"""PPO-RLHF (phase 3b) on the GPU: rollout -> score -> update.

The CLI of ``dla_tpu.training.train_rlhf`` with the same config:

  python -m dla_tpu_torch.training.train_rlhf \\
      --config config/rlhf_config.yaml [--overlay o.yaml] \\
      [--set key=value ...] [--resume]

Each rollout draws ``ppo.batch_size / samples_per_prompt`` prompts
(``random.Random(seed)``, templated ``"{prompt}\\n\\n"``), generates
``samples_per_prompt`` (G) responses each with the policy (prefill once,
cache expanded G-fold; the key ``fold_in(PRNGKey(seed), 10_000 +
rollout)``, so the same checkpoint, config and seed give the JAX CLI's
tokens), scores them and updates the policy:

- ``ppo.algo: reinforce`` (the default, the reference's behaviour):
  reward = RM(sequence) - kl_coef * (logp_pi - logp_ref) over
  sequence-mean log-probs, advantage = reward - batch mean, loss
  -(advantage * logp).mean(), one update per rollout;
- ``ppo``: the clipped surrogate over minibatches (a permutation from
  ``np.random.default_rng((rollout, epoch))``) for ``ppo.epochs``, with
  the adaptive KL coefficient (``target_kl``);
- ``gae``: a zero-init value head on the policy trunk, per-token
  KL-penalty rewards with the RM score at the last response token,
  GAE(gamma, lambda) advantages whitened over action tokens, the
  token-level clipped surrogate and the clipped value loss.

Scoring and sampling share one tree: the policy's weights cast once a
rollout to the activation dtype (the values every forward computes
with), or with ``ppo.rollout_quantize_weights`` its int8 weight-only
copy, so the behaviour log-probs are the sampler's; the update trains
the full-precision parameters. The reference and reward models are
frozen (no grad). Logs the JAX CLI's ``train/*`` payload every
``log_every_steps`` rollouts; checkpoints every ``save_every_steps``
rollouts, ``final`` at the end and, for gae, a plain-policy ``policy``
checkpoint that ``latest`` names; ``--resume`` continues at the rollout
boundary of the latest checkpoint.

Not ported yet, each raising with a pointer to ROADMAP.md: the serving
rollout backend, its async mode and sampler fleet, and LoRA policies.
"""
from __future__ import annotations

import random
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dla_tpu_torch.data.loaders import load_prompt_records
from dla_tpu_torch.generation.engine import (
    GenerationConfig,
    build_generate_fn,
    encode_prompt_batch,
)
from dla_tpu_torch.ops import prng
from dla_tpu_torch.ops.fused_ce import (
    fused_token_logprobs,
    model_fused_sequence_logprob,
    unembed_operands,
)
from dla_tpu_torch.ops.losses import (
    gae_advantages,
    masked_mean,
    ppo_clip_loss,
    ppo_token_loss,
    ppo_value_loss,
    reinforce_loss,
)
from dla_tpu_torch.training.config import config_from_args, make_arg_parser
from dla_tpu_torch.training.model_io import (
    build_reward_model,
    load_causal_lm,
    model_aux,
)
from dla_tpu_torch.training.trainer import Trainer
from dla_tpu_torch.training.utils import root_key

PROMPT_TEMPLATE = "{prompt}\n\n"


def make_policy_gradient_loss(policy_model, algo: str, clip_ratio: float):
    """Sequence-level loss over the fused sequence-mean log-prob: REINFORCE
    or (``algo == "ppo"``) the clipped surrogate."""
    def loss_fn(params, frozen, batch, rng):
        del frozen, rng
        logp = model_fused_sequence_logprob(
            policy_model, params, batch["sequences"], batch["sequence_mask"])
        if algo == "ppo":
            loss, clip_frac = ppo_clip_loss(
                logp, batch["behavior_logp"], batch["advantages"], clip_ratio)
            return loss, {"policy_logp": logp.mean(), "clip_frac": clip_frac}
        return reinforce_loss(logp, batch["advantages"]), \
            {"policy_logp": logp.mean()}
    return loss_fn


def init_value_head(model, device) -> Dict[str, torch.Tensor]:
    """The critic: a scalar head on the policy trunk's hidden states,
    zero-init (V starts at 0, so the first rollout's advantages are the
    KL-penalized rewards)."""
    d = model.cfg.hidden_size
    return {"w": torch.zeros((d, 1), dtype=torch.float32, device=device),
            "b": torch.zeros((1,), dtype=torch.float32, device=device)}


def token_logps_and_values(model, params, seqs, mask, value_head=None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-token next-token log-probs [B, S-1] (fused, no [B, S, V]) and,
    with a value head, values [B, S-1] on the same shifted grid (v[t]
    estimates the return from the state that predicts token t+1)."""
    h = model.hidden_states(params, seqs, attention_mask=mask)
    w, bias = unembed_operands(model, params)
    lp = fused_token_logprobs(h[:, :-1, :], w, seqs[:, 1:], bias)
    v = None
    if value_head is not None:
        v = (h[:, :-1, :].float() @ value_head["w"])[..., 0] \
            + value_head["b"]
    return lp, v


def make_gae_loss(policy_model, clip_ratio: float, value_coef: float,
                  value_clip: float):
    """Per-token clipped PPO + clipped value loss over the trainable tree
    {"policy": params, "value_head": {w, b}}."""
    def loss_fn(params, frozen, batch, rng):
        del frozen, rng
        lp, v = token_logps_and_values(
            policy_model, params["policy"], batch["sequences"],
            batch["sequence_mask"], value_head=params["value_head"])
        am = batch["action_mask"]
        pg, clip_frac = ppo_token_loss(
            lp, batch["behavior_logp"], batch["advantages"], am, clip_ratio)
        vl = ppo_value_loss(v, batch["behavior_values"], batch["returns"],
                            am, value_clip)
        return pg + value_coef * vl, {"clip_frac": clip_frac,
                                      "value_loss": vl,
                                      "policy_logp": masked_mean(lp, am)}
    return loss_fn


@torch.no_grad()
def score_rollout(policy_model, ref_model, reward_model, policy_params,
                  ref_params, rm_params, seqs, mask, kl_coef: float
                  ) -> Dict[str, torch.Tensor]:
    """Sequence-level scores of a rollout batch: the reward RM(seq) -
    kl_coef * (logp_pi - logp_ref) and its batch-mean baseline."""
    logp_pi = model_fused_sequence_logprob(policy_model, policy_params,
                                           seqs, mask)
    logp_ref = model_fused_sequence_logprob(ref_model, ref_params, seqs, mask)
    rm_score = reward_model.apply(rm_params, seqs, mask)
    kl = logp_pi - logp_ref
    reward = rm_score - kl_coef * kl
    return {"advantages": reward - reward.mean(), "behavior_logp": logp_pi,
            "reward_mean": reward.mean(), "rm_score_mean": rm_score.mean(),
            "kl": kl.mean()}


@torch.no_grad()
def score_rollout_gae(policy_model, ref_model, reward_model, policy_params,
                      value_head, ref_params, rm_params, seqs, mask,
                      prompt_lens, kl_coef: float, gamma: float, lam: float
                      ) -> Dict[str, torch.Tensor]:
    """Per-token scores: KL-penalty rewards on every action token, the RM
    score added at the last one, GAE over the values, advantages
    whitened over action tokens."""
    lp_pi, v = token_logps_and_values(policy_model, policy_params, seqs,
                                      mask, value_head=value_head)
    lp_ref, _ = token_logps_and_values(ref_model, ref_params, seqs, mask)
    rm_score = reward_model.apply(rm_params, seqs, mask)          # [B]
    s = seqs.shape[1]
    # action position t on the shifted grid: target token t+1 is a real
    # generated token (left_align puts responses right after the prompt)
    pos = torch.arange(1, s, device=seqs.device)[None, :]
    am = (mask[:, 1:] > 0) & (pos >= prompt_lens[:, None])
    amf = am.float()
    rewards = -kl_coef * (lp_pi - lp_ref) * amf
    last = (mask.sum(1) - 2).clamp(0, s - 2)
    terminal = torch.nn.functional.one_hot(last.long(), s - 1).float() * amf
    rewards = rewards + terminal * rm_score[:, None]
    adv, ret = gae_advantages(rewards, v, am, gamma, lam)
    mu = masked_mean(adv, am)
    var = masked_mean(torch.square(adv - mu), am)
    adv = (adv - mu) * torch.rsqrt(var + 1e-8) * amf
    return {"advantages": adv, "returns": ret, "behavior_logp": lp_pi,
            "behavior_values": v, "action_mask": am,
            "reward_mean": rewards.sum(1).mean(),
            "rm_score_mean": rm_score.mean(),
            "kl": masked_mean(lp_pi - lp_ref, am)}


def compute_rollout_shape(batch_size: int, samples_per_prompt: int = 1
                          ) -> Tuple[int, int]:
    """(rollout rows, unique prompts) of one rollout on one device: G =
    ``samples_per_prompt`` must divide the rows."""
    if samples_per_prompt < 1:
        raise ValueError(
            f"ppo.samples_per_prompt ({samples_per_prompt}) must be >= 1")
    if batch_size % samples_per_prompt:
        raise ValueError(
            f"ppo.samples_per_prompt ({samples_per_prompt}) must divide "
            f"the rollout batch ({batch_size})")
    return batch_size, batch_size // samples_per_prompt


def _check_ported(ppo_cfg: Dict[str, Any], policy) -> None:
    rollout_cfg = dict(ppo_cfg.get("rollout") or {})
    backend = str(rollout_cfg.get("backend", "batch")).lower()
    if backend not in ("batch", "serving"):
        raise ValueError(f"ppo.rollout.backend must be batch|serving, got "
                         f"{backend!r}")
    if backend == "serving":
        raise NotImplementedError(
            "ppo.rollout.backend: serving is not ported yet (it sits on the "
            "serving stack, ROADMAP.md §1 item 3); use backend: batch")
    if rollout_cfg.get("fleet") is not None:
        raise NotImplementedError(
            "ppo.rollout.fleet (the sampler fleet) is not ported yet "
            "(ROADMAP.md §1 item 3)")
    if str(rollout_cfg.get("mode", "sync")).lower() != "sync":
        raise NotImplementedError(
            "ppo.rollout.mode: async is not ported yet (ROADMAP.md §1 item "
            "3); the batch backend runs sync")
    if policy.config.lora_r > 0:
        raise NotImplementedError(
            "LoRA policies are not ported yet (ROADMAP.md §1 item 1)")


def _generator(seed: int, stream: int, device) -> torch.Generator:
    """The stream that initialises preset ``stream`` of the run (0 the
    policy, 1 the reference, 2 the reward model)."""
    state = np.random.SeedSequence((seed % 2 ** 64, stream)).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, device="cuda") -> Trainer:
    args = make_arg_parser("dla_tpu_torch PPO-RLHF trainer").parse_args(argv)
    config = config_from_args(args)
    device = torch.device(device)
    seed = int(config.get("seed", 0))
    rng = root_key(seed)

    model_cfg: Dict[str, Any] = config.get("model", {})
    ppo_cfg: Dict[str, Any] = config.get("ppo", {})
    algo = str(ppo_cfg.get("algo", "reinforce")).lower()
    if algo == "ppo_gae":
        algo = "gae"
    if algo not in ("reinforce", "ppo", "gae"):
        raise ValueError(f"unknown ppo.algo '{algo}'; use reinforce "
                         "(reference behavior), ppo (clipped, seq-level), "
                         "or gae (per-token critic PPO)")
    gamma = float(ppo_cfg.get("gamma", 1.0))
    gae_lambda = float(ppo_cfg.get("gae_lambda", 0.95))
    value_coef = float(ppo_cfg.get("value_coef", 0.5))
    value_clip = float(ppo_cfg.get("value_clip", 0.2))
    batch_size = int(ppo_cfg.get("batch_size", 64))
    mini_batch = int(ppo_cfg.get("mini_batch_size", batch_size))
    ppo_epochs = int(ppo_cfg.get("epochs", 1))
    kl_coef = float(ppo_cfg.get("kl_coef", 0.1))
    target_kl = ppo_cfg.get("target_kl")
    clip_ratio = float(ppo_cfg.get("clip_ratio", 0.2))
    n_steps = int(ppo_cfg.get("steps", 1024))
    max_seq = int(model_cfg.get("max_seq_length", 1024))
    samples_per_prompt = int(ppo_cfg.get("samples_per_prompt", 1))
    gen = GenerationConfig.from_dict(
        ppo_cfg.get("generation_params"), max_new_tokens=256,
        temperature=1.0, top_p=1.0, do_sample=True)
    prompt_width = int(ppo_cfg.get(
        "max_prompt_length", max_seq - gen.max_new_tokens))

    policy_name = model_cfg.get("policy_model_name_or_path", "tiny")
    policy = load_causal_lm(policy_name, model_cfg,
                            _generator(seed, 0, device), device=device)
    _check_ported(ppo_cfg, policy)
    ref = load_causal_lm(
        model_cfg.get("reference_model_name_or_path") or policy_name,
        model_cfg, _generator(seed, 1, device), device=device)
    rm_cfg = {**config.get("reward_model", {})}
    rm_cfg.setdefault("base_model_name_or_path", rm_cfg.pop("path", None))
    rm_cfg.setdefault("tokenizer", model_cfg.get("tokenizer"))
    rm = build_reward_model(rm_cfg, _generator(seed, 2, device),
                            device=device)
    # frozen models: the leaves every forward casts, cast once (the same
    # values); no gradients
    ref_params = ref.model.activation_weights(ref.params)
    rm_params = {**rm.model.backbone.activation_weights(rm.params),
                 "reward_head": rm.params["reward_head"]}
    ref.params = rm.params = None

    gen = GenerationConfig(**{**gen.__dict__,
                              "eos_token_id": policy.tokenizer.eos_token_id,
                              "pad_token_id": policy.tokenizer.pad_token_id})
    rollout_rows, n_prompts = compute_rollout_shape(batch_size,
                                                    samples_per_prompt)
    mb_size = min(mini_batch, rollout_rows)
    n_minibatches = max(1, rollout_rows // mb_size)
    # optimizer steps per rollout: they size the LR horizon and the
    # resume position; ppo/gae drop rollout_rows % mb_size rows an epoch
    updates_per_rollout = (n_minibatches * ppo_epochs
                           if algo in ("ppo", "gae") else 1)
    base_opt = dict(config.get("optimization", {}))
    update_bs = mb_size if algo in ("ppo", "gae") else rollout_rows
    accum = int(config.get("hardware", {}).get(
        "gradient_accumulation_steps", 1))
    opt_block = {
        **base_opt,
        "learning_rate": ppo_cfg.get(
            "learning_rate", base_opt.get("learning_rate", 1e-6)),
        "max_train_steps": n_steps * updates_per_rollout,
        "total_batch_size": update_bs,
        "micro_batch_size": ppo_cfg.get(
            "micro_batch_size", base_opt.get("micro_batch_size"))
        or max(1, update_bs // accum),
        "lr_scheduler": ppo_cfg.get(
            "lr_scheduler", base_opt.get("lr_scheduler", "constant")),
        "max_grad_norm": ppo_cfg.get(
            "max_grad_norm", base_opt.get("max_grad_norm", 1.0)),
    }
    cfg_for_trainer = {**config, "optimization": opt_block}

    if algo == "gae":
        trainer = Trainer(
            config=cfg_for_trainer,
            loss_fn=make_gae_loss(policy.model, clip_ratio, value_coef,
                                  value_clip),
            params={"policy": policy.params,
                    "value_head": init_value_head(policy.model, device)})
    else:
        trainer = Trainer(
            config=cfg_for_trainer,
            loss_fn=make_policy_gradient_loss(policy.model, algo,
                                              clip_ratio),
            params=policy.params)

    def policy_tree():
        return (trainer.params["policy"] if algo == "gae"
                else trainer.params)

    quantize = bool(ppo_cfg.get("rollout_quantize_weights", False))

    @torch.no_grad()
    def rollout_params():
        """The tree that samples and scores this rollout: the policy, or
        its int8 weight-only copy with ``rollout_quantize_weights``, with
        the leaves every forward casts cast once to the activation dtype
        (the values every forward computes with)."""
        tree = policy_tree()
        if quantize:
            tree = policy.model.quantize_weights(tree)
        return policy.model.activation_weights(tree)

    generate_fn = build_generate_fn(policy.model, gen,
                                    group_size=samples_per_prompt)
    prompts = load_prompt_records(config.get("sampling", {}))
    if not prompts:
        raise ValueError("no prompts loaded for RLHF sampling")
    print(f"[dla_tpu_torch] RLHF: {len(prompts)} prompts, algo={algo}, "
          f"batch {batch_size}, {n_steps} steps", flush=True)
    host_rng = random.Random(seed)
    tok = policy.tokenizer

    def sample_prompt_batch():
        """One prompt draw (call exactly once per rollout, in order):
        templated text on the fixed right-padded [prompts, P] grid."""
        batch = [PROMPT_TEMPLATE.format(prompt=p) for p in (
            host_rng.sample(prompts, n_prompts)
            if len(prompts) >= n_prompts
            else host_rng.choices(prompts, k=n_prompts))]
        ids, mask = encode_prompt_batch(tok, batch, prompt_width)
        return (torch.from_numpy(ids).to(device),
                torch.from_numpy(mask).to(device))

    rollout_idx = 0
    if args.resume and trainer.try_resume() is not None:
        # optimizer steps -> completed rollouts: a resumed run executes
        # only the remainder
        rollout_idx = trainer.step // updates_per_rollout
        print(f"[dla_tpu_torch] resuming at rollout {rollout_idx}/{n_steps}",
              flush=True)
    log_every = int(config.get("logging", {}).get("log_every_steps", 10))
    save_every = int(config.get("logging", {}).get("save_every_steps", 0))
    aux = model_aux(policy, model_cfg.get("tokenizer"))
    # per-rollout phase times and update metrics, for whoever drives the
    # run (chip_smoke.py reads them)
    trainer.rollout_stats = []

    while rollout_idx < n_steps:
        t0 = time.perf_counter()
        rp = rollout_params()
        ids, mask = sample_prompt_batch()
        out = generate_fn(rp, ids, mask, prng.fold_in(rng, 10_000
                                                      + rollout_idx))
        # ids hold the unique prompts; rows come G per prompt in order
        prompt_lens = torch.repeat_interleave(mask.sum(1),
                                              samples_per_prompt)
        _sync(device)
        t1 = time.perf_counter()
        if algo == "gae":
            scores = score_rollout_gae(
                policy.model, ref.model, rm.model, rp,
                trainer.params["value_head"], ref_params, rm_params,
                out["sequences"], out["sequence_mask"], prompt_lens, kl_coef,
                gamma, gae_lambda)
        else:
            scores = score_rollout(
                policy.model, ref.model, rm.model, rp, ref_params, rm_params,
                out["sequences"], out["sequence_mask"], kl_coef)
        del rp
        _sync(device)
        t2 = time.perf_counter()

        up = {"sequences": out["sequences"],
              "sequence_mask": out["sequence_mask"],
              "advantages": scores["advantages"],
              "behavior_logp": scores["behavior_logp"]}
        if algo == "gae":
            up.update(returns=scores["returns"],
                      behavior_values=scores["behavior_values"],
                      action_mask=scores["action_mask"])
        losses, metrics = [], []
        if algo in ("ppo", "gae"):
            assert int(up["sequences"].shape[0]) == rollout_rows
            for epoch in range(ppo_epochs):
                order = np.random.default_rng(
                    (rollout_idx, epoch)).permutation(rollout_rows)
                for k in range(n_minibatches):
                    sl = torch.from_numpy(
                        order[k * mb_size:(k + 1) * mb_size]).to(device)
                    mb = {key: v.index_select(0, sl) for key, v in up.items()}
                    loss, m = trainer.step_on_batch(mb)
                    losses.append(loss)
                    metrics.append(m)
        else:
            loss, m = trainer.step_on_batch(up)
            losses.append(loss)
            metrics.append(m)
        _sync(device)
        t3 = time.perf_counter()

        kl_now = float(scores["kl"])
        if algo in ("ppo", "gae") and target_kl:
            # the adaptive KL controller
            if kl_now > 1.5 * float(target_kl):
                kl_coef *= 2.0
            elif kl_now < float(target_kl) / 1.5:
                kl_coef *= 0.5
        rollout_idx += 1
        resp_len = out["response_mask"].sum(-1)
        payload = {
            "train/loss": float(np.mean(losses)),
            "train/kl": kl_now,
            "train/kl_coef": kl_coef,
            "train/reward_mean": float(scores["reward_mean"]),
            "train/rm_score_mean": float(scores["rm_score_mean"]),
            "train/response_len": float(resp_len.float().mean()),
            # rows that generated nothing (a collapsed all-EOS policy
            # would otherwise read as reward ~0)
            "train/zero_len_responses": float((resp_len == 0).sum()),
        }
        trainer.rollout_stats.append(dict(
            rollout=rollout_idx, rollout_s=t1 - t0, score_s=t2 - t1,
            update_s=t3 - t2, losses=losses, metrics=metrics, **payload))
        if rollout_idx % log_every == 0:
            trainer.logger.log(payload, rollout_idx)
            print(f"rollout {rollout_idx}: reward "
                  f"{payload['train/reward_mean']:.4f} kl {kl_now:.4f}",
                  flush=True)
        if save_every and rollout_idx % save_every == 0:
            trainer.save(extra_aux=aux)

    trainer.save(extra_aux=aux, tag="final")
    if algo == "gae":
        # `final` holds the {policy, value_head} training tree (what resume
        # reads); chained configs read `latest`, which now names a
        # plain-policy checkpoint a causal LM loads
        trainer.checkpointer.save(trainer.step, {"params": policy_tree()},
                                  {"step": trainer.step, **aux},
                                  tag="policy")
        print("[dla_tpu_torch] wrote plain-policy checkpoint (`latest` -> "
              "policy; training state in `final`)", flush=True)
    return trainer


if __name__ == "__main__":
    main()
