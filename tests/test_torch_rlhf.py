"""PPO-RLHF in the port (``dla_tpu_torch.training.train_rlhf``) against
the JAX package's CLI, and its five losses and prompt loader.

The CLI cases run ``train_rlhf.main(argv, device="cpu")`` and
``dla_tpu.training.train_rlhf.main`` on config/rlhf_config.yaml with the
same tiny checkpoints (the committed fp32 llama as policy and reference,
a reward model made from it with a head from a numpy seed, written by
the port's Checkpointer, which both packages load), the same local
prompts and seed: 8 rollout rows of 8 new tokens, 3 rollouts. JAX runs
the 8-device CPU mesh of the tests' conftest. The rollouts must hold the
same tokens (the samplers draw ``jax.random``'s bits in both packages);
every logged ``train/*`` value per rollout must agree to 1e-5, absolute
and relative (fp32 sums taken in another order; the REINFORCE loss sums
advantages of zero mean, so its rounding noise is absolute)."""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.data.jsonl import write_jsonl
from dla_tpu.ops import losses as jlosses
from dla_tpu_torch.checkpoint.checkpointer import Checkpointer, load_tree_numpy
from dla_tpu_torch.data.loaders import load_prompt_records
from dla_tpu_torch.models.weights import params_from_jax
from dla_tpu_torch.ops import losses
from dla_tpu_torch.training import train_rlhf

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "config" / "rlhf_config.yaml")
POLICY = str(ROOT / "checkpoints" / "run" / "final")
TRAIN_KEYS = ("train/loss", "train/kl", "train/kl_coef", "train/reward_mean",
              "train/rm_score_mean", "train/response_len",
              "train/zero_len_responses")


# ------------------------------------------------------------------ losses

def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def test_sequence_losses_match_jax():
    """``reinforce_loss`` and ``ppo_clip_loss`` (loss and clip fraction)
    on the same [B] inputs to 1e-6, and their gradients in logp."""
    rs = np.random.RandomState(0)
    logp, beh, adv = _rand(rs, 16) * 0.3, _rand(rs, 16) * 0.3, _rand(rs, 16)
    t = torch.from_numpy(logp).requires_grad_(True)
    got = losses.reinforce_loss(t, torch.from_numpy(adv))
    got.backward()
    want, jgrad = jax.value_and_grad(jlosses.reinforce_loss)(
        jnp.asarray(logp), jnp.asarray(adv))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), atol=1e-6)
    t.grad = None
    loss, frac = losses.ppo_clip_loss(t, torch.from_numpy(beh),
                                      torch.from_numpy(adv), 0.2)
    loss.backward()
    (jl, jf), jg = jax.value_and_grad(jlosses.ppo_clip_loss, has_aux=True)(
        jnp.asarray(logp), jnp.asarray(beh), jnp.asarray(adv), 0.2)
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-6)
    assert 0.0 < float(frac) < 1.0
    np.testing.assert_allclose(float(frac), float(jf), atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-6)


def _spans_mask(b, t, spans):
    am = np.zeros((b, t), np.int32)
    for row, (lo, hi) in enumerate(spans):
        am[row, lo:hi] = 1
    return am


def test_gae_advantages_match_jax_and_naive_loop():
    """``gae_advantages`` against the JAX reverse scan and the textbook
    per-row recursion (tests/test_train_rlhf.py's naive loop): actions on
    [2, 8), [0, 10) and [5, 6), terminal bootstrap V := 0."""
    rs = np.random.RandomState(0)
    b, t, gamma, lam = 3, 10, 0.99, 0.9
    spans = [(2, 8), (0, 10), (5, 6)]
    am = _spans_mask(b, t, spans)
    rewards = _rand(rs, b, t) * am
    values = _rand(rs, b, t)
    adv, ret = losses.gae_advantages(torch.from_numpy(rewards),
                                     torch.from_numpy(values),
                                     torch.from_numpy(am), gamma, lam)
    jadv, jret = jlosses.gae_advantages(jnp.asarray(rewards),
                                        jnp.asarray(values), jnp.asarray(am),
                                        gamma, lam)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), atol=1e-6)
    want = np.zeros((b, t), np.float32)
    for row, (lo, hi) in enumerate(spans):
        a_next = 0.0
        for s in range(hi - 1, lo - 1, -1):
            v_next = values[row, s + 1] if s + 1 < hi else 0.0
            a_next = (rewards[row, s] + gamma * v_next - values[row, s]
                      + gamma * lam * a_next)
            want[row, s] = a_next
    np.testing.assert_allclose(adv.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), want + values * am, rtol=1e-5,
                               atol=1e-5)


def test_token_losses_match_jax():
    """``ppo_token_loss`` (loss, clip fraction) and ``ppo_value_loss`` on
    [B, T] inputs under an action mask, values and gradients to 1e-6."""
    rs = np.random.RandomState(1)
    b, t = 4, 12
    am = _spans_mask(b, t, [(3, 9), (0, 12), (6, 7), (2, 11)])
    lp, beh = _rand(rs, b, t) * 0.3, _rand(rs, b, t) * 0.3
    adv, ret = _rand(rs, b, t), _rand(rs, b, t)
    val, vold = _rand(rs, b, t), _rand(rs, b, t)
    tl = torch.from_numpy(lp).requires_grad_(True)
    loss, frac = losses.ppo_token_loss(tl, torch.from_numpy(beh),
                                       torch.from_numpy(adv),
                                       torch.from_numpy(am), 0.2)
    loss.backward()
    (jl, jf), jg = jax.value_and_grad(jlosses.ppo_token_loss, has_aux=True)(
        jnp.asarray(lp), jnp.asarray(beh), jnp.asarray(adv), jnp.asarray(am),
        0.2)
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-6)
    np.testing.assert_allclose(float(frac), float(jf), atol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), atol=1e-6)
    tv = torch.from_numpy(val).requires_grad_(True)
    vl = losses.ppo_value_loss(tv, torch.from_numpy(vold),
                               torch.from_numpy(ret), torch.from_numpy(am),
                               0.2)
    vl.backward()
    jvl, jvg = jax.value_and_grad(jlosses.ppo_value_loss)(
        jnp.asarray(val), jnp.asarray(vold), jnp.asarray(ret),
        jnp.asarray(am), 0.2)
    np.testing.assert_allclose(vl.item(), float(jvl), atol=1e-6)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jvg), atol=1e-6)


def test_load_prompt_records_matches_jax(tmp_path):
    from dla_tpu.data.loaders import load_prompt_records as j_load
    write_jsonl(tmp_path / "p.jsonl", [{"prompt": f"p{i}" if i % 5 else ""}
                                       for i in range(20)])
    for cfg in ({"source": "local", "prompt_path": str(tmp_path / "p.jsonl")},
                {"path": str(tmp_path / "p.jsonl"), "limit": 7}):
        assert load_prompt_records(cfg) == j_load(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_prompt_records({"source": "hf", "hf_path": "x"})
    with pytest.raises(ValueError, match="prompt_path"):
        load_prompt_records({"source": "local"})


# --------------------------------------------------------------------- CLI

def reward_checkpoint(path: pathlib.Path) -> str:
    """A reward model both packages load: the policy checkpoint's trunk
    (its lm_head dropped) with a head drawn from a numpy seed."""
    tree, aux = load_tree_numpy(POLICY, prefix="params")
    tree.pop("lm_head")
    d = tree["final_norm"].shape[0]
    rs = np.random.RandomState(11)
    tree["reward_head"] = {"w": (rs.randn(d, 1) * 0.5).astype(np.float32),
                           "b": np.zeros((1,), np.float32)}
    Checkpointer(str(path)).save(
        0, {"params": params_from_jax(tree, "cpu")},
        {"model_config": aux["model_config"], "tokenizer": "byte"},
        tag="final")
    return str(path / "final")


def write_prompts(path: pathlib.Path) -> None:
    write_jsonl(path, [{"prompt": f"say something about topic {i}"}
                       for i in range(32)])


def rlhf_argv(tmp: pathlib.Path, work: str, algo: str, steps: int = 3,
              **extra):
    """The CLI's arguments on config/rlhf_config.yaml (prompts and the
    reward checkpoint under ``tmp``; checkpoints and logs under
    ``tmp / work``), shaped like tests/test_train_rlhf.py's config."""
    sets = {"seed": 0,
            "model.policy_model_name_or_path": POLICY,
            "model.reference_model_name_or_path": POLICY,
            "model.tokenizer": "byte", "model.max_seq_length": 48,
            "reward_model.path": str(tmp / "reward" / "final"),
            "ppo.algo": algo, "ppo.batch_size": 8, "ppo.mini_batch_size": 4,
            "ppo.epochs": 1, "ppo.learning_rate": "1.0e-4",
            "ppo.kl_coef": 0.1, "ppo.target_kl": 6.0, "ppo.steps": steps,
            "ppo.generation_params.max_new_tokens": 8,
            "sampling.source": "local",
            "sampling.prompt_path": str(tmp / "prompts.jsonl"),
            "logging.output_dir": str(tmp / work / "ckpt"),
            "logging.log_dir": str(tmp / work / "logs"),
            "logging.log_every_steps": 1, "logging.save_every_steps": 0,
            "hardware.mesh": "{data: 2, fsdp: 2, model: 2}", **extra}
    argv = ["--config", CONFIG]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    return argv


def train_rows(log_dir: pathlib.Path):
    return [r for r in (json.loads(line) for line in
                        (log_dir / "metrics.jsonl").read_text().splitlines())
            if "train/kl" in r]


def _recorded(monkeypatch, module, where, store):
    """Wrap the score functions of ``module`` so each call records its
    rollout sequences: ``where`` maps a name to the position of the
    sequences among the call's arguments; a ``make_*`` name is a factory
    whose product is wrapped."""
    for name, pos in where.items():
        real = getattr(module, name)

        def wrap(fn, pos=pos):
            def scored(*args, **kw):
                store.append(np.asarray(args[pos]))
                return fn(*args, **kw)
            return scored

        if name.startswith("make_"):
            monkeypatch.setattr(module, name, lambda *a, _real=real,
                                _wrap=wrap, **k: _wrap(_real(*a, **k)))
        else:
            monkeypatch.setattr(module, name, wrap(real))


def run_both(tmp: pathlib.Path, monkeypatch, algo: str, steps: int = 3,
             resume_at: int = 0, **extra):
    """Both CLIs on the same config; returns (JAX rows, port rows, JAX
    rollout sequences, port rollout sequences, port trainer). With
    ``resume_at`` each first runs ``resume_at`` rollouts, then resumes
    from its final checkpoint to ``steps``."""
    import dla_tpu.training.train_rlhf as j_rlhf
    monkeypatch.chdir(ROOT)
    if not (tmp / "reward").is_dir():
        reward_checkpoint(tmp / "reward")
        write_prompts(tmp / "prompts.jsonl")
    jseqs, tseqs = [], []
    _recorded(monkeypatch, j_rlhf,
              {"make_score_fn": 3, "make_gae_score_fn": 4}, jseqs)
    _recorded(monkeypatch, train_rlhf,
              {"score_rollout": 6, "score_rollout_gae": 7}, tseqs)
    trainer = None
    for n, resume in ([(resume_at, False), (steps, True)] if resume_at
                      else [(steps, False)]):
        tail = ["--resume"] if resume else []
        j_rlhf.main(rlhf_argv(tmp, f"j_{algo}", algo, n, **extra) + tail)
        trainer = train_rlhf.main(
            rlhf_argv(tmp, f"t_{algo}", algo, n, **extra) + tail,
            device="cpu")
    return (train_rows(tmp / f"j_{algo}" / "logs"),
            train_rows(tmp / f"t_{algo}" / "logs"), jseqs, tseqs, trainer)


def assert_rollouts_match(jrows, trows, jseqs, tseqs, n_rollouts):
    """The same rollout tokens first, then every train/* value per
    rollout to 1e-5."""
    assert len(jseqs) == len(tseqs) == n_rollouts
    for i, (js, ts) in enumerate(zip(jseqs, tseqs)):
        np.testing.assert_array_equal(ts, js, err_msg=f"rollout {i + 1}")
    assert [r["step"] for r in trows] == [r["step"] for r in jrows]
    for key in TRAIN_KEYS:
        np.testing.assert_allclose([r[key] for r in trows],
                                   [r[key] for r in jrows], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    for r in trows:
        assert all(np.isfinite(r[k]) for k in TRAIN_KEYS)


@pytest.mark.parametrize("algo", ["reinforce", "ppo", "gae"])
def test_rlhf_cli_matches_jax(tmp_path, monkeypatch, algo):
    """reinforce (one update a rollout), ppo (2 minibatches of 4 rows, the
    adaptive KL controller) and gae (value head, per-token rewards): 3
    rollouts each, tokens equal and train/* values to 1e-5; policy =
    reference, so the first rollout's KL is 0 exactly in the port."""
    jrows, trows, jseqs, tseqs, trainer = run_both(tmp_path, monkeypatch,
                                                   algo)
    assert [r["step"] for r in trows] == [1, 2, 3]
    assert_rollouts_match(jrows, trows, jseqs, tseqs, 3)
    assert trows[0]["train/kl"] == 0.0
    stats = trainer.rollout_stats
    assert len(stats) == 3
    n_updates = 1 if algo == "reinforce" else 2
    assert all(len(s["losses"]) == n_updates for s in stats)
    if algo != "reinforce":
        # the first minibatch updates from the sampling policy itself
        assert stats[0]["metrics"][0]["clip_frac"] == 0.0
