"""Direct Preference Optimization (phase 3a) on the GPU, full-parameter.

The CLI of ``dla_tpu.training.train_dpo`` with the same config:

  python -m dla_tpu_torch.training.train_dpo \\
      --config config/dpo_config.yaml [--overlay o.yaml] \\
      [--set key=value ...] [--resume]

The policy trains against a frozen reference: the loss is
-logsigmoid(beta * ((pi_c - pi_r) - (ref_c - ref_r))) over each
sequence's length-normalized mean token log p (``model.label_smoothing``
> 0: conservative DPO), the four forwards through the fused log-prob
(no [B, T, V] logits), the reference's under ``torch.no_grad``. The
reference is ``model.reference_model_name_or_path``, loaded as its own
copy, or else a frozen copy of the starting policy. Logs
``preference_rate`` (margin > 0), ``margin`` and ``policy_chosen_logp``.
``data.packing`` scores per packed segment under the pair mask. LoRA is
not ported yet and raises (ROADMAP.md), as do HF data sources.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from dla_tpu_torch.data.iterator import ShardedBatchIterator
from dla_tpu_torch.data.loaders import build_preference_splits
from dla_tpu_torch.ops.fused_ce import (
    model_fused_segment_logprob,
    model_fused_sequence_logprob,
)
from dla_tpu_torch.ops.losses import dpo_loss, masked_mean
from dla_tpu_torch.training.config import config_from_args, make_arg_parser
from dla_tpu_torch.training.model_io import load_causal_lm, model_aux
from dla_tpu_torch.training.trainer import Trainer
from dla_tpu_torch.training.utils import seed_everything


def make_dpo_loss(policy_model, ref_model, beta: float,
                  label_smoothing: float = 0.0, n_segments: int = 0):
    """``n_segments`` > 0: packed rows, per-segment log p [B, n_segments]
    with the pair mask weighting every mean (segment j of a chosen row
    pairs with segment j of the rejected row)."""
    def seq_logp(model, params, sub):
        if n_segments:
            return model_fused_segment_logprob(model, params, sub,
                                               n_segments)
        return model_fused_sequence_logprob(model, params, sub["input_ids"],
                                            sub["attention_mask"])

    def loss_fn(params, frozen, batch, rng):
        del rng
        pi_c = seq_logp(policy_model, params, batch["chosen"])
        pi_r = seq_logp(policy_model, params, batch["rejected"])
        with torch.no_grad():
            ref_c = seq_logp(ref_model, frozen, batch["chosen"])
            ref_r = seq_logp(ref_model, frozen, batch["rejected"])
        pv = batch.get("pair_mask") if n_segments else None
        loss, margin = dpo_loss(pi_c, pi_r, ref_c, ref_r, beta,
                                label_smoothing, valid=pv)
        return loss, {
            "preference_rate": masked_mean((margin > 0).float(), pv),
            "margin": masked_mean(margin, pv),
            "policy_chosen_logp": masked_mean(pi_c, pv)}
    return loss_fn


def main(argv=None, device="cuda") -> Trainer:
    args = make_arg_parser("dla_tpu_torch DPO trainer").parse_args(argv)
    config = config_from_args(args)
    seed = int(config.get("seed", 0))
    generator = seed_everything(seed, device)
    model_cfg: Dict[str, Any] = config.get("model", {})
    policy = load_causal_lm(
        model_cfg.get("policy_model_name_or_path",
                      model_cfg.get("model_name_or_path", "tiny")),
        model_cfg, generator, device=device)
    ref_name = model_cfg.get("reference_model_name_or_path")
    # a preset reference starts from the policy's weights: a generator
    # seeded alike
    ref = (load_causal_lm(ref_name, model_cfg,
                          torch.Generator(device=device).manual_seed(seed),
                          device=device)
           if ref_name else policy)
    train_ds, eval_ds, n_segments = build_preference_splits(
        config, policy.tokenizer, policy.config.max_seq_length)
    # the Trainer copies reference leaves that share the policy's storage
    trainer = Trainer(
        config=config,
        loss_fn=make_dpo_loss(policy.model, ref.model,
                              float(model_cfg.get("beta", 0.1)),
                              float(model_cfg.get("label_smoothing", 0.0)),
                              n_segments),
        params=policy.params, frozen=ref.params)
    train_it = ShardedBatchIterator(train_ds, trainer.global_batch,
                                    seed=seed)
    eval_iter_fn = None
    if eval_ds is not None:
        def eval_iter_fn():
            return iter(ShardedBatchIterator(eval_ds, trainer.micro,
                                             shuffle=False))
    trainer.fit(train_it, eval_iter_fn=eval_iter_fn,
                data_state=train_it.state_dict, resume=args.resume,
                extra_aux=model_aux(policy, model_cfg.get("tokenizer")))
    return trainer


if __name__ == "__main__":
    main()
