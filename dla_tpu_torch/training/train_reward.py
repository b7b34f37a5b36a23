"""Reward-model training (phase 2) on the GPU, full-parameter.

The CLI of ``dla_tpu.training.train_reward`` with the same config:

  python -m dla_tpu_torch.training.train_reward \\
      --config config/reward_config.yaml [--overlay o.yaml] \\
      [--set key=value ...] [--resume]

Bradley-Terry pairwise loss over two backbone forwards per micro-batch
(chosen, rejected), dropout on the pooled feature during training; eval
reports loss and preference accuracy (chosen > rejected) without
dropout. ``data.packing`` packs pairs jointly: rewards pool per segment
and the pair mean is weighted by the batch's pair mask. The model warm-
starts from a causal-LM checkpoint (``model.base_model_name_or_path``,
``checkpoints/sft/latest`` after SFT) with a fresh head. LoRA
(``model.lora``) is not ported yet and raises (ROADMAP.md), as do HF data
sources.
"""
from __future__ import annotations

from typing import Any, Dict

from dla_tpu_torch.data.iterator import ShardedBatchIterator
from dla_tpu_torch.data.loaders import build_preference_splits
from dla_tpu_torch.ops.losses import masked_mean, pairwise_reward_loss
from dla_tpu_torch.training.config import config_from_args, make_arg_parser
from dla_tpu_torch.training.model_io import build_reward_model, model_aux
from dla_tpu_torch.training.trainer import Trainer
from dla_tpu_torch.training.utils import seed_everything


def _rewards(model, params, batch, n_segments: int, generator=None):
    """(chosen, rejected) rewards of a (possibly packed) batch, each
    side's dropout drawn in turn from ``generator``."""
    out = []
    for side in ("chosen", "rejected"):
        sub = batch[side]
        kw: Dict[str, Any] = {}
        if n_segments:
            kw = {"segment_ids": sub["segment_ids"],
                  "n_segments": n_segments}
        out.append(model.apply(params, sub["input_ids"],
                               sub["attention_mask"], generator=generator,
                               **kw))
    return out


def make_reward_loss(model, n_segments: int = 0):
    """``n_segments`` > 0: packed rows, [B, n_segments] rewards and the
    pair mask weighting every mean."""
    def loss_fn(params, frozen, batch, rng):
        del frozen
        chosen, rejected = _rewards(model, params, batch, n_segments, rng)
        pv = batch.get("pair_mask") if n_segments else None
        loss = pairwise_reward_loss(chosen, rejected, valid=pv)
        return loss, {"acc": masked_mean((chosen > rejected).float(), pv),
                      "reward_margin": masked_mean(chosen - rejected, pv)}
    return loss_fn


def make_reward_eval(model, n_segments: int = 0):
    """The eval loss: no dropout; loss and accuracy."""
    def eval_fn(params, frozen, batch, rng):
        del frozen, rng
        chosen, rejected = _rewards(model, params, batch, n_segments)
        pv = batch.get("pair_mask") if n_segments else None
        loss = pairwise_reward_loss(chosen, rejected, valid=pv)
        return loss, {"acc": masked_mean((chosen > rejected).float(), pv)}
    return eval_fn


def main(argv=None, device="cuda") -> Trainer:
    args = make_arg_parser("dla_tpu_torch reward-model trainer").parse_args(
        argv)
    config = config_from_args(args)
    generator = seed_everything(int(config.get("seed", 0)), device)
    model_cfg: Dict[str, Any] = config.get("model", {})
    bundle = build_reward_model(model_cfg, generator, device=device)
    train_ds, eval_ds, n_segments = build_preference_splits(
        config, bundle.tokenizer, bundle.config.max_seq_length)
    trainer = Trainer(config=config,
                      loss_fn=make_reward_loss(bundle.model, n_segments),
                      eval_fn=make_reward_eval(bundle.model, n_segments),
                      params=bundle.params)
    train_it = ShardedBatchIterator(train_ds, trainer.global_batch,
                                    seed=int(config.get("seed", 0)))
    eval_iter_fn = None
    if eval_ds is not None:
        def eval_iter_fn():
            return iter(ShardedBatchIterator(eval_ds, trainer.micro,
                                             shuffle=False))
    trainer.fit(train_it, eval_iter_fn=eval_iter_fn,
                data_state=train_it.state_dict, resume=args.resume,
                extra_aux=model_aux(bundle, model_cfg.get("tokenizer")))
    return trainer


if __name__ == "__main__":
    main()
