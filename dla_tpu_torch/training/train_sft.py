"""Supervised fine-tuning (phase 1) on the GPU, full-parameter.

The CLI of ``dla_tpu.training.train_sft`` with the same config:

  python -m dla_tpu_torch.training.train_sft --config config/sft_config.yaml \\
      [--overlay o.yaml] [--set key=value ...] [--resume]

Next-token CE on "{prompt}\\n\\n{response}{eos}" with prompt-masked labels
(the fused, chunked CE: no [B, T, V] logits), optional sequence packing
(``data.packing``), gradient accumulation, global-norm clipping, AdamW
(betas 0.9/0.95) on a warmup-cosine schedule, periodic eval (mean loss
over the eval split) and checkpoints, ``final/`` at the end. LoRA
(``model.lora``) is not ported yet and raises, as do HF data sources.
"""
from __future__ import annotations

from typing import Any, Dict

from dla_tpu_torch.data.iterator import ShardedBatchIterator
from dla_tpu_torch.data.loaders import build_instruction_dataset
from dla_tpu_torch.data.packing import PackedInstructionDataset
from dla_tpu_torch.ops.fused_ce import model_fused_ce
from dla_tpu_torch.training.config import config_from_args, make_arg_parser
from dla_tpu_torch.training.model_io import load_causal_lm, model_aux
from dla_tpu_torch.training.trainer import Trainer
from dla_tpu_torch.training.utils import seed_everything


def make_sft_loss(model):
    def loss_fn(params, frozen, batch, rng):
        del frozen, rng
        loss, n_tokens = model_fused_ce(model, params, batch)
        return loss, {"ce": loss, "tokens": n_tokens}
    return loss_fn


def build_train_iterator(config: Dict[str, Any], tokenizer,
                         max_seq_length: int,
                         global_batch: int) -> ShardedBatchIterator:
    """The training split as the CLI feeds it: tokenized, packed into
    ``max_seq_length`` rows when ``data.packing`` is set, and shuffled
    per epoch from ``config["seed"]``."""
    data_cfg = {**config.get("data", {}), "max_seq_length": max_seq_length}
    train_ds = build_instruction_dataset(data_cfg, tokenizer, "train")
    if data_cfg.get("packing"):
        train_ds = PackedInstructionDataset(train_ds, max_seq_length)
        print(f"[dla_tpu_torch] packing: {len(train_ds)} rows, "
              f"{train_ds.packing_efficiency():.1%} token efficiency",
              flush=True)
    return ShardedBatchIterator(train_ds, global_batch,
                                seed=int(config.get("seed", 0)))


def main(argv=None, device="cuda") -> Trainer:
    args = make_arg_parser("dla_tpu_torch SFT trainer").parse_args(argv)
    config = config_from_args(args)
    seed = int(config.get("seed", 0))
    generator = seed_everything(seed, device)
    model_cfg: Dict[str, Any] = config.get("model", {})
    bundle = load_causal_lm(model_cfg.get("model_name_or_path", "tiny"),
                            model_cfg, generator, device=device)
    loss_fn = make_sft_loss(bundle.model)
    trainer = Trainer(config=config, loss_fn=loss_fn, params=bundle.params)

    max_len = bundle.config.max_seq_length
    train_it = build_train_iterator(config, bundle.tokenizer, max_len,
                                    trainer.global_batch)

    data_cfg = {**config.get("data", {}), "max_seq_length": max_len}
    eval_iter_fn = None
    if data_cfg.get("eval_path"):
        eval_ds = build_instruction_dataset(data_cfg, bundle.tokenizer,
                                            "eval")

        def eval_iter_fn():
            return iter(ShardedBatchIterator(eval_ds, trainer.micro,
                                             shuffle=False))

    trainer.fit(train_it, eval_iter_fn=eval_iter_fn,
                data_state=train_it.state_dict, resume=args.resume,
                extra_aux=model_aux(bundle, model_cfg.get("tokenizer")))
    return trainer


if __name__ == "__main__":
    main()
