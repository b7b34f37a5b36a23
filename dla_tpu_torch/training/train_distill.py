"""On-policy distillation (phase 4) on the GPU, full-parameter.

The CLI of ``dla_tpu.training.train_distill`` with the same config:

  python -m dla_tpu_torch.training.train_distill \\
      --config config/distill_config.yaml [--overlay o.yaml] \\
      [--set key=value ...] [--resume]

The student (``model.student_model_name_or_path``; the config's
``microsoft/phi-2`` resolves to the phi-2 preset) trains on teacher
rollouts (``data.teacher_samples_path``: {prompt, teacher_response,
reward?} JSONL, as ``generate_teacher_data`` writes it) in one of two
modes:

- default: next-token CE on the whole rollout (labels = input ids, no
  prompt mask) through the fused CE, the ``lm_head`` bias included;
- ``distill.use_kl`` and ``distill.on_policy``: forward KL(mean of
  teachers || student) at ``optimization.temperature``, a token-masked
  mean times T^2, through the fused KL. The teachers
  (``distill.teacher_model_names_or_paths``, else
  ``distill.teacher_model_name_or_path``, else ``model.teacher_path``)
  are the Trainer's frozen tree (``teacher_{i}``), run under
  ``torch.no_grad``, and must share the student's vocabulary.

Each sample's ``reward`` is logged as ``reward_mean`` (token-weighted
over packed rows), not used to weight the loss. ``data.packing`` packs
the rollouts into ``max_seq_length`` rows (segment ids to the flash
kernels; the KL skips each segment's first token). LoRA
(``model.lora``) is not ported yet and raises (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from dla_tpu_torch.data.iterator import ShardedBatchIterator
from dla_tpu_torch.data.loaders import build_teacher_dataset
from dla_tpu_torch.data.packing import PackedTeacherDataset
from dla_tpu_torch.ops.fused_ce import (
    fused_cross_entropy_loss,
    fused_kl_distill_loss,
    unembed_operands,
)
from dla_tpu_torch.training.config import config_from_args, make_arg_parser
from dla_tpu_torch.training.model_io import (
    load_causal_lm,
    load_teacher,
    model_aux,
)
from dla_tpu_torch.training.trainer import Trainer
from dla_tpu_torch.training.utils import seed_everything


def make_distill_loss(student_model, teacher_models: List[Any],
                      use_kl: bool, temperature: float):
    """``loss_fn(params, frozen, batch, rng)``: CE on the rollout tokens,
    or (``use_kl`` with teachers) the fused KL against the teachers'
    hidden states in ``frozen["teacher_{i}"]``. Metrics: ``reward_mean``
    and ``ce`` or ``kl``."""
    def loss_fn(params, frozen, batch, rng):
        del rng
        seg = batch.get("segment_ids")   # packed rows (data.packing)
        mask = batch["attention_mask"]
        h = student_model.hidden_states(params, batch["input_ids"],
                                        attention_mask=mask,
                                        segment_ids=seg)
        sw, sbias = unembed_operands(student_model, params)
        if seg is None:
            reward_mean = batch["reward"].float().mean()
        else:
            # packed rows carry token-weighted row means: weighted by row
            # fill this is the corpus token-weighted mean under any packing
            w = mask.sum(1).float()
            reward_mean = (batch["reward"] * w).sum() / (w.sum() + 1e-8)
        metrics = {"reward_mean": reward_mean}
        if use_kl and teacher_models:
            t_hiddens, t_ws, t_biases = [], [], []
            with torch.no_grad():
                for i, tm in enumerate(teacher_models):
                    tp = frozen[f"teacher_{i}"]
                    t_hiddens.append(tm.hidden_states(
                        tp, batch["input_ids"], attention_mask=mask,
                        segment_ids=seg))
                    tw, tb = unembed_operands(tm, tp)
                    t_ws.append(tw)
                    t_biases.append(tb)
            kl_mask = mask
            if seg is not None:
                # a packed segment's first token is the next-token target
                # of the previous segment's last position: the pair the
                # packer's label mask drops on the CE path
                start = torch.ones_like(seg)
                start[:, 1:] = (seg[:, 1:] != seg[:, :-1]).to(seg.dtype)
                kl_mask = mask * (1 - start)
            loss = fused_kl_distill_loss(
                h, sw, t_hiddens, t_ws, kl_mask, temperature,
                student_bias=sbias, teacher_biases=t_biases)
            metrics["kl"] = loss
        else:
            loss, _ = fused_cross_entropy_loss(h, sw, batch["labels"],
                                               sbias)
            metrics["ce"] = loss
        return loss, metrics
    return loss_fn


def build_train_iterator(config: Dict[str, Any], tokenizer,
                         max_seq_length: int,
                         global_batch: int) -> ShardedBatchIterator:
    """The rollouts as the CLI feeds them: tokenized, packed into
    ``max_seq_length`` rows when ``data.packing`` is set, and shuffled
    per epoch from ``config["seed"]``."""
    data_cfg = {**config.get("data", {}), "max_seq_length": max_seq_length}
    train_ds = build_teacher_dataset(data_cfg, tokenizer)
    if data_cfg.get("packing"):
        train_ds = PackedTeacherDataset(train_ds, max_seq_length)
        print(f"[dla_tpu_torch] packing: {len(train_ds)} rows, "
              f"{train_ds.packing_efficiency():.1%} token efficiency",
              flush=True)
    return ShardedBatchIterator(train_ds, global_batch,
                                seed=int(config.get("seed", 0)))


def main(argv=None, device="cuda") -> Trainer:
    args = make_arg_parser("dla_tpu_torch distillation trainer").parse_args(
        argv)
    config = config_from_args(args)
    seed = int(config.get("seed", 0))
    generator = seed_everything(seed, device)
    model_cfg: Dict[str, Any] = config.get("model", {})
    distill_cfg: Dict[str, Any] = config.get("distill", {})
    use_kl = bool(distill_cfg.get("use_kl")) and bool(
        distill_cfg.get("on_policy"))
    temperature = float(config.get("optimization", {})
                        .get("temperature", 1.0))
    student = load_causal_lm(
        model_cfg.get("student_model_name_or_path", "tiny"), model_cfg,
        generator, device=device)

    teachers, frozen = [], None
    if use_kl:
        # the ensemble list, else the one teacher, else model.teacher_path
        names = (distill_cfg.get("teacher_model_names_or_paths")
                 or [distill_cfg.get("teacher_model_name_or_path",
                                     model_cfg.get("teacher_path"))])
        frozen = {}
        for i, name in enumerate(n for n in names if n):
            tb = load_teacher(
                name, model_cfg, student.config.vocab_size,
                torch.Generator(device=device).manual_seed(seed + 1 + i),
                device=device)
            teachers.append(tb.model)
            frozen[f"teacher_{i}"] = tb.params
        print(f"[dla_tpu_torch] KL distillation from {len(teachers)} "
              f"teacher(s), T={temperature}", flush=True)
    trainer = Trainer(
        config=config,
        loss_fn=make_distill_loss(student.model, teachers, use_kl,
                                  temperature),
        params=student.params, frozen=frozen)

    train_it = build_train_iterator(config, student.tokenizer,
                                    student.config.max_seq_length,
                                    trainer.global_batch)
    trainer.fit(train_it, data_state=train_it.state_dict,
                resume=args.resume,
                extra_aux=model_aux(student, model_cfg.get("tokenizer")))
    return trainer


if __name__ == "__main__":
    main()
