"""Instruction, preference and teacher-rollout records from local JSONL,
alone or as a weighted mixture, and RLHF's bare prompts
(``dla_tpu.data.loaders``). HF-hub sources need the network and the
``datasets`` package and raise."""
from __future__ import annotations

import random
from typing import Any, Dict, List, Tuple

from dla_tpu_torch.data.datasets import (
    InstructionDataset,
    PreferenceDataset,
    TeacherRolloutDataset,
)
from dla_tpu_torch.data.jsonl import read_jsonl
from dla_tpu_torch.data.packing import pack_preference_splits
from dla_tpu_torch.data.tokenizers import Tokenizer

# keys of the outer data config a mixture entry never inherits: an entry
# names its own source
_SOURCE_KEYS = ("source", "hf_path", "hf_name", "path", "train_path",
                "eval_path", "prompt_path", "preference_path", "split",
                "train_split", "eval_split", "columns")


def _apply_limit(records: List[Dict[str, Any]], limit) -> List[Dict[str, Any]]:
    return records[: int(limit)] if limit else records


def _load_mixture(cfg: Dict[str, Any], split: str, loader
                  ) -> List[Dict[str, Any]]:
    """``data.mixture``: per-source fragments with a ``weight`` (default
    1.0), inheriting the outer config's shaping keys. The epoch holds
    ``mixture_size`` records (default: all sources' total) apportioned by
    largest remainder; undersized sources repeat after a seeded shuffle;
    the epoch order is shuffled with ``mixture_seed`` — the JAX package's
    draws exactly (Python's ``random`` seeded with the same strings)."""
    entries = cfg["mixture"]
    if not entries:
        raise ValueError("data.mixture is empty")
    outer = {k: v for k, v in cfg.items()
             if k not in ("mixture", "mixture_size", "mixture_seed")
             and k not in _SOURCE_KEYS}
    per = [loader({**outer, **e}, split) for e in entries]
    for e, recs in zip(entries, per):
        if not recs:
            raise ValueError(f"mixture source produced no records: {e}")
    weights = [max(0.0, float(e.get("weight", 1.0))) for e in entries]
    wsum = sum(weights)
    if wsum <= 0:
        raise ValueError("mixture weights sum to zero")
    total = int(cfg.get("mixture_size", sum(len(r) for r in per)))
    quotas = [w / wsum * total for w in weights]
    counts = [int(q) for q in quotas]
    rema = sorted(range(len(quotas)), key=lambda i: quotas[i] - counts[i],
                  reverse=True)
    for i in rema[: total - sum(counts)]:
        counts[i] += 1

    seed = int(cfg.get("mixture_seed", 0))
    out: List[Dict[str, Any]] = []
    for si, (recs, n) in enumerate(zip(per, counts)):
        order = list(range(len(recs)))
        random.Random(f"{seed}:src{si}").shuffle(order)
        out.extend(recs[order[i % len(recs)]] for i in range(n))
    random.Random(f"{seed}:epoch").shuffle(out)
    return out


def _local_records(cfg: Dict[str, Any], split: str,
                   train_keys: Tuple[str, ...]) -> List[Dict[str, Any]]:
    """Records of ``<split>_path`` (for train, else the first of
    ``train_keys`` set), cut to ``limit``."""
    if cfg.get("source", "local") == "hf":
        raise NotImplementedError(
            "data source 'hf' is not ported (it needs the network and the "
            "datasets package; ROADMAP.md §1): point data.train_path / "
            "eval_path at local JSONL")
    path = cfg.get(f"{split}_path")
    if path is None and split == "train":
        path = next((cfg[k] for k in train_keys if cfg.get(k)), None)
    if path is None:
        raise ValueError(f"No {split}_path in data config")
    return _apply_limit(read_jsonl(path), cfg.get("limit"))


def load_instruction_records(cfg: Dict[str, Any],
                             split: str = "train") -> List[Dict[str, Any]]:
    """{prompt, response} records from ``<split>_path`` (``path`` for
    train); ``data.mixture`` composes several sources for the train
    split only (eval stays the outer config's held-out file)."""
    if cfg.get("mixture") and split == "train":
        return _load_mixture(cfg, split, load_instruction_records)
    return _local_records(cfg, split, ("path",))


def load_preference_records(cfg: Dict[str, Any],
                            split: str = "train") -> List[Dict[str, Any]]:
    """{prompt, chosen, rejected} records from ``<split>_path`` (for
    train, else ``path`` or ``preference_path``); ``data.mixture`` as for
    instruction records."""
    if cfg.get("mixture") and split == "train":
        return _load_mixture(cfg, split, load_preference_records)
    return _local_records(cfg, split, ("path", "preference_path"))


def load_prompt_records(cfg: Dict[str, Any],
                        split: str = "train") -> List[str]:
    """Bare prompt strings for RLHF rollouts: the ``prompt`` of each
    record of ``prompt_path`` (else ``path``), cut to ``limit``, empty
    prompts dropped."""
    del split
    if cfg.get("source", "local") == "hf":
        raise NotImplementedError(
            "sampling source 'hf' is not ported (it needs the network and "
            "the datasets package; ROADMAP.md §1): set sampling.source=local "
            "and point sampling.prompt_path at local JSONL")
    path = cfg.get("prompt_path") or cfg.get("path")
    if path is None:
        raise ValueError("No prompt_path/path in sampling config")
    prompts = [r["prompt"] for r in read_jsonl(path)]
    return [p for p in _apply_limit(prompts, cfg.get("limit")) if p]


def build_instruction_dataset(cfg: Dict[str, Any], tokenizer: Tokenizer,
                              split: str = "train") -> InstructionDataset:
    return InstructionDataset(
        tokenizer=tokenizer,
        max_length=int(cfg.get("max_length",
                               cfg.get("max_seq_length", 2048))),
        mask_prompt=bool(cfg.get("mask_prompt", True)),
        records=load_instruction_records(cfg, split),
    )


def build_preference_dataset(cfg: Dict[str, Any], tokenizer: Tokenizer,
                             split: str = "train") -> PreferenceDataset:
    return PreferenceDataset(
        tokenizer=tokenizer,
        max_length=int(cfg.get("max_length",
                               cfg.get("max_seq_length", 1024))),
        records=load_preference_records(cfg, split),
    )


def build_teacher_dataset(cfg: Dict[str, Any], tokenizer: Tokenizer
                          ) -> TeacherRolloutDataset:
    """Teacher rollouts ({prompt, teacher_response, reward?}) from
    ``teacher_samples_path`` (else ``path``)."""
    return TeacherRolloutDataset(
        tokenizer=tokenizer,
        max_length=int(cfg.get("max_length",
                               cfg.get("max_seq_length", 2048))),
        path=cfg.get("teacher_samples_path") or cfg.get("path"),
    )


def build_preference_splits(config: Dict[str, Any], tokenizer: Tokenizer,
                            max_seq_length: int):
    """The preference phases' data: the train split, the eval split when
    ``data.eval_path`` is set, both packed when ``data.packing`` is.
    Returns (train, eval or None, n_segments; 0 when unpacked)."""
    cfg = {**config.get("data", {}), "max_seq_length": max_seq_length}
    train = build_preference_dataset(cfg, tokenizer, "train")
    evl = (build_preference_dataset(cfg, tokenizer, "eval")
           if cfg.get("eval_path") else None)
    if not cfg.get("packing"):
        return train, evl, 0
    train, evl, n = pack_preference_splits(train, evl, max_seq_length)
    print(f"[dla_tpu_torch] packing: {len(train)} pair-rows, "
          f"{train.packing_efficiency():.1%} token efficiency, <= {n} "
          f"pairs/row", flush=True)
    return train, evl, n
