"""Tokenized instruction, preference and teacher-rollout examples with the
reference's text contract and fixed batch shapes, and the evaluation's
plain prompt records (``dla_tpu.data.datasets``).

- template ``"{prompt}\\n\\n{response}{eos}"``; the tokens of
  ``"{prompt}\\n\\n"`` get label -100 when ``mask_prompt``
- batches are padded to a fixed ``max_length`` (input_ids -> pad id,
  attention_mask -> 0, labels -> -100), the JAX package's static shapes
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from dla_tpu_torch.data.jsonl import read_jsonl
from dla_tpu_torch.data.tokenizers import Tokenizer
from dla_tpu_torch.ops.losses import IGNORE_INDEX

PROMPT_TEMPLATE = "{prompt}\n\n"
FULL_TEMPLATE = "{prompt}\n\n{response}"


def encode_prompt_response(
    tokenizer: Tokenizer, prompt: str, response: str, max_length: int,
    mask_prompt: bool = True,
) -> Dict[str, np.ndarray]:
    """One example -> unpadded (input_ids, attention_mask, labels)."""
    prompt = prompt.strip()
    response = response.strip()
    full_ids = tokenizer.encode(
        FULL_TEMPLATE.format(prompt=prompt, response=response), add_eos=True)
    prompt_ids = tokenizer.encode(
        PROMPT_TEMPLATE.format(prompt=prompt), add_eos=False)
    full_ids = full_ids[:max_length]
    labels = list(full_ids)
    if mask_prompt:
        cut = min(len(prompt_ids), len(labels))
        labels[:cut] = [IGNORE_INDEX] * cut
    return {
        "input_ids": np.asarray(full_ids, np.int32),
        "attention_mask": np.ones(len(full_ids), np.int32),
        "labels": np.asarray(labels, np.int32),
    }


def pad_to(arr: np.ndarray, length: int, pad_value: int) -> np.ndarray:
    if arr.shape[0] >= length:
        return arr[:length]
    pad = np.full((length - arr.shape[0],) + arr.shape[1:], pad_value,
                  arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def pad_batch(examples: Sequence[Dict[str, np.ndarray]], pad_token_id: int,
              length: int) -> Dict[str, np.ndarray]:
    """Stack variable-length examples into fixed [B, length] arrays:
    input_ids -> pad_token_id, labels -> -100, any other key -> 0;
    scalar keys are stacked unpadded."""
    out: Dict[str, np.ndarray] = {}
    for key in examples[0]:
        vals = [ex[key] for ex in examples]
        if vals[0].ndim == 0:
            out[key] = np.stack(vals)
            continue
        pv = {"labels": IGNORE_INDEX, "input_ids": pad_token_id}.get(key, 0)
        out[key] = np.stack([pad_to(v, length, pv) for v in vals])
    return out


class _RecordDataset:
    """Records from a list or a JSONL path, tokenized on access; batches
    padded to ``max_length`` (``pad_batch``)."""

    def __init__(self, tokenizer: Tokenizer, max_length: int,
                 path: Optional[str] = None,
                 records: Optional[List[Dict[str, Any]]] = None):
        if records is None and path is None:
            raise ValueError(f"{type(self).__name__} needs records or a path")
        self.records = records if records is not None else read_jsonl(path)
        self.tokenizer = tokenizer
        self.max_length = max_length

    def __len__(self) -> int:
        return len(self.records)

    def collate(self, batch: Sequence[Dict[str, np.ndarray]]
                ) -> Dict[str, np.ndarray]:
        return pad_batch(batch, self.tokenizer.pad_token_id, self.max_length)


class InstructionDataset(_RecordDataset):
    """SFT examples: {prompt, response} records with prompt-masked
    labels."""

    def __init__(self, tokenizer: Tokenizer, max_length: int,
                 mask_prompt: bool = True, path: Optional[str] = None,
                 records: Optional[List[Dict[str, Any]]] = None):
        super().__init__(tokenizer, max_length, path, records)
        self.mask_prompt = mask_prompt

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        return encode_prompt_response(
            self.tokenizer, rec["prompt"], rec["response"],
            self.max_length, self.mask_prompt)


class PreferenceDataset(_RecordDataset):
    """Reward-model and DPO pairs: {prompt, chosen, rejected} records ->
    {"chosen": example, "rejected": example}, each side prompt-masked."""

    SIDES = ("chosen", "rejected")

    def __getitem__(self, idx: int) -> Dict[str, Dict[str, np.ndarray]]:
        rec = self.records[idx]
        return {side: encode_prompt_response(
            self.tokenizer, rec["prompt"], rec[side], self.max_length,
            mask_prompt=True) for side in self.SIDES}

    def collate(self, batch) -> Dict[str, Dict[str, np.ndarray]]:
        return {side: pad_batch([ex[side] for ex in batch],
                                self.tokenizer.pad_token_id, self.max_length)
                for side in self.SIDES}


class TeacherRolloutDataset(_RecordDataset):
    """Distillation examples: {prompt, teacher_response, reward?} records.
    Labels are the input ids (no prompt mask) and the scalar ``reward``
    (default 1.0) rides along as a 0-d fp32 array."""

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        ex = encode_prompt_response(
            self.tokenizer, rec["prompt"], rec["teacher_response"],
            self.max_length, mask_prompt=False)
        ex["labels"] = ex["input_ids"].copy()
        ex["reward"] = np.asarray(float(rec.get("reward", 1.0)), np.float32)
        return ex


class EvalPromptDataset:
    """Plain prompt records for evaluation, untokenized."""

    def __init__(self, path: str):
        self.records = read_jsonl(path)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.records[idx]
