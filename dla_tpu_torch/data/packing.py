"""Sequence packing: fill fixed-length rows with several examples
(``dla_tpu.data.packing``, the instruction part). Packed rows carry
``segment_ids`` (1, 2, ... per example, 0 = padding); the transformer
masks cross-segment attention and restarts positions per segment, so
packing is loss-equivalent to unpacked batches. Placement is the JAX
package's greedy first-fit, in Python (its native packer must match the
same Python loop bit for bit)."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from dla_tpu_torch.ops.losses import IGNORE_INDEX


def pack_first_fit_python(lengths: np.ndarray, max_length: int,
                          close_margin: int):
    """Greedy first-fit placement: (row per example, n_rows). A row
    closes once it cannot take ``close_margin`` more tokens."""
    assign = np.empty(len(lengths), np.int32)
    row_len: List[int] = []
    open_rows: List[int] = []
    for i, raw in enumerate(lengths):
        n = min(int(raw), max_length)
        placed = False
        for r in open_rows:
            if row_len[r] + n <= max_length:
                row_len[r] += n
                assign[i] = r
                placed = True
                break
        if not placed:
            row_len.append(n)
            open_rows.append(len(row_len) - 1)
            assign[i] = len(row_len) - 1
        open_rows = [r for r in open_rows
                     if row_len[r] + close_margin <= max_length]
    return assign, len(row_len)


class PackedInstructionDataset:
    """Rows of exactly ``max_length`` tokens packed from an
    ``InstructionDataset`` (same __len__/__getitem__/collate protocol).
    Only the example lengths are kept; a row's examples are tokenized
    again when the row is read (the JAX package's default ``lazy``
    mode)."""

    CLOSE_MARGIN = 8  # close rows that cannot take even a tiny example

    def __init__(self, base, max_length: int):
        self.max_length = max_length
        self.pad_token_id = base.tokenizer.pad_token_id
        self.base = base
        self.lengths = np.asarray(
            [min(int(base[i]["input_ids"].shape[0]), max_length)
             for i in range(len(base))], np.int32)
        assign, n_rows = pack_first_fit_python(
            self.lengths, max_length, self.CLOSE_MARGIN)
        self.rows: List[List[int]] = [[] for _ in range(n_rows)]
        for i, r in enumerate(assign):
            self.rows[int(r)].append(i)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        L = self.max_length
        input_ids = np.full(L, self.pad_token_id, np.int32)
        labels = np.full(L, IGNORE_INDEX, np.int32)
        attention_mask = np.zeros(L, np.int32)
        segment_ids = np.zeros(L, np.int32)  # 0 = padding segment
        pos = 0
        for si, i in enumerate(self.rows[idx], start=1):
            ex = {k: v[:L] for k, v in self.base[i].items()}
            n = ex["input_ids"].shape[0]
            input_ids[pos:pos + n] = ex["input_ids"]
            labels[pos:pos + n] = ex["labels"]
            # the next-token shift would otherwise train segment i's last
            # token to predict segment i+1's first token
            labels[pos] = IGNORE_INDEX
            attention_mask[pos:pos + n] = 1
            segment_ids[pos:pos + n] = si
            pos += n
        return {"input_ids": input_ids, "attention_mask": attention_mask,
                "labels": labels, "segment_ids": segment_ids}

    def collate(self, batch: Sequence[Dict[str, np.ndarray]]
                ) -> Dict[str, np.ndarray]:
        return {k: np.stack([ex[k] for ex in batch]) for k in batch[0]}

    def packing_efficiency(self) -> float:
        """Fraction of token slots holding real tokens (1.0 = perfect)."""
        total = len(self.rows) * self.max_length
        return int(self.lengths.sum()) / max(total, 1)
