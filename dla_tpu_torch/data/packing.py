"""Sequence packing: fill fixed-length rows with several examples
(``dla_tpu.data.packing``, the instruction, teacher-rollout and
preference parts). Packed rows carry ``segment_ids`` (1, 2, ... per
example, 0 = padding); the transformer
masks cross-segment attention and restarts positions per segment, so
packing is loss-equivalent to unpacked batches. Placement is the JAX
package's greedy first-fit, in Python (its native packer must match the
same Python loop bit for bit)."""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

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
        L = self.max_length    # per-example scalars (a reward) stay out
        return _pack_row([{k: v[:L] for k, v in self.base[i].items()
                           if v.ndim}
                          for i in self.rows[idx]], L, self.pad_token_id)

    def collate(self, batch: Sequence[Dict[str, np.ndarray]]
                ) -> Dict[str, np.ndarray]:
        return {k: np.stack([ex[k] for ex in batch]) for k in batch[0]}

    def packing_efficiency(self) -> float:
        """Fraction of token slots holding real tokens (1.0 = perfect)."""
        total = len(self.rows) * self.max_length
        return int(self.lengths.sum()) / max(total, 1)


class PackedTeacherDataset(PackedInstructionDataset):
    """Distillation rows packed from a ``TeacherRolloutDataset``: the
    instruction packer's rows, plus each row's ``reward`` as the
    token-weighted mean of its examples' rewards (the trainer re-weights
    its ``reward_mean`` by row fill, so the logged value is the corpus
    token-weighted mean under any packing)."""

    def __init__(self, base, max_length: int):
        super().__init__(base, max_length)
        self.rewards = np.asarray(
            [float(base.records[i].get("reward", 1.0))
             for i in range(len(base))], np.float32)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        row = super().__getitem__(idx)
        ex_idx = self.rows[idx]
        w = self.lengths[ex_idx].astype(np.float32)
        r = self.rewards[ex_idx]
        row["reward"] = np.asarray(
            float((w * r).sum() / max(w.sum(), 1.0)), np.float32)
        return row


def _pack_row(exs: Sequence[Dict[str, np.ndarray]], max_length: int,
              pad_token_id: int) -> Dict[str, np.ndarray]:
    """Examples laid end to end in one row: segment i + 1 holds example i
    (0 = padding); each segment's first label is masked, else the
    next-token shift would train the last token of one example to
    predict the first of the next."""
    L = max_length
    out = {"input_ids": np.full(L, pad_token_id, np.int32),
           "attention_mask": np.zeros(L, np.int32),
           "labels": np.full(L, IGNORE_INDEX, np.int32),
           "segment_ids": np.zeros(L, np.int32)}
    pos = 0
    for si, ex in enumerate(exs, start=1):
        n = ex["input_ids"].shape[0]
        out["input_ids"][pos:pos + n] = ex["input_ids"]
        out["labels"][pos:pos + n] = ex["labels"]
        out["labels"][pos] = IGNORE_INDEX
        out["attention_mask"][pos:pos + n] = 1
        out["segment_ids"][pos:pos + n] = si
        pos += n
    return out


class PackedPreferenceDataset:
    """Preference pairs packed jointly into rows of ``max_length`` tokens
    per side: pair i goes into the first open row where its chosen side
    fits the chosen row and its rejected side the rejected row, so
    segment j of a chosen row is the partner of segment j of the same
    rejected row. A row closes once either side cannot take
    ``CLOSE_MARGIN`` more tokens. Only the lengths are kept; a row's
    pairs are tokenized again when it is read.

    Items: ``chosen`` / ``rejected`` {input_ids, attention_mask, labels,
    segment_ids} [L] each, and ``pair_mask`` [max_pairs] (1.0 where pair
    j exists)."""

    CLOSE_MARGIN = 8

    def __init__(self, base, max_length: int):
        self.max_length = max_length
        self.pad_token_id = base.tokenizer.pad_token_id
        self.base = base
        lens = np.zeros((len(base), 2), np.int32)
        for i in range(len(base)):
            ex = base[i]
            lens[i] = [min(int(ex[side]["input_ids"].shape[0]), max_length)
                       for side in ("chosen", "rejected")]
        self.len_c, self.len_r = lens[:, 0], lens[:, 1]
        rows: List[List[int]] = []
        fill: List[List[int]] = []
        open_rows: List[int] = []
        for i, (lc, lr) in enumerate(lens.tolist()):
            for r in open_rows:
                if (fill[r][0] + lc <= max_length
                        and fill[r][1] + lr <= max_length):
                    rows[r].append(i)
                    fill[r][0] += lc
                    fill[r][1] += lr
                    break
            else:
                rows.append([i])
                fill.append([lc, lr])
                open_rows.append(len(rows) - 1)
            open_rows = [r for r in open_rows
                         if max(fill[r]) + self.CLOSE_MARGIN <= max_length]
        self.rows = rows
        self.max_pairs = max(len(r) for r in rows) if rows else 1

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        L = self.max_length
        exs = [self.base[i] for i in self.rows[idx]]
        pair_mask = np.zeros(self.max_pairs, np.float32)
        pair_mask[:len(exs)] = 1.0
        out: Dict[str, Any] = {
            side: _pack_row([{k: v[:L] for k, v in e[side].items()}
                             for e in exs], L, self.pad_token_id)
            for side in ("chosen", "rejected")}
        out["pair_mask"] = pair_mask
        return out

    def collate(self, batch) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            side: {k: np.stack([ex[side][k] for ex in batch])
                   for k in batch[0][side]}
            for side in ("chosen", "rejected")}
        out["pair_mask"] = np.stack([ex["pair_mask"] for ex in batch])
        return out

    def packing_efficiency(self) -> float:
        """Fraction of both sides' token slots holding real tokens."""
        total = 2 * len(self.rows) * self.max_length
        return (int(self.len_c.sum()) + int(self.len_r.sum())) / max(total, 1)


def pack_preference_splits(train_ds, eval_ds, max_length: int):
    """Pack the train and (optional) eval preference splits with one
    shared pair width, so one ``n_segments`` serves both. Returns
    (packed_train, packed_eval or None, n_segments)."""
    train_p = PackedPreferenceDataset(train_ds, max_length)
    eval_p = (PackedPreferenceDataset(eval_ds, max_length)
              if eval_ds is not None else None)
    n = max([train_p.max_pairs]
            + ([eval_p.max_pairs] if eval_p is not None else []))
    train_p.max_pairs = n
    if eval_p is not None:
        eval_p.max_pairs = n
    return train_p, eval_p, n
