"""JSONL IO for the data loaders, the generation CLI and the metrics log:
the same on-disk contract and record striding as ``dla_tpu.data.jsonl``
(pure-Python line iteration; the JAX package's native byte-range indexer
returns identical records)."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterable, List, Union

PathLike = Union[str, Path]


def read_jsonl(path: PathLike, shard_index: int = 0,
               shard_count: int = 1) -> List[Dict[str, Any]]:
    """Parse a JSONL file; with ``shard_count > 1`` return only records
    ``shard_index::shard_count`` (by non-empty-line position)."""
    if shard_count < 1:
        raise ValueError(f"shard_count must be >= 1, got {shard_count}")
    if not 0 <= shard_index < shard_count:
        raise ValueError(
            f"shard_index must be in [0, {shard_count}), got {shard_index}"
            " — a misconfigured fan-out would silently produce nothing")
    out: List[Dict[str, Any]] = []
    pos = 0
    with Path(path).open("r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                if pos % shard_count == shard_index:
                    out.append(json.loads(line))
                pos += 1
    return out


def write_jsonl(path: PathLike, records: Iterable[Dict[str, Any]]) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("w", encoding="utf-8") as fh:
        for rec in records:
            fh.write(json.dumps(rec, ensure_ascii=False) + "\n")


def append_jsonl(path: PathLike, record: Dict[str, Any]) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("a", encoding="utf-8") as fh:
        fh.write(json.dumps(record, ensure_ascii=False) + "\n")
