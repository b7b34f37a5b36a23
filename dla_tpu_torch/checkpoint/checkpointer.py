"""Checkpoints in the format of ``dla_tpu.checkpoint`` (format 2).

``index.json``: whole leaves carry ``{file, shape, dtype}``; sharded
leaves carry ``{shape, dtype, shards: [{file, index: [[start, stop],
...]}]}``, one ``.npy`` per distinct shard region. Format-1 checkpoints
(whole-file only) are the one-shard case. Leaves are named by their
dotted tree path (``params.layers.wq``).

``load_tree_numpy`` reads any of them into host numpy trees.
``Checkpointer`` writes whole-leaf checkpoints the JAX package reads
(``step_XXXXXXXX/`` or a named tag, an atomic ``latest`` pointer,
keep-last-N) and restores them in place into a tree of tensors.

numpy has no bfloat16: a bf16 leaf is stored as npy 2-byte voids with
``dtype: bfloat16`` in the index (the JAX package's encoding) and is read
back widened to float32, which is exact; the caller casts it back.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SEP = "."


def _as_logical(arr: np.ndarray, dtype_str: str) -> np.ndarray:
    """Undo npy's void encoding of dtypes numpy lacks. bfloat16 is the
    top half of a float32, so shifting the raw bits widens it exactly."""
    if arr.dtype.kind != "V":
        return arr
    if dtype_str != "bfloat16":
        raise NotImplementedError(
            f"checkpoint leaf dtype {dtype_str!r} has no numpy counterpart")
    bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.uint32)
    return (bits << 16).view(np.float32)


def _normalize_index(idx, shape) -> Tuple[Tuple[int, int], ...]:
    """Index (tuple of slices) -> ((start, stop), ...) per dim."""
    out = []
    for sl, dim in zip(idx, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        out.append((start, stop))
    return tuple(out)


class _ShardReader:
    """Assemble arbitrary slices of a logical array from its shard files.

    Files are opened with mmap, so reading a slice touches only the bytes
    that overlap it."""

    def __init__(self, ckpt_dir: Path, meta: Dict[str, Any]):
        self.dir = ckpt_dir
        self.shape = tuple(meta["shape"])
        self.dtype_str = str(meta["dtype"])
        self.shards = meta["shards"]
        self._by_region = {
            tuple(tuple(se) for se in sh["index"]): sh["file"]
            for sh in self.shards}

    @classmethod
    def from_meta(cls, ckpt_dir: Path, meta: Dict[str, Any]) -> "_ShardReader":
        """Reader for either index format: a format-1 whole-file leaf is
        exactly the one-shard case."""
        if "shards" in meta:
            return cls(ckpt_dir, meta)
        whole = dict(meta)
        whole["shards"] = [{
            "file": meta["file"],
            "index": [[0, d] for d in meta["shape"]],
        }]
        return cls(ckpt_dir, whole)

    def _load(self, fname: str) -> np.ndarray:
        return _as_logical(np.load(self.dir / fname, mmap_mode="r"),
                           self.dtype_str)

    def read(self, idx) -> np.ndarray:
        """idx: tuple of slices into the global shape."""
        region = _normalize_index(idx, self.shape)
        exact = self._by_region.get(region)
        if exact is not None:  # fast path: slice == one shard file
            return np.asarray(self._load(exact))
        out_shape = tuple(stop - start for start, stop in region)
        out = None
        filled = 0
        for sh in self.shards:
            sh_region = [tuple(se) for se in sh["index"]]
            dst, src = [], []
            empty = False
            for (want_s, want_e), (have_s, have_e) in zip(region, sh_region):
                lo, hi = max(want_s, have_s), min(want_e, have_e)
                if lo >= hi:
                    empty = True
                    break
                dst.append(slice(lo - want_s, hi - want_s))
                src.append(slice(lo - have_s, hi - have_s))
            if empty:
                continue
            arr = self._load(sh["file"])
            if out is None:
                out = np.empty(out_shape, arr.dtype)
            out[tuple(dst)] = arr[tuple(src)]
            filled += math.prod(s.stop - s.start for s in dst)
        if out is None or filled < math.prod(out_shape):
            raise ValueError(
                f"shard files do not cover requested region {region} "
                f"of shape {self.shape}")
        return out

    def full(self) -> np.ndarray:
        return self.read(tuple(slice(0, d) for d in self.shape))


def _latest_tag(root: Path) -> Optional[str]:
    """The tag the ``latest`` pointer names, else the newest step_*."""
    latest = root / "latest"
    if latest.is_file():
        tag = latest.read_text().strip()
        if (root / tag).is_dir():
            return tag
    steps = sorted(d.name for d in root.glob("step_*") if d.is_dir())
    return steps[-1] if steps else None


def load_tree_numpy(ckpt_dir, prefix: Optional[str] = None
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a checkpoint's leaves as host numpy arrays, rebuilt into nested
    dicts from their path-encoded names. Returns (tree, aux)."""
    ckpt = resolve_checkpoint_dir(ckpt_dir)
    with (ckpt / "index.json").open() as fh:
        index = json.load(fh)
    tree: Dict[str, Any] = {}
    for path, meta in index["leaves"].items():
        if prefix is not None:
            if not path.startswith(prefix + SEP):
                continue
            rel = path[len(prefix) + 1:]
        else:
            rel = path
        node = tree
        keys = rel.split(SEP)
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _ShardReader.from_meta(ckpt, meta).full()
    return tree, index.get("aux", {})


def resolve_checkpoint_dir(path) -> Path:
    """Follow a ``latest`` pointer if ``path`` is a checkpoint root or ends
    in /latest (configs point at ``checkpoints/X/latest``)."""
    p = Path(path)
    if p.name == "latest":
        root = p.parent
        tag = _latest_tag(root)
        if tag is None:
            raise FileNotFoundError(f"No checkpoint under {root}")
        return root / tag
    if (p / "index.json").is_file():
        return p
    tag = _latest_tag(p) if p.is_dir() else None
    if tag:
        return p / tag
    raise FileNotFoundError(f"No checkpoint at {p}")


def is_checkpoint_path(path) -> bool:
    try:
        resolve_checkpoint_dir(path)
        return True
    except (FileNotFoundError, NotADirectoryError):
        return False


# ------------------------------------------------------------------ write


def flatten_tree(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(dotted path, leaf) pairs of nested dicts, in key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in tree.items():
        out += flatten_tree(v, f"{prefix}{SEP}{k}" if prefix else str(k))
    return out


def _host_array(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor as the array npy stores and the index's dtype name."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _leaf_filename(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.\-]", "_", path) + ".npy"


class Checkpointer:
    """Whole-leaf format-2 checkpoints under ``output_dir``: each save
    goes to a staging directory renamed into place, then ``latest``
    names it (write-aside + rename), then all but the newest
    ``keep_last_n`` ``step_*`` directories are removed."""

    def __init__(self, output_dir, keep_last_n: int = 3):
        self.dir = Path(output_dir)
        self.keep_last_n = keep_last_n

    def save(self, step: int, tree: Any, aux: Optional[Dict[str, Any]] = None,
             tag: Optional[str] = None) -> Path:
        tag = tag or f"step_{step:08d}"
        final = self.dir / tag
        tmp = self.dir / f".tmp_{tag}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        index = {"format": 2, "step": int(step), "aux": aux or {},
                 "leaves": {}}
        for path, leaf in flatten_tree(tree):
            arr, dtype = _host_array(leaf)
            fname = _leaf_filename(path)
            np.save(tmp / fname, arr)
            index["leaves"][path] = {"file": fname, "shape": list(arr.shape),
                                     "dtype": dtype}
        with (tmp / "index.json").open("w") as fh:
            json.dump(index, fh)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        latest_tmp = self.dir / ".latest.tmp"
        with latest_tmp.open("w") as fh:
            fh.write(tag)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(latest_tmp, self.dir / "latest")
        if self.keep_last_n > 0:
            steps = sorted(d for d in self.dir.glob("step_*") if d.is_dir())
            for old in steps[: max(0, len(steps) - self.keep_last_n)]:
                shutil.rmtree(old, ignore_errors=True)
        return final

    def latest_tag(self) -> Optional[str]:
        return _latest_tag(self.dir) if self.dir.is_dir() else None

    def peek_aux(self, tag: str) -> Dict[str, Any]:
        """A checkpoint's aux dict, without reading any leaf."""
        with (self.dir / tag / "index.json").open() as fh:
            return json.load(fh).get("aux", {})

    def restore(self, tree: Any, tag: Optional[str] = None
                ) -> Dict[str, Any]:
        """Copy a checkpoint's leaves in place into the tensors of
        ``tree`` (same paths and shapes; every leaf of ``tree`` must be
        present). Returns the aux dict."""
        tag = tag or self.latest_tag()
        if tag is None:
            raise FileNotFoundError(f"No checkpoint under {self.dir}")
        ckpt = self.dir / tag
        with (ckpt / "index.json").open() as fh:
            index = json.load(fh)
        for path, dst in flatten_tree(tree):
            meta = index["leaves"].get(path)
            if meta is None:
                raise KeyError(f"checkpoint {ckpt} has no leaf {path!r}")
            arr = _ShardReader.from_meta(ckpt, meta).full()
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{path}: checkpoint shape {arr.shape} != "
                                 f"{tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.array(arr)))
        return index.get("aux", {})
