"""The safetensors file format, read and written without the
``safetensors`` package (which the GPU machine does not have).

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` plus
an optional ``"__metadata__"`` of strings, padded with spaces to a
multiple of 8 bytes), then the tensors' raw little-endian bytes, each at
its offsets from the end of the header. A sharded weight directory adds
``model.safetensors.index.json``: ``{"metadata": {"total_size": ...},
"weight_map": {name: file}}``; ``load_dir`` reads its shards.

Reads map the file (``numpy.memmap``): a tensor is a view of the mapped
bytes until the caller copies it. numpy has no bfloat16, so a BF16
tensor comes back widened to float32 (exact), as the JAX package's
importer widens a torch bin's bf16 tensors.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np

INDEX_NAME = "model.safetensors.index.json"

# safetensors dtype code <-> numpy dtype (little-endian); BF16 is read as
# its 16-bit pattern and widened
_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
           "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1",
           "BOOL": "?"}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items() if k != "BF16"}


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _read_header(path):
    """(header length, the JSON header with ``__metadata__``)."""
    with Path(path).open("rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        return n, json.loads(fh.read(n))


def read_header(path) -> Dict[str, dict]:
    """The JSON header of one file, ``__metadata__`` included."""
    return _read_header(path)[1]


def load_file(path) -> Dict[str, np.ndarray]:
    """Every tensor of one file: {name: array}, each a view of the
    mapped file (BF16 widened to float32, a copy)."""
    path = Path(path)
    n, header = _read_header(path)
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n) \
        if path.stat().st_size > 8 + n else np.zeros(0, np.uint8)
    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        code = meta["dtype"]
        if code not in _DTYPES:
            raise NotImplementedError(
                f"{path}: tensor {name!r} has dtype {code}, which this "
                f"reader does not take ({sorted(_DTYPES)})")
        begin, end = meta["data_offsets"]
        shape = tuple(int(d) for d in meta["shape"])
        arr = data[begin:end].view(np.dtype(_DTYPES[code])).reshape(shape)
        out[name] = _bf16_to_f32(arr) if code == "BF16" else arr
    return out


def checkpoint_files(model_dir) -> list:
    """The safetensors files of a weight directory: the index's shards
    when ``model.safetensors.index.json`` is there, else every
    ``*.safetensors`` file, sorted."""
    model_dir = Path(model_dir)
    index = model_dir / INDEX_NAME
    if index.is_file():
        weight_map = json.loads(index.read_text())["weight_map"]
        files = [model_dir / f for f in sorted(set(weight_map.values()))]
        missing = [str(f) for f in files if not f.is_file()]
        if missing:
            raise FileNotFoundError(f"{index} names missing shards {missing}")
        return files
    return sorted(model_dir.glob("*.safetensors"))


def load_dir(model_dir) -> Dict[str, np.ndarray]:
    """All tensors of a weight directory's safetensors files."""
    out: Dict[str, np.ndarray] = {}
    for f in checkpoint_files(model_dir):
        out.update(load_file(f))
    return out


def _header_bytes(tensors: Dict[str, np.ndarray],
                  metadata: Optional[Dict[str, str]]) -> bytes:
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, arr in tensors.items():
        header[name] = {"dtype": _CODES[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return raw + b" " * (-len(raw) % 8)


def save_file(tensors: Dict[str, np.ndarray], path,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (numpy arrays of the dtypes above; names in the
    order given) to one file."""
    arrays = {}
    for name, arr in tensors.items():
        a = np.ascontiguousarray(arr)
        a = a.astype(a.dtype.newbyteorder("<"), copy=False)
        if a.dtype not in _CODES:
            raise ValueError(f"tensor {name!r}: dtype {a.dtype} has no "
                             "safetensors code here")
        arrays[name] = a
    header = _header_bytes(arrays, metadata)
    with Path(path).open("wb") as fh:
        fh.write(struct.pack("<Q", len(header)))
        fh.write(header)
        for a in arrays.values():   # the array's own bytes, no copy
            fh.write(a.reshape(-1).view(np.uint8).data)
