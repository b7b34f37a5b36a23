"""Build, load and count the port's CUDA kernels.

The sources under ``dla_tpu_torch/csrc`` are compiled at first use with
``nvcc`` for ``sm_90a`` — one ``nvcc -c`` per source, all started
together, then one link — into ``libdla_kernels.so`` under
``build/kernels/<hash of sources and flags>/`` at the repository root,
and loaded with ``ctypes`` (a plain C interface: no PyTorch headers, so
a build takes seconds, not minutes). Nothing here runs at import time;
the CPU tests import every module without a compiler or a card.

``LAUNCHES`` counts, per kernel name, the calls of each wrapper that
launched its kernel — one shared tally for the process, read and reset
by whoever drives a run (``launch_counts`` / ``reset_launch_counts``).
A call made while a CUDA graph is captured counts once, as it records
its launch into the graph; the graph's replays run with no Python and
count nothing here (a profiler's trace of the card counts them).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libdla_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: "collections.Counter[str]" = collections.Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, w, scale, out, M, N, K, tile_n, splits, stream
    "dla_int8_matmul_decode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # tile_n -> dynamic shared memory bytes per block
    "dla_int8_matmul_decode_smem_bytes": [_I],
    # x, w, scale, out, M, N, K, stream
    "dla_int8_matmul_tma": [_P, _P, _P, _P, _I, _I, _I, _P],
    # -> dynamic shared memory bytes per block
    "dla_int8_matmul_smem_bytes": [],
    # q, k, v, qseg, kseg, out, lse, B, H, KH, T, S, D, strides, scale,
    # window, SMs, stream
    "dla_flash_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      ctypes.POINTER(ctypes.c_longlong), _F, _I, _I, _P],
    # D -> dynamic shared memory bytes per block of the forward
    "dla_flash_fwd_smem_bytes": [_I],
    # q, k, v, out, dout, lse, qseg, kseg, dq, delta (out), B, H, KH, T,
    # S, D, strides, scale, window, stream
    "dla_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, ctypes.POINTER(ctypes.c_longlong), _F,
                         _I, _P],
    # q, k, v, dout, lse, delta, qseg, kseg, dk, dv, B, H, KH, T, S, D,
    # strides, scale, window, stream
    "dla_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong),
                          _F, _I, _P],
    # dkv (0: the dQ kernel), D -> dynamic shared memory bytes per block
    "dla_flash_bwd_smem_bytes": [_I, _I],
    # -> the least status of a failed tensor-map encode
    "dla_map_error_base": [],
    # q, kc, vc, ks, vs, kn, vn, bias, out, fill (device int32 or null),
    # B, S, K, G, D, fill (host), split, cache_int8, scale, softcap,
    # out_bf16, stream
    "dla_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    # D, cache_int8 -> dynamic shared memory bytes per block
    "dla_decode_attention_smem_bytes": [_I, _I],
    # logits, key (or null), seeds, positions (or null), partial values,
    # partial indices, out, noise (or null), B, V, stream
    "dla_categorical_draw": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # V -> partials per row
    "dla_categorical_draw_chunks": [_I],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Tuple[Path, str]:
    """Compile the kernels (if this exact source set was not built
    before) and return (library path, compiler log with ptxas resource
    usage). Raises RuntimeError with the compiler's output on failure."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    log_file = out_dir / "build.log"
    if lib.is_file():
        return lib, log_file.read_text() if log_file.is_file() else ""
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix=".tmp-", dir=BUILD_ROOT))
    try:
        sources = sorted(CSRC.glob("*.cu"))

        def compile_one(src: Path) -> subprocess.CompletedProcess:
            return subprocess.run(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                 str(tmp / (src.stem + ".o"))],
                capture_output=True, text=True)

        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            results = list(pool.map(compile_one, sources))
        log = []
        for src, res in zip(sources, results):
            log.append(f"== {src.name}\n{res.stdout}{res.stderr}")
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n"
                                   f"{res.stdout}{res.stderr}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *(str(tmp / (s.stem + ".o")) for s in sources)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        text = "\n".join(log)
        (tmp / "build.log").write_text(text)
        try:
            tmp.rename(out_dir)
        except OSError:
            if not lib.is_file():  # not a concurrent build that won
                raise
        return lib, text
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero status returned by a launch function: a
    cudaGetLastError() code, or a tensor-map encode failure (a status at
    or above the library's ``dla_map_error_base()``: that base plus the
    encode's CUresult)."""
    if status == 0:
        return
    base = library().dla_map_error_base()
    if status >= base:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {status - base}")
    raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                       f"{status}")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The multiprocessor count of a CUDA device, read once per device."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count
