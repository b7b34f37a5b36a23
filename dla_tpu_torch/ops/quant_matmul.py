"""int8 weight-only matmul: ``x @ (w * wscale)`` -> bf16.

``Transformer.quantize_weights`` stores rollout weights as int8 with
per-output-channel fp32 scales. On the card ``int8_matmul`` launches a
hand-written kernel of ``csrc/int8_matmul.cu`` (the counterpart of
``dla_tpu.ops.quant_matmul``'s Pallas kernel), which reads the int8
bytes and converts them on chip, so a decode step's weight traffic is
the int8 bytes and nothing else. ``plan`` picks the kernel from the
shape: M > 64 (prefill) the TMA + wgmma kernel at 128 x 256 output
tiles; M <= 64 (decode: M is the batch) the TMA + wgmma decode kernel,
whose blocks split K inside a thread-block cluster and sum the splits
through distributed shared memory (one launch, nothing allocated but
the output, so a CUDA graph of the decode step captures it as it is).
On CPU tensors it computes ``int8_matmul_plain``: the same function
with the same casts (x -> bf16, w -> bf16 exactly, fp32 accumulation,
fp32 scale on the product, one bf16 rounding).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dla_tpu_torch.ops import _native

NAME = "int8_matmul"
_DECODE_ROWS = 64  # most x rows of the decode kernel (its wgmma's N)
_K_TILE = 64      # K depth of a ring stage (both kernels)
# the decode kernel's blocks: (output columns, most K splits = the
# largest cluster they run in)
_DECODE_TILES = ((128, 4), (64, 16))


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                      wscale: torch.Tensor) -> torch.Tensor:
    """Reference version: [..., K] x [K, N] int8 x [N] or [1, N] fp32 ->
    [..., N] bf16."""
    xb = x.to(torch.bfloat16).float()
    acc = xb @ w.float()     # int8 -> bf16 is exact, so -> fp32 is too
    return (acc * wscale.reshape(-1).float()).to(torch.bfloat16)


class Plan(NamedTuple):
    path: str     # "tma" (prefill, M > 64) or "decode" (M <= 64)
    splits: int   # K splits, the blocks of a cluster (1 on the TMA path)
    tile_n: int   # output columns of a block


def plan(m: int, n: int, k: int, sms: int) -> Plan:
    """The kernel, block width and K splits for x [m, k] @ w [k, n] on a
    card with ``sms`` multiprocessors. M > 64 takes the TMA kernel
    (128 x 256 tiles, rows past M read as zeros). M <= 64 takes the
    decode kernel with the widest
    block (128 columns, else 64) whose output tiles, K split in powers
    of two (at most 4 ways for 128 columns, where a larger cluster's sum
    costs more than the wider block saves, 16 for 64, and never more
    than the 64-deep K tiles, so no split is empty), put a block on
    every SM; a product too small for that gets 64-column blocks and the
    most splits its K allows."""
    if m > _DECODE_ROWS:
        return Plan("tma", 1, 256)
    k_tiles = max(1, -(-k // _K_TILE))
    for tile_n, most in _DECODE_TILES:
        tiles = -(-n // tile_n)
        splits = 1
        while tiles * splits < sms and splits * 2 <= min(most, k_tiles):
            splits *= 2
        if tiles * splits >= sms:
            return Plan("decode", splits, tile_n)
    return Plan("decode", splits, tile_n)


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                wscale: torch.Tensor) -> torch.Tensor:
    """``x @ (w * wscale)`` in bf16. x [..., K] (any float dtype, cast to
    bf16 as the TPU kernel does), w [K, N] int8, wscale [N] or [1, N]
    fp32. CPU tensors take ``int8_matmul_plain``; CUDA tensors launch the
    kernel or raise."""
    if w.dtype != torch.int8:
        raise ValueError(f"int8_matmul needs int8 weights, got {w.dtype}")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, wscale)
    if x.device.type != "cuda" or w.device != x.device \
            or wscale.device != x.device:
        raise ValueError("int8_matmul: x, w and wscale must share one CUDA "
                         f"device, got {x.device}, {w.device}, "
                         f"{wscale.device}")
    k, n = w.shape
    if x.shape[-1] != k or wscale.numel() != n:
        raise ValueError(f"int8_matmul: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, scale {tuple(wscale.shape)}")
    if k % 8 or n % 16:
        raise ValueError(f"int8_matmul kernel needs K % 8 == 0 and N % 16 "
                         f"== 0 (16-byte rows), got K={k}, N={n}")
    if wscale.dtype != torch.float32:
        raise ValueError(f"int8_matmul: scale must be fp32, got "
                         f"{wscale.dtype}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(torch.bfloat16).contiguous()
    w = w.contiguous()
    wscale = wscale.reshape(-1).contiguous()
    for t in (x2, w, wscale):
        if t.data_ptr() % 16:
            raise ValueError("int8_matmul: operands must be 16-byte aligned")
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0 or k == 0:     # an empty product: nothing to launch
        return out.zero_().reshape(*lead, n)
    p = plan(m, n, k, _native.sm_count(x.device))
    lib = _native.library()
    stream = _native.stream_handle(x.device)
    if p.path == "tma":
        status = lib.dla_int8_matmul_tma(
            x2.data_ptr(), w.data_ptr(), wscale.data_ptr(), out.data_ptr(),
            m, n, k, stream)
    else:
        status = lib.dla_int8_matmul_decode(
            x2.data_ptr(), w.data_ptr(), wscale.data_ptr(), out.data_ptr(),
            m, n, k, p.tile_n, p.splits, stream)
    _native.check(status, NAME)
    _native.LAUNCHES[NAME] += 1
    return out.reshape(*lead, n)
