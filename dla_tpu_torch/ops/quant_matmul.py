"""int8 weight-only matmul: ``x @ (w * wscale)`` -> bf16.

``Transformer.quantize_weights`` stores rollout weights as int8 with
per-output-channel fp32 scales. On the card ``int8_matmul`` launches a
hand-written kernel of ``csrc/int8_matmul.cu`` (the counterpart of
``dla_tpu.ops.quant_matmul``'s Pallas kernel), which reads the int8
bytes and converts them on chip, so a decode step's weight traffic is
the int8 bytes and nothing else. ``plan`` picks the kernel from the
shape: M >= 128 (prefill) the TMA + wgmma kernel at 128 x 256 output
tiles; smaller M (decode) the split-K mma.sync kernel,
which needs no tensor maps. On CPU tensors it computes
``int8_matmul_plain``: the same function with the same casts (x -> bf16,
w -> bf16 exactly, fp32 accumulation, fp32 scale on the product, one
bf16 rounding).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dla_tpu_torch.ops import _native

NAME = "int8_matmul"
_BLOCK = 64       # the split-K kernel's M/N/K tile
_TMA_ROWS = 128   # output rows of a TMA kernel block (two warpgroups)


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                      wscale: torch.Tensor) -> torch.Tensor:
    """Reference version: [..., K] x [K, N] int8 x [N] or [1, N] fp32 ->
    [..., N] bf16."""
    xb = x.to(torch.bfloat16).float()
    acc = xb @ w.float()     # int8 -> bf16 is exact, so -> fp32 is too
    return (acc * wscale.reshape(-1).float()).to(torch.bfloat16)


class Plan(NamedTuple):
    path: str     # "tma" (TMA + wgmma) or "splitk" (mma.sync, split K)
    splits: int   # K splits of the split-K path (1 on the TMA path)


def plan(m: int, n: int, k: int, sms: int) -> Plan:
    """The kernel and K splits for x [m, k] @ w [k, n] on a card with
    ``sms`` multiprocessors. M >= 128 takes the TMA kernel; smaller M
    the split-K kernel, K split so that at least one block lands on
    every SM, never into more splits than a quarter of its 64-deep K
    tiles (and at least 1)."""
    if m >= _TMA_ROWS:
        return Plan("tma", 1)
    tiles = -(-m // _BLOCK) * -(-n // _BLOCK)
    if tiles >= sms:
        return Plan("splitk", 1)
    k_tiles = -(-k // _BLOCK)
    return Plan("splitk", max(1, min(-(-sms // tiles), k_tiles // 4, 16)))


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
    for t in (x2, w):
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
        partial = torch.empty((p.splits, m, n) if p.splits > 1 else (1,),
                              dtype=torch.float32, device=x.device)
        status = lib.dla_int8_matmul(
            x2.data_ptr(), w.data_ptr(), wscale.data_ptr(), out.data_ptr(),
            partial.data_ptr(), m, n, k, p.splits, stream)
    _native.check(status, NAME)
    _native.LAUNCHES[NAME] += 1
    return out.reshape(*lead, n)
