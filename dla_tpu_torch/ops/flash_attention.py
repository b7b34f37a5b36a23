"""Causal flash attention, forward only.

``flash_causal_attention`` takes ``dla_tpu.ops.flash_attention``'s public
layout (q [B, T, H, D], k/v [B, S, KH, D]) and returns [B, T, H, D]. On
the card it launches the hand-written kernel in ``csrc/flash_fwd.cu``
(blockwise online softmax, O(T) memory, per-row log-sum-exp emitted for
the backward that comes with training); the kernel reads the public
layout through strides, so no transpose copies are made. On CPU tensors
it computes ``flash_forward_plain``, the same function with the same
casts: scores in fp32 from operands in the input dtype, probabilities
cast to v's dtype for the value product, fully masked rows -> 0 with
lse -1e30.

Masking is the Pallas kernel's: causal on the global index, optional
sliding window (q attends (q - window, q]), optional segment ids
(attend only equal ids; packing numbers segments from 1, pads 0). The
TPU's lane/sublane broadcast of the segment ids is layout, not
semantics: here they are plain [B, T] / [B, S] int32 rows.

No autograd yet: with grad enabled and an input that requires grad the
function raises rather than return a result the backward cannot follow.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dla_tpu_torch.ops import _native

NAME = "flash_attention_fwd"
NEG_INF = -1e30


def flash_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference version: (out [B, T, H, D] in q's dtype, lse [B, H, T]
    fp32)."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qg = q.float().reshape(b, t, kh, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    q_pos = torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    mask = (q_pos >= k_pos)[None]                          # [1, T, S]
    if window is not None:
        mask = mask & (q_pos - k_pos < window)[None]
    if segment_ids is not None:
        kseg = segment_ids if kv_segment_ids is None else kv_segment_ids
        mask = mask & (segment_ids[:, :, None] == kseg[:, None, :])
    mask = mask[:, None, None]                             # [B|1,1,1,T,S]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    lsum = p.sum(dim=-1, keepdim=True)
    safe = torch.where(lsum == 0, torch.ones_like(lsum), lsum)
    pv = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(), v.float())
    out = pv / safe[..., 0].permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(safe))[..., 0].reshape(b, h, t)
    return out.reshape(b, t, h, d).to(q.dtype), lse


def _check_grad(*ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "flash_causal_attention is forward-only until the backward "
            "kernels are ported with training; run under torch.no_grad()")


def flash_attention_forward(
    q: torch.Tensor,   # [B, T, H, D]
    k: torch.Tensor,   # [B, S, KH, D]
    v: torch.Tensor,   # [B, S, KH, D]
    *,
    segment_ids: Optional[torch.Tensor] = None,     # [B, T]
    kv_segment_ids: Optional[torch.Tensor] = None,  # [B, S]
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, T, H, D], lse [B, H, T] fp32). CPU tensors take
    ``flash_forward_plain``; CUDA tensors launch the kernel or raise."""
    _check_grad(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"sliding window must be positive, got {window}")
    kw = dict(segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
              softmax_scale=softmax_scale, window=window)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, **kw)
    b, t, h, d = q.shape
    _, s, kh, _ = k.shape
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash attention: q, k, v must share one CUDA "
                         "device")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention kernel takes bf16 q/k/v, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in (64, 96, 128):
        raise ValueError(f"flash attention kernel takes head_dim 64, 96 or "
                         f"128, got {d}")
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d or h % kh:
        raise ValueError(f"flash attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(x.stride(i) % 8 for i in range(3)) \
                or x.data_ptr() % 16:
            raise ValueError(f"flash attention: {name} needs a contiguous "
                             "head dim, 8-element strides and 16-byte "
                             "alignment")
    qseg = kseg = None
    if segment_ids is not None:
        qseg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        kseg = (qseg if kv_segment_ids is None else kv_segment_ids.to(
            device=q.device, dtype=torch.int32).contiguous())
        if qseg.shape != (b, t) or kseg.shape != (b, s):
            raise ValueError("flash attention: segment ids must be [B, T] "
                             "and [B, S]")
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    # element strides (batch, head, row) of each [B, rows, heads, D] view
    st = []
    for x in (q, k, v, out):
        st += [x.stride(0), x.stride(2), x.stride(1)]
    strides = (ctypes.c_longlong * 12)(*st)
    lib = _native.library()
    status = lib.dla_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if qseg is None else qseg.data_ptr(),
        None if kseg is None else kseg.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, h, kh, t, s, d, strides,
        float(scale), int(window or 0), _native.stream_handle(q.device))
    _native.check(status, NAME)
    _native.LAUNCHES[NAME] += 1
    return out, lse


def flash_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Drop-in for ``ops.attention.causal_attention`` on contiguous
    right-padded (or segment-packed) sequences: [B, T, H, D] out."""
    return flash_attention_forward(
        q, k, v, segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
        softmax_scale=softmax_scale, window=window)[0]
