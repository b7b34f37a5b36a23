"""Causal flash attention, forward and backward.

``flash_causal_attention`` takes ``dla_tpu.ops.flash_attention``'s public
layout (q [B, T, H, D], k/v [B, S, KH, D]) and returns [B, T, H, D]; it is
a ``torch.autograd.Function`` whose forward saves q, k, v, out, the
per-row log-sum-exp and the segment ids, and whose backward recomputes
the probabilities from them (the JAX package's ``custom_vjp``).

On the card the forward launches ``csrc/flash_fwd.cu`` and the backward
the two kernels of ``csrc/flash_bwd.cu``: dQ, which also writes delta =
rowsum(dO * O), then dK/dV summed over each GQA group, which reads it.
The kernels read the public layout through strides (the backward's
through TMA tensor maps built per call), so no transpose copies are
made. On CPU tensors the same wrappers compute
``flash_forward_plain`` / ``flash_backward_plain``, the same functions
with the Pallas kernels' casts: scores and dP in fp32 from operands in
the input dtype, probabilities cast to v's dtype for the value product,
dS cast to the input dtype before its products, fully masked rows -> 0
with lse -1e30 and no gradient.

Masking is the Pallas kernel's: causal on the global index, optional
sliding window (q attends (q - window, q]), optional segment ids
(attend only equal ids; packing numbers segments from 1, pads 0). The
TPU's lane/sublane broadcast of the segment ids is layout, not
semantics: here they are plain [B, T] / [B, S] int32 rows.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dla_tpu_torch.ops import _native

NAME = "flash_attention_fwd"
NAME_DQ = "flash_attention_bwd_dq"
NAME_DKV = "flash_attention_bwd_dkv"
NEG_INF = -1e30
# head dims the kernels take: 64 and 128 natively, 80 (phi-2) and 96
# (phi3-mini) through the 128-wide kernels
HEAD_DIMS = (64, 80, 96, 128)


def _mask(t: int, s: int, device, segment_ids, kv_segment_ids,
          window: Optional[int]) -> torch.Tensor:
    """[B|1, 1, 1, T, S] validity in the [B, KH, G, T, S] score layout."""
    q_pos = torch.arange(t, device=device)[:, None]
    k_pos = torch.arange(s, device=device)[None, :]
    mask = (q_pos >= k_pos)[None]                          # [1, T, S]
    if window is not None:
        mask = mask & (q_pos - k_pos < window)[None]
    if segment_ids is not None:
        kseg = segment_ids if kv_segment_ids is None else kv_segment_ids
        mask = mask & (segment_ids[:, :, None] == kseg[:, None, :])
    return mask[:, None, None]


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
    mask = _mask(t, s, q.device, segment_ids, kv_segment_ids, window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    lsum = p.sum(dim=-1, keepdim=True)
    safe = torch.where(lsum == 0, torch.ones_like(lsum), lsum)
    pv = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(), v.float())
    out = pv / safe[..., 0].permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(safe))[..., 0].reshape(b, h, t)
    return out.reshape(b, t, h, d).to(q.dtype), lse


def delta_rowsum(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in fp32, [B, H, T] (computed outside the Pallas
    kernels in the JAX package; on the card the dQ kernel computes it)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, *,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference version of the backward: (dq [B, T, H, D], dk, dv
    [B, S, KH, D]) in the inputs' dtypes, from the forward's out and lse."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    qg = q.float().reshape(b, t, kh, g, d)
    dog = dout.float().reshape(b, t, kh, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    mask = _mask(t, s, q.device, segment_ids, kv_segment_ids, window)
    lse_g = lse.reshape(b, kh, g, t)[..., None]
    # the exp only sees live entries: a fully masked row has lse -1e30
    p = torch.where(mask, torch.exp(torch.where(mask, scores - lse_g, 0.0)),
                    0.0)
    dp = torch.einsum("btkgd,bskd->bkgts", dog, v.float())
    delta = delta_rowsum(out, dout).reshape(b, kh, g, t)[..., None]
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = scale * torch.einsum("bkgts,bskd->btkgd", ds, k.float())
    dk = scale * torch.einsum("bkgts,btkgd->bskd", ds, qg)
    dv = torch.einsum("bkgts,btkgd->bskd", p.to(dout.dtype).float(), dog)
    return (dq.reshape(b, t, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_inputs(q, k, v) -> None:
    b, t, h, d = q.shape
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash attention: q, k, v must share one CUDA "
                         "device")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention kernel takes bf16 q/k/v, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim 64, 80, 96 "
                         f"or 128, got {d}")
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d \
            or h % k.shape[2]:
        raise ValueError(f"flash attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")


def _strided_ok(x: torch.Tensor) -> bool:
    return (x.stride(3) == 1 and not any(x.stride(i) % 8 for i in range(3))
            and x.data_ptr() % 16 == 0)


def _check_strides(**named: torch.Tensor) -> None:
    for name, x in named.items():
        if not _strided_ok(x):
            raise ValueError(f"flash attention: {name} needs a contiguous "
                             "head dim, 8-element strides and 16-byte "
                             "alignment")


def _segments(q, k, segment_ids, kv_segment_ids):
    """int32 [B, T] / [B, S] ids on q's device, or (None, None)."""
    if segment_ids is None:
        return None, None
    b, t = q.shape[:2]
    s = k.shape[1]
    qseg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    kseg = (qseg if kv_segment_ids is None else kv_segment_ids.to(
        device=q.device, dtype=torch.int32).contiguous())
    if qseg.shape != (b, t) or kseg.shape != (b, s):
        raise ValueError("flash attention: segment ids must be [B, T] "
                         "and [B, S]")
    return qseg, kseg


def _strides(*xs: torch.Tensor):
    """Element strides (batch, head, row) of each [B, rows, heads, D]."""
    st = []
    for x in xs:
        st += [x.stride(0), x.stride(2), x.stride(1)]
    return (ctypes.c_longlong * len(st))(*st)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


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
    """(out [B, T, H, D], lse [B, H, T] fp32), no autograd. CPU tensors
    take ``flash_forward_plain``; CUDA tensors launch the kernel or
    raise."""
    if window is not None and window <= 0:
        raise ValueError(f"sliding window must be positive, got {window}")
    kw = dict(segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
              softmax_scale=softmax_scale, window=window)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, **kw)
    _check_inputs(q, k, v)
    _check_strides(q=q, k=k, v=v)
    b, t, h, d = q.shape
    _, s, kh, _ = k.shape
    qseg, kseg = _segments(q, k, segment_ids, kv_segment_ids)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    status = _native.library().dla_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(qseg), _ptr(kseg),
        out.data_ptr(), lse.data_ptr(), b, h, kh, t, s, d,
        _strides(q, k, v, out), float(scale), int(window or 0),
        _native.sm_count(q.device), _native.stream_handle(q.device))
    _native.check(status, NAME)
    _native.LAUNCHES[NAME] += 1
    return out, lse


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, *,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's out and lse. CPU tensors take
    ``flash_backward_plain``; CUDA tensors launch the dQ kernel (which
    also produces delta) and then the dK/dV kernel, or raise."""
    if window is not None and window <= 0:
        raise ValueError(f"sliding window must be positive, got {window}")
    if q.device.type == "cpu":
        return flash_backward_plain(
            q, k, v, out, lse, dout, segment_ids=segment_ids,
            kv_segment_ids=kv_segment_ids, softmax_scale=softmax_scale,
            window=window)
    if not _strided_ok(dout):       # autograd may hand over any layout
        dout = dout.contiguous()
    qseg, kseg = _segments(q, k, segment_ids, kv_segment_ids)
    lse = lse.contiguous()
    dq, delta = launch_bwd_dq(q, k, v, out, dout, lse, qseg, kseg,
                              softmax_scale, window)
    return (dq,) + launch_bwd_dkv(q, k, v, dout, lse, delta, qseg, kseg,
                                  softmax_scale, window)


def _check_bwd(q, k, v, dout, **rows: torch.Tensor) -> None:
    _check_inputs(q, k, v)
    _check_strides(q=q, k=k, v=v, dout=dout)
    b, t, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("flash attention backward: dout must match q")
    for name, x in rows.items():
        if x.shape != (b, h, t) or x.dtype != torch.float32 \
                or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"flash attention backward: {name} must be a "
                             "contiguous fp32 [B, H, T] on q's device")


def launch_bwd_dq(q, k, v, out, dout, lse, qseg, kseg,
                  softmax_scale: Optional[float], window: Optional[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dQ kernel of ``flash_attention_backward`` (int32 segment ids
    from ``_segments`` or None): (dq [B, T, H, D], delta [B, H, T] fp32),
    delta = rowsum(dout * out) for ``launch_bwd_dkv``, on CUDA inputs."""
    _check_bwd(q, k, v, dout, lse=lse)
    _check_strides(out=out)
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("flash attention backward: out must match q")
    b, t, h, d = q.shape
    _, s, kh, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    status = _native.library().dla_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), _ptr(qseg), _ptr(kseg),
        dq.data_ptr(), delta.data_ptr(), b, h, kh, t, s, d,
        _strides(q, k, v, out, dout, dq), float(scale), int(window or 0),
        _native.stream_handle(q.device))
    _native.check(status, NAME_DQ)
    _native.LAUNCHES[NAME_DQ] += 1
    return dq, delta


def launch_bwd_dkv(q, k, v, dout, lse, delta, qseg, kseg,
                   softmax_scale: Optional[float], window: Optional[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel of ``flash_attention_backward`` on CUDA inputs,
    after ``launch_bwd_dq`` on the same stream (its delta): (dk, dv)
    [B, S, KH, D], summed over each GQA group."""
    _check_bwd(q, k, v, dout, lse=lse, delta=delta)
    b, t, h, d = q.shape
    _, s, kh, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    dk = torch.empty((b, s, kh, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, s, kh, d), dtype=v.dtype, device=v.device)
    status = _native.library().dla_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(qseg), _ptr(kseg),
        dk.data_ptr(), dv.data_ptr(), b, h, kh, t, s, d,
        _strides(q, k, v, dout, dk, dv), float(scale), int(window or 0),
        _native.stream_handle(q.device))
    _native.check(status, NAME_DKV)
    _native.LAUNCHES[NAME_DKV] += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``_flash_attention_core`` custom_vjp: saves the
    inputs, out and lse; int segment ids carry no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, kv_segment_ids, softmax_scale,
                window):
        out, lse = flash_attention_forward(
            q, k, v, segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
            softmax_scale=softmax_scale, window=window)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids,
                              kv_segment_ids)
        ctx.softmax_scale, ctx.window = softmax_scale, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seg, kv_seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout, segment_ids=seg, kv_segment_ids=kv_seg,
            softmax_scale=ctx.softmax_scale, window=ctx.window)
        return dq, dk, dv, None, None, None, None


def flash_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Drop-in for ``ops.attention.causal_attention`` on contiguous
    right-padded (or segment-packed) sequences: [B, T, H, D] out,
    differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, segment_ids, kv_segment_ids,
                                 softmax_scale, window)
