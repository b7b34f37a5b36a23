"""Attention ops without a kernel of their own.

``causal_attention`` and ``decode_attention`` are the einsum forms of
``dla_tpu.ops.attention``: fp32 scores from operands in the input dtype,
masked softmax in fp32, weights cast to v's dtype for the value product.
The model takes them where no kernel applies — prefill without the flash
backend, decode with ``decode_kernel="off"`` or a bf16 cache under
``"auto"``. ``chunked_causal_attention`` and ``block_decode_attention``
wait for the slices that run them (long-context training, speculative
decoding).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-but-finite: -inf breaks softmax rows that are fully masked


def _dot_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with fp32 accumulation of operands in their own dtype: bf16
    values are exact in fp32, so upcasting first gives products rounded
    only by the fp32 sum (the TPU's bf16-in / fp32-out contraction)."""
    return torch.einsum(eq, a.float(), b.float())


def causal_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, K, D]   K = num kv heads (GQA when K < H)
    v: torch.Tensor,  # [B, S, K, D]
    *,
    kv_segment_mask: Optional[torch.Tensor] = None,  # [B, T, S] 1=attend
    q_positions: Optional[torch.Tensor] = None,  # [B, T] absolute positions
    kv_positions: Optional[torch.Tensor] = None,  # [B, S]
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,  # sliding window: attend (q-window, q]
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Grouped-query causal attention on absolute positions. Returns
    [B, T, H, D] in v's dtype."""
    b, t, h, d = q.shape
    _, s, kheads, _ = k.shape
    groups = h // kheads
    scale = softmax_scale if softmax_scale is not None else d ** -0.5

    qg = q.reshape(b, t, kheads, groups, d)
    scores = _dot_f32("btkgd,bskd->bkgts", qg, k) * scale
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)

    if window is not None and not causal:
        raise ValueError("window implements causal sliding-window "
                         "semantics (q - window, q]; causal=False with a "
                         "window would silently attend the whole future")
    mask = None
    if causal or window is not None:
        if q_positions is None:
            q_positions = torch.arange(t, device=q.device)[None, :]
        if kv_positions is None:
            kv_positions = torch.arange(s, device=q.device)[None, :]
        delta = q_positions[:, :, None] - kv_positions[:, None, :]
        mask = delta >= 0 if causal else None
        if window is not None:
            win = delta < window
            mask = win if mask is None else (mask & win)
    if kv_segment_mask is not None:
        seg = kv_segment_mask.bool()
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores,
                             torch.full_like(scores, NEG_INF))

    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-30)
    out = _dot_f32("bkgts,bskd->btkgd", weights.to(v.dtype), v)
    return out.to(v.dtype).reshape(b, t, h, d)


def decode_attention(
    q: torch.Tensor,       # [B, 1, H, D]  the current token's query
    k_cache: torch.Tensor,  # [B, S, K, D]  cache BEFORE this step's write
    v_cache: torch.Tensor,  # [B, S, K, D]
    k_new: torch.Tensor,    # [B, 1, K, D]  this token's key (rotary applied)
    v_new: torch.Tensor,    # [B, 1, K, D]
    *,
    kv_valid: torch.Tensor,        # [B, S] valid cache columns (1=attend)
    q_positions: torch.Tensor,     # [B, 1] absolute position of the token
    kv_positions: torch.Tensor,    # [B, S] logical position per column
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Single-token attention over an un-updated KV cache plus the
    just-computed key/value (joint softmax with the new token's score
    column), without writing the cache. Returns [B, 1, H, D]."""
    b, t, h, d = q.shape
    assert t == 1, "decode_attention is single-token by construction"
    _, s, kheads, _ = k_cache.shape
    groups = h // kheads
    scale = softmax_scale if softmax_scale is not None else d ** -0.5

    qg = q.reshape(b, kheads, groups, d)
    scores = _dot_f32("bkgd,bskd->bkgs", qg, k_cache) * scale
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    delta = q_positions - kv_positions            # [B, S]
    mask = kv_valid.bool() & (delta >= 0)
    if window is not None:
        mask = mask & (delta < window)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    self_score = _dot_f32("bkgd,bkd->bkg", qg, k_new[:, 0])[..., None] * scale
    if logit_softcap:
        self_score = logit_softcap * torch.tanh(self_score / logit_softcap)

    joint = torch.cat([scores, self_score], dim=-1)  # [B,K,G,S+1]
    joint = joint - joint.amax(dim=-1, keepdim=True)
    weights = torch.exp(joint)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    w_cache = weights[..., :s].to(v_cache.dtype)
    w_self = weights[..., s:].to(v_new.dtype)           # [B,K,G,1]
    out = _dot_f32("bkgs,bskd->bkgd", w_cache, v_cache).to(v_cache.dtype)
    out = out + w_self * v_new[:, 0][:, :, None, :]
    return out.reshape(b, 1, h, d)
