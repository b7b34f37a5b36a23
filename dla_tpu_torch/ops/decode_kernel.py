"""Single-token decode attention with in-kernel KV dequantization.

``flash_decode_attention`` has ``dla_tpu.ops.decode_kernel``'s signature
and semantics: joint softmax over the UN-updated cache plus the new
token's k/v (the caller writes the cache once), masking from a
precomputed additive ``bias`` [B, S] (or built here from
kv_valid/positions/window), int8 caches with K-major [B, K, S] fp32
scales, and ``kv_fill``: every valid column sits below it, so columns at
or past it are neither read nor allowed to poison the result (they may
hold NaN). q, k_new and v_new are rounded to bf16; the result comes back
in v_new's dtype.

``kv_fill`` is a host int or a 0-dim int32 tensor on the inputs' device
(the decode step's write column, which it keeps on the card so that a
CUDA graph of the step reads the fill of each replay).

On the card it launches the hand-written kernel in ``csrc/decode_attn.cu``
(one launch whose grid depends on the shapes only; the kernel reads the
fill); on CPU tensors it computes ``flash_decode_attention_plain``, the
same function with the same casts (cache dequantized to bf16 with an
fp32 multiply, fp32 scores, softmax weights of cache columns rounded to
bf16 before the value product).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from dla_tpu_torch.ops import _native

NAME = "decode_attention"
NEG_INF = -1e30
_GMAX = 8        # query heads per kv head (the kernel's 8-wide mma operand)
_MAX_SPLIT = 8   # blocks per (batch, kv head) pair, one cluster
_MIN_COLS = 64   # cache columns a split block keeps at least


def decode_split(pairs: int, s: int, sms: int) -> int:
    """Blocks per (batch, kv head) pair for ``pairs`` pairs over a cache
    of ``s`` columns on a card with ``sms`` multiprocessors: 1 when the
    pairs alone put a block on every SM, else doubled until they do, at
    most 8 and keeping at least 64 columns a block."""
    split = 1
    while pairs * split < sms and \
            split * 2 <= min(_MAX_SPLIT, -(-s // _MIN_COLS)):
        split *= 2
    return split


def decode_bias(kv_valid: torch.Tensor, q_positions: torch.Tensor,
                kv_positions: torch.Tensor,
                window: Optional[int] = None) -> torch.Tensor:
    """Additive [B, S] fp32 mask: 0 where a column may be attended
    (valid, causal, inside the window), NEG_INF elsewhere."""
    delta = q_positions - kv_positions
    mask = kv_valid.bool() & (delta >= 0)
    if window is not None:
        mask = mask & (delta < window)
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, neg)


def _dequant(c: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, S, K, D] cache -> bf16 values as fp32; int8 takes K-major
    [B, K, S] scales (fp32 multiply, bf16 cast of the product)."""
    if scale is None:
        return c.to(torch.bfloat16).float()
    return (c.float() * scale.float().transpose(1, 2)[..., None]).to(
        torch.bfloat16).float()


def flash_decode_attention_plain(q, k_cache, v_cache, k_new, v_new, *,
                                 bias, k_scale=None, v_scale=None,
                                 kv_fill=None, softmax_scale=None,
                                 logit_softcap: float = 0.0) -> torch.Tensor:
    """Reference version (precomputed ``bias``). Returns [B, 1, H, D] in
    v_new's dtype."""
    b, _, h, d = q.shape
    _, s, kheads, _ = k_cache.shape
    g = h // kheads
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    bound = s if kv_fill is None else max(0, min(s, int(kv_fill)))

    def cap(x):
        return logit_softcap * torch.tanh(x / logit_softcap) \
            if logit_softcap else x

    qf = q.to(torch.bfloat16).float().reshape(b, kheads, g, d)
    kn = k_new.to(torch.bfloat16).float()[:, 0]            # [B, K, D]
    vn = v_new.to(torch.bfloat16).float()[:, 0]
    ks = k_scale[:, :, :bound] if k_scale is not None else None
    vs = v_scale[:, :, :bound] if v_scale is not None else None
    kc = _dequant(k_cache[:, :bound], ks)                  # [B, bound, K, D]
    vc = _dequant(v_cache[:, :bound], vs)
    scores = cap(torch.einsum("bkgd,bskd->bkgs", qf, kc) * scale)
    scores = scores + bias[:, None, None, :bound].float()
    s_self = cap(torch.einsum("bkgd,bkd->bkg", qf, kn) * scale)[..., None]
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), s_self) \
        if bound else s_self
    p = torch.exp(scores - m)
    e_self = torch.exp(s_self - m)
    l_sum = p.sum(dim=-1, keepdim=True) + e_self
    acc = torch.einsum("bkgs,bskd->bkgd", p.to(torch.bfloat16).float(), vc)
    acc = acc + e_self * vn[:, :, None, :]
    out = acc / l_sum
    return out.reshape(b, 1, h, d).to(v_new.dtype)


def flash_decode_attention(
    q: torch.Tensor,        # [B, 1, H, D]
    k_cache: torch.Tensor,  # [B, S, K, D] bf16 or int8
    v_cache: torch.Tensor,
    k_new: torch.Tensor,    # [B, 1, K, D]
    v_new: torch.Tensor,
    *,
    kv_valid: Optional[torch.Tensor] = None,      # [B, S]
    q_positions: Optional[torch.Tensor] = None,   # [B, 1]
    kv_positions: Optional[torch.Tensor] = None,  # [B, S]
    bias: Optional[torch.Tensor] = None,          # [B, S] fp32 additive
    k_scale: Optional[torch.Tensor] = None,  # [B, K, S] fp32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    kv_fill: Union[int, torch.Tensor, None] = None,  # valid cols < fill
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Drop-in for ``ops.attention.decode_attention`` (see the module
    docstring). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    b, t, h, d = q.shape
    assert t == 1, "flash_decode_attention is single-token by construction"
    _, s, kheads, _ = k_cache.shape
    if bias is None:
        if kv_valid is None or q_positions is None or kv_positions is None:
            raise ValueError("pass bias= or all of kv_valid/q_positions/"
                             "kv_positions")
        bias = decode_bias(kv_valid, q_positions, kv_positions, window)
    quant = k_cache.dtype == torch.int8
    if quant and (k_scale is None or v_scale is None):
        raise ValueError("int8 cache needs k_scale/v_scale")
    if not quant:
        k_scale = v_scale = None
    kw = dict(bias=bias, k_scale=k_scale, v_scale=v_scale, kv_fill=kv_fill,
              softmax_scale=softmax_scale, logit_softcap=logit_softcap)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_cache, v_cache, k_new,
                                            v_new, **kw)
    g = h // kheads
    dev = q.device
    tensors = [q, k_cache, v_cache, k_new, v_new, bias] + \
        ([k_scale, v_scale] if quant else [])
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("flash_decode_attention: all inputs must share one "
                         "CUDA device")
    if h % kheads or not 1 <= g <= _GMAX or d not in (64, 96, 128, 256):
        raise ValueError(f"decode kernel takes head_dim 64/96/128/256 and "
                         f"1..8 query heads per kv head, got D={d}, H={h}, "
                         f"K={kheads}")
    if k_cache.dtype not in (torch.int8, torch.bfloat16) \
            or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"decode kernel takes int8 or bf16 caches, got "
                         f"{k_cache.dtype}/{v_cache.dtype}")
    if v_cache.shape != k_cache.shape or k_new.shape != (b, 1, kheads, d) \
            or v_new.shape != k_new.shape or bias.shape != (b, s):
        raise ValueError("flash_decode_attention: inconsistent shapes")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_decode_attention: caches must be contiguous")
    if v_new.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"decode kernel returns bf16 or fp32, v_new is "
                         f"{v_new.dtype}")
    fill_dev, fill_host = None, s
    if torch.is_tensor(kv_fill):
        if kv_fill.numel() != 1 or kv_fill.dtype != torch.int32 \
                or kv_fill.device != dev:
            raise ValueError("flash_decode_attention: a tensor kv_fill must "
                             "be one int32 on the inputs' device, got "
                             f"{kv_fill.dtype} {tuple(kv_fill.shape)} on "
                             f"{kv_fill.device}")
        fill_dev = kv_fill.contiguous()
    elif kv_fill is not None:
        fill_host = max(0, min(s, int(kv_fill)))
    q3 = q.reshape(b, h, d).to(torch.bfloat16).contiguous()
    kn = k_new.reshape(b, kheads, d).to(torch.bfloat16).contiguous()
    vn = v_new.reshape(b, kheads, d).to(torch.bfloat16).contiguous()
    bias = bias.to(torch.float32).contiguous()
    ks = vs = None
    if quant:
        ks = k_scale.to(torch.float32).contiguous()
        vs = v_scale.to(torch.float32).contiguous()
        if ks.shape != (b, kheads, s) or vs.shape != ks.shape:
            raise ValueError("flash_decode_attention: scales must be "
                             "K-major [B, K, S]")
    for t in (k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("flash_decode_attention: caches must be 16-byte "
                             "aligned")
    out = torch.empty((b, h, d), dtype=v_new.dtype, device=dev)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    split = decode_split(b * kheads, s, _native.sm_count(dev))
    lib = _native.library()
    status = lib.dla_decode_attention(
        q3.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(),
        kn.data_ptr(), vn.data_ptr(), bias.data_ptr(), out.data_ptr(),
        None if fill_dev is None else fill_dev.data_ptr(), b, s, kheads, g,
        d, fill_host, split, int(quant), float(scale), float(logit_softcap),
        int(v_new.dtype == torch.bfloat16), _native.stream_handle(dev))
    _native.check(status, NAME)
    _native.LAUNCHES[NAME] += 1
    return out.reshape(b, 1, h, d)
