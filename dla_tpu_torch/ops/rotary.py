"""Rotary position embeddings (RoPE), LLaMA convention.

Angles are computed on the fly from integer positions, as in
``dla_tpu.ops.rotary``: every HF ``rope_scaling`` type the JAX package
implements (llama3, linear, yarn, longrope, dynamic) with the same
formulas, so imported extended-context checkpoints rotate identically.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch


def validate_rope_scaling(scaling: Optional[Dict[str, Any]]
                          ) -> Optional[Dict[str, Any]]:
    """Normalize an HF ``rope_scaling`` dict: None/default-type -> None,
    supported types pass through, anything else raises."""
    if not scaling:
        return None
    rope_type = str(scaling.get("rope_type")
                    or scaling.get("type") or "default").lower()
    if rope_type in ("default", "none"):
        return None
    if rope_type == "su":  # phi-3's pre-release name for longrope
        rope_type = "longrope"
    if rope_type not in ("llama3", "linear", "yarn", "longrope",
                         "dynamic"):
        raise NotImplementedError(
            f"rope_scaling type '{rope_type}' is not supported "
            "(implemented: llama3, linear, yarn, longrope, dynamic — "
            "the full HF ROPE_INIT_FUNCTIONS family)")
    out = dict(scaling)
    out["rope_type"] = rope_type   # normalized: consumers read ONE key
    out.pop("type", None)
    return out


def _scale_inv_freq(inv_freq: torch.Tensor, scaling: Dict[str, Any],
                    head_dim: int, theta: float
                    ) -> Tuple[torch.Tensor, float]:
    """Frequency remapping for llama3 / linear / yarn scaling. Returns
    (scaled inv_freq, attention scale multiplier for cos/sin)."""
    rope_type = scaling["rope_type"]
    factor = float(scaling.get("factor", 1.0))
    if rope_type == "linear":
        return inv_freq / factor, 1.0
    if rope_type == "yarn":
        beta_fast = float(scaling.get("beta_fast") or 32.0)
        beta_slow = float(scaling.get("beta_slow") or 1.0)
        if "original_max_position_embeddings" not in scaling:
            raise ValueError(
                "yarn rope_scaling needs original_max_position_"
                "embeddings (the HF importer injects the checkpoint's "
                "max_position_embeddings when the dict omits it)")
        old_ctx = float(scaling["original_max_position_embeddings"])

        def get_mscale(scale: float, m: float = 1.0) -> float:
            if scale <= 1.0:
                return 1.0
            return 0.1 * m * math.log(scale) + 1.0

        attn = scaling.get("attention_factor")
        if attn is None:
            mscale = scaling.get("mscale")
            mscale_all = scaling.get("mscale_all_dim")
            if mscale and mscale_all:
                attn = float(get_mscale(factor, mscale)
                             / get_mscale(factor, mscale_all))
            else:
                attn = get_mscale(factor)
        else:
            attn = float(attn)

        def correction_dim(n_rot: float) -> float:
            return (head_dim
                    * math.log(old_ctx / (n_rot * 2.0 * math.pi))
                    / (2.0 * math.log(theta)))

        low = correction_dim(beta_fast)
        high = correction_dim(beta_slow)
        if scaling.get("truncate", True):
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, head_dim - 1)
        if low == high:
            high += 0.001  # HF's degenerate-ramp guard
        ramp = (torch.arange(head_dim // 2, dtype=torch.float32,
                             device=inv_freq.device) - low) / (high - low)
        extrap_mask = 1.0 - torch.clamp(ramp, 0.0, 1.0)
        scaled = (inv_freq / factor * (1.0 - extrap_mask)
                  + inv_freq * extrap_mask)
        return scaled, attn
    assert rope_type == "llama3", rope_type
    low = float(scaling.get("low_freq_factor", 1.0))
    high = float(scaling.get("high_freq_factor", 4.0))
    old_ctx = float(scaling.get("original_max_position_embeddings", 8192))
    wavelen = 2.0 * math.pi / inv_freq
    smooth = (old_ctx / wavelen - low) / (high - low)
    interpolated = ((1.0 - smooth) * inv_freq / factor
                    + smooth * inv_freq)
    out = torch.where(wavelen > old_ctx / low, inv_freq / factor,
                      interpolated)
    return torch.where(wavelen < old_ctx / high, inv_freq, out), 1.0


def _longrope_inv_freq(inv_freq: torch.Tensor, scaling: Dict[str, Any],
                       positions: torch.Tensor
                       ) -> Tuple[torch.Tensor, float]:
    """LongRoPE: the short per-dim factor list while max(position)+1 <=
    the original context, the long list beyond; cos/sin scale by
    attention_factor (default sqrt(1 + ln(factor)/ln(original_ctx)))."""
    if "original_max_position_embeddings" not in scaling:
        raise ValueError(
            "longrope rope_scaling needs original_max_position_"
            "embeddings (the HF importer injects it from the "
            "checkpoint's top-level config)")
    orig = int(scaling["original_max_position_embeddings"])
    half = inv_freq.shape[0]
    if "short_factor" not in scaling or "long_factor" not in scaling:
        raise ValueError("longrope rope_scaling needs short_factor and "
                         "long_factor per-dim rescale lists")
    dev = inv_freq.device
    short = torch.as_tensor(scaling["short_factor"], dtype=torch.float32,
                            device=dev)
    long = torch.as_tensor(scaling["long_factor"], dtype=torch.float32,
                           device=dev)
    if short.shape != (half,) or long.shape != (half,):
        raise ValueError(
            f"longrope factor lists must have rotary_dim/2 = {half} "
            f"entries, got short {tuple(short.shape)} "
            f"long {tuple(long.shape)}")
    factor = float(scaling.get("factor") or 1.0)
    attn = scaling.get("attention_factor")
    if attn is None:
        attn = 1.0 if factor <= 1.0 else \
            math.sqrt(1.0 + math.log(factor) / math.log(orig))
    seq_len = torch.max(positions) + 1
    ext = torch.where(seq_len > orig, long, short)
    return inv_freq / ext, float(attn)


def _dynamic_ntk_inv_freq(scaling: Dict[str, Any],
                          positions: torch.Tensor, head_dim: int,
                          theta: float) -> torch.Tensor:
    """Dynamic NTK scaling: the wavelength base stretches once the
    current sequence exceeds the trained context."""
    if "max_position_embeddings" not in scaling:
        raise ValueError(
            "dynamic rope_scaling needs max_position_embeddings (the "
            "HF importer injects it from the checkpoint config)")
    max_pos = float(scaling["max_position_embeddings"])
    factor = float(scaling["factor"])
    seq = torch.clamp(torch.max(positions).float() + 1.0, min=max_pos)
    base = theta * ((factor * seq / max_pos) - (factor - 1.0)) \
        ** (head_dim / (head_dim - 2.0))
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    return 1.0 / (base ** exps)


def rotary_angles(positions: torch.Tensor, head_dim: int,
                  theta: float = 10000.0,
                  scaling: Optional[Dict[str, Any]] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., T] int -> (cos, sin) each [..., T, head_dim//2],
    fp32."""
    dev = positions.device
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=dev) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    scaling = validate_rope_scaling(scaling)
    attn_scale = 1.0
    if scaling:
        if scaling["rope_type"] == "longrope":
            inv_freq, attn_scale = _longrope_inv_freq(
                inv_freq, scaling, positions)
        elif scaling["rope_type"] == "dynamic":
            inv_freq = _dynamic_ntk_inv_freq(scaling, positions,
                                             head_dim, theta)
        else:
            inv_freq, attn_scale = _scale_inv_freq(inv_freq, scaling,
                                                   head_dim, theta)
    ang = positions.float()[..., None] * inv_freq  # [..., T, D/2]
    if attn_scale != 1.0:
        return torch.cos(ang) * attn_scale, torch.sin(ang) * attn_scale
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 rotary_dim: int = 0) -> torch.Tensor:
    """x [B, T, H, D] with (cos, sin) [B, T, rd/2] (or broadcastable).
    Split-halves convention (rotate_half), matching LLaMA / HF.
    ``rotary_dim``: rotate only the first rd dims (partial RoPE); 0 means
    full rotation."""
    d = x.shape[-1]
    if rotary_dim < 0 or rotary_dim > d:
        raise ValueError(f"rotary_dim {rotary_dim} out of range for head "
                         f"dim {d}")
    rd = rotary_dim or d
    rot, rest = x[..., :rd], x[..., rd:]
    d_half = rd // 2
    x1, x2 = rot[..., :d_half], rot[..., d_half:]
    cos = cos[..., None, :].to(x.dtype)  # [B, T, 1, rd/2]
    sin = sin[..., None, :].to(x.dtype)
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    if rd == d:
        return torch.cat([out1, out2], dim=-1)
    return torch.cat([out1, out2, rest], dim=-1)
