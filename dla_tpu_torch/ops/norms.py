"""Normalization ops. RMSNorm computed in fp32 regardless of input dtype
(bf16 variance accumulation loses too much precision), cast back on exit
— the same recipe as ``dla_tpu.ops.norms``."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Full LayerNorm (mean-centered, affine with bias) — the phi-family
    norm; llama-family models use rms_norm above."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    normed = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float() + bias.float()).to(x.dtype)
