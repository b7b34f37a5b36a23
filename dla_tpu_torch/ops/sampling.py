"""Token sampling for the decode loop.

The filters are ``dla_tpu.ops.sampling``'s, op for op: temperature, then
top-k, then nucleus (top-p) masking to NEG_INF, in fp32. The draw takes
an explicit ``torch.Generator``; it does not reproduce ``jax.random``'s
bits, so sampled tokens agree with the JAX package in distribution, not
token for token (greedy decoding agrees exactly). The per-row seeded
sampler (``sample_token_per_row``, keyed by threefry ``fold_in``) waits
for a bit-exact threefry port.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def apply_temperature(logits: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    return logits / max(float(temperature), 1e-6)


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row, NEG_INF elsewhere."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    cutoff = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= cutoff, logits,
                       torch.full_like(logits, NEG_INF))


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the sorted
    distribution with cumulative probability >= p (the token that crosses
    the threshold is kept); others get NEG_INF."""
    if p >= 1.0:
        return logits
    sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                         stable=True)
    sorted_probs = torch.softmax(sorted_logits.float(), dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) < p
    keep = torch.empty_like(keep_sorted).scatter_(-1, sort_idx, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def filtered_probs(logits: torch.Tensor, *, temperature: float = 1.0,
                   top_p: float = 1.0, top_k: int = 0,
                   do_sample: bool = True) -> torch.Tensor:
    """The probability vector ``sample_token`` draws from: softmax of the
    filtered logits, or a one-hot at the argmax for greedy decoding.
    fp32 [..., V], rows sum to 1."""
    logits = logits.float()
    if not do_sample or temperature == 0.0:
        return torch.nn.functional.one_hot(
            logits.argmax(dim=-1), logits.shape[-1]).float()
    logits = apply_temperature(logits, temperature)
    logits = top_k_mask(logits, top_k)
    logits = top_p_mask(logits, top_p)
    return torch.softmax(logits, dim=-1)


def sample_token(generator: torch.Generator, logits: torch.Tensor, *,
                 temperature: float = 1.0, top_p: float = 1.0,
                 top_k: int = 0, do_sample: bool = True) -> torch.Tensor:
    """One sampling step: [B, V] logits -> [B] int32 token ids, drawn
    from ``filtered_probs`` with ``generator`` (greedy ignores it)."""
    logits = logits.float()
    if not do_sample or temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = filtered_probs(logits, temperature=temperature, top_p=top_p,
                           top_k=top_k, do_sample=True)
    # the exponential race: argmax_i p_i / E_i with E_i ~ Exp(1) drawn from
    # ``generator`` is token i with probability p_i. torch.multinomial
    # draws one sample the same way, with the same noise, but checks the
    # probabilities on the host first, which a CUDA graph cannot capture
    noise = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return (probs / noise).argmax(dim=-1).to(torch.int32)


def filter_logits_per_row(logits: torch.Tensor, temps: torch.Tensor,
                          top_ps: torch.Tensor,
                          top_ks: torch.Tensor) -> torch.Tensor:
    """Temperature/top-k/top-p filtering with PER-ROW parameters ([B]
    temps, top_ps, and top_ks where <= 0 disables top-k). One descending
    sort serves both filters; same k-then-p composition as the static
    filters above."""
    x = logits.float() / torch.clamp(temps.float(), min=1e-6)[:, None]
    v = x.shape[-1]
    sorted_x, sort_idx = torch.sort(x, dim=-1, descending=True, stable=True)
    ranks = torch.arange(v, device=x.device)[None, :]
    keep_k = (ranks < top_ks[:, None]) | (top_ks[:, None] <= 0)
    sorted_probs = torch.softmax(
        torch.where(keep_k, sorted_x, torch.full_like(sorted_x, NEG_INF)),
        dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_p = (cum - sorted_probs) < top_ps.float()[:, None]
    keep_sorted = keep_p & keep_k
    keep = torch.empty_like(keep_sorted).scatter_(-1, sort_idx, keep_sorted)
    return torch.where(keep, x, torch.full_like(x, NEG_INF))
