"""Token sampling for the decode loop (``dla_tpu.ops.sampling``).

The filters are the JAX package's, op for op: temperature, then top-k,
then nucleus (top-p) masking to NEG_INF, in fp32; ties in the sort keep
JAX's order (a stable ascending sort, reversed). The draw is
``jax.random.categorical``'s, bit for bit: threefry bits from a key (a
[2] tensor of uint32 words, ``ops.prng``), gumbel noise, argmax. So a
seeded draw gives the JAX package's tokens from the same key; the two
logs of the gumbel may differ from XLA's by an ulp, which moves a token
only at a near-tie of gumbel + logit.

``draw_categorical`` / ``draw_categorical_per_row`` are the wrappers of
the fused draw kernel (``csrc/sample.cu``): given CUDA tensors they
launch it (or raise), given CPU tensors they compute its plain version,
``prng.categorical`` / ``prng.categorical_per_row``. The per-row
sampler draws row i with ``fold_in(PRNGKey(seeds[i]), positions[i])``,
the serving engine's per-request stream.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dla_tpu_torch.ops import _native, prng

NEG_INF = -1e30
NAME = "categorical_draw"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs: ``seed`` names the request's stream
    (generated token k is drawn with ``fold_in(PRNGKey(seed), k)``);
    ``do_sample=False`` or temperature 0 is greedy."""

    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0
    do_sample: bool = True

    @property
    def effective_temperature(self) -> float:
        if not self.do_sample:
            return 0.0
        return float(self.temperature)

    @classmethod
    def from_gen(cls, gen, seed: int) -> "SamplingParams":
        """Engine defaults for a request with no explicit override."""
        return cls(temperature=float(gen.temperature), top_p=float(gen.top_p),
                   top_k=int(gen.top_k), seed=int(seed) & 0xFFFFFFFF,
                   do_sample=bool(gen.do_sample))


def derive_request_seed(base_seed: int, rid: int) -> int:
    """Default seed of a request without explicit ``SamplingParams``: a
    function of (engine seed, request id) only."""
    return (int(base_seed) * 1000003 + int(rid) * 2654435761) & 0xFFFFFFFF


def derive_rollout_seeds(rollout_seed: int, n: int) -> np.ndarray:
    """Per-row sampling seeds of one rollout batch, [n] uint32."""
    idx = np.arange(n, dtype=np.uint64)
    base = np.uint64(int(rollout_seed) & 0xFFFFFFFF)
    vals = (base * np.uint64(0x9E3779B1) + idx * np.uint64(0x85EBCA6B)
            ) & np.uint64(0xFFFFFFFF)
    return vals.astype(np.uint32)


def apply_temperature(logits: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    return logits / max(float(temperature), 1e-6)


def _sort_descending(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.argsort(x)[..., ::-1]`` and the sorted values: equal values
    in descending index order."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals.flip(-1), idx.flip(-1)


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
    sorted_logits, sort_idx = _sort_descending(logits)
    sorted_probs = torch.softmax(sorted_logits.float(), dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) < p
    keep = torch.empty_like(keep_sorted).scatter_(-1, sort_idx, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def filtered_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                    top_p: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """Temperature, top-k and top-p applied to fp32 logits."""
    logits = apply_temperature(logits.float(), temperature)
    logits = top_k_mask(logits, top_k)
    return top_p_mask(logits, top_p)


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
    return torch.softmax(filtered_logits(
        logits, temperature=temperature, top_p=top_p, top_k=top_k), dim=-1)


# ------------------------------------------------------------- the draw

def _on_device(t: torch.Tensor, dev: torch.device, what: str
               ) -> torch.Tensor:
    if t.device != dev:
        raise ValueError(f"{NAME}: {what} on {t.device}, logits on {dev} "
                         "(a CUDA graph cannot copy it over)")
    return t.to(torch.int64).contiguous()


def _launch(logits: torch.Tensor, key: Optional[torch.Tensor] = None,
            seeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    dev = logits.device
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: logits on {dev}; the kernel takes CUDA "
                         "tensors")
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"{NAME}: takes fp32 logits [B, V], got "
                         f"{logits.dtype} {tuple(logits.shape)}")
    b, v = logits.shape
    x = logits.contiguous()
    if key is not None:
        if key.shape != (2,):
            raise ValueError(f"{NAME}: one key of shape [2], got "
                             f"{tuple(key.shape)}")
        key = _on_device(key, dev, "key")
    else:
        if seeds.shape != (b,) or positions.shape != (b,):
            raise ValueError(f"{NAME}: seeds and positions must be [B]")
        seeds = _on_device(seeds, dev, "seeds")
        positions = _on_device(positions, dev, "positions")
    if noise is not None and (noise.shape != (b, v) or noise.device != dev
                              or noise.dtype != torch.float32
                              or not noise.is_contiguous()):
        raise ValueError(f"{NAME}: noise must be a contiguous fp32 [B, V] "
                         "tensor on the logits' device")
    lib = _native.library()
    chunks = lib.dla_categorical_draw_chunks(v)
    part_v = torch.empty((b, chunks), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, chunks), dtype=torch.int32, device=dev)
    out = torch.empty((b,), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = lib.dla_categorical_draw(
        x.data_ptr(), ptr(key), ptr(seeds), ptr(positions), part_v.data_ptr(),
        part_i.data_ptr(), out.data_ptr(), ptr(noise), b, v,
        _native.stream_handle(dev))
    _native.check(status, NAME)
    _native.LAUNCHES[NAME] += 1
    return out


def draw_categorical(key: torch.Tensor, logits: torch.Tensor,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over [B, V] fp32 logits:
    [B] int32. CUDA tensors run the fused kernel (``noise``, optional,
    receives its gumbel values); CPU tensors the plain version."""
    if logits.device.type == "cpu":
        return prng.categorical(key, logits).to(torch.int32)
    return _launch(logits.float(), key=key, noise=noise)


def draw_categorical_per_row(seeds: torch.Tensor, positions: torch.Tensor,
                             logits: torch.Tensor,
                             noise: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Row i drawn with ``fold_in(PRNGKey(seeds[i]), positions[i])`` and
    counters 0..V-1 (``jax.vmap`` of categorical over rows): [B] int32."""
    if logits.device.type == "cpu":
        return prng.categorical_per_row(
            prng.row_keys(seeds, positions), logits).to(torch.int32)
    return _launch(logits.float(), seeds=seeds, positions=positions,
                   noise=noise)


# ------------------------------------------------------------ samplers

def sample_token(key: torch.Tensor, logits: torch.Tensor, *,
                 temperature: float = 1.0, top_p: float = 1.0,
                 top_k: int = 0, do_sample: bool = True) -> torch.Tensor:
    """One sampling step: [B, V] logits -> [B] int32 token ids, drawn
    from the filtered logits under ``key`` (greedy ignores it)."""
    logits = logits.float()
    if not do_sample or temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    return draw_categorical(key, filtered_logits(
        logits, temperature=temperature, top_p=top_p, top_k=top_k))


def filter_logits_per_row(logits: torch.Tensor, temps: torch.Tensor,
                          top_ps: torch.Tensor,
                          top_ks: torch.Tensor) -> torch.Tensor:
    """Temperature/top-k/top-p filtering with PER-ROW parameters ([B]
    temps, top_ps, and top_ks where <= 0 disables top-k). One descending
    sort serves both filters; same k-then-p composition as the static
    filters above."""
    x = logits.float() / torch.clamp(temps.float(), min=1e-6)[:, None]
    v = x.shape[-1]
    sorted_x, sort_idx = _sort_descending(x)
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


def sample_token_per_row(seeds: torch.Tensor, positions: torch.Tensor,
                         logits: torch.Tensor, temps: torch.Tensor,
                         top_ps: torch.Tensor, top_ks: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row sampled (temps > 0) or greedy next token and its log-prob
    under the RAW logits: row i draws with ``fold_in(PRNGKey(seeds[i]),
    positions[i])``. Returns (tokens [B] int32, logps [B] fp32)."""
    raw = logits.float()
    logp_all = torch.log_softmax(raw, dim=-1)
    filt = filter_logits_per_row(raw, temps, top_ps, top_ks)
    sampled = draw_categorical_per_row(seeds, positions, filt)
    greedy = raw.argmax(dim=-1).to(torch.int32)
    tok = torch.where(temps <= 0.0, greedy, sampled)
    logp = logp_all.gather(1, tok[:, None].long())[:, 0]
    return tok, logp


def sample_token_block(seeds: torch.Tensor, positions0: torch.Tensor,
                       logits: torch.Tensor, temps: torch.Tensor,
                       top_ps: torch.Tensor, top_ks: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block form of ``sample_token_per_row`` over logits [B, G, V]:
    column g of row i draws at position ``positions0[i] + g`` with row
    i's seed and knobs, as G successive single-token calls would.
    Returns (tokens [B, G] int32, logps [B, G] fp32)."""
    b, g, v = logits.shape
    offs = torch.arange(g, device=positions0.device)[None, :]
    flat_pos = (positions0[:, None].to(torch.int64) + offs).reshape(b * g)

    def rep(x):
        return torch.repeat_interleave(x, g, dim=0)

    tok, logp = sample_token_per_row(
        rep(seeds), flat_pos, logits.reshape(b * g, v), rep(temps),
        rep(top_ps), rep(top_ks))
    return tok.reshape(b, g), logp.reshape(b, g)
