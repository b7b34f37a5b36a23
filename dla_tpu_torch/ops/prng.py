"""The parts of ``jax.random`` the package uses, bit for bit, in PyTorch.

The counterpart of jax 0.9.0's threefry PRNG with
``jax_threefry_partitionable`` on (its default):

- ``threefry2x32``: the Threefry-2x32 hash, 20 rounds, rotations
  (13, 15, 26, 6) / (17, 29, 16, 24), key schedule k0, k1, k0 ^ k1 ^
  0x1BD11BDA;
- ``PRNGKey(seed)``: [seed >> 32, seed & 0xFFFFFFFF] (a 32-bit seed pads
  with a zero high word);
- ``fold_in(key, data)``: threefry2x32(key, (0, data));
- ``split(key, n)``: key i = threefry2x32(key, (0, i));
- ``random_bits(key, shape)``: element i (flat index) is the XOR of the
  two words of threefry2x32(key, (i >> 32, i & 0xFFFFFFFF));
- ``uniform`` from the top 23 bits, ``gumbel`` = -log(-log(u)) with u in
  [tiny, 1), ``categorical`` = argmax(logits + gumbel), lowest index on
  ties.

A key is a tensor of shape [..., 2] holding two uint32 words. torch has
no arithmetic on uint32 on the CPU, so the words are carried as int64
and every sum and shift is masked to 32 bits. Bits and uniforms equal
``jax.random``'s exactly; the gumbel's two logs may differ from XLA's by
an ulp (another libm), which moves a draw only at a near-tie.

This module is the plain version of the fused draw kernel
(``ops.sampling.draw_categorical``, ``csrc/sample.cu``): on a [64,
128256] batch it makes ~150 full int64 passes.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
FLOAT_TINY = 1.1754943508222875e-38      # float32 smallest normal

Shape = Union[int, Sequence[int]]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words (x0, x1) under ``key`` [..., 2]
    (its words broadcast against the counters). int64 in, int64 out,
    values in [0, 2**32)."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = (x0 + ks[0]) & MASK
    b = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (and the data of ``jax.random.key``):
    [2] int64. Seeds in [-2**31, 2**32) give [0, seed & 0xFFFFFFFF], as
    with 32-bit seeds in JAX; wider ones split into two words."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 32 else (seed >> 32) & MASK
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def key_from_seeds(seeds: torch.Tensor) -> torch.Tensor:
    """``PRNGKey`` of each uint32 seed of ``seeds`` [...]: [..., 2]."""
    s = seeds.to(torch.int64) & MASK
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: [..., 2] keys and data broadcast (an int
    or an integer tensor, taken as uint32)."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    a, b = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of one key [2]: [num, 2]."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key, torch.zeros_like(i), i)
    return torch.stack([a, b], dim=-1)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit) as int64 in [0, 2**32)."""
    shape = _shape(shape)
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key, i >> 32, i & MASK)
    return (a ^ b).reshape(shape)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64) -> float32 in [0, 1): the top 23 bits as the
    mantissa of a float in [1, 2), less one."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32. XLA fuses f * (max - min) + min
    into one rounding; the product is exact in float64, so the sum is
    taken there and rounded once."""
    f = bits_to_uniform(random_bits(key, shape))
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """-log(-log(u)) with u = uniform(tiny, 1) of the bits, float32."""
    u = torch.clamp(bits_to_uniform(bits) + FLOAT_TINY, min=FLOAT_TINY)
    return -torch.log(-torch.log(u))


def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"), float32."""
    return gumbel_from_bits(random_bits(key, shape))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: argmax over the
    last axis of logits + gumbel noise drawn over the whole shape
    (counters run over the flattened logits), the lowest index winning
    ties. int64 indices of shape logits.shape[:-1]."""
    g = gumbel(key, tuple(logits.shape))
    return torch.argmax(logits.float() + g, dim=-1)


def gumbel_per_row(keys: torch.Tensor, v: int) -> torch.Tensor:
    """Row i's gumbel noise under ``keys[i]`` with counters 0..V-1: [B,
    V] float32."""
    i = torch.arange(v, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[:, None, :], torch.zeros_like(i), i)
    return gumbel_from_bits(a ^ b)


def categorical_per_row(keys: torch.Tensor, logits: torch.Tensor
                        ) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)(keys, logits)`` over rows: row i
    draws under ``keys[i]`` with counters 0..V-1. [B] int64."""
    g = gumbel_per_row(keys, logits.shape[-1])
    return torch.argmax(logits.float() + g, dim=-1)


def row_keys(seeds: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``fold_in(PRNGKey(seed_i), position_i)`` per row: [B, 2]."""
    return fold_in(key_from_seeds(seeds), positions)
