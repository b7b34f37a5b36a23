"""The port's threefry PRNG (``dla_tpu_torch.ops.prng``) and seeded
samplers against ``jax.random`` and ``dla_tpu.ops.sampling``.

Keys, ``fold_in``, ``split``, 32-bit bits and uniforms must be
bit-equal to jax 0.9.0's (``jax_threefry_partitionable`` on). The gumbel
noise is held to 2e-6 absolute: its two logs are XLA's CPU ``log`` in
JAX and torch's here, which differ by an ulp in about a quarter of the
elements (9.5e-7 at [64, 128256]). ``categorical`` and the samplers must
give the same tokens; log-probs to 1e-6. The fused draw kernel's
wrappers run their plain versions on these CPU tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.ops import sampling as jsampling
from dla_tpu_torch.ops import prng, sampling

SEEDS = [0, 21, 2 ** 31 + 5, 0xFFFFFFFF]
SHAPES = [(), (7,), (3, 5, 7), (64, 1000)]


def _data(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_bit_equal(seed):
    """``PRNGKey`` (the data of ``jax.random.key`` and of
    ``jax.random.PRNGKey``), ``fold_in`` of 32-bit data, ``split`` and
    chained ``fold_in(split(...))``: equal words."""
    k, jk = prng.PRNGKey(seed), jax.random.key(seed)
    np.testing.assert_array_equal(k.numpy(), _data(jk))
    np.testing.assert_array_equal(
        k.numpy(), np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))
    for d in (0, 1, 100, 10_000, 2 ** 31 + 7, 0xFFFFFFFF):
        np.testing.assert_array_equal(prng.fold_in(k, d).numpy(),
                                      _data(jax.random.fold_in(jk, d)))
    np.testing.assert_array_equal(prng.split(k, 5).numpy(),
                                  _data(jax.random.split(jk, 5)))
    chained = prng.fold_in(prng.split(prng.fold_in(k, 3), 4)[2], 9)
    jchained = jax.random.fold_in(
        jax.random.split(jax.random.fold_in(jk, 3), 4)[2], 9)
    np.testing.assert_array_equal(chained.numpy(), _data(jchained))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bit_equal_gumbel_close(seed, shape):
    k, jk = prng.fold_in(prng.PRNGKey(seed), 4), \
        jax.random.fold_in(jax.random.key(seed), 4)
    np.testing.assert_array_equal(
        prng.random_bits(k, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
    np.testing.assert_array_equal(prng.uniform(k, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(
        prng.uniform(k, shape, minval=-2.0, maxval=3.0).numpy(),
        np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0)))
    g = prng.gumbel(k, shape).numpy()
    jg = np.asarray(jax.random.gumbel(jk, shape))
    assert g.shape == jg.shape and g.dtype == np.float32
    np.testing.assert_allclose(g, jg, rtol=0, atol=2e-6)


def test_categorical_equal_at_full_vocab():
    """Tokens of ``categorical`` at V = 128256 equal JAX's under 20 keys
    (4 rows each: 80 draws), logits of std 3 from a numpy seed."""
    logits = np.random.RandomState(0).randn(4, 128256).astype(np.float32) * 3
    root, jroot = prng.PRNGKey(21), jax.random.key(21)
    for i in range(20):
        tok = prng.categorical(prng.fold_in(root, 10_000 + i),
                               torch.from_numpy(logits))
        want = jax.random.categorical(jax.random.fold_in(jroot, 10_000 + i),
                                      jnp.asarray(logits))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(want))


def test_categorical_per_row_equals_vmap():
    """``categorical_per_row`` under ``row_keys(seeds, positions)`` equals
    ``jax.vmap`` of ``categorical(fold_in(PRNGKey(seed), position))``
    over rows; ``draw_categorical_per_row`` on CPU tensors is it."""
    rs = np.random.RandomState(1)
    logits = rs.randn(16, 3000).astype(np.float32) * 2
    seeds = rs.randint(0, 2 ** 32, 16, dtype=np.uint64).astype(np.uint32)
    pos = rs.randint(0, 300, 16).astype(np.int32)

    def draw(seed, p, row):
        return jax.random.categorical(
            jax.random.fold_in(jax.random.PRNGKey(seed), p), row)

    want = np.asarray(jax.vmap(draw)(jnp.asarray(seeds), jnp.asarray(pos),
                                     jnp.asarray(logits)))
    ts, tp = torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(pos)
    got = prng.categorical_per_row(prng.row_keys(ts, tp),
                                   torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = sampling.draw_categorical_per_row(ts, tp,
                                              torch.from_numpy(logits))
    assert drawn.dtype == torch.int32
    np.testing.assert_array_equal(drawn.numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(temperature=0.7, top_p=0.9),
    dict(temperature=1.0, top_p=1.0, top_k=5),
    dict(temperature=0.5, top_p=0.5, top_k=20),
    dict(do_sample=False),
])
def test_sample_token_matches_jax(kw):
    """``sample_token`` from one key: the JAX package's tokens. The
    logits are bf16-rounded, so ties in the top-p sort are common: they
    must keep JAX's order (higher index first)."""
    logits = np.random.RandomState(2).randn(8, 1000).astype(np.float32) * 3
    logits = np.array(jnp.asarray(logits, jnp.bfloat16).astype(jnp.float32))
    for i in range(4):
        tok = sampling.sample_token(prng.fold_in(prng.PRNGKey(5), i),
                                    torch.from_numpy(logits), **kw)
        want = jsampling.sample_token(jax.random.fold_in(jax.random.key(5), i),
                                      jnp.asarray(logits), **kw)
        assert tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), np.asarray(want))


def _per_row_inputs(b, v, seed):
    rs = np.random.RandomState(seed)
    logits = rs.randn(b, v).astype(np.float32) * 3
    seeds = sampling.derive_rollout_seeds(seed, b)
    pos = rs.randint(0, 64, b).astype(np.int32)
    temps = np.where(np.arange(b) % 4 == 3, 0.0, 0.8).astype(np.float32)
    top_ps = np.full(b, 0.9, np.float32)
    top_ks = np.where(np.arange(b) % 3 == 0, 7, 0).astype(np.int32)
    return logits, seeds, pos, temps, top_ps, top_ks


def _torch(*arrays):
    return [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                             else a) for a in arrays]


def test_sample_token_per_row_matches_jax():
    """Per-row seeds, positions, temperatures (greedy rows among them),
    top-p and top-k: tokens equal, raw-logit log-probs to 1e-6."""
    args = _per_row_inputs(12, 700, 3)
    tok, logp = sampling.sample_token_per_row(*_torch(args[1], args[2],
                                                      args[0], *args[3:]))
    jtok, jlogp = jsampling.sample_token_per_row(
        *(jnp.asarray(a) for a in (args[1], args[2], args[0], *args[3:])))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), atol=1e-6)


def test_sample_token_block_equals_per_row_calls():
    """``sample_token_block`` over [B, G, V] equals G calls of the per-row
    sampler at positions p0 + g, and the JAX block sampler."""
    b, g, v = 4, 3, 500
    logits, seeds, pos, temps, top_ps, top_ks = _per_row_inputs(b * g, v, 4)
    logits = logits.reshape(b, g, v)
    seeds, pos, temps, top_ps, top_ks = (
        a[:b] for a in (seeds, pos, temps, top_ps, top_ks))
    tok, logp = sampling.sample_token_block(*_torch(
        seeds, pos, logits, temps, top_ps, top_ks))
    for col in range(g):
        t1, l1 = sampling.sample_token_per_row(*_torch(
            seeds, pos + col, logits[:, col], temps, top_ps, top_ks))
        assert torch.equal(tok[:, col], t1)
        assert torch.equal(logp[:, col], l1)
    jtok, jlogp = jsampling.sample_token_block(*(jnp.asarray(a) for a in (
        seeds, pos, logits, temps, top_ps, top_ks)))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), atol=1e-6)


def test_derived_seeds_and_params_equal():
    for base, rid in ((0, 0), (21, 7), (2 ** 40 + 3, 123456789)):
        assert sampling.derive_request_seed(base, rid) == \
            jsampling.derive_request_seed(base, rid)
    for seed in (0, 21, 2 ** 31 + 5):
        got = sampling.derive_rollout_seeds(seed, 64)
        want = jsampling.derive_rollout_seeds(seed, 64)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)

    class Gen:
        temperature, top_p, top_k, do_sample = 0.7, 0.9, 3, True
    mine = sampling.SamplingParams.from_gen(Gen, 2 ** 33 + 9)
    theirs = jsampling.SamplingParams.from_gen(Gen, 2 ** 33 + 9)
    assert dataclass_tuple(mine) == dataclass_tuple(theirs)
    assert sampling.SamplingParams(do_sample=False).effective_temperature \
        == 0.0


def dataclass_tuple(p):
    return (p.temperature, p.top_p, p.top_k, p.seed, p.do_sample,
            p.effective_temperature)


def test_draw_wrappers_refuse_what_the_kernel_does_not_take():
    """On the CPU the wrappers compute the plain version; a tensor on
    another device than the CPU needs the kernel, and bad shapes raise
    before any launch."""
    logits = torch.zeros((2, 10))
    key = prng.PRNGKey(0)
    assert sampling.draw_categorical(key, logits).tolist() == \
        prng.categorical(key, logits).tolist()
    with pytest.raises(ValueError, match="CUDA"):
        sampling._launch(logits, key=key)
    meta = torch.zeros((2, 10), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sampling.draw_categorical(key, meta)
