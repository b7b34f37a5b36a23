"""Model-level parity: the PyTorch port's Transformer against dla_tpu's.

Weights travel JAX -> port through ``params_from_jax``, so both models
compute with identical parameters. Two configurations:

- the committed fp32 checkpoint (``checkpoints/run/final``, a tiny llama
  with the einsum attention path): prefill logits to 1e-4;
- the rollout configuration at head_dim 128 (flash prefill, int8 KV
  cache, ``quantize_weights`` tree) — small enough for the CPU, wide
  enough that the JAX reference itself takes all three Pallas kernels
  (interpret mode): logits to 5e-2, the bound the JAX package's own
  kernel-vs-XLA tests use (bf16 activations through int8 weights and
  an int8 cache).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.checkpoint.checkpointer import load_tree_numpy as j_load
from dla_tpu.models.config import ModelConfig as JModelConfig
from dla_tpu.models.transformer import Transformer as JTransformer
from dla_tpu_torch.checkpoint.checkpointer import load_tree_numpy
from dla_tpu_torch.models.config import ModelConfig
from dla_tpu_torch.models.transformer import Transformer
from dla_tpu_torch.models.weights import params_from_jax, params_to_numpy

CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / "run" / "final"


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _prompts(b: int, t: int, vocab: int, seed: int):
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, vocab, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, t - 3:] = 0                       # one right-padded row
    return ids, mask


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_checkpoint_reader_matches_jax():
    """The port's format-2 reader reassembles the per-shard .npy files
    of the fixture exactly as the JAX package does (every tree, not just
    params: optimizer state too)."""
    tree, aux = load_tree_numpy(CKPT)
    jtree, jaux = j_load(str(CKPT))
    assert aux == jaux
    mine, theirs = dict(_leaves(tree)), dict(_leaves(jtree))
    assert mine.keys() == theirs.keys()
    for key, val in theirs.items():
        assert mine[key].dtype == val.dtype, key
        np.testing.assert_array_equal(mine[key], val, err_msg=key)


def _ckpt_models():
    jtree, aux = j_load(str(CKPT), prefix="params")
    mc = aux["model_config"]
    return (JTransformer(JModelConfig.from_dict(mc)), jtree,
            Transformer(ModelConfig.from_dict(mc)),
            params_from_jax(jtree, "cpu"))


def test_fp32_prefill_logits_match_jax():
    jm, jp, tm, tp = _ckpt_models()
    ids, mask = _prompts(3, 12, 259, seed=0)
    jl, jc = jm.start_decode(jp, jnp.asarray(ids), jnp.asarray(mask), 4)
    tl, tc = tm.start_decode(tp, torch.from_numpy(ids),
                             torch.from_numpy(mask), 4)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4, rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(_f32(tc[key]), _f32(jc[key]), atol=1e-4)
    np.testing.assert_array_equal(tc["valid"].numpy(), np.asarray(jc["valid"]))
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


def test_fp32_decode_steps_match_jax():
    jm, jp, tm, tp = _ckpt_models()
    ids, mask = _prompts(3, 12, 259, seed=1)
    jl, jc = jm.start_decode(jp, jnp.asarray(ids), jnp.asarray(mask), 3)
    tl, tc = tm.start_decode(tp, torch.from_numpy(ids),
                             torch.from_numpy(mask), 3)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _hd128_cfg(**over):
    kw = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
              num_layers=2, num_heads=2, num_kv_heads=1, max_seq_length=128,
              attention="flash", kv_cache_dtype="int8", remat="none",
              dtype="bfloat16", param_dtype="bfloat16", rope_theta=10000.0)
    kw.update(over)
    return JModelConfig(**kw), ModelConfig(**kw)


def _rollout(**over):
    """(JAX model, port model, JAX params) of the hd128 rollout config;
    with ``attention_bias`` the zero-initialised q/k/v biases get random
    values so they take part."""
    jcfg, tcfg = _hd128_cfg(**over)
    jm, tm = JTransformer(jcfg), Transformer(tcfg)
    jp = jm.init(jax.random.key(0))
    if over.get("attention_bias"):
        rs = np.random.RandomState(9)
        for name in ("wq_bias", "wk_bias", "wv_bias"):
            leaf = jp["layers"][name]
            jp["layers"][name] = jnp.asarray(
                rs.randn(*leaf.shape) * 0.1, leaf.dtype)
    return jm, tm, jp


@pytest.fixture(scope="module")
def rollout():
    return _rollout()


def test_quantize_weights_matches_jax(rollout):
    """int8 values equal except where the two frameworks round the fp32
    quotient x / scale to different sides of a .5 boundary (at most one
    step, and rare: counted and bounded — 0 of 1,245,184 codes differ
    for init seeds 0-2 on the CPU); scales within 1e-7 relative."""
    jm, tm, jp = rollout
    jq = jax.tree.map(np.asarray, jm.quantize_weights(jp))
    tq = params_to_numpy(tm.quantize_weights(params_from_jax(jp, "cpu")))
    mine, theirs = dict(_leaves(tq)), dict(_leaves(jq))
    assert mine.keys() == theirs.keys()
    n_off, n_total = 0, 0
    for key, val in theirs.items():
        if val.dtype == np.int8:
            assert mine[key].dtype == np.int8
            diff = np.abs(mine[key].astype(np.int32) - val.astype(np.int32))
            assert diff.max() <= 1, key
            n_off += int((diff > 0).sum())
            n_total += diff.size
        elif key.endswith("_wscale"):
            np.testing.assert_allclose(mine[key], val, rtol=1e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(mine[key], _f32(val), err_msg=key)
    assert n_total > 0 and n_off <= n_total // 10000, (n_off, n_total)


@pytest.mark.parametrize("variant", [
    {},                          # llama
    {"sliding_window": 6},       # mistral-style uniform window
    {"attention_bias": True},    # qwen2-style q/k/v biases
    # a bf16 cache, still through the decode kernel
    {"kv_cache_dtype": "bfloat16", "decode_kernel": "on"},
])
def test_rollout_prefill_and_decode_match_jax(variant, monkeypatch):
    """start_decode (flash prefill + int8 or bf16 cache) and three decode
    steps (decode kernel + int8 matmuls) on the same quantized tree. The
    steps write the cache at the device column ``cache["col"]`` and give
    the decode kernel that 0-dim int32 tensor as its fill; the cache's
    bookkeeping (col, valid, pos, lengths) must match JAX's after them.
    Spies on the three kernel wrappers pin that the port routed through
    them."""
    from dla_tpu_torch.ops import decode_kernel, flash_attention, quant_matmul
    calls = {"flash": 0, "decode": 0, "int8": 0}

    def spy(module, name, key):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    spy(flash_attention, "flash_causal_attention", "flash")
    spy(decode_kernel, "flash_decode_attention", "decode")
    spy(quant_matmul, "int8_matmul", "int8")
    jm, tm, jp = _rollout(**variant)
    jq = jm.quantize_weights(jp)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), "cpu")
    ids, mask = _prompts(2, 16, 256, seed=2)
    jl, jc = jm.start_decode(jq, jnp.asarray(ids), jnp.asarray(mask), 3)
    tl, tc = tm.start_decode(tq, torch.from_numpy(ids),
                             torch.from_numpy(mask), 3)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=5e-2, rtol=5e-2)
    # the cache through its dequantized values (int8 codes may differ by
    # one where bf16 k/v rounded differently before quantization)
    for key in ("k", "v"):
        if key + "_scale" not in tc:     # bf16 cache
            np.testing.assert_allclose(_f32(tc[key]), _f32(jc[key]),
                                       atol=5e-2)
            continue
        deq_t = tc[key].float() * tc[key + "_scale"].transpose(2, 3)[..., None]
        deq_j = (np.asarray(jc[key], np.float32)
                 * np.asarray(jc[key + "_scale"]).transpose(0, 1, 3, 2)[..., None])
        np.testing.assert_allclose(deq_t.numpy(), deq_j, atol=5e-2)
    np.testing.assert_array_equal(tc["valid"].numpy(), np.asarray(jc["valid"]))
    for step in range(3):
        assert tc["col"].dtype == torch.int32 and tc["col"].ndim == 0
        assert int(tc["col"]) == 16 + step
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jm.decode_step(jq, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tq, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=5e-2, rtol=5e-2)
    assert int(tc["col"]) == 16 + 3 and tc["step"] == 3
    for key in ("valid", "pos", "lengths"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]),
                                      err_msg=key)
    # 2 layers: flash once per layer at prefill; decode attention once per
    # layer per step; 7 projections per layer + lm_head per forward
    assert calls == {"flash": 2, "decode": 2 * 3, "int8": 15 * (1 + 3)}


@pytest.mark.parametrize("decode_kernel", ["auto", "off", "on"])
def test_decode_kernel_modes_agree(decode_kernel):
    """auto/on route the step through the decode kernel's wrapper, off
    through the einsum path on a dequantized cache: same logits."""
    _, base_cfg = _hd128_cfg()
    base = Transformer(base_cfg)
    params = base.quantize_weights(base.init(
        torch.Generator().manual_seed(3)))
    other = Transformer(dataclasses.replace(base_cfg,
                                            decode_kernel=decode_kernel))
    ids, mask = (torch.from_numpy(a) for a in _prompts(2, 10, 256, seed=3))
    l0, c0 = base.start_decode(params, ids, mask, 2)
    l1, c1 = other.start_decode(params, ids, mask, 2)
    assert torch.equal(l0, l1)
    tok = l0.float().argmax(-1).to(torch.int32)
    l0, _ = base.decode_step(params, c0, tok)
    l1, _ = other.decode_step(params, c1, tok)
    np.testing.assert_allclose(_f32(l1), _f32(l0), atol=5e-2, rtol=5e-2)


def test_unported_branches_raise():
    _, cfg = _hd128_cfg()
    for over in (dict(arch="gemma2"), dict(num_experts=4), dict(lora_r=4)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Transformer(dataclasses.replace(cfg, **over))
