"""Phi generation in the port against the JAX package on a tiny phi
(hidden 160 = 2 heads x 80, MHA, partial rotary 0.4, 2 layers, vocab
512, fp32): ``quantize_weights`` leaf for leaf, prefill logits, every
step's logits of an 8-step decode loop over an activation-dtype cache
and an int8 cache, greedy and seeded sampled generation, and generation
from the int8 weight tree. The JAX side runs its Pallas kernels in
interpret mode (its int8 matmul through ``_flash_mesh() -> None``, as on
one device); the port's kernel wrappers compute their plain versions.
Inputs come from numpy seeds; each test states its tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.generation.engine import GenerationConfig as JGen
from dla_tpu.generation.engine import build_generate_fn as j_build
from dla_tpu.models import transformer as j_transformer
from dla_tpu.models.config import get_model_config as j_get_config
from dla_tpu.models.transformer import Transformer as JTransformer
from dla_tpu_torch.generation.engine import (GenerationConfig,
                                             build_generate_fn)
from dla_tpu_torch.models.config import get_model_config
from dla_tpu_torch.models.transformer import Transformer
from dla_tpu_torch.models.weights import params_from_jax, params_to_numpy
from dla_tpu_torch.ops import prng

TINY_PHI = dict(vocab_size=512, hidden_size=160, intermediate_size=320,
                num_layers=2, num_heads=2, num_kv_heads=2,
                max_seq_length=64, param_dtype="float32", dtype="float32",
                remat="none")
STEPS = 8


def _models(**over):
    """(JAX model, JAX params, port model, port params) of the tiny phi,
    the port's tree converted from JAX's with random biases (so every
    bias term, the lm_head's included, is exercised)."""
    over = {**TINY_PHI, **over}
    jm = JTransformer(j_get_config("phi-2", **over))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    rs = np.random.RandomState(11)
    for name in ("wq_bias", "wk_bias", "wv_bias", "wo_bias", "fc1_bias",
                 "fc2_bias", "ln_bias"):
        jp["layers"][name] = (0.05 * rs.randn(
            *jp["layers"][name].shape)).astype(np.float32)
    for name in ("final_norm_bias", "lm_head_bias"):
        jp[name] = (0.05 * rs.randn(*jp[name].shape)).astype(np.float32)
    tm = Transformer(get_model_config("phi-2", **over))
    return jm, jp, tm, params_from_jax(jp, "cpu")


def _prompts(b=3, width=12, seed=4):
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, 512, (b, width)).astype(np.int32)
    lens = np.array([width, 7, 10][:b])
    mask = (np.arange(width)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def test_quantize_weights_matches_jax_leaf_for_leaf():
    """The port's int8 copy of a phi tree equals the JAX package's leaf
    for leaf: int8 values and fp32 scales exactly, fc1/fc2 quantized with
    the attention projections and the lm_head."""
    jm, jp, tm, tp = _models()
    j_leaves = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jm.quantize_weights(jp))))
    t_leaves = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(tm.quantize_weights(tp))))
    assert set(t_leaves) == set(j_leaves)
    names = {jax.tree_util.keystr(k) for k in t_leaves}
    for leaf in ("fc1", "fc2", "wq", "wo"):
        assert f"['layers']['{leaf}_wscale']" in names
    assert "['lm_head_wscale']" in names
    for path, j in j_leaves.items():
        t = t_leaves[path]
        assert t.dtype == j.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(t, j, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_phi_prefill_logits_match_jax(attention):
    """prefill_external and prefill (into a zero cache) give the JAX
    package's last-real-token logits within 1e-4, and the same k/v."""
    width = 128 if attention == "flash" else 12   # JAX flash tiles 128
    jm, jp, tm, tp = _models(attention=attention, max_seq_length=160)
    ids, mask = _prompts(width=width)
    j_logits, j_ks, j_vs = jm.prefill_external(jp, jnp.asarray(ids),
                                               jnp.asarray(mask))
    t_logits, t_ks, t_vs = tm.prefill_external(
        tp, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), atol=1e-4)
    live = mask.astype(bool)[None, :, :, None, None]
    for t, j in ((t_ks, j_ks), (t_vs, j_vs)):
        np.testing.assert_allclose(np.where(live, _np(t), 0),
                                   np.where(live, _np(j), 0), atol=1e-4)
    cache = tm.init_cache(ids.shape[0], width + 4, torch.device("cpu"))
    t2, cache = tm.prefill(tp, cache, torch.from_numpy(ids),
                           torch.from_numpy(mask))
    np.testing.assert_allclose(_np(t2), _np(j_logits), atol=1e-4)


def _decode_loop(jm, jp, tm, tp, ids, mask):
    """Greedy loops in both packages; returns per-step logits lists and
    the tokens fed."""
    j_logits, j_cache = jm.start_decode(jp, jnp.asarray(ids),
                                        jnp.asarray(mask), STEPS)
    t_logits, t_cache = tm.start_decode(tp, torch.from_numpy(ids),
                                        torch.from_numpy(mask), STEPS)
    js, ts = [_np(j_logits)], [_np(t_logits)]
    for _ in range(STEPS):
        tok = np.argmax(js[-1], axis=-1).astype(np.int32)
        assert np.array_equal(tok, np.argmax(ts[-1], axis=-1))
        j_logits, j_cache = jm.decode_step(jp, j_cache, jnp.asarray(tok))
        t_logits, t_cache = tm.decode_step(tp, t_cache, torch.from_numpy(tok))
        js.append(_np(j_logits))
        ts.append(_np(t_logits))
    return js, ts


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_phi_decode_logits_match_jax_every_step(cache):
    """Prefill + 8 decode steps: the logits of every step within 1e-4 of
    the JAX package's and the same greedy tokens, over an
    activation-dtype cache (``kv_cache_dtype: bfloat16`` stores in the
    activation dtype, here fp32) and an int8 cache. The JAX package's
    decode kernel takes no head dim 80, so both packages take the einsum
    route (``decode_kernel: off``) to compute one function."""
    jm, jp, tm, tp = _models(kv_cache_dtype=cache, decode_kernel="off")
    ids, mask = _prompts()
    js, ts = _decode_loop(jm, jp, tm, tp, ids, mask)
    for i, (j, t) in enumerate(zip(js, ts)):
        np.testing.assert_allclose(t, j, atol=1e-4, err_msg=f"step {i}")


def test_phi_decode_kernel_route_matches_einsum_route():
    """The port's int8-cache decode through #4 at head dim 80 (its plain
    version on the CPU: q and the cache rounded to bf16, P rounded to
    bf16 before the value product) against the einsum route on the same
    cache: logits within 2e-2 (bf16 roundings) and the same greedy
    tokens at every step."""
    _, _, tm_k, tp = _models(kv_cache_dtype="int8", decode_kernel="auto")
    tm_e = Transformer(get_model_config(
        "phi-2", **TINY_PHI, kv_cache_dtype="int8", decode_kernel="off"))
    ids, mask = _prompts()
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    lk, ck = tm_k.start_decode(tp, ids_t, mask_t, STEPS)
    le, ce = tm_e.start_decode(tp, ids_t, mask_t, STEPS)
    for i in range(STEPS):
        np.testing.assert_allclose(_np(lk), _np(le), atol=2e-2,
                                   err_msg=f"step {i}")
        tok = torch.argmax(le, dim=-1).to(torch.int32)
        assert torch.equal(tok, torch.argmax(lk, dim=-1).to(torch.int32))
        lk, ck = tm_k.decode_step(tp, ck, tok)
        le, ce = tm_e.decode_step(tp, ce, tok)


def _generate_both(jm, jp, tm, tp, **kw):
    ids, mask = _prompts()
    jkey = jax.random.fold_in(jax.random.key(21), 10_000)
    key = prng.fold_in(prng.PRNGKey(21), 10_000)
    jout = j_build(jm, JGen(max_new_tokens=STEPS, eos_token_id=-1, **kw))(
        jp, jnp.asarray(ids), jnp.asarray(mask), jkey)
    tout = build_generate_fn(tm, GenerationConfig(
        max_new_tokens=STEPS, eos_token_id=-1, **kw))(
        tp, torch.from_numpy(ids), torch.from_numpy(mask), key)
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in tout.items()})


def _assert_same(jout, tout, logp_atol):
    for key in ("sequences", "sequence_mask", "response_tokens",
                "response_mask", "lengths"):
        np.testing.assert_array_equal(tout[key], jout[key], err_msg=key)
    np.testing.assert_allclose(tout["response_logps"],
                               jout["response_logps"], atol=logp_atol)


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("sampled", [False, True])
def test_phi_generate_matches_jax(cache, sampled):
    """build_generate_fn on phi: greedy, and sampled from the same key at
    temperature 0.7 / top_p 0.9, give the JAX package's sequences, masks,
    tokens and lengths, logps within 1e-4, over either cache."""
    jm, jp, tm, tp = _models(kv_cache_dtype=cache, decode_kernel="off")
    kw = dict(do_sample=True, temperature=0.7, top_p=0.9) if sampled \
        else dict(do_sample=False)
    _assert_same(*_generate_both(jm, jp, tm, tp, **kw), logp_atol=1e-4)


def test_phi_int8_weight_tree_generate_matches_jax(monkeypatch):
    """Greedy generation from the int8 weight trees (biases added after
    the int8 matmul, the biased lm_head too), fp32 activations around
    the matmul (which rounds x and its output to bf16 in both): the
    port's plain int8 matmul and the JAX package's Pallas kernel give
    the same tokens, logps within 1e-4."""
    monkeypatch.setattr(j_transformer, "_flash_mesh", lambda: None)
    jm, jp, tm, tp = _models(decode_kernel="off")
    jq = jax.tree.map(np.asarray, jm.quantize_weights(jp))
    tq = tm.quantize_weights(tp)
    jout, tout = _generate_both(jm, jq, tm, tq, do_sample=False)
    _assert_same(jout, tout, logp_atol=1e-4)
