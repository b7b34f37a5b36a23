"""Generation parity: the port's build_generate_fn against dla_tpu's.

Greedy decoding on the committed fp32 checkpoint must give EXACTLY the
JAX package's tokens, masks and lengths (logps to 1e-4), under the
fixed-length schedule, per-step early exit on EOS, and group_size > 1.
The filtered distribution must match JAX's to 1e-6. Sampling draws
``jax.random``'s bits (``ops.prng``): from the same key, or the same
per-request seeds, sampled generation gives the JAX package's tokens,
masks and lengths, and the response logps to 1e-5."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.checkpoint.checkpointer import load_tree_numpy as j_load
from dla_tpu.generation.engine import GenerationConfig as JGen
from dla_tpu.generation.engine import build_generate_fn as j_build
from dla_tpu.models.config import ModelConfig as JModelConfig
from dla_tpu.models.transformer import Transformer as JTransformer
from dla_tpu.ops.sampling import filtered_probs as j_filtered_probs
from dla_tpu.ops.sampling import sample_token as j_sample_token
from dla_tpu_torch.data.tokenizers import ByteTokenizer
from dla_tpu_torch.generation.engine import (
    GenerationConfig,
    GenerationEngine,
    build_generate_fn,
)
from dla_tpu_torch.models.config import ModelConfig
from dla_tpu_torch.models.transformer import Transformer
from dla_tpu_torch.models.weights import params_from_jax
from dla_tpu_torch.ops import prng
from dla_tpu_torch.ops.sampling import filtered_probs, sample_token
from dla_tpu_torch.training.model_io import load_causal_lm

CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / "run" / "final"


@pytest.fixture(scope="module")
def models():
    jtree, aux = j_load(str(CKPT), prefix="params")
    jm = JTransformer(JModelConfig.from_dict(aux["model_config"]))
    bundle = load_causal_lm(str(CKPT), {}, device="cpu")
    return jm, jtree, bundle


def _prompts():
    tok = ByteTokenizer()
    texts = ["The quick brown fox", "hello", "Once upon a time, in"]
    width = 16
    ids = np.zeros((len(texts), width), np.int32)
    mask = np.zeros_like(ids)
    for i, t in enumerate(texts):
        enc = tok.encode(t)[:width]
        ids[i, :len(enc)], mask[i, :len(enc)] = enc, 1
    return ids, mask


def _run_both(models, group_size=1, **gen_kw):
    jm, jp, bundle = models
    ids, mask = _prompts()
    jout = j_build(jm, JGen(do_sample=False, **gen_kw),
                   group_size=group_size)(
        jp, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(0))
    tout = build_generate_fn(bundle.model, GenerationConfig(
        do_sample=False, **gen_kw), group_size=group_size)(
        bundle.params, torch.from_numpy(ids), torch.from_numpy(mask),
        prng.PRNGKey(0))
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in tout.items()})


def _assert_same(jout, tout, logp_atol=1e-4):
    for key in ("sequences", "sequence_mask", "response_tokens",
                "response_mask", "lengths"):
        np.testing.assert_array_equal(tout[key], jout[key], err_msg=key)
    np.testing.assert_allclose(tout["response_logps"],
                               jout["response_logps"], atol=logp_atol)


def test_greedy_fixed_length_matches_jax(models):
    jout, tout = _run_both(models, max_new_tokens=10, eos_token_id=-1)
    assert tout["response_mask"].all()
    _assert_same(jout, tout)


def test_greedy_early_exit_on_eos_matches_jax(models):
    """EOS = a token row 0 emits mid-response, so rows finish at
    different steps; finished rows emit pad with a zero mask."""
    _, fixed = _run_both(models, max_new_tokens=10, eos_token_id=-1)
    eos = int(fixed["response_tokens"][0, 3])
    jout, tout = _run_both(models, max_new_tokens=10, eos_token_id=eos)
    assert not tout["response_mask"].all()
    _assert_same(jout, tout)


def test_group_size_two_matches_jax(models):
    jout, tout = _run_both(models, group_size=2, max_new_tokens=6,
                           eos_token_id=-1)
    assert tout["response_tokens"].shape == (6, 6)
    _assert_same(jout, tout)


@pytest.mark.parametrize("cache", ["int8", "bfloat16"])
def test_group_size_two_rollout_config_expands_the_cache(cache):
    """group_size = 2 through build_generate_fn on the rollout
    configuration (flash prefill, int8 weight tree, an int8 or bf16
    cache through the decode kernel, whose fill is the cache's 0-dim
    device column) matches the JAX package's group_size = 2 on the same
    quantized tree: the same tokens, masks and lengths, logps to 5e-2
    (bf16 activations rounded in another order). ``_expand`` repeats
    every batch leaf and passes the column through, so each prompt's two
    rows also decode exactly as the prompt alone does (logps to 1e-4)."""
    kw = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
              num_layers=2, num_heads=2, num_kv_heads=1, max_seq_length=64,
              attention="flash", kv_cache_dtype=cache, decode_kernel="on",
              remat="none", dtype="bfloat16", param_dtype="bfloat16",
              rope_theta=10000.0)
    jm = JTransformer(JModelConfig(**kw))
    tm = Transformer(ModelConfig(**kw))
    jq = jm.quantize_weights(jm.init(jax.random.key(0)))
    tq = params_from_jax(jax.tree.map(np.asarray, jq), "cpu")
    ids, mask = (torch.from_numpy(a) for a in _prompts())
    gen = GenerationConfig(do_sample=False, max_new_tokens=5,
                           eos_token_id=-1)
    g = prng.PRNGKey(0)
    two = build_generate_fn(tm, gen, group_size=2)(tq, ids, mask, g)
    jout = j_build(jm, JGen(do_sample=False, max_new_tokens=5,
                            eos_token_id=-1), group_size=2)(
        jq, jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()),
        jax.random.key(0))
    _assert_same({k: np.asarray(v) for k, v in jout.items()},
                 {k: v.numpy() for k, v in two.items()}, logp_atol=5e-2)
    one = build_generate_fn(tm, gen)(tq, ids.repeat_interleave(2, 0),
                                     mask.repeat_interleave(2, 0), g)
    for key in ("sequences", "sequence_mask", "response_tokens",
                "response_mask", "lengths"):
        assert torch.equal(two[key], one[key]), key
    assert torch.equal(two["response_tokens"][0::2],
                       two["response_tokens"][1::2])
    np.testing.assert_allclose(two["response_logps"].numpy(),
                               one["response_logps"].numpy(), atol=1e-4)


def test_generate_text_greedy(models):
    _, _, bundle = models
    engine = GenerationEngine(bundle.model, bundle.tokenizer,
                              GenerationConfig(max_new_tokens=8,
                                               do_sample=False))
    texts, out = engine.generate_text(bundle.params, ["hello", "abc"], 16,
                                      prng.PRNGKey(0))
    assert len(texts) == 2 and all(isinstance(t, str) for t in texts)
    assert out["response_tokens"].shape == (2, 8)


@pytest.mark.parametrize("kw", [
    dict(temperature=0.7, top_p=0.9),
    dict(temperature=1.0, top_p=1.0, top_k=5),
    dict(temperature=0.5, top_p=0.5, top_k=20),
    dict(do_sample=False),
])
def test_filtered_probs_match_jax(kw):
    logits = np.random.RandomState(6).randn(4, 300).astype(np.float32) * 3
    ref = np.asarray(j_filtered_probs(jnp.asarray(logits), **kw))
    out = filtered_probs(torch.from_numpy(logits), **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_seeded_sampling_reproducible_and_filtered():
    """``sample_token`` from a key: the JAX package's tokens from the same
    key (20 keys folded from one root), reproducible, never on a
    filtered-out token, and another key gives another stream."""
    logits = np.random.RandomState(7).randn(64, 500).astype(np.float32) * 4
    kw = dict(temperature=0.7, top_p=0.9)
    root, jroot = prng.PRNGKey(123), jax.random.key(123)
    draws = []
    for step in range(20):
        tok = sample_token(prng.fold_in(root, step), torch.from_numpy(logits),
                           **kw)
        want = j_sample_token(jax.random.fold_in(jroot, step),
                              jnp.asarray(logits), **kw)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(want))
        draws.append(tok)
    draws = torch.stack(draws)
    again = sample_token(prng.fold_in(root, 0), torch.from_numpy(logits), **kw)
    assert torch.equal(again, draws[0])
    probs = filtered_probs(torch.from_numpy(logits), **kw)
    assert (probs.gather(1, draws.T.long()) > 0).all()
    other = sample_token(prng.PRNGKey(124), torch.from_numpy(logits), **kw)
    assert not torch.equal(other, draws[0])


def _run_sampled(models, group_size, per_request_seeds, **gen_kw):
    jm, jp, bundle = models
    ids, mask = _prompts()
    b = ids.shape[0] * group_size
    kw = dict(temperature=0.7, top_p=0.9, **gen_kw)
    if per_request_seeds:
        seeds = (np.arange(b, dtype=np.uint64) * 2654435761 + 5
                 ).astype(np.uint32)
        jkey, key = jnp.asarray(seeds), torch.from_numpy(
            seeds.astype(np.int64))
    else:
        jkey = jax.random.fold_in(jax.random.key(21), 10_000)
        key = prng.fold_in(prng.PRNGKey(21), 10_000)
    jout = j_build(jm, JGen(**kw), group_size=group_size,
                   per_request_seeds=per_request_seeds)(
        jp, jnp.asarray(ids), jnp.asarray(mask), jkey)
    tout = build_generate_fn(bundle.model, GenerationConfig(**kw),
                             group_size=group_size,
                             per_request_seeds=per_request_seeds)(
        bundle.params, torch.from_numpy(ids), torch.from_numpy(mask), key)
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in tout.items()})


@pytest.mark.parametrize("group_size,per_request_seeds,eos", [
    (1, False, -1), (2, False, -1), (1, True, -1), (2, True, -1),
    (2, True, "mid")])
def test_per_request_seeds_match_jax(models, group_size, per_request_seeds,
                                     eos):
    """Sampled generation (temperature 0.7, top_p 0.9) from the same key
    or the same [B*G] row seeds as the JAX package: equal sequences,
    masks, tokens and lengths, logps to 1e-5, with group_size 1 and 2,
    batch keys and per-request seeds, and with an EOS that finishes rows
    at different steps."""
    if eos == "mid":
        _, fixed = _run_sampled(models, group_size, per_request_seeds,
                                max_new_tokens=10, eos_token_id=-1)
        eos = int(fixed["response_tokens"][0, 3])
    jout, tout = _run_sampled(models, group_size, per_request_seeds,
                              max_new_tokens=10, eos_token_id=eos)
    if eos >= 0:
        assert not tout["response_mask"].all()
    _assert_same(jout, tout, logp_atol=1e-5)
