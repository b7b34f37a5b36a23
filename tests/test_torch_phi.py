"""Parity of the port's phi block with the JAX package: the flash kernels'
plain versions at head_dim 80 (phi-2's), ``apply`` logits and every
leaf's gradient on a tiny phi config (hidden 160 = 2 heads x 80, MHA,
partial rotary 0.4, 2 layers, vocab 512, T = 128 so that flash is
eligible in both packages; the JAX side runs its Pallas kernels in
interpret mode), the parameter tree through ``params_from_jax``, and the
block variants that still refuse. Inputs come from numpy seeds; each
test states its tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.models.config import get_model_config as j_get_config
from dla_tpu.models.transformer import Transformer as JTransformer
from dla_tpu.ops import fused_ce as j_fused
from dla_tpu.ops.flash_attention import flash_causal_attention as j_flash
from dla_tpu_torch.models.config import get_model_config
from dla_tpu_torch.models.transformer import Transformer
from dla_tpu_torch.models.weights import params_from_jax, params_to_numpy
from dla_tpu_torch.ops import fused_ce
from dla_tpu_torch.ops.flash_attention import (
    flash_attention_forward,
    flash_backward_plain,
    flash_causal_attention,
)
from dla_tpu_torch.ops.losses import IGNORE_INDEX
from dla_tpu_torch.training.trainer import _leaves, _train_views

T = 128
TINY_PHI = dict(vocab_size=512, hidden_size=160, intermediate_size=320,
                num_layers=2, num_heads=2, num_kv_heads=2,
                max_seq_length=T, param_dtype="float32", dtype="float32")


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _phi_models(**over):
    """(JAX model, JAX params, port model, port params): the tiny phi
    config in both packages, the port's tree converted from JAX's, whose
    zero-initialised biases are replaced by random ones (so that every
    bias term is exercised)."""
    jm = JTransformer(j_get_config("phi-2", **TINY_PHI, **over))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    rs = np.random.RandomState(11)
    for name in ("wq_bias", "wk_bias", "wv_bias", "wo_bias", "fc1_bias",
                 "fc2_bias", "ln_bias"):
        jp["layers"][name] = (0.05 * rs.randn(
            *jp["layers"][name].shape)).astype(np.float32)
    for name in ("final_norm_bias", "lm_head_bias"):
        jp[name] = (0.05 * rs.randn(*jp[name].shape)).astype(np.float32)
    tm = Transformer(get_model_config("phi-2", **TINY_PHI, **over))
    return jm, jp, tm, params_from_jax(jp, "cpu")


def _batch(kind: str, b: int = 2, seed: int = 3):
    """Right-padded rows, or packed rows with segment ids (each
    segment's first label masked, as the packer does)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, 512, (b, T)).astype(np.int32)
    labels = ids.copy()
    batch = {"input_ids": ids}
    if kind == "padded":
        mask = np.ones((b, T), np.int32)
        mask[1, T - 37:] = 0
        labels[mask == 0] = IGNORE_INDEX
    else:
        seg = np.zeros((b, T), np.int32)
        seg[0, :40], seg[0, 40:90], seg[0, 90:] = 1, 2, 3
        seg[1, :70], seg[1, 70:110] = 1, 2
        labels[seg == 0] = IGNORE_INDEX
        labels[:, 0] = IGNORE_INDEX
        labels[0, [40, 90]] = IGNORE_INDEX
        labels[1, 70] = IGNORE_INDEX
        mask = (seg > 0).astype(np.int32)
        batch["segment_ids"] = seg
    batch["attention_mask"] = mask
    batch["labels"] = labels
    return batch


# ------------------------------------------------------------ flash, D=80

@pytest.mark.parametrize("segments", [False, True])
def test_flash_head_dim_80_matches_pallas(segments):
    """#1 / #2 / #3 at phi-2's head_dim 80 (MHA, GQA group 1): the
    forward and the backward the port's wrappers compute on CPU tensors
    against the Pallas flash attention and its ``jax.vjp`` in interpret
    mode, fp32, 1e-4 (sums in another order)."""
    rs = np.random.RandomState(5)
    b, h, d = 2, 2, 80
    q, k, v, g = (rs.randn(b, T, h, d).astype(np.float32) for _ in range(4))
    seg = None
    if segments:
        seg = np.zeros((b, T), np.int32)
        seg[0, :50], seg[0, 50:120] = 1, 2
        seg[1, :T - 9] = 1
    jseg = None if seg is None else jnp.asarray(seg)
    tseg = None if seg is None else torch.from_numpy(seg)

    def f(q, k, v):
        return j_flash(q, k, v, segment_ids=jseg, interpret=True)
    ref, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    refs = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention_forward(tq, tk, tv, segment_ids=tseg)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-4, rtol=1e-4)
    grads = flash_backward_plain(tq, tk, tv, out, lse, torch.from_numpy(g),
                                 segment_ids=tseg)
    for got, r in zip(grads, refs):
        np.testing.assert_allclose(_np(got), _np(r), atol=1e-4, rtol=1e-4)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    got = torch.autograd.grad(flash_causal_attention(
        *leaves, segment_ids=tseg), leaves, torch.from_numpy(g))
    for a, r in zip(got, refs):
        np.testing.assert_allclose(_np(a), _np(r), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------- the block

@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("kind", ["padded", "packed"])
def test_phi_apply_logits_match_jax(kind, attention):
    """``apply`` of the phi block (shared LayerNorm, partial rotary,
    parallel residual, GELU(tanh) MLP, biased final LayerNorm and
    lm_head) on padded and packed rows, einsum and flash attention: fp32
    logits to 1e-4."""
    jm, jp, tm, tp = _phi_models(attention=attention)
    batch = _batch(kind)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref = jm.apply(jp, jb["input_ids"], jb["attention_mask"],
                   jb.get("segment_ids"))
    with torch.no_grad():
        got = tm.apply(tp, tb["input_ids"], tb["attention_mask"],
                       tb.get("segment_ids"))
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("attention,kind,remat", [
    ("flash", "packed", "full"),
    ("xla", "padded", "none"),
])
def test_phi_gradients_match_jax(attention, kind, remat):
    """Every leaf's gradient of the CE with the lm_head bias
    (``model_fused_ce``: hidden_states -> the fused CE) and of a random
    projection of ``hidden_states`` against ``jax.grad`` through the
    Pallas kernels: fp32, 1e-4 relative to each leaf's largest
    gradient."""
    jm, jp, tm, tp = _phi_models(attention=attention, remat=remat)
    batch = _batch(kind)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    cot = np.random.RandomState(9).randn(2, T, 160).astype(np.float32)

    def j_loss(p):
        ce = j_fused.model_fused_ce(jm, p, jb, chunk=64)[0]
        h = jm.hidden_states(p, jb["input_ids"], jb["attention_mask"],
                             jb.get("segment_ids"))
        return ce + jnp.sum(h * jnp.asarray(cot)) * 1e-3
    jl, jg = jax.value_and_grad(j_loss)(jp)

    views = _train_views(tp)
    for leaf in _leaves(views):
        leaf.requires_grad_(True)
    ce, _ = fused_ce.model_fused_ce(tm, views, tb, chunk=64)
    h = tm.hidden_states(views, tb["input_ids"], tb["attention_mask"],
                         tb.get("segment_ids"))
    loss = ce + (h * torch.from_numpy(cot)).sum() * 1e-3
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    got = {"embed": views["embed"]["embedding"].grad}
    for name in ("final_norm", "final_norm_bias", "lm_head", "lm_head_bias"):
        got[name] = views[name].grad
    for name in views["layers"][0]:
        got[f"layers.{name}"] = torch.stack(
            [layer[name].grad for layer in views["layers"]])
    ref = {"embed": jg["embed"]["embedding"],
           **{k: jg[k] for k in ("final_norm", "final_norm_bias", "lm_head",
                                 "lm_head_bias")},
           **{f"layers.{k}": v for k, v in jg["layers"].items()}}
    assert set(ref) == set(got)
    for name, r in ref.items():
        r = _np(r)
        scale = np.abs(r).max()
        np.testing.assert_allclose(_np(got[name]) / scale, r / scale,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_carries_the_phi_tree(dtype):
    """The JAX phi tree (``ln``/``ln_bias``, biased projections,
    ``fc1``/``fc2``, ``final_norm_bias``, untied ``lm_head`` +
    ``lm_head_bias``) converts leaf for leaf, bf16 and fp32, and back
    through ``params_to_numpy`` exactly; the port's own ``init`` draws
    the same leaf names, shapes and dtypes."""
    over = dict(TINY_PHI, param_dtype=dtype)
    jm = JTransformer(j_get_config("phi-2", **over))
    jp = jm.init(jax.random.key(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    mine = Transformer(get_model_config("phi-2", **over)).init(
        torch.Generator().manual_seed(0))
    j_leaves = dict(jax.tree_util.tree_leaves_with_path(jp))
    t_leaves = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(tp)))
    own = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda x: x, mine,
                     is_leaf=lambda x: torch.is_tensor(x))))
    assert set(j_leaves) == set(t_leaves) == set(own)
    assert any("lm_head_bias" in jax.tree_util.keystr(k) for k in j_leaves)
    for path, j in j_leaves.items():
        np.testing.assert_array_equal(t_leaves[path],
                                      np.asarray(j, np.float32))
        assert tuple(own[path].shape) == j.shape
        assert own[path].dtype == getattr(torch, dtype)


def test_gemma2_and_lora_phi_refused_at_construction():
    """A gemma2 block and a LoRA phi student refuse at construction,
    naming ROADMAP.md (phi generation itself is held against the JAX
    package in test_torch_phi_generation.py)."""
    _, _, tm, _ = _phi_models()
    for over in (dict(arch="gemma2"), dict(lora_r=4)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Transformer(dataclasses.replace(tm.cfg, **over))
