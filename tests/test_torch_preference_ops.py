"""Parity of the port's preference-training modules with the JAX package:
the four losses, the fused sequence and segment log-probs (values and
gradients), ``RewardModel.apply`` on padded and packed rows, reward trees
carried across (``params_from_jax`` / ``params_to_numpy``) and
``build_reward_model``. Inputs come from numpy seeds; the JAX side runs
its Pallas flash kernel in interpret mode, the port its plain versions
(CPU tensors). Each test states its tolerance."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.checkpoint.checkpointer import Checkpointer as JCheckpointer
from dla_tpu.checkpoint.checkpointer import load_tree_numpy as j_load
from dla_tpu.models.config import get_model_config as j_get_config
from dla_tpu.models.reward import RewardModel as JRewardModel
from dla_tpu.ops import fused_ce as j_fused
from dla_tpu.ops import losses as j_losses
from dla_tpu.training.model_io import build_reward_model as j_build_rm
from dla_tpu_torch.models.config import get_model_config
from dla_tpu_torch.models.reward import RewardModel
from dla_tpu_torch.models.weights import params_from_jax, params_to_numpy
from dla_tpu_torch.ops import fused_ce, losses
from dla_tpu_torch.training.model_io import build_reward_model

CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / "run" / "final"


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("loss,smoothing,masked", [
    ("dpo", 0.0, False), ("dpo", 0.1, False), ("dpo", 0.0, True),
    ("dpo", 0.1, True), ("pairwise", None, False), ("pairwise", None, True),
    ("masked_mean", None, False), ("masked_mean", None, True),
    ("sequence_logprob_mean", None, False)])
def test_losses_match_jax(loss, smoothing, masked):
    """``dpo_loss`` (loss and margin) over label smoothing {0, 0.1} x pair
    mask {None, mask}, ``pairwise_reward_loss``, ``masked_mean`` and
    ``sequence_logprob_mean``: fp32, 1e-6 (the same arithmetic)."""
    rs = np.random.RandomState(5)
    x = [rs.randn(3, 4).astype(np.float32) for _ in range(4)]
    mask = (rs.rand(3, 4) > 0.3).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    jx = [jnp.asarray(a) for a in x]
    tx = [torch.from_numpy(a) for a in x]
    if loss == "dpo":
        ref = j_losses.dpo_loss(*jx, 0.5, smoothing, valid=jm)
        got = losses.dpo_loss(*tx, 0.5, smoothing, valid=tm)
    elif loss == "pairwise":
        ref = [j_losses.pairwise_reward_loss(jx[0], jx[1], valid=jm)]
        got = [losses.pairwise_reward_loss(tx[0], tx[1], valid=tm)]
    elif loss == "masked_mean":
        ref = [j_losses.masked_mean(jx[0], jm)]
        got = [losses.masked_mean(tx[0], tm)]
    else:
        logits = rs.randn(2, 9, 30).astype(np.float32) * 2
        ids = rs.randint(0, 30, (2, 9)).astype(np.int32)
        m = np.ones((2, 9), np.int32)
        m[1, 6:] = 0
        ref = [j_losses.sequence_logprob_mean(
            jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(m))]
        got = [losses.sequence_logprob_mean(
            torch.from_numpy(logits), torch.from_numpy(ids),
            torch.from_numpy(m))]
    for a, b in zip(got, ref):
        _close(a, b, 1e-6)


# ------------------------------------------------------------ fused logp

def _segments_batch(rs, b=2, t=12, v=40):
    ids = rs.randint(0, v, (b, t)).astype(np.int32)
    seg = np.zeros((b, t), np.int32)
    seg[0, :5], seg[0, 5:] = 1, 2
    seg[1, :4], seg[1, 4:8] = 1, 2
    return ids, seg


@pytest.mark.parametrize("kind", ["sequence", "segment"])
@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_fused_logprobs_and_grads_match_jax(kind, chunk):
    """``fused_sequence_logprob_mean`` ([B], right-padded rows) and
    ``fused_segment_logprob_mean`` ([B, 3] over packed rows, one segment
    absent) and their d(hidden), d(w) under a random cotangent, against
    ``jax.vjp`` of the JAX functions, over chunks of 1, 5 (not dividing
    the 2 x 11 shifted rows) and 64 (one tile): fp32, 1e-5 (sums in
    another order)."""
    rs = np.random.RandomState(7)
    b, t, d, v = 2, 12, 16, 40
    h = rs.randn(b, t, d).astype(np.float32)
    w = (rs.randn(d, v) * 0.3).astype(np.float32)
    ids, seg = _segments_batch(rs, b, t, v)
    if kind == "sequence":
        mask = np.ones((b, t), np.int32)
        mask[1, 8:] = 0
        g = rs.randn(b).astype(np.float32)

        def jf(hh, ww):
            return j_fused.fused_sequence_logprob_mean(
                hh, ww, jnp.asarray(ids), jnp.asarray(mask), chunk=chunk)

        def tf(hh, ww):
            return fused_ce.fused_sequence_logprob_mean(
                hh, ww, torch.from_numpy(ids), torch.from_numpy(mask),
                chunk=chunk)
    else:
        mask = (seg > 0).astype(np.int32)
        g = rs.randn(b, 3).astype(np.float32)

        def jf(hh, ww):
            return j_fused.fused_segment_logprob_mean(
                hh, ww, jnp.asarray(ids), jnp.asarray(mask),
                jnp.asarray(seg), 3, chunk=chunk)

        def tf(hh, ww):
            return fused_ce.fused_segment_logprob_mean(
                hh, ww, torch.from_numpy(ids), torch.from_numpy(mask),
                torch.from_numpy(seg), 3, chunk=chunk)
    ref, vjp = jax.vjp(jf, jnp.asarray(h), jnp.asarray(w))
    ref_dh, ref_dw = vjp(jnp.asarray(g))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = tf(th, tw)
    (got * torch.from_numpy(g)).sum().backward()
    _close(got, ref, 1e-5)
    _close(th.grad, ref_dh, 1e-5)
    _close(tw.grad, ref_dw, 1e-5)
    if kind == "segment":
        assert got[1, 2].item() == 0.0          # absent segment


def test_model_fused_logprobs_refuse_bias_and_softcap():
    """The model-level log-probs refuse what the fused path does not
    compute yet (an lm_head bias, a final-logit softcap)."""
    import dataclasses
    from dla_tpu_torch.models.transformer import Transformer
    cfg = dataclasses.replace(get_model_config("tiny"),
                              final_logit_softcap=30.0)
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_ce.model_fused_sequence_logprob(model, params, ids,
                                              torch.ones_like(ids))
    sub = {"input_ids": ids, "attention_mask": torch.ones_like(ids),
           "segment_ids": torch.ones_like(ids)}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_ce.model_fused_segment_logprob(model, params, sub, 1)


# ---------------------------------------------------------- reward model

def _reward_models(pooling: str, attention: str):
    cfg_j = j_get_config("tiny", attention=attention)
    jm = JRewardModel(cfg_j, pooling=pooling)
    jp = jm.init(jax.random.key(1))
    tm = RewardModel(get_model_config("tiny", attention=attention),
                     pooling=pooling)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _reward_batch(kind: str, b: int = 2, t: int = 24):
    rs = np.random.RandomState(9)
    ids = rs.randint(3, 512, (b, t)).astype(np.int32)
    if kind == "padded":
        mask = np.ones((b, t), np.int32)
        mask[1, t - 9:] = 0
        return ids, mask, None
    seg = np.zeros((b, t), np.int32)
    seg[0, :7], seg[0, 7:15], seg[0, 15:] = 1, 2, 3
    seg[1, :10], seg[1, 10:19] = 1, 2
    return ids, (seg > 0).astype(np.int32), seg


@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("rows", ["padded", "packed"])
@pytest.mark.parametrize("pooling", ["last_token", "mean"])
def test_reward_apply_matches_jax(pooling, rows, attention):
    """``RewardModel.apply`` against the JAX reward model from the same
    weights (tiny, fp32): [B] rewards of right-padded rows, [B, 3]
    per-segment rewards of packed rows, einsum and flash attention, to
    1e-4 (the bound of the causal LM's logits test). The port's absent
    segment (row 1, segment 3) reads 0."""
    jm, jp, tm, tp = _reward_models(pooling, attention)
    ids, mask, seg = _reward_batch(rows)
    kw_j, kw_t = {}, {}
    if seg is not None:
        kw_j = {"segment_ids": jnp.asarray(seg), "n_segments": 3}
        kw_t = {"segment_ids": torch.from_numpy(seg), "n_segments": 3}
    ref = np.asarray(jm.apply(jp, jnp.asarray(ids), jnp.asarray(mask),
                              **kw_j))
    with torch.no_grad():
        got = tm.apply(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                       **kw_t).numpy()
    if seg is None:
        _close(got, ref, 1e-4)
    else:
        present = np.array([[1, 1, 1], [1, 1, 0]], bool)
        _close(got[present], ref[present], 1e-4)
        assert got[1, 2] == 0.0


@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("pooling", ["last_token", "mean"])
def test_packed_rewards_equal_unpacked(pooling, attention):
    """Five sequences scored one per right-padded row and packed three and
    two to a row: each segment's reward equals its row's (positions
    restart and attention stays inside the segment), fp32, 1e-5."""
    _, _, tm, tp = _reward_models(pooling, attention)
    rs = np.random.RandomState(13)
    lens = [6, 9, 5, 11, 8]
    t = 24
    seqs = [rs.randint(3, 512, n).astype(np.int32) for n in lens]
    ids = np.zeros((len(seqs), t), np.int32)
    mask = np.zeros((len(seqs), t), np.int32)
    for i, s in enumerate(seqs):
        ids[i, :len(s)], mask[i, :len(s)] = s, 1
    pids = np.zeros((2, t), np.int32)
    pseg = np.zeros((2, t), np.int32)
    place = [(0, 1), (0, 2), (0, 3), (1, 1), (1, 2)]
    fill = [0, 0]
    for s, (row, sid) in zip(seqs, place):
        pids[row, fill[row]:fill[row] + len(s)] = s
        pseg[row, fill[row]:fill[row] + len(s)] = sid
        fill[row] += len(s)
    with torch.no_grad():
        alone = tm.apply(tp, torch.from_numpy(ids), torch.from_numpy(mask))
        packed = tm.apply(tp, torch.from_numpy(pids),
                          torch.from_numpy((pseg > 0).astype(np.int32)),
                          segment_ids=torch.from_numpy(pseg), n_segments=3)
    got = np.array([float(packed[row, sid - 1]) for row, sid in place])
    _close(got, alone, 1e-5)


def test_reward_dropout_uses_the_generator():
    """Dropout on the pooled feature: none without a generator, the same
    mask from generators seeded alike, another from another seed."""
    _, _, _, tp = _reward_models("last_token", "xla")
    tm = RewardModel(get_model_config("tiny"), dropout=0.5)
    ids, mask, _ = _reward_batch("padded")
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        plain = tm.apply(tp, ids, mask)
        a = tm.apply(tp, ids, mask, generator=torch.Generator().manual_seed(1))
        b = tm.apply(tp, ids, mask, generator=torch.Generator().manual_seed(1))
        c = tm.apply(tp, ids, mask, generator=torch.Generator().manual_seed(2))
    assert torch.equal(plain, tm.apply(tp, ids, mask))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, plain)


def test_reward_tree_carries_across():
    """A JAX reward tree (backbone and ``reward_head``) goes to the port
    and back through ``params_from_jax`` / ``params_to_numpy`` exactly,
    fp32 and bf16 leaves alike."""
    for dtype in ("float32", "bfloat16"):
        jm = JRewardModel(j_get_config("tiny", param_dtype=dtype))
        jp = jm.init(jax.random.key(2))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        assert set(tp) == set(jp) and "lm_head" not in tp
        assert tp["reward_head"]["w"].dtype == getattr(torch, dtype)
        back = params_to_numpy(tp)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                                jax.tree.leaves(back)):
            np.testing.assert_array_equal(
                np.asarray(a, np.float32), b, err_msg=str(path))


@pytest.mark.parametrize("case", ["preset", "warm_start", "reward_ckpt"])
def test_build_reward_model_matches_jax(case, tmp_path):
    """``build_reward_model``'s three sources against the JAX package's:
    a preset (same tree, shapes and dtypes; a fresh N(0, 1/D) head with
    b = 0), a warm start from the causal-LM checkpoint the JAX package
    wrote (its backbone exactly, ``lm_head`` dropped, a fresh head), and
    a reward checkpoint the JAX package wrote (every leaf exactly, and
    rewards to 1e-4)."""
    g = torch.Generator().manual_seed(0)
    if case == "preset":
        cfg = {"base_model_name_or_path": "tiny", "tokenizer": "byte",
               "pooling": "mean", "dropout": 0.1}
    else:
        cfg = {"base_model_name_or_path": str(CKPT)}
    jb = j_build_rm(cfg, jax.random.key(4))
    if case == "reward_ckpt":
        JCheckpointer(str(tmp_path)).save(
            0, {"params": jb.params},
            {"model_config": jb.config.to_dict(), "tokenizer": "byte"})
        cfg = {"base_model_name_or_path": str(tmp_path)}
    tb = build_reward_model(cfg, g, device="cpu")
    assert isinstance(tb.model, RewardModel)
    assert (tb.model.pooling, tb.model.dropout) == (jb.model.pooling,
                                                    jb.model.dropout)
    jleaves = dict(jax.tree_util.tree_leaves_with_path(jb.params))
    tleaves = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(tb.params)))
    assert set(jleaves) == set(tleaves)
    for path, a in jleaves.items():
        assert tleaves[path].shape == a.shape, path
    head = tb.params["reward_head"]
    if case != "reward_ckpt":
        assert float(head["b"].abs().max()) == 0.0
        std = float(head["w"].std()) * 64 ** 0.5
        assert 0.5 < std < 1.5
    if case == "warm_start":
        saved, _ = j_load(CKPT, prefix="params")
        assert "lm_head" in saved and "lm_head" not in tb.params
        np.testing.assert_array_equal(
            tleaves[(jax.tree_util.DictKey("layers"),
                     jax.tree_util.DictKey("wq"))], saved["layers"]["wq"])
    if case == "reward_ckpt":
        for path, a in jleaves.items():
            np.testing.assert_array_equal(tleaves[path], np.asarray(a))
        ids, mask, _ = _reward_batch("padded")
        ref = jb.model.apply(jb.params, jnp.asarray(ids), jnp.asarray(mask))
        with torch.no_grad():
            got = tb.model.apply(tb.params, torch.from_numpy(ids),
                                 torch.from_numpy(mask))
        _close(got, ref, 1e-4)
