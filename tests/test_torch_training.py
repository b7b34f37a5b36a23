"""SFT-path parity between the JAX package and the PyTorch port.

The same numpy inputs (and, through ``params_from_jax``, the same
weights) go through both packages on the CPU, in fp32 unless a test is
about bf16. The port's flash attention runs its plain versions here
(CPU tensors); the JAX side runs its Pallas kernels in interpret mode.
Tolerances, with their reasons, sit beside each comparison."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from dla_tpu.data.datasets import InstructionDataset as JInstructionDataset
from dla_tpu.data.iterator import ShardedBatchIterator as JIterator
from dla_tpu.data.loaders import load_instruction_records as j_records
from dla_tpu.data.packing import PackedInstructionDataset as JPacked
from dla_tpu.data.tokenizers import ByteTokenizer as JByteTokenizer
from dla_tpu.models.config import get_model_config as j_get_config
from dla_tpu.models.transformer import Transformer as JTransformer
from dla_tpu.ops import fused_ce as j_fused
from dla_tpu.ops import losses as j_losses
from dla_tpu.training import optim as j_optim
from dla_tpu_torch.checkpoint.checkpointer import Checkpointer
from dla_tpu_torch.data.datasets import InstructionDataset
from dla_tpu_torch.data.iterator import ShardedBatchIterator
from dla_tpu_torch.data.jsonl import write_jsonl
from dla_tpu_torch.data.loaders import load_instruction_records
from dla_tpu_torch.data.packing import PackedInstructionDataset
from dla_tpu_torch.data.tokenizers import ByteTokenizer
from dla_tpu_torch.models.config import get_model_config
from dla_tpu_torch.models.transformer import Transformer
from dla_tpu_torch.models.weights import params_from_jax
from dla_tpu_torch.ops import fused_ce, losses
from dla_tpu_torch.training import optim
from dla_tpu_torch.training.config import load_config
from dla_tpu_torch.training.train_sft import main as sft_main
from dla_tpu_torch.training.train_sft import make_sft_loss
from dla_tpu_torch.training.trainer import Trainer, _leaves, _train_views


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _records(n: int, seed: int = 0, lo: int = 4, hi: int = 40):
    rs = np.random.RandomState(seed)
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta"]

    def text(k):
        return " ".join(rs.choice(words, k))
    return [{"prompt": text(rs.randint(1, 6)),
             "response": text(rs.randint(lo, hi) // 4 + 1)}
            for _ in range(n)]


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("chunk", [5, 1, 64])
def test_fused_ce_loss_and_grads_match_jax(chunk):
    """Loss and d(hidden), d(w) of the chunked fused CE against the JAX
    custom_vjp, over 2 x 12 shifted rows: a chunk (5) that does not divide
    them, one row per chunk, and one tile for all. fp32 sums in another
    order (1e-5)."""
    rs = np.random.RandomState(0)
    b, t, d, v = 2, 13, 16, 40
    h = rs.randn(b, t, d).astype(np.float32)
    w = (rs.randn(d, v) * 0.3).astype(np.float32)
    labels = rs.randint(0, v, (b, t)).astype(np.int32)
    labels[0, :4] = losses.IGNORE_INDEX

    def jloss(h, w):
        return j_fused.fused_cross_entropy_loss(
            h, w, jnp.asarray(labels), chunk=chunk)[0]
    jl, jgrads = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl, n = fused_ce.fused_cross_entropy_loss(
        th, tw, torch.from_numpy(labels), chunk=chunk)
    tl.backward()
    assert int(n) == int((labels[:, 1:] != losses.IGNORE_INDEX).sum())
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for got, ref in zip([th, tw], jgrads):
        np.testing.assert_allclose(_np(got.grad), _np(ref), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("case", ["bias", "softcap"])
def test_model_fused_ce_refuses_bias_and_softcap(case):
    """A final-logit softcap is not ported into the fused CE: it raises
    instead of training another objective. An lm_head bias is ported
    (phi-2's): the fused CE with it equals the CE of the materialized
    logits, bias included, to 1e-5."""
    over = {"final_logit_softcap": 30.0} if case == "softcap" else {}
    model = Transformer(get_model_config("tiny", dtype="float32", **over))
    params = model.init(torch.Generator().manual_seed(0))
    ids = torch.randint(3, 512, (2, 8), generator=torch.Generator()
                        .manual_seed(1))
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids),
             "labels": ids}
    if case == "softcap":
        with pytest.raises(NotImplementedError,
                           match="architecture-branches"):
            fused_ce.model_fused_ce(model, params, batch)
        return
    params["lm_head_bias"] = torch.randn(
        model.cfg.vocab_size, generator=torch.Generator().manual_seed(2))
    fused, _ = fused_ce.model_fused_ce(model, params, batch, chunk=5)
    plain, _ = losses.cross_entropy_loss(model.apply(params, ids), ids)
    np.testing.assert_allclose(float(fused), float(plain), rtol=1e-5)


def test_unfused_losses_match_jax():
    """token_logprobs (targets clipped to the vocab) and the token-mean
    cross_entropy_loss on materialized logits: 1e-5."""
    rs = np.random.RandomState(1)
    logits = rs.randn(2, 9, 30).astype(np.float32)
    labels = rs.randint(0, 35, (2, 9)).astype(np.int32)   # some >= V
    labels[1, 3:] = losses.IGNORE_INDEX
    jl, jn = j_losses.cross_entropy_loss(jnp.asarray(logits),
                                         jnp.asarray(labels))
    tl, tn = losses.cross_entropy_loss(torch.from_numpy(logits),
                                       torch.from_numpy(labels))
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(
        losses.token_logprobs(torch.from_numpy(logits),
                              torch.from_numpy(labels)).numpy(),
        _np(j_losses.token_logprobs(jnp.asarray(logits),
                                    jnp.asarray(labels))), atol=1e-5)


# ------------------------------------------------------------------- model

def _models(**over):
    jcfg = j_get_config("tiny", **over)
    jm = JTransformer(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = Transformer(get_model_config("tiny", **over))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _batch(kind: str, b: int = 2, t: int = 32, vocab: int = 512,
           seed: int = 3):
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, vocab, (b, t)).astype(np.int32)
    labels = ids.copy()
    batch = {"input_ids": ids}
    if kind == "padded":
        mask = np.ones((b, t), np.int32)
        mask[1, t - 7:] = 0
        labels[mask == 0] = losses.IGNORE_INDEX
        batch["attention_mask"] = mask
    else:   # packed: three segments in row 0, two + pads in row 1
        seg = np.zeros((b, t), np.int32)
        seg[0, :10], seg[0, 10:22], seg[0, 22:] = 1, 2, 3
        seg[1, :15], seg[1, 15:27] = 1, 2
        labels[seg == 0] = losses.IGNORE_INDEX
        labels[:, 0] = losses.IGNORE_INDEX
        labels[0, [10, 22]] = losses.IGNORE_INDEX
        labels[1, 15] = losses.IGNORE_INDEX
        batch["attention_mask"] = (seg > 0).astype(np.int32)
        batch["segment_ids"] = seg
    batch["labels"] = labels
    return batch


@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("kind", ["padded", "packed"])
def test_apply_logits_match_jax(kind, attention):
    """``apply`` (hidden_states + unembed) on padded and packed batches,
    einsum and flash attention: fp32 logits to 1e-4 (the bound of the
    rollout slice's prefill test)."""
    jm, jp, tm, tp = _models(attention=attention)
    batch = _batch(kind)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref = jm.apply(jp, jb["input_ids"], jb["attention_mask"],
                   jb.get("segment_ids"))
    with torch.no_grad():
        got = tm.apply(tp, tb["input_ids"], tb["attention_mask"],
                       tb.get("segment_ids"))
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=1e-4)


def _grads_by_name(tm, tp, batch):
    views = _train_views(tp)
    for leaf in _leaves(views):
        leaf.requires_grad_(True)
    loss, _ = fused_ce.model_fused_ce(
        tm, views, {k: torch.from_numpy(v) for k, v in batch.items()},
        chunk=16)
    loss.backward()
    out = {"embed": views["embed"]["embedding"].grad,
           "final_norm": views["final_norm"].grad}
    for name in views["layers"][0]:
        out[f"layers.{name}"] = torch.stack(
            [layer[name].grad for layer in views["layers"]])
    return float(loss), out


@pytest.mark.parametrize("attention,kind,remat", [
    ("flash", "packed", "full"),
    ("xla", "padded", "none"),
])
def test_sft_loss_gradients_match_jax(attention, kind, remat):
    """Gradients of the SFT loss (hidden_states -> fused CE, tied
    embedding taking both the lookup's and the CE's dW) for every leaf,
    the port's autograd through per-layer views and the flash autograd
    Function vs jax.grad through the Pallas kernels: fp32, 1e-4 relative
    to each leaf's largest gradient (sums in another order)."""
    jm, jp, tm, tp = _models(attention=attention, remat=remat,
                             tie_embeddings=True)
    batch = _batch(kind)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(
        lambda p: j_fused.model_fused_ce(jm, p, jb, chunk=16)[0])(jp)
    tl, tg = _grads_by_name(tm, tp, batch)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    ref = {"embed": jg["embed"]["embedding"], "final_norm": jg["final_norm"],
           **{f"layers.{k}": v for k, v in jg["layers"].items()}}
    assert set(ref) == set(tg)
    for name, r in ref.items():
        r = _np(r)
        scale = np.abs(r).max()
        np.testing.assert_allclose(_np(tg[name]) / scale, r / scale,
                                   atol=1e-4, err_msg=name)


def test_per_layer_views_are_the_leaves():
    """The trainer's autograd leaves are per-layer views of the stacked
    tensors: one gradient per layer (no stacked zero gradients), and an
    in-place update of a view lands in the stacked storage."""
    _, _, tm, tp = _models()
    views = _train_views(tp)
    for leaf in _leaves(views):
        leaf.requires_grad_(True)
    wq0 = views["layers"][0]["wq"]
    assert wq0.is_leaf and wq0._base is tp["layers"]["wq"]
    loss, _ = fused_ce.model_fused_ce(
        tm, views, {k: torch.from_numpy(v)
                    for k, v in _batch("padded").items()})
    loss.backward()
    assert wq0.grad.shape == wq0.shape
    assert tp["layers"]["wq"].grad is None
    with torch.no_grad():
        wq0.add_(1.0)
    assert torch.equal(tp["layers"]["wq"][0], wq0)


def test_unported_options_raise(tmp_path):
    tm = Transformer(get_model_config("tiny", remat="dots"))
    tp = tm.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.hidden_states(tp, torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optim.build_optimizer({"optimizer": "adafactor"}, [])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_instruction_records({"source": "hf", "hf_path": "x"})


# ------------------------------------------------------------- optimizer

@pytest.mark.parametrize("cfg", [
    dict(lr_scheduler="cosine", warmup_steps=3, max_train_steps=10),
    dict(lr_scheduler="cosine", warmup_steps=0, max_train_steps=6),
    dict(lr_scheduler="constant", warmup_steps=3, max_train_steps=8),
])
def test_schedule_matches_optax(cfg):
    """The lr of update n (n counted from 0, so a 0-init warmup starts at
    lr 0) against the optax schedule, fp32 rounding only."""
    cfg = {"learning_rate": 2e-3, **cfg}
    j = j_optim.build_schedule(cfg)
    t = optim.build_schedule(cfg)
    steps = range(cfg["max_train_steps"] + 3)
    np.testing.assert_allclose([t(s) for s in steps],
                               [float(j(s)) for s in steps], rtol=1e-6,
                               atol=1e-12)
    assert t(0) == 0.0       # every warmup starts from init_value 0


def test_clip_and_adamw_match_optax_over_five_steps():
    """Five updates of clip_by_global_norm + AdamW (wd on every leaf)
    against optax on the same gradients; the norm crosses max_norm, so
    both branches run. Params to 1e-6: the same fp32 formula in another
    operation order."""
    rs = np.random.RandomState(2)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    cfg = {"learning_rate": 1e-2, "warmup_steps": 2, "max_train_steps": 5,
           "weight_decay": 0.1, "max_grad_norm": 1.0}
    jopt, _ = j_optim.build_optimizer(cfg)
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    topt, sched = optim.build_optimizer(cfg, tp)
    norms = []
    for step in range(5):
        scale = [0.1, 3.0, 0.5, 2.0, 0.05][step]   # below / above the clip
        grads = [(rs.randn(*s) * scale).astype(np.float32) for s in shapes]
        upd, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        tg = [torch.from_numpy(g.copy()) for g in grads]
        norms.append(optim.clip_by_global_norm_(tg, cfg["max_grad_norm"]))
        for p, g in zip(tp, tg):
            p.grad = g
        for group in topt.param_groups:
            group["lr"] = sched(step)
        topt.step()
        np.testing.assert_allclose(
            norms[-1], float(optax.global_norm([jnp.asarray(g)
                                                for g in grads])), rtol=1e-6)
    assert min(norms) < 1.0 < max(norms)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6, rtol=1e-6)


# -------------------------------------------------------------------- data

def test_dataset_packing_and_iterator_match_jax(tmp_path):
    """Tokenized examples, padded batches, first-fit packed rows and the
    seeded epoch order are identical to the JAX package's (exact)."""
    recs = _records(40)
    tds = InstructionDataset(ByteTokenizer(), 64, records=recs)
    jds = JInstructionDataset(JByteTokenizer(), 64, records=recs)
    for i in (0, 7):
        for k, v in jds[i].items():
            np.testing.assert_array_equal(tds[i][k], v)
    tb = tds.collate([tds[i] for i in range(4)])
    jb = jds.collate([jds[i] for i in range(4)])
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    tpk, jpk = PackedInstructionDataset(tds, 64), JPacked(jds, 64)
    assert tpk.rows == jpk.rows and len(tpk) == len(jpk) > 4
    assert tpk.packing_efficiency() == jpk.packing_efficiency()
    ti = iter(ShardedBatchIterator(tpk, 3, seed=5))
    ji = iter(JIterator(jpk, 3, seed=5))
    for _ in range(len(tpk) // 3 + 2):        # crosses an epoch boundary
        a, b = next(ti), next(ji)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_mixture_records_match_jax(tmp_path):
    """data.mixture: weighted, resampled, seeded epoch — same records in
    the same order as the JAX loader."""
    write_jsonl(tmp_path / "a.jsonl", _records(7, seed=1))
    write_jsonl(tmp_path / "b.jsonl", _records(4, seed=2))
    cfg = {"limit": 6, "mixture_size": 15, "mixture_seed": 3,
           "mixture": [{"path": str(tmp_path / "a.jsonl"), "weight": 2.0},
                       {"path": str(tmp_path / "b.jsonl")}]}
    assert load_instruction_records(cfg) == j_records(cfg)


def test_config_overlays_and_overrides(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text(yaml.safe_dump({"model": {"a": 1, "b": {"c": 2}},
                                    "lst": [1, 2]}))
    ov = tmp_path / "ov.yaml"
    ov.write_text(yaml.safe_dump({"model": {"b": {"d": 3}}, "lst": [9]}))
    cfg = load_config(base, [str(ov)], ["model.b.c=1.0e-5", "new.key=true"])
    assert cfg == {"model": {"a": 1, "b": {"c": 1.0e-5, "d": 3}}, "lst": [9],
                   "new": {"key": True}}


# ----------------------------------------------------------------- trainer

def test_trainer_steps_match_jax(mesh8, tmp_path):
    """Three SFT optimizer steps of the port's Trainer against the JAX
    Trainer (tiny, fp32, packed rows, grad accum 2, clipping on) from the
    same weights and numpy batches. Losses to 1e-5 (the steps see the
    same parameters up to rounding). Parameters: each update moves a
    coordinate by at most ~lr (Adam's normalized step) plus weight decay,
    and Adam's first steps can turn a rounding-level gradient difference
    near zero into a full +-lr step, so the bound is 2 x (sum of the lrs
    applied) per coordinate; the median difference stays at rounding
    level (1e-6)."""
    from dla_tpu.training.train_sft import make_sft_loss as j_sft_loss
    from dla_tpu.training.trainer import Trainer as JTrainer
    jm, jp, tm, tp = _models()
    base = {"optimization": {"learning_rate": 1e-2, "warmup_steps": 1,
                             "max_train_steps": 10, "weight_decay": 0.01,
                             "max_grad_norm": 0.5},
            "hardware": {"gradient_accumulation_steps": 2},
            "logging": {"log_dir": None}}
    jcfg = {**base, "optimization": {**base["optimization"],
                                     "micro_batch_size": 1},
            "logging": {"output_dir": str(tmp_path / "j"), "log_dir": None}}
    tcfg = {**base, "optimization": {**base["optimization"],
                                     "micro_batch_size": 4},
            "logging": {"output_dir": str(tmp_path / "t"), "log_dir": None}}
    ds = PackedInstructionDataset(
        InstructionDataset(ByteTokenizer(), 48, records=_records(60)), 48)
    it = iter(ShardedBatchIterator(ds, 8, seed=0))
    batches = [next(it) for _ in range(3)]
    with jax.sharding.set_mesh(mesh8):
        jt = JTrainer(config=jcfg, mesh=mesh8, loss_fn=j_sft_loss(jm),
                      params=jp, param_specs=jm.partition_specs())
        jl = [jt.step_on_batch(b, jax.random.key(0))[0] for b in batches]
        jfinal = jax.tree.map(np.asarray, jt.params)
    tt = Trainer(config=tcfg, loss_fn=make_sft_loss(tm), params=tp)
    assert tt.global_batch == jt.global_batch == 8
    tl = [tt.step_on_batch(b)[0] for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    lr_sum = sum(tt.schedule(s) for s in range(3))
    diffs = []
    for path_t, t in [("embed", tp["embed"]["embedding"]),
                      ("final_norm", tp["final_norm"])] + [
            (f"layers.{k}", v) for k, v in tp["layers"].items()]:
        j = jfinal["embed"]["embedding"] if path_t == "embed" else (
            jfinal["final_norm"] if path_t == "final_norm"
            else jfinal["layers"][path_t.split(".")[1]])
        d = np.abs(_np(t) - np.asarray(j))
        assert d.max() <= 2 * lr_sum, path_t
        diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) <= 1e-6


def test_checkpoint_is_read_by_jax_and_resume_restores(tmp_path):
    """A port checkpoint's params (fp32 and bf16 leaves) read back
    through ``dla_tpu.checkpoint.load_tree_numpy`` exactly; a fresh
    Trainer resumes params, AdamW moments and step."""
    from dla_tpu.checkpoint import load_tree_numpy as j_load
    _, _, tm, tp = _models()
    cfg = {"optimization": {"micro_batch_size": 2, "learning_rate": 1e-2,
                            "warmup_steps": 0, "max_train_steps": 4},
           "logging": {"output_dir": str(tmp_path / "ck"), "log_dir": None}}
    tt = Trainer(config=cfg, loss_fn=make_sft_loss(tm), params=tp)
    batch = {k: v[:2] for k, v in _batch("packed").items()}
    tt.step_on_batch(batch)
    tt.save({"epoch": 0, "step_in_epoch": 1}, {"note": "x"})
    jtree, aux = j_load(tmp_path / "ck", prefix="params")
    assert aux["step"] == 1 and aux["note"] == "x"
    np.testing.assert_array_equal(jtree["layers"]["wq"],
                                  _np(tp["layers"]["wq"]))
    bf = torch.randn(3, 5).to(torch.bfloat16)
    Checkpointer(tmp_path / "bf").save(0, {"params": {"w": bf}})
    np.testing.assert_array_equal(
        np.asarray(j_load(tmp_path / "bf", prefix="params")[0]["w"],
                   np.float32), _np(bf))

    _, _, tm2, tp2 = _models()
    fresh = Trainer(config=cfg, loss_fn=make_sft_loss(tm2), params=tp2)
    fresh.try_resume()
    assert fresh.step == 1
    for a, b in zip(fresh.leaves, tt.leaves):
        assert torch.equal(a, b)
        sa, sb = fresh.optimizer.state[a], tt.optimizer.state[b]
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    la = fresh.step_on_batch(batch)[0]
    lb = tt.step_on_batch(batch)[0]
    assert la == lb


def _cli_config(tmp_path, steps: int, **extra):
    write_jsonl(tmp_path / "train.jsonl", _records(48, seed=4))
    write_jsonl(tmp_path / "eval.jsonl", _records(8, seed=5))
    sets = {
        "model.model_name_or_path": "tiny", "model.tokenizer": "byte",
        "model.max_seq_length": 64, "model.use_flash_attention": True,
        "data.train_path": str(tmp_path / "train.jsonl"),
        "data.eval_path": str(tmp_path / "eval.jsonl"),
        "optimization.micro_batch_size": 2,
        "hardware.gradient_accumulation_steps": 2,
        "optimization.max_train_steps": steps,
        "optimization.warmup_steps": 2,
        "optimization.learning_rate": 1e-3,
        "logging.output_dir": str(tmp_path / "ckpt"),
        "logging.log_dir": str(tmp_path / "logs"),
        "logging.log_every_steps": 1, "logging.eval_every_steps": 2,
        "logging.save_every_steps": 2, **extra}
    argv = ["--config", "config/sft_config.yaml"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={json.dumps(v) if isinstance(v, bool) else v}"]
    return argv


def _metrics(log_dir):
    return [json.loads(line) for line in
            (log_dir / "metrics.jsonl").read_text().splitlines()]


def test_sft_cli_trains_saves_and_resumes(tmp_path, monkeypatch):
    """``train_sft.main(argv, device="cpu")`` on config/sft_config.yaml
    (tiny, byte tokenizer, packing and flash as the config has them):
    finite falling-from-ln(V) loss, metrics.jsonl keys, final/ readable
    by the JAX package; a run stopped after step 2 and resumed with
    --resume logs steps 3-4 with the uninterrupted run's losses (exact:
    the same CPU arithmetic from the same restored state)."""
    import pathlib
    from dla_tpu.checkpoint import load_tree_numpy as j_load
    monkeypatch.chdir(pathlib.Path(__file__).resolve().parents[1])
    full, part = tmp_path / "full", tmp_path / "part"
    full.mkdir()
    part.mkdir()
    sft_main(_cli_config(full, 4), device="cpu")
    rows = [r for r in _metrics(full / "logs") if "train/loss" in r]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    for key in ("train/loss", "train/lr", "train/grad_norm",
                "tokens_per_sec_per_chip"):
        assert key in rows[-1]
    assert all(np.isfinite(r["train/loss_instant"]) for r in rows)
    assert abs(rows[0]["train/loss_instant"] - np.log(512)) < 1.0
    assert any("eval/loss" in r for r in _metrics(full / "logs"))
    tree, aux = j_load(full / "ckpt" / "final", prefix="params")
    assert aux["step"] == 4 and tree["layers"]["wq"].shape == (2, 64, 64)

    sft_main(_cli_config(part, 2), device="cpu")
    sft_main(_cli_config(part, 4) + ["--resume"], device="cpu")
    resumed = [r for r in _metrics(part / "logs") if "train/loss" in r]
    assert [r["step"] for r in resumed] == [1, 2, 3, 4]
    np.testing.assert_allclose(
        [r["train/loss_instant"] for r in resumed[2:]],
        [r["train/loss_instant"] for r in rows[2:]], rtol=1e-6)
