"""Parity of the port's distillation phase with the JAX package: the
fused CE with an ``lm_head`` bias, the fused and plain distillation KL
(teacher ensembles, temperature, biases, masks and packed rows), the
teacher-rollout data, the distill CLI's per-step losses and metrics in
CE and KL-ensemble modes against the JAX CLI from the same initial
parameters, and the CPU chain from teacher generation to distillation.
The student is a tiny phi (hidden 160 = 2 heads x 80, 2 layers, vocab
512, rows of 128 tokens, flash on). Inputs come from numpy seeds; each
test states its tolerance."""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.data.datasets import TeacherRolloutDataset as JTeacherDataset
from dla_tpu.data.iterator import ShardedBatchIterator as JIterator
from dla_tpu.data.loaders import build_teacher_dataset as j_build_teacher
from dla_tpu.data.packing import PackedTeacherDataset as JPackedTeacher
from dla_tpu.data.tokenizers import ByteTokenizer as JByteTokenizer
from dla_tpu.models.config import get_model_config as j_get_config
from dla_tpu.models.transformer import Transformer as JTransformer
from dla_tpu.ops import fused_ce as j_fused
from dla_tpu.ops import losses as j_losses
from dla_tpu_torch.checkpoint.checkpointer import Checkpointer
from dla_tpu_torch.data.datasets import TeacherRolloutDataset
from dla_tpu_torch.data.iterator import ShardedBatchIterator
from dla_tpu_torch.data.jsonl import write_jsonl
from dla_tpu_torch.data.loaders import build_teacher_dataset
from dla_tpu_torch.data.packing import PackedTeacherDataset
from dla_tpu_torch.data.tokenizers import ByteTokenizer
from dla_tpu_torch.models.weights import params_from_jax, params_to_numpy
from dla_tpu_torch.ops import fused_ce, losses
from dla_tpu_torch.training import generate_teacher_data, train_distill
from dla_tpu_torch.training.model_io import load_causal_lm

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = "config/distill_config.yaml"
T = 128
TINY_PHI = dict(vocab_size=512, hidden_size=160, intermediate_size=320,
                num_layers=2, num_heads=2, num_kv_heads=2,
                max_seq_length=T, param_dtype="float32", dtype="float32")
_LETTERS = list("abcdefghijklmnopqrstuvwxyz     ")


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rollouts(n: int, seed: int):
    """{prompt, teacher_response, reward} records of 8..150 bytes (some
    run past the 128-token rows and are cut), a few without a reward."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        rec = {"prompt": "".join(rs.choice(_LETTERS, rs.randint(4, 30))),
               "teacher_response": "".join(
                   rs.choice(_LETTERS, rs.randint(4, 120)))}
        if i % 5:
            rec["reward"] = float(rs.randn())
        out.append(rec)
    return out


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------- fused CE

@pytest.mark.parametrize("chunk", [7, 1024])
def test_fused_ce_with_bias_matches_jax(chunk):
    """``fused_cross_entropy_loss`` with an lm_head bias against the JAX
    package's: the loss and the gradients of h, w and the bias (the bias
    gradient the column sum of each tile's fp32 dlogits), fp32, 1e-5,
    ragged last chunk or one chunk."""
    rs = np.random.RandomState(0)
    b, t, d, v = 2, 13, 16, 40
    h = rs.randn(b, t, d).astype(np.float32)
    w = (rs.randn(d, v) * 0.3).astype(np.float32)
    bias = rs.randn(v).astype(np.float32)
    labels = rs.randint(0, v, (b, t)).astype(np.int32)
    labels[0, :4] = losses.IGNORE_INDEX

    def jloss(h, w, bias):
        return j_fused.fused_cross_entropy_loss(
            h, w, jnp.asarray(labels), bias=bias, chunk=chunk)[0]
    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias))
    th, tw, tb = (torch.from_numpy(x).requires_grad_() for x in (h, w, bias))
    tl, _ = fused_ce.fused_cross_entropy_loss(
        th, tw, torch.from_numpy(labels), tb, chunk=chunk)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for got, ref in zip((th, tw, tb), jg):
        np.testing.assert_allclose(_np(got.grad), _np(ref), atol=1e-5,
                                   rtol=1e-5)


# ------------------------------------------------------------ fused KL

@pytest.mark.parametrize("n_teachers,packed", [(1, False), (2, True)])
def test_fused_kl_matches_jax_and_plain(n_teachers, packed):
    """``fused_kl_distill_loss`` (chunked, teachers of their own hidden
    sizes, student and teacher biases, temperature 2) against the JAX
    package's on the same inputs, and the port's plain
    ``kl_distill_loss`` on materialized logits against the JAX plain
    one and the fused one; right-padded rows, or packed rows whose
    segment starts are masked as the distill loss masks them. Values and
    the student's gradients (h, w, bias), fp32, 1e-5 (relative to each
    gradient's largest entry)."""
    rs = np.random.RandomState(4)
    b, t, ds, v, temp = 2, 17, 12, 48, 2.0
    hs = rs.randn(b, t, ds).astype(np.float32)
    ws = (rs.randn(ds, v) * 0.4).astype(np.float32)
    bs = (rs.randn(v) * 0.3).astype(np.float32)
    dts = [10, 20][:n_teachers]
    hts = [rs.randn(b, t, dt).astype(np.float32) for dt in dts]
    wts = [(rs.randn(dt, v) * 0.4).astype(np.float32) for dt in dts]
    bts = [(rs.randn(v) * 0.3).astype(np.float32) for _ in dts]
    mask = np.ones((b, t), np.int32)
    mask[1, 12:] = 0
    if packed:
        seg = np.ones((b, t), np.int32)
        seg[0, 6:] = 2
        seg[1, 5:12], seg[1, 12:] = 2, 0
        start = np.concatenate([np.ones((b, 1), np.int32),
                                (seg[:, 1:] != seg[:, :-1])], 1)
        mask = mask * (1 - start)
    chunk = 5

    def jf(h, w, bias):
        return j_fused.fused_kl_distill_loss(
            h, w, [jnp.asarray(x) for x in hts],
            [jnp.asarray(x) for x in wts], jnp.asarray(mask), temp,
            student_bias=bias, teacher_biases=[jnp.asarray(x) for x in bts],
            chunk=chunk)
    jl, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(hs), jnp.asarray(ws), jnp.asarray(bs))
    th, tw, tb = (torch.from_numpy(x).requires_grad_() for x in (hs, ws, bs))
    tl = fused_ce.fused_kl_distill_loss(
        th, tw, [torch.from_numpy(x) for x in hts],
        [torch.from_numpy(x) for x in wts], torch.from_numpy(mask), temp,
        student_bias=tb, teacher_biases=[torch.from_numpy(x) for x in bts],
        chunk=chunk)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for got, ref in zip((th, tw, tb), jg):
        scale = np.abs(_np(ref)).max()
        np.testing.assert_allclose(_np(got.grad) / scale, _np(ref) / scale,
                                   atol=1e-5)

    s_logits = hs @ ws + bs
    t_logits = [h @ w + bb for h, w, bb in zip(hts, wts, bts)]
    jplain = j_losses.kl_distill_loss(
        jnp.asarray(s_logits), [jnp.asarray(x) for x in t_logits],
        jnp.asarray(mask), temp)
    ts = torch.from_numpy(s_logits).requires_grad_()
    tplain = losses.kl_distill_loss(
        ts, [torch.from_numpy(x) for x in t_logits], torch.from_numpy(mask),
        temp)
    np.testing.assert_allclose(tplain.item(), float(jplain), rtol=1e-5)
    np.testing.assert_allclose(tplain.item(), tl.item(), rtol=1e-5)
    tplain.backward()
    # d/dh of the plain loss through the materialized logits = the fused
    dh = ts.grad.numpy() @ ws.T
    scale = np.abs(dh).max()
    np.testing.assert_allclose(_np(th.grad) / scale, dh / scale, atol=1e-5)


# ------------------------------------------------------------------ data

def test_teacher_datasets_match_jax(tmp_path):
    """``TeacherRolloutDataset`` items (labels = input ids, reward
    default 1.0) and batches, ``PackedTeacherDataset`` rows (token-
    weighted row reward) and batches, ``build_teacher_dataset`` from
    ``teacher_samples_path`` and the seeded batch order, against the JAX
    package's: arrays exactly equal."""
    recs = _rollouts(30, seed=1)
    path = tmp_path / "rollouts.jsonl"
    write_jsonl(path, recs)
    t, jt = ByteTokenizer(), JByteTokenizer()
    ds = TeacherRolloutDataset(t, 64, records=recs)
    jds = JTeacherDataset(jt, 64, records=recs)
    for i in (0, 3, 29):
        _tree_equal(ds[i], jds[i])
    assert float(ds[0]["reward"]) == 1.0
    _tree_equal(ds.collate([ds[0], ds[5]]), jds.collate([jds[0], jds[5]]))
    p, jp = PackedTeacherDataset(ds, 64), JPackedTeacher(jds, 64)
    assert p.rows == jp.rows and len(p) == len(jp)
    for i in range(len(p)):
        _tree_equal(p[i], jp[i])
    assert p.packing_efficiency() == jp.packing_efficiency()
    cfg = {"teacher_samples_path": str(path), "max_seq_length": 64}
    b, jb = build_teacher_dataset(cfg, t), j_build_teacher(cfg, jt)
    _tree_equal(b[7], jb[7])
    it, jit = iter(ShardedBatchIterator(p, 4, seed=3)), \
        iter(JIterator(p, 4, seed=3))
    for _ in range(3):
        _tree_equal(next(it), next(jit))


# ------------------------------------------------------------------- CLI

def _phi_checkpoint(path: pathlib.Path, seed: int) -> str:
    """A tiny phi checkpoint both packages load: JAX init from ``seed``
    with random biases, written by the port's Checkpointer."""
    cfg = j_get_config("phi-2", **TINY_PHI)
    jp = jax.tree.map(np.asarray, JTransformer(cfg).init(
        jax.random.key(seed)))
    rs = np.random.RandomState(seed)
    for name in ("wq_bias", "wv_bias", "fc1_bias", "ln_bias"):
        jp["layers"][name] = (0.05 * rs.randn(
            *jp["layers"][name].shape)).astype(np.float32)
    jp["lm_head_bias"] = (0.05 * rs.randn(512)).astype(np.float32)
    Checkpointer(str(path)).save(
        0, {"params": params_from_jax(jp, "cpu")},
        {"model_config": cfg.to_dict(), "tokenizer": "byte"}, tag="final")
    return str(path / "final")


def _metrics(log_dir):
    return [json.loads(line) for line in
            (log_dir / "metrics.jsonl").read_text().splitlines()]


def _distill_argv(work: pathlib.Path, student: str, steps: int, micro: int,
                  **extra):
    """The CLI's arguments: rollouts from ``work.parent``, checkpoints
    and logs under ``work``."""
    sets = {"seed": 0, "model.student_model_name_or_path": student,
            "model.tokenizer": "byte", "model.use_flash_attention": "true",
            "model.max_seq_length": T,
            "data.teacher_samples_path": str(work.parent / "rollouts.jsonl"),
            "optimization.micro_batch_size": micro,
            "hardware.gradient_accumulation_steps": 2,
            "optimization.max_train_steps": steps,
            "optimization.learning_rate": "1.0e-3",
            "optimization.warmup_steps": 1,
            "logging.output_dir": str(work / "ckpt"),
            "logging.log_dir": str(work / "logs"),
            "logging.log_every_steps": 1, **extra}
    argv = ["--config", CONFIG]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    return argv


@pytest.mark.parametrize("mode", ["ce", "kl_ensemble_packed"])
def test_distill_cli_steps_match_jax(tmp_path, monkeypatch, mode):
    """``train_distill.main(argv, device="cpu")`` against the JAX
    package's ``train_distill.main`` on config/distill_config.yaml, from
    the same tiny phi checkpoint and rollouts: CE mode as configured
    (right-padded rows), and KL mode (use_kl + on_policy, temperature
    2) against an ensemble of two phi teachers over packed rows. JAX
    runs an 8-device CPU mesh with micro-batch 1 (8 rows per
    micro-step), the port micro-batch 8: the same 16-row global batches
    in the same order. Per-step losses, ``reward_mean`` and ``ce`` /
    ``kl`` to 1e-5 (fp32, sums in another order); the final parameters
    within 2 x the summed learning rate per coordinate."""
    from dla_tpu.training.train_distill import main as j_main
    monkeypatch.chdir(ROOT)
    write_jsonl(tmp_path / "rollouts.jsonl", _rollouts(40, seed=7))
    student = _phi_checkpoint(tmp_path / "student", 0)
    extra = {}
    if mode != "ce":
        teachers = [_phi_checkpoint(tmp_path / f"teacher{i}", i + 1)
                    for i in range(2)]
        extra = {"distill.use_kl": "true", "distill.on_policy": "true",
                 "distill.teacher_model_names_or_paths":
                     "[" + ", ".join(teachers) + "]",
                 "optimization.temperature": "2.0", "data.packing": "true"}
    j_main(_distill_argv(tmp_path / "j", student, 3, 1, **extra))
    trainer = train_distill.main(
        _distill_argv(tmp_path / "t", student, 3, 8, **extra), device="cpu")
    key = "train/ce" if mode == "ce" else "train/kl"
    jrows = [r for r in _metrics(tmp_path / "j" / "logs")
             if "train/loss_instant" in r]
    trows = [r for r in _metrics(tmp_path / "t" / "logs")
             if "train/loss_instant" in r]
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == \
        [1, 2, 3]
    for k in ("train/loss_instant", "train/reward_mean", key):
        np.testing.assert_allclose([r[k] for r in trows],
                                   [r[k] for r in jrows], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if mode == "ce":
        assert abs(trows[0][key] - np.log(512)) < 1.0
    else:
        assert all(r[key] >= 0 for r in trows)
    jfinal = load_causal_lm(str(tmp_path / "j" / "ckpt" / "final"),
                            {"tokenizer": "byte"}, device="cpu").params
    lr_sum = sum(trainer.schedule(s) for s in range(3))
    mine = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(trainer.params)))
    for path, j in jax.tree_util.tree_leaves_with_path(
            params_to_numpy(jfinal)):
        assert np.abs(mine[path] - j).max() <= 2 * lr_sum, path


def test_generation_to_distillation_chain_on_cpu(tmp_path, monkeypatch):
    """The phase chain on the CPU: ``generate_teacher_data`` (the tiny
    llama checkpoint of checkpoints/run, scored by a reward model
    warm-started from it) writes rollouts with finite rewards, the
    distill CLI trains the tiny phi student on them in CE mode, its
    ``final/`` loads back equal to the trained parameters and serves as
    the one teacher of a KL run; a teacher of another vocabulary raises
    the JAX package's message; ``--resume`` continues at the saved
    step."""
    monkeypatch.chdir(ROOT)
    prompts = tmp_path / "prompts.jsonl"
    write_jsonl(prompts, [{"prompt": r["prompt"]}
                          for r in _rollouts(10, seed=3)])
    ckpt = str(ROOT / "checkpoints" / "run" / "final")
    generate_teacher_data.main(
        ["--model_name_or_path", ckpt, "--reward_model_path", ckpt,
         "--prompts_path", str(prompts), "--output_path",
         str(tmp_path / "rollouts.jsonl"), "--batch_size", "4",
         "--max_prompt_length", "32", "--max_new_tokens", "12"],
        device="cpu")
    rows = [json.loads(line) for line in
            (tmp_path / "rollouts.jsonl").read_text().splitlines()]
    assert len(rows) == 10 and all(np.isfinite(r["reward"]) for r in rows)
    student = _phi_checkpoint(tmp_path / "student", 0)
    ce = train_distill.main(_distill_argv(tmp_path / "ce", student, 2, 4),
                            device="cpu")
    back = load_causal_lm(str(tmp_path / "ce" / "ckpt" / "final"),
                          {"tokenizer": "byte"}, device="cpu").params
    _tree_equal(params_to_numpy(back), params_to_numpy(ce.params))
    kl_sets = {"distill.use_kl": "true", "distill.on_policy": "true",
               "distill.teacher_model_name_or_path":
                   str(tmp_path / "ce" / "ckpt" / "final")}
    train_distill.main(_distill_argv(tmp_path / "kl", student, 2, 4,
                                     **kl_sets), device="cpu")
    kl = [r["train/kl"] for r in _metrics(tmp_path / "kl" / "logs")
          if "train/kl" in r]
    assert len(kl) == 2 and all(np.isfinite(x) and x >= 0 for x in kl)
    train_distill.main(_distill_argv(tmp_path / "kl", student, 3, 4,
                                     **kl_sets) + ["--resume"],
                       device="cpu")
    steps = [r["step"] for r in _metrics(tmp_path / "kl" / "logs")
             if "train/kl" in r]
    assert steps == [1, 2, 3]
    cfg = j_get_config("tiny", vocab_size=640)
    Checkpointer(str(tmp_path / "wide")).save(
        0, {"params": params_from_jax(jax.tree.map(np.asarray, JTransformer(
            cfg).init(jax.random.key(0))), "cpu")},
        {"model_config": cfg.to_dict()}, tag="final")
    wide = {**kl_sets, "distill.teacher_model_name_or_path":
            str(tmp_path / "wide" / "final")}
    with pytest.raises(ValueError, match="shared vocabulary"):
        train_distill.main(_distill_argv(tmp_path / "w", student, 1, 4,
                                         **wide), device="cpu")


def test_teacher_cli_records_match_jax(tmp_path, monkeypatch):
    """The teacher CLI keys each batch as the JAX CLI does (``fold_in(
    PRNGKey(seed), 100 + start)``): from the same checkpoint, prompts and
    seed its records equal the JAX CLI's, prompt and response token for
    token (3 batches of 4, the last one padded), and the rewards of a
    reward checkpoint both packages load agree to 1e-5."""
    from dla_tpu.training import generate_teacher_data as j_teacher
    from test_torch_rlhf import reward_checkpoint
    monkeypatch.chdir(ROOT)
    prompts = tmp_path / "prompts.jsonl"
    write_jsonl(prompts, [{"prompt": r["prompt"][:24]}
                          for r in _rollouts(10, seed=5)])
    ckpt = str(ROOT / "checkpoints" / "run" / "final")
    rm = reward_checkpoint(tmp_path / "reward")
    out = {}
    for name, run in (("j", j_teacher.main), ("t", lambda a:
                      generate_teacher_data.main(a, device="cpu"))):
        out[name] = tmp_path / f"{name}.jsonl"
        run(["--model_name_or_path", ckpt, "--reward_model_path", rm,
             "--prompts_path", str(prompts), "--output_path",
             str(out[name]), "--batch_size", "4", "--max_prompt_length",
             "32", "--max_new_tokens", "12", "--seed", "21"])
    rows = {k: [json.loads(line) for line in p.read_text().splitlines()]
            for k, p in out.items()}
    assert len(rows["t"]) == len(rows["j"]) == 10
    for mine, theirs in zip(rows["t"], rows["j"]):
        assert mine["prompt"] == theirs["prompt"]
        assert mine["teacher_response"] == theirs["teacher_response"]
        np.testing.assert_allclose(mine["reward"], theirs["reward"],
                                   rtol=1e-5, atol=1e-5)
    assert len({r["teacher_response"] for r in rows["t"]}) > 1
