"""Parity of the port's preference training with the JAX package: the
preference data (records, dataset, joint packing, batches), three
optimizer steps of the Trainer with the reward and DPO losses, packed
and unpacked, and both CLIs on the CPU (``device="cpu"``). Inputs come
from numpy seeds; each test states its tolerance."""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from dla_tpu.data.datasets import PreferenceDataset as JPreferenceDataset
from dla_tpu.data.iterator import ShardedBatchIterator as JIterator
from dla_tpu.data.loaders import load_preference_records as j_records
from dla_tpu.data.packing import pack_preference_splits as j_pack_splits
from dla_tpu.data.tokenizers import ByteTokenizer as JByteTokenizer
from dla_tpu.models.config import get_model_config as j_get_config
from dla_tpu.models.reward import RewardModel as JRewardModel
from dla_tpu.models.transformer import Transformer as JTransformer
from dla_tpu_torch.data.datasets import PreferenceDataset
from dla_tpu_torch.data.iterator import ShardedBatchIterator
from dla_tpu_torch.data.jsonl import write_jsonl
from dla_tpu_torch.data.loaders import load_preference_records
from dla_tpu_torch.data.packing import pack_preference_splits
from dla_tpu_torch.data.tokenizers import ByteTokenizer
from dla_tpu_torch.models.config import get_model_config
from dla_tpu_torch.models.reward import RewardModel
from dla_tpu_torch.models.transformer import Transformer
from dla_tpu_torch.models.weights import params_from_jax, params_to_numpy
from dla_tpu_torch.training import train_dpo, train_reward
from dla_tpu_torch.training.trainer import Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
LN2 = float(np.log(2.0))


def _pref_records(n: int, seed: int = 0):
    """Chosen answers are right and polite, rejected ones curt: a signal
    a tiny model separates in a few dozen steps (the JAX package's smoke
    data), with prompts and answers of varied length."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a, b = int(rs.randint(0, 30)), int(rs.randint(0, 30))
        pad = " ".join(["please"] * int(rs.randint(0, 4)))
        out.append({"prompt": f"add {a} {b} {pad}".strip(),
                    "chosen": f"the answer is {a + b} thanks",
                    "rejected": "no idea" + " ." * int(rs.randint(0, 5))})
    return out


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -------------------------------------------------------------------- data

def test_preference_data_matches_jax():
    """PreferenceDataset items and batches, PackedPreferenceDataset rows
    (joint first fit), items and batches, pack_preference_splits' shared
    pair width and the seeded batch order, against the JAX package's:
    arrays exactly equal (the same integer arithmetic)."""
    recs = _pref_records(40, seed=1)
    ev = _pref_records(9, seed=2)
    t, jt = ByteTokenizer(), JByteTokenizer()
    ds, jds = PreferenceDataset(t, 40, records=recs), \
        JPreferenceDataset(jt, 40, records=recs)
    for i in (0, 7, 39):
        _tree_equal(ds[i], jds[i])
    _tree_equal(ds.collate([ds[0], ds[5]]), jds.collate([jds[0], jds[5]]))
    pt, pe, n = pack_preference_splits(
        ds, PreferenceDataset(t, 40, records=ev), 40)
    jpt, jpe, jn = j_pack_splits(
        jds, JPreferenceDataset(jt, 40, records=ev), 40)
    assert n == jn and pt.rows == jpt.rows and pe.rows == jpe.rows
    assert pt.max_pairs == pe.max_pairs == jpt.max_pairs
    assert pt.packing_efficiency() == jpt.packing_efficiency()
    for i in range(len(pt)):
        _tree_equal(pt[i], jpt[i])
    for d, jd in ((ds, jds), (pt, jpt)):
        it, jit_ = iter(ShardedBatchIterator(d, 4, seed=3)), \
            iter(JIterator(jd, 4, seed=3))
        for _ in range(3):
            _tree_equal(next(it), next(jit_))


def test_preference_records_match_jax(tmp_path):
    """load_preference_records: ``<split>_path``, ``preference_path``,
    ``limit`` and a weighted ``data.mixture`` (train split) give the JAX
    package's records exactly; an HF source raises."""
    write_jsonl(tmp_path / "a.jsonl", _pref_records(7, seed=3))
    write_jsonl(tmp_path / "b.jsonl", _pref_records(5, seed=4))
    cfgs = [
        ({"preference_path": str(tmp_path / "a.jsonl"), "limit": 4},
         "train"),
        ({"eval_path": str(tmp_path / "b.jsonl")}, "eval"),
        ({"mixture": [{"path": str(tmp_path / "a.jsonl"), "weight": 2.0},
                      {"path": str(tmp_path / "b.jsonl")}],
          "mixture_size": 11, "mixture_seed": 5}, "train")]
    for cfg, split in cfgs:
        assert load_preference_records(cfg, split) == j_records(cfg, split)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_preference_records({"source": "hf", "hf_path": "x"})


# ----------------------------------------------------------------- trainer

def _trainer_batches(packed: bool):
    t = ByteTokenizer()
    ds = PreferenceDataset(t, 32, records=_pref_records(64, seed=6))
    if packed:
        ds, _, n = pack_preference_splits(ds, None, 32)
    else:
        n = 0
    it = iter(ShardedBatchIterator(ds, 8, seed=0))
    return [next(it) for _ in range(3)], n


@pytest.mark.parametrize("phase", ["reward", "dpo"])
@pytest.mark.parametrize("packed", [False, True])
def test_preference_trainer_steps_match_jax(mesh8, tmp_path, phase, packed):
    """Three optimizer steps of the port's Trainer against the JAX
    Trainer (tiny, fp32, grad accum 2, clipping on, dropout 0) from the
    same weights and numpy batches, with the reward loss and with the DPO
    loss (the frozen reference = the starting policy), packed and
    unpacked. Losses and the loss's metrics to 1e-5 (DPO's first step:
    loss ln 2, margin 0 exactly in the port); parameters within
    the bound and median of ``test_trainer_steps_match_jax`` (2 x the
    summed lr per coordinate, median at rounding level, 1e-6)."""
    from dla_tpu.training.train_dpo import make_dpo_loss as j_dpo_loss
    from dla_tpu.training.train_reward import make_reward_loss as j_rm_loss
    from dla_tpu.training.trainer import Trainer as JTrainer
    batches, n = _trainer_batches(packed)
    if phase == "reward":
        jm = JRewardModel(j_get_config("tiny"))
        jp = jm.init(jax.random.key(0))
        tm = RewardModel(get_model_config("tiny"))
        j_loss, t_loss = j_rm_loss(jm, n_segments=n), \
            train_reward.make_reward_loss(tm, n)
        keys = ("acc", "reward_margin")
    else:
        jm = JTransformer(j_get_config("tiny"))
        jp = jm.init(jax.random.key(0))
        tm = Transformer(get_model_config("tiny"))
        j_loss = j_dpo_loss(jm, jm, 0.5, 0.1, n_segments=n)
        t_loss = train_dpo.make_dpo_loss(tm, tm, 0.5, 0.1, n)
        keys = ("preference_rate", "margin", "policy_chosen_logp")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    base = {"optimization": {"learning_rate": 1e-2, "warmup_steps": 1,
                             "max_train_steps": 10, "weight_decay": 0.01,
                             "max_grad_norm": 0.5},
            "hardware": {"gradient_accumulation_steps": 2}}
    jcfg = {**base, "optimization": {**base["optimization"],
                                     "micro_batch_size": 1},
            "logging": {"output_dir": str(tmp_path / "j"), "log_dir": None}}
    tcfg = {**base, "optimization": {**base["optimization"],
                                     "micro_batch_size": 4},
            "logging": {"output_dir": str(tmp_path / "t"), "log_dir": None}}
    with jax.sharding.set_mesh(mesh8):
        specs = jm.partition_specs()
        extra = ({"frozen": jp, "frozen_specs": specs}
                 if phase == "dpo" else {})
        jt = JTrainer(config=jcfg, mesh=mesh8, loss_fn=j_loss, params=jp,
                      param_specs=specs, **extra)
        jout = [jt.step_on_batch(b, jax.random.key(0)) for b in batches]
        jfinal = jax.tree.map(np.asarray, jt.params)
    tt = Trainer(config=tcfg, loss_fn=t_loss, params=tp,
                 frozen=tp if phase == "dpo" else None)
    assert tt.global_batch == jt.global_batch == 8
    tout = [tt.step_on_batch(b) for b in batches]
    np.testing.assert_allclose([o[0] for o in tout], [o[0] for o in jout],
                               rtol=1e-5, atol=1e-6)
    for k in keys:
        # step 1 of DPO has policy = reference: every margin is 0 in exact
        # arithmetic, and the rate (margin > 0) of the JAX run reads the
        # sign of its rounding; it is compared from step 2 on
        first = 1 if k == "preference_rate" else 0
        np.testing.assert_allclose([o[1][k] for o in tout[first:]],
                                   [float(o[1][k]) for o in jout[first:]],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if phase == "dpo":
        assert tout[0][0] == pytest.approx(LN2, abs=1e-6)
        assert tout[0][1]["margin"] == 0.0
        assert tout[0][1]["preference_rate"] == 0.0
    lr_sum = sum(tt.schedule(s) for s in range(3))
    mine = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(tp)))
    diffs = []
    for path, j in jax.tree_util.tree_leaves_with_path(jfinal):
        d = np.abs(mine[path] - np.asarray(j))
        assert d.max() <= 2 * lr_sum, path
        diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) <= 1e-6


def test_trainer_frozen_tree_is_a_copy_outside_the_checkpoint(tmp_path):
    """A frozen leaf that shares the trained tree's storage is copied
    before the first step (the reference stays the starting policy);
    frozen leaves take no gradient and no optimizer state and are not in
    the checkpoint."""
    tm = Transformer(get_model_config("tiny"))
    tp = tm.init(torch.Generator().manual_seed(0))
    start = {k: v.clone() for k, v in tp["layers"].items()}
    cfg = {"optimization": {"micro_batch_size": 4, "learning_rate": 1e-2,
                            "warmup_steps": 0, "max_train_steps": 2},
           "logging": {"output_dir": str(tmp_path), "log_dir": None}}
    tt = Trainer(config=cfg, loss_fn=train_dpo.make_dpo_loss(tm, tm, 0.5),
                 params=tp, frozen=tp)
    batches, _ = _trainer_batches(False)
    for _ in range(2):
        tt.step_on_batch({s: {k: v[:4] for k, v in batches[0][s].items()}
                          for s in ("chosen", "rejected")})
    assert not torch.equal(tp["layers"]["wq"], start["wq"])
    for k, v in tt.frozen["layers"].items():
        assert torch.equal(v, start[k]) and v.grad is None
        assert not v.requires_grad
    assert len(tt.optimizer.state) == len(tt.leaves)
    tt.save()
    index = json.loads((tmp_path / "step_00000002" / "index.json")
                       .read_text())
    assert all(k.startswith(("params.", "opt_state."))
               for k in index["leaves"])
    assert sum(k.startswith("params.") for k in index["leaves"]) == len(
        jax.tree.leaves(params_to_numpy(tp)))


# -------------------------------------------------------------------- CLIs

def _argv(config: str, sets: dict):
    argv = ["--config", config]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    return argv


def _metrics(log_dir):
    return [json.loads(line) for line in
            (log_dir / "metrics.jsonl").read_text().splitlines()]


def _cli_sets(tmp_path, steps: int, **extra):
    write_jsonl(tmp_path / "train.jsonl", _pref_records(48, seed=7))
    write_jsonl(tmp_path / "eval.jsonl", _pref_records(8, seed=8))
    return {"seed": 0, "model.tokenizer": "byte",
            "model.max_seq_length": 32,
            "data.train_path": str(tmp_path / "train.jsonl"),
            "data.eval_path": str(tmp_path / "eval.jsonl"),
            "optimization.micro_batch_size": 8,
            "hardware.gradient_accumulation_steps": 2,
            "optimization.max_train_steps": steps,
            "optimization.warmup_steps": 2,
            "logging.output_dir": str(tmp_path / "ckpt"),
            "logging.log_dir": str(tmp_path / "logs"),
            "logging.log_every_steps": 1,
            "logging.eval_every_steps": 5,
            "logging.save_every_steps": 5, **extra}


def test_reward_cli_learns_saves_and_resumes(tmp_path, monkeypatch):
    """``train_reward.main(argv, device="cpu")`` on
    config/reward_config.yaml (tiny, byte tokenizer, last-token pooling,
    dropout 0.1 as configured): over 20 steps the pairwise accuracy
    passes 0.6 and the loss falls (what the JAX package's smoke test asks
    of it); eval logs loss and accuracy; ``final/`` loads in the JAX
    package's ``build_reward_model`` with the port's weights; a run
    stopped at step 10 and resumed with --resume logs steps 11-20 with
    the uninterrupted run's losses (dropout on: exact, the same CPU
    arithmetic and the same per-step random streams). ``model.lora``
    raises."""
    from dla_tpu.training.model_io import build_reward_model as j_build_rm
    monkeypatch.chdir(ROOT)
    cfg = "config/reward_config.yaml"
    full, part = tmp_path / "full", tmp_path / "part"
    full.mkdir()
    part.mkdir()
    # the warmup covers the stopped run's 10 steps, so both runs apply
    # the same learning rates there (the cosine spans max_train_steps)
    extra = {"model.base_model_name_or_path": "tiny",
             "optimization.learning_rate": "2.0e-3",
             "optimization.warmup_steps": 10}
    trainer = train_reward.main(
        _argv(cfg, _cli_sets(full, 20, **extra)), device="cpu")
    rows = [r for r in _metrics(full / "logs") if "train/loss" in r]
    assert [r["step"] for r in rows] == list(range(1, 21))
    losses = [r["train/loss_instant"] for r in rows]
    assert np.mean(losses[-2:]) < losses[0]
    assert rows[-1]["train/acc"] > 0.6
    assert "train/reward_margin" in rows[-1]
    evals = [r for r in _metrics(full / "logs") if "eval/loss" in r]
    assert len(evals) == 4 and "eval/acc" in evals[-1]
    jb = j_build_rm({"base_model_name_or_path": str(full / "ckpt" /
                                                    "final")},
                    jax.random.key(0))
    _tree_equal(jax.tree.map(np.asarray, jb.params),
                params_to_numpy(trainer.params))

    train_reward.main(_argv(cfg, _cli_sets(part, 10, **extra)),
                      device="cpu")
    train_reward.main(_argv(cfg, _cli_sets(part, 20, **extra))
                      + ["--resume"], device="cpu")
    resumed = [r for r in _metrics(part / "logs") if "train/loss" in r]
    assert [r["step"] for r in resumed] == list(range(1, 21))
    np.testing.assert_allclose(
        [r["train/loss_instant"] for r in resumed[10:]], losses[10:],
        rtol=1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_reward.main(_argv(cfg, {**_cli_sets(tmp_path, 1, **extra),
                                      "model.lora.enabled": "true"}),
                          device="cpu")


@pytest.mark.parametrize("reference", ["preset", "starting_policy"])
def test_dpo_cli_starts_at_ln2_saves_and_resumes(tmp_path, monkeypatch,
                                                 reference):
    """``train_dpo.main(argv, device="cpu")`` on config/dpo_config.yaml
    (tiny policy, beta 0.1 and label smoothing 0 as configured), the
    reference either the same preset (drawn from a generator seeded
    alike) or, with none named, a frozen copy of the starting policy:
    the first loss is ln 2 (policy = reference) to 1e-6 and its
    preference rate 0; ``final/`` loads in the JAX package's
    ``load_causal_lm`` with the port's weights; --resume after step 2
    logs steps 3-4 with the uninterrupted run's losses (exact)."""
    from dla_tpu.training.model_io import load_causal_lm as j_load_lm
    monkeypatch.chdir(ROOT)
    cfg = "config/dpo_config.yaml"
    full, part = tmp_path / "full", tmp_path / "part"
    full.mkdir()
    part.mkdir()
    extra = {"model.policy_model_name_or_path": "tiny",
             "model.reference_model_name_or_path":
                 "tiny" if reference == "preset" else "null",
             "optimization.learning_rate": "1.0e-3",
             "logging.eval_every_steps": 2}
    trainer = train_dpo.main(_argv(cfg, _cli_sets(full, 4, **extra)),
                             device="cpu")
    rows = [r for r in _metrics(full / "logs") if "train/loss" in r]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert abs(rows[0]["train/loss_instant"] - LN2) < 1e-6
    assert rows[0]["train/preference_rate"] == 0.0
    assert rows[0]["train/margin"] == 0.0
    assert rows[-1]["train/loss_instant"] < LN2
    assert all(np.isfinite(r["train/policy_chosen_logp"]) for r in rows)
    assert any("eval/loss" in r for r in _metrics(full / "logs"))
    jb = j_load_lm(str(full / "ckpt" / "final"), {}, jax.random.key(0))
    _tree_equal(jax.tree.map(np.asarray, jb.params),
                params_to_numpy(trainer.params))

    train_dpo.main(_argv(cfg, _cli_sets(part, 2, **extra)), device="cpu")
    train_dpo.main(_argv(cfg, _cli_sets(part, 4, **extra)) + ["--resume"],
                   device="cpu")
    resumed = [r for r in _metrics(part / "logs") if "train/loss" in r]
    assert [r["step"] for r in resumed] == [1, 2, 3, 4]
    np.testing.assert_allclose(
        [r["train/loss_instant"] for r in resumed[2:]],
        [r["train/loss_instant"] for r in rows[2:]], rtol=1e-6)
