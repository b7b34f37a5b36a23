"""Parity of the port's non-kernel modules with the JAX package: norms,
rotary (all five HF scalings), the einsum attention paths, per-row
sampling filters, the config registry, the tokenizer, the checkpoint
reader on bf16 leaves, model loading and the teacher-generation CLI.
Inputs come from numpy seeds; fp32 results agree to 1e-5 (summation
order and transcendental implementations only)."""
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.checkpoint.checkpointer import Checkpointer
from dla_tpu.data.tokenizers import ByteTokenizer as JByteTokenizer
from dla_tpu.models.config import known_models as j_known_models
from dla_tpu.ops import attention as j_att
from dla_tpu.ops import norms as j_norms
from dla_tpu.ops import rotary as j_rot
from dla_tpu.ops.sampling import filter_logits_per_row as j_filter_rows
from dla_tpu_torch.checkpoint.checkpointer import load_tree_numpy
from dla_tpu_torch.data.tokenizers import ByteTokenizer, load_tokenizer
from dla_tpu_torch.generation.engine import left_align
from dla_tpu_torch.models.config import known_models
from dla_tpu_torch.ops import attention as t_att
from dla_tpu_torch.ops import norms as t_norms
from dla_tpu_torch.ops import rotary as t_rot
from dla_tpu_torch.ops.sampling import filter_logits_per_row
from dla_tpu_torch.training import generate_teacher_data
from dla_tpu_torch.training.model_io import load_causal_lm

CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / "run" / "final"
RS = np.random.RandomState(11)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


def test_norms_match_jax():
    x = RS.randn(3, 5, 64).astype(np.float32) * 3
    w = RS.randn(64).astype(np.float32)
    bias = RS.randn(64).astype(np.float32)
    _close(t_norms.rms_norm(_t(x), _t(w), 1e-6),
           j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    _close(t_norms.layer_norm(_t(x), _t(w), _t(bias)),
           j_norms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(bias)))


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
    {"type": "linear", "factor": 2.0},
    {"rope_type": "yarn", "factor": 4.0,
     "original_max_position_embeddings": 64},
    {"rope_type": "su", "factor": 4.0, "original_max_position_embeddings": 64,
     "short_factor": list(np.linspace(1.0, 2.0, 16)),
     "long_factor": list(np.linspace(1.0, 8.0, 16))},
    {"rope_type": "dynamic", "factor": 2.0, "max_position_embeddings": 64},
])
def test_rotary_matches_jax(scaling):
    pos = np.stack([np.arange(100), np.arange(100) + 7]).astype(np.int32)
    jc, js = j_rot.rotary_angles(jnp.asarray(pos), 32, 10000.0, scaling)
    tc, ts = t_rot.rotary_angles(_t(pos), 32, 10000.0, scaling)
    _close(tc, jc)
    _close(ts, js)
    x = RS.randn(2, 100, 3, 40).astype(np.float32)   # partial rotary: 32/40
    _close(t_rot.apply_rotary(_t(x), tc, ts, rotary_dim=32),
           j_rot.apply_rotary(jnp.asarray(x), jc, js, rotary_dim=32))


def test_rotary_rejects_unknown_scaling():
    with pytest.raises(NotImplementedError):
        t_rot.validate_rope_scaling({"rope_type": "ntk-magic"})


@pytest.mark.parametrize("kw", [
    dict(),
    dict(window=5, softmax_scale=0.3),
    dict(logit_softcap=2.0),
    dict(segments=True),
])
def test_causal_attention_matches_jax(kw):
    kw = dict(kw)
    b, t, h, kh, d = 2, 12, 4, 2, 16
    q, k, v = (RS.randn(b, t, n, d).astype(np.float32)
               for n in (h, kh, kh))
    jkw, tkw = {}, {}
    if kw.pop("segments", False):
        seg = np.repeat(np.array([[1] * 7 + [2] * 5]), b, 0)
        m = seg[:, :, None] == seg[:, None, :]
        jkw["kv_segment_mask"], tkw["kv_segment_mask"] = jnp.asarray(m), _t(m)
    ref = j_att.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw, **jkw)
    out = t_att.causal_attention(_t(q), _t(k), _t(v), **kw, **tkw)
    _close(out, ref)


@pytest.mark.parametrize("kw", [dict(), dict(window=4), dict(logit_softcap=3.0)])
def test_decode_attention_matches_jax(kw):
    b, s, h, kh, d = 2, 10, 4, 2, 16
    q = RS.randn(b, 1, h, d).astype(np.float32)
    kc, vc = (RS.randn(b, s, kh, d).astype(np.float32) for _ in range(2))
    kn, vn = (RS.randn(b, 1, kh, d).astype(np.float32) for _ in range(2))
    valid = RS.rand(b, s) < 0.7
    qpos = np.full((b, 1), 9, np.int32)
    kpos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    args = (q, kc, vc, kn, vn)
    ref = j_att.decode_attention(
        *map(jnp.asarray, args), kv_valid=jnp.asarray(valid),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos), **kw)
    out = t_att.decode_attention(
        *map(_t, args), kv_valid=_t(valid), q_positions=_t(qpos),
        kv_positions=_t(kpos), **kw)
    _close(out, ref)


def test_filter_logits_per_row_matches_jax():
    logits = RS.randn(4, 200).astype(np.float32) * 2
    temps = np.array([0.7, 1.0, 0.0, 1.3], np.float32)
    top_ps = np.array([0.9, 1.0, 0.5, 0.3], np.float32)
    top_ks = np.array([0, 10, 5, 0], np.int32)
    ref = np.asarray(j_filter_rows(*map(jnp.asarray,
                                        (logits, temps, top_ps, top_ks))))
    out = filter_logits_per_row(*map(_t, (logits, temps, top_ps,
                                          top_ks))).numpy()
    np.testing.assert_array_equal(out <= -1e29, ref <= -1e29)
    keep = ref > -1e29
    _close(out[keep], ref[keep])


def test_left_align():
    ids = torch.tensor([[5, 6, 0, 7, 0], [1, 0, 0, 2, 3]])
    mask = (ids != 0).int()
    out_ids, out_mask = left_align(ids, mask)
    assert out_ids.tolist() == [[5, 6, 7, 0, 0], [1, 2, 3, 0, 0]]
    assert out_mask.tolist() == [[1, 1, 1, 0, 0], [1, 1, 1, 0, 0]]


def test_config_registry_and_tokenizer_match_jax():
    mine, theirs = known_models(), j_known_models()
    assert mine.keys() == theirs.keys()
    for name, cfg in theirs.items():
        assert mine[name].to_dict() == cfg.to_dict(), name
    text = "héllo, wörld"
    assert ByteTokenizer().encode(text, add_eos=True) == \
        JByteTokenizer().encode(text, add_eos=True)
    assert load_tokenizer("byte").decode(ByteTokenizer().encode(text)) == text
    with pytest.raises(NotImplementedError):
        load_tokenizer("meta-llama/Meta-Llama-3-8B")


def test_checkpoint_bf16_leaves_widen_exactly(tmp_path):
    """bf16 leaves (npy 2-byte voids) come back as exact fp32; the model
    loader narrows them back to the config's bf16 param dtype."""
    vals = RS.randn(4, 6).astype(np.float32)
    tree = {"params": {"w": jnp.asarray(vals, jnp.bfloat16),
                       "q": jnp.asarray(RS.randint(-9, 9, (3,)), jnp.int8)}}
    Checkpointer(str(tmp_path)).save(3, tree, {"note": "x"})
    loaded, aux = load_tree_numpy(tmp_path / "latest")
    assert aux == {"note": "x"}
    assert loaded["params"]["w"].dtype == np.float32
    np.testing.assert_array_equal(
        loaded["params"]["w"],
        np.asarray(jnp.asarray(vals, jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_array_equal(loaded["params"]["q"],
                                  np.asarray(tree["params"]["q"]))


def test_load_causal_lm_checkpoint_preset_and_refusals(tmp_path):
    b = load_causal_lm(str(CKPT), {"dtype": "bfloat16",
                                   "param_dtype": "bfloat16"}, device="cpu")
    assert b.config.dtype == "bfloat16"
    assert b.params["layers"]["wq"].dtype == torch.bfloat16
    assert b.tokenizer.eos_token_id == 2
    g = torch.Generator().manual_seed(0)
    tiny = load_causal_lm("tiny", {"tokenizer": "byte"}, g, device="cpu")
    assert tiny.params["layers"]["w_gate"].shape == (2, 64, 192)
    assert tiny.params["lm_head"].shape == (64, 512)
    with pytest.raises(ValueError):      # presets need a generator
        load_causal_lm("tiny", {"tokenizer": "byte"}, device="cpu")
    # a local HF weight directory: its tokenizer is not read yet, and a
    # config.json without weight files is refused as the reference does
    (tmp_path / "config.json").write_text(json.dumps(dict(
        model_type="llama", vocab_size=128, hidden_size=32,
        intermediate_size=64, num_hidden_layers=2, num_attention_heads=4)))
    with pytest.raises(NotImplementedError, match="tokenizer"):
        load_causal_lm(str(tmp_path), {}, g, device="cpu")
    with pytest.raises(FileNotFoundError, match="safetensors"):
        load_causal_lm(str(tmp_path), {"tokenizer": "byte"}, g,
                       device="cpu")


def test_teacher_generation_cli(tmp_path, monkeypatch):
    """The teacher CLI writes one record per prompt; with
    ``--reward_model_path`` (a reward checkpoint the JAX package wrote,
    warm-started from CKPT) each record's ``reward`` equals the JAX
    reward model's score of the same generated sequences to 1e-4 (fp32;
    summation order only)."""
    import jax
    from dla_tpu.training.model_io import build_reward_model as j_build_rm
    from dla_tpu_torch.generation.engine import GenerationEngine
    jrm = j_build_rm({"base_model_name_or_path": str(CKPT)},
                     jax.random.key(3))
    rm_dir = tmp_path / "rm"
    Checkpointer(str(rm_dir)).save(
        0, {"params": jrm.params},
        {"model_config": jrm.config.to_dict(), "tokenizer": "byte"})
    seqs = []
    real = GenerationEngine.generate_text

    def spy(self, *a, **kw):
        texts, out = real(self, *a, **kw)
        seqs.append((out["sequences"].numpy(), out["sequence_mask"].numpy()))
        return texts, out
    monkeypatch.setattr(GenerationEngine, "generate_text", spy)

    prompts = tmp_path / "prompts.jsonl"
    prompts.write_text("".join(json.dumps({"prompt": p}) + "\n"
                               for p in ["one", "two", "three"]))
    out = tmp_path / "out.jsonl"
    argv = ["--model_name_or_path", str(CKPT), "--prompts_path",
            str(prompts), "--output_path", str(out), "--batch_size", "2",
            "--max_prompt_length", "16", "--max_new_tokens", "4"]
    generate_teacher_data.main(argv, device="cpu")
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["prompt"] for r in rows] == ["one", "two", "three"]
    assert all(isinstance(r["teacher_response"], str) for r in rows)
    assert all("reward" not in r for r in rows)

    seqs.clear()
    generate_teacher_data.main(argv + ["--reward_model_path", str(rm_dir)],
                               device="cpu")
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["prompt"] for r in rows] == ["one", "two", "three"]
    ref = np.concatenate([np.asarray(jrm.model.apply(
        jrm.params, jnp.asarray(ids), jnp.asarray(mask)))
        for ids, mask in seqs])[:len(rows)]
    _close([r["reward"] for r in rows], ref, tol=1e-4)


def test_sliding_window_config_is_supported():
    """mistral's uniform window is in the llama family; gemma-2's
    alternating pattern waits for the architecture slice."""
    from dla_tpu_torch.models.config import get_model_config
    from dla_tpu_torch.models.transformer import Transformer
    Transformer(get_model_config("mistral-7b"))
    with pytest.raises(NotImplementedError):
        Transformer(dataclasses.replace(get_model_config("mistral-7b"),
                                        sliding_window_pattern=2))
