"""HF weight directories in the port against the JAX package: tiny HF
llama, mistral (sliding window), qwen2 (q/k/v biases) and phi models
written by the installed ``transformers`` (safetensors, a sharded index,
a ``pytorch_model.bin``) import to the JAX package's tree exactly;
``hf_config_to_model_config`` maps configs as the JAX one does;
``load_causal_lm`` resolves a directory to the JAX model's logits; the
export writes the JAX export's tensors and ``config.json`` and
round-trips; phi export and adapter checkpoints are refused; and the
port's safetensors reader and writer interoperate with the
``safetensors`` package. Each test states its tolerance."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")

from dla_tpu.models import hf_export as j_export  # noqa: E402
from dla_tpu.models import hf_import as j_import  # noqa: E402
from dla_tpu.models.config import get_model_config as j_get_config  # noqa: E402
from dla_tpu.models.transformer import Transformer as JTransformer  # noqa: E402
from dla_tpu.training import model_io as j_model_io  # noqa: E402
from dla_tpu_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from dla_tpu_torch.models import hf_export, hf_import, safetensors_io  # noqa: E402
from dla_tpu_torch.models.config import ModelConfig, get_model_config  # noqa: E402
from dla_tpu_torch.models.weights import params_from_jax  # noqa: E402
from dla_tpu_torch.training import model_io  # noqa: E402

SMALL = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=64)


def _hf_model(arch: str):
    from transformers import (LlamaConfig, LlamaForCausalLM, MistralConfig,
                              MistralForCausalLM, PhiConfig, PhiForCausalLM,
                              Qwen2Config, Qwen2ForCausalLM)
    if arch == "llama":
        model = LlamaForCausalLM(LlamaConfig(
            **SMALL, num_key_value_heads=2, tie_word_embeddings=False))
    elif arch == "mistral":
        model = MistralForCausalLM(MistralConfig(
            **SMALL, num_key_value_heads=2, sliding_window=16))
    elif arch == "qwen2":
        model = Qwen2ForCausalLM(Qwen2Config(
            **SMALL, num_key_value_heads=2, tie_word_embeddings=False))
    else:
        model = PhiForCausalLM(PhiConfig(**SMALL, partial_rotary_factor=0.5))
    with torch.no_grad():          # non-zero biases, norms near 1
        g = torch.Generator().manual_seed(7)
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model.eval()


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """{(arch, layout): directory} for every arch and weight layout."""
    out = {}
    for arch in ("llama", "mistral", "qwen2", "phi"):
        torch.manual_seed(0)
        model = _hf_model(arch)
        for layout, kw in (("safetensors", {}),
                           ("sharded", dict(max_shard_size="20KB")),
                           ("bin", dict(safe_serialization=False))):
            d = tmp_path_factory.mktemp(f"{arch}_{layout}")
            model.save_pretrained(str(d), **kw)
            out[arch, layout] = d
        out[arch, "model"] = model
    return out


@pytest.mark.parametrize("layout", ["safetensors", "sharded", "bin"])
@pytest.mark.parametrize("arch", ["llama", "mistral", "qwen2", "phi"])
def test_import_matches_jax_leaf_for_leaf(hf_dirs, arch, layout):
    """The port's config and tree of an HF directory equal the JAX
    package's, every leaf exactly."""
    d = hf_dirs[arch, layout]
    if layout == "sharded":
        assert (d / safetensors_io.INDEX_NAME).is_file()
        assert len(safetensors_io.checkpoint_files(d)) > 1
    if layout == "bin":
        assert not list(d.glob("*.safetensors"))
    hf_cfg = hf_import.read_hf_config(d)
    assert hf_cfg == j_import.read_hf_config(d)
    cfg = hf_import.hf_config_to_model_config(hf_cfg)
    jcfg = j_import.hf_config_to_model_config(hf_cfg)
    assert cfg.to_dict() == jcfg.to_dict()
    mine = hf_import.import_hf_weights(d, cfg)
    ref = j_import.import_hf_weights(d, jcfg)
    m_leaves = dict(jax.tree_util.tree_leaves_with_path(mine))
    r_leaves = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert set(m_leaves) == set(r_leaves)
    for path, r in r_leaves.items():
        m = m_leaves[path]
        assert m.dtype == r.dtype and m.shape == r.shape
        np.testing.assert_array_equal(m, r, err_msg=str(path))


_BASE = dict(model_type="llama", vocab_size=128, hidden_size=32,
             intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2)
CONFIGS = {
    "llama": _BASE,
    "mistral window": {**_BASE, "model_type": "mistral",
                       "sliding_window": 4096},
    "mistral no window": {**_BASE, "model_type": "mistral"},
    "window None": {**_BASE, "model_type": "mistral",
                    "sliding_window": None},
    "qwen2 window off": {**_BASE, "model_type": "qwen2",
                         "sliding_window": 131072,
                         "use_sliding_window": False},
    "qwen2 partial window": {**_BASE, "model_type": "qwen2",
                             "num_hidden_layers": 28, "sliding_window": 4096,
                             "use_sliding_window": True,
                             "max_window_layers": 21},
    "qwen2 mwl = L": {**_BASE, "model_type": "qwen2", "num_hidden_layers": 28,
                      "sliding_window": 4096, "use_sliding_window": True,
                      "max_window_layers": 28},
    "qwen2 mwl = 0": {**_BASE, "model_type": "qwen2", "num_hidden_layers": 28,
                      "sliding_window": 4096, "use_sliding_window": True,
                      "max_window_layers": 0},
    "qwen2 mwl absent": {**_BASE, "model_type": "qwen2",
                         "sliding_window": 4096, "use_sliding_window": True},
    "llama3.1 rope": {**_BASE, "max_position_embeddings": 131072,
                      "rope_theta": 500000.0,
                      "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                                       "low_freq_factor": 1.0,
                                       "high_freq_factor": 4.0,
                                       "original_max_position_embeddings":
                                           8192}},
    "yarn": {**_BASE, "max_position_embeddings": 4096,
             "rope_scaling": {"rope_type": "yarn", "factor": 4.0}},
    "dynamic": {**_BASE, "max_position_embeddings": 2048,
                "rope_scaling": {"type": "dynamic", "factor": 2.0}},
    "longrope": {**_BASE, "model_type": "phi3",
                 "max_position_embeddings": 131072,
                 "original_max_position_embeddings": 4096,
                 "sliding_window": 262144,
                 "rope_scaling": {"type": "longrope",
                                  "short_factor": [1.0] * 4,
                                  "long_factor": [2.0] * 4}},
    "default rope": {**_BASE, "rope_scaling": {"rope_type": "default"}},
    "unknown rope": {**_BASE, "rope_scaling": {"rope_type": "made_up",
                                               "factor": 2.0}},
    "gemma": {**_BASE, "model_type": "gemma", "head_dim": 16},
    "gemma2": {**_BASE, "model_type": "gemma2", "head_dim": 16,
               "attn_logit_softcapping": 50.0,
               "final_logit_softcapping": 30.0,
               "query_pre_attn_scalar": 16, "sliding_window": 8},
    "mixtral": {**_BASE, "model_type": "mixtral", "num_local_experts": 4,
                "num_experts_per_tok": 2, "sliding_window": None},
    "phi": {"model_type": "phi", "vocab_size": 128, "hidden_size": 32,
            "intermediate_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "partial_rotary_factor": 0.4,
            "layer_norm_eps": 1e-5, "max_position_embeddings": 2048},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_hf_config_to_model_config_matches_jax(name):
    """Every mapping rule (windows and max_window_layers, rope-scaling
    folds and refusals, gemma / gemma2 / mixtral / phi fields) gives the
    JAX package's ModelConfig, or the same exception."""
    hf_cfg = CONFIGS[name]
    try:
        ref = j_import.hf_config_to_model_config(json.loads(
            json.dumps(hf_cfg))).to_dict()
    except (ValueError, NotImplementedError) as e:
        with pytest.raises(type(e)):
            hf_import.hf_config_to_model_config(dict(hf_cfg))
        return
    assert hf_import.hf_config_to_model_config(
        json.loads(json.dumps(hf_cfg))).to_dict() == ref


@pytest.mark.parametrize("arch", ["llama", "phi"])
def test_load_causal_lm_resolves_hf_dir(hf_dirs, arch):
    """A local HF directory resolves (checkpoint > HF dir > preset) to
    the JAX package's model: fp32 logits within 1e-4, and within 2e-4
    of transformers' own. Without ``tokenizer: byte`` the directory's
    HF tokenizer is asked for, which the port does not read yet."""
    d = hf_dirs[arch, "safetensors"]
    extra = {"tokenizer": "byte", "dtype": "float32",
             "param_dtype": "float32", "remat": "none"}
    bundle = model_io.load_causal_lm(str(d), extra, device="cpu")
    jb = j_model_io.load_causal_lm(str(d), extra, jax.random.key(0))
    assert bundle.config.to_dict() == jb.config.to_dict()
    ids = np.random.RandomState(0).randint(0, 128, (2, 10)).astype(np.int32)
    ours = bundle.model.apply(bundle.params, torch.from_numpy(ids)).numpy()
    ref = np.asarray(jb.model.apply(jb.params, jnp.asarray(ids)))
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    with torch.no_grad():
        hf = hf_dirs[arch, "model"](torch.from_numpy(ids).long()).logits
    np.testing.assert_allclose(ours, hf.numpy(), atol=2e-4)
    with pytest.raises(NotImplementedError, match="tokenizer"):
        model_io.load_causal_lm(str(d), {}, device="cpu")


def test_reward_model_backbone_from_hf_dir(hf_dirs):
    """build_reward_model takes an HF directory as its backbone (the
    lm_head dropped, a fresh head): the backbone leaves equal the
    import's."""
    d = hf_dirs["llama", "safetensors"]
    bundle = model_io.build_reward_model(
        {"base_model_name_or_path": str(d), "tokenizer": "byte"},
        torch.Generator().manual_seed(0), device="cpu")
    assert "lm_head" not in bundle.params and "reward_head" in bundle.params
    ref = hf_import.import_hf_weights(d, bundle.config)
    np.testing.assert_array_equal(bundle.params["layers"]["wq"].numpy(),
                                  ref["layers"]["wq"])


def _llama_tree(**over):
    """A tiny llama-family JAX config and tree with random norms and
    biases."""
    kw = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, max_seq_length=64,
              param_dtype="float32")
    jcfg = j_get_config("llama3-8b", **{**kw, **over})
    jp = jax.tree.map(np.asarray, JTransformer(jcfg).init(jax.random.key(3)))
    rs = np.random.RandomState(5)
    for name, leaf in list(jp["layers"].items()):
        if name.endswith(("_norm", "_bias")):
            jp["layers"][name] = (leaf + 0.1 * rs.randn(*leaf.shape)).astype(
                np.float32)
    return jcfg, jp


EXPORTS = {"llama": {},
           "mistral window": dict(sliding_window=16),
           "qwen2 biases + window": dict(attention_bias=True,
                                         sliding_window=16),
           "tied": dict(tie_embeddings=True),
           "llama3 rope": dict(rope_scaling={
               "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 32})}


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_export_matches_jax_and_round_trips(tmp_path, name):
    """The port's export of a tiny tree has the JAX export's tensors
    (read by ``safetensors.safe_open``) and ``config.json``; importing it
    back gives the tree and the config exactly."""
    from safetensors import safe_open
    jcfg, jp = _llama_tree(**EXPORTS[name])
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    j_export.export_hf_weights(jp, jcfg, tmp_path / "jax")
    hf_export.export_hf_weights(params_from_jax(jp, "cpu"), cfg,
                                tmp_path / "port")
    assert json.loads((tmp_path / "port" / "config.json").read_text()) == \
        json.loads((tmp_path / "jax" / "config.json").read_text())
    tensors = []
    for side in ("jax", "port"):
        with safe_open(str(tmp_path / side / "model.safetensors"),
                       framework="np") as f:
            tensors.append({k: f.get_tensor(k) for k in f.keys()})
    assert set(tensors[0]) == set(tensors[1])
    for k, v in tensors[0].items():
        assert tensors[1][k].dtype == np.float32
        np.testing.assert_array_equal(tensors[1][k], v, err_msg=k)
    hf_cfg = hf_import.read_hf_config(tmp_path / "port")
    back_cfg = hf_import.hf_config_to_model_config(
        hf_cfg, param_dtype="float32")
    for field in ("vocab_size", "hidden_size", "num_layers", "num_kv_heads",
                  "sliding_window", "attention_bias", "tie_embeddings",
                  "rope_scaling"):
        assert getattr(back_cfg, field) == getattr(cfg, field), field
    back = hf_import.import_hf_weights(tmp_path / "port", back_cfg)
    orig = dict(jax.tree_util.tree_leaves_with_path(jp))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(orig)
    for path, leaf in orig.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_export_checkpoint_cli_and_refusals(tmp_path):
    """The CLI exports a checkpoint the port wrote, read back equal; a
    phi config and a checkpoint of LoRA adapters are refused."""
    jcfg, jp = _llama_tree()
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    aux = {"model_config": cfg.to_dict()}
    Checkpointer(tmp_path / "ckpt").save(
        4, {"params": params_from_jax(jp, "cpu")}, aux, tag="final")
    hf_export.main(["--checkpoint", str(tmp_path / "ckpt" / "final"),
                    "--output", str(tmp_path / "hf")])
    back = hf_import.import_hf_weights(tmp_path / "hf", cfg)
    np.testing.assert_array_equal(back["layers"]["w_up"],
                                  jp["layers"]["w_up"])
    phi = get_model_config("phi-2", num_layers=2)
    with pytest.raises(NotImplementedError, match="phi export"):
        hf_export.model_config_to_hf(phi)
    with pytest.raises(NotImplementedError, match="phi export"):
        hf_export.export_hf_weights({}, phi, tmp_path / "phi")
    lora = {"embed": {"embedding": torch.zeros(4, 2)},
            "layers": {"wq_lora_a": torch.zeros(2, 2, 1)}}
    Checkpointer(tmp_path / "lora").save(1, {"params": lora}, aux,
                                         tag="final")
    with pytest.raises(ValueError, match="LoRA"):
        hf_export.export_checkpoint(tmp_path / "lora" / "final",
                                    tmp_path / "x")
    with pytest.raises(ValueError, match="model_config"):
        Checkpointer(tmp_path / "bare").save(1, {"params": lora}, {},
                                             tag="final")
        hf_export.export_checkpoint(tmp_path / "bare" / "final",
                                    tmp_path / "y")


def _arrays():
    rs = np.random.RandomState(9)
    return {"f32": rs.randn(3, 5).astype(np.float32),
            "f16": rs.randn(4).astype(np.float16),
            "f64": rs.randn(2, 2),
            "i8": rs.randint(-128, 128, (6, 2)).astype(np.int8),
            "i32": rs.randint(-9, 9, (2, 3, 2)).astype(np.int32),
            "i64": np.arange(5, dtype=np.int64),
            "scalar": np.asarray(2.5, np.float32),
            "empty": np.zeros((0, 3), np.float32)}


def test_safetensors_reader_reads_the_package_files(tmp_path):
    """Files the ``safetensors`` package wrote (numpy: F32/F16/F64/I8/
    I32/I64, scalars, empty; torch: BF16) read back equal through the
    port's reader, BF16 widened to float32 exactly."""
    from safetensors.numpy import save_file as np_save
    from safetensors.torch import save_file as torch_save
    arrays = _arrays()
    np_save(arrays, str(tmp_path / "a.safetensors"), metadata={"k": "v"})
    got = safetensors_io.load_file(tmp_path / "a.safetensors")
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)
    assert safetensors_io.read_header(
        tmp_path / "a.safetensors")["__metadata__"] == {"k": "v"}
    bf = torch.randn(7, 3).to(torch.bfloat16)
    torch_save({"w": bf}, str(tmp_path / "b.safetensors"))
    w = safetensors_io.load_file(tmp_path / "b.safetensors")["w"]
    assert w.dtype == np.float32
    np.testing.assert_array_equal(w, bf.float().numpy())


def test_safetensors_writer_is_read_by_the_package(tmp_path):
    """The port's writer's files read back equal through
    ``safetensors.safe_open`` (numpy), metadata included, and through
    the port's reader."""
    from safetensors import safe_open
    arrays = _arrays()
    path = tmp_path / "mine.safetensors"
    safetensors_io.save_file(arrays, path, metadata={"format": "pt"})
    with safe_open(str(path), framework="np") as f:
        assert f.metadata() == {"format": "pt"}
        assert set(f.keys()) == set(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(f.get_tensor(k), v)
    mine = safetensors_io.load_file(path)
    for k, v in arrays.items():
        np.testing.assert_array_equal(mine[k], v)
    with pytest.raises(ValueError, match="dtype"):
        safetensors_io.save_file({"c": np.zeros(2, np.complex64)},
                                 tmp_path / "c.safetensors")


def test_hf_dir_model_is_a_transformers_model(tmp_path):
    """transformers loads the port's export of a tiny llama and computes
    the port model's logits (within 2e-4)."""
    jcfg, jp = _llama_tree()
    cfg = dataclasses.replace(ModelConfig.from_dict(jcfg.to_dict()),
                              dtype="float32", remat="none")
    params = params_from_jax(jp, "cpu")
    hf_export.export_hf_weights(params, cfg, tmp_path / "hf")
    from transformers import AutoModelForCausalLM
    hf = AutoModelForCausalLM.from_pretrained(str(tmp_path / "hf")).eval()
    from dla_tpu_torch.models.transformer import Transformer
    ids = np.random.RandomState(1).randint(0, 96, (2, 9))
    ours = Transformer(cfg).apply(params, torch.from_numpy(ids)).numpy()
    with torch.no_grad():
        theirs = hf(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-4)
