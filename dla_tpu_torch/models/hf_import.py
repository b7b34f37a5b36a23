"""Import HuggingFace llama / mistral / qwen2 / phi weights from a local
directory (``dla_tpu.models.hf_import``).

Reads ``config.json`` and ``*.safetensors`` (through the port's own
reader, ``models.safetensors_io``; a ``model.safetensors.index.json``
names the shards) or ``pytorch_model*.bin`` (``torch.load`` with
``weights_only=True``), and returns the JAX package's parameter tree as
host numpy: HF's [out, in] Linear weights transposed to [in, out]
(``x @ w``), per-layer tensors stacked along a leading [L]. The tree
goes to the device through ``models.weights.params_from_jax``, as a
checkpoint's does.

``hf_config_to_model_config`` maps gemma, gemma2 and mixtral configs as
the JAX package does, and the importer reads their tensors, but the
port's ``Transformer`` raises for those blocks until they are ported
(ROADMAP.md §1, item 1). Only local files are read: there is no hub
download.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from dla_tpu_torch.models import safetensors_io
from dla_tpu_torch.models.config import ModelConfig
from dla_tpu_torch.ops.rotary import validate_rope_scaling


def _validated_rope_scaling(hf_cfg):
    """rope_scaling from a config.json, normalized or refused by the
    whitelist ``ops/rotary.py`` implements (None for default-type dicts),
    with the top-level fallbacks HF applies folded into the dict: YaRN's
    and dynamic NTK's trained context, and longrope's switch point and
    attention factor."""
    rs = validate_rope_scaling(hf_cfg.get("rope_scaling"))
    rope_type = rs and rs["rope_type"]
    if (rope_type == "yarn"
            and "original_max_position_embeddings" not in rs
            and "max_position_embeddings" in hf_cfg):
        rs["original_max_position_embeddings"] = int(
            hf_cfg["max_position_embeddings"])
    if (rope_type == "dynamic"
            and "max_position_embeddings" not in rs
            and "max_position_embeddings" in hf_cfg):
        rs["max_position_embeddings"] = int(
            hf_cfg["max_position_embeddings"])
    if rope_type == "longrope":
        # the TOP-LEVEL value wins over a dict-level one: HF reads the
        # config attribute for both the switch point and the factor
        max_pos = hf_cfg.get("max_position_embeddings")
        orig = hf_cfg.get("original_max_position_embeddings")
        if orig:
            rs["original_max_position_embeddings"] = int(orig)
            if max_pos:
                rs["factor"] = float(max_pos) / float(orig)
        elif ("original_max_position_embeddings" not in rs and max_pos):
            rs["original_max_position_embeddings"] = int(max_pos)
    return rs


def hf_config_to_model_config(hf_cfg: Dict[str, Any],
                              **overrides) -> ModelConfig:
    """Map a llama / mistral / qwen2 / gemma / gemma2 / mixtral or phi
    config.json to ModelConfig."""
    model_type = str(hf_cfg.get("model_type", "")).lower()
    if model_type == "phi":
        return _phi_config(hf_cfg, overrides)
    n_heads = int(hf_cfg["num_attention_heads"])
    fields = dict(
        vocab_size=int(hf_cfg["vocab_size"]),
        hidden_size=int(hf_cfg["hidden_size"]),
        intermediate_size=int(hf_cfg["intermediate_size"]),
        num_layers=int(hf_cfg["num_hidden_layers"]),
        num_heads=n_heads,
        num_kv_heads=int(hf_cfg.get("num_key_value_heads", n_heads)),
        head_dim=hf_cfg.get("head_dim"),
        rope_theta=float(hf_cfg.get("rope_theta", 10000.0)),
        rms_norm_eps=float(hf_cfg.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(hf_cfg.get("tie_word_embeddings", False)),
        max_seq_length=int(hf_cfg.get("max_position_embeddings", 4096)),
        # qwen2 carries q/k/v biases; llama configs may set attention_bias
        attention_bias=bool(hf_cfg.get("attention_bias",
                                       model_type == "qwen2")),
    )
    rs = _validated_rope_scaling(hf_cfg)
    if rs:
        fields["rope_scaling"] = rs
    if model_type in ("gemma", "gemma2"):
        # GemmaConfig / Gemma2Config default tie_word_embeddings to True
        fields["arch"] = model_type
        fields["tie_embeddings"] = bool(
            hf_cfg.get("tie_word_embeddings", True))
    if model_type == "gemma2":
        # softcaps, query_pre_attn_scalar, and alternating-layer windows
        # (even layers slide: pattern 2); Gemma2Config has no
        # use_sliding_window knob
        fields["attn_logit_softcap"] = float(
            hf_cfg.get("attn_logit_softcapping") or 0.0)
        fields["final_logit_softcap"] = float(
            hf_cfg.get("final_logit_softcapping") or 0.0)
        qpas = hf_cfg.get("query_pre_attn_scalar")
        if qpas:
            fields["query_pre_attn_scalar"] = int(qpas)
        if hf_cfg.get("sliding_window"):
            fields["sliding_window"] = int(hf_cfg["sliding_window"])
            fields["sliding_window_pattern"] = 2
    if model_type == "mixtral" or "num_local_experts" in hf_cfg:
        fields["num_experts"] = int(hf_cfg.get("num_local_experts", 8))
        fields["num_experts_per_token"] = int(
            hf_cfg.get("num_experts_per_tok", 2))
    # a set sliding_window applies unconditionally in the families with
    # no use_sliding_window knob; qwen2's knob defaults to False
    sw = hf_cfg.get("sliding_window")
    sw_default_on = model_type in ("mistral", "mixtral", "phi3")
    if sw and hf_cfg.get("use_sliding_window", sw_default_on):
        # qwen2's max_window_layers: the FIRST mwl layers run full
        # attention. The window here is all-layers, so only mwl == 0 maps
        # to it; mwl >= L disables it; anything between is refused. An
        # absent key means qwen2's default, 28.
        mwl = hf_cfg.get("max_window_layers")
        if mwl is None and model_type == "qwen2":
            mwl = 28
        n_layers = int(hf_cfg["num_hidden_layers"])
        if mwl is None or int(mwl) == 0:
            fields["sliding_window"] = int(sw)
        elif int(mwl) < n_layers:
            raise ValueError(
                f"partial sliding-window scheme (max_window_layers={mwl} "
                f"of {n_layers} layers full-attention) is not supported; "
                "sliding_window here is all-layers")
    fields.update(overrides)
    return ModelConfig(**fields)


def _phi_config(hf_cfg: Dict[str, Any], overrides) -> ModelConfig:
    """microsoft/phi-2-style config.json: parallel block, partial rotary,
    LayerNorm (layer_norm_eps), biased projections."""
    n_heads = int(hf_cfg["num_attention_heads"])
    fields = dict(
        vocab_size=int(hf_cfg["vocab_size"]),
        hidden_size=int(hf_cfg["hidden_size"]),
        intermediate_size=int(hf_cfg["intermediate_size"]),
        num_layers=int(hf_cfg["num_hidden_layers"]),
        num_heads=n_heads,
        num_kv_heads=int(hf_cfg.get("num_key_value_heads") or n_heads),
        rope_theta=float(hf_cfg.get("rope_theta", 10000.0)),
        rms_norm_eps=float(hf_cfg.get("layer_norm_eps", 1e-5)),
        tie_embeddings=bool(hf_cfg.get("tie_word_embeddings", False)),
        max_seq_length=int(hf_cfg.get("max_position_embeddings", 2048)),
        arch="phi",
        rotary_pct=float(hf_cfg.get("partial_rotary_factor", 0.5)),
    )
    rs = _validated_rope_scaling(hf_cfg)
    if rs:
        fields["rope_scaling"] = rs
    fields.update(overrides)
    return ModelConfig(**fields)


def read_hf_config(model_dir) -> Optional[Dict[str, Any]]:
    p = Path(model_dir) / "config.json"
    if not p.is_file():
        return None
    with p.open() as fh:
        return json.load(fh)


def _load_state_dict(model_dir: Path) -> Dict[str, np.ndarray]:
    """All tensors from safetensors shards (preferred) or torch bins."""
    if safetensors_io.checkpoint_files(model_dir):
        return safetensors_io.load_dir(model_dir)
    bin_files = sorted(model_dir.glob("pytorch_model*.bin"))
    if bin_files:
        import torch
        out: Dict[str, np.ndarray] = {}
        for f in bin_files:
            sd = torch.load(str(f), map_location="cpu", weights_only=True)
            for k, v in sd.items():
                out[k] = v.float().numpy() if v.dtype == torch.bfloat16 \
                    else v.numpy()
        return out
    raise FileNotFoundError(
        f"No *.safetensors or pytorch_model*.bin under {model_dir}")


def import_hf_weights(model_dir, cfg: ModelConfig,
                      dtype: Optional[str] = None) -> Dict[str, Any]:
    """Local HF checkpoint dir -> the parameter tree (host numpy). numpy
    has no bfloat16: a bf16 ``param_dtype`` imports as float32, and the
    device copy (``params_from_jax`` and a cast) rounds it as the JAX
    package's import does."""
    model_dir = Path(model_dir)
    sd = _load_state_dict(model_dir)
    name = dtype or cfg.param_dtype
    pdtype = np.dtype("float32" if name == "bfloat16" else name)
    pre = "model." if any(k.startswith("model.") for k in sd) else ""

    def take(name: str) -> np.ndarray:
        key = pre + name
        if key not in sd:
            raise KeyError(f"HF checkpoint missing tensor '{key}'")
        return np.asarray(sd[key])

    def linear(name: str) -> np.ndarray:
        return take(name).T.astype(pdtype)  # [out, in] -> [in, out]

    if cfg.arch == "phi":
        return _import_phi(sd, cfg, pdtype, take, linear)

    moe = cfg.num_experts > 0
    gemma2 = cfg.arch == "gemma2"
    stacked: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wq", "wk", "wv", "wo",
        "mlp_norm", "w_gate", "w_up", "w_down")}
    if gemma2:
        stacked["attn_post_norm"] = []
        stacked["mlp_post_norm"] = []
    if moe:
        stacked["router"] = []
    if cfg.attention_bias:
        for k in ("wq_bias", "wk_bias", "wv_bias"):
            stacked[k] = []
    # phi-3 fuses q/k/v into qkv_proj and gate/up into gate_up_proj
    fused_qkv = (pre + "layers.0.self_attn.qkv_proj.weight") in sd
    qd = cfg.num_heads * cfg.head_dim_
    kvd = cfg.num_kv_heads * cfg.head_dim_
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        stacked["attn_norm"].append(
            take(p + "input_layernorm.weight").astype(pdtype))
        if fused_qkv:
            qkv = take(p + "self_attn.qkv_proj.weight")  # [(H+2K)dh, D]
            stacked["wq"].append(qkv[:qd].T.astype(pdtype))
            stacked["wk"].append(qkv[qd:qd + kvd].T.astype(pdtype))
            stacked["wv"].append(qkv[qd + kvd:].T.astype(pdtype))
        else:
            stacked["wq"].append(linear(p + "self_attn.q_proj.weight"))
            stacked["wk"].append(linear(p + "self_attn.k_proj.weight"))
            stacked["wv"].append(linear(p + "self_attn.v_proj.weight"))
        if cfg.attention_bias:
            for ours, theirs in (("wq_bias", "q_proj"), ("wk_bias", "k_proj"),
                                 ("wv_bias", "v_proj")):
                stacked[ours].append(
                    take(p + f"self_attn.{theirs}.bias").astype(pdtype))
        stacked["wo"].append(linear(p + "self_attn.o_proj.weight"))
        if gemma2:
            # post_attention_layernorm normalizes the attention OUTPUT; the
            # MLP's pre-norm is pre_feedforward_layernorm
            stacked["attn_post_norm"].append(
                take(p + "post_attention_layernorm.weight").astype(pdtype))
            stacked["mlp_norm"].append(
                take(p + "pre_feedforward_layernorm.weight").astype(pdtype))
            stacked["mlp_post_norm"].append(
                take(p + "post_feedforward_layernorm.weight").astype(pdtype))
        else:
            stacked["mlp_norm"].append(
                take(p + "post_attention_layernorm.weight").astype(pdtype))
        if moe:
            # mixtral: block_sparse_moe.gate -> router, experts.j.{w1, w3,
            # w2} -> gate/up/down stacked along a leading [E]
            m = p + "block_sparse_moe."
            stacked["router"].append(linear(m + "gate.weight"))
            for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"),
                                 ("w_down", "w2")):
                stacked[ours].append(np.stack(
                    [linear(m + f"experts.{j}.{theirs}.weight")
                     for j in range(cfg.num_experts)]))
        elif fused_qkv:
            gu = take(p + "mlp.gate_up_proj.weight")      # [2F, D]
            f_dim = cfg.intermediate_size
            stacked["w_gate"].append(gu[:f_dim].T.astype(pdtype))
            stacked["w_up"].append(gu[f_dim:].T.astype(pdtype))
            stacked["w_down"].append(linear(p + "mlp.down_proj.weight"))
        else:
            stacked["w_gate"].append(linear(p + "mlp.gate_proj.weight"))
            stacked["w_up"].append(linear(p + "mlp.up_proj.weight"))
            stacked["w_down"].append(linear(p + "mlp.down_proj.weight"))

    params: Dict[str, Any] = {
        "embed": {"embedding": take("embed_tokens.weight").astype(pdtype)},
        "layers": {k: np.stack(v) for k, v in stacked.items()},
        "final_norm": take("norm.weight").astype(pdtype),
    }
    if cfg.arch in ("gemma", "gemma2"):
        # HF gemma RMSNorm computes x * (1 + w): the +1 folds into the
        # stored weights, so the model's rms_norm needs no arch branch
        norm_keys = ("attn_norm", "mlp_norm") if cfg.arch == "gemma" else (
            "attn_norm", "mlp_norm", "attn_post_norm", "mlp_post_norm")
        for k in norm_keys:
            params["layers"][k] = params["layers"][k] + np.asarray(1, pdtype)
        params["final_norm"] = params["final_norm"] + np.asarray(1, pdtype)
    if not cfg.tie_embeddings:
        if "lm_head.weight" in sd:
            params["lm_head"] = np.asarray(
                sd["lm_head.weight"]).T.astype(pdtype)
        else:
            params["lm_head"] = params["embed"]["embedding"].T.copy()
    return params


def _import_phi(sd, cfg: ModelConfig, pdtype, take, linear
                ) -> Dict[str, Any]:
    """HF PhiForCausalLM: shared input_layernorm (weight + bias), biased
    q/k/v_proj and dense, biased mlp.fc1/fc2, final_layernorm, biased
    lm_head."""
    names = {
        "ln": "input_layernorm.weight", "ln_bias": "input_layernorm.bias",
        "wq": "self_attn.q_proj.weight", "wq_bias": "self_attn.q_proj.bias",
        "wk": "self_attn.k_proj.weight", "wk_bias": "self_attn.k_proj.bias",
        "wv": "self_attn.v_proj.weight", "wv_bias": "self_attn.v_proj.bias",
        "wo": "self_attn.dense.weight", "wo_bias": "self_attn.dense.bias",
        "fc1": "mlp.fc1.weight", "fc1_bias": "mlp.fc1.bias",
        "fc2": "mlp.fc2.weight", "fc2_bias": "mlp.fc2.bias",
    }
    matrices = ("wq", "wk", "wv", "wo", "fc1", "fc2")
    stacked: Dict[str, list] = {k: [] for k in names}
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        for ours, theirs in names.items():
            stacked[ours].append(
                linear(p + theirs) if ours in matrices
                else take(p + theirs).astype(pdtype))
    params: Dict[str, Any] = {
        "embed": {"embedding": take("embed_tokens.weight").astype(pdtype)},
        "layers": {k: np.stack(v) for k, v in stacked.items()},
        "final_norm": take("final_layernorm.weight").astype(pdtype),
        "final_norm_bias": take("final_layernorm.bias").astype(pdtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = np.asarray(sd["lm_head.weight"]).T.astype(pdtype)
        bias = sd.get("lm_head.bias")
        params["lm_head_bias"] = (
            np.asarray(bias).astype(pdtype) if bias is not None
            else np.zeros((cfg.vocab_size,), pdtype))
    return params
