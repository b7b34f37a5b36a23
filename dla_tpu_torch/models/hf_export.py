"""Export a parameter tree to a HuggingFace checkpoint directory
(``dla_tpu.models.hf_export``), the inverse of ``models.hf_import``.

Writes ``config.json`` and one fp32 ``model.safetensors`` (through the
port's own writer, ``models.safetensors_io``) in the llama-family layout
(llama / mistral / qwen2 / mixtral / gemma / gemma2), so a model trained
here loads into ``transformers`` or any safetensors reader and round-trips
through ``models.hf_import``: the ``x @ w`` [in, out] matrices go back to
HF's [out, in] Linear layout and the leading [L] unstacks into
``model.layers.{i}.*``. Phi is import-only, as in the JAX package, and a
checkpoint of LoRA adapters is refused.

    python -m dla_tpu_torch.models.hf_export \\
        --checkpoint checkpoints/sft/latest --output export/sft_hf
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from dla_tpu_torch.models import safetensors_io
from dla_tpu_torch.models.config import ModelConfig

_ARCHITECTURES = {"mixtral": "MixtralForCausalLM",
                  "mistral": "MistralForCausalLM",
                  "qwen2": "Qwen2ForCausalLM",
                  "gemma": "GemmaForCausalLM",
                  "gemma2": "Gemma2ForCausalLM",
                  "llama": "LlamaForCausalLM"}


def _hf_model_type(cfg: ModelConfig) -> str:
    if cfg.arch in ("phi", "gemma", "gemma2"):
        return cfg.arch
    if cfg.num_experts > 0:
        return "mixtral"
    # attention_bias wins over sliding_window: MistralForCausalLM has no
    # q/k/v biases, qwen2 takes both
    if cfg.attention_bias:
        return "qwen2"
    if cfg.sliding_window:
        return "mistral"
    return "llama"


def _refuse_phi(cfg: ModelConfig) -> None:
    if cfg.arch == "phi":
        raise NotImplementedError(
            "phi export is not implemented (import-only architecture); "
            "export llama-family models")


def model_config_to_hf(cfg: ModelConfig) -> Dict[str, Any]:
    """ModelConfig -> HF config.json dict (the inverse of
    ``hf_config_to_model_config`` for the llama family)."""
    _refuse_phi(cfg)
    model_type = _hf_model_type(cfg)
    out: Dict[str, Any] = {
        "architectures": [_ARCHITECTURES[model_type]],
        "model_type": model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim_,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "max_position_embeddings": cfg.max_seq_length,
        "hidden_act": ("gelu_pytorch_tanh"
                       if cfg.arch in ("gemma", "gemma2") else "silu"),
        "torch_dtype": "float32",
    }
    if cfg.arch == "gemma2":
        # Gemma2's alternation is implicit (pattern 2); another pattern
        # would round-trip to other logits
        if cfg.sliding_window and cfg.sliding_window_pattern != 2:
            raise ValueError(
                f"gemma2 export requires sliding_window_pattern == 2 "
                f"(HF Gemma2's implicit alternation); this model uses "
                f"pattern {cfg.sliding_window_pattern}, which a gemma2 "
                "config.json cannot express")
        out["hidden_activation"] = "gelu_pytorch_tanh"
        out["attn_logit_softcapping"] = cfg.attn_logit_softcap or None
        out["final_logit_softcapping"] = cfg.final_logit_softcap or None
        if cfg.query_pre_attn_scalar:
            out["query_pre_attn_scalar"] = int(cfg.query_pre_attn_scalar)
    if cfg.attention_bias:
        out["attention_bias"] = True
    if cfg.rope_scaling:
        # drop the keys the importer folded in from config.json's top
        # level when they re-derive to the same value there
        rs = dict(cfg.rope_scaling)
        rope_type = rs.get("rope_type")
        if (rope_type == "yarn"
                and rs.get("original_max_position_embeddings")
                == cfg.max_seq_length):
            rs.pop("original_max_position_embeddings")
        if (rope_type == "dynamic"
                and rs.get("max_position_embeddings") == cfg.max_seq_length):
            rs.pop("max_position_embeddings")
        if rope_type == "longrope":
            orig = rs.get("original_max_position_embeddings")
            if orig and int(orig) != int(cfg.max_seq_length):
                # transformers reads longrope's switch point (and the
                # derived factor) from the top-level attribute only
                out["original_max_position_embeddings"] = int(orig)
                if rs.get("factor") == (float(cfg.max_seq_length)
                                        / float(orig)):
                    rs.pop("factor")
            rs.pop("original_max_position_embeddings", None)
        out["rope_scaling"] = rs
    if cfg.sliding_window:
        out["sliding_window"] = int(cfg.sliding_window)
        if model_type == "qwen2":
            # qwen2: max_window_layers 0 = the window on every layer, the
            # all-layer window here
            out["use_sliding_window"] = True
            out["max_window_layers"] = 0
    if cfg.num_experts > 0:
        out["num_local_experts"] = cfg.num_experts
        out["num_experts_per_tok"] = cfg.num_experts_per_token
    return out


def _host(x) -> np.ndarray:
    """A leaf (tensor or array) as host fp32 numpy."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def export_hf_weights(params: Dict[str, Any], cfg: ModelConfig,
                      out_dir) -> Path:
    """Write ``config.json`` + ``model.safetensors`` (fp32) to
    ``out_dir``. ``params`` is the parameter tree (tensors on any device,
    or host numpy)."""
    _refuse_phi(cfg)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def linear(x) -> np.ndarray:
        return np.ascontiguousarray(_host(x).T)   # [in, out] -> [out, in]

    layers = params["layers"]
    # gemma's norms are stored with the +1 of x * (1 + w) folded in
    off = np.float32(1.0 if cfg.arch in ("gemma", "gemma2") else 0.0)

    def norm(x) -> np.ndarray:
        return _host(x) - off

    sd: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": _host(params["embed"]["embedding"]),
        "model.norm.weight": norm(params["final_norm"]),
    }
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = norm(layers["attn_norm"][i])
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"),
                             ("wv", "v_proj"), ("wo", "o_proj")):
            sd[p + f"self_attn.{theirs}.weight"] = linear(layers[ours][i])
        if cfg.attention_bias:
            for ours, theirs in (("wq_bias", "q_proj"), ("wk_bias", "k_proj"),
                                 ("wv_bias", "v_proj")):
                sd[p + f"self_attn.{theirs}.bias"] = _host(layers[ours][i])
        if cfg.arch == "gemma2":
            sd[p + "post_attention_layernorm.weight"] = norm(
                layers["attn_post_norm"][i])
            sd[p + "pre_feedforward_layernorm.weight"] = norm(
                layers["mlp_norm"][i])
            sd[p + "post_feedforward_layernorm.weight"] = norm(
                layers["mlp_post_norm"][i])
        else:
            sd[p + "post_attention_layernorm.weight"] = norm(
                layers["mlp_norm"][i])
        if cfg.num_experts > 0:
            m = p + "block_sparse_moe."
            sd[m + "gate.weight"] = linear(layers["router"][i])
            for j in range(cfg.num_experts):
                for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"),
                                     ("w_down", "w2")):
                    sd[m + f"experts.{j}.{theirs}.weight"] = linear(
                        layers[ours][i][j])
        else:
            for ours, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                                 ("w_down", "down_proj")):
                sd[p + f"mlp.{theirs}.weight"] = linear(layers[ours][i])
    if not cfg.tie_embeddings and "lm_head" in params:
        sd["lm_head.weight"] = linear(params["lm_head"])

    safetensors_io.save_file(sd, out_dir / "model.safetensors",
                             metadata={"format": "pt"})
    with (out_dir / "config.json").open("w") as fh:
        json.dump(model_config_to_hf(cfg), fh, indent=1)
    return out_dir


def export_checkpoint(checkpoint_path, out_dir) -> Path:
    """A checkpoint dir (or its ``latest`` pointer) -> HF dir. The
    checkpoint's ``model_config`` aux describes it. A tree of LoRA
    adapters (or one without base weights) is refused: export the
    ``merged`` checkpoint."""
    from dla_tpu_torch.checkpoint.checkpointer import load_tree_numpy
    params, aux = load_tree_numpy(checkpoint_path, prefix="params")
    mc = aux.get("model_config")
    if mc is None:
        raise ValueError(
            f"checkpoint {checkpoint_path} lacks model_config aux; "
            "cannot derive the HF config")
    layer_keys = params.get("layers", {})
    if "embed" not in params or any(
            k.endswith(("_lora_a", "_lora_b")) for k in layer_keys):
        raise ValueError(
            "checkpoint holds unmerged LoRA adapters (or no base "
            "weights); export the `merged` checkpoint the trainers "
            "write (checkpoints/<phase>/merged)")
    return export_hf_weights(params, ModelConfig.from_dict(mc), out_dir)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Export a checkpoint to HF safetensors")
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint dir or its latest pointer")
    ap.add_argument("--output", required=True, help="output directory")
    args = ap.parse_args(argv)
    out = export_checkpoint(args.checkpoint, args.output)
    print(f"[dla_tpu_torch] exported HF checkpoint to {out}")


if __name__ == "__main__":
    main()
