"""Model resolution: checkpoint path / preset name -> ModelBundle.

The causal-LM half of ``dla_tpu.training.model_io``: the same config keys
accept a checkpoint directory written by the JAX package (or its
``latest`` pointer) or a registry preset / HF repo id (fresh random
init). Local HF weight directories and the reward model are not ported
yet and raise.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from dla_tpu_torch.checkpoint.checkpointer import (
    is_checkpoint_path,
    load_tree_numpy,
)
from dla_tpu_torch.data.tokenizers import ByteTokenizer, Tokenizer, load_tokenizer
from dla_tpu_torch.models.config import ModelConfig, get_model_config
from dla_tpu_torch.models.transformer import Transformer
from dla_tpu_torch.models.weights import params_from_jax


@dataclasses.dataclass
class ModelBundle:
    model: Transformer
    params: Any
    tokenizer: Tokenizer
    config: ModelConfig


def _tokenizer_for(name_or_path: str, model_cfg: Dict[str, Any],
                   aux: Optional[Dict] = None) -> Tokenizer:
    tok_name = model_cfg.get("tokenizer")
    if tok_name:
        return load_tokenizer(tok_name)
    if aux and aux.get("tokenizer"):
        return load_tokenizer(aux["tokenizer"])
    if is_checkpoint_path(name_or_path):
        return ByteTokenizer()
    return load_tokenizer(name_or_path)


def _arch_overrides(model_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Config keys that override preset architecture fields (the JAX
    package's whitelist, unchanged)."""
    out: Dict[str, Any] = {}
    if "max_seq_length" in model_cfg:
        out["max_seq_length"] = int(model_cfg["max_seq_length"])
    if model_cfg.get("gradient_checkpointing") is False:
        out["remat"] = "none"
    elif model_cfg.get("gradient_checkpointing") is True:
        out["remat"] = "full"
    if "use_flash_attention" in model_cfg:
        out["attention"] = ("flash" if model_cfg["use_flash_attention"]
                            else "xla")
    for key in ("dtype", "param_dtype", "remat", "vocab_size", "attention",
                "kv_cache_dtype", "decode_kernel",
                "context_parallel", "arch", "rotary_pct", "attention_bias",
                "sliding_window", "sliding_window_pattern",
                "attn_logit_softcap", "final_logit_softcap",
                "query_pre_attn_scalar",
                "pipeline_microbatches", "pipeline_interleave",
                "pipeline_stages",
                "num_experts", "num_experts_per_token",
                "moe_capacity_factor", "moe_group_size", "moe_aux_weight",
                "moe_z_weight"):
        if key in model_cfg:
            out[key] = model_cfg[key]
    lora = model_cfg.get("lora") or {}
    if lora.get("enabled"):
        out["lora_r"] = int(lora.get("r", 8))
        out["lora_alpha"] = float(lora.get("alpha", 32.0))
        out["lora_dropout"] = float(lora.get("dropout", 0.0))
        if lora.get("target_modules"):
            out["lora_targets"] = tuple(lora["target_modules"])
    return out


def load_causal_lm(name_or_path: str, model_cfg: Dict[str, Any],
                   generator: Optional[torch.Generator] = None,
                   device="cuda") -> ModelBundle:
    """Resolve a causal LM: checkpoint > registry preset. Parameters land
    on ``device``; a preset is initialised from ``generator``, which must
    live on that device."""
    device = torch.device(device)
    overrides = _arch_overrides(model_cfg)
    if is_checkpoint_path(name_or_path):
        tree, aux = load_tree_numpy(name_or_path, prefix="params")
        mc = aux.get("model_config")
        if mc is None:
            raise ValueError(
                f"checkpoint {name_or_path} lacks model_config aux; "
                "cannot rebuild the architecture")
        cfg = ModelConfig.from_dict({**mc, **overrides})
        model = Transformer(cfg)
        params = params_from_jax(tree, device)
        if model.pdtype != torch.float32:   # bf16 leaves were widened
            params = _cast_floats(params, model.pdtype)
        tok = _tokenizer_for(name_or_path, model_cfg, aux)
        return ModelBundle(model, params, tok, cfg)

    p = Path(name_or_path)
    if p.is_dir() and (p / "config.json").is_file():
        raise NotImplementedError(
            f"{name_or_path}: HF weight-directory import is not ported yet "
            "(ROADMAP.md); load a dla_tpu checkpoint or a preset")
    cfg = get_model_config(name_or_path, **overrides)
    tok = _tokenizer_for(name_or_path, model_cfg)
    if getattr(tok, "vocab_size", cfg.vocab_size) > cfg.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=int(tok.vocab_size))
    model = Transformer(cfg)
    if generator is None:
        raise ValueError("load_causal_lm: a preset needs a torch.Generator "
                         "to initialise its parameters")
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device} cannot "
                         f"initialise parameters on {device}")
    params = model.init(generator)
    return ModelBundle(model, params, tok, cfg)


def _cast_floats(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree
