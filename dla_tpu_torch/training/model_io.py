"""Model resolution: checkpoint path / preset name -> ModelBundle
(``dla_tpu.training.model_io``).

The same config keys accept a checkpoint directory written by either
package (or its ``latest`` pointer) or a registry preset / HF repo id
(fresh random init), for a causal LM (``load_causal_lm``; llama or phi
blocks), a distillation teacher (``load_teacher``: a causal LM whose
vocabulary must be the student's) or a reward model
(``build_reward_model``). Local HF weight directories are not ported yet
and raise.
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
from dla_tpu_torch.models.reward import RewardModel
from dla_tpu_torch.models.transformer import Transformer
from dla_tpu_torch.models.weights import params_from_jax


@dataclasses.dataclass
class ModelBundle:
    model: Any          # Transformer or RewardModel
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


def _checkpoint_tree(name: str, model_cfg: Dict[str, Any]):
    """(host numpy params, ModelConfig with the config's overrides,
    tokenizer) of a checkpoint."""
    tree, aux = load_tree_numpy(name, prefix="params")
    mc = aux.get("model_config")
    if mc is None:
        raise ValueError(
            f"checkpoint {name} lacks model_config aux; cannot rebuild the "
            "architecture")
    cfg = ModelConfig.from_dict({**mc, **_arch_overrides(model_cfg)})
    return tree, cfg, _tokenizer_for(name, model_cfg, aux)


def _device_params(tree, dtype: torch.dtype, device) -> Any:
    params = params_from_jax(tree, device)
    if dtype != torch.float32:   # bf16 leaves were widened
        params = _cast_floats(params, dtype)
    return params


def _preset(name: str, model_cfg: Dict[str, Any],
            generator: Optional[torch.Generator], device: torch.device):
    """(ModelConfig, tokenizer) of a registry preset, its vocabulary grown
    to the tokenizer's; checks that ``generator`` can initialise it on
    ``device``."""
    p = Path(name)
    if p.is_dir() and (p / "config.json").is_file():
        raise NotImplementedError(
            f"{name}: HF weight-directory import is not ported yet "
            "(ROADMAP.md); load a dla_tpu checkpoint or a preset")
    cfg = get_model_config(name, **_arch_overrides(model_cfg))
    tok = _tokenizer_for(name, model_cfg)
    if getattr(tok, "vocab_size", cfg.vocab_size) > cfg.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=int(tok.vocab_size))
    _check_generator(generator, device)
    return cfg, tok


def _check_generator(generator: Optional[torch.Generator],
                     device: torch.device) -> None:
    if generator is None:
        raise ValueError("a preset needs a torch.Generator to initialise "
                         "its parameters")
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device} cannot "
                         f"initialise parameters on {device}")


def load_causal_lm(name_or_path: str, model_cfg: Dict[str, Any],
                   generator: Optional[torch.Generator] = None,
                   device="cuda") -> ModelBundle:
    """Resolve a causal LM: checkpoint > registry preset. Parameters land
    on ``device``; a preset is initialised from ``generator``, which must
    live on that device."""
    device = torch.device(device)
    if is_checkpoint_path(name_or_path):
        tree, cfg, tok = _checkpoint_tree(name_or_path, model_cfg)
        model = Transformer(cfg)
        return ModelBundle(model, _device_params(tree, model.pdtype, device),
                           tok, cfg)
    cfg, tok = _preset(name_or_path, model_cfg, generator, device)
    model = Transformer(cfg)
    return ModelBundle(model, model.init(generator), tok, cfg)


def load_teacher(name_or_path: str, model_cfg: Dict[str, Any],
                 student_vocab: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> ModelBundle:
    """A distillation teacher, resolved as ``load_causal_lm`` does; KL
    distillation needs the student's vocabulary, and another one
    raises."""
    tb = load_causal_lm(name_or_path, model_cfg, generator, device=device)
    if tb.config.vocab_size != student_vocab:
        raise ValueError(
            f"teacher '{name_or_path}' vocab {tb.config.vocab_size} != "
            f"student vocab {student_vocab}; KL distillation needs a shared "
            "vocabulary")
    return tb


def build_reward_model(model_cfg: Dict[str, Any],
                       generator: Optional[torch.Generator] = None,
                       device="cuda") -> ModelBundle:
    """Reward model from ``model.base_model_name_or_path`` (or
    ``model_name_or_path``) with ``model.pooling`` / ``model.dropout``:
    a reward checkpoint as saved; a causal-LM checkpoint as a warm start
    (its ``lm_head`` dropped, a fresh head drawn from ``generator``); or
    a preset initialised from ``generator``."""
    device = torch.device(device)
    name = (model_cfg.get("base_model_name_or_path")
            or model_cfg.get("model_name_or_path"))
    pooling = model_cfg.get("pooling", "last_token")
    dropout = float(model_cfg.get("dropout", 0.0))
    if is_checkpoint_path(name):
        tree, cfg, tok = _checkpoint_tree(name, model_cfg)
        rm = RewardModel(cfg, pooling=pooling, dropout=dropout)
        warm = "reward_head" not in tree
        if warm:
            tree.pop("lm_head", None)
            _check_generator(generator, device)
        params = _device_params(tree, rm.backbone.pdtype, device)
        if warm:
            params["reward_head"] = rm.init_head(generator)
        return ModelBundle(rm, params, tok, cfg)
    cfg, tok = _preset(name, model_cfg, generator, device)
    rm = RewardModel(cfg, pooling=pooling, dropout=dropout)
    return ModelBundle(rm, rm.init(generator), tok, cfg)


def model_aux(bundle: ModelBundle, tokenizer_name: Optional[str] = None
              ) -> Dict[str, Any]:
    """The aux a checkpoint carries to describe itself."""
    out: Dict[str, Any] = {"model_config": bundle.config.to_dict()}
    if tokenizer_name:
        out["tokenizer"] = tokenizer_name
    return out


def _cast_floats(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree
