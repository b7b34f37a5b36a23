"""Config loading for the CLIs (``dla_tpu.training.config``, lines
30-145): the YAML files under ``config/``, overlay fragments merged in
order, then dotted ``--set key=value`` overrides parsed as YAML. The
schema dataclasses the JAX package's linter reads are not ported."""
from __future__ import annotations

import argparse
import copy
from pathlib import Path
from typing import Any, Dict, Sequence

import yaml


def load_yaml(path) -> Dict[str, Any]:
    with Path(path).open("r", encoding="utf-8") as fh:
        return yaml.safe_load(fh) or {}


def deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]
               ) -> Dict[str, Any]:
    """Recursive dict merge; overlay wins; lists replace wholesale."""
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def set_dotted(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"Cannot set '{dotted}': '{k}' is not a mapping")
    node[keys[-1]] = value


def apply_overrides(cfg: Dict[str, Any], overrides: Sequence[str]
                    ) -> Dict[str, Any]:
    """``a.b.c=value`` overrides; values parsed as YAML (1e-5, true,
    [1,2])."""
    out = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override '{ov}' is not of the form key=value")
        key, raw = ov.split("=", 1)
        set_dotted(out, key.strip(), yaml.safe_load(raw))
    return out


def load_config(path, overlays: Sequence[str] = (),
                overrides: Sequence[str] = ()) -> Dict[str, Any]:
    cfg = load_yaml(path)
    for ov_path in overlays:
        cfg = deep_merge(cfg, load_yaml(ov_path))
    return apply_overrides(cfg, overrides)


def make_arg_parser(description: str) -> argparse.ArgumentParser:
    """``train_X --config cfg.yaml [--overlay o.yaml] [--set key=value]
    [--resume]``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True, help="YAML config path")
    p.add_argument("--overlay", action="append", default=[],
                   help="overlay YAML fragment(s), e.g. "
                        "config/ablations/low_lr.yaml")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted config override")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "logging.output_dir")
    return p


def config_from_args(args: argparse.Namespace) -> Dict[str, Any]:
    return load_config(args.config, args.overlay, args.overrides)
