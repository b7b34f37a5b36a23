"""Parameter trees between the JAX package and the port.

Both packages use one layout (leaf names, stacked ``[L, d_in, d_out]``
layer leaves, ``x @ W``), so conversion is a dtype-preserving copy.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _to_tensor(leaf: Any, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 arrays are not accepted by torch.from_numpy;
        # widening to fp32 and narrowing back is exact
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The JAX package's parameter tree (nested dicts of numpy or
    numpy-convertible arrays) -> the same tree of tensors on ``device``.
    int8 weights and their ``_wscale`` leaves pass through unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Tensors -> host numpy (bf16 widened to fp32, exactly)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
