"""LR schedule, global-norm clipping and AdamW with optax's semantics
(``dla_tpu.training.optim``).

- The schedule is a function of the number of updates already applied
  (optax's count starts at 0): with ``warmup_cosine_decay_schedule(
  init_value=0)`` the first update has lr 0, and ``decay_steps =
  max(total, warmup + 1)`` includes the warmup.
- Clipping scales by ``max_norm / max(norm, max_norm)`` with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6), computed as optax does:
  ``g / norm * max_norm`` once the norm reaches the bound.
- ``torch.optim.AdamW`` matches ``optax.adamw``: bias-corrected moments,
  eps outside the square root, decoupled weight decay on every leaf
  (norms and embedding included) scaled by the same lr. The JAX package
  leaves the update to optax/XLA; there is no Pallas kernel on it.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _join(schedules: Sequence[Callable[[int], float]],
          boundaries: Sequence[int]) -> Callable[[int], float]:
    """optax.join_schedules: after boundary b, the next schedule runs
    on (count - b)."""
    def f(count: int) -> float:
        for i, b in enumerate(boundaries):
            if count < b:
                return schedules[i](count - (boundaries[i - 1] if i else 0))
        return schedules[-1](count - boundaries[-1])
    return f


def _cosine(init: float, decay_steps: int) -> Callable[[int], float]:
    def f(count: int) -> float:
        c = min(count, decay_steps)
        return init * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
    return f


def build_schedule(opt_cfg: Dict[str, Any]) -> Callable[[int], float]:
    lr = float(opt_cfg.get("learning_rate", 1e-5))
    warmup = int(opt_cfg.get("warmup_steps", 0))
    total = int(opt_cfg.get("max_train_steps", 10000))
    kind = str(opt_cfg.get("lr_scheduler", "cosine")).lower()
    if kind in ("cosine", "cosine_with_warmup"):
        w = max(warmup, 1)
        return _join([_linear(0.0, lr, w),
                      _cosine(lr, max(total, warmup + 1) - w)], [w])
    if kind in ("constant", "constant_with_warmup", "none"):
        if warmup:
            return _join([_linear(0.0, lr, warmup), lambda c: lr], [warmup])
        return lambda c: lr
    raise ValueError(f"Unknown lr_scheduler '{kind}'")


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, fp32, on the device."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.stack(norms).pow(2).sum().sqrt()


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> float:
    """Scale ``grads`` in place when their global norm reaches
    ``max_norm``; returns the norm before clipping (one host sync)."""
    norm_t = global_norm(grads)
    norm = float(norm_t)
    if max_norm > 0 and not norm < max_norm:
        for g in grads:
            g.div_(norm_t).mul_(max_norm)
    return norm


def build_optimizer(opt_cfg: Dict[str, Any], params: List[torch.Tensor]
                    ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """(AdamW over ``params`` with lr set per update from the schedule,
    schedule). ``optimization.optimizer: adafactor`` and a bf16
    ``adam_moment_dtype`` are not ported."""
    kind = str(opt_cfg.get("optimizer", "adamw")).lower()
    if kind == "adafactor":
        raise NotImplementedError(
            "optimization.optimizer 'adafactor' is not ported yet "
            "(ROADMAP.md §1, item 2: training options); use 'adamw'")
    if kind != "adamw":
        raise ValueError(f"Unknown optimization.optimizer '{kind}' "
                         "(expected 'adamw' or 'adafactor')")
    if opt_cfg.get("adam_moment_dtype") not in (None, "float32"):
        raise NotImplementedError(
            "optimization.adam_moment_dtype other than float32 is not "
            "ported yet (ROADMAP.md §1, item 2: training options)")
    opt = torch.optim.AdamW(
        params, lr=0.0,
        betas=(float(opt_cfg.get("adam_beta1", 0.9)),
               float(opt_cfg.get("adam_beta2", 0.95))),
        eps=float(opt_cfg.get("adam_eps", 1e-8)),
        weight_decay=float(opt_cfg.get("weight_decay", 0.0)))
    return opt, build_schedule(opt_cfg)
