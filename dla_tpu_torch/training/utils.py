"""Training utilities: seeding (a torch generator, or a threefry root key
for the CLIs that draw ``jax.random``'s bits), throughput timing, the
windowed running loss and the JSONL metrics log
(``dla_tpu.training.utils`` and ``dla_tpu.utils.logging``, single
process)."""
from __future__ import annotations

import collections
import json
import math
import random
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from dla_tpu_torch.ops import prng


def seed_everything(seed: int, device) -> torch.Generator:
    """Seed host RNGs and return the run's root generator on ``device``."""
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    return torch.Generator(device=device).manual_seed(seed)


def root_key(seed: int) -> torch.Tensor:
    """Seed the host RNGs and return the run's root key
    ``prng.PRNGKey(seed)`` ([2] uint32 words on the host): the JAX
    package's ``seed_everything``, whose ``jax.random.key(seed)`` holds
    the same data. Keys folded from it draw ``jax.random``'s bits."""
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    return prng.PRNGKey(seed)


class StepTimer:
    """Wall-clock tokens/s around the train step; the clock starts after
    the first step (which carries one-time set-up, e.g. the kernel
    build)."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.tokens = 0
        self.steps = 0

    def tick(self, n_tokens: int) -> None:
        if self.t0 is None:
            self.t0 = time.perf_counter()
            return
        self.tokens += n_tokens
        self.steps += 1

    def rates(self) -> Dict[str, float]:
        if not self.t0 or not self.steps:
            return {"tokens_per_sec": 0.0, "ms_per_step": 0.0}
        dt = time.perf_counter() - self.t0
        return {"tokens_per_sec": self.tokens / dt,
                "tokens_per_sec_per_chip": self.tokens / dt,  # one device
                "ms_per_step": 1000.0 * dt / self.steps}


class RunningMean:
    """Windowed running average of the logged loss."""

    def __init__(self, window: int = 100):
        self.values: collections.deque = collections.deque(maxlen=window)

    def update(self, value: float) -> None:
        self.values.append(float(value))

    @property
    def average(self) -> float:
        return sum(self.values) / len(self.values) if self.values else 0.0


def _scalar(v: Any) -> Any:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return v
    return f if math.isfinite(f) else None   # strict JSON: no NaN tokens


class MetricsLogger:
    """Appends ``{"step", "time", **metrics}`` lines to
    ``<log_dir>/metrics.jsonl`` (non-finite values become null)."""

    def __init__(self, log_dir: Optional[str]):
        self.jsonl_path: Optional[Path] = None
        if log_dir:
            d = Path(log_dir)
            d.mkdir(parents=True, exist_ok=True)
            self.jsonl_path = d / "metrics.jsonl"

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if self.jsonl_path is None:
            return
        payload = {"step": int(step), "time": time.time(),
                   **{k: _scalar(v) for k, v in metrics.items()}}
        with self.jsonl_path.open("a") as fh:
            fh.write(json.dumps(payload, allow_nan=False) + "\n")
