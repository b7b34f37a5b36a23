"""The training loop every phase shares (``dla_tpu.training.Trainer``),
one device.

A phase supplies ``loss_fn(params, frozen, batch, rng) -> (loss,
metrics)``, the JAX Trainer's contract: ``params`` the trained tree (its
per-layer views, below), ``frozen`` a tree that is read but not trained
(DPO's reference model; None when there is none), ``batch`` a micro-batch
of tensors, flat or nested (``{"chosen": {...}, "rejected": {...},
"pair_mask": ...}``), and ``rng`` a ``torch.Generator`` for dropout.
``eval_fn`` has the same signature and defaults to ``loss_fn``. The
Trainer provides:

- one optimizer step per global batch of ``micro_batch_size *
  gradient_accumulation_steps`` rows: each micro-batch (contiguous rows,
  as the JAX package's ``[accum, micro, ...]`` reshape) runs forward and
  backward, gradients sum in the fp32 ``.grad`` of every leaf and are
  divided by ``accum``; the step's loss is the mean of the per-micro
  token-mean losses (not a token-weighted mean over the step);
- the random stream of micro-step i of step s: a generator seeded from
  (seed, s, i) and made afresh, so a resumed run draws what the
  uninterrupted run drew. Its bits are not ``jax.random``'s (the
  threefry port, ``ops.prng``, serves the samplers), so dropout masks
  equal the JAX package's in distribution only;
- the frozen tree: no autograd leaves, no optimizer state, not in the
  checkpoint; a frozen leaf that shares storage with a trained one is
  copied before the first step (DPO's reference = the starting policy);
- global-norm clipping, then AdamW on the warmup-cosine schedule
  (``training.optim``, optax's semantics); ``train/grad_norm`` is the
  norm before clipping;
- periodic log (``<log_dir>/metrics.jsonl``: train/loss, train/lr,
  train/grad_norm, tokens_per_sec_per_chip, ...; tokens are the sum of
  every ``attention_mask`` in the batch), eval and checkpoint, a
  ``final`` checkpoint at the end, and ``--resume`` from the latest one
  (params, AdamW state, step and data position).

The autograd leaves are per-layer views of the stacked ``[L, ...]``
layer tensors, sharing their storage: each layer's gradient is written
once, where a stacked leaf indexed per layer would make every layer's
backward write a zero gradient the size of the whole stack. The
checkpoint keeps the stacked layout of ``params_from_jax``.

Later work (ROADMAP.md): telemetry, the non-finite-step guard, the
watchdog, elastic resume, SLO watch and asynchronous checkpointing.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dla_tpu_torch.checkpoint.checkpointer import Checkpointer
from dla_tpu_torch.training.optim import build_optimizer, clip_by_global_norm_
from dla_tpu_torch.training.utils import MetricsLogger, RunningMean, StepTimer

EVAL_BATCHES = 8   # micro-batches per eval (the JAX Trainer's default)

LossFn = Callable[[Dict[str, Any], Optional[Dict[str, Any]], Dict[str, Any],
                   Optional[torch.Generator]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _count_tokens(np_batch: Dict[str, Any]) -> int:
    """Real tokens of a (possibly nested) host batch: the sum of every
    ``attention_mask`` in it."""
    total = 0
    for k, v in np_batch.items():
        if isinstance(v, dict):
            total += _count_tokens(v)
        elif k == "attention_mask":
            total += int(v.sum())
    return total


def _train_views(params: Dict[str, Any]) -> Dict[str, Any]:
    """The tree the loss sees: stacked layer leaves replaced by a list of
    per-layer dicts of views; every tensor is an autograd leaf."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k == "layers":
            n = next(iter(v.values())).shape[0]
            out[k] = [{name: t[i] for name, t in v.items()}
                      for i in range(n)]
        elif isinstance(v, dict):
            out[k] = _train_views(v)
        else:
            out[k] = v
    return out


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


class Trainer:
    def __init__(self, *, config: Dict[str, Any], loss_fn: LossFn,
                 params: Dict[str, Any],
                 frozen: Optional[Dict[str, Any]] = None,
                 eval_fn: Optional[LossFn] = None):
        self.config = config
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn or loss_fn
        self.seed = int(config.get("seed", 0))
        opt_cfg = dict(config.get("optimization", {}))
        hw_cfg = dict(config.get("hardware", {}))
        opt_cfg.setdefault("gradient_accumulation_steps",
                           hw_cfg.get("gradient_accumulation_steps", 1))
        if str(opt_cfg.get("grad_accum_dtype", "float32")) != "float32":
            raise NotImplementedError(
                "optimization.grad_accum_dtype other than float32 is not "
                "ported yet (ROADMAP.md §3, training items)")
        self.accum = int(opt_cfg["gradient_accumulation_steps"])
        self.micro = int(opt_cfg.get("micro_batch_size", 1))
        self.global_batch = self.micro * self.accum   # one device
        total = opt_cfg.get("total_batch_size")
        if total is not None and int(total) != self.global_batch:
            print(f"[dla_tpu_torch] effective global batch "
                  f"{self.global_batch} (micro {self.micro} x accum "
                  f"{self.accum}) != configured total_batch_size {total}",
                  flush=True)
        self.max_steps = int(opt_cfg.get("max_train_steps", 1000))
        self.max_grad_norm = float(opt_cfg.get("max_grad_norm", 0.0) or 0.0)

        # stacked storage (checkpoint layout) and its per-layer views
        self.params = params
        self.train_params = _train_views(params)
        self.leaves = _leaves(self.train_params)
        for t in self.leaves:
            t.requires_grad_(True)
        self.optimizer, self.schedule = build_optimizer(opt_cfg, self.leaves)
        self.step = 0
        self.frozen = None
        if frozen is not None:
            owned = {t.untyped_storage().data_ptr() for t in _leaves(params)}
            self.frozen = _tree_map(
                lambda t: (t.detach().clone()
                           if t.untyped_storage().data_ptr() in owned
                           else t.detach()), frozen)

        log_cfg = config.get("logging", {})
        self.logger = MetricsLogger(log_cfg.get("log_dir"))
        self.checkpointer = Checkpointer(
            log_cfg.get("output_dir", "checkpoints/run"),
            keep_last_n=int(log_cfg.get("keep_last_n", 3)))
        self.log_every = int(log_cfg.get("log_every_steps", 10))
        self.eval_every = int(log_cfg.get("eval_every_steps", 0))
        self.save_every = int(log_cfg.get("save_every_steps", 0))
        self.last_save_s: Optional[float] = None   # wall time of a save

    @property
    def device(self) -> torch.device:
        return self.leaves[0].device

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Host arrays copied to the device; tensors moved only if they
        lie elsewhere (a batch already on the card stays where it is)."""
        def put(v):
            if torch.is_tensor(v):
                return v.to(self.device)
            return torch.from_numpy(np.asarray(v)).to(self.device)
        return _tree_map(put, batch)

    def generator(self, step: int, index: int,
                  for_eval: bool = False) -> torch.Generator:
        """The random stream of micro-batch ``index`` of ``step`` (of eval
        batch ``index`` after ``step`` with ``for_eval``), on the
        device."""
        entropy = (self.seed % 2 ** 64, step, int(for_eval), index)
        seed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    # ------------------------------------------------------------ the step

    def step_on_batch(self, np_batch: Dict[str, Any]
                      ) -> Tuple[float, Dict[str, float]]:
        """One optimizer step on a batch of ``global_batch`` rows (flat or
        nested dicts of host arrays, or of tensors: the RLHF loop's
        rollout tensors stay on the card, as the JAX Trainer's
        ``step_on_device_batch`` takes them). Returns (loss, metrics incl.
        grad_norm)."""
        rows = _leaves(np_batch)[0].shape[0]
        if rows % self.accum:
            raise ValueError(f"batch of {rows} rows not divisible by accum "
                             f"{self.accum}")
        per = rows // self.accum
        for t in self.leaves:
            t.grad = None
        loss_acc = torch.zeros((), device=self.device)
        metric_acc: Dict[str, torch.Tensor] = {}
        for i in range(self.accum):
            mb = self._to_device(_tree_map(
                lambda v: v[i * per:(i + 1) * per], np_batch))
            loss, metrics = self.loss_fn(self.train_params, self.frozen, mb,
                                         self.generator(self.step, i))
            loss.backward()
            loss_acc += loss.detach() / self.accum
            for k, m in metrics.items():
                m = torch.as_tensor(m, device=self.device).detach().float()
                metric_acc[k] = metric_acc.get(k, 0.0) + m / self.accum
        grads = [t.grad for t in self.leaves]
        torch._foreach_div_(grads, float(self.accum))
        gnorm = clip_by_global_norm_(grads, self.max_grad_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = float(self.schedule(self.step))
        self.optimizer.step()
        self.step += 1
        out = {k: float(v) for k, v in metric_acc.items()}
        out["grad_norm"] = gnorm
        return float(loss_acc), out

    # ------------------------------------------------------------ the loop

    def fit(self, train_iter, *,
            eval_iter_fn: Optional[Callable[[], Iterator]] = None,
            data_state: Optional[Callable[[], Dict]] = None,
            resume: bool = False,
            extra_aux: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        running = RunningMean(100)
        timer = StepTimer()
        if resume:
            aux = self.try_resume()
            if aux and aux.get("data_state") and hasattr(
                    train_iter, "load_state_dict"):
                train_iter.load_state_dict(aux["data_state"])
        gen = iter(train_iter)
        while self.step < self.max_steps:
            np_batch = next(gen)
            n_tokens = _count_tokens(np_batch)
            loss, metrics = self.step_on_batch(np_batch)
            timer.tick(n_tokens)
            running.update(loss)
            if self.step % self.log_every == 0:
                payload = {"train/loss": running.average,
                           "train/loss_instant": loss,
                           "train/lr": float(self.schedule(self.step)),
                           **{f"train/{k}": v for k, v in metrics.items()},
                           **timer.rates()}
                self.logger.log(payload, self.step)
                print(f"step {self.step}: loss {running.average:.4f} "
                      f"(grad_norm {metrics['grad_norm']:.4f}, "
                      f"{payload.get('tokens_per_sec_per_chip', 0):.0f} "
                      f"tok/s/chip)", flush=True)
            if self.eval_every and eval_iter_fn \
                    and self.step % self.eval_every == 0:
                self.run_eval(eval_iter_fn)
            if self.save_every and self.step % self.save_every == 0:
                self.save(data_state() if data_state else None, extra_aux)
        self.save(data_state() if data_state else None, extra_aux,
                  tag="final")
        return self.params

    @torch.no_grad()
    def run_eval(self, eval_iter_fn) -> Dict[str, float]:
        """Mean loss and metrics over the first ``EVAL_BATCHES`` batches
        of ``eval_iter_fn()`` (an iterator that wraps epochs, as the JAX
        package's, so a small eval set is read more than once)."""
        losses: List[float] = []
        sums: Dict[str, List[float]] = {}
        for i, np_batch in enumerate(eval_iter_fn()):
            if i >= EVAL_BATCHES:
                break
            loss, metrics = self.eval_fn(
                self.train_params, self.frozen, self._to_device(np_batch),
                self.generator(self.step, i, for_eval=True))
            losses.append(float(loss))
            for k, v in metrics.items():
                sums.setdefault(k, []).append(float(v))
        out = {"eval/loss": float(np.mean(losses)) if losses else 0.0}
        out.update({f"eval/{k}": float(np.mean(v)) for k, v in sums.items()})
        self.logger.log(out, self.step)
        print(f"eval @ {self.step}: " +
              " ".join(f"{k}={v:.4f}" for k, v in out.items()), flush=True)
        return out

    # -------------------------------------------------------- checkpointing

    def _opt_state_tree(self) -> Dict[str, Any]:
        """AdamW state by leaf position: {i: {step, exp_avg,
        exp_avg_sq}} (empty before the first update)."""
        return {str(i): dict(self.optimizer.state[t])
                for i, t in enumerate(self.leaves)
                if t in self.optimizer.state}

    def save(self, data_state: Optional[Dict] = None,
             extra_aux: Optional[Dict[str, Any]] = None,
             tag: Optional[str] = None) -> None:
        aux = {"step": self.step, "data_state": data_state or {},
               "global_batch": int(self.global_batch), **(extra_aux or {})}
        t0 = time.perf_counter()
        self.checkpointer.save(
            self.step, {"params": self.params,
                        "opt_state": self._opt_state_tree()}, aux, tag=tag)
        self.last_save_s = time.perf_counter() - t0
        print(f"[dla_tpu_torch] saved checkpoint @ step {self.step} in "
              f"{self.last_save_s:.1f} s", flush=True)

    def try_resume(self) -> Optional[Dict[str, Any]]:
        """Restore params, AdamW state and step from the latest
        checkpoint in ``logging.output_dir``; None when there is none."""
        tag = self.checkpointer.latest_tag()
        if tag is None:
            return None
        aux = self.checkpointer.peek_aux(tag)
        self.step = int(aux.get("step", 0))
        state: Dict[str, Any] = {}
        if self.step:
            # the saved moments need tensors of the right shapes to land in
            state = {str(i): {"step": torch.zeros((), dtype=torch.float32),
                              "exp_avg": torch.zeros_like(t),
                              "exp_avg_sq": torch.zeros_like(t)}
                     for i, t in enumerate(self.leaves)}
        self.checkpointer.restore({"params": self.params,
                                   "opt_state": state}, tag)
        sd = self.optimizer.state_dict()
        sd["state"] = {int(i): s for i, s in state.items()}
        self.optimizer.load_state_dict(sd)
        print(f"[dla_tpu_torch] resumed from {tag} @ step {self.step}",
              flush=True)
        return aux
