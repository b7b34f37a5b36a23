#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dla_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure fails the run; the phases all run so one call shows
every fault, and the result lines are printed only when all passed):

1. build   — compile the CUDA kernels from ``dla_tpu_torch/csrc`` (nvcc,
             sm_90a, one process per source) and print the build time,
             ptxas resource usage, a summary line per tensor-core kernel
             (flash forward, dQ, dK/dV, the int8 matmul's prefill and
             decode kernels, decode attention: registers, spills,
             dynamic shared memory) and, where ``cuobjdump`` exists, the
             HGMMA (wgmma) count of each kernel's SASS; fails on a ptxas
             "Potential Performance Loss" (C75xx: wgmma serialized)
             warning or a wgmma kernel with no HGMMA;
2. parity  — hold each kernel against its plain PyTorch version on the
             card at the paths' shapes: flash forward at T=128 (rollout),
             at the SFT shape with packed segment ids, at ragged T with
             segments and a window (head dims 64 and 96), decode attention
             over an int8 cache of S=384 with the fill as a device scalar
             mid-slice and NaN past it (and as a host int), at g = 4 and
             8, head dims 64, 96, 128 and 256, and at few (batch, kv
             head) pairs, where the kernel splits S over a cluster; the
             int8 matmul at M = 1 and 64 (decode kernel), 65, 127 and
             8192 (TMA kernel) for every projection and lm_head and at ragged
             shapes (M 8190, K 4104, N 1040); the flash backward (dQ,
             dK/dV) at the SFT shape with packed segments, with a window,
             at ragged T=77, at head_dim 128 and at head_dim 96 (packed
             segments and a window), and the
             autograd Function's gradients against autograd through the
             plain forward; #1, #2 and #3 again at the preference shape
             (B2 T1024 H32 KH8 D64, right-padded rows, real rows
             compared) and at the distill shape (B4 T2048 H32 KH32 D80:
             phi-2's head dim through the 128-wide kernels, MHA),
             right-padded, with packed segment ids and a window, at a
             ragged T, and the autograd Function at D80; the fused
             categorical draw against ``ops.prng`` at [64, 128256]
             (filtered logits) and a ragged [3, 1000], with one key and
             per-row (seed, position) keys: equal tokens, gumbel noise
             within 2e-6;
3. timing  — CUDA-event medians of each kernel, its plain version and a
             one-call PyTorch yardstick, beside the least time the card
             could take (bytes / 3.35 TB/s vs FLOPs / 989 TFLOP/s); the
             flash forward, dQ and dK/dV also at the SFT shape, and with
             packed segment ids (bound from the live pairs of those ids;
             yardstick: SDPA given the block-diagonal causal mask, its
             backend named), and at the preference and distill shapes
             (causal; SDPA with ``is_causal``); the draw at the rollout
             shape beside its plain version and the exponential race it
             replaced (bound: bytes vs its operations at the CUDA-core
             rate; no PyTorch call computes threefry);
4. slice   — llama3-8b at full width and depth (random weights from a
             seed): flash attention, int8 KV, int8 weight tree, then
             build_generate_fn with the RLHF config's sampling (B=64
             prompts of width 128, 256 new tokens, temperature 0.7,
             top_p 0.9, no EOS; a threefry key), whose decode loop runs
             as one CUDA graph with the fused draw in it. The first generate runs under torch.profiler: each
             wrapper's count of the launches it issued (the prefill's,
             the first step's, the capture's) and the card's launches of
             each kernel counted in the trace (graph replays included)
             must equal the path's counts; outputs must be well formed
             and equal (tokens, logps, lengths) an eager loop of
             ``build_decode_step`` from the same key, and the
             logits of the prefill and 4 decode steps must match the
             same model running the plain versions (4 layers). Decode
             ms/step graphed and eager, and the device time of an eager
             step and of the traced generate's graph replays;
5. train   — ``dla_tpu_torch.training.train_sft.main`` on
             config/sft_config.yaml with llama3.2-1b at full width and
             depth (random init, byte tokenizer, flash + full remat, fp32
             params, bf16 activations, packing into 2048-token rows,
             micro-batch 4), cut to grad accumulation 4 and 4 steps, eval
             every 2 steps, final save into build/ (timed; the preference
             phase starts from it and deletes it).
             Launch counts must equal the path's, losses and grad norms
             be finite and the first loss near ln V. Then, at 2 layers:
             every leaf's gradient on the kernel path against the plain
             path (judged against the bf16 noise floor), an interrupted
             and resumed run's step 3-4 losses against the uninterrupted
             run's, and a loss that falls on one repeated batch;
6. preference — from the train phase's SFT checkpoint (its ``latest``, as
             the configs chain the phases), at full width and depth:
             ``train_reward.main`` on config/reward_config.yaml (last-token
             pooling, dropout 0.1, micro-batch 2, 1024-token right-padded
             rows as configured) and ``train_dpo.main`` on
             config/dpo_config.yaml (policy and reference the SFT
             checkpoint, beta 0.1, micro-batch 1), byte tokenizer, local
             records from the seed, each cut to grad accumulation 4 and 4
             steps with an eval every 2. Launch counts must equal the
             path's, losses, grad norms and metrics be finite, the
             accuracy and preference rate lie in [0, 1], DPO's first loss
             be ln 2 within 1e-4 with margin 0 (policy = reference), and
             each final checkpoint load back equal to the trained
             parameters; then a steady-state step is timed and profiled.
             At 2 layers: each loss's per-leaf gradients on the kernel
             path against the plain path (bf16 floor), packed rewards and
             log-probs against the same pairs unpacked (same floor), an
             interrupted and resumed reward run (dropout on) against the
             uninterrupted one, and a loss that falls on one repeated
             batch. The SFT, reward and DPO ``final/`` checkpoints stay,
             parameters only, for the rlhf and distill phases;
7. rlhf    — ``train_rlhf.main`` on config/rlhf_config.yaml at full width
             and depth as the configs chain it (policy and reference the
             SFT checkpoint, the reward model the preference phase's),
             byte tokenizer, flash on, 64 local prompts from the seed
             (64 rows of 768 + 256 tokens, temperature 0.7, top_p 0.9),
             cut to 2 rollouts, in three runs: reinforce; ppo (mini-batch
             8, 1 epoch); gae with int8 rollout weights and an int8 KV
             cache. Launch counts must equal the path's (#1, #2, #3 and
             the draw; #4 and #5 in gae), losses, KL, rewards and grad
             norms be finite, the first rollout's KL 0 exactly where
             policy = reference (reinforce, ppo), ppo's first minibatch
             clip fraction 0, clip fractions in [0, 1], and the final
             (gae: also the plain-policy) checkpoint load back equal to
             the trained parameters; then the trained policy's rollout is
             timed (prefill, decode ms/step), traced (busy share) and, for
             reinforce, held equal to an eager loop from the same key;
8. distill — the configs' chain on: ``generate_teacher_data.main`` on the
             preference phase's DPO checkpoint, scored by its reward
             checkpoint (64 prompts from the seed, 256 new tokens), then
             ``train_distill.main`` on config/distill_config.yaml with
             the phi-2 preset student (random weights, full width and
             depth, flash on, micro-batch 4, 2048-token right-padded
             rows as configured), cut to grad accumulation 4 and 4
             steps: CE mode as configured, then KL mode (use_kl +
             on_policy, temperature 2, the student from the next seed)
             against the CE run's final checkpoint as the one teacher. Launch counts must equal the
             path's, losses, grad norms, reward_mean and kl be finite,
             the first CE loss near ln V, the first KL >= 0, each final
             checkpoint load back equal to the trained parameters; a
             steady-state step of each mode is timed and profiled. At 2
             layers: each mode's per-leaf gradients on the kernel path
             against the plain path (bf16 floor), the einsum route's
             loss against the flash route's, an interrupted and resumed
             CE run against the uninterrupted one, and a loss that falls
             on a repeated batch. Each checkpoint is deleted as soon as
             the next step has read it; the peak disk use is printed.

Last lines: the card's name and power limit (nvidia-smi), a JSON line of
per-kernel numbers, and ``{"ok": true, "device": {...}}``. Exits non-zero
without a result when no CUDA device is visible or the package is
missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak
CUDA_CORE_OPS_PER_S = 67e12   # float32 outside the tensor cores
# the fused draw's operations an element (csrc/sample.cu): threefry's 2 +
# 20 x (add, rotate, xor) + 5 x 2 key injections, the counter, the
# bits-to-float, two logs (one each), the add and the argmax compare
DRAW_OPS = 88
SEED = 0

# the SFT path's shapes (llama3.2-1b, config/sft_config.yaml, micro 4)
SFT_CONFIG = ROOT / "config" / "sft_config.yaml"
SFT_MODEL = "llama3.2-1b"
SFT_B, SFT_T, SFT_H, SFT_KH, SFT_HD, SFT_LAYERS = 4, 2048, 32, 8, 64, 16
SFT_ACCUM, SFT_STEPS, SFT_EVAL_EVERY = 4, 4, 2
# Trainer.fit's eval takes 8 micro-batches from an iterator that never
# ends (it wraps epochs, as the JAX package's does): 32 records = 8
# distinct batches of 4
SFT_EVAL_BATCHES, SFT_EVAL_RECORDS = 8, 32

# the preference path (llama3.2-1b from the train phase's SFT checkpoint;
# config/reward_config.yaml and config/dpo_config.yaml): right-padded rows
# of 1024 tokens, micro-batch 2 (reward) and 1 (DPO) as configured
REWARD_CONFIG = ROOT / "config" / "reward_config.yaml"
DPO_CONFIG = ROOT / "config" / "dpo_config.yaml"
SFT_WORK = ROOT / "build" / "chip_smoke_sft"
PREF_T, RM_B, DPO_B = 1024, 2, 1
PREF_ACCUM, PREF_STEPS, PREF_EVAL_EVERY = 4, 4, 2   # configs: 32 / 256; 3000 / 2000
PREF_TRAIN_RECORDS, PREF_EVAL_RECORDS = 64, 16

PREF_WORK = ROOT / "build" / "chip_smoke_pref"

# the RLHF path (config/rlhf_config.yaml): policy and reference the train
# phase's SFT checkpoint, the preference phase's reward model; 64 rows of
# 768-token prompts + 256 new tokens as configured, cut to 2 rollouts
RLHF_CONFIG = ROOT / "config" / "rlhf_config.yaml"
RLHF_WORK = ROOT / "build" / "chip_smoke_rlhf"
RLHF_PROMPTS, RLHF_ROLLOUTS, RLHF_MINI = 64, 2, 8
RLHF_EAGER_STEPS = 64    # decode steps held against the eager loop

# the distill path (config/distill_config.yaml): the phi-2 preset student
# (hidden 2560 = 32 heads x 80, MHA, vocab 51200), micro-batch 4 of
# 2048-token right-padded rows as configured; teacher rollouts from the
# preference phase's DPO checkpoint
DISTILL_CONFIG = ROOT / "config" / "distill_config.yaml"
DISTILL_WORK = ROOT / "build" / "chip_smoke_distill"
PHI_MODEL = "phi-2"
DIS_B, DIS_T, DIS_H, DIS_HD, DIS_LAYERS, DIS_VOCAB = 4, 2048, 32, 80, 32, \
    51200
DIS_ACCUM, DIS_STEPS = 4, 4          # config: 32 / 4000
DIS_PROMPTS, DIS_NEW, DIS_GEN_BATCH = 64, 256, 8   # the teacher CLI's batch
DIS_TEMPERATURE = 2.0
DIS_LENS = [2048, 1210, 640, 333]    # parity's right-padded row lengths

# the rollout path's shapes (llama3-8b, config/rlhf_config.yaml)
B, PROMPT, NEW = 64, 128, 256
TEMPERATURE, TOP_P = 0.7, 0.9
HID, FFN, HEADS, KV_HEADS, HD, VOCAB, LAYERS = (
    4096, 14336, 32, 8, 128, 128256, 32)
PROJ = {  # name: (K, N) of x [M, K] @ w [K, N]; count per layer
    "wq": (HID, HEADS * HD), "wk": (HID, KV_HEADS * HD),
    "wv": (HID, KV_HEADS * HD), "wo": (HEADS * HD, HID),
    "w_gate": (HID, FFN), "w_up": (HID, FFN), "w_down": (FFN, HID)}


def bound_ms(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


class Run:
    """Collects phase results; a phase that raises is recorded, not fatal
    to the later phases, and fails the run at the end."""

    def __init__(self):
        self.failures = []
        self.kernels = {}
        self.report = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        print(f"== phase {name}", flush=True)
        try:
            yield
        except Exception:  # noqa: BLE001 — recorded; the run exits 1 below
            self.failures.append(name)
            print(f"!! phase {name} FAILED", flush=True)
            traceback.print_exc(file=sys.stdout)
        print(f"== phase {name} done in {time.perf_counter() - t0:.1f} s",
              flush=True)

    def check(self, ok: bool, what: str):
        print(f"   {'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            raise AssertionError(what)


class _DiskPeak:
    """The largest total size, sampled when asked, of the checkpoint
    directories the phases keep under build/. The chip's machine counts
    the high-water mark of what its disk holds, so a checkpoint is
    deleted as soon as the next step has read it (``_delete_once_read``)
    and never lives beside the next save."""

    DIRS = (SFT_WORK, PREF_WORK, RLHF_WORK, DISTILL_WORK)

    def __init__(self):
        self.peak_gb = 0.0

    def sample(self, where: str) -> float:
        gb = sum(f.stat().st_size for d in self.DIRS if d.is_dir()
                 for f in d.rglob("*") if f.is_file()) / 1e9
        self.peak_gb = max(self.peak_gb, gb)
        print(f"   disk: {gb:.1f} GB under build/ ({where})", flush=True)
        return gb


DISK = _DiskPeak()


def _params_only(ckpt: Path) -> None:
    """Delete a checkpoint's optimizer state (its ``opt_state.*`` leaves
    and their files) once nothing will resume from it: the later phases
    read its parameters only, and the chip's machine counts the disk's
    high-water mark."""
    index_path = ckpt / "index.json"
    index = json.loads(index_path.read_text())
    for name in [k for k in index["leaves"] if k.startswith("opt_state.")]:
        meta = index["leaves"].pop(name)
        for f in ([meta["file"]] if "file" in meta
                  else [sh["file"] for sh in meta["shards"]]):
            (ckpt / f).unlink(missing_ok=True)
    index_path.write_text(json.dumps(index))


@contextlib.contextmanager
def _delete_once_read(module, name: str, path: Path, reads: int):
    """Within the block, the loader ``module.<name>`` that a CLI calls
    deletes the checkpoint directory ``path`` once it has returned
    ``reads`` times: the CLI has read it and will not again."""
    import shutil
    real = getattr(module, name)
    calls = [0]

    def loader(*args, **kwargs):
        out = real(*args, **kwargs)
        calls[0] += 1
        if calls[0] == reads:
            shutil.rmtree(path, ignore_errors=True)
            DISK.sample(f"{path.relative_to(ROOT)} read and deleted")
        return out
    setattr(module, name, loader)
    try:
        yield
    finally:
        setattr(module, name, real)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing measured",
              file=sys.stderr)
        return 2
    if not (ROOT / "dla_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: dla_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dla_tpu_torch.ops import _native

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    run = Run()

    with run.phase("build"):
        t0 = time.perf_counter()
        path, log = _native.build()
        _native.library()
        print(f"   built {path.relative_to(ROOT)} in "
              f"{time.perf_counter() - t0:.1f} s")
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "warning" in line
                    or "Performance" in line or line.startswith("==")):
                print("   " + line.strip())
        run.report["kernel_build"] = kernel_build_summary(
            log, path, _native)
        slow = [line.strip() for line in log.splitlines()
                if "Potential Performance Loss" in line
                or re.search(r"\bC75\d\d\b", line)]
        run.check(not slow, f"no ptxas wgmma serialization warning {slow}")
        counted = [r["hgmma"] for r in run.report["kernel_build"].values()
                   if r["wgmma"]]
        run.check(all(c == "no cuobjdump" or (c or 0) > 0 for c in counted),
                  f"every wgmma kernel has HGMMA in its SASS {counted}")

    with run.phase("parity"):
        parity(run, torch, dev)

    with run.phase("timing"):
        timing(run, torch, dev)

    with run.phase("slice"):
        slice_run(run, torch, dev, _native)

    with run.phase("train"):
        train_run(run, torch, dev, _native)

    with run.phase("preference"):
        preference_run(run, torch, dev, _native)

    with run.phase("rlhf"):
        rlhf_run(run, torch, dev, _native)

    with run.phase("distill"):
        distill_run(run, torch, dev, _native)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(
        {"card": smi, "failures": run.failures, "kernels": run.kernels,
         **run.report}, indent=1))
    if run.failures:
        print(f"chip_smoke: FAILED phases: {run.failures}", flush=True)
        return 1
    missing = [k for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv", "decode_attention",
                           "int8_matmul", "categorical_draw")
               if k not in run.kernels]
    if missing:
        print(f"chip_smoke: no numbers for {missing}", flush=True)
        return 1
    print(smi)
    print(json.dumps({"kernels": list(run.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# the tensor-core kernels: mangled-name pattern (name[, template
# arguments]) -> (wgmma?, its dynamic shared memory per block, asked of
# the library)
SUMMARY_KERNELS = (
    (r"(flash_bwd_dq_kernel)ILi(\d+)E",
     True, lambda lib, d: lib.dla_flash_bwd_smem_bytes(0, d)),
    (r"(flash_bwd_dkv_kernel)ILi(\d+)E",
     True, lambda lib, d: lib.dla_flash_bwd_smem_bytes(1, d)),
    (r"(flash_fwd_kernel)ILi(\d+)E",
     True, lambda lib, d: lib.dla_flash_fwd_smem_bytes(d)),
    (r"(int8_mm_tma_kernel)E",
     True, lambda lib: lib.dla_int8_matmul_smem_bytes()),
    (r"(int8_mm_decode_kernel)ILi(\d+)E",          # <consumers>
     True, lambda lib, cw: lib.dla_int8_matmul_decode_smem_bytes(64 * cw)),
    (r"(decode_attn_kernel)ILi(\d+)ELb(\d)E",        # <D, int8>: mma.sync
     False, lambda lib, d, q: lib.dla_decode_attention_smem_bytes(d, q)),
)


def kernel_build_summary(log: str, lib_path: Path, native):
    """Per tensor-core kernel instantiation: ptxas registers and spill
    bytes (from the build log), dynamic shared memory per block (asked of
    the library) and, where ``cuobjdump`` exists, the HGMMA (wgmma)
    instructions in its SASS. Printed one line each."""
    import shutil
    stats, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            stats.setdefault(cur, {})["spill"] = (int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            stats.setdefault(cur, {})["registers"] = int(m[1])
    hgmma = {}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).is_file():
        sass = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              timeout=120).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
            elif fn and "HGMMA" in line:
                hgmma[fn] = hgmma.get(fn, 0) + 1
    lib = native.library()
    out = {}
    for mangled, st in sorted(stats.items()):
        for pattern, wgmma, smem_of in SUMMARY_KERNELS:
            m = re.search(pattern, mangled)
            if m:
                break
        else:
            continue
        args = [int(a) for a in m.groups()[1:]]
        name = m[1] + "".join(f"<{a}>" for a in args)
        smem = smem_of(lib, *args)
        row = dict(registers=st.get("registers"), spill_bytes=st.get("spill"),
                   dynamic_smem_bytes=smem, wgmma=wgmma,
                   hgmma=hgmma.get(mangled, 0) if hgmma else "no cuobjdump")
        out[name] = row
        print(f"   ptxas {name}: {row['registers']} registers, spill "
              f"stores/loads {row['spill_bytes']} bytes, {smem} bytes of "
              f"dynamic shared memory, HGMMA in SASS: {row['hgmma']}",
              flush=True)
    return out


# ------------------------------------------------------------------ inputs

def _gen(torch, dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _flash_inputs(torch, dev, g, b=B, t=PROMPT, h=HEADS, kh=KV_HEADS, d=HD):
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    return mk(b, t, h, d), mk(b, t, kh, d), mk(b, t, kh, d)


def _decode_inputs(torch, dev, g, fill, b=B, s=PROMPT + NEW, kh=KV_HEADS,
                   g_rows=HEADS // KV_HEADS, d=HD, int8=True, fill_dev=True):
    """Decode inputs at cache length s, valid columns < fill (70% of
    them), NaN planted in the scales (int8) or values (bf16) past it; the
    fill as a 0-dim int32 tensor on the card (the decode step's form) or,
    with ``fill_dev=False``, a host int."""
    h = kh * g_rows
    mk = lambda *sh: torch.randn(sh, generator=g, device=dev)
    q, kn, vn = (mk(b, 1, h, d).to(torch.bfloat16),
                 mk(b, 1, kh, d).to(torch.bfloat16),
                 mk(b, 1, kh, d).to(torch.bfloat16))
    valid = (torch.rand((b, s), generator=g, device=dev) < 0.7)
    valid[:, fill:] = False
    bias = torch.where(valid, 0.0, -1e30).float()
    if int8:
        kc = torch.randint(-127, 128, (b, s, kh, d), generator=g,
                           device=dev, dtype=torch.int8)
        vc = torch.randint(-127, 128, (b, s, kh, d), generator=g,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((b, kh, s), generator=g, device=dev) * 0.02
        vs = torch.rand((b, kh, s), generator=g, device=dev) * 0.02
        ks[..., fill:] = float("nan")
        vs[..., fill:] = float("nan")
    else:
        kc, vc = (mk(b, s, kh, d).to(torch.bfloat16),
                  mk(b, s, kh, d).to(torch.bfloat16))
        kc[:, fill:] = float("nan")
        vc[:, fill:] = float("nan")
        ks = vs = None
    if fill_dev:
        fill = torch.tensor(fill, dtype=torch.int32, device=dev)
    return dict(q=q, k_cache=kc, v_cache=vc, k_new=kn, v_new=vn, bias=bias,
                k_scale=ks, v_scale=vs, kv_fill=fill)


def _int8_inputs(torch, dev, g, m, k, n):
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    sc = torch.rand((n,), generator=g, device=dev) * (0.04 / 127) + 1e-5
    return x, w, sc


def _call_decode(fn, inp):
    return fn(inp["q"], inp["k_cache"], inp["v_cache"], inp["k_new"],
              inp["v_new"], bias=inp["bias"], k_scale=inp["k_scale"],
              v_scale=inp["v_scale"], kv_fill=inp["kv_fill"])


# ------------------------------------------------------------------ parity

def parity(run, torch, dev):
    from dla_tpu_torch.ops import _native
    from dla_tpu_torch.ops import decode_kernel as dk
    from dla_tpu_torch.ops import flash_attention as fa
    from dla_tpu_torch.ops import quant_matmul as qm
    g = _gen(torch, dev, SEED)
    errs = {}

    # flash forward: bf16 outputs of |x| < ~4 -> 2 bf16 ulps = 3e-2; lse
    # (fp32) 1e-3
    cases = [("path B64 T128 H32 KH8 D128", {}, {})]
    cases.append(("ragged T100 D64 window+segments",
                  dict(b=2, t=100, h=4, kh=2, d=64), "segwin"))
    cases.append(("ragged T77 D128 GQA8", dict(b=3, t=77, h=8, kh=1),
                  {}))
    cases.append(("phi3-mini head_dim 96, T130", dict(b=2, t=130, h=4,
                                                       kh=4, d=96), {}))
    cases.append(("SFT shape B4 T2048 H32 KH8 D64, packed segments",
                  dict(b=SFT_B, t=SFT_T, h=SFT_H, kh=SFT_KH, d=SFT_HD),
                  "packed"))
    cases.append(("head_dim 96, ragged T300 GQA, packed segments, window "
                  "50", dict(b=2, t=300, h=8, kh=2, d=96), "packed+win"))
    for label, shape, extra in cases:
        q, k, v = _flash_inputs(torch, dev, g, **shape)
        kw = {}
        if extra == "segwin":
            seg = torch.ones((q.shape[0], q.shape[1]), dtype=torch.int32,
                             device=dev)
            seg[:, 40:] = 2
            seg[:, 90:] = 0
            kw = dict(segment_ids=seg, window=24)
        if extra in ("packed", "packed+win"):
            kw = dict(segment_ids=_segments(torch, dev, q.shape[0],
                                            q.shape[1], SEED))
        if extra == "packed+win":
            kw["window"] = 50
        out, lse = fa.flash_attention_forward(q, k, v, **kw)
        ref, ref_lse = fa.flash_forward_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        e = (out.float() - ref.float()).abs().max().item()
        live = ref_lse > -1e29
        e_lse = (lse - ref_lse)[live].abs().max().item()
        run.check(e <= 3e-2 and e_lse <= 1e-3 and torch.isfinite(
            out.float()).all().item(),
            f"flash {label}: max|out err| {e:.3g} <= 3e-2, "
            f"max|lse err| {e_lse:.3g} <= 1e-3")
        errs.setdefault("flash_attention_fwd", e)

    # decode attention: bf16 outputs of |x| < ~1 -> 2e-2. Fill mid-slice
    # (slices are 16 columns) with NaN past it; the split cases have few
    # (batch, kv head) pairs, so the kernel splits S over a cluster
    sms = _native.sm_count(dev)
    for label, kw in [
            ("path B64 S384 int8 g4 D128, device fill 300, NaN past fill",
             dict(fill=300)),
            ("path shape, host-int fill 300", dict(fill=300, fill_dev=False)),
            ("path shape, device fill 383 (the last step)", dict(fill=383)),
            ("int8 g8 D128 fill 201", dict(fill=201, b=32, kh=4, g_rows=8)),
            ("int8 g8 D64 fill 777 of S1024, few pairs",
             dict(fill=777, b=2, s=1024, kh=2, g_rows=8, d=64)),
            ("int8 g4 D64 fill 129", dict(fill=129, b=64, kh=8, d=64)),
            ("int8 g4 D128 fill 250, few pairs",
             dict(fill=250, b=4, kh=2)),
            ("bf16 cache fill 150, NaN past fill, D256 g8, few pairs",
             dict(fill=150, b=4, kh=2, g_rows=8, d=256, int8=False)),
            ("int8 fill 1 (self column + one)", dict(fill=1, b=8)),
            ("int8 fill 0 (self column only)", dict(fill=0, b=8)),
            ("int8 head_dim 96 (phi3-mini) g1 fill 100", dict(
                fill=100, b=4, kh=4, g_rows=1, d=96))]:
        inp = _decode_inputs(torch, dev, g, **kw)
        out = _call_decode(dk.flash_decode_attention, inp)
        ref = _call_decode(dk.flash_decode_attention_plain, inp)
        torch.cuda.synchronize()
        e = (out.float() - ref.float()).abs().max().item()
        b_, s_, kh_ = inp["k_cache"].shape[:3]
        split = dk.decode_split(b_ * kh_, s_, sms)
        run.check(e <= 2e-2 and torch.isfinite(out.float()).all().item(),
                  f"decode {label} (split {split}): max|err| {e:.3g} <= 2e-2")
        errs.setdefault("decode_attention", e)
    inp = _decode_inputs(torch, dev, g, fill=200, b=8)
    cap = dict(logit_softcap=30.0)
    out = dk.flash_decode_attention(
        inp["q"], inp["k_cache"], inp["v_cache"], inp["k_new"], inp["v_new"],
        bias=inp["bias"], k_scale=inp["k_scale"], v_scale=inp["v_scale"],
        kv_fill=inp["kv_fill"], **cap)
    ref = dk.flash_decode_attention_plain(
        inp["q"], inp["k_cache"], inp["v_cache"], inp["k_new"], inp["v_new"],
        bias=inp["bias"], k_scale=inp["k_scale"], v_scale=inp["v_scale"],
        kv_fill=inp["kv_fill"], **cap)
    e = (out.float() - ref.float()).abs().max().item()
    run.check(e <= 2e-2, f"decode softcap 30: max|err| {e:.3g} <= 2e-2")

    # int8 matmul: one bf16 rounding of fp32 sums in another order -> at
    # most ~1 bf16 ulp: max|err| <= 1e-2 * max|ref|
    worst = 0.0   # max absolute error over the path's shapes
    shapes = [(64, k, n) for (k, n) in PROJ.values()] + [(64, HID, VOCAB)]
    shapes += [(B * PROMPT, k, n) for (k, n) in PROJ.values()]
    path_shapes = set(shapes)
    # M = 1: the decode kernel's edge; 65 and 127: past the decode
    # batch, the TMA kernel's 128-row tile with the rows past M as zeros
    shapes += [(m, k, n) for m in (1, 65, 127)
               for (k, n) in list(PROJ.values()) + [(HID, VOCAB)]]
    shapes += [(130, HID, 4096), (5, 256, 48),   # ragged M and N
               (8190, 4104, 1040), (129, 72, 272),   # ragged M, K and N
               (64, 4104, 1040), (100, 72, 272), (33, 4104, 14336)]
    for m, k, n in dict.fromkeys(shapes):
        x, w, sc = _int8_inputs(torch, dev, g, m, k, n)
        out = qm.int8_matmul(x, w, sc)
        ref = qm.int8_matmul_plain(x, w, sc)
        torch.cuda.synchronize()
        e = (out.float() - ref.float()).abs().max().item()
        tol = 1e-2 * ref.float().abs().max().item()
        p = qm.plan(m, n, k, sms)
        run.check(e <= tol, f"int8_matmul M{m} K{k} N{n} ({p.path}, "
                  f"{p.tile_n} columns, {p.splits} splits): max|err| "
                  f"{e:.3g} <= {tol:.3g}")
        if (m, k, n) in path_shapes:
            worst = max(worst, e)
        del x, w, sc, out, ref
    errs["int8_matmul"] = worst
    parity_backward(run, torch, dev, g, errs)
    parity_preference(run, torch, dev, g)
    parity_distill(run, torch, dev, g)
    parity_draw(run, torch, dev, g, errs)
    run.report["parity_max_err"] = errs


def _draw_logits(torch, dev, g, b, v, filtered):
    """fp32 logits of std 3; the rollout's are filtered (temperature 0.7,
    top_p 0.9: most of the row at NEG_INF), as the sampler hands them to
    the draw."""
    from dla_tpu_torch.ops import sampling
    x = torch.randn((b, v), generator=g, device=dev) * 3.0
    if filtered:
        x = sampling.filtered_logits(x, temperature=TEMPERATURE, top_p=TOP_P)
    return x.contiguous()


def parity_draw(run, torch, dev, g, errs):
    """The fused draw against its plain version (``ops.prng``) on the
    card: at the rollout's [64, 128256] (filtered) and a ragged [3,
    1000], with one key (counters over [B, V]) and per row (seed,
    position): tokens equal, and the kernel's gumbel noise within 2e-6
    of the plain version's (precise logf on both sides; an ulp apart at
    most)."""
    import numpy as np
    from dla_tpu_torch.ops import prng, sampling
    worst = 0.0
    for b, v, filtered in ((B, VOCAB, True), (3, 1000, False)):
        logits = _draw_logits(torch, dev, g, b, v, filtered)
        key = prng.fold_in(prng.PRNGKey(21), 10_000).to(dev)
        seeds = torch.from_numpy(sampling.derive_rollout_seeds(7, b).astype(
            np.int64)).to(dev)
        pos = torch.arange(b, device=dev) * 3 + 5
        for mode in ("batch key", "per-row seed, position"):
            noise = torch.empty((b, v), dtype=torch.float32, device=dev)
            if mode == "batch key":
                tok = sampling.draw_categorical(key, logits, noise=noise)
                ref_noise = prng.gumbel(key, (b, v))
                ref = prng.categorical(key, logits)
            else:
                tok = sampling.draw_categorical_per_row(seeds, pos, logits,
                                                        noise=noise)
                keys = prng.row_keys(seeds, pos)
                ref_noise = prng.gumbel_per_row(keys, v)
                ref = prng.categorical_per_row(keys, logits)
            torch.cuda.synchronize()
            e = (noise - ref_noise).abs().max().item()
            same = torch.equal(tok.long(), ref)
            worst = max(worst, e)
            run.check(same and e <= 2e-6 and tok.dtype == torch.int32,
                      f"categorical draw [{b}, {v}] {mode}: tokens equal the "
                      f"plain version's, gumbel max|err| {e:.3g} <= 2e-6")
    errs["categorical_draw"] = worst


def _segments(torch, dev, b, t, seed):
    """Packed-row segment ids: runs of 16..t/3 tokens numbered from 1,
    the last tenth of each row padding (0)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    seg = np.zeros((b, t), np.int32)
    for row in range(b):
        pos, sid = 0, 1
        while pos < t - t // 10:
            n = int(rs.randint(16, max(17, t // 3)))
            seg[row, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return torch.from_numpy(seg).to(dev)


def parity_backward(run, torch, dev, g, errs):
    """dQ, dK, dV of the two backward kernels against
    ``flash_backward_plain`` on the same inputs: one bf16 rounding of
    fp32 sums taken in another order, plus the rare flip of a bf16 dS
    entry at a rounding point, so max|err| <= 1e-2 * max|ref| (~2 bf16
    ulps at the largest gradient)."""
    from dla_tpu_torch.ops import flash_attention as fa
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    cases = [
        ("SFT shape B4 T2048 H32 KH8 D64, packed segments",
         (SFT_B, SFT_T, SFT_H, SFT_KH, SFT_HD), "seg"),
        ("window 37, T300", (2, 300, 8, 2, 64), "win"),
        ("ragged T77 D64", (3, 77, 4, 2, 64), None),
        ("llama3-8b heads D128, T256", (2, 256, HEADS, KV_HEADS, HD), None),
        ("phi3-mini head dim 96, ragged T130 GQA, packed segments, "
         "window 50", (2, 130, 8, 2, 96), "seg+win")]
    for label, (b, t, h, kh, d), extra in cases:
        q, k, v, do = mk(b, t, h, d), mk(b, t, kh, d), mk(b, t, kh, d), \
            mk(b, t, h, d)
        kw = {}
        if extra in ("seg", "seg+win"):
            kw["segment_ids"] = _segments(torch, dev, b, t, SEED)
        if extra == "win":
            kw["window"] = 37
        if extra == "seg+win":
            kw["window"] = 50
        out, lse = fa.flash_attention_forward(q, k, v, **kw)
        got = fa.flash_attention_backward(q, k, v, out, lse, do, **kw)
        ref = fa.flash_backward_plain(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        es = []
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            e = (a.float() - r.float()).abs().max().item()
            tol = 1e-2 * r.float().abs().max().item()
            run.check(e <= tol and torch.isfinite(a.float()).all().item(),
                      f"flash bwd {label} {name}: max|err| {e:.3g} <= "
                      f"{tol:.3g}")
            es.append(e)
        if extra == "seg":
            errs["flash_attention_bwd_dq"] = es[0]
            errs["flash_attention_bwd_dkv"] = max(es[1:])
        del q, k, v, do, out, lse, got, ref
        torch.cuda.empty_cache()

    # the autograd Function (kernels both ways) against autograd through
    # the plain forward, which keeps dS in fp32 where the kernels round it
    # to bf16 as the Pallas kernels do: <= 2e-2 * max|ref|
    b, t, h, kh, d = 2, 200, 8, 2, 64
    base = [mk(b, t, h, d), mk(b, t, kh, d), mk(b, t, kh, d)]
    do = mk(b, t, h, d)
    seg = _segments(torch, dev, b, t, SEED + 1)
    leaves = [x.clone().requires_grad_() for x in base]
    got = torch.autograd.grad(fa.flash_causal_attention(
        *leaves, segment_ids=seg), leaves, do)
    leaves = [x.clone().requires_grad_() for x in base]
    ref = torch.autograd.grad(fa.flash_forward_plain(
        *leaves, segment_ids=seg)[0], leaves, do)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        e = (a.float() - r.float()).abs().max().item()
        tol = 2e-2 * r.float().abs().max().item()
        run.check(e <= tol, f"flash autograd Function {name} vs autograd "
                  f"of the plain forward: max|err| {e:.3g} <= {tol:.3g}")


def parity_preference(run, torch, dev, g):
    """#1, #2 and #3 at the preference shape (B2 T1024 H32 KH8 D64,
    causal, no segment ids) on right-padded rows whose real lengths are
    those of the reward path's first micro-batch. Pad queries produce
    values nobody reads, and their dO is 0 on the path (no loss reads a
    pad position): the forward and dQ are compared on the real rows;
    dK and dV on all rows (pad keys are seen by pad queries only, so
    theirs are 0 in both). Tolerances as above: forward 3e-2 (lse 1e-3),
    kernels 1e-2 * max|ref|, autograd Function 2e-2 * max|ref|."""
    from dla_tpu_torch.ops import flash_attention as fa
    lens = _pref_first_lengths()
    b, t, h, kh, d = RM_B, PREF_T, SFT_H, SFT_KH, SFT_HD
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    q, k, v, do = mk(b, t, h, d), mk(b, t, kh, d), mk(b, t, kh, d), \
        mk(b, t, h, d)
    real = (torch.arange(t, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None])           # [B, T]
    do = do * real[:, :, None, None].to(do.dtype)
    label = f"preference shape B{b} T{t} H{h} KH{kh} D{d}, real lengths {lens}"
    errs = {}
    out, lse = fa.flash_attention_forward(q, k, v)
    ref, ref_lse = fa.flash_forward_plain(q, k, v)
    torch.cuda.synchronize()
    e = (out.float() - ref.float())[real].abs().max().item()
    e_lse = (lse - ref_lse).transpose(1, 2)[real].abs().max().item()
    run.check(e <= 3e-2 and e_lse <= 1e-3 and torch.isfinite(
        out.float()[real]).all().item(),
        f"flash {label}, real rows: max|out err| {e:.3g} <= 3e-2, "
        f"max|lse err| {e_lse:.3g} <= 1e-3")
    errs["flash_attention_fwd"] = e
    got = fa.flash_attention_backward(q, k, v, out, lse, do)
    refb = fa.flash_backward_plain(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv"), got, refb):
        a, r = a.float(), r.float()
        if name == "dq":
            a, r = a[real], r[real]
        e = (a - r).abs().max().item()
        tol = 1e-2 * r.abs().max().item()
        run.check(e <= tol and torch.isfinite(a).all().item(),
                  f"flash bwd {label} {name}"
                  f"{', real rows' if name == 'dq' else ''}: max|err| "
                  f"{e:.3g} <= {tol:.3g}")
        errs[name] = e
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(fa.flash_causal_attention(*leaves), leaves, do)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    refb = torch.autograd.grad(fa.flash_forward_plain(*leaves)[0], leaves,
                               do)
    for name, a, r in zip(("dq", "dk", "dv"), got, refb):
        a, r = a.float(), r.float()
        if name == "dq":
            a, r = a[real], r[real]
        e = (a - r).abs().max().item()
        tol = 2e-2 * r.abs().max().item()
        run.check(e <= tol, f"flash autograd Function {label} {name} vs "
                  f"autograd of the plain forward: max|err| {e:.3g} <= "
                  f"{tol:.3g}")
    run.report["parity_preference"] = dict(lengths=lens, max_abs_err=errs)


def parity_distill(run, torch, dev, g):
    """#1, #2 and #3 at phi-2's head dim 80 (the 128-wide kernels through
    80-column tensor maps) with GQA group 1: at the distill shape (B4
    T2048 H32 KH32 D80, causal) on right-padded rows (forward and dQ
    compared on the real rows, pad rows' dO 0 as on the path), with
    packed segment ids and a window, at a ragged T; then the autograd
    Function against autograd through the plain forward. Tolerances as
    in ``parity_backward``: forward 3e-2 (lse 1e-3), kernels 1e-2 *
    max|ref|, autograd Function 2e-2 * max|ref|."""
    from dla_tpu_torch.ops import flash_attention as fa
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    b, t, h, d = DIS_B, DIS_T, DIS_H, DIS_HD
    errs = {}
    cases = [(f"distill shape B{b} T{t} H{h} KH{h} D{d}, causal, "
              f"right-padded rows of {DIS_LENS}", (b, t, h, d), "pad"),
             ("D80 packed segment ids, window 300", (b, t, h, d),
              "seg+win"),
             ("D80 ragged T1000, MHA", (2, 1000, 8, d), None)]
    for label, (b_, t_, h_, d_), extra in cases:
        q, k, v, do = (mk(b_, t_, h_, d_) for _ in range(4))
        kw, real = {}, torch.ones((b_, t_), dtype=torch.bool, device=dev)
        if extra == "pad":
            real = (torch.arange(t_, device=dev)[None, :]
                    < torch.tensor(DIS_LENS, device=dev)[:, None])
            do = do * real[:, :, None, None].to(do.dtype)
        if extra == "seg+win":
            kw = dict(segment_ids=_segments(torch, dev, b_, t_, SEED),
                      window=300)
        out, lse = fa.flash_attention_forward(q, k, v, **kw)
        ref, ref_lse = fa.flash_forward_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        e = (out.float() - ref.float())[real].abs().max().item()
        live = (ref_lse > -1e29).transpose(1, 2) & real[:, :, None]
        e_lse = (lse - ref_lse).transpose(1, 2)[live].abs().max().item()
        run.check(e <= 3e-2 and e_lse <= 1e-3 and torch.isfinite(
            out.float()[real]).all().item(),
            f"flash {label}: max|out err| {e:.3g} <= 3e-2, max|lse err| "
            f"{e_lse:.3g} <= 1e-3")
        got = fa.flash_attention_backward(q, k, v, out, lse, do, **kw)
        refb = fa.flash_backward_plain(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        es = [e]
        for name, a, r in zip(("dq", "dk", "dv"), got, refb):
            a, r = a.float(), r.float()
            if name == "dq":
                a, r = a[real], r[real]
            err = (a - r).abs().max().item()
            tol = 1e-2 * r.abs().max().item()
            run.check(err <= tol and torch.isfinite(a).all().item(),
                      f"flash bwd {label} {name}: max|err| {err:.3g} <= "
                      f"{tol:.3g}")
            es.append(err)
        if extra == "pad":
            errs = dict(zip(("fwd", "dq", "dk", "dv"), es))
        del q, k, v, do, out, lse, ref, ref_lse, got, refb
        torch.cuda.empty_cache()
    b_, t_, h_ = 2, 256, 8
    base = [mk(b_, t_, h_, d) for _ in range(3)]
    do = mk(b_, t_, h_, d)
    seg = _segments(torch, dev, b_, t_, SEED + 2)
    leaves = [x.clone().requires_grad_() for x in base]
    got = torch.autograd.grad(fa.flash_causal_attention(
        *leaves, segment_ids=seg), leaves, do)
    leaves = [x.clone().requires_grad_() for x in base]
    ref = torch.autograd.grad(fa.flash_forward_plain(
        *leaves, segment_ids=seg)[0], leaves, do)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        e = (a.float() - r.float()).abs().max().item()
        tol = 2e-2 * r.float().abs().max().item()
        run.check(e <= tol, f"flash autograd Function D80 {name} vs "
                  f"autograd of the plain forward: max|err| {e:.3g} <= "
                  f"{tol:.3g}")
    run.report["parity_distill"] = dict(lengths=DIS_LENS, max_abs_err=errs)


# ------------------------------------------------------------------ timing

def _time_ms(torch, calls, reps=5):
    """Median over ``reps`` of the mean device time per call of one pass
    over ``calls``. A GPU-side spin queued first lets the host enqueue
    the whole pass, so host launch cost is not in the measurement."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for c in calls:
            c()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / len(calls))
    return statistics.median(per)


def _copies(nbytes: int, most: int = 8) -> int:
    """Input copies to cycle through so a pass streams > 100 MB (the
    path's inputs arrive cold, never from the 50 MB L2)."""
    return max(1, min(most, -(-100_000_000 // max(nbytes, 1))))


def timing(run, torch, dev):
    import torch.nn.functional as F
    from dla_tpu_torch.ops import _native
    from dla_tpu_torch.ops import decode_kernel as dk
    from dla_tpu_torch.ops import flash_attention as fa
    from dla_tpu_torch.ops import quant_matmul as qm
    g = _gen(torch, dev, SEED + 1)
    timings = {}

    # flash forward, one prefill layer: B=64, T=128, H=32, KH=8, D=128
    sets = [_flash_inputs(torch, dev, g) for _ in range(2)]
    q, k, v = sets[0]
    nbytes = 2 * (q.numel() * 2 + k.numel() * 2) + B * HEADS * PROMPT * 4
    flops = 4 * HD * B * HEADS * PROMPT * (PROMPT + 1) // 2
    bms, by = bound_ms(nbytes, flops)
    sdpa_sets = [tuple(x.transpose(1, 2).contiguous() for x in s)
                 for s in sets]
    t_k = _time_ms(torch, [lambda s=s: fa.flash_attention_forward(*s)
                           for s in sets * 4])
    t_p = _time_ms(torch, [lambda s=s: fa.flash_forward_plain(*s)
                           for s in sets])
    t_l = _time_ms(torch, [lambda s=s: F.scaled_dot_product_attention(
        *s, is_causal=True, enable_gqa=True) for s in sdpa_sets * 4])
    run.kernels["flash_attention_fwd"] = dict(
        name="flash_attention_fwd", route="cuda",
        source="dla_tpu_torch/csrc/flash_fwd.cu",
        replaces="dla_tpu/ops/flash_attention.py:227", launches=None,
        max_abs_err=run.report.get("parity_max_err", {}).get(
            "flash_attention_fwd"),
        ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=by, library_ms=t_l,
        unit="one launch: one layer of the B=64 T=128 prefill")
    timings["flash"] = dict(bytes=nbytes, flops=flops)
    del sets, sdpa_sets, q, k, v

    # decode attention at the last step's fill (S=384, fill 383), int8
    fill = PROMPT + NEW - 1
    sets = [_decode_inputs(torch, dev, g, fill=fill) for _ in range(2)]
    hd = HEADS // KV_HEADS
    nbytes = (2 * B * fill * KV_HEADS * HD + 2 * B * KV_HEADS * fill * 4
              + B * HEADS * HD * 2 * 2 + 2 * B * KV_HEADS * HD * 2
              + B * fill * 4)
    flops = 4 * B * HEADS * (fill + 1) * HD
    bms, by = bound_ms(nbytes, flops)
    copies = _copies(nbytes)
    sets = sets * (copies // 2 + 1)
    t_k = _time_ms(torch, [lambda s=s: _call_decode(
        dk.flash_decode_attention, s) for s in sets])
    t_p = _time_ms(torch, [lambda s=s: _call_decode(
        dk.flash_decode_attention_plain, s) for s in sets[:2]])
    # yardstick: one SDPA call over the dequantized cache + new column
    lib_sets = []
    for s in sets[:2]:
        kd = dk._dequant(s["k_cache"][:, :fill], s["k_scale"][..., :fill])
        vd = dk._dequant(s["v_cache"][:, :fill], s["v_scale"][..., :fill])
        kk = torch.cat([kd, s["k_new"].float()], 1).to(torch.bfloat16)
        vv = torch.cat([vd, s["v_new"].float()], 1).to(torch.bfloat16)
        mask = torch.cat([s["bias"][:, :fill], torch.zeros(
            (s["bias"].shape[0], 1), device=dev)], 1).to(
            torch.bfloat16)[:, None, None, :]
        lib_sets.append((s["q"].transpose(1, 2).contiguous(),
                         kk.transpose(1, 2).contiguous(),
                         vv.transpose(1, 2).contiguous(), mask))
    t_l = _time_ms(torch, [lambda s=s: F.scaled_dot_product_attention(
        s[0], s[1], s[2], attn_mask=s[3], enable_gqa=True)
        for s in lib_sets * 4])
    run.kernels["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="dla_tpu_torch/csrc/decode_attn.cu",
        replaces="dla_tpu/ops/decode_kernel.py:201", launches=None,
        max_abs_err=run.report.get("parity_max_err", {}).get(
            "decode_attention"),
        ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=by, library_ms=t_l,
        unit=f"one launch: one layer of the last decode step (B=64, int8 "
             f"cache S=384, fill {fill}, g={hd})")
    timings["decode"] = dict(bytes=nbytes, flops=flops)
    del sets, lib_sets

    # int8 matmul: per shape, then one decode step (225 launches at M=64)
    # and one prefill's projections (224 at M=8192 + lm_head at M=64)
    per_shape = []
    shapes = [(name, 64, k, n) for name, (k, n) in PROJ.items()]
    shapes += [("lm_head", 64, HID, VOCAB)]
    shapes += [(name, B * PROMPT, k, n) for name, (k, n) in PROJ.items()]
    measured = {}
    for name, m, k, n in shapes:
        key = (m, k, n)
        if key not in measured:
            nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
            flops = 2 * m * n * k
            sets = [_int8_inputs(torch, dev, g, m, k, n)
                    for _ in range(_copies(nbytes, most=4))]
            t_k = _time_ms(torch, [lambda s=s: qm.int8_matmul(*s)
                                   for s in sets * 2])
            t_p = _time_ms(torch, [lambda s=s: qm.int8_matmul_plain(*s)
                                   for s in sets[:1]], reps=3)
            deq = [(s[0], (s[1].float() * s[2]).to(torch.bfloat16))
                   for s in sets]
            t_l = _time_ms(torch, [lambda s=s: torch.matmul(*s)
                                   for s in deq * 2])
            measured[key] = (t_k, t_p, t_l, nbytes, flops)
            del sets, deq
        t_k, t_p, t_l, nbytes, flops = measured[key]
        bms, by = bound_ms(nbytes, flops)
        p = qm.plan(m, n, k, _native.sm_count(dev))
        per_shape.append(dict(proj=name, M=m, K=k, N=n, ms=t_k, plain_ms=t_p,
                              library_ms=t_l, bound_ms=bms, bound_by=by,
                              plan=p._asdict()))
        print(f"   int8_matmul {name:7s} M{m:5d} K{k:5d} N{n:6d}: "
              f"{t_k:.4f} ms (bound {bms:.4f} {by}, torch.matmul "
              f"{t_l:.4f}, plain {t_p:.4f}; {p.path}, {p.tile_n} columns, "
              f"{p.splits} splits)", flush=True)

    def total(rows, field):
        return sum(r[field] * (1 if r["proj"] == "lm_head" else LAYERS)
                   for r in rows)

    step = [r for r in per_shape if r["M"] == 64]
    pre = [r for r in per_shape if r["M"] != 64] + \
        [r for r in step if r["proj"] == "lm_head"]
    by_step = ("bytes" if sum(r["bound_by"] == "bytes" for r in step)
               * 2 >= len(step) else "operations")
    seq, seq_lib = _int8_step_sequence(torch, dev, g, qm)
    run.kernels["int8_matmul"] = dict(
        name="int8_matmul", route="cuda",
        source="dla_tpu_torch/csrc/int8_matmul.cu",
        replaces="dla_tpu/ops/quant_matmul.py:86", launches=None,
        max_abs_err=run.report.get("parity_max_err", {}).get("int8_matmul"),
        ms=total(step, "ms"), plain_ms=total(step, "plain_ms"),
        bound_ms=total(step, "bound_ms"), bound_by=by_step,
        library_ms=total(step, "library_ms"),
        kernels=["int8_mm_decode_kernel (M <= 64)",
                 "int8_mm_tma_kernel (M > 64)"],
        step_sequence_ms=seq, library_step_sequence_ms=seq_lib,
        unit="one decode step: 7 projections x 32 layers + lm_head at "
             "M=64 (225 launches of int8_mm_decode_kernel); ms, plain_ms, "
             "library_ms and bound_ms: each shape's median summed over "
             "the step; step_sequence_ms and library_step_sequence_ms: "
             "the 225 calls in the step's order over 32 layers' own "
             "weights (each read cold), one pass timed, the kernel and "
             "torch.matmul on the dequantized bf16 weights; max_abs_err "
             "over the path's M=64 and M=8192 shapes")
    run.report["int8_matmul_shapes"] = per_shape
    run.report["int8_matmul_prefill"] = {
        f: total(pre, f) for f in ("ms", "plain_ms", "library_ms",
                                   "bound_ms")}
    run.kernels["int8_matmul"]["prefill"] = dict(
        run.report["int8_matmul_prefill"],
        unit="one prefill: 7 projections x 32 layers at M=8192 "
             "(int8_mm_tma_kernel) + lm_head at M=64")
    run.report["timing_work"] = timings
    for kname, kv in run.kernels.items():
        print(f"   {kname}: {kv['ms']:.4f} ms vs bound {kv['bound_ms']:.4f} "
              f"({kv['bound_by']}), library {kv['library_ms']:.4f}, plain "
              f"{kv['plain_ms']:.4f} [{kv['unit']}]", flush=True)
    print(f"   int8_matmul per prefill: {run.report['int8_matmul_prefill']}")
    print(f"   int8_matmul decode step, 225 calls in order: {seq:.4f} ms, "
          f"torch.matmul {seq_lib:.4f} ms", flush=True)
    timing_sft(run, torch, dev, g)
    timing_preference(run, torch, dev, g)
    timing_distill(run, torch, dev, g)
    timing_draw(run, torch, dev, g)


def timing_draw(run, torch, dev, g):
    """The fused draw at the rollout's [64, 128256] filtered logits beside
    its plain version and the exponential race it replaces (softmax of
    the filtered logits, Exp(1) noise from a generator, argmax of p /
    noise: the port's earlier draw, which agreed with JAX in
    distribution only). No PyTorch call computes threefry: no library time. Bound:
    the logits read once and the tokens written, against the ops the
    kernel does an element (DRAW_OPS, each logf counted as one) at the
    table's CUDA-core rate."""
    from dla_tpu_torch.ops import prng, sampling
    nbytes = B * VOCAB * 4 + B * 4
    ops = B * VOCAB * DRAW_OPS
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    bms, by = max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"
    sets = [_draw_logits(torch, dev, g, B, VOCAB, True)
            for _ in range(_copies(nbytes, most=4))]
    key = prng.fold_in(prng.PRNGKey(21), 10_000).to(dev)
    t_k = _time_ms(torch, [lambda s=s: sampling.draw_categorical(key, s)
                           for s in sets * 4])
    t_p = _time_ms(torch, [lambda s=s: prng.categorical(key, s)
                           for s in sets[:1]], reps=3)
    gen = _gen(torch, dev, SEED + 5)

    def race(s):
        probs = torch.softmax(s, dim=-1)
        noise = torch.empty_like(probs).exponential_(1.0, generator=gen)
        return (probs / noise).argmax(dim=-1)

    t_race = _time_ms(torch, [lambda s=s: race(s) for s in sets * 2])
    run.kernels["categorical_draw"] = dict(
        name="categorical_draw", route="cuda",
        source="dla_tpu_torch/csrc/sample.cu",
        replaces="dla_tpu/ops/sampling.py:148 (jax.random.categorical, "
                 "fused by XLA: no pallas_call); per row :209",
        launches=None,
        max_abs_err=run.report.get("parity_max_err", {}).get(
            "categorical_draw"),
        ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=by, library_ms=None,
        exponential_race_ms=t_race,
        unit="one draw: [64, 128256] fp32 filtered logits -> 64 tokens "
             "(two launches: the row-chunk partials, then one warp a "
             "row); bound: 32.8 MB or %d ops an element at %.0f T ops/s"
             % (DRAW_OPS, CUDA_CORE_OPS_PER_S / 1e12))
    print(f"   categorical_draw: {t_k:.4f} ms vs bound {bms:.4f} ({by}), "
          f"plain {t_p:.4f}, the exponential race it replaced "
          f"{t_race:.4f}",
          flush=True)


def _int8_step_sequence(torch, dev, g, qm):
    """Device ms of one decode step's 225 int8 calls in the step's order
    (wq wk wv wo gate up down in each of 32 layers, then lm_head) at
    M = 64, each layer with its own weights, so that every weight byte
    comes from HBM as in the rollout (7.5 GB: past any cache); then of
    torch.matmul over the same sequence of dequantized bf16 weights.
    Each the median of 3 passes, each after a GPU-side spin that hides
    the host."""
    layers = [[_int8_inputs(torch, dev, g, 1, k, n)[1:] for k, n in
               PROJ.values()] for _ in range(LAYERS)]
    head = _int8_inputs(torch, dev, g, 1, HID, VOCAB)[1:]
    x_h = torch.randn((B, HID), generator=g, device=dev).to(torch.bfloat16)
    x_f = torch.randn((B, FFN), generator=g, device=dev).to(torch.bfloat16)
    calls = [(x_f if k == FFN else x_h, *ws) for layer in layers
             for (k, _), ws in zip(PROJ.values(), layer)]
    calls.append((x_h, *head))
    del layers, head
    t = _time_ms(torch, [lambda c=c: qm.int8_matmul(*c) for c in calls],
                 reps=3) * len(calls)
    deq = [(x, (w.float() * sc).to(torch.bfloat16)) for x, w, sc in calls]
    t_lib = _time_ms(torch, [lambda c=c: torch.matmul(*c) for c in deq],
                     reps=3) * len(deq)
    del calls, deq
    torch.cuda.empty_cache()
    return t, t_lib


def timing_sft(run, torch, dev, g):
    """Flash forward, dQ and dK/dV at the SFT shape (B=4, T=2048, H=32,
    KH=8, D=64; causal, no segments, so the causal count below is the
    work the inputs need and SDPA computes the same function). One
    causal T x T x D product is 2 * B * H * D * T(T+1)/2 FLOPs: the
    forward does 2, dQ 3 (S, dP, dS K) and dK/dV 4 (S, dP, P^T dO,
    dS^T Q). dQ reads q, dO, O (for delta), k, v and lse and writes dq
    and delta; dK/dV reads q, dO, k, v, lse and delta and writes dk, dv.
    All three are timed again with the packed segment ids of
    ``_segments`` (the train phase's kind of input), against SDPA given
    the block-diagonal causal boolean mask [B, 1, T, T] (the same
    function; the profiler names the backend that served it). Their
    bound counts the products over the live pairs of this run's ids
    only (k <= q and equal ids, about a fifth of the causal pairs), plus
    the ids; the causal count stays beside it as ``bound_causal_ms``."""
    import torch.nn.functional as F
    from dla_tpu_torch.ops import flash_attention as fa
    b, t, h, kh, d = SFT_B, SFT_T, SFT_H, SFT_KH, SFT_HD
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    sets = []
    for _ in range(2):          # ~110 MB each: a pass streams past the L2
        q, k, v, do = mk(b, t, h, d), mk(b, t, kh, d), mk(b, t, kh, d), \
            mk(b, t, h, d)
        out, lse = fa.flash_attention_forward(q, k, v)
        seg = _segments(torch, dev, b, t, SEED)
        out_p, lse_p = fa.flash_attention_forward(q, k, v, segment_ids=seg)
        sets.append(dict(q=q, k=k, v=v, do=do, out=out, lse=lse,
                         delta=fa.delta_rowsum(out, do), seg=seg,
                         segs=fa._segments(q, k, seg, None), out_p=out_p,
                         lse_p=lse_p, delta_p=fa.delta_rowsum(out_p, do)))
    mm = 2 * b * h * d * t * (t + 1) // 2          # one causal product
    seg = sets[0]["seg"]                           # the same ids in both
    live = (torch.tril(torch.ones(t, t, dtype=torch.bool, device=dev))
            & (seg[:, :, None] == seg[:, None, :])).sum().item()
    mm_p = 2 * h * d * live                        # one packed product
    qb, kvb, rowb = b * t * h * d * 2, b * t * kh * d * 2, b * h * t * 4
    segb = 2 * b * t * 4                           # q and kv segment ids
    rows = {}

    def dq_args(s, packed=False):
        o, lse, segs = ((s["out_p"], s["lse_p"], s["segs"]) if packed
                        else (s["out"], s["lse"], (None, None)))
        return (s["q"], s["k"], s["v"], o, s["do"], lse, *segs, None, None)

    def dkv_args(s, packed=False):
        lse, delta, segs = ((s["lse_p"], s["delta_p"], s["segs"]) if packed
                            else (s["lse"], s["delta"], (None, None)))
        return (s["q"], s["k"], s["v"], s["do"], lse, delta, *segs, None,
                None)
    t_fwd = _time_ms(torch, [lambda s=s: fa.flash_attention_forward(
        s["q"], s["k"], s["v"]) for s in sets * 4])
    t_dq = _time_ms(torch, [lambda s=s: fa.launch_bwd_dq(*dq_args(s))
                            for s in sets * 4])
    t_dkv = _time_ms(torch, [lambda s=s: fa.launch_bwd_dkv(*dkv_args(s))
                             for s in sets * 4])
    t_dq_p = _time_ms(torch, [lambda s=s: fa.launch_bwd_dq(
        *dq_args(s, True)) for s in sets * 4])
    t_dkv_p = _time_ms(torch, [lambda s=s: fa.launch_bwd_dkv(
        *dkv_args(s, True)) for s in sets * 4])
    t_bwd = _time_ms(torch, [lambda s=s: fa.flash_attention_backward(
        s["q"], s["k"], s["v"], s["out"], s["lse"], s["do"])
        for s in sets * 4])
    t_pf = _time_ms(torch, [lambda s=s: fa.flash_forward_plain(
        s["q"], s["k"], s["v"]) for s in sets], reps=3)
    t_pb = _time_ms(torch, [lambda s=s: fa.flash_backward_plain(
        s["q"], s["k"], s["v"], s["out"], s["lse"], s["do"])
        for s in sets], reps=3)
    t_pb_p = _time_ms(torch, [lambda s=s: fa.flash_backward_plain(
        s["q"], s["k"], s["v"], s["out_p"], s["lse_p"], s["do"],
        segment_ids=s["seg"]) for s in sets], reps=3)
    t_fwd_p = _time_ms(torch, [lambda s=s: fa.flash_attention_forward(
        s["q"], s["k"], s["v"], segment_ids=s["seg"]) for s in sets * 4])
    t_pf_p = _time_ms(torch, [lambda s=s: fa.flash_forward_plain(
        s["q"], s["k"], s["v"], segment_ids=s["seg"]) for s in sets],
        reps=3)
    # yardstick: SDPA in [B, H, T, D], forward and autograd backward
    lib = []
    for s in sets:
        qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (s["q"], s["k"], s["v"]))
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                           enable_gqa=True)
        lib.append((qs, ks, vs, o, s["do"].transpose(1, 2).contiguous()))
    with torch.no_grad():
        t_lf = _time_ms(torch, [lambda s=s: F.scaled_dot_product_attention(
            s[0], s[1], s[2], is_causal=True, enable_gqa=True)
            for s in lib * 4])
    t_lb = _time_ms(torch, [lambda s=s: torch.autograd.grad(
        s[3], s[:3], s[4], retain_graph=True) for s in lib * 4])
    # the same function with packed ids: SDPA given the block-diagonal
    # causal mask [B, 1, T, T] (bool), forward and autograd backward
    mask = (torch.tril(torch.ones(t, t, dtype=torch.bool, device=dev))
            & (seg[:, :, None] == seg[:, None, :]))[:, None]
    lib_p = []
    for s in sets:
        qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (s["q"], s["k"], s["v"]))
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                           enable_gqa=True)
        lib_p.append((qs, ks, vs, o, s["do"].transpose(1, 2).contiguous()))

    def sdpa_fwd_p(s):
        with torch.no_grad():
            return F.scaled_dot_product_attention(
                s[0], s[1], s[2], attn_mask=mask, enable_gqa=True)
    t_lf_p = _time_ms(torch, [lambda s=s: sdpa_fwd_p(s) for s in lib_p * 4])
    t_lb_p = _time_ms(torch, [lambda s=s: torch.autograd.grad(
        s[3], s[:3], s[4], retain_graph=True) for s in lib_p * 4])
    backend_f = _top_kernel(torch, lambda: sdpa_fwd_p(lib_p[0]))
    backend_b = _top_kernel(torch, lambda: torch.autograd.grad(
        lib_p[0][3], lib_p[0][:3], lib_p[0][4], retain_graph=True))
    print(f"   SDPA with the packed mask ran {backend_f} (forward), "
          f"{backend_b} (backward)", flush=True)
    rows["fwd"] = dict(
        ms=t_fwd, plain_ms=t_pf, library_ms=t_lf,
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(2 * qb + 2 * kvb + rowb, 2 * mm))),
        unit="one launch: one layer of an SFT micro-step, B4 T2048 H32 "
             "KH8 D64, causal")
    fwd_bytes = 2 * qb + 2 * kvb + rowb
    rows["fwd_packed"] = dict(
        ms=t_fwd_p, plain_ms=t_pf_p, library_ms=t_lf_p,
        library=f"SDPA, block-diagonal causal bool mask: {backend_f}",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(fwd_bytes + segb, 2 * mm_p))),
        bound_causal_ms=bound_ms(fwd_bytes + segb, 2 * mm)[0],
        live_pair_share=live / (b * t * (t + 1) // 2),
        unit="one launch at the SFT shape with packed segment ids (the "
             "train path's input)")
    dq_bytes, dkv_bytes = 4 * qb + 2 * kvb + 2 * rowb, \
        2 * qb + 4 * kvb + 2 * rowb
    rows["dq"] = dict(
        ms=t_dq, plain_ms=t_pb, library_ms=t_lb,
        **dict(zip(("bound_ms", "bound_by"), bound_ms(dq_bytes, 3 * mm))),
        unit="one launch at the SFT shape, delta included (plain and "
             "library compute dQ, dK and dV together)")
    rows["dkv"] = dict(
        ms=t_dkv, plain_ms=t_pb, library_ms=t_lb,
        **dict(zip(("bound_ms", "bound_by"), bound_ms(dkv_bytes, 4 * mm))),
        unit="one launch at the SFT shape (plain and library compute dQ, "
             "dK and dV together)")
    for key, t_k, nbytes, n_mm in (("dq", t_dq_p, dq_bytes, 3),
                                   ("dkv", t_dkv_p, dkv_bytes, 4)):
        rows[key + "_packed"] = dict(
            ms=t_k, plain_ms=t_pb_p, library_ms=t_lb_p,
            library=f"SDPA backward, block-diagonal causal bool mask "
                    f"(dQ, dK and dV together): {backend_b}",
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(nbytes + segb, n_mm * mm_p))),
            bound_causal_ms=bound_ms(nbytes + segb, n_mm * mm)[0],
            live_pair_share=live / (b * t * (t + 1) // 2),
            unit="one launch at the SFT shape with packed segment ids "
                 "(plain computes dQ, dK and dV together)")
    rows["backward_total_ms"] = t_bwd     # delta + dQ + dK/dV
    run.report["timing_sft"] = rows
    err = run.report.get("parity_max_err", {})
    fwd = run.kernels["flash_attention_fwd"]
    fwd["sft_shape"] = rows["fwd"]
    fwd["sft_packed"] = rows["fwd_packed"]
    for key, name, line in (("dq", "flash_attention_bwd_dq", 398),
                            ("dkv", "flash_attention_bwd_dkv", 438)):
        r = rows[key]
        run.kernels[name] = dict(
            name=name, route="cuda", source="dla_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"dla_tpu/ops/flash_attention.py:{line}", launches=None,
            max_abs_err=err.get(name), ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], unit=r["unit"],
            sft_packed=rows[key + "_packed"])
    for key, r in rows.items():
        if isinstance(r, dict):
            lib_ms = ("none" if r["library_ms"] is None
                      else f"{r['library_ms']:.4f}")
            causal = ("" if "bound_causal_ms" not in r else
                      f" (causal count {r['bound_causal_ms']:.4f}, live "
                      f"pairs {r['live_pair_share']:.4f} of causal)")
            print(f"   SFT flash {key}: {r['ms']:.4f} ms vs bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}){causal}, library "
                  f"{lib_ms}, plain {r['plain_ms']:.4f}", flush=True)
    print(f"   SFT flash backward (delta + dQ + dK/dV): {t_bwd:.4f} ms vs "
          f"SDPA backward {t_lb:.4f} ms", flush=True)
    del sets, lib, lib_p, mask
    torch.cuda.empty_cache()


def timing_preference(run, torch, dev, g):
    """Flash forward, dQ and dK/dV at the preference shape (B=2, T=1024,
    H=32, KH=8, D=64, causal, no segment ids: right-padded rows need no
    mask, so every causal tile is computed), their plain versions and
    SDPA with ``is_causal`` (forward; autograd backward for dQ, dK and
    dV together). Bounds as in ``timing_sft``, over the causal work."""
    import torch.nn.functional as F
    from dla_tpu_torch.ops import flash_attention as fa
    b, t, h, kh, d = RM_B, PREF_T, SFT_H, SFT_KH, SFT_HD
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    qb, kvb, rowb = b * t * h * d * 2, b * t * kh * d * 2, b * h * t * 4
    sets = []
    for _ in range(_copies(3 * qb + 2 * kvb)):
        q, k, v, do = mk(b, t, h, d), mk(b, t, kh, d), mk(b, t, kh, d), \
            mk(b, t, h, d)
        out, lse = fa.flash_attention_forward(q, k, v)
        sets.append(dict(q=q, k=k, v=v, do=do, out=out, lse=lse,
                         delta=fa.delta_rowsum(out, do)))
    mm = 2 * b * h * d * t * (t + 1) // 2          # one causal product
    t_fwd = _time_ms(torch, [lambda s=s: fa.flash_attention_forward(
        s["q"], s["k"], s["v"]) for s in sets * 2])
    t_dq = _time_ms(torch, [lambda s=s: fa.launch_bwd_dq(
        s["q"], s["k"], s["v"], s["out"], s["do"], s["lse"], None, None,
        None, None) for s in sets * 2])
    t_dkv = _time_ms(torch, [lambda s=s: fa.launch_bwd_dkv(
        s["q"], s["k"], s["v"], s["do"], s["lse"], s["delta"], None, None,
        None, None) for s in sets * 2])
    t_pf = _time_ms(torch, [lambda s=s: fa.flash_forward_plain(
        s["q"], s["k"], s["v"]) for s in sets[:2]], reps=3)
    t_pb = _time_ms(torch, [lambda s=s: fa.flash_backward_plain(
        s["q"], s["k"], s["v"], s["out"], s["lse"], s["do"])
        for s in sets[:2]], reps=3)
    lib = []
    for s in sets:
        qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (s["q"], s["k"], s["v"]))
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                           enable_gqa=True)
        lib.append((qs, ks, vs, o, s["do"].transpose(1, 2).contiguous()))
    with torch.no_grad():
        t_lf = _time_ms(torch, [lambda s=s: F.scaled_dot_product_attention(
            s[0], s[1], s[2], is_causal=True, enable_gqa=True)
            for s in lib * 2])
    t_lb = _time_ms(torch, [lambda s=s: torch.autograd.grad(
        s[3], s[:3], s[4], retain_graph=True) for s in lib * 2])
    unit = "one launch: one layer of a preference micro-step, B2 T1024 " \
           "H32 KH8 D64, causal, right-padded rows"
    rows = {
        "fwd": dict(ms=t_fwd, plain_ms=t_pf, library_ms=t_lf, unit=unit,
                    **dict(zip(("bound_ms", "bound_by"), bound_ms(
                        2 * qb + 2 * kvb + rowb, 2 * mm)))),
        "dq": dict(ms=t_dq, plain_ms=t_pb, library_ms=t_lb,
                   unit=unit + " (plain and library: dQ, dK and dV)",
                   **dict(zip(("bound_ms", "bound_by"), bound_ms(
                       4 * qb + 2 * kvb + 2 * rowb, 3 * mm)))),
        "dkv": dict(ms=t_dkv, plain_ms=t_pb, library_ms=t_lb,
                    unit=unit + " (plain and library: dQ, dK and dV)",
                    **dict(zip(("bound_ms", "bound_by"), bound_ms(
                        2 * qb + 4 * kvb + 2 * rowb, 4 * mm))))}
    run.report["timing_preference"] = rows
    for key, name in (("fwd", "flash_attention_fwd"),
                      ("dq", "flash_attention_bwd_dq"),
                      ("dkv", "flash_attention_bwd_dkv")):
        run.kernels[name]["preference_shape"] = rows[key]
        r = rows[key]
        print(f"   preference flash {key}: {r['ms']:.4f} ms vs bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}), SDPA "
              f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f}",
              flush=True)
    del sets, lib
    torch.cuda.empty_cache()


def timing_distill(run, torch, dev, g):
    """Flash forward, dQ and dK/dV at the distill shape (B=4, T=2048,
    H=KH=32, D=80, causal: right-padded rows need no mask, so every
    causal tile is computed), their plain versions and SDPA with
    ``is_causal`` (forward; autograd backward for dQ, dK and dV
    together). Bounds as in ``timing_sft``, over the causal work at
    D = 80 (the kernels run 128-wide tiles: 1.6 times those products)."""
    import torch.nn.functional as F
    from dla_tpu_torch.ops import flash_attention as fa
    b, t, h, d = DIS_B, DIS_T, DIS_H, DIS_HD
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    qb, rowb = b * t * h * d * 2, b * h * t * 4
    sets = []
    for _ in range(2):          # ~170 MB each: a pass streams past the L2
        q, k, v, do = (mk(b, t, h, d) for _ in range(4))
        out, lse = fa.flash_attention_forward(q, k, v)
        sets.append(dict(q=q, k=k, v=v, do=do, out=out, lse=lse,
                         delta=fa.delta_rowsum(out, do)))
    mm = 2 * b * h * d * t * (t + 1) // 2          # one causal product
    t_fwd = _time_ms(torch, [lambda s=s: fa.flash_attention_forward(
        s["q"], s["k"], s["v"]) for s in sets * 4])
    t_dq = _time_ms(torch, [lambda s=s: fa.launch_bwd_dq(
        s["q"], s["k"], s["v"], s["out"], s["do"], s["lse"], None, None,
        None, None) for s in sets * 4])
    t_dkv = _time_ms(torch, [lambda s=s: fa.launch_bwd_dkv(
        s["q"], s["k"], s["v"], s["do"], s["lse"], s["delta"], None, None,
        None, None) for s in sets * 4])
    t_pf = _time_ms(torch, [lambda s=s: fa.flash_forward_plain(
        s["q"], s["k"], s["v"]) for s in sets], reps=3)
    t_pb = _time_ms(torch, [lambda s=s: fa.flash_backward_plain(
        s["q"], s["k"], s["v"], s["out"], s["lse"], s["do"])
        for s in sets], reps=3)
    lib = []
    for s in sets:
        qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (s["q"], s["k"], s["v"]))
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        lib.append((qs, ks, vs, o, s["do"].transpose(1, 2).contiguous()))
    with torch.no_grad():
        t_lf = _time_ms(torch, [lambda s=s: F.scaled_dot_product_attention(
            s[0], s[1], s[2], is_causal=True) for s in lib * 4])
    t_lb = _time_ms(torch, [lambda s=s: torch.autograd.grad(
        s[3], s[:3], s[4], retain_graph=True) for s in lib * 4])
    backend_f = _top_kernel(torch, lambda: F.scaled_dot_product_attention(
        lib[0][0].detach(), lib[0][1].detach(), lib[0][2].detach(),
        is_causal=True))
    print(f"   SDPA at D80 ran {backend_f} (forward)", flush=True)
    unit = "one launch: one layer of a distill micro-step, B4 T2048 H32 " \
           "KH32 D80, causal, right-padded rows"
    rows = {
        "fwd": dict(ms=t_fwd, plain_ms=t_pf, library_ms=t_lf, unit=unit,
                    library=f"SDPA is_causal: {backend_f}",
                    **dict(zip(("bound_ms", "bound_by"), bound_ms(
                        4 * qb + rowb, 2 * mm)))),
        "dq": dict(ms=t_dq, plain_ms=t_pb, library_ms=t_lb,
                   unit=unit + " (plain and library: dQ, dK and dV)",
                   **dict(zip(("bound_ms", "bound_by"), bound_ms(
                       6 * qb + 2 * rowb, 3 * mm)))),
        "dkv": dict(ms=t_dkv, plain_ms=t_pb, library_ms=t_lb,
                    unit=unit + " (plain and library: dQ, dK and dV)",
                    **dict(zip(("bound_ms", "bound_by"), bound_ms(
                        6 * qb + 2 * rowb, 4 * mm))))}
    run.report["timing_distill"] = rows
    for key, name in (("fwd", "flash_attention_fwd"),
                      ("dq", "flash_attention_bwd_dq"),
                      ("dkv", "flash_attention_bwd_dkv")):
        run.kernels[name]["distill_shape"] = rows[key]
        r = rows[key]
        print(f"   distill flash {key}: {r['ms']:.4f} ms vs bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}), SDPA "
              f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f}",
              flush=True)
    del sets, lib
    torch.cuda.empty_cache()


def _top_kernel(torch, fn) -> str:
    """The CUDA kernel that took the most device time in one call of
    ``fn`` (which SDPA backend served it), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_name, _ = _device_ms(prof, 1)
    if not per_name:
        return "not measured"
    return max(per_name.items(), key=lambda kv: kv[1])[0][:100]


# ------------------------------------------------------------------- slice

@contextlib.contextmanager
def plain_versions():
    """Point the model's kernel call sites at the plain versions (the
    reference run of phase 4; the port itself never does this)."""
    from dla_tpu_torch.ops import decode_kernel as dk
    from dla_tpu_torch.ops import flash_attention as fa
    from dla_tpu_torch.ops import quant_matmul as qm
    saved = (qm.int8_matmul, fa.flash_causal_attention,
             dk.flash_decode_attention)
    qm.int8_matmul = qm.int8_matmul_plain
    fa.flash_causal_attention = \
        lambda q, k, v, **kw: fa.flash_forward_plain(q, k, v, **kw)[0]
    dk.flash_decode_attention = dk.flash_decode_attention_plain
    try:
        yield
    finally:
        (qm.int8_matmul, fa.flash_causal_attention,
         dk.flash_decode_attention) = saved


def slice_run(run, torch, dev, native):
    import numpy as np
    from dla_tpu_torch.generation.engine import (GenerationConfig,
                                                 build_generate_fn)
    from dla_tpu_torch.models.transformer import Transformer
    from dla_tpu_torch.training.model_io import load_causal_lm

    t0 = time.perf_counter()
    gen_t = _gen(torch, dev, SEED)
    bundle = load_causal_lm(
        "llama3-8b", {"attention": "flash", "kv_cache_dtype": "int8",
                      "dtype": "bfloat16", "param_dtype": "bfloat16",
                      "tokenizer": "byte"}, gen_t, device=dev)
    model, cfg = bundle.model, bundle.config
    run.check((cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
               cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
               cfg.vocab_size) == (HID, FFN, LAYERS, HEADS, KV_HEADS, HD,
                                   VOCAB), "llama3-8b widths and depth")
    params = model.quantize_weights(bundle.params)
    del bundle
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"   init + quantize {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")

    rs = np.random.RandomState(SEED)
    ids = rs.randint(3, VOCAB, (B, PROMPT)).astype(np.int32)
    lens = rs.randint(PROMPT // 2, PROMPT + 1, B)
    lens[0] = PROMPT
    mask = (np.arange(PROMPT)[None, :] < lens[:, None]).astype(np.int32)
    ids = torch.from_numpy(ids * mask).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    gen = GenerationConfig(max_new_tokens=NEW, temperature=TEMPERATURE,
                           top_p=TOP_P,
                           do_sample=True, eos_token_id=-1, pad_token_id=0)
    generate = build_generate_fn(model, gen)

    # the main path, traced: the wrappers count the launches they issue
    # (the prefill, the eager first step and the one capture of the
    # step); the card's launches, replays included, are counted from
    # torch.profiler's kernel records
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = generate(params, ids, mask, _key(SEED + 7))
        torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    wrapped = native.launch_counts()
    trace = _trace_kernels(torch, prof)
    del prof
    per_step = {"flash_attention_fwd": 0, "decode_attention": LAYERS,
                "int8_matmul": 7 * LAYERS + 1, "categorical_draw": 1}
    prefill = {"flash_attention_fwd": LAYERS, "decode_attention": 0,
               "int8_matmul": 7 * LAYERS + 1, "categorical_draw": 0}
    want_wrapped = {k: prefill[k] + 2 * v for k, v in per_step.items()}
    want = {k: prefill[k] + NEW * v for k, v in per_step.items()}
    counts = {k: sum(n for name, n in trace["launches"].items()
                     if any(sym in name for sym in KERNEL_SYMBOLS[k]))
              for k in want}
    replayed = {k: sum(n for name, n in trace["replay_launches"].items()
                       if any(sym in name for sym in KERNEL_SYMBOLS[k]))
                for k in want}
    print(f"   wrapper launches (prefill, first step, capture) {wrapped}, "
          f"expected {want_wrapped}")
    print(f"   card launches (trace) {counts}, expected {want}; in "
          f"{trace['replays']} graph replays {replayed}", flush=True)
    run.check(wrapped == want_wrapped, "each wrapper issued its launches: "
              "the prefill's, the first step's and the capture's")
    run.check(counts == want, "the card's launches of each kernel, counted "
              "in the trace, equal the path's counts")
    run.check(trace["replays"] == NEW - 1 and replayed == {
        k: (NEW - 1) * v for k, v in per_step.items()},
        "the graph replayed the step 255 times, each with its launches")
    for name in want:
        if name in run.kernels:
            run.kernels[name]["launches"] = counts[name]
            run.kernels[name]["wrapper_launches"] = wrapped.get(name, 0)

    toks, lps = out["response_tokens"], out["response_logps"]
    run.check(tuple(toks.shape) == (B, NEW) and tuple(
        out["sequences"].shape) == (B, PROMPT + NEW), "output shapes")
    run.check(bool(((toks >= 0) & (toks < VOCAB)).all()), "token ids in vocab")
    run.check(bool(torch.isfinite(lps).all()) and bool((lps <= 0).all()),
              "response logps finite and <= 0")
    run.check(bool((out["lengths"] == mask.sum(1) + NEW).all()),
              "lengths = prompt + 256")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # steady-state timing: prefill alone, a second full generate (graphed
    # decode), then the same from the same seed through an eager loop of
    # build_decode_step: its outputs must equal the graph's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.start_decode(params, ids, mask, NEW)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    del logits, cache
    t0 = time.perf_counter()
    out2 = generate(params, ids, mask, _key(SEED + 8))
    torch.cuda.synchronize()
    t_gen2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    e_toks, e_lps = _eager_decode(torch, model, params, ids, mask, gen,
                                  _key(SEED + 8))
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    same = (torch.equal(out2["response_tokens"], e_toks)
            and torch.equal(out2["response_logps"], e_lps))
    run.check(same, "the graphed generate's tokens and logps equal an eager "
              "build_decode_step loop's from the same key")
    run.check(bool((out2["lengths"] == mask.sum(1) + NEW).all()),
              "graphed generate #2: lengths = prompt + 256")
    dec = (t_gen2 - t_pre) / NEW
    dec_eager = (t_eager - t_pre) / NEW
    slice_rep = dict(
        prefill_ms=t_pre * 1e3, decode_ms_per_step=dec * 1e3,
        decode_ms_per_step_eager=dec_eager * 1e3,
        generate_s_first_traced=t_gen, generate_s=t_gen2,
        eager_generate_s=t_eager,
        tokens_per_s=B * NEW / t_gen2, decode_tokens_per_s=B / dec,
        tokens_per_s_eager=B * NEW / t_eager,
        peak_mem_gib=peak, launches=counts, wrapper_launches=wrapped)
    run.report["slice"] = slice_rep
    print("   slice " + json.dumps(slice_rep), flush=True)
    del out2, e_toks, e_lps

    # reference: same weights at 4 layers, kernels vs plain versions, and
    # the plain versions with fp32 activations (the bf16 noise floor)
    depth = min(4, cfg.num_layers)
    cfg4 = dataclasses.replace(cfg, num_layers=depth)
    p4 = {**params,
          "layers": {k: v[:depth] for k, v in params["layers"].items()}}

    def roll(model4, steps_tokens=None):
        logits, cache = model4.start_decode(p4, ids, mask, 4)
        outs, toks_used = [logits.float()], []
        for i in range(4):
            tok = (logits.float().argmax(-1).to(torch.int32)
                   if steps_tokens is None else steps_tokens[i])
            toks_used.append(tok)
            logits, cache = model4.decode_step(p4, cache, tok)
            outs.append(logits.float())
        return outs, toks_used

    got, used = roll(Transformer(cfg4))
    with plain_versions():
        ref, _ = roll(Transformer(cfg4), used)
        ref32, _ = roll(Transformer(dataclasses.replace(
            cfg4, dtype="float32")), used)
    torch.cuda.synchronize()

    def stats(a_list, b_list):
        err = torch.cat([(a - b).flatten() for a, b in zip(a_list, b_list)])
        refv = torch.cat([b.flatten() for b in b_list])
        return dict(max_err=err.abs().max().item(),
                    rms_err=err.pow(2).mean().sqrt().item(),
                    max_ref=refv.abs().max().item(),
                    rms_ref=refv.pow(2).mean().sqrt().item())

    k_vs_p = stats(got, ref)
    floor = stats(ref, ref32)
    agree = sum((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                for a, b in zip(got, ref)) / len(got)
    print(f"   4-layer logits, kernels vs plain: {k_vs_p}; argmax agreement "
          f"{agree:.4f}", flush=True)
    print(f"   4-layer logits, plain bf16 vs plain fp32 activations (noise "
          f"floor): {floor}", flush=True)
    run.report["slice"]["ref_logits"] = dict(
        kernels_vs_plain=k_vs_p, plain_bf16_vs_fp32=floor,
        argmax_agreement=agree)
    # bf16 keeps 8 bits; ~10 bf16-rounded stages per layer over 4 layers
    # leave logits a few percent of their range apart between any two
    # equally valid rounding orders: max within 5% of max|ref|, rms
    # within 2% of rms(ref)
    run.check(k_vs_p["max_err"] <= 0.05 * k_vs_p["max_ref"]
              and k_vs_p["rms_err"] <= 0.02 * k_vs_p["rms_ref"],
              "4-layer prefill + 4 decode-step logits match the plain "
              "versions (max |err| <= 5% of max|logit|, rms <= 2% of rms)")
    profile_decode(run, torch, model, params, ids, mask, gen,
                   slice_rep["decode_ms_per_step_eager"], trace,
                   slice_rep["decode_ms_per_step"])


def _key(n: int):
    """The root key of seed ``SEED`` folded with ``n``, a [2] tensor on
    the host (the generate fn moves it to the card)."""
    from dla_tpu_torch.ops import prng
    return prng.fold_in(prng.PRNGKey(SEED), n)


def _eager_decode(torch, model, params, ids, mask, gen, key, new=NEW):
    """The rollout's decode as an eager loop of ``build_decode_step`` (the
    public single-step API) with step i under ``split(key, new)[i]``, as
    ``build_generate_fn`` keys it: (tokens [B, new], chosen-token logps),
    as ``build_generate_fn`` computes them with no EOS."""
    from dla_tpu_torch.generation.engine import build_decode_step
    from dla_tpu_torch.ops import prng
    step = build_decode_step(model, gen)
    keys = prng.split(key.to(ids.device), new)
    logits, cache = model.start_decode(params, ids, mask, new)
    done = torch.zeros((ids.shape[0],), dtype=torch.bool, device=ids.device)
    toks, lps = [], []
    for i in range(new):
        prev = logits.float()
        tok, _, logits, cache, done = step(keys[i], params, logits, cache,
                                           done)
        lps.append(torch.log_softmax(prev, dim=-1).gather(
            1, tok[:, None].long())[:, 0])
        toks.append(tok)
    return torch.stack(toks, 1), torch.stack(lps, 1)


OUR_KERNELS = ("int8_mm_decode_kernel", "int8_mm_tma_kernel",
               "flash_fwd_kernel", "flash_bwd_dq_kernel",
               "flash_bwd_dkv_kernel", "decode_attn_kernel",
               "draw_partial_kernel", "draw_final_kernel")
# each rollout wrapper's kernels, as their names read in a trace
KERNEL_SYMBOLS = {"flash_attention_fwd": ("flash_fwd_kernel",),
                  "decode_attention": ("decode_attn_kernel",),
                  "int8_matmul": ("int8_mm_decode_kernel",
                                  "int8_mm_tma_kernel"),
                  "categorical_draw": ("draw_partial_kernel",)}


def _trace_kernels(torch, prof):
    """The kernel records of a torch.profiler trace: launches by kernel
    name; the same, and device ns by name, for the kernels of CUDA graph
    replays (a kernel of a graph carries the correlation id of the
    cudaGraphLaunch that ran it); the number of replays, and the ns from
    the first replay kernel's start to the last one's end."""
    from torch.autograd import DeviceType
    evs = prof.profiler.kineto_results.events()
    graph_ids = {e.correlation_id() for e in evs
                 if e.device_type() == DeviceType.CPU
                 and e.name().startswith("cudaGraphLaunch")}
    launches, replay_launches, replay_ns = {}, {}, {}
    first, last = None, None
    for e in evs:
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        launches[name] = launches.get(name, 0) + 1
        if e.correlation_id() in graph_ids:
            replay_launches[name] = replay_launches.get(name, 0) + 1
            replay_ns[name] = replay_ns.get(name, 0) + e.duration_ns()
            first = min(first or e.start_ns(), e.start_ns())
            last = max(last or 0, e.start_ns() + e.duration_ns())
    return dict(launches=launches, replay_launches=replay_launches,
                replay_ns=replay_ns, replays=len(graph_ids),
                replay_span_ns=(last - first) if first else 0)


def _device_ms(prof, n: int, ops: bool = False):
    """(device ms per iteration by kernel name, total) from a profile of
    ``n`` iterations (or its ``key_averages()``). With ``ops``, the names
    are instead the ATen ops whose own launches took that device time
    (kernels attributed to the op that launched them)."""
    from torch.autograd import DeviceType
    per_name = {}
    events = prof if isinstance(prof, list) else prof.key_averages()
    for ev in events:
        if ops != (ev.device_type == DeviceType.CPU) or (
                ops and not ev.key.startswith("aten::")):
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            per_name[ev.key] = per_name.get(ev.key, 0.0) + t / 1e3 / n
    return per_name, sum(per_name.values())


def profile_decode(run, torch, model, params, ids, mask, gen, step_ms,
                   trace, graph_step_ms):
    """Device time of a decode step against its wall time: the device's
    busy share of a step, and its device time by kernel. Eager: three
    engine steps (``build_decode_step``: sampling + decode_step) under
    torch.profiler, against the slice's unprofiled eager loop, with the
    device time also by the ATen op that launched it. Graphed: the
    replays of the step in the traced main-path generate (the graph
    ``build_generate_fn`` captured), against the unprofiled graphed
    generate's ms per step and against the traced replays' span."""
    from torch.profiler import ProfilerActivity, profile

    from dla_tpu_torch.generation.engine import build_decode_step
    step = build_decode_step(model, gen)
    g = _key(SEED + 9).to(ids.device)
    logits, cache = model.start_decode(params, ids, mask, 16)
    done = torch.zeros((ids.shape[0],), dtype=torch.bool, device=ids.device)
    step(g, params, logits, cache, done)          # warm
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            _, _, logits, cache, done = step(g, params, logits, cache, done)
        torch.cuda.synchronize()
    per_name, dev_ms = _device_ms(prof, n)
    rep = {"eager": dict(_profile_rep(per_name, dev_ms, step_ms),
                         device_ms_by_op=sorted(
                             _device_ms(prof, n, ops=True)[0].items(),
                             key=lambda kv: -kv[1])[:20])}
    reps = max(trace["replays"], 1)
    per_name = {k: v / 1e6 / reps for k, v in trace["replay_ns"].items()}
    span_ms = trace["replay_span_ns"] / 1e6 / reps
    rep["graph_replay"] = dict(
        _profile_rep(per_name, sum(per_name.values()), graph_step_ms),
        replays=trace["replays"], replay_span_ms_per_step=span_ms,
        busy_share_of_span=(sum(per_name.values()) / span_ms) if span_ms
        else "not measured")
    run.report["decode_profile"] = rep
    print("   decode profile " + json.dumps(rep), flush=True)


def _device_ms_by_kind(per_name):
    """Device ms by kind of kernel: the port's, cuBLAS's, PyTorch's."""
    kinds = {}
    for k, v in per_name.items():
        kind = ("port attention kernels" if any(o in k for o in OUR_KERNELS)
                else "matmul (cuBLAS)" if any(m in k for m in (
                    "nvjet", "gemm", "xmma", "cutlass", "sm90_"))
                else "elementwise / reduce / copy (PyTorch)")
        kinds[kind] = kinds.get(kind, 0.0) + v
    return kinds


def _profile_rep(per_name, dev_ms, step_ms):
    ours = {o: sum(v for k, v in per_name.items() if o in k)
            for o in OUR_KERNELS}
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(device_ms_per_step=dev_ms if dev_ms > 0 else "not measured",
                port_kernels_ms_per_step=sum(ours.values()),
                port_kernels={k: v for k, v in ours.items() if v},
                wall_ms_per_step=step_ms,
                busy_share=(dev_ms / step_ms) if dev_ms > 0 else
                "not measured",
                top=[(k[:60], v) for k, v in top])


# ------------------------------------------------------------------- train

_LETTERS = list("abcdefghijklmnopqrstuvwxyz     ")


def _sft_records(n: int, seed: int):
    """Instruction records of 64..1536 bytes (= byte-tokenizer tokens),
    prompt an eighth to a half of each, so 2048-token rows pack several
    segments."""
    import numpy as np
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        total = int(rs.randint(64, 1536))
        cut = int(rs.randint(total // 8, total // 2))
        out.append({"prompt": "".join(rs.choice(_LETTERS, cut)),
                    "response": "".join(rs.choice(_LETTERS, total - cut))})
    return out


def _sft_argv(work: Path):
    sets = {
        "seed": SEED,
        "model.model_name_or_path": SFT_MODEL,
        "model.tokenizer": "byte",
        "data.train_path": str(work / "train.jsonl"),
        "data.eval_path": str(work / "eval.jsonl"),
        "data.packing": "true",
        "model.max_seq_length": SFT_T,
        "optimization.micro_batch_size": SFT_B,
        "hardware.gradient_accumulation_steps": SFT_ACCUM,   # config: 32
        "optimization.max_train_steps": SFT_STEPS,           # config: 5000
        "logging.eval_every_steps": SFT_EVAL_EVERY,
        "logging.log_every_steps": 1,
        "logging.output_dir": str(work / "ckpt"),
        "logging.log_dir": str(work / "logs"),
    }
    argv = ["--config", str(SFT_CONFIG)]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    return argv


def _sft_batches(work: Path, n: int):
    """The first ``n`` global batches the CLI's iterator yields."""
    from dla_tpu_torch.data.tokenizers import ByteTokenizer
    from dla_tpu_torch.training.config import (config_from_args,
                                               make_arg_parser)
    from dla_tpu_torch.training.train_sft import build_train_iterator
    config = config_from_args(make_arg_parser("").parse_args(
        _sft_argv(work)))
    it = iter(build_train_iterator(config, ByteTokenizer(), SFT_T,
                                   SFT_B * SFT_ACCUM))
    return [next(it) for _ in range(n)]


def _small_trainer(torch, dev, layers: int, opt: dict, out_dir, seed=SEED):
    """A Trainer on llama3.2-1b cut to ``layers`` (full width), SFT loss,
    random init from ``seed``."""
    import dataclasses
    from dla_tpu_torch.models.config import get_model_config
    from dla_tpu_torch.models.transformer import Transformer
    from dla_tpu_torch.training.train_sft import make_sft_loss
    from dla_tpu_torch.training.trainer import Trainer
    cfg = dataclasses.replace(get_model_config(
        SFT_MODEL, max_seq_length=SFT_T, attention="flash",
        remat="full"), num_layers=layers)
    model = Transformer(cfg)
    params = model.init(_gen(torch, dev, seed))
    config = {"optimization": opt,
              "logging": {"output_dir": str(out_dir), "log_dir": None}}
    return Trainer(config=config, loss_fn=make_sft_loss(model),
                   params=params), model


def _config_opt(config: Path, **over):
    """A config's optimization block with ``over`` set (this run's cuts;
    one device, so no total batch size)."""
    from dla_tpu_torch.training.config import load_config
    opt = dict(load_config(config)["optimization"])
    opt.pop("total_batch_size")
    opt.update(over)
    return opt


def _sft_opt(**over):
    """config/sft_config.yaml's optimization block at this run's cuts."""
    return _config_opt(SFT_CONFIG, **{
        "micro_batch_size": SFT_B, "gradient_accumulation_steps": SFT_ACCUM,
        "max_train_steps": SFT_STEPS, **over})


def train_run(run, torch, dev, native):
    import shutil
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from dla_tpu_torch.data.jsonl import write_jsonl
    from dla_tpu_torch.training import train_sft

    work = ROOT / "build" / "chip_smoke_sft"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    write_jsonl(work / "train.jsonl", _sft_records(320, SEED))
    write_jsonl(work / "eval.jsonl", _sft_records(SFT_EVAL_RECORDS, SEED + 1))

    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = train_sft.main(_sft_argv(work), device="cuda")
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    counts = native.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_eval = SFT_STEPS // SFT_EVAL_EVERY * SFT_EVAL_BATCHES
    micro = SFT_ACCUM * SFT_STEPS
    want = {"flash_attention_fwd": SFT_LAYERS * (2 * micro + n_eval),
            "flash_attention_bwd_dq": SFT_LAYERS * micro,
            "flash_attention_bwd_dkv": SFT_LAYERS * micro}
    print(f"   launches {counts}, expected {want} (full remat: 2 forwards "
          f"per layer per micro-step, + {n_eval} eval batches)")
    run.check(counts == want, "train launch counts equal the path's counts")
    run.kernels["flash_attention_fwd"]["launches_train"] = counts.get(
        "flash_attention_fwd", 0)
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        run.kernels[name]["launches"] = counts.get(name, 0)

    rows = [json.loads(line) for line in
            (work / "logs" / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "train/loss_instant" in r]
    losses = [r["train/loss_instant"] for r in train_rows]
    gnorms = [r["train/grad_norm"] for r in train_rows]
    evals = [r["eval/loss"] for r in rows if "eval/loss" in r]
    print(f"   losses {losses}, grad norms {gnorms}, eval {evals}")
    run.check(len(losses) == SFT_STEPS and all(
        x is not None and np.isfinite(x) for x in losses + gnorms + evals),
        "losses, grad norms and eval losses finite")
    run.check(11.0 <= losses[0] <= 13.5,
              f"first loss {losses[0]:.4f} near ln V = "
              f"{np.log(VOCAB):.4f} (in [11, 13.5])")
    n_params = sum(t.numel() for t in trainer.leaves)
    ckpt = work / "ckpt" / "final"
    index = json.loads((ckpt / "index.json").read_text())
    ckpt_gb = sum(f.stat().st_size for f in ckpt.iterdir()) / 1e9
    run.check(index["leaves"]["params.layers.wq"]["shape"]
              == [SFT_LAYERS, 2048, 2048] and index["aux"]["step"]
              == SFT_STEPS, "final/ holds stacked params at step 4")
    save_s = trainer.last_save_s   # final/ stays for the preference phase
    DISK.sample("SFT final saved")

    # steady state: one optimizer step and one micro-step, synchronized
    batch = _sft_batches(work, 1)[0]
    tokens = int(batch["attention_mask"].sum())
    trainer.step_on_batch(batch)                 # warm (allocator, cuBLAS)
    torch.cuda.synchronize()
    native.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.step_on_batch(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    per_step = native.launch_counts()    # one optimizer step, no eval
    layer_steps = SFT_LAYERS * SFT_ACCUM   # layer passes per step
    print(f"   launches per optimizer step {per_step}")
    run.check(per_step == {"flash_attention_fwd": 2 * layer_steps,
                           "flash_attention_bwd_dq": layer_steps,
                           "flash_attention_bwd_dkv": layer_steps},
              "one optimizer step launches 2 forwards and 1 of each "
              "backward per layer per micro-step")
    run.kernels["flash_attention_fwd"]["sft_shape"]["launches_per_step"] = \
        per_step.get("flash_attention_fwd", 0)
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        run.kernels[name]["launches_per_step"] = per_step.get(name, 0)
    mb = {k: torch.from_numpy(v[:SFT_B]).to(dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = trainer.loss_fn(trainer.train_params, None, mb, None)
    loss.backward()
    torch.cuda.synchronize()
    micro_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step_on_batch(batch)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    per_name, dev_ms = _device_ms(prof, 1)
    ours = {next(o for o in OUR_KERNELS if o in k): v
            for k, v in per_name.items() if any(o in k for o in OUR_KERNELS)}
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    by_op = sorted(_device_ms(prof, 1, ops=True)[0].items(),
                   key=lambda kv: -kv[1])[:15]
    kinds = _device_ms_by_kind(per_name)
    tok_s = tokens / step_s
    rep = dict(
        cli_s=t_cli, losses=losses, grad_norms=gnorms, eval_losses=evals,
        launches=counts, launches_per_step=per_step, n_params=n_params,
        tokens_per_step=tokens,
        optimizer_step_ms=step_s * 1e3, micro_step_ms=micro_s * 1e3,
        tokens_per_s=tok_s,
        mfu_6n=6 * n_params * tok_s / BF16_FLOP_PER_S,
        peak_mem_gib=peak, checkpoint_save_s=save_s, checkpoint_gb=ckpt_gb,
        profiled_step_ms=prof_s * 1e3,
        device_ms_per_step=dev_ms if dev_ms > 0 else "not measured",
        busy_share=dev_ms / (prof_s * 1e3) if dev_ms > 0 else
        "not measured",
        port_kernels_ms_per_step=sum(ours.values()),
        port_kernels=ours, device_ms_by_kind=kinds,
        top=[(k[:60], v) for k, v in top], device_ms_by_op=by_op)
    run.report["train"] = rep
    print("   train " + json.dumps(rep), flush=True)
    del trainer, mb, loss, prof
    torch.cuda.empty_cache()

    train_checks_2_layers(run, torch, dev, work)
    for d in work.iterdir():     # all but ckpt/, which the next phase reads
        if d.name != "ckpt":
            shutil.rmtree(d) if d.is_dir() else d.unlink()


def _named_leaves(views, prefix=""):
    """{dotted name: tensor} of a tree of the Trainer's per-layer views."""
    out = {}
    for k, v in views.items():
        if isinstance(v, dict):
            out.update(_named_leaves(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            for i, layer in enumerate(v):
                out.update(_named_leaves(layer, f"{prefix}{k}.{i}."))
        else:
            out[prefix + k] = v
    return out


def _grads(torch, loss_of, params):
    """(loss, {leaf name: fp32 gradient}) of ``loss_of(views)``, the
    autograd leaves being per-layer views (the Trainer's)."""
    from dla_tpu_torch.training.trainer import _train_views
    views = _train_views(params)
    named = _named_leaves(views)
    for t in named.values():
        t.requires_grad_(True)
        t.grad = None
    loss = loss_of(views)
    loss.backward()
    out = {k: t.grad.float().clone() for k, t in named.items()}
    loss = loss.detach()
    for t in named.values():
        t.grad = None
    return float(loss), out


def _grad_floor_check(run, torch, label, gk, gp, g32, factor=1.0):
    """Every leaf's relative gradient error on the kernel path (against
    the plain versions) must not exceed ``factor`` times the plain path's
    own bf16 error (against fp32 activations)."""
    worst = {}
    for name in gk:
        ref = gp[name].norm().item()
        e = (gk[name] - gp[name]).norm().item() / max(ref, 1e-30)
        floor = (gp[name] - g32[name]).norm().item() / max(
            g32[name].norm().item(), 1e-30)
        worst[name] = (e, floor)
    bad = {k: v for k, v in worst.items() if not v[0] <= factor * v[1]}
    top = sorted(worst.items(),
                 key=lambda kv: -kv[1][0] / max(kv[1][1], 1e-30))[:4]
    print(f"   {label}: per-leaf relative gradient error (kernels vs "
          f"plain, plain bf16 vs fp32), worst ratios: {top}", flush=True)
    bound = "" if factor == 1.0 else f"{factor:.3g} x "
    run.check(not bad, f"{label}: every leaf's gradient on the kernel path "
              f"is within {bound}the plain path's distance from fp32 "
              f"({len(worst)} leaves; over: {sorted(bad)})")
    return worst


def train_checks_2_layers(run, torch, dev, work):
    import dataclasses
    from dla_tpu_torch.models.transformer import Transformer
    from dla_tpu_torch.ops.fused_ce import model_fused_ce

    batches = _sft_batches(work, SFT_STEPS)

    # gradients, kernels vs plain versions vs plain with fp32 activations
    trainer, model = _small_trainer(torch, dev, 2, _sft_opt(), work / "g")
    params = trainer.params
    mb = {k: torch.from_numpy(v[:SFT_B]).to(dev)
          for k, v in batches[0].items()}
    model32 = Transformer(dataclasses.replace(model.cfg, dtype="float32"))
    lk, gk = _grads(torch, lambda v: model_fused_ce(model, v, mb)[0], params)
    with plain_versions():
        lp, gp = _grads(torch, lambda v: model_fused_ce(model, v, mb)[0],
                        params)
        l32, g32 = _grads(torch, lambda v: model_fused_ce(model32, v, mb)[0],
                          params)
    print(f"   2-layer loss kernels {lk:.6f}, plain {lp:.6f}, plain fp32 "
          f"{l32:.6f}", flush=True)
    worst = _grad_floor_check(run, torch, "SFT loss, 2 layers", gk, gp, g32)
    run.report["train_grad_check"] = dict(
        loss_kernels=lk, loss_plain=lp, loss_plain_fp32=l32,
        rel_err_vs_floor=worst)
    del trainer, model, model32, params, gk, gp, g32, mb
    torch.cuda.empty_cache()

    # interrupted at step 2 and resumed vs uninterrupted
    a, _ = _small_trainer(torch, dev, 2, _sft_opt(), work / "a")
    la = [a.step_on_batch(b)[0] for b in batches]
    del a
    b, _ = _small_trainer(torch, dev, 2, _sft_opt(), work / "r")
    for bt in batches[:2]:
        b.step_on_batch(bt)
    b.save()
    del b
    c, _ = _small_trainer(torch, dev, 2, _sft_opt(), work / "r",
                          seed=SEED + 5)
    c.try_resume()
    lc = [c.step_on_batch(bt)[0] for bt in batches[2:]]
    del c
    torch.cuda.empty_cache()
    print(f"   2-layer losses uninterrupted {la}, resumed steps 3-4 {lc}")
    run.report["train_resume"] = dict(uninterrupted=la, resumed=lc)
    run.check(lc == la[2:], "resumed step 3-4 losses equal the "
              "uninterrupted run's")

    # constant lr 1e-4 on one repeated batch: the loss falls
    d, _ = _small_trainer(torch, dev, 2, _sft_opt(
        learning_rate=1e-4, lr_scheduler="constant", warmup_steps=0,
        gradient_accumulation_steps=1), work / "d")
    one = {k: v[:SFT_B] for k, v in batches[0].items()}
    ld = [d.step_on_batch(one)[0] for _ in range(10)]
    del d
    torch.cuda.empty_cache()
    print(f"   2-layer, lr 1e-4, one batch x 10 steps: losses {ld}")
    run.report["train_overfit"] = ld
    run.check(ld[-1] < ld[0] - 0.5, f"loss falls on a repeated batch "
              f"({ld[0]:.4f} -> {ld[-1]:.4f}, by more than 0.5)")


# -------------------------------------------------------------- preference

@contextlib.contextmanager
def plain_kernels():
    """Route the flash autograd Function through the kernels' plain
    versions (``flash_forward_plain`` / ``flash_backward_plain``: the
    same arithmetic as the kernels, dS rounded to bf16 as the Pallas
    kernels do), where ``plain_versions`` differentiates the plain
    forward with autograd (dS kept in fp32)."""
    from dla_tpu_torch.ops import flash_attention as fa
    saved = (fa.flash_attention_forward, fa.flash_attention_backward)
    fa.flash_attention_forward = lambda q, k, v, **kw: \
        fa.flash_forward_plain(q, k, v, **kw)
    fa.flash_attention_backward = fa.flash_backward_plain
    try:
        yield
    finally:
        fa.flash_attention_forward, fa.flash_attention_backward = saved


def _pref_records(n: int, seed: int):
    """Preference records: prompts of 32..256 bytes, chosen and rejected
    responses of 32..900 (= byte-tokenizer tokens); the longest pairs run
    past 1024 tokens and are truncated."""
    import numpy as np
    rs = np.random.RandomState(seed)

    def text(lo, hi):
        return "".join(rs.choice(_LETTERS, int(rs.randint(lo, hi + 1))))
    return [{"prompt": text(32, 256), "chosen": text(32, 900),
             "rejected": text(32, 900)} for _ in range(n)]


def _pref_first_lengths():
    """Real lengths of the chosen rows of the reward path's first
    micro-batch (the CLI's iterator over the phase's records)."""
    from dla_tpu_torch.data.datasets import PreferenceDataset
    from dla_tpu_torch.data.iterator import ShardedBatchIterator
    from dla_tpu_torch.data.tokenizers import ByteTokenizer
    ds = PreferenceDataset(ByteTokenizer(), PREF_T,
                           records=_pref_records(PREF_TRAIN_RECORDS, SEED))
    batch = next(iter(ShardedBatchIterator(ds, RM_B * PREF_ACCUM,
                                           seed=SEED)))
    return [int(x) for x in batch["chosen"]["attention_mask"][:RM_B].sum(1)]


def _pref_argv(phase: str, work: Path):
    """The CLI's arguments: the phase's config with the SFT checkpoint as
    the starting point (``latest``, as the configs chain phases), the
    byte tokenizer, local records and this run's cuts."""
    sft = str(SFT_WORK / "ckpt" / "latest")
    sets = {"seed": SEED, "model.tokenizer": "byte",
            "model.max_seq_length": PREF_T,
            "data.eval_path": str(work / "eval.jsonl"),
            "hardware.gradient_accumulation_steps": PREF_ACCUM,
            "optimization.max_train_steps": PREF_STEPS,
            "logging.eval_every_steps": PREF_EVAL_EVERY,
            "logging.log_every_steps": 1,
            "logging.output_dir": str(work / phase / "ckpt"),
            "logging.log_dir": str(work / phase / "logs")}
    if phase == "reward":
        config = REWARD_CONFIG
        sets.update({"model.base_model_name_or_path": sft,
                     "model.pooling": "last_token", "model.dropout": 0.1,
                     "optimization.micro_batch_size": RM_B,
                     "data.train_path": str(work / "train.jsonl")})
    else:
        config = DPO_CONFIG
        sets.update({"model.policy_model_name_or_path": sft,
                     "model.reference_model_name_or_path": sft,
                     "model.beta": 0.1, "model.label_smoothing": 0.0,
                     "optimization.micro_batch_size": DPO_B,
                     "data.preference_path": str(work / "train.jsonl")})
    argv = ["--config", str(config)]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    return argv


def _pref_batches(phase: str, work: Path, n: int):
    """The first ``n`` global batches the phase's CLI iterator yields."""
    from dla_tpu_torch.data.iterator import ShardedBatchIterator
    from dla_tpu_torch.data.loaders import build_preference_splits
    from dla_tpu_torch.data.tokenizers import ByteTokenizer
    from dla_tpu_torch.training.config import (config_from_args,
                                               make_arg_parser)
    config = config_from_args(make_arg_parser("").parse_args(
        _pref_argv(phase, work)))
    train, _, _ = build_preference_splits(config, ByteTokenizer(), PREF_T)
    micro = config["optimization"]["micro_batch_size"]
    it = iter(ShardedBatchIterator(train, micro * PREF_ACCUM,
                                   seed=int(config["seed"])))
    return [next(it) for _ in range(n)]


def _pref_launches(phase: str, micro_steps: int, eval_batches: int):
    """Wrapper launches of #1, #2, #3 on the path: per micro-step each
    side's trained forward runs every layer twice (full remat) and its
    backward once; DPO adds the reference's forward of both sides (no
    grad: once per layer); an eval batch runs each forward once."""
    L = SFT_LAYERS
    fwd = 2 * L * 2 + (2 * L if phase == "dpo" else 0)
    eval_fwd = 2 * L * (2 if phase == "dpo" else 1)
    return {"flash_attention_fwd": micro_steps * fwd
            + eval_batches * eval_fwd,
            "flash_attention_bwd_dq": micro_steps * 2 * L,
            "flash_attention_bwd_dkv": micro_steps * 2 * L}


def _run_parts(run, parts):
    """Run each part; print a failing part's traceback and go on, so one
    run shows every fault; raise at the end if any failed."""
    failed = []
    for name, fn in parts:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — recorded, raised below
            failed.append(name)
            print(f"!! {name} FAILED", flush=True)
            traceback.print_exc(file=sys.stdout)
        print(f"   {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"failed: {failed}")


def preference_run(run, torch, dev, native):
    import gc
    import shutil
    from dla_tpu_torch.data.jsonl import write_jsonl
    work = PREF_WORK
    try:
        gc.collect()
        torch.cuda.empty_cache()
        run.check((SFT_WORK / "ckpt" / "final" / "index.json").is_file(),
                  "the train phase's SFT checkpoint is there to start from")
        # the preference and RLHF phases read its parameters only
        _params_only(SFT_WORK / "ckpt" / "final")
        DISK.sample("SFT final's optimizer state dropped")
        print(f"   {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"allocated at the start", flush=True)
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        write_jsonl(work / "train.jsonl",
                    _pref_records(PREF_TRAIN_RECORDS, SEED))
        write_jsonl(work / "eval.jsonl",
                    _pref_records(PREF_EVAL_RECORDS, SEED + 1))
        _run_parts(run, [
            ("reward CLI", lambda: pref_cli(run, torch, dev, native,
                                            "reward", work)),
            ("DPO CLI", lambda: pref_cli(run, torch, dev, native, "dpo",
                                         work)),
            ("2-layer checks", lambda: pref_checks_2_layers(
                run, torch, dev, work))])
    finally:     # the SFT, reward and DPO finals stay for rlhf and distill
        for d in (work.iterdir() if work.is_dir() else ()):
            if d.name not in ("reward", "dpo"):
                shutil.rmtree(d) if d.is_dir() else d.unlink()


def _params_equal(torch, a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_params_equal(torch, a[k], b[k])
                                        for k in a)
    return a.dtype == b.dtype and torch.equal(a, b.to(a.device))


def pref_cli(run, torch, dev, native, phase: str, work: Path):
    """One preference CLI at full width and depth from the SFT checkpoint,
    its gates, its final checkpoint read back, then the steady-state step
    measured on the CLI's first batch."""
    import gc
    import shutil
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from dla_tpu_torch.training import train_dpo, train_reward
    from dla_tpu_torch.training.model_io import (build_reward_model,
                                                 load_causal_lm)
    micro_rows = RM_B if phase == "reward" else DPO_B
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    main_fn = train_reward.main if phase == "reward" else train_dpo.main
    trainer = main_fn(_pref_argv(phase, work), device="cuda")
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    counts = native.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_eval = PREF_STEPS // PREF_EVAL_EVERY * 8     # Trainer.run_eval: 8
    want = _pref_launches(phase, PREF_ACCUM * PREF_STEPS, n_eval)
    print(f"   {phase}: launches {counts}, expected {want} (per micro-step "
          f"and side: trained forward x2 under full remat, backward x1"
          f"{', reference forward x1' if phase == 'dpo' else ''}; + "
          f"{n_eval} eval batches)", flush=True)
    run.check(counts == want, f"{phase} launch counts equal the path's")

    log = work / phase / "logs" / "metrics.jsonl"
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    train_rows = [r for r in rows if "train/loss_instant" in r]
    eval_rows = [r for r in rows if "eval/loss" in r]
    keys = (("train/acc", "train/reward_margin") if phase == "reward" else
            ("train/preference_rate", "train/margin",
             "train/policy_chosen_logp"))
    series = {k: [r.get(k) for r in train_rows] for k in
              ("train/loss_instant", "train/grad_norm") + keys}
    series["eval"] = [v for r in eval_rows for k, v in r.items()
                      if k.startswith("eval/")]
    print(f"   {phase}: {json.dumps(series)}", flush=True)
    run.check(len(train_rows) == PREF_STEPS and len(eval_rows) ==
              PREF_STEPS // PREF_EVAL_EVERY and all(
                  x is not None and np.isfinite(x)
                  for v in series.values() for x in v),
              f"{phase}: losses, grad norms, metrics and eval finite")
    rate = "train/acc" if phase == "reward" else "train/preference_rate"
    run.check(all(0.0 <= x <= 1.0 for x in series[rate]),
              f"{phase}: {rate} in [0, 1]")
    if phase == "dpo":
        first = series["train/loss_instant"][0]
        run.check(abs(first - math.log(2)) <= 1e-4 and
                  series["train/margin"][0] == 0.0,
                  f"DPO step 1 (policy = reference): loss {first:.7f} within "
                  f"1e-4 of ln 2 and margin {series['train/margin'][0]} == 0")

    t_parts = {"cli": t_cli}
    t0 = time.perf_counter()
    final = work / phase / "ckpt" / "final"
    ckpt_gb = sum(f.stat().st_size for f in final.iterdir()) / 1e9
    cfg = {"tokenizer": "byte", "max_seq_length": PREF_T}
    if phase == "reward":
        back = build_reward_model({"base_model_name_or_path": str(final),
                                   **cfg}, device=dev).params
    else:
        back = load_causal_lm(str(final), cfg, device=dev).params
    DISK.sample(f"{phase} final saved")
    run.check(_params_equal(torch, back, trainer.params),
              f"{phase}: final/ loads back (through "
              f"{'build_reward_model' if phase == 'reward' else 'load_causal_lm'}"
              f") equal to the trained parameters")
    del back
    _params_only(final)       # later phases read its parameters only
    DISK.sample(f"{phase} final's optimizer state dropped")
    save_s = trainer.last_save_s

    t_parts["load_back"] = time.perf_counter() - t0

    # steady state: optimizer steps on the CLI's first batch
    t_steps = time.perf_counter()
    batch = _pref_batches(phase, work, 1)[0]
    real = int(sum(batch[s]["attention_mask"].sum()
                   for s in ("chosen", "rejected")))
    positions = int(sum(batch[s]["attention_mask"].size
                        for s in ("chosen", "rejected")))
    trainer.step_on_batch(batch)                 # warm
    torch.cuda.synchronize()
    steps_s = []
    for _ in range(3):
        native.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.step_on_batch(batch)
        torch.cuda.synchronize()
        steps_s.append(time.perf_counter() - t0)
    step_s = statistics.median(steps_s)
    per_step = native.launch_counts()
    run.check(per_step == _pref_launches(phase, PREF_ACCUM, 0),
              f"{phase}: one optimizer step launches "
              f"{_pref_launches(phase, PREF_ACCUM, 0)} ({per_step})")
    t_parts["steps"] = time.perf_counter() - t_steps
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step_on_batch(batch)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    events = prof.key_averages()        # built once: ~1e5 events a step
    per_name, dev_ms = _device_ms(events, 1)
    kinds = _device_ms_by_kind(per_name)
    by_op = sorted(_device_ms(events, 1, ops=True)[0].items(),
                   key=lambda kv: -kv[1])[:12]
    host = _host_profile(events)
    t_parts["profile"] = time.perf_counter() - t1
    n_params = sum(t.numel() for t in trainer.leaves)
    embed = trainer.params["embed"]["embedding"].numel()
    tied = "lm_head" not in trainer.params
    # parameters a position multiplies: the reward model never unembeds;
    # a tied causal LM unembeds with its embedding table
    n_mm = n_params - embed if (phase == "reward" or not tied) else n_params
    flops = 6 * n_mm * positions + (2 * n_mm * positions
                                    if phase == "dpo" else 0)
    rep = dict(
        cli_s=t_cli, part_s=t_parts, launches=counts,
        launches_per_step=per_step,
        series=series, n_params=n_params, n_params_per_position=n_mm,
        rows_per_step=micro_rows * PREF_ACCUM,
        positions_per_step=positions, real_tokens_per_step=real,
        padded_positions_per_step=positions - real,
        pad_share=(positions - real) / positions,
        optimizer_step_ms=step_s * 1e3,
        optimizer_steps_ms=[x * 1e3 for x in steps_s],
        real_tokens_per_s=real / step_s,
        model_flops_formula=("6 N per position of both sides (N = "
                             "parameters a position multiplies)"
                             + (" + 2 N per position for the reference "
                                "forward" if phase == "dpo" else "")
                             + ", attention excluded"),
        model_flops_share=flops / step_s / BF16_FLOP_PER_S,
        peak_mem_gib=peak, checkpoint_save_s=save_s, checkpoint_gb=ckpt_gb,
        profiled_step_ms=prof_s * 1e3,
        device_ms_per_step=dev_ms if dev_ms > 0 else "not measured",
        busy_share=dev_ms / (prof_s * 1e3) if dev_ms > 0 else
        "not measured",
        device_ms_by_kind=kinds, device_ms_by_op=by_op, **host,
        top=[(k[:60], v) for k, v in sorted(
            per_name.items(), key=lambda kv: -kv[1])[:8]])
    run.report[f"preference_{phase}"] = rep
    print(f"   {phase} " + json.dumps(rep), flush=True)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        entry = run.kernels.setdefault(name, {})
        entry[f"launches_{phase}"] = counts.get(name, 0)
        entry.setdefault("preference_shape", {})[
            f"launches_per_{phase}_step"] = per_step.get(name, 0)
    del trainer, batch, prof
    gc.collect()
    torch.cuda.empty_cache()


def _host_profile(events):
    """Host side of a profiled step (its ``key_averages()``): kernels
    launched on the card, ATen ops called, and the ops taking the most
    host time (self CPU ms)."""
    from torch.autograd import DeviceType
    kernels = ops = 0
    host = {}
    for ev in events:
        if ev.device_type != DeviceType.CPU:
            kernels += ev.count
        elif ev.key.startswith("aten::"):
            ops += ev.count
            host[ev.key] = ev.self_cpu_time_total / 1e3
    return dict(kernels_launched_per_step=kernels, aten_ops_per_step=ops,
                host_ms_by_op=sorted(host.items(), key=lambda kv: -kv[1])[:12])


def _pref_small(torch, dev, phase: str, layers: int, opt: dict, out_dir,
                seed=SEED, dtype=None):
    """(Trainer, model, loss factory) at ``layers`` of llama3.2-1b (full
    width, flash, full remat): the reward model (dropout 0.1 as
    configured) or a DPO policy over a frozen copy of itself, random
    init from ``seed``."""
    import dataclasses
    from dla_tpu_torch.models.config import get_model_config
    from dla_tpu_torch.models.reward import RewardModel
    from dla_tpu_torch.models.transformer import Transformer
    from dla_tpu_torch.training import train_dpo, train_reward
    from dla_tpu_torch.training.trainer import Trainer
    cfg = dataclasses.replace(get_model_config(
        SFT_MODEL, max_seq_length=PREF_T, attention="flash", remat="full"),
        num_layers=layers)
    config = {"seed": SEED, "optimization": opt,
              "logging": {"output_dir": str(out_dir), "log_dir": None}}
    if phase == "reward":
        model = RewardModel(cfg, dropout=0.1)
        params = model.init(_gen(torch, dev, seed))
        return Trainer(config=config, params=params,
                       loss_fn=train_reward.make_reward_loss(model)), model
    model = Transformer(cfg)
    params = model.init(_gen(torch, dev, seed))
    return Trainer(config=config, params=params, frozen=params,
                   loss_fn=train_dpo.make_dpo_loss(model, model, 0.1)), model


def _pref_opt(phase: str, **over):
    """The phase config's optimization block at this run's cuts."""
    return _config_opt(REWARD_CONFIG if phase == "reward" else DPO_CONFIG,
                       **{"gradient_accumulation_steps": PREF_ACCUM,
                          "max_train_steps": PREF_STEPS, **over})


def _side_scores(torch, phase, model, params, sides, n_segments=0):
    """Rewards or fused sequence log-probs of each side of a host batch,
    in micro-batches of the phase's size, no grad."""
    from dla_tpu_torch.ops.fused_ce import (model_fused_segment_logprob,
                                            model_fused_sequence_logprob)
    step = RM_B if phase == "reward" else DPO_B
    out = {}
    with torch.no_grad():
        for side in ("chosen", "rejected"):
            sub = {k: torch.from_numpy(v).to(params["final_norm"].device)
                   for k, v in sides[side].items()}
            parts = []
            for i in range(0, sub["input_ids"].shape[0], step):
                mb = {k: v[i:i + step] for k, v in sub.items()}
                if phase == "reward":
                    kw = ({"segment_ids": mb["segment_ids"],
                           "n_segments": n_segments} if n_segments else {})
                    parts.append(model.apply(params, mb["input_ids"],
                                             mb["attention_mask"], **kw))
                elif n_segments:
                    parts.append(model_fused_segment_logprob(
                        model, params, mb, n_segments))
                else:
                    parts.append(model_fused_sequence_logprob(
                        model, params, mb["input_ids"],
                        mb["attention_mask"]))
            out[side] = torch.cat(parts).float()
    return out


def pref_checks_2_layers(run, torch, dev, work):
    """At 2 layers of llama3.2-1b: each phase's loss gradients on the
    kernel path against the path through the kernels' plain versions
    (``PREF_GRAD_FACTOR`` x the bf16 noise floor: that path in bf16
    against fp32), packed scores
    against the same pairs unpacked (the same floor), an interrupted and
    resumed reward run (dropout on) against the uninterrupted one (losses
    equal), and a loss that falls on one repeated batch."""
    rep = {}
    run.report["preference_checks"] = rep
    _run_parts(run, [(f"{phase} gradients and packing, 2 layers",
                      lambda phase=phase: _pref_grads_and_packing(
                          run, torch, dev, work, phase, rep))
                     for phase in ("reward", "dpo")]
               + [("reward resume, 2 layers",
                   lambda: _pref_resume(run, torch, dev, work, rep))]
               + [(f"{phase} repeated batch, 2 layers",
                   lambda phase=phase: _pref_overfit(
                       run, torch, dev, work, phase, rep))
                  for phase in ("reward", "dpo")])


# the kernel path and the path through the kernels' plain versions round
# the forward's probabilities at different points (online softmax against
# the running max, against the final max): two bf16 evaluations, each its
# own distance from fp32, so up to sqrt(2) times that apart. A loss read
# at one position per row (last-token pooling) averages none of it away.
PREF_GRAD_FACTOR = math.sqrt(2.0)


def _pref_grads_and_packing(run, torch, dev, work, phase, rep):
    import dataclasses
    import gc
    from dla_tpu_torch.data.datasets import PreferenceDataset
    from dla_tpu_torch.data.packing import PackedPreferenceDataset
    from dla_tpu_torch.data.tokenizers import ByteTokenizer
    from dla_tpu_torch.models.reward import RewardModel
    from dla_tpu_torch.models.transformer import Transformer
    trainer, model = _pref_small(torch, dev, phase, 2, _pref_opt(phase),
                                 work / f"g_{phase}")
    params = trainer.params
    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    model32 = (RewardModel(cfg32, dropout=model.dropout)
               if phase == "reward" else Transformer(cfg32))
    rows = RM_B if phase == "reward" else DPO_B
    batch = _pref_batches(phase, work, 1)[0]
    mb = trainer._to_device({s: {k: v[:rows] for k, v in
                                 batch[s].items()}
                             for s in ("chosen", "rejected")})

    def loss_of(m):
        # the same dropout draws on every path: a generator seeded alike
        from dla_tpu_torch.training import train_dpo, train_reward
        if phase == "reward":
            fn = train_reward.make_reward_loss(m)
            return lambda v: fn(v, None, mb, _gen(torch, dev, 7))[0]
        fn = train_dpo.make_dpo_loss(m, m, 0.1)
        return lambda v: fn(v, params, mb, None)[0]
    lk, gk = _grads(torch, loss_of(model), params)
    with plain_kernels():
        lp, gp = _grads(torch, loss_of(model), params)
        l32, g32 = _grads(torch, loss_of(model32), params)
    print(f"   {phase} 2-layer loss kernels {lk:.6f}, plain {lp:.6f}, "
          f"plain fp32 {l32:.6f}", flush=True)
    worst = _grad_floor_check(run, torch, f"{phase} loss, 2 layers",
                              gk, gp, g32, PREF_GRAD_FACTOR)
    rep[f"{phase}_grad_check"] = dict(loss_kernels=lk, loss_plain=lp,
                                      loss_plain_fp32=l32,
                                      rel_err_vs_floor=worst)
    del gk, gp, g32

    # packed vs unpacked scores of the same 8 pairs: the phase's
    # shortest, so that rows hold several
    recs = sorted(_pref_records(PREF_TRAIN_RECORDS, SEED),
                  key=lambda r: len(r["prompt"]) + max(
                      len(r["chosen"]), len(r["rejected"])))[:8]
    ds = PreferenceDataset(ByteTokenizer(), PREF_T, records=recs)
    unpacked = ds.collate([ds[i] for i in range(len(ds))])
    packed_ds = PackedPreferenceDataset(ds, PREF_T)
    packed = packed_ds.collate([packed_ds[i]
                                for i in range(len(packed_ds))])
    n_seg = packed_ds.max_pairs
    alone = _side_scores(torch, phase, model, params, unpacked)
    in_rows = _side_scores(torch, phase, model, params, packed, n_seg)
    with plain_kernels():
        alone32 = _side_scores(torch, phase, model32, params, unpacked)
    res = {}
    for side in ("chosen", "rejected"):
        got = torch.stack([in_rows[side][r, j] for r, pairs in
                           enumerate(packed_ds.rows)
                           for j, _ in enumerate(pairs)])
        order = [i for pairs in packed_ds.rows for i in pairs]
        ref = alone[side][order]
        e = (got - ref).norm().item() / max(ref.norm().item(), 1e-30)
        floor = (alone[side] - alone32[side]).norm().item() / max(
            alone32[side].norm().item(), 1e-30)
        res[side] = (e, floor)
        run.check(e <= floor, f"{phase} 2 layers: packed {side} "
                  f"{'rewards' if phase == 'reward' else 'log-probs'} "
                  f"({len(packed_ds)} rows of up to {n_seg} pairs) vs "
                  f"the same 8 pairs unpacked: relative error {e:.3g} "
                  f"<= bf16 floor {floor:.3g}")
    rep[f"{phase}_packed_vs_unpacked"] = res
    del trainer, model, model32, params, mb
    gc.collect()
    torch.cuda.empty_cache()


def _pref_resume(run, torch, dev, work, rep):
    """Reward, interrupted at step 2 and resumed, against the
    uninterrupted run (dropout on)."""
    import gc
    batches = _pref_batches("reward", work, PREF_STEPS)
    a, _ = _pref_small(torch, dev, "reward", 2, _pref_opt("reward"),
                       work / "a")
    la = [a.step_on_batch(bt)[0] for bt in batches]
    del a
    b, _ = _pref_small(torch, dev, "reward", 2, _pref_opt("reward"),
                       work / "r")
    for bt in batches[:2]:
        b.step_on_batch(bt)
    b.save()
    del b
    c, _ = _pref_small(torch, dev, "reward", 2, _pref_opt("reward"),
                       work / "r", seed=SEED + 5)
    c.try_resume()
    lc = [c.step_on_batch(bt)[0] for bt in batches[2:]]
    del c
    gc.collect()
    torch.cuda.empty_cache()
    print(f"   reward 2-layer losses uninterrupted {la}, resumed steps 3-4 "
          f"{lc}", flush=True)
    rep["reward_resume"] = dict(uninterrupted=la, resumed=lc)
    run.check(lc == la[2:], "reward (dropout 0.1): resumed step 3-4 losses "
              "equal the uninterrupted run's")


def _pref_overfit(run, torch, dev, work, phase, rep):
    """Constant lr 1e-4 on one repeated micro-batch: the loss falls."""
    import gc
    rows = RM_B if phase == "reward" else DPO_B
    d, _ = _pref_small(torch, dev, phase, 2, _pref_opt(
        phase, learning_rate=1e-4, lr_scheduler="constant",
        warmup_steps=0, gradient_accumulation_steps=1,
        micro_batch_size=rows), work / f"d_{phase}")
    one = _pref_batches(phase, work, 1)[0]
    one = {s: {k: v[:rows] for k, v in one[s].items()}
           for s in ("chosen", "rejected")}
    ld = [d.step_on_batch(one)[0] for _ in range(10)]
    del d
    gc.collect()
    torch.cuda.empty_cache()
    print(f"   {phase} 2-layer, lr 1e-4, one micro-batch x 10 steps: "
          f"losses {ld}", flush=True)
    rep[f"{phase}_overfit"] = ld
    if phase == "reward":
        run.check(ld[-1] < 0.5 * ld[0], f"reward loss falls on a "
                  f"repeated batch ({ld[0]:.4f} -> {ld[-1]:.4f}, "
                  f"below half)")
    else:
        run.check(ld[-1] < ld[0] - 0.01, f"DPO loss falls on a "
                  f"repeated batch ({ld[0]:.4f} -> {ld[-1]:.4f}, by "
                  f"more than 0.01)")


# ----------------------------------------------------------------- distill

def _rlhf_argv(algo: str, work: Path):
    """config/rlhf_config.yaml chained as configured: policy and reference
    the SFT checkpoint's ``latest``, the reward model the preference
    phase's final; the byte tokenizer, flash on (a preset's default is
    the einsum), local prompts, and the run's cut: 2 rollouts (config:
    1024). gae adds int8 rollout weights and an int8 KV cache."""
    sft = str(SFT_WORK / "ckpt" / "latest")
    sets = {"model.policy_model_name_or_path": sft,
            "model.reference_model_name_or_path": sft,
            "model.tokenizer": "byte",
            "model.use_flash_attention": "true",
            "reward_model.path": str(PREF_WORK / "reward" / "ckpt" / "final"),
            "ppo.algo": algo,
            "ppo.steps": RLHF_ROLLOUTS,                        # config: 1024
            "sampling.source": "local",
            "sampling.prompt_path": str(work / "prompts.jsonl"),
            "logging.log_every_steps": 1,
            "logging.output_dir": str(work / algo / "ckpt"),
            "logging.log_dir": str(work / algo / "logs")}
    if algo == "gae":
        sets.update({"ppo.rollout_quantize_weights": "true",
                     "model.kv_cache_dtype": "int8"})
    argv = ["--config", str(RLHF_CONFIG)]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    return argv


def _rlhf_launches(algo: str):
    """Wrapper launches of one RLHF CLI run: per rollout the prefill (#1,
    and #5 on int8 weights, per layer), the decode step's eager first
    run and its capture (the draw; #4 and #5 with int8), the three
    scoring forwards (#1; #5 in the int8 policy's), and per optimizer
    step the policy's forward twice under full remat and its backward
    once (16 layers, one micro-step a minibatch)."""
    L = SFT_LAYERS
    updates = 1 if algo == "reinforce" else RLHF_PROMPTS // RLHF_MINI
    per = {"flash_attention_fwd": L + 3 * L + 2 * L * updates,
           "flash_attention_bwd_dq": L * updates,
           "flash_attention_bwd_dkv": L * updates,
           "categorical_draw": 2}
    if algo == "gae":     # tied embeddings: no int8 lm_head
        per["decode_attention"] = 2 * L
        per["int8_matmul"] = 3 * 7 * L + 7 * L
    return {k: v * RLHF_ROLLOUTS for k, v in per.items()}


def rlhf_run(run, torch, dev, native):
    import gc
    import shutil
    from dla_tpu_torch.data.jsonl import write_jsonl
    work = RLHF_WORK
    rep = {}
    run.report["rlhf"] = rep
    try:
        gc.collect()
        torch.cuda.empty_cache()
        sft = SFT_WORK / "ckpt" / "final" / "index.json"
        reward = PREF_WORK / "reward" / "ckpt" / "final" / "index.json"
        run.check(sft.is_file() and reward.is_file(),
                  "the SFT and reward checkpoints are there to start from")
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        write_jsonl(work / "prompts.jsonl",
                    _distill_prompts(RLHF_PROMPTS, SEED + 2))
        DISK.sample("rlhf start")
        _run_parts(run, [(f"{algo} CLI", lambda algo=algo: rlhf_cli(
            run, torch, dev, native, algo, work, rep))
            for algo in ("reinforce", "ppo", "gae")])
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(SFT_WORK, ignore_errors=True)
        rep["peak_disk_gb"] = DISK.peak_gb
        print(f"   peak disk use under build/ so far: {DISK.peak_gb:.1f} GB",
              flush=True)


def rlhf_cli(run, torch, dev, native, algo: str, work: Path, rep):
    """One RLHF CLI at full width and depth, its gates, its checkpoints
    read back; then the trained policy's rollout timed, traced and held
    against an eager loop."""
    import gc
    import shutil
    import numpy as np
    from dla_tpu_torch.checkpoint.checkpointer import load_tree_numpy
    from dla_tpu_torch.training import model_io, train_rlhf
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the last run reads the SFT checkpoint last: policy and reference
    with (_delete_once_read(train_rlhf, "load_causal_lm", SFT_WORK / "ckpt",
                            2) if algo == "gae" else contextlib.nullcontext()):
        trainer = train_rlhf.main(_rlhf_argv(algo, work), device="cuda")
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    counts = native.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = _rlhf_launches(algo)
    print(f"   {algo}: CLI {t_cli:.1f} s, peak {peak:.2f} GiB, launches "
          f"{counts}, expected {want}", flush=True)
    run.check(counts == want, f"rlhf {algo} launch counts equal the path's")
    rows = [json.loads(line) for line in (work / algo / "logs" /
                                          "metrics.jsonl").read_text()
            .splitlines()]
    rows = [r for r in rows if "train/kl" in r]
    stats = trainer.rollout_stats
    keys = ("train/loss", "train/kl", "train/kl_coef", "train/reward_mean",
            "train/rm_score_mean", "train/response_len",
            "train/zero_len_responses")
    grad_norms = [m["grad_norm"] for st in stats for m in st["metrics"]]
    clip = [m["clip_frac"] for st in stats for m in st["metrics"]
            if "clip_frac" in m]
    series = {k: [r.get(k) for r in rows] for k in keys}
    series.update(grad_norm=grad_norms, clip_frac=clip)
    print(f"   {algo}: {json.dumps(series)}", flush=True)
    run.check(len(rows) == RLHF_ROLLOUTS and all(
        x is not None and np.isfinite(x) for v in series.values()
        for x in v), f"rlhf {algo}: losses, KL, rewards and grad norms "
        "finite")
    run.check(all(0.0 <= c <= 1.0 for c in clip),
              f"rlhf {algo}: clip fractions in [0, 1]")
    if algo != "gae":    # policy = reference, same kernels, same inputs
        run.check(rows[0]["train/kl"] == 0.0, f"rlhf {algo}: the first "
                  f"rollout's KL is 0 exactly ({rows[0]['train/kl']})")
    if algo == "ppo":
        run.check(clip[0] == 0.0, "ppo: the first minibatch's clip "
                  f"fraction is 0 ({clip[0]})")
    ckpt = work / algo / "ckpt"
    final = ckpt / "final"
    ckpt_gb = sum(f.stat().st_size for d in ckpt.iterdir() if d.is_dir()
                  for f in d.iterdir()) / 1e9
    DISK.sample(f"rlhf {algo} checkpoints saved")
    t1 = time.perf_counter()
    policy = trainer.params["policy"] if algo == "gae" else trainer.params
    back = model_io.load_causal_lm(str(ckpt / "latest"),
                                   {"tokenizer": "byte"}, device="cpu")
    ok = _params_equal(torch, back.params, policy)
    if algo == "gae":
        tree, _ = load_tree_numpy(str(final), prefix="params")
        ok = ok and all(np.array_equal(
            tree["value_head"][k], trainer.params["value_head"][k].detach()
            .cpu().numpy()) for k in ("w", "b"))
    run.check(ok, f"rlhf {algo}: {'policy/ and final/' if algo == 'gae' else 'final/'}"
              " load back equal to the trained parameters")
    t_load = time.perf_counter() - t1
    model_cfg = back.config
    del back
    shutil.rmtree(ckpt, ignore_errors=True)
    DISK.sample(f"rlhf {algo} checkpoints read back and deleted")
    out = dict(cli_s=t_cli, load_back_s=t_load, launches=counts,
               peak_mem_gib=peak, checkpoint_gb=ckpt_gb,
               checkpoint_save_s=trainer.last_save_s, series=series,
               rollout_s=[st["rollout_s"] for st in stats],
               scoring_s=[st["score_s"] for st in stats],
               update_ms_per_step=[st["update_s"] * 1e3 / len(st["losses"])
                                   for st in stats],
               updates_per_rollout=len(stats[0]["losses"]))
    with torch.no_grad():
        out.update(_rlhf_rollout_measure(run, torch, dev, algo, policy,
                                         model_cfg, work))
    rep[algo] = out
    print(f"   rlhf {algo} " + json.dumps(out), flush=True)
    for name, n in counts.items():
        run.kernels.setdefault(name, {})[f"launches_rlhf_{algo}"] = n
    del trainer, policy
    gc.collect()
    torch.cuda.empty_cache()


def _rlhf_rollout_measure(run, torch, dev, algo, policy, model_cfg, work):
    """The trained policy's rollout tree as the CLI builds it, on the
    CLI's first prompts: prefill ms and a graphed generate (decode ms per
    step), one generate traced (device busy share: kernel time over the
    traced wall time), and, for reinforce, the graphed tokens and logps
    against an eager ``build_decode_step`` loop from the same key."""
    from torch.profiler import ProfilerActivity, profile
    from dla_tpu_torch.data.jsonl import read_jsonl
    from dla_tpu_torch.data.tokenizers import ByteTokenizer
    from dla_tpu_torch.generation.engine import (GenerationConfig,
                                                 build_generate_fn,
                                                 encode_prompt_batch)
    from dla_tpu_torch.models.transformer import Transformer
    from dla_tpu_torch.training.train_rlhf import PROMPT_TEMPLATE
    cfg = dataclasses.replace(
        model_cfg, attention="flash",
        kv_cache_dtype="int8" if algo == "gae" else model_cfg.kv_cache_dtype)
    model = Transformer(cfg)
    rp = model.quantize_weights(policy) if algo == "gae" else policy
    rp = model.activation_weights(rp)
    tok = ByteTokenizer()
    prompts = [PROMPT_TEMPLATE.format(prompt=r["prompt"]) for r in
               read_jsonl(work / "prompts.jsonl")][:RLHF_PROMPTS]
    width = cfg.max_seq_length - NEW
    ids, mask = (torch.from_numpy(a).to(dev) for a in
                 encode_prompt_batch(tok, prompts, width))
    gen = GenerationConfig(max_new_tokens=NEW, temperature=TEMPERATURE,
                           top_p=TOP_P, eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id)
    generate = build_generate_fn(model, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.start_decode(rp, ids, mask, NEW)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    del logits, cache
    t0 = time.perf_counter()
    out = generate(rp, ids, mask, _key(32))
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    steps = int(out["response_mask"].sum(0).gt(0).sum())  # EOS may end it
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(rp, ids, mask, _key(32))
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    from torch.autograd import DeviceType
    per_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            per_name[e.name()] = per_name.get(e.name(), 0.0) + \
                e.duration_ns() / 1e6
    del prof
    dev_ms = sum(per_name.values())
    res = dict(prefill_ms=t_pre * 1e3, generate_s=t_gen,
               decode_steps=steps,
               decode_ms_per_step=(t_gen - t_pre) * 1e3 / max(steps, 1),
               traced_generate_s=t_prof,
               rollout_busy_share=dev_ms / 1e3 / t_prof,
               rollout_device_ms_by_kind=_device_ms_by_kind(per_name),
               rollout_top=[(k[:60], v) for k, v in sorted(
                   per_name.items(), key=lambda kv: -kv[1])[:6]],
               response_tokens_mean=float(out["response_mask"].sum(1)
                                          .float().mean()))
    if algo == "reinforce":
        # the first 64 steps: a generate fn of that budget, graphed, and
        # the eager loop from the same key
        short = dataclasses.replace(gen, max_new_tokens=RLHF_EAGER_STEPS)
        out = build_generate_fn(model, short)(rp, ids, mask, _key(33))
        e_toks, e_lps = _eager_decode(torch, model, rp, ids, mask, short,
                                      _key(33), new=RLHF_EAGER_STEPS)
        live = out["response_mask"] > 0
        same = (torch.equal(out["response_tokens"], e_toks)
                and torch.equal(out["response_logps"], torch.where(
                    live, e_lps, torch.zeros_like(e_lps))))
        run.check(same, f"rlhf rollout: the graphed generate's tokens and "
                  f"logps ({RLHF_EAGER_STEPS} steps) equal an eager "
                  f"build_decode_step loop's from the same key")
    return res


def _distill_prompts(n: int, seed: int):
    """Prompts of 32..250 bytes (= byte-tokenizer tokens, inside the
    teacher CLI's 256-token prompt limit)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    return [{"prompt": "".join(rs.choice(_LETTERS, int(rs.randint(32, 251))))}
            for _ in range(n)]


def _distill_argv(mode: str, work: Path):
    """config/distill_config.yaml with the phi-2 preset student, flash
    on, the byte tokenizer, the phase's rollouts and this run's cuts
    (micro-batch 4 and 2048-token rows as configured); KL mode adds
    use_kl + on_policy, temperature 2 and the CE run's final checkpoint
    as the one teacher, with the student drawn from the next seed (the
    CE run's student barely moved inside the warmup: from the same
    draw the KL would start at ~0)."""
    sets = {"seed": SEED,
            "model.student_model_name_or_path": PHI_MODEL,
            "model.use_flash_attention": "true",
            "model.tokenizer": "byte",
            "data.teacher_samples_path": str(work / "teacher_rollouts.jsonl"),
            "hardware.gradient_accumulation_steps": DIS_ACCUM,  # config: 32
            "optimization.max_train_steps": DIS_STEPS,          # config: 4000
            "logging.log_every_steps": 1,
            "logging.output_dir": str(work / mode / "ckpt"),
            "logging.log_dir": str(work / mode / "logs")}
    if mode == "kl":   # a student from another seed than its teacher's
        sets.update({"seed": SEED + 1,
                     "distill.use_kl": "true", "distill.on_policy": "true",
                     "optimization.temperature": DIS_TEMPERATURE,
                     "distill.teacher_model_name_or_path":
                         str(work / "ce" / "ckpt" / "final")})
    argv = ["--config", str(DISTILL_CONFIG)]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    return argv


def _distill_batches(work: Path, n: int):
    """The first ``n`` global batches the CE CLI's iterator yields."""
    from dla_tpu_torch.data.tokenizers import ByteTokenizer
    from dla_tpu_torch.training.config import (config_from_args,
                                               make_arg_parser)
    from dla_tpu_torch.training.train_distill import build_train_iterator
    config = config_from_args(make_arg_parser("").parse_args(
        _distill_argv("ce", work)))
    it = iter(build_train_iterator(config, ByteTokenizer(), DIS_T,
                                   DIS_B * DIS_ACCUM))
    return [next(it) for _ in range(n)]


def _distill_launches(mode: str, micro_steps: int):
    """Wrapper launches of #1, #2, #3 per run of ``micro_steps``: the
    student's forward runs every layer twice (full remat) and its
    backward once; KL adds the teacher's forward (no grad: once)."""
    L = DIS_LAYERS
    return {"flash_attention_fwd": micro_steps * (3 if mode == "kl" else 2)
            * L,
            "flash_attention_bwd_dq": micro_steps * L,
            "flash_attention_bwd_dkv": micro_steps * L}


def distill_run(run, torch, dev, native):
    import gc
    import shutil
    from dla_tpu_torch.data.jsonl import write_jsonl
    work = DISTILL_WORK
    rep = {}
    run.report["distill"] = rep
    disk = DISK
    try:
        gc.collect()
        torch.cuda.empty_cache()
        finals = {p: PREF_WORK / p / "ckpt" / "final"
                  for p in ("reward", "dpo")}
        run.check(all((f / "index.json").is_file() for f in finals.values()),
                  "the preference phase's reward and DPO checkpoints are "
                  "there to start from")
        free = shutil.disk_usage(ROOT).free / 1e9
        print(f"   {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"allocated at the start; {free:.1f} GB free on disk",
              flush=True)
        rep["disk_free_gb_at_start"] = free
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        write_jsonl(work / "prompts.jsonl",
                    _distill_prompts(DIS_PROMPTS, SEED))
        disk.sample("start")
        _run_parts(run, [
            ("teacher rollouts", lambda: distill_rollouts(
                run, torch, dev, native, work, finals, rep, disk)),
            ("CE CLI", lambda: distill_cli(run, torch, dev, native, "ce",
                                           work, rep, disk)),
            ("KL CLI", lambda: distill_cli(run, torch, dev, native, "kl",
                                           work, rep, disk)),
            ("2-layer checks", lambda: distill_checks_2_layers(
                run, torch, dev, work, rep))])
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(PREF_WORK, ignore_errors=True)
        rep["peak_disk_gb"] = disk.peak_gb
        print(f"   peak disk use under build/: {disk.peak_gb:.1f} GB",
              flush=True)


def distill_rollouts(run, torch, dev, native, work, finals, rep, disk):
    """The teacher CLI on the DPO checkpoint with the reward checkpoint
    scoring each sequence; each batch runs the policy's prefill and the
    reward model's forward through #1 (the decode steps of a bf16 cache
    take the einsum path under ``decode_kernel: auto``)."""
    import shutil
    import numpy as np
    from dla_tpu_torch.training import generate_teacher_data
    out = work / "teacher_rollouts.jsonl"
    argv = ["--model_name_or_path", str(finals["dpo"]),
            "--reward_model_path", str(finals["reward"]),
            "--prompts_path", str(work / "prompts.jsonl"),
            "--output_path", str(out), "--max_new_tokens", str(DIS_NEW),
            "--seed", str(SEED)]
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate_teacher_data.main(argv, device="cuda")
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    shutil.rmtree(PREF_WORK, ignore_errors=True)     # read: not needed now
    disk.sample("rollouts written, preference checkpoints deleted")
    counts = native.launch_counts()
    batches = -(-DIS_PROMPTS // DIS_GEN_BATCH)
    want = {"flash_attention_fwd": 2 * SFT_LAYERS * batches,
            "categorical_draw": 2 * batches}
    print(f"   teacher CLI: {t_gen:.1f} s, launches {counts}, expected "
          f"{want} (per batch of {DIS_GEN_BATCH}: the prefill and the "
          f"reward forward, {SFT_LAYERS} layers each; the draw in the "
          f"decode step's eager first run and its capture)", flush=True)
    run.check(counts == want, "teacher generation launch counts equal the "
              "path's")
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    ok = len(rows) == DIS_PROMPTS and all(
        isinstance(r.get("prompt"), str) and isinstance(
            r.get("teacher_response"), str)
        and isinstance(r.get("reward"), float) and np.isfinite(r["reward"])
        for r in rows)
    run.check(ok, f"{len(rows)} rollouts, each with a prompt, a response "
              "and a finite reward")
    resp = [len(r["teacher_response"].encode()) for r in rows]
    prompt = [len(r["prompt"].encode()) for r in rows]
    rewards = [r["reward"] for r in rows]
    rep["rollouts"] = dict(
        seconds=t_gen, launches=counts, n=len(rows),
        prompt_bytes_mean=float(np.mean(prompt)),
        response_bytes_mean=float(np.mean(resp)),
        response_bytes_max=int(max(resp)),
        reward_mean=float(np.mean(rewards)),
        reward_std=float(np.std(rewards)))
    print(f"   rollouts: {json.dumps(rep['rollouts'])}", flush=True)


def _load_back_equal(torch, final: Path, trainer) -> bool:
    """``final/`` through ``load_causal_lm`` (on the host) equals the
    trainer's parameters, leaf by leaf."""
    from dla_tpu_torch.training.model_io import load_causal_lm
    back = load_causal_lm(str(final), {"tokenizer": "byte"},
                          device="cpu").params
    return _params_equal(torch, back, trainer.params)


def distill_cli(run, torch, dev, native, mode: str, work: Path, rep, disk):
    """One distill CLI at full width and depth, its gates, its final
    checkpoint read back, then steady-state steps on the CLI's first
    batch, timed and profiled."""
    import gc
    import shutil
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from dla_tpu_torch.training import train_distill
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # KL reads the CE run's final as its teacher, the last step that does
    with (_delete_once_read(train_distill, "load_teacher",
                            work / "ce" / "ckpt", 1)
          if mode == "kl" else contextlib.nullcontext()):
        trainer = train_distill.main(_distill_argv(mode, work),
                                     device="cuda")
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    counts = native.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = _distill_launches(mode, DIS_ACCUM * DIS_STEPS)
    print(f"   {mode}: CLI {t_cli:.1f} s, peak {peak:.2f} GiB, launches "
          f"{counts}, expected {want} (per micro-step and layer: student "
          f"forward x2 under full remat, backward x1"
          f"{', teacher forward x1' if mode == 'kl' else ''})", flush=True)
    run.check(counts == want, f"distill {mode} launch counts equal the "
              "path's")
    rows = [json.loads(line) for line in
            (work / mode / "logs" / "metrics.jsonl").read_text().splitlines()]
    rows = [r for r in rows if "train/loss_instant" in r]
    key = "train/ce" if mode == "ce" else "train/kl"
    series = {k: [r.get(k) for r in rows] for k in
              ("train/loss_instant", "train/grad_norm", "train/reward_mean",
               key)}
    print(f"   {mode}: {json.dumps(series)}", flush=True)
    run.check(len(rows) == DIS_STEPS and all(
        x is not None and np.isfinite(x) for v in series.values()
        for x in v), f"distill {mode}: losses, grad norms, reward_mean and "
        f"{key} finite")
    first = series[key][0]
    if mode == "ce":
        # random logits of std 0.02 * sqrt(2560) = 1.01 add ~0.5 to ln V
        ln_v = math.log(DIS_VOCAB)
        run.check(ln_v - 0.5 <= first <= ln_v + 1.0, f"first CE loss "
                  f"{first:.4f} near ln V = {ln_v:.4f} (in [ln V - 0.5, "
                  f"ln V + 1])")
    else:
        run.check(first >= 0.0, f"KL at step 1 {first:.6f} >= 0")
    final = work / mode / "ckpt" / "final"
    ckpt_gb = sum(f.stat().st_size for f in final.iterdir()) / 1e9
    disk.sample(f"{mode} final saved")
    t1 = time.perf_counter()
    run.check(_load_back_equal(torch, final, trainer),
              f"distill {mode}: final/ loads back (load_causal_lm) equal "
              "to the trained parameters")
    t_load = time.perf_counter() - t1
    if mode == "kl":       # read back: nothing reads it again
        shutil.rmtree(work / "kl" / "ckpt", ignore_errors=True)
        disk.sample("KL checkpoint deleted")

    t_steps = time.perf_counter()
    batch = _distill_batches(work, 1)[0]
    real = int(batch["attention_mask"].sum())
    positions = int(batch["attention_mask"].size)
    trainer.step_on_batch(batch)                 # warm
    torch.cuda.synchronize()
    steps_s = []
    for _ in range(2):
        native.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.step_on_batch(batch)
        torch.cuda.synchronize()
        steps_s.append(time.perf_counter() - t0)
    step_s = statistics.median(steps_s)
    per_step = native.launch_counts()
    run.check(per_step == _distill_launches(mode, DIS_ACCUM),
              f"distill {mode}: one optimizer step launches "
              f"{_distill_launches(mode, DIS_ACCUM)} ({per_step})")
    t_steps = time.perf_counter() - t_steps
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step_on_batch(batch)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    events = prof.key_averages()
    per_name, dev_ms = _device_ms(events, 1)
    kinds = _device_ms_by_kind(per_name)
    by_op = sorted(_device_ms(events, 1, ops=True)[0].items(),
                   key=lambda kv: -kv[1])[:12]
    host = _host_profile(events)
    t_prof = time.perf_counter() - t_prof
    n_params = sum(t.numel() for t in trainer.leaves)
    # parameters a position multiplies: all but the embedding table (the
    # lm_head is untied); the teacher is a phi-2 of the same size
    n_mm = n_params - trainer.params["embed"]["embedding"].numel()
    flops = (6 + (2 if mode == "kl" else 0)) * n_mm * positions
    out = dict(
        cli_s=t_cli, load_back_s=t_load, steps_s=t_steps, profile_s=t_prof,
        launches=counts,
        launches_per_step=per_step, series=series, n_params=n_params,
        n_params_per_position=n_mm, rows_per_step=DIS_B * DIS_ACCUM,
        positions_per_step=positions, real_tokens_per_step=real,
        pad_share=(positions - real) / positions,
        optimizer_step_ms=step_s * 1e3,
        optimizer_steps_ms=[x * 1e3 for x in steps_s],
        real_tokens_per_s=real / step_s,
        model_flops_formula="6 N per position" + (
            " + 2 N per teacher position" if mode == "kl" else "")
        + " (N = parameters a position multiplies), attention excluded",
        model_flops_share=flops / step_s / BF16_FLOP_PER_S,
        peak_mem_gib=peak, checkpoint_save_s=trainer.last_save_s,
        checkpoint_gb=ckpt_gb, profiled_step_ms=prof_s * 1e3,
        device_ms_per_step=dev_ms if dev_ms > 0 else "not measured",
        busy_share=dev_ms / (prof_s * 1e3) if dev_ms > 0 else
        "not measured",
        device_ms_by_kind=kinds, device_ms_by_op=by_op, **host,
        top=[(k[:60], v) for k, v in sorted(
            per_name.items(), key=lambda kv: -kv[1])[:8]])
    rep[mode] = out
    print(f"   distill {mode} " + json.dumps(out), flush=True)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        entry = run.kernels.setdefault(name, {})
        entry[f"launches_distill_{mode}"] = counts.get(name, 0)
        entry.setdefault("distill_shape", {})[
            f"launches_per_{mode}_step"] = per_step.get(name, 0)
    del trainer, batch, prof, events
    gc.collect()
    torch.cuda.empty_cache()


def _phi_small(torch, dev, mode: str, layers: int, opt: dict, out_dir,
               seed=SEED, attention="flash"):
    """(Trainer, model) at ``layers`` of phi-2 (full width, remat full)
    with the distill loss of ``mode``: KL against a phi of the same
    shape drawn from ``seed + 100``."""
    import dataclasses
    from dla_tpu_torch.models.config import get_model_config
    from dla_tpu_torch.models.transformer import Transformer
    from dla_tpu_torch.training import train_distill
    from dla_tpu_torch.training.trainer import Trainer
    cfg = dataclasses.replace(get_model_config(
        PHI_MODEL, max_seq_length=DIS_T, attention=attention, remat="full"),
        num_layers=layers)
    model = Transformer(cfg)
    params = model.init(_gen(torch, dev, seed))
    kl = mode == "kl"
    frozen = ({"teacher_0": model.init(_gen(torch, dev, seed + 100))}
              if kl else None)
    config = {"seed": SEED, "optimization": opt,
              "logging": {"output_dir": str(out_dir), "log_dir": None}}
    loss = train_distill.make_distill_loss(
        model, [model] if kl else [], kl, DIS_TEMPERATURE if kl else 1.0)
    return Trainer(config=config, params=params, frozen=frozen,
                   loss_fn=loss), model


def _distill_opt(**over):
    """config/distill_config.yaml's optimization block at this run's
    cuts."""
    return _config_opt(DISTILL_CONFIG, **{
        "gradient_accumulation_steps": DIS_ACCUM,
        "max_train_steps": DIS_STEPS, **over})


def distill_checks_2_layers(run, torch, dev, work, rep):
    """At 2 layers of phi-2 on the CLI's batches: each mode's per-leaf
    gradients on the kernel path against the path through the kernels'
    plain versions (``PREF_GRAD_FACTOR`` x the bf16 floor, as the
    preference check), the einsum route's loss against the flash
    route's, an interrupted and resumed CE run against the uninterrupted
    one, and a CE loss that falls on one repeated micro-batch."""
    checks = {}
    rep["checks_2_layers"] = checks
    batches = _distill_batches(work, DIS_STEPS)
    _run_parts(run, [(f"{mode} gradients, 2 layers",
                      lambda mode=mode: _distill_grads(
                          run, torch, dev, work, mode, batches[0], checks))
                     for mode in ("ce", "kl")]
               + [("CE resume, 2 layers", lambda: _distill_resume(
                   run, torch, dev, work, batches, checks)),
                  ("CE repeated batch, 2 layers", lambda: _distill_overfit(
                      run, torch, dev, work, batches[0], checks))])


def _distill_grads(run, torch, dev, work, mode, batch, checks):
    import dataclasses
    import gc
    from dla_tpu_torch.models.transformer import Transformer
    from dla_tpu_torch.training import train_distill
    trainer, model = _phi_small(torch, dev, mode, 2, _distill_opt(),
                                work / f"g_{mode}")
    params, frozen = trainer.params, trainer.frozen
    mb = trainer._to_device({k: v[:DIS_B] for k, v in batch.items()})
    kl = mode == "kl"
    temp = DIS_TEMPERATURE if kl else 1.0

    def loss_of(m):
        fn = train_distill.make_distill_loss(m, [m] if kl else [], kl, temp)
        return lambda v: fn(v, frozen, mb, None)[0]
    model32 = Transformer(dataclasses.replace(model.cfg, dtype="float32"))
    lk, gk = _grads(torch, loss_of(model), params)
    with plain_kernels():
        lp, gp = _grads(torch, loss_of(model), params)
        l32, g32 = _grads(torch, loss_of(model32), params)
    print(f"   distill {mode} 2-layer loss kernels {lk:.6f}, plain "
          f"{lp:.6f}, plain fp32 {l32:.6f}", flush=True)
    # the k bias moves every score of a query alike outside the rotary
    # dims, so its exact gradient there is 0 and what the leaf carries is
    # mostly the rounding of bf16 dS: the preference gate's sqrt(2)
    worst = _grad_floor_check(run, torch, f"distill {mode} loss, 2 layers",
                              gk, gp, g32, PREF_GRAD_FACTOR)
    out = dict(loss_kernels=lk, loss_plain=lp, loss_plain_fp32=l32,
               rel_err_vs_floor=worst)
    if mode == "ce":       # the einsum route on the same rows
        xla = Transformer(dataclasses.replace(model.cfg, attention="xla"))
        with torch.no_grad():
            lx = float(loss_of(xla)(params))
        e = abs(lx - lk) / abs(l32)
        out["loss_einsum"] = lx
        run.check(e <= 5e-3, f"distill ce 2 layers: einsum-route loss "
                  f"{lx:.6f} vs flash-route {lk:.6f}: relative {e:.3g} <= "
                  f"5e-3")
    checks[f"{mode}_grad_check"] = out
    del trainer, model, model32, params, frozen, gk, gp, g32, mb
    gc.collect()
    torch.cuda.empty_cache()


def _distill_resume(run, torch, dev, work, batches, checks):
    """CE, interrupted at step 2 and resumed, against the uninterrupted
    run: losses equal."""
    import gc
    a, _ = _phi_small(torch, dev, "ce", 2, _distill_opt(), work / "a")
    la = [a.step_on_batch(bt)[0] for bt in batches]
    del a
    b, _ = _phi_small(torch, dev, "ce", 2, _distill_opt(), work / "r")
    for bt in batches[:2]:
        b.step_on_batch(bt)
    b.save()
    del b
    c, _ = _phi_small(torch, dev, "ce", 2, _distill_opt(), work / "r",
                      seed=SEED + 5)
    c.try_resume()
    lc = [c.step_on_batch(bt)[0] for bt in batches[2:]]
    del c
    gc.collect()
    torch.cuda.empty_cache()
    print(f"   distill ce 2-layer losses uninterrupted {la}, resumed steps "
          f"3-4 {lc}", flush=True)
    checks["ce_resume"] = dict(uninterrupted=la, resumed=lc)
    run.check(lc == la[2:], "distill ce: resumed step 3-4 losses equal "
              "the uninterrupted run's")


def _distill_overfit(run, torch, dev, work, batch, checks):
    """Constant lr 1e-4 on one repeated micro-batch: the CE loss falls."""
    import gc
    d, _ = _phi_small(torch, dev, "ce", 2, _distill_opt(
        learning_rate=1e-4, lr_scheduler="constant", warmup_steps=0,
        gradient_accumulation_steps=1), work / "d")
    one = {k: v[:DIS_B] for k, v in batch.items()}
    ld = [d.step_on_batch(one)[0] for _ in range(10)]
    del d
    gc.collect()
    torch.cuda.empty_cache()
    print(f"   distill ce 2-layer, lr 1e-4, one micro-batch x 10 steps: "
          f"losses {ld}", flush=True)
    checks["ce_overfit"] = ld
    run.check(ld[-1] < ld[0] - 0.5, f"distill CE loss falls on a repeated "
              f"batch ({ld[0]:.4f} -> {ld[-1]:.4f}, by more than 0.5)")


if __name__ == "__main__":
    sys.exit(main())
