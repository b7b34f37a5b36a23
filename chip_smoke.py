#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dla_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure fails the run; the phases all run so one call shows
every fault, and the result lines are printed only when all passed):

1. build   — compile the CUDA kernels from ``dla_tpu_torch/csrc`` (nvcc,
             sm_90a, one process per source) and print the build time,
             ptxas resource usage, a summary line per flash-backward
             kernel (registers, spills, dynamic shared memory) and, where
             ``cuobjdump`` exists, the HGMMA (wgmma) count of each
             kernel's SASS;
2. parity  — hold each kernel against its plain PyTorch version on the
             card at the paths' shapes: flash forward at T=128 (rollout),
             decode attention over an int8 cache of S=384 with the fill
             mid-chunk and NaN past it, the int8 matmul at M=64 and M=8192
             for every projection and lm_head; the flash backward (dQ,
             dK/dV) at the SFT shape with packed segments, with a window,
             at ragged T=77, at head_dim 128 and at head_dim 96 (packed
             segments and a window), and the
             autograd Function's gradients against autograd through the
             plain forward;
3. timing  — CUDA-event medians of each kernel, its plain version and a
             one-call PyTorch yardstick, beside the least time the card
             could take (bytes / 3.35 TB/s vs FLOPs / 989 TFLOP/s); the
             flash forward, dQ and dK/dV also at the SFT shape, the
             backward kernels also with packed segment ids (bound from
             the live pairs of those ids);
4. slice   — llama3-8b at full width and depth (random weights from a
             seed): flash attention, int8 KV, int8 weight tree, then
             build_generate_fn with the RLHF config's sampling (B=64
             prompts of width 128, 256 new tokens, temperature 0.7,
             top_p 0.9, no EOS). Launch counts must equal the path's
             expected counts, outputs must be well formed, and the logits
             of the prefill and 4 decode steps must match the same model
             running the plain versions (4 layers);
5. train   — ``dla_tpu_torch.training.train_sft.main`` on
             config/sft_config.yaml with llama3.2-1b at full width and
             depth (random init, byte tokenizer, flash + full remat, fp32
             params, bf16 activations, packing into 2048-token rows,
             micro-batch 4), cut to grad accumulation 4 and 4 steps, eval
             every 2 steps, final save into build/ (timed, then deleted).
             Launch counts must equal the path's, losses and grad norms
             be finite and the first loss near ln V. Then, at 2 layers:
             every leaf's gradient on the kernel path against the plain
             path (judged against the bf16 noise floor), an interrupted
             and resumed run's step 3-4 losses against the uninterrupted
             run's, and a loss that falls on one repeated batch.

Last lines: the card's name and power limit (nvidia-smi), a JSON line of
per-kernel numbers, and ``{"ok": true, "device": {...}}``. Exits non-zero
without a result when no CUDA device is visible or the package is
missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak
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

# the rollout path's shapes (llama3-8b, config/rlhf_config.yaml)
B, PROMPT, NEW = 64, 128, 256
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
        run.report["flash_bwd_build"] = flash_bwd_build_summary(
            log, path, _native)

    with run.phase("parity"):
        parity(run, torch, dev)

    with run.phase("timing"):
        timing(run, torch, dev)

    with run.phase("slice"):
        slice_run(run, torch, dev, _native)

    with run.phase("train"):
        train_run(run, torch, dev, _native)

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
                           "int8_matmul") if k not in run.kernels]
    if missing:
        print(f"chip_smoke: no numbers for {missing}", flush=True)
        return 1
    print(smi)
    print(json.dumps({"kernels": list(run.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def flash_bwd_build_summary(log: str, lib_path: Path, native):
    """Per flash-backward kernel instantiation: ptxas registers and spill
    bytes (from the build log), dynamic shared memory per block (asked of
    the library) and, where ``cuobjdump`` exists, the HGMMA (wgmma)
    instructions in its SASS. Printed one line each."""
    import re
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
        m = re.search(r"(flash_bwd_(?:dq|dkv)_kernel)ILi(\d+)E", mangled)
        if not m:
            continue
        name = f"{m[1]}<{m[2]}>"
        smem = lib.dla_flash_bwd_smem_bytes(int("dkv" in m[1]), int(m[2]))
        row = dict(registers=st.get("registers"), spill_bytes=st.get("spill"),
                   dynamic_smem_bytes=smem,
                   hgmma=hgmma.get(mangled) if hgmma else "no cuobjdump")
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
                   g_rows=HEADS // KV_HEADS, d=HD, int8=True):
    """Decode inputs at cache length s, valid columns < fill (70% of
    them), NaN planted in the scales (int8) or values (bf16) past it."""
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
    for label, shape, extra in cases:
        q, k, v = _flash_inputs(torch, dev, g, **shape)
        kw = {}
        if extra == "segwin":
            seg = torch.ones((q.shape[0], q.shape[1]), dtype=torch.int32,
                             device=dev)
            seg[:, 40:] = 2
            seg[:, 90:] = 0
            kw = dict(segment_ids=seg, window=24)
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

    # decode attention: bf16 outputs of |x| < ~1 -> 2e-2
    for label, kw in [
            ("path B64 S384 int8 fill 300 (mid-chunk), NaN past fill",
             dict(fill=300)),
            ("bf16 cache fill 150, NaN past fill, D256 g8",
             dict(fill=150, b=4, kh=2, g_rows=8, d=256, int8=False)),
            ("int8 fill 1 (self column + one)", dict(fill=1, b=8)),
            ("int8 head_dim 96 (phi3-mini) fill 100", dict(
                fill=100, b=4, kh=4, g_rows=1, d=96))]:
        inp = _decode_inputs(torch, dev, g, **kw)
        out = _call_decode(dk.flash_decode_attention, inp)
        ref = _call_decode(dk.flash_decode_attention_plain, inp)
        torch.cuda.synchronize()
        e = (out.float() - ref.float()).abs().max().item()
        run.check(e <= 2e-2 and torch.isfinite(out.float()).all().item(),
                  f"decode {label}: max|err| {e:.3g} <= 2e-2")
        errs.setdefault("decode_attention", e)
    inp = _decode_inputs(torch, dev, g, fill=200, b=8)
    cap = dict(logit_softcap=30.0)
    out = dk.flash_decode_attention(
        inp["q"], inp["k_cache"], inp["v_cache"], inp["k_new"], inp["v_new"],
        bias=inp["bias"], k_scale=inp["k_scale"], v_scale=inp["v_scale"],
        kv_fill=200, **cap)
    ref = dk.flash_decode_attention_plain(
        inp["q"], inp["k_cache"], inp["v_cache"], inp["k_new"], inp["v_new"],
        bias=inp["bias"], k_scale=inp["k_scale"], v_scale=inp["v_scale"],
        kv_fill=200, **cap)
    e = (out.float() - ref.float()).abs().max().item()
    run.check(e <= 2e-2, f"decode softcap 30: max|err| {e:.3g} <= 2e-2")

    # int8 matmul: one bf16 rounding of fp32 sums in another order -> at
    # most ~1 bf16 ulp: max|err| <= 1e-2 * max|ref|
    worst = 0.0   # max absolute error over the path's shapes
    shapes = [(64, k, n) for (k, n) in PROJ.values()] + [(64, HID, VOCAB)]
    shapes += [(B * PROMPT, k, n) for (k, n) in PROJ.values()]
    path_shapes = set(shapes)
    shapes += [(130, HID, 4096), (5, 256, 48)]   # ragged M and N
    for m, k, n in dict.fromkeys(shapes):
        x, w, sc = _int8_inputs(torch, dev, g, m, k, n)
        out = qm.int8_matmul(x, w, sc)
        ref = qm.int8_matmul_plain(x, w, sc)
        torch.cuda.synchronize()
        e = (out.float() - ref.float()).abs().max().item()
        tol = 1e-2 * ref.float().abs().max().item()
        run.check(e <= tol, f"int8_matmul M{m} K{k} N{n}: max|err| {e:.3g} "
                  f"<= {tol:.3g}")
        if (m, k, n) in path_shapes:
            worst = max(worst, e)
        del x, w, sc, out, ref
    errs["int8_matmul"] = worst
    parity_backward(run, torch, dev, g, errs)
    run.report["parity_max_err"] = errs


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
        per_shape.append(dict(proj=name, M=m, K=k, N=n, ms=t_k, plain_ms=t_p,
                              library_ms=t_l, bound_ms=bms, bound_by=by))
        print(f"   int8_matmul {name:7s} M{m:5d} K{k:5d} N{n:6d}: "
              f"{t_k:.4f} ms (bound {bms:.4f} {by}, torch.matmul "
              f"{t_l:.4f}, plain {t_p:.4f})", flush=True)

    def total(rows, field):
        return sum(r[field] * (1 if r["proj"] == "lm_head" else LAYERS)
                   for r in rows)

    step = [r for r in per_shape if r["M"] == 64]
    pre = [r for r in per_shape if r["M"] != 64] + \
        [r for r in step if r["proj"] == "lm_head"]
    by_step = ("bytes" if sum(r["bound_by"] == "bytes" for r in step)
               * 2 >= len(step) else "operations")
    run.kernels["int8_matmul"] = dict(
        name="int8_matmul", route="cuda",
        source="dla_tpu_torch/csrc/int8_matmul.cu",
        replaces="dla_tpu/ops/quant_matmul.py:86", launches=None,
        max_abs_err=run.report.get("parity_max_err", {}).get("int8_matmul"),
        ms=total(step, "ms"), plain_ms=total(step, "plain_ms"),
        bound_ms=total(step, "bound_ms"), bound_by=by_step,
        library_ms=total(step, "library_ms"),
        unit="one decode step: 7 projections x 32 layers + lm_head at "
             "M=64 (225 launches); max_abs_err over the path's M=64 and "
             "M=8192 shapes")
    run.report["int8_matmul_shapes"] = per_shape
    run.report["int8_matmul_prefill"] = {
        f: total(pre, f) for f in ("ms", "plain_ms", "library_ms",
                                   "bound_ms")}
    run.report["timing_work"] = timings
    for kname, kv in run.kernels.items():
        print(f"   {kname}: {kv['ms']:.4f} ms vs bound {kv['bound_ms']:.4f} "
              f"({kv['bound_by']}), library {kv['library_ms']:.4f}, plain "
              f"{kv['plain_ms']:.4f} [{kv['unit']}]", flush=True)
    print(f"   int8_matmul per prefill: {run.report['int8_matmul_prefill']}")
    timing_sft(run, torch, dev, g)


def timing_sft(run, torch, dev, g):
    """Flash forward, dQ and dK/dV at the SFT shape (B=4, T=2048, H=32,
    KH=8, D=64; causal, no segments, so the causal count below is the
    work the inputs need and SDPA computes the same function). One
    causal T x T x D product is 2 * B * H * D * T(T+1)/2 FLOPs: the
    forward does 2, dQ 3 (S, dP, dS K) and dK/dV 4 (S, dP, P^T dO,
    dS^T Q). dQ reads q, dO, O (for delta), k, v and lse and writes dq
    and delta; dK/dV reads q, dO, k, v, lse and delta and writes dk, dv.
    The backward kernels are timed again with the packed segment ids of
    ``_segments`` (the train phase's kind of input; no library call
    computes it). Their bound counts the products over the live pairs
    of this run's ids only (k <= q and equal ids, about a fifth of the
    causal pairs), plus the ids; the causal count stays beside it as
    ``bound_causal_ms``."""
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
    rows["fwd"] = dict(
        ms=t_fwd, plain_ms=t_pf, library_ms=t_lf,
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(2 * qb + 2 * kvb + rowb, 2 * mm))),
        unit="one launch: one layer of an SFT micro-step, B4 T2048 H32 "
             "KH8 D64, causal")
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
            ms=t_k, plain_ms=t_pb_p, library_ms=None,
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
    del sets, lib
    torch.cuda.empty_cache()


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
    gen = GenerationConfig(max_new_tokens=NEW, temperature=0.7, top_p=0.9,
                           do_sample=True, eos_token_id=-1, pad_token_id=0)
    generate = build_generate_fn(model, gen)

    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(params, ids, mask, _gen(torch, dev, SEED + 7))
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = native.launch_counts()
    want = {"flash_attention_fwd": LAYERS, "decode_attention": LAYERS * NEW,
            "int8_matmul": (7 * LAYERS + 1) * (1 + NEW)}
    print(f"   launches {counts}, expected {want}")
    run.check(counts == want, "launch counts equal the path's counts")
    for name in want:
        if name in run.kernels:
            run.kernels[name]["launches"] = counts.get(name, 0)

    toks, lps = out["response_tokens"], out["response_logps"]
    run.check(tuple(toks.shape) == (B, NEW) and tuple(
        out["sequences"].shape) == (B, PROMPT + NEW), "output shapes")
    run.check(bool(((toks >= 0) & (toks < VOCAB)).all()), "token ids in vocab")
    run.check(bool(torch.isfinite(lps).all()) and bool((lps <= 0).all()),
              "response logps finite and <= 0")
    run.check(bool((out["lengths"] == mask.sum(1) + NEW).all()),
              "lengths = prompt + 256")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # steady-state timing: prefill alone, then a second full generate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.start_decode(params, ids, mask, NEW)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    del logits, cache
    t0 = time.perf_counter()
    generate(params, ids, mask, _gen(torch, dev, SEED + 8))
    torch.cuda.synchronize()
    t_gen2 = time.perf_counter() - t0
    dec = (t_gen2 - t_pre) / NEW
    slice_rep = dict(
        prefill_ms=t_pre * 1e3, decode_ms_per_step=dec * 1e3,
        generate_s_first=t_gen, generate_s=t_gen2,
        tokens_per_s=B * NEW / t_gen2, decode_tokens_per_s=B / dec,
        peak_mem_gib=peak, launches=counts)
    run.report["slice"] = slice_rep
    print("   slice " + json.dumps(slice_rep), flush=True)

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
                   slice_rep["decode_ms_per_step"])


OUR_KERNELS = ("int8_mm_kernel", "int8_mm_finalize", "flash_fwd_kernel",
               "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
               "decode_chunk_kernel", "decode_merge_kernel")


def _device_ms(prof, n: int, ops: bool = False):
    """(device ms per iteration by kernel name, total) from a profile of
    ``n`` iterations. With ``ops``, the names are instead the ATen ops
    whose own launches took that device time (kernels attributed to the
    op that launched them)."""
    from torch.autograd import DeviceType
    per_name = {}
    for ev in prof.key_averages():
        if ops != (ev.device_type == DeviceType.CPU) or (
                ops and not ev.key.startswith("aten::")):
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            per_name[ev.key] = per_name.get(ev.key, 0.0) + t / 1e3 / n
    return per_name, sum(per_name.values())


def profile_decode(run, torch, model, params, ids, mask, gen, step_ms):
    """Device time of three engine decode steps (sampling + decode_step)
    from torch.profiler's CUDA activity, against the unprofiled wall
    time per step: the device's busy share of a decode step."""
    from torch.profiler import ProfilerActivity, profile

    from dla_tpu_torch.generation.engine import build_decode_step
    step = build_decode_step(model, gen)
    g = _gen(torch, ids.device, SEED + 9)
    logits, cache = model.start_decode(params, ids, mask, 8)
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
    ours = sum(v for k, v in per_name.items()
               if any(o in k for o in OUR_KERNELS))
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    rep = dict(device_ms_per_step=dev_ms if dev_ms > 0 else "not measured",
               port_kernels_ms_per_step=ours,
               busy_share=(dev_ms / step_ms) if dev_ms > 0 else
               "not measured",
               top=[(k[:60], v) for k, v in top])
    run.report["decode_profile"] = rep
    print("   decode profile " + json.dumps(rep), flush=True)


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


def _sft_opt(**over):
    """config/sft_config.yaml's optimization block at this run's cuts."""
    from dla_tpu_torch.training.config import load_config
    opt = dict(load_config(SFT_CONFIG)["optimization"])
    opt.pop("total_batch_size")
    opt.update(micro_batch_size=SFT_B, gradient_accumulation_steps=SFT_ACCUM,
               max_train_steps=SFT_STEPS)
    opt.update(over)
    return opt


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
    save_s = trainer.last_save_s
    shutil.rmtree(work / "ckpt")

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
    loss, _ = trainer.loss_fn(trainer.train_params, mb)
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
    kinds = {}     # device ms per optimizer step by kind of kernel
    for k, v in per_name.items():
        kind = ("port attention kernels" if any(o in k for o in OUR_KERNELS)
                else "matmul (cuBLAS)" if any(m in k for m in (
                    "nvjet", "gemm", "xmma", "cutlass", "sm90_"))
                else "elementwise / reduce / copy (PyTorch)")
        kinds[kind] = kinds.get(kind, 0.0) + v
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
    shutil.rmtree(work, ignore_errors=True)


def _grads(torch, model, params, mb):
    """{leaf name: fp32 gradient} of the SFT loss on one micro-batch, the
    autograd leaves being per-layer views (the Trainer's)."""
    from dla_tpu_torch.ops.fused_ce import model_fused_ce
    from dla_tpu_torch.training.trainer import _train_views
    views = _train_views(params)
    named = {"embed": views["embed"]["embedding"],
             "final_norm": views["final_norm"]}
    for i, layer in enumerate(views["layers"]):
        named.update({f"layers.{i}.{k}": t for k, t in layer.items()})
    for t in named.values():
        t.requires_grad_(True)
        t.grad = None
    loss, _ = model_fused_ce(model, views, mb)
    loss.backward()
    out = {k: t.grad.float().clone() for k, t in named.items()}
    loss = loss.detach()
    for t in named.values():
        t.grad = None
    return float(loss), out


def train_checks_2_layers(run, torch, dev, work):
    import dataclasses
    from dla_tpu_torch.models.transformer import Transformer

    batches = _sft_batches(work, SFT_STEPS)

    # gradients, kernels vs plain versions vs plain with fp32 activations
    trainer, model = _small_trainer(torch, dev, 2, _sft_opt(), work / "g")
    params = trainer.params
    mb = {k: torch.from_numpy(v[:SFT_B]).to(dev)
          for k, v in batches[0].items()}
    lk, gk = _grads(torch, model, params, mb)
    with plain_versions():
        lp, gp = _grads(torch, model, params, mb)
        l32, g32 = _grads(torch, Transformer(dataclasses.replace(
            model.cfg, dtype="float32")), params, mb)
    worst = {}
    for name in gk:
        ref = gp[name].norm().item()
        e = (gk[name] - gp[name]).norm().item() / max(ref, 1e-30)
        floor = (gp[name] - g32[name]).norm().item() / max(
            g32[name].norm().item(), 1e-30)
        worst[name] = (e, floor)
    bad = {k: v for k, v in worst.items() if not v[0] <= v[1]}
    top = sorted(worst.items(),
                 key=lambda kv: -kv[1][0] / max(kv[1][1], 1e-30))[:4]
    print(f"   2-layer loss kernels {lk:.6f}, plain {lp:.6f}, plain fp32 "
          f"{l32:.6f}; per-leaf relative gradient error (kernels vs plain, "
          f"plain bf16 vs fp32), worst ratios: {top}", flush=True)
    run.report["train_grad_check"] = dict(
        loss_kernels=lk, loss_plain=lp, loss_plain_fp32=l32,
        rel_err_vs_floor=worst)
    run.check(not bad, f"every leaf's gradient on the kernel path is as "
              f"close to the plain path as bf16 is to fp32 ({len(worst)} "
              f"leaves; over the floor: {sorted(bad)})")
    del trainer, model, params, gk, gp, g32, mb
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


if __name__ == "__main__":
    sys.exit(main())
