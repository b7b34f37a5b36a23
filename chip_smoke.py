#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dla_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure fails the run; the phases all run so one call shows
every fault, and the result lines are printed only when all passed):

1. build   — compile the CUDA kernels from ``dla_tpu_torch/csrc`` (nvcc,
             sm_90a) and print the build time and ptxas resource usage;
2. parity  — hold each kernel against its plain PyTorch version on the
             card at the rollout path's shapes (llama3-8b widths, B=64):
             flash forward at T=128, decode attention over an int8 cache
             of S=384 with the fill mid-chunk and NaN past it, the int8
             matmul at M=64 and M=8192 for every projection and lm_head;
3. timing  — CUDA-event medians of each kernel, its plain version and a
             one-call PyTorch yardstick, beside the least time the card
             could take (bytes / 3.35 TB/s vs FLOPs / 989 TFLOP/s);
4. slice   — llama3-8b at full width and depth (random weights from a
             seed): flash attention, int8 KV, int8 weight tree, then
             build_generate_fn with the RLHF config's sampling (B=64
             prompts of width 128, 256 new tokens, temperature 0.7,
             top_p 0.9, no EOS). Launch counts must equal the path's
             expected counts, outputs must be well formed, and the logits
             of the prefill and 4 decode steps must match the same model
             running the plain versions (4 layers).

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
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("   " + line.strip())

    with run.phase("parity"):
        parity(run, torch, dev)

    with run.phase("timing"):
        timing(run, torch, dev)

    with run.phase("slice"):
        slice_run(run, torch, dev, _native)

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
    missing = [k for k in ("flash_attention_fwd", "decode_attention",
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
    run.report["parity_max_err"] = errs


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
               "decode_chunk_kernel", "decode_merge_kernel")


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
    from torch.autograd import DeviceType
    per_name = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # op rows repeat kernel time
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            per_name[ev.key] = per_name.get(ev.key, 0.0) + t / 1e3 / n
    dev_ms = sum(per_name.values())
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


if __name__ == "__main__":
    sys.exit(main())
