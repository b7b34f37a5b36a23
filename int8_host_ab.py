"""Host cost of the int8 matmul wrapper on the decode path, two trees in
alternating processes.

A rollout decode step calls ``dla_tpu_torch.ops.quant_matmul.int8_matmul``
225 times at M = 64 (llama3-8b: 7 projections in each of 32 layers, then
the lm_head), and the step is host-bound, so the wrapper's host time per
call sets much of the step time. This script times that call sequence in
two checkouts of the repository (for example a parent commit and a
change), one process at a time in the order A B, B A, A B, ... so that
drift on the machine falls on both trees alike.

Each process imports ``dla_tpu_torch`` from its tree (built there at
first use), makes one layer's int8 weights and the lm_head from a seed,
and runs the 225-call sequence as one "step" per repetition: it waits for
the card to drain before each step (so no launch waits for queue room),
times each wrapper call on the host clock, then synchronizes. It prints
one JSON line: the median host microseconds per call, the median host
milliseconds per step (the sum of the calls), the median wall
milliseconds per step (first call to the end of the synchronize), and,
for the largest projection, the host microseconds of the tree's C launch
function for the decode's M = 64 called with ready arguments (what the
wrapper's Python adds is the rest).

With ``--decode-pairs N`` it then runs N more pairs of processes that
each drive the whole rollout decode as ``chip_smoke.py`` does (llama3-8b
at full width, int8 weights from a seed, batch 64, 128-token prompts,
256 new tokens, through the tree's ``build_generate_fn``: eager steps,
or one CUDA graph where the tree has it) and print the decode
milliseconds per step, the median over ``DECODE_REPS`` generates of
(generate - prefill) / 256, and the rollout tokens per second.

Run it on a machine with one CUDA card:

    python3 int8_host_ab.py TREE_A TREE_B [--pairs 10] [--decode-pairs 4]
        [--out FILE]

Each line goes to stdout and, with ``--out``, to FILE as JSON lines; the
last line is a summary with both trees' medians and the per-pair
differences (B minus A).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HID, FFN, KV, VOCAB, LAYERS, M = 4096, 14336, 1024, 128256, 32, 64
LAYER = [(HID, HID), (HID, KV), (HID, KV), (HID, HID), (HID, FFN),
         (HID, FFN), (FFN, HID)]   # (K, N) of wq wk wv wo gate up down
STEPS, WARMUP = 20, 3
DECODE_REPS = 3


def worker(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    from dla_tpu_torch.ops import _native
    from dla_tpu_torch.ops import quant_matmul as qm
    assert Path(qm.__file__).resolve().is_relative_to(tree.resolve()), \
        qm.__file__
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def weights(k, n):
        w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        return w, torch.rand((n,), generator=g, device=dev) * 3e-4 + 1e-5

    layer = [weights(k, n) for k, n in LAYER]
    head = weights(HID, VOCAB)
    x_h = torch.randn((M, HID), generator=g, device=dev).to(torch.bfloat16)
    x_f = torch.randn((M, FFN), generator=g, device=dev).to(torch.bfloat16)
    calls = [(x_f if k == FFN else x_h, w, s)
             for _ in range(LAYERS) for (k, _), (w, s) in zip(LAYER, layer)]
    calls.append((x_h, *head))
    _native.library()
    per_call, step_host, step_wall = [], [], []
    for rep in range(WARMUP + STEPS):
        torch.cuda.synchronize()
        times = []
        t0 = time.perf_counter()
        for x, w, s in calls:
            a = time.perf_counter()
            qm.int8_matmul(x, w, s)
            times.append(time.perf_counter() - a)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rep >= WARMUP:
            per_call += times
            step_host.append(sum(times))
            step_wall.append(wall)
    # the C launch alone, ready arguments, largest projection (gate), in
    # the tree's own decode entry point: the split-K kernel of the first
    # port (one K split: 224 output tiles of 64 x 64) or the cluster
    # kernel with the tree's plan
    w, s = layer[4]
    out = torch.empty((M, FFN), dtype=torch.bfloat16, device=dev)
    lib, stream = _native.library(), _native.stream_handle(dev)
    ptrs = (x_h.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr())
    if "dla_int8_matmul_decode" in _native._SIGNATURES:
        p = qm.plan(M, FFN, HID, _native.sm_count(dev))
        fn = lib.dla_int8_matmul_decode
        args = (*ptrs, M, FFN, HID, p.tile_n, p.splits, stream)
    else:
        part = torch.empty((1,), dtype=torch.float32, device=dev)
        fn = lib.dla_int8_matmul
        args = (*ptrs, part.data_ptr(), M, FFN, HID, 1, stream)
    launch = []
    for rep in range(WARMUP + STEPS):
        torch.cuda.synchronize()
        for _ in range(100):
            a = time.perf_counter()
            fn(*args)
            launch.append(time.perf_counter() - a)
    torch.cuda.synchronize()
    return {"tree": str(tree), "calls_per_step": len(calls),
            "host_us_per_call": statistics.median(per_call) * 1e6,
            "host_ms_per_step": statistics.median(step_host) * 1e3,
            "wall_ms_per_step": statistics.median(step_wall) * 1e3,
            "c_launch_us": statistics.median(launch[WARMUP * 100:]) * 1e6}


def _rng(torch, dev, seed: int):
    """The generate fn's last argument in the tree under test: a threefry
    key where the tree has ``ops/prng.py``, else (an older tree) a torch
    generator."""
    try:
        from dla_tpu_torch.ops import prng
    except ImportError:
        return torch.Generator(device=dev).manual_seed(seed)
    return prng.PRNGKey(seed)


def decode_worker(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from dla_tpu_torch.generation.engine import (GenerationConfig,
                                                 build_generate_fn)
    from dla_tpu_torch.ops import _native
    from dla_tpu_torch.training.model_io import load_causal_lm
    dev = torch.device("cuda", 0)
    _native.library()
    bundle = load_causal_lm(
        "llama3-8b", {"attention": "flash", "kv_cache_dtype": "int8",
                      "dtype": "bfloat16", "param_dtype": "bfloat16",
                      "tokenizer": "byte"},
        torch.Generator(device=dev).manual_seed(0), device=dev)
    model = bundle.model
    params = model.quantize_weights(bundle.params)
    del bundle
    torch.cuda.empty_cache()
    b, prompt, new = 64, 128, 256
    rs = np.random.RandomState(0)
    ids = rs.randint(3, VOCAB, (b, prompt)).astype(np.int32)
    lens = rs.randint(prompt // 2, prompt + 1, b)
    lens[0] = prompt
    mask = (np.arange(prompt)[None, :] < lens[:, None]).astype(np.int32)
    ids = torch.from_numpy(ids * mask).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    generate = build_generate_fn(model, GenerationConfig(
        max_new_tokens=new, temperature=0.7, top_p=0.9, do_sample=True,
        eos_token_id=-1, pad_token_id=0))
    generate(params, ids, mask, _rng(torch, dev, 7))
    steps, rates = [], []
    for i in range(DECODE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.start_decode(params, ids, mask, new)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        t0 = time.perf_counter()
        generate(params, ids, mask, _rng(torch, dev, 8 + i))
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        steps.append((t_gen - t_pre) / new * 1e3)
        rates.append(b * new / t_gen)
    return {"tree": str(tree), "decode_ms_per_step": statistics.median(steps),
            "decode_ms_per_step_each": steps,
            "tokens_per_s": statistics.median(rates)}


def _pairs(trees, n: int, flag: str, rows: dict, sinks) -> int:
    """n pairs of worker processes, A B then B A alternately; rows[j]
    gets tree j's JSON lines. Returns the count of failed processes."""
    failed = 0
    for i in range(n):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            r = subprocess.run(
                [sys.executable, __file__, flag, str(trees[j])],
                capture_output=True, text=True, timeout=900)
            if r.returncode != 0:
                print(r.stdout + r.stderr, file=sys.stderr)
                failed += 1
                continue
            row = json.loads(r.stdout.strip().splitlines()[-1])
            row.update(pair=i, side="AB"[j])
            rows[j].append(row)
            for f in sinks:
                print(json.dumps(row), file=f, flush=True)
    return failed


def _compare(rows: dict, keys, summary: dict) -> None:
    for k in keys:
        for j in (0, 1):
            summary[f"{'AB'[j]}_{k}_median"] = statistics.median(
                r[k] for r in rows[j]) if rows[j] else None
        by_pair = {r["pair"]: r[k] for r in rows[0]}
        summary[f"B_minus_A_{k}"] = [
            round(r[k] - by_pair[r["pair"]], 3)
            for r in rows[1] if r["pair"] in by_pair]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--decode-pairs", type=int, default=0)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--decode-worker", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker)), flush=True)
        return 0
    if a.decode_worker:
        print(json.dumps(decode_worker(a.decode_worker)), flush=True)
        return 0
    if len(a.trees) != 2:
        ap.error("give two trees")
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sinks = [sys.stdout] + ([a.out.open("w")] if a.out else [])
    rows, drows = {0: [], 1: []}, {0: [], 1: []}
    failed = _pairs(a.trees, a.pairs, "--worker", rows, sinks)
    failed += _pairs(a.trees, a.decode_pairs, "--decode-worker", drows,
                     sinks)
    summary = {"pairs": a.pairs, "decode_pairs": a.decode_pairs,
               "failed": failed}
    _compare(rows, ("host_us_per_call", "host_ms_per_step",
                    "wall_ms_per_step", "c_launch_us"), summary)
    if a.decode_pairs:
        _compare(drows, ("decode_ms_per_step", "tokens_per_s"), summary)
    for f in sinks:
        print(json.dumps({"summary": summary}), file=f, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
