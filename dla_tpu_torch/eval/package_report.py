"""Packaging, the pipeline's sixth phase (``dla_tpu.eval.package_report``):
a run's JSONL metrics, the eval's artifacts (``results.json``,
``summary.md``, ``latency.json``) and generation samples in one report
directory:

    report/
      report.md            # headline numbers and links
      metrics_<k>.png      # one curve per plotted metric
      samples.md           # qualitative generations (when given)

    python -m dla_tpu_torch.eval.package_report \
        --metrics logs/metrics.jsonl [--eval-dir logs/eval] \
        [--samples data/rollouts.jsonl] --output report/

Curves need matplotlib, imported only where one is drawn. Where it
cannot be imported (the GPU machine has none), ``report.md`` names the
curves that were not drawn and why, and the report is otherwise the
same.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

PLOT_KEYS = ("train/loss", "eval/loss", "tokens_per_sec_per_chip",
             "train/kl", "train/reward_mean", "eval/acc",
             "train/preference_rate")


def iter_jsonl(path, limit: Optional[int] = None):
    """Yield parsed rows lazily, skipping torn lines of killed runs;
    ``limit`` stops reading early (sample files can be large)."""
    n = 0
    with Path(path).open() as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue
            n += 1
            if limit is not None and n >= limit:
                return


def read_metrics(path) -> List[Dict[str, Any]]:
    return list(iter_jsonl(path))


def _series(rows, key):
    xs, ys = [], []
    for r in rows:
        if key in r and "step" in r:
            xs.append(r["step"])
            ys.append(float(r[key]))
    return xs, ys


def _pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError where
    matplotlib is not installed."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_metric(rows, key, out_png) -> bool:
    """Draw ``key`` against step into ``out_png``; False when it has
    fewer than two points."""
    xs, ys = _series(rows, key)
    if len(xs) < 2:
        return False
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 3.2), dpi=120)
    ax.plot(xs, ys, lw=1.5)
    ax.set_xlabel("step")
    ax.set_ylabel(key)
    ax.set_title(key)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return True


def _fmt(v) -> str:
    return f"{v:.4g}" if isinstance(v, float) else str(v)


def _curve_lines(rows, out: Path) -> List[str]:
    """The report's curves section: each drawable metric plotted, or,
    without matplotlib, a section naming the curves not drawn."""
    plotted, undrawn, why = [], [], ""
    for key in PLOT_KEYS:
        fname = "metrics_" + key.replace("/", "_") + ".png"
        if why:
            if len(_series(rows, key)[0]) >= 2:
                undrawn.append(key)
            continue
        try:
            if plot_metric(rows, key, out / fname):
                plotted.append((key, fname))
        except ImportError as e:
            why = f"matplotlib cannot be imported ({e})"
            undrawn.append(key)
    lines: List[str] = []
    if plotted:
        lines += ["## Curves", ""]
        for key, fname in plotted:
            lines += [f"![{key}]({fname})", ""]
    if undrawn:
        lines += ["## Curves not drawn", "",
                  f"{why}; not drawn: " + ", ".join(undrawn) + ".", ""]
    return lines


def _eval_lines(ed: Path) -> List[str]:
    lines: List[str] = []
    results = ed / "results.json"
    if results.is_file():
        lines += ["## Alignment eval", ""]
        data = json.loads(results.read_text())
        # perplexity benchmarks have none of the heuristic fields: their
        # own table, as in the eval's summary.md
        heur = [(m, b, s) for m, benches in data.items()
                for b, s in benches.items() if "perplexity" not in s]
        ppl = [(m, b, s) for m, benches in data.items()
               for b, s in benches.items() if "perplexity" in s]
        if heur:
            lines += ["| model | benchmark | avg_length | refusal_rate "
                      "| toxicity_proxy |", "|---|---|---|---|---|"]
            for model, bench, s in heur:
                lines.append(
                    f"| {model} | {bench} | {_fmt(s.get('avg_length'))}"
                    f" | {_fmt(s.get('refusal_rate'))} | "
                    f"{_fmt(s.get('toxicity_proxy'))} |")
            lines.append("")
        if ppl:
            lines += ["| model | benchmark | perplexity | nll "
                      "| n_tokens |", "|---|---|---|---|---|"]
            for model, bench, s in ppl:
                lines.append(
                    f"| {model} | {bench} | {_fmt(s.get('perplexity'))}"
                    f" | {_fmt(s.get('nll'))} | "
                    f"{_fmt(s.get('n_tokens'))} |")
            lines.append("")
    latency = ed / "latency.json"
    if latency.is_file():
        data = json.loads(latency.read_text())
        lines += ["## Latency", "",
                  "```json", json.dumps(data, indent=1)[:4000], "```", ""]
    summary = ed / "summary.md"
    if summary.is_file():
        lines += ["## Eval summary", "", summary.read_text(), ""]
    return lines


def _write_samples(samples_path, out: Path) -> None:
    sm = ["# Qualitative samples", ""]
    for i, row in enumerate(iter_jsonl(samples_path, limit=21)):
        if i >= 20:
            sm.append(f"*(truncated; more in {samples_path})*")
            break
        resp = (row.get("teacher_response") or row.get("response")
                or row.get("chosen") or "")
        sm += [f"## Sample {i}", f"**Prompt:** {row.get('prompt', '')}", "",
               f"**Response:** {resp}", ""]
        if row.get("reward") is not None:
            sm += [f"**Reward:** {_fmt(float(row['reward']))}", ""]
    (out / "samples.md").write_text("\n".join(sm))


def write_report(metrics_path, eval_dir, samples_path, out_dir,
                 title: str = "Training run report") -> Path:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    lines = [f"# {title}", ""]
    rows = read_metrics(metrics_path) if metrics_path else []
    if rows:
        lines += ["## Final metrics", "",
                  "| metric | last value |", "|---|---|"]
        lines += [f"| {k} | {_fmt(rows[-1][k])} |" for k in sorted(rows[-1])
                  if k != "time"]
        lines.append("")
        lines += _curve_lines(rows, out)
    if eval_dir:
        lines += _eval_lines(Path(eval_dir))
    if samples_path and Path(samples_path).is_file():
        _write_samples(samples_path, out)
        lines += ["## Samples", "", "See [samples.md](samples.md).", ""]
    report = out / "report.md"
    report.write_text("\n".join(lines))
    return report


def main(argv: Optional[list] = None) -> Path:
    ap = argparse.ArgumentParser(
        description="Package a run's metrics/evals/samples into a report")
    ap.add_argument("--metrics", help="logs/metrics.jsonl from a trainer")
    ap.add_argument("--eval-dir", help="logs/eval dir with results.json/"
                                       "summary.md/latency.json")
    ap.add_argument("--samples", help="JSONL of generations "
                                      "(e.g. teacher rollouts)")
    ap.add_argument("--output", required=True, help="report directory")
    ap.add_argument("--title", default="Training run report")
    args = ap.parse_args(argv)
    report = write_report(args.metrics, args.eval_dir, args.samples,
                          args.output, args.title)
    print(f"[dla_tpu_torch] wrote {report}")
    return report


if __name__ == "__main__":
    main()
