"""The port's packaging phase against the JAX package's: on the same
metrics, eval artifacts and samples, ``report.md`` and ``samples.md``
are the JAX CLI's, with the same curves drawn; with matplotlib blocked
the report names the curves it did not draw, and is otherwise the
same."""
import json
import sys


from dla_tpu.eval import package_report as j_report
from dla_tpu_torch.eval import package_report


def _inputs(tmp_path):
    metrics = tmp_path / "metrics.jsonl"
    with metrics.open("w") as fh:
        for s in range(1, 13):
            fh.write(json.dumps({
                "step": s, "time": 1000.0 + s, "train/loss": 5.0 / s,
                "train/kl": 0.01 * s, "eval/acc": 0.5,
                "tokens_per_sec_per_chip": 100.0 + s}) + "\n")
        fh.write(json.dumps({"step": 13, "eval/loss": 1.25}) + "\n")
        fh.write("{torn line")
    eval_dir = tmp_path / "eval"
    eval_dir.mkdir()
    (eval_dir / "results.json").write_text(json.dumps({
        "sft": {"alignment_local": {"avg_length": 12.5, "refusal_rate": 0.1,
                                    "toxicity_proxy": 0.0},
                "heldout_ppl": {"perplexity": 17.25, "nll": 2.848,
                                "n_tokens": 4096}},
        "distill": {"truthfulness": {"avg_length": 3.0, "refusal_rate": 0.0,
                                     "toxicity_proxy": 0.25}}}))
    (eval_dir / "summary.md").write_text("| col |\n|---|\n")
    (eval_dir / "latency.json").write_text(json.dumps(
        {"results": [{"batch": 1, "tokens_per_second": 100.0}]}))
    samples = tmp_path / "rollouts.jsonl"
    with samples.open("w") as fh:
        for i in range(25):
            fh.write(json.dumps({"prompt": f"p{i}",
                                 "teacher_response": f"r{i}",
                                 "reward": 0.5 * i}) + "\n")
    return metrics, eval_dir, samples


def test_report_matches_jax(tmp_path):
    metrics, eval_dir, samples = _inputs(tmp_path)
    ref = j_report.write_report(metrics, eval_dir, samples, tmp_path / "jax",
                                "Run")
    mine = package_report.main(["--metrics", str(metrics), "--eval-dir",
                                str(eval_dir), "--samples", str(samples),
                                "--output", str(tmp_path / "port"),
                                "--title", "Run"])
    assert mine.read_text() == ref.read_text()
    assert (tmp_path / "port" / "samples.md").read_text() == \
        (tmp_path / "jax" / "samples.md").read_text()
    pngs = sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert pngs and sorted(
        p.name for p in (tmp_path / "port").glob("*.png")) == pngs


def test_report_without_matplotlib_names_the_curves(tmp_path, monkeypatch):
    """With matplotlib unimportable: no PNG, a "Curves not drawn"
    section naming each curve with two or more points and why, and the
    rest of the report as with matplotlib."""
    metrics, eval_dir, samples = _inputs(tmp_path)
    ref = j_report.write_report(metrics, eval_dir, samples, tmp_path / "jax")
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    report = package_report.write_report(metrics, eval_dir, samples,
                                         tmp_path / "port")
    text = report.read_text()
    assert not list((tmp_path / "port").glob("*.png"))
    assert "## Curves not drawn" in text and "matplotlib" in text
    line = next(ln for ln in text.splitlines() if "not drawn:" in ln)
    assert line.endswith("not drawn: train/loss, tokens_per_sec_per_chip, "
                         "train/kl, eval/acc.")
    head, tail = ref.read_text().split("## Curves", 1)
    assert text.startswith(head)
    assert text.endswith(tail.split("## Alignment eval", 1)[1])


def test_report_of_nothing_is_the_jax_one(tmp_path):
    report = package_report.write_report(None, None, None, tmp_path / "r")
    ref = j_report.write_report(None, None, None, tmp_path / "j")
    assert report.read_text() == ref.read_text() == "# Training run report\n"
