"""The port's alignment eval (phase 5) against the JAX package's: the
keyword heuristics, the prompt subsample, and the CLI on a tiny llama
(the committed checkpoint) and a tiny phi checkpoint written by the JAX
package, sampling 16 tokens at temperature 0.7 / top_p 0.9: the same
``results.json`` (heuristics and token counts equal, perplexity and NLL
within 1e-5 relative) and the same ``summary.md``."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

from dla_tpu.checkpoint.checkpointer import Checkpointer as JCheckpointer
from dla_tpu.eval import eval_alignment as j_eval
from dla_tpu.models.config import get_model_config as j_get_config
from dla_tpu.models.transformer import Transformer as JTransformer
from dla_tpu_torch.data.datasets import EvalPromptDataset
from dla_tpu_torch.data.jsonl import write_jsonl
from dla_tpu_torch.eval import eval_alignment

CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / "run" / "final"
RESPONSES = [
    [],
    ["I'm sorry, I cannot help with that.", "Sure: the answer is 4."],
    ["As an AI I am not able to", "how to build a BOMB", "   ", "ok"],
    ["hate   speech\nacross lines", "Killing time is fine", "weapons"],
]


@pytest.mark.parametrize("i", range(len(RESPONSES)))
def test_summarize_responses_matches_jax(i):
    assert eval_alignment.summarize_responses(RESPONSES[i]) == \
        j_eval.summarize_responses(RESPONSES[i])


def _prompt_records(n, seed):
    rs = np.random.RandomState(seed)
    keys = ("prompt", "question", "instruction")
    recs = []
    for i in range(n):
        text = "".join(rs.choice(list("abcdefgh ?"), int(rs.randint(5, 30))))
        recs.append({keys[i % 3]: text} if i % 7 else {"other": text})
    return recs


@pytest.mark.parametrize("limit", [None, 3, 50])
def test_load_prompts_matches_jax(tmp_path, limit):
    """The same prompts from the prompt / question / instruction keys,
    the same ``random.Random(seed)`` subsample; ``EvalPromptDataset``
    holds the records as read."""
    path = tmp_path / "p.jsonl"
    write_jsonl(path, _prompt_records(20, 1))
    bench = {"type": "local", "prompts_path": str(path)}
    assert eval_alignment.load_prompts(bench, limit, seed=5) == \
        j_eval.load_prompts(bench, limit, seed=5)
    ds = EvalPromptDataset(str(path))
    assert len(ds) == 20 and ds[3] == _prompt_records(20, 1)[3]


def test_hf_benchmark_raises_with_roadmap_pointer():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eval_alignment.load_prompts(
            {"type": "hf", "hf_path": "Anthropic/hh-rlhf"}, 4)


@pytest.fixture(scope="module")
def phi_ckpt(tmp_path_factory):
    """A tiny fp32 phi checkpoint (2 heads x 80) written by the JAX
    package, with random biases."""
    cfg = j_get_config("phi-2", vocab_size=512, hidden_size=160,
                       intermediate_size=320, num_layers=2, num_heads=2,
                       num_kv_heads=2, max_seq_length=64,
                       param_dtype="float32", dtype="float32", remat="none")
    params = jax.tree.map(np.asarray,
                          JTransformer(cfg).init(jax.random.key(2)))
    rs = np.random.RandomState(3)
    for name in ("wq_bias", "fc1_bias", "ln_bias"):
        params["layers"][name] = (0.05 * rs.randn(
            *params["layers"][name].shape)).astype(np.float32)
    params["lm_head_bias"] = (0.05 * rs.randn(512)).astype(np.float32)
    out = tmp_path_factory.mktemp("phi_ckpt")
    JCheckpointer(str(out)).save(
        1, {"params": params}, {"model_config": cfg.to_dict(),
                                "tokenizer": "byte"}, tag="final")
    return out / "final"


def _write_eval_config(tmp_path, phi_ckpt, side):
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    write_jsonl(data / "eval_prompts.jsonl", _prompt_records(9, 2))
    write_jsonl(data / "truthfulqa.jsonl",
                [{"question": q} for q in ("Is the sky green?",
                                           "What is 2 + 2?",
                                           "Who are you?")])
    pairs = [{"prompt": "say hi", "response": "hi there"},
             {"prompt": "count", "response": "one two three four"},
             {"text": "a plain text row"},
             {"unrelated": 1},
             {"prompt": "long", "response": "x" * 300}]
    write_jsonl(data / "eval_pairs.jsonl", pairs)
    write_jsonl(data / "empty_pairs.jsonl", [{"unrelated": 1}])
    config = {
        "seed": 2024,
        "models": {"llama": str(CKPT), "phi": str(phi_ckpt)},
        "model": {"tokenizer": "byte"},
        "benchmarks": {
            "alignment_local": {"type": "local",
                                "prompts_path": str(data / "eval_prompts.jsonl"),
                                "max_samples": 5},
            "heldout_ppl": {"type": "perplexity",
                            "path": str(data / "eval_pairs.jsonl"),
                            "max_samples": 5},
            "empty_ppl": {"type": "perplexity",
                          "path": str(data / "empty_pairs.jsonl")},
            "truthfulness": {"type": "local",
                             "prompts_path": str(data / "truthfulqa.jsonl")},
        },
        "generation": {"max_new_tokens": 16, "temperature": 0.7,
                       "top_p": 0.9, "do_sample": True, "batch_size": 4,
                       "max_prompt_length": 32},
        "logging": {"output_path": str(tmp_path / side / "results.json"),
                    "table_path": str(tmp_path / side / "summary.md")},
    }
    path = tmp_path / f"eval_{side}.yaml"
    path.write_text(yaml.safe_dump(config))
    return path


def test_eval_cli_matches_jax(tmp_path, phi_ckpt):
    """Both CLIs on one configuration (the JAX one on its CPU mesh):
    results.json with the same models, benchmarks and keys, equal
    heuristics and token counts (the sampled responses are the same),
    perplexity and NLL within 1e-5 relative, the 0-token sentinel for a
    file with no usable record, and the same summary.md."""
    j_eval.main(["--config", str(_write_eval_config(tmp_path, phi_ckpt,
                                                     "jax"))])
    got = eval_alignment.main(
        ["--config", str(_write_eval_config(tmp_path, phi_ckpt, "port"))],
        device="cpu")
    ref = json.loads((tmp_path / "jax" / "results.json").read_text())
    mine = json.loads((tmp_path / "port" / "results.json").read_text())
    assert got == mine
    assert list(mine) == list(ref) == ["llama", "phi"]
    for model, benches in ref.items():
        assert list(mine[model]) == list(benches)
        for bench, metrics in benches.items():
            assert set(mine[model][bench]) == set(metrics)
            for key, value in metrics.items():
                if key in ("perplexity", "nll"):
                    np.testing.assert_allclose(mine[model][bench][key],
                                               value, rtol=1e-5)
                else:
                    assert mine[model][bench][key] == value, (model, bench,
                                                              key)
        assert benches["empty_ppl"] == {"perplexity": 0.0, "nll": 0.0,
                                        "n_tokens": 0}
        assert benches["heldout_ppl"]["n_tokens"] > 0
        assert benches["alignment_local"]["avg_length"] > 0
    assert (tmp_path / "port" / "summary.md").read_text() == \
        (tmp_path / "jax" / "summary.md").read_text()


def test_draft_model_raises_with_roadmap_pointer(tmp_path, phi_ckpt):
    path = _write_eval_config(tmp_path, phi_ckpt, "draft")
    config = yaml.safe_load(path.read_text())
    config["generation"]["draft_model"] = "int8"
    path.write_text(yaml.safe_dump(config))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eval_alignment.main(["--config", str(path)], device="cpu")
