"""Teacher rollout generation for distillation, on the GPU.

The CLI of ``dla_tpu.training.generate_teacher_data`` with the same
arguments:

  python -m dla_tpu_torch.training.generate_teacher_data \
      --model_name_or_path checkpoints/run/final \
      --prompts_path prompts.jsonl --output_path rollouts.jsonl

Batch sampling with temperature/top-p (batch ``start`` drawn under
``fold_in(PRNGKey(seed), 100 + start)``, the JAX CLI's key, so the same
checkpoint and seed give its tokens), the prompt stripped from the
response, streamed JSONL ``{prompt, teacher_response}``; with
``--reward_model_path`` a reward model (``build_reward_model``) scores
each generated sequence (prompt + response) and the record gains a
``reward``. Speculative decoding (``--draft_model_name_or_path``) is not
ported yet and raises.
"""
from __future__ import annotations

import argparse

import torch

from dla_tpu_torch.data.jsonl import append_jsonl, read_jsonl
from dla_tpu_torch.generation.engine import GenerationConfig, GenerationEngine
from dla_tpu_torch.ops import prng
from dla_tpu_torch.training.model_io import build_reward_model, load_causal_lm
from dla_tpu_torch.training.utils import root_key, seed_everything

PROMPT_TEMPLATE = "{prompt}\n\n"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Generate teacher rollouts")
    p.add_argument("--model_name_or_path", required=True)
    p.add_argument("--prompts_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--reward_model_path", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_prompt_length", type=int, default=256)
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--shard_count", type=int, default=1)
    p.add_argument("--draft_model_name_or_path", default=None)
    p.add_argument("--speculative_gamma", type=int, default=4)
    return p.parse_args(argv)


def main(argv=None, device="cuda") -> None:
    args = parse_args(argv)
    if args.draft_model_name_or_path:
        raise NotImplementedError(
            "--draft_model_name_or_path: speculative decoding is not ported "
            "yet (ROADMAP.md)")
    generator = seed_everything(args.seed, device)   # preset weights
    rng = root_key(args.seed)
    model_cfg = {"tokenizer": args.tokenizer} if args.tokenizer else {}
    bundle = load_causal_lm(args.model_name_or_path, model_cfg, generator,
                            device=device)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature, top_p=args.top_p,
                           do_sample=args.temperature > 0)
    engine = GenerationEngine(bundle.model, bundle.tokenizer, gen)
    rm = None
    if args.reward_model_path:
        # a causal-LM checkpoint warm-starts a fresh head from this stream
        rm = build_reward_model(
            {"base_model_name_or_path": args.reward_model_path, **model_cfg},
            torch.Generator(device=device).manual_seed(args.seed + 1),
            device=device)

    records = read_jsonl(args.prompts_path, shard_index=args.shard_index,
                         shard_count=args.shard_count)
    prompts = [r["prompt"] for r in records if r.get("prompt")]
    if args.limit:
        prompts = prompts[: args.limit]
    shard = (f" (shard {args.shard_index}/{args.shard_count})"
             if args.shard_count > 1 else "")
    print(f"[dla_tpu_torch] generating rollouts for {len(prompts)} "
          f"prompts{shard}", flush=True)

    open(args.output_path, "w").close()   # truncate a previous output
    n_done = 0
    for start in range(0, len(prompts), args.batch_size):
        chunk = prompts[start:start + args.batch_size]
        # pad the tail chunk to a full batch; padded rows are dropped
        padded = chunk + [chunk[-1]] * (args.batch_size - len(chunk))
        templated = [PROMPT_TEMPLATE.format(prompt=p) for p in padded]
        texts, out = engine.generate_text(
            bundle.params, templated, args.max_prompt_length,
            prng.fold_in(rng, 100 + start))
        rewards = None
        if rm is not None:
            with torch.no_grad():
                rewards = rm.model.apply(rm.params, out["sequences"],
                                         out["sequence_mask"]).tolist()
        for i, (prompt, response) in enumerate(zip(chunk, texts)):
            rec = {"prompt": prompt, "teacher_response": response}
            if rewards is not None:
                rec["reward"] = float(rewards[i])
            append_jsonl(args.output_path, rec)
        n_done += len(chunk)
        print(f"[dla_tpu_torch] {n_done}/{len(prompts)} rollouts written",
              flush=True)


if __name__ == "__main__":
    main()
