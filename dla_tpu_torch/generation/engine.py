"""Autoregressive generation: prefill + decode over a preallocated KV
cache, with temperature/top-p/top-k sampling.

The counterpart of ``dla_tpu.generation.engine``, the engine behind PPO
rollouts, teacher generation and evaluation. Prompts arrive right-padded
to a static width P. With ``eos_token_id < 0`` decode runs exactly
``max_new_tokens`` steps; with a real EOS id it stops once every row has
finished (one host check per step) — finished rows emit pad with a zero
mask, so outputs equal the fixed-length schedule's. The JAX package's
chunked early-exit schedule only changes the loop's shape, so
``early_exit_chunk`` takes the same per-step loop here.

On the card the decode loop runs as one CUDA graph per generate call,
the port's counterpart of the JAX package's jitted ``lax.scan`` /
``while_loop``: the first step runs eagerly (real work, and the warm-up
a capture needs), the step (sampling, ``decode_step``, the chosen
token's logprob, the writes of the step's outputs at a device step
counter) is captured once and replayed for the remaining steps. With an
EOS the host checks ``done`` between replays. CPU tensors run the eager
loop.

Sampling is ``jax.random``'s, bit for bit (``ops.prng``, the fused draw
kernel of ``ops.sampling``): the generate fn takes a key ([2] uint32
words), splits it into one key per step as the JAX package does, and
keeps the [n, 2] step keys on the device, indexed by the step counter,
so the graph's replays draw what the eager loop draws. With
``per_request_seeds`` it takes [B*G] row seeds instead, and token k of
row i is drawn with ``fold_in(PRNGKey(seed_i), k)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dla_tpu_torch.models.transformer import Transformer
from dla_tpu_torch.ops import prng
from dla_tpu_torch.ops.sampling import sample_token, sample_token_per_row


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Mirrors ``dla_tpu.generation.engine.GenerationConfig``."""
    max_new_tokens: int = 128
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    do_sample: bool = True
    eos_token_id: int = 2
    pad_token_id: int = 0
    early_exit_chunk: int = 0

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]], **defaults
                  ) -> "GenerationConfig":
        """Fields of ``d`` over ``defaults``; keys that are not fields
        are ignored."""
        fields = {f.name for f in dataclasses.fields(cls)}
        d = dict(d or {})
        return cls(**{**defaults, **{k: v for k, v in d.items()
                                     if k in fields}})


def left_align(ids: torch.Tensor, mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact masked-out gaps: real tokens slide left, pads to the right,
    stable order among real tokens."""
    order = torch.argsort((mask == 0).to(torch.int8), dim=1, stable=True)
    return ids.gather(1, order), mask.gather(1, order)


def encode_prompt_batch(tokenizer, prompts, width: int):
    """Host-side prompt encoding to fixed-width right-padded int32
    arrays (ids, mask)."""
    ids = np.full((len(prompts), width), tokenizer.pad_token_id, np.int32)
    mask = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        enc = tokenizer.encode(p)[:width]
        ids[i, :len(enc)] = enc
        mask[i, :len(enc)] = 1
    return ids, mask


def build_prefill_step(model: Transformer, max_new_tokens: int):
    """``fn(params, input_ids, attention_mask) -> (logits [B, V], cache)``
    — ``start_decode`` with the decode budget bound."""
    def prefill_step(params, input_ids, attention_mask):
        return model.start_decode(
            params, input_ids, attention_mask, max_new_tokens)
    return prefill_step


def build_decode_step(model: Transformer, gen: GenerationConfig):
    """``fn(key, params, logits, cache, done) -> (tok, emit_mask, logits,
    cache, done)``: sample from the incoming logits under ``key``, hold
    finished rows at pad, advance the KV cache (in place)."""
    def decode_step(key, params, logits, cache, done):
        tok = sample_token(
            key, logits, temperature=gen.temperature,
            top_p=gen.top_p, top_k=gen.top_k, do_sample=gen.do_sample)
        tok = torch.where(done, torch.full_like(tok, gen.pad_token_id), tok)
        emit_mask = ~done
        done = done | (tok == gen.eos_token_id)
        logits, cache = model.decode_step(params, cache, tok)
        return tok, emit_mask, logits, cache, done
    return decode_step


def _expand(cache: Dict[str, Any], group: int) -> Dict[str, Any]:
    """Repeat each prompt's prefill state ``group`` times along the batch:
    KV [L, B, S, KH, D] and scales [L, B, KH, S] carry batch at axis 1,
    per-row metadata (valid/pos [B, S], lengths [B]) at axis 0; host ints
    and the 0-dim device column are batch-free."""
    out = {}
    for key, leaf in cache.items():
        if not torch.is_tensor(leaf) or leaf.ndim == 0:
            out[key] = leaf
        elif leaf.ndim >= 4:
            out[key] = torch.repeat_interleave(leaf, group, dim=1)
        else:
            out[key] = torch.repeat_interleave(leaf, group, dim=0)
    return out


def build_generate_fn(model: Transformer, gen: GenerationConfig,
                      group_size: int = 1, per_request_seeds: bool = False):
    """Returns ``fn(params, input_ids, attention_mask, key)`` -> dict of
    tensors:

      sequences/sequence_mask  [B, P+N]  prompt + response, left-aligned
      response_tokens/response_mask [B, N]
      response_logps [B, N] chosen-token logprobs under the RAW model
        distribution (zero where the mask is zero)
      lengths [B] total real tokens (prompt + generated, incl. eos)

    ``key`` is a [2] key (``ops.prng``); step i draws with ``split(key,
    n)[i]``. ``group_size`` G > 1: B unique prompts are prefilled once
    and their prefill state expanded G-fold before decode, rows laid out
    grouped ([p0 s0..sG-1, p1 s0..sG-1, ...]). ``per_request_seeds``
    swaps the last argument for [B*G] uint32 row seeds: token k of row i
    is drawn with ``fold_in(PRNGKey(seeds[i]), k)``."""
    single_step = build_decode_step(model, gen)
    eos = gen.eos_token_id if gen.eos_token_id is not None else -1

    @torch.no_grad()
    def generate(params, input_ids, attention_mask, rng):
        b, _ = input_ids.shape
        n = gen.max_new_tokens
        dev = input_ids.device
        logits, cache = model.start_decode(params, input_ids,
                                           attention_mask, n)
        if group_size > 1:
            logits = torch.repeat_interleave(logits, group_size, dim=0)
            cache = _expand(cache, group_size)
            input_ids = torch.repeat_interleave(input_ids, group_size, 0)
            attention_mask = torch.repeat_interleave(attention_mask,
                                                     group_size, 0)
            b = b * group_size

        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        toks = torch.full((n, b), gen.pad_token_id, dtype=torch.int32,
                          device=dev)
        emits = torch.zeros((n, b), dtype=torch.bool, device=dev)
        lps = torch.zeros((n, b), dtype=torch.float32, device=dev)
        # logits, done and the step counter `at` are carried from step to
        # step in place
        at = torch.zeros((1,), dtype=torch.int64, device=dev)
        if per_request_seeds:
            seeds = torch.as_tensor(rng).to(device=dev, dtype=torch.int64)
            if seeds.shape != (b,):
                raise ValueError(f"per_request_seeds takes [{b}] seeds, got "
                                 f"{tuple(seeds.shape)}")
            temps = torch.full((b,), float(gen.temperature)
                               if gen.do_sample else 0.0, device=dev)
            top_ps = torch.full((b,), float(gen.top_p), device=dev)
            top_ks = torch.full((b,), int(gen.top_k), dtype=torch.int32,
                                device=dev)
        else:
            keys = prng.split(torch.as_tensor(rng).to(dev), max(n, 1))

        def body():
            """One step; every tensor it carries to the next step is
            updated in place (what a graph replay needs)."""
            prev = logits.float()
            if per_request_seeds:
                tok, logp = sample_token_per_row(
                    seeds, at.expand(b), prev, temps, top_ps, top_ks)
                tok = torch.where(done, torch.full_like(
                    tok, gen.pad_token_id), tok)
                emit_mask = ~done
                new_done = done | (tok == eos)
                new_logits, _ = model.decode_step(params, cache, tok)
            else:
                tok, emit_mask, new_logits, _, new_done = single_step(
                    keys.index_select(0, at)[0], params, logits, cache,
                    done)
                logp = torch.log_softmax(prev, dim=-1).gather(
                    1, tok[:, None].long())[:, 0]
            toks.index_copy_(0, at, tok[None])
            emits.index_copy_(0, at, emit_mask[None])
            lps.index_copy_(0, at, logp[None])
            logits.copy_(new_logits)
            done.copy_(new_done)
            at.add_(1)

        if dev.type == "cuda" and n > 0:
            _decode_graphed(body, done, n, eos >= 0, dev)
        else:
            for _ in range(n):
                if eos >= 0 and bool(done.all()):
                    break   # every row finished: the rest stays pad / 0
                body()

        response_tokens = toks.T.contiguous()                  # [B, N]
        response_mask = emits.T.to(torch.int32).contiguous()   # [B, N]
        response_logps = torch.where(response_mask > 0, lps.T,
                                     torch.zeros_like(lps.T))
        raw_ids = torch.cat([input_ids.to(torch.int32), response_tokens], 1)
        raw_mask = torch.cat([attention_mask.to(torch.int32),
                              response_mask], 1)
        sequences, sequence_mask = left_align(raw_ids, raw_mask)
        return {
            "sequences": sequences,
            "sequence_mask": sequence_mask,
            "response_tokens": response_tokens,
            "response_mask": response_mask,
            "response_logps": response_logps,
            "lengths": raw_mask.sum(dim=1).to(torch.int32),
        }

    return generate


def _decode_graphed(body, done: torch.Tensor, n: int, check_eos: bool,
                    dev: torch.device) -> None:
    """Run ``body`` (one decode step, state updated in place) ``n`` times
    on the card: step 1 eagerly, on the stream the capture uses (it is
    the warm-up too), then the step captured once as a CUDA graph and
    replayed for steps 2..n; with ``check_eos`` the host stops once
    every row is done, as the eager loop does. The kernel wrappers count
    the step's launches once, at the capture; the replays run them with
    no Python. A capture that fails raises."""
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        body()
    torch.cuda.current_stream(dev).wait_stream(stream)
    if n == 1 or (check_eos and bool(done.all())):
        return
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        body()
    for _ in range(n - 1):
        if check_eos and bool(done.all()):
            break
        graph.replay()
    del graph


class GenerationEngine:
    """Tokenizes/detokenizes at the host boundary around
    ``build_generate_fn``; the public single-step surface
    (``prefill_step``/``decode_step``) runs the same math."""

    def __init__(self, model: Transformer, tokenizer, gen: GenerationConfig):
        self.model = model
        self.tokenizer = tokenizer
        self.gen = dataclasses.replace(
            gen,
            eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id)
        self._fn = build_generate_fn(model, self.gen)
        self.prefill_step = build_prefill_step(model,
                                               self.gen.max_new_tokens)
        self.decode_step = build_decode_step(model, self.gen)

    def encode_prompts(self, prompts, max_prompt_len: int):
        return encode_prompt_batch(self.tokenizer, prompts, max_prompt_len)

    def generate_text(self, params, prompts, max_prompt_len: int,
                      rng: torch.Tensor) -> Tuple[list, Dict[str, Any]]:
        ids, mask = self.encode_prompts(prompts, max_prompt_len)
        dev = params["embed"]["embedding"].device
        out = self._fn(params, torch.from_numpy(ids).to(dev),
                       torch.from_numpy(mask).to(dev), rng)
        resp = out["response_tokens"].cpu().numpy()
        rmask = out["response_mask"].cpu().numpy()
        texts = []
        for i in range(len(prompts)):
            toks = [int(t) for t, m in zip(resp[i], rmask[i])
                    if m and t != self.tokenizer.eos_token_id]
            texts.append(self.tokenizer.decode(toks))
        return texts, out
