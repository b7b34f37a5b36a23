"""Fused unembedding + log-prob gather (``dla_tpu.ops.fused_ce``, the parts
SFT and DPO use): never holds [B, T, V] logits.

A ``torch.autograd.Function`` walks the flattened rows in chunks: each
[chunk, V] logit tile is computed in fp32 straight out of the matmul's
accumulator (bf16 operands, fp32 output — ``torch.mm(...,
out_dtype=torch.float32)`` on the card, an fp32 product of the widened
operands on the CPU, where bf16 values are exact), reduced to per-token
(logp[target], logsumexp) and discarded. The backward recomputes each
tile from the saved logsumexp — softmax = exp(logits - lse) — and
contracts it at once into dHidden and an fp32 dW accumulator, so live
memory is O(chunk * V) at every point of the step.

The one layout difference from the JAX scan: the last chunk is ragged
(rows are sliced, not padded to a chunk multiple), so there are no pad
rows whose recomputed probabilities would need g = 0 and lse = 1e30 to
stay inert.

The caller passes the unembedding matrix already cast to the activation
dtype (``Transformer.unembed_params``), so the master-weight cast stays
outside and autograd carries dW back through it (for tied embeddings
onto the embedding table, beside the lookup's gradient).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from dla_tpu_torch.ops.losses import IGNORE_INDEX

DEFAULT_CHUNK = 1024  # rows (B*T flattened) per logit tile


def _mm_f32(a: torch.Tensor, b: torch.Tensor,
            acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a @ b (+ acc) with fp32 output from operands in their own dtype."""
    if a.is_cuda and a.dtype != torch.float32:
        if acc is None:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.addmm(acc, a, b, out_dtype=torch.float32)
    out = a.float() @ b.float()
    return out if acc is None else acc + out


class _FusedLogprobs(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden2d, w, targets, chunk: int):
        n = hidden2d.shape[0]
        logp = torch.empty(n, dtype=torch.float32, device=hidden2d.device)
        lse = torch.empty_like(logp)
        for s in range(0, n, chunk):
            logits = _mm_f32(hidden2d[s:s + chunk], w)
            lse[s:s + chunk] = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, 1, targets[s:s + chunk, None])
            logp[s:s + chunk] = picked[:, 0] - lse[s:s + chunk]
            del logits
        ctx.save_for_backward(hidden2d, w, targets, lse)
        ctx.chunk = chunk
        return logp

    @staticmethod
    def backward(ctx, g):
        hidden2d, w, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        n = hidden2d.shape[0]
        dh = torch.empty_like(hidden2d)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for s in range(0, n, chunk):
            h = hidden2d[s:s + chunk]
            rows = torch.arange(h.shape[0], device=h.device)
            logits = _mm_f32(h, w)                           # recompute
            dl = torch.exp(logits - lse[s:s + chunk, None]).neg_()
            dl[rows, targets[s:s + chunk]] += 1.0            # onehot - p
            dl *= g[s:s + chunk, None]
            del logits
            dlc = dl.to(w.dtype)
            del dl
            # one rounding of an fp32-accumulated product, as the JAX
            # package's fp32 dot followed by the final cast
            dh[s:s + chunk] = (dlc @ w.T).to(hidden2d.dtype)
            dw = _mm_f32(h.to(w.dtype).T, dlc, dw)
        return dh, dw.to(w.dtype), None, None


def fused_token_logprobs(
    hidden: torch.Tensor,          # [B, T, D] (activation dtype)
    w: torch.Tensor,               # [D, V] unembedding, activation dtype
    targets: torch.Tensor,         # [B, T] int
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """log p(target) per token, [B, T] fp32 — ``token_logprobs(hidden @ w,
    targets)`` without holding [B, T, V]. Targets are clipped to [0, V)
    (IGNORE_INDEX positions are masked by callers)."""
    b, t, d = hidden.shape
    tgt = targets.long().clamp(0, w.shape[1] - 1).reshape(b * t)
    logp = _FusedLogprobs.apply(hidden.reshape(b * t, d), w, tgt,
                                max(1, min(chunk, b * t)))
    return logp.reshape(b, t)


def fused_cross_entropy_loss(
    hidden: torch.Tensor,          # [B, T, D] full-sequence hidden states
    w: torch.Tensor,               # [D, V]
    labels: torch.Tensor,          # [B, T] with IGNORE_INDEX masking
    chunk: int = DEFAULT_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-mean next-token CE from hidden states (the SFT objective),
    the shift applied to hidden states instead of logits. Returns (loss,
    n_valid_tokens)."""
    labels_s = labels[:, 1:]
    valid = labels_s != IGNORE_INDEX
    logp = fused_token_logprobs(hidden[:, :-1, :], w, labels_s, chunk)
    n = valid.sum()
    loss = -(logp * valid).sum() / n.clamp(min=1)
    return loss, n


def _unembed_w(model, params) -> torch.Tensor:
    """The unembedding [D, V] in activation dtype; refuses what the fused
    path does not compute yet."""
    w, bias = model.unembed_params(params)
    if bias is not None or model.cfg.final_logit_softcap:
        raise NotImplementedError(
            "the fused CE takes no lm_head bias or final-logit softcap yet; "
            "they arrive with the architecture-branches slice listed in "
            "ROADMAP.md")
    return w


def model_fused_ce(model, params, batch, chunk: int = DEFAULT_CHUNK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden_states -> unembed_params -> fused CE, the SFT recipe.
    Returns (loss, n_valid_tokens)."""
    w = _unembed_w(model, params)
    h = model.hidden_states(
        params, batch["input_ids"],
        attention_mask=batch.get("attention_mask"),
        segment_ids=batch.get("segment_ids"))
    return fused_cross_entropy_loss(h, w, batch["labels"], chunk=chunk)


def fused_sequence_logprob_mean(
    hidden: torch.Tensor,          # [B, T, D]
    w: torch.Tensor,               # [D, V]
    input_ids: torch.Tensor,       # [B, T]
    mask: torch.Tensor,            # [B, T] 1 = real token
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """Length-normalized mean per-token log p of each sequence, [B] fp32
    (``losses.sequence_logprob_mean`` of ``hidden @ w``), the DPO
    objective."""
    m = mask[:, 1:].float()
    logp = fused_token_logprobs(hidden[:, :-1, :], w, input_ids[:, 1:],
                                chunk)
    return (logp * m).sum(-1) / (m.sum(-1) + 1e-8)


def fused_segment_logprob_mean(
    hidden: torch.Tensor,          # [B, T, D]
    w: torch.Tensor,               # [D, V]
    input_ids: torch.Tensor,       # [B, T]
    mask: torch.Tensor,            # [B, T] 1 = real token
    segment_ids: torch.Tensor,     # [B, T] packed ids from 1 (0 = pad)
    n_segments: int,
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """Mean per-token log p of each packed segment, [B, n_segments] fp32:
    each segment as fused_sequence_logprob_mean would score it alone in
    a row (positions restart per segment). A target counts only when the
    hidden state predicting it lies in its own segment; absent segments
    read 0."""
    seg_t = segment_ids[:, 1:]
    m = (mask[:, 1:].float() * (seg_t == segment_ids[:, :-1])
         * (seg_t > 0))
    logp = fused_token_logprobs(hidden[:, :-1, :], w, input_ids[:, 1:],
                                chunk)                       # [B, T-1]
    oh = (seg_t[:, :, None] == torch.arange(
        1, n_segments + 1, device=seg_t.device)).float()     # [B, T-1, S]
    num = torch.einsum("bt,bts->bs", logp * m, oh)
    den = torch.einsum("bt,bts->bs", m, oh)
    return num / (den + 1e-8)


def model_fused_sequence_logprob(model, params, input_ids, attention_mask,
                                 chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """hidden_states -> unembed_params -> fused sequence log p, [B] fp32:
    the per-sequence score of DPO's four forwards."""
    w = _unembed_w(model, params)
    h = model.hidden_states(params, input_ids, attention_mask=attention_mask)
    return fused_sequence_logprob_mean(h, w, input_ids, attention_mask,
                                       chunk)


def model_fused_segment_logprob(model, params, sub, n_segments: int,
                                chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Per-segment log p of one side of a packed preference batch (``sub``:
    input_ids / attention_mask / segment_ids), [B, n_segments] fp32."""
    w = _unembed_w(model, params)
    h = model.hidden_states(params, sub["input_ids"],
                            attention_mask=sub["attention_mask"],
                            segment_ids=sub["segment_ids"])
    return fused_segment_logprob_mean(
        h, w, sub["input_ids"], sub["attention_mask"], sub["segment_ids"],
        n_segments, chunk)
