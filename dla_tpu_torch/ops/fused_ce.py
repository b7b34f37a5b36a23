"""Fused unembedding + log-prob gather and the distillation KL
(``dla_tpu.ops.fused_ce``, the parts SFT, DPO and distillation use): never
holds [B, T, V] logits.

A ``torch.autograd.Function`` walks the flattened rows in chunks: each
[chunk, V] logit tile is computed in fp32 straight out of the matmul's
accumulator (bf16 operands, fp32 output — ``torch.mm(...,
out_dtype=torch.float32)`` on the card, an fp32 product of the widened
operands on the CPU, where bf16 values are exact), reduced to per-token
(logp[target], logsumexp) and discarded. The backward recomputes each
tile from the saved logsumexp — softmax = exp(logits - lse) — and
contracts it at once into dHidden and an fp32 dW accumulator, so live
memory is O(chunk * V) at every point of the step. An ``lm_head`` bias
(phi-2) is added to each fp32 tile; its gradient is the column sum of
each tile's fp32 dlogits. ``fused_kl_distill_loss`` walks the rows the
same way for KL(mean of teachers || student).

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

from typing import Optional, Sequence, Tuple

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


def _logits_tile(h: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    """[chunk, D] @ [D, V] (+ bias) as fp32 logits."""
    logits = _mm_f32(h, w)
    return logits if bias is None else logits.add_(bias.float())


def _tile_grads(dl: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                dw: torch.Tensor, db: Optional[torch.Tensor]):
    """One tile's share of the unembedding's gradients from its fp32
    dlogits ``dl`` [chunk, V]: adds the column sum to ``db`` in fp32 and
    ``h^T dl`` to the fp32 ``dw``; returns (dHidden of the tile in h's
    dtype, dw). dl is rounded to w's dtype once for both products, then
    each product to its output once, as the JAX package's fp32 dots
    followed by the final casts."""
    if db is not None:
        db += dl.sum(0)
    dlc = dl.to(w.dtype)
    return (dlc @ w.T).to(h.dtype), _mm_f32(h.to(w.dtype).T, dlc, dw)


class _FusedLogprobs(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden2d, w, bias, targets, chunk: int):
        n = hidden2d.shape[0]
        logp = torch.empty(n, dtype=torch.float32, device=hidden2d.device)
        lse = torch.empty_like(logp)
        for s in range(0, n, chunk):
            logits = _logits_tile(hidden2d[s:s + chunk], w, bias)
            lse[s:s + chunk] = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, 1, targets[s:s + chunk, None])
            logp[s:s + chunk] = picked[:, 0] - lse[s:s + chunk]
            del logits
        ctx.save_for_backward(hidden2d, w, bias, targets, lse)
        ctx.chunk = chunk
        return logp

    @staticmethod
    def backward(ctx, g):
        hidden2d, w, bias, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        n = hidden2d.shape[0]
        dh = torch.empty_like(hidden2d)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = (None if bias is None else
              torch.zeros(bias.shape, dtype=torch.float32, device=w.device))
        for s in range(0, n, chunk):
            h = hidden2d[s:s + chunk]
            rows = torch.arange(h.shape[0], device=h.device)
            logits = _logits_tile(h, w, bias)                # recompute
            dl = torch.exp(logits - lse[s:s + chunk, None]).neg_()
            dl[rows, targets[s:s + chunk]] += 1.0            # onehot - p
            dl *= g[s:s + chunk, None]
            del logits
            dh[s:s + chunk], dw = _tile_grads(dl, h, w, dw, db)
            del dl
        return (dh, dw.to(w.dtype), None if db is None else db.to(bias.dtype),
                None, None)


def fused_token_logprobs(
    hidden: torch.Tensor,          # [B, T, D] (activation dtype)
    w: torch.Tensor,               # [D, V] unembedding, activation dtype
    targets: torch.Tensor,         # [B, T] int
    bias: Optional[torch.Tensor] = None,   # [V]
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """log p(target) per token, [B, T] fp32 — ``token_logprobs(hidden @ w
    + bias, targets)`` without holding [B, T, V]. Targets are clipped to
    [0, V) (IGNORE_INDEX positions are masked by callers)."""
    b, t, d = hidden.shape
    tgt = targets.long().clamp(0, w.shape[1] - 1).reshape(b * t)
    logp = _FusedLogprobs.apply(hidden.reshape(b * t, d), w, bias, tgt,
                                max(1, min(chunk, b * t)))
    return logp.reshape(b, t)


def fused_cross_entropy_loss(
    hidden: torch.Tensor,          # [B, T, D] full-sequence hidden states
    w: torch.Tensor,               # [D, V]
    labels: torch.Tensor,          # [B, T] with IGNORE_INDEX masking
    bias: Optional[torch.Tensor] = None,   # [V]
    chunk: int = DEFAULT_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-mean next-token CE from hidden states (the SFT and
    distillation-CE objective), the shift applied to hidden states
    instead of logits. Returns (loss, n_valid_tokens)."""
    labels_s = labels[:, 1:]
    valid = labels_s != IGNORE_INDEX
    logp = fused_token_logprobs(hidden[:, :-1, :], w, labels_s, bias, chunk)
    n = valid.sum()
    loss = -(logp * valid).sum() / n.clamp(min=1)
    return loss, n


def unembed_operands(model, params
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The unembedding (w [D, V], bias [V] or None) in activation dtype;
    refuses the final-logit softcap, which the fused path does not
    compute yet."""
    if model.cfg.final_logit_softcap:
        raise NotImplementedError(
            "the fused CE takes no final-logit softcap yet; it arrives with "
            "the architecture-branches slice listed in ROADMAP.md")
    return model.unembed_params(params)


def model_fused_ce(model, params, batch, chunk: int = DEFAULT_CHUNK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden_states -> unembed_params -> fused CE, the SFT recipe.
    Returns (loss, n_valid_tokens)."""
    w, bias = unembed_operands(model, params)
    h = model.hidden_states(
        params, batch["input_ids"],
        attention_mask=batch.get("attention_mask"),
        segment_ids=batch.get("segment_ids"))
    return fused_cross_entropy_loss(h, w, batch["labels"], bias, chunk)


def fused_sequence_logprob_mean(
    hidden: torch.Tensor,          # [B, T, D]
    w: torch.Tensor,               # [D, V]
    input_ids: torch.Tensor,       # [B, T]
    mask: torch.Tensor,            # [B, T] 1 = real token
    bias: Optional[torch.Tensor] = None,   # [V]
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """Length-normalized mean per-token log p of each sequence, [B] fp32
    (``losses.sequence_logprob_mean`` of ``hidden @ w + bias``), the DPO
    objective."""
    m = mask[:, 1:].float()
    logp = fused_token_logprobs(hidden[:, :-1, :], w, input_ids[:, 1:],
                                bias, chunk)
    return (logp * m).sum(-1) / (m.sum(-1) + 1e-8)


def fused_segment_logprob_mean(
    hidden: torch.Tensor,          # [B, T, D]
    w: torch.Tensor,               # [D, V]
    input_ids: torch.Tensor,       # [B, T]
    mask: torch.Tensor,            # [B, T] 1 = real token
    segment_ids: torch.Tensor,     # [B, T] packed ids from 1 (0 = pad)
    n_segments: int,
    bias: Optional[torch.Tensor] = None,   # [V]
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
                                bias, chunk)                 # [B, T-1]
    oh = (seg_t[:, :, None] == torch.arange(
        1, n_segments + 1, device=seg_t.device)).float()     # [B, T-1, S]
    num = torch.einsum("bt,bts->bs", logp * m, oh)
    den = torch.einsum("bt,bts->bs", m, oh)
    return num / (den + 1e-8)


def model_fused_sequence_logprob(model, params, input_ids, attention_mask,
                                 chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """hidden_states -> unembed_params -> fused sequence log p, [B] fp32:
    the per-sequence score of DPO's four forwards."""
    w, bias = unembed_operands(model, params)
    h = model.hidden_states(params, input_ids, attention_mask=attention_mask)
    return fused_sequence_logprob_mean(h, w, input_ids, attention_mask,
                                       bias, chunk)


def model_fused_segment_logprob(model, params, sub, n_segments: int,
                                chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Per-segment log p of one side of a packed preference batch (``sub``:
    input_ids / attention_mask / segment_ids), [B, n_segments] fp32."""
    w, bias = unembed_operands(model, params)
    h = model.hidden_states(params, sub["input_ids"],
                            attention_mask=sub["attention_mask"],
                            segment_ids=sub["segment_ids"])
    return fused_segment_logprob_mean(
        h, w, sub["input_ids"], sub["attention_mask"], sub["segment_ids"],
        n_segments, bias, chunk)


class _FusedKL(torch.autograd.Function):
    """sum over rows of mask * KL(mean of teachers || student) at
    temperature ``temp``, in row chunks; the gradient flows to the
    student's hidden states, unembedding and bias only. The backward
    recomputes each chunk's student and teacher tiles (the JAX package's
    checkpointed scan body): d/dz_raw = mask * (p_s - p_t) / temp."""

    @staticmethod
    def forward(ctx, hs, w, bias, m, temp: float, chunk: int, teachers):
        kl = torch.zeros((), dtype=torch.float32, device=hs.device)
        lse = torch.empty(hs.shape[0], dtype=torch.float32, device=hs.device)
        for s in range(0, hs.shape[0], chunk):
            z = _logits_tile(hs[s:s + chunk], w, bias).div_(temp)
            lse[s:s + chunk] = torch.logsumexp(z, dim=-1)
            t_prob = _teacher_probs(teachers, s, chunk, temp)
            s_logp = z.sub_(lse[s:s + chunk, None])
            # t * (log t - log s): the JAX package's +1e-20 inside the log
            per_tok = (t_prob * (torch.log(t_prob + 1e-20) - s_logp)).sum(-1)
            kl += (per_tok * m[s:s + chunk]).sum()
            del z, t_prob, s_logp
        ctx.save_for_backward(hs, w, bias, m, lse)
        ctx.temp, ctx.chunk, ctx.teachers = temp, chunk, teachers
        return kl

    @staticmethod
    def backward(ctx, g):
        hs, w, bias, m, lse = ctx.saved_tensors
        temp, chunk, teachers = ctx.temp, ctx.chunk, ctx.teachers
        dh = torch.empty_like(hs)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = (None if bias is None else
              torch.zeros(bias.shape, dtype=torch.float32, device=w.device))
        for s in range(0, hs.shape[0], chunk):
            h = hs[s:s + chunk]
            z = _logits_tile(h, w, bias).div_(temp)          # recompute
            dl = torch.exp(z.sub_(lse[s:s + chunk, None]))   # p_s
            del z
            dl -= _teacher_probs(teachers, s, chunk, temp)
            dl *= (m[s:s + chunk] * (g / temp))[:, None]
            dh[s:s + chunk], dw = _tile_grads(dl, h, w, dw, db)
            del dl
        return (dh, dw.to(w.dtype), None if db is None else db.to(bias.dtype),
                None, None, None, None)


def _teacher_probs(teachers, s: int, chunk: int, temp: float) -> torch.Tensor:
    """Mean over the teachers of softmax(logits / temp) of rows
    [s, s + chunk), fp32; ``teachers`` is a list of (hidden [n, D_i], w
    [D_i, V], bias [V] or None)."""
    t_prob = None
    for th, tw, tb in teachers:
        p = torch.softmax(_logits_tile(th[s:s + chunk], tw, tb).div_(temp),
                          dim=-1)
        t_prob = p if t_prob is None else t_prob.add_(p)
    return t_prob.div_(len(teachers))


def fused_kl_distill_loss(
    student_hidden: torch.Tensor,         # [B, T, D_s]
    student_w: torch.Tensor,              # [D_s, V]
    teacher_hiddens: Sequence[torch.Tensor],   # each [B, T, D_i]
    teacher_ws: Sequence[torch.Tensor],        # each [D_i, V]
    mask: torch.Tensor,                   # [B, T] valid-token mask
    temperature: float = 1.0,
    student_bias: Optional[torch.Tensor] = None,
    teacher_biases: Optional[Sequence[Optional[torch.Tensor]]] = None,
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """Forward KL(mean of teachers || student), a token-masked mean times
    temperature^2, from hidden states: ``losses.kl_distill_loss`` of the
    unembedded logits without any [B, T, V] tensor (next-token
    distributions: rows [:, :-1] under mask[:, 1:]). The teachers take
    no gradient; each may have its own hidden size and bias, the
    vocabulary is shared."""
    b, t, d = student_hidden.shape
    n = b * (t - 1)
    if teacher_biases is None:
        teacher_biases = [None] * len(teacher_hiddens)
    teachers = [(th[:, :-1].detach().reshape(n, th.shape[-1]),
                 tw.detach(), None if tb is None else tb.detach())
                for th, tw, tb in zip(teacher_hiddens, teacher_ws,
                                      teacher_biases)]
    m = mask[:, 1:].reshape(n).float()
    kl_sum = _FusedKL.apply(student_hidden[:, :-1].reshape(n, d), student_w,
                            student_bias, m, float(temperature),
                            max(1, min(chunk, n)), teachers)
    return kl_sum / (m.sum() + 1e-8) * (temperature ** 2)
