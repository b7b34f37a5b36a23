"""The alignment losses as plain functions (``dla_tpu.ops.losses``, the
parts SFT, the reward model, DPO and distillation use): the reference's
-100 label mask, log-prob gathers via logit[target] - logsumexp(logits),
the Bradley-Terry pairwise loss, the DPO loss over per-sequence
log-probs and the distillation KL over materialized logits."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

IGNORE_INDEX = -100  # reference label-mask convention


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                eps: float = 1e-8) -> torch.Tensor:
    """Mean of ``x`` weighted by ``mask``; None = plain mean (the packed
    preference path passes its pair mask, the unpacked one None)."""
    if mask is None:
        return x.mean()
    mask = mask.float()
    return (x * mask).sum() / (mask.sum() + eps)


def token_logprobs(logits: torch.Tensor, targets: torch.Tensor
                   ) -> torch.Tensor:
    """Per-token log p(target): logits [B, T, V] (any float dtype),
    targets [B, T] int -> [B, T] fp32. Targets are clipped to [0, V) so a
    vocab mismatch cannot index out of range (callers mask those)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    idx = targets.long().clamp(0, logits.shape[-1] - 1)[..., None]
    return torch.gather(logits, -1, idx)[..., 0] - lse


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-mean next-token CE: logits[:, :-1] predict labels[:, 1:],
    IGNORE_INDEX positions excluded. Returns (loss, n_valid_tokens)."""
    labels_s = labels[:, 1:]
    valid = labels_s != IGNORE_INDEX
    logp = token_logprobs(logits[:, :-1, :], labels_s)
    n = valid.sum()
    loss = -(logp * valid).sum() / n.clamp(min=1)
    return loss, n


def sequence_logprob_mean(logits: torch.Tensor, input_ids: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Length-normalized mean per-token log p of each sequence, [B] fp32:
    logits[:, :-1] predict input_ids[:, 1:] under mask[:, 1:]."""
    m = mask[:, 1:].float()
    logp = token_logprobs(logits[:, :-1, :], input_ids[:, 1:])
    return (logp * m).sum(-1) / (m.sum(-1) + 1e-8)


def dpo_loss(policy_chosen_logp: torch.Tensor,
             policy_rejected_logp: torch.Tensor,
             ref_chosen_logp: torch.Tensor,
             ref_rejected_logp: torch.Tensor,
             beta: float, label_smoothing: float = 0.0,
             valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-logsigmoid(beta * ((pi_c - pi_r) - (ref_c - ref_r))), mean over
    the pairs (``valid``-weighted on packed rows). ``label_smoothing`` > 0
    is conservative DPO: (1 - eps) * that + eps * -logsigmoid(-margin).
    Returns (loss, margin = beta * (pi_diff - ref_diff))."""
    margin = beta * ((policy_chosen_logp - policy_rejected_logp)
                     - (ref_chosen_logp - ref_rejected_logp))
    per = -F.logsigmoid(margin)
    if label_smoothing:
        per = ((1 - label_smoothing) * per
               + label_smoothing * -F.logsigmoid(-margin))
    return masked_mean(per, valid), margin


def pairwise_reward_loss(chosen_rewards: torch.Tensor,
                         rejected_rewards: torch.Tensor,
                         valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Bradley-Terry: -logsigmoid(chosen - rejected), mean over the pairs
    (``valid``-weighted on packed rows)."""
    return masked_mean(-F.logsigmoid(chosen_rewards - rejected_rewards),
                       valid)


def kl_distill_loss(student_logits: torch.Tensor,
                    teacher_logits: Sequence[torch.Tensor],
                    mask: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
    """Forward KL(mean of teachers || student), token-masked mean, times
    temperature^2: teacher probabilities averaged over the ensemble, KL
    summed over the vocabulary, next-token distributions (logits[:, :-1]
    under mask[:, 1:]). The plain [B, T, V] version of
    ``fused_ce.fused_kl_distill_loss``."""
    s_logp = torch.log_softmax(
        student_logits[:, :-1].float() / temperature, dim=-1)
    t_probs = None
    for tl in teacher_logits:
        tp = torch.softmax(tl[:, :-1].float() / temperature, dim=-1)
        t_probs = tp if t_probs is None else t_probs + tp
    t_probs = t_probs / len(teacher_logits)
    per_token = (t_probs * (torch.log(t_probs + 1e-20) - s_logp)).sum(-1)
    return masked_mean(per_token, mask[:, 1:]) * (temperature ** 2)
