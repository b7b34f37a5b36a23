"""The alignment losses as plain functions (``dla_tpu.ops.losses``): the
reference's -100 label mask, log-prob gathers via logit[target] -
logsumexp(logits), the Bradley-Terry pairwise loss, the DPO loss over
per-sequence log-probs, the distillation KL over materialized logits,
and RLHF's: REINFORCE with a baseline, the clipped PPO surrogate per
sequence and per token, GAE advantages and the clipped value loss."""
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


# ------------------------------------------------------------------ RLHF


def reinforce_loss(policy_logp: torch.Tensor,
                   advantages: torch.Tensor) -> torch.Tensor:
    """REINFORCE with a baseline: -(advantage.detach() * logp).mean(),
    over [B] sequence-mean log-probs."""
    return -(advantages.detach() * policy_logp).mean()


def ppo_clip_loss(policy_logp: torch.Tensor, behavior_logp: torch.Tensor,
                  advantages: torch.Tensor, clip_ratio: float = 0.2
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The clipped PPO surrogate over [B] sequence log-probs (behavior
    log-probs and advantages detached). Returns (loss, clip_frac: the
    share of ratios more than ``clip_ratio`` from 1)."""
    adv = advantages.detach()
    ratio = torch.exp(policy_logp - behavior_logp.detach())
    clipped = torch.clamp(ratio, 1 - clip_ratio, 1 + clip_ratio) * adv
    loss = -torch.minimum(ratio * adv, clipped).mean()
    clip_frac = ((ratio - 1.0).abs() > clip_ratio).float().mean()
    return loss, clip_frac


def gae_advantages(rewards: torch.Tensor, values: torch.Tensor,
                   action_mask: torch.Tensor, gamma: float = 1.0,
                   lam: float = 0.95) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized Advantage Estimation over each row's contiguous action
    region, [B, T] in and out: positions past the last action are
    terminal (V := 0), positions outside it carry no advantage. Returns
    (advantages, returns = advantages + values), zeroed off-action. A
    backward loop over T stands in for the JAX package's reverse
    ``lax.scan``; the inputs are detached."""
    m = action_mask.float()
    rewards, values = rewards.detach(), values.detach()
    m_next = torch.cat([m[:, 1:], torch.zeros_like(m[:, :1])], dim=1)
    v_next = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])],
                       dim=1) * m_next
    delta = (rewards + gamma * v_next - values) * m
    adv = torch.zeros_like(delta)
    carry = torch.zeros_like(delta[:, 0])
    for t in range(delta.shape[1] - 1, -1, -1):
        carry = delta[:, t] + gamma * lam * m_next[:, t] * carry
        adv[:, t] = carry
    adv = adv * m
    return adv, (adv + values) * m


def ppo_token_loss(policy_logp: torch.Tensor, behavior_logp: torch.Tensor,
                   advantages: torch.Tensor, action_mask: torch.Tensor,
                   clip_ratio: float = 0.2
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The clipped surrogate per token [B, T], mean over action tokens.
    Returns (loss, clip_frac over action tokens)."""
    adv = advantages.detach()
    ratio = torch.exp(policy_logp - behavior_logp.detach())
    clipped = torch.clamp(ratio, 1 - clip_ratio, 1 + clip_ratio) * adv
    loss = -masked_mean(torch.minimum(ratio * adv, clipped), action_mask)
    clip_frac = masked_mean(((ratio - 1.0).abs() > clip_ratio).float(),
                            action_mask)
    return loss, clip_frac


def ppo_value_loss(values: torch.Tensor, behavior_values: torch.Tensor,
                   returns: torch.Tensor, action_mask: torch.Tensor,
                   value_clip: float = 0.2) -> torch.Tensor:
    """The clipped (PPO2) value loss: half the action-token mean of the
    larger of the squared errors of the values and of the values clipped
    to ``value_clip`` around their rollout-time estimates."""
    ret, v_old = returns.detach(), behavior_values.detach()
    v_clip = v_old + torch.clamp(values - v_old, -value_clip, value_clip)
    err = torch.square(values - ret)
    err_clip = torch.square(v_clip - ret)
    return 0.5 * masked_mean(torch.maximum(err, err_clip), action_mask)
