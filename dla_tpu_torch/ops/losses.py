"""The SFT objective as plain functions (``dla_tpu.ops.losses``, the part
SFT and the fused CE use): the reference's -100 label mask, log-prob
gathers via logit[target] - logsumexp(logits)."""
from __future__ import annotations

from typing import Tuple

import torch

IGNORE_INDEX = -100  # reference label-mask convention


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
