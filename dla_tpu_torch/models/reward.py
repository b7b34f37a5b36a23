"""Reward model: the transformer backbone with a pooled scalar head
(``dla_tpu.models.reward``).

The backbone is a ``Transformer`` whose tree has no ``lm_head``; the head
``reward_head`` is {w [D, 1], b [1]}, w drawn N(0, 1/D). ``last_token``
pooling reads the hidden state at attention_mask.sum() - 1 (rows are
right-padded), ``mean`` the masked mean. Pooled features, dropout and
the head run in fp32.

Dropout on the pooled feature is drawn from the ``torch.Generator`` the
caller passes; with none there is no dropout (deterministic eval), as in
the JAX package with no dropout rng. The masks are other bits than
``jax.random``'s (the threefry port, ``ops.prng``, serves the
samplers). LoRA adapters
(``init_lora`` / ``merge_lora``) are not ported yet: a config with
``lora_r`` > 0 raises in ``Transformer``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from dla_tpu_torch.models.config import ModelConfig
from dla_tpu_torch.models.transformer import Transformer

Params = Dict[str, Any]


class RewardModel(nn.Module):
    def __init__(self, cfg: ModelConfig, pooling: str = "last_token",
                 dropout: float = 0.0):
        super().__init__()
        if pooling not in ("last_token", "mean"):
            raise ValueError(f"Unknown pooling '{pooling}'")
        self.backbone = Transformer(cfg)
        self.cfg = cfg
        self.pooling = pooling
        self.dropout = dropout

    def init(self, generator: torch.Generator) -> Params:
        """Random backbone (no unembedding) and head on ``generator``'s
        device."""
        params = self.backbone.init(generator)
        params.pop("lm_head", None)
        params["reward_head"] = self.init_head(generator)
        return params

    def init_head(self, generator: torch.Generator) -> Params:
        """A fresh head: w ~ N(0, 1) / sqrt(D), b = 0, in the param
        dtype (also the warm start from a causal-LM checkpoint)."""
        d, dev = self.cfg.hidden_size, generator.device
        w = torch.randn((d, 1), generator=generator, device=dev,
                        dtype=torch.float32) * d ** -0.5
        return {"w": w.to(self.backbone.pdtype),
                "b": torch.zeros(1, dtype=self.backbone.pdtype, device=dev)}

    def apply(self, params: Params, input_ids: torch.Tensor,
              attention_mask: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              segment_ids: Optional[torch.Tensor] = None,
              n_segments: int = 0) -> torch.Tensor:
        """[B, T] -> [B] rewards (fp32). With ``segment_ids`` (packed
        preference rows, segments numbered from 1) and ``n_segments``,
        each segment pools as it would alone in a row (the backbone masks
        across segments and restarts positions): [B, n_segments], absent
        segments 0."""
        h = self.backbone.hidden_states(params, input_ids,
                                        attention_mask=attention_mask,
                                        segment_ids=segment_ids)
        mask = attention_mask.float()
        present = None
        if segment_ids is not None:
            if not n_segments:
                raise ValueError("segment_ids needs n_segments")
            oh = (segment_ids[:, :, None] == torch.arange(
                1, n_segments + 1, device=h.device)).float() \
                * mask[:, :, None]                            # [B, T, S]
            present = oh.sum(1) > 0                           # [B, S]
            if self.pooling == "last_token":
                # a segment's tokens are contiguous: its last is the
                # largest index where it is on
                t_idx = torch.arange(h.shape[1], device=h.device)
                idx = torch.where(oh > 0, t_idx[None, :, None],
                                  -1).amax(1).clamp(min=0)    # [B, S]
                pooled = torch.gather(
                    h, 1, idx[:, :, None].expand(-1, -1, h.shape[2]))
            else:
                pooled = torch.einsum("btd,bts->bsd", h.float(), oh) / (
                    oh.sum(1)[..., None] + 1e-8)
        elif self.pooling == "last_token":
            idx = (mask.sum(1).long() - 1).clamp(min=0)
            pooled = h[torch.arange(h.shape[0], device=h.device), idx]
        else:
            pooled = (h.float() * mask[..., None]).sum(1) / (
                mask.sum(1, keepdim=True) + 1e-8)
        pooled = pooled.float()
        if generator is not None and self.dropout > 0.0:
            keep = torch.rand(pooled.shape, generator=generator,
                              device=pooled.device) < 1.0 - self.dropout
            pooled = torch.where(keep, pooled / (1.0 - self.dropout),
                                 torch.zeros_like(pooled))
        head = params["reward_head"]
        rewards = (pooled @ head["w"].float() + head["b"].float())[..., 0]
        if present is not None:
            rewards = torch.where(present, rewards,
                                  torch.zeros_like(rewards))
        return rewards
