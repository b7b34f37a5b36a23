"""Decoder-only transformer (llama and phi families) for PyTorch, single
device.

The counterpart of ``dla_tpu.models.transformer.Transformer`` on the
generation and SFT paths: initialisation, int8 weight quantization,
prefill into a contiguous KV cache (bf16 or int8 with K-major scales),
one-token decode steps, and the differentiable training forward
(``hidden_states`` / ``apply``, with per-layer activation
checkpointing). The parameter tree keeps the JAX package's layout — the
same leaf names, stacked ``[L, d_in, d_out]`` layer leaves, ``x @ W`` —
so trees convert between the packages with no transposes
(``models.weights.params_from_jax``), and the model stays functional:
every method takes the parameter dict, as the JAX model does.

Kernels on these paths: prefill and training attention through the
flash kernels (``attention="flash"``; forward, and dQ / dK-dV in the
backward), every projection of an int8 tree and the int8 ``lm_head``
through the int8 matmul kernel, and every decode step's attention
through the decode-attention kernel (int8 cache under
``decode_kernel="auto"``, any cache under ``"on"``). The TPU-only gates
are gone: flash needs no 128-multiple length (the kernel masks ragged
tails) and the decode kernel has no head_dim % 128 or 8-row group limit.
There is no mesh: sharding constraints and shard_map wrappers have no
counterpart here.

The phi block (phi-2: one shared LayerNorm feeding attention and the
MLP, biased projections, partial rotary, a GELU(tanh) fc1/fc2 MLP, the
parallel residual ``x + attn + mlp``, a biased final LayerNorm and an
untied, biased ``lm_head``) runs the training forward only:
``init_cache``, ``prefill``, ``prefill_external`` and ``decode_step``
raise for it until phi generation is ported (ROADMAP.md).

Not ported yet (``__init__`` or ``hidden_states`` raises, naming the
ROADMAP item): the gemma / gemma2 block variants, alternating-layer
sliding windows, MoE, LoRA, interleaved pipeline storage, pipeline
parallelism, ``remat: dots``; multi-token ``decode_block`` and the paged
serving entry points. Long flash-ineligible sequences take the full
einsum attention (``chunked_causal_attention`` is not ported).

Difference in mutation: ``decode_step`` writes the new KV column into
the cache tensors in place and returns the same dict (the JAX version
returns a new cache that XLA aliases); at 8B scale a cache copy per step
would move ~1.6 GB. Every tensor of the cache is updated in place, and
the write column lives on the device (``cache["col"]``), so the step
reads no host state that changes from step to step and a CUDA graph of
it replays correctly (``generation.engine.build_generate_fn``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dla_tpu_torch.models.config import ModelConfig
from dla_tpu_torch.ops import decode_kernel, flash_attention, quant_matmul
from dla_tpu_torch.ops.attention import causal_attention, decode_attention
from dla_tpu_torch.ops.norms import layer_norm, rms_norm
from dla_tpu_torch.ops.rotary import apply_rotary, rotary_angles

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def _check_supported(cfg: ModelConfig) -> None:
    later = None
    if cfg.arch not in ("llama", "phi"):
        later = f"arch '{cfg.arch}' (the gemma/gemma2 block variants)"
    elif cfg.num_experts > 0:
        later = "MoE layers (num_experts > 0)"
    elif cfg.lora_r > 0:
        later = "LoRA adapters (lora_r > 0)"
    elif cfg.sliding_window and cfg.sliding_window_pattern > 1:
        later = "alternating-layer sliding windows"
    elif cfg.pipeline_stages > 1 and cfg.pipeline_interleave > 1:
        later = "interleaved pipeline storage"
    if later:
        raise NotImplementedError(
            f"dla_tpu_torch does not port {later} yet; it arrives with the "
            "architecture-branches slice listed in ROADMAP.md")


def _layer(layers: Params, i: int) -> Params:
    return {k: v[i] for k, v in layers.items()}


class Transformer(nn.Module):
    """Functional model bound to a config; the parameter tree is passed
    to every method. ``forward`` is the prompt forward
    (``prefill_external``)."""

    _WEIGHT_ONLY_MATS = ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                         "w_down")

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.adtype = torch_dtype(cfg.dtype)
        self.pdtype = torch_dtype(cfg.param_dtype)
        self._softmax_scale = (
            cfg.query_pre_attn_scalar ** -0.5
            if cfg.query_pre_attn_scalar else None)

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters on ``generator``'s device: N(0, 0.02)
        matrices with the output projections scaled by 1/sqrt(2L)
        (gpt-2 style), unit norms, zero biases — the JAX package's
        scheme, drawn from a torch.Generator (other bits than
        jax.random, same distribution)."""
        cfg = self.cfg
        dev = generator.device
        dh = cfg.head_dim_
        qdim, kvdim = cfg.num_heads * dh, cfg.num_kv_heads * dh
        std = 0.02
        out_std = std / (2 * cfg.num_layers) ** 0.5
        L, D, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size

        def mat(shape, scale):
            x = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return x.mul_(scale).to(self.pdtype)

        def ones(*shape):
            return torch.ones(shape, dtype=self.pdtype, device=dev)

        def zeros(*shape):
            return torch.zeros(shape, dtype=self.pdtype, device=dev)

        if cfg.arch == "phi":
            # parallel-residual block: one shared input LayerNorm, biased
            # projections, non-gated GELU MLP (fc1/fc2)
            params: Params = {
                "embed": {"embedding": mat((cfg.vocab_size, D), std)},
                "layers": {
                    "ln": ones(L, D), "ln_bias": zeros(L, D),
                    "wq": mat((L, D, qdim), std), "wq_bias": zeros(L, qdim),
                    "wk": mat((L, D, kvdim), std), "wk_bias": zeros(L, kvdim),
                    "wv": mat((L, D, kvdim), std), "wv_bias": zeros(L, kvdim),
                    "wo": mat((L, qdim, D), out_std), "wo_bias": zeros(L, D),
                    "fc1": mat((L, D, F), std), "fc1_bias": zeros(L, F),
                    "fc2": mat((L, F, D), out_std), "fc2_bias": zeros(L, D),
                },
                "final_norm": ones(D), "final_norm_bias": zeros(D),
            }
            if not cfg.tie_embeddings:
                params["lm_head"] = mat((D, cfg.vocab_size), std)
                params["lm_head_bias"] = zeros(cfg.vocab_size)
            return params
        params = {
            "embed": {"embedding": mat((cfg.vocab_size, D), std)},
            "layers": {
                "attn_norm": ones(L, D),
                "wq": mat((L, D, qdim), std),
                "wk": mat((L, D, kvdim), std),
                "wv": mat((L, D, kvdim), std),
                "wo": mat((L, qdim, D), out_std),
                "mlp_norm": ones(L, D),
                "w_gate": mat((L, D, F), std),
                "w_up": mat((L, D, F), std),
                "w_down": mat((L, F, D), out_std),
            },
            "final_norm": ones(D),
        }
        if cfg.attention_bias:  # qwen2-style q/k/v biases
            params["layers"]["wq_bias"] = zeros(L, qdim)
            params["layers"]["wk_bias"] = zeros(L, kvdim)
            params["layers"]["wv_bias"] = zeros(L, kvdim)
        if not cfg.tie_embeddings:
            params["lm_head"] = mat((D, cfg.vocab_size), std)
        return params

    # ------------------------------------------------------- int8 weights

    @staticmethod
    def _symmetric_int8(x: torch.Tensor, axis: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Symmetric int8 quantization along ``axis``: (int8 values,
        fp32 scale with keepdims) — absmax/127 (+1e-12), round half to
        even, clip. Shared by the KV cache and weight-only paths."""
        xf = x.float()
        absmax = xf.abs().amax(dim=axis, keepdim=True)
        scale = absmax / 127.0 + 1e-12
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return q, scale

    def quantize_weights(self, params: Params) -> Params:
        """Weight-only int8 copy of a parameter tree for rollout decode:
        each dense [L, in, out] matrix becomes int8 with per-(layer,
        out-channel) fp32 scales ``<name>_wscale`` [L, 1, out]; an untied
        ``lm_head`` [D, V] gets [1, V] scales. Embeddings, norms and
        biases stay as they are. Quantized one layer at a time to bound
        the fp32 temporaries."""
        out_layers: Params = {}
        for key, val in params["layers"].items():
            if (key in self._WEIGHT_ONLY_MATS and val.ndim == 3
                    and val.dtype != torch.int8):
                q = torch.empty(val.shape, dtype=torch.int8,
                                device=val.device)
                scale = torch.empty((val.shape[0], 1, val.shape[2]),
                                    dtype=torch.float32, device=val.device)
                for i in range(val.shape[0]):
                    q[i], scale[i] = self._symmetric_int8(val[i], axis=0)
                out_layers[key] = q
                out_layers[key + "_wscale"] = scale
            else:
                out_layers[key] = val
        new = {**params, "layers": out_layers}
        lm = params.get("lm_head")
        if lm is not None and lm.dtype != torch.int8:      # [D, V]
            q, scale = self._symmetric_int8(lm, axis=0)     # [1, V]
            new["lm_head"] = q
            new["lm_head_wscale"] = scale
        return new

    def activation_weights(self, params: Params) -> Params:
        """A copy of a parameter tree whose leaves the forward casts to
        the activation dtype on every use (the dense matrices, their
        biases, the embedding table, ``lm_head`` and its bias) are cast
        once; norms keep their dtype (the norms compute in fp32). Every
        forward over it computes exactly what it computes over ``params``,
        without casting the master weights at each layer of each step.
        int8 matrices and their scales stay as they are."""
        def cast(t: torch.Tensor) -> torch.Tensor:
            return t.to(self.adtype) if t.is_floating_point() else t

        mats = self._WEIGHT_ONLY_MATS + ("fc1", "fc2")
        layers = {k: (cast(v) if k in mats or (k.endswith("_bias") and
                                                k[:-5] in mats) else v)
                  for k, v in params["layers"].items()}
        out = {**params, "layers": layers,
               "embed": {**params["embed"],
                         "embedding": cast(params["embed"]["embedding"])}}
        for k in ("lm_head", "lm_head_bias"):
            if k in params:
                out[k] = cast(params[k])
        return out

    def _weight(self, container: Params, name: str) -> torch.Tensor:
        """The named matrix in activation dtype (int8 dequantized with an
        fp32 multiply, the product cast once)."""
        w = container[name]
        if w.dtype == torch.int8:
            return (w.float() * container[name + "_wscale"]).to(self.adtype)
        return w.to(self.adtype)

    def _dense(self, container: Params, name: str,
               inp: torch.Tensor) -> torch.Tensor:
        """``inp @ weight``; int8 weights go through the int8 matmul
        kernel, so only the int8 bytes are read."""
        w = container[name]
        if w.dtype != torch.int8:
            return inp @ w.to(self.adtype)
        return quant_matmul.int8_matmul(
            inp, w, container[name + "_wscale"]).to(self.adtype)

    # ---------------------------------------------------------------- block

    def _embed(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        # F.embedding rather than indexing: its CUDA backward sums the
        # rows of repeated ids in a fixed order (indexing's accumulates
        # with atomics), which keeps training steps reproducible
        return torch.nn.functional.embedding(
            ids.long(), params["embed"]["embedding"]).to(self.adtype)

    def _final_norm(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.arch == "phi":
            return layer_norm(x, params["final_norm"],
                              params["final_norm_bias"], self.cfg.rms_norm_eps)
        return rms_norm(x, params["final_norm"], self.cfg.rms_norm_eps)

    def _proj(self, layer: Params, name: str,
              inp: torch.Tensor) -> torch.Tensor:
        out = self._dense(layer, name, inp)
        bias = layer.get(f"{name}_bias")
        return out if bias is None else out + bias.to(self.adtype)

    def _mlp(self, layer: Params, h: torch.Tensor) -> torch.Tensor:
        gate = torch.nn.functional.silu(self._proj(layer, "w_gate", h))
        up = self._proj(layer, "w_up", h)
        return self._proj(layer, "w_down", gate * up)

    def _flash_eligible(self) -> bool:
        """Whether the flash kernel may serve a full-sequence forward for
        this config: it speaks neither softcapping, per-layer windows nor
        a non-default softmax scale (the effective scale is compared)."""
        cfg = self.cfg
        return (cfg.attention == "flash"
                and not cfg.attn_logit_softcap
                and cfg.sliding_window_pattern == 1
                and (cfg.query_pre_attn_scalar is None
                     or cfg.query_pre_attn_scalar == cfg.head_dim_))

    def _attention(self, q, k, v, kv_mask, q_positions, kv_positions,
                   allow_flash: bool,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """Flash kernel for the full-sequence causal path on right-padded
        batches (pad keys sit above every real query's diagonal, so no
        mask is needed) and on packed ones (the segment ids go to the
        kernel); the einsum path otherwise."""
        window = self.cfg.sliding_window or None
        if allow_flash and q.shape[1] == k.shape[1]:
            return flash_attention.flash_causal_attention(
                q, k, v, segment_ids=segment_ids, window=window)
        return causal_attention(
            q, k, v, kv_segment_mask=kv_mask, q_positions=q_positions,
            kv_positions=kv_positions, window=window,
            softmax_scale=self._softmax_scale,
            logit_softcap=self.cfg.attn_logit_softcap)

    def _block(self, layer: Params, x: torch.Tensor, cos, sin,
               kv_mask: Optional[torch.Tensor], positions: torch.Tensor,
               allow_flash: bool,
               segment_ids: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """One decoder block over a full sequence. Returns (output,
        (k, v)) — k/v for the cache writes."""
        cfg = self.cfg
        dh = cfg.head_dim_
        b, t, _ = x.shape
        phi = cfg.arch == "phi"
        if phi:
            h = layer_norm(x, layer["ln"], layer["ln_bias"], cfg.rms_norm_eps)
        else:
            h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        q = self._proj(layer, "wq", h).reshape(b, t, cfg.num_heads, dh)
        k = self._proj(layer, "wk", h).reshape(b, t, cfg.num_kv_heads, dh)
        v = self._proj(layer, "wv", h).reshape(b, t, cfg.num_kv_heads, dh)
        q = apply_rotary(q, cos, sin, rotary_dim=cfg.rotary_dim_)
        k = apply_rotary(k, cos, sin, rotary_dim=cfg.rotary_dim_)
        attn = self._attention(q, k, v, kv_mask, positions, positions,
                               allow_flash, segment_ids)
        attn_out = self._proj(layer, "wo", attn.reshape(b, t, -1))
        if phi:   # parallel residual: attention and MLP both read h
            ff = torch.nn.functional.gelu(self._proj(layer, "fc1", h),
                                          approximate="tanh")
            return x + attn_out + self._proj(layer, "fc2", ff), (k, v)
        x = x + attn_out
        h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
        return x + self._mlp(layer, h), (k, v)

    def _layer_list(self, params: Params):
        """Per-layer parameter dicts: ``params["layers"]`` is either the
        stacked [L, ...] tree or already a list of per-layer dicts (the
        trainer's per-layer views, which are its autograd leaves: indexing
        a stacked leaf would make every layer's backward write a
        full-size zero gradient for the whole stack)."""
        layers = params["layers"]
        if isinstance(layers, (list, tuple)):
            return layers
        return [_layer(layers, i) for i in range(self.cfg.num_layers)]

    # ---------------------------------------------------- training forward

    def hidden_states(
        self,
        params: Params,
        input_ids: torch.Tensor,                          # [B, T]
        attention_mask: Optional[torch.Tensor] = None,    # [B, T] 1 = real
        segment_ids: Optional[torch.Tensor] = None,       # [B, T] packing
    ) -> torch.Tensor:
        """Full-sequence forward up to the final norm, [B, T, D],
        differentiable in the parameters.

        Positions: the index among real tokens (cumsum of the mask)
        without segments, restarting at each packed segment with them,
        else arange. Under flash the kernel takes the segment ids and no
        mask is built (pad keys sit above every real query's diagonal);
        otherwise attention_mask AND same-segment form an explicit
        [B, T, T] mask for ``causal_attention``. ``remat: full``
        checkpoints every layer (its forward runs again in the
        backward)."""
        cfg = self.cfg
        if cfg.remat not in ("none", "full"):
            raise NotImplementedError(
                f"remat {cfg.remat!r} is not ported yet (ROADMAP.md §3, "
                "training items); use 'full' or 'none'")
        if cfg.pipeline_stages > 1:
            raise NotImplementedError(
                "pipeline parallelism is not ported yet (ROADMAP.md §1, "
                "multi-GPU parallelism)")
        b, t = input_ids.shape
        dev = input_ids.device
        ar = torch.arange(t, device=dev)[None, :]
        if segment_ids is None and attention_mask is not None:
            positions = (attention_mask.long().cumsum(1) - 1).clamp(min=0)
        elif segment_ids is not None:
            start = torch.ones((b, t), dtype=torch.bool, device=dev)
            start[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
            first = torch.where(start, ar, torch.zeros_like(ar))
            positions = ar - torch.cummax(first, dim=1).values
        else:
            positions = ar.expand(b, t)

        allow_flash = self._flash_eligible()
        kv_mask = None
        if not allow_flash:
            if attention_mask is not None:
                kv_mask = attention_mask[:, None, :].bool().expand(b, t, t)
            if segment_ids is not None:
                same = segment_ids[:, :, None] == segment_ids[:, None, :]
                kv_mask = same if kv_mask is None else kv_mask & same
        flash_segs = segment_ids if allow_flash else None

        x = self._embed(params, input_ids)
        cos, sin = rotary_angles(positions, cfg.rotary_dim_, cfg.rope_theta,
                                 scaling=cfg.rope_scaling)

        def layer_fwd(layer, x):
            return self._block(layer, x, cos, sin, kv_mask, positions,
                               allow_flash, flash_segs)[0]

        remat = cfg.remat == "full" and torch.is_grad_enabled()
        for layer in self._layer_list(params):
            if remat:
                x = checkpoint(layer_fwd, layer, x, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer_fwd(layer, x)
        return self._final_norm(params, x)

    def apply(self, params: Params, input_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None,
              segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits forward: [B, T] -> [B, T, V] in activation dtype."""
        h = self.hidden_states(params, input_ids, attention_mask,
                               segment_ids)
        return self.unembed(params, h)

    def unembed_params(self, params: Params
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(w [D, V] in activation dtype, bias [V] or None)."""
        if self.cfg.tie_embeddings:
            w = params["embed"]["embedding"].to(self.adtype).T
        else:
            w = self._weight(params, "lm_head")
        bias = params.get("lm_head_bias")
        return w, None if bias is None else bias.to(self.adtype)

    def unembed(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        """[..., D] -> [..., V] logits in activation dtype."""
        lm = params.get("lm_head")
        if lm is not None and lm.dtype == torch.int8:
            logits = self._dense(params, "lm_head", hidden)
            bias = params.get("lm_head_bias")
            bias = None if bias is None else bias.to(logits.dtype)
        else:
            w, bias = self.unembed_params(params)
            logits = hidden @ w
        if bias is not None:
            logits = logits + bias
        cap = self.cfg.final_logit_softcap
        if cap:
            logits = torch.tanh(logits / cap) * cap
        return logits

    # ------------------------------------------------------------- KV cache

    def _check_generation(self, entry: str) -> None:
        """The generation entry points run the llama block only."""
        if self.cfg.arch == "phi":
            raise NotImplementedError(
                f"Transformer.{entry}: phi prefill and decode are not ported "
                "yet (ROADMAP.md §2, phi prefill and decode); the phi block "
                "runs the training forward (hidden_states / apply) only")

    @property
    def _kv_int8(self) -> bool:
        return self.cfg.kv_cache_dtype == "int8"

    def _quantize_kv(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[..., D] -> (int8 values, fp32 scale [...]): per-position
        per-head symmetric quantization along the head dim."""
        q, scale = self._symmetric_int8(x, axis=-1)
        return q, scale[..., 0]

    def _dequantize_kv(self, q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
        return (q.float() * scale[..., None]).to(self.adtype)

    def init_cache(self, batch: int, max_len: int,
                   device: torch.device) -> Params:
        """Zero-filled contiguous cache: k/v [L, B, S, K, D] (int8 or the
        activation dtype), int8 scales K-major [L, B, K, S] fp32,
        valid [B, S], lengths [B] (next position per row), the host int
        ``step`` (decode steps taken) and ``col``, the column the next
        decode step writes, as a 0-dim int32 tensor on the device."""
        self._check_generation("init_cache")
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim_)
        kv_dtype = torch.int8 if self._kv_int8 else self.adtype
        cache = {
            "k": torch.zeros(shape, dtype=kv_dtype, device=device),
            "v": torch.zeros(shape, dtype=kv_dtype, device=device),
            "valid": torch.zeros((batch, max_len), dtype=torch.bool,
                                 device=device),
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device),
            "step": 0,
            "col": torch.zeros((), dtype=torch.int32, device=device),
        }
        if self._kv_int8:
            sshape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len)
            cache["k_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                           device=device)
            cache["v_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                           device=device)
        return cache

    @torch.no_grad()
    def prefill_external(self, params: Params, input_ids: torch.Tensor,
                         attention_mask: torch.Tensor,
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The prompt forward without a cache layout: (last-real-token
        logits [B, V], ks [L, B, T, KH, D], vs [L, B, T, KH, D]) in
        activation dtype. Prompts are right-padded; under flash no mask
        is built (pad keys sit above every real query's diagonal)."""
        self._check_generation("prefill_external")
        cfg = self.cfg
        b, t = input_ids.shape
        dev = input_ids.device
        positions = torch.arange(t, device=dev)[None, :].expand(b, t)
        flash_ok = self._flash_eligible()
        kv_mask = None
        if not flash_ok:
            kv_mask = attention_mask[:, None, :].bool().expand(b, t, t)
        x = self._embed(params, input_ids)
        cos, sin = rotary_angles(positions, cfg.rotary_dim_, cfg.rope_theta,
                                 scaling=cfg.rope_scaling)
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, (k, v) = self._block(_layer(params["layers"], i), x, cos, sin,
                                    kv_mask, positions, flash_ok)
            ks.append(k)
            vs.append(v)
        h = self._final_norm(params, x)
        lengths = attention_mask.to(torch.int32).sum(dim=1)
        last_idx = torch.clamp(lengths - 1, min=0).long()
        last_h = h[torch.arange(b, device=dev), last_idx]
        return self.unembed(params, last_h), torch.stack(ks), torch.stack(vs)

    forward = prefill_external

    @torch.no_grad()
    def prefill(self, params: Params, cache: Params,
                input_ids: torch.Tensor, attention_mask: torch.Tensor,
                ) -> Tuple[torch.Tensor, Params]:
        """Run the prompt, writing columns [0, T) of a zero-filled cache
        in place. Returns (last-real-token logits [B, V], cache)."""
        self._check_generation("prefill")
        t = input_ids.shape[1]
        logits, ks, vs = self.prefill_external(params, input_ids,
                                               attention_mask)
        cache["valid"][:, :t] = attention_mask.bool()
        cache["lengths"] = attention_mask.to(torch.int32).sum(dim=1).to(
            torch.int32)
        cache["step"] = 0
        if self._kv_int8:
            kq, k_s = self._quantize_kv(ks)
            vq, v_s = self._quantize_kv(vs)
            cache["k"][:, :, :t] = kq
            cache["v"][:, :, :t] = vq
            # [L, B, T, K] -> K-major [L, B, K, T]
            cache["k_scale"][..., :t] = k_s.transpose(2, 3)
            cache["v_scale"][..., :t] = v_s.transpose(2, 3)
        else:
            cache["k"][:, :, :t] = ks
            cache["v"][:, :, :t] = vs
        return logits, cache

    def start_decode(self, params: Params, input_ids: torch.Tensor,
                     attention_mask: torch.Tensor, max_new_tokens: int,
                     ) -> Tuple[torch.Tensor, Params]:
        """Prefill + decode bookkeeping. Returns (first logits, cache)."""
        b, t = input_ids.shape
        max_len = t + max_new_tokens
        cache0 = self.init_cache(b, max_len, input_ids.device)
        logits, cache = self.prefill(params, cache0, input_ids,
                                     attention_mask)
        cache["prompt_width"] = t
        cache["col"].fill_(t)
        cache["pos"] = torch.arange(
            max_len, dtype=torch.int32,
            device=input_ids.device)[None, :].repeat(b, 1)
        return logits, cache

    def _decode_layer(self, layer: Params, h_in: torch.Tensor, cos, sin,
                      attend):
        """Per-layer decode computation; ``attend(q, k, v)`` supplies the
        attention backend. Returns (output, (k, v))."""
        cfg = self.cfg
        b, t, _ = h_in.shape
        dh = cfg.head_dim_
        hn = rms_norm(h_in, layer["attn_norm"], cfg.rms_norm_eps)
        q = self._proj(layer, "wq", hn).reshape(b, t, cfg.num_heads, dh)
        k = self._proj(layer, "wk", hn).reshape(b, t, cfg.num_kv_heads, dh)
        v = self._proj(layer, "wv", hn).reshape(b, t, cfg.num_kv_heads, dh)
        q = apply_rotary(q, cos, sin, rotary_dim=cfg.rotary_dim_)
        k = apply_rotary(k, cos, sin, rotary_dim=cfg.rotary_dim_)
        attn = attend(q, k, v).reshape(b, t, cfg.num_heads * dh)
        x1 = h_in + self._proj(layer, "wo", attn)
        hn2 = rms_norm(x1, layer["mlp_norm"], cfg.rms_norm_eps)
        return x1 + self._mlp(layer, hn2), (k, v)

    @torch.no_grad()
    def decode_step(self, params: Params, cache: Params,
                    tokens: torch.Tensor,  # [B] the tokens just sampled
                    ) -> Tuple[torch.Tensor, Params]:
        """One decode step: write ``tokens`` at column prompt_T + step,
        return logits for the next token. Rotary and causality use each
        row's logical position (pads skipped via the valid mask). The
        cache is updated in place and returned. The column is read from
        ``cache["col"]`` on the device (the host int ``step`` serves the
        cache-full check only), and the step makes no host
        synchronisation, so it can be captured in a CUDA graph."""
        self._check_generation("decode_step")
        cfg = self.cfg
        if "prompt_width" not in cache:
            raise ValueError(
                "decode_step requires a cache produced by start_decode()")
        max_len = cache["k"].shape[2]
        if cache["prompt_width"] + cache["step"] >= max_len:
            raise ValueError(f"decode_step: cache of {max_len} columns is "
                             "full")
        col = cache["col"]                                 # 0-dim int32
        idx = col.reshape(1).long()                        # index_* take int64
        write_idx = cache["lengths"]                       # [B]
        positions = write_idx[:, None]                     # [B, 1]
        x = self._embed(params, tokens[:, None])
        cos, sin = rotary_angles(positions, cfg.rotary_dim_, cfg.rope_theta,
                                 scaling=cfg.rope_scaling)
        kv_pos = cache["pos"]
        window = cfg.sliding_window or None
        # "auto": int8 caches take the kernel (in-kernel dequant); "on":
        # bf16 caches too; "off": the einsum path everywhere
        use_kernel = cfg.decode_kernel != "off" and (
            self._kv_int8 or cfg.decode_kernel == "on")
        bias = None
        if use_kernel:   # validity+causality+window, once per step
            bias = decode_kernel.decode_bias(cache["valid"], positions,
                                             kv_pos, window)

        for i in range(cfg.num_layers):
            layer = _layer(params["layers"], i)
            k_cache, v_cache = cache["k"][i], cache["v"][i]
            k_s = v_s = None
            if self._kv_int8:
                k_s, v_s = cache["k_scale"][i], cache["v_scale"][i]
                if not use_kernel:   # K-major [B, K, S] -> positional
                    k_cache = self._dequantize_kv(k_cache, k_s.transpose(1, 2))
                    v_cache = self._dequantize_kv(v_cache, v_s.transpose(1, 2))

            def attend(q, k, v, k_cache=k_cache, v_cache=v_cache, k_s=k_s,
                       v_s=v_s):
                if use_kernel:
                    return decode_kernel.flash_decode_attention(
                        q, k_cache, v_cache, k, v, bias=bias,
                        k_scale=k_s, v_scale=v_s,
                        kv_fill=col,  # no valid column at/after the write
                        softmax_scale=self._softmax_scale,
                        logit_softcap=cfg.attn_logit_softcap)
                return decode_attention(
                    q, k_cache, v_cache, k, v, kv_valid=cache["valid"],
                    q_positions=positions, kv_positions=kv_pos,
                    window=window, softmax_scale=self._softmax_scale,
                    logit_softcap=cfg.attn_logit_softcap)

            x, (k_new, v_new) = self._decode_layer(layer, x, cos, sin, attend)
            # this layer has attended: its column can be written now
            if self._kv_int8:
                kq, ks_new = self._quantize_kv(k_new)   # [B, 1, K, D]
                vq, vs_new = self._quantize_kv(v_new)
                cache["k"][i].index_copy_(1, idx, kq)
                cache["v"][i].index_copy_(1, idx, vq)
                # [B, 1, K] -> K-major [B, K, 1]
                cache["k_scale"][i].index_copy_(2, idx, ks_new.transpose(1, 2))
                cache["v_scale"][i].index_copy_(2, idx, vs_new.transpose(1, 2))
            else:
                cache["k"][i].index_copy_(1, idx, k_new.to(cache["k"].dtype))
                cache["v"][i].index_copy_(1, idx, v_new.to(cache["v"].dtype))

        h = self._final_norm(params, x)
        logits = self.unembed(params, h[:, 0])
        cache["valid"].index_fill_(1, idx, True)
        cache["pos"].index_copy_(1, idx, write_idx[:, None])
        write_idx.add_(1)                                  # cache["lengths"]
        col.add_(1)
        cache["step"] += 1
        return logits, cache
