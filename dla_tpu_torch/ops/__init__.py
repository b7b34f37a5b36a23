from dla_tpu_torch.ops.attention import causal_attention, decode_attention
from dla_tpu_torch.ops.norms import layer_norm, rms_norm
from dla_tpu_torch.ops.rotary import apply_rotary, rotary_angles

__all__ = [
    "causal_attention",
    "decode_attention",
    "layer_norm",
    "rms_norm",
    "apply_rotary",
    "rotary_angles",
]
