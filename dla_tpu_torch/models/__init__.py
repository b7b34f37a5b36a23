from dla_tpu_torch.models.config import (ModelConfig, get_model_config,
                                         known_models, register_model)
from dla_tpu_torch.models.transformer import Transformer

__all__ = [
    "ModelConfig",
    "get_model_config",
    "known_models",
    "register_model",
    "Transformer",
]
