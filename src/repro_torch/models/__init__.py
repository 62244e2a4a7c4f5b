from .common import ParamSpec, init_params, tree_to
from .config import MLAConfig, ModelConfig, MoEConfig
from .model import DecoderLM

__all__ = ["DecoderLM", "MLAConfig", "ModelConfig", "MoEConfig",
           "ParamSpec", "init_params", "tree_to"]
