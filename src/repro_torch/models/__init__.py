from .common import ParamSpec, init_params, tree_to
from .config import ModelConfig, MoEConfig
from .model import DecoderLM

__all__ = ["DecoderLM", "ModelConfig", "MoEConfig", "ParamSpec",
           "init_params", "tree_to"]
