from .common import ParamSpec, init_params, tree_to
from .config import ModelConfig
from .model import DecoderLM

__all__ = ["DecoderLM", "ModelConfig", "ParamSpec", "init_params", "tree_to"]
