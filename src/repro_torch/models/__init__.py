from .common import ParamSpec, init_params, tree_to
from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig, ZambaConfig
from .model import DecoderLM

__all__ = ["DecoderLM", "MLAConfig", "ModelConfig", "MoEConfig",
           "ParamSpec", "SSMConfig", "ZambaConfig", "init_params",
           "tree_to"]
