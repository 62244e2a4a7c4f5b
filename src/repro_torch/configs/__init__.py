"""Config registry: assigned architectures + paper SLM suite.

`get_config(arch_id)` returns the full-scale ModelConfig for an assigned
architecture; `get_smoke_config(arch_id)` a reduced same-family variant.
`PAPER_SLMS` maps the paper's 12 benchmark SLMs to core.SLMSpec objects.
"""
from .registry import (ARCH_IDS, get_config, get_smoke_config, register,
                       input_specs, SHAPE_IDS)
from .paper_slms import PAPER_SLMS, paper_slm

__all__ = ["ARCH_IDS", "SHAPE_IDS", "get_config", "get_smoke_config",
           "register", "input_specs", "PAPER_SLMS", "paper_slm"]
