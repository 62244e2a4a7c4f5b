"""EdgeCIM core: the paper's analytical CIM simulator, which the energy
meter (`repro_torch.obs.energy`) runs for every served token.

Public API:
    HWConfig, TechConstants      hardware design point / 65nm constants
    SLMSpec                      workload description
    EdgeCIMSimulator, SimReport  analytical simulation

The JAX package's design-space search (objective, GA, Pareto front)
comes with the slice that reads it.
"""
from .hw import (HWConfig, TechConstants, DEFAULT_TECH, chip_area_mm2,
                 peak_tops, stream_bandwidth, search_space_size)
from .workload import SLMSpec, Stage, make_dense_spec
from .simulator import (EdgeCIMSimulator, SimReport, SpecKnob,
                        decode_fraction)

__all__ = [
    "HWConfig", "TechConstants", "DEFAULT_TECH", "chip_area_mm2", "peak_tops",
    "stream_bandwidth", "search_space_size", "SLMSpec", "Stage",
    "make_dense_spec", "EdgeCIMSimulator", "SimReport", "SpecKnob",
    "decode_fraction",
]
