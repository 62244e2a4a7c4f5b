"""EdgeCIM core: the paper's contribution — analytical CIM simulator + GA
DSE (the port's own copies of `repro.core`, numpy and stdlib only; the
energy meter, `repro_torch.obs.energy`, runs the simulator for every
served token).

Public API:
    HWConfig, TechConstants      hardware design point / 65nm constants
    SLMSpec                      workload description
    EdgeCIMSimulator, SimReport  analytical simulation
    Objective                    L^a * E^(1-a) cost (Eq. 1)
    GeneticDSE, run_dse          the paper's GA optimization engine
    pareto_front                 Pareto utilities
"""
from .hw import (HWConfig, TechConstants, DEFAULT_TECH, chip_area_mm2,
                 peak_tops, stream_bandwidth, search_space_size)
from .workload import SLMSpec, Stage, make_dense_spec
from .simulator import (EdgeCIMSimulator, SimReport, SpecKnob,
                        decode_fraction)
from .objective import Objective
from .dse import GeneticDSE, GAResult, run_dse, decode, encode
from .pareto import pareto_front, pareto_reports

__all__ = [
    "HWConfig", "TechConstants", "DEFAULT_TECH", "chip_area_mm2", "peak_tops",
    "stream_bandwidth", "search_space_size", "SLMSpec", "Stage",
    "make_dense_spec", "EdgeCIMSimulator", "SimReport", "SpecKnob",
    "decode_fraction",
    "Objective", "GeneticDSE", "GAResult", "run_dse", "decode", "encode",
    "pareto_front", "pareto_reports",
]
