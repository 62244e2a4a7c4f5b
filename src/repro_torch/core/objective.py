"""DSE objective (paper Eq. 1):  minimize  L(h)^alpha * E(h)^(1-alpha).

`spec_decode` prices speculative decoding inside the objective, so the
Pareto fronts the GA traces can trade hardware against a software
speculation factor the same way they trade it against precision.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .hw import HWConfig
from .simulator import EdgeCIMSimulator, SimReport, SpecKnob
from .workload import SLMSpec


@dataclass(frozen=True)
class Objective:
    spec: SLMSpec
    alpha: float = 0.5
    prefill_tokens: int = 128
    gen_tokens: int = 128
    w_bits: int = 4
    a_bits: int = 8
    spec_decode: Optional[SpecKnob] = None

    def __post_init__(self):
        assert 0.0 <= self.alpha <= 1.0

    def evaluate(self, h: HWConfig,
                 sim: EdgeCIMSimulator | None = None) -> SimReport:
        sim = sim or EdgeCIMSimulator()
        return sim.generate(self.spec, h, self.prefill_tokens,
                            self.gen_tokens, self.w_bits, self.a_bits,
                            spec_decode=self.spec_decode)

    def cost(self, report: SimReport) -> float:
        """Scale-invariant latency-energy trade-off (Eq. 1)."""
        return (report.latency_s ** self.alpha) * \
               (report.energy_j ** (1.0 - self.alpha))

    def __call__(self, h: HWConfig,
                 sim: EdgeCIMSimulator | None = None) -> float:
        return self.cost(self.evaluate(h, sim))
