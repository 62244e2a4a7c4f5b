"""Genetic-algorithm design-space exploration (paper Sec. IV).

Exactly the paper's recipe: population 20, 50 generations, simulated
binary crossover (SBX, crossover probability = 1) and polynomial mutation
with distribution index eta = 3, over the ~3.1e6-point space H.

Genome: 9 real genes in [0, 1], each decoded to its discrete choice list
(Cv, Ch, Tv_act, Th_act, M, P^2, three bus widths).  Real-coded SBX /
polynomial mutation operate on the unit cube; decoding rounds to the
nearest valid choice — the standard discrete-SBX construction.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .hw import (ACTIVE_TILE_CHOICES, BUS_WIDTH_CHOICES, CLUSTER_CHOICES,
                 HWConfig, PE_COUNT_CHOICES, TILE_MULT_CHOICES)
from .objective import Objective
from .simulator import EdgeCIMSimulator, SimReport

GENE_CHOICES: Tuple[Sequence[int], ...] = (
    CLUSTER_CHOICES, CLUSTER_CHOICES,
    ACTIVE_TILE_CHOICES, ACTIVE_TILE_CHOICES,
    TILE_MULT_CHOICES, PE_COUNT_CHOICES,
    BUS_WIDTH_CHOICES, BUS_WIDTH_CHOICES, BUS_WIDTH_CHOICES,
)
N_GENES = len(GENE_CHOICES)


def decode(genome: np.ndarray) -> HWConfig:
    vals = []
    for g, choices in zip(genome, GENE_CHOICES):
        i = min(len(choices) - 1, int(np.clip(g, 0.0, 1.0) * len(choices)))
        vals.append(choices[i])
    return HWConfig(*vals)


def encode(h: HWConfig) -> np.ndarray:
    raw = h.as_tuple()
    g = np.empty(N_GENES)
    for k, (v, choices) in enumerate(zip(raw, GENE_CHOICES)):
        g[k] = (choices.index(v) + 0.5) / len(choices)
    return g


def sbx_crossover(p1: np.ndarray, p2: np.ndarray, rng: np.random.Generator,
                  eta: float = 3.0) -> Tuple[np.ndarray, np.ndarray]:
    """Simulated binary crossover (Deb & Agrawal 1995), per-gene."""
    u = rng.random(N_GENES)
    beta = np.where(u <= 0.5,
                    (2.0 * u) ** (1.0 / (eta + 1.0)),
                    (1.0 / (2.0 * (1.0 - u))) ** (1.0 / (eta + 1.0)))
    c1 = 0.5 * ((1 + beta) * p1 + (1 - beta) * p2)
    c2 = 0.5 * ((1 - beta) * p1 + (1 + beta) * p2)
    return np.clip(c1, 0.0, 1.0), np.clip(c2, 0.0, 1.0)


def polynomial_mutation(g: np.ndarray, rng: np.random.Generator,
                        eta: float = 3.0, p_mut: Optional[float] = None
                        ) -> np.ndarray:
    """Polynomial mutation (Deb), distribution index eta = 3 per the paper."""
    if p_mut is None:
        p_mut = 1.0 / N_GENES
    out = g.copy()
    mask = rng.random(N_GENES) < p_mut
    u = rng.random(N_GENES)
    delta = np.where(u < 0.5,
                     (2.0 * u) ** (1.0 / (eta + 1.0)) - 1.0,
                     1.0 - (2.0 * (1.0 - u)) ** (1.0 / (eta + 1.0)))
    out[mask] = np.clip(out[mask] + delta[mask], 0.0, 1.0)
    return out


@dataclass
class GAResult:
    best: HWConfig
    best_report: SimReport
    best_cost: float
    history: List[float] = field(default_factory=list)      # best cost/gen
    evaluated: List[Tuple[HWConfig, float, float, float]] = \
        field(default_factory=list)                          # (h, L, E, cost)


class GeneticDSE:
    """The paper's optimization engine."""

    def __init__(self, objective: Objective, pop_size: int = 20,
                 generations: int = 50, eta_crossover: float = 3.0,
                 eta_mutation: float = 3.0, p_crossover: float = 1.0,
                 tournament_k: int = 2, elitism: int = 2,
                 sim: Optional[EdgeCIMSimulator] = None,
                 seed: int = 0):
        self.obj = objective
        self.pop_size = pop_size
        self.generations = generations
        self.eta_c = eta_crossover
        self.eta_m = eta_mutation
        self.p_c = p_crossover
        self.tournament_k = tournament_k
        self.elitism = elitism
        self.sim = sim or EdgeCIMSimulator()
        self.rng = np.random.default_rng(seed)
        self._cache: dict = {}

    # ------------------------------------------------------------------
    def _evaluate(self, h: HWConfig, result: GAResult) -> float:
        key = h.as_tuple()
        if key in self._cache:
            return self._cache[key][0]
        rep = self.obj.evaluate(h, self.sim)
        cost = self.obj.cost(rep)
        self._cache[key] = (cost, rep)
        result.evaluated.append((h, rep.latency_s, rep.energy_j, cost))
        return cost

    def _tournament(self, pop: List[np.ndarray], costs: np.ndarray
                    ) -> np.ndarray:
        idx = self.rng.integers(0, len(pop), size=self.tournament_k)
        return pop[int(idx[np.argmin(costs[idx])])]

    # ------------------------------------------------------------------
    def run(self) -> GAResult:
        result = GAResult(best=HWConfig(), best_report=None, best_cost=math.inf)  # type: ignore
        pop = [self.rng.random(N_GENES) for _ in range(self.pop_size)]

        for _gen in range(self.generations):
            configs = [decode(g) for g in pop]
            costs = np.array([self._evaluate(h, result) for h in configs])

            order = np.argsort(costs)
            if costs[order[0]] < result.best_cost:
                best_h = configs[order[0]]
                result.best_cost = float(costs[order[0]])
                result.best = best_h
                result.best_report = self._cache[best_h.as_tuple()][1]
            result.history.append(result.best_cost)

            # next generation: elitism + SBX + polynomial mutation
            next_pop: List[np.ndarray] = [pop[i].copy() for i in order[:self.elitism]]
            while len(next_pop) < self.pop_size:
                p1 = self._tournament(pop, costs)
                p2 = self._tournament(pop, costs)
                if self.rng.random() < self.p_c:
                    c1, c2 = sbx_crossover(p1, p2, self.rng, self.eta_c)
                else:
                    c1, c2 = p1.copy(), p2.copy()
                next_pop.append(polynomial_mutation(c1, self.rng, self.eta_m))
                if len(next_pop) < self.pop_size:
                    next_pop.append(polynomial_mutation(c2, self.rng, self.eta_m))
            pop = next_pop

        return result


def run_dse(spec, alpha: float = 1.0, w_bits: int = 4, a_bits: int = 8,
            prefill_tokens: int = 128, gen_tokens: int = 128,
            seed: int = 0, pop_size: int = 20, generations: int = 50
            ) -> GAResult:
    """One-call DSE entry point used by benchmarks and the launcher."""
    obj = Objective(spec=spec, alpha=alpha, prefill_tokens=prefill_tokens,
                    gen_tokens=gen_tokens, w_bits=w_bits, a_bits=a_bits)
    ga = GeneticDSE(obj, pop_size=pop_size, generations=generations, seed=seed)
    return ga.run()
