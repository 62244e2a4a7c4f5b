"""The port's design-space search (`repro_torch.core`: GA, objective,
Pareto front) and the paper's SLM suite (`repro_torch.configs`) against
the JAX package's `repro.core` / `repro.configs`: the same seeds give
bit-equal results (both draw from `np.random.default_rng(seed)`), at the
small sizes `tests/test_dse.py` runs."""
import dataclasses

import numpy as np
import pytest

from repro.configs.paper_slms import PAPER_SLMS as JAX_SLMS
from repro import core as jcore
from repro.core import dse as jdse
from repro_torch.configs import PAPER_SLMS, paper_slm
from repro_torch import core as tcore
from repro_torch.core import dse as tdse


def _evaluated(res):
    return [(h.as_tuple(), lat, en, cost) for h, lat, en, cost in
            res.evaluated]


# (slm, alpha, w_bits, seed, population, generations): test_dse.py's runs
RUNS = [("llama3.2-3b", 0.5, 8, 0, 10, 15),
        ("qwen2.5-0.5b", 1.0, 4, 7, 8, 5),
        ("qwen2.5-0.5b", 1.0, 4, 1, 8, 10),
        ("llama3.2-1b", 1.0, 4, 3, 12, 12),
        ("llama3.2-1b", 0.0, 4, 3, 12, 12)]


@pytest.mark.parametrize("slm,alpha,w_bits,seed,pop,gens", RUNS)
def test_run_dse_equals_jax(slm, alpha, w_bits, seed, pop, gens):
    a = jcore.run_dse(JAX_SLMS[slm], alpha=alpha, w_bits=w_bits, seed=seed,
                      pop_size=pop, generations=gens)
    b = tcore.run_dse(PAPER_SLMS[slm], alpha=alpha, w_bits=w_bits,
                      seed=seed, pop_size=pop, generations=gens)
    assert a.best.as_tuple() == b.best.as_tuple()
    assert a.best_cost == b.best_cost
    assert a.history == b.history
    assert _evaluated(a) == _evaluated(b)
    assert dataclasses.asdict(a.best_report) == \
        dataclasses.asdict(b.best_report)


def test_genetic_dse_options_equal_jax():
    """The GA's knobs (crossover probability, tournament, elitism) and a
    prefill / generation mix other than the default."""
    kw = dict(pop_size=9, generations=6, eta_crossover=5.0,
              eta_mutation=7.0, p_crossover=0.6, tournament_k=3,
              elitism=1, seed=11)
    a = jcore.GeneticDSE(jcore.Objective(
        spec=JAX_SLMS["smollm2-1.7b"], alpha=0.3, prefill_tokens=64,
        gen_tokens=32, w_bits=8), **kw).run()
    b = tcore.GeneticDSE(tcore.Objective(
        spec=PAPER_SLMS["smollm2-1.7b"], alpha=0.3, prefill_tokens=64,
        gen_tokens=32, w_bits=8), **kw).run()
    assert a.best.as_tuple() == b.best.as_tuple()
    assert (a.best_cost, a.history) == (b.best_cost, b.history)
    assert _evaluated(a) == _evaluated(b)


def test_objective_cost_and_operators_equal_jax():
    rng = np.random.default_rng(5)
    for alpha in (0.0, 0.25, 1.0):
        oj = jcore.Objective(spec=JAX_SLMS["qwen3-1.7b"], alpha=alpha)
        ot = tcore.Objective(spec=PAPER_SLMS["qwen3-1.7b"], alpha=alpha)
        for _ in range(6):
            g = rng.random(tdse.N_GENES)
            rj, rt = oj.evaluate(jdse.decode(g)), ot.evaluate(tdse.decode(g))
            assert dataclasses.asdict(rj) == dataclasses.asdict(rt)
            assert oj.cost(rj) == ot.cost(rt)
            assert oj(jdse.decode(g)) == ot(tdse.decode(g))
    for seed in range(4):
        p1, p2 = rng.random(9), rng.random(9)
        cj = jdse.sbx_crossover(p1, p2, np.random.default_rng(seed))
        ct = tdse.sbx_crossover(p1, p2, np.random.default_rng(seed))
        assert all(np.array_equal(x, y) for x, y in zip(cj, ct))
        mj = jdse.polynomial_mutation(p1, np.random.default_rng(seed),
                                      p_mut=0.5)
        mt = tdse.polynomial_mutation(p1, np.random.default_rng(seed),
                                      p_mut=0.5)
        assert np.array_equal(mj, mt)


def test_pareto_front_equals_jax():
    rng = np.random.default_rng(9)
    for n in (1, 7, 40):
        pts = [tuple(p) for p in rng.random((n, 2))]
        pts += pts[:2]                          # ties
        assert jcore.pareto_front(pts) == tcore.pareto_front(pts)
    oj = jcore.Objective(spec=JAX_SLMS["tinyllama-1.1b"])
    ot = tcore.Objective(spec=PAPER_SLMS["tinyllama-1.1b"])
    genomes = rng.random((12, tdse.N_GENES))
    front_j = jcore.pareto_reports(oj.evaluate(jdse.decode(g))
                                   for g in genomes)
    front_t = tcore.pareto_reports(ot.evaluate(tdse.decode(g))
                                   for g in genomes)
    assert [dataclasses.asdict(r) for r in front_j] == \
        [dataclasses.asdict(r) for r in front_t]


def test_encode_decode_every_gene_equals_jax():
    assert tdse.GENE_CHOICES == jdse.GENE_CHOICES
    base = tcore.HWConfig().as_tuple()
    for k, choices in enumerate(tdse.GENE_CHOICES):
        for v in choices:
            vals = list(base)
            vals[k] = v
            ht, hj = tcore.HWConfig(*vals), jcore.HWConfig(*vals)
            assert np.array_equal(tdse.encode(ht), jdse.encode(hj))
            assert tdse.decode(tdse.encode(ht)) == ht
            g = tdse.encode(ht)
            assert tdse.decode(g).as_tuple() == jdse.decode(g).as_tuple()


@pytest.mark.parametrize("name", sorted(JAX_SLMS))
def test_paper_slm_equals_jax(name):
    assert sorted(PAPER_SLMS) == sorted(JAX_SLMS)
    assert dataclasses.asdict(paper_slm(name)) == \
        dataclasses.asdict(JAX_SLMS[name])
