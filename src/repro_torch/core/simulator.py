"""End-to-end analytical simulator for EdgeCIM decode (+ prefill estimate).

Reports latency, energy, and area for executing the decoding phase of a
decoder-only SLM on a candidate hardware configuration h — the evaluation
engine behind the DSE (paper Sec. III-A / IV).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np

from .hw import HWConfig, TechConstants, DEFAULT_TECH, chip_area_mm2, peak_tops
from .stages import StageCost, stage_cost, stage_cost_vec
from .workload import SLMSpec, Stage


@dataclass(frozen=True)
class SpecKnob:
    """Speculative-decoding factor for the analytical model.

    Decode's bottleneck is the weight stream (one full pass per token);
    a verify step streams weights ONCE for a (k+1)-token window and
    keeps E[accepted+bonus] of them — the same arithmetic-intensity
    lever the DSE prices precision with, so Pareto fronts can price
    spec decode too.  Per verify step:

      weight_elems, kv_stream   x1       (shared across the window; the
                                          multi-query kernel makes one
                                          pass over the pages)
      macs, vector, writeback   x(k+1)   (every window position computes)

    plus `draft_cost_ratio` x k target-token-equivalents of drafting
    (0 for the model-free n-gram drafter; ~the parameter ratio for a
    small draft model).  `accept_rate` is the measured per-token
    acceptance probability (spec_bench.py reports it), modeled i.i.d.
    """
    k: int = 4
    accept_rate: float = 0.7
    draft_cost_ratio: float = 0.0

    def tokens_per_step(self) -> float:
        """E[tokens emitted per verify step] = (1 - a^(k+1)) / (1 - a)
        (accepted prefix of i.i.d. Bernoulli(a) draws, plus the bonus)."""
        a = min(max(self.accept_rate, 0.0), 1.0)
        if a >= 1.0:
            return float(self.k + 1)
        return float((1.0 - a ** (self.k + 1)) / (1.0 - a))


@dataclass(frozen=True)
class SimReport:
    """Simulation result for generating `gen_tokens` after `prefill_tokens`."""
    model: str
    hw: HWConfig
    w_bits: int
    a_bits: int
    prefill_tokens: int
    gen_tokens: int
    latency_s: float
    energy_j: float
    area_mm2: float
    stage_seconds: Dict[str, float]
    stage_joules: Dict[str, float]
    spec_decode: Optional[SpecKnob] = None

    @property
    def tokens_per_s(self) -> float:
        return self.gen_tokens / self.latency_s

    @property
    def tokens_per_j(self) -> float:
        return self.gen_tokens / self.energy_j

    @property
    def edp(self) -> float:
        return self.latency_s * self.energy_j

    def peak_tops(self, tech: TechConstants = DEFAULT_TECH) -> float:
        return peak_tops(self.hw, min(self.w_bits, self.a_bits), tech)

    def tops_per_w_per_mm2(self, tech: TechConstants = DEFAULT_TECH) -> float:
        avg_power = self.energy_j / self.latency_s
        return self.peak_tops(tech) / avg_power / self.area_mm2


class EdgeCIMSimulator:
    """Dataflow-aware analytical simulator (Sec. IV): captures the
    PE/tile/cluster/chip hierarchy, partitioning, active-tile pipelining,
    inter-stage dependencies, DRAM transfers, and compute/transfer overlap."""

    def __init__(self, tech: TechConstants = DEFAULT_TECH):
        self.tech = tech

    # ------------------------------------------------------------------
    def decode_token(self, spec: SLMSpec, h: HWConfig, seq: float,
                     w_bits: int = 4, a_bits: int = 8) -> StageCost:
        """Exact cost of one decode step at KV length `seq` (all layers)."""
        total = StageCost(0.0, 0.0)
        stages = spec.decode_stages(seq)
        mult = spec.layer_multiplicity()
        assert len(stages) == len(mult)
        for st, m in zip(stages, mult):
            total = total + stage_cost(st, h, w_bits, a_bits, self.tech).scale(m)
        total = total + stage_cost(spec.embed_stage(), h, w_bits, a_bits, self.tech)
        total = total + stage_cost(spec.head_stage(), h, w_bits, a_bits, self.tech)
        return total

    # ------------------------------------------------------------------
    def generate(self, spec: SLMSpec, h: HWConfig, prefill_tokens: int = 128,
                 gen_tokens: int = 128, w_bits: int = 4, a_bits: int = 8,
                 spec_decode: Optional[SpecKnob] = None) -> SimReport:
        """Full decoding run: token t sees KV length prefill + t.

        `spec_decode` prices speculative decoding: each emitted token
        costs 1/E of a (k+1)-query verify step (weights/KV streamed
        once, compute x(k+1)) plus k/E x draft_cost_ratio plain-token
        equivalents of drafting."""
        tech = self.tech
        area = chip_area_mm2(h, tech)
        if spec_decode is not None:
            E = spec_decode.tokens_per_step()
            kq = spec_decode.k + 1              # window width per verify
            draft_tok = spec_decode.k * spec_decode.draft_cost_ratio / E

            def verify_stage(st: Stage) -> Stage:
                return replace(st, macs=st.macs * kq,
                               vector_ops=st.vector_ops * kq,
                               writeback_elems=st.writeback_elems * kq)

            def spec_mix(plain_s, plain_j, ver_s, ver_j):
                return (ver_s / E + draft_tok * plain_s,
                        ver_j / E + draft_tok * plain_j)

        # ---- seq-independent stages: cost once, multiply by gen_tokens ----
        seqs = prefill_tokens + np.arange(gen_tokens, dtype=np.float64)
        stage_s: Dict[str, float] = {}
        stage_j: Dict[str, float] = {}
        total_s = 0.0
        total_j = 0.0

        stages0 = spec.decode_stages(float(seqs[0]))
        mult = spec.layer_multiplicity()
        for idx, (st, m) in enumerate(zip(stages0, mult)):
            if st.kv_stream_elems and st.name in ("attention",):
                # KV grows with seq: vectorize over all generated tokens
                kv = np.array([
                    spec.decode_stages(float(s))[idx].kv_stream_elems
                    for s in (seqs[0], seqs[-1])
                ])
                # kv stream is linear in seq -> interpolate exactly
                kv_all = np.interp(seqs, [seqs[0], seqs[-1]], kv)
                ratio = kv_all / max(st.kv_stream_elems, 1.0)
                s_vec, j_vec = stage_cost_vec(
                    np.full_like(seqs, st.weight_elems), kv_all,
                    st.macs * ratio, st.vector_ops * ratio,
                    np.full_like(seqs, st.writeback_elems),
                    h, w_bits, a_bits, tech)
                if spec_decode is not None:
                    v_s, v_j = stage_cost_vec(
                        np.full_like(seqs, st.weight_elems), kv_all,
                        st.macs * ratio * kq, st.vector_ops * ratio * kq,
                        np.full_like(seqs, st.writeback_elems * kq),
                        h, w_bits, a_bits, tech)
                    s_vec, j_vec = spec_mix(s_vec, j_vec, v_s, v_j)
                s_sum, j_sum = float(s_vec.sum()) * m, float(j_vec.sum()) * m
            else:
                c = stage_cost(st, h, w_bits, a_bits, tech).scale(m)
                sec_t, j_t = c.seconds, c.joules
                if spec_decode is not None:
                    cv = stage_cost(verify_stage(st), h, w_bits, a_bits,
                                    tech).scale(m)
                    sec_t, j_t = spec_mix(sec_t, j_t, cv.seconds, cv.joules)
                s_sum, j_sum = sec_t * gen_tokens, j_t * gen_tokens
            stage_s[st.name] = stage_s.get(st.name, 0.0) + s_sum
            stage_j[st.name] = stage_j.get(st.name, 0.0) + j_sum
            total_s += s_sum
            total_j += j_sum

        for st in (spec.embed_stage(), spec.head_stage()):
            c = stage_cost(st, h, w_bits, a_bits, tech)
            sec_t, j_t = c.seconds, c.joules
            if spec_decode is not None:
                cv = stage_cost(verify_stage(st), h, w_bits, a_bits, tech)
                sec_t, j_t = spec_mix(sec_t, j_t, cv.seconds, cv.joules)
            stage_s[st.name] = sec_t * gen_tokens
            stage_j[st.name] = j_t * gen_tokens
            total_s += sec_t * gen_tokens
            total_j += j_t * gen_tokens

        # ---- static (leakage) energy over the whole run --------------------
        p_static = area * tech.p_static_mm2
        e_static = p_static * total_s
        stage_j["static"] = e_static
        total_j += e_static

        return SimReport(
            model=spec.name, hw=h, w_bits=w_bits, a_bits=a_bits,
            prefill_tokens=prefill_tokens, gen_tokens=gen_tokens,
            latency_s=total_s, energy_j=total_j, area_mm2=area,
            stage_seconds=stage_s, stage_joules=stage_j,
            spec_decode=spec_decode,
        )

    # ------------------------------------------------------------------
    def prefill(self, spec: SLMSpec, h: HWConfig, prefill_tokens: int,
                w_bits: int = 4, a_bits: int = 8) -> StageCost:
        """Prefill estimate (GEMM regime): weights loaded once per layer and
        reused across the prompt; compute becomes multiplicative.  Used for
        the Fig. 2-style decode-dominance profiling, not for the DSE
        objective (the paper optimizes decode)."""
        tech = self.tech
        P = prefill_tokens
        total = StageCost(0.0, 0.0)
        stages = spec.decode_stages(P / 2.0)  # avg causal KV length
        mult = spec.layer_multiplicity()
        from .hw import stream_bandwidth
        from .macro import pass_cycles as _pc
        bw = stream_bandwidth(h, tech)
        for st, m in zip(stages, mult):
            w_bytes = st.weight_elems * w_bits / 8.0
            t_load = w_bytes / bw
            # P bit-serial passes per partition (inputs streamed through)
            macs = st.macs * P
            passes = macs / max(h.active_pes() * 256.0, 1.0)
            t_compute = passes * _pc(a_bits, tech) / tech.f_clk
            sec = max(t_load, t_compute) + st.vector_ops * P / tech.vector_lanes / tech.f_clk
            e = (w_bytes * 8.0 * (tech.e_dram_bit + 3 * tech.e_bus_bit)
                 + macs * tech.e_mac(min(w_bits, a_bits))
                 + st.vector_ops * P * tech.e_vec_op)
            total = total + StageCost(sec, e).scale(m)
        return total


def decode_fraction(spec: SLMSpec, h: HWConfig, prefill_tokens: int,
                    gen_tokens: int, w_bits: int = 4, a_bits: int = 8,
                    sim: EdgeCIMSimulator | None = None) -> float:
    """Fraction of end-to-end time spent decoding (paper Fig. 2: ~96.6%)."""
    sim = sim or EdgeCIMSimulator()
    pre = sim.prefill(spec, h, prefill_tokens, w_bits, a_bits)
    rep = sim.generate(spec, h, prefill_tokens, gen_tokens, w_bits, a_bits)
    return rep.latency_s / (rep.latency_s + pre.seconds)
