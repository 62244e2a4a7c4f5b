"""Per-stage latency/energy with the active-tile pipelined mapping (Sec. III-C).

Execution model for one stage (one layer, one decode token):

  * The stage's operand matrix (weights, or KV/state blocks) is partitioned
    into chunks sized to the chip-wide *active* capacity:
    n_clusters * T_A * P^2 * 256 elements.
  * Chunks stream DRAM -> global buffer -> (bus hierarchy) -> macro cells.
    The memory controller pipelines bursts, so the DRAM first-word latency
    is paid once per stage (pipeline fill), not per chunk.
  * Writing a chunk into the SRAM cells takes MACRO_ROWS cycles (row-wise
    write, macros in parallel); the bit-serial compute pass takes
    input_bits + drain cycles plus the adder-tree depth.
  * Active-tile pipelining (the paper's key scheduling idea): with
    M = T_total / T_A >= 2 there are spare tiles to prefetch+write into
    while the active set computes, so per-chunk time is
        max(t_load, t_write, t_compute)            (fully pipelined)
    With M == 1 the cells are busy computing and cannot be rewritten:
        t_load_hidden? no ->  t_load + t_write + t_compute  (serialized)
    (buffer prefetch still hides the DRAM latency).  This is exactly the
    parallelism/bandwidth/area trade-off the DSE explores.
  * Auxiliary ops run on dedicated vector units and sit on stage boundaries.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .hw import HWConfig, MACRO_ROWS, TechConstants, DEFAULT_TECH, stream_bandwidth
from .macro import pass_cycles, macro_energy, macro_write_energy
from .workload import Stage


@dataclass(frozen=True)
class StageCost:
    seconds: float
    joules: float

    def __add__(self, other: "StageCost") -> "StageCost":
        return StageCost(self.seconds + other.seconds, self.joules + other.joules)

    def scale(self, k: float) -> "StageCost":
        return StageCost(self.seconds * k, self.joules * k)


ZERO = StageCost(0.0, 0.0)


def _adder_tree_cycles(h: HWConfig, tech: TechConstants) -> int:
    """Vertical reduction depth: PEs within tile, tiles within cluster,
    clusters at chip level (log2 stages, pipelined)."""
    depth = (math.ceil(math.log2(max(h.pe_side, 2)))
             + math.ceil(math.log2(max(h.t_act_v, 2)))
             + math.ceil(math.log2(max(h.c_v, 2))))
    return depth * tech.adder_tree_stage_cycles


def _chunk_times(h: HWConfig, w_bits: int, a_bits: int, tech: TechConstants,
                 bytes_per_chunk):
    bw = stream_bandwidth(h, tech)
    t_load = bytes_per_chunk / bw
    t_write = MACRO_ROWS / tech.f_clk
    t_compute = (pass_cycles(a_bits, tech) + _adder_tree_cycles(h, tech)) / tech.f_clk
    return t_load, t_write, t_compute


def stage_cost(st: Stage, h: HWConfig, w_bits: int, a_bits: int,
               tech: TechConstants = DEFAULT_TECH) -> StageCost:
    """Latency + dynamic energy of one stage instance (one layer, one token)."""
    chunk_elems = float(h.n_clusters * h.active_weight_capacity())

    # ---- streamed bytes (weights at w_bits, KV/state at a_bits) -----------
    # group-scale metadata overhead: 16-bit scale per 128-element group
    scale_overhead = 1.0 + 16.0 / (128.0 * w_bits)
    w_bytes = st.weight_elems * w_bits / 8.0 * scale_overhead
    kv_bytes = st.kv_stream_elems * a_bits / 8.0
    stream_elems = st.weight_elems + st.kv_stream_elems
    stream_bytes = w_bytes + kv_bytes

    n_chunks = max(1.0, math.ceil(stream_elems / chunk_elems))
    t_load, t_write, t_compute = _chunk_times(
        h, w_bits, a_bits, tech, stream_bytes / n_chunks)

    if h.m_mult >= 2:   # active-tile overlap: spare tiles absorb the write
        per_chunk = max(t_load, t_write, t_compute)
        t_stream = tech.dram_latency + t_load + \
            (n_chunks - 1) * per_chunk + t_write + t_compute
    else:               # no spare tiles: write+compute serialize with load
        t_stream = tech.dram_latency + n_chunks * (t_load + t_write + t_compute)

    # ---- auxiliary vector ops ---------------------------------------------
    t_aux = st.vector_ops / tech.vector_lanes / tech.f_clk

    # ---- write-back (KV append / state update) -----------------------------
    wb_bytes = st.writeback_elems * a_bits / 8.0
    t_wb = wb_bytes / tech.dram_bw() if wb_bytes else 0.0

    seconds = t_stream + t_aux + t_wb

    # ---- energy -------------------------------------------------------------
    e = (stream_bytes * 8.0 * (tech.e_dram_bit + 3 * tech.e_bus_bit)
         + macro_write_energy(stream_elems, w_bits, tech)
         + macro_energy(st.macs, min(w_bits, a_bits), tech)
         + st.vector_ops * tech.e_vec_op
         + wb_bytes * 8.0 * (tech.e_dram_bit + 3 * tech.e_bus_bit))

    return StageCost(seconds, e)


def stage_cost_vec(st_weight_elems: np.ndarray, st_kv_elems: np.ndarray,
                   st_macs: np.ndarray, st_vec_ops: np.ndarray,
                   st_wb_elems: np.ndarray, h: HWConfig, w_bits: int,
                   a_bits: int, tech: TechConstants = DEFAULT_TECH
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized over numpy arrays (per-token KV growth during generation).
    Mirrors `stage_cost` exactly — tested for equality in tests/."""
    chunk_elems = float(h.n_clusters * h.active_weight_capacity())
    scale_overhead = 1.0 + 16.0 / (128.0 * w_bits)

    w_bytes = st_weight_elems * w_bits / 8.0 * scale_overhead
    kv_bytes = st_kv_elems * a_bits / 8.0
    stream_elems = st_weight_elems + st_kv_elems
    stream_bytes = w_bytes + kv_bytes

    n_chunks = np.maximum(1.0, np.ceil(stream_elems / chunk_elems))
    t_load, t_write, t_compute = _chunk_times(
        h, w_bits, a_bits, tech, stream_bytes / n_chunks)

    if h.m_mult >= 2:
        per_chunk = np.maximum(np.maximum(t_load, t_write), t_compute)
        t_stream = tech.dram_latency + t_load + \
            (n_chunks - 1) * per_chunk + t_write + t_compute
    else:
        t_stream = tech.dram_latency + n_chunks * (t_load + t_write + t_compute)

    t_aux = st_vec_ops / tech.vector_lanes / tech.f_clk
    wb_bytes = st_wb_elems * a_bits / 8.0
    t_wb = wb_bytes / tech.dram_bw()
    seconds = t_stream + t_aux + t_wb

    e = (stream_bytes * 8.0 * (tech.e_dram_bit + 3 * tech.e_bus_bit)
         + stream_elems * w_bits * tech.e_buf_bit
         + st_macs * tech.e_mac(min(w_bits, a_bits))
         + st_vec_ops * tech.e_vec_op
         + wb_bytes * 8.0 * (tech.e_dram_bit + 3 * tech.e_bus_bit))
    return seconds, e
