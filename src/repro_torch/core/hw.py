"""Hardware design space and 65nm technology constants for the EdgeCIM simulator.

The paper (Sec. IV) defines the search space H:
  * vertical/horizontal clusters          C_v, C_h      in {1..5}
  * active tiles per cluster              T_A = T_v_act * T_h_act,
                                          T_v_act, T_h_act in {2..8}
  * total tiles per cluster               T_total = M * T_A, M in {1..8}
  * PEs per tile                          P^2 in {4, 9, 16, 25, 36}
  * bus widths (inter-cluster, inter-tile, intra-tile) in {512,1024,2048,4096} bits
  => 25 * 49 * 8 * 5 * 64 = 3.136e6 configurations ("~3.1e6" in the paper).

Technology constants are calibrated against the paper's reported numbers
(Sec. V) because the authors' C++ simulator constants are unpublished.
Provenance / calibration notes inline; the calibration benchmark is
benchmarks/fig9_slm_suite.py and the tolerance tests are in
tests/test_core_simulator.py.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Iterator

# ----------------------------------------------------------------------------
# Search space (exact paper definition)
# ----------------------------------------------------------------------------
CLUSTER_CHOICES = (1, 2, 3, 4, 5)
ACTIVE_TILE_CHOICES = (2, 3, 4, 5, 6, 7, 8)
TILE_MULT_CHOICES = (1, 2, 3, 4, 5, 6, 7, 8)
PE_COUNT_CHOICES = (4, 9, 16, 25, 36)          # P^2
BUS_WIDTH_CHOICES = (512, 1024, 2048, 4096)    # bits

MACRO_ROWS = 16   # each PE is a 16x16 SRAM bit-serial DCIM macro [25]
MACRO_COLS = 16


@dataclass(frozen=True)
class HWConfig:
    """One point h in the hardware design space H."""
    c_v: int = 2
    c_h: int = 3
    t_act_v: int = 4
    t_act_h: int = 2
    m_mult: int = 1          # T_total = m_mult * T_A
    pe_count: int = 4        # P^2, PEs per tile
    bus_ic: int = 4096       # inter-cluster bus width (bits)
    bus_it: int = 4096       # inter-tile bus width (bits)
    bus_intra: int = 4096    # intra-tile bus width (bits)

    # -- derived ------------------------------------------------------------
    @property
    def n_clusters(self) -> int:
        return self.c_v * self.c_h

    @property
    def t_active(self) -> int:
        return self.t_act_v * self.t_act_h

    @property
    def t_total(self) -> int:
        return self.m_mult * self.t_active

    @property
    def pe_side(self) -> int:
        return int(round(self.pe_count ** 0.5))

    @property
    def macs_per_pe_pass(self) -> int:
        return MACRO_ROWS * MACRO_COLS

    def active_pes(self) -> int:
        """PEs computing concurrently chip-wide (active tiles only)."""
        return self.n_clusters * self.t_active * self.pe_count

    def total_pes(self) -> int:
        return self.n_clusters * self.t_total * self.pe_count

    def active_weight_capacity(self) -> int:
        """INT elements held by the active tiles of one cluster."""
        return self.t_active * self.pe_count * MACRO_ROWS * MACRO_COLS

    def validate(self) -> None:
        assert self.c_v in CLUSTER_CHOICES and self.c_h in CLUSTER_CHOICES
        assert self.t_act_v in ACTIVE_TILE_CHOICES
        assert self.t_act_h in ACTIVE_TILE_CHOICES
        assert self.m_mult in TILE_MULT_CHOICES
        assert self.pe_count in PE_COUNT_CHOICES
        for b in (self.bus_ic, self.bus_it, self.bus_intra):
            assert b in BUS_WIDTH_CHOICES

    def as_tuple(self) -> tuple:
        return dataclasses.astuple(self)


def search_space_size() -> int:
    return (len(CLUSTER_CHOICES) ** 2 * len(ACTIVE_TILE_CHOICES) ** 2 *
            len(TILE_MULT_CHOICES) * len(PE_COUNT_CHOICES) *
            len(BUS_WIDTH_CHOICES) ** 3)


def iter_search_space() -> Iterator[HWConfig]:
    """Exhaustive iterator (3.1M points) — used only by tests on slices."""
    for cv, ch, tav, tah, m, p2, bic, bit_, bintra in itertools.product(
            CLUSTER_CHOICES, CLUSTER_CHOICES, ACTIVE_TILE_CHOICES,
            ACTIVE_TILE_CHOICES, TILE_MULT_CHOICES, PE_COUNT_CHOICES,
            BUS_WIDTH_CHOICES, BUS_WIDTH_CHOICES, BUS_WIDTH_CHOICES):
        yield HWConfig(cv, ch, tav, tah, m, p2, bic, bit_, bintra)


# ----------------------------------------------------------------------------
# Technology constants (65nm, calibrated)
# ----------------------------------------------------------------------------
@dataclass(frozen=True)
class TechConstants:
    """65nm CMOS + LPDDR5X system constants.

    Calibration provenance:
      f_clk           : bit-serial DCIM macros at 65nm; [25] runs at 22nm —
                        conservatively derated to 500 MHz.
      dram_*          : LPDDR5X-9600, 16 channels x 16-bit (paper Sec. IV):
                        9600 MT/s * 2 B = 19.2 GB/s/ch -> 307.2 GB/s peak;
                        utilization 0.80 (typical LPDDR efficiency) gives the
                        ~246 GB/s effective stream rate that reproduces the
                        paper's LLaMA3.2-1B 400 tok/s headline.
      e_dram_bit      : 0.60 pJ/bit — interface-level transfer energy. The
                        paper's tokens/J figures imply sub-datasheet DRAM
                        energy accounting (device-core energy excluded); we
                        match their accounting and note it in EXPERIMENTS.md.
      e_mac_int8      : [25] reports 89 TOPS/W INT8 at 22nm => 11.2 fJ/op;
                        scaled (65/22)^2 for capacitance+voltage => ~0.196
                        pJ/MAC (2 ops/MAC). INT4 bit-serial halves input
                        toggling => 0.098 pJ/MAC.
      a_pe_mm2        : fits the paper's h* area of 11.83 mm^2 for
                        (6 clusters x 8 tiles x 4 PEs) with the buffer model.
      sram (CACTI-ish): 65nm 6T SRAM ~0.525 um^2/bit + periphery factor.
      p_static_mm2    : 15 mW/mm^2 leakage at 65nm (CACTI-6.0 ballpark).
      bus             : f_bus = f_clk; energy from Dally et al. [34]
                        (~0.1 pJ/bit/mm on-chip wire, ~2 mm avg hop).
    """
    f_clk: float = 500e6                 # Hz, macro + vector units
    f_bus: float = 500e6                 # Hz, on-chip buses
    adder_tree_stage_cycles: int = 1     # pipelined adder-tree stage

    dram_bw_peak: float = 307.2e9        # B/s (LPDDR5X-9600 x16 ch)
    dram_util: float = 0.80
    dram_latency: float = 60e-9          # first-word latency per burst
    e_dram_bit: float = 0.60e-12         # J/bit

    e_mac_int8: float = 0.196e-12        # J/MAC
    e_mac_int4: float = 0.098e-12        # J/MAC

    e_buf_bit: float = 0.012e-12         # J/bit SRAM buffer access (65nm)
    e_bus_bit: float = 0.05e-12          # J/bit/hop on-chip (~0.1 pJ/bit/mm [34], short hops)
    e_vec_op: float = 0.8e-12            # J per vector-unit elementwise op

    a_pe_mm2: float = 0.011              # mm^2 per 16x16 DCIM macro + logic
    a_sram_mm2_per_kb: float = 0.0043    # mm^2 per KB (65nm, w/ periphery)
    a_aux_mm2: float = 1.2               # softmax/norm/act/quant units
    a_noc_mm2_per_cluster: float = 0.15

    p_static_mm2: float = 15e-3          # W/mm^2 leakage

    vector_lanes: int = 64               # lanes of each auxiliary unit

    # on-chip buffer sizing (bytes)
    global_buffer_kb: int = 1024
    cluster_buffer_kb: int = 128
    tile_buffer_kb: int = 8

    def dram_bw(self) -> float:
        return self.dram_bw_peak * self.dram_util

    def e_mac(self, bits: int) -> float:
        return self.e_mac_int4 if bits <= 4 else self.e_mac_int8


DEFAULT_TECH = TechConstants()


def chip_area_mm2(h: HWConfig, tech: TechConstants = DEFAULT_TECH) -> float:
    """Area model: PEs + buffer hierarchy + aux units + NoC."""
    pe_area = h.total_pes() * tech.a_pe_mm2
    buf_kb = (tech.global_buffer_kb
              + h.n_clusters * tech.cluster_buffer_kb
              + h.n_clusters * h.t_total * tech.tile_buffer_kb)
    buf_area = buf_kb * tech.a_sram_mm2_per_kb
    noc_area = h.n_clusters * tech.a_noc_mm2_per_cluster
    return pe_area + buf_area + tech.a_aux_mm2 + noc_area


def peak_tops(h: HWConfig, bits: int, tech: TechConstants = DEFAULT_TECH) -> float:
    """Peak INT throughput (2 ops per MAC) of the active tiles.

    Bit-serial: one input bit per cycle => a full `bits`-bit GEMV pass over
    the 16x16 macro takes `bits` cycles.
    """
    passes_per_s = tech.f_clk / bits
    macs_per_s = h.active_pes() * h.macs_per_pe_pass * passes_per_s
    return 2.0 * macs_per_s / 1e12


def stream_bandwidth(h: HWConfig, tech: TechConstants = DEFAULT_TECH) -> float:
    """Effective weight-stream bandwidth DRAM -> active tiles (B/s).

    The 2D hierarchical bus (Sec. III-B): one inter-cluster trunk from the
    global buffer, per-cluster inter-tile buses in parallel, per-active-tile
    intra-tile buses in parallel. The stream rate is the min of DRAM and
    every bus level's aggregate capacity along the broadcast path.
    """
    bw_dram = tech.dram_bw()
    bw_ic = h.bus_ic / 8.0 * tech.f_bus
    bw_it = h.n_clusters * h.bus_it / 8.0 * tech.f_bus
    bw_intra = h.n_clusters * h.t_active * h.bus_intra / 8.0 * tech.f_bus
    return min(bw_dram, bw_ic, bw_it, bw_intra)
