"""Off-chip DRAM, on-chip buffer, and bus models for the EdgeCIM simulator.

DRAM:   LPDDR5X, 16 channels (paper Sec. IV). Modeled as a stream engine
        with peak bandwidth * utilization and a fixed first-word latency
        per transfer burst.
Buffer: CACTI-6.0-style energy/area fits (constants in hw.TechConstants).
Bus:    2D hierarchical bus (Sec. III-B); stream bandwidth computed in
        hw.stream_bandwidth; per-bit hop energy here.
"""
from __future__ import annotations

from dataclasses import dataclass

from .hw import HWConfig, TechConstants, DEFAULT_TECH


@dataclass(frozen=True)
class TransferCost:
    seconds: float
    joules: float

    def __add__(self, other: "TransferCost") -> "TransferCost":
        return TransferCost(self.seconds + other.seconds,
                            self.joules + other.joules)


def dram_stream(nbytes: float, h: HWConfig,
                tech: TechConstants = DEFAULT_TECH,
                bursts: int = 1) -> TransferCost:
    """Stream `nbytes` from DRAM through the bus hierarchy to the tiles.

    Time: limited by the min bandwidth level (DRAM or any bus tier) plus
    `bursts` first-word latencies (one per independent partition fetch).
    Energy: DRAM interface energy + one hop per bus tier traversed
    (global buffer -> cluster -> tile -> macro write is counted by caller).
    """
    from .hw import stream_bandwidth
    bw = stream_bandwidth(h, tech)
    seconds = nbytes / bw + bursts * tech.dram_latency
    bits = nbytes * 8.0
    joules = bits * (tech.e_dram_bit + 3 * tech.e_bus_bit)
    return TransferCost(seconds, joules)


def dram_write(nbytes: float, tech: TechConstants = DEFAULT_TECH) -> TransferCost:
    """Write-back to DRAM (quantized KV append): bandwidth-symmetric."""
    seconds = nbytes / tech.dram_bw()
    joules = nbytes * 8.0 * (tech.e_dram_bit + 3 * tech.e_bus_bit)
    return TransferCost(seconds, joules)


def buffer_access_energy(nbytes: float, tech: TechConstants = DEFAULT_TECH) -> float:
    return nbytes * 8.0 * tech.e_buf_bit


def onchip_move(nbytes: float, hops: int, h: HWConfig,
                tech: TechConstants = DEFAULT_TECH) -> TransferCost:
    """Move intermediate results across `hops` bus tiers (adder-tree outputs,
    cluster->global buffer concatenation, ...)."""
    bw = min(h.bus_ic, h.bus_it, h.bus_intra) / 8.0 * tech.f_bus
    seconds = nbytes / bw
    joules = nbytes * 8.0 * tech.e_bus_bit * hops + buffer_access_energy(nbytes, tech)
    return TransferCost(seconds, joules)
