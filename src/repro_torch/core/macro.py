"""Bit-serial SRAM DCIM macro model (the PE of EdgeCIM, after [25]).

A 16x16 weight-stationary macro: 16 input rows broadcast one input *bit*
per cycle; 16 columns each hold a 16-element weight vector and produce a
1b x Wb partial product per cycle, accumulated with shift-and-add across
`input_bits` cycles.  Higher precision = more input cycles (precision
reconfigurability, Sec. II-B): INT4 inputs -> 4 cycles/pass, INT8 -> 8.

Weight precision is handled by column combining: an INT8 weight occupies
two 4-bit column slices whose outputs are fused by shift-and-add, halving
effective columns.  We model this as an occupancy factor.
"""
from __future__ import annotations

from dataclasses import dataclass

from .hw import MACRO_COLS, MACRO_ROWS, TechConstants, DEFAULT_TECH


@dataclass(frozen=True)
class MacroGeometry:
    rows: int = MACRO_ROWS
    cols: int = MACRO_COLS
    weight_bits_per_cell_col: int = 4  # native column slice width

    def effective_cols(self, weight_bits: int) -> int:
        """Columns available after shift-add column fusion for wide weights."""
        slices = max(1, weight_bits // self.weight_bits_per_cell_col)
        return max(1, self.cols // slices)


DEFAULT_MACRO = MacroGeometry()


def pass_cycles(input_bits: int, tech: TechConstants = DEFAULT_TECH) -> int:
    """Cycles for one GEMV pass: one cycle per input bit + pipeline drain."""
    drain = 2 * tech.adder_tree_stage_cycles  # shift-add + output latch
    return input_bits + drain


def pass_latency(input_bits: int, tech: TechConstants = DEFAULT_TECH) -> float:
    return pass_cycles(input_bits, tech) / tech.f_clk


def pass_macs(geom: MacroGeometry = DEFAULT_MACRO) -> int:
    """MACs completed by one macro per pass (full 16x16 tile)."""
    return geom.rows * geom.cols


def macro_energy(n_macs: int, bits: int, tech: TechConstants = DEFAULT_TECH) -> float:
    """Dynamic energy of `n_macs` bit-serial MACs at the given precision."""
    return n_macs * tech.e_mac(bits)


def macro_write_energy(n_weights: int, weight_bits: int,
                       tech: TechConstants = DEFAULT_TECH) -> float:
    """Energy to (re)load weights into the SRAM cells (weight-stationary
    means this happens once per streamed partition)."""
    return n_weights * weight_bits * tech.e_buf_bit
