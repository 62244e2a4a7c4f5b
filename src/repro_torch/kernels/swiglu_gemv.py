"""`swiglu_qgemv`: silu(x @ Wg) * (x @ Wu) over packed INT4/INT8 gate and
up weights, CUDA kernel + plain version.

Replaces the Pallas TPU kernel
`src/repro/kernels/swiglu_gemv.py:swiglu_qgemv`.  The kernel
(`csrc/swiglu_gemv.cu`, on the loaders of `csrc/qgemv.cuh`) streams both
packed weights once per call at any M; its source comment says what
bounds it and how.  Same layout and group rules as `cim_gemv`'s
`(K/2, F)` path: any group dividing K.

One call is one kernel launch: K is split across the blocks of a column
tile and the last block to arrive sums the splits in order and applies
the SiLU * mul epilogue.  The host plan (`split_plan`) reads shapes only
and the arrival counters are kept per (device, stream)
(`cim_gemv._counters`, this kernel's own arrays), so a call makes no
host sync and can be captured in a CUDA graph.

On a CPU tensor the wrapper runs the plain version (`ref_swiglu_qgemv`);
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.quant.qarray import QTensor, count_dequant

from . import _build
from .launches import launched
from .cim_gemv import (MAX_TILES, _check_packed, _counters, m_tile,
                       split_order_sum, vec_bytes)
from .ref import ref_swiglu_qgemv
from .split_decode import H100_SMS, sm_count

# Mirrors of the source's constants (csrc/swiglu_gemv.cu): change both.
TN = 128                    # columns of each matrix per block
VN = 2 * TN                 # gate then up: bytes of a stored row per block
LANES = 8                   # row-lanes per block (one per warp), each a K
WARPS = 8                   #   sub-range; warps per block
MAX_SPLITS = 8              # K splits of a column tile, at most
SMEM_MAX = 226 * 1024       # dynamic shared memory per block, at most
# The card's side of the plan: how many blocks share an SM.
BLOCKS_PER_SM = 2           # by registers: 256 threads at <= 128 each
SM_SMEM = 228 * 1024        # shared memory of one SM ...
BLOCK_RESERVED = 1024       # ... of which each resident block loses 1 KB


class Plan(NamedTuple):
    mt: int                 # M tile: rows of x a block holds at once
    splits: int             # K splits of a column tile
    rows: int               # stored rows per split
    blocks: int             # grid size: column tiles x splits


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(plan: Plan, m: int, bits: int, group: int) -> int:
    """Dynamic shared memory of one block for M = m rows of x, as the
    source computes it (`smem_bytes`): both weight slices, x (two
    buffers when M > MT), each warp's scales, and the warps' partials
    unless one M tile lets them reuse the slice."""
    rpp = 2 if bits == 4 else 1
    pl = _cdiv(plan.rows, LANES)
    xs = 4 * _cdiv(pl * rpp, 4)              # floats per row-lane
    lane_groups = _cdiv(pl * rpp, group) + 1
    red = WARPS * plan.mt * VN * 4           # the warps' partials ...
    red_in_slice = m <= plan.mt and red <= LANES * pl * VN  # ... in slice
    return (LANES * pl * VN
            + (2 if m > plan.mt else 1) * plan.mt * LANES * xs * 4
            + WARPS * lane_groups * VN * 2 + (0 if red_in_slice else red))


def blocks_per_sm(smem: int) -> int:
    """Blocks of this kernel an SM holds at once, by registers and by
    shared memory."""
    return max(1, min(BLOCKS_PER_SM, SM_SMEM // (smem + BLOCK_RESERVED)))


def _rows(stored_rows: int, splits: int) -> int:
    return _cdiv(_cdiv(stored_rows, splits), LANES) * LANES


def _plan(m: int, stored_rows: int, n: int, splits: int) -> Plan:
    """The launch with `splits` K splits (fewer if the last would hold no
    rows): a block per column tile of TN and split."""
    rows = _rows(stored_rows, splits)
    while splits > 1 and (splits - 1) * rows >= stored_rows:
        splits -= 1                      # no split left without rows
        rows = _rows(stored_rows, splits)
    return Plan(m_tile(m), splits, rows, _cdiv(n, TN) * splits)


def split_plan(m: int, stored_rows: int, n: int, bits: int, group: int,
               n_sms: int = H100_SMS) -> Plan:
    """The launch of one call, from shapes alone: the split count (1 to
    MAX_SPLITS, at least 2 * LANES stored rows a split) whose grid puts
    the least of K on one block slot -- rounds of blocks_per_sm x n_sms
    blocks, each a 1/splits share of a column tile -- the fewer splits
    on a tie (each block pays a fixed chain of latencies)."""
    if bits not in (4, 8):
        raise ValueError(f"split_plan: bits {bits}")
    best, best_load = None, None
    for splits in range(1, MAX_SPLITS + 1):
        if splits > 1 and stored_rows < 2 * splits * LANES:
            break
        plan = _plan(m, stored_rows, n, splits)
        slots = blocks_per_sm(smem_bytes(plan, m, bits, group)) * n_sms
        load = _cdiv(plan.blocks, slots) / plan.splits
        if best is None or load < best_load:
            best, best_load = plan, load
    return best


def swiglu_plain(x: torch.Tensor, w_gate: QTensor, w_up: QTensor
                 ) -> torch.Tensor:
    """The plain PyTorch version: two fused grouped contractions."""
    return ref_swiglu_qgemv(x, w_gate, w_up)


def swiglu_split_order(x: torch.Tensor, w_gate: QTensor, w_up: QTensor,
                       n_sms: int = H100_SMS) -> torch.Tensor:
    """The kernel's order of summation in plain PyTorch, f32: gate and up
    each as `split_order_sum` over the plan (8 row-lanes, one to a
    warp), then g * (1 / (1 + exp(-g))) * u on the sums of the whole K.
    Shows that the plan covers K once and that this order keeps the
    reference's accuracy; the kernel differs from it only inside a
    group's sum."""
    m, k = x.shape
    stored = k // (2 if w_gate.bits == 4 else 1)
    plan = split_plan(m, stored, w_gate.data.shape[1], w_gate.bits,
                      w_gate.group, n_sms)
    g = split_order_sum(x, w_gate, plan, LANES, WARPS)
    u = split_order_sum(x, w_up, plan, LANES, WARPS)
    return g * (1.0 / (1.0 + torch.exp(-g))) * u


def _lib():
    lib = _build.load("swiglu_gemv")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.swiglu_qgemv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                     i, i, i, i, p]
        lib.swiglu_qgemv.restype = i
        lib.swiglu_gemv_error_string.argtypes = [i]
        lib.swiglu_gemv_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def swiglu_qgemv(x: torch.Tensor, w_gate: QTensor, w_up: QTensor
                 ) -> torch.Tensor:
    """x: (M, K) f32; w_gate, w_up: 2D axis=-2 packed QTensors of the
    same shape, bits and group.  Returns (M, F) f32."""
    if not (isinstance(w_gate, QTensor) and isinstance(w_up, QTensor)):
        raise TypeError("swiglu_qgemv takes QTensor weights")
    devs = {w_gate.data.device, w_gate.scales.device, w_up.data.device,
            w_up.scales.device}
    if x.device.type in ("cpu", "meta") and devs == {x.device}:
        return swiglu_plain(x, w_gate, w_up)    # meta: the dry-run
    if x.device.type != "cuda" or devs != {x.device}:
        raise ValueError(f"swiglu_qgemv: x on {x.device}, weights on {devs}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("swiglu_qgemv: x must be a contiguous 2D f32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if (w_gate.bits, w_gate.group, w_gate.axis, tuple(w_gate.data.shape)) != \
            (w_up.bits, w_up.group, w_up.axis, tuple(w_up.data.shape)):
        raise ValueError("swiglu_qgemv: gate and up must share layout")
    if w_gate.axis != -2:
        raise ValueError(f"swiglu_qgemv: layout axis={w_gate.axis}")
    m, k = x.shape
    stored = _check_packed(w_gate, k)
    _check_packed(w_up, k)
    f = w_gate.data.shape[1]
    if w_gate.data.shape[0] != stored or \
            w_gate.scales.shape != (k // w_gate.group, f) or \
            w_up.scales.shape != w_gate.scales.shape:
        raise ValueError(f"swiglu_qgemv: data {tuple(w_gate.data.shape)} / "
                         f"scales {tuple(w_gate.scales.shape)} vs K={k}")
    if f % 4:
        raise ValueError(f"swiglu_qgemv: F={f} must be a multiple of 4")
    if w_gate.scales.data_ptr() % 4 or w_up.scales.data_ptr() % 4:
        raise ValueError("swiglu_qgemv: scales must start on a 4-byte "
                         "boundary")                # copied in 4-byte pieces
    out = torch.empty((m, f), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    plan = split_plan(m, stored, f, w_gate.bits, w_gate.group,
                      sm_count(x.device))
    smem = smem_bytes(plan, m, w_gate.bits, w_gate.group)
    if smem > SMEM_MAX:
        raise ValueError(f"swiglu_qgemv: a block of this weight needs {smem}"
                         f" B of shared memory, over {SMEM_MAX}")
    if plan.splits > 1 and _cdiv(f, TN) > MAX_TILES:
        raise ValueError(f"swiglu_qgemv: F={f} has more column tiles than "
                         f"the {MAX_TILES} arrival counters")
    vec = min(vec_bytes(w_gate, f), vec_bytes(w_up, f))
    if vec < 4:
        raise ValueError("swiglu_qgemv: packed rows must start on 4-byte "
                         "boundaries")
    count_dequant("fused_dequant")
    part = (torch.empty(plan.splits * 2 * m * f, dtype=torch.float32,
                        device=x.device) if plan.splits > 1 else None)
    lib = _lib()
    stream = _build.stream_handle()
    err = lib.swiglu_qgemv(
        x.data_ptr(), w_gate.data.data_ptr(), w_gate.scales.data_ptr(),
        w_up.data.data_ptr(), w_up.scales.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        _counters(x.device, "swiglu_qgemv", stream).data_ptr(), m, k, f,
        w_gate.bits, w_gate.group, plan.mt, plan.splits, plan.rows,
        vec, stream)
    if err:
        raise RuntimeError("swiglu_qgemv launch failed: "
                           + lib.swiglu_gemv_error_string(err).decode())
    launched(swiglu_qgemv)
    return out


swiglu_qgemv.launches = 0
swiglu_qgemv.SOURCE = "src/repro_torch/csrc/swiglu_gemv.cu"
swiglu_qgemv.REPLACES = "src/repro/kernels/swiglu_gemv.py:47"
