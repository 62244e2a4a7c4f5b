"""`swiglu_qgemv`: silu(x @ Wg) * (x @ Wu) over packed INT4/INT8 gate and
up weights, CUDA kernel + plain version.

Replaces the Pallas TPU kernel
`src/repro/kernels/swiglu_gemv.py:swiglu_qgemv`.  The kernel
(`csrc/swiglu_gemv.cu`) is bound by the bytes of the two packed
weights; gate and up stream together over one K loop into two f32
accumulators, and neither reaches device memory at full size.  Same
layout and group rules as `cim_gemv`'s `(K/2, F)` path.

On a CPU tensor the wrapper runs the plain version (`ref_swiglu_qgemv`);
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.quant.qarray import QTensor, count_dequant

from . import _build
from .cim_gemv import _check_packed
from .ref import ref_swiglu_qgemv

BM = 4                      # x rows per block, as in the source
TILE_N = 128                # columns per block
TARGET_BLOCKS = 132 * 8     # enough blocks in flight to fill the SMs
MIN_ROWS_PER_SPLIT = 32     # stored K rows per block: 8 per warp


def swiglu_plain(x: torch.Tensor, w_gate: QTensor, w_up: QTensor
                 ) -> torch.Tensor:
    """The plain PyTorch version: two fused grouped contractions."""
    return ref_swiglu_qgemv(x, w_gate, w_up)


def split_plan(m: int, stored_rows: int, n: int, bm: int = BM):
    """(splits, rows_per_split): split K across blocks until about
    TARGET_BLOCKS blocks are in flight, keeping at least
    MIN_ROWS_PER_SPLIT rows each."""
    blocks = -(-m // bm) * -(-n // TILE_N)
    want = max(1, -(-TARGET_BLOCKS // blocks))
    splits = max(1, min(want, stored_rows // MIN_ROWS_PER_SPLIT))
    rows = -(-stored_rows // splits)
    return -(-stored_rows // rows), rows


def _lib():
    lib = _build.load("swiglu_gemv")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.swiglu_qgemv.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                     i, p]
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
    if x.device.type == "cpu" and devs == {x.device}:
        return swiglu_plain(x, w_gate, w_up)
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
    out = torch.empty((m, f), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    count_dequant("fused_dequant")
    splits, rows = split_plan(m, stored, f, BM)
    work = torch.empty(splits * 2 * m * f, dtype=torch.float32,
                       device=x.device)
    lib = _lib()
    err = lib.swiglu_qgemv(
        x.data_ptr(), w_gate.data.data_ptr(), w_gate.scales.data_ptr(),
        w_up.data.data_ptr(), w_up.scales.data_ptr(), out.data_ptr(),
        work.data_ptr(), m, k, f, w_gate.bits, w_gate.group, splits, rows,
        _build.stream_handle())
    if err:
        raise RuntimeError("swiglu_qgemv launch failed: "
                           + lib.swiglu_gemv_error_string(err).decode())
    swiglu_qgemv.launches += 1
    return out


swiglu_qgemv.launches = 0
swiglu_qgemv.SOURCE = "src/repro_torch/csrc/swiglu_gemv.cu"
swiglu_qgemv.REPLACES = "src/repro/kernels/swiglu_gemv.py:47"
