"""`cim_gemv`: x @ W for packed INT4/INT8 weights, CUDA kernel + plain
version.

Replaces the Pallas TPU kernel `src/repro/kernels/cim_gemv.py:cim_gemv`.
The kernel (`csrc/cim_gemv.cu`) is bound by the bytes of the packed
weight; its source comment says how it streams them once per M-tile at
full rate.  It takes both serve-path layouts:

  * axis=-2 `(K/2, N)` (or `(K, N)` INT8) projections, scales
    `(K/group, N)`: q/k/v/o, `w_down`;
  * axis=-1 `(V, K/2)` tied embedding table, scales `(V, K/group)`:
    the logits head, out[m, v] = x[m] . table[v].

Any group dividing K works (qwen2.5-3b's `w_down` has groups of 86,
which the Pallas kernel's `block_k % group` rule could not take).

On a CPU tensor the wrapper runs the plain version (`ref_qmatmul_fused`);
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.quant.qarray import QTensor, count_dequant

from . import _build
from .ref import ref_qmatmul_fused

BM = 8                      # x rows per block, as in the source
TILE_N = 128                # columns per block, (K/2, N) layout
TARGET_BLOCKS = 132 * 8     # enough blocks in flight to fill the SMs
MIN_ROWS_PER_SPLIT = 32     # stored K rows per block: 8 per warp


def cim_gemv_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """The plain PyTorch version: the fused grouped contraction."""
    return ref_qmatmul_fused(x, w, out_dtype=torch.float32)


def split_plan(m: int, stored_rows: int, n: int, bm: int = BM):
    """(splits, rows_per_split) for the (K/2, N) layout with `bm` x rows
    per block: split K across blocks until about TARGET_BLOCKS blocks
    are in flight, keeping at least MIN_ROWS_PER_SPLIT rows each."""
    blocks = -(-m // bm) * -(-n // TILE_N)
    want = max(1, -(-TARGET_BLOCKS // blocks))
    splits = max(1, min(want, stored_rows // MIN_ROWS_PER_SPLIT))
    rows = -(-stored_rows // splits)
    return -(-stored_rows // rows), rows


def _lib():
    lib = _build.load("cim_gemv")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cim_gemv_cols.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.cim_gemv_cols.restype = i
        lib.cim_gemv_rows.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.cim_gemv_rows.restype = i
        lib.cim_gemv_error_string.argtypes = [i]
        lib.cim_gemv_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_packed(w: QTensor, k: int) -> int:
    """Validate a 2D QTensor against x's K; returns the stored row
    length along K (K/2 for INT4, K for INT8)."""
    want = torch.uint8 if w.bits == 4 else torch.int8
    if w.bits not in (4, 8) or w.data.dtype != want:
        raise ValueError(f"cim_gemv: bits={w.bits} with data {w.data.dtype}")
    if w.scales.dtype != torch.float16:
        raise ValueError(f"cim_gemv: scales must be f16, got {w.scales.dtype}")
    if w.data.ndim != 2 or w.scales.ndim != 2:
        raise ValueError("cim_gemv: takes a 2D (per-layer) packed weight")
    if not (w.data.is_contiguous() and w.scales.is_contiguous()):
        raise ValueError("cim_gemv: packed data and scales must be contiguous")
    if k % w.group:
        raise ValueError(f"cim_gemv: group {w.group} does not divide K={k}")
    return k // 2 if w.bits == 4 else k


def cim_gemv(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x: (M, K) f32; w: a 2D packed QTensor in either layout.
    Returns (M, N) f32 (N = V for the axis=-1 table)."""
    if not isinstance(w, QTensor):
        raise TypeError("cim_gemv takes a QTensor weight")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return cim_gemv_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device \
            or w.scales.device != x.device:
        raise ValueError(f"cim_gemv: x on {x.device}, weight on "
                         f"{w.data.device}/{w.scales.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("cim_gemv: x must be a contiguous 2D f32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    m, k = x.shape
    stored = _check_packed(w, k)
    lib = _lib()
    if w.axis == -2:
        if w.data.shape[0] != stored or w.scales.shape != (
                k // w.group, w.data.shape[1]):
            raise ValueError(f"cim_gemv: data {tuple(w.data.shape)} / scales "
                             f"{tuple(w.scales.shape)} do not match K={k}")
        n = w.data.shape[1]
        if n % 4:
            raise ValueError(f"cim_gemv: N={n} must be a multiple of 4")
    elif w.axis == -1:
        n = w.data.shape[0]
        if w.data.shape[1] != stored or w.scales.shape != (n, k // w.group):
            raise ValueError(f"cim_gemv: table {tuple(w.data.shape)} / "
                             f"scales {tuple(w.scales.shape)} vs K={k}")
        if stored % 4 or -(-n // 8) > 65535:
            raise ValueError(f"cim_gemv: table row of {stored} bytes must "
                             "be a multiple of 4 and V < 524288")
    else:
        raise ValueError(f"cim_gemv: layout axis={w.axis}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    count_dequant("fused_dequant")
    stream = _build.stream_handle()
    if w.axis == -2:
        splits, rows = split_plan(m, stored, n)
        work = (torch.empty(splits * m * n, dtype=torch.float32,
                            device=x.device) if splits > 1 else None)
        err = lib.cim_gemv_cols(
            x.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
            out.data_ptr(), work.data_ptr() if work is not None else None,
            m, k, n, w.bits, w.group, splits, rows, stream)
    else:
        err = lib.cim_gemv_rows(
            x.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
            out.data_ptr(), m, k, n, w.bits, w.group, stream)
    if err:
        raise RuntimeError("cim_gemv launch failed: "
                           + lib.cim_gemv_error_string(err).decode())
    cim_gemv.launches += 1
    return out


cim_gemv.launches = 0
cim_gemv.SOURCE = "src/repro_torch/csrc/cim_gemv.cu"
cim_gemv.REPLACES = "src/repro/kernels/cim_gemv.py:69"
