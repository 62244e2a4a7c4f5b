"""Packed INT4/INT8 weight tensors with per-group scales (PyTorch).

Counterpart of `repro.quant.qarray`.  The byte format is identical, so
packed data and f16 scales cross between the packages unchanged:

  * symmetric per-(group, column) quantization along the contraction
    axis `axis` (stored negative, relative to the end);
  * INT4 packs two consecutive `axis` entries per uint8 byte in place:
    low nibble = even row, high nibble = odd row, each offset by +8;
  * INT8 keeps one int8 per entry;
  * scales are f16 with the `axis` dim shrunk to K / group.

Rounding is half-to-even (`torch.round`, like `jnp.round`), and the f32
scale that divides is the one JAX divides by, so quantizing the same
float weight in both packages gives equal bytes.
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

INT4_GROUP = 128

# Call counters.  `full_dequant` counts whole-weight float
# materializations (the serve path must keep it at 0); `fused_dequant`
# counts group-scale applications that never build the float weight
# (fused plain versions, the CUDA kernels, embedding row gathers).  Kept
# for the process and for each thread (engine replicas dequantize on
# their own driver threads), under one lock.
_COUNTERS = {"full_dequant": 0, "fused_dequant": 0}
_THREAD_COUNTERS: "weakref.WeakKeyDictionary[threading.Thread, dict]" = \
    weakref.WeakKeyDictionary()
_LOCK = threading.Lock()


def count_dequant(kind: str = "full_dequant") -> None:
    with _LOCK:
        _COUNTERS[kind] += 1
        mine = _THREAD_COUNTERS.setdefault(threading.current_thread(),
                                           dict.fromkeys(_COUNTERS, 0))
        mine[kind] += 1


def dequant_counters(thread: Optional[threading.Thread] = None) -> dict:
    """The process's counts, or `thread`'s when given."""
    with _LOCK:
        if thread is None:
            return dict(_COUNTERS)
        return dict(_THREAD_COUNTERS.get(thread,
                                         dict.fromkeys(_COUNTERS, 0)))


def reset_dequant_counters() -> None:
    with _LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0
        _THREAD_COUNTERS.clear()


@dataclass
class QTensor:
    """Quantized weight: two tensors plus metadata.  `axis` is the
    contraction/grouping axis, NEGATIVE so that indexing a stacked
    leading layer dim (`qt[i]`) keeps it valid."""
    data: torch.Tensor       # int8 (bits=8) or uint8 packed pairs (bits=4)
    scales: torch.Tensor     # data's shape with axis dim = K/group, f16
    bits: int
    group: int
    axis: int
    orig_shape: Tuple[int, ...]

    @property
    def shape(self):
        return self.orig_shape

    @property
    def ndim(self):
        return len(self.orig_shape)

    @property
    def device(self):
        return self.data.device

    def __getitem__(self, i: int) -> "QTensor":
        """Slice a leading stacked dim (views, no copy)."""
        return QTensor(self.data[i], self.scales[i], self.bits, self.group,
                       self.axis, tuple(self.orig_shape[1:]))

    def to(self, device) -> "QTensor":
        return QTensor(self.data.to(device), self.scales.to(device),
                       self.bits, self.group, self.axis, self.orig_shape)

    def nbytes_packed(self) -> int:
        return self.data.numel() + 2 * self.scales.numel()

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return dequantize(self, dtype)


def quantize(w: torch.Tensor, bits: int = 4, group: int = INT4_GROUP,
             axis: int = 0) -> QTensor:
    """Symmetric per-(group, col) quantization along `axis` (in place)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if axis >= 0:
        axis = axis - w.ndim
    orig_shape = tuple(w.shape)
    wf = torch.movedim(w.to(torch.float32), axis, 0)
    K = wf.shape[0]
    rest = wf.shape[1:]
    g = min(group, K)
    if K % g:
        raise ValueError(f"group {g} does not divide K={K}")
    wg = wf.reshape(K // g, g, *rest)
    qmax = 7.0 if bits == 4 else 127.0
    absmax = wg.abs().amax(dim=1, keepdim=True)
    scale = absmax.clamp_min(1e-8) / qmax
    q = torch.clamp(torch.round(wg / scale), -qmax - 1, qmax)
    q = q.reshape(K, *rest).to(torch.int8)
    scales = torch.movedim(scale[:, 0].to(torch.float16), 0, axis)
    if bits == 4:
        if K % 2:
            raise ValueError(f"int4 packing needs an even K, got {K}")
        lo = q[0::2].to(torch.int32) + 8
        hi = q[1::2].to(torch.int32) + 8
        data = torch.movedim((lo | (hi << 4)).to(torch.uint8), 0, axis)
    else:
        data = torch.movedim(q, 0, axis)
    return QTensor(data=data.contiguous(), scales=scales.contiguous(),
                   bits=bits, group=g, axis=axis, orig_shape=orig_shape)


def unpack_int4(packed: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """(..., K/2, ...) uint8 -> (..., K, ...) int8 in [-8, 7] along axis."""
    p = torch.movedim(packed, axis, 0)
    lo = (p & 0xF).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    out = torch.stack([lo, hi], dim=1).reshape(2 * p.shape[0], *p.shape[1:])
    return torch.movedim(out, 0, axis)


def int_weight(qt: QTensor) -> torch.Tensor:
    """Packed data -> int8 values at full size (scales NOT applied)."""
    return unpack_int4(qt.data, qt.axis) if qt.bits == 4 else qt.data


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    count_dequant("full_dequant")
    qm = torch.movedim(int_weight(qt), qt.axis, 0)
    K = qm.shape[0]
    rest = qm.shape[1:]
    sm = torch.movedim(qt.scales, qt.axis, 0)
    qg = qm.reshape(K // qt.group, qt.group, *rest).to(torch.float32)
    w = (qg * sm[:, None].to(torch.float32)).reshape(K, *rest)
    return torch.movedim(w, 0, qt.axis).to(dtype)


def maybe_dequantize(w, dtype=torch.bfloat16):
    """A QTensor dequantized to `dtype` (bf16 by default, as the JAX
    package's `maybe_dequantize`); a float weight unchanged."""
    return dequantize(w, dtype) if isinstance(w, QTensor) else w


def dequant_rows(qt: QTensor, ids: torch.Tensor, dtype=torch.bfloat16
                 ) -> torch.Tensor:
    """Gather + dequantize rows of an axis=-1-quantized (vocab, d) table:
    only the gathered rows are unpacked.  ids: (...,) -> (..., d)."""
    if qt.axis != -1 or qt.data.ndim != 2:
        raise ValueError("dequant_rows takes a 2D axis=-1 table")
    count_dequant("fused_dequant")
    d = qt.orig_shape[-1]
    data = qt.data[ids]
    scales = qt.scales[ids]
    if qt.bits == 4:
        lo = (data & 0xF).to(torch.int8) - 8
        hi = (data >> 4).to(torch.int8) - 8
        q = torch.stack([lo, hi], dim=-1).reshape(*data.shape[:-1], d)
    else:
        q = data
    qg = q.reshape(*q.shape[:-1], d // qt.group, qt.group).to(torch.float32)
    w = qg * scales[..., None].to(torch.float32)
    return w.reshape(*q.shape[:-1], d).to(dtype)
