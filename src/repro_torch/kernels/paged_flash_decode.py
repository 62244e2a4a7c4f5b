"""`paged_flash_decode`: one-token GQA attention through a block table,
CUDA kernel + plain version.

Replaces the Pallas TPU kernel
`src/repro/kernels/paged_flash_decode.py:paged_flash_decode`.  The
kernel (`csrc/paged_flash_decode.cu`) is bound by the bytes of the K/V
rows a lane owns; one block per (lane, kv head) walks only that lane's
pages, `ceil(length / page_size)` of them, with an online softmax in
f32, and dequantizes INT8 rows by their f16 scale right after the load.
It also takes f32 and bf16 pools, a sliding window and a softcap.

Lanes with `length == 0` are inactive padding: the kernel returns zeros
there, while the plain version (like the TPU kernel) returns the mean of
masked rows.  Callers drop those rows.

On a CPU tensor the wrapper runs the plain version (`ref_paged_decode`);
on a CUDA tensor it launches the kernel or raises.  The multi-query
verify variant (`paged_flash_verify`) is not ported yet.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import ref_paged_decode

REPLACES = "src/repro/kernels/paged_flash_decode.py:209"
SOURCE = "src/repro_torch/csrc/paged_flash_decode.cu"

_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

paged_decode_plain = ref_paged_decode


def _lib():
    lib = _build.load("paged_flash_decode")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_flash_decode.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                           i, i, i, i, ctypes.c_float,
                                           ctypes.c_float, p]
        lib.paged_flash_decode.restype = i
        lib.paged_flash_decode_error_string.argtypes = [i]
        lib.paged_flash_decode_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor, window: int = 0,
                       attn_cap: float = 0.0,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """q: (b, g, qpk, hd) f32; k_pages/v_pages: (n_pages, page_size, g,
    hd) f32, bf16, or int8 with k_scales/v_scales (n_pages, page_size, g)
    f16; tables: (b, max_pages) int32 (entries past a lane's length are
    never read); lengths: (b,) int32 including the current token.
    Returns (b, g, qpk, hd) f32."""
    tensors = [q, k_pages, v_pages, tables, lengths]
    quant = k_scales is not None
    if quant:
        tensors += [k_scales, v_scales]
    if all(t.device.type == "cpu" for t in tensors):
        return paged_decode_plain(q, k_pages, v_pages, tables, lengths,
                                  window, attn_cap, k_scales, v_scales)
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in tensors):
        raise ValueError("paged_flash_decode: all tensors must be on one "
                         f"CUDA device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_flash_decode: tensors must be contiguous")
    if q.dtype != torch.float32 or q.ndim != 4:
        raise ValueError(f"paged_flash_decode: q must be 4D f32, got "
                         f"{tuple(q.shape)} {q.dtype}")
    b, g, qpk, hd = q.shape
    n_pages, ps = k_pages.shape[0], k_pages.shape[1]
    if (k_pages.shape != (n_pages, ps, g, hd)
            or v_pages.shape != k_pages.shape
            or v_pages.dtype != k_pages.dtype):
        raise ValueError(f"paged_flash_decode: pools {tuple(k_pages.shape)} "
                         f"/ {tuple(v_pages.shape)} vs q {tuple(q.shape)}")
    kind = _KV_KIND.get(k_pages.dtype)
    if kind is None or (kind == 2) != quant:
        raise ValueError(f"paged_flash_decode: pool dtype {k_pages.dtype} "
                         f"with scales={quant}")
    if quant and (k_scales.shape != (n_pages, ps, g)
                  or v_scales.shape != k_scales.shape
                  or k_scales.dtype != torch.float16
                  or v_scales.dtype != torch.float16):
        raise ValueError("paged_flash_decode: scales must be f16 "
                         f"{(n_pages, ps, g)}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or tables.ndim != 2 or tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("paged_flash_decode: tables (b, max_pages) and "
                         "lengths (b,) must be int32")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _lib()
    err = lib.paged_flash_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, g, qpk, hd, ps, tables.shape[1], kind, int(window),
        float(attn_cap), 1.0 / math.sqrt(hd), _build.stream_handle())
    if err:
        raise RuntimeError("paged_flash_decode launch failed: "
                           + lib.paged_flash_decode_error_string(err).decode())
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
