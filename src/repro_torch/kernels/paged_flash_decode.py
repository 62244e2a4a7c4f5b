"""Paged GQA attention through a block table: `paged_flash_decode` (one
token per lane) and `paged_flash_verify` (a speculative-decode window of
`s` tokens per lane), CUDA kernels + plain versions.

`paged_flash_decode` replaces the Pallas TPU kernel
`src/repro/kernels/paged_flash_decode.py:paged_flash_decode`.  The
kernel (`csrc/paged_flash_decode.cu` on `csrc/split_decode.cuh`) is bound
by the bytes of the K/V rows a lane owns.  It splits each (lane, kv
head)'s keys across blocks by whole pages, from a shape-only plan
(`split_decode.plan_splits`); each block folds its pages with an online
softmax in f32, and a second launch merges the splits in a fixed order.
It also takes f32 and bf16 pools, a sliding window and a softcap.  A
lane with `length == 0` (an inactive padding lane) gets the mean of V
over all `max_pages` pages of its table, as the TPU kernel and the plain
version give; every table entry must be a valid page id.

`paged_flash_verify` replaces the Pallas TPU kernel
`src/repro/kernels/paged_flash_decode.py:paged_flash_verify`.  Its
kernel (`csrc/paged_flash_verify.cu`) holds all `s * qpk` query rows of
a (lane, kv head) in one block, so each K/V row is loaded once for the
whole window; at the verify shape the f32 products, not the bytes, bound
it.  `lengths` EXCLUDES the window: row j sees k_pos <= lengths + j.
Padded rows and padding lanes read stale pool rows, as the plain version
does; their output is finite and discarded.

On CPU tensors each wrapper runs its plain version (`ref_paged_decode`,
`ref_paged_verify`); on CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, split_decode
from .ref import ref_paged_decode, ref_paged_verify

_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_SMEM = 232448           # dynamic shared memory a block may use (227 KB)

paged_decode_plain = ref_paged_decode
paged_verify_plain = ref_paged_verify


def _lib(name: str, n_ptrs: int, n_ints: int):
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, name)
        fn.argtypes = [p] * n_ptrs + [i] * n_ints + [ctypes.c_float,
                                                      ctypes.c_float, p]
        fn.restype = i
        err = getattr(lib, name + "_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(name: str, ndim: int, q: torch.Tensor, k_pages: torch.Tensor,
           v_pages: torch.Tensor, tables: torch.Tensor,
           lengths: torch.Tensor, k_scales, v_scales) -> bool:
    """Validate a CUDA call: True when it runs on the CPU plain version
    instead (every tensor on the CPU); raises on what the kernel does not
    take.  q is (b, [s,] g, qpk, hd) f32, `ndim` dimensions."""
    tensors = [q, k_pages, v_pages, tables, lengths]
    quant = k_scales is not None
    if quant:
        tensors += [k_scales, v_scales]
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if q.dtype != torch.float32 or q.ndim != ndim:
        raise ValueError(f"{name}: q must be {ndim}D f32, got "
                         f"{tuple(q.shape)} {q.dtype}")
    b, g, hd = q.shape[0], q.shape[-3], q.shape[-1]
    n_pages, ps = k_pages.shape[0], k_pages.shape[1]
    if (k_pages.shape != (n_pages, ps, g, hd)
            or v_pages.shape != k_pages.shape
            or v_pages.dtype != k_pages.dtype):
        raise ValueError(f"{name}: pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} vs q {tuple(q.shape)}")
    kind = _KV_KIND.get(k_pages.dtype)
    if kind is None or (kind == 2) != quant:
        raise ValueError(f"{name}: pool dtype {k_pages.dtype} with "
                         f"scales={quant}")
    if quant and (k_scales.shape != (n_pages, ps, g)
                  or v_scales.shape != k_scales.shape
                  or k_scales.dtype != torch.float16
                  or v_scales.dtype != torch.float16):
        raise ValueError(f"{name}: scales must be f16 {(n_pages, ps, g)}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or tables.ndim != 2 or tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError(f"{name}: tables (b, max_pages) and lengths (b,) "
                         "must be int32")
    return False


def _launch(name: str, ints, q, k_pages, v_pages, tables, lengths, out,
            window, attn_cap, k_scales, v_scales, part=None) -> None:
    quant = k_scales is not None
    ptrs = [out.data_ptr()] + ([part.data_ptr()] if part is not None
                               else [])
    lib = _lib(name, 7 + len(ptrs), len(ints) + 2)
    err = getattr(lib, name)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None,
        tables.data_ptr(), lengths.data_ptr(), *ptrs, *ints,
        _KV_KIND[k_pages.dtype], int(window), float(attn_cap),
        1.0 / math.sqrt(q.shape[-1]), _build.stream_handle())
    if err:
        raise RuntimeError(f"{name} launch failed: " + getattr(
            lib, name + "_error_string")(err).decode())


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor, window: int = 0,
                       attn_cap: float = 0.0,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """q: (b, g, qpk, hd) f32; k_pages/v_pages: (n_pages, page_size, g,
    hd) f32, bf16, or int8 with k_scales/v_scales (n_pages, page_size, g)
    f16; tables: (b, max_pages) int32 valid page ids (a lane reads only
    the pages under its length, a length-0 lane all of them); lengths:
    (b,) int32 including the current token.  Returns (b, g, qpk, hd)
    f32."""
    if _check("paged_flash_decode", 4, q, k_pages, v_pages, tables, lengths,
              k_scales, v_scales):
        return paged_decode_plain(q, k_pages, v_pages, tables, lengths,
                                  window, attn_cap, k_scales, v_scales)
    b, g, qpk, hd = q.shape
    split_decode.check_shape("paged_flash_decode", qpk, hd)
    split_decode.check_aligned("paged_flash_decode", k_pages, v_pages)
    out = torch.empty_like(q)
    if b == 0:
        return out
    ps, max_pages = k_pages.shape[1], tables.shape[1]
    n_split, chunk = decode_plan(b, g, max_pages, ps,
                                 split_decode.sm_count(q.device))
    part = split_decode.scratch(b * g, n_split, qpk, hd, q.device)
    _launch("paged_flash_decode",
            (b, g, qpk, hd, ps, max_pages, chunk, n_split), q, k_pages,
            v_pages, tables, lengths, out, window, attn_cap, k_scales,
            v_scales, part)
    paged_flash_decode.launches += 1
    return out


def decode_plan(b: int, g: int, max_pages: int, page_size: int,
                n_sms: int = split_decode.H100_SMS):
    """(n_split, chunk) of a `paged_flash_decode` call: splits of whole
    pages over the `max_pages * page_size` keys a lane may hold."""
    return split_decode.plan_splits(b * g, max_pages * page_size,
                                    page_size, n_sms)


def verify_smem_bytes(s: int, qpk: int, hd: int, page_size: int) -> int:
    """Dynamic shared memory of one verify block, as the source sizes it:
    q and accumulator tiles, one staged K (padded) and V page, scores,
    and three per-row softmax values, all f32."""
    r = s * qpk
    return 4 * (2 * r * hd + page_size * (2 * hd + 1) + r * page_size
                + 3 * r)


def paged_flash_verify(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor, window: int = 0,
                       attn_cap: float = 0.0,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """q: (b, s, g, qpk, hd) f32, query j of lane i at position
    lengths[i] + j; pools, scales and tables as `paged_flash_decode`;
    lengths: (b,) int32 tokens cached BEFORE the window.  Returns
    (b, s, g, qpk, hd) f32."""
    if _check("paged_flash_verify", 5, q, k_pages, v_pages, tables, lengths,
              k_scales, v_scales):
        return paged_verify_plain(q, k_pages, v_pages, tables, lengths,
                                  window, attn_cap, k_scales, v_scales)
    b, s, g, qpk, hd = q.shape
    ps = k_pages.shape[1]
    smem = verify_smem_bytes(s, qpk, hd, ps)
    if smem > MAX_SMEM:
        raise ValueError(f"paged_flash_verify: s*qpk = {s * qpk} rows of "
                         f"hd {hd} need {smem} B of shared memory, more "
                         f"than a block has ({MAX_SMEM} B)")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    _launch("paged_flash_verify", (b, s, g, qpk, hd, ps, tables.shape[1]),
            q, k_pages, v_pages, tables, lengths, out, window, attn_cap,
            k_scales, v_scales)
    paged_flash_verify.launches += 1
    return out


paged_flash_decode.launches = 0
paged_flash_decode.SOURCE = "src/repro_torch/csrc/paged_flash_decode.cu"
paged_flash_decode.REPLACES = "src/repro/kernels/paged_flash_decode.py:209"
paged_flash_verify.launches = 0
paged_flash_verify.SOURCE = "src/repro_torch/csrc/paged_flash_verify.cu"
paged_flash_verify.REPLACES = "src/repro/kernels/paged_flash_decode.py:153"
