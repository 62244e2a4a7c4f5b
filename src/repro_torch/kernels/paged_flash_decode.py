"""Paged GQA attention through a block table: `paged_flash_decode` (one
token per lane) and `paged_flash_verify` (a speculative-decode window of
`s` tokens per lane), CUDA kernels + plain versions.

`paged_flash_decode` replaces the Pallas TPU kernel
`src/repro/kernels/paged_flash_decode.py:paged_flash_decode`.  The
kernel (`csrc/paged_flash_decode.cu` on `csrc/split_decode.cuh`) is bound
by the bytes of the K/V rows a lane owns.  It splits each (lane, kv
head)'s keys across blocks by whole pages, from a shape-only plan
(`split_decode.plan_splits`), and its query heads over blocks of 8 (up
to 16 heads per kv head); each block folds its pages with an online
softmax in f32, and a second launch merges the splits in a fixed order.
It also takes f32 and bf16 pools, a sliding window and a softcap.  A
lane with `length == 0` (an inactive padding lane) gets the mean of V
over all `max_pages` pages of its table, as the TPU kernel and the plain
version give; every table entry must be a valid page id.

`paged_flash_verify` replaces the Pallas TPU kernel
`src/repro/kernels/paged_flash_decode.py:paged_flash_verify`.  Its
kernel (`csrc/paged_flash_verify.cu` on `csrc/split_decode.cuh`) is
split-KV too, from `split_decode.plan_verify`: a block holds all `s *
qpk` query rows of a (lane, kv head) (up to 64; more go to further
blocks), stages each K/V tile of its split once and folds it for every
row of the window, one warp per 8 rows; at the verify shape the f32
products, not the bytes, bound it.  `lengths` EXCLUDES the window: row j
sees k_pos <= lengths + j.  A row that sees no key (a window, and a
padded row past the table) gets the mean of V over the whole table, as
the TPU kernel and the plain version give.  Padded rows and padding
lanes read stale pool rows, as the plain version does; their output is
finite and discarded.

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
                                 split_decode.sm_count(q.device), qpk)
    part = split_decode.scratch(b * g, n_split, qpk, hd, q.device)
    _launch("paged_flash_decode",
            (b, g, qpk, hd, ps, max_pages, chunk, n_split), q, k_pages,
            v_pages, tables, lengths, out, window, attn_cap, k_scales,
            v_scales, part)
    paged_flash_decode.launches += 1
    return out


def decode_plan(b: int, g: int, max_pages: int, page_size: int,
                n_sms: int = split_decode.H100_SMS, qpk: int = 1):
    """(n_split, chunk) of a `paged_flash_decode` call: splits of whole
    pages over the `max_pages * page_size` keys a lane may hold, each
    (lane, kv head) weighed by its blocks of query heads."""
    return split_decode.plan_splits(b * g * split_decode.q_groups(qpk),
                                    max_pages * page_size, page_size, n_sms)


def verify_plan(b: int, g: int, s: int, qpk: int, max_pages: int,
                page_size: int, n_sms: int = split_decode.H100_SMS):
    """(n_split, chunk) of a `paged_flash_verify` call: splits of whole
    pages over the `max_pages * page_size` keys of a lane's table, for
    s * qpk query rows per (lane, kv head)."""
    return split_decode.plan_verify(b * g, s * qpk, max_pages * page_size,
                                    page_size, n_sms)


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
    (b, s, g, qpk, hd) f32.

    On CUDA tensors it raises ValueError, as `paged_flash_decode` does,
    for tensors on another device or not contiguous, q not f32, pools,
    scales, tables or lengths of the wrong shape or type, and also for hd
    not in `split_decode.HEAD_DIMS` (the instantiated head dims) and for
    q, K or V not starting on a 16-byte boundary.  Any s and qpk go."""
    if _check("paged_flash_verify", 5, q, k_pages, v_pages, tables, lengths,
              k_scales, v_scales):
        return paged_verify_plain(q, k_pages, v_pages, tables, lengths,
                                  window, attn_cap, k_scales, v_scales)
    b, s, g, qpk, hd = q.shape
    if hd not in split_decode.HEAD_DIMS:
        raise ValueError(f"paged_flash_verify: hd {hd} is not one of the "
                         f"instantiated head dims {split_decode.HEAD_DIMS}")
    split_decode.check_aligned("paged_flash_verify", q, k_pages, v_pages)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ps, max_pages = k_pages.shape[1], tables.shape[1]
    n_split, chunk = verify_plan(b, g, s, qpk, max_pages, ps,
                                 split_decode.sm_count(q.device))
    part = split_decode.scratch(b * g, n_split, s * qpk, hd, q.device)
    _launch("paged_flash_verify",
            (b, s, g, qpk, hd, ps, max_pages, chunk, n_split), q, k_pages,
            v_pages, tables, lengths, out, window, attn_cap, k_scales,
            v_scales, part)
    paged_flash_verify.launches += 1
    return out


paged_flash_decode.launches = 0
paged_flash_decode.SOURCE = "src/repro_torch/csrc/paged_flash_decode.cu"
paged_flash_decode.REPLACES = "src/repro/kernels/paged_flash_decode.py:209"
paged_flash_verify.launches = 0
paged_flash_verify.SOURCE = "src/repro_torch/csrc/paged_flash_verify.cu"
paged_flash_verify.REPLACES = "src/repro/kernels/paged_flash_decode.py:153"
