"""`flash_decode`: one-token decode attention over a contiguous K/V
cache, CUDA kernel + plain version.

Replaces the Pallas TPU kernel
`src/repro/kernels/flash_decode.py:flash_decode`.  The kernel
(`csrc/flash_decode.cu` on `csrc/split_decode.cuh`) is bound by the
bytes of the K/V rows up to `pos`.  It splits each `bg` row's keys
across blocks from a shape-only plan (`split_decode.plan_splits`); each
block folds its keys with an online softmax in f32 and masks its own
ragged edge, so any cache length S is taken (the TPU kernel needed S to
be a multiple of its 512-key block), and a second launch merges the
splits in a fixed order; up to 16 query heads a row, 8 a block.  f32
and bf16 caches, a sliding window and a softcap.  `pos` is a Python int
or a 0-d int32 tensor on the card, which the kernel reads itself (no
host sync).  When no key is visible
(pos < 0, or a window past the cache) the result is the mean of V over
all S keys, as the TPU kernel and the plain version give.

On CPU tensors the wrapper runs the plain version (`ref_flash_decode`);
on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Union

import torch

from . import _build, split_decode
from .launches import launched
from .ref import ref_flash_decode

_KV_KIND = {torch.float32: 0, torch.bfloat16: 1}


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos, window: int = 0,
                       attn_cap: float = 0.0) -> torch.Tensor:
    """`ref_flash_decode` in the kernel's (bg, ...) layout: each bg row
    is a batch of one kv head."""
    return ref_flash_decode(q[:, None], k[:, :, None], v[:, :, None], pos,
                            window, attn_cap)[:, 0]


def _lib():
    lib = _build.load("flash_decode")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_decode.argtypes = [p, p, p, p, i, p, p] + [i] * 8 + [
            ctypes.c_float, ctypes.c_float, p]
        lib.flash_decode.restype = i
        lib.flash_decode_error_string.argtypes = [i]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def plan(bg: int, S: int, n_sms: int = split_decode.H100_SMS,
         qpk: int = 1):
    """(n_split, chunk) of a call over `bg` rows of S keys, each row
    weighed by its blocks of query heads."""
    return split_decode.plan_splits(bg * split_decode.q_groups(qpk), S, 16,
                                    n_sms)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: Union[int, torch.Tensor], window: int = 0,
                 attn_cap: float = 0.0) -> torch.Tensor:
    """q: (bg, qpk, hd) f32; k, v: (bg, S, hd) f32 or bf16; pos: an int
    or a 0-d int32 tensor, keys k_pos <= pos visible.  Returns (bg, qpk,
    hd) f32."""
    tensors = [q, k, v] + ([pos] if isinstance(pos, torch.Tensor) else [])
    if all(t.device.type == "cpu" for t in tensors) or \
            all(t.device.type == "meta" for t in tensors):
        # meta: shapes only, the dry-run
        return flash_decode_plain(q, k, v, pos, window, attn_cap)
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in tensors):
        raise ValueError("flash_decode: all tensors must be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_decode: q, k, v must be contiguous")
    if q.dtype != torch.float32 or q.ndim != 3:
        raise ValueError(f"flash_decode: q must be 3D f32, got "
                         f"{tuple(q.shape)} {q.dtype}")
    bg, qpk, hd = q.shape
    if k.ndim != 3 or k.shape[0] != bg or k.shape[2] != hd \
            or v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"flash_decode: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} vs q {tuple(q.shape)}")
    kind = _KV_KIND.get(k.dtype)
    if kind is None:
        raise ValueError(f"flash_decode: cache dtype {k.dtype} (f32 or "
                         "bf16)")
    pos_ptr, pos_val = None, 0
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or pos.numel() != 1:
            raise ValueError("flash_decode: a tensor pos must be one int32")
        pos_ptr = pos.data_ptr()
    else:
        pos_val = int(pos)
    split_decode.check_shape("flash_decode", qpk, hd)
    split_decode.check_aligned("flash_decode", k, v)
    out = torch.empty_like(q)
    if bg == 0:
        return out
    S = k.shape[1]
    n_split, chunk = plan(bg, S, split_decode.sm_count(q.device), qpk)
    part = split_decode.scratch(bg, n_split, qpk, hd, q.device)
    lib = _lib()
    err = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_ptr, pos_val,
        out.data_ptr(), part.data_ptr(), bg, S, qpk, hd, chunk, n_split,
        kind, int(window), float(attn_cap), 1.0 / math.sqrt(hd),
        _build.stream_handle())
    if err:
        raise RuntimeError("flash_decode launch failed: "
                           + lib.flash_decode_error_string(err).decode())
    launched(flash_decode)
    return out


flash_decode.launches = 0
flash_decode.SOURCE = "src/repro_torch/csrc/flash_decode.cu"
flash_decode.REPLACES = "src/repro/kernels/flash_decode.py:69"
