"""Host side of the split-KV decode kernels (`csrc/split_decode.cuh`),
shared by `paged_flash_decode` and `flash_decode`: the split plan, the
kernels' shared-memory size, the partials' scratch, and the key ranges
each split folds, in plain Python the CPU tests reach.

A call's grid is (rows, n_split), a row being one (lane, kv head).  The
plan depends only on shapes (rows, the keys a row may hold, the page
size, the SM count), never on `lengths` or `pos`, which live on the
card: the wrapper makes no host sync, and the launch can be captured in
a CUDA graph.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

QMAX = 8                    # query rows per kv head a block holds
HEAD_DIMS = (16, 32, 64, 128, 256)
WARPS = 4
MIN_KEYS = 16               # a split folds at least this many keys
MAX_SPLITS = 256
H100_SMS = 132

_SMS: Dict[int, int] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (a host query)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def plan_splits(rows: int, n_keys: int, unit: int,
                n_sms: int = H100_SMS) -> Tuple[int, int]:
    """(n_split, chunk) for `rows` rows of up to `n_keys` keys: split s
    folds keys [s * chunk, (s + 1) * chunk), chunk a multiple of `unit`
    (the page size, so a split holds whole pages).  The splits are small
    enough that rows * n_split >= n_sms when every key is live (one full
    wave of busy blocks), but hold at least MIN_KEYS keys and number at
    most MAX_SPLITS per row."""
    unit = max(1, unit)
    if rows <= 0 or n_keys <= 0:
        return 1, unit
    want = _cdiv(n_sms, rows)                # splits per row for a wave
    chunk = max(unit * _cdiv(MIN_KEYS, unit), n_keys // want // unit * unit)
    if _cdiv(n_keys, chunk) > MAX_SPLITS:
        chunk = unit * _cdiv(_cdiv(n_keys, MAX_SPLITS), unit)
    return _cdiv(n_keys, chunk), chunk


def split_range(s: int, chunk: int, lo: int, hi: int) -> Tuple[int, int]:
    """Keys [kbeg, kend) that split s folds of a row whose walked keys
    are [lo, hi); empty when kbeg >= kend (as the kernel computes it)."""
    return max(s * chunk, lo), min((s + 1) * chunk, hi)


def paged_live(length: int, window: int, n_keys: int) -> Tuple[int, int,
                                                                bool]:
    """(lo, hi, empty) of a paged lane: it sees keys [lo, hi); a lane of
    length <= 0 sees none and walks all n_keys with score 0."""
    if length <= 0:
        return 0, n_keys, True
    lo = max(0, length - window) if window > 0 else 0
    return lo, min(length, n_keys), False


def flash_live(pos: int, window: int, S: int) -> Tuple[int, int, bool]:
    """(lo, hi, empty) over a contiguous cache of S keys at query
    position pos: keys [lo, hi) are visible; with none visible every key
    counts with score 0."""
    hi = min(pos, S - 1) + 1
    lo = max(0, pos - window + 1) if window > 0 else 0
    if hi <= lo:
        return 0, S, True
    return lo, hi, False


def smem_bytes(elem_bytes: int, hd: int) -> int:
    """Dynamic shared memory of one block (`Shape::SMEM` in the source):
    q (QMAX, hd) f32, and per warp two stages of K and V tiles of KT
    keys (rows padded by 16 B) plus the tile's (KT, QMAX) probabilities;
    KT is 16, or 8 / 4 for rows wider than 256 / 512 B."""
    row = hd * elem_bytes
    kt = 16 if row <= 256 else (8 if row <= 512 else 4)
    stage = 2 * kt * (row + 16)
    return QMAX * hd * 4 + WARPS * (2 * stage + kt * QMAX * 4)


def check_shape(name: str, qpk: int, hd: int) -> None:
    """Raise on a (qpk, hd) the kernels are not instantiated for."""
    if not 1 <= qpk <= QMAX or hd not in HEAD_DIMS:
        raise ValueError(f"{name}: qpk {qpk} (1..{QMAX}) and hd {hd} "
                         f"({HEAD_DIMS}) are what the kernel takes")


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The kernels copy rows in 16-byte chunks."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: K/V must start on a 16-byte boundary")


def scratch(rows: int, n_split: int, qpk: int, hd: int,
            device: torch.device) -> torch.Tensor:
    """The partials (m, l, acc) of every split: rows * n_split * qpk *
    (hd + 2) f32, or an empty tensor when one split writes the output."""
    n = rows * n_split * qpk * (hd + 2) if n_split > 1 else 0
    return torch.empty(n, dtype=torch.float32, device=device)
