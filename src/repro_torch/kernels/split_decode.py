"""Host side of the split-KV kernels (`csrc/split_decode.cuh`), shared
by `paged_flash_decode`, `flash_decode` and `paged_flash_verify`: the
split plans, the kernels' shared-memory sizes, the partials' scratch,
and the key ranges each split folds, in plain Python the CPU tests
reach.

A call's grid is (rows, n_split, z), a row being one (lane, kv head) and
z the blocks over groups of its query rows: a one-token call takes up to
QMAX query heads a block (z = 2 at 16 heads per kv head), a verify call
up to VERIFY_WARPS * QMAX of its s * qpk rows.  The plans depend only on
shapes (rows, query rows, the keys a row may hold, the page size, the SM
count), never on `lengths` or `pos`, which live on the card: the
wrapper makes no host sync, and the launch can be captured in a CUDA
graph.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

QMAX = 8                    # query rows a warp holds (a one-token
                            # block: QMAX query heads of its kv head)
QPK_MAX = 16                # query heads per kv head, at most
HEAD_DIMS = (16, 32, 64, 112, 128, 256)   # the source's `by_hd`
WARPS = 4
MIN_KEYS = 16               # a split folds at least this many keys
VERIFY_MIN_KEYS = 32        # a verify split, at least (two INT8 tiles)
MAX_SPLITS = 256
H100_SMS = 132
VERIFY_WARPS = 8            # row groups a verify block holds, at most
VERIFY_STAGES = 3           # K/V tiles in a verify block's ring

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
                n_sms: int = H100_SMS,
                min_keys: int = MIN_KEYS) -> Tuple[int, int]:
    """(n_split, chunk) for `rows` rows of up to `n_keys` keys: split s
    folds keys [s * chunk, (s + 1) * chunk), chunk a multiple of `unit`
    (the page size, so a split holds whole pages).  The splits are small
    enough that rows * n_split >= n_sms when every key is live (one full
    wave of busy blocks), but hold at least `min_keys` keys and number
    at most MAX_SPLITS per row."""
    unit = max(1, unit)
    if rows <= 0 or n_keys <= 0:
        return 1, unit
    want = _cdiv(n_sms, rows)                # splits per row for a wave
    chunk = max(unit * _cdiv(min_keys, unit), n_keys // want // unit * unit)
    if _cdiv(n_keys, chunk) > MAX_SPLITS:
        chunk = unit * _cdiv(_cdiv(n_keys, MAX_SPLITS), unit)
    return _cdiv(n_keys, chunk), chunk


def verify_geometry(n_rows: int) -> Tuple[int, int]:
    """(warps, z) of a verify block over n_rows = s * qpk query rows:
    rows go in groups of QMAX, one warp each, at most VERIFY_WARPS
    groups per block, over z blocks of as even a size as they allow
    (as `paged_flash_verify.cu` sizes its launch)."""
    groups = _cdiv(max(1, n_rows), QMAX)
    z = _cdiv(groups, VERIFY_WARPS)
    return _cdiv(groups, z), z


def plan_verify(rows: int, n_rows: int, n_keys: int, unit: int,
                n_sms: int = H100_SMS) -> Tuple[int, int]:
    """(n_split, chunk) of a verify call: `plan_splits` with each block
    weighed by its warps, and at least VERIFY_MIN_KEYS keys a split.  A
    one-token block's 4 warps share one group of query rows; a verify
    block's warps each fold every key of the split for their own group,
    so its work per key grows with them, and the plan aims for that many
    more blocks.  Two tiles a split, not one: at qwen2.5-3b's 40 rows a
    block holds 5 warps of about 140 registers, two blocks an SM, and
    16-key splits ran 2.2 waves of them (slower, on the card)."""
    warps, z = verify_geometry(n_rows)
    return plan_splits(rows * z, n_keys, unit, n_sms * warps,
                       VERIFY_MIN_KEYS)


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


def verify_live(length: int, j: int, window: int,
                n_keys: int) -> Tuple[int, int, bool]:
    """(lo, hi, empty) of verify row j of a lane (any query head of
    window position j): it sees keys [lo, hi) up to its horizon length
    + j; with none visible it walks all n_keys with score 0."""
    h = length + j
    lo = max(0, h - window + 1) if window > 0 else 0
    hi = min(h + 1, n_keys)
    if hi <= lo:
        return 0, n_keys, True
    return lo, hi, False


def verify_span(length: int, j_a: int, j_b: int, window: int,
                n_keys: int) -> Tuple[int, int]:
    """Keys [lo, hi) a verify block walks for window positions j_a..j_b
    of a lane: the union of its rows' keys (all n_keys when one of them
    sees none)."""
    a, b = (verify_live(length, j, window, n_keys) for j in (j_a, j_b))
    if a[2] or b[2]:
        return 0, n_keys
    return a[0], b[1]


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


def verify_smem_bytes(elem_bytes: int, hd: int, warps: int) -> int:
    """Dynamic shared memory of one verify block (`smem_bytes` in
    `csrc/paged_flash_verify.cu`): each warp's QMAX rows of q f32, a
    ring of VERIFY_STAGES K and V tiles of KT keys (rows padded by 16
    B), and each warp's (KT, QMAX) probabilities."""
    row = hd * elem_bytes
    kt = 16 if row <= 256 else (8 if row <= 512 else 4)
    return (warps * QMAX * hd * 4 + VERIFY_STAGES * 2 * kt * (row + 16)
            + warps * kt * QMAX * 4)


def q_groups(qpk: int) -> int:
    """Blocks a one-token (row, split) takes: query heads in groups of
    QMAX."""
    return _cdiv(max(1, qpk), QMAX)


def check_shape(name: str, qpk: int, hd: int) -> None:
    """Raise on a (qpk, hd) the kernels are not instantiated for."""
    if not 1 <= qpk <= QPK_MAX or hd not in HEAD_DIMS:
        raise ValueError(f"{name}: qpk {qpk} (1..{QPK_MAX}) and hd {hd} "
                         f"({HEAD_DIMS}) are what the kernel takes")


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The kernels copy rows (K/V; q too in the verify kernel) in
    16-byte chunks."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors copied in 16-byte chunks must "
                         "start on a 16-byte boundary")


def scratch(rows: int, n_split: int, qpk: int, hd: int,
            device: torch.device) -> torch.Tensor:
    """The partials (m, l, acc) of every split: rows * n_split * qpk *
    (hd + 2) f32, or an empty tensor when one split writes the output."""
    n = rows * n_split * qpk * (hd + 2) if n_split > 1 else 0
    return torch.empty(n, dtype=torch.float32, device=device)
