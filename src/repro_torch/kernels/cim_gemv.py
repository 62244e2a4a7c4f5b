"""`cim_gemv`: x @ W for packed INT4/INT8 weights, CUDA kernel + plain
version.

Replaces the Pallas TPU kernel `src/repro/kernels/cim_gemv.py:cim_gemv`.
The kernel (`csrc/cim_gemv.cu`, on the loaders of `csrc/qgemv.cuh`)
streams the packed weight once per call; its source comment says what
bounds it and how.  It takes both serve-path layouts:

  * axis=-2 `(K/2, N)` (or `(K, N)` INT8) projections, scales
    `(K/group, N)`: q/k/v/o, `w_down`;
  * axis=-1 `(V, K/2)` tied embedding table, scales `(V, K/group)`:
    the logits head, out[m, v] = x[m] . table[v];
  * an axis=-2 stack of E such projections, `(E, K/2, N)` with scales
    `(E, K/group, N)`: MoE's experts.  x is `(E, C, K)` (each expert's
    capacity of C rows) and a device `int32` count of the rows each
    expert holds goes with it; the kernel reads the count itself, skips
    an expert with none and leaves rows past it unread and unwritten.

Any group dividing K works (qwen2.5-3b's `w_down` has groups of 86,
which the Pallas kernel's `block_k % group` rule could not take).

One call is one kernel launch.  The host plan (`split_plan`) reads
shapes only, and the per-tile arrival counters the kernel leaves zeroed
are kept once per device, so a call makes no host sync and allocates
nothing but its output and workspace: it can be captured in a CUDA
graph.  The counters belong to one stream.

On a CPU tensor the wrapper runs the plain version (`ref_qmatmul_fused`);
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.quant.qarray import QTensor, count_dequant, int_weight

from . import _build
from .ref import ref_qmatmul_fused
from .split_decode import H100_SMS, sm_count

# Mirrors of the source's constants (csrc/cim_gemv.cu): change both.
TN = 64                     # columns per block, (K/2, N) layout
LANES = 32                  # row-lanes per block, each a K sub-range
WARPS = 8                   # warps per (K/2, N) block
MAX_SPLITS = 32             # K splits of a column tile, at most
WAVE_SPLITS = 16            # ... while they only fill the wave
MAX_TILES = 4096            # arrival counters kept per device
BLOCKS_PER_SM = 2           # (K/2, N) blocks that fit on an SM at once
TBL_VB = 64                 # vocab rows per table tile, at most
TBL_R = 8                   # vocab rows per warp: the least tile
M_TILES = (1, 2, 4)         # instantiated M tiles
SMEM_MAX = 226 * 1024       # dynamic shared memory per block, at most


class Plan(NamedTuple):
    mt: int                 # M tile: rows of x a block holds at once
    splits: int             # K splits of a column tile (1 for the table)
    rows: int               # stored rows per split (vocab rows per tile
                            # for the table: 64, or fewer for wide rows)
    blocks: int             # grid size


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def m_tile(m: int) -> int:
    """The M tile the kernel is instantiated with for M rows of x."""
    return 1 if m <= 1 else (2 if m == 2 else 4)


def split_plan(layout: str, m: int, stored_rows: int, n: int, bits: int,
               n_sms: int = H100_SMS) -> Plan:
    """The launch of one call, from shapes alone.  layout "cols": a
    (stored_rows, n) projection in column tiles of TN, K split over up
    to WAVE_SPLITS blocks (a power of two, at least LANES stored rows
    each) while tiles x splits fits the one wave of two blocks per SM,
    and further, up to MAX_SPLITS, while a block's slice would not fit
    its shared memory (`_slice_fits`); "table": (n, stored_rows) rows in
    tiles of TBL_VB, one persistent block per SM, no split (`table_rows`
    halves the tile where the weight's rows are too wide)."""
    if bits not in (4, 8) or layout not in ("cols", "table"):
        raise ValueError(f"split_plan: layout {layout!r}, bits {bits}")
    mt = m_tile(m)
    if layout == "table":
        return Plan(mt, 1, TBL_VB, max(1, min(_cdiv(n, TBL_VB), n_sms)))
    return _cols_plan(m, stored_rows, n, bits, n_sms, 1)


def stack_plan(m: int, stored_rows: int, n: int, bits: int, experts: int,
               n_sms: int = H100_SMS) -> Plan:
    """The launch of one expert-stack call, from shapes alone: the
    "cols" plan of one expert's (stored_rows, n) weight at M = m (its
    capacity), with the experts' blocks counted towards the wave (E x
    tiles fills the card on its own, so K splits only where a slice
    would not fit); blocks counts one expert's."""
    if bits not in (4, 8) or experts < 1:
        raise ValueError(f"stack_plan: bits {bits}, experts {experts}")
    return _cols_plan(m, stored_rows, n, bits, n_sms, experts)


def _cols_plan(m: int, stored_rows: int, n: int, bits: int, n_sms: int,
               units: int) -> Plan:
    mt = m_tile(m)
    tiles = _cdiv(n, TN)
    splits = 1
    while (splits < WAVE_SPLITS
           and units * tiles * splits * 2 <= BLOCKS_PER_SM * n_sms
           and stored_rows >= 2 * splits * LANES):
        splits *= 2
    rows = _cdiv(_cdiv(stored_rows, splits), LANES) * LANES
    while splits < MAX_SPLITS and not _slice_fits(rows, m, mt, bits):
        splits *= 2                      # more blocks, each a smaller slice
        rows = _cdiv(_cdiv(stored_rows, splits), LANES) * LANES
    while splits > 1 and (splits - 1) * rows >= stored_rows:
        splits //= 2                     # no split left without rows
        rows = _cdiv(_cdiv(stored_rows, splits), LANES) * LANES
    return Plan(mt, splits, rows, tiles * splits)


def table_rows(plan: Plan, k: int, n: int, bits: int, group: int,
               n_sms: int = H100_SMS) -> Plan:
    """A table plan with its tile of vocab rows halved (64 -> 32, 16, 8)
    while one weight buffer, its scales and x do not fit shared memory
    (64 rows of 4608 B are 295 KB: gemma2-27b's INT8 table takes 32)."""
    vb = plan.rows
    while vb > TBL_R and _table_smem(k, bits, group, plan.mt, 1,
                                     vb) > SMEM_MAX:
        vb //= 2
    return Plan(plan.mt, 1, vb, max(1, min(_cdiv(n, vb), n_sms)))


def _slice_fits(rows: int, m: int, mt: int, bits: int) -> bool:
    """Whether a (K/2, N) block over `rows` stored rows fits SMEM_MAX,
    with scales counted as if in groups of LANES (the plan reads no
    group; the wrapper checks the exact size)."""
    plan = Plan(mt, 1, rows, 1)
    return smem_bytes("cols", plan, m, 0, bits, LANES) <= SMEM_MAX


def _table_smem(k, bits, group, mt, nbuf, vb=TBL_VB):
    """A table block with nbuf weight buffers of vb rows
    (`rows_smem`)."""
    kp = k // (2 if bits == 4 else 1)
    wbuf = _cdiv(vb * kp + 16, 16) * 16
    return (nbuf * wbuf + _cdiv(nbuf * vb * (k // group) * 2, 16) * 16
            + mt * _cdiv(k, 32) * 128)


def smem_bytes(layout: str, plan: Plan, m: int, k: int, bits: int,
               group: int) -> int:
    """Dynamic shared memory of one block for M = m rows of x, as the
    source computes it (`cols_smem` / `rows_smem`)."""
    if layout == "cols":
        rpp = 2 if bits == 4 else 1
        pl = _cdiv(plan.rows, LANES)     # odd strides: see the source
        xbufs = 2 if m > plan.mt else 1
        return (LANES * (pl | 1) * TN
                + xbufs * plan.mt * LANES * ((pl * rpp) | 1) * 4
                + WARPS * plan.mt * TN * 4
                + (_cdiv(plan.rows * rpp, group) + 1) * TN * 2)
    # two weight buffers (the next tile loads under this one) if they fit
    two = _table_smem(k, bits, group, plan.mt, 2, plan.rows)
    return two if two <= SMEM_MAX else _table_smem(k, bits, group,
                                                    plan.mt, 1, plan.rows)


def lane_rows(plan, split: int, stored_rows: int, lanes: int = LANES):
    """Stored rows [begin, end) each of the `lanes` row-lanes of split
    `split` walks, as the (K/2, N) kernel (and swiglu_qgemv's) divides
    its slice."""
    p0 = split * plan.rows
    rows = max(0, min(plan.rows, stored_rows - p0))
    pl = _cdiv(rows, lanes)
    return [(p0 + min(rows, r * pl), p0 + min(rows, (r + 1) * pl))
            for r in range(lanes)]


def cim_gemv_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """The plain PyTorch version: the fused grouped contraction (for a
    stack, expert by expert, as `ref_qmatmul_fused` with a lead dim)."""
    return ref_qmatmul_fused(x, w, out_dtype=torch.float32)


def cim_gemv_split_order(x: torch.Tensor, w: QTensor,
                         n_sms: int = H100_SMS) -> torch.Tensor:
    """The (K/2, N) kernel's order of summation in plain PyTorch, f32:
    each row-lane's K range scaled group by group (a group cut by a
    range edge is scaled in pieces); the four row-lanes of a warp as
    (0 + 1) + (2 + 3), the warps in order, then the splits in split
    order.  Shows that the plan covers K once and that this order
    keeps the reference's accuracy; the kernel differs from it only
    inside a group's sum."""
    if w.axis != -2:
        raise ValueError("cim_gemv_split_order: the (K/2, N) layout")
    m, k = x.shape
    stored = k // (2 if w.bits == 4 else 1)
    plan = split_plan("cols", m, stored, w.data.shape[1], w.bits, n_sms)
    return split_order_sum(x, w, plan, LANES, WARPS)


def split_order_sum(x: torch.Tensor, w: QTensor, plan, lanes: int,
                    warps: int) -> torch.Tensor:
    """x @ w in f32, summed in the order of a split-K kernel whose blocks
    have `lanes` row-lanes over `warps` warps: each row-lane's stored
    rows (`lane_rows`) scaled group by group, the row-lanes of a warp in
    a pairwise tree (the shuffles), the warps in order, then the splits
    (`plan.splits` slices of `plan.rows` stored rows) in split order."""
    m, k = x.shape
    rpp = 2 if w.bits == 4 else 1
    stored, n = k // rpp, w.data.shape[1]
    q = int_weight(w).to(torch.float32)
    xf, sf = x.to(torch.float32), w.scales.to(torch.float32)
    out = torch.zeros(m, n, dtype=torch.float32)
    for sp in range(plan.splits):
        vals = []
        for pb, pe in lane_rows(plan, sp, stored, lanes):
            acc = torch.zeros(m, n, dtype=torch.float32)
            k0, k1 = pb * rpp, pe * rpp
            while k0 < k1:
                gi = k0 // w.group
                ke = min(k1, (gi + 1) * w.group)
                acc = acc + (xf[:, k0:ke] @ q[k0:ke]) * sf[gi]
                k0 = ke
            vals.append(acc)
        per_warp = lanes // warps
        while per_warp > 1:              # the shuffles: pairs, then pairs
            vals = [vals[i] + vals[i + 1] for i in range(0, len(vals), 2)]
            per_warp //= 2
        block = vals[0]
        for wv in vals[1:]:
            block = block + wv
        out = out + block
    return out


def _lib():
    lib = _build.load("cim_gemv")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cim_gemv_cols.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                      i, i, i, i, i, p]
        lib.cim_gemv_cols.restype = i
        lib.cim_gemv_rows.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                                      p]
        lib.cim_gemv_rows.restype = i
        lib.cim_gemv_error_string.argtypes = [i]
        lib.cim_gemv_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


_COUNTERS: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _counters(device: torch.device, kernel: str = "cim_gemv"
              ) -> torch.Tensor:
    """`kernel`'s per-device arrival counters of the column tiles, zeroed
    once; every call leaves them zero.  Each kernel has its own.  They
    belong to one stream: two calls running at once on two streams must
    not share them."""
    t = _COUNTERS.get((kernel, device))
    if t is None:
        t = _COUNTERS[kernel, device] = torch.zeros(
            MAX_TILES, dtype=torch.int32, device=device)
    return t


def _check_packed(w: QTensor, k: int, ndim: int = 2) -> int:
    """Validate a 2D QTensor (or, ndim = 3, an expert stack) against
    x's K; returns the stored row length along K (K/2 for INT4, K for
    INT8)."""
    want = torch.uint8 if w.bits == 4 else torch.int8
    if w.bits not in (4, 8) or w.data.dtype != want:
        raise ValueError(f"cim_gemv: bits={w.bits} with data {w.data.dtype}")
    if w.scales.dtype != torch.float16:
        raise ValueError(f"cim_gemv: scales must be f16, got {w.scales.dtype}")
    if w.data.ndim != ndim or w.scales.ndim != ndim:
        raise ValueError("cim_gemv: takes a 2D (per-layer) packed weight "
                         "or a 3D (per-layer) expert stack with counts")
    if not (w.data.is_contiguous() and w.scales.is_contiguous()):
        raise ValueError("cim_gemv: packed data and scales must be contiguous")
    if k % w.group:
        raise ValueError(f"cim_gemv: group {w.group} does not divide K={k}")
    return k // 2 if w.bits == 4 else k


def vec_bytes(w: QTensor, row_bytes: int) -> int:
    """16 when every packed row starts on a 16-byte boundary (the kernel
    copies 16-byte chunks), else 4 (the 4-byte instantiation)."""
    return 16 if w.data.data_ptr() % 16 == 0 and row_bytes % 16 == 0 else 4


def cim_gemv(x: torch.Tensor, w: QTensor,
             counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (M, K) f32; w: a 2D packed QTensor in either layout.
    Returns (M, N) f32 (N = V for the axis=-1 table).

    With `counts`: x (E, C, K) f32, w an (E, K/2, N) stack, counts (E,)
    int32 on x's device, the rows of each expert's C to compute (at most
    C).  Returns (E, C, N) f32 whose rows past an expert's count are
    unspecified on the card (the plain version computes every row)."""
    if not isinstance(w, QTensor):
        raise TypeError("cim_gemv takes a QTensor weight")
    tensors = [x] + ([counts] if counts is not None else [])
    if all(t.device.type == "cpu" for t in tensors) \
            and w.device.type == "cpu":
        return cim_gemv_plain(x, w)
    if counts is not None:
        return _stack(x, w, counts)
    if x.device.type != "cuda" or w.device != x.device \
            or w.scales.device != x.device:
        raise ValueError(f"cim_gemv: x on {x.device}, weight on "
                         f"{w.data.device}/{w.scales.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("cim_gemv: x must be a contiguous 2D f32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    m, k = x.shape
    stored = _check_packed(w, k)
    if w.scales.data_ptr() % 4:            # copied in 4-byte pieces
        raise ValueError("cim_gemv: scales must start on a 4-byte boundary")
    if w.axis == -2:
        if w.data.shape[0] != stored or w.scales.shape != (
                k // w.group, w.data.shape[1]):
            raise ValueError(f"cim_gemv: data {tuple(w.data.shape)} / scales "
                             f"{tuple(w.scales.shape)} do not match K={k}")
        n = w.data.shape[1]
        if n % 4:
            raise ValueError(f"cim_gemv: N={n} must be a multiple of 4")
        layout, row_bytes = "cols", n
    elif w.axis == -1:
        n = w.data.shape[0]
        if w.data.shape[1] != stored or w.scales.shape != (n, k // w.group):
            raise ValueError(f"cim_gemv: table {tuple(w.data.shape)} / "
                             f"scales {tuple(w.scales.shape)} vs K={k}")
        if stored % 4:
            raise ValueError(f"cim_gemv: table row of {stored} bytes must "
                             "be a multiple of 4")
        layout, row_bytes = "table", stored
    else:
        raise ValueError(f"cim_gemv: layout axis={w.axis}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    plan = split_plan(layout, m, stored, n, w.bits, sm_count(x.device))
    if layout == "table":
        plan = table_rows(plan, k, n, w.bits, w.group, sm_count(x.device))
    smem = smem_bytes(layout, plan, m, k, w.bits, w.group)
    if smem > SMEM_MAX:
        raise ValueError(f"cim_gemv: a {layout} block of this weight needs "
                         f"{smem} B of shared memory, over {SMEM_MAX}")
    if layout == "cols" and plan.splits > 1 and _cdiv(n, TN) > MAX_TILES:
        raise ValueError(f"cim_gemv: N={n} has more column tiles than the "
                         f"{MAX_TILES} arrival counters")
    vec = vec_bytes(w, row_bytes)
    count_dequant("fused_dequant")
    lib = _lib()
    stream = _build.stream_handle()
    if layout == "cols":
        part = (torch.empty(plan.splits * m * n, dtype=torch.float32,
                            device=x.device) if plan.splits > 1 else None)
        err = lib.cim_gemv_cols(
            x.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
            out.data_ptr(), part.data_ptr() if part is not None else None,
            _counters(x.device).data_ptr(), None, m, k, n, w.bits, w.group,
            plan.mt, plan.splits, plan.rows, vec, 1, stream)
    else:
        err = lib.cim_gemv_rows(
            x.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
            out.data_ptr(), m, k, n, w.bits, w.group, plan.mt, vec,
            plan.blocks, plan.rows, stream)
    if err:
        raise RuntimeError("cim_gemv launch failed: "
                           + lib.cim_gemv_error_string(err).decode())
    cim_gemv.launches += 1
    return out


def _stack(x: torch.Tensor, w: QTensor, counts: torch.Tensor
           ) -> torch.Tensor:
    """The expert-stack launch: one kernel, grid (tiles, splits, E)."""
    if x.device.type != "cuda" or w.device != x.device \
            or w.scales.device != x.device or counts.device != x.device:
        raise ValueError(f"cim_gemv: x on {x.device}, stack on "
                         f"{w.data.device}, counts on {counts.device}")
    if x.dtype != torch.float32 or x.ndim != 3 or not x.is_contiguous():
        raise ValueError("cim_gemv: a stack's x must be a contiguous (E, C, "
                         f"K) f32 tensor, got {tuple(x.shape)} {x.dtype}")
    e, c, k = x.shape
    stored = _check_packed(w, k, ndim=3)
    if w.axis != -2:
        raise ValueError(f"cim_gemv: a stack takes axis=-2, got {w.axis}")
    n = w.data.shape[2]
    if w.data.shape[:2] != (e, stored) or w.scales.shape != (
            e, k // w.group, n):
        raise ValueError(f"cim_gemv: stack {tuple(w.data.shape)} / scales "
                         f"{tuple(w.scales.shape)} vs x {tuple(x.shape)}")
    if n % 4:
        raise ValueError(f"cim_gemv: N={n} must be a multiple of 4")
    if counts.dtype != torch.int32 or counts.shape != (e,) \
            or not counts.is_contiguous():
        raise ValueError(f"cim_gemv: counts must be ({e},) int32")
    if w.scales.data_ptr() % 4:
        raise ValueError("cim_gemv: scales must start on a 4-byte boundary")
    out = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
    if c == 0 or e == 0:
        return out
    plan = stack_plan(c, stored, n, w.bits, e, sm_count(x.device))
    smem = smem_bytes("cols", plan, c, k, w.bits, w.group)
    if smem > SMEM_MAX:
        raise ValueError(f"cim_gemv: a stack block of this weight needs "
                         f"{smem} B of shared memory, over {SMEM_MAX}")
    if plan.splits > 1 and e * _cdiv(n, TN) > MAX_TILES:
        raise ValueError(f"cim_gemv: {e} experts x {_cdiv(n, TN)} column "
                         f"tiles are more than the {MAX_TILES} arrival "
                         "counters")
    vec = vec_bytes(w, n)
    count_dequant("fused_dequant")
    lib = _lib()
    part = (torch.empty(e * plan.splits * c * n, dtype=torch.float32,
                        device=x.device) if plan.splits > 1 else None)
    err = lib.cim_gemv_cols(
        x.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
        out.data_ptr(), part.data_ptr() if part is not None else None,
        _counters(x.device).data_ptr(), counts.data_ptr(), c, k, n, w.bits,
        w.group, plan.mt, plan.splits, plan.rows, vec, e,
        _build.stream_handle())
    if err:
        raise RuntimeError("cim_gemv launch failed: "
                           + lib.cim_gemv_error_string(err).decode())
    cim_gemv.launches += 1
    return out


cim_gemv.launches = 0
cim_gemv.SOURCE = "src/repro_torch/csrc/cim_gemv.cu"
cim_gemv.REPLACES = "src/repro/kernels/cim_gemv.py:69"
