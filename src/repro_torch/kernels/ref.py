"""Plain PyTorch versions of the serve-path kernels.

Counterparts of the oracles in `repro.kernels.ref`, in the same layouts.
They are what a kernel wrapper runs for a tensor on the CPU, and what
the CUDA kernels are held against on the card.  They repeat the
kernels' arithmetic; they are no yardstick of speed.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.quant.qarray import QTensor, count_dequant, int_weight

NEG_INF = -1.0e30


def ref_qmatmul_fused(x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """x @ W with W held as integers end to end: per-group partial sums
    contracted against the f16 scales, never the float weight.

    Layouts: 2D (K, N) axis=-2 projections, the axis=-1 (V, K) tied
    embedding table contracted over K for logits (x @ table.T), and the
    (E, K, N) expert stack, whose lead dim pairs with x's: x (E, ..., K)
    -> (E, ..., N), contracted one expert at a time (a full-width stack
    unpacked at once would be E x K x N f32).  Shapes come from the data
    tensors.
    """
    out_dtype = out_dtype or x.dtype
    if not isinstance(w, QTensor):
        return torch.matmul(x, w.to(x.dtype)).to(out_dtype)
    count_dequant("fused_dequant")
    g = w.group
    xf = x.to(torch.float32)
    if w.axis == -1:
        q = int_weight(w)
        V, K = q.shape[-2], q.shape[-1]
        xg = xf.reshape(*x.shape[:-1], K // g, g)
        qg = q.reshape(V, K // g, g).to(torch.float32)
        partial = torch.einsum("...ag,vag->...av", xg, qg)
        out = torch.einsum("...av,va->...v", partial, w.scales.float())
        return out.to(out_dtype)
    if w.axis != -2 or w.data.ndim not in (2, 3):
        raise NotImplementedError(
            f"ref_qmatmul_fused: layout axis={w.axis}, ndim={w.data.ndim}")
    if w.data.ndim == 2:
        return _grouped(xf, int_weight(w), w.scales, g).to(out_dtype)
    if x.shape[0] != w.data.shape[0]:
        raise ValueError(f"ref_qmatmul_fused: x {tuple(x.shape)} against a "
                         f"stack of {w.data.shape[0]}")
    return torch.stack([_grouped(xf[e], int_weight(w[e]), w.scales[e], g)
                        for e in range(w.data.shape[0])]).to(out_dtype)


def _grouped(xf: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
             g: int) -> torch.Tensor:
    """f32 x (..., K) against int values q (K, N) in groups of g along K,
    each group's partial sum scaled by its f16 scale row."""
    K, N = q.shape
    xg = xf.reshape(*xf.shape[:-1], K // g, g)
    qg = q.reshape(K // g, g, N).to(torch.float32)
    partial = torch.einsum("...ag,agn->...an", xg, qg)
    return torch.einsum("...an,an->...n", partial, scales.to(torch.float32))


def ref_swiglu_qgemv(x: torch.Tensor, w_gate, w_up) -> torch.Tensor:
    """Fused gate/up GEMV + SiLU*mul. x: (m, d) -> (m, f)."""
    g = ref_qmatmul_fused(x, w_gate, out_dtype=torch.float32)
    u = ref_qmatmul_fused(x, w_up, out_dtype=torch.float32)
    return (g * torch.sigmoid(g) * u).to(x.dtype)


def _gather_pages(pages: torch.Tensor, tables: torch.Tensor, b: int, S: int,
                  scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather pool pages by block table; with `scales` dequantize only
    the gathered rows."""
    x = pages[tables].reshape(b, S, *pages.shape[2:])
    if scales is None:
        return x
    s = scales[tables].reshape(b, S, *scales.shape[2:])
    return x.to(torch.float32) * s[..., None].to(torch.float32)


def ref_paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, tables: torch.Tensor,
                     lengths: torch.Tensor, window: int = 0,
                     attn_cap: float = 0.0,
                     k_scales: Optional[torch.Tensor] = None,
                     v_scales: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Paged single-token decode attention (block-table gather).

    q: (b, g, qpk, hd); pools (n_pages, page_size, g, hd); tables
    (b, max_pages) page ids (padded entries must be valid ids); lengths
    (b,) tokens valid per lane INCLUDING the current one.  With
    k_scales/v_scales ((n_pages, page_size, g) f16) the pools are
    per-token INT8.  A lane with length 0 gets the mean of its masked
    rows, as in the JAX oracle.  Returns (b, g, qpk, hd) in q.dtype.
    """
    scores, v = _paged_scores(q, k_pages, v_pages, tables, attn_cap,
                              k_scales, v_scales)
    mask = _paged_visible(lengths.to(q.device), window, scores.shape[-1])
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bgpk,bkgh->bgph", w.to(q.dtype),
                        v.to(q.dtype))


def _paged_scores(q, k_pages, v_pages, tables, attn_cap, k_scales,
                  v_scales):
    """Scaled (and capped) scores (b, g, qpk, S) of every row of each
    lane's table, and the gathered V rows (b, S, g, hd)."""
    b, hd = q.shape[0], q.shape[-1]
    S = tables.shape[1] * k_pages.shape[1]
    tables = tables.long()
    k = _gather_pages(k_pages, tables, b, S, k_scales)
    v = _gather_pages(v_pages, tables, b, S, v_scales)
    scores = torch.einsum("bgph,bkgh->bgpk", q.to(torch.float32),
                          k.to(q.dtype).to(torch.float32))
    scores = scores / math.sqrt(hd)
    if attn_cap:
        scores = attn_cap * torch.tanh(scores / attn_cap)
    return scores, v


def _paged_visible(lengths, window, S):
    """(b, S) keys each lane sees: k_pos < length, within the window."""
    k_pos = torch.arange(S, device=lengths.device)
    mask = k_pos[None, :] < lengths[:, None]
    if window:
        mask = mask & ((lengths[:, None] - 1) - k_pos[None, :] < window)
    return mask


def _flash_visible(pos, window, S, device):
    """(S,) keys a query at `pos` sees over a contiguous cache."""
    k_pos = torch.arange(S, device=device)
    pos = torch.as_tensor(pos, device=device)
    mask = k_pos <= pos
    if window:
        mask = mask & (pos - k_pos < window)
    return mask


def _verify_visible(lengths, s, window, S):
    """(b, s, S) keys each window position sees: query j of a lane at
    position lengths + j sees k_pos <= lengths + j, within the window."""
    k_pos = torch.arange(S, device=lengths.device)
    q_pos = (lengths.long()[:, None]
             + torch.arange(s, device=lengths.device)[None, :])     # (b, s)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]
    if window:
        mask = mask & (q_pos[:, :, None] - k_pos[None, None, :] < window)
    return mask


def ref_paged_verify(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, tables: torch.Tensor,
                     lengths: torch.Tensor, window: int = 0,
                     attn_cap: float = 0.0,
                     k_scales: Optional[torch.Tensor] = None,
                     v_scales: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Multi-query paged verify attention (speculative-decode windows).

    q: (b, s, g, qpk, hd) — query j of lane i sits at absolute position
    lengths[i] + j (its K/V rows are already in the pool); lengths: (b,)
    tokens cached BEFORE the window (EXCLUSIVE, unlike
    `ref_paged_decode`).  Query j sees k_pos <= lengths[i] + j, within
    `window` of it when one is set; there is no upper bound from the
    lane's real token count, so a padded query row reads stale pool
    rows (its output is discarded).  Returns (b, s, g, qpk, hd).
    """
    b, s, hd = q.shape[0], q.shape[1], q.shape[-1]
    ps = k_pages.shape[1]
    S = tables.shape[1] * ps
    tables = tables.long()
    k = _gather_pages(k_pages, tables, b, S, k_scales)
    v = _gather_pages(v_pages, tables, b, S, v_scales)
    scores = torch.einsum("bqgph,bkgh->bgpqk", q.to(torch.float32),
                          k.to(q.dtype).to(torch.float32))
    scores = scores / math.sqrt(hd)
    if attn_cap:
        scores = attn_cap * torch.tanh(scores / attn_cap)
    mask = _verify_visible(lengths.to(q.device), s, window, S)    # (b, s, S)
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bgpqk,bkgh->bqgph", w.to(q.dtype), v.to(q.dtype))


def ref_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, window: int = 0,
                     attn_cap: float = 0.0) -> torch.Tensor:
    """Single-token decode attention over a contiguous cache.

    q: (b, g, qpk, hd); k, v: (b, S, g, hd); pos: scalar (an int or a
    0-d tensor), keys k_pos <= pos are visible (within `window` of pos
    when one is set).  A bf16 cache is read as f32, as the kernel reads
    it.  Returns (b, g, qpk, hd) in q.dtype.
    """
    hd, S = q.shape[-1], k.shape[1]
    scores = torch.einsum("bgph,bkgh->bgpk", q.to(torch.float32),
                          k.to(q.dtype).to(torch.float32)) / math.sqrt(hd)
    if attn_cap:
        scores = attn_cap * torch.tanh(scores / attn_cap)
    mask = _flash_visible(pos, window, S, q.device)
    scores = scores.masked_fill(~mask[None, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bgpk,bkgh->bgph", w.to(q.dtype), v.to(q.dtype))


# ----------------------------------------------------------------------------
# the two halves of the split-KV kernels, for the CPU tests
# ----------------------------------------------------------------------------
def _range_partials(scores, v, visible, k0, k1):
    """Softmax state (m, l, acc) of keys [k0, k1), as one split of a
    split-KV kernel folds them.  scores (n, rows, S) f32, v (n, S, hd)
    f32, visible (n, S) bool, the same for every row, or (n, rows, S); a
    row that sees no key counts every key with score 0.  A range with no
    key gives m = NEG_INF, l = 0, acc = 0."""
    if visible.dim() == 2:
        visible = visible[:, None, :]
    empty = ~visible.any(-1)                                   # (n, 1|rows)
    scores = torch.where(empty[..., None], torch.zeros_like(scores),
                         scores)
    vis = (visible | empty[..., None])[..., k0:k1]
    s = scores[..., k0:k1].masked_fill(~vis, NEG_INF)
    n, rows = scores.shape[:2]
    if k1 <= k0:
        m = torch.full((n, rows), NEG_INF, device=scores.device)
    else:
        m = s.amax(-1)
    p = torch.where(vis, torch.exp(s - m[..., None]), torch.zeros_like(s))
    return m, p.sum(-1), torch.einsum("nqt,nth->nqh", p,
                                      v[:, k0:k1].to(torch.float32))


def ref_paged_decode_partials(q, k_pages, v_pages, tables, lengths, k0, k1,
                              window=0, attn_cap=0.0, k_scales=None,
                              v_scales=None):
    """One split of `paged_flash_decode`: (m, l, acc) of keys [k0, k1)
    of every (lane, kv head), shapes (b, g, qpk), (b, g, qpk), (b, g,
    qpk, hd).  Same arguments as `ref_paged_decode`."""
    b, g, qpk, hd = q.shape
    scores, v = _paged_scores(q, k_pages, v_pages, tables, attn_cap,
                              k_scales, v_scales)
    S = scores.shape[-1]
    vis = _paged_visible(lengths.to(q.device), window, S)
    m, l, acc = _range_partials(
        scores.reshape(b * g, qpk, S), v.transpose(1, 2).reshape(b * g, S,
                                                                 hd),
        vis.repeat_interleave(g, 0), k0, k1)
    return m.reshape(b, g, qpk), l.reshape(b, g, qpk), acc.reshape(q.shape)


def ref_paged_verify_partials(q, k_pages, v_pages, tables, lengths, k0,
                              k1, window=0, attn_cap=0.0, k_scales=None,
                              v_scales=None):
    """One split of `paged_flash_verify`: (m, l, acc) of keys [k0, k1)
    for the s * qpk rows of every (lane, kv head), row r = j * qpk + p
    being query head p of window position j, each masked by its own
    horizon; shapes (b, g, s * qpk), (b, g, s * qpk), (b, g, s * qpk,
    hd).  Same arguments as `ref_paged_verify`."""
    b, s, g, qpk, hd = q.shape
    S = tables.shape[1] * k_pages.shape[1]
    tables = tables.long()
    k = _gather_pages(k_pages, tables, b, S, k_scales)
    v = _gather_pages(v_pages, tables, b, S, v_scales)
    scores = torch.einsum("bqgph,bkgh->bgqpk", q.to(torch.float32),
                          k.to(q.dtype).to(torch.float32)) / math.sqrt(hd)
    if attn_cap:
        scores = attn_cap * torch.tanh(scores / attn_cap)
    vis = _verify_visible(lengths.to(q.device), s, window, S)     # (b, s, S)
    vis = vis[:, None, :, None, :].expand(b, g, s, qpk, S)
    m, l, acc = _range_partials(
        scores.reshape(b * g, s * qpk, S),
        v.transpose(1, 2).reshape(b * g, S, hd).to(torch.float32),
        vis.reshape(b * g, s * qpk, S), k0, k1)
    return (m.reshape(b, g, s * qpk), l.reshape(b, g, s * qpk),
            acc.reshape(b, g, s * qpk, hd))


def ref_flash_decode_partials(q, k, v, pos, k0, k1, window=0,
                              attn_cap=0.0):
    """One split of `flash_decode`, in its (bg, ...) layout: (m, l, acc)
    of keys [k0, k1), shapes (bg, qpk), (bg, qpk), (bg, qpk, hd)."""
    bg, S = q.shape[0], k.shape[1]
    scores = torch.einsum("nph,nkh->npk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(q.shape[-1])
    if attn_cap:
        scores = attn_cap * torch.tanh(scores / attn_cap)
    vis = _flash_visible(pos, window, S, q.device)[None].expand(bg, S)
    return _range_partials(scores, v, vis, k0, k1)


def ref_merge_partials(parts):
    """Merge the splits' (m, l, acc) in split order, as the merge kernel
    does: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, a split
    with no key (m = NEG_INF) skipped, never multiplied."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        live = m > 0.5 * NEG_INF            # a split with no key adds
        e = torch.exp(torch.where(live, m - M, torch.zeros_like(m)))
        L = L + torch.where(live, l * e, torch.zeros_like(l))
        A = A + torch.where(live[..., None], acc * e[..., None],
                            torch.zeros_like(acc))
    return A / L.clamp_min(1e-30)[..., None]
