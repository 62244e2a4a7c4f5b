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

    Layouts: 2D (K, N) axis=-2 projections, and the axis=-1 (V, K) tied
    embedding table contracted over K for logits (x @ table.T).  Shapes
    come from the data tensors.  (The (E, K, N) expert-stack layout of
    the JAX oracle belongs to MoE, which this port does not serve yet.)
    """
    out_dtype = out_dtype or x.dtype
    if not isinstance(w, QTensor):
        return torch.matmul(x, w.to(x.dtype)).to(out_dtype)
    count_dequant("fused_dequant")
    g = w.group
    q = int_weight(w)
    xf = x.to(torch.float32)
    sf = w.scales.to(torch.float32)
    if w.axis == -1:
        V, K = q.shape[-2], q.shape[-1]
        xg = xf.reshape(*x.shape[:-1], K // g, g)
        qg = q.reshape(V, K // g, g).to(torch.float32)
        partial = torch.einsum("...ag,vag->...av", xg, qg)
        out = torch.einsum("...av,va->...v", partial, sf)
        return out.to(out_dtype)
    if w.axis != -2 or q.ndim != 2:
        raise NotImplementedError(
            f"ref_qmatmul_fused: layout axis={w.axis}, ndim={q.ndim} "
            "(expert stacks) is not in this port yet")
    K, N = q.shape
    xg = xf.reshape(*x.shape[:-1], K // g, g)
    qg = q.reshape(K // g, g, N).to(torch.float32)
    partial = torch.einsum("...ag,agn->...an", xg, qg)
    out = torch.einsum("...an,an->...n", partial, sf)
    return out.to(out_dtype)


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
    b, hd = q.shape[0], q.shape[-1]
    ps = k_pages.shape[1]
    S = tables.shape[1] * ps
    tables = tables.long()
    k = _gather_pages(k_pages, tables, b, S, k_scales)
    v = _gather_pages(v_pages, tables, b, S, v_scales)
    scores = torch.einsum("bgph,bkgh->bgpk", q.to(torch.float32),
                          k.to(q.dtype).to(torch.float32))
    scores = scores / math.sqrt(hd)
    if attn_cap:
        scores = attn_cap * torch.tanh(scores / attn_cap)
    k_pos = torch.arange(S, device=q.device)
    lengths = lengths.to(q.device)
    mask = k_pos[None, :] < lengths[:, None]
    if window:
        mask = mask & ((lengths[:, None] - 1) - k_pos[None, :] < window)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bgpk,bkgh->bgph", w.to(q.dtype),
                        v.to(q.dtype))


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
    k_pos = torch.arange(S, device=q.device)
    q_pos = (lengths.to(q.device).long()[:, None]
             + torch.arange(s, device=q.device)[None, :])          # (b, s)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]               # (b, s, S)
    if window:
        mask = mask & (q_pos[:, :, None] - k_pos[None, None, :] < window)
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
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
    k_pos = torch.arange(S, device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    mask = k_pos <= pos
    if window:
        mask = mask & (pos - k_pos < window)
    scores = torch.where(mask[None, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bgpk,bkgh->bgph", w.to(q.dtype), v.to(q.dtype))
