"""Attention (PyTorch port of `repro.models.attention`): the serve path
over a paged KV pool (GQA over K/V pages, DeepSeek's absorbed multi-head
latent attention (MLA) over latent pages), the full-sequence forward of
training and prefill (`gqa_forward`, `mla_forward`: causal, optionally
windowed, in query blocks of Q_CHUNK; each also returns the rows a cache
holds), and one token against a contiguous cache (`gqa_decode`, through
`ops.decode_attention`, the `flash_decode` kernel; `mla_decode`).

The forward contracts with plain products, as the JAX package's einsums
do: f32 scores, then the softcap, the mask and the softmax, the
probabilities cast to V's dtype for the value product.  Not
`scaled_dot_product_attention`: it takes no softcap and sums in another
order.  `mla_forward` decompresses the latent into per-head K and V (the
value dim differs from the query dim), not the absorbed serving form.

Differences from the JAX package, all PyTorch idiom:
  * the KV pools are updated IN PLACE (`index_copy_` into the layer's
    pool view), where JAX returned new, donated pools;
  * where a step's new K/V rows land is computed once per forward
    (`page_rows`), at a static shape with no host sync, so a step can be
    captured in a CUDA graph.  JAX sends padding rows to page `n_pages`
    and lets the scatter drop them; torch raises on an index out of
    range, so every pool has one page more than the allocator hands out
    (`paged_cache_spec`): page `n_pages`, the dump page, which no block
    table names.  All `b * s` rows are written, the padding rows into
    the dump page.  The page index is clamped where JAX's gather clamps
    (right-padded prefill slots of a lane near `max_seq` index past
    `max_pages`).

MLA has no Pallas kernel in the JAX package: it gathers the latent pages
and contracts with einsums, and so does the port, in plain PyTorch.  Its
`w_dkv`, `wq` and `wo` go through `cim_gemv`.  The absorbed `w_uk` and
`w_uv` do not: their products contract over the ungrouped axis of a
weight grouped along the latent rank, so the JAX package dequantizes
them to bf16 in every step (`maybe_dequantize`) and contracts with
einsums, outside any kernel; the port does the same.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

import torch

from repro_torch.kernels.ops import (decode_attention,
                                     paged_decode_attention,
                                     paged_verify_attention, row_parallel)
from repro_torch.kernels.ops import qmatmul as qmm
from repro_torch.quant.qarray import maybe_dequantize as deq

from .common import (BATCH, FSDP, KV_SEQ, NONE, TP, ParamSpec, apply_rope,
                     rms_norm, rope_tables, softcap)
from .config import ModelConfig

Params = Dict[str, torch.Tensor]

Q_CHUNK = 2048      # query-block size of the full-sequence forward
NEG_INF = -1.0e30


def gqa_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.hd()
    sp: Dict[str, ParamSpec] = {
        "wq": ParamSpec((d, cfg.n_heads * hd), axes=(FSDP, TP)),
        "wk": ParamSpec((d, cfg.n_kv_heads * hd), axes=(FSDP, TP)),
        "wv": ParamSpec((d, cfg.n_kv_heads * hd), axes=(FSDP, TP)),
        "wo": ParamSpec((cfg.n_heads * hd, d), axes=(TP, FSDP)),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((cfg.n_heads * hd,), axes=(TP,), init="zeros")
        sp["bk"] = ParamSpec((cfg.n_kv_heads * hd,), axes=(TP,),
                             init="zeros")
        sp["bv"] = ParamSpec((cfg.n_kv_heads * hd,), axes=(TP,),
                             init="zeros")
    if cfg.qk_norm:
        sp["q_norm"] = ParamSpec((hd,), axes=(NONE,), init="ones")
        sp["k_norm"] = ParamSpec((hd,), axes=(NONE,), init="ones")
    return sp


def mla_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": ParamSpec((d, H * qk_dim), axes=(FSDP, TP)),
        "w_dkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           axes=(FSDP, NONE)),
        "ckv_norm": ParamSpec((m.kv_lora_rank,), axes=(NONE,),
                              init="ones"),
        "w_uk": ParamSpec((m.kv_lora_rank, H * m.qk_nope_head_dim),
                          axes=(NONE, TP)),
        "w_uv": ParamSpec((m.kv_lora_rank, H * m.v_head_dim),
                          axes=(NONE, TP)),
        "wo": ParamSpec((H * m.v_head_dim, d), axes=(TP, FSDP)),
    }


def attention_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return mla_specs(cfg) if cfg.attn_kind == "mla" else gqa_specs(cfg)


def _qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
         lora: Params = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v of x; with `lora` (zamba's per-site deltas) each adds
    (x @ lora_a) @ lora_b to its packed product, the linear identity of
    JAX's x @ (W + lora_a @ lora_b), which never materializes W.  The
    head counts are read off the products: a tensor-parallel rank's
    column slices of wq / wk / wv (and of their biases) give its heads,
    at the config's head_dim."""
    b, s, _ = x.shape
    hd = cfg.hd()
    q = qmm(x, p["wq"])
    k = qmm(x, p["wk"])
    v = qmm(x, p["wv"])
    if lora is not None:
        q = q + qmm(qmm(x, lora["lora_a_q"]), lora["lora_b_q"])
        k = k + qmm(qmm(x, lora["lora_a_k"]), lora["lora_b_k"])
        v = v + qmm(qmm(x, lora["lora_a_v"]), lora["lora_b_v"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.qk_norm:
        # plain RMSNorm scales (no +1), even where the block norms use
        # rms_scale_plus_one, as the JAX package applies them
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def layer_theta(cfg: ModelConfig, is_local: bool) -> float:
    """RoPE base of a layer: `rope_theta_local` (else `rope_theta`) on
    sliding-window layers, `rope_theta` on global ones."""
    return (cfg.rope_theta_local or cfg.rope_theta) if is_local \
        else cfg.rope_theta


Rope = Tuple[torch.Tensor, torch.Tensor]


def rope_dim(cfg: ModelConfig) -> int:
    """Dims RoPE rotates: the head dim, or MLA's `qk_rope_head_dim`."""
    return cfg.mla.qk_rope_head_dim if cfg.attn_kind == "mla" else cfg.hd()


def rope_by_theta(cfg: ModelConfig, slots: torch.Tensor,
                  local_flags: Iterable[bool]) -> Dict[float, Rope]:
    """cos/sin tables (b, s, rope_dim/2) at a step's positions `slots`,
    once per distinct RoPE base among the layers (one or two), not per
    layer."""
    return {theta: rope_tables(slots, rope_dim(cfg), theta)
            for theta in {layer_theta(cfg, f) for f in local_flags}}


def forward_ropes(cfg: ModelConfig, positions: torch.Tensor,
                  local_flags: Iterable[bool]) -> Dict[float, Rope]:
    """cos/sin tables (s, rope_dim/2) of the full-sequence forward, once
    per distinct RoPE base.  GQA computes its frequencies as JAX's
    `gqa_forward` does, exp(i / hd * -log(theta)) (its base is traced
    there), MLA as `rope_tables`: the two round differently."""
    if cfg.attn_kind == "mla":
        return rope_by_theta(cfg, positions, local_flags)
    hd = cfg.hd()
    out = {}
    for theta in {layer_theta(cfg, f) for f in local_flags}:
        log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
        freqs = torch.exp(torch.arange(0, hd, 2, dtype=torch.float32) / hd
                          * -log_theta).to(positions.device)
        ang = positions.to(torch.float32)[:, None] * freqs[None, :]
        out[theta] = (torch.cos(ang), torch.sin(ang))
    return out


def _softmax_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, scale: float,
                    attn_cap: float) -> torch.Tensor:
    """q (b, qs, g, qpk, hd), k (b, ks, g, hd), v (b, ks, g, hd_v), mask
    (qs, ks) -> (b, qs, g, qpk, hd_v)."""
    f32 = torch.float32
    scores = torch.einsum("bqgph,bkgh->bgpqk", q.to(f32), k.to(f32)) * scale
    if attn_cap:
        scores = softcap(scores, attn_cap)
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bgpqk,bkgh->bqgph", w.to(v.dtype), v)


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: int, scale: float,
                       attn_cap: float) -> torch.Tensor:
    """Causal (windowed when `window` > 0) attention in blocks of
    Q_CHUNK queries, so the score tensor of a long sequence is never
    whole.  q (b, qs, g, qpk, hd); k, v (b, ks, g, hd[_v]); q_pos (qs,),
    k_pos (ks,) absolute positions.  A query row's result does not
    depend on its block, so the last block is not padded (JAX pads it to
    a whole chunk for its scan)."""
    def mask_for(qp):
        mask = qp[:, None] >= k_pos[None, :]
        if window:
            mask = mask & (qp[:, None] - k_pos[None, :] < window)
        return mask

    outs = [_softmax_attend(q[:, i:i + Q_CHUNK], k, v,
                            mask_for(q_pos[i:i + Q_CHUNK]), scale, attn_cap)
            for i in range(0, q.shape[1], Q_CHUNK)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def gqa_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, rope: Rope,
                is_local: bool = False, lora: Params = None):
    """Full-sequence attention: x (b, s, d), positions (s,), rope this
    layer's tables (`forward_ropes`); a local layer sees the
    `cfg.local_window` keys up to each query.  Returns (output (b, s,
    d), {"k", "v"}: the layer's rotated K and its V, (b, s, g, hd))."""
    b, s, _ = x.shape
    hd, g, qpk = cfg.hd(), cfg.n_kv_heads, cfg.q_per_kv()
    q, k, v = _qkv(p, cfg, x, lora)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    window = cfg.local_window if is_local else 0
    out = _chunked_attention(q.reshape(b, s, g, qpk, hd), k, v, positions,
                             positions, window, 1.0 / math.sqrt(hd),
                             cfg.attn_softcap)
    return qmm(out.reshape(b, s, cfg.n_heads * hd), p["wo"]), \
        {"k": k, "v": v}


def mla_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, rope: Rope,
                is_local: bool = False):
    """Training path of MLA: the latent decompressed into per-head K
    (no-RoPE part from `w_uk`, the shared RoPE key broadcast over heads)
    and V (`w_uv`, at `v_head_dim`), then causal attention as GQA with
    one query per kv head (`is_local` unused: MLA has no window).
    Returns (output, {"c_kv": (b, s, r), "k_rope": (b, s, rope_d)}: the
    rows a latent cache holds)."""
    m = cfg.mla
    b, s, _ = x.shape
    H = cfg.n_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q = qmm(x, p["wq"]).reshape(b, s, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = qmm(x, p["w_dkv"])
    c_kv = rms_norm(dkv[..., :m.kv_lora_rank], p["ckv_norm"], cfg.norm_eps)
    cos, sin = rope
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(dkv[..., m.kv_lora_rank:][:, :, None, :], cos, sin)
    k_nope = qmm(c_kv, p["w_uk"]).reshape(b, s, H, nope)
    v = qmm(c_kv, p["w_uv"]).reshape(b, s, H, vd)
    k = torch.cat([k_nope, k_rope.expand(b, s, H, rope_d)], dim=-1)
    qg = torch.cat([q_nope, q_rope], dim=-1).reshape(b, s, H, 1,
                                                     nope + rope_d)
    out = _chunked_attention(qg, k, v, positions, positions, 0,
                             1.0 / math.sqrt(nope + rope_d),
                             cfg.attn_softcap)
    return qmm(out.reshape(b, s, H * vd), p["wo"]), \
        {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}


def attn_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, rope: Rope,
                 is_local: bool = False, lora: Params = None):
    if cfg.attn_kind == "mla":
        return mla_forward(p, cfg, x, positions, rope, is_local)
    return gqa_forward(p, cfg, x, positions, rope, is_local, lora)


# ----------------------------------------------------------------------------
# one token against a contiguous cache (`DecoderLM.decode_step`)
# ----------------------------------------------------------------------------
def _write_row(leaf: torch.Tensor, pos: torch.Tensor,
               row: torch.Tensor) -> None:
    """leaf[:, pos] = row in place: leaf (b, S, ...), row (b, 1, ...),
    pos a 0-d int32 tensor read on the device (no host sync)."""
    leaf.index_copy_(1, pos.reshape(1).long(), row.to(leaf.dtype))


def gqa_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: torch.Tensor,
               rope: Rope, is_local: bool = False,
               lora: Params = None) -> torch.Tensor:
    """One-token GQA decode: x (b, 1, d); cache {k, v} (b, S, g, hd),
    f32 or bf16, this layer's; pos a 0-d int32 tensor; rope the tables
    at pos (`forward_ropes`).  Writes the fresh k/v row at pos, then
    attends positions <= pos (within the layer's window) through
    `ops.decode_attention`, the `flash_decode` kernel on the card.

    JAX attends the stale rows < pos plus a rank-1 term for the fresh
    token; the two are equal in exact arithmetic and differ only where
    the cache is narrower than the activations: the fresh row is read
    back rounded to the cache dtype here."""
    b = x.shape[0]
    hd, g, qpk = cfg.hd(), cfg.n_kv_heads, cfg.q_per_kv()
    q, k, v = _qkv(p, cfg, x, lora)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    _write_row(cache["k"], pos, k)
    _write_row(cache["v"], pos, v)
    out = decode_attention(
        q.reshape(b, g, qpk, hd).to(torch.float32).contiguous(),
        cache["k"], cache["v"], pos,
        window=cfg.local_window if is_local else 0,
        attn_cap=cfg.attn_softcap)
    return qmm(out.reshape(b, 1, cfg.n_heads * hd).to(x.dtype), p["wo"])


def mla_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: torch.Tensor,
               rope: Rope, is_local: bool = False) -> torch.Tensor:
    """Absorbed one-token MLA decode over the latent cache {c_kv: (b, S,
    r), k_rope: (b, S, rope_d)}, rows written at pos in place; plain
    PyTorch, as in JAX (`mla_attend`, with the contiguous cache read as
    one page of S rows a lane)."""
    m = cfg.mla
    b = x.shape[0]
    H, S = cfg.n_heads, cache["c_kv"].shape[1]
    nope, rope_d, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    q = qmm(x, p["wq"]).reshape(b, 1, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = qmm(x, p["w_dkv"])
    c_new = rms_norm(dkv[..., :r], p["ckv_norm"], cfg.norm_eps)
    cos, sin = rope
    q_rope = apply_rope(q_rope, cos, sin)
    kr_new = apply_rope(dkv[..., r:][:, :, None, :], cos, sin)
    _write_row(cache["c_kv"], pos, c_new)
    _write_row(cache["k_rope"], pos, kr_new[:, :, 0, :])
    tables = torch.arange(b, dtype=torch.int32, device=x.device)[:, None]
    slots = pos.reshape(1, 1).expand(b, 1)
    out = mla_attend(p, cfg, q_nope, q_rope, cache, tables, slots,
                     slots[:, 0] + 1, x.dtype)
    return qmm(out, p["wo"])


def attn_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                rope: Rope, is_local: bool = False,
                lora: Params = None) -> torch.Tensor:
    if cfg.attn_kind == "mla":
        return mla_decode(p, cfg, x, cache, pos, rope, is_local)
    return gqa_decode(p, cfg, x, cache, pos, rope, is_local, lora)


def empty_cache_spec(cfg: ModelConfig, batch: int, max_seq: int,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, ParamSpec]:
    """One layer's contiguous cache, zeros, the lane axis first: {k, v}
    (batch, max_seq, g, hd), or MLA's {c_kv, k_rope} latent rows."""
    if cfg.attn_kind == "mla":
        m = cfg.mla
        shapes = {"c_kv": (batch, max_seq, m.kv_lora_rank),
                  "k_rope": (batch, max_seq, m.qk_rope_head_dim)}
    else:
        kv = (batch, max_seq, cfg.n_kv_heads, cfg.hd())
        shapes = {"k": kv, "v": kv}
    return {k: ParamSpec(v, dtype, (BATCH, KV_SEQ) + (NONE,) * (len(v) - 2),
                         init="zeros", lane_axis=0)
            for k, v in shapes.items()}


@dataclass
class PageRows:
    """Where one step's new K/V rows land in every layer's pool.

    slots: (b, s) absolute positions; dst: (b * s,) flat row indices
    into a pool viewed as (n_pages_with_dump * page_size, ...), one per
    token row of the step: the n_new[i] real tokens of lane i go to its
    pages, every other row to the dump page."""
    slots: torch.Tensor
    dst: torch.Tensor


def page_rows(tables: torch.Tensor, lengths: torch.Tensor,
              n_new: torch.Tensor, s: int, page_size: int,
              dump_page: int) -> PageRows:
    """Shape-only: reads no device value to the host.  `dump_page` is
    the pool's last page, which no table names (JAX's `n_pages`, whose
    writes are dropped); several padding rows may land on one of its
    rows, so what it holds is unspecified and never read."""
    max_pages = tables.shape[1]
    pos = torch.arange(s, device=tables.device, dtype=lengths.dtype)
    slots = lengths[:, None] + pos[None, :]                       # (b, s)
    idx = (slots // page_size).clamp(max=max_pages - 1).long()
    page = tables.long().gather(1, idx)
    page = page.masked_fill(pos[None, :] >= n_new[:, None], dump_page)
    flat = page * page_size + (slots % page_size).long()
    return PageRows(slots=slots, dst=flat.reshape(-1))


def _page_scatter(pool: torch.Tensor, vals: torch.Tensor,
                  rows: PageRows) -> None:
    """Write per-token rows into a paged pool in place.
    pool: (n_pages + 1, page_size, ...); vals: (b, s, ...)."""
    flat = pool.view(-1, *pool.shape[2:])
    flat.index_copy_(0, rows.dst,
                     vals.reshape(-1, *vals.shape[2:]).to(pool.dtype))


def _quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, kv-head) symmetric INT8: x (b, s, g, hd) -> (values
    rounded to [-127, 127] still in float, scales (b, s, g) f16).  The
    stored f16 scale is what divides, so int8 x scale round-trips."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = (absmax.clamp_min(1e-8) / 127.0).to(torch.float16)
    q = torch.clamp(torch.round(xf / scale[..., None].to(torch.float32)),
                    -127.0, 127.0)
    return q, scale


def gqa_paged_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
                   cache: Dict[str, torch.Tensor], tables: torch.Tensor,
                   lengths: torch.Tensor, n_new: torch.Tensor,
                   rows: PageRows, rope: Rope, is_local: bool = False,
                   verify: bool = False, lora: Params = None
                   ) -> torch.Tensor:
    """Chunked prefill / decode against this layer's paged KV pools.

    x: (b, s, d) — s == 1 is decode, s > 1 a right-padded prefill chunk
    (`n_new[i]` of the s tokens are real).  cache {k, v[, k_scale,
    v_scale]}: (n_pages, page_size, g, hd) pools shared by the batch,
    written in place; tables: (b, max_pages) int32; lengths: (b,) int32
    tokens already cached; rope: this layer's cos/sin tables at
    `rows.slots` (`rope_by_theta`).  Returns the attention output (b, s,
    d).

    is_local (static: the port loops over layers in Python) makes this a
    sliding-window layer: each query sees the `cfg.local_window` keys up
    to its own.  Where the JAX package's traced `is_local` sends every
    layer of a windowed model to the masked gather, the port hands the
    window and `cfg.attn_softcap` to the decode and verify kernels, which
    compute the same function.

    verify=True (speculative decode) sends an s > 1 window through the
    multi-query verify kernel — one pass over the lane's pages scores
    all s positions — instead of the chunk path's page gather.  Same
    math: the intra-window causal mask is identical.  `lora`: zamba's
    per-site q/k/v deltas (`_qkv`).

    Under tensor parallelism (`dist.shard.use_tp`) a rank holds its
    slices of wq / wk / wv, wo and of the pools' kv heads: it attends
    with its n_heads / tp query heads over its n_kv_heads / tp pool
    heads (the pools' width sets g), and `wo`'s output is summed over
    the ranks (`row_parallel`) on all three routes."""
    b, s, _ = x.shape
    hd, g, qpk = cfg.hd(), cache["k"].shape[-2], cfg.q_per_kv()
    ps = cache["k"].shape[1]
    S = tables.shape[1] * ps
    q, k, v = _qkv(p, cfg, x, lora)

    cos, sin = rope                                              # (b, s, hd/2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    quant_kv = "k_scale" in cache
    ck, cv = cache["k"], cache["v"]
    cks = cvs = None
    if quant_kv:
        kq, ks = _quantize_kv_rows(k)
        vq, vs = _quantize_kv_rows(v)
        cks, cvs = cache["k_scale"], cache["v_scale"]
        _page_scatter(ck, kq, rows)
        _page_scatter(cv, vq, rows)
        _page_scatter(cks, ks, rows)
        _page_scatter(cvs, vs, rows)
    else:
        _page_scatter(ck, k, rows)
        _page_scatter(cv, v, rows)
    total = lengths + n_new
    scale = 1.0 / math.sqrt(hd)
    window = cfg.local_window if is_local else 0
    cap = cfg.attn_softcap

    if s == 1:
        qg = q.reshape(b, g, qpk, hd).contiguous()
        out_g = paged_decode_attention(qg, ck, cv, tables, total, window,
                                       cap, k_scales=cks, v_scales=cvs)
        out = out_g.reshape(b, 1, g * qpk * hd).to(x.dtype)
        return row_parallel(out, p["wo"])

    if verify:
        qg = q.reshape(b, s, g, qpk, hd).contiguous()
        out_g = paged_verify_attention(qg, ck, cv, tables, lengths, window,
                                       cap, k_scales=cks, v_scales=cvs)
        out = out_g.reshape(b, s, g * qpk * hd).to(x.dtype)
        return row_parallel(out, p["wo"])

    # chunk path: gather the lane's pages back to a contiguous view
    tl = tables.long()
    if quant_kv:
        kg = (ck[tl].to(torch.float32) * cks[tl][..., None].to(torch.float32)
              ).reshape(b, S, g, hd)
        vg = (cv[tl].to(torch.float32) * cvs[tl][..., None].to(torch.float32)
              ).reshape(b, S, g, hd)
    else:
        kg = ck[tl].reshape(b, S, g, hd)
        vg = cv[tl].reshape(b, S, g, hd)
    qg = q.reshape(b, s, g, qpk, hd)
    scores = torch.einsum("bqgph,bkgh->bgpqk", qg.to(torch.float32),
                          kg.to(qg.dtype).to(torch.float32)) * scale
    if cap:
        scores = softcap(scores, cap)                # after the scale
    k_pos = torch.arange(S, device=x.device)
    mask = (k_pos[None, None, :] <= rows.slots[:, :, None]) \
        & (k_pos[None, None, :] < total[:, None, None])          # (b, s, S)
    if window:
        mask = mask & (rows.slots[:, :, None] - k_pos[None, None, :]
                       < window)
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgpqk,bkgh->bqgph", w.to(vg.dtype), vg)
    out = out.reshape(b, s, g * qpk * hd).to(x.dtype)
    return row_parallel(out, p["wo"])


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum of two operands in their promoted dtype, as `jnp.einsum`
    promotes (f32 x bf16 -> f32, bf16 x bf16 -> bf16)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def mla_attend(p: Params, cfg: ModelConfig, q_nope: torch.Tensor,
               q_rope: torch.Tensor, cache: Dict[str, torch.Tensor],
               tables: torch.Tensor, slots: torch.Tensor,
               total: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The absorbed latent attention of a step, after its rows are
    written: q_nope (b, s, H, nope) and the rotated q_rope (b, s, H,
    rope_d) against every latent row the lanes' tables name.  Returns
    (b, s, H * v_head_dim), before `wo`.

    Rounds where the JAX package rounds: `w_uk` / `w_uv` dequantized to
    bf16 (unchanged when float), the scores in f32 against the pools
    read at the query's dtype, the probabilities cast to the pool dtype
    for the latent product, whose result is rounded to `out_dtype` (the
    activations') only after."""
    m = cfg.mla
    b, s, H, nope = q_nope.shape
    r, rope_d, vd = m.kv_lora_rank, m.qk_rope_head_dim, m.v_head_dim
    c_pool, kr_pool = cache["c_kv"], cache["k_rope"]
    S = tables.shape[1] * c_pool.shape[1]
    tl = tables.long()
    c_all = c_pool[tl].reshape(b, S, r)
    kr_all = kr_pool[tl].reshape(b, S, rope_d)

    w_uk = deq(p["w_uk"]).reshape(r, H, nope)
    q_lat = _einsum("bqhn,rhn->bqhr", q_nope, w_uk)
    f32 = torch.float32
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat.to(f32),
                           c_all.to(q_lat.dtype).to(f32))
              + torch.einsum("bqhr,bkr->bhqk", q_rope.to(f32),
                             kr_all.to(q_rope.dtype).to(f32)))
    scores = scores / math.sqrt(nope + rope_d)
    k_pos = torch.arange(S, device=tables.device)
    mask = (k_pos[None, None, :] <= slots[:, :, None]) \
        & (k_pos[None, None, :] < total[:, None, None])          # (b, s, S)
    scores = scores.masked_fill(~mask[:, None, :, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)

    o_lat = torch.einsum("bhqk,bkr->bqhr", w.to(c_all.dtype), c_all)
    w_uv = deq(p["w_uv"]).reshape(r, H, vd)
    out = _einsum("bqhr,rhv->bqhv", o_lat.to(out_dtype), w_uv)
    return out.reshape(b, s, H * vd)


def mla_paged_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
                   cache: Dict[str, torch.Tensor], tables: torch.Tensor,
                   lengths: torch.Tensor, n_new: torch.Tensor,
                   rows: PageRows, rope: Rope, is_local: bool = False,
                   verify: bool = False) -> torch.Tensor:
    """Paged absorbed-MLA step over this layer's latent pools, written
    in place: cache {c_kv: (n_pages + 1, ps, r), k_rope: (n_pages + 1,
    ps, rope_d)}; rope: cos/sin tables (b, s, rope_d/2) at `rows.slots`.
    Returns the attention output (b, s, d).

    Prefill chunks, decode steps and verify windows take the same path:
    the latent gather scores every window position under the
    intra-window causal mask, so `verify` needs no kernel of its own (as
    in the JAX package; `is_local` and `verify` are unused).

    Under tensor parallelism (`dist.shard.use_tp`) a rank holds its
    heads' columns of wq, w_uk and w_uv (head-major, so a contiguous
    slice is whole heads) and their rows of wo, whose output is summed
    over the ranks (`row_parallel`); w_dkv, ckv_norm and the latent pools
    stay whole, and every rank writes the same latent rows.  The head
    count is read off wq's columns."""
    m = cfg.mla
    b, s, _ = x.shape
    nope, rope_d, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    H = p["wq"].shape[-1] // (nope + rope_d)

    q = qmm(x, p["wq"]).reshape(b, s, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = qmm(x, p["w_dkv"])
    c_new = rms_norm(dkv[..., :r], p["ckv_norm"], cfg.norm_eps)
    kr_new = dkv[..., r:][:, :, None, :]                         # (b,s,1,rd)
    cos, sin = rope
    q_rope = apply_rope(q_rope, cos, sin)
    kr_new = apply_rope(kr_new, cos, sin)

    _page_scatter(cache["c_kv"], c_new, rows)
    _page_scatter(cache["k_rope"], kr_new[:, :, 0, :], rows)
    out = mla_attend(p, cfg, q_nope, q_rope, cache, tables, rows.slots,
                     lengths + n_new, x.dtype)
    return row_parallel(out, p["wo"])


def attn_paged_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    cache: Dict[str, torch.Tensor], tables: torch.Tensor,
                    lengths: torch.Tensor, n_new: torch.Tensor,
                    rows: PageRows, rope: Rope, is_local: bool = False,
                    verify: bool = False, lora: Params = None
                    ) -> torch.Tensor:
    if cfg.attn_kind == "mla":
        return mla_paged_step(p, cfg, x, cache, tables, lengths, n_new,
                              rows, rope, is_local=is_local, verify=verify)
    return gqa_paged_step(p, cfg, x, cache, tables, lengths, n_new, rows,
                          rope, is_local=is_local, verify=verify, lora=lora)


def paged_cache_spec(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, ParamSpec]:
    """One layer's paged KV pools: `n_pages` pages for the block tables
    plus the dump page `n_pages` that takes a step's padding rows
    (`page_rows`).  dtype int8 adds f16 per-(token, kv-head) scale pools
    "k_scale"/"v_scale"; every leaf keeps the page axis first, so page
    copies move scales with their pages.  MLA keeps float latent pools
    "c_kv" / "k_rope" and refuses int8, as the JAX package does.

    Logical axes as the JAX package's `paged_cache_specs`: K/V pools and
    their scale pools shard the kv-head dim (`TP`), the page axis stays
    replicated (the block tables are host-side and the same on every
    rank); MLA's latent pools are replicated."""
    if cfg.attn_kind == "mla":
        if dtype == torch.int8:
            raise ValueError(
                "int8 paged KV is not supported for MLA latent pools")
        m = cfg.mla
        return {
            "c_kv": ParamSpec((n_pages + 1, page_size, m.kv_lora_rank),
                              dtype, (NONE, NONE, NONE), init="zeros"),
            "k_rope": ParamSpec((n_pages + 1, page_size,
                                 m.qk_rope_head_dim), dtype,
                                (NONE, NONE, NONE), init="zeros")}
    kv = ParamSpec((n_pages + 1, page_size, cfg.n_kv_heads, cfg.hd()),
                   dtype, (NONE, NONE, TP, NONE), init="zeros")
    spec = {"k": kv, "v": kv}
    if dtype == torch.int8:
        sc = ParamSpec((n_pages + 1, page_size, cfg.n_kv_heads),
                       torch.float16, (NONE, NONE, TP), init="zeros")
        spec["k_scale"] = sc
        spec["v_scale"] = sc
    return spec
