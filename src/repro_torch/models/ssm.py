"""Recurrent-state blocks (PyTorch port of `repro.models.ssm`): Mamba2,
and xLSTM's mLSTM and sLSTM.

Three entry points a cell:
  * `*_forward(p, cfg, x)`: the full sequence from the zero state
    (training, and `prefill`).  Nothing is written in place, so autograd
    holds.  Mamba2 is JAX's chunked SSD (the sequence padded to a
    multiple of L = min(chunk, s), the state carried across chunks);
    the sLSTM is JAX's recurrence over time (JAX checkpoints it per
    `time_chunk`, which changes no value; the port loops straight); the
    mLSTM is the stabilised PARALLEL form of JAX's recurrence (below).
  * `*_serve_step(p, cfg, x, cache, valid[, n_new])` advances up to s
    tokens per lane in one call (a chunked prefill, or s == 1 batched
    decode): x (b, s, d), valid (b, s) with lane i's first n_new[i]
    positions valid (the cells with a conv take n_new too).  A lane's
    state after the call is the state after feeding its valid tokens one
    at a time; masked positions update nothing, so one lane's padding
    never reaches another lane's state (the engine's
    continuous-batching contract).
  * the one-token decode of `DecoderLM.decode_step` is the serve step
    at s == 1 with every lane valid (`blocks.one_token`): the per-token
    arithmetic lives once.

The mLSTM's full-sequence forward.  JAX scans `_mlstm_cell` over time
from C = 0, n = 0, m = -1e30; under autograd that saves one (b, nh, dh,
dh) C a step (16.8 MB a lane at xlstm-1.3b's width, 361 GB for its 42
mLSTM layers at batch 8 x 64).  Unrolled, with F_t = sum_{l<=t} log
sigmoid(f_l) and D_tj = i_j + F_t - F_j (j <= t), the recurrence's
stabiliser is m_t = max(max_j D_tj, -1e30) and

    h_t = sum_j S_tj v_j / max(|sum_j S_tj|, exp(-m_t)),
    S_tj = (q_t . k_j) exp(D_tj - m_t),

which `mlstm_parallel` computes with (s, s) scores a head (F_t - F_j as
a masked cumulative sum, so no large prefix sums cancel).  Equal to
JAX's scan in exact arithmetic, gradients too (m flows back through its
max, as JAX's does); in f32 to sum order.

Differences of the serve steps from the JAX package:
  * the state is written IN PLACE into the caller's views of the
    `StateArena` leaves, where JAX returns new arrays.  A masked
    position keeps its lane's state bit for bit by folding the mask into
    the update's coefficients (decay 1, input 0) instead of a `where`
    and a copy, so a step reads and writes each large state leaf in
    place (Mamba2's SSM state, the mLSTM's matrix memory C);
  * what does not depend on the recurrent state runs over (b, s) at
    once, before the loop over s: the causal conv over concat(conv
    state, x), the mLSTM's q/k/v and gates, the sLSTM's x @ w_gates.
    Valid positions are a prefix of each lane (right-padded chunks), so
    for them this is JAX's arithmetic up to sum order; padding positions
    compute values no valid position reads, as in JAX.  The new conv
    state is the last k - 1 rows after each lane's valid ones (a lane
    with n_new == 0 keeps its own);
  * the mLSTM's head-wise q/k/v, (nh, dh, dh) and packed, go to
    `cim_gemv`'s expert-stack layout with the heads as the experts (x
    (nh, b * s, dh), every row counted), where JAX dequantizes them to
    bf16 in every step (`maybe_dequantize`); the port's weights are the
    exact INT4 values times their f16 scales.  The forward does the
    same.

Tensor parallelism (the engine's steps under `dist.shard.use_tp`): a
rank holds the leaves `dist.shard.recurrent_splits` cuts for it, and the
serve steps read the rank's widths off them (the forwards run whole).
  * Mamba2 runs its nh / tp heads: its z, x and dt columns of in_proj,
    all of B and C; the gated RMSNorm takes its mean of squares over the
    ranks' channels gathered (one `tp_all_gather`: the bits of tp = 1's
    mean), then `out_proj` is row-parallel (one `tp_all_reduce`);
  * the mLSTM gathers x_m (its heads' columns of up_proj) whole: `w_o`
    gives the rank's output columns of it, and the conv and the gates
    run whole on every rank; q / k / v and the cell run on its heads
    (its experts of the head-wise stacks), `hnorm` as Mamba2's norm,
    `down_proj` row-parallel: two gathers and one all-reduce a layer;
  * the sLSTM cell runs whole on every rank; its FFN is column-parallel
    and `ffn_down` row-parallel (one all-reduce).
A cell the table keeps whole runs as at tp = 1, with no collective; a
row-parallel projection the table keeps whole takes its input gathered
(`_project_down`).  Outside `use_tp` every leaf is whole and every
step's arithmetic is the same as before tensor parallelism.

Numerics copied from JAX: `jax.nn.softplus` is logaddexp(x, 0)
(`softplus` here; torch's own has a threshold shortcut), `jax.nn.gelu`
the tanh form, the mLSTM's log f = -softplus(-f) and den = max(|n.q|,
exp(-m)), the sLSTM's per-head gate means and max(n, 1e-6), Mamba2's
A = -exp(a_log) and softplus(dt + dt_bias) in f32 and its gated RMSNorm.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.dist.shard import tp_all_gather, tp_rank_and_size
from repro_torch.kernels.ops import expert_qmatmul
from repro_torch.kernels.ops import qmatmul as qmm
from repro_torch.kernels.ops import row_parallel
from repro_torch.quant.qarray import QTensor

from .common import (ACTIVATIONS, BATCH, FSDP, NONE, TP, ParamSpec, rms_norm,
                     scan, swish)
from .config import ModelConfig

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]

F32 = torch.float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as `jax.nn.softplus` computes it: logaddexp(x, 0)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype, as `jnp` promotes a float product."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _conv_taps(buf: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               s: int) -> torch.Tensor:
    """The depthwise causal conv of s positions over buf (b, k - 1 + s,
    c), the k - 1 inputs before them first; w: (k, c); b: (c,).  The
    taps sum in f32 in tap order; the result, before the activation, is
    in buf's dtype."""
    wf = w.to(F32)
    acc = buf[:, 0:s].to(F32) * wf[0]
    for i in range(1, w.shape[0]):
        acc = acc + buf[:, i:i + s].to(F32) * wf[i]
    return (acc + b.to(F32)).to(buf.dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """JAX's `_causal_conv` of a whole sequence from a zero state: x
    (b, s, c) -> (b, s, c) in the promoted dtype of x and w."""
    k = w.shape[0]
    dt = torch.promote_types(x.dtype, w.dtype)
    buf = torch.cat([x.new_zeros((x.shape[0], k - 1, x.shape[2]),
                                 dtype=dt), x.to(dt)], dim=1)
    return _conv_taps(buf, w, b, x.shape[1])


def _conv_prefix(conv: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor, n_new: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The depthwise causal conv of every position of a chunk.

    conv: (b, k - 1, c) the lane's last k - 1 inputs; x: (b, s, c) the
    chunk; w: (k, c); b: (c,).  Returns (the conv at each position,
    before the activation, (b, s, c) in the promoted dtype; the new
    state, the k - 1 rows after each lane's n_new valid ones)."""
    k, s = w.shape[0], x.shape[1]
    dt = torch.promote_types(torch.promote_types(conv.dtype, x.dtype),
                             w.dtype)
    buf = torch.cat([conv.to(dt), x.to(dt)], dim=1)          # (b, k-1+s, c)
    out = _conv_taps(buf, w, b, s)
    idx = n_new.long()[:, None] + torch.arange(k - 1, device=x.device)
    new = buf.gather(1, idx[..., None].expand(-1, -1, buf.shape[-1]))
    return out, new


def _norm_over(y: torch.Tensor, scale: torch.Tensor, eps: float,
               width: int) -> torch.Tensor:
    """`rms_norm` of y over `width` channels: y itself when it holds all
    of them, else a rank's channels (and its slice of `scale`), whose
    mean of squares is taken over the ranks' y gathered (the full row,
    so the mean has tp = 1's bits)."""
    if y.shape[-1] == width:
        return rms_norm(y, scale, eps)
    var = tp_all_gather(y, -1).to(F32).square().mean(dim=-1, keepdim=True)
    return (y.to(F32) * torch.rsqrt(var + eps) * scale.to(F32)).to(y.dtype)


def _project_down(y: torch.Tensor, w, width: int) -> torch.Tensor:
    """y @ w of an output projection whose input is `width` wide: y and
    w whole, or a rank's channels of y against its rows of w (summed
    over the ranks) or against w left whole (y gathered)
    (`row_parallel`)."""
    if y.shape[-1] == width:
        return qmm(y, w)
    return row_parallel(y, w)


def _lane_spec(shape, axes, dtype=F32) -> ParamSpec:
    """A decode-state leaf of one layer: lane axis first (`BATCH`),
    zeros; `axes` the logical axes of the dims after it."""
    return ParamSpec(tuple(shape), dtype, (BATCH, *axes), init="zeros",
                     lane_axis=0)


# ============================================================================
# Mamba2
# ============================================================================
def mamba2_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = int(s.expand * cfg.d_model)
    return d_inner, d_inner // s.head_dim, s.d_state


def mamba2_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    s, d = cfg.ssm, cfg.d_model
    di, nh, ds = mamba2_dims(cfg)
    conv_dim = di + 2 * ds                       # x + B + C (single group)
    return {
        "in_proj": ParamSpec((d, 2 * di + 2 * ds + nh), axes=(FSDP, TP)),
        "conv_w": ParamSpec((s.d_conv, conv_dim), axes=(NONE, TP),
                            scale=1.0 / math.sqrt(s.d_conv)),
        "conv_b": ParamSpec((conv_dim,), axes=(TP,), init="zeros"),
        "a_log": ParamSpec((nh,), axes=(NONE,), init="zeros"),
        "d_skip": ParamSpec((nh,), axes=(NONE,), init="ones"),
        "dt_bias": ParamSpec((nh,), axes=(NONE,), init="zeros"),
        "norm": ParamSpec((di,), axes=(TP,), init="ones"),
        "out_proj": ParamSpec((di, d), axes=(TP, FSDP)),
    }


def _mamba2_local(p: Params, cfg: ModelConfig):
    """(channels, heads, d_state) the leaves p hold: mamba2_dims', or a
    tensor-parallel rank's nh / tp heads of head_dim channels."""
    di, nh, ds = mamba2_dims(cfg)
    mine = p["a_log"].shape[-1]
    return (di, nh, ds) if mine == nh else (mine * cfg.ssm.head_dim, mine,
                                            ds)


def _mamba2_in(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """in_proj of x (b, s, d) split: the gate z, the conv input xbc
    (x, B, C), dt = softplus(dt_raw + dt_bias) (b, s, nh) f32 and
    A = -exp(a_log) (nh,) f32 (a rank's heads of each under tensor
    parallelism)."""
    di, nh, ds = _mamba2_local(p, cfg)
    proj = qmm(x, p["in_proj"])
    dt = softplus(proj[..., 2 * di + 2 * ds:].to(F32)
                  + p["dt_bias"].to(F32))
    return (proj[..., :di], proj[..., di:2 * di + 2 * ds], dt,
            -torch.exp(p["a_log"].to(F32)))


def _mamba2_out(p: Params, cfg: ModelConfig, y: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """The gated RMSNorm and out_proj of y (b, s, di) (a rank's channels:
    `_norm_over`, `_project_down`)."""
    di = mamba2_dims(cfg)[0]
    return _project_down(_norm_over(y * swish(z), p["norm"], cfg.norm_eps,
                                    di), p["out_proj"], di)


def mamba2_forward(p: Params, cfg: ModelConfig,
                   x: torch.Tensor) -> torch.Tensor:
    """JAX's chunked SSD over the full sequence from the zero state: x
    (b, s, d) padded to a multiple of L = min(chunk, s); in each chunk
    the intra-chunk scores (C_l . B_m) exp(cs_l - cs_m) dt_m (m <= l)
    plus the carried state's term, then the state advanced to the
    chunk's end.  Returns (b, s, d)."""
    b, s_orig, _ = x.shape
    di, nh, ds = mamba2_dims(cfg)
    hd = cfg.ssm.head_dim
    L = min(cfg.ssm.chunk, s_orig)
    pad = (-s_orig) % L
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    s = s_orig + pad
    nc = s // L
    z, xbc, dt, A = _mamba2_in(p, cfg, x)
    xbc = swish(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :di].reshape(b, nc, L, nh, hd)
    B = xbc[..., di:di + ds].reshape(b, nc, L, ds)
    C = xbc[..., di + ds:].reshape(b, nc, L, ds)
    dt = dt.reshape(b, nc, L, nh)
    cs = torch.cumsum(dt * A, dim=2)                         # (b, c, l, h)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    state = x.new_zeros((b, nh, hd, ds), dtype=F32)

    def chunk(carry, xs_i, B_i, C_i, dt_i, cs_i):
        """(the state at this chunk's end, its y)"""
        (state,) = carry
        cb = torch.einsum("bln,bmn->blm", C_i.to(F32), B_i.to(F32))
        # exp of the masked segment sums only: exp(+large) above the
        # diagonal would give 0 * inf in the backward
        seg = (cs_i[:, :, None, :] - cs_i[:, None, :, :]).masked_fill(
            ~causal[None, :, :, None], float("-inf"))        # (b, l, m, h)
        w = cb[..., None] * torch.exp(seg) * dt_i[:, None, :, :]
        y_intra = torch.einsum("blmh,bmhp->blhp", w.to(xs.dtype), xs_i)
        y_inter = torch.einsum("bln,bhpn,blh->blhp", C_i,
                               state.to(C_i.dtype),
                               torch.exp(cs_i).to(C_i.dtype))
        tot = cs_i[:, -1, :]                                  # (b, h)
        dec_end = torch.exp(tot[:, None, :] - cs_i)           # (b, l, h)
        contrib = torch.einsum("blh,blhp,bln->bhpn",
                               (dec_end * dt_i).to(xs.dtype), xs_i, B_i)
        state = state * torch.exp(tot)[:, :, None, None] + contrib.to(F32)
        return (state,), y_intra + y_inter

    _, y = scan(chunk, (state,), (xs, B, C, dt, cs))
    y = y.reshape(b, s, nh, hd)
    y = y + xs.reshape(b, s, nh, hd) * p["d_skip"].to(x.dtype)[None, None,
                                                               :, None]
    out = _mamba2_out(p, cfg, y.reshape(b, s, di), z)
    return out[:, :s_orig] if pad else out


def mamba2_serve_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      cache: State, valid: torch.Tensor,
                      n_new: torch.Tensor) -> torch.Tensor:
    """Masked multi-token Mamba2 step; cache {state (b, nh, hd, ds) f32,
    conv (b, d_conv - 1, conv_dim)} is advanced in place (a rank's
    heads, and its x channels of the conv: `_mamba2_local`).  Returns
    (b, s, d)."""
    b, s, _ = x.shape
    di, nh, ds = _mamba2_local(p, cfg)
    hd = cfg.ssm.head_dim

    z, xbc, dt, A = _mamba2_in(p, cfg, x)
    xc, conv = _conv_prefix(cache["conv"], xbc, p["conv_w"], p["conv_b"],
                            n_new)
    xc = swish(xc)
    xs = xc[..., :di].reshape(b, s, nh, hd)
    B = xc[..., di:di + ds].to(F32)
    C = xc[..., di + ds:].to(F32)
    # a masked position decays by 1 and takes no input: the state stays
    dA = torch.where(valid[..., None], torch.exp(dt * A), 1.0)
    u = torch.where(valid[..., None, None], dt[..., None] * xs.to(F32), 0.0)
    d_skip = p["d_skip"].to(x.dtype)[None, :, None]
    state = cache["state"]
    ys = []
    for t in range(s):
        state.mul_(dA[:, t, :, None, None])
        state.addcmul_(u[:, t, :, :, None], B[:, t, None, None, :])
        y = torch.matmul(state, C[:, t, None, :, None])[..., 0]
        ys.append(y.to(x.dtype) + xs[:, t] * d_skip)
    cache["conv"].copy_(conv)
    return _mamba2_out(p, cfg, torch.stack(ys, dim=1).reshape(b, s, di), z)


def mamba2_cache_spec(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    di, nh, ds = mamba2_dims(cfg)
    return {"state": _lane_spec((batch, nh, cfg.ssm.head_dim, ds),
                                (TP, NONE, NONE)),
            "conv": _lane_spec((batch, cfg.ssm.d_conv - 1, di + 2 * ds),
                               (NONE, TP), torch.bfloat16)}


# ============================================================================
# mLSTM (xLSTM matrix-memory block)
# ============================================================================
def mlstm_dims(cfg: ModelConfig):
    s = cfg.ssm
    di = int(s.proj_factor_mlstm * cfg.d_model)
    return di, s.mlstm_heads, di // s.mlstm_heads


def mlstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    s, d = cfg.ssm, cfg.d_model
    di, nh, dh = mlstm_dims(cfg)
    return {
        "up_proj": ParamSpec((d, 2 * di), axes=(FSDP, TP)),
        "conv_w": ParamSpec((s.conv_width, di), axes=(NONE, TP),
                            scale=1.0 / math.sqrt(s.conv_width)),
        "conv_b": ParamSpec((di,), axes=(TP,), init="zeros"),
        # head-wise (block diagonal) q/k/v, sharded on the output dh dim
        "wq": ParamSpec((nh, dh, dh), axes=(NONE, NONE, TP)),
        "wk": ParamSpec((nh, dh, dh), axes=(NONE, NONE, TP)),
        "wv": ParamSpec((nh, dh, dh), axes=(NONE, NONE, TP)),
        "w_if": ParamSpec((di, 2 * nh), axes=(FSDP, NONE),
                          scale=1.0 / math.sqrt(di)),
        "b_if": ParamSpec((2 * nh,), axes=(NONE,), init="zeros"),
        "w_o": ParamSpec((di, di), axes=(FSDP, TP)),
        "hnorm": ParamSpec((di,), axes=(TP,), init="ones"),
        "down_proj": ParamSpec((di, d), axes=(TP, FSDP)),
    }


def headwise(xh: torch.Tensor, w) -> torch.Tensor:
    """x (nh, T, dh) against a head-wise weight (nh, dh, dh) -> (nh, T,
    dh) in x's dtype: a packed weight is one `cim_gemv` call in its
    stack layout, each head an expert holding all T rows; a float one is
    a batched product, as JAX's einsum."""
    if isinstance(w, QTensor):
        nh, T = xh.shape[0], xh.shape[1]
        counts = torch.full((nh,), T, dtype=torch.int32, device=xh.device)
        return expert_qmatmul(xh, w, counts)
    return expert_qmatmul(xh, w, None)


def mlstm_qkvif(p: Params, cfg: ModelConfig, xc: torch.Tensor):
    """q, k, v (b, s, nh, dh) f32 and the raw input / forget gates (b,
    s, nh) f32 of every position of the conv output xc (b, s, di), as
    JAX's `_mlstm_qkvif`: the head-wise products in xc's dtype, k scaled
    by 1/sqrt(dh) there.  A tensor-parallel rank holding its heads of
    the stacks gets its heads of each: the gates of the whole xc, the
    products of its channels."""
    di, nh, dh = mlstm_dims(cfg)
    b, s, _ = xc.shape
    gates = (_mm(xc, p["w_if"]) + p["b_if"]).to(F32)
    i_raw, f_raw = gates[..., :nh], gates[..., nh:]
    mine = p["wq"].shape[-3]
    if mine != nh:
        lo = tp_rank_and_size()[0] * mine
        xc = xc[..., lo * dh:(lo + mine) * dh]
        i_raw, f_raw = i_raw[..., lo:lo + mine], f_raw[..., lo:lo + mine]
        nh = mine
    xh = xc.reshape(b * s, nh, dh).transpose(0, 1).contiguous()

    def heads(w, scale=None):
        out = headwise(xh, w).to(xc.dtype)
        if scale is not None:
            out = out / scale
        return out.transpose(0, 1).reshape(b, s, nh, dh).to(F32)
    q, k, v = heads(p["wq"]), heads(p["wk"], math.sqrt(dh)), heads(p["wv"])
    return q, k, v, i_raw, f_raw


def _mlstm_in(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """up_proj of x (b, s, d) split into the cell input x_m and the gate
    z, and the output gate o = sigmoid(x_m @ w_o).  A tensor-parallel
    rank's columns of up_proj give its heads' x_m, gathered whole, and
    its z; its columns of w_o its o."""
    up = qmm(x, p["up_proj"])
    mine = up.shape[-1] // 2
    x_m, z = up[..., :mine], up[..., mine:]
    if mine != mlstm_dims(cfg)[0]:
        x_m = tp_all_gather(x_m, -1)
    return x_m, z, torch.sigmoid(qmm(x_m, p["w_o"]))


def _mlstm_out(p: Params, cfg: ModelConfig, h: torch.Tensor,
               o: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The cell's h (b, s, nh, dh) f32 -> RMSNorm, output gate, gate z,
    down_proj (a rank's heads: `_norm_over`, `_project_down`)."""
    b, s = h.shape[:2]
    di = mlstm_dims(cfg)[0]
    h = h.reshape(b, s, -1).to(dtype)
    h = _norm_over(h, p["hnorm"], cfg.norm_eps, di) * o
    return _project_down(h * swish(z), p["down_proj"], di)


def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_raw: torch.Tensor, f_raw: torch.Tensor) -> torch.Tensor:
    """h (b, s, nh, dh) f32 of JAX's mLSTM recurrence over s steps from
    C = 0, n = 0, m = -1e30, in the stabilised parallel form (module
    docstring): q, k, v (b, s, nh, dh) f32; i_raw, f_raw (b, s, nh)
    f32.  Saves (b, nh, s, s) scores for the backward, not a C a step."""
    s = q.shape[1]
    log_f = (-softplus(-f_raw)).transpose(1, 2)               # (b, nh, s)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    # seg[t, j] = sum_{j < l <= t} log_f_l: column j of a cumulative sum
    # over l of log_f_l kept where l > j
    seg = log_f[..., :, None].expand(*log_f.shape, s).masked_fill(
        ~causal.tril(-1), 0.0).cumsum(dim=-2)
    D = (i_raw.transpose(1, 2)[..., None, :] + seg).masked_fill(
        ~causal, float("-inf"))                               # (b, nh, t, j)
    m = D.amax(dim=-1).clamp_min(-1e30)
    S = torch.einsum("bthd,bjhd->bhtj", q, k) * torch.exp(D - m[..., None])
    num = torch.einsum("bhtj,bjhd->bthd", S, v)
    den = torch.maximum(S.sum(-1).abs(), torch.exp(-m))       # (b, nh, t)
    return num / den.transpose(1, 2)[..., None]


def mlstm_forward(p: Params, cfg: ModelConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """The mLSTM block's cell over the full sequence from the zero
    state: x (b, s, d) -> (b, s, d)."""
    x_m, z, o = _mlstm_in(p, cfg, x)
    xc = swish(causal_conv(x_m, p["conv_w"], p["conv_b"]))
    h = mlstm_parallel(*mlstm_qkvif(p, cfg, xc))
    return _mlstm_out(p, cfg, h, o, z, x.dtype)


def mlstm_serve_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache: State, valid: torch.Tensor,
                     n_new: torch.Tensor) -> torch.Tensor:
    """Masked multi-token mLSTM step; cache {C (b, nh, dh, dh), n (b, nh,
    dh), m (b, nh) f32 (a rank's heads), conv (b, conv_width - 1, di)
    (whole)} is advanced in place.  C is scaled by the forget gate and
    takes the rank-1 input in place (`mul_`, `addcmul_`), then read once
    for h.  Returns (b, s, d)."""
    s = x.shape[1]
    x_m, z, o = _mlstm_in(p, cfg, x)
    xc, conv = _conv_prefix(cache["conv"], x_m, p["conv_w"], p["conv_b"],
                            n_new)
    q, k, v, i_raw, f_raw = mlstm_qkvif(p, cfg, swish(xc))
    log_f = -softplus(-f_raw)                           # log sigmoid(f)
    C, n, m = cache["C"], cache["n"], cache["m"]
    hs = []
    for t in range(s):
        vt = valid[:, t, None]
        m_new = torch.maximum(log_f[:, t] + m, i_raw[:, t])
        i_p = torch.exp(i_raw[:, t] - m_new)
        f_p = torch.exp(log_f[:, t] + m - m_new)
        # a masked position: forget gate 1, input 0
        fe = torch.where(vt, f_p, 1.0)[..., None]
        iv = torch.where(vt[..., None], i_p[..., None] * v[:, t], 0.0)
        ik = torch.where(vt[..., None], i_p[..., None] * k[:, t], 0.0)
        C.mul_(fe[..., None]).addcmul_(iv[..., :, None],
                                       k[:, t, :, None, :])
        n.mul_(fe).add_(ik)
        m.copy_(torch.where(vt, m_new, m))
        num = torch.matmul(C, q[:, t, ..., None])[..., 0]
        den = torch.maximum((n * q[:, t]).sum(-1).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
    cache["conv"].copy_(conv)
    return _mlstm_out(p, cfg, torch.stack(hs, dim=1), o, z, x.dtype)


def mlstm_cache_spec(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    di, nh, dh = mlstm_dims(cfg)
    return {"C": _lane_spec((batch, nh, dh, dh), (NONE, TP, NONE)),
            "n": _lane_spec((batch, nh, dh), (NONE, TP)),
            "m": _lane_spec((batch, nh), (NONE,)),
            "conv": _lane_spec((batch, cfg.ssm.conv_width - 1, di),
                               (NONE, TP), torch.bfloat16)}


# ============================================================================
# sLSTM (xLSTM scalar-memory block with recurrent gating)
# ============================================================================
def slstm_dims(cfg: ModelConfig):
    nh = cfg.ssm.mlstm_heads
    return cfg.d_model, nh, cfg.d_model // nh


def slstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, nh, dh = slstm_dims(cfg)
    f_up = int(cfg.ssm.proj_factor_slstm * d)
    return {
        "w_gates": ParamSpec((d, 4 * d), axes=(FSDP, NONE)),
        "r_gates": ParamSpec((nh, dh, 4 * dh), axes=(NONE, NONE, TP),
                             scale=1.0 / math.sqrt(dh)),
        "b_gates": ParamSpec((4 * d,), axes=(NONE,), init="zeros"),
        "gnorm": ParamSpec((d,), axes=(NONE,), init="ones"),
        "ffn_up": ParamSpec((d, 2 * f_up), axes=(FSDP, TP)),
        "ffn_down": ParamSpec((f_up, d), axes=(TP, FSDP)),
    }


def _slstm_gx(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w_gates + b_gates of every position, f32: (b, s, 4d)."""
    return _mm(x.to(F32), p["w_gates"]) + p["b_gates"].to(F32)


def _slstm_cell(gx_t: torch.Tensor, r: torch.Tensor, state):
    """One sLSTM step of every lane (JAX's `_slstm_cell`): gx_t (b, 4d)
    the input's gates, r the recurrent gates (nh, dh, 4dh) f32, state
    (c, n, h (b, d), m (b, nh)) f32 -> the new state."""
    c, n, h, m = state
    b, d = c.shape
    nh = m.shape[1]
    dh = d // nh
    rec = torch.matmul(h.reshape(b, nh, dh).transpose(0, 1), r)
    g = gx_t + rec.transpose(0, 1).reshape(b, 4 * d)
    zr, ir, fr, orr = g.split(d, dim=-1)
    ir_h = ir.reshape(b, nh, dh).mean(-1)             # per-head scalar gates
    fr_h = fr.reshape(b, nh, dh).mean(-1)
    m_new = torch.maximum(fr_h + m, ir_h)
    i_p = torch.exp(ir_h - m_new)[..., None]
    f_p = torch.exp(fr_h + m - m_new)[..., None]
    c_new = f_p * c.reshape(b, nh, dh) + i_p * torch.tanh(zr).reshape(
        b, nh, dh)
    n_new = f_p * n.reshape(b, nh, dh) + i_p
    h_new = torch.sigmoid(orr) * (
        c_new / torch.clamp_min(n_new, 1e-6)).reshape(b, d)
    return c_new.reshape(b, d), n_new.reshape(b, d), h_new, m_new


def _slstm_ffn(p: Params, cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
    """RMSNorm, then the gated GELU FFN of the cell's h (b, s, d) (a
    rank's columns of each half of ffn_up, `_project_down`)."""
    y = rms_norm(y, p["gnorm"], cfg.norm_eps)
    up = qmm(y, p["ffn_up"])
    f_up = up.shape[-1] // 2
    y = ACTIVATIONS["gelu"](up[..., :f_up]) * up[..., f_up:]
    return _project_down(y, p["ffn_down"],
                         int(cfg.ssm.proj_factor_slstm * cfg.d_model))


def slstm_forward(p: Params, cfg: ModelConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """The sLSTM block's cell over the full sequence from the zero state
    (m = -1e30): the recurrence over time, x (b, s, d) -> (b, s, d)."""
    b, _, d = x.shape
    nh = slstm_dims(cfg)[1]
    gx = _slstm_gx(p, x)
    r = p["r_gates"].to(F32)
    zero = x.new_zeros((b, d), dtype=F32)
    state = (zero, zero, zero, x.new_full((b, nh), -1e30, dtype=F32))

    def step(state, gx_t, r):
        state = _slstm_cell(gx_t, r, state)
        return state, state[2]

    _, hs = scan(step, state, (gx,), (r,))
    return _slstm_ffn(p, cfg, hs.to(x.dtype))


def slstm_serve_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache: State, valid: torch.Tensor) -> torch.Tensor:
    """Masked multi-token sLSTM step; cache {c, n, h (b, d), m (b, nh)}
    f32 is advanced in place.  x @ w_gates runs over (b, s) at once; the
    recurrent h_prev @ r_gates stays in the loop; the gated GELU FFN runs
    over (b, s).  Returns (b, s, d)."""
    gx = _slstm_gx(p, x)                                     # (b, s, 4d)
    r = p["r_gates"].to(F32)
    state = tuple(cache[k] for k in ("c", "n", "h", "m"))
    hs = []
    for t in range(x.shape[1]):
        new = _slstm_cell(gx[:, t], r, state)
        vt = valid[:, t, None]
        state = tuple(torch.where(vt, a2, a) for a, a2 in zip(state, new))
        hs.append(new[2])
    for key, val in zip(("c", "n", "h", "m"), state):
        cache[key].copy_(val)
    return _slstm_ffn(p, cfg, torch.stack(hs, dim=1).to(x.dtype))


def slstm_cache_spec(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    d, nh, _ = slstm_dims(cfg)
    return {"c": _lane_spec((batch, d), (TP,)),
            "n": _lane_spec((batch, d), (TP,)),
            "h": _lane_spec((batch, d), (TP,)),
            "m": _lane_spec((batch, nh), (NONE,))}
