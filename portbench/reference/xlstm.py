"""Plain float32 reference of xLSTM[7:1] (xlstm-1.3b) over whole
sequences from the zero state: groups of 7 mLSTM blocks closed by an
sLSTM block, pre-norm residual blocks, RMSNorm, an untied head.  The
equations are the xLSTM paper's (arXiv:2405.04517) in the port's layout:

  mLSTM: x_m, z = x W_up; o = sigmoid(x_m W_o); c = silu(conv4(x_m));
         i, f = c W_if + b_if (one a head); q, k, v = c W_q, c W_k /
         sqrt(dh), c W_v head-wise; C_t = f'_t C_{t-1} + i'_t v_t k_t^T,
         n_t = f'_t n_{t-1} + i'_t k_t, h_t = C_t q_t / max(|n_t q_t|, 1)
         with log f' = log sigmoid(f) and i' = exp(i), stabilised;
         out = (RMSNorm(h) * o * silu(z)) W_down.
  sLSTM: g = x W_gates + b_gates + h_{t-1} R (R block-diagonal, a
         head's 4 dh columns side by side; g split in four d-wide
         parts z, i, f, o); i and f are a head's mean; m_t = max(f + m,
         i), i' = exp(i - m_t), f' = exp(f + m - m_t); c_t = f' c + i'
         tanh(z), n_t = f' n + i', h_t = sigmoid(o) c_t / max(n_t, 1e-6);
         out = (gelu_tanh(a) * b) W_ffn_down, a, b = RMSNorm(h) W_ffn_up.

The mLSTM runs in the parallel form (an (s, s) matrix a head), equal to
the recurrence in exact arithmetic; the sLSTM steps through time."""
from __future__ import annotations

import math

import torch

from reference.common import einsum, gelu_tanh, mm, rms_norm, silu
from weights import dequantize


def _log_sigmoid(x):
    return -torch.logaddexp(-x, torch.zeros((), device=x.device))


def _mlstm(z, w, gi, pi, x, control):
    n, s, d = x.shape
    nh, dh, di = z["heads"], z["dh"], z["di"]
    c = ("mlstm", "cell")

    def W(name):
        return dequantize(w[c + (name,)], (gi, pi))

    def v(name):
        return w[c + (name,)].value[gi, pi]
    up = mm(x, W("up_proj"), control)
    x_m, zg = up[..., :di], up[..., di:]
    o = torch.sigmoid(mm(x_m, W("w_o"), control))
    cw, cb = v("conv_w"), v("conv_b")
    kw = cw.shape[0]
    pad = torch.cat([x_m.new_zeros(n, kw - 1, di), x_m], dim=1)
    xc = silu(sum(pad[:, j:j + s] * cw[j] for j in range(kw)) + cb)
    gates = mm(xc, v("w_if"), control) + v("b_if")
    i_raw, f_raw = gates[..., :nh], gates[..., nh:]
    xh = xc.view(n, s, nh, dh)
    q = einsum("nshd,hde->nshe", xh, W("wq"), control)
    k = einsum("nshd,hde->nshe", xh, W("wk"), control) / math.sqrt(dh)
    vv = einsum("nshd,hde->nshe", xh, W("wv"), control)
    log_f = _log_sigmoid(f_raw).transpose(1, 2)                  # (n, h, s)
    cum = torch.cumsum(log_f, dim=-1)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    D = (cum[..., :, None] - cum[..., None, :]
         + i_raw.transpose(1, 2)[..., None, :])
    D = D.masked_fill(~causal, float("-inf"))
    m = D.amax(-1, keepdim=True)
    S = einsum("nthd,njhd->nhtj", q, k, control) * torch.exp(D - m)
    num = einsum("nhtj,njhd->nthd", S, vv, control)
    den = torch.maximum(S.sum(-1).abs(), torch.exp(-m[..., 0]))
    h = (num / den.transpose(1, 2)[..., None]).reshape(n, s, di)
    h = rms_norm(h, v("hnorm"), z["eps"]) * o
    return mm(h * silu(zg), W("down_proj"), control)


def _slstm(z, w, gi, x, control):
    n, s, d = x.shape
    nh, sdh = z["heads"], z["sdh"]
    c = ("slstm", "cell")

    def v(name):
        return w[c + (name,)].value[gi]
    gx = mm(x, v("w_gates"), control) + v("b_gates")
    r = v("r_gates")                                   # (nh, sdh, 4 sdh)
    cs = x.new_zeros(n, d)
    ns = x.new_zeros(n, d)
    hs = x.new_zeros(n, d)
    ms = x.new_zeros(n, nh)
    out = []
    for t in range(s):
        rec = einsum("nhd,hde->nhe", hs.view(n, nh, sdh), r, control)
        gt = gx[:, t] + rec.reshape(n, 4 * d)
        zr, ir, fr, orr = gt.split(d, dim=-1)
        ih, fh = ir.view(n, nh, sdh).mean(-1), fr.view(n, nh, sdh).mean(-1)
        m_new = torch.maximum(fh + ms, ih)
        ip = torch.exp(ih - m_new)[..., None]
        fp = torch.exp(fh + ms - m_new)[..., None]
        c3 = fp * cs.view(n, nh, sdh) + ip * torch.tanh(zr).view(n, nh, sdh)
        n3 = fp * ns.view(n, nh, sdh) + ip
        hs = torch.sigmoid(orr) * (c3 / n3.clamp_min(1e-6)).reshape(n, d)
        cs, ns, ms = c3.reshape(n, d), n3.reshape(n, d), m_new
        out.append(hs)
    y = rms_norm(torch.stack(out, dim=1), v("gnorm"), z["eps"])
    up = mm(y, dequantize(w[c + ("ffn_up",)], gi), control)
    f = z["f_up"]
    return mm(gelu_tanh(up[..., :f]) * up[..., f:],
              dequantize(w[c + ("ffn_down",)], gi), control)


def hidden(z: dict, w: dict, tokens: torch.Tensor,
           control: bool = False) -> torch.Tensor:
    eps = z["eps"]
    h = dequantize(w[("embed",)])[tokens]
    G, P = z["layers"] // z["per"], z["per"] - 1
    for gi in range(G):
        for pi in range(P):
            x = rms_norm(h, w[("mlstm", "ln", "scale")].value[gi, pi], eps)
            h = h + _mlstm(z, w, gi, pi, x, control)
        x = rms_norm(h, w[("slstm", "ln", "scale")].value[gi], eps)
        h = h + _slstm(z, w, gi, x, control)
    return rms_norm(h, w[("ln_final", "scale")].value, eps)


def head_weight(z: dict, w: dict) -> torch.Tensor:
    return dequantize(w[("head",)])
