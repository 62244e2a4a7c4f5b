"""Plain float32 reference of a dense GQA + SwiGLU decoder with RoPE,
QKV bias, RMSNorm and a tied table (qwen2.5-3b), over whole sequences
from position 0.  K and V take the INT8 round trip of the paged pools
before attention reads them, the current token's too.  Weights are the
INT4 leaves the benchmark drew, dequantized here one layer at a time.

`hidden(...)` returns the final-normed states (n, s, d); `head(...)`
the logits of some of those rows."""
from __future__ import annotations

import math

import torch

from reference.common import (einsum, int8_roundtrip, mm, rms_norm, rope,
                              silu)
from weights import dequantize


def hidden(z: dict, w: dict, tokens: torch.Tensor,
           control: bool = False) -> torch.Tensor:
    """tokens (n, s) int64, right-padded sequences."""
    n, s = tokens.shape
    H, g, hd, eps = z["heads"], z["kv_heads"], z["hd"], z["eps"]
    h = dequantize(w[("embed",)])[tokens]            # only these rows
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    b = ("blocks",)
    for i in range(z["layers"]):
        def W(*path):
            return dequantize(w[b + path], i)

        def v(*path):
            return w[b + path].value[i]
        x = rms_norm(h, v("ln_attn", "scale"), eps)
        q = (mm(x, W("attn", "wq"), control) + v("attn", "bq")
             ).view(n, s, H, hd)
        k = (mm(x, W("attn", "wk"), control) + v("attn", "bk")
             ).view(n, s, g, hd)
        vv = (mm(x, W("attn", "wv"), control) + v("attn", "bv")
              ).view(n, s, g, hd)
        q, k = rope(q, z["theta"]), rope(k, z["theta"])
        k, vv = int8_roundtrip(k), int8_roundtrip(vv)
        q = q.view(n, s, g, H // g, hd)
        sc = einsum("nsgph,ntgh->ngpst", q, k, control) / math.sqrt(hd)
        p = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
        a = einsum("ngpst,ntgh->nsgph", p, vv, control).reshape(n, s, H * hd)
        h = h + mm(a, W("attn", "wo"), control)
        x = rms_norm(h, v("ln_ffn", "scale"), eps)
        f = silu(mm(x, W("ffn", "w_gate"), control)) * mm(
            x, W("ffn", "w_up"), control)
        h = h + mm(f, W("ffn", "w_down"), control)
    return rms_norm(h, w[("ln_final", "scale")].value, eps)


def head_weight(z: dict, w: dict) -> torch.Tensor:
    """(d, V) f32."""
    return dequantize(w[("embed",)]).t()
