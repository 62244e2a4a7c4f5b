"""Frozen counts of a dense GQA + SwiGLU model call (qwen2.5-3b), the
port's serving route: per layer `cim_gemv` for q, k, v, o and w_down,
`swiglu_qgemv` for gate and up, `paged_flash_decode` on a decode call;
the tied table's `cim_gemv` for the logits.  Paged K/V are INT8 with
one f16 scale per (token, kv head)."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from counts.common import F16, F32, cim_gemv, packed_bytes, swiglu_qgemv
from weights import pick_group

Count = Tuple[float, float]


def _proj(z: dict):
    """(K, N, group) of each packed projection of a layer, in call order."""
    d, H, g, hd, f = z["d"], z["heads"], z["kv_heads"], z["hd"], z["ff"]
    return [(d, H * hd), (d, g * hd), (d, g * hd), (H * hd, d), (f, d)]


def launches(z: dict) -> Dict[str, Dict[str, int]]:
    """Kernel wrapper calls of one model call, by kind."""
    L = z["layers"]
    one = {"cim_gemv": 5 * L + 1, "swiglu_qgemv": L}
    return {"prefill": dict(one), "decode": {**one, "paged_flash_decode": L}}


def kernel_calls(z: dict, group: int, m: int) -> Dict[str, List[Count]]:
    """The packed products of one model call whose kernels get m rows."""
    L, d, f, V = z["layers"], z["d"], z["ff"], z["vocab"]
    layer = [cim_gemv(m, k, n, pick_group(k, group))
             for k, n in _proj(z)]
    return {"cim_gemv": layer * L + [cim_gemv(m, d, V, pick_group(d, group))],
            "swiglu_qgemv": [swiglu_qgemv(m, d, f, pick_group(d, group))] * L}


def kv_token_bytes(z: dict) -> int:
    """One token's K and V in one layer: INT8 values and f16 scales."""
    return 2 * z["kv_heads"] * (z["hd"] + F16)


def attention_calls(z: dict, page_size: int, max_pages: int,
                    totals: Sequence[int]) -> Dict[str, List[Count]]:
    """`paged_flash_decode` of every layer of a decode call; totals: the
    keys each of the call's lanes attends over (0 for an empty lane,
    which reads one page)."""
    H, hd, b = z["heads"], z["hd"], len(totals)
    keys = sum(t if t else page_size for t in totals)
    flops = 4.0 * H * hd * sum(totals)
    nbytes = (keys * kv_token_bytes(z) + 2 * b * H * hd * F32
              + b * max_pages * 4 + b * 4)
    return {"paged_flash_decode": [(flops, nbytes)] * z["layers"]}


def weight_bytes(z: dict, group: int) -> int:
    """Every leaf a call reads once: packed weights with their scales,
    the table, the f32 norms and biases."""
    L, d, f, V = z["layers"], z["d"], z["ff"], z["vocab"]
    packed = sum(packed_bytes(k, n, pick_group(k, group))
                 for k, n in _proj(z))
    packed += 2 * packed_bytes(d, f, pick_group(d, group))
    floats = 2 * d + (z["heads"] + 2 * z["kv_heads"]) * z["hd"]
    return L * (packed + floats * F32) + packed_bytes(d, V, pick_group(
        d, group)) + d * F32


def _mm_params(z: dict) -> int:
    return z["layers"] * sum(k * n for k, n in _proj(z)) + \
        z["layers"] * 2 * z["d"] * z["ff"] + z["d"] * z["vocab"]


def least_decode(z: dict, group: int, totals: Sequence[int]) -> Count:
    """What a decode call must do for its decoding lanes, each attending
    over `totals[i]` keys (its new one included)."""
    n, L = len(totals), z["layers"]
    flops = 2.0 * n * _mm_params(z) + 4.0 * z["heads"] * z["hd"] * L * \
        sum(totals)
    nbytes = (weight_bytes(z, group) + L * kv_token_bytes(z) * sum(totals)
              + L * kv_token_bytes(z) * n + n * z["vocab"] * F32)
    return flops, nbytes


def least_prefill(z: dict, group: int,
                  lanes: Sequence[Tuple[int, int]]) -> Count:
    """What a prefill call must do: lanes of (tokens cached before, new
    tokens), each new token attending over the keys up to its own."""
    L, q = z["layers"], sum(n for _, n in lanes)
    keys = sum(n * p + n * (n + 1) // 2 for p, n in lanes)
    flops = 2.0 * q * _mm_params(z) + 4.0 * z["heads"] * z["hd"] * L * keys
    nbytes = (weight_bytes(z, group)
              + L * kv_token_bytes(z) * sum(p + n for p, n in lanes)
              + q * z["vocab"] * F32)
    return flops, nbytes
