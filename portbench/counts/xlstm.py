"""Frozen counts of an xLSTM[7:1] model call (xlstm-1.3b), the port's
serving route: per mLSTM layer `cim_gemv` for up_proj, the head-wise
q / k / v (one stack call each, the heads as experts), w_o and
down_proj; per sLSTM layer for ffn_up and ffn_down; the untied head.
The sLSTM's w_gates and r_gates and the mLSTM's gates are f32 leaves.
A lane's recurrent state is read and written once a call."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from counts.common import F32, cim_gemv, packed_bytes
from weights import pick_group

Count = Tuple[float, float]


def _groups(z: dict) -> Tuple[int, int]:
    return z["layers"] // z["per"], z["per"] - 1


def launches(z: dict) -> Dict[str, Dict[str, int]]:
    G, P = _groups(z)
    one = {"cim_gemv": G * P * 6 + G * 2 + 1}
    return {"prefill": dict(one), "decode": dict(one)}


def _mlstm_proj(z: dict):
    d, di = z["d"], z["di"]
    return [(d, 2 * di), (di, di), (di, d)]


def _slstm_proj(z: dict):
    return [(z["d"], 2 * z["f_up"]), (z["f_up"], z["d"])]


def kernel_calls(z: dict, group: int, m: int) -> Dict[str, List[Count]]:
    G, P = _groups(z)
    nh, dh = z["heads"], z["dh"]
    up, wo, down = (cim_gemv(m, k, n, pick_group(k, group))
                    for k, n in _mlstm_proj(z))
    qkv = cim_gemv(m, dh, dh, pick_group(dh, group), experts=nh)
    sl = [cim_gemv(m, k, n, pick_group(k, group)) for k, n in _slstm_proj(z)]
    head = cim_gemv(m, z["d"], z["vocab"], pick_group(z["d"], group))
    calls = (([up] + [qkv] * 3 + [wo, down]) * P + sl) * G + [head]
    return {"cim_gemv": calls}


def attention_calls(z, page_size, max_pages, totals):
    return {}


def state_bytes(z: dict) -> int:
    """One lane's recurrent state over all layers (f32)."""
    G, P = _groups(z)
    nh, dh, di, d = z["heads"], z["dh"], z["di"], z["d"]
    mlstm = nh * dh * dh + nh * dh + nh + (z["conv"] - 1) * di
    slstm = 4 * d + nh
    return F32 * G * (P * mlstm + slstm)


def weight_bytes(z: dict, group: int) -> int:
    G, P = _groups(z)
    d, di, nh, dh, sdh = z["d"], z["di"], z["heads"], z["dh"], z["sdh"]
    ml = sum(packed_bytes(k, n, pick_group(k, group))
             for k, n in _mlstm_proj(z))
    ml += 3 * nh * packed_bytes(dh, dh, pick_group(dh, group))
    ml += F32 * (d + z["conv"] * di + di + di * 2 * nh + 2 * nh + di)
    sl = sum(packed_bytes(k, n, pick_group(k, group))
             for k, n in _slstm_proj(z))
    sl += F32 * (d + d * 4 * d + nh * sdh * 4 * sdh + 4 * d + d)
    table = packed_bytes(d, z["vocab"], pick_group(d, group))
    return G * (P * ml + sl) + 2 * table + d * F32


def _token_flops(z: dict) -> float:
    """Operations of one token through every layer and the head."""
    G, P = _groups(z)
    d, di, nh, dh, sdh = z["d"], z["di"], z["heads"], z["dh"], z["sdh"]
    ml = sum(k * n for k, n in _mlstm_proj(z)) + 3 * nh * dh * dh \
        + di * 2 * nh + z["conv"] * di
    ml = 2.0 * ml + 5.0 * nh * dh * dh
    sl = 2.0 * (d * 4 * d + nh * sdh * 4 * sdh
                + sum(k * n for k, n in _slstm_proj(z)))
    return G * (P * ml + sl) + 2.0 * d * z["vocab"]


def least_decode(z: dict, group: int, totals: Sequence[int]) -> Count:
    n = len(totals)
    return (n * _token_flops(z),
            weight_bytes(z, group) + n * (2 * state_bytes(z)
                                          + z["vocab"] * F32))


def least_prefill(z: dict, group: int,
                  lanes: Sequence[Tuple[int, int]]) -> Count:
    q = sum(n for _, n in lanes)
    return (q * _token_flops(z),
            weight_bytes(z, group) + len(lanes) * 2 * state_bytes(z)
            + q * z["vocab"] * F32)
