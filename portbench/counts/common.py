"""Operations and bytes of one call of each kernel, from its shapes
(`counts/peaks.py` gives the rule).  A packed INT4 weight is K * N / 2
bytes and K / group * N f16 scales; activations in and out are f32."""
from __future__ import annotations

from typing import Tuple

F32, F16 = 4, 2


def packed_bytes(k: int, n: int, group: int) -> int:
    return k * n // 2 + (k // group) * n * F16


def cim_gemv(m: int, k: int, n: int, group: int,
             experts: int = 1) -> Tuple[float, float]:
    """x (m, k) @ W (k, n), each of `experts` stacked weights with its
    own m rows (the head-wise stack), or the (n, k) table: the same
    count."""
    flops = 2.0 * experts * m * k * n
    nbytes = experts * (packed_bytes(k, n, group) + m * k * F32
                        + m * n * F32)
    return flops, nbytes


def swiglu_qgemv(m: int, k: int, f: int, group: int) -> Tuple[float, float]:
    """silu(x @ Wg) * (x @ Wu): two packed weights in, one (m, f) out."""
    flops = 4.0 * m * k * f
    nbytes = 2 * packed_bytes(k, f, group) + m * k * F32 + m * f * F32
    return flops, nbytes
