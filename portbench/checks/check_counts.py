"""The frozen count of one qwen2.5-3b decode call against a hand count
from the published sizes: 181 `cim_gemv` calls (q, k, v, o and w_down of
36 layers, and the tied table) and 36 `swiglu_qgemv` calls, their
operations and bytes, and the call's least time."""
from _cpu import harness
import weights
from counts.peaks import PEAK_BYTES, PEAK_FLOPS, least_s

CONF = harness.load_config("qwen2.5-3b")
Z = weights.dims(CONF)
DENSE = harness.counts_for("dense")


def check_decode_call_by_hand():
    m, L, d, f, V = 8, 36, 2048, 11008, 151936
    calls = DENSE.kernel_calls(Z, 128, m)
    assert len(calls["cim_gemv"]) == 181
    assert len(calls["swiglu_qgemv"]) == 36
    assert DENSE.launches(Z)["decode"] == {
        "cim_gemv": 181, "swiglu_qgemv": 36, "paged_flash_decode": 36}
    # by hand: per layer q (2048 x 2048), k and v (2048 x 256 each), o
    # (2048 x 2048), w_down (11008 x 2048, groups of 86); the table
    mats = [(d, d, 128), (d, 256, 128), (d, 256, 128), (d, d, 128),
            (f, d, 86)]
    flops = sum(2 * m * k * n for k, n, _ in mats) * L + 2 * m * d * V
    nbytes = sum(k * n // 2 + k // g * n * 2 + 4 * m * (k + n)
                 for k, n, g in mats) * L
    nbytes += V * d // 2 + V * (d // 128) * 2 + 4 * m * (d + V)
    got = calls["cim_gemv"]
    assert sum(c[0] for c in got) == flops
    assert sum(c[1] for c in got) == nbytes
    sw = calls["swiglu_qgemv"][0]
    assert sw == (4 * m * d * f, 2 * (d * f // 2 + d // 128 * f * 2)
                  + 4 * m * (d + f))
    # 1.598 GB of weights: the call is bound by its bytes
    w = DENSE.weight_bytes(Z, 128)
    assert abs(w - 1_598_222_336) == 0
    fl, by = DENSE.least_decode(Z, 128, [1000] * 8)
    assert by > w and fl / PEAK_FLOPS < by / PEAK_BYTES
    assert least_s(fl, by) == by / PEAK_BYTES


def check_attention_bytes():
    totals = [100, 0, 300]
    [(fl, by)] = set(DENSE.attention_calls(Z, 16, 104, totals)[
        "paged_flash_decode"])
    kv = 2 * 2 * (128 + 2)                  # k and v, INT8 + f16 scale
    assert by == (100 + 16 + 300) * kv + 2 * 3 * 16 * 128 * 4 + 3 * 104 * 4 \
        + 3 * 4
    assert fl == 4 * 16 * 128 * 400
