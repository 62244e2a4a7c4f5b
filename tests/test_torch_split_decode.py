"""The split-KV decode kernels' host plan and their two halves, on the
CPU: the plan (`repro_torch.kernels.split_decode`) covers every key of
every row exactly once, and merging the plain per-split partials in
split order (`ref.*_partials`, `ref.ref_merge_partials`) equals the
Pallas kernels in interpret mode and the whole plain versions.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerance: 1e-5 absolute on attention outputs of O(1); the splits sum
in another order than one softmax (f32 sum order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as pl_flash_decode
from repro.kernels.paged_flash_decode import \
    paged_flash_decode as pl_paged_flash_decode

from repro_torch.kernels import split_decode as sd
from repro_torch.kernels.flash_decode import flash_decode, plan as fd_plan
from repro_torch.kernels.paged_flash_decode import (decode_plan,
                                                    paged_flash_decode)
from repro_torch.kernels.ref import (ref_flash_decode_partials,
                                     ref_merge_partials,
                                     ref_paged_decode_partials)


# ----------------------------------------------------------------------------
# the plan
# ----------------------------------------------------------------------------
def _covered(n_split, chunk, lo, hi):
    keys = []
    for s in range(n_split):
        kb, ke = sd.split_range(s, chunk, lo, hi)
        keys.extend(range(kb, ke))
    return keys


@pytest.mark.parametrize("seed", range(6))
def test_plan_covers_every_key_of_every_lane_once(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        b, g = int(rng.integers(1, 7)), int(rng.integers(1, 4))
        ps = int(rng.choice([1, 4, 5, 8, 16]))
        max_pages = int(rng.integers(1, 80))
        n_sms = int(rng.choice([8, 132]))
        n_keys = max_pages * ps
        n_split, chunk = decode_plan(b, g, max_pages, ps, n_sms)
        assert chunk % ps == 0 and chunk >= sd.MIN_KEYS
        assert (n_split - 1) * chunk < n_keys <= n_split * chunk
        assert n_split <= sd.MAX_SPLITS
        if n_keys // -(-n_sms // (b * g)) >= chunk:
            assert b * g * n_split >= n_sms      # one full wave when live
        window = int(rng.choice([0, 0, 7, 40]))
        lengths = list(rng.integers(0, n_keys + 1, size=b))
        lengths += [min(n_keys, chunk), min(n_keys, 2 * chunk), 1, 0]
        for n in lengths:
            lo, hi, empty = sd.paged_live(int(n), window, n_keys)
            want = range(n_keys) if n <= 0 else range(
                max(0, n - window) if window else 0, n)
            assert empty == (n <= 0)
            assert _covered(n_split, chunk, lo, hi) == list(want)


@pytest.mark.parametrize("S,pos,window", [
    (1000, 999, 0), (1000, 0, 0), (1000, -1, 0), (1000, 5000, 10),
    (1000, 5000, 0), (1024, 100, 40), (40, 17, 0), (4096, 4095, 0)])
def test_flash_plan_covers_the_visible_keys_once(S, pos, window):
    n_split, chunk = fd_plan(8, S)
    lo, hi, empty = sd.flash_live(pos, window, S)
    want = [t for t in range(S) if t <= pos and
            (not window or pos - t < window)] or list(range(S))
    assert empty == (not any(t <= pos and (not window or pos - t < window)
                             for t in range(S)))
    assert _covered(n_split, chunk, lo, hi) == want


@pytest.mark.parametrize("rows,n_keys", [(8, 1024), (2, 4096)])
def test_plan_fills_the_h100_at_the_timed_shapes(rows, n_keys):
    """Batch 4 at 1024 keys and batch 1 at 4096 (2 kv heads): at least
    one full wave of blocks on 132 SMs when every key is live."""
    n_split, chunk = sd.plan_splits(rows, n_keys, 16)
    assert rows * n_split >= sd.H100_SMS
    assert chunk % 16 == 0


# ----------------------------------------------------------------------------
# merged partials vs the Pallas kernels and the whole plain versions
# ----------------------------------------------------------------------------
def _pools(rng, pool, b, g, hd, ps, max_pages):
    n_pages = b * max_pages
    kf = rng.standard_normal((n_pages, ps, g, hd)).astype(np.float32)
    vf = rng.standard_normal((n_pages, ps, g, hd)).astype(np.float32)
    if pool != "int8":
        return kf, vf, None, None
    out = []
    for x in (kf, vf):
        sc = (np.maximum(np.abs(x).max(-1), 1e-8) / 127.0).astype(np.float16)
        out.append((np.clip(np.round(x / sc[..., None].astype(np.float32)),
                            -127, 127).astype(np.int8), sc))
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.parametrize("pool", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("case", ["edges", "window", "cap"])
def test_paged_merged_partials_match_pallas_and_plain(pool, case):
    """Lanes: on a split boundary (32), one past it, length 1 (every
    later split wholly past its end), length 0; a window that starts
    inside a split; a softcap."""
    b, g, qpk, hd, ps, max_pages = 4, 2, 4, 32, 8, 9
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, g, qpk, hd)).astype(np.float32)
    k, v, ks, vs = _pools(rng, pool, b, g, hd, ps, max_pages)
    tables = rng.permutation(b * max_pages).reshape(b, max_pages).astype(
        np.int32)
    n_split, chunk = decode_plan(b, g, max_pages, ps)
    assert n_split > 2 and chunk == 16
    lengths = np.array([2 * chunk, 2 * chunk + 1, 1, 0], np.int32)
    window, cap = {"edges": (0, 0.0), "window": (20, 0.0),
                   "cap": (0, 30.0)}[case]
    if case == "window":
        lengths[:2] = [43, 70]                 # windows start at 23 and 50
    quant = pool == "int8"
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if pool == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.bfloat16(), tv.bfloat16()
    pallas = np.asarray(pl_paged_flash_decode(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(lengths),
        window=window, attn_cap=cap, interpret=True,
        k_scales=jnp.asarray(ks) if quant else None,
        v_scales=jnp.asarray(vs) if quant else None))
    sc = (torch.from_numpy(ks), torch.from_numpy(vs)) if quant else \
        (None, None)
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(lengths))
    parts = []
    for s in range(n_split):
        # the plain partial over the split's whole key range; the kernel
        # clips the range to the lane's live keys, which the mask does here
        parts.append(ref_paged_decode_partials(
            *args, s * chunk, min((s + 1) * chunk, max_pages * ps), window,
            cap, *sc))
    merged = ref_merge_partials(parts).numpy()
    whole = paged_flash_decode(*args, window, cap, *sc).numpy()
    np.testing.assert_allclose(merged, pallas, atol=1e-5)
    np.testing.assert_allclose(merged, whole, atol=1e-5)
    m_last, l_last, _ = parts[-1]               # past lane 2's length 1
    assert float(m_last[2].max()) <= -1e29 and float(l_last[2].max()) == 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pos,window,cap", [
    (999, 0, 0.0), (0, 0, 0.0), (47, 0, 0.0), (48, 0, 0.0),
    (103, 20, 30.0), (-1, 0, 0.0), (5000, 10, 0.0)])
def test_flash_merged_partials_match_pallas_and_plain(dtype, pos, window,
                                                      cap):
    """S = 1000 (no multiple of 512); pos as a 0-d tensor; pos on and one
    past a split boundary; a window across one; no visible key."""
    bg, qpk, hd, S = 3, 4, 32, 1000
    rng = np.random.default_rng(12)
    q = rng.standard_normal((bg, qpk, hd)).astype(np.float32)
    k = rng.standard_normal((bg, S, hd)).astype(np.float32)
    v = rng.standard_normal((bg, S, hd)).astype(np.float32)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if dtype == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.bfloat16(), tv.bfloat16()
    pallas = np.asarray(pl_flash_decode(
        jnp.asarray(q), jk, jv, jnp.int32(pos), block_s=200, window=window,
        attn_cap=cap, interpret=True))
    pos_t = torch.tensor(pos, dtype=torch.int32)
    n_split, chunk = fd_plan(bg, S)
    assert n_split > 2
    parts = [ref_flash_decode_partials(torch.from_numpy(q), tk, tv, pos_t,
                                       s * chunk, min((s + 1) * chunk, S),
                                       window, cap)
             for s in range(n_split)]
    merged = ref_merge_partials(parts).numpy()
    whole = flash_decode(torch.from_numpy(q), tk, tv, pos_t, window,
                         cap).numpy()
    np.testing.assert_allclose(merged, pallas, atol=1e-5)
    np.testing.assert_allclose(merged, whole, atol=1e-5)


def test_merge_skips_empty_partials_and_reads_no_garbage():
    """A split with no key (m = NEG_INF, l = 0) adds nothing, whatever its
    accumulator holds, as in the merge kernel."""
    m = torch.tensor([[0.5, 1.0]])
    l = torch.tensor([[2.0, 3.0]])
    acc = torch.ones(1, 2, 4)
    empty = (torch.full((1, 2), -1e30), torch.zeros(1, 2),
             torch.full((1, 2, 4), float("nan")))
    out = ref_merge_partials([(m, l, acc), empty])
    torch.testing.assert_close(out, acc / l[..., None])


# ----------------------------------------------------------------------------
# 16 query heads per kv head (qwen3-moe): two blocks of 8 a (row, split)
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("pool", ["int8", "f32"])
@pytest.mark.parametrize("qpk", [16, 12])
def test_paged_qpk16_groups_of_8_match_pallas(pool, qpk):
    """qpk 16 (and a ragged 12): the kernel's z blocks each take 8 query
    heads of a (lane, kv head) over the same splits.  The plain partials
    of each group of 8 heads, merged in split order and put side by
    side, equal the Pallas kernel (interpret mode) at the whole qpk and
    the whole plain version; the plan weighs each row by its 2 blocks."""
    b, g, hd, ps, max_pages = 3, 2, 32, 8, 9
    rng = np.random.default_rng(13)
    q = rng.standard_normal((b, g, qpk, hd)).astype(np.float32)
    k, v, ks, vs = _pools(rng, pool, b, g, hd, ps, max_pages)
    tables = rng.permutation(b * max_pages).reshape(b, max_pages).astype(
        np.int32)
    n_split, chunk = decode_plan(b, g, max_pages, ps, qpk=qpk)
    assert (n_split, chunk) == sd.plan_splits(b * g * 2, max_pages * ps, ps)
    assert sd.q_groups(qpk) == 2
    lengths = np.array([2 * chunk + 1, 5, 0], np.int32)
    quant = pool == "int8"
    pallas = np.asarray(pl_paged_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lengths), interpret=True,
        k_scales=jnp.asarray(ks) if quant else None,
        v_scales=jnp.asarray(vs) if quant else None))
    sc = (torch.from_numpy(ks), torch.from_numpy(vs)) if quant else \
        (None, None)
    pools = (torch.from_numpy(k), torch.from_numpy(v),
             torch.from_numpy(tables), torch.from_numpy(lengths))
    merged = []
    for z in range(sd.q_groups(qpk)):
        qz = torch.from_numpy(q[:, :, 8 * z:8 * z + 8].copy())
        parts = [ref_paged_decode_partials(
            qz, *pools, s * chunk, min((s + 1) * chunk, max_pages * ps), 0,
            0.0, *sc) for s in range(n_split)]
        merged.append(ref_merge_partials(parts))
    merged = torch.cat(merged, dim=2).numpy()
    whole = paged_flash_decode(torch.from_numpy(q), *pools, 0, 0.0,
                               *sc).numpy()
    np.testing.assert_allclose(merged, pallas, atol=1e-5)
    np.testing.assert_allclose(merged, whole, atol=1e-5)


def test_qpk_bounds_and_flash_plan_weigh_query_groups():
    sd.check_shape("paged_flash_decode", 16, 128)
    with pytest.raises(ValueError):
        sd.check_shape("paged_flash_decode", 17, 128)
    assert fd_plan(8, 1024, qpk=16) == sd.plan_splits(16, 1024, 16)
    assert fd_plan(8, 1024) == fd_plan(8, 1024, qpk=8)


# ----------------------------------------------------------------------------
# head_dim 112 at one query head per kv head (zamba2-7b's shared attention)
# ----------------------------------------------------------------------------
def _shape(elem: int, hd: int) -> dict:
    """`Shape<T, HD>` of csrc/split_decode.cuh in Python, with its
    static_asserts: the one place the CPU can check that a head dim
    instantiates (no compiler here)."""
    row = hd * elem
    kt = 16 if row <= 256 else (8 if row <= 512 else 4)
    parts = 32 // kt
    dp = hd // parts
    dpb = dp * elem
    vb = 16 if dpb % 16 == 0 else (8 if dpb % 8 == 0 else 4)
    ve = vb // elem
    hdl = -(-hd // 32)
    stage = 2 * kt * (row + 16)
    assert hd % 16 == 0 and hd <= 256 and row % 16 == 0
    assert ve % 4 == 0 and dp % ve == 0 and hd % hdl == 0
    assert sd.QMAX * (hd + 2) * 4 <= 2 * stage
    # each lane's loads start on their own size: K rows padded to 16 B
    assert (row + 16) % 16 == 0 and (dp * elem) % vb == 0
    return dict(kt=kt, dp=dp, vb=vb, ve=ve, hdl=hdl,
                smem=sd.QMAX * hd * 4 + sd.WARPS * (2 * stage
                                                    + kt * sd.QMAX * 4))


def test_head_dims_mirror_the_sources_by_hd():
    """HEAD_DIMS is the list of `by_hd`'s cases, which all three split-KV
    kernels dispatch through; every one instantiates (`_shape`) and the
    host's shared-memory mirror equals the source's SMEM."""
    from repro_torch.kernels import _build
    import re
    src = (_build.CSRC / "split_decode.cuh").read_text()
    body = src[src.index("int by_hd(int hd"):]
    cases = tuple(int(c) for c in re.findall(r"case (\d+): return Fn<\1>",
                                             body[:body.index("default")]))
    assert cases == sd.HEAD_DIMS and 112 in cases
    for hd in sd.HEAD_DIMS:
        for elem in (1, 2, 4):
            assert sd.smem_bytes(elem, hd) == _shape(elem, hd)["smem"]


def test_head_dim_112_shape():
    """At hd 112 a lane holds ceil(112 / 32) = 4 dims of p . v (28 lanes
    busy, 4 idle), and int8's 56 bytes of q . k per lane load in 8-byte
    pieces (16 would run past the lane's dims); f32 and bf16 keep 16."""
    assert _shape(1, 112) == dict(kt=16, dp=56, vb=8, ve=8, hdl=4,
                                  smem=38400)
    assert _shape(2, 112)["vb"] == 16 and _shape(2, 112)["kt"] == 16
    assert _shape(4, 112)["vb"] == 16 and _shape(4, 112)["kt"] == 8
    assert _shape(4, 112)["smem"] == 64000
    sd.check_shape("paged_flash_decode", 1, 112)
    with pytest.raises(ValueError):
        sd.check_shape("paged_flash_decode", 1, 96)


@pytest.mark.parametrize("pool", ["int8", "bf16", "f32"])
def test_paged_hd112_qpk1_merged_partials_match_pallas(pool):
    """32 kv heads of one query head, hd 112, as the plan splits zamba2's
    decode call: the plain partials merged in split order equal the
    Pallas kernel (interpret mode) and the whole plain version, for
    lanes on and past a split boundary, at length 1 and at 0."""
    b, g, hd, ps, max_pages = 4, 32, 112, 16, 8
    rng = np.random.default_rng(17)
    q = rng.standard_normal((b, g, 1, hd)).astype(np.float32)
    k, v, ks, vs = _pools(rng, pool, b, g, hd, ps, max_pages)
    tables = rng.permutation(b * max_pages).reshape(b, max_pages).astype(
        np.int32)
    n_split, chunk = decode_plan(b, g, max_pages, ps, qpk=1)
    assert n_split > 1 and sd.q_groups(1) == 1
    lengths = np.array([chunk, chunk + 1, 1, 0], np.int32)
    quant = pool == "int8"
    pallas = np.asarray(pl_paged_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lengths), interpret=True,
        k_scales=jnp.asarray(ks) if quant else None,
        v_scales=jnp.asarray(vs) if quant else None))
    sc = (torch.from_numpy(ks), torch.from_numpy(vs)) if quant else \
        (None, None)
    pools = (torch.from_numpy(k), torch.from_numpy(v),
             torch.from_numpy(tables), torch.from_numpy(lengths))
    parts = [ref_paged_decode_partials(
        torch.from_numpy(q), *pools, s * chunk,
        min((s + 1) * chunk, max_pages * ps), 0, 0.0, *sc)
        for s in range(n_split)]
    merged = ref_merge_partials(parts).numpy()
    whole = paged_flash_decode(torch.from_numpy(q), *pools, 0, 0.0,
                               *sc).numpy()
    np.testing.assert_allclose(merged, pallas, atol=1e-5)
    np.testing.assert_allclose(merged, whole, atol=1e-5)
