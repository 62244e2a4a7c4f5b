"""The split-KV verify kernel's host plan and its two halves, on the CPU:
the plan (`repro_torch.kernels.split_decode.plan_verify`) walks every
key each window row sees exactly once, and all of the table's keys for a
row that sees none; merging the plain per-split partials of all s * qpk
rows (`ref.ref_paged_verify_partials`, `ref.ref_merge_partials`) in
split order equals the Pallas kernel in interpret mode and the whole
plain version; the block's shared-memory size is the source's.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerance: 1e-5 absolute on attention outputs of O(1); the splits sum
in another order than one softmax (f32 sum order).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_flash_decode import \
    paged_flash_verify as pl_paged_flash_verify

from repro_torch.kernels import _build
from repro_torch.kernels import split_decode as sd
from repro_torch.kernels.paged_flash_decode import (paged_flash_verify,
                                                    verify_plan)
from repro_torch.kernels.ref import (ref_merge_partials,
                                     ref_paged_verify_partials)


# ----------------------------------------------------------------------------
# the plan
# ----------------------------------------------------------------------------
def _rows_walk(length, s, qpk, window, n_split, chunk, n_keys):
    """{row r: the keys it counts}, as the kernel walks them: block z of
    the row groups walks the span of its rows, split by split, and each
    row counts the keys of that walk it sees (all of them when it sees
    none)."""
    R = s * qpk
    warps, z = sd.verify_geometry(R)
    counted = {}
    for zi in range(z):
        r0, r1 = zi * warps * sd.QMAX, min(R, (zi + 1) * warps * sd.QMAX)
        lo, hi = sd.verify_span(length, r0 // qpk, (r1 - 1) // qpk, window,
                                n_keys)
        for r in range(r0, r1):
            rlo, rhi, empty = sd.verify_live(length, r // qpk, window,
                                             n_keys)
            keys = counted.setdefault(r, [])
            for sp in range(n_split):
                kb, ke = sd.split_range(sp, chunk, lo, hi)
                keys.extend(t for t in range(kb, ke)
                            if empty or rlo <= t < rhi)
    return counted


@pytest.mark.parametrize("seed", range(6))
def test_verify_plan_walks_every_visible_key_of_every_row_once(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        b, g = int(rng.integers(1, 6)), int(rng.integers(1, 4))
        s, qpk = int(rng.integers(1, 10)), int(rng.choice([1, 3, 8, 16]))
        ps = int(rng.choice([1, 4, 5, 8, 16]))
        max_pages = int(rng.integers(1, 40))
        n_sms = int(rng.choice([8, 132]))
        n_keys = max_pages * ps
        n_split, chunk = verify_plan(b, g, s, qpk, max_pages, ps, n_sms)
        assert chunk % ps == 0 and chunk >= sd.VERIFY_MIN_KEYS
        assert (n_split - 1) * chunk < n_keys <= n_split * chunk
        assert n_split <= sd.MAX_SPLITS
        window = int(rng.choice([0, 0, 1, 7, 40]))
        lengths = list(rng.integers(0, n_keys + 1, size=b))
        lengths += [0, 1, chunk - 1, chunk, n_keys - s, n_keys - 1,
                    n_keys + 2]
        for n in lengths:
            walk = _rows_walk(int(n), s, qpk, window, n_split, chunk, n_keys)
            assert sorted(walk) == list(range(s * qpk))
            for r, keys in walk.items():
                h = int(n) + r // qpk
                want = [t for t in range(n_keys)
                        if t <= h and (not window or h - t < window)]
                assert keys == (want or list(range(n_keys))), (n, r)


@pytest.mark.parametrize("b,s,max_pages,n_split,chunk", [
    (4, 5, 72, 36, 32),       # a verify step: lengths up to 1024 + 5
    (1, 5, 260, 130, 32),     # one lane at length 4096 + 5
    (4, 5, 8, 4, 32)])        # the spec run's 128-token tables
def test_verify_plan_at_the_timed_shapes(b, s, max_pages, n_split, chunk):
    """qwen2.5-3b (2 kv heads x 8 query heads, pages of 16): 32-key
    splits (two tiles of INT8 keys), and at least one wave of blocks on
    132 SMs at the two timed shapes."""
    assert verify_plan(b, 2, s, 8, max_pages, 16) == (n_split, chunk)
    assert sd.verify_geometry(s * 8) == (5, 1)
    if max_pages >= 72:
        assert b * 2 * n_split >= sd.H100_SMS


def test_verify_geometry_fills_its_blocks():
    """Rows in groups of QMAX, at most VERIFY_WARPS groups a block, and
    at most one warp of a block without rows."""
    for R in range(1, 400):
        warps, z = sd.verify_geometry(R)
        groups = -(-R // sd.QMAX)
        assert 1 <= warps <= sd.VERIFY_WARPS
        assert z == -(-groups // sd.VERIFY_WARPS)
        assert groups <= warps * z < groups + z
        assert (z - 1) * warps * sd.QMAX < R     # no block without rows


def test_verify_smem_bytes_mirror_the_source():
    """`verify_smem_bytes` equals `smem_bytes` of
    csrc/paged_flash_verify.cu, read from the source, for every
    instantiation, and every block fits the card's 227 KB."""
    src = (_build.CSRC / "paged_flash_verify.cu").read_text()
    hdr = (_build.CSRC / "split_decode.cuh").read_text()
    const = {n: int(v) for n, v in re.findall(
        r"^constexpr int (\w+) = (\d+);", src + hdr, re.M)}
    assert (const["MAX_WARPS"], const["STAGES"], const["QMAX"],
            const["MAX_SPLITS"]) == (sd.VERIFY_WARPS, sd.VERIFY_STAGES,
                                     sd.QMAX, sd.MAX_SPLITS)
    # the tile rule that sd.verify_smem_bytes repeats
    assert ("static constexpr int KT = ROW <= 256 ? 16 : "
            "(ROW <= 512 ? 8 : 4);") in hdr
    assert "static constexpr int RS = ROW + 16;" in hdr
    expr = re.search(r"constexpr int smem_bytes\(int warps\) \{.*?"
                     r"return ([^;]+);", src, re.S).group(1)
    for elem in (1, 2, 4):
        for hd in sd.HEAD_DIMS:
            row = hd * elem
            kt = 16 if row <= 256 else (8 if row <= 512 else 4)
            for warps in range(1, sd.VERIFY_WARPS + 1):
                env = dict(warps=warps, QMAX=sd.QMAX, HD=hd, KT=kt,
                           RS=row + 16, STAGES=const["STAGES"])
                want = eval(expr, {}, env)
                assert sd.verify_smem_bytes(elem, hd, warps) == want
                assert want <= 232448


# ----------------------------------------------------------------------------
# merged partials vs the Pallas kernel and the whole plain version
# ----------------------------------------------------------------------------
def _pools(rng, pool, n_pages, ps, g, hd):
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
@pytest.mark.parametrize("s", [1, 2, 5])
@pytest.mark.parametrize("case", ["edges", "window", "cap", "past_end"])
def test_verify_merged_partials_match_pallas_and_plain(pool, s, case):
    """edges: a lane whose first row's keys end on the split boundary, one
    whose first row sees one key past it, length 0, and a window ending
    at the table's last row; window: windows of 20 that start inside a
    split; cap: a softcap; past_end: window 1 and rows past the table,
    which see no key and get the mean of V over the whole table."""
    b, g, qpk, hd, ps, max_pages = 4, 2, 4, 32, 8, 9
    n_keys = max_pages * ps
    rng = np.random.default_rng(21)
    q = rng.standard_normal((b, s, g, qpk, hd)).astype(np.float32)
    k, v, ks, vs = _pools(rng, pool, b * max_pages, ps, g, hd)
    tables = rng.permutation(b * max_pages).reshape(b, max_pages).astype(
        np.int32)
    n_split, chunk = verify_plan(b, g, s, qpk, max_pages, ps)
    assert n_split > 2 and chunk == 32
    lengths, window, cap = {
        "edges": ([chunk - 1, chunk, 0, n_keys - s], 0, 0.0),
        "window": ([43, 50, 3, n_keys - s], 20, 0.0),
        "cap": ([chunk - 1, chunk, 0, n_keys - s], 0, 30.0),
        "past_end": ([n_keys - 2, n_keys - 1, n_keys + 3, 0], 1, 0.0),
    }[case]
    lengths = np.array(lengths, np.int32)
    quant = pool == "int8"
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if pool == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.bfloat16(), tv.bfloat16()
    pallas = np.asarray(pl_paged_flash_verify(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(lengths),
        window=window, attn_cap=cap, interpret=True,
        k_scales=jnp.asarray(ks) if quant else None,
        v_scales=jnp.asarray(vs) if quant else None))
    sc = (torch.from_numpy(ks), torch.from_numpy(vs)) if quant else \
        (None, None)
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(lengths))
    # each split's plain partial over its whole key range; the kernel
    # clips the range to its rows' span, which the row masks do here
    parts = [ref_paged_verify_partials(*args, sp * chunk,
                                       min((sp + 1) * chunk, n_keys),
                                       window, cap, *sc)
             for sp in range(n_split)]
    merged = ref_merge_partials(parts).reshape(b, g, s, qpk, hd).permute(
        0, 2, 1, 3, 4).numpy()
    whole = paged_flash_verify(*args, window, cap, *sc).numpy()  # plain
    np.testing.assert_allclose(merged, pallas, atol=1e-5)
    np.testing.assert_allclose(merged, whole, atol=1e-5)
    m_last, l_last, _ = parts[-1]
    if case == "edges":             # length 0: past its rows' keys
        assert float(m_last[2].max()) <= -1e29 and float(l_last[2].max()) == 0
    if case == "past_end":          # every row of lane 2 sees no key
        vf = (tv.float() * (torch.from_numpy(vs).float()[..., None]
                            if quant else 1.0))
        mean = vf[torch.from_numpy(tables[2]).long()].reshape(
            n_keys, g, hd).mean(0)
        np.testing.assert_allclose(
            merged[2], mean[None, :, None, :].expand(s, g, qpk, hd).numpy(),
            atol=1e-5)
        # the last split's keys all count, with score 0
        assert float(l_last[2].min()) == n_keys - (n_split - 1) * chunk
