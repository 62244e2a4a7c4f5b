"""PyTorch port vs the JAX package: quantization bytes, and the plain
versions of the three ported kernels vs the Pallas kernels (interpret
mode) and the JAX oracles.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances (all f32): the plain versions contract in another order than
XLA, so sums agree to a few f32 ulps of the largest term — 1e-5 of the
output scale for GEMVs, 1e-5 absolute for attention outputs of O(1).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cim_gemv import cim_gemv as pl_cim_gemv
from repro.kernels.paged_flash_decode import \
    paged_flash_decode as pl_paged_flash_decode
from repro.kernels.ref import ref_qmatmul_fused as jax_ref_qmatmul_fused
from repro.kernels.swiglu_gemv import swiglu_qgemv as pl_swiglu_qgemv
from repro.quant import ptq as jax_ptq
from repro.quant import qarray as jax_qarray

from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.cim_gemv import cim_gemv
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.paged_flash_decode import (paged_flash_decode,
                                                    paged_flash_verify)
from repro_torch.kernels.swiglu_gemv import swiglu_qgemv
from repro_torch.quant import ptq as port_ptq
from repro_torch.quant import qarray as port_qarray


def _np_qtensor(qt):
    """A JAX QTensor as the field dict `convert.from_numpy_tree` takes."""
    return {"data": np.asarray(qt.data), "scales": np.asarray(qt.scales),
            "bits": qt.bits, "group": qt.group, "axis": qt.axis,
            "orig_shape": qt.orig_shape}


def _port_qtensor(qt):
    return from_numpy_tree(_np_qtensor(qt))


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


# ----------------------------------------------------------------------------
# quantization
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape,group,axis", [
    ((256, 48), 16, 0),
    ((256, 48), 128, 0),
    ((1376, 40), 86, 0),          # qwen-style w_down group (not a power of 2)
    ((40, 172), 86, 1),           # embed table, grouped along d
    ((3, 128, 24), 16, 1),        # stacked (L, K, N) layer leaf
])
def test_quantize_bytes_match_jax(bits, shape, group, axis):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jq = jax_qarray.quantize(jnp.asarray(w), bits=bits, group=group,
                             axis=axis)
    tq = port_qarray.quantize(torch.from_numpy(w), bits=bits, group=group,
                              axis=axis)
    assert (tq.bits, tq.group, tq.axis, tq.orig_shape) == \
        (jq.bits, jq.group, jq.axis, jq.orig_shape)
    assert np.array_equal(tq.data.numpy(), np.asarray(jq.data))
    assert np.array_equal(tq.scales.numpy().view(np.uint16),
                          np.asarray(jq.scales).view(np.uint16))
    # unpack + dequantize agree exactly too (same f32 products)
    np.testing.assert_array_equal(
        tq.dequantize(torch.float32).numpy(),
        np.asarray(jq.dequantize(jnp.float32)))


def test_pick_group_matches_jax():
    for K in (8, 9, 64, 128, 172, 256, 1376, 2048, 11008, 151936, 97):
        for group in (16, 64, 128):
            assert port_ptq._pick_group(K, group, 16) == \
                jax_ptq._pick_group(K, group, 16), (K, group)
    assert port_ptq._pick_group(11008, 128, 16) == 86


def test_dequant_rows_matches_jax():
    rng = np.random.default_rng(1)
    tab = rng.standard_normal((50, 64)).astype(np.float32)
    ids = rng.integers(0, 50, size=(2, 5))
    jq = jax_qarray.quantize(jnp.asarray(tab), bits=4, group=16, axis=1)
    ref = jax_qarray.dequant_rows(jq, jnp.asarray(ids), jnp.float32)
    out = port_qarray.dequant_rows(_port_qtensor(jq), torch.from_numpy(ids),
                                   torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_convert_carries_bf16_and_packed_leaves_bit_for_bit():
    rng = np.random.default_rng(8)
    w = jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16)
    qt = jax_qarray.quantize(jnp.asarray(rng.standard_normal((32, 8)),
                                         jnp.float32), 4, 16)
    tree = from_numpy_tree({"a": {"w": np.asarray(w)},
                            "q": _np_qtensor(qt)})
    assert tree["a"]["w"].dtype == torch.bfloat16
    assert np.array_equal(tree["a"]["w"].view(torch.int16).numpy(),
                          np.asarray(w).view(np.int16))
    assert isinstance(tree["q"], port_qarray.QTensor)
    assert np.array_equal(tree["q"].data.numpy(), np.asarray(qt.data))


# ----------------------------------------------------------------------------
# cim_gemv
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,n,group,bk", [
    (1, 256, 128, 128, 256),
    (4, 512, 256, 128, 256),
    (3, 256, 128, 32, 128),
])
def test_cim_gemv_plain_matches_pallas(bits, m, k, n, group, bk):
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jq = jax_qarray.quantize(jnp.asarray(w), bits=bits, group=group)
    pallas = pl_cim_gemv(jnp.asarray(x), jq.data, jq.scales, bits=bits,
                         group=group, block_n=128, block_k=bk,
                         interpret=True)
    oracle = jax_ref_qmatmul_fused(jnp.asarray(x), jq, out_dtype=jnp.float32)
    out = cim_gemv(torch.from_numpy(x), _port_qtensor(jq))
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert _rel_err(out.numpy(), pallas) < 1e-5
    assert _rel_err(out.numpy(), oracle) < 1e-5


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("layout,k,n,group", [
    ("cols", 172, 64, 86),        # groups of 86: no Pallas kernel takes it
    ("cols", 172, 64, 43),        # odd group: pairs straddle groups
    ("table", 64, 96, 16),        # (V, K/2) tied logits table
    ("table", 172, 40, 86),
])
def test_cim_gemv_plain_matches_oracle(bits, layout, k, n, group):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, k)).astype(np.float32)
    if layout == "cols":
        w = rng.standard_normal((k, n)).astype(np.float32)
        jq = jax_qarray.quantize(jnp.asarray(w), bits=bits, group=group)
    else:
        w = rng.standard_normal((n, k)).astype(np.float32)
        jq = jax_qarray.quantize(jnp.asarray(w), bits=bits, group=group,
                                 axis=1)
    oracle = jax_ref_qmatmul_fused(jnp.asarray(x), jq, out_dtype=jnp.float32)
    out = cim_gemv(torch.from_numpy(x), _port_qtensor(jq))
    assert out.shape == (5, n)
    assert _rel_err(out.numpy(), oracle) < 1e-5


# ----------------------------------------------------------------------------
# swiglu_qgemv
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,f", [(2, 256, 128), (4, 512, 256)])
def test_swiglu_plain_matches_pallas(bits, m, k, f):
    rng = np.random.default_rng(4)
    wg = (rng.standard_normal((k, f)) * 0.1).astype(np.float32)
    wu = (rng.standard_normal((k, f)) * 0.1).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qg = jax_qarray.quantize(jnp.asarray(wg), bits, 128)
    qu = jax_qarray.quantize(jnp.asarray(wu), bits, 128)
    pallas = pl_swiglu_qgemv(jnp.asarray(x), qg.data, qg.scales, qu.data,
                             qu.scales, bits=bits, group=128, block_n=128,
                             block_k=256, interpret=True)
    out = swiglu_qgemv(torch.from_numpy(x), _port_qtensor(qg),
                       _port_qtensor(qu))
    assert out.shape == (m, f)
    assert _rel_err(out.numpy(), pallas) < 1e-5


# ----------------------------------------------------------------------------
# paged_flash_decode
# ----------------------------------------------------------------------------
def _paged_case(rng, pool_dtype, b=3, g=2, qpk=4, hd=64, ps=16, max_pages=8):
    n_pages = b * max_pages
    q = rng.standard_normal((b, g, qpk, hd)).astype(np.float32)
    kf = rng.standard_normal((n_pages, ps, g, hd)).astype(np.float32)
    vf = rng.standard_normal((n_pages, ps, g, hd)).astype(np.float32)
    tables = rng.permutation(n_pages).reshape(b, max_pages).astype(np.int32)
    lengths = rng.integers(1, max_pages * ps + 1, size=b).astype(np.int32)
    case = {"q": q, "tables": tables, "lengths": lengths}
    if pool_dtype == "int8":
        for name, x in (("k", kf), ("v", vf)):
            amax = np.abs(x).max(-1)
            sc = (np.maximum(amax, 1e-8) / 127.0).astype(np.float16)
            case[name] = np.clip(np.round(x / sc[..., None].astype(
                np.float32)), -127, 127).astype(np.int8)
            case[name + "_scales"] = sc
    else:
        case["k"], case["v"] = kf, vf
    return case


@pytest.mark.parametrize("pool_dtype", ["f32", "int8"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (40, 0.0), (0, 30.0)])
def test_paged_decode_plain_matches_pallas(pool_dtype, window, cap):
    c = _paged_case(np.random.default_rng(5), pool_dtype)
    c["lengths"][1] = 0                       # an inactive padding lane
    quant = pool_dtype == "int8"
    jargs = [jnp.asarray(c[n]) for n in ("q", "k", "v", "tables", "lengths")]
    pallas = pl_paged_flash_decode(
        *jargs, window=window, attn_cap=cap, interpret=True,
        k_scales=jnp.asarray(c["k_scales"]) if quant else None,
        v_scales=jnp.asarray(c["v_scales"]) if quant else None)
    targs = [torch.from_numpy(c[n]) for n in ("q", "k", "v", "tables",
                                               "lengths")]
    out = paged_flash_decode(
        *targs, window=window, attn_cap=cap,
        k_scales=torch.from_numpy(c["k_scales"]) if quant else None,
        v_scales=torch.from_numpy(c["v_scales"]) if quant else None)
    # every lane, the length-0 padding lane too: the mean of V over its
    # whole table, as the TPU kernel gives
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-5)


def test_paged_decode_plain_bf16_pools_match_jax():
    """bf16 pools: both packages upcast each gathered row to f32."""
    c = _paged_case(np.random.default_rng(6), "f32")
    kb = jnp.asarray(c["k"]).astype(jnp.bfloat16)
    vb = jnp.asarray(c["v"]).astype(jnp.bfloat16)
    pallas = pl_paged_flash_decode(jnp.asarray(c["q"]), kb, vb,
                                   jnp.asarray(c["tables"]),
                                   jnp.asarray(c["lengths"]), interpret=True)
    out = paged_flash_decode(
        torch.from_numpy(c["q"]), torch.from_numpy(c["k"]).bfloat16(),
        torch.from_numpy(c["v"]).bfloat16(), torch.from_numpy(c["tables"]),
        torch.from_numpy(c["lengths"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-5)


# ----------------------------------------------------------------------------
# CPU dispatch, counters, import isolation
# ----------------------------------------------------------------------------
def test_cpu_calls_run_plain_versions_and_count_no_launches():
    reset_launch_counts()
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    qt = port_qarray.quantize(w, 4, 16)
    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    cim_gemv(x, qt)
    swiglu_qgemv(x, qt, qt)
    c = _paged_case(rng, "int8", b=2, max_pages=2)
    paged_flash_decode(*[torch.from_numpy(c[n]) for n in
                         ("q", "k", "v", "tables", "lengths")],
                       k_scales=torch.from_numpy(c["k_scales"]),
                       v_scales=torch.from_numpy(c["v_scales"]))
    q5 = torch.from_numpy(c["q"])[:, None].repeat(1, 3, 1, 1, 1)
    paged_flash_verify(q5, *[torch.from_numpy(c[n]) for n in
                             ("k", "v", "tables", "lengths")],
                       k_scales=torch.from_numpy(c["k_scales"]),
                       v_scales=torch.from_numpy(c["v_scales"]))
    kv = torch.ones(4, 40, 64)
    flash_decode(torch.ones(4, 2, 64), kv, kv, 17)
    assert launch_counts() == {"cim_gemv": 0, "swiglu_qgemv": 0,
                               "paged_flash_decode": 0,
                               "paged_flash_verify": 0, "flash_decode": 0}


def test_wrapper_refuses_mixed_devices():
    qt = port_qarray.quantize(torch.ones(64, 32), 4, 16)
    with pytest.raises(ValueError):
        cim_gemv(torch.ones(2, 64, device="meta"), qt)


def test_import_repro_torch_leaves_jax_and_repro_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.launch.serve\n"
        "want = ['repro_torch.api.gateway', 'repro_torch.api.driver',\n"
        "        'repro_torch.api.protocol', 'repro_torch.fleet.router',\n"
        "        'repro_torch.fleet.replica', 'repro_torch.fleet.policy',\n"
        "        'repro_torch.obs.slo', 'repro_torch.obs.drift',\n"
        "        'repro_torch.obs.export', 'repro_torch.kernels.launches',\n"
        "        'repro_torch.dist.axes', 'repro_torch.dist.shard']\n"
        "assert all(m in sys.modules for m in want), want\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules "
        "if k.startswith('repro_torch')]))\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_gateway_fleet_and_slo_modules_import_no_jax():
    """The gateway, fleet and SLO modules, imported on their own in a
    fresh process, bring in neither `jax` nor `repro`."""
    code = (
        "import sys\n"
        "import repro_torch.api, repro_torch.fleet, repro_torch.obs\n"
        "from repro_torch.obs import prometheus_text, SLOMonitor\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


# ----------------------------------------------------------------------------
# launch and dequantize counts, per thread (engine replicas step on their
# own driver threads)
# ----------------------------------------------------------------------------
def _hammer(work, n_threads=8):
    """Run work(i) on n_threads threads at once, with a short switch
    interval so a lost update would show."""
    import threading
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return threads


def test_launch_counts_are_exact_per_thread_and_in_total():
    from repro_torch.kernels import thread_launch_counts
    from repro_torch.kernels.ops import add_launches
    reset_launch_counts()

    def work(i):
        for _ in range(500):
            add_launches({"cim_gemv": 1, "swiglu_qgemv": i})
    threads = _hammer(work)
    try:
        total = launch_counts()
        assert total["cim_gemv"] == 8 * 500
        assert total["swiglu_qgemv"] == 500 * sum(range(8))
        for i, thread in enumerate(threads):
            mine = thread_launch_counts(thread)
            assert mine["cim_gemv"] == 500 and mine["swiglu_qgemv"] == 500 * i
            assert mine["paged_flash_decode"] == 0
        assert thread_launch_counts() == dict.fromkeys(total, 0)
    finally:
        reset_launch_counts()
    assert launch_counts() == dict.fromkeys(total, 0)
    assert thread_launch_counts(threads[1]) == dict.fromkeys(total, 0)


def test_dequant_counts_are_exact_per_thread_and_in_total():
    port_qarray.reset_dequant_counters()

    def work(i):
        for _ in range(300):
            port_qarray.count_dequant("fused_dequant")
        for _ in range(i):
            port_qarray.count_dequant()
    threads = _hammer(work)
    try:
        assert port_qarray.dequant_counters() == {
            "full_dequant": sum(range(8)), "fused_dequant": 8 * 300}
        for i, thread in enumerate(threads):
            assert port_qarray.dequant_counters(thread) == {
                "full_dequant": i, "fused_dequant": 300}
    finally:
        port_qarray.reset_dequant_counters()


def test_capture_takes_back_only_its_own_threads_launches():
    """`StepRunner._capture`'s arithmetic on the CPU: what another thread
    launches while this one captures stays out of the capture's count."""
    import threading

    from repro_torch.kernels import thread_launch_counts
    from repro_torch.kernels.ops import add_launches
    reset_launch_counts()
    before = thread_launch_counts()
    other = threading.Thread(target=add_launches,
                             args=({"cim_gemv": 7},))
    add_launches({"cim_gemv": 3, "paged_flash_decode": 1})   # "captured"
    other.start()
    other.join(30)
    mine = {k: n - before[k] for k, n in thread_launch_counts().items()}
    try:
        assert mine["cim_gemv"] == 3 and mine["paged_flash_decode"] == 1
        assert launch_counts()["cim_gemv"] == 10
    finally:
        reset_launch_counts()


@pytest.mark.parametrize("n,offset,want", [
    (64, 0, 16), (48, 0, 16), (68, 0, 4), (64, 4, 4), (170, 0, 1),
    (171, 0, 1), (3, 0, 1), (64, 2, 1), (6, 0, 1)])
def test_vec_bytes_picks_the_widest_aligned_copy(n, offset, want):
    """16-byte copies where the weight's base and rows allow them, 4-byte
    ones where they are 4-byte aligned, else byte copies (any N)."""
    from repro_torch.kernels.cim_gemv import vec_bytes
    qt = port_qarray.quantize(torch.ones(64, n), 4, 16)
    flat = torch.empty(qt.data.numel() + 16, dtype=qt.data.dtype)
    base = (-flat.data_ptr()) % 16 + offset
    data = flat[base:base + qt.data.numel()].view(qt.data.shape)
    w = port_qarray.QTensor(data, qt.scales, qt.bits, qt.group, qt.axis,
                            qt.orig_shape)
    assert vec_bytes(w, n) == want
