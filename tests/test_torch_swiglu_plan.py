"""`swiglu_qgemv`'s host plan and its order of summation, on the CPU.

The plan (`repro_torch.kernels.swiglu_gemv.split_plan`) is a function of
shapes alone; it must give every call qwen2.5-3b and its smoke config
make an instantiated M tile, a shared-memory size the card holds (two
blocks to an SM on the full model), a grid of column tiles x splits with
no M dimension (each weight byte read once per call at any M), and
splits that cover K exactly once.  The kernel's order of summation,
emulated in plain PyTorch (`swiglu_split_order`: per-lane group-scaled
partials of gate and up, lanes in pairs, warps and splits in order,
then the SiLU * mul epilogue), must equal the JAX oracle and the Pallas
kernel (interpret mode) within 1e-5 relative: f32 sums in another
order, on O(1) inputs.

Inputs are drawn with numpy from a seed and handed to both packages.
"""
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ref_swiglu_qgemv as jax_ref_swiglu_qgemv
from repro.kernels.swiglu_gemv import swiglu_qgemv as pl_swiglu_qgemv
from repro.quant import qarray as jax_qarray

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import _build
from repro_torch.kernels import cim_gemv as cg
from repro_torch.kernels import swiglu_gemv as sw
from repro_torch.quant.ptq import _pick_group

M_SENT = (1, 4, 9, 20, 64, 128)   # batch 1/4, tile edge, verify, prefill


def _port_qtensor(jq):
    return from_numpy_tree({"data": np.asarray(jq.data),
                            "scales": np.asarray(jq.scales), "bits": jq.bits,
                            "group": jq.group, "axis": jq.axis,
                            "orig_shape": jq.orig_shape})


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def test_plan_reads_shapes_only():
    params = list(inspect.signature(sw.split_plan).parameters)
    assert params == ["m", "stored_rows", "n", "bits", "group", "n_sms"]
    a = sw.split_plan(4, 1024, 11008, 4, 128, 132)
    assert a == sw.split_plan(4, 1024, 11008, 4, 128, 132)
    assert all(isinstance(v, int) for v in a)
    with pytest.raises(ValueError):
        sw.split_plan(4, 1024, 11008, 5, 128)


def test_plan_constants_mirror_the_source():
    """The host's mirrors equal the constants of csrc/swiglu_gemv.cu."""
    src = (_build.CSRC / "swiglu_gemv.cu").read_text()
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src,
                                 re.M):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    assert (env["TN"], env["VN"], env["LANES"], env["WARPS"],
            env["MAX_SPLITS"], env["SMEM_MAX"]) == \
        (sw.TN, sw.VN, sw.LANES, sw.WARPS, sw.MAX_SPLITS, sw.SMEM_MAX)


@pytest.mark.parametrize("arch", ["full", "smoke"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", M_SENT)
def test_plan_takes_every_call_the_model_sends(arch, bits, m):
    cfg = (get_config if arch == "full" else get_smoke_config)("qwen2.5-3b")
    k, f = cfg.d_model, cfg.d_ff
    group = _pick_group(k, 128, 16)
    stored = k // 2 if bits == 4 else k
    plan = sw.split_plan(m, stored, f, bits, group, 132)
    assert plan.mt in cg.M_TILES and plan.mt == min(4, m)
    smem = sw.smem_bytes(plan, m, bits, group)
    assert smem <= sw.SMEM_MAX, smem
    assert plan.rows % sw.LANES == 0
    assert 1 <= plan.splits <= sw.MAX_SPLITS
    assert (plan.splits - 1) * plan.rows < stored <= plan.splits * plan.rows
    # the grid has no M dimension: every weight byte is read once per call
    assert plan.blocks == -(-f // sw.TN) * plan.splits
    if arch == "full":
        assert sw.blocks_per_sm(smem) == sw.BLOCKS_PER_SM, smem
        assert plan.blocks >= 132, plan            # every SM has work
        if bits == 4 and m <= 4:                   # decode: one round
            assert plan.blocks <= sw.BLOCKS_PER_SM * 132, plan


@pytest.mark.parametrize("seed", range(4))
def test_plan_splits_cover_k_exactly_once(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        stored = int(rng.integers(1, 6000))
        n = 4 * int(rng.integers(1, 3000))
        m = int(rng.choice(M_SENT))
        bits = int(rng.choice([4, 8]))
        group = int(rng.choice([16, 43, 86, 128]))
        n_sms = int(rng.choice([1, 8, 132]))
        plan = sw.split_plan(m, stored, n, bits, group, n_sms)
        rows = [p for sp in range(plan.splits)
                for b, e in cg.lane_rows(plan, sp, stored, sw.LANES)
                for p in range(b, e)]
        assert rows == list(range(stored)), (stored, n, plan)


def _case(bits, m, k, f, group, seed):
    rng = np.random.default_rng(seed)
    wg = (rng.standard_normal((k, f)) * 0.1).astype(np.float32)
    wu = (rng.standard_normal((k, f)) * 0.1).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qg = jax_qarray.quantize(jnp.asarray(wg), bits=bits, group=group)
    qu = jax_qarray.quantize(jnp.asarray(wu), bits=bits, group=group)
    return x, qg, qu


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,f,group,block_k,n_sms", [
    (4, 512, 256, 128, 256, 132),   # 8 splits
    (20, 1024, 512, 128, 512, 16),  # 6 splits
    (9, 688, 128, 86, 344, 4),      # groups of 86 (w_down's), 3 splits
    (3, 172, 68, 43, 172, 132),     # odd group, ragged column tile
])
def test_split_order_matches_pallas_and_oracle(bits, m, k, f, group,
                                               block_k, n_sms):
    x, qg, qu = _case(bits, m, k, f, group, 9)
    pallas = pl_swiglu_qgemv(jnp.asarray(x), qg.data, qg.scales, qu.data,
                             qu.scales, bits=bits, group=group,
                             block_n=min(128, f), block_k=block_k,
                             interpret=True)
    oracle = jax_ref_swiglu_qgemv(jnp.asarray(x), qg, qu)
    stored = k // 2 if bits == 4 else k
    plan = sw.split_plan(m, stored, f, bits, group, n_sms)
    assert plan.splits > 1 or f == 68
    out = sw.swiglu_split_order(torch.from_numpy(x), _port_qtensor(qg),
                                _port_qtensor(qu), n_sms)
    assert out.dtype == torch.float32 and out.shape == (m, f)
    assert _rel_err(out.numpy(), pallas) < 1e-5
    assert _rel_err(out.numpy(), oracle) < 1e-5


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,f,group,n_sms", [
    (4, 2048, 128, 128, 132),      # qwen2.5-3b's K, 3+ splits
    (20, 688, 16, 86, 1),          # one lane range cuts groups
    (9, 172, 68, 43, 8),           # pairs of INT4 rows straddle groups
])
def test_split_order_matches_oracle_any_group(bits, m, k, f, group, n_sms):
    x, qg, qu = _case(bits, m, k, f, group, 10)
    oracle = jax_ref_swiglu_qgemv(jnp.asarray(x), qg, qu)
    out = sw.swiglu_split_order(torch.from_numpy(x), _port_qtensor(qg),
                                _port_qtensor(qu), n_sms)
    assert _rel_err(out.numpy(), oracle) < 1e-5


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", M_SENT)
def test_plan_takes_phi3_gate_up(bits, m):
    """phi3-medium-14b's gate/up (5120 -> 17920, groups of 80): a
    shared-memory size the card holds, K covered once."""
    cfg = get_config("phi3-medium-14b")
    k, f = cfg.d_model, cfg.d_ff
    group = _pick_group(k, 128, 16)
    assert group == 80
    stored = k // 2 if bits == 4 else k
    plan = sw.split_plan(m, stored, f, bits, group, 132)
    assert sw.smem_bytes(plan, m, bits, group) <= sw.SMEM_MAX
    assert (plan.splits - 1) * plan.rows < stored <= plan.splits * plan.rows


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", M_SENT)
def test_plan_takes_deepseek_dense_gate_up(bits, m):
    """deepseek-v2-lite-16b's leading dense layer (2048 -> 10944, groups
    of 128): F / TN = 85.5, so the last column tile is half full; a
    shared-memory size the card holds, K covered once."""
    cfg = get_config("deepseek-v2-lite-16b")
    k, f = cfg.d_model, cfg.moe.first_dense_d_ff
    assert f % sw.TN == sw.TN // 2
    group = _pick_group(k, 128, 16)
    stored = k // 2 if bits == 4 else k
    plan = sw.split_plan(m, stored, f, bits, group, 132)
    assert sw.smem_bytes(plan, m, bits, group) <= sw.SMEM_MAX
    assert (plan.splits - 1) * plan.rows < stored <= plan.splits * plan.rows
    assert plan.blocks == -(-f // sw.TN) * plan.splits


@pytest.mark.parametrize("bits", [4, 8])
def test_split_order_matches_oracle_half_last_tile(bits):
    """A half-full last column tile (F = 192 = 1.5 tiles, as deepseek's
    10944 = 85.5 tiles) in the kernel's order of summation."""
    test_split_order_matches_oracle_any_group(bits, 4, 512, 192, 128, 132)
