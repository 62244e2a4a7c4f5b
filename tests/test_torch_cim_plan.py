"""`cim_gemv`'s host plan and its order of summation, on the CPU.

The plan (`repro_torch.kernels.cim_gemv.split_plan`) is a function of
shapes alone; it must give every call qwen2.5-3b and its smoke config
make an instantiated M tile, a shared-memory size the card holds, enough
blocks to fill 132 SMs on the wide projections, and splits that cover K
exactly once.  The kernel's order of summation, emulated in plain
PyTorch (`cim_gemv_split_order`: per-lane group-scaled partials, lanes
in pairs, warps and splits in order), must equal the JAX oracle and the
Pallas kernel (interpret mode) within 1e-5 relative: f32 sums in
another order, on O(1) inputs.

Inputs are drawn with numpy from a seed and handed to both packages.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cim_gemv import cim_gemv as pl_cim_gemv
from repro.kernels.ref import ref_qmatmul_fused as jax_ref_qmatmul_fused
from repro.quant import qarray as jax_qarray

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import cim_gemv as cg
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


def _calls(cfg):
    """(name, layout, K, N, group) of every cim_gemv call of a model."""
    d, hd = cfg.d_model, cfg.hd()
    H, G = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def grp(k):
        return _pick_group(k, 128, 16)
    return [("wq", "cols", d, H, grp(d)), ("wk", "cols", d, G, grp(d)),
            ("wo", "cols", H, d, grp(H)),
            ("w_down", "cols", cfg.d_ff, d, grp(cfg.d_ff)),
            ("table", "table", d, cfg.vocab, grp(d))]


def test_plan_reads_shapes_only():
    params = list(inspect.signature(cg.split_plan).parameters)
    assert params == ["layout", "m", "stored_rows", "n", "bits", "n_sms"]
    a = cg.split_plan("cols", 4, 5504, 2048, 4, 132)
    assert a == cg.split_plan("cols", 4, 5504, 2048, 4, 132)
    assert all(isinstance(v, int) for v in a)
    with pytest.raises(ValueError):
        cg.split_plan("rows", 4, 1024, 2048, 4)
    with pytest.raises(ValueError):
        cg.split_plan("cols", 4, 1024, 2048, 5)


@pytest.mark.parametrize("arch", ["full", "smoke"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", M_SENT)
def test_plan_takes_every_call_the_model_sends(arch, bits, m):
    cfg = (get_config if arch == "full" else get_smoke_config)("qwen2.5-3b")
    for name, layout, k, n, group in _calls(cfg):
        stored = k // 2 if bits == 4 else k
        plan = cg.split_plan(layout, m, stored, n, bits, 132)
        assert plan.mt in cg.M_TILES and plan.mt == min(4, m)
        smem = cg.smem_bytes(layout, plan, m, k, bits, group)
        assert smem <= cg.SMEM_MAX, (name, smem)
        if layout == "cols":
            assert plan.rows % cg.LANES == 0
            assert plan.splits <= cg.MAX_SPLITS
            assert plan.splits & (plan.splits - 1) == 0   # a cluster
            assert (plan.splits - 1) * plan.rows < stored \
                <= plan.splits * plan.rows
            assert plan.blocks == -(-n // cg.TN) * plan.splits
            if arch == "full" and (n == 2048 or name == "w_down"):
                assert plan.blocks >= 132, (name, plan)
        else:                          # persistent: one block per SM
            assert plan.splits == 1
            assert plan.blocks == min(132, -(-n // cg.TBL_VB))


@pytest.mark.parametrize("seed", range(4))
def test_plan_splits_cover_k_exactly_once(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        stored = int(rng.integers(1, 6000))
        n = 4 * int(rng.integers(1, 1200))
        m = int(rng.choice(M_SENT))
        n_sms = int(rng.choice([1, 8, 132]))
        plan = cg.split_plan("cols", m, stored, n, int(rng.choice([4, 8])),
                             n_sms)
        rows = [p for sp in range(plan.splits)
                for b, e in cg.lane_rows(plan, sp, stored)
                for p in range(b, e)]
        assert rows == list(range(stored)), (stored, n, plan)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,n,group,n_sms", [
    (4, 512, 256, 128, 132),      # 8 splits
    (20, 1024, 512, 128, 16),     # 2 splits
    (9, 768, 128, 64, 4),         # 2 splits
])
def test_split_order_matches_pallas_and_oracle(bits, m, k, n, group, n_sms):
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jq = jax_qarray.quantize(jnp.asarray(w), bits=bits, group=group)
    pallas = pl_cim_gemv(jnp.asarray(x), jq.data, jq.scales, bits=bits,
                         group=group, block_n=128, block_k=256,
                         interpret=True)
    oracle = jax_ref_qmatmul_fused(jnp.asarray(x), jq, out_dtype=jnp.float32)
    stored = k // 2 if bits == 4 else k
    assert cg.split_plan("cols", m, stored, n, bits, n_sms).splits > 1
    out = cg.cim_gemv_split_order(torch.from_numpy(x), _port_qtensor(jq),
                                  n_sms)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert _rel_err(out.numpy(), pallas) < 1e-5
    assert _rel_err(out.numpy(), oracle) < 1e-5


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,n,group,n_sms", [
    (4, 11008 // 8, 64, 86, 132),  # w_down's group of 86, 8 splits
    (3, 172, 68, 43, 132),         # odd group: pairs straddle groups
    (20, 688, 16, 86, 1),          # one lane range cuts groups
])
def test_split_order_matches_oracle_any_group(bits, m, k, n, group, n_sms):
    rng = np.random.default_rng(8)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jq = jax_qarray.quantize(jnp.asarray(w), bits=bits, group=group)
    oracle = jax_ref_qmatmul_fused(jnp.asarray(x), jq, out_dtype=jnp.float32)
    out = cg.cim_gemv_split_order(torch.from_numpy(x), _port_qtensor(jq),
                                  n_sms)
    assert _rel_err(out.numpy(), oracle) < 1e-5


def _family_calls(cfg):
    """(name, layout, K, N, group) of every cim_gemv call of a gemma or
    phi3 model: the projections, gemma's unfused gate/up, the tied table
    or phi3's untied head (cols layout)."""
    d, f = cfg.d_model, cfg.d_ff
    calls = [c for c in _calls(cfg) if c[0] != "table"]
    if cfg.ffn_act != "silu":
        calls += [(k, "cols", d, f, _pick_group(d, 128, 16))
                  for k in ("w_gate", "w_up")]
    if cfg.tie_embeddings:
        return calls + [("table", "table", d, cfg.vocab,
                         _pick_group(d, 128, 16))]
    return calls + [("head", "cols", d, cfg.vocab, _pick_group(d, 128, 16))]


@pytest.mark.parametrize("arch_id,bits", [
    ("gemma3-4b", 4), ("gemma3-4b", 8), ("gemma2-27b", 4),
    ("gemma2-27b", 8), ("phi3-medium-14b", 4), ("phi3-medium-14b", 8)])
@pytest.mark.parametrize("m", M_SENT + (256,))
def test_plan_takes_every_call_of_the_window_families_and_phi3(arch_id,
                                                                bits, m):
    """At full width: a shared-memory size the card holds for every call
    (gemma2-27b's w_down, K = 36864, takes 16 splits where one wave
    would give it 1, and 32 at INT8 once M > 4), splits covering K
    once; gemma2-27b's INT8 table (4608 B rows) in tiles of 32 rows, as
    the wrapper plans it (`table_rows`, with the exact group)."""
    cfg = get_config(arch_id)
    for name, layout, k, n, group in _family_calls(cfg):
        stored = k // 2 if bits == 4 else k
        plan = cg.split_plan(layout, m, stored, n, bits, 132)
        if layout == "table":
            plan = cg.table_rows(plan, k, n, bits, group, 132)
            assert plan.blocks == min(132, -(-n // plan.rows))
        smem = cg.smem_bytes(layout, plan, m, k, bits, group)
        assert smem <= cg.SMEM_MAX, (name, m, plan, smem)
        if layout == "cols":
            assert plan.splits <= cg.MAX_SPLITS
            assert plan.splits & (plan.splits - 1) == 0
            assert (plan.splits - 1) * plan.rows < stored \
                <= plan.splits * plan.rows
    if arch_id == "gemma2-27b" and bits == 4 and m >= 4:
        assert cg.split_plan("cols", m, 18432, 4608, 4, 132).splits == 16
    if arch_id == "gemma2-27b" and bits == 8:
        assert cg.split_plan("cols", m, 36864, 4608, 8, 132).splits == (
            32 if m > 4 else 16)
        assert cg.table_rows(cg.split_plan("table", m, 4608, 256000, 8,
                                           132), 4608, 256000, 8, 96).rows \
            == 32


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("c", (1, 4, 8, 20, 64))
def test_stack_plan_takes_qwen3_moe_calls(bits, c):
    """qwen3-moe's expert stacks at capacity C (8 in a decode step and in
    a 64-token prefill chunk): gate/up 4096 -> 1536 (groups of 128),
    down 1536 -> 4096 (groups of 96).  A block fits shared memory, K is
    covered once, the experts alone fill the wave (no split for it), and
    when K is split the (expert, tile) arrival counters fit."""
    cfg = get_config("qwen3-moe-235b-a22b")
    E, fe, d = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.d_model
    for k, n in ((d, fe), (fe, d)):
        group = _pick_group(k, 128, 16)
        assert group == (128 if k == d else 96)
        stored = k // 2 if bits == 4 else k
        plan = cg.stack_plan(c, stored, n, bits, E, 132)
        assert plan.mt == min(4, c)
        assert cg.smem_bytes("cols", plan, c, k, bits, group) <= cg.SMEM_MAX
        assert plan.splits <= cg.MAX_SPLITS
        assert (plan.splits - 1) * plan.rows < stored \
            <= plan.splits * plan.rows
        assert plan.splits == 1 or cg._slice_fits(
            plan.rows * 2, c, plan.mt, bits) is False
        if plan.splits > 1:
            assert E * -(-n // cg.TN) <= cg.MAX_TILES
        rows = [p for sp in range(plan.splits)
                for b, e in cg.lane_rows(plan, sp, stored)
                for p in range(b, e)]
        assert rows == list(range(stored))
    assert cg.stack_plan(8, 2048, 1536, 4, E, 132).splits == 2

def test_cols_constants_mirror_the_source():
    """The host's mirrors equal the constants of csrc/cim_gemv.cu."""
    import re

    from repro_torch.kernels import _build
    src = (_build.CSRC / "cim_gemv.cu").read_text()
    const = dict(re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M))
    assert (int(const["MAX_SPLITS"]), int(const["THREADS"]) // 8) == \
        (cg.MAX_SPLITS, cg.LANES)
    # the table's least tile (a warp's rows) and its largest, 8 warps of it
    assert int(const["TBL_R"]) == cg.TBL_R
    assert cg.TBL_R * int(const["TBL_THREADS"]) // 32 == cg.TBL_VB


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", M_SENT + (256,))
def test_plan_takes_every_call_of_deepseek(bits, m):
    """deepseek-v2-lite-16b at full width: MLA's wq (2048 -> 3072),
    w_dkv (2048 -> 576: nine 64-column tiles) and wo, layer 0's w_down
    (10944 -> 2048, groups of 114), the shared experts (2048 -> 2816,
    2816 -> 2048 in groups of 88) and the untied head (2048 -> 102400):
    a shared-memory size the card holds, K covered once; and the expert
    stacks (64 experts, capacity 8 at decode, in a 64-row chunk and in
    a verify window of 20 rows; down in groups of 88)."""
    cfg = get_config("deepseek-v2-lite-16b")
    d, mla, moe = cfg.d_model, cfg.mla, cfg.moe
    H = cfg.n_heads
    fs = moe.d_ff_expert * moe.n_shared_experts
    calls = [("wq", d, H * (mla.qk_nope_head_dim + mla.qk_rope_head_dim)),
             ("w_dkv", d, mla.kv_lora_rank + mla.qk_rope_head_dim),
             ("wo", H * mla.v_head_dim, d),
             ("w_down", moe.first_dense_d_ff, d), ("ws_gate", d, fs),
             ("ws_down", fs, d), ("head", d, cfg.vocab)]
    for name, k, n in calls:
        group = _pick_group(k, 128, 16)
        stored = k // 2 if bits == 4 else k
        plan = cg.split_plan("cols", m, stored, n, bits, 132)
        smem = cg.smem_bytes("cols", plan, m, k, bits, group)
        assert smem <= cg.SMEM_MAX, (name, m, plan, smem)
        assert plan.splits <= cg.MAX_SPLITS
        assert (plan.splits - 1) * plan.rows < stored \
            <= plan.splits * plan.rows
        assert plan.blocks == -(-n // cg.TN) * plan.splits
        rows = [p for sp in range(plan.splits)
                for b, e in cg.lane_rows(plan, sp, stored)
                for p in range(b, e)]
        assert rows == list(range(stored)), name
    assert _pick_group(moe.first_dense_d_ff, 128, 16) == 114
    assert -(-(mla.kv_lora_rank + mla.qk_rope_head_dim) // cg.TN) == 9
    E, fe = moe.n_experts, moe.d_ff_expert
    c = min(m, 8)
    for k, n in ((d, fe), (fe, d)):
        group = _pick_group(k, 128, 16)
        assert group == (128 if k == d else 88)
        stored = k // 2 if bits == 4 else k
        plan = cg.stack_plan(c, stored, n, bits, E, 132)
        assert cg.smem_bytes("cols", plan, c, k, bits, group) <= cg.SMEM_MAX
        assert (plan.splits - 1) * plan.rows < stored \
            <= plan.splits * plan.rows
        if plan.splits > 1:
            assert E * -(-n // cg.TN) <= cg.MAX_TILES


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,n,group,n_sms", [
    (4, 10944 // 8, 64, 114, 132),  # deepseek's w_down group of 114
    (20, 1408, 64, 88, 132),        # its experts' down, groups of 88
])
def test_split_order_matches_oracle_deepseek_groups(bits, m, k, n, group,
                                                    n_sms):
    test_split_order_matches_oracle_any_group(bits, m, k, n, group, n_sms)


# ----------------------------------------------------------------------------
# the recurrent families: xlstm-1.3b and zamba2-7b
# ----------------------------------------------------------------------------
def _recurrent_calls(arch_id):
    """(name, K, N, group) of every (K/2, N) cim_gemv call of xlstm-1.3b
    or zamba2-7b at full width, with the groups `_pick_group` gives."""
    cfg = get_config(arch_id)
    d = cfg.d_model
    if cfg.family == "xlstm":
        di = int(cfg.ssm.proj_factor_mlstm * d)
        f_up = int(cfg.ssm.proj_factor_slstm * d)
        calls = [("up_proj", d, 2 * di), ("w_o", di, di),
                 ("down_proj", di, d), ("ffn_up", d, 2 * f_up),
                 ("ffn_down", f_up, d), ("head", d, cfg.vocab)]
    else:
        di = cfg.ssm.expand * d
        ds, nh = cfg.ssm.d_state, di // cfg.ssm.head_dim
        qkv = cfg.n_heads * cfg.hd()
        calls = [("in_proj", d, 2 * di + 2 * ds + nh), ("out_proj", di, d),
                 ("wq", d, qkv), ("wo", qkv, d), ("lora_out_proj", d, d),
                 ("w_down", cfg.zamba.shared_d_ff, d),
                 ("head", d, cfg.vocab)]
    return [(n, k, nn, _pick_group(k, 128, 16)) for n, k, nn in calls]


@pytest.mark.parametrize("arch_id", ["xlstm-1.3b", "zamba2-7b"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", M_SENT + (256,))
def test_plan_takes_every_call_of_the_recurrent_families(arch_id, bits, m):
    """At full width, every call fits the card's shared memory and its
    splits cover K once: xlstm's up_proj (2048 -> 8192), w_o (4096^2),
    down_proj, ffn_up (2048 -> 5460), ffn_down (2730 -> 2048 in odd
    groups of 105) and head (2048 -> 50304); zamba's in_proj (3584 ->
    14576), out_proj (7168 -> 3584), q/k/v/o and the LoRA out_proj
    (3584^2), w_down (14336 -> 3584) and head (3584 -> 32000), groups of
    112 on K = 3584 and 7168.  And the mLSTM's head-wise q/k/v as an
    expert stack: 4 heads of 1024 -> 1024 in groups of 64, capacity m."""
    calls = _recurrent_calls(arch_id)
    groups = {n: g for n, _, _, g in calls}
    if arch_id == "xlstm-1.3b":
        assert groups["ffn_down"] == 105 and groups["up_proj"] == 128
    else:
        assert groups["in_proj"] == groups["out_proj"] == 112
        assert groups["w_down"] == 128
    for name, k, n, group in calls:
        assert n % 4 == 0, name
        stored = k // 2 if bits == 4 else k
        plan = cg.split_plan("cols", m, stored, n, bits, 132)
        assert cg.smem_bytes("cols", plan, m, k, bits, group) <= \
            cg.SMEM_MAX, (name, m, plan)
        rows = [p for sp in range(plan.splits)
                for b, e in cg.lane_rows(plan, sp, stored)
                for p in range(b, e)]
        assert rows == list(range(stored)), name
    if arch_id == "xlstm-1.3b":
        assert _pick_group(1024, 128, 16) == 64
        stored = 512 if bits == 4 else 1024
        plan = cg.stack_plan(m, stored, 1024, bits, 4, 132)
        assert plan.mt == cg.m_tile(m)
        assert cg.smem_bytes("cols", plan, m, 1024, bits, 64) <= \
            cg.SMEM_MAX
        assert (plan.splits - 1) * plan.rows < stored \
            <= plan.splits * plan.rows
        if plan.splits > 1:
            assert 4 * -(-1024 // cg.TN) <= cg.MAX_TILES


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,n,group,n_sms", [
    (4, 2730, 64, 105, 132),   # xlstm's ffn_down: odd groups of 105
    (1, 3584, 64, 112, 132),   # zamba's K = 3584 in groups of 112
    (4, 1024, 64, 64, 132),    # the mLSTM's head-wise q/k/v
])
def test_split_order_matches_oracle_recurrent_groups(bits, m, k, n, group,
                                                     n_sms):
    test_split_order_matches_oracle_any_group(bits, m, k, n, group, n_sms)
