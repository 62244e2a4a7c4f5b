"""Mixture-of-Experts in the PyTorch port vs the JAX package, on the CPU.

qwen3-moe-235b-a22b's config copy; the parameter tree and `convert` of
stacked `(L, E, K/2, N)` expert QTensors; the expert-stack product
(`cim_gemv` with counts, its plain version here) against JAX's
`ref_qmatmul_fused` with a lead dim; the router's top-k on tied
probabilities; the kept and dropped slots of both JAX dispatches
(`_moe_gather`, `_moe_onehot`) and the grouped capacity of
`_moe_onehot_grouped` at T = 1024; `moe_ffn` with and without shared
experts; teacher-forced `serve_step` / `paged_verify_step` logits (a
leading dense layer in a variant, and a prefill chunk whose padding rows
crowd an expert past its capacity); greedy and n-gram engine streams
and the cost model's `sim_*` keys against JAX's `PagedServeEngine`; the
launcher.

Same weights in both packages (drawn by JAX, carried across with
`repro_torch.convert`), same numpy inputs.  Tolerances:
  * the stack product and the FFN, f32: 1e-5 relative to the largest
    |value| (sums in another order); 1e-2 against JAX's grouped
    dispatch with packed stacks, which rounds the dequantized weights to
    bf16 (`test_grouped_capacity_at_1024_tokens`);
  * step logits: `KV_TOL` of tests/test_torch_model.py (reasons in its
    docstring), bf16 KV scaled by the step's largest |logit| as in
    tests/test_torch_families.py.  A row past it is allowed only at a
    router near-tie: some layer's k-th and (k+1)-th probabilities of
    that row within ROUTER_TIE (recorded from the port's router), which
    an ulp of the KV pools can flip; it is printed as a near-tie.
"""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.kernels.ref import ref_qmatmul_fused as jax_ref_qmatmul_fused
from repro.models import DecoderLM as JaxLM
from repro.models import ModelConfig as JaxConfig
from repro.models import MoEConfig as JaxMoE
from repro.models import init_params as jax_init
from repro.models import ffn as jffn
from repro.models.common import spec_structs
from repro.quant import qarray as jax_qarray
from repro.quant.ptq import quantize_params as jax_quantize_params
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxRequest
from repro.spec import SpecConfig as JaxSpecConfig

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.cim_gemv import cim_gemv
from repro_torch.models import DecoderLM, ModelConfig, MoEConfig
from repro_torch.models import ffn as tffn
from repro_torch.quant.qarray import QTensor
from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest
from repro_torch.spec import SpecConfig

from test_torch_model import KV_TOL, _KV, _to_numpy

ARCH = "qwen3-moe-235b-a22b"
ROUTER_TIE = 1e-4
FFN_TOL = 1e-5
GROUPED_BF16_TOL = 1e-2     # bf16 weights: 2^-9 relative each; measured
                            # 2.6e-3 (int4, test_grouped_capacity_...)


def _smoke(**moe_kw):
    """JAX's qwen3-moe smoke config as a keyword dict, `moe` as a dict of
    MoEConfig fields (so each package builds its own)."""
    cfg = jax_get_smoke_config(ARCH)
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["moe"] = dict(dataclasses.asdict(cfg.moe), **moe_kw)
    return d


SMOKE = _smoke()
# a shared expert and one leading dense layer (deepseek's layout), which
# the JAX package builds for any MoE config
VARIANT = dict(_smoke(n_shared_experts=1, first_dense_layers=1,
                      first_dense_d_ff=128),
               name="qwen3-moe-shared-first", n_layers=3)
# the full config's onehot dispatch, and a capacity the padding rows of a
# prefill chunk overrun (cap = max(8, ceil(32 * 2 / 8)) = 8 at b * s = 32)
CROWD = dict(_smoke(dispatch="onehot", capacity_factor=1.0),
             name="qwen3-moe-crowd")
_PAIRS = {}


def _pair(arch, precision):
    """(jax model, jax params, port model, port params), built once;
    precision fp, int4 or int8 (groups of 128, as the engine packs)."""
    key = (arch["name"], precision)
    if key not in _PAIRS:
        kw = dict(arch, dtype="float32", remat=False)
        moe = kw.pop("moe")
        jm = JaxLM(JaxConfig(**kw, moe=JaxMoE(**moe)))
        jp = jax_init(jm.param_specs(), jax.random.PRNGKey(0),
                      dtype_override=jnp.float32)
        if precision != "fp":
            jp = jax_quantize_params(jp, bits=int(precision[3:]), group=128)
        tm = DecoderLM(ModelConfig(**kw, moe=MoEConfig(**moe)))
        _PAIRS[key] = (jm, jp, tm, from_numpy_tree(_to_numpy(jp)))
    return _PAIRS[key]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


# ----------------------------------------------------------------------------
# configs, parameter trees, convert
# ----------------------------------------------------------------------------
def test_config_copies_equal_jax_field_for_field():
    for mine, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        assert {f.name for f in dataclasses.fields(mine)} == \
            {f.name for f in dataclasses.fields(ref)}
        for f in dataclasses.fields(ref):
            if f.name != "moe":
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert isinstance(mine.moe, MoEConfig)
        assert dataclasses.asdict(mine.moe) == dataclasses.asdict(ref.moe)
    assert {f.name for f in dataclasses.fields(MoEConfig)} == \
        {f.name for f in dataclasses.fields(JaxMoE)}
    assert dataclasses.asdict(MoEConfig()) == dataclasses.asdict(JaxMoE())
    assert get_config(ARCH).moe.dispatch == "onehot"


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", ["full", "smoke", "variant"])
def test_param_tree_matches_jax(arch):
    """The same tree and shapes: router (d, E), we_* (L, E, d, fe) /
    (L, E, fe, d), ws_* when shared experts exist, `first_blocks` with
    a dense FFN of first_dense_d_ff for the leading dense layers."""
    if arch == "variant":
        kw = dict(VARIANT, dtype="float32")
        moe = kw.pop("moe")
        jm = JaxLM(JaxConfig(**kw, moe=JaxMoE(**moe)))
        tm = DecoderLM(ModelConfig(**kw, moe=MoEConfig(**moe)))
    else:
        get = {"full": (jax_get_config, get_config),
               "smoke": (jax_get_smoke_config, get_smoke_config)}[arch]
        jm, tm = JaxLM(get[0](ARCH)), DecoderLM(get[1](ARCH))
    assert _shapes(tm.param_specs()) == _shapes(jm.param_specs())
    ffn = tm.param_specs()["blocks"]["ffn"]
    L = tm.cfg.n_layers - tm.n_first
    m = tm.cfg.moe
    assert ffn["we_down"].shape == (L, m.n_experts, m.d_ff_expert,
                                    tm.cfg.d_model)
    if arch == "variant":
        assert set(ffn) >= {"ws_gate", "ws_up", "ws_down"}
        first = tm.param_specs()["first_blocks"]["ffn"]
        assert first["w_gate"].shape == (1, tm.cfg.d_model, 128)
        pools = tm.paged_cache_specs(8, 4, torch.int8)
        assert pools["attn_first"]["k"].shape[0] == 1
        assert pools["attn"]["k"].shape[0] == 2


@pytest.mark.parametrize("precision", ["int4", "int8"])
def test_convert_carries_stacked_expert_qtensors_byte_for_byte(precision):
    jm, jp, tm, tp = _pair(VARIANT, precision)
    bits = int(precision[3:])
    for name in ("we_gate", "we_up", "we_down", "ws_gate"):
        j, t = jp["blocks"]["ffn"][name], tp["blocks"]["ffn"][name]
        assert isinstance(t, QTensor) and t.bits == j.bits == bits
        assert (t.group, t.axis, t.orig_shape) == (j.group, j.axis,
                                                   j.orig_shape)
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.scales.numpy(),
                                      np.asarray(j.scales))
        assert t.data.dtype == (torch.uint8 if bits == 4 else torch.int8)
    we = tp["blocks"]["ffn"]["we_gate"]
    L, E, d, fe = we.orig_shape
    assert tuple(we.data.shape) == (L, E, d // (2 if bits == 4 else 1), fe)
    assert we.axis == -2
    assert tp["blocks"]["ffn"]["router"].dtype == torch.float32


# ----------------------------------------------------------------------------
# the expert-stack product
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("E,C,K,N,group", [(8, 8, 128, 96, 128),
                                           (4, 3, 192, 64, 96),
                                           (16, 5, 96, 40, 32)])
def test_stack_plain_matches_jax_lead_dim(bits, E, C, K, N, group):
    """cim_gemv with counts (plain version on the CPU: every row) equals
    JAX's ref_qmatmul_fused over the stack's lead dim, groups of 96 too
    (qwen3-moe's we_down)."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((E, K, N)) * 0.1).astype(np.float32)
    x = rng.standard_normal((E, C, K)).astype(np.float32)
    jq = jax_qarray.quantize(jnp.asarray(w), bits=bits, group=group, axis=1)
    ref = np.asarray(jax_ref_qmatmul_fused(jnp.asarray(x), jq,
                                           out_dtype=jnp.float32))
    tq = from_numpy_tree(_to_numpy(jq))
    counts = torch.from_numpy(rng.integers(0, C + 1, E).astype(np.int32))
    got = cim_gemv(torch.from_numpy(x), tq, counts)
    assert got.shape == (E, C, N) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < FFN_TOL


# ----------------------------------------------------------------------------
# router and dispatch
# ----------------------------------------------------------------------------
def _moe_cfgs(moe, d=16):
    kw = dict(name="moe-unit", family="moe", n_layers=1, d_model=d,
              n_heads=2, n_kv_heads=1, d_ff=32, vocab=32, head_dim=8,
              dtype="float32")
    return (JaxConfig(**kw, moe=JaxMoE(**moe)),
            ModelConfig(**kw, moe=MoEConfig(**moe)))


def _full_moe(**kw):
    return dict(dataclasses.asdict(jax_get_config(ARCH).moe), **kw)


@pytest.mark.parametrize("router", ["zero", "two-way ties", "random"])
def test_router_ids_equal_lax_top_k_on_ties(router):
    """128 experts, top 8: with zero router weights every probability
    ties and lax.top_k picks experts 0..7 (torch.topk would not); with
    duplicated router columns ties come in pairs."""
    jcfg, tcfg = _moe_cfgs(_full_moe())
    d, E = 16, 128
    rng = np.random.default_rng(2)
    r = (rng.standard_normal((d, E)) * 0.3).astype(np.float32)
    if router == "zero":
        r[:] = 0.0
    elif router == "two-way ties":
        r[:, 1::2] = r[:, 0::2]
    x = rng.standard_normal((7, d)).astype(np.float32)
    jw, jids = jffn._router({"router": jnp.asarray(r)}, jcfg, jnp.asarray(x))
    tw, tids = tffn._router({"router": torch.from_numpy(r)}, tcfg,
                            torch.from_numpy(x))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    if router == "zero":
        assert tids.tolist() == [list(range(8))] * 7


def _jax_keep(ids, E, cap, groups):
    """JAX's kept slots (the onehot dispatches' rule, which the gather
    dispatch matches): each slot's rank among the earlier slots of its
    expert, in flattened (token, k) order, within its group."""
    T, k = ids.shape
    oh = jax.nn.one_hot(jnp.asarray(ids).reshape(groups, T // groups * k),
                        E, dtype=jnp.float32)
    pos = jnp.cumsum(oh, axis=1) - oh
    rank = np.asarray(jnp.sum(pos * oh, axis=-1)).reshape(T * k)
    return rank < cap


def _unit_params(precision, E=8, d=16, fe=24, seed=0):
    """One MoE layer's params drawn by JAX (router, stacks), packed as
    the engine packs them, in both packages."""
    jcfg, _ = _moe_cfgs(dict(n_experts=E, top_k=2, n_shared_experts=1,
                             d_ff_expert=fe), d)
    specs = jffn.moe_specs(jcfg)
    jp = jax_init(specs, jax.random.PRNGKey(seed), dtype_override=jnp.float32)
    if precision != "fp":
        jp = jax_quantize_params(jp, bits=int(precision[3:]), group=128)
    return jp, from_numpy_tree(_to_numpy(jp))


@pytest.mark.parametrize("precision", ["fp", "int4"])
@pytest.mark.parametrize("dispatch", ["gather", "onehot"])
def test_kept_slots_and_drops_match_both_jax_dispatches(precision, dispatch):
    """capacity_factor 0.5 over 64 tokens x top 2 of 8 experts: cap 8
    against ~16 slots an expert, so about half drop.  The port keeps
    exactly JAX's slots, and its output equals the JAX dispatch's."""
    moe = dict(n_experts=8, top_k=2, n_shared_experts=0, d_ff_expert=24,
               capacity_factor=0.5, dispatch=dispatch)
    jcfg, tcfg = _moe_cfgs(moe)
    jp, tp = _unit_params(precision)
    x = np.random.default_rng(3).standard_normal((4, 16, 16)).astype(
        np.float32)
    T = 64
    groups, cap = tffn.capacity(tcfg, T)
    assert (groups, cap) == (1, 8)
    _, jids = jffn._router(jp, jcfg, jnp.asarray(x.reshape(T, 16)))
    _, tids = tffn._router(tp, tcfg, torch.from_numpy(x.reshape(T, 16)))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    slot, counts = tffn.dispatch_slots(tids, 8, cap, groups)
    keep = (slot < 8 * cap).numpy()
    np.testing.assert_array_equal(keep, _jax_keep(np.asarray(jids), 8, cap,
                                                  1))
    assert 0 < (~keep).sum() < keep.size       # some slots drop
    assert counts.tolist() == np.minimum(
        np.bincount(np.asarray(jids).ravel(), minlength=8), cap).tolist()
    jfn = jffn._moe_gather if dispatch == "gather" else jffn._moe_onehot
    ref = np.asarray(jfn(jp, jcfg, jnp.asarray(x)))
    got = tffn.moe_routed(tp, tcfg, torch.from_numpy(x)).numpy()
    assert _rel(got, ref) < FFN_TOL


@pytest.mark.parametrize("precision", ["fp", "int4"])
def test_grouped_capacity_at_1024_tokens(precision, monkeypatch):
    """The onehot dispatch at T = 1024 (64 lanes x 16, a full batch's
    prefill chunk) ranks slots within groups of 512 tokens, with a
    capacity per group: it keeps other slots than one capacity over all
    1024 tokens (the gather dispatch's), and the port follows each.

    JAX's grouped dispatch contracts its stacks dequantized to bf16
    (`maybe_dequantize`'s default), where every other route, the port's
    included, keeps integer groups scaled in f32: packed weights there
    are held within GROUPED_BF16_TOL, and within FFN_TOL of the same
    JAX function with the stacks dequantized to f32."""
    out = {}
    for dispatch in ("onehot", "gather"):
        moe = dict(n_experts=8, top_k=2, n_shared_experts=0, d_ff_expert=24,
                   capacity_factor=0.5, dispatch=dispatch)
        jcfg, tcfg = _moe_cfgs(moe)
        jp, tp = _unit_params(precision)
        x = np.random.default_rng(4).standard_normal((64, 16, 16)).astype(
            np.float32)
        groups, cap = tffn.capacity(tcfg, 1024)
        assert (groups, cap) == ((2, 64) if dispatch == "onehot"
                                 else (1, 128))
        _, tids = tffn._router(tp, tcfg, torch.from_numpy(x.reshape(-1, 16)))
        slot, counts = tffn.dispatch_slots(tids, 8, cap, groups)
        keep = (slot < 8 * groups * cap).numpy()
        np.testing.assert_array_equal(keep, _jax_keep(tids.numpy(), 8, cap,
                                                      groups))
        assert int(counts.sum()) == int(keep.sum()) < keep.size
        jfn = jffn._moe_onehot if dispatch == "onehot" else jffn._moe_gather
        ref = np.asarray(jfn(jp, jcfg, jnp.asarray(x)))
        got = tffn.moe_routed(tp, tcfg, torch.from_numpy(x)).numpy()
        if dispatch == "onehot" and precision != "fp":
            assert _rel(got, ref) < GROUPED_BF16_TOL
            with monkeypatch.context() as mp:
                mp.setattr(jffn, "deq", lambda w: jax_qarray.maybe_dequantize(
                    w, jnp.float32))
                ref = np.asarray(jfn(jp, jcfg, jnp.asarray(x)))
        assert _rel(got, ref) < FFN_TOL
        out[dispatch] = (keep, got)
    assert not np.array_equal(out["onehot"][0], out["gather"][0])


@pytest.mark.parametrize("precision", ["fp", "int4", "int8"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("dispatch", ["gather", "onehot"])
def test_moe_ffn_matches_jax(precision, shared, dispatch):
    """`moe_ffn` of one layer of the smoke model's stacks (d 64, 8
    experts of 96, top 2), with a shared expert in a variant."""
    arch = dict(_smoke(n_shared_experts=shared, dispatch=dispatch),
                name=f"ffn-{shared}-{dispatch}")
    jm, jp, tm, tp = _pair(arch, precision)
    x = np.random.default_rng(0).standard_normal((3, 5, 64)).astype(
        np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["ffn"])
    lp_t = {k: v[0] for k, v in tp["blocks"]["ffn"].items()}
    assert ("ws_down" in lp_t) == bool(shared)
    if precision != "fp":
        assert lp_t["we_down"].data.ndim == 3
    ref = np.asarray(jffn.moe_ffn(lp_j, jm.cfg, jnp.asarray(x)))
    got = tffn.moe_ffn(lp_t, tm.cfg, torch.from_numpy(x)).numpy()
    assert _rel(got, ref) < FFN_TOL


# ----------------------------------------------------------------------------
# model steps under teacher forcing
# ----------------------------------------------------------------------------
def _pools(jm, tm, n_pages, ps, kv):
    jdt, tdt = _KV[kv]
    jcache = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        spec_structs(jm.paged_cache_specs(n_pages, ps, jdt)))
    tcache = {name: {k: torch.zeros(v.shape, dtype=v.dtype)
                     for k, v in pools.items()}
              for name, pools in tm.paged_cache_specs(n_pages, ps,
                                                      tdt).items()}
    return jcache, tcache


class _RouterLog:
    """Records the port's router probabilities and dispatches per call."""

    def __init__(self, monkeypatch):
        self.gaps, self.dropped = [], []
        router, dispatch = tffn._router, tffn.dispatch_slots

        def spy_router(p, cfg, xf):
            w, ids = router(p, cfg, xf)
            probs = torch.softmax(xf.float() @ p["router"].float(), -1)
            top = probs.sort(dim=-1, descending=True).values
            k = cfg.moe.top_k
            self.gaps.append(top[:, k - 1] - top[:, k])
            return w, ids

        def spy_dispatch(ids, n_experts, cap, groups=1):
            slot, counts = dispatch(ids, n_experts, cap, groups)
            self.dropped.append(int((slot == n_experts * groups * cap)
                                    .sum()))
            return slot, counts
        monkeypatch.setattr(tffn, "_router", spy_router)
        monkeypatch.setattr(tffn, "dispatch_slots", spy_dispatch)

    def near_tie(self, b, s, lane, row):
        """Whether any layer of the last step routed (lane, row) at a
        top-k boundary gap under ROUTER_TIE."""
        return any(float(g.reshape(b, s)[lane, row]) < ROUTER_TIE
                   for g in self.gaps)


def _run_plan(arch, precision, kv, plan, monkeypatch):
    """Run `plan` [(verify, s, n_new per lane)] through both packages on
    shuffled tables; each real row's logits must agree (or sit at a
    logged router near-tie).  Returns the port's dropped slots per
    step."""
    jm, jp, tm, tp = _pair(arch, precision)
    ps, max_pages, b = 4, 12, 2
    n_pages = b * max_pages
    jcache, tcache = _pools(jm, tm, n_pages, ps, kv)
    rng = np.random.default_rng(0)
    tables = rng.permutation(n_pages).reshape(b, max_pages).astype(np.int32)
    jsteps = {False: jax.jit(jm.serve_step),
              True: jax.jit(jm.paged_verify_step)}
    log = _RouterLog(monkeypatch)
    lengths = np.zeros(b, np.int32)
    drops, ties = [], 0
    for verify, s, n_new in plan:
        n_new = np.asarray(n_new, np.int32)
        tokens = rng.integers(0, arch["vocab"], (b, s)).astype(np.int32)
        jlog, jcache = jsteps[verify](
            jp, jcache, {"tokens": jnp.asarray(tokens)}, jnp.asarray(tables),
            jnp.asarray(lengths), jnp.asarray(n_new))
        log.gaps, log.dropped = [], []
        step = tm.paged_verify_step if verify else tm.serve_step
        tlog, tcache = step(tp, tcache, {"tokens": torch.from_numpy(tokens)},
                            torch.from_numpy(tables),
                            torch.from_numpy(lengths),
                            torch.from_numpy(n_new))
        jlog = np.asarray(jlog)
        tol = KV_TOL[kv] * (max(1.0, float(np.abs(jlog).max()))
                            if kv == "bf16" else 1.0)
        for i in range(b):
            for j in range(int(n_new[i])):
                err = float(np.abs(tlog[i, j].numpy() - jlog[i, j]).max())
                if err <= tol:
                    continue
                assert log.near_tie(b, s, i, j), (verify, s, i, j, err, tol)
                ties += 1
                print(f"near-tie: step s={s} lane {i} row {j}: logits "
                      f"differ by {err:.3e} (tol {tol:.3e}), a router "
                      f"gap under {ROUTER_TIE}")
        drops.append(sum(log.dropped))
        lengths = lengths + n_new
    assert ties <= 2, ties
    return drops


# two prefill chunks (lane 1 idles in the second), then decode steps
DECODE_PLAN = [(False, 8, [8, 5]), (False, 8, [4, 0])] + \
    [(False, 1, [1, 1])] * 4 + [(False, 1, [1, 0])]
# a prefill, then verify windows of width 5 with ragged real rows
VERIFY_PLAN = [(False, 8, [8, 6]), (True, 5, [5, 3]), (True, 5, [2, 5]),
               (True, 5, [5, 0])]
# lane 1 brings one token to a 16-row chunk: its 15 padding rows route
# alike and overrun an expert's capacity of 8 (as in the JAX engine)
CROWD_PLAN = [(False, 16, [16, 1]), (False, 16, [9, 4]),
              (False, 1, [1, 1]), (False, 1, [1, 1])]

STEP_CASES = ([(SMOKE, p, kv) for p, kv in (
    ("fp", "f32"), ("fp", "bf16"), ("fp", "int8"), ("int4", "f32"),
    ("int4", "bf16"), ("int4", "int8"))]
    + [(VARIANT, "fp", "f32"), (VARIANT, "int4", "int8")])


def _ids(cases):
    return [f"{c[0]['name']}-{c[1]}-{c[2]}" for c in cases]


@pytest.mark.parametrize("arch,precision,kv", STEP_CASES,
                         ids=_ids(STEP_CASES))
def test_serve_step_logits_match_jax(arch, precision, kv, monkeypatch):
    _run_plan(arch, precision, kv, DECODE_PLAN, monkeypatch)


VERIFY_CASES = [(SMOKE, "fp", "f32"), (SMOKE, "int4", "int8"),
                (VARIANT, "int4", "int8")]


@pytest.mark.parametrize("arch,precision,kv", VERIFY_CASES,
                         ids=_ids(VERIFY_CASES))
def test_paged_verify_step_logits_match_jax(arch, precision, kv,
                                            monkeypatch):
    _run_plan(arch, precision, kv, VERIFY_PLAN, monkeypatch)


@pytest.mark.parametrize("precision,kv", [("fp", "f32"), ("int4", "int8")])
def test_padding_rows_crowding_an_expert_drop_as_in_jax(precision, kv,
                                                        monkeypatch):
    drops = _run_plan(CROWD, precision, kv, CROWD_PLAN, monkeypatch)
    assert drops[0] > 0, drops                 # the padding rows overran


# ----------------------------------------------------------------------------
# engines and the launcher
# ----------------------------------------------------------------------------
def _workload(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in (3, 9, 17, 6, 12)]


ENGINE_CASES = [(a, p, kv) for a in (SMOKE, CROWD)
                for p, kv in (("fp", "bf16"), ("int4", "int8"))]


@pytest.mark.parametrize("arch,precision,kv", ENGINE_CASES,
                         ids=_ids(ENGINE_CASES))
def test_engine_greedy_streams_and_sim_keys_match_jax(arch, precision, kv):
    jm, jp, tm, tp = _pair(arch, precision)
    prompts = _workload(arch["vocab"])
    geom = dict(precision=precision, kv_dtype=kv, max_batch=2, max_seq=48,
                page_size=4, prefill_chunk=8)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=8, rid=i)
             for i, p in enumerate(prompts)]
    jeng = JaxEngine(jm, jp, JaxServeConfig(**geom))
    jeng.run(jreqs)
    treqs = [ServeRequest(prompt=p, max_new_tokens=8, rid=i)
             for i, p in enumerate(prompts)]
    eng = PagedServeEngine(tm, tp, ServeConfig(**geom), device="cpu")
    reset_launch_counts()
    eng.run(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == 8 for r in treqs)
    assert eng.cache.n_free_or_cached() == eng.cache.allocator.n_pages
    assert set(launch_counts().values()) == {0}
    js, ts = jeng.summary(), eng.summary()
    sim = sorted(k for k in js if k.startswith("sim_"))
    assert sim and sim == sorted(k for k in ts if k.startswith("sim_"))
    for k in sim:
        assert math.isclose(ts[k], js[k], rel_tol=1e-12, abs_tol=0.0), k


SPEC_PROMPTS = [np.array([1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3], np.int32),
                np.array([7, 9, 11], np.int32),
                np.arange(10, 30, dtype=np.int32) % 64]


@pytest.mark.parametrize("arch", [SMOKE, VARIANT], ids=lambda a: a["name"])
def test_ngram_spec_streams_match_plain_and_jax(arch):
    jm, jp, tm, tp = _pair(arch, "int4")
    serve_kw = dict(max_batch=2, max_seq=64, page_size=8, prefill_chunk=8,
                    precision="int4", kv_dtype="int8")
    outs = []
    for spec in (None, SpecConfig(k=4)):
        eng = PagedServeEngine(tm, tp, ServeConfig(**serve_kw), spec=spec,
                               device="cpu")
        reqs = [ServeRequest(prompt=p.copy(), max_new_tokens=12, rid=i)
                for i, p in enumerate(SPEC_PROMPTS)]
        eng.run(reqs)
        outs.append([r.out_tokens for r in reqs])
    assert eng.verify_calls > 0 and eng.summary()["spec_drafted"] > 0
    jreqs = [JaxRequest(prompt=p.copy(), max_new_tokens=12, rid=i)
             for i, p in enumerate(SPEC_PROMPTS)]
    JaxEngine(jm, jp, JaxServeConfig(**serve_kw),
              spec=JaxSpecConfig(k=4, drafter="ngram")).run(jreqs)
    assert outs[1] == outs[0] == [r.out_tokens for r in jreqs]


@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_launcher_qwen3_moe_smoke_on_cpu(spec):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "3", "--tokens", "8",
         "--max-seq", "48", "--page-size", "8", "--spec", spec],
        capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stderr
    assert "qwen3-moe-smoke x2 layers" in r.stdout
    assert "24 tokens" in r.stdout
    assert ("spec[ngram k=4] acceptance" in r.stdout) == (spec == "ngram")
