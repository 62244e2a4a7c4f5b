"""The recurrent families in the PyTorch port vs the JAX package, on the
CPU: xLSTM (mLSTM + sLSTM) and pure Mamba2 (zamba with shared_every >
n_layers, so no attention layer), and the `StateArena` and engine
machinery every recurrent family shares (tests/test_torch_zamba.py holds
the hybrid).

Shapes are the JAX package's own (`tests/test_serve_state.py`): d 32,
xlstm 2 heads at slstm_every 2, Mamba2 d_state 16 and head_dim 16.  The
weights are drawn by JAX and carried across with `repro_torch.convert`;
the inputs are numpy arrays from a seed.  Covered: the config copies,
parameter trees and state specs (lane axes, promoted conv dtypes),
`convert` of the doubly stacked and 5-D packed leaves, each serve cell
(`mamba2_serve_step`, `mlstm_serve_step`, `slstm_serve_step`) over a
padded chunk of mixed n_new (0 included) and decode steps with every
state leaf, teacher-forced `serve_step` logits, greedy engine streams,
preemption from a host snapshot, the arena's lane ops and addresses,
the capability errors and the launcher, `state_bytes` and the slot
occupancy, and which packed leaves go to the kernels.

Tolerances, relative to the largest |value| of the reference (logits:
to max(1, max|logit|)):
  * STEP_TOL = 1e-5 on cell outputs, state leaves and logits with f32
    or INT4 weights: the same arithmetic in another order (the conv and
    the gates hoisted over the chunk, products of three factors
    associated differently); measured up to 1.1e-6.  For INT4, JAX is
    fed the mLSTM's q/k/v pre-dequantized to f32 as plain arrays
    (`maybe_dequantize` passes them through), since the port sends the
    packed leaves to `cim_gemv`'s stack layout with their exact values.
  * BF16_ROUTE_TOL = 2e-2 against JAX's own route with the packed
    q/k/v, which it dequantizes to bf16 in every step: the port differs
    from it only by that rounding of the weights; measured 8.9e-3 on
    logits and 5.3e-3 on the state.
"""
import dataclasses
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
from repro.launch.serve import check_capabilities as jax_check_caps
from repro.models import DecoderLM as JaxLM
from repro.models import ModelConfig as JaxConfig
from repro.models import init_params as jax_init
from repro.models import ssm as jssm
from repro.models.common import BATCH, spec_structs
from repro.models.config import SSMConfig as JaxSSM
from repro.models.config import ZambaConfig as JaxZamba
from repro.quant.ptq import quantize_params as jax_quantize_params
from repro.quant.qarray import QTensor as JaxQTensor
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxRequest
from repro.serve import StateArena as JaxArena
from repro.serve.engine import capability_error as jax_capability_error
from repro.spec import SpecConfig as JaxSpecConfig

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import launch_counts, ops
from repro_torch.launch.serve import check_capabilities
from repro_torch.models import DecoderLM, ModelConfig
from repro_torch.models import ssm as tssm
from repro_torch.models.common import map_specs
from repro_torch.models.config import SSMConfig, ZambaConfig
from repro_torch.quant import qarray
from repro_torch.quant.qarray import QTensor
from repro_torch.serve import (PagedServeEngine, ServeConfig, ServeRequest,
                               StepRunner)
from repro_torch.serve.engine import capability_error
from repro_torch.serve.state import StateArena
from repro_torch.spec import SpecConfig

from test_torch_model import _to_numpy

STEP_TOL = 1e-5
BF16_ROUTE_TOL = 2e-2
GROUP = 16
_PAIRS = {}


# ----------------------------------------------------------------------------
# the configs of tests/test_serve_state.py, in both packages
# ----------------------------------------------------------------------------
def configs(kind):
    """(jax cfg, port cfg) of `kind`: xlstm, zamba (hybrid: 4 layers,
    shared_every 2) or mamba2 (zamba with shared_every 8 > 3 layers)."""
    base = dict(d_model=32, n_heads=2, d_ff=64, vocab=64, head_dim=16,
                dtype="float32", remat=False)
    if kind == "xlstm":
        kw = dict(base, name="x", family="xlstm", n_layers=4, n_kv_heads=2)
        ssm = dict(mlstm_heads=2, slstm_every=2)
        return (JaxConfig(**kw, ssm=JaxSSM(**ssm)),
                ModelConfig(**kw, ssm=SSMConfig(**ssm)))
    every, n = (2, 4) if kind == "zamba" else (8, 3)
    kw = dict(base, name="z" if kind == "zamba" else "m", family="zamba",
              n_layers=n, n_kv_heads=1)
    ssm = dict(d_state=16, head_dim=16, expand=2)
    zam = dict(shared_every=every, lora_rank=4, shared_d_ff=64)
    return (JaxConfig(**kw, ssm=JaxSSM(**ssm), zamba=JaxZamba(**zam)),
            ModelConfig(**kw, ssm=SSMConfig(**ssm), zamba=ZambaConfig(**zam)))


# the leaves JAX dequantizes to bf16 in every step instead of a fused
# contraction: the mLSTM's head-wise q/k/v and zamba's shared q/k/v
BF16_ROUTE = {"xlstm": ("mlstm", ("wq", "wk", "wv")),
              "zamba": ("shared", ("wq", "wk", "wv"))}


def _deq_f32(jp, kind):
    """JAX params with the BF16_ROUTE leaves dequantized to f32 plain
    arrays: JAX then contracts exactly what the port's kernels do."""
    if kind not in BF16_ROUTE:
        return jp
    top, names = BF16_ROUTE[kind]
    jp = dict(jp)
    sub = dict(jp[top])
    if top == "mlstm":
        cell = dict(sub["cell"])
        for k in names:
            cell[k] = cell[k].dequantize(jnp.float32)
        sub["cell"] = cell
    else:
        attn = dict(sub["attn"])
        for k in names:
            attn[k] = attn[k].dequantize(jnp.float32)
        sub["attn"] = attn
    jp[top] = sub
    return jp


def pair(kind, precision):
    """(jax model, jax params, port model, port params), built once.
    precision: fp, int4 (JAX's own bf16 route for BF16_ROUTE leaves) or
    int4f32 (the same packed bytes, JAX fed those leaves in f32).
    zamba's lora_b are drawn nonzero (their init is zeros, which would
    hide the LoRA term)."""
    key = (kind, precision)
    if key not in _PAIRS:
        jcfg, tcfg = configs(kind)
        jm = JaxLM(jcfg)
        jp = jax_init(jm.param_specs(), jax.random.PRNGKey(
            {"xlstm": 0, "zamba": 1, "mamba2": 1}[kind]),
            dtype_override=jnp.float32)
        if "lora" in jp:
            rng = np.random.default_rng(11)
            jp["lora"] = {k: (jnp.asarray(0.2 * rng.standard_normal(
                v.shape).astype(np.float32)) if k.startswith("lora_b")
                else v) for k, v in jp["lora"].items()}
        if precision != "fp":
            jp = jax_quantize_params(jp, bits=4, group=GROUP)
        tp = from_numpy_tree(_to_numpy(jp))
        if precision == "int4f32":
            jp = _deq_f32(jp, kind)
        _PAIRS[key] = (jm, jp, DecoderLM(tcfg), tp)
    return _PAIRS[key]


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def logit_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def np_leaves(tree, prefix=""):
    """{path: float64 numpy} of a JAX or port tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(np_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().to(torch.float64).numpy()}
    return {prefix: np.asarray(tree, np.float64)}


def jax_state(jm, b, n_pages, ps, kv=jnp.float32):
    st = jm.decode_state_specs(b, n_pages, ps, kv)
    z = {}
    for half in ("paged", "arena"):
        z.update(jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), spec_structs(st[half])))
    return z


def port_state(tm, b, n_pages, ps, kv=torch.float32):
    st = tm.decode_state_specs(b, n_pages, ps, kv)
    z = {}
    for half in ("paged", "arena"):
        z.update(map_specs(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                           st[half]))
    return z


def compare_states(jstate, tstate, tol):
    """Every state leaf, the port's pools without their dump page."""
    j, t = np_leaves(jstate), np_leaves(tstate)
    assert set(j) == set(t)
    worst = {}
    for k in j:
        got = t[k][:, :-1] if k.startswith("/attn") else t[k]
        assert got.shape == j[k].shape, k
        worst[k] = rel(got, j[k])
    assert max(worst.values()) <= tol, worst
    return worst


PLAN = [(6, [6, 3, 0]), (6, [2, 6, 4]), (1, [1, 1, 1]), (1, [1, 0, 1]),
        (1, [1, 1, 1])]


def step_both(kind, precision, plan=PLAN, kv="f32", tol=STEP_TOL):
    """Teacher-forced `serve_step` of both packages over `plan` ((s,
    n_new per lane) calls: a padded chunk with a lane at 0, a second
    chunk, decode steps with an idle lane): logits of every valid row
    and, at the end, every state leaf within `tol`."""
    jm, jp, tm, tp = pair(kind, precision)
    b, n_pages, ps = 3, 12, 4
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "int8": (jnp.int8, torch.int8)}[kv]
    js, ts = jax_state(jm, b, n_pages, ps, jdt), port_state(tm, b, n_pages,
                                                           ps, tdt)
    tables = np.arange(b * 4, dtype=np.int32).reshape(b, 4)
    lengths = np.zeros(b, np.int32)
    rng = np.random.default_rng(1)
    jstep = jax.jit(jm.serve_step)
    err = 0.0
    for s, n_new in plan:
        tok = rng.integers(0, 64, (b, s)).astype(np.int32)
        n_new = np.asarray(n_new, np.int32)
        jl, js = jstep(jp, js, {"tokens": jnp.asarray(tok)},
                       jnp.asarray(tables), jnp.asarray(lengths),
                       jnp.asarray(n_new))
        tl, out = tm.serve_step(tp, ts, {"tokens": torch.from_numpy(tok)},
                                torch.from_numpy(tables),
                                torch.from_numpy(lengths),
                                torch.from_numpy(n_new))
        assert out is ts
        for i in range(b):
            if n_new[i]:
                err = max(err, logit_err(tl[i, :n_new[i]].numpy(),
                                         np.asarray(jl[i, :n_new[i]])))
        lengths = lengths + n_new
    assert err <= tol, err
    return compare_states(js, ts, tol if kv == "f32" else 1.0), err


# ----------------------------------------------------------------------------
# configs, trees, specs, convert
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-7b"])
def test_config_copies_equal_jax_field_for_field(arch):
    for mine, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_get_smoke_config(arch))):
        assert {f.name for f in dataclasses.fields(mine)} == \
            {f.name for f in dataclasses.fields(ref)}
        for f in dataclasses.fields(ref):
            if f.name not in ("ssm", "zamba"):
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert dataclasses.asdict(mine.ssm) == dataclasses.asdict(ref.ssm)
        assert (mine.zamba is None) == (ref.zamba is None)
        if ref.zamba is not None:
            assert dataclasses.asdict(mine.zamba) == \
                dataclasses.asdict(ref.zamba)
    assert dataclasses.asdict(SSMConfig()) == dataclasses.asdict(JaxSSM())
    assert dataclasses.asdict(ZambaConfig()) == \
        dataclasses.asdict(JaxZamba())


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize("which", ["xlstm", "zamba", "mamba2",
                                   "xlstm-1.3b", "zamba2-7b-27"])
def test_param_tree_and_state_specs_match_jax(which):
    """The same parameter tree, arena leaves (shape, dtype, lane axis =
    JAX's BATCH axis) and paged pools (the port's one page more)."""
    if which in ("xlstm", "zamba", "mamba2"):
        jcfg, tcfg = configs(which)
    elif which == "xlstm-1.3b":
        jcfg, tcfg = jax_get_config(which), get_config(which)
    else:
        jcfg = jax_get_config("zamba2-7b").replace(n_layers=27)
        tcfg = get_config("zamba2-7b").replace(n_layers=27)
    jm, tm = JaxLM(jcfg), DecoderLM(tcfg)
    assert _shapes(tm.param_specs()) == _shapes(jm.param_specs())
    for m in (jm, tm):
        assert not m.supports_paged() and m.has_recurrent_state()
    assert tm.n_paged_layers() == jm.n_paged_layers()
    ja, ta = jm.arena_state_specs(4), tm.arena_state_specs(4)
    jl = {tuple(p.key for p in path): js for path, js in
          jax.tree_util.tree_leaves_with_path(
              ja, is_leaf=lambda x: hasattr(x, "axes"))}
    tl = dict(np_paths(ta))
    assert set(jl) == set(tl) and tl
    for path, js in jl.items():
        ts = tl[path]
        assert ts.shape == js.shape
        assert ts.lane_axis == js.axes.index(BATCH)
        assert str(ts.dtype).split(".")[-1] == jnp.dtype(js.dtype).name
    jp, tp = (jm.paged_cache_specs(9, 4, jnp.int8),
              tm.paged_cache_specs(9, 4, torch.int8))
    assert set(tp) == set(jp)
    for name in jp:
        for k, v in jp[name].items():
            L, n, *rest = v.shape
            assert tp[name][k].shape == (L, n + 1, *rest)


def np_paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += np_paths(v, prefix + (k,))
        return out
    return [(prefix, tree)]


def test_convert_carries_doubly_stacked_and_five_d_packed_leaves():
    """The mLSTM's q/k/v, (groups, per - 1, nh, dh, dh), pack along dh
    into (groups, per - 1, nh, dh / 2, dh) bytes; they and the doubly
    stacked Mamba2 projections cross byte for byte; a layer's view of
    the stack is the JAX leaf's slice."""
    for kind, top, name in (("xlstm", "mlstm", "wq"),
                            ("zamba", "mamba", "in_proj")):
        jm, jp, tm, tp = pair(kind, "int4")
        j = jp[top]["cell"][name]
        t = tp[top]["cell"][name]
        assert isinstance(j, JaxQTensor) and isinstance(t, QTensor)
        assert (t.bits, t.group, t.axis, t.orig_shape) == \
            (j.bits, j.group, j.axis, j.orig_shape)
        assert t.data.ndim == len(j.orig_shape) == (5 if kind == "xlstm"
                                                    else 4)
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.scales.numpy(),
                                      np.asarray(j.scales))
        layer = t[1][0]
        np.testing.assert_array_equal(layer.data.numpy(),
                                      np.asarray(j.data[1, 0]))
        assert layer.orig_shape == j.orig_shape[2:]


def test_full_width_packs_as_the_kernel_checks_assume():
    """The groups `_pick_group` (shard hint 16) gives the full-width
    leaves, at which chip_smoke and tests/test_torch_cim_plan.py hold
    cim_gemv: 64 on the mLSTM's q/k/v (K = 1024), 105 on the sLSTM's
    ffn_down (K = 2730, odd), 128 on xlstm's other K = 2048 / 4096
    leaves, 112 on zamba's K = 3584 and 7168, 128 on its K = 14336."""
    from repro_torch.quant.ptq import _pick_group
    assert _pick_group(1024, 128, 16) == 64
    assert _pick_group(2730, 128, 16) == 105
    assert _pick_group(2048, 128, 16) == _pick_group(4096, 128, 16) == 128
    assert _pick_group(3584, 128, 16) == _pick_group(7168, 128, 16) == 112
    assert _pick_group(14336, 128, 16) == 128
    x = tssm.slstm_specs(get_config("xlstm-1.3b"))
    assert x["ffn_down"].shape == (2730, 2048)
    assert x["ffn_up"].shape == (2048, 5460)
    assert tssm.mamba2_specs(get_config("zamba2-7b"))["in_proj"].shape == \
        (3584, 14576)


# ----------------------------------------------------------------------------
# numerics the cells copy
# ----------------------------------------------------------------------------
def test_softplus_and_gelu_match_jax():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        [-1e4, -88.0, 19.9, 20.0, 20.1, 88.0, 1e4]]
                       ).astype(np.float32)
    np.testing.assert_allclose(
        tssm.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=1e-30)
    from repro_torch.models.common import ACTIVATIONS
    np.testing.assert_allclose(
        ACTIVATIONS["gelu"](torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------------
# the serve cells against JAX's
# ----------------------------------------------------------------------------
def jax_layer(a, depth):
    """Layer 0 of a JAX leaf stacked `depth` dims deep (a QTensor's
    data, scales and shape sliced alike)."""
    for _ in range(depth):
        a = (JaxQTensor(a.data[0], a.scales[0], a.bits, a.group, a.axis,
                        a.orig_shape[1:]) if isinstance(a, JaxQTensor)
             else a[0])
    return a


def _cell_case(kind, precision, layer):
    """One layer's (jax params, port params) of a cell, a state at lanes
    of random state, inputs x (b, s, d) for a padded chunk (n_new 5, 2,
    0) then two decode steps (n_new 1, 0, 1)."""
    jm, jp, tm, tp = pair(kind, precision)
    top = {"mlstm": "mlstm", "slstm": "slstm", "mamba2": "mamba"}[layer]
    depth = 1 if layer == "slstm" else 2
    jl = jax.tree_util.tree_map(lambda a: jax_layer(a, depth),
                                jp[top]["cell"],
                                is_leaf=lambda a: isinstance(a, JaxQTensor))
    tl = tm._stack_views(tp[top], top, depth)[0]
    tl = (tl if depth == 1 else tl[0])["cell"]
    spec = {"mlstm": jssm.mlstm_cache_spec, "slstm": jssm.slstm_cache_spec,
            "mamba2": jssm.mamba2_cache_spec}[layer](jm.cfg, 3)
    rng = np.random.default_rng(7)
    state = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in spec.items()}
    return jm.cfg, tm.cfg, jl, tl, state, rng


@pytest.mark.parametrize("precision", ["fp", "int4f32", "int4"])
@pytest.mark.parametrize("layer", ["mamba2", "mlstm", "slstm"])
def test_serve_cell_matches_jax(layer, precision):
    kind = "zamba" if layer == "mamba2" else "xlstm"
    jcfg, tcfg, jl, tl, state, rng = _cell_case(kind, precision, layer)
    jfn = {"mamba2": jssm.mamba2_serve_step, "mlstm": jssm.mlstm_serve_step,
           "slstm": jssm.slstm_serve_step}[layer]
    tfn = {"mamba2": tssm.mamba2_serve_step, "mlstm": tssm.mlstm_serve_step,
           "slstm": tssm.slstm_serve_step}[layer]
    tol = BF16_ROUTE_TOL if (precision == "int4" and layer == "mlstm") \
        else STEP_TOL
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    ptrs = {k: v.data_ptr() for k, v in tstate.items()}
    err = {}
    for s, n_new in ((6, [5, 2, 0]), (1, [1, 0, 1]), (1, [1, 1, 1])):
        x = rng.standard_normal((3, s, 32)).astype(np.float32)
        n_new = np.asarray(n_new, np.int32)
        valid = np.arange(s)[None, :] < n_new[:, None]
        jy, jstate = jfn(jl, jcfg, jnp.asarray(x), jstate,
                         jnp.asarray(valid))
        args = (tl, tcfg, torch.from_numpy(x), tstate,
                torch.from_numpy(valid))
        ty = tfn(*args) if layer == "slstm" else tfn(
            *args, torch.from_numpy(n_new))
        for i in range(3):
            if n_new[i]:
                err["out"] = max(err.get("out", 0.0), rel(
                    ty[i, :n_new[i]].numpy(), np.asarray(jy[i, :n_new[i]])))
        for k in state:
            err[k] = rel(tstate[k].numpy(), np.asarray(jstate[k]))
    assert max(err.values()) <= tol, err
    assert {k: v.data_ptr() for k, v in tstate.items()} == ptrs


def test_masked_lane_keeps_its_state_bit_for_bit():
    """A lane whose n_new is 0 keeps every state leaf exactly, in all
    three cells (the masked update folds the mask into the
    coefficients)."""
    for kind, layer in (("zamba", "mamba2"), ("xlstm", "mlstm"),
                        ("xlstm", "slstm")):
        _, tcfg, _, tl, state, rng = _cell_case(kind, "int4", layer)
        fn = {"mamba2": tssm.mamba2_serve_step,
              "mlstm": tssm.mlstm_serve_step,
              "slstm": tssm.slstm_serve_step}[layer]
        tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
        x = torch.from_numpy(rng.standard_normal((3, 4, 32)).astype(
            np.float32))
        n_new = torch.tensor([4, 0, 2], dtype=torch.int32)
        valid = torch.arange(4)[None] < n_new[:, None]
        if layer == "slstm":
            fn(tl, tcfg, x, tstate, valid)
        else:
            fn(tl, tcfg, x, tstate, valid, n_new)
        for k, v in state.items():
            assert torch.equal(tstate[k][1], torch.from_numpy(v[1])), \
                (layer, k)
            assert not torch.equal(tstate[k][0], torch.from_numpy(v[0]))


# ----------------------------------------------------------------------------
# whole steps: teacher-forced logits
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("kind,precision", [
    ("xlstm", "fp"), ("xlstm", "int4f32"), ("mamba2", "fp"),
    ("mamba2", "int4")])
def test_serve_step_logits_and_state_match_jax(kind, precision):
    step_both(kind, precision)


def test_xlstm_bf16_route_measured():
    """Against JAX's own route (q/k/v dequantized to bf16 each step):
    within BF16_ROUTE_TOL, and not within STEP_TOL (the difference is
    real: the rounding of the weights)."""
    worst, err = step_both("xlstm", "int4", tol=BF16_ROUTE_TOL)
    assert err > STEP_TOL


# ----------------------------------------------------------------------------
# the engine: streams, preemption, arena
# ----------------------------------------------------------------------------
def _prompts(n=5):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 64, int(k)).astype(np.int32)
            for k in (3, 11, 7, 20, 5)[:n]]


def _geom(**kw):
    return dict(dict(precision="int4", quant_group=GROUP, max_batch=2,
                     max_seq=64, page_size=8, prefill_chunk=4), **kw)


def serve_both(kind, geom, prompts, new=6, precision="fp"):
    """Greedy streams of `prompts` through both engines (the port's on
    the CPU) at `geom`, the params of `pair(kind, precision)`: packed
    ones are served as they are (int4f32: JAX's q/k/v in f32).  Returns
    (jax requests, port requests, port engine)."""
    jm, jp, tm, tp = pair(kind, precision)
    jreqs = [JaxRequest(prompt=p.copy(), max_new_tokens=new, rid=i)
             for i, p in enumerate(prompts)]
    JaxEngine(jm, jp, JaxServeConfig(**geom)).run(jreqs)
    treqs = [ServeRequest(prompt=p.copy(), max_new_tokens=new, rid=i)
             for i, p in enumerate(prompts)]
    eng = PagedServeEngine(tm, tp, ServeConfig(**geom), device="cpu")
    eng.run(treqs)
    return jreqs, treqs, eng


@pytest.mark.parametrize("kind,precision", [
    ("xlstm", "fp"), ("xlstm", "int4f32"), ("mamba2", "fp"),
    ("mamba2", "int4")])
def test_engine_streams_match_jax_and_single_requests(kind, precision):
    """A mixed-length batch (5 prompts over 2 lanes, continuous
    admission) gives JAX's greedy streams, and each equals its request
    served alone."""
    geom = _geom(precision="fp" if precision == "fp" else "int4")
    jreqs, treqs, eng = serve_both(kind, geom, _prompts(),
                                   precision=precision)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(r.done and len(r.out_tokens) == 6 for r in treqs)
    _, _, tm, tp = pair(kind, precision)
    for req in treqs[:3]:
        solo = ServeRequest(prompt=np.asarray(req.prompt), max_new_tokens=6)
        PagedServeEngine(tm, tp, ServeConfig(**geom), device="cpu").run(
            [solo])
        assert solo.out_tokens == req.out_tokens
    m = eng.summary()
    assert m["state_slot_occupancy_peak"] == 1.0
    assert m[f"lane_steps_{tm.cfg.family}"] > 0
    assert eng.cache.pools == {}
    assert set(launch_counts().values()) == {0}


@pytest.mark.parametrize("kind", ["xlstm", "mamba2"])
def test_preempted_lane_resumes_from_its_snapshot(kind):
    """Two lanes whose generations cannot coexist in 8 pages of 4: the
    preempted lane's arena slot goes to the host and comes back; its
    stream equals the unpreempted run's and JAX's tight run's, and no
    page leaks."""
    prompt = np.arange(1, 9, dtype=np.int32)
    jm, jp, tm, tp = pair(kind, "fp")

    def port(n_pages):
        eng = PagedServeEngine(tm, tp, ServeConfig(
            precision="fp", max_batch=2, max_seq=64, page_size=4,
            n_pages=n_pages, prefill_chunk=8), device="cpu")
        saves = []
        save = eng.arena.save_lane
        eng.arena.save_lane = lambda lane: saves.append(lane) or save(lane)
        reqs = [ServeRequest(prompt=prompt.copy(), max_new_tokens=10,
                             rid=i) for i in range(2)]
        eng.run(reqs)
        return reqs, eng, saves
    tight, eng, saves = port(8)
    assert saves, "no lane was preempted"
    assert all(r.done and len(r.out_tokens) >= 10 for r in tight)
    assert all(r.saved_state is None and r.prompt_folded == 0
               for r in tight)
    assert eng.cache.n_free_or_cached() == 8
    roomy, _, none = port(None)
    assert not none
    jreqs = [JaxRequest(prompt=prompt.copy(), max_new_tokens=10, rid=i)
             for i in range(2)]
    JaxEngine(jm, jp, JaxServeConfig(precision="fp", max_batch=2,
                                     max_seq=64, page_size=4, n_pages=8,
                                     prefill_chunk=8)).run(jreqs)
    for a, b, c in zip(tight, roomy, jreqs):
        assert a.out_tokens == b.out_tokens == c.out_tokens


def _random_arena(tm, lanes, rng):
    arena = StateArena(tm, max_batch=lanes)
    for _, leaf, _ in arena._leaves():
        leaf.copy_(torch.from_numpy(rng.standard_normal(
            tuple(leaf.shape)).astype(np.float32)).to(leaf.dtype))
    return arena


@pytest.mark.parametrize("kind", ["xlstm", "zamba", "mamba2"])
def test_arena_save_evict_restore_bit_identical(kind):
    """Seeded random lane traffic: save -> reset -> scribble -> restore
    gives every leaf's rows back bit for bit, other lanes untouched, and
    no leaf changes its address."""
    _, _, tm, _ = pair(kind, "fp")
    rng = np.random.default_rng(42)
    arena = _random_arena(tm, 3, rng)
    ptrs = [leaf.data_ptr() for _, leaf, _ in arena._leaves()]
    for _ in range(6):
        lane = int(rng.integers(0, 3))
        other = (lane + 1) % 3
        snap = arena.save_lane(lane)
        other_before = arena.save_lane(other)
        arena.reset_lane(lane)
        arena.restore_lane(lane, {k: torch.from_numpy(
            rng.standard_normal(tuple(v.shape)).astype(np.float32)).to(
                v.dtype) for k, v in snap.items()})
        arena.restore_lane(lane, snap)
        for k, v in arena.save_lane(lane).items():
            assert torch.equal(v, snap[k])
        for k, v in arena.save_lane(other).items():
            assert torch.equal(v, other_before[k])
    assert [leaf.data_ptr() for _, leaf, _ in arena._leaves()] == ptrs


def test_reset_lane_zeroes_only_its_lane_as_jax():
    _, _, tm, _ = pair("xlstm", "fp")
    jm = pair("xlstm", "fp")[0]
    rng = np.random.default_rng(3)
    arena = _random_arena(tm, 2, rng)
    keep = arena.save_lane(1)
    arena.reset_lane(0)
    assert all(not v.any() for v in arena.save_lane(0).values())
    assert all(torch.equal(v, keep[k])
               for k, v in arena.save_lane(1).items())
    assert arena.state_bytes() == JaxArena(jm, 2).state_bytes()


@pytest.mark.parametrize("kind", ["xlstm", "zamba"])
def test_state_bytes_and_slot_occupancy_equal_jax(kind):
    geom = _geom(precision="fp", max_batch=3)
    jm, jp, tm, tp = pair(kind, "fp")
    prompts = _prompts(4)
    jeng = JaxEngine(jm, jp, JaxServeConfig(**geom))
    jeng.run([JaxRequest(prompt=p.copy(), max_new_tokens=4, rid=i)
              for i, p in enumerate(prompts)])
    eng = PagedServeEngine(tm, tp, ServeConfig(**geom), device="cpu")
    eng.run([ServeRequest(prompt=p.copy(), max_new_tokens=4, rid=i)
             for i, p in enumerate(prompts)])
    jm_, tm_ = jeng.summary(), eng.summary()
    for key in ("state_bytes", "state_slot_occupancy_peak",
                "state_slot_occupancy_mean", f"lane_steps_{kind}"):
        assert tm_[key] == jm_[key], key


def test_arena_addresses_stay_across_steps_lane_ops_and_runner():
    """The captured graphs hold the arena's tensors by address: a
    StepRunner's calls, the engine's steps, preemption snapshots and
    lane resets and restores write them in place."""
    _, _, tm, tp = pair("xlstm", "int4")
    eng = PagedServeEngine(tm, tp, ServeConfig(
        precision="int4", quant_group=GROUP, max_batch=2, max_seq=64,
        page_size=4, n_pages=8, prefill_chunk=8), device="cpu")
    ptrs = [leaf.data_ptr() for _, leaf, _ in eng.arena._leaves()]
    assert eng.state["mlstm"] is eng.arena.state["mlstm"]
    reqs = [ServeRequest(prompt=np.arange(1, 9, dtype=np.int32),
                         max_new_tokens=10, rid=i) for i in range(2)]
    eng.run(reqs)
    assert [leaf.data_ptr() for _, leaf, _ in eng.arena._leaves()] == ptrs
    assert isinstance(eng.runner, StepRunner)
    assert len(eng.runner.steps()) == 2      # (4, 8) prefill, (2, 1) decode


# ----------------------------------------------------------------------------
# capabilities: the engine's and the launcher's refusals, JAX's wording
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["xlstm", "zamba", "mamba2"])
@pytest.mark.parametrize("capability", ["speculative-decoding",
                                        "prefix-cache",
                                        "parallel-sampling"])
def test_capability_errors_match_jax_text(kind, capability):
    jm, jp, tm, tp = pair(kind, "fp")
    want = jax_capability_error(jm, capability)
    assert capability_error(tm, capability) == want
    geom = dict(max_batch=1, max_seq=32, page_size=8)
    with pytest.raises(ValueError) as got:
        if capability == "speculative-decoding":
            PagedServeEngine(tm, tp, ServeConfig(**geom),
                             spec=SpecConfig(k=2), device="cpu")
        elif capability == "prefix-cache":
            PagedServeEngine(tm, tp, ServeConfig(**geom, prefix_cache=True),
                             device="cpu")
        else:
            eng = PagedServeEngine(tm, tp, ServeConfig(**geom),
                                   device="cpu")
            parent = ServeRequest(prompt=np.arange(4, dtype=np.int32))
            eng.submit(parent)
            eng.submit(ServeRequest(prompt=np.arange(4, dtype=np.int32),
                                    fork_from=parent))
    assert str(got.value) == want
    with pytest.raises(ValueError) as jgot:
        if capability == "speculative-decoding":
            JaxEngine(jm, jp, JaxServeConfig(**geom),
                      spec=JaxSpecConfig(k=2))
        elif capability == "prefix-cache":
            JaxEngine(jm, jp, JaxServeConfig(**geom, prefix_cache=True))
        else:
            jeng = JaxEngine(jm, jp, JaxServeConfig(**geom))
            parent = JaxRequest(prompt=np.arange(4, dtype=np.int32))
            jeng.submit(parent)
            jeng.submit(JaxRequest(prompt=np.arange(4, dtype=np.int32),
                                   fork_from=parent))
    assert str(jgot.value) == want


@pytest.mark.parametrize("kind", ["xlstm", "zamba", "mamba2"])
def test_prefix_cache_defaults_off_on_recurrent_models(kind):
    _, _, tm, tp = pair(kind, "fp")
    eng = PagedServeEngine(tm, tp, ServeConfig(max_batch=1, max_seq=32,
                                               page_size=8), device="cpu")
    assert eng.prefix is None and eng.arena is not None
    assert "prefix_pages_resident" not in eng.summary()


def test_prefix_cache_default_unchanged_for_dense_models():
    from test_torch_model import SMOKE
    from test_torch_model import _pair as dense_pair
    _, _, tm, tp = dense_pair(SMOKE, "fp")
    geom = dict(max_batch=1, max_seq=32, page_size=8)
    assert PagedServeEngine(tm, tp, ServeConfig(**geom),
                            device="cpu").prefix is not None
    assert PagedServeEngine(tm, tp, ServeConfig(**geom, prefix_cache=True),
                            device="cpu").prefix is not None
    assert PagedServeEngine(tm, tp, ServeConfig(**geom, prefix_cache=False),
                            device="cpu").prefix is None
    eng = PagedServeEngine(tm, tp, ServeConfig(**geom), device="cpu")
    assert eng.arena is None and eng.state is eng.cache.pools
    assert "state_bytes" not in eng.summary()


def test_launcher_check_capabilities_as_jax(capsys):
    for kind in ("xlstm", "zamba"):
        jm, _, tm, _ = pair(kind, "fp")
        for mode in ("ngram", "model"):
            with pytest.raises(ValueError) as got:
                check_capabilities(tm, mode, no_prefix_cache=False)
            with pytest.raises(ValueError) as want:
                jax_check_caps(jm, mode, no_prefix_cache=False)
            assert str(got.value) == str(want.value)
        assert check_capabilities(tm, "off", no_prefix_cache=False) is False
        mine = capsys.readouterr().out
        assert jax_check_caps(jm, "off", no_prefix_cache=False) is False
        assert mine == capsys.readouterr().out != ""
        assert check_capabilities(tm, "off", no_prefix_cache=True) is False
    from test_torch_model import SMOKE
    dense = DecoderLM(ModelConfig(**dict(SMOKE, dtype="float32")))
    assert check_capabilities(dense, "off", no_prefix_cache=False) is True
    assert check_capabilities(dense, "ngram", no_prefix_cache=True) is False


def test_launcher_refuses_spec_before_drawing_weights():
    from repro_torch.launch.serve import main
    with pytest.raises(ValueError, match="speculative-decoding"):
        main(["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu",
              "--spec", "ngram"])


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-7b"])
def test_launcher_smoke_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main
    eng, reqs = main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "3", "--tokens", "5", "--max-seq", "32",
                      "--page-size", "8"])
    out = capsys.readouterr().out
    assert "15 tokens" in out and "--no-prefix-cache implied" in out
    assert eng.prefix is None and eng.arena is not None
    assert all(len(r.out_tokens) == 5 for r in reqs)


# ----------------------------------------------------------------------------
# the kernel rule: every packed leaf to its kernel
# ----------------------------------------------------------------------------
def _packed_layers(tree, depth):
    """Data pointers of every packed per-layer weight under `tree`,
    stacked `depth` dims deep."""
    out = set()
    for _, leaf in np_paths(tree):
        if isinstance(leaf, QTensor):
            views = [leaf]
            for _ in range(depth):
                views = [v[i] for v in views for i in range(v.shape[0])]
            out |= {v.data.data_ptr() for v in views}
    return out


DEPTHS = {"mlstm": 2, "slstm": 1, "mamba": 2, "mamba_tail": 1, "lora": 1,
          "shared": 0, "head": 0}


def kernel_leaves(tm, tp, monkeypatch, s=1):
    """(packed per-layer weights the step hands to cim_gemv /
    swiglu_qgemv, every packed per-layer weight the model uses (the
    embedding table only as a tied head: its rows are gathered),
    whole-weight dequantizations) of one serve_step."""
    seen = set()
    real_cim, real_sw = ops.cim_gemv, ops.swiglu_qgemv

    def cim(x, w, counts=None):
        seen.add(w.data.data_ptr())
        return real_cim(x, w, counts)

    def sw(x, wg, wu):
        seen.update({wg.data.data_ptr(), wu.data.data_ptr()})
        return real_sw(x, wg, wu)
    monkeypatch.setattr(ops, "cim_gemv", cim)
    monkeypatch.setattr(ops, "swiglu_qgemv", sw)
    state = port_state(tm, 2, 8, 4, torch.int8)
    qarray.reset_dequant_counters()
    tm.serve_step(tp, state, {"tokens": torch.zeros(2, s, dtype=torch.long)},
                  torch.arange(8, dtype=torch.int32).reshape(2, 4),
                  torch.zeros(2, dtype=torch.int32),
                  torch.full((2,), s, dtype=torch.int32))
    want = set()
    for name, depth in DEPTHS.items():
        # a pure-Mamba2 zamba has the shared block's leaves, as in JAX,
        # but never invokes them
        if name in tp and not (name == "shared"
                               and tm.n_paged_layers() == 0):
            want |= _packed_layers(tp[name] if isinstance(tp[name], dict)
                                   else {"w": tp[name]}, depth)
    if tm.cfg.tie_embeddings:                # the table is the head
        want.add(tp["embed"].data.data_ptr())
    return seen, want, qarray.dequant_counters()["full_dequant"]


@pytest.mark.parametrize("kind", ["xlstm", "mamba2"])
def test_every_packed_leaf_goes_to_a_kernel(kind, monkeypatch):
    """No packed leaf leaves the kernels: the mLSTM's head-wise q/k/v
    (in cim_gemv's stack layout) with every other projection, in a
    decode step and a prefill chunk; nothing is dequantized whole."""
    _, _, tm, tp = pair(kind, "int4")
    for s in (1, 5):
        seen, want, full = kernel_leaves(tm, tp, monkeypatch, s)
        assert want and seen == want and full == 0


def test_import_isolation_covers_the_recurrent_modules():
    code = (
        "import sys\n"
        "import repro_torch.models.ssm, repro_torch.serve.state\n"
        "import repro_torch.configs.archs.xlstm_1_3b\n"
        "import repro_torch.configs.archs.zamba2_7b\n"
        "import repro_torch.launch.serve\n"
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
