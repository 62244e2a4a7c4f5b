"""The port's dry-run and roofline tooling against the JAX package's:
the registry's shape tables and `long_ok` flags, `params_count`, the
probe, `quantize_structs`, each rule table's per-device blocks (JAX's
`NamedSharding.shard_shape` on an `AbstractMesh` with Auto axes), the
smoke cells' argument bytes (JAX's `memory_analysis()` on a 1 x 1 Auto
mesh) and FLOPs (the dot_generals of JAX's jaxpr), the tensor-parallel
collectives' independence of tp, the kernels' meta route, and the
roofline on the H100's constants."""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jex
from jax.sharding import AbstractMesh, AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jreg
from repro.launch import params_count as jpc
from repro.launch import probe as jprobe
from repro.launch import specs as jspecs
from repro.models import DecoderLM as JaxLM
from repro.quant import ptq as jptq
from repro.quant.qarray import QTensor as JQT
from repro_torch.configs import registry as treg
from repro_torch.dist.shard import shard_shape
from repro_torch.kernels.cim_gemv import cim_gemv
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.paged_flash_decode import paged_flash_decode
from repro_torch.kernels.swiglu_gemv import swiglu_qgemv
from repro_torch.launch import dryrun, metarun
from repro_torch.launch import params_count as tpc
from repro_torch.launch import probe as tprobe
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import DecoderLM as TorchLM
from repro_torch.quant import ptq as tptq
from repro_torch.quant.qarray import QTensor as TQT
from repro_torch.quant.qarray import quantize as tquantize
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import report as rr

ARCHS = sorted(jreg.ARCH_IDS)


def _dt(d) -> str:
    return str(d).replace("torch.", "")


# ----------------------------------------------------------------------------
# registry, params_count, probe
# ----------------------------------------------------------------------------
def test_registry_tables_and_long_ok():
    assert treg.SHAPE_IDS == jreg.SHAPE_IDS and treg.SHAPES == jreg.SHAPES
    assert list(treg.ARCH_IDS) == list(jreg.ARCH_IDS) and \
        len(treg.ARCH_IDS) == 10 and "qwen2.5-3b" in treg.ARCH_IDS
    for arch in ARCHS:
        assert treg.supports_long(arch) == jreg.supports_long(arch), arch
        assert treg.shapes_for(arch) == jreg.shapes_for(arch), arch
    assert {a for a in ARCHS if treg.supports_long(a)} == {
        "gemma2-27b", "gemma3-4b", "xlstm-1.3b", "zamba2-7b"}
    with pytest.raises(NotImplementedError):
        treg.shapes_for("no-such-arch")
    got = treg.input_specs("musicgen-medium", "train_4k", multi_pod=True)
    want = jreg.input_specs("musicgen-medium", "train_4k", multi_pod=True)
    assert {k: (tuple(v.shape), _dt(v.dtype), v.device.type)
            for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype), "meta") for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_count_equals_jax(arch):
    cj, ct = jreg.get_config(arch), treg.get_config(arch)
    assert tpc.total_params(ct) == jpc.total_params(cj)
    assert tpc.active_params(ct) == jpc.active_params(cj)
    for shape in jreg.SHAPE_IDS:
        assert tpc.total_tokens(shape) == jpc.total_tokens(shape)
    for quant in ("bf16", "int8", "int4"):
        assert tpc.bytes_per_param(quant) == jpc.bytes_per_param(quant)
        for shape in ("decode_32k", "long_500k"):
            for n in (1, 256, 512):
                assert tpc.decode_model_bytes(ct, shape, quant, n) == \
                    jpc.decode_model_bytes(cj, shape, quant, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_equals_jax(arch):
    cj, ct = jreg.get_config(arch), treg.get_config(arch)
    vj, vt = jprobe.probe_variants(cj), tprobe.probe_variants(ct)
    assert vj[2] == vt[2]
    for (cfg_j, uj), (cfg_t, ut) in zip(vj[:2], vt[:2]):
        assert uj == ut and cfg_j.n_layers == cfg_t.n_layers
        assert cfg_j.unroll and cfg_t.unroll
        assert TorchLM(cfg_t).n_params() == JaxLM(cfg_j).n_params()
    for shape in jreg.shapes_for(arch):
        for n in (1, 256):
            assert tprobe.time_scan_corrections(ct, shape, n) == \
                jprobe.time_scan_corrections(cj, shape, n)
    m1 = {"flops": 3.0, "hlo_bytes": 10.0, "label": "x"}
    m2 = {"flops": 5.0, "hlo_bytes": 13.5, "label": "y"}
    assert tprobe.extrapolate(m1, m2, 1, 2, 36) == \
        jprobe.extrapolate(m1, m2, 1, 2, 36)


# ----------------------------------------------------------------------------
# quantize_structs, the rule tables' per-device blocks
# ----------------------------------------------------------------------------
def _jax_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _jax_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _torch_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _torch_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _desc(leaf):
    if isinstance(leaf, (JQT, TQT)):
        return ("q", tuple(leaf.data.shape), _dt(leaf.data.dtype),
                tuple(leaf.scales.shape), _dt(leaf.scales.dtype), leaf.bits,
                leaf.group, leaf.axis, tuple(leaf.orig_shape))
    return (tuple(leaf.shape), _dt(leaf.dtype))


@pytest.mark.filterwarnings("ignore:ptq")
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_structs_equals_jax(arch):
    sj = JaxLM(jreg.get_config(arch)).param_specs()
    st = TorchLM(treg.get_config(arch)).param_specs()
    for bits in (4, 8):
        qj = dict(_jax_leaves(jptq.quantize_structs(sj, bits=bits)))
        qt = dict(_torch_leaves(tptq.quantize_structs(st, bits=bits)))
        assert qj.keys() == qt.keys()
        for path in qj:
            assert _desc(qt[path]) == _desc(qj[path]), (bits, path)
            leaf = qt[path]
            for t in ((leaf.data, leaf.scales) if isinstance(leaf, TQT)
                      else (leaf,)):
                assert t.device.type == "meta"


@pytest.mark.filterwarnings("ignore:ptq")
def test_quantized_fraction_equals_jax():
    cfg_j = jreg.get_smoke_config("qwen2.5-3b")
    cfg_t = treg.get_smoke_config("qwen2.5-3b")
    rng = np.random.default_rng(0)
    pj, pt = {}, {}
    for (path, sj), (_, s_t) in zip(
            _jax_leaves(JaxLM(cfg_j).param_specs()),
            _torch_leaves(TorchLM(cfg_t).param_specs())):
        x = rng.standard_normal(sj.shape).astype(np.float32)
        node_j, node_t = pj, pt
        for k in path[:-1]:
            node_j, node_t = node_j.setdefault(k, {}), node_t.setdefault(k, {})
        node_j[path[-1]] = jnp.asarray(x, jnp.bfloat16)
        node_t[path[-1]] = torch.from_numpy(x).to(torch.bfloat16)
    for bits in (4, 8):
        fj = jptq.quantized_fraction(jptq.quantize_params(pj, bits=bits))
        ft = tptq.quantized_fraction(tptq.quantize_params(pt, bits=bits))
        assert ft == fj and 0.5 < ft < 1.0


def _jax_tables():
    from repro.dist.axes import MULTI_POD_RULES, SINGLE_POD_RULES
    return {"SINGLE_POD_RULES": SINGLE_POD_RULES,
            "MULTI_POD_RULES": MULTI_POD_RULES,
            **{n: getattr(jspecs, n) for n in (
                "LONG_SINGLE_RULES", "LONG_MULTI_RULES",
                "SERVE_SINGLE_RULES", "SERVE_MULTI_RULES",
                "SERVE_LONG_SINGLE_RULES", "SERVE_LONG_MULTI_RULES")}}


def _torch_tables():
    from repro_torch.dist.axes import MULTI_POD_RULES, SINGLE_POD_RULES
    return {"SINGLE_POD_RULES": SINGLE_POD_RULES,
            "MULTI_POD_RULES": MULTI_POD_RULES,
            **{n: getattr(tspecs, n) for n in (
                "LONG_SINGLE_RULES", "LONG_MULTI_RULES",
                "SERVE_SINGLE_RULES", "SERVE_MULTI_RULES",
                "SERVE_LONG_SINGLE_RULES", "SERVE_LONG_MULTI_RULES")}}


def test_rule_tables_and_rules_for_equal_jax():
    tj, tt = _jax_tables(), _torch_tables()
    for name in tj:
        assert tt[name].table == tj[name].table, name
    for multi in (False, True):
        mesh_t = make_production_mesh(multi_pod=multi)
        mesh_j = AbstractMesh(tuple(mesh_t.values()), tuple(mesh_t),
                              axis_types=(AxisType.Auto,) * len(mesh_t))
        for shape in jreg.SHAPE_IDS:
            for serve in (False, True):
                assert tspecs.rules_for(mesh_t, shape, serve).table == \
                    jspecs.rules_for(mesh_j, shape, serve).table
    assert tspecs.SMOKE_SHAPES == jspecs.SMOKE_SHAPES


@pytest.mark.filterwarnings("ignore:ptq")
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_blocks_equal_jax_shard_shape(arch):
    """Every rule table's per-device block of every param leaf (float and
    INT4), cache leaf and input, at the single and the multi mesh."""
    from repro.dist.shard import qtree_shardings, tree_shardings
    cj, ct = jreg.get_config(arch), treg.get_config(arch)
    mj, mt = JaxLM(cj), TorchLM(ct)
    trees = [(mj.param_specs(), mt.param_specs(), False),
             (mj.param_specs(), mt.param_specs(), True),
             (mj.cache_specs(128, 4096), mt.cache_specs(128, 4096), False)]
    tables_j, tables_t = _jax_tables(), _torch_tables()
    for multi in (False, True):
        mesh_t = make_production_mesh(multi_pod=multi)
        mesh_j = AbstractMesh(tuple(mesh_t.values()), tuple(mesh_t),
                              axis_types=(AxisType.Auto,) * len(mesh_t))
        for name in tables_j:
            if ("MULTI" in name) != multi:
                continue
            rj, rt = tables_j[name], tables_t[name]
            for spec_j, spec_t, packed in trees:
                if packed:
                    qj = jptq.quantize_structs(spec_j, bits=4)
                    qt = tptq.quantize_structs(spec_t, bits=4)
                    shj = qtree_shardings(spec_j, qj, mesh_j, rj)
                else:
                    qj = jax.tree_util.tree_map(
                        lambda s: s.struct(), spec_j,
                        is_leaf=lambda x: hasattr(x, "materialize"))
                    qt = tspecs.meta_tree(spec_t)
                    shj = tree_shardings(spec_j, mesh_j, rj)
                leaves_j = dict(_jax_leaves(qj))
                sh_leaves = dict(_jax_leaves(shj))
                ps_t = dict(_torch_leaves(tspecs.tree_pspecs(
                    spec_t, qt, mesh_t, rt)))
                for path, leaf_t in _torch_leaves(qt):
                    lj, sh = leaves_j[path], sh_leaves[path]
                    parts = ((lj.data, sh.data), (lj.scales, sh.scales)) \
                        if isinstance(lj, JQT) else ((lj, sh),)
                    parts_t = (leaf_t.data, leaf_t.scales) \
                        if isinstance(leaf_t, TQT) else (leaf_t,)
                    for (x, s), xt in zip(parts, parts_t):
                        assert shard_shape(tuple(xt.shape), ps_t[path],
                                           mesh_t) == \
                            s.shard_shape(x.shape), (name, path)
        inp = tspecs.input_specs(arch, "decode_32k", multi)
        rules = tspecs.rules_for(mesh_t, "decode_32k")
        for k, v in tspecs.input_pspecs(inp, mesh_t, rules).items():
            b = rules.get("batch")
            want = NamedSharding(mesh_j, P(b, *([None] * (inp[k].ndim - 1)))
                                 ).shard_shape(tuple(inp[k].shape))
            assert shard_shape(tuple(inp[k].shape), v, mesh_t) == want


# ----------------------------------------------------------------------------
# the smoke cells against XLA
# ----------------------------------------------------------------------------
def _jax_cell(arch, shape, quant):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    cell = jspecs.build_cell(arch, shape, mesh, quant=quant,
                             cfg=jreg.get_smoke_config(arch),
                             shapes=jspecs.SMOKE_SHAPES)
    return mesh, cell


def _torch_record(arch, shape, quant):
    return dryrun.run_cell(arch, shape, False, quant, out_dir=None,
                           verbose=False, cfg=treg.get_smoke_config(arch),
                           shapes=tspecs.SMOKE_SHAPES,
                           mesh_shape=make_host_mesh())


@pytest.mark.filterwarnings("ignore:ptq")
@pytest.mark.parametrize("arch,shape,quant", [
    ("qwen2.5-3b", "decode_32k", "int4"), ("qwen2.5-3b", "train_4k", "bf16"),
    ("deepseek-v2-lite-16b", "decode_32k", "int4"),
    ("xlstm-1.3b", "decode_32k", "bf16")])
def test_argument_bytes_equal_jax_memory_analysis(arch, shape, quant):
    """xlstm's decode never reads pos: jax.jit drops it (keep_unused is
    off), and the port's count leaves it out too."""
    mesh, cell = _jax_cell(arch, shape, quant)
    with mesh:
        compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                           donate_argnums=cell.donate).lower(
                               *cell.args).compile()
    want = compiled.memory_analysis().argument_size_in_bytes
    rec = _torch_record(arch, shape, quant)
    assert rec["memory_per_device"]["argument_bytes"] == want
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    if arch == "xlstm-1.3b":
        assert rec["memory_per_device"]["unused_argument_bytes"] == 4


def _dot_flops(jaxpr, mult=1):
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            k = math.prod(eqn.invars[0].aval.shape[i] for i in lc)
            total += mult * 2 * math.prod(eqn.outvars[0].aval.shape) * k
        m = mult * (eqn.params["length"] if eqn.primitive.name == "scan"
                    else 1)
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(sub, jex.ClosedJaxpr):
                    total += _dot_flops(sub.jaxpr, m)
                elif isinstance(sub, jex.Jaxpr):
                    total += _dot_flops(sub, m)
    return total


@pytest.mark.filterwarnings("ignore:ptq")
@pytest.mark.parametrize("shape,quant,tol", [
    ("train_4k", "bf16", 0.0), ("prefill_32k", "bf16", 0.0),
    ("decode_32k", "bf16", 0.01), ("decode_32k", "int4", 0.015)])
def test_flops_match_jax_dot_generals(shape, quant, tol):
    """qwen2.5-3b smoke.  Train and prefill are equal.  Decode: JAX
    attends the stale rows and adds the fresh token as a rank-1 term
    (two more small dot_generals a layer, 0.26 % here); at INT4 a packed
    product whose contraction is one scale group (K / group = 1) scales
    it as an elementwise product in torch's einsum, where XLA keeps a
    dot_general (1.26 % in all)."""
    mesh, cell = _jax_cell("qwen2.5-3b", shape, quant)
    with mesh:
        want = _dot_flops(jax.make_jaxpr(cell.fn)(*cell.args).jaxpr)
    got = _torch_record("qwen2.5-3b", shape, quant)["flops"]
    assert abs(got - want) <= tol * want
    if tol:
        assert got < want


# ----------------------------------------------------------------------------
# the port's own pieces
# ----------------------------------------------------------------------------
@pytest.mark.filterwarnings("ignore:ptq")
@pytest.mark.parametrize("quant", ["bf16", "int4"])
def test_tp_collectives_do_not_depend_on_tp(quant):
    cfg = treg.get_smoke_config("qwen2.5-3b").replace(n_kv_heads=4)
    at = {tp: dryrun._tp_run("qwen2.5-3b", "decode_32k", quant, cfg,
                             tspecs.SMOKE_SHAPES, tp=tp) for tp in (2, 4)}
    assert isinstance(at[2], dict) and at[2] == at[4]
    L = cfg.n_layers
    assert sum(n for n, _ in at[2].values()) == 2 * L + 2
    assert isinstance(dryrun._tp_run("qwen2.5-3b", "train_4k", "bf16", cfg,
                                     tspecs.SMOKE_SHAPES), str)


@pytest.mark.filterwarnings("ignore:ptq")
def test_a_failing_tp_run_fails_the_cell(monkeypatch):
    """Only train and prefill cells have no tp run; a decode cell whose
    tp run raises is no `ok` record."""
    def broken(*a, **k):
        raise RuntimeError("tp path broken")
    monkeypatch.setattr(dryrun, "_tp_decode_step", broken)
    cfg = treg.get_smoke_config("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="tp path broken"):
        dryrun._tp_run("qwen2.5-3b", "decode_32k", "int4", cfg,
                       tspecs.SMOKE_SHAPES)
    with pytest.raises(RuntimeError, match="tp path broken"):
        dryrun.run_cell("qwen2.5-3b", "decode_32k", False, "int4",
                        out_dir=None, verbose=False, cfg=cfg.replace(
                            n_layers=3), shapes=tspecs.SMOKE_SHAPES)


@pytest.mark.filterwarnings("ignore:ptq")
def test_min_bytes_is_what_the_decode_step_must_move():
    """qwen2.5-3b smoke decode on the host mesh: every argument read
    once (the tied table whole, by the head), the logits written, and
    in place one K and one V row a lane and layer; far below the bytes
    by op, which are no bound."""
    cfg = treg.get_smoke_config("qwen2.5-3b")
    rec = dryrun.run_cell("qwen2.5-3b", "decode_32k", False, "int4",
                          out_dir=None, verbose=False, cfg=cfg,
                          shapes=tspecs.SMOKE_SHAPES,
                          mesh_shape=make_host_mesh())
    seq, b, _ = tspecs.SMOKE_SHAPES["decode_32k"]
    mem = rec["memory_per_device"]
    rows = cfg.n_layers * 2 * b * cfg.n_kv_heads * cfg.head_dim * 2
    new = mem["output_bytes"] - mem["alias_bytes"]
    assert new == b * cfg.vocab * 4
    assert rec["min_bytes"] == mem["argument_bytes"] + new + rows
    assert rec["t_memory"] == rec["min_bytes"] / ra.HBM_BW
    assert rec["hlo_bytes"] > 2 * rec["min_bytes"]


def test_meta_counter_moves_gathered_and_scattered_rows_only():
    table = torch.empty(100, 8, device="meta")
    cache = torch.empty(50, 8, device="meta")
    idx = torch.empty(3, dtype=torch.int64, device="meta")
    mc = metarun.MetaCounter()
    mc.hold((table, cache))
    with mc:
        rows = torch.nn.functional.embedding(idx, table)
        cache.index_put_((idx[:2],), rows[:2])
        # data-shaped: every element kept
        u, n = torch.unique_consecutive(idx, return_counts=True)
    moved = mc.moved()
    k_t = table.untyped_storage()._cdata
    k_c = cache.untyped_storage()._cdata
    assert moved[k_t] == pytest.approx(3 / 100)
    assert moved[k_c] == pytest.approx(2 / 50)
    assert u.shape == (3,) and n.shape == (3,) and u.device.type == "meta"


def test_scan_loops_on_the_cpu_and_takes_one_step_under_a_counter():
    from repro_torch.models.common import SCANS, scan
    xs = torch.randn(2, 5, 3)

    def step(carry, x_t, w):
        (h,) = carry
        h = torch.tanh(h * w + x_t)
        return (h,), h

    w = torch.tensor(0.5)
    (last,), ys = scan(step, (torch.zeros(2, 3),), (xs,), (w,))
    h, want = torch.zeros(2, 3), []
    for t in range(5):
        h = torch.tanh(h * w + xs[:, t])
        want.append(h)
    assert torch.equal(ys, torch.stack(want, 1)) and torch.equal(last, h)
    h0, xm, wm = (t.to("meta") for t in (torch.zeros(2, 3), xs, w))
    mc = metarun.MetaCounter()
    with mc:
        assert SCANS == [metarun.scan_once]
        _, ys = scan(step, (h0,), (xm,), (wm,))
    assert SCANS == [] and ys.shape == (2, 5, 3)
    one = metarun.MetaCounter()
    x0 = xm[:, 0]
    with one:
        step((h0,), x0, wm)
    # one step counted 5 times, then the y's written out (b, 5, ...)
    assert mc.bytes == 5 * one.bytes + 2 * ys.numel() * 4


def test_meta_stack_product_counts_the_expert_loops_flops():
    """cim_gemv's meta route contracts a stack at once: the FLOPs of the
    plain version's loop over experts, the same result shape."""
    from repro_torch.kernels.cim_gemv import cim_gemv_plain
    qt = tquantize(torch.randn(4, 64, 24), 4, 16, axis=-2)
    w = TQT(qt.data.to("meta"), qt.scales.to("meta"), qt.bits, qt.group,
            qt.axis, qt.orig_shape)
    x = torch.empty(4, 5, 64, device="meta")
    got = []
    for fn in (cim_gemv, cim_gemv_plain):
        mc = metarun.MetaCounter()
        with mc:
            out = fn(x, w)
        got.append((mc.flops, tuple(out.shape), out.dtype))
    assert got[0] == got[1] and got[0][0] == 2 * 4 * 5 * 64 * 24 + \
        2 * 4 * 5 * 4 * 24


def test_wrappers_take_the_meta_route_only_when_every_tensor_is_meta():
    qt = tquantize(torch.randn(64, 32), 4, 16)
    meta_qt = TQT(qt.data.to("meta"), qt.scales.to("meta"), qt.bits,
                  qt.group, qt.axis, qt.orig_shape)
    x = torch.ones(3, 64, device="meta")
    assert cim_gemv(x, meta_qt).shape == (3, 32)
    assert cim_gemv(x, meta_qt).device.type == "meta"
    assert swiglu_qgemv(x, meta_qt, meta_qt).shape == (3, 32)
    for bad in ((x, qt), (torch.ones(3, 64), meta_qt)):
        with pytest.raises(ValueError):
            cim_gemv(*bad)
    with pytest.raises(ValueError):
        swiglu_qgemv(x, qt, qt)
    mixed = TQT(qt.data.to("meta"), qt.scales, qt.bits, qt.group, qt.axis,
                qt.orig_shape)
    with pytest.raises(ValueError):
        cim_gemv(x, mixed)
    q = torch.ones(4, 2, 16, device="meta")
    kv = torch.ones(4, 32, 16, device="meta")
    assert flash_decode(q, kv, kv, 5).shape == (4, 2, 16)
    with pytest.raises(ValueError):
        flash_decode(q, torch.ones(4, 32, 16), torch.ones(4, 32, 16), 5)
    pools = torch.ones(8, 16, 2, 16, device="meta")
    out = paged_flash_decode(
        torch.ones(2, 2, 1, 16, device="meta"), pools, pools,
        torch.zeros(2, 4, dtype=torch.int32, device="meta"),
        torch.ones(2, dtype=torch.int32, device="meta"))
    assert out.shape == (2, 2, 1, 16) and out.device.type == "meta"
    with pytest.raises(ValueError):
        paged_flash_decode(
            torch.ones(2, 2, 1, 16), pools, pools,
            torch.zeros(2, 4, dtype=torch.int32),
            torch.ones(2, dtype=torch.int32))


def test_meta_counter_counts_what_flop_counter_mode_counts():
    """The memo and the time-loop stand-in change no count: the smoke
    xlstm and zamba forwards (an sLSTM recurrence, Mamba2's chunk loop)
    on meta against FlopCounterMode over the same forward on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.common import init_params
    for arch in ("xlstm-1.3b", "zamba2-7b"):
        model = TorchLM(treg.get_smoke_config(arch).replace(remat=False))
        specs = model.param_specs()
        params = init_params(specs, torch.Generator().manual_seed(0))
        tokens = torch.randint(0, 64, (2, 40))
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            model.forward(params, {"tokens": tokens})
        counts = []
        for _ in range(2):                      # the second from the memo
            mc = metarun.MetaCounter(dryrun._MEMO)
            meta = tspecs.meta_tree(specs)
            with torch.no_grad(), mc:
                model.forward(meta, {"tokens": tokens.to("meta")})
            counts.append(mc.flops)
        assert counts == [fc.get_total_flops()] * 2, arch


def test_roofline_terms_on_h100_constants():
    assert (ra.PEAK_FLOPS, ra.HBM_BW, ra.NVLINK_BW, ra.NIC_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)
    assert ra.axis_bandwidth(8) == ra.NVLINK_BW
    assert ra.axis_bandwidth(16) == ra.NIC_BW
    assert ra.mesh_collective_bw(make_production_mesh()) == ra.NIC_BW
    assert ra.mesh_collective_bw({"data": 2, "model": 4}) == ra.NVLINK_BW
    r = ra.Roofline(arch="a", shape_id="s", kind="train", mesh="single",
                    quant="bf16", flops=ra.PEAK_FLOPS,
                    hlo_bytes=ra.HBM_BW * 7, min_bytes=ra.HBM_BW * 2,
                    collective_bytes=ra.COLLECTIVE_BW * 0.5,
                    model_flops=ra.PEAK_FLOPS / 2)
    assert r.t_compute == 1.0 and r.t_memory == 2.0 and r.t_collective == 0.5
    assert r.t_memory_by_op == 7.0
    assert r.dominant == "memory" and r.bound_time == 2.0
    assert abs(r.roofline_fraction - 0.25) < 1e-9
    assert abs(r.useful_flops_ratio - 0.5) < 1e-9
    st = ra.CollectiveStats()
    st.add("all-gather", 10.0)
    st.add("all-gather", 6.0, count=3)
    assert st.total_bytes == 16.0 and st.count_by_kind == {"all-gather": 4}
    assert ra.model_flops_for("qwen2.5-3b", "train_4k", 256) == \
        6.0 * tpc.active_params(treg.get_config("qwen2.5-3b")) \
        * 4096 * 256 / 256


def test_dryrun_cli_writes_records_the_report_reads(tmp_path, capsys):
    out = str(tmp_path / "dryrun_torch")
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                 "--quant", "int4", "--out", out])
    path = os.path.join(out, "qwen2.5-3b__decode_32k__single__int4.json")
    with open(path) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    mem = rec["memory_per_device"]
    assert mem["peak_bytes"] == pytest.approx(
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
        - mem["alias_bytes"])
    assert rec["collective_bw"] == ra.NIC_BW and rec["flops"] > 0
    assert "code_bytes" not in mem and "t_trace_s" in rec
    os.utime(path, (0, 0))
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                 "--quant", "int4", "--out", out])
    assert os.stat(path).st_mtime == 0          # never replaced
    capsys.readouterr()
    rr.main(["--md", "--dryrun-dir", out, "--probe-dir",
             str(tmp_path / "none"), "--json-out",
             str(tmp_path / "table.json")])
    table = capsys.readouterr().out
    assert "| qwen2.5-3b | decode_32k | int4 |" in table
    rows = json.load(open(tmp_path / "table.json"))
    assert rows[0]["source"] == "full" and rows[0]["fits_80g"]
