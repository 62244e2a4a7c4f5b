"""The port's sharding substrate (`repro_torch.dist.axes`, `dist.shard`,
`ParamSpec.axes`, `DecoderLM.validate_tp`) against the JAX package's, on
the CPU with no process group.

  * every ParamSpec of every arch's smoke config (params, the engine's
    decode state, the contiguous cache) carries JAX's logical axes;
  * the rule tables, their pspecs and `sanitize_pspec` equal JAX's, a
    pspec a tuple of `PartitionSpec`'s entries;
  * `leaf_pspec` equals `qtree_shardings(...)`'s spec on JAX's serve
    mesh of 2 devices (tests/conftest.py forces a 2-device host) for
    every leaf of the qwen2.5-3b and gemma3-4b smoke configs, float and
    INT4, and of a config whose `w_down` JAX replicates (3 groups of 8
    rows do not split in two);
  * each rank's slice (`shard_tree`) is byte-equal to the shard JAX puts
    on that rank's device;
  * `validate_tp` raises where JAX's does, with its message;
  * the kernels' host plans take every call at qwen2.5-3b's shapes on
    one of two ranks.
Weights are drawn with numpy from a seed (`host_weights`) and packed
once for both packages (`packed`).
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_smoke
from repro.dist import axes as jax_axes
from repro.dist import qtree_shardings, serve_mesh
from repro.models import DecoderLM as JaxLM
from repro.models import MLAConfig as JaxMLA
from repro.models import ModelConfig as JaxConfig
from repro.models import MoEConfig as JaxMoE
from repro.models import SSMConfig as JaxSSM
from repro.models import ZambaConfig as JaxZamba
from repro.models.common import is_spec
from repro.quant.qarray import QTensor as JaxQTensor

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.dist import axes as port_axes
from repro_torch.dist.shard import leaf_pspec, shard_specs, shard_tree
from repro_torch.kernels import cim_gemv as cg
from repro_torch.kernels import split_decode as sd
from repro_torch.kernels import swiglu_gemv as sw
from repro_torch.models import DecoderLM
from repro_torch.quant.ptq import _pick_group, quantize_params
from repro_torch.quant.qarray import QTensor

from torch_tp_ranks import port_config


# w_down (24, 32) in groups of 8: 12 packed rows but 3 scale rows, which
# two ranks cannot split, so JAX's rule (and the port's) replicates it;
# its head is untied, a (32, 64) leaf sharded by vocab columns
REPLICATED_LEAF = dict(name="rep-leaf", family="dense", n_layers=2,
                       d_model=32, n_heads=4, n_kv_heads=2, d_ff=24,
                       vocab=64, head_dim=8, tie_embeddings=False)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _smoke_kw(arch_id):
    """JAX's smoke config of `arch_id` as an arch dict, its `moe` / `mla`
    / `ssm` / `zamba` as dicts of their fields (tests/torch_tp_ranks.py)."""
    cfg = jax_smoke(arch_id)
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for k in ("moe", "mla", "ssm", "zamba"):
        if out[k] is not None:
            out[k] = dataclasses.asdict(out[k])
    return out


def jax_config(arch):
    """JAX's f32 ModelConfig of an arch dict."""
    kw = dict(arch, dtype="float32", remat=False)
    if isinstance(kw.get("moe"), dict):
        kw["moe"] = JaxMoE(**kw["moe"])
    for k, cls in (("mla", JaxMLA), ("ssm", JaxSSM), ("zamba", JaxZamba)):
        if isinstance(kw.get(k), dict):
            kw[k] = cls(**kw[k])
    return JaxConfig(**kw)


# ----------------------------------------------------------------------------
# ParamSpec.axes
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_param_and_state_axes_equal_jax(arch_id):
    jm, tm = JaxLM(jax_smoke(arch_id)), DecoderLM(get_smoke_config(arch_id))
    pairs = [(jm.param_specs(), tm.param_specs()),
             (jm.cache_specs(2, 16), tm.cache_specs(2, 16))]
    if jm.cfg.embed_inputs:
        pairs.append((jm.decode_state_specs(2, 8, 4),
                      tm.decode_state_specs(2, 8, 4)))
    if jm.cfg.embed_inputs and jm.cfg.attn_kind != "mla":    # int8 pools
        pairs.append((jm.decode_state_specs(2, 8, 4, jnp.int8),
                      tm.decode_state_specs(2, 8, 4, torch.int8)))
    for ref, mine in pairs:
        ref, mine = _flat(ref), _flat(mine)
        assert set(ref) == set(mine)
        for k in ref:
            assert mine[k].axes == ref[k].axes, k


# ----------------------------------------------------------------------------
# rule tables
# ----------------------------------------------------------------------------
LOGICAL = ("batch", "fsdp", "tp", "expert", "kv_seq", "seq", "layers", None)


@pytest.mark.parametrize("name", ["SERVE_RULES", "SINGLE_POD_RULES",
                                  "MULTI_POD_RULES"])
def test_rule_tables_and_pspecs_equal_jax(name):
    ref, mine = getattr(jax_axes, name), getattr(port_axes, name)
    assert mine.table == ref.table
    for axes in itertools.product(LOGICAL, repeat=2):
        assert mine.pspec(axes) == tuple(ref.pspec(axes)), axes
    assert mine.replace(tp=None).table == ref.replace(tp=None).table


def _meshes():
    devs = np.asarray(jax.devices()[:2])
    return [Mesh(devs, ("model",)), Mesh(devs.reshape(2, 1), ("data",
                                                              "model")),
            Mesh(devs.reshape(1, 1, 2), ("pod", "data", "model"))]


def test_rules_for_mesh_and_sanitize_pspec_equal_jax():
    for mesh in _meshes():
        shape = dict(zip(mesh.axis_names, mesh.devices.shape))
        assert port_axes.rules_for_mesh(mesh.axis_names).table == \
            jax_axes.rules_for_mesh(mesh).table
        entries = [None] + list(mesh.axis_names) + [tuple(mesh.axis_names)]
        for spec in itertools.product(entries, repeat=2):
            for dims in ((2, 3), (4, 1), (6, 8), (1, 2)):
                ref = jax_axes.sanitize_pspec(PartitionSpec(*spec), dims,
                                              mesh)
                assert port_axes.sanitize_pspec(spec, dims, shape) == \
                    tuple(ref), (mesh.axis_names, spec, dims)


# ----------------------------------------------------------------------------
# leaf pspecs and each rank's bytes
# ----------------------------------------------------------------------------
_PARAMS = {}


def host_weights(arch, seed=0):
    """Float weights of `arch` drawn with numpy from `seed`: the JAX
    parameter tree as numpy f32 arrays."""
    jm = JaxLM(jax_config(arch))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.2 * rng.standard_normal(s.shape)).astype(np.float32),
        jm.param_specs(), is_leaf=is_spec)


def packed(host, group):
    """`host` packed at INT4 in groups of `group` (the port's
    `quantize_params`, whose bytes equal JAX's, tests/test_torch_kernels
    .py; JAX's op-by-op quantizer would compile for every leaf shape),
    as (the JAX tree with JAX QTensors, the numpy tree
    `convert.from_numpy_tree` takes)."""
    port = quantize_params(from_numpy_tree(host), bits=4, group=group)

    def walk(t):
        if isinstance(t, dict):
            pairs = {k: walk(v) for k, v in t.items()}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        if isinstance(t, QTensor):
            d = {"data": t.data.numpy(), "scales": t.scales.numpy(),
                 "bits": t.bits, "group": t.group, "axis": t.axis,
                 "orig_shape": tuple(t.orig_shape)}
            return JaxQTensor(jnp.asarray(d["data"]),
                              jnp.asarray(d["scales"]), t.bits, t.group,
                              t.axis, d["orig_shape"]), d
        return jnp.asarray(t.numpy()), t.numpy()
    return walk(port)


def _params(arch, precision):
    """(jax specs, jax params, port specs, port params), built once."""
    key = (arch["name"], precision)
    if key not in _PARAMS:
        host = host_weights(arch)
        if precision == "int4":
            jp, host = packed(host, 8 if arch is REPLICATED_LEAF else 16)
        else:
            jp = jax.tree_util.tree_map(jnp.asarray, host)
        _PARAMS[key] = (JaxLM(jax_config(arch)).param_specs(), jp,
                        DecoderLM(port_config(arch)).param_specs(),
                        from_numpy_tree(host))
    return _PARAMS[key]


CASES = [(_smoke_kw("qwen2.5-3b"), "fp"), (_smoke_kw("qwen2.5-3b"), "int4"),
         (_smoke_kw("gemma3-4b"), "fp"), (_smoke_kw("gemma3-4b"), "int4"),
         (REPLICATED_LEAF, "int4"),
         (_smoke_kw("qwen3-moe-235b-a22b"), "fp"),
         (_smoke_kw("qwen3-moe-235b-a22b"), "int4"),
         (_smoke_kw("deepseek-v2-lite-16b"), "fp"),
         (_smoke_kw("deepseek-v2-lite-16b"), "int4")]


def _jax_leaves(jspecs, jp, mesh):
    """{path: (jax leaf, its sharding)}; a QTensor's sharding is the
    QTensor of its data / scales shardings."""
    shards = _flat(qtree_shardings(jspecs, jp, mesh, jax_axes.SERVE_RULES))
    return {k: (leaf, shards[k]) for k, leaf in _flat(jp).items()}


@pytest.mark.parametrize("arch,precision", CASES,
                         ids=[f"{a['name']}-{p}" for a, p in CASES])
def test_leaf_pspec_equals_qtree_shardings(arch, precision):
    jspecs, jp, tspecs, tp = _params(arch, precision)
    mesh = serve_mesh(2)
    flat_specs, flat_tp = _flat(tspecs), _flat(tp)
    replicated_rows = []
    for k, (leaf, sh) in _jax_leaves(jspecs, jp, mesh).items():
        want = sh.data.spec if isinstance(leaf, JaxQTensor) else sh.spec
        got = leaf_pspec(flat_specs[k], flat_tp[k], 2)
        assert got == tuple(want), k
        if isinstance(leaf, JaxQTensor):
            assert tuple(sh.scales.spec) == tuple(want), k
            if flat_specs[k].axes[-2] == "tp" and got[-2] is None:
                replicated_rows.append(k)
    # the replicated-leaf config is what its name says: JAX (and the
    # port) keep its packed w_down whole on each rank
    assert ("/blocks/ffn/w_down" in replicated_rows) == \
        (arch is REPLICATED_LEAF)


@pytest.mark.parametrize("arch,precision", [CASES[1], CASES[3], CASES[4],
                                            *CASES[5:]],
                         ids=lambda a: a["name"] if isinstance(a, dict)
                         else a)
def test_each_ranks_shard_is_the_bytes_jax_puts_on_its_device(arch,
                                                              precision):
    jspecs, jp, tspecs, tp = _params(arch, precision)
    mesh = serve_mesh(2)
    devices = list(mesh.devices.flat)
    ranks = [_flat(shard_tree(tp, tspecs, r, 2)) for r in range(2)]

    def check(arr, sharding, mine, what):
        placed = jax.device_put(arr, sharding)
        for shard in placed.addressable_shards:
            r = devices.index(shard.device)
            want = np.asarray(shard.data)
            got = mine[r].numpy()
            assert got.shape == want.shape and got.tobytes() == \
                want.tobytes(), what
            assert mine[r].is_contiguous()

    for k, (leaf, sh) in _jax_leaves(jspecs, jp, mesh).items():
        mine = [ranks[r][k] for r in range(2)]
        if isinstance(leaf, JaxQTensor):
            assert all(isinstance(m, QTensor) for m in mine)
            check(leaf.data, sh.data, [m.data for m in mine], k + " data")
            check(leaf.scales, sh.scales, [m.scales for m in mine],
                  k + " scales")
            assert mine[0].orig_shape == tuple(
                n // 2 if e else n
                for n, e in zip(leaf.orig_shape, sh.data.spec)), k
        else:
            check(leaf, sh, mine, k)


def test_shard_specs_gives_the_ranks_pool_heads():
    tm = DecoderLM(get_config("qwen2.5-3b"))
    pools = shard_specs(tm.decode_state_specs(4, 32, 16, torch.int8)
                        ["paged"], 2)["attn"]
    assert pools["k"].shape == (36, 33, 16, 1, 128)
    assert pools["k_scale"].shape == (36, 33, 16, 1)


# ----------------------------------------------------------------------------
# validate_tp
# ----------------------------------------------------------------------------
VALIDATE = [("qwen2.5-3b", {}, 2), ("qwen2.5-3b", {}, 4),
            ("qwen2.5-3b", {}, 3), ("qwen2.5-3b", {"d_ff": 129}, 2),
            ("qwen2.5-3b", {}, 1),
            ("deepseek-v2-lite-16b", {}, 4),
            ("deepseek-v2-lite-16b", {"n_heads": 6}, 4),
            ("qwen3-moe-235b-a22b", {}, 2),
            ("xlstm-1.3b", {}, 8)]


@pytest.mark.parametrize("arch_id,kw,tp", VALIDATE)
def test_validate_tp_raises_where_jax_does_with_its_message(arch_id, kw,
                                                            tp):
    jcfg = jax_smoke(arch_id).replace(**kw)
    tcfg = get_smoke_config(arch_id).replace(**kw)
    if arch_id == "qwen3-moe-235b-a22b":        # an expert width of 90
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    d_ff_expert=90))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                    d_ff_expert=90))
        tp = 4
    errs = []
    for model in (JaxLM(jcfg), DecoderLM(tcfg)):
        try:
            model.validate_tp(tp)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    assert (errs[0] is None) == ((arch_id, tp) in (
        ("qwen2.5-3b", 2), ("qwen2.5-3b", 1),
        ("deepseek-v2-lite-16b", 4)) and not kw)


# ----------------------------------------------------------------------------
# the kernels' host plans at one rank's shapes (qwen2.5-3b, tp = 2)
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("m", (1, 4, 20))
def test_kernel_plans_take_the_rank_shapes(m):
    cfg = get_config("qwen2.5-3b")
    tp, hd = 2, cfg.hd()
    H, G, F = cfg.n_heads * hd // tp, cfg.n_kv_heads * hd // tp, \
        cfg.d_ff // tp
    d = cfg.d_model
    # (name, layout, K, N, group): the groups the full leaf was packed
    # with, which a rank's slice keeps
    calls = [("wq", "cols", d, H, _pick_group(d, 128, 16)),
             ("wk", "cols", d, G, _pick_group(d, 128, 16)),
             ("wo", "cols", H, d, _pick_group(H * tp, 128, 16)),
             ("w_down", "cols", F, d, _pick_group(cfg.d_ff, 128, 16)),
             ("table", "table", d, cfg.vocab // tp, _pick_group(d, 128, 16))]
    assert [c[2:] for c in calls] == [(2048, 1024, 128), (2048, 128, 128),
                                      (1024, 2048, 128), (5504, 2048, 86),
                                      (2048, 75968, 128)]
    for name, layout, k, n, group in calls:
        assert k % group == 0, name
        stored = k // 2
        plan = cg.split_plan(layout, m, stored, n, 4, 132)
        assert plan.mt == min(4, m)
        assert cg.smem_bytes(layout, plan, m, k, 4, group) <= cg.SMEM_MAX
        if layout == "cols":
            rows = [p for sp in range(plan.splits)
                    for b, e in cg.lane_rows(plan, sp, stored)
                    for p in range(b, e)]
            assert rows == list(range(stored)), name
            assert plan.blocks == -(-n // cg.TN) * plan.splits
        else:
            assert plan.blocks == min(132, -(-n // cg.TBL_VB))
    plan = sw.split_plan(m, d // 2, F, 4, 128, 132)
    assert -(-F // sw.TN) == 43
    assert sw.smem_bytes(plan, m, 4, 128) <= sw.SMEM_MAX
    assert (plan.splits - 1) * plan.rows < d // 2 <= plan.splits * plan.rows
    # split-KV at g 1, qpk 8, hd 128: batch 4 over 128 keys of 16-key
    # pages (a decode step) and a 5-row verify window
    n_split, chunk = sd.plan_splits(4 * sd.q_groups(8), 128, 16)
    assert chunk % 16 == 0 and (n_split - 1) * chunk < 128 <= \
        n_split * chunk
    n_split, chunk = sd.plan_verify(4, 5 * 8, 128, 16)
    assert chunk % 16 == 0 and (n_split - 1) * chunk < 128 <= \
        n_split * chunk
    assert sd.smem_bytes(1, 128) <= 226 * 1024


# ----------------------------------------------------------------------------
# the MoE and MLA configs: validate_tp, and the kernels' host plans at one
# rank's shapes (qwen3-moe-235b-a22b and deepseek-v2-lite-16b, tp = 2)
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id,tp", [
    ("qwen3-moe-235b-a22b", 2), ("qwen3-moe-235b-a22b", 4),
    ("qwen3-moe-235b-a22b", 8), ("deepseek-v2-lite-16b", 2),
    ("deepseek-v2-lite-16b", 8), ("deepseek-v2-lite-16b", 32)])
def test_validate_tp_of_the_full_moe_and_mla_configs(arch_id, tp):
    """qwen3-moe's 4 kv heads stop it at tp = 8; deepseek's MLA has no kv
    head dim to divide (8 passes), its 16 heads stop it at 32."""
    from repro.configs import get_config as jax_get_config
    errs = []
    for model in (JaxLM(jax_get_config(arch_id)),
                  DecoderLM(get_config(arch_id))):
        try:
            model.validate_tp(tp)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    bad = {("qwen3-moe-235b-a22b", 8): "n_kv_heads=4",
           ("deepseek-v2-lite-16b", 32): "n_heads=16"}.get((arch_id, tp))
    assert (errs[1] is None) == (bad is None)
    if bad:
        assert bad in errs[1]


@pytest.mark.parametrize("m", (1, 4, 20))
def test_kernel_plans_take_the_moe_and_mla_rank_shapes(m):
    """One rank of two: qwen3-moe's projections (64 heads, 4 kv heads of
    128) and 64-expert stacks, deepseek's MLA projections (8 heads of
    192, wo 1024 -> 2048), its 32-expert stacks and shared experts, and
    layer 0's dense FFN (5472 columns, w_down 48 of its 96 groups of
    114); the stacks at a decode step's capacity (8 rows an expert) and
    a 64-token chunk's; split-KV at g 2, qpk 16."""
    tp = 2
    q3m, ds = get_config("qwen3-moe-235b-a22b"), get_config(
        "deepseek-v2-lite-16b")
    d, hd = q3m.d_model, q3m.hd()
    fe = q3m.moe.d_ff_expert
    m_ = ds.mla
    H = ds.n_heads // tp
    qk, vd = m_.qk_nope_head_dim + m_.qk_rope_head_dim, m_.v_head_dim
    dd, fs = ds.d_model, ds.moe.d_ff_expert * ds.moe.n_shared_experts
    g = _pick_group
    # (name, K, N, group): the full leaf's group, which the slice keeps
    calls = [("q3m wq", d, q3m.n_heads * hd // tp, g(d, 128, 16)),
             ("q3m wk", d, q3m.n_kv_heads * hd // tp, g(d, 128, 16)),
             ("q3m wo", q3m.n_heads * hd // tp, d,
              g(q3m.n_heads * hd, 128, 16)),
             ("q3m head", d, q3m.vocab // tp, g(d, 128, 16)),
             ("ds wq", dd, H * qk, g(dd, 128, 16)),
             ("ds w_dkv", dd, m_.kv_lora_rank + m_.qk_rope_head_dim,
              g(dd, 128, 16)),
             ("ds wo", H * vd, dd, g(ds.n_heads * vd, 128, 16)),
             ("ds ws_gate", dd, fs // tp, g(dd, 128, 16)),
             ("ds ws_down", fs // tp, dd, g(fs, 128, 16)),
             ("ds w_down", ds.d_ff // tp, dd, g(ds.d_ff, 128, 16)),
             ("ds head", dd, ds.vocab // tp, g(dd, 128, 16))]
    assert [c[1:] for c in calls] == [
        (4096, 4096, 128), (4096, 256, 128), (4096, 4096, 128),
        (4096, 75968, 128), (2048, 1536, 128), (2048, 576, 128),
        (1024, 2048, 128), (2048, 1408, 128), (1408, 2048, 88),
        (5472, 2048, 114), (2048, 51200, 128)]
    for name, k, n, group in calls:
        assert k % group == 0, name
        stored = k // 2
        plan = cg.split_plan("cols", m, stored, n, 4, 132)
        assert plan.mt == min(4, m)
        assert cg.smem_bytes("cols", plan, m, k, 4, group) <= cg.SMEM_MAX
        rows = [p for sp in range(plan.splits)
                for b, e in cg.lane_rows(plan, sp, stored)
                for p in range(b, e)]
        assert rows == list(range(stored)), name
        assert plan.blocks == -(-n // cg.TN) * plan.splits
    # the expert stacks: E / tp experts a rank, one expert's shape as at
    # tp = 1; C rows an expert (8 at a decode step, m here beside it)
    stacks = [("q3m we_gate", q3m.moe.n_experts // tp, d, fe, g(d, 128, 16)),
              ("q3m we_down", q3m.moe.n_experts // tp, fe, d,
               g(fe, 128, 16)),
              ("ds we_gate", ds.moe.n_experts // tp, dd,
               ds.moe.d_ff_expert, g(dd, 128, 16)),
              ("ds we_down", ds.moe.n_experts // tp, ds.moe.d_ff_expert,
               dd, g(ds.moe.d_ff_expert, 128, 16))]
    assert [s[1:] for s in stacks] == [(64, 4096, 1536, 128),
                                       (64, 1536, 4096, 96),
                                       (32, 2048, 1408, 128),
                                       (32, 1408, 2048, 88)]
    for name, E, k, n, group in stacks:
        for c in (8, m):
            plan = cg.stack_plan(c, k // 2, n, 4, E, 132)
            assert plan.mt == min(4, c)
            assert cg.smem_bytes("cols", plan, c, k, 4, group) \
                <= cg.SMEM_MAX, name
            assert plan.splits == 1 or E * -(-n // cg.TN) <= cg.MAX_TILES
            assert plan.blocks == -(-n // cg.TN) * plan.splits
    # layer 0's fused gate / up: 5472 columns a rank, F % 4 == 0
    F = ds.d_ff // tp
    assert F % 4 == 0 and -(-F // sw.TN) == 43
    plan = sw.split_plan(m, dd // 2, F, 4, 128, 132)
    assert sw.smem_bytes(plan, m, 4, 128) <= sw.SMEM_MAX
    assert (plan.splits - 1) * plan.rows < dd // 2 <= plan.splits * plan.rows
    # qwen3-moe's paged attention: 2 kv heads a rank, 16 queries each
    qpk = q3m.n_heads // q3m.n_kv_heads
    assert (q3m.n_kv_heads // tp, qpk) == (2, 16)
    n_split, chunk = sd.plan_splits(4 * 2 * sd.q_groups(qpk), 128, 16)
    assert chunk % 16 == 0 and (n_split - 1) * chunk < 128 <= \
        n_split * chunk
    n_split, chunk = sd.plan_verify(4 * 2, 5 * qpk, 128, 16)
    assert chunk % 16 == 0 and (n_split - 1) * chunk < 128 <= \
        n_split * chunk
    assert sd.smem_bytes(1, 128) <= 226 * 1024
