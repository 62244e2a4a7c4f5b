"""The hybrid family in the PyTorch port vs the JAX package, on the CPU:
zamba (Mamba2 groups, each followed by one invocation of a shared
attention + MLP block with per-site LoRA deltas and a gated output
projection, then trailing Mamba2 layers).

The hybrid config of `tests/test_serve_state.py` (4 layers, shared_every
2: two groups, no tail) and the smoke config (5 layers: two groups and
a tail layer), weights drawn by JAX with every `lora_b` drawn nonzero
(its init is zeros, which would hide the LoRA term), carried across with
`repro_torch.convert`; numpy inputs from a seed.  Covered:
`zamba_shared_block_paged` and its pools, teacher-forced `serve_step`
logits and every state leaf, greedy engine streams, preemption (a
hybrid re-prefills: no snapshot), the pools at the shared block's shape
and the arena at full width, which packed leaves go to the kernels, and
the steps under the capture guard.

Tolerances (relative, logits to max(1, max|logit|)), as in
tests/test_torch_recurrent.py:
  * STEP_TOL = 1e-5 with f32 or INT4 weights and f32 KV: the port
    computes x W + (x A) B where JAX merges A B into W (a linear
    identity: sums in another order), and hoists the conv over the
    chunk; measured up to 1.1e-6.  For INT4, JAX is fed the shared
    q/k/v pre-dequantized to f32 as plain arrays.
  * INT8 KV: KV_TOL = 2e-3 on logits, as tests/test_torch_model.py (a
    K/V value one ulp from a rounding boundary lands one int8 step
    apart); the pools are not compared.
  * BF16_ROUTE_TOL = 2e-2 against JAX's own route, which dequantizes
    the shared q/k/v to bf16 and adds the LoRA product in bf16 in every
    call; measured 1.7e-3 on logits.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models.blocks import zamba_shared_block_paged as jax_shared_block
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxRequest

from repro_torch.configs import get_config
from repro_torch.models import DecoderLM
from repro_torch.models import attention as tattn
from repro_torch.models.blocks import (zamba_shared_block_paged,
                                       zamba_shared_cfg)
from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest

from test_torch_graphs import CaptureGuard
from test_torch_recurrent import (BF16_ROUTE_TOL, STEP_TOL, _geom, _prompts,
                                  jax_layer, kernel_leaves, logit_err, pair,
                                  port_state, rel, serve_both, step_both)

KV_TOL = 2e-3


def jax_layer_drop(a):
    """Drop group 0 of a JAX leaf stacked over groups: `jax_layer` then
    takes group 1."""
    from repro.quant.qarray import QTensor as JaxQTensor
    if isinstance(a, JaxQTensor):
        return JaxQTensor(a.data[1:], a.scales[1:], a.bits, a.group, a.axis,
                          (a.orig_shape[0] - 1,) + a.orig_shape[1:])
    return a[1:]


# ----------------------------------------------------------------------------
# the shared block
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("precision,tol", [("fp", STEP_TOL),
                                           ("int4f32", STEP_TOL),
                                           ("int4", BF16_ROUTE_TOL)])
def test_shared_block_matches_jax_with_nonzero_lora(precision, tol):
    """One invocation (group 1's LoRA) over a padded prefill chunk of
    lanes at other lengths, then a decode step: the block's output on
    every valid row and the K/V pools it wrote."""
    jm, jp, tm, tp = pair("zamba", precision)
    assert float(np.abs(np.asarray(jp["lora"]["lora_b_q"])).max()) > 0.1
    jcfg, tcfg = jm.cfg, tm.cfg
    jlora = {k: jax_layer(jax_layer_drop(v), 1)
             for k, v in jp["lora"].items()}
    tlora = tm._stack_views(tp["lora"], "lora")[1]
    b, n_pages, ps, max_pages = 3, 12, 4, 4
    shared_cfg = zamba_shared_cfg(tcfg)
    hd, g = shared_cfg.hd(), shared_cfg.n_kv_heads
    jpool = {k: jnp.zeros((n_pages, ps, g, hd), jnp.float32)
             for k in ("k", "v")}
    tpool = {k: torch.zeros(n_pages + 1, ps, g, hd) for k in ("k", "v")}
    rng = np.random.default_rng(5)
    tables = rng.permutation(n_pages).reshape(b, max_pages).astype(np.int32)
    lengths = np.array([0, 3, 9], np.int32)
    err = 0.0
    for s, n_new in ((5, [5, 2, 0]), (1, [1, 1, 1])):
        x = rng.standard_normal((b, s, 32)).astype(np.float32)
        n_new = np.asarray(n_new, np.int32)
        jy, jpool = jax_shared_block(
            jp["shared"], jlora, jcfg, jnp.asarray(x), jpool,
            jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(n_new))
        t = [torch.from_numpy(a) for a in (tables, lengths, n_new)]
        rows = tattn.page_rows(*t, s, ps, dump_page=n_pages)
        rope = tattn.rope_by_theta(shared_cfg, rows.slots, [False])[
            shared_cfg.rope_theta]
        ty = zamba_shared_block_paged(tp["shared"], tlora, tcfg,
                                      torch.from_numpy(x), tpool, *t, rows,
                                      rope)
        for i in range(b):
            if n_new[i]:
                err = max(err, rel(ty[i, :n_new[i]].numpy(),
                                   np.asarray(jy[i, :n_new[i]])))
        lengths = lengths + n_new
    for k in ("k", "v"):
        err = max(err, rel(tpool[k][:-1].numpy(), np.asarray(jpool[k])))
    assert err <= tol, err
    if precision == "int4":
        assert err > STEP_TOL          # the bf16 rounding is real


# ----------------------------------------------------------------------------
# whole steps
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("precision,kv,tol", [
    ("fp", "f32", STEP_TOL), ("int4f32", "f32", STEP_TOL),
    ("fp", "int8", KV_TOL), ("int4f32", "int8", KV_TOL),
    ("int4", "f32", BF16_ROUTE_TOL)])
def test_serve_step_logits_and_state_match_jax(precision, kv, tol):
    step_both("zamba", precision, kv=kv, tol=tol)


@pytest.mark.parametrize("precision", ["fp", "int4f32"])
def test_engine_streams_match_jax_and_single_requests(precision):
    geom = _geom(precision="fp" if precision == "fp" else "int4",
                 kv_dtype="int8")
    jreqs, treqs, eng = serve_both("zamba", geom, _prompts(),
                                   precision=precision)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(r.done and len(r.out_tokens) == 6 for r in treqs)
    _, _, tm, tp = pair("zamba", precision)
    for req in treqs[:2]:
        solo = ServeRequest(prompt=np.asarray(req.prompt), max_new_tokens=6)
        PagedServeEngine(tm, tp, ServeConfig(**geom), device="cpu").run(
            [solo])
        assert solo.out_tokens == req.out_tokens
    assert eng.cache.n_free_or_cached() == eng.cache.allocator.n_pages
    assert set(eng.cache.pools) == {"attn"} and eng.prefix is None


def test_preempted_hybrid_lane_reprefills_as_jax():
    """A hybrid loses its pages at preemption, so it requeues with its
    prompt plus what it generated and rebuilds by prefill (a restored
    Mamba2 state would be advanced twice): no snapshot is taken, and
    the streams equal JAX's in the same tight pool and the unpreempted
    run's."""
    prompt = np.arange(1, 9, dtype=np.int32)
    jm, jp, tm, tp = pair("zamba", "fp")
    geom = dict(precision="fp", max_batch=2, max_seq=64, page_size=4,
                prefill_chunk=8)

    def port(n_pages):
        eng = PagedServeEngine(tm, tp, ServeConfig(**geom, n_pages=n_pages),
                               device="cpu")
        saves = []
        save = eng.arena.save_lane
        eng.arena.save_lane = lambda lane: saves.append(lane) or save(lane)
        reqs = [ServeRequest(prompt=prompt.copy(), max_new_tokens=10,
                             rid=i) for i in range(2)]
        eng.run(reqs)
        return reqs, eng, saves
    tight, eng, saves = port(8)
    assert not saves and any(r.prompt_folded for r in tight)
    assert eng.cache.n_free_or_cached() == 8
    roomy, _, _ = port(None)
    jreqs = [JaxRequest(prompt=prompt.copy(), max_new_tokens=10, rid=i)
             for i in range(2)]
    JaxEngine(jm, jp, JaxServeConfig(**geom, n_pages=8)).run(jreqs)
    for a, b, c in zip(tight, roomy, jreqs):
        assert a.out_tokens == c.out_tokens
        assert a.out_tokens[:len(b.out_tokens)] == b.out_tokens


# ----------------------------------------------------------------------------
# full width: pools, arena, groups (specs only, nothing allocated)
# ----------------------------------------------------------------------------
def _spec_bytes(tree):
    if isinstance(tree, dict):
        return sum(_spec_bytes(v) for v in tree.values())
    return int(np.prod(tree.shape)) * torch.empty(
        0, dtype=tree.dtype).element_size()


def test_full_width_state_at_the_shared_block_shape():
    """zamba2-7b at 27 layers (4 groups of 6 + 3 tail layers), served
    with f32 activations as the launcher and chip_smoke serve it: 4 paged
    pools of 32 kv heads x hd 112; an arena of 207.6 MB at 4 lanes (27 x
    4 x (112 x 64 x 64 f32 + 3 x 7296 conv rows, promoted to f32));
    xlstm-1.3b's 2.82 GB of mLSTM memory C at 4 lanes (42 x 4 x 4 x
    1024^2 f32) and no pool."""
    zm = DecoderLM(get_config("zamba2-7b").replace(n_layers=27,
                                                  dtype="float32"))
    assert zm._groups() == (4, 6, 3) and zm.n_paged_layers() == 4
    pools = zm.paged_cache_specs(64, 16, torch.int8)["attn"]
    assert pools["k"].shape == (4, 65, 16, 32, 112)
    assert pools["k_scale"].shape == (4, 65, 16, 32)
    arena = zm.arena_state_specs(4)
    assert _spec_bytes(arena) == 27 * 4 * (112 * 64 * 64 * 4 + 3 * 7296 * 4)
    xm = DecoderLM(get_config("xlstm-1.3b").replace(dtype="float32"))
    xa = xm.arena_state_specs(4)
    assert xa["mlstm"]["C"].shape == (6, 7, 4, 4, 1024, 1024)
    assert _spec_bytes(xa["mlstm"]["C"]) == 42 * 4 * 4 * 1024 * 1024 * 4
    assert xm.paged_cache_specs(64, 16, torch.int8) == {}


# ----------------------------------------------------------------------------
# the kernel rule and the capture guard
# ----------------------------------------------------------------------------
def test_every_packed_leaf_goes_to_a_kernel(monkeypatch):
    """The shared q/k/v go to cim_gemv with their LoRA delta added after
    (never merged into a dequantized weight), with every Mamba2
    projection, the LoRA out_proj, the MLP (swiglu_qgemv, w_down) and
    the head, in a decode step and a prefill chunk; nothing is
    dequantized whole."""
    _, _, tm, tp = pair("zamba", "int4")
    for s in (1, 5):
        seen, want, full = kernel_leaves(tm, tp, monkeypatch, s)
        assert want and seen == want and full == 0


@pytest.mark.parametrize("kind", ["xlstm", "zamba", "mamba2"])
@pytest.mark.parametrize("s", [1, 8])
def test_steps_are_capturable(kind, s):
    """A recurrent step reads nothing to the host and makes no tensor
    from host values (`CaptureGuard`), prefill chunk and decode alike."""
    _, _, tm, tp = pair(kind, "int4")
    state = port_state(tm, 3, 12, 4, torch.int8)
    tables = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    lengths = torch.tensor([0, 6, 3], dtype=torch.int32)
    n_new = torch.tensor([0, s, max(1, s - 2)], dtype=torch.int32)
    tokens = torch.arange(3 * s, dtype=torch.int32).reshape(3, s) % 64
    with CaptureGuard():
        logits, _ = tm.serve_step(tp, state, {"tokens": tokens}, tables,
                                  lengths, n_new)
    assert logits.shape == (3, s, 64) and bool(torch.isfinite(logits).all())


def test_smoke_config_serves_groups_and_a_tail():
    """The smoke config (5 layers at shared_every 2: two groups and one
    tail layer) against JAX teacher-forced, as the launcher builds it."""
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import DecoderLM as JaxLM
    from repro.models import init_params as jax_init
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import from_numpy_tree
    from test_torch_model import _to_numpy
    from test_torch_recurrent import jax_state
    jm = JaxLM(jax_smoke("zamba2-7b").replace(dtype="float32", remat=False))
    tm = DecoderLM(get_smoke_config("zamba2-7b").replace(dtype="float32",
                                                         remat=False))
    assert tm._groups() == (2, 2, 1)
    jp = jax_init(jm.param_specs(), jax.random.PRNGKey(3),
                  dtype_override=jnp.float32)
    tp = from_numpy_tree(_to_numpy(jp))
    js, ts = jax_state(jm, 2, 8, 4), port_state(tm, 2, 8, 4)
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    lengths = np.zeros(2, np.int32)
    rng = np.random.default_rng(9)
    for s, n_new in ((7, [7, 4]), (1, [1, 1]), (1, [1, 0])):
        tok = rng.integers(0, 128, (2, s)).astype(np.int32)
        n_new = np.asarray(n_new, np.int32)
        jl, js = jm.serve_step(jp, js, {"tokens": jnp.asarray(tok)},
                               jnp.asarray(tables), jnp.asarray(lengths),
                               jnp.asarray(n_new))
        tl, _ = tm.serve_step(tp, ts, {"tokens": torch.from_numpy(tok)},
                              torch.from_numpy(tables),
                              torch.from_numpy(lengths),
                              torch.from_numpy(n_new))
        for i in range(2):
            if n_new[i]:
                assert logit_err(tl[i, :n_new[i]].numpy(),
                                 np.asarray(jl[i, :n_new[i]])) <= STEP_TOL
        lengths = lengths + n_new
