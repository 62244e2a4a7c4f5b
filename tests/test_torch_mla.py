"""Multi-head latent attention (MLA) in the PyTorch port vs the JAX
package, on the CPU.

deepseek-v2-lite-16b's config copy and parameter tree; `convert` of the
MLA leaves (`w_dkv`, `ckv_norm`, `w_uk`, `w_uv`); `mla_paged_step`
against JAX's over a prefill chunk, decode steps and verify windows of
lanes at other lengths with padding rows, its output and its latent
pools; teacher-forced `serve_step` / `paged_verify_step` logits of the
smoke model (3 layers: a leading dense layer, then MoE with one shared
expert); greedy, n-gram, fork / copy-on-write and preemption streams and
the cost model's `sim_*` keys against JAX's `PagedServeEngine`; the int8
refusal and the `auto` -> bf16 pin; the absorbed-weight exception
(`w_uk` / `w_uv` dequantized to bf16 in every step, every other packed
projection through `cim_gemv` / `swiglu_qgemv`); the steps under the
capture guard; the launcher.

Same weights in both packages (drawn by JAX, carried across with
`repro_torch.convert`), same numpy inputs.  Tolerances, relative to the
largest |value| of the reference (logits: to max(1, max|logit|) of the
step):
  * f32 latent pools, float or INT4 weights: STEP_TOL = 1e-4 on the MLA
    step's output and the step logits (sums in another order; measured
    up to 5.7e-7 on the step, 7.1e-7 on logits), POOL_TOL = 1e-5 on the
    pools (measured 2.5e-7).
  * bf16 latent pools: BF16_TOL = 2e-3.  Both packages round the new
    rows and the probabilities to bf16 and take the latent product of
    bf16 operands (`w.astype(c_all.dtype)`), so a value one f32 ulp from
    a bf16 rounding boundary lands one bf16 ulp (2^-8 relative) apart;
    measured up to 3.8e-7 on the step and 2.0e-4 on logits (INT4).  The
    pools are held at one bf16 ulp of their largest value, 2^-8
    (measured 4.6e-6).
  * A logits row past its tolerance is allowed only at a router
    near-tie (`test_torch_moe._RouterLog`), as in tests/test_torch_moe.py.
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
from repro.models import DecoderLM as JaxLM
from repro.models import MLAConfig as JaxMLA
from repro.models import init_params as jax_init
from repro.models.attention import mla_paged_step as jax_mla_step
from repro.models.common import spec_structs
from repro.quant.ptq import quantize_params as jax_quantize_params
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxRequest
from repro.spec import SpecConfig as JaxSpecConfig

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import ops
from repro_torch.models import DecoderLM, MLAConfig
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.quant import qarray
from repro_torch.quant.qarray import QTensor
from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest
from repro_torch.serve.paged_cache import _copy_pool_pages
from repro_torch.spec import SpecConfig

from test_torch_graphs import CaptureGuard
from test_torch_model import _to_numpy
from test_torch_moe import _RouterLog

ARCH = "deepseek-v2-lite-16b"
STEP_TOL = 1e-4
POOL_TOL = 1e-5
BF16_TOL = 2e-3
_KV = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
_PAIRS = {}


def _pair(precision):
    """(jax model, jax params, port model, port params) of the smoke
    config, built once; precision fp, int4 or int8 (groups of 128, as
    the engine packs)."""
    if precision not in _PAIRS:
        jcfg = jax_get_smoke_config(ARCH).replace(dtype="float32",
                                                  remat=False)
        tcfg = get_smoke_config(ARCH).replace(dtype="float32", remat=False)
        jm = JaxLM(jcfg)
        jp = jax_init(jm.param_specs(), jax.random.PRNGKey(0),
                      dtype_override=jnp.float32)
        if precision != "fp":
            jp = jax_quantize_params(jp, bits=int(precision[3:]), group=128)
        _PAIRS[precision] = (jm, jp, DecoderLM(tcfg),
                             from_numpy_tree(_to_numpy(jp)))
    return _PAIRS[precision]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def _np(t):
    """A port tensor (bf16 too) as float64 numpy."""
    return t.detach().to(torch.float32).numpy().astype(np.float64)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


# ----------------------------------------------------------------------------
# configs, parameter trees, convert
# ----------------------------------------------------------------------------
def test_config_copies_equal_jax_field_for_field():
    for mine, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        assert {f.name for f in dataclasses.fields(mine)} == \
            {f.name for f in dataclasses.fields(ref)}
        for f in dataclasses.fields(ref):
            if f.name not in ("mla", "moe"):
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert isinstance(mine.mla, MLAConfig)
        assert dataclasses.asdict(mine.mla) == dataclasses.asdict(ref.mla)
        assert dataclasses.asdict(mine.moe) == dataclasses.asdict(ref.moe)
    assert {f.name for f in dataclasses.fields(MLAConfig)} == \
        {f.name for f in dataclasses.fields(JaxMLA)}
    assert dataclasses.asdict(MLAConfig()) == dataclasses.asdict(JaxMLA())
    assert get_config(ARCH).mla.q_lora_rank == 0


@pytest.mark.parametrize("arch", ["full", "smoke"])
def test_param_tree_and_pools_match_jax(arch):
    """The same parameter tree (MLA's six leaves in both stacks, a dense
    FFN of first_dense_d_ff in `first_blocks`) and the same latent pools
    but for the port's dump page."""
    get = {"full": (jax_get_config, get_config),
           "smoke": (jax_get_smoke_config, get_smoke_config)}[arch]
    jm, tm = JaxLM(get[0](ARCH)), DecoderLM(get[1](ARCH))
    assert _shapes(tm.param_specs()) == _shapes(jm.param_specs())
    attn = tm.param_specs()["blocks"]["attn"]
    assert set(attn) == {"wq", "w_dkv", "ckv_norm", "w_uk", "w_uv", "wo"}
    m, H = tm.cfg.mla, tm.cfg.n_heads
    assert attn["w_uk"].shape[1:] == (m.kv_lora_rank,
                                      H * m.qk_nope_head_dim)
    n_pages, ps = 6, 4
    jpools = jm.paged_cache_specs(n_pages, ps, jnp.bfloat16)
    tpools = tm.paged_cache_specs(n_pages, ps, torch.bfloat16)
    assert set(tpools) == set(jpools) == {"attn", "attn_first"}
    for name in jpools:
        assert set(tpools[name]) == set(jpools[name]) == {"c_kv", "k_rope"}
        for k, v in jpools[name].items():
            L, n, *rest = v.shape
            assert tpools[name][k].shape == (L, n + 1, *rest)
            assert tpools[name][k].dtype == torch.bfloat16


@pytest.mark.parametrize("precision", ["int4", "int8"])
def test_convert_carries_mla_leaves_byte_for_byte(precision):
    _, jp, _, tp = _pair(precision)
    bits = int(precision[3:])
    for stack in ("first_blocks", "blocks"):
        ja, ta = jp[stack]["attn"], tp[stack]["attn"]
        for name in ("wq", "w_dkv", "w_uk", "w_uv", "wo"):
            j, t = ja[name], ta[name]
            assert isinstance(t, QTensor) and t.bits == j.bits == bits
            assert (t.group, t.axis, t.orig_shape) == (j.group, j.axis,
                                                       j.orig_shape)
            np.testing.assert_array_equal(t.data.numpy(),
                                          np.asarray(j.data))
            np.testing.assert_array_equal(t.scales.numpy(),
                                          np.asarray(j.scales))
        np.testing.assert_array_equal(ta["ckv_norm"].numpy(),
                                      np.asarray(ja["ckv_norm"]))
        assert ta["ckv_norm"].dtype == torch.float32


def test_full_width_packs_as_the_plan_tests_assume():
    """The groups `_pick_group` gives deepseek's leaves at full width,
    which tests/test_torch_cim_plan.py and chip_smoke check the kernels
    at: 114 on layer 0's w_down (K = 10944 = 2^6 3^2 19), 88 on the
    experts' and shared experts' down (K = 1408, 2816), 32 on w_uk /
    w_uv (K = 512, 16 groups)."""
    from repro_torch.quant.ptq import _pick_group
    cfg = get_config(ARCH)
    m, moe = cfg.mla, cfg.moe
    assert _pick_group(moe.first_dense_d_ff, 128, 16) == 114
    assert _pick_group(moe.d_ff_expert, 128, 16) == 88
    assert _pick_group(moe.d_ff_expert * moe.n_shared_experts, 128, 16) \
        == 88
    assert _pick_group(m.kv_lora_rank, 128, 16) == 32
    assert _pick_group(cfg.d_model, 128, 16) == 128


# ----------------------------------------------------------------------------
# the MLA step
# ----------------------------------------------------------------------------
# (verify, s, n_new per lane): a prefill chunk with a padded lane, a
# second chunk where lane 1 idles, decode steps, verify windows of s = 5
# with ragged real rows, a decode step with an idle lane
STEP_PLAN = [(False, 8, [8, 5]), (False, 8, [3, 0]), (False, 1, [1, 1]),
             (True, 5, [5, 3]), (True, 5, [2, 5]), (False, 1, [1, 0])]
STEP_CASES = [("fp", "f32"), ("fp", "bf16"), ("int4", "f32"),
              ("int4", "bf16")]


def _layer(tree, i=0):
    return {k: v[i] for k, v in tree.items()}


@pytest.mark.parametrize("precision,kv", STEP_CASES)
def test_mla_paged_step_matches_jax(precision, kv):
    """Layer 0's attention of the smoke model, stepped through STEP_PLAN
    in both packages on shuffled tables: every real row's output and
    the latent pools (the port's but the dump page)."""
    jm, jp, tm, tp = _pair(precision)
    jcfg, tcfg = jm.cfg, tm.cfg
    m = tcfg.mla
    jdt, tdt = _KV[kv]
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp["first_blocks"]["attn"])
    lp_t = _layer(tp["first_blocks"]["attn"])
    b, ps, max_pages = 2, 4, 8
    n_pages = b * max_pages
    jcache = {"c_kv": jnp.zeros((n_pages, ps, m.kv_lora_rank), jdt),
              "k_rope": jnp.zeros((n_pages, ps, m.qk_rope_head_dim), jdt)}
    tcache = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
              tattn.paged_cache_spec(tcfg, n_pages, ps, tdt).items()}
    rng = np.random.default_rng(0)
    tables = rng.permutation(n_pages).reshape(b, max_pages).astype(np.int32)
    lengths = np.zeros(b, np.int32)
    jstep = jax.jit(jax_mla_step, static_argnums=(1,),
                    static_argnames=("verify",))
    out_tol = STEP_TOL if kv == "f32" else BF16_TOL
    pool_tol = POOL_TOL if kv == "f32" else 2.0 ** -8
    worst = worst_pool = 0.0
    for verify, s, n_new in STEP_PLAN:
        n_new = np.asarray(n_new, np.int32)
        x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
        jout, jcache = jstep(lp_j, jcfg, jnp.asarray(x), jcache,
                             jnp.asarray(tables), jnp.asarray(lengths),
                             jnp.asarray(n_new), jnp.bool_(False),
                             verify=verify)
        tl, ln, nn = (torch.from_numpy(a) for a in (tables, lengths, n_new))
        rows = tattn.page_rows(tl, ln, nn, s, ps, dump_page=n_pages)
        rope = tattn.rope_by_theta(tcfg, rows.slots, [False])[
            tcfg.rope_theta]
        tout = tattn.mla_paged_step(lp_t, tcfg, torch.from_numpy(x), tcache,
                                    tl, ln, nn, rows, rope, verify=verify)
        assert tout.shape == (b, s, tcfg.d_model)
        real = np.arange(s)[None, :] < n_new[:, None]
        err = _rel(tout.numpy()[real], np.asarray(jout)[real])
        worst = max(worst, err)
        assert err < out_tol, (verify, s, n_new.tolist(), err)
        for k in ("c_kv", "k_rope"):
            assert tcache[k].dtype == tdt
            perr = _rel(_np(tcache[k][:n_pages]),
                        np.asarray(jcache[k], np.float64))
            worst_pool = max(worst_pool, perr)
            assert perr <= pool_tol, k
        lengths = lengths + n_new
    print(f"mla step {precision}/{kv}: worst relative error {worst:.3e}, "
          f"pools {worst_pool:.3e}")


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


@pytest.mark.parametrize("precision,kv", STEP_CASES)
def test_step_logits_match_jax(precision, kv, monkeypatch):
    """The smoke model's `serve_step` / `paged_verify_step` under
    teacher forcing through STEP_PLAN: every real row's logits."""
    jm, jp, tm, tp = _pair(precision)
    ps, max_pages, b = 4, 8, 2
    n_pages = b * max_pages
    jcache, tcache = _pools(jm, tm, n_pages, ps, kv)
    rng = np.random.default_rng(1)
    tables = rng.permutation(n_pages).reshape(b, max_pages).astype(np.int32)
    jsteps = {False: jax.jit(jm.serve_step),
              True: jax.jit(jm.paged_verify_step)}
    log = _RouterLog(monkeypatch)
    lengths = np.zeros(b, np.int32)
    ties, worst = 0, 0.0
    for verify, s, n_new in STEP_PLAN:
        n_new = np.asarray(n_new, np.int32)
        tokens = rng.integers(0, tm.cfg.vocab, (b, s)).astype(np.int32)
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
        tol = (STEP_TOL if kv == "f32" else BF16_TOL) * max(
            1.0, float(np.abs(jlog).max()))
        for i in range(b):
            for j in range(int(n_new[i])):
                err = float(np.abs(tlog[i, j].numpy() - jlog[i, j]).max())
                if err <= tol:
                    worst = max(worst, err / max(1.0, float(
                        np.abs(jlog).max())))
                    continue
                assert log.near_tie(b, s, i, j), (verify, s, i, j, err, tol)
                ties += 1
        lengths = lengths + n_new
    assert ties <= 1, ties
    print(f"step logits {precision}/{kv}: worst relative error {worst:.3e}")


# ----------------------------------------------------------------------------
# engines and the launcher
# ----------------------------------------------------------------------------
def _workload(vocab):
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in (3, 9, 17, 6, 12)]


def _draft():
    """The launcher's `--spec model` draft of the smoke config (one
    layer at half width: deepseek's leading dense layer, so no MoE
    layer; MLA's latent widths unchanged), weights from JAX seed 7, in
    both packages."""
    if "draft" not in _PAIRS:
        kw = dict(name="deepseek-v2-lite-smoke-draft", n_layers=1,
                  d_model=32, d_ff=64, dtype="float32", remat=False)
        jm = JaxLM(jax_get_smoke_config(ARCH).replace(**kw))
        jp = jax_init(jm.param_specs(), jax.random.PRNGKey(7),
                      dtype_override=jnp.float32)
        _PAIRS["draft"] = (jm, jp,
                           DecoderLM(get_smoke_config(ARCH).replace(**kw)),
                           from_numpy_tree(_to_numpy(jp)))
    return _PAIRS["draft"]


def _spec(spec_cls, drafter, port):
    if drafter is None:
        return None
    if drafter == "ngram":
        return spec_cls(k=4, drafter="ngram")
    jdm, jdp, tdm, tdp = _draft()
    return spec_cls(k=4, drafter="model", draft_model=tdm if port else jdm,
                    draft_params=tdp if port else jdp, draft_page_size=8)


def _serve(precision, kv, prompts, spec=None, forks=(), max_new=8,
           **geom):
    """The same requests through both engines; returns (port engine,
    port requests, jax engine, jax requests).  `spec`: None, "ngram" or
    "model" (the draft of `_draft`); `forks` lists (child, parent)
    request indices: the child forks its parent's prompt."""
    jm, jp, tm, tp = _pair(precision)
    kw = dict(precision=precision, kv_dtype=kv, max_batch=2, max_seq=48,
              page_size=4, prefill_chunk=8)
    kw.update(geom)
    out = []
    for eng_cls, req_cls, cfg_cls, model, params, spec_cls, dev in (
            (PagedServeEngine, ServeRequest, ServeConfig, tm, tp, SpecConfig,
             {"device": "cpu"}),
            (JaxEngine, JaxRequest, JaxServeConfig, jm, jp, JaxSpecConfig,
             {})):
        reqs = [req_cls(prompt=p.copy(), max_new_tokens=max_new, rid=i)
                for i, p in enumerate(prompts)]
        for child, parent in forks:
            reqs[child].fork_from = reqs[parent]
        eng = eng_cls(model, params, cfg_cls(**kw),
                      spec=_spec(spec_cls, spec, eng_cls is PagedServeEngine),
                      **dev)
        eng.run(reqs)
        out += [eng, reqs]
    return out


@pytest.mark.parametrize("precision,kv", [("fp", "f32"), ("int4", "auto")])
def test_engine_greedy_streams_and_sim_keys_match_jax(precision, kv):
    prompts = _workload(128)
    reset_launch_counts()
    eng, reqs, jeng, jreqs = _serve(precision, kv, prompts)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == 8 for r in reqs)
    assert eng.cache.n_free_or_cached() == eng.cache.allocator.n_pages
    assert set(launch_counts().values()) == {0}
    assert eng.config.kv_dtype == jeng.config.kv_dtype == (
        "f32" if kv == "f32" else "bf16")
    js, ts = jeng.summary(), eng.summary()
    sim = sorted(k for k in js if k.startswith("sim_"))
    assert sim and sim == sorted(k for k in ts if k.startswith("sim_"))
    for k in sim:
        assert math.isclose(ts[k], js[k], rel_tol=1e-12, abs_tol=0.0), k


SPEC_PROMPTS = [np.array([1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3], np.int32),
                np.array([7, 9, 11], np.int32),
                np.arange(10, 30, dtype=np.int32) % 64]


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_streams_match_plain_and_jax(drafter):
    """n-gram and draft-model speculation (the draft is MLA too, its
    pools pinned to bf16 like the target's): verify windows through
    `mla_paged_step`, streams equal to no speculation and to JAX's spec
    engine, no page leaked by either cache."""
    eng, reqs, jeng, jreqs = _serve("int4", "auto", SPEC_PROMPTS,
                                    spec=drafter, max_seq=64, page_size=8)
    assert eng.verify_calls > 0 and eng.summary()["spec_drafted"] > 0
    assert eng.cache.n_free_or_cached() == eng.cache.allocator.n_pages
    if drafter == "model":
        d = eng.spec.drafter
        assert d.decode_calls > 0
        assert d.cache.allocator.n_free == d.cache.allocator.n_pages
    plain, preqs, _, _ = _serve("int4", "auto", SPEC_PROMPTS, max_seq=64,
                                page_size=8)
    assert plain.verify_calls == 0
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in preqs] \
        == [r.out_tokens for r in jreqs]


def test_fork_copies_the_shared_latent_page_on_write_as_jax():
    """A child forked off an 11-token prompt shares its three pages; the
    last is a partial page, which the child copies before writing its
    first row (copy-on-write of both latent leaves).  Streams equal
    JAX's and the parent's (greedy, same prompt)."""
    prompt = np.arange(11, dtype=np.int32) * 3 % 128
    eng, reqs, jeng, jreqs = _serve("int4", "auto", [prompt, prompt],
                                    forks=[(1, 0)])
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert reqs[0].out_tokens == reqs[1].out_tokens
    assert eng.summary()["fork_admissions"] == 1.0
    assert eng.cache.cow_copies == jeng.cache.cow_copies > 0


def test_preempted_requests_rebuild_their_latent_pages_as_jax():
    """Prompts of 3, 9 and 6 tokens fill a pool of 9 pages at
    admission; their growth by 10 tokens each cannot fit, so lanes are
    preempted, requeued and their latent rows rebuilt by prefill;
    streams equal JAX's."""
    w = _workload(128)
    eng, reqs, jeng, jreqs = _serve("int4", "auto", [w[0], w[1], w[3]],
                                    max_new=10, max_batch=3, max_seq=32,
                                    n_pages=9, prefix_cache=False)
    assert any(r.prompt_folded for r in reqs), "no lane was preempted"
    assert [r.prompt_folded for r in reqs] == \
        [r.prompt_folded for r in jreqs]
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert eng.cache.n_free_or_cached() == eng.cache.allocator.n_pages


def test_int8_latent_pools_raise_and_auto_pins_bf16():
    _, _, tm, tp = _pair("int4")
    with pytest.raises(ValueError, match="MLA"):
        tattn.paged_cache_spec(tm.cfg, 4, 4, torch.int8)
    with pytest.raises(ValueError, match="MLA"):
        PagedServeEngine(tm, tp, ServeConfig(precision="int4",
                                             kv_dtype="int8", max_seq=32,
                                             page_size=4), device="cpu")
    cfg = ServeConfig(precision="int4", kv_dtype="auto", max_seq=32,
                      page_size=4)
    assert cfg.resolved_kv_dtype() == torch.int8
    eng = PagedServeEngine(tm, tp, cfg, device="cpu")
    assert eng.config.kv_dtype == "bf16"
    assert eng.config.as_dict()["kv_dtype_resolved"] == "bfloat16"
    assert {v.dtype for pools in eng.cache.pools.values()
            for v in pools.values()} == {torch.bfloat16}
    # a GQA model keeps auto -> int8
    from test_torch_model import SMOKE, _pair as gqa_pair
    _, _, gm, gp = gqa_pair(SMOKE, "int4")
    assert PagedServeEngine(gm, gp, cfg, device="cpu").config.kv_dtype \
        == "auto"


def test_page_copies_trim_and_bytes_walk_the_latent_leaves():
    _, _, tm, _ = _pair("fp")
    pools = {name: {k: torch.randn(v.shape) for k, v in p.items()}
             for name, p in tm.paged_cache_specs(6, 4,
                                                 torch.float32).items()}
    before = {n: {k: v.clone() for k, v in p.items()}
              for n, p in pools.items()}
    _copy_pool_pages(pools, [1, 4], [2, 5])
    for name, p in pools.items():
        for k, v in p.items():
            assert torch.equal(v[:, [2, 5]], before[name][k][:, [1, 4]])
            assert torch.equal(v[:, [0, 1, 3, 4, 6]],
                               before[name][k][:, [0, 1, 3, 4, 6]])
    eng = PagedServeEngine(tm, _pair("fp")[3], ServeConfig(
        kv_dtype="f32", max_batch=2, max_seq=16, page_size=4),
        device="cpu")
    m = tm.cfg.mla
    rows = (eng.cache.allocator.n_pages + 1) * 4 * tm.cfg.n_layers
    assert eng.cache.kv_bytes() == rows * (m.kv_lora_rank
                                           + m.qk_rope_head_dim) * 4


# ----------------------------------------------------------------------------
# the absorbed-weight exception, RoPE, capture
# ----------------------------------------------------------------------------
def test_only_w_uk_and_w_uv_leave_the_kernels(monkeypatch):
    """One INT4 decode step of the smoke model: every packed projection
    but `w_uk` / `w_uv` goes through `cim_gemv` (3 attention calls a
    layer, layer 0's `w_down`, 3 shared-expert and 3 stack calls a MoE
    layer, the head) or `swiglu_qgemv` (layer 0's gate/up), and exactly
    `w_uk` and `w_uv` of each layer are dequantized, to bf16, in the
    step."""
    _, _, tm, tp = _pair("int4")
    cfg = tm.cfg
    seen = {"cim_gemv": [], "swiglu_qgemv": 0, "deq": [], "deq_ptr": []}
    cim, swi, deq = ops.cim_gemv, ops.swiglu_qgemv, qarray.dequantize

    def spy_cim(x, w, counts=None):
        seen["cim_gemv"].append(w.data.data_ptr())
        return cim(x, w, counts)

    def spy_swi(x, wg, wu):
        seen["swiglu_qgemv"] += 1
        return swi(x, wg, wu)

    def spy_deq(qt, dtype=torch.bfloat16):
        seen["deq"].append((tuple(qt.orig_shape), dtype))
        seen["deq_ptr"].append(qt.data.data_ptr())
        return deq(qt, dtype)
    monkeypatch.setattr(ops, "cim_gemv", spy_cim)
    monkeypatch.setattr(ops, "swiglu_qgemv", spy_swi)
    monkeypatch.setattr(qarray, "dequantize", spy_deq)
    _, tcache = _pools(*_pair("int4")[::2], 4, 4, "bf16")
    tm.serve_step(tp, tcache, {"tokens": torch.tensor([[5], [7]])},
                  torch.arange(4, dtype=torch.int32).reshape(2, 2),
                  torch.tensor([3, 0], dtype=torch.int32),
                  torch.tensor([1, 1], dtype=torch.int32))
    m, H, L = cfg.mla, cfg.n_heads, cfg.n_layers
    n_moe = L - cfg.moe.first_dense_layers
    assert len(seen["cim_gemv"]) == 3 * L + 1 + 6 * n_moe + 1
    assert seen["swiglu_qgemv"] == 1
    uk = ((m.kv_lora_rank, H * m.qk_nope_head_dim), torch.bfloat16)
    uv = ((m.kv_lora_rank, H * m.v_head_dim), torch.bfloat16)
    assert seen["deq"] == [uk, uv] * L
    attn = [tp[st]["attn"][k][i] for st in ("first_blocks", "blocks")
            for i in range(tp[st]["attn"]["w_uk"].data.shape[0])
            for k in ("w_uk", "w_uv")]
    assert seen["deq_ptr"] == [w.data.data_ptr() for w in attn]
    assert not set(seen["deq_ptr"]) & set(seen["cim_gemv"])


def test_rope_tables_are_built_once_a_step_at_rope_dim(monkeypatch):
    _, _, tm, tp = _pair("fp")
    dims = []
    tables = tcommon.rope_tables

    def spy(positions, dim, theta=10000.0):
        dims.append(dim)
        return tables(positions, dim, theta)
    monkeypatch.setattr(tattn, "rope_tables", spy)
    _, tcache = _pools(*_pair("fp")[::2], 4, 4, "f32")
    tm.serve_step(tp, tcache, {"tokens": torch.tensor([[5, 6], [7, 8]])},
                  torch.arange(4, dtype=torch.int32).reshape(2, 2),
                  torch.tensor([0, 1], dtype=torch.int32),
                  torch.tensor([2, 1], dtype=torch.int32))
    assert dims == [tm.cfg.mla.qk_rope_head_dim]


@pytest.mark.parametrize("precision,kv", [("int4", "bf16"), ("fp", "f32")])
@pytest.mark.parametrize("fn,s", [("serve_step", 8), ("serve_step", 1),
                                  ("paged_verify_step", 5),
                                  ("paged_step", 1)])
def test_mla_steps_are_capturable(fn, s, precision, kv):
    """No host read, no data-dependent shape, no tensor from host values
    in an MLA step (tests/test_torch_graphs.py's guard), with an empty
    lane beside two live ones."""
    _, _, tm, tp = _pair(precision)
    _, pools = _pools(*_pair(precision)[::2], 12, 4, kv)
    tables = torch.tensor([[0, 0, 0, 0], [3, 7, 0, 9], [5, 1, 2, 4]],
                          dtype=torch.int32)
    lengths = torch.tensor([0, 6, 3], dtype=torch.int32)
    n_new = torch.tensor([0, s, max(1, s - 2)], dtype=torch.int32)
    tokens = torch.arange(3 * s, dtype=torch.int32).reshape(3, s) % 100
    with CaptureGuard():
        logits, _ = getattr(tm, fn)(tp, pools, {"tokens": tokens}, tables,
                                    lengths, n_new)
    assert logits.shape == (3, s, tm.cfg.vocab)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("spec", ["off", "ngram", "model"])
def test_launcher_deepseek_smoke_on_cpu(spec):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "3", "--tokens", "8",
         "--max-seq", "48", "--page-size", "8", "--spec", spec],
        capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stderr
    assert "deepseek-v2-lite-smoke x3 layers, int4 weights, kv bfloat16" \
        in r.stdout
    assert "24 tokens" in r.stdout
    assert (f"spec[{spec} k=4] acceptance" in r.stdout) == (spec != "off")
