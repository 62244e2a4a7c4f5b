"""Speculative decoding in the PyTorch port vs the JAX package, on the
CPU: the plain verify and contiguous decode attention vs the Pallas
kernels (interpret mode) and JAX oracles, `paged_verify_step` logits
under teacher forcing, the drafters and the acceptance walk, and greedy
engine streams with speculation on and off.

Inputs are drawn with numpy from a seed and handed to both packages;
weights cross with `repro_torch.convert` (see tests/test_torch_model.py).
Tolerances: attention outputs of O(1) in f32 agree to 1e-5 absolute (sum
order); model logits at `KV_TOL` of tests/test_torch_model.py, whose
docstring gives the reason for each KV dtype.
"""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.flash_decode import flash_decode as pl_flash_decode
from repro.kernels.paged_flash_decode import \
    paged_flash_verify as pl_paged_flash_verify
from repro.kernels.ref import ref_flash_decode as jax_ref_flash_decode
from repro.kernels.ref import ref_paged_verify as jax_ref_paged_verify
from repro.models import DecoderLM as JaxLM
from repro.models import ModelConfig as JaxConfig
from repro.models import init_params as jax_init
from repro.models.common import spec_structs
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import SamplingParams as JaxSampling
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxRequest
from repro.spec import NGramDrafter as JaxNGram
from repro.spec import SpecConfig as JaxSpecConfig
from repro.spec import accept_draft as jax_accept_draft

from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import (decode_attention, launch_counts,
                                 reset_launch_counts)
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.paged_flash_decode import paged_flash_verify
from repro_torch.kernels.ref import ref_paged_decode, ref_paged_verify
from repro_torch.models import DecoderLM, ModelConfig
from repro_torch.serve import (PagedServeEngine, SamplingParams, ServeConfig,
                               ServeRequest)
from repro_torch.spec import NGramDrafter, SpecConfig, accept_draft
from repro_torch.spec.decode import SpecDecoder

from test_torch_model import DFF86, KV_TOL, SMOKE, _KV, _pair, _to_numpy


# ----------------------------------------------------------------------------
# paged_flash_verify: plain version vs Pallas (interpret) and the JAX oracle
# ----------------------------------------------------------------------------
def _verify_case(rng, s, ps, max_pages, pool, b=3, g=2, qpk=4, hd=64):
    n_pages = b * max_pages
    q = rng.standard_normal((b, s, g, qpk, hd)).astype(np.float32)
    kf = rng.standard_normal((n_pages, ps, g, hd)).astype(np.float32)
    vf = rng.standard_normal((n_pages, ps, g, hd)).astype(np.float32)
    tables = rng.permutation(n_pages).reshape(b, max_pages).astype(np.int32)
    lengths = rng.integers(0, max_pages * ps - s + 1,
                           size=b).astype(np.int32)
    case = {"q": q, "tables": tables, "lengths": lengths,
            "k_scales": None, "v_scales": None}
    if pool == "int8":
        for name, x in (("k", kf), ("v", vf)):
            sc = (np.maximum(np.abs(x).max(-1), 1e-8) / 127.0
                  ).astype(np.float16)
            case[name] = np.clip(np.round(x / sc[..., None].astype(
                np.float32)), -127, 127).astype(np.int8)
            case[name + "_scales"] = sc
    else:
        case["k"], case["v"] = kf, vf
    return case


_ARGS = ("q", "k", "v", "tables", "lengths")


def _jax(c, name):
    return None if c[name] is None else jnp.asarray(c[name])


def _torch(c, name):
    return None if c[name] is None else torch.from_numpy(c[name])


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("s,ps,max_pages,window,cap", [
    (4, 16, 8, 0, 0.0),
    (5, 8, 16, 0, 0.0),
    (3, 16, 8, 24, 0.0),
    (4, 16, 8, 0, 30.0),
    (2, 8, 16, 12, 50.0),
])
def test_paged_verify_plain_matches_pallas(pool, s, ps, max_pages, window,
                                           cap):
    c = _verify_case(np.random.default_rng(0), s, ps, max_pages, pool)
    jargs = [jnp.asarray(c[n]) for n in _ARGS]
    pallas = pl_paged_flash_verify(
        *jargs, window=window, attn_cap=cap, interpret=True,
        k_scales=_jax(c, "k_scales"), v_scales=_jax(c, "v_scales"))
    oracle = jax_ref_paged_verify(*jargs, window, cap,
                                  _jax(c, "k_scales"), _jax(c, "v_scales"))
    out = paged_flash_verify(*[torch.from_numpy(c[n]) for n in _ARGS],
                             window=window, attn_cap=cap,
                             k_scales=_torch(c, "k_scales"),
                             v_scales=_torch(c, "v_scales"))
    assert out.shape == (3, s, 2, 4, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), atol=1e-5)


def test_paged_verify_s1_matches_paged_decode():
    """A 1-wide window IS a decode step; lengths exclusive vs inclusive
    is the only difference in convention."""
    c = _verify_case(np.random.default_rng(2), 1, 16, 8, "int8", b=2)
    c["lengths"] = np.asarray([17, 90], np.int32)
    t = {n: _torch(c, n) for n in (*_ARGS, "k_scales", "v_scales")}
    ver = ref_paged_verify(t["q"], t["k"], t["v"], t["tables"], t["lengths"],
                           k_scales=t["k_scales"], v_scales=t["v_scales"])
    dec = ref_paged_decode(t["q"][:, 0], t["k"], t["v"], t["tables"],
                           t["lengths"] + 1, k_scales=t["k_scales"],
                           v_scales=t["v_scales"])
    assert float((ver[:, 0] - dec).abs().max()) < 1e-6


# ----------------------------------------------------------------------------
# flash_decode / ops.decode_attention
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("pos,window,cap", [(900, 0, 0.0), (0, 0, 0.0),
                                            (1023, 100, 0.0),
                                            (513, 0, 30.0)])
def test_flash_decode_plain_matches_pallas_and_ops(pos, window, cap):
    b, g, qpk, hd, S = 2, 2, 2, 32, 1024
    rng = np.random.default_rng(4)
    q = rng.standard_normal((b, g, qpk, hd)).astype(np.float32)
    k = rng.standard_normal((b, S, g, hd)).astype(np.float32)
    v = rng.standard_normal((b, S, g, hd)).astype(np.float32)
    oracle = np.asarray(jax_ref_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
        window, cap))
    kf = np.ascontiguousarray(k.swapaxes(1, 2).reshape(b * g, S, hd))
    vf = np.ascontiguousarray(v.swapaxes(1, 2).reshape(b * g, S, hd))
    pallas = np.asarray(pl_flash_decode(
        jnp.asarray(q.reshape(b * g, qpk, hd)), jnp.asarray(kf),
        jnp.asarray(vf), jnp.int32(pos), window=window, attn_cap=cap,
        interpret=True)).reshape(b, g, qpk, hd)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    outs = {
        "ops kernel": decode_attention(tq, tk, tv, pos, window, cap),
        "ops plain": decode_attention(tq, tk, tv, torch.tensor(pos),
                                      window, cap, use_kernel=False),
        "wrapper": flash_decode(tq.reshape(b * g, qpk, hd),
                                torch.from_numpy(kf), torch.from_numpy(vf),
                                pos, window, cap).reshape(b, g, qpk, hd),
    }
    for name, out in outs.items():
        np.testing.assert_allclose(out.numpy(), oracle, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(out.numpy(), pallas, atol=1e-5,
                                   err_msg=name)
    if window == 0 and cap == 0.0:
        jk = np.asarray(jax_ops.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos)))
        np.testing.assert_allclose(outs["ops kernel"].numpy(), jk,
                                   atol=1e-5)


# ----------------------------------------------------------------------------
# paged_verify_step logits vs JAX, and vs sequential decode
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch,precision,kv", [
    (SMOKE, "fp", "f32"), (SMOKE, "int4", "int8"),
    (DFF86, "fp", "f32"), (DFF86, "int4", "int8"),
])
def test_paged_verify_step_logits_match_jax_teacher_forced(arch, precision,
                                                           kv):
    jm, jp, tm, tp = _pair(arch, precision)
    ps, max_pages, b = 4, 8, 2
    n_pages = b * max_pages
    jdt, tdt = _KV[kv]
    jcache = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        spec_structs(jm.paged_cache_specs(n_pages, ps, jdt)))
    tcache = {"attn": {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
                       tm.paged_cache_specs(n_pages, ps, tdt)["attn"].items()}}
    rng = np.random.default_rng(0)
    tables = rng.permutation(n_pages).reshape(b, max_pages).astype(np.int32)
    jsteps = {False: jax.jit(jm.paged_step),
              True: jax.jit(jm.paged_verify_step)}
    lengths = np.zeros(b, np.int32)
    # a prefill chunk, then verify windows of width 5 with ragged real
    # rows (lane 1 idles in the last one)
    plan = [(False, 8, [8, 5]), (True, 5, [5, 3]), (True, 5, [2, 5]),
            (True, 5, [1, 0])]
    for verify, s, n_new in plan:
        n_new = np.asarray(n_new, np.int32)
        tokens = rng.integers(0, arch["vocab"], (b, s)).astype(np.int32)
        jlog, jcache = jsteps[verify](
            jp, jcache, {"tokens": jnp.asarray(tokens)}, jnp.asarray(tables),
            jnp.asarray(lengths), jnp.asarray(n_new))
        step = tm.paged_verify_step if verify else tm.paged_step
        tlog, tcache = step(tp, tcache, {"tokens": torch.from_numpy(tokens)},
                            torch.from_numpy(tables),
                            torch.from_numpy(lengths),
                            torch.from_numpy(n_new))
        jlog = np.asarray(jlog)
        for i in range(b):
            np.testing.assert_allclose(
                tlog[i, :n_new[i]].numpy(), jlog[i, :n_new[i]],
                atol=KV_TOL[kv], rtol=0)
        lengths = lengths + n_new


def test_paged_verify_step_matches_sequential_serve_step():
    """Mirror of tests/test_spec.py's check on the port alone: a verify
    window scores each position as sequential decode steps do.  1e-4:
    the decode and verify plain versions contract in another order."""
    _, _, tm, tp = _pair(SMOKE, "fp")
    toks = np.array([5, 9, 3, 17, 2, 41, 8, 30], np.int32)
    tables = torch.tensor([[3, 7, 1, 5, 0, 0, 0, 0]], dtype=torch.int32)

    def pool():
        return {"attn": {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
                         tm.paged_cache_specs(10, 4, torch.float32)
                         ["attn"].items()}}

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32)

    seq_pool = pool()
    seq = []
    for t, tok in enumerate(toks):
        lg, _ = tm.serve_step(tp, seq_pool,
                              {"tokens": torch.tensor([[int(tok)]])},
                              tables, i32(t), i32(1))
        seq.append(lg[0, 0])
    ver_pool = pool()
    tm.serve_step(tp, ver_pool, {"tokens": torch.from_numpy(toks[None, :3])},
                  tables, i32(0), i32(3))
    vg, _ = tm.paged_verify_step(
        tp, ver_pool, {"tokens": torch.from_numpy(toks[None, 3:])}, tables,
        i32(3), i32(5))
    for i in range(5):
        assert float((vg[0, i] - seq[3 + i]).abs().max()) < 1e-4, i


# ----------------------------------------------------------------------------
# drafters and the acceptance walk: identical to JAX's
# ----------------------------------------------------------------------------
def test_ngram_proposals_match_jax():
    rng = np.random.default_rng(0)
    motif = rng.integers(0, 50, 6)
    histories = [np.tile(motif, 4)[:int(n)].astype(np.int32)
                 for n in (7, 13, 22)]
    histories += [rng.integers(0, 50, 30).astype(np.int32), None,
                  np.array([3], np.int32),
                  np.array([2, 3, 9, 1, 2, 3, 7, 4, 2, 3], np.int32)]
    for k in (1, 2, 4):
        for nmax, nmin in ((3, 1), (2, 2)):
            j = JaxNGram(nmax, nmin).propose(histories, k, [None] * 7)
            t = NGramDrafter(nmax, nmin).propose(histories, k, [None] * 7)
            np.testing.assert_array_equal(t.tokens, j.tokens)
            np.testing.assert_array_equal(t.n, j.n)
            assert t.probs is None and j.probs is None


@pytest.mark.parametrize("lane", ["greedy", "point-mass", "model-q"])
def test_accept_draft_matches_jax(lane):
    rng_in = np.random.default_rng(11)
    temp = 0.0 if lane == "greedy" else 0.9
    jsp = JaxSampling(temperature=temp, top_k=12, top_p=0.95)
    tsp = SamplingParams(temperature=temp, top_k=12, top_p=0.95)
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(60):
        nd = int(rng_in.integers(0, 5))
        logits = rng_in.standard_normal((nd + 1, 32)) * 2.0
        draft = rng_in.integers(0, 32, nd).astype(np.int32)
        if lane == "greedy" and nd:
            hit = rng_in.random(nd) < 0.6          # mix hits and misses
            draft = np.where(hit, logits[:nd].argmax(-1), draft)
        q = None
        if lane == "model-q":
            q = rng_in.random((nd, 32))
            q /= q.sum(-1, keepdims=True)
        assert (accept_draft(logits, draft, q, tsp, trng)
                == jax_accept_draft(logits, draft, q, jsp, jrng))


def test_autok_adapts_up_and_down():
    _, _, tm, _ = _pair(SMOKE, "fp")
    dec = SpecDecoder(tm, SpecConfig(k=6, autok=True, autok_beta=0.5),
                      max_batch=2, max_seq=64)
    assert 1 < dec.current_k() < 6, "autok starts mid-window"
    for drafted, accepted, k in ((8, 8, 6), (8, 0, 1), (4, 4, 6)):
        for _ in range(12):
            dec.observe(drafted=drafted, accepted=accepted)
        assert dec.current_k() == k
    dec.observe(drafted=0, accepted=0)           # no signal
    assert dec.current_k() == 6
    pinned = SpecDecoder(tm, SpecConfig(k=4), max_batch=2, max_seq=64)
    for _ in range(10):
        pinned.observe(drafted=8, accepted=0)
    assert pinned.current_k() == 4


def test_model_drafter_device_defaults_to_cuda_or_raises(monkeypatch):
    """A draft model's cache goes where every port entry point goes: the
    card, unless the caller asks for the CPU; with no card, device=None
    raises rather than drafting on the CPU."""
    from repro_torch.spec import DraftModelDrafter
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tm, _ = _pair(SMOKE, "fp")
    _, _, dm, dp = _draft_pair()
    spec = SpecConfig(k=2, drafter="model", draft_model=dm,
                      draft_params=dp, draft_page_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DraftModelDrafter(dm, dp, max_batch=2, max_seq=64, page_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpecDecoder(tm, spec, max_batch=2, max_seq=64)
    on_cpu = SpecDecoder(tm, spec, max_batch=2, max_seq=64, device="cpu")
    assert on_cpu.drafter.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in
               on_cpu.drafter.cache.pools["attn"].values())
    ngram = SpecDecoder(tm, SpecConfig(k=2), max_batch=2, max_seq=64)
    assert isinstance(ngram.drafter, NGramDrafter)   # needs no device


# ----------------------------------------------------------------------------
# engine: greedy streams with speculation on/off, port vs JAX
# ----------------------------------------------------------------------------
PROMPTS = [np.array([1, 2, 3, 1, 2, 3, 1, 2], np.int32),      # repetitive
           np.array([7, 9, 11], np.int32),                     # short
           np.arange(10, 30, dtype=np.int32) % 64]             # long
GEOM = dict(max_batch=2, max_seq=64, page_size=8, prefill_chunk=8)
_DRAFTS = {}


def _draft_pair():
    """A 1-layer half-width draft of SMOKE, weights from JAX seed 3."""
    if not _DRAFTS:
        kw = dict(SMOKE, name="smoke-draft", n_layers=1, d_model=32,
                  d_ff=64, dtype="float32", remat=False)
        jm = JaxLM(JaxConfig(**kw))
        jp = jax_init(jm.param_specs(), jax.random.PRNGKey(3),
                      dtype_override=jnp.float32)
        _DRAFTS["pair"] = (jm, jp, DecoderLM(ModelConfig(**kw)),
                           from_numpy_tree(_to_numpy(jp)))
    return _DRAFTS["pair"]


def _spec_cfgs(drafter, k=4, **kw):
    if drafter is None:
        return None, None
    if drafter == "ngram":
        return (JaxSpecConfig(k=k, drafter="ngram", **kw),
                SpecConfig(k=k, drafter="ngram", **kw))
    jdm, jdp, tdm, tdp = _draft_pair()
    return (JaxSpecConfig(k=k, drafter="model", draft_model=jdm,
                          draft_params=jdp, draft_page_size=8, **kw),
            SpecConfig(k=k, drafter="model", draft_model=tdm,
                       draft_params=tdp, draft_page_size=8, **kw))


def _port_run(tm, tp, spec_cfg, serve_kw, prompts=PROMPTS, new=12,
              **req_kw):
    eng = PagedServeEngine(tm, tp, ServeConfig(**serve_kw), spec=spec_cfg,
                           device="cpu")
    reqs = [ServeRequest(prompt=p.copy(), max_new_tokens=new, rid=i,
                         **req_kw) for i, p in enumerate(prompts)]
    eng.run(reqs)
    return [r.out_tokens for r in reqs], eng


def _pages_conserved(eng):
    return eng.cache.n_free_or_cached() == eng.cache.allocator.n_pages


@pytest.mark.parametrize("drafter,precision,kv", [
    ("ngram", "fp", "bf16"), ("ngram", "int4", "int8"),
    ("model", "int4", "int8")])
def test_spec_engine_greedy_streams_match_plain_and_jax(drafter, precision,
                                                        kv):
    jm, jp, tm, tp = _pair(SMOKE, precision)
    serve_kw = dict(GEOM, precision=precision, kv_dtype=kv)
    jspec, tspec = _spec_cfgs(drafter)
    base, _ = _port_run(tm, tp, None, serve_kw)
    reset_launch_counts()
    out, eng = _port_run(tm, tp, tspec, serve_kw)
    jreqs = [JaxRequest(prompt=p.copy(), max_new_tokens=12, rid=i)
             for i, p in enumerate(PROMPTS)]
    JaxEngine(jm, jp, JaxServeConfig(**serve_kw), spec=jspec).run(jreqs)
    assert out == base
    assert out == [r.out_tokens for r in jreqs]
    s = eng.summary()
    assert eng.verify_calls > 0 and s["spec_drafted"] > 0
    assert s["spec_accepted"] <= s["spec_drafted"]
    assert s["spec_k_now"] == 4.0
    assert _pages_conserved(eng)
    assert set(launch_counts().values()) == {0}       # CPU: plain versions
    if drafter == "model":
        d = eng.spec.drafter
        assert d.decode_calls > 0
        assert d.cache.allocator.n_free == d.cache.allocator.n_pages, \
            "draft cache leaked pages"


def test_spec_repetitive_prompt_accepts_several_tokens_per_step():
    _, _, tm, tp = _pair(SMOKE, "fp")
    out, eng = _port_run(tm, tp, SpecConfig(k=4), GEOM,
                         prompts=[np.array([1, 2, 3] * 6, np.int32)],
                         new=16)
    s = eng.summary()
    assert s["tokens_per_decode_step"] > 1.0
    assert s["spec_acceptance_rate"] > 0.0


def test_spec_mixed_batch_opt_out_eos_and_token_budget():
    _, _, tm, tp = _pair(SMOKE, "int4")
    serve_kw = dict(GEOM, precision="int4")
    # per-request opt-out rides the same verify calls
    on = ServeRequest(prompt=np.array([1, 2, 3, 1, 2, 3], np.int32),
                      max_new_tokens=8, rid=0)
    off = ServeRequest(prompt=np.array([4, 5, 6, 4, 5, 6], np.int32),
                       max_new_tokens=8, rid=1, spec=False)
    eng = PagedServeEngine(tm, tp, ServeConfig(**serve_kw),
                           spec=SpecConfig(k=3), device="cpu")
    eng.run([on, off])
    base, _ = _port_run(tm, tp, None, serve_kw,
                        prompts=[on.prompt, off.prompt], new=8)
    assert [on.out_tokens, off.out_tokens] == base
    # a budget shorter than a window is respected exactly
    out, _ = _port_run(tm, tp, SpecConfig(k=4), serve_kw, new=5)
    assert all(len(o) == 5 for o in out)
    # EOS inside an accepted window stops the stream AT the EOS: take the
    # token whose first occurrence in the plain stream is deepest
    base, _ = _port_run(tm, tp, None, serve_kw, new=12)
    j, eos, pos = max(((j, t, o.index(t)) for j, o in enumerate(base)
                       for t in set(o)), key=lambda x: x[2])
    out, _ = _port_run(tm, tp, SpecConfig(k=4),
                       dict(serve_kw, eos_id=int(eos)),
                       prompts=[PROMPTS[j]], new=12)
    assert out[0] == base[j][:pos + 1]
    # all lanes opted out: plain (b, 1) decode calls only
    out, eng = _port_run(tm, tp, SpecConfig(k=4), serve_kw,
                         prompts=PROMPTS[:2], new=8, spec=False)
    assert out == _port_run(tm, tp, None, serve_kw, prompts=PROMPTS[:2],
                            new=8)[0]
    assert eng.verify_calls == 0 and eng.summary()["spec_drafted"] == 0


def test_spec_engine_preempts_and_conserves_pages_under_a_small_pool():
    _, _, tm, tp = _pair(SMOKE, "int4")
    serve_kw = dict(precision="int4", max_batch=2, max_seq=64, page_size=4,
                    n_pages=8, prefill_chunk=8)
    prompts = [np.arange(1, 9, dtype=np.int32)] * 2
    for drafter in ("ngram", "model"):
        _, tspec = _spec_cfgs(drafter)
        eng = PagedServeEngine(tm, tp, ServeConfig(**serve_kw), spec=tspec,
                               device="cpu")
        reqs = [ServeRequest(prompt=p.copy(), max_new_tokens=10, rid=i)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        assert all(r.done and len(r.out_tokens) == 10 for r in reqs)
        assert any(r.prompt_folded for r in reqs), "no lane was preempted"
        assert eng.cache.n_free_or_cached() == 8
        assert all(lane is None for lane in eng.lanes)


def test_spec_stochastic_run_completes_and_rolls_back():
    _, _, tm, tp = _pair(SMOKE, "fp")
    for drafter in ("ngram", "model"):
        _, tspec = _spec_cfgs(drafter, k=3)
        out, eng = _port_run(
            tm, tp, tspec, dict(GEOM, seed=3), new=10,
            sampling=SamplingParams(temperature=0.8, top_k=20, top_p=0.95))
        assert all(len(o) == 10 for o in out)
        assert _pages_conserved(eng)


def test_spec_refused_for_unknown_drafter_or_unpaged_model():
    _, _, tm, tp = _pair(SMOKE, "fp")
    with pytest.raises(ValueError, match="drafter"):
        PagedServeEngine(tm, tp, ServeConfig(**GEOM),
                         spec=SpecConfig(drafter="tree"), device="cpu")
    unpaged = types.SimpleNamespace(cfg=tm.cfg, supports_paged=lambda: False)
    # the JAX engine's wording (`capability_error`): the capability, and
    # that it needs a paged-attention-only model
    with pytest.raises(ValueError, match="'speculative-decoding' requires "
                                         "a paged-attention-only model"):
        PagedServeEngine(unpaged, tp, ServeConfig(**GEOM), spec=SpecConfig(),
                         device="cpu")


@pytest.mark.parametrize("spec", ["ngram", "model"])
def test_launcher_spec_smoke_on_cpu(spec):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "3", "--tokens", "6",
         "--max-seq", "32", "--page-size", "8", "--spec", spec],
        capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stderr
    assert "18 tokens" in r.stdout
    assert f"spec[{spec} k=4] acceptance" in r.stdout
