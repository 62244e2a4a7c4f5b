"""The sliding-window / softcap dense families in the PyTorch port vs the
JAX package, on the CPU: gemma2, gemma3 and phi3-medium.

Same weights in both packages (drawn by JAX, carried across with
`repro_torch.convert`, as in tests/test_torch_model.py), same numpy
inputs.  The JAX paged step sends every layer of a windowed model
through its masked page gather (its `is_local` is traced); the port
hands each layer's window and the attention softcap to the decode and
verify kernels, whose plain versions run here.  These tests hold the
two routes equal: teacher-forced `serve_step` and `paged_verify_step`
logits with lanes well past the smoke window of 8 keys, both softcaps
saturated in a variant, the unfused gated-GELU FFN, greedy engine
streams with and without n-gram speculation, the configs and the
embedding scale in bf16.

Tolerances are `KV_TOL` of tests/test_torch_model.py (reasons in its
docstring), absolute on logits of O(1), with two stated widenings for
bf16 KV pools:
  * `KV_TOL["bf16"]` scales with the step's largest |logit| (at least
    1): a flipped bf16 rounding is an error relative to the value (one
    ulp is 2^-8 of it), and gemma's logits reach 5.3 at smoke size
    (six layers, embeddings scaled by sqrt(d)) where qwen2.5-smoke's
    stay near 1.  Measured: 2.2e-3 in a prefill chunk of gemma3-smoke,
    where both packages run the same masked gather.
  * decode steps of a windowed model, 2e-2 absolute.  There JAX's gather
    route casts the attention probabilities to bf16 before the V
    contraction and returns a bf16 output, where the kernel route (the
    Pallas kernel of JAX's own non-window decode, and the port's) keeps
    both in f32.  Measured: up to 1.6e-2 (gemma3-smoke).  With that
    rounding put into the port's plain decode, the two agree within the
    first tolerance (`test_bf16_gap_is_the_gather_routes_rounding`).
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
from repro.models import DecoderLM as JaxLM
from repro.models import ModelConfig as JaxConfig
from repro.models import init_params as jax_init
from repro.models.common import spec_structs
from repro.models.ffn import dense_ffn as jax_dense_ffn
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxRequest
from repro.spec import SpecConfig as JaxSpecConfig

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import DecoderLM, ModelConfig
from repro_torch.models.ffn import dense_ffn
from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest
from repro_torch.spec import SpecConfig

from test_torch_model import KV_TOL, _KV, _pair, _to_numpy

ARCHS = ("gemma2-27b", "gemma3-4b", "phi3-medium-14b")


def _smoke(arch_id, **kw):
    """The JAX package's smoke config as the keyword dict `_pair` takes."""
    cfg = jax_get_smoke_config(arch_id)
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return dict(d, **kw)


GEMMA2 = _smoke("gemma2-27b")
GEMMA3 = _smoke("gemma3-4b")
PHI3 = _smoke("phi3-medium-14b")
# both caps saturate: at smoke size the real caps (50 / 30) never bite
GEMMA2_CAPPED = _smoke("gemma2-27b", name="gemma2-capped", attn_softcap=1.0,
                       final_softcap=2.0)
GEMMA3_CAPPED = _smoke("gemma3-4b", name="gemma3-capped", attn_softcap=1.0,
                       final_softcap=2.0)
WINDOW = 8
BF16_WINDOW_TOL = 2e-2


def _tol(arch, kv, decode, ref, gather_rounding=False):
    """Tolerance of one step's logits `ref` (JAX's)."""
    if kv != "bf16":
        return KV_TOL[kv]
    if decode and arch["local_window"] and not gather_rounding:
        return BF16_WINDOW_TOL
    return KV_TOL[kv] * max(1.0, float(np.abs(ref).max()))


# ----------------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", ARCHS)
def test_copied_configs_equal_jax_field_for_field(arch_id):
    for mine, ref in ((get_config(arch_id), jax_get_config(arch_id)),
                      (get_smoke_config(arch_id),
                       jax_get_smoke_config(arch_id))):
        for f in dataclasses.fields(ref):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert {f.name for f in dataclasses.fields(mine)} == \
            {f.name for f in dataclasses.fields(ref)}


@pytest.mark.parametrize("arch_id", ARCHS)
def test_local_flags_and_full_param_tree_match_jax(arch_id):
    """`is_local_layer` is JAX's `_local_flags`; DecoderLM builds the full
    config, with the JAX package's parameter tree and shapes."""
    for full in (True, False):
        ref_cfg = (jax_get_config if full else jax_get_smoke_config)(arch_id)
        cfg = (get_config if full else get_smoke_config)(arch_id)
        jm, tm = JaxLM(ref_cfg), DecoderLM(cfg)
        flags = [cfg.is_local_layer(i) for i in range(cfg.n_layers)]
        assert flags == np.asarray(jm._local_flags(cfg.n_layers)).tolist()

        def shapes(tree):
            if isinstance(tree, dict):
                return {k: shapes(v) for k, v in tree.items()}
            return tuple(tree.shape)
        assert shapes(tm.param_specs()) == shapes(jm.param_specs())
    if arch_id == "gemma3-4b":      # 5 local layers, then a global one
        assert flags == [True, True, False, True, True, False]


# ----------------------------------------------------------------------------
# the unfused FFN (one cim_gemv call per packed projection on the card)
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("act,gated", [("gelu_tanh", True), ("gelu", True),
                                       ("gelu_tanh", False),
                                       ("relu", True)])
@pytest.mark.parametrize("precision", ["fp", "int4"])
def test_dense_ffn_matches_jax(act, gated, precision):
    kw = dict(GEMMA2, name=f"ffn-{act}-{gated}", ffn_act=act,
              ffn_gated=gated, dtype="float32", remat=False)
    jm, jp, tm, tp = _pair(kw, precision)
    assert ("w_gate" in tp["blocks"]["ffn"]) == gated
    x = np.random.default_rng(0).standard_normal((3, 5, kw["d_model"]),
                                                 np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["ffn"])
    lp_t = {k: v[0] for k, v in tp["blocks"]["ffn"].items()}
    ref = np.asarray(jax_dense_ffn(lp_j, jm.cfg, jnp.asarray(x)))
    got = dense_ffn(lp_t, tm.cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# ----------------------------------------------------------------------------
# model steps under teacher forcing, windows and caps biting
# ----------------------------------------------------------------------------
def _pools(jm, tm, n_pages, ps, kv):
    jdt, tdt = _KV[kv]
    jcache = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        spec_structs(jm.paged_cache_specs(n_pages, ps, jdt)))
    tcache = {"attn": {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
                       tm.paged_cache_specs(n_pages, ps, tdt)["attn"].items()}}
    return jcache, tcache


def _run_plan(arch, precision, kv, plan, gather_rounding=False):
    """Run `plan` [(verify, s, n_new per lane)] through both packages on
    shuffled tables; assert each step's real rows agree and return the
    port's logits of every real row with the lane's length after it.
    `gather_rounding`: the port's decode rounds as JAX's gather route
    does (see the module docstring)."""
    jm, jp, tm, tp = _pair(arch, precision)
    ps, max_pages, b = 4, 10, 2
    n_pages = b * max_pages
    jcache, tcache = _pools(jm, tm, n_pages, ps, kv)
    rng = np.random.default_rng(0)
    tables = rng.permutation(n_pages).reshape(b, max_pages).astype(np.int32)
    jsteps = {False: jax.jit(jm.serve_step),
              True: jax.jit(jm.paged_verify_step)}
    lengths = np.zeros(b, np.int32)
    rows = []
    for verify, s, n_new in plan:
        n_new = np.asarray(n_new, np.int32)
        tokens = rng.integers(0, arch["vocab"], (b, s)).astype(np.int32)
        jlog, jcache = jsteps[verify](
            jp, jcache, {"tokens": jnp.asarray(tokens)}, jnp.asarray(tables),
            jnp.asarray(lengths), jnp.asarray(n_new))
        step = tm.paged_verify_step if verify else tm.serve_step
        tlog, tcache = step(tp, tcache, {"tokens": torch.from_numpy(tokens)},
                            torch.from_numpy(tables),
                            torch.from_numpy(lengths),
                            torch.from_numpy(n_new))
        jlog = np.asarray(jlog)
        for i in range(b):
            np.testing.assert_allclose(
                tlog[i, :n_new[i]].numpy(), jlog[i, :n_new[i]],
                atol=_tol(arch, kv, s == 1, jlog, gather_rounding), rtol=0)
            rows += [(int(lengths[i]) + j + 1, tlog[i, j])
                     for j in range(n_new[i])]
        lengths = lengths + n_new
    assert lengths.max() > 2 * WINDOW          # the window bites
    return rows


# chunked prefill (lane 1 idles in the third chunk), then decode steps:
# lane 0 reaches 29 tokens, lane 1 18, against the window of 8
DECODE_PLAN = ([(False, 8, [8, 8]), (False, 8, [8, 5]), (False, 8, [7, 0])]
               + [(False, 1, [1, 1])] * 5 + [(False, 1, [1, 0])])
# a prefill, then verify windows of width 5 with ragged real rows
VERIFY_PLAN = [(False, 8, [8, 8]), (False, 8, [6, 5]), (True, 5, [5, 3]),
               (True, 5, [2, 5]), (True, 5, [5, 0])]

FAMILY_CASES = [(a, p, kv) for a in (GEMMA2, GEMMA3, PHI3)
                for p, kv in (("fp", "f32"), ("fp", "bf16"), ("fp", "int8"),
                              ("int4", "f32"), ("int4", "int8"))]


def _ids(cases):
    return [f"{c[0]['name']}-{c[1]}-{c[2]}" for c in cases]


@pytest.mark.parametrize("arch,precision,kv", FAMILY_CASES,
                         ids=_ids(FAMILY_CASES))
def test_serve_step_logits_match_jax_past_the_window(arch, precision, kv):
    _run_plan(arch, precision, kv, DECODE_PLAN)


CAPPED_CASES = [(a, p, kv) for a in (GEMMA2_CAPPED, GEMMA3_CAPPED)
                for p, kv in (("fp", "f32"), ("int4", "int8"))]


@pytest.mark.parametrize("arch,precision,kv", CAPPED_CASES,
                         ids=_ids(CAPPED_CASES))
def test_saturated_softcaps_match_jax(arch, precision, kv):
    rows = _run_plan(arch, precision, kv, DECODE_PLAN)
    top = max(float(lg.abs().max()) for _, lg in rows)
    assert 1.9 < top <= 2.0, top               # the final cap saturates


VERIFY_CASES = [(a, p, kv) for a in (GEMMA2, GEMMA3, GEMMA2_CAPPED, PHI3)
                for p, kv in (("fp", "f32"), ("int4", "int8"))]


@pytest.mark.parametrize("arch,precision,kv", VERIFY_CASES,
                         ids=_ids(VERIFY_CASES))
def test_paged_verify_step_logits_match_jax_past_the_window(arch, precision,
                                                            kv):
    _run_plan(arch, precision, kv, VERIFY_PLAN)


def _gather_rounding_decode(q, k_pages, v_pages, tables, lengths, window=0,
                            attn_cap=0.0, k_scales=None, v_scales=None):
    """The plain paged decode with JAX's gather-route rounding: the
    probabilities cast to the pools' dtype before the V contraction, and
    the output in that dtype."""
    scores, v = tref._paged_scores(q, k_pages, v_pages, tables, attn_cap,
                                   k_scales, v_scales)
    mask = tref._paged_visible(lengths, window, scores.shape[-1])
    w = torch.softmax(scores.masked_fill(~mask[:, None, None, :],
                                         tref.NEG_INF), dim=-1)
    return torch.einsum("bgpk,bkgh->bgph", w.to(v.dtype), v).to(q.dtype)


@pytest.mark.parametrize("arch", [GEMMA2, GEMMA3], ids=lambda a: a["name"])
def test_bf16_gap_is_the_gather_routes_rounding(arch, monkeypatch):
    monkeypatch.setattr(tattn, "paged_decode_attention",
                        _gather_rounding_decode)
    _run_plan(arch, "fp", "bf16", DECODE_PLAN, gather_rounding=True)


def test_the_window_bites():
    """Rows within the window are the same with an unbounded window on
    the same local layers (same RoPE bases); rows past it differ."""
    near = _run_plan(GEMMA3, "fp", "f32", DECODE_PLAN)
    far = _run_plan(dict(GEMMA3, name="gemma3-wide", local_window=10 ** 6),
                    "fp", "f32", DECODE_PLAN)
    inside = [float((a - b).abs().max()) for (n, a), (_, b) in zip(near, far)
              if n <= WINDOW]
    past = [float((a - b).abs().max()) for (n, a), (_, b) in zip(near, far)
            if n > WINDOW + 2]
    assert max(inside) < 1e-5 and min(past) > 1e-3, (inside, past)


# ----------------------------------------------------------------------------
# the embedding scale in bf16
# ----------------------------------------------------------------------------
def test_embed_scale_rounds_to_bf16_as_jax():
    """JAX multiplies by jnp.asarray(sqrt(d_model), h.dtype): in bf16 the
    scale itself is rounded first (sqrt(2560) = 50.596 -> 50.5)."""
    full = DecoderLM(get_config("gemma3-4b").replace(dtype="bfloat16"))
    assert full._embed_scale[torch.bfloat16] == float(
        jnp.asarray(np.sqrt(2560.0), jnp.bfloat16)) == 50.5
    # d = 80: sqrt 8.944 rounds to 8.9375 in bf16
    kw = dict(GEMMA3, name="gemma3-d80", d_model=80, dtype="bfloat16",
              remat=False)
    jm = JaxLM(JaxConfig(**kw))
    jp = jax_init(jm.param_specs(), jax.random.PRNGKey(0))
    tm = DecoderLM(ModelConfig(**kw))
    tp = from_numpy_tree(_to_numpy(jp))
    assert tp["embed"].dtype == torch.bfloat16
    tokens = np.arange(0, kw["vocab"], 3, dtype=np.int32)[None]
    ref = np.asarray(jm._embed(jp, {"tokens": jnp.asarray(tokens)})
                     .astype(jnp.float32))
    got = tm._embed(tp, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)
    # the unrounded scale gives other bf16 embeddings
    raw = (tp["embed"][torch.from_numpy(tokens).long()]
           * float(np.sqrt(80.0))).float().numpy()
    assert not np.array_equal(raw, ref)


# ----------------------------------------------------------------------------
# engines: greedy streams with and without n-gram speculation
# ----------------------------------------------------------------------------
def _workload(vocab):
    """Prompts shorter and longer than the window, more requests than
    lanes; 9 new tokens take every lane past the window."""
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in (3, 9, 17, 6, 12)]


ENGINE_CASES = [(a, p, kv) for a in (GEMMA2, GEMMA3, PHI3)
                for p, kv in (("fp", "bf16"), ("int4", "int8"))]


@pytest.mark.parametrize("arch,precision,kv", ENGINE_CASES,
                         ids=_ids(ENGINE_CASES))
def test_engine_greedy_streams_match_jax(arch, precision, kv):
    jm, jp, tm, tp = _pair(arch, precision)
    prompts = _workload(arch["vocab"])
    geom = dict(precision=precision, kv_dtype=kv, max_batch=2, max_seq=48,
                page_size=4, prefill_chunk=8)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=9, rid=i)
             for i, p in enumerate(prompts)]
    JaxEngine(jm, jp, JaxServeConfig(**geom)).run(jreqs)
    treqs = [ServeRequest(prompt=p, max_new_tokens=9, rid=i)
             for i, p in enumerate(prompts)]
    eng = PagedServeEngine(tm, tp, ServeConfig(**geom), device="cpu")
    reset_launch_counts()
    eng.run(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == 9 for r in treqs)
    assert eng.cache.n_free_or_cached() == eng.cache.allocator.n_pages
    assert set(launch_counts().values()) == {0}


SPEC_PROMPTS = [np.array([1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3], np.int32),
                np.array([7, 9, 11], np.int32),
                np.arange(10, 30, dtype=np.int32) % 64]


@pytest.mark.parametrize("arch", [GEMMA2, GEMMA3, PHI3],
                         ids=lambda a: a["name"])
def test_ngram_spec_streams_match_plain_and_jax(arch):
    jm, jp, tm, tp = _pair(arch, "int4")
    serve_kw = dict(max_batch=2, max_seq=64, page_size=8, prefill_chunk=8,
                    precision="int4", kv_dtype="int8")
    outs = []
    for spec in (None, SpecConfig(k=4)):
        eng = PagedServeEngine(tm, tp, ServeConfig(**serve_kw), spec=spec,
                               device="cpu")
        reqs = [ServeRequest(prompt=p.copy(), max_new_tokens=14, rid=i)
                for i, p in enumerate(SPEC_PROMPTS)]
        eng.run(reqs)
        outs.append([r.out_tokens for r in reqs])
    assert eng.verify_calls > 0 and eng.summary()["spec_drafted"] > 0
    jreqs = [JaxRequest(prompt=p.copy(), max_new_tokens=14, rid=i)
             for i, p in enumerate(SPEC_PROMPTS)]
    JaxEngine(jm, jp, JaxServeConfig(**serve_kw),
              spec=JaxSpecConfig(k=4, drafter="ngram")).run(jreqs)
    assert outs[1] == outs[0] == [r.out_tokens for r in jreqs]


# ----------------------------------------------------------------------------
# launcher
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_launcher_gemma3_smoke_on_cpu(spec):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-4b", "--smoke", "--device", "cpu", "--requests", "3",
         "--tokens", "12", "--max-seq", "48", "--page-size", "8",
         "--spec", spec],
        capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stderr
    assert "gemma3-smoke x6 layers" in r.stdout
    assert "36 tokens" in r.stdout
    assert ("spec[ngram k=4] acceptance" in r.stdout) == (spec == "ngram")
