"""PyTorch port vs the JAX package, end to end on the CPU: per-step
logits of `DecoderLM.serve_step` under teacher forcing, greedy token
streams of `PagedServeEngine`, and page conservation.

Weights are drawn once by the JAX package and carried across with
`repro_torch.convert` (packed bytes unchanged), so both packages run the
same model.  Tolerances, absolute on logits of O(1):
  * f32 KV: 1e-4.  The two contract in another order, so sums differ by
    f32 ulps (measured: ~2e-6).
  * int8 KV: 2e-3.  A K/V value that sits on a rounding boundary after
    an ulp-level difference lands one int8 step apart (scale/127 of its
    row) in the two pools; with one kv head every query head sees it.
    Measured: one flipped element in the dff86 pools moved logits by
    up to 9.5e-4.
  * bf16 KV: 2e-3.  K/V rows are rounded to bf16 in both packages, and
    the probabilities are cast to bf16 before the V contraction, where
    the two frameworks may round a product differently by one bf16 ulp
    (2^-8 relative).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import DecoderLM as JaxLM
from repro.models import ModelConfig as JaxConfig
from repro.models import init_params as jax_init
from repro.models.common import spec_structs
from repro.quant.ptq import quantize_params as jax_quantize_params
from repro.quant.qarray import QTensor as JaxQTensor
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxRequest

from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import DecoderLM, ModelConfig
from repro_torch.serve import (PagedServeEngine, SamplingParams, ServeConfig,
                               ServeRequest, processed_probs, sample_tokens)

SMOKE = dict(name="qwen2.5-smoke", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
             qkv_bias=True, tie_embeddings=True)
# d_ff=1376 gives w_down K=1376, which _pick_group packs in groups of 86
DFF86 = dict(name="dff86", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=1, d_ff=1376, vocab=96, head_dim=16,
             qkv_bias=True, rope_theta=1e6, tie_embeddings=True)

KV_TOL = {"f32": 1e-4, "int8": 2e-3, "bf16": 2e-3}
_PAIRS = {}


def _to_numpy(tree):
    if isinstance(tree, JaxQTensor):
        return {"data": np.asarray(tree.data),
                "scales": np.asarray(tree.scales), "bits": tree.bits,
                "group": tree.group, "axis": tree.axis,
                "orig_shape": tree.orig_shape}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _pair(arch, precision):
    """(jax model, jax params, port model, port params), built once."""
    key = (arch["name"], precision)
    if key not in _PAIRS:
        kw = dict(arch, dtype="float32", remat=False)
        jm = JaxLM(JaxConfig(**kw))
        jp = jax_init(jm.param_specs(), jax.random.PRNGKey(0),
                      dtype_override=jnp.float32)
        if precision == "int4":
            jp = jax_quantize_params(jp, bits=4, group=128)
        tm = DecoderLM(ModelConfig(**kw))
        _PAIRS[key] = (jm, jp, tm, from_numpy_tree(_to_numpy(jp)))
    return _PAIRS[key]


_KV = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16),
       "int8": (jnp.int8, torch.int8)}


@pytest.mark.parametrize("arch,precision,kv", [
    (SMOKE, "fp", "f32"), (SMOKE, "fp", "bf16"), (SMOKE, "fp", "int8"),
    (SMOKE, "int4", "f32"), (SMOKE, "int4", "int8"),
    (DFF86, "fp", "f32"), (DFF86, "int4", "bf16"), (DFF86, "int4", "int8"),
])
def test_serve_step_logits_match_jax_teacher_forced(arch, precision, kv):
    jm, jp, tm, tp = _pair(arch, precision)
    if precision == "int4":
        w_down = tp["blocks"]["ffn"]["w_down"]
        assert w_down.bits == 4
        if arch is DFF86:
            assert w_down.group == 86
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
    jstep = jax.jit(jm.serve_step)
    lengths = np.zeros(b, np.int32)
    # two prefill chunks (lane 1 idles in the second), then decode steps
    plan = [(8, [8, 5]), (8, [4, 0])] + [(1, [1, 1])] * 5
    for s, n_new in plan:
        n_new = np.asarray(n_new, np.int32)
        tokens = rng.integers(0, arch["vocab"], (b, s)).astype(np.int32)
        jlog, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(tokens)},
                             jnp.asarray(tables), jnp.asarray(lengths),
                             jnp.asarray(n_new))
        tlog, tcache = tm.serve_step(
            tp, tcache, {"tokens": torch.from_numpy(tokens)},
            torch.from_numpy(tables), torch.from_numpy(lengths),
            torch.from_numpy(n_new))
        jlog = np.asarray(jlog)
        for i in range(b):
            if n_new[i]:
                np.testing.assert_allclose(
                    tlog[i, :n_new[i]].numpy(), jlog[i, :n_new[i]],
                    atol=KV_TOL[kv], rtol=0)
        lengths = lengths + n_new


def _workload(vocab):
    """Mixed prompt lengths, more requests than lanes (so some queue),
    spanning several 4-token pages."""
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in (3, 9, 17, 6, 12)]


@pytest.mark.parametrize("precision,kv", [("fp", "bf16"), ("int4", "int8")])
def test_engine_greedy_streams_match_jax(precision, kv):
    jm, jp, tm, tp = _pair(SMOKE, precision)
    prompts = _workload(SMOKE["vocab"])
    geom = dict(precision=precision, kv_dtype=kv, max_batch=2, max_seq=48,
                page_size=4, prefill_chunk=8)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=7, rid=i)
             for i, p in enumerate(prompts)]
    JaxEngine(jm, jp, JaxServeConfig(**geom)).run(jreqs)
    treqs = [ServeRequest(prompt=p, max_new_tokens=7, rid=i)
             for i, p in enumerate(prompts)]
    eng = PagedServeEngine(tm, tp, ServeConfig(**geom), device="cpu")
    reset_launch_counts()
    eng.run(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == 7 for r in treqs)
    # pages conserved; no kernel launched on the CPU
    assert eng.cache.n_free_or_cached() == eng.cache.allocator.n_pages
    assert set(launch_counts().values()) == {0}


def _drained(eng):
    return (eng.cache.n_free_or_cached() == eng.cache.allocator.n_pages
            and all(r is None for r in eng.lanes)
            and eng.scheduler.n_queued == 0)


def test_engine_preempts_and_conserves_pages_under_a_small_pool():
    _, _, tm, tp = _pair(SMOKE, "int4")
    eng = PagedServeEngine(tm, tp, ServeConfig(
        precision="int4", max_batch=3, max_seq=32, page_size=4, n_pages=9,
        prefill_chunk=8, prefix_cache=False), device="cpu")
    w = _workload(SMOKE["vocab"])
    # prompts of 3, 9 and 6 tokens fill the 9 pages at admission; their
    # growth cannot fit, so lanes are preempted and rebuilt
    reqs = [ServeRequest(prompt=p, max_new_tokens=10, rid=i)
            for i, p in enumerate([w[0], w[1], w[3]])]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert any(r.prompt_folded for r in reqs), "no lane was preempted"
    assert _drained(eng)


def test_engine_cancel_mid_decode_and_queued_frees_pages():
    _, _, tm, tp = _pair(SMOKE, "fp")
    eng = PagedServeEngine(tm, tp, ServeConfig(
        max_batch=1, max_seq=48, page_size=4), device="cpu")
    a = ServeRequest(prompt=np.arange(10, dtype=np.int32), max_new_tokens=20)
    b = ServeRequest(prompt=np.arange(5, dtype=np.int32), max_new_tokens=4)
    eng.submit(a)
    eng.submit(b)
    assert eng.cancel(b.eid)                 # still queued
    for _ in range(4):
        eng.step()
    assert 0 < len(a.out_tokens) < 20
    assert eng.cancel(a.eid)                 # mid-decode
    assert not eng.cancel(a.eid)
    assert a.cancelled and b.cancelled and b.out_tokens == []
    assert _drained(eng)
    assert eng.summary()["cancelled"] == 2.0


def test_engine_fork_shares_prompt_pages():
    _, _, tm, tp = _pair(SMOKE, "fp")
    eng = PagedServeEngine(tm, tp, ServeConfig(
        max_batch=2, max_seq=48, page_size=4), device="cpu")
    prompt = np.arange(11, dtype=np.int32)
    parent = ServeRequest(prompt=prompt, max_new_tokens=5)
    child = ServeRequest(prompt=prompt, max_new_tokens=5, fork_from=parent)
    eng.run([parent, child])
    assert parent.out_tokens == child.out_tokens      # greedy, same prompt
    assert eng.summary()["fork_admissions"] == 1.0
    assert _drained(eng)


def test_sampling_respects_top_k_and_processed_probs():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.5, -1.0]] * 2)
    temp = np.array([1.0, 0.0], np.float32)
    draws = {int(sample_tokens(gen, logits, temp, np.array([2, 0]),
                               np.array([1.0, 1.0]))[0]) for _ in range(64)}
    assert draws <= {1, 3} and len(draws) == 2
    assert int(sample_tokens(gen, logits, temp, np.array([2, 0]))[1]) == 1
    p = processed_probs(logits[0].numpy(), 1.0, 2, 1.0)
    assert np.count_nonzero(p) == 2
    nucleus = {int(sample_tokens(gen, logits, temp, np.array([0, 0]),
                                 np.array([0.5, 1.0]))[0])
               for _ in range(32)}
    assert nucleus == {1}


def test_engine_packs_float_params_when_precision_asks():
    """ServeConfig.precision is authoritative: float params handed to an
    int4 engine are packed exactly as ptq packs them, so the stream
    equals the one from pre-packed params."""
    _, _, tm, fp = _pair(SMOKE, "fp")
    _, _, _, qp = _pair(SMOKE, "int4")
    cfg = ServeConfig(precision="int4", max_batch=2, max_seq=32, page_size=4)
    outs = []
    for params in (fp, qp):
        eng = PagedServeEngine(tm, params, cfg, device="cpu")
        assert eng.params["blocks"]["ffn"]["w_down"].bits == 4
        req = ServeRequest(prompt=np.arange(6, dtype=np.int32),
                           max_new_tokens=4)
        eng.run([req])
        outs.append(req.out_tokens)
    assert outs[0] == outs[1]


def test_engine_temperature_sampling_runs():
    _, _, tm, tp = _pair(SMOKE, "fp")
    eng = PagedServeEngine(tm, tp, ServeConfig(max_batch=2, max_seq=32,
                                               page_size=4, seed=3),
                           device="cpu")
    reqs = [ServeRequest(prompt=np.arange(6, dtype=np.int32),
                         max_new_tokens=5,
                         sampling=SamplingParams(temperature=1.0, top_k=8,
                                                 top_p=0.9))]
    eng.run(reqs)
    assert len(reqs[0].out_tokens) == 5
    assert all(0 <= t < SMOKE["vocab"] for t in reqs[0].out_tokens)


def test_entry_points_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    _, _, tm, tp = _pair(SMOKE, "fp")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedServeEngine(tm, tp, ServeConfig(max_seq=32, page_size=4))


def test_features_outside_the_slice_raise():
    """Tensor parallelism with no process group of tp ranks, a recurrent
    family without its SSMConfig and a norm the port does not have
    raise.  (Tensor-parallel serving itself is held against JAX's in
    tests/test_torch_tp_serving.py; LayerNorm and frontend-stub
    embeddings are ported for training; the engine refuses the latter,
    tests/test_torch_forward.py.  The recurrent families' full-sequence
    forward is ported: it runs.)"""
    _, _, tm, tp = _pair(SMOKE, "fp")
    with pytest.raises(ValueError, match="torch.distributed group of 2"):
        PagedServeEngine(tm, tp, ServeConfig(max_seq=32, page_size=4,
                                             tp=2), device="cpu")
    with pytest.raises(NotImplementedError):
        DecoderLM(ModelConfig(**dict(SMOKE, family="xlstm")))
    with pytest.raises(NotImplementedError):
        DecoderLM(ModelConfig(**dict(SMOKE, norm_kind="group")))
    DecoderLM(ModelConfig(**dict(SMOKE, norm_kind="layer")))
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    xm = DecoderLM(get_smoke_config("xlstm-1.3b"))
    params = init_params(xm.param_specs(), torch.Generator().manual_seed(0),
                         "cpu")
    with torch.no_grad():
        logits = xm.forward(params, {"tokens": torch.zeros(
            1, 2, dtype=torch.long)})
    assert logits.shape == (1, 2, xm.cfg.vocab)
    assert torch.isfinite(logits).all()


def test_launcher_smoke_on_cpu():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "3", "--tokens", "4",
         "--max-seq", "32", "--page-size", "8"],
        capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stderr
    assert "12 tokens" in r.stdout
