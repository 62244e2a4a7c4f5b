"""The port's engine observability against the JAX engine's, on the
CPU: the same greedy workload through both `PagedServeEngine`s (with
and without n-gram speculation, tracer on and off) gives the same token
streams, the same `sim_*` energy keys (relative 1e-12: the meter is the
same arithmetic on the same token and length stream), the same
flight-recorder events and the same tracer spans and instants, timings
aside.  Also the launcher's `--trace` against the JAX launcher's, and
its cost-model line.

The port also splits each model call into spans of category "step"
(`step_inputs`, `step_replay`, `step_sample`: `serve/graphs.py`
`CallMarks`), which the JAX engine has no counterpart of: the parity
helpers `_trace` and `_counts` compare every other event, and the step
spans have tests of their own below.
"""
import collections
import contextlib
import io
import math
import sys

import numpy as np
import pytest
import torch

import repro.launch.serve as jax_launch
from repro.obs import get_tracer as jax_get_tracer
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxRequest
from repro.spec import SpecConfig as JaxSpecConfig

import repro_torch.launch.serve as port_launch
from repro_torch.obs import EnergyMeter, get_tracer
from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest
from repro_torch.spec import SpecConfig

from test_torch_model import SMOKE, _pair, _workload

TIMING = ("t_s", "dur_s")


@pytest.fixture
def tracers():
    """Both packages' process tracers on for one test, then off and
    empty again, so other tests in the worker see them quiet."""
    trs = (get_tracer(), jax_get_tracer())
    for tr in trs:
        tr.clear()
        tr.enable()
    try:
        yield trs
    finally:
        for tr in trs:
            tr.disable()
            tr.clear()


def _prompts(vocab, spec):
    if not spec:
        return _workload(vocab)
    # a repeated motif, so the n-gram drafter proposes from the start
    rng = np.random.default_rng(4)
    motif = rng.integers(0, vocab, 5).astype(np.int32)
    return [np.tile(motif, 4)[:n] for n in (7, 13, 18, 9)]


def _geom(precision, kv, **geom_kw):
    return dict(precision=precision, kv_dtype=kv, max_batch=2, max_seq=48,
                page_size=4, prefill_chunk=8, **geom_kw)


def _port_engine(precision, kv, spec, **geom_kw):
    """The port's engine and requests of `_serve_both`, not yet run."""
    tm, tp = _pair(SMOKE, precision)[2:]
    treqs = [ServeRequest(prompt=p.copy(), max_new_tokens=9, rid=i)
             for i, p in enumerate(_prompts(SMOKE["vocab"], spec))]
    teng = PagedServeEngine(tm, tp, ServeConfig(**_geom(precision, kv,
                                                        **geom_kw)),
                            device="cpu",
                            spec=SpecConfig(drafter="ngram", k=4) if spec
                            else None)
    return teng, treqs


def _serve_both(precision, kv, spec, **geom_kw):
    jm, jp = _pair(SMOKE, precision)[:2]
    jreqs = [JaxRequest(prompt=p.copy(), max_new_tokens=9, rid=i)
             for i, p in enumerate(_prompts(SMOKE["vocab"], spec))]
    jeng = JaxEngine(jm, jp, JaxServeConfig(**_geom(precision, kv,
                                                    **geom_kw)),
                     spec=JaxSpecConfig(drafter="ngram", k=4) if spec
                     else None)
    jeng.run(jreqs)
    teng, treqs = _port_engine(precision, kv, spec, **geom_kw)
    teng.run(treqs)
    return (jeng, jreqs), (teng, treqs)


def _events(recorder):
    return [{k: v for k, v in e.items() if k not in TIMING}
            for e in recorder.snapshot()]


def _trace(tracer):
    """The tracer's events, timings aside, but the port-only step
    spans."""
    return [(e["ph"], e["name"], e["cat"], e["args"])
            for e in tracer.events() if e["cat"] != "step"]


def _check_same(jax_side, port_side, spec):
    (jeng, jreqs), (teng, treqs) = jax_side, port_side
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    js, ts = jeng.summary(), teng.summary()
    sim = sorted(k for k in js if k.startswith("sim_"))
    assert sim == sorted(k for k in ts if k.startswith("sim_"))
    for k in sim:
        assert math.isclose(ts[k], js[k], rel_tol=1e-12, abs_tol=0.0), k
    assert ts["sim_decode_tokens"] == teng.telemetry.decode_tokens
    assert ts["sim_energy_j"] > 0
    assert _events(teng.recorder) == _events(jeng.recorder)
    kinds = [e["kind"] for e in teng.recorder.snapshot()]
    assert kinds.count("submit") == kinds.count("finish") == len(treqs)
    assert ("spec_verify" in kinds) == spec
    assert ("decode_step" in kinds) != spec


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "ngram"])
@pytest.mark.parametrize("precision,kv", [("int4", "int8"), ("fp", "bf16")])
def test_engine_obs_matches_jax_tracer_off(precision, kv, spec):
    jax_side, port_side = _serve_both(precision, kv, spec)
    _check_same(jax_side, port_side, spec)
    assert get_tracer().events() == []


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "ngram"])
def test_engine_obs_matches_jax_tracer_on(tracers, spec):
    port_tr, jax_tr = tracers
    jax_side, port_side = _serve_both("int4", "int8", spec)
    _check_same(jax_side, port_side, spec)
    got, want = _trace(port_tr), _trace(jax_tr)
    assert got == want
    names = [n for _, n, _, _ in got]
    teng = port_side[0]
    assert names.count("prefill_chunk") == teng.prefill_calls
    if spec:
        assert names.count("spec_verify") == (teng.verify_calls
                                              + teng.decode_calls)
        ver = [a for _, n, _, a in got if n == "spec_verify"]
        assert sum(a["drafted"] for a in ver) == \
            teng.telemetry.spec_drafted
        assert sum(a["accepted"] for a in ver) == \
            teng.telemetry.spec_accepted
    else:
        assert names.count("decode_step") == teng.decode_calls
    # spans start on the tracer's clock: every instant and span lies in
    # the run's window, in the order they were recorded
    ts = [e["t_s"] for e in port_tr.events()]
    assert ts == sorted(ts)


def test_engine_obs_matches_jax_under_preemption(tracers):
    """A pool too small for the workload: preempt instants, lanes
    rebuilt, prefix-cache eviction — the same events in both."""
    jax_side, port_side = _serve_both("int4", "int8", False, n_pages=9)
    _check_same(jax_side, port_side, False)
    assert "preempt" in [e["kind"] for e in port_side[0].recorder.snapshot()]
    assert _trace(tracers[0]) == _trace(tracers[1])


# ----------------------------------------------------------------------------
# the port's step spans (category "step")
# ----------------------------------------------------------------------------
CALLS = ("prefill_chunk", "decode_step", "spec_verify")
SLACK = 1e-9        # seconds: one rounding of a clock reading's sum


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "ngram"])
def test_step_spans_split_every_model_call(tracers, spec):
    """Each model call's span holds exactly one `step_inputs`, one
    `step_replay` and, where the call samples, one `step_sample` span,
    in that order, one after another, inside it, of the call's phase.
    On the CPU a phase's `device_ms` is the host clock's between the
    same marks.  Counted by phase, the replays are the engine's calls."""
    port_tr = tracers[0]
    eng, reqs = _port_engine("int4", "int8", spec)
    sampled = []
    sample_rows = eng._sample_rows
    eng._sample_rows = lambda *a: sampled.append(1) or sample_rows(*a)
    eng.run(reqs)
    evs = port_tr.events()
    steps = [e for e in evs if e["cat"] == "step"]
    calls = [e for e in evs if e["name"] in CALLS]
    assert steps and all(e["ph"] == "X" for e in steps)
    assert all(e["cat"] == "engine" for e in calls)
    replays = collections.Counter()
    sampled_prefills = n_kids = 0
    for call in calls:
        end = call["t_s"] + call["dur_s"]
        kids = [e for e in steps if call["t_s"] <= e["t_s"] <= end]
        n_kids += len(kids)
        phase = kids[0]["args"]["phase"]
        want = {"prefill_chunk": ("prefill",), "decode_step": ("decode",),
                "spec_verify": ("decode", "verify")}[call["name"]]
        assert phase in want
        samples = phase != "prefill" or len(kids) == 3
        assert [k["name"] for k in kids] == (
            ["step_inputs", "step_replay"]
            + (["step_sample"] if samples else []))
        assert kids[0]["t_s"] == call["t_s"]
        for a, b in zip(kids, kids[1:]):
            assert a["t_s"] + a["dur_s"] <= b["t_s"] + SLACK
        assert kids[-1]["t_s"] + kids[-1]["dur_s"] <= end + SLACK
        for k in kids:
            assert set(k["args"]) == {"phase", "device_ms"}
            assert k["args"]["phase"] == phase
            assert k["args"]["device_ms"] >= 0.0
            if k["name"] == "step_sample":
                assert k["args"]["device_ms"] <= 1e3 * k["dur_s"] + 1e-6
            else:
                assert k["args"]["device_ms"] == pytest.approx(
                    1e3 * k["dur_s"], rel=1e-6, abs=1e-6)
        replays[phase] += 1
        sampled_prefills += phase == "prefill" and samples
    assert n_kids == len(steps)
    assert replays == collections.Counter(
        {"prefill": eng.prefill_calls, "decode": eng.decode_calls,
         "verify": eng.verify_calls}) and replays["prefill"] > 0
    # a prefill call samples where a lane ends its prompt; a plain
    # engine's decode calls sample too, a speculative one's take the
    # verify logits instead
    assert 0 < sampled_prefills == len(sampled) - (
        0 if spec else eng.decode_calls)
    if spec:
        assert eng.verify_calls > 0


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_tracing_off_adds_no_events_and_no_ranges(monkeypatch, on):
    """With the tracer off a served run creates no `torch.cuda.Event`
    and enters no profiler range (neither the function-scope range the
    marks use nor `record_function`), and records nothing; with it on
    (the control) every step span's range is entered and left, and on
    the CPU still no CUDA event is made.  Streams are equal."""
    made, log = [], []

    class Range:
        def __init__(self, name, *args, **kw):
            self.name = name

        def __enter__(self):
            log.append(("enter", self.name))
            return self

        def __exit__(self, *exc):
            log.append(("exit", self.name))

    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **kw: made.append(kw))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Range)
    monkeypatch.setattr(torch.profiler, "record_function", Range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Range)
    tr = get_tracer()
    tr.clear()
    if on:
        tr.enable()
    try:
        eng, reqs = _port_engine("int4", "int8", False)
        eng.run(reqs)
        events = tr.events()
    finally:
        tr.disable()
        tr.clear()
    assert made == []
    if not on:
        assert log == [] and events == []
        return
    # one range a step span, entered and left in the spans' order
    steps = [e["name"] for e in events if e["cat"] == "step"]
    assert log == [(k, n) for n in steps for k in ("enter", "exit")]
    assert steps.count("step_replay") == eng.prefill_calls + \
        eng.decode_calls
    ref, ref_reqs = _port_engine("int4", "int8", False)
    ref.run(ref_reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_traced_call_that_raises_closes_its_range(monkeypatch, phase):
    """A traced model call whose dispatch raises (a runner's shape
    error, a failed capture) leaves its step range, opened at the
    call's start, closed, its marks dropped and no step span behind;
    the error reaches the caller."""
    log = []

    class Range:
        def __init__(self, name, *args, **kw):
            self.name = name

        def __enter__(self):
            log.append(("enter", self.name))
            return self

        def __exit__(self, *exc):
            log.append(("exit", self.name))

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Range)
    tr = get_tracer()
    tr.clear()
    tr.enable()
    try:
        eng, reqs = _port_engine("int4", "int8", False)
        dispatch = eng._dispatch
        width = 1 if phase == "decode" else eng.config.prefill_chunk

        def failing(tokens, *a, **kw):
            if tokens.shape[1] == width:
                raise ValueError("no such step")
            return dispatch(tokens, *a, **kw)

        eng._dispatch = failing
        with pytest.raises(ValueError, match="no such step"):
            eng.run(reqs)
        events = tr.events()
    finally:
        tr.disable()
        tr.clear()
    assert eng._traced is None
    assert log and log[-2:] == [("enter", "step_inputs"),
                                ("exit", "step_inputs")]
    assert log[0::2] == [("enter", n) for _, n in log[0::2]]
    assert log[1::2] == [("exit", n) for _, n in log[0::2]]
    replays = [e for e in events if e["name"] == "step_replay"]
    assert len(replays) == eng.prefill_calls + eng.decode_calls
    assert all(e["args"]["phase"] == "prefill" for e in replays)


class _Spy:
    """Records what each call of the wrapped phase returned."""

    def __init__(self, fn):
        self.fn, self.out = fn, []

    def __call__(self):
        r = self.fn()
        self.out.append(r)
        return r


def test_spec_step_with_no_lane_ready_adds_no_decode_time():
    """A drafts and decodes while B's long prompt prefills in chunks of
    4, and B's admission left A one spare page: when A reaches the next
    page boundary no page is free, so A is preempted after drafting and
    the step decodes nothing.  Such a step adds no time to
    `Telemetry.decode_s`, as in the JAX engine."""
    jm, jp, tm, tp = _pair(SMOKE, "int4")
    geom = dict(precision="int4", max_batch=2, max_seq=64, page_size=4,
                n_pages=12, prefill_chunk=4, prefix_cache=False)
    prompts = [np.arange(4, dtype=np.int32),
               np.arange(40, dtype=np.int32) % SMOKE["vocab"]]
    runs = []
    for eng_cls, cfg_cls, req_cls, spec_cls, kw in (
            (JaxEngine, JaxServeConfig, JaxRequest, JaxSpecConfig, {}),
            (PagedServeEngine, ServeConfig, ServeRequest, SpecConfig,
             {"device": "cpu"})):
        model, params = (jm, jp) if eng_cls is JaxEngine else (tm, tp)
        eng = eng_cls(model, params, cfg_cls(**geom),
                      spec=spec_cls(drafter="ngram", k=4), **kw)
        spy = _Spy(eng._decode_phase_spec)
        eng._decode_phase_spec = spy
        reqs = [req_cls(prompt=p, max_new_tokens=n, rid=i)
                for i, (p, n) in enumerate(zip(prompts, (12, 4)))]
        eng.run(reqs)
        assert [len(r.out_tokens) for r in reqs] == [12, 4]
        assert reqs[0].prompt_folded > 0, "lane A was not preempted"
        runs.append((spy.out, eng.telemetry.decode_s, reqs))
    for out, decode_s, _ in runs:
        idle = [dt for dt, lanes in out if lanes == 0]
        assert idle and all(dt == 0.0 for dt in idle)
        assert decode_s == pytest.approx(sum(dt for dt, _ in out), rel=1e-9)
    # the same steps decoded nothing in both engines
    assert [lanes for _, lanes in runs[0][0]] == \
        [lanes for _, lanes in runs[1][0]]
    assert [r.out_tokens for r in runs[0][2]] == \
        [r.out_tokens for r in runs[1][2]]


# ----------------------------------------------------------------------------
# launcher: --trace, the cost-model line
# ----------------------------------------------------------------------------
ARGS = ["--smoke", "--requests", "2", "--tokens", "4", "--max-seq", "32",
        "--page-size", "8"]


def _run_jax_launcher(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_launch.main()
    return out.getvalue()


def _run_port_launcher(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eng, _ = port_launch.main(argv + ["--device", "cpu"])
    return eng, out.getvalue()


def _counts(tracer):
    """Events by name, but the port-only step spans."""
    names = {}
    for e in tracer.events():
        if e["cat"] != "step":
            names[e["name"]] = names.get(e["name"], 0) + 1
    return names


def test_launcher_trace_matches_jax(monkeypatch):
    port_tr, jax_tr = get_tracer(), jax_get_tracer()
    try:
        for tr in (port_tr, jax_tr):
            tr.clear()
        _run_jax_launcher(monkeypatch, ARGS + ["--trace"])
        eng, out = _run_port_launcher(ARGS + ["--trace"])
        assert port_tr.enabled and jax_tr.enabled
        got = _counts(port_tr)
        assert got == _counts(jax_tr)
        assert got["prefill_chunk"] == eng.prefill_calls
        assert got["decode_step"] == eng.decode_calls
        assert got["submit"] == got["admit"] == got["finish"] == 2
        assert f"trace: {len(port_tr.events())} events" in out
        assert "EdgeCIM cost model (simulated, not measured)" in out
    finally:
        for tr in (port_tr, jax_tr):
            tr.disable()
            tr.clear()


@pytest.mark.parametrize("precision,w_bits,a_bits", [
    ("fp", 16, 16), ("int8", 8, 8), ("int4", 4, 8)])
def test_launcher_prints_the_cost_model_at_the_served_precision(
        precision, w_bits, a_bits):
    """The `sim_*` line charges the weight and activation widths the
    launcher served, for every decode token, as a meter of its own on
    the same token and length stream does."""
    eng, out = _run_port_launcher(ARGS + ["--precision", precision])
    m = eng.summary()
    assert (m["sim_w_bits"], m["sim_a_bits"]) == (w_bits, a_bits)
    assert m["sim_decode_tokens"] == eng.telemetry.decode_tokens > 0
    ref = EnergyMeter(eng.model.cfg, w_bits=w_bits, a_bits=a_bits)
    assert eng.energy.decode_cost_j(64.0) == ref.decode_cost_j(64.0)
    line = next(ln for ln in out.splitlines() if "EdgeCIM cost model" in ln)
    assert line == (
        "[serve] EdgeCIM cost model (simulated, not measured): "
        f"{m['sim_tokens_per_j']:.2f} tok/J, "
        f"{m['sim_tokens_per_s']:.1f} tok/s, {m['sim_energy_j']:.4g} J for "
        f"{int(m['sim_decode_tokens'])} decode tokens at w{w_bits}/a{a_bits}")
