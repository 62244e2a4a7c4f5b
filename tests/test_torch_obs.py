"""The port's copies of the EdgeCIM cost model (`repro_torch.core`) and
of the observability layer (`repro_torch.obs`) against the JAX
package's, on the same inputs, on the CPU.

The cost model and the energy meter are the same numpy and float
arithmetic in both packages, so their results must be exactly equal
(no tolerance).  The tracer, Chrome-trace export and flight recorder
run the same cases through both packages' modules and must produce the
same events and documents.  The workloads are the paper's SLMs, taken
from the JAX package's `configs.paper_slms` field by field.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest

import repro.core as jcore
import repro.obs as jobs
from repro.configs import get_config as jax_get_config
from repro.configs.paper_slms import PAPER_SLMS as JAX_SLMS
from repro.models import ModelConfig as JaxConfig
from repro.obs.trace import NULL_SPAN as JAX_NULL_SPAN

import repro_torch.core as tcore
import repro_torch.obs as tobs
from repro_torch.configs import get_config
from repro_torch.models import ModelConfig

from test_torch_model import SMOKE

BITS = [(4, 8), (8, 8), (16, 16)]
SEQS = [64.0, 1500.0]


def _stage(cost):
    return (cost.seconds, cost.joules)


def _report(rep):
    """A SimReport as plain values (the HWConfig and SpecKnob classes
    differ between the packages)."""
    d = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)}
    d["hw"] = rep.hw.as_tuple()
    d["spec_decode"] = (dataclasses.astuple(rep.spec_decode)
                        if rep.spec_decode is not None else None)
    return d


def _port_spec(jspec):
    """The port's SLMSpec with every field of the JAX one."""
    return tcore.SLMSpec(**{f.name: getattr(jspec, f.name)
                            for f in dataclasses.fields(jspec)})


@pytest.mark.parametrize("name", sorted(JAX_SLMS))
def test_simulator_reports_equal_jax(name):
    tsim, jsim = tcore.EdgeCIMSimulator(), jcore.EdgeCIMSimulator()
    th, jh = tcore.HWConfig(), jcore.HWConfig()
    jspec = JAX_SLMS[name]
    tspec = _port_spec(jspec)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    for w, a in BITS:
        for seq in SEQS:
            assert _stage(tsim.decode_token(tspec, th, seq, w, a)) == \
                _stage(jsim.decode_token(jspec, jh, seq, w, a))
            assert _stage(tsim.prefill(tspec, th, int(seq), w, a)) == \
                _stage(jsim.prefill(jspec, jh, int(seq), w, a))
        got = tsim.generate(tspec, th, 32, 16, w, a,
                            spec_decode=tcore.SpecKnob(k=4, accept_rate=0.6))
        want = jsim.generate(jspec, jh, 32, 16, w, a,
                             spec_decode=jcore.SpecKnob(k=4, accept_rate=0.6))
        assert _report(got) == _report(want)
        assert tcore.decode_fraction(tspec, th, 32, 16, w, a) == \
            jcore.decode_fraction(jspec, jh, 32, 16, w, a)
    assert tcore.chip_area_mm2(th) == jcore.chip_area_mm2(jh)
    assert tcore.stream_bandwidth(th) == jcore.stream_bandwidth(jh)
    for w, a in BITS:
        assert tcore.peak_tops(th, a) == jcore.peak_tops(jh, a)


def _meters(pair, w_bits, a_bits):
    tcfg, jcfg = pair
    return (tobs.EnergyMeter(tcfg, w_bits=w_bits, a_bits=a_bits),
            jobs.EnergyMeter(jcfg, w_bits=w_bits, a_bits=a_bits))


_COEFFS = ("_e0_j", "_de_j", "_s0_s", "_ds_s", "_prefill_j_per_tok",
           "_prefill_s_per_tok")


@pytest.mark.parametrize("w_bits,a_bits", BITS)
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "smoke"])
def test_energy_meter_equals_jax(arch, w_bits, a_bits):
    if arch == "smoke":
        pair = (ModelConfig(**SMOKE), JaxConfig(**SMOKE))
    else:
        pair = (get_config(arch), jax_get_config(arch))
    assert dataclasses.asdict(tobs.slm_spec_from_model_config(pair[0])) == \
        dataclasses.asdict(jobs.slm_spec_from_model_config(pair[1]))
    t, j = _meters(pair, w_bits, a_bits)
    assert [getattr(t, c) for c in _COEFFS] == [getattr(j, c) for c in _COEFFS]
    rng = np.random.default_rng(0)
    for _ in range(20):
        n, seq = int(rng.integers(0, 5)), float(rng.integers(1, 2048))
        p = int(rng.integers(0, 64))
        for m in (t, j):
            m.charge_decode(n, seq)
            m.charge_prefill(p)
        assert t.decode_cost_j(seq) == j.decode_cost_j(seq)
    assert t.summary() == j.summary()
    assert t.summary()["sim_decode_tokens"] > 0
    t.reset()
    j.reset()
    assert t.summary() == j.summary()


# ----------------------------------------------------------------------------
# tracer, Chrome trace: the cases of tests/test_obs.py, on both packages
# ----------------------------------------------------------------------------
PORT = dict(Tracer=tobs.Tracer, NULL_SPAN=tobs.NULL_SPAN,
            chrome_trace=tobs.chrome_trace)
JAX = dict(Tracer=jobs.Tracer, NULL_SPAN=JAX_NULL_SPAN,
           chrome_trace=jobs.chrome_trace)


def _case_disabled(ns):
    tr = ns["Tracer"]()
    assert not tr.enabled
    assert tr.span("x") is ns["NULL_SPAN"]
    with tr.span("x", cat="engine", k=1):
        pass
    tr.instant("y", rid=3)
    tr.complete("z", 0.0, 1.0)
    assert tr.events() == [] and tr.dropped() == 0
    return []


def _strip(evs):
    return [{k: v for k, v in e.items() if k not in ("tid", "thread_name")}
            for e in evs]


def _case_wraparound(ns):
    tr = ns["Tracer"](capacity=8, clock=iter(range(100)).__next__).enable()
    for i in range(20):
        tr.instant("e", i=i)
    evs = tr.events()
    assert [e["args"]["i"] for e in evs] == list(range(12, 20))
    assert tr.dropped() == 12
    out = (_strip(evs), tr.dropped())
    tr.clear()
    assert tr.events() == [] and tr.dropped() == 0
    return out


def _case_span_and_complete(ns):
    t = [0.0]

    def clock():
        t[0] += 0.5
        return t[0]

    tr = ns["Tracer"](clock=clock).enable()
    with tr.span("work", cat="driver", job=7):
        pass
    tr.complete("measured", t0=10.0, dur_s=0.25, cat="engine", rids=[1])
    spans = {e["name"]: e for e in tr.events()}
    assert spans["work"]["ph"] == "X" and spans["work"]["dur_s"] == 0.5
    assert spans["work"]["args"] == {"job": 7}
    assert spans["measured"]["t_s"] == 10.0
    assert spans["measured"]["dur_s"] == 0.25
    return _strip(tr.events())


def _case_threads(ns):
    tr = ns["Tracer"](capacity=256).enable()
    ids = []
    lock = threading.Lock()

    def worker(k):
        for _ in range(100):
            tr.instant("e", w=k)
            with lock:
                ids.append(tr.next_request_id())

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert [len(r.events) for r in tr.rings()] == [100] * 4
    assert len(set(ids)) == 400 and tr.dropped() == 0
    return sorted(e["args"]["w"] for e in tr.events())


def _case_chrome_trace(ns):
    tr = ns["Tracer"](clock=lambda: 2.0).enable()
    with tr.span("s", cat="engine", rids=[0]):
        pass
    tr.instant("i", cat="gateway", rid=0)
    doc = json.loads(json.dumps(ns["chrome_trace"](tr)))
    evs = doc["traceEvents"]
    assert {m["name"] for m in evs if m["ph"] == "M"} >= {"process_name",
                                                          "thread_name"}
    for e in evs:
        assert {"ph", "name", "pid"} <= set(e)
        if e["ph"] != "M":
            assert e["ts"] == 2.0e6 and "tid" in e
    span = next(e for e in evs if e["name"] == "s")
    assert span["ph"] == "X" and span["dur"] == 0.0
    inst = next(e for e in evs if e["name"] == "i")
    assert inst["ph"] == "i" and inst["s"] == "t"
    assert doc["metadata"]["dropped_events"] == 0
    return doc


@pytest.mark.parametrize("case", [
    _case_disabled, _case_wraparound, _case_span_and_complete,
    _case_threads, _case_chrome_trace],
    ids=lambda f: f.__name__[len("_case_"):])
def test_tracer_and_exporters_match_jax(case):
    assert case(PORT) == case(JAX)


def test_flight_recorder_dump_matches_jax(tmp_path, monkeypatch):
    payloads = []
    for pkg, sub in ((tobs, "port"), (jobs, "jax")):
        rec = pkg.FlightRecorder(capacity=4, label="unit",
                                 clock=iter(np.arange(100.0)).__next__)
        for i in range(10):
            rec.record("step", i=i)
        assert rec.dropped == 6
        assert [e["i"] for e in rec.snapshot()] == [6, 7, 8, 9]
        path = rec.dump(reason="boom", directory=str(tmp_path / sub))
        assert path.startswith(str(tmp_path / sub))
        with open(path) as f:
            payloads.append(json.load(f))
        # with no directory given, REPRO_FLIGHT_DIR names it
        monkeypatch.setenv("REPRO_FLIGHT_DIR", str(tmp_path / "env"))
        assert rec.dump(reason="env").startswith(str(tmp_path / "env"))
    assert payloads[0] == payloads[1]
    assert payloads[0]["label"] == "unit" and payloads[0]["dropped"] == 6
