"""The port's SLO layer (`repro_torch.obs.slo`, `obs.drift`,
`obs.export.prometheus_text`) against the JAX package's, on the CPU.

Each behaviour of `tests/test_slo.py` is one case run against both
packages (parametrised over `repro` and `repro_torch`), fed the same
inputs on a manual clock, and its output held equal to the JAX
package's: burn-rate alert transitions and payloads, spec parsing (the
same verdicts and messages), the drift auditor's events and summaries,
and the Prometheus text of the same /metrics payload.  Then the SLO
layer end to end through each package's gateway over two replicas: an
unmeetable objective pages (`/healthz` degraded, the level gauge at 2,
the fleet-scope event in every replica's flight recorder), an induced
decode slowdown trips the drift alarm, and a healthy run stays "ok"
with no NaN.  The gateway's own poll loop is parked (`slo_poll_s` of an
hour) and `FleetRouter.poll_slo` is ticked by hand, so no case waits on
wall-clock windows.
"""
import asyncio
import json
import math
import re

import numpy as np
import pytest

import repro.obs as jax_obs
import repro.obs.export as jax_export
import repro.obs.slo as jax_slo

import repro_torch.obs as port_obs
import repro_torch.obs.export as port_export
import repro_torch.obs.slo as port_slo

from test_torch_gateway import PKGS, body, get, pkg, post, status

OBS = {"repro": (jax_obs, jax_slo, jax_export),
       "repro_torch": (port_obs, port_slo, port_export)}


def _latency_digest_dict(obs, good, bad):
    d = obs.QuantileDigest()
    d.extend([0.01] * good + [10.0] * bad if good + bad else [])
    return d.to_dict()


def _fast_burn(obs, mon):
    good = bad = 0
    for i in range(220):
        t = i * 0.1
        if i < 70:
            bad += 5
        else:
            good += 5
        mon.ingest("r0", digests={"ttft_s": _latency_digest_dict(
            obs, good, bad)}, now=t)
        mon.evaluate(t)


def _short_window_veto(obs, mon):
    total = bad = 0
    for i in range(20):
        total += 10 if i < 10 else 1
        bad += 10 if i < 10 else 0
        mon.ingest("r0", counters={"requests_total": total,
                                   "cancelled": bad}, now=i * 0.1)
    mon.evaluate(2.0)


def _goodput(obs, mon, idle=False):
    tok = busy = 0.0
    for i in range(70):
        if not idle:
            tok += 2.0
            busy += 0.1
        mon.ingest("r0", counters={"decode_tokens": tok or 5.0,
                                   "decode_s": busy or 1.0}, now=i * 0.1)
        mon.evaluate(i * 0.1)


SCENARIOS = {
    "fast_burn_recovers": (["ttft_p95_s < 1.0"], _fast_burn),
    "short_window_vetoes": (["error_rate < 0.05"], _short_window_veto),
    "goodput_floor": (["goodput_tokens_per_s > 100"], _goodput),
    "goodput_idle": (["goodput_tokens_per_s > 100"],
                     lambda obs, mon: _goodput(obs, mon, idle=True)),
}


def _scenario(name, scenario):
    obs, slo, _ = OBS[name]
    specs, drive = SCENARIOS[scenario]
    mon = obs.SLOMonitor(specs, policy=obs.BurnRatePolicy(
        timescale=1 / 600))
    seen = []
    mon.on_transition(seen.append)
    drive(obs, mon)
    return seen, mon.payload(), mon.worst_level()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("name", PKGS)
def test_burn_rate_transitions_and_payload_equal_jax(name, scenario):
    seen, payload, worst = _scenario(name, scenario)
    assert (seen, payload, worst) == _scenario("repro", scenario)
    want = {"fast_burn_recovers": "ok", "short_window_vetoes": "warn",
            "goodput_floor": "page", "goodput_idle": "ok"}[scenario]
    assert worst == want
    if scenario == "fast_burn_recovers":
        levels = [ev["to"] for ev in seen]
        assert levels[0] == "page" and levels[-1] == "ok"


@pytest.mark.parametrize("name", PKGS)
def test_burn_policy_timescale_compresses_windows(name):
    pol = OBS[name][0].BurnRatePolicy(timescale=1 / 600)
    assert pol.windows() == jax_obs.BurnRatePolicy(
        timescale=1 / 600).windows()
    assert pol.windows()["page"] == (6.0, 0.5, 14.4)
    assert pol.max_window_s == 36.0


SPECS = ["ttft_p95_s < 0.5", "error_rate < 0.01",
         "goodput_tokens_per_s > 10", "itl_p99_s < 1.0", "tpot_p50 < 2",
         "ttft_p95_s > 0.5", "nonsense_metric < 1", "error_rate < 2",
         "goodput > 0", "goodput < 3", "ttft_p100_s < 1", "ttft < what"]


def _parse(slo, text):
    try:
        return "ok", slo.SLOSpec.parse(text)
    except ValueError as e:
        return "error", str(e)


@pytest.mark.parametrize("text", SPECS)
@pytest.mark.parametrize("name", PKGS)
def test_slo_spec_parsing_same_verdict_and_message(name, text):
    got, want = _parse(OBS[name][1], text), _parse(jax_slo, text)
    assert got[0] == want[0]
    if got[0] == "ok":
        assert vars(got[1]) == vars(want[1])
    else:
        assert got[1] == want[1]


@pytest.mark.parametrize("name", PKGS)
def test_parse_slos_refuses_duplicates_and_defaults_match(name):
    slo = OBS[name][1]
    assert slo.DEFAULT_SLOS == jax_slo.DEFAULT_SLOS
    assert [vars(s) for s in slo.parse_slos(slo.DEFAULT_SLOS)] == \
        [vars(s) for s in jax_slo.parse_slos(jax_slo.DEFAULT_SLOS)]
    with pytest.raises(ValueError):
        slo.parse_slos(["ttft_p95_s < 1", "ttft_p95_s < 2"])


def _drift_run(obs, case):
    rng = np.random.default_rng(9)
    aud = obs.DriftAuditor(calib_ticks=5) if case == "idle" \
        else obs.DriftAuditor()
    meas = sim = 0.0
    out = []
    for i in range(60):
        if case == "idle" and i >= 3:
            pass                          # no decode progress
        elif case == "healthy" or i < 30:
            meas += 0.010 * (1 + 0.05 * rng.standard_normal())
            sim += 0.004
        else:
            meas += 0.030                 # measured decode 3x slower
            sim += 0.004
        out.append((aud.observe(float(i), meas, sim), aud.summary()))
    return out, aud.calibrated


def _nan_eq(a, b):
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("case", ["healthy", "slowdown", "idle"])
@pytest.mark.parametrize("name", PKGS)
def test_drift_auditor_equal_jax(name, case):
    got, calibrated = _drift_run(OBS[name][0], case)
    assert _nan_eq(got, _drift_run(jax_obs, case)[0])
    events = [ev for ev, _ in got if ev is not None]
    last = got[-1][1]
    if case == "slowdown":
        assert len(events) == 1
        assert events[0]["direction"] == "measured_degraded"
        assert last["sim_drift_alarm"] == 1.0 and last["sim_drift_ratio"] < 0.6
    elif case == "healthy":
        assert events == [] and last["sim_drift_alarm"] == 0.0
    else:
        assert not calibrated and math.isnan(last["sim_drift_ratio"])


def _payload():
    nan = float("nan")
    edges = [0.0, 0.01, 0.1, "inf"]
    return {
        "schema_version": 3,
        "engine": {"requests": 4.0, "tokens": 20.0, "ttft_p95_s": 0.25,
                   "spec_acceptance_rate": nan, "kv_occupancy_peak": 0.5,
                   "cancelled": 1.0, "sim_energy_j": 1e-3},
        "histograms": {"ttft_s": {"edges_s": edges, "counts": [1, 2, 1]},
                       "itl_s": {"edges_s": edges, "counts": [0, 5, 0]}},
        "n_running": 2, "n_queued": 0, "kv_pages_free": 60,
        "gateway": {"http_requests": 9, "accepted_samples": 4,
                    "rejected_429": 1, "inflight": 2, "max_pending": 64},
        "fleet": {"policy": "prefix", "n_replicas": 2, "n_live": 1,
                  "counters": {"dispatched": 4, "requeued": 0},
                  "affinity_hits": 2, "affinity_misses": 2,
                  "replicas": {
                      "0": {"alive": True, "pending": 2, "dispatches": 3,
                            "snapshot": {"kv_occupancy": 0.25,
                                         "n_running": 2.0},
                            "drift": {"sim_drift_ratio": 1.02,
                                      "sim_drift_alarm": 0.0,
                                      "sim_drift_alarms": 0.0,
                                      "sim_drift_cusum": 0.1,
                                      "sim_measured_ratio": 0.4}},
                      "1": {"alive": False, "pending": 0, "dispatches": 1,
                            "snapshot": {}, "drift": {
                                "sim_drift_ratio": nan}}}},
        "slo": {"states": [
            {"scope": "fleet", "slo": "ttft_p95", "level": "page",
             "burn": {"page_long": 20.0, "page_short": 19.5},
             "transitions": 1},
            {"scope": "replica-0", "slo": 'quote"d\\', "level": "warn",
             "burn": {"page_long": nan}, "transitions": 2}]},
    }


@pytest.mark.parametrize("prefix", ["repro", "edge cim"])
@pytest.mark.parametrize("name", PKGS)
def test_prometheus_text_equal_jax(name, prefix):
    got = OBS[name][2].prometheus_text(_payload(), prefix=prefix)
    assert got == jax_export.prometheus_text(_payload(), prefix=prefix)
    assert "NaN" not in got
    assert re.search(r'_slo_alert_level\{scope="fleet",slo="ttft_p95"\} 2',
                     got)


# ----------------------------------------------------------------------------
# end to end through the gateway, two replicas, manual SLO clock
# ----------------------------------------------------------------------------
async def _get_json(host, port, path):
    raw = await get(host, port, path)
    return status(raw), json.loads(body(raw))


@pytest.mark.parametrize("name", PKGS)
def test_gateway_slo_page_healthz_degraded_and_recorder(name):
    p = pkg(name)
    obs = OBS[name][0]
    alerts = []

    async def run():
        router = p.fleet.FleetRouter([p.engine() for _ in range(2)],
                                     policy="least-loaded", max_pending=16)
        router.on_alert(alerts.append)
        gw = p.api.Gateway(router, slos=["ttft_p95_s < 0.000000001"],
                           slo_policy=obs.BurnRatePolicy(
                               timescale=1 / 600), slo_poll_s=3600)
        host, port = await gw.start()
        try:
            for i in range(6):
                raw = await post(host, port, {"prompt": [1 + i, 2, 3],
                                              "max_tokens": 4})
                assert status(raw) == 200
                router.poll_slo(now=0.1 * i)
            slo = await _get_json(host, port, "/debug/slo")
            health = await _get_json(host, port, "/healthz")
            metrics = await _get_json(host, port, "/metrics")
            prom = body(await get(host, port,
                                  "/metrics?format=prometheus")).decode()
            recs = [rep.engine.recorder.snapshot()
                    for rep in router.replicas]
        finally:
            await gw.stop()
        return slo, health, metrics, prom, recs

    (st, doc), (st_h, health), (_, metrics), prom, recs = asyncio.run(run())
    assert st == 200 and doc["worst"] == "page"
    paged = [s for s in doc["states"] if s["level"] == "page"]
    assert any(s["scope"] == "fleet" for s in paged)
    assert all(s["burn"]["page_long"] >= 14.4 for s in paged)
    assert st_h == 200 and health["ok"] is True
    assert health["degraded"] is True and health["slo_worst"] == "page"
    assert metrics["slo"]["worst"] == "page"
    assert re.search(
        r'repro_slo_alert_level\{scope="fleet",slo="[^"]+"\} 2\b', prom)
    assert "NaN" not in prom
    assert any(ev["kind"] == "slo_alert" and ev["to"] == "page"
               for ev in alerts)
    for snap in recs:
        assert any(ev["kind"] == "slo_alert" for ev in snap)


@pytest.mark.parametrize("name", PKGS)
def test_gateway_drift_alarm_on_induced_decode_slowdown(name):
    p = pkg(name)
    alerts = []

    async def run():
        router = p.fleet.FleetRouter([p.engine() for _ in range(2)],
                                     policy="rr", max_pending=16)
        router.on_alert(alerts.append)
        gw = p.api.Gateway(router, slo_poll_s=3600)
        host, port = await gw.start()
        tick = [0.0]

        async def traffic(n):
            for i in range(n):
                raw = await post(host, port, {"prompt": [1 + i % 7, 2, 3],
                                              "max_tokens": 8})
                assert status(raw) == 200
                tick[0] += 1.0
                router.poll_slo(now=tick[0])
        try:
            for _ in range(40):          # calibrate on honest timings
                await traffic(2)
                if all(rep.drift.calibrated for rep in router.replicas):
                    break
            calibrated = [rep.drift.calibrated for rep in router.replicas]
            for rep in router.replicas:  # 8x slower measured decode
                orig = rep.engine._decode_phase

                def slow(orig=orig):
                    d, lanes = orig()
                    return d * 8.0, lanes
                rep.engine._decode_phase = slow
            for _ in range(60):
                await traffic(2)
                if all(rep.drift.summary()["sim_drift_alarm"]
                       for rep in router.replicas):
                    break
            _, doc = await _get_json(host, port, "/debug/slo")
            prom = body(await get(host, port,
                                  "/metrics?format=prometheus")).decode()
            recs = [rep.engine.recorder.snapshot()
                    for rep in router.replicas]
        finally:
            await gw.stop()
        return calibrated, doc, prom, recs

    calibrated, doc, prom, recs = asyncio.run(run())
    assert calibrated == [True, True]
    assert len(doc["drift"]) == 2
    for d in doc["drift"].values():
        assert d["sim_drift_alarm"] == 1.0 and d["sim_drift_ratio"] < 0.6
        assert any(ev["direction"] == "measured_degraded"
                   for ev in d["events"])
    assert 'repro_replica_sim_drift_alarm{replica="0"} 1.0' in prom
    assert any(ev["kind"] == "drift_alarm" for ev in alerts)
    for snap in recs:
        assert any(ev["kind"] == "drift_alarm" for ev in snap)


@pytest.mark.parametrize("name", PKGS)
def test_gateway_healthy_run_stays_ok_no_nan(name):
    p = pkg(name)
    slo = OBS[name][1]

    async def run():
        router = p.fleet.FleetRouter([p.engine() for _ in range(2)],
                                     policy="least-loaded", max_pending=16)
        gw = p.api.Gateway(router, slos=list(slo.DEFAULT_SLOS),
                           slo_poll_s=3600)
        host, port = await gw.start()
        try:
            for i in range(4):
                raw = await post(host, port, {"prompt": [1 + i, 2, 3],
                                              "max_tokens": 4})
                assert status(raw) == 200
                router.poll_slo(now=0.1 * i)
            _, doc = await _get_json(host, port, "/debug/slo")
            _, health = await _get_json(host, port, "/healthz")
            _, metrics = await _get_json(host, port, "/metrics")
            prom = body(await get(host, port,
                                  "/metrics?format=prometheus")).decode()
        finally:
            await gw.stop()
        return doc, health, metrics, prom

    doc, health, metrics, prom = asyncio.run(run())
    assert doc["worst"] == "ok" and doc["transitions"] == []
    assert health["degraded"] is False
    assert metrics["engine"]["ttft_p95_s"] > 0
    assert metrics["engine"]["requests"] == 4.0
    assert "NaN" not in prom
    assert "repro_engine_spec_acceptance_rate" not in prom
