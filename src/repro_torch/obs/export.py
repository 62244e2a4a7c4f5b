"""Trace and metrics exporters.

chrome_trace   Tracer events -> Chrome trace-event JSON (the format
               Perfetto / chrome://tracing load directly): one process,
               one track per recorded thread, "X" complete spans and
               "i" instants, args (request ids, lane lists, policy
               scores) preserved per event.

prometheus_text
               the gateway's /metrics JSON payload -> Prometheus text
               exposition (version 0.0.4): engine counters/gauges,
               gateway counters, per-replica gauges with a `replica`
               label, and the latency histograms as cumulative
               `_bucket{le=...}` series.  Same numbers as the JSON —
               one source payload, two renderings — so a scrape can
               never disagree with the debug view.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional

from .slo import LEVEL_VALUE
from .trace import Tracer

TRACE_CATEGORIES = ("gateway", "router", "driver", "engine", "sched")


def chrome_trace(tracer: Tracer,
                 process_name: str = "repro-serve") -> Dict[str, Any]:
    """Chrome trace-event JSON object for every ring in `tracer`.

    Timestamps are microseconds on the tracer's monotonic clock; each
    thread that ever recorded becomes its own track via metadata
    events, so a 2-replica run shows gateway/event-loop, router, and
    both driver threads as parallel lanes.
    """
    events: List[Dict[str, Any]] = []
    pid = tracer.pid
    named: Dict[int, str] = {}
    for ring in tracer.rings():
        if ring.tid not in named:
            named[ring.tid] = ring.thread_name
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": ring.tid,
                           "args": {"name": ring.thread_name}})
    for ev in tracer.events():
        out = {"name": ev["name"], "cat": ev["cat"], "ph": ev["ph"],
               "ts": ev["t_s"] * 1e6, "pid": pid, "tid": ev["tid"]}
        if ev["ph"] == "X":
            out["dur"] = ev["dur_s"] * 1e6
        if ev["ph"] == "i":
            out["s"] = "t"                  # instant scope: thread
        if ev["args"]:
            out["args"] = dict(ev["args"])
        events.append(out)
    events.insert(0, {"ph": "M", "name": "process_name", "pid": pid,
                      "tid": 0, "args": {"name": process_name}})
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"dropped_events": tracer.dropped()}}


# ----------------------------------------------------------------------------
# Prometheus text exposition
# ----------------------------------------------------------------------------
_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")

# engine-summary keys that are monotonic counts (everything else in the
# summary is a gauge: rates, percentiles, occupancies)
_COUNTER_KEYS = frozenset({
    "requests", "tokens", "prefill_tokens", "steps", "decode_steps",
    "spec_drafted", "spec_accepted", "prefix_lookups", "prefix_hits",
    "prefill_tokens_skipped", "fork_admissions", "cancelled",
    "cow_copies", "kv_pages_shared", "prefix_pages_evicted",
})


def _mname(*parts: str) -> str:
    return _NAME_OK.sub("_", "_".join(p.strip("_") for p in parts))


def _fmt_value(v: Any) -> Optional[str]:
    if isinstance(v, bool):
        return "1" if v else "0"
    if not isinstance(v, (int, float)):
        return None
    f = float(v)
    if not math.isfinite(f):
        # "no data yet" is an ABSENT series in Prometheus, not a NaN
        # sample: a NaN line poisons every recording rule / aggregation
        # that touches it, and +/-Inf never describes a real scrape.
        # Skipping the line is the exposition-format idiom for absence.
        return None
    return repr(f) if isinstance(v, float) else str(v)


def _line(out: List[str], name: str, value: Any,
          labels: Optional[Dict[str, str]] = None,
          mtype: Optional[str] = None,
          typed: Optional[set] = None) -> None:
    sval = _fmt_value(value)
    if sval is None:
        return
    if mtype and typed is not None and name not in typed:
        typed.add(name)
        out.append(f"# TYPE {name} {mtype}")
    lab = ""
    if labels:
        body = ",".join(
            '%s="%s"' % (k, str(v).replace("\\", "\\\\")
                         .replace('"', '\\"').replace("\n", "\\n"))
            for k, v in sorted(labels.items()))
        lab = "{" + body + "}"
    out.append(f"{name}{lab} {sval}")


def _hist_lines(out: List[str], name: str, hist: Dict[str, List],
                labels: Optional[Dict[str, str]], typed: set) -> None:
    """Fixed-bucket latency histogram -> cumulative `le` series.  Our
    edges bracket every count (first bucket reaches to 0, last is
    unbounded), so the +Inf bucket equals the total count exactly."""
    edges = hist["edges_s"]
    counts = hist["counts"]
    if name not in typed:
        typed.add(name)
        out.append(f"# TYPE {name} histogram")
    cum = 0
    # counts[i] covers (edges[i], edges[i+1]]; upper bounds skip the
    # leading 0.0 edge and end on the "inf" sentinel
    for upper, c in zip(list(edges[1:]), counts):
        cum += int(c)
        le = "+Inf" if upper == "inf" else repr(float(upper))
        _line(out, name + "_bucket", cum, {**(labels or {}), "le": le})
    _line(out, name + "_count", cum, labels)


def prometheus_text(payload: Dict[str, Any],
                    prefix: str = "repro") -> str:
    """Render the gateway /metrics JSON payload as Prometheus text
    exposition.  Strictly derived: every sample is read from `payload`,
    so the JSON and Prometheus views are always the same scrape."""
    out: List[str] = []
    typed: set = set()

    if payload.get("schema_version") is not None:
        _line(out, _mname(prefix, "metrics_schema_version"),
              payload["schema_version"], mtype="gauge", typed=typed)

    engine = payload.get("engine") or {}
    for key in sorted(engine):
        val = engine[key]
        mtype = "counter" if key in _COUNTER_KEYS else "gauge"
        name = _mname(prefix, "engine", key)
        if mtype == "counter":
            name = _mname(name, "total")
        _line(out, name, val, mtype=mtype, typed=typed)

    for key in ("n_running", "n_queued", "kv_pages_free"):
        if key in payload:
            _line(out, _mname(prefix, key), payload[key],
                  mtype="gauge", typed=typed)

    gw = payload.get("gateway") or {}
    for key in sorted(gw):
        mtype = "gauge" if key in ("inflight", "max_pending") \
            else "counter"
        name = _mname(prefix, "gateway", key)
        if mtype == "counter":
            name = _mname(name, "total")
        _line(out, name, gw[key], mtype=mtype, typed=typed)

    fleet = payload.get("fleet") or {}
    for key, val in sorted((fleet.get("counters") or {}).items()):
        _line(out, _mname(prefix, "fleet", key, "total"), val,
              mtype="counter", typed=typed)
    for key in ("n_replicas", "n_live"):
        if key in fleet:
            _line(out, _mname(prefix, "fleet", key), fleet[key],
                  mtype="gauge", typed=typed)
    for key in ("affinity_hits", "affinity_misses"):
        if fleet.get(key) is not None:
            _line(out, _mname(prefix, "fleet", key, "total"),
                  fleet[key], mtype="counter", typed=typed)
    for rid, rep in sorted((fleet.get("replicas") or {}).items()):
        labels = {"replica": rid}
        _line(out, _mname(prefix, "replica_up"),
              bool(rep.get("alive")), labels, mtype="gauge", typed=typed)
        _line(out, _mname(prefix, "replica_pending"),
              rep.get("pending"), labels, mtype="gauge", typed=typed)
        _line(out, _mname(prefix, "replica_dispatches_total"),
              rep.get("dispatches"), labels, mtype="counter",
              typed=typed)
        snap = rep.get("snapshot") or {}
        for key in ("kv_occupancy", "n_running", "n_queued"):
            if key in snap:
                _line(out, _mname(prefix, "replica", key), snap[key],
                      labels, mtype="gauge", typed=typed)
        # digital-twin drift audit (obs/drift.py): NaN ratio before
        # calibration renders as an absent series, so dashboards show
        # drift only once it is a meaningful number
        drift = rep.get("drift") or {}
        for key in ("sim_drift_ratio", "sim_drift_alarm",
                    "sim_drift_cusum", "sim_measured_ratio"):
            if key in drift:
                _line(out, _mname(prefix, "replica", key), drift[key],
                      labels, mtype="gauge", typed=typed)
        if "sim_drift_alarms" in drift:
            _line(out, _mname(prefix, "replica_sim_drift_alarms_total"),
                  drift["sim_drift_alarms"], labels, mtype="counter",
                  typed=typed)

    # SLO alert state machines (obs/slo.py): level as an enum gauge
    # (0=ok 1=warn 2=page) plus the page-window burn rates behind it
    slo = payload.get("slo") or {}
    for st in slo.get("states") or []:
        labels = {"scope": str(st.get("scope")),
                  "slo": str(st.get("slo"))}
        lvl = LEVEL_VALUE.get(st.get("level"), 0)
        _line(out, _mname(prefix, "slo_alert_level"), lvl, labels,
              mtype="gauge", typed=typed)
        burn = st.get("burn") or {}
        for bkey in ("page_long", "page_short"):
            if bkey in burn:
                _line(out, _mname(prefix, "slo_burn", bkey),
                      burn[bkey], labels, mtype="gauge", typed=typed)
        _line(out, _mname(prefix, "slo_transitions_total"),
              st.get("transitions"), labels, mtype="counter",
              typed=typed)

    for hname, hist in sorted((payload.get("histograms") or {}).items()):
        _hist_lines(out, _mname(prefix, hname.removesuffix("_s"),
                                "seconds"), hist, None, typed)

    return "\n".join(out) + "\n"
