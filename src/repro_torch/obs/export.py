"""Trace exporter.

chrome_trace   Tracer events -> Chrome trace-event JSON (the format
               Perfetto / chrome://tracing load directly): one process,
               one track per recorded thread, "X" complete spans and
               "i" instants, args (request ids, lane lists, policy
               scores) preserved per event.

The JAX package's `prometheus_text` comes with the gateway that serves
it.
"""
from __future__ import annotations

from typing import Any, Dict, List

from .trace import Tracer


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
