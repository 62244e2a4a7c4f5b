"""model step layer: mean device time of a decode call's replay, from
the port's tracer: the `device_ms` of the spans of phase "decode" named
`step_replay` (CUDA events before and after `graph.replay()`: the
launch's latency, the graph's kernels and the gaps between them) over
the window.  Calls that overlap the device-traced sub-window are left
out: under the profiler each launch is slower."""


def read(run):
    tl = run.timeline
    d = [s["args"]["device_ms"] for s in run.spans
         if s["name"] == "step_replay" and s["args"]["phase"] == "decode"
         and (tl is None or s["t_s"] + s["dur_s"] < tl.host_t0
              or s["t_s"] > tl.host_t1)]
    return sum(d) / len(d) if d else None
