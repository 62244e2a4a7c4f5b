"""model step layer: mean host time of a decode call's replay, from the
port's tracer: the duration of the spans of phase "decode" named
`step_replay` (the host's `graph.replay()` call, which launches the
captured step) over the window.  Calls that overlap the device-traced
sub-window are left out: under the profiler each launch is slower."""


def read(run):
    tl = run.timeline
    d = [s["dur_s"] for s in run.spans
         if s["name"] == "step_replay" and s["args"]["phase"] == "decode"
         and (tl is None or s["t_s"] + s["dur_s"] < tl.host_t0
              or s["t_s"] > tl.host_t1)]
    return 1e3 * sum(d) / len(d) if d else None
