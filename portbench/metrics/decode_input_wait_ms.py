"""engine layer: mean time the card waits for a decode call's inputs,
from the port's tracer: the `device_ms` of the spans of phase
"decode" named `step_inputs` (CUDA events at the call's opening and
before its replay, while the host builds the tokens, lengths and tables
and copies them in) over the window.  Calls that overlap the device-traced
sub-window are left out: under the profiler each launch is slower."""


def read(run):
    tl = run.timeline
    d = [s["args"]["device_ms"] for s in run.spans
         if s["name"] == "step_inputs" and s["args"]["phase"] == "decode"
         and (tl is None or s["t_s"] + s["dur_s"] < tl.host_t0
              or s["t_s"] > tl.host_t1)]
    return sum(d) / len(d) if d else None
