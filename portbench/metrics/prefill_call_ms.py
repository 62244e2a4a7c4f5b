"""engine layer: mean host time of a prefill call, from the port's
tracer (`prefill_chunk` spans) over the window."""


def read(run):
    d = [s["dur_s"] for s in run.spans if s["name"] == "prefill_chunk"]
    return 1e3 * sum(d) / len(d) if d else None
