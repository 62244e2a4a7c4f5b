"""engine layer: mean host time of a decode call, from the port's tracer
(`decode_step` spans: the dispatch of the step through the sampled
tokens' copy to the host) over the window."""


def read(run):
    d = [s["dur_s"] for s in run.spans if s["name"] == "decode_step"]
    return 1e3 * sum(d) / len(d) if d else None
