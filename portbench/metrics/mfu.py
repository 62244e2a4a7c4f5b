"""model step layer: the share of the window the chip would need at its
peaks for the window's model calls: the sum over the calls of each
call's least time (`counts/`, `counts/peaks.py`) over the window's
seconds.  Device metric: nothing on the CPU."""
from counts.peaks import least_s


def read(run):
    if run.device != "cuda" or not run.calls:
        return None
    least = sum(least_s(*c["least"]) for c in run.calls)
    return 100.0 * least / run.window_s
