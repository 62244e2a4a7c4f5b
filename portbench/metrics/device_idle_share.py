"""device layer: share of the device-traced sub-window in which no
operation ran on the card (the union of the trace's device intervals)."""


def read(run):
    tl = run.timeline
    if tl is None or not tl.ops or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)
