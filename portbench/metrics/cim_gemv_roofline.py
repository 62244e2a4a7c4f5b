"""kernels layer: `cim_gemv`'s share of its roofline over the device
trace's sub-window: the sum of its calls' least times (`counts/`) over
the device seconds of its kernels, found by name.  Nothing where the
trace holds none of its calls."""
from counts.peaks import least_s

KERNEL = "cim_gemv"


def read(run):
    if not run.timeline_ok:
        return None
    calls = [fb for c in run.prof_calls for fb in c["kernels"].get(KERNEL, ())]
    busy = run.timeline.by_kernel().get(KERNEL, 0.0)
    if not calls or busy <= 0:
        return None
    return 100.0 * sum(least_s(f, b) for f, b in calls) / busy
