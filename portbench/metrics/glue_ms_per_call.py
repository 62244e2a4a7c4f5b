"""model step layer: device ms a model call spends outside the port's
named CUDA kernels (norms, RoPE, the K/V rounding and page writes, the
recurrent cells' element-wise work, copies), from the device trace's
sub-window over the model calls of its steps."""


def read(run):
    if not run.timeline_ok or not run.prof_calls:
        return None
    return 1e3 * run.timeline.by_kernel().get("glue", 0.0) / len(
        run.prof_calls)
