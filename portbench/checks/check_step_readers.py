"""The step-span readers leave out the calls that overlap the
device-traced sub-window, where the profiler slows each launch, and
read every call when there is none (the CPU)."""
import pytest

from _cpu import harness
from devtrace import Timeline

READERS = ["decode_input_wait_ms", "decode_launch_ms", "decode_replay_ms"]


def _call(t_s, ms, phase="decode"):
    """One call's step spans from `t_s`: each phase `ms` on both
    clocks."""
    return [dict(name=n, t_s=t_s + i * ms / 1e3, dur_s=ms / 1e3,
                 args=dict(phase=phase, device_ms=ms))
            for i, n in enumerate(("step_inputs", "step_replay",
                                   "step_sample"))]


@pytest.mark.parametrize("name", READERS)
def check_readers_skip_the_profiled_calls(name):
    read = harness.load_module("metrics", name).read
    spans = (_call(1.0, 2.0) + _call(2.0, 4.0) + _call(2.0, 90.0, "prefill")
             + _call(9.99, 50.0) + _call(10.5, 50.0) + _call(12.0, 6.0))
    run = harness.Run(device="cpu", spans=spans)
    assert read(run) == pytest.approx(
        (2.0 + 4.0 + 50.0 + 50.0 + 6.0) / 5)
    # 9.99 s ends inside the profiled [10, 11]; 10.5 s starts inside it
    run.timeline = Timeline(10.0, 11.0)
    assert read(run) == pytest.approx((2.0 + 4.0 + 6.0) / 3)
    run.timeline = Timeline(0.0, 20.0)
    assert read(run) is None
