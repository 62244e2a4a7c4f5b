"""The traced run's device timeline: `torch.profiler` over a sub-window
of whole engine steps, read back as kernel intervals by name.

The port's five CUDA kernels are known by the names of their
`__global__` functions (`KERNELS`: the wrapper each belongs to); every
other device operation of a step is glue.  A CUDA graph's kernels come
back one by one, as launched from the replay.  Each step runs under a
`record_function` marker, whose host interval on the profiler's clock
ties the tracer's spans (host clock) to the device timeline.  Nothing
is written to disk but the Chrome trace, under `TMPDIR`.
"""
from __future__ import annotations

import os
import re
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

KERNELS = {"cols_kernel": "cim_gemv", "rows_kernel": "cim_gemv",
           "swiglu_kernel": "swiglu_qgemv",
           "decode_kernel": "paged_flash_decode",
           "merge_kernel": "paged_flash_decode",
           "verify_kernel": "paged_flash_verify",
           "flash_decode_kernel": "flash_decode"}
MARK = "portbench.step"


def base_name(name: str) -> str:
    """`void (anonymous namespace)::cols_kernel<4>(float const*, ...)`
    -> `cols_kernel`; `Memcpy HtoD (...)` -> `Memcpy`."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void\s+)?([\w:]+)", name)
    return m.group(1).split("::")[-1] if m else name


@dataclass
class Timeline:
    host_t0: float                  # host clock at the profiler's start
    host_t1: float                  # ... and at its stop
    ops: List[Tuple[str, int, int]] = field(default_factory=list)
    marks: List[Tuple[int, int]] = field(default_factory=list)
    steps: Tuple[int, int] = (0, 0)  # [first, last) step profiled

    @property
    def window_s(self) -> float:
        return self.host_t1 - self.host_t0

    def by_kernel(self) -> Dict[str, float]:
        """Device seconds by the wrapper a kernel belongs to; "glue" for
        every other device operation."""
        out: Dict[str, float] = {}
        for name, _, dur in self.ops:
            k = KERNELS.get(base_name(name), "glue")
            out[k] = out.get(k, 0.0) + dur * 1e-9
        return out

    def by_name(self) -> Dict[str, float]:
        """Device seconds by kernel (or operation) name."""
        out: Dict[str, float] = {}
        for name, _, dur in self.ops:
            k = base_name(name)
            out[k] = out.get(k, 0.0) + dur * 1e-9
        return out

    def count(self, wrapper: str) -> int:
        return sum(1 for name, _, _ in self.ops
                   if KERNELS.get(base_name(name)) == wrapper)

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, sorted."""
        iv = sorted((s, s + d) for _, s, d in self.ops)
        out: List[Tuple[int, int]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-9


class Profiler:
    """Start and stop between steps; `mark()` wraps one step."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof.start()
        self.t0 = time.perf_counter()

    def mark(self):
        return torch.profiler.record_function(MARK)

    def stop(self) -> Timeline:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.stop()
        tl = Timeline(self.t0, self.t1)
        for ev in self._prof.profiler.kineto_results.events():
            start = _ns(ev, "start")
            dur = _ns(ev, "duration")
            if ev.name() == MARK:
                if ev.device_type() != torch.autograd.DeviceType.CUDA:
                    tl.marks.append((start, start + dur))
            elif ev.device_type() == torch.autograd.DeviceType.CUDA:
                tl.ops.append((ev.name(), start, dur))
        tl.marks.sort()
        path = os.path.join(tempfile.gettempdir(), "portbench_trace.json")
        self._prof.export_chrome_trace(path)
        return tl


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def idle_gaps(tl: Timeline, step_t0: List[float],
              spans: List[dict]) -> Dict[str, float]:
    """Idle device seconds inside the profiled window by what the host
    was doing: inside a tracer span (its name) or between them
    ("between_calls").  Host times map onto the profiler's clock through
    the step markers."""
    if not tl.marks or not step_t0:
        return {}
    offs = sorted(m[0] * 1e-9 - t for m, t in zip(tl.marks, step_t0))
    off = offs[len(offs) // 2]
    lo = tl.marks[0][0] * 1e-9
    hi = tl.marks[-1][1] * 1e-9
    iv = [(a, b, sp["name"]) for sp in spans
          for a, b in [(sp["t_s"] + off, sp["t_s"] + sp["dur_s"] + off)]
          if b > lo and a < hi]
    busy = tl.busy()
    out: Dict[str, float] = {}
    prev = lo
    for s, e in busy + [(int(hi * 1e9), int(hi * 1e9))]:
        s_s, e_s = s * 1e-9, e * 1e-9
        if s_s > prev:
            mid = 0.5 * (prev + min(s_s, hi))
            label = next((n for a, b, n in iv if a <= mid < b),
                         "between_calls")
            out[label] = out.get(label, 0.0) + (min(s_s, hi) - prev)
        prev = max(prev, e_s)
        if prev >= hi:
            break
    return out
