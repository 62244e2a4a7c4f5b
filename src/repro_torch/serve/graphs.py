"""Captured serving steps: the counterpart of the JAX package's jitted
steps.

The JAX package never runs a serving step op by op.  `PagedServeEngine`
jits `serve_step` with the state donated (`repro/serve/engine.py`,
`_jit_step`), `SpecDecoder` jits the verify window
(`repro/spec/decode.py`) and the draft-model drafter its `paged_step`
(`repro/spec/drafter.py`); `jax.jit` traces once per input shape and
reuses the executable after.  `StepRunner` does the same with CUDA
graphs.  A step `fn(params, pools, {"tokens": t}, tables, lengths,
n_new) -> (logits, pools)` is captured once per (fn, tokens shape) and
replayed after:

  * Static inputs: each (fn, shape) owns device buffers for tokens,
    tables, lengths and n_new, filled with `copy_` from the caller's
    numpy arrays on every call; the graph reads them in place.
  * Static output: a replay writes the logits into the tensor its
    capture allocated and returns that tensor, which the next call of
    the same (fn, shape) overwrites.  A caller is done with the logits
    (sampled, copied to the host) before it calls again.
  * Params and pools are captured by address.  They stay the same
    tensors: the KV pools are allocated once and written in place
    (`PagedKVCache`), and so are a recurrent model's per-lane state
    leaves (`StateArena`), which the engine hands over in one dict with
    the pools (`engine.state`): the step writes them with `copy_` and
    in-place ops, and the engine's lane ops (reset, snapshot restore)
    write their rows in place between calls, so a replay reads and
    advances the same arena.  A call with other params or pools for a
    captured (fn, shape) raises.
  * The first call of a shape runs the step eagerly on the runner's side
    stream and returns that result.  This warm-up builds the kernels,
    sets their shared-memory opt-ins and allocates `cim_gemv`'s arrival
    counters outside any capture.  The capture that follows runs
    nothing; every later call is a replay.
  * All graphs of a runner share one memory pool.
  * Kernel launches (`kernels.launch_counts`): a wrapper counts its
    launch when it is called, which under a graph happens only at
    capture.  The runner takes the capture's counts back and adds them
    again on every replay, so the counts are the kernels that ran.  It
    reads the capturing thread's own counts
    (`kernels.thread_launch_counts`): another engine stepping on another
    thread meanwhile adds nothing to a capture's.
  * Engines that share a card (fleet replicas, one driver thread each)
    capture one at a time: a per-device lock covers the warm-up and the
    capture, and the capture is `thread_local`, so another thread's
    replays, allocations and stream syncs meanwhile do not invalidate
    it.
  * No fallback: on a CUDA device a capture or replay that fails
    raises.  The card runs the steps eagerly only when the caller asks
    (`eager=True`).  On the CPU the steps run eagerly through the same
    static buffers.
  * A traced call carries its `CallMarks` (`marks(fn, shape)`): the
    runner marks the replay's start and end on them, after the input
    copies and around `graph.replay()` (on the CPU, the eager step).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import add_launches, thread_launch_counts

_CAPTURE_LOCKS: Dict[torch.device, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()


def _capture_lock(device: torch.device) -> threading.Lock:
    """The lock that lets one `StepRunner` at a time capture on
    `device`."""
    with _LOCKS_GUARD:
        return _CAPTURE_LOCKS.setdefault(device, threading.Lock())


@dataclass
class _Step:
    """One (fn, tokens shape): its static buffers and, on the card, its
    graph."""
    fn: Callable
    params: Any
    pools: Any
    tokens: torch.Tensor
    tables: torch.Tensor
    lengths: torch.Tensor
    n_new: torch.Tensor
    graph: Optional[Any] = None             # torch.cuda.CUDAGraph
    logits: Optional[torch.Tensor] = None   # the graph's static output
    launches: Dict[str, int] = field(default_factory=dict)
    capture_s: float = 0.0
    replays: int = 0

    def run(self) -> torch.Tensor:
        logits, _ = self.fn(self.params, self.pools,
                            {"tokens": self.tokens}, self.tables,
                            self.lengths, self.n_new)
        return logits


PHASES = ("step_inputs", "step_replay", "step_sample")


class CallMarks:
    """The phases of one traced model call, on the device's clock.

    Four marks split the call: E0 at its opening, E1 once its inputs are
    built and copied in, E2 once the host's replay call returns (on the
    CPU, the eager step), E3 once the sampling kernels are launched,
    before the tokens' copy to the host (only where the call samples).
    Each mark is a reading of the tracer's clock and, on the card, a
    timing event on the current stream: one set of four a (step, shape),
    allocated at its first traced call.  The events are read in `close`,
    after the sync the call makes anyway (the tokens' `.cpu()` or the
    stream's `synchronize`), so a traced call adds none.  On the CPU,
    where the step runs eagerly and synchronously, the host clock's
    readings at the same marks stand in for the device's.

    `close` records one span a phase, category "step", inside the
    call's own span: `step_inputs` (E0 -> E1), `step_replay` (E1 ->
    E2) and, where the call samples, `step_sample` (from E2 until the
    tokens are on the host; on the device E2 -> E3), each with the
    call's `phase` and its `device_ms`.  While a phase lasts, a profiler
    range of its name is open (`_RecordFunctionFast`: function scope, so
    a torch profiler shows it on the host's track beside the kernels it
    launched and adds no device-side annotation to the kernels' own
    timeline)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.events = ([torch.cuda.Event(enable_timing=True)
                        for _ in range(4)]
                       if device.type == "cuda" else None)
        self.host = [0.0] * 4
        self.tracer = None
        self.phase = ""
        self.samples = False
        self._stream = None
        self._range = None

    def open(self, tracer, t0: float, phase: str, samples: bool) -> None:
        """E0, at the call's opening `t0` (a reading of `tracer.now()`)."""
        self.tracer, self.phase, self.samples = tracer, phase, samples
        self.host[0] = t0
        if self.events is not None:
            self._stream = torch.cuda.current_stream(self.device)
            self.events[0].record(self._stream)
        self._enter("step_inputs")

    def begin_replay(self) -> None:
        """E1: the inputs are in place; the replay follows."""
        self._exit()
        if self.events is not None:
            self.events[1].record(self._stream)
        self._enter("step_replay")
        self.host[1] = self.tracer.now()

    def end_replay(self) -> None:
        """E2: the host's replay call returned."""
        self.host[2] = self.tracer.now()
        self._exit()
        if self.events is not None:
            self.events[2].record(self._stream)
        if self.samples:
            self._enter("step_sample")

    def end_sample(self) -> None:
        """E3: the sampling kernels are launched; the copy follows."""
        if self.events is not None:
            self.events[3].record(self._stream)
        self.host[3] = self.tracer.now()

    def close(self, t_end: float) -> None:
        """After the call's sync, at `t_end`: one span a phase."""
        self._exit()
        h, n = self.host, 3 if self.samples else 2
        if self.events is None:
            ms = [1e3 * (h[i + 1] - h[i]) for i in range(n)]
        else:
            ev = self.events
            ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(n)]
        ends = (h[1], h[2], t_end)
        for i in range(n):
            self.tracer.complete(PHASES[i], h[i], ends[i] - h[i], cat="step",
                                 phase=self.phase, device_ms=ms[i])

    def abort(self) -> None:
        """The call raised before `close`: its open range ends, and no
        span is recorded."""
        self._exit()

    def _enter(self, name: str) -> None:
        self._range = torch._C._profiler._RecordFunctionFast(name)
        self._range.__enter__()

    def _exit(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None


def _name(fn: Callable) -> str:
    owner = getattr(getattr(fn, "__self__", None), "cfg", None)
    name = getattr(fn, "__name__", repr(fn))
    return f"{owner.name}.{name}" if owner is not None else name


class StepRunner:
    def __init__(self, device, *, eager: bool = False):
        self.device = torch.device(device)
        self.graphs = self.device.type == "cuda" and not eager
        self._steps: Dict[tuple, _Step] = {}
        self._marks: Dict[tuple, CallMarks] = {}
        self._stream = self._pool = None
        if self.graphs:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()

    def __call__(self, fn: Callable, params: Any, pools: Any,
                 tokens: np.ndarray, tables: np.ndarray,
                 lengths: np.ndarray, n_new: np.ndarray,
                 marks: Optional[CallMarks] = None) -> torch.Tensor:
        """Logits of `fn` on these inputs; the pools are updated in
        place.  `marks`, a traced call's, are marked around the step."""
        host = (tokens, tables, lengths, n_new)
        key = (fn, tokens.shape)
        st = self._steps.get(key)
        if st is None:
            bufs = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                device=self.device) for a in host]
            st = self._steps[key] = _Step(fn, params, pools, *bufs)
        elif st.params is not params or st.pools is not pools:
            raise ValueError(f"{_name(fn)} {tokens.shape}: captured on "
                             "other params or pools")
        for buf, a in zip((st.tokens, st.tables, st.lengths, st.n_new),
                          host):
            if tuple(buf.shape) != a.shape:
                raise ValueError(f"{_name(fn)}: input {a.shape} for a "
                                 f"buffer of {tuple(buf.shape)}")
            buf.copy_(torch.from_numpy(a))
        if marks is not None:
            marks.begin_replay()
        if not self.graphs:
            logits = st.run()
        elif st.graph is None:
            logits = self._capture(st)
        else:
            st.graph.replay()
            st.replays += 1
            add_launches(st.launches)
            logits = st.logits
        if marks is not None:
            marks.end_replay()
        return logits

    def marks(self, fn: Callable, shape) -> CallMarks:
        """The marks of (fn, shape)'s traced calls, allocated at the
        first."""
        key = (fn, tuple(shape))
        m = self._marks.get(key)
        if m is None:
            m = self._marks[key] = CallMarks(self.device)
        return m

    def _capture(self, st: _Step) -> torch.Tensor:
        with _capture_lock(self.device):
            t0 = time.perf_counter()
            cur = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                logits = st.run()              # the warm-up is this call
            logits.record_stream(cur)
            before = thread_launch_counts()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=self._stream,
                                      capture_error_mode="thread_local"):
                    st.logits = st.run()
                st.launches = {k: n - before[k]
                               for k, n in thread_launch_counts().items()}
            finally:                           # the capture ran nothing
                add_launches({k: before[k] - n
                              for k, n in thread_launch_counts().items()})
            st.graph = graph
            cur.wait_stream(self._stream)
            st.capture_s = time.perf_counter() - t0
        return logits

    def steps(self) -> List[Dict[str, Any]]:
        """Per (fn, shape): capture seconds, replays and the kernel
        launches of one call (the capture's wrapper calls)."""
        return [{"fn": _name(st.fn), "shape": list(st.tokens.shape),
                 "captured": st.graph is not None,
                 "capture_s": st.capture_s, "replays": st.replays,
                 "launches_per_call": st.launches}
                for st in self._steps.values()]

    def graph_of(self, fn: Callable, shape) -> Any:
        """The captured graph of (fn, shape): for timing and checking a
        replay on its static inputs, outside the launch counts."""
        st = self._steps[(fn, tuple(shape))]
        return st.graph, st.logits
