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
    again on every replay, so the counts are the kernels that ran.
  * No fallback: on a CUDA device a capture or replay that fails
    raises.  The card runs the steps eagerly only when the caller asks
    (`eager=True`).  On the CPU the steps run eagerly through the same
    static buffers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import add_launches, launch_counts


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


def _name(fn: Callable) -> str:
    owner = getattr(getattr(fn, "__self__", None), "cfg", None)
    name = getattr(fn, "__name__", repr(fn))
    return f"{owner.name}.{name}" if owner is not None else name


class StepRunner:
    def __init__(self, device, *, eager: bool = False):
        self.device = torch.device(device)
        self.graphs = self.device.type == "cuda" and not eager
        self._steps: Dict[tuple, _Step] = {}
        self._stream = self._pool = None
        if self.graphs:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()

    def __call__(self, fn: Callable, params: Any, pools: Any,
                 tokens: np.ndarray, tables: np.ndarray,
                 lengths: np.ndarray, n_new: np.ndarray) -> torch.Tensor:
        """Logits of `fn` on these inputs; the pools are updated in
        place."""
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
        if not self.graphs:
            return st.run()
        if st.graph is None:
            return self._capture(st)
        st.graph.replay()
        st.replays += 1
        add_launches(st.launches)
        return st.logits

    def _capture(self, st: _Step) -> torch.Tensor:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            logits = st.run()                  # the warm-up is this call
        logits.record_stream(cur)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                st.logits = st.run()
            st.launches = {k: n - before[k]
                           for k, n in launch_counts().items()}
        finally:                               # the capture ran nothing
            add_launches({k: before[k] - n
                          for k, n in launch_counts().items()})
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
