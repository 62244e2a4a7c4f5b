"""Span tracer: lock-free per-thread event rings for the serving stack.

EdgeCIM's whole argument is an attribution argument — decode's
memory-bound GEMV is where time and energy go (paper Fig. 2) — and the
runtime now spans gateway -> fleet router -> driver thread -> engine
phases.  Windowed aggregates (serve/telemetry.py) cannot answer "where
did THIS request's p99 spike come from", so this module records the
raw timeline instead: timestamped spans and instants, tagged with a
propagated request id, exportable as a Chrome trace (obs/export.py)
that Perfetto opens directly.

Design constraints, in order:

  disabled == free   every instrumentation site guards on the single
                     attribute read `tracer.enabled` before building
                     any args dict; `span()` on a disabled tracer
                     returns one shared no-op context manager.
  no locks on the    each thread writes its OWN `collections.deque`
  hot path           (appends are atomic in CPython, maxlen gives ring
                     semantics for free); the only lock guards ring
                     REGISTRATION — once per thread, ever.
  bounded memory     rings hold `capacity` events per thread; older
                     events fall off the back.  `dropped` counts what
                     the window lost, so an export can say "partial".

Clocks are `time.monotonic` seconds (caller-overridable for tests),
exported as microseconds — the unit Chrome trace events use.

One process-wide tracer (`get_tracer()`) serves every component:
request ids must correlate across gateway, router, and N driver
threads, which means one id namespace and one export surface.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_CAPACITY = 65536        # events per thread ring

# event tuples: (ph, t_s, dur_s, name, cat, args_or_None)
#   ph "X" = complete span (dur_s meaningful), "i" = instant


class _Ring:
    """One thread's event buffer.  Only its owner thread appends;
    exporters snapshot via list(), which is safe against concurrent
    appends in CPython (worst case: an event lands after the copy)."""

    __slots__ = ("events", "tid", "thread_name", "pushes")

    def __init__(self, capacity: int, tid: int, thread_name: str):
        self.events: deque = deque(maxlen=capacity)
        self.tid = tid
        self.thread_name = thread_name
        self.pushes = 0         # total ever; minus len() = dropped

    @property
    def dropped(self) -> int:
        return self.pushes - len(self.events)


class _Span:
    """Context manager recording one complete ("X") event on exit.
    Exceptions propagate; the span still closes (the trace should show
    the step that blew up, not end just before it)."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc) -> None:
        t = self._tracer
        t._push(("X", self._t0, t._clock() - self._t0, self._name,
                 self._cat, self._args))


class _NullSpan:
    """Shared no-op context manager: `span()` on a disabled tracer
    costs one attribute check and returns this singleton."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock=time.monotonic):
        self.enabled = False
        self.capacity = capacity
        self._clock = clock
        self._tls = threading.local()
        self._rings: List[_Ring] = []
        self._reg_lock = threading.Lock()
        self._rid_counter = itertools.count()
        self.pid = os.getpid()

    # -- lifecycle ------------------------------------------------------
    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        """Drop all recorded events (rings stay registered — their
        owner threads still hold them thread-locally)."""
        for ring in list(self._rings):
            ring.events.clear()
            ring.pushes = 0

    def next_request_id(self) -> int:
        """Process-unique request id: the one value that ties a
        gateway lifecycle span to router dispatch instants and engine
        step spans across threads."""
        return next(self._rid_counter)

    # -- recording (hot path) -------------------------------------------
    def _ring(self) -> _Ring:
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            th = threading.current_thread()
            ring = _Ring(self.capacity, th.ident or 0, th.name)
            self._tls.ring = ring
            with self._reg_lock:
                self._rings.append(ring)
        return ring

    def _push(self, event: Tuple) -> None:
        ring = self._ring()
        ring.events.append(event)
        ring.pushes += 1

    def instant(self, name: str, cat: str = "engine",
                **args: Any) -> None:
        """Zero-duration event.  Callers on a hot path should guard
        with `if tracer.enabled:` so the kwargs dict is never built."""
        if not self.enabled:
            return
        self._push(("i", self._clock(), 0.0, name, cat, args or None))

    def span(self, name: str, cat: str = "engine", **args: Any):
        """`with tracer.span("prefill_chunk", lanes=3): ...`"""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, args or None)

    def complete(self, name: str, t0: float, dur_s: float,
                 cat: str = "engine", **args: Any) -> None:
        """Record a span whose interval was measured by the caller
        (the engine already times its jitted dispatches; re-measuring
        around them would double the clock reads)."""
        if not self.enabled:
            return
        self._push(("X", t0, dur_s, name, cat, args or None))

    # -- export side ----------------------------------------------------
    def rings(self) -> List[_Ring]:
        with self._reg_lock:
            return list(self._rings)

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of every ring as plain dicts (seconds-domain ts);
        obs/export.py turns these into Chrome trace events."""
        out: List[Dict[str, Any]] = []
        for ring in self.rings():
            for ph, t_s, dur_s, name, cat, args in list(ring.events):
                out.append({"ph": ph, "t_s": t_s, "dur_s": dur_s,
                            "name": name, "cat": cat,
                            "tid": ring.tid,
                            "thread_name": ring.thread_name,
                            "args": args})
        out.sort(key=lambda e: e["t_s"])
        return out

    def dropped(self) -> int:
        return sum(r.dropped for r in self.rings())


# process-wide tracer: request ids and the /debug/trace export need one
# namespace across the event loop and every driver thread
_TRACER = Tracer()
if os.environ.get("REPRO_TRACE", "") not in ("", "0"):
    _TRACER.enable()


def get_tracer() -> Tracer:
    return _TRACER
