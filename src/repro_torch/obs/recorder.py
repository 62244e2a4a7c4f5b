"""Flight recorder: bounded ring of recent engine events, dumped on death.

The fleet layer evicts a replica whose driver thread dies — but
evicting silently discards the one thing a postmortem needs: what the
engine was doing in the seconds before the fatal step.  The recorder is
the black box for that crash: every engine lifecycle event (admit,
prefill chunk, decode step, preempt, finish, cancel, eviction) lands in
a small ring regardless of whether tracing is enabled, and
`EngineDriver` dumps it to disk when its loop dies.

Unlike the tracer (opt-in, high-volume, per-thread rings), the recorder
is always on, tiny (default 512 events), and single-ring: engine events
are produced only by the one driver thread that owns the engine, so a
plain deque suffices.  Cost per event is one tuple append.

Dumps go to `REPRO_FLIGHT_DIR` (default `flight_records/` under the
cwd) as `flight-<label>-<pid>.json`:

    {"label": "replica-0", "reason": "boom", "pushes": 1234,
     "events": [{"t_s": ..., "kind": "decode_step", ...}, ...]}
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 512
ENV_FLIGHT_DIR = "REPRO_FLIGHT_DIR"


class FlightRecorder:
    """Always-on bounded ring of engine events.

    `record(kind, **fields)` is the single producer API; `snapshot()`
    and `dump(reason)` are the consumer side.  The ring is written by
    the engine's owning thread and read (rarely) by whoever asks for a
    postmortem, so deque append/list() atomicity is all the safety we
    need — same argument as obs/trace.py, without even the per-thread
    indirection.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 label: str = "engine", clock=time.monotonic):
        self.capacity = capacity
        self.label = label
        self._clock = clock
        self._events: deque = deque(maxlen=capacity)
        self.pushes = 0

    def record(self, kind: str, **fields: Any) -> None:
        self._events.append((self._clock(), kind, fields or None))
        self.pushes += 1

    @property
    def dropped(self) -> int:
        return self.pushes - len(self._events)

    def snapshot(self) -> List[Dict[str, Any]]:
        out = []
        for t_s, kind, fields in list(self._events):
            ev = {"t_s": t_s, "kind": kind}
            if fields:
                ev.update(fields)
            out.append(ev)
        return out

    def to_payload(self, reason: str = "") -> Dict[str, Any]:
        return {
            "label": self.label,
            "reason": reason,
            "pid": os.getpid(),
            "thread": threading.current_thread().name,
            "capacity": self.capacity,
            "pushes": self.pushes,
            "dropped": self.dropped,
            "events": self.snapshot(),
        }

    def dump(self, reason: str = "",
             directory: Optional[str] = None) -> Optional[str]:
        """Write the ring to disk; returns the path, or None if the
        write itself failed (a postmortem must never take down the
        thread that is already dying)."""
        directory = directory or os.environ.get(
            ENV_FLIGHT_DIR, "flight_records")
        try:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(
                directory, f"flight-{self.label}-{os.getpid()}.json")
            with open(path, "w") as f:
                json.dump(self.to_payload(reason), f, indent=1,
                          default=str)
            return path
        except OSError:
            return None
