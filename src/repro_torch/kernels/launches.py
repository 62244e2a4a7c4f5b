"""Kernel launch counts, for the process and for each thread.

A wrapper calls `launched(fn)` where it launches its kernel, and nowhere
else: that adds one to `fn.launches` (the process-wide count, a plain
integer on the wrapper) and to the calling thread's tally.  A CUDA graph
replay adds the launches its capture recorded (`ops.add_launches`), on
the replaying thread.  Two engine replicas step their engines on two
driver threads at once, so a capture must take back exactly its own
thread's launches (`serve.graphs.StepRunner`) and a replica's launches
are its driver thread's tally (`thread_counts(thread)`).  Tallies are
kept per `threading.Thread` object (weakly), not per thread id, which a
new thread may reuse.  One lock guards both, so concurrent wrappers lose
no count.
"""
from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, Optional

_LOCK = threading.Lock()
_THREADS: "weakref.WeakKeyDictionary[threading.Thread, Dict[str, int]]" = \
    weakref.WeakKeyDictionary()


def launched(fn: Callable, n: int = 1) -> None:
    """Count `n` launches of `fn`'s kernel on the calling thread."""
    with _LOCK:
        fn.launches += n
        tally = _THREADS.setdefault(threading.current_thread(), {})
        tally[fn.__name__] = tally.get(fn.__name__, 0) + n


def thread_counts(thread: Optional[threading.Thread] = None
                  ) -> Dict[str, int]:
    """The launches counted on `thread` (the calling thread by default)
    since the last `reset`, by wrapper name."""
    if thread is None:
        thread = threading.current_thread()
    with _LOCK:
        return dict(_THREADS.get(thread, {}))


def reset(fns) -> None:
    """Zero the process-wide counts of `fns` and every thread's tally."""
    with _LOCK:
        for fn in fns:
            fn.launches = 0
        _THREADS.clear()
