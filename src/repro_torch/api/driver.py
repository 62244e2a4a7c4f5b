"""EngineDriver: the one thread that owns a PagedServeEngine (PyTorch
port of `repro.api.driver`).

`PagedServeEngine` is synchronous and single-threaded by contract —
its step loop mutates block tables, lane lists, and device pools with
no locking.  The gateway therefore never touches the engine from the
asyncio event loop: everything crosses this boundary as a JOB — a
callable executed on the driver thread between engine steps — and
results come back on `concurrent.futures.Future`s.  Submissions,
cancellations, and metrics snapshots are all jobs, so they serialize
with `step()` for free and the engine needs no locks at all.

The driver also closes the one gap the engine's callback API leaves
for async callers: `ServeRequest.on_token` fires per token, but
nothing fires on completion.  `watch(req, on_done)` registers a
request; after every step (and every job drain) the driver sweeps its
watchlist and invokes `on_done(req)` exactly once when `req.done`
flips — cancellations, rejections, and clean finishes all land there.

On the card the whole loop runs with the engine's own CUDA stream
current (`engine.stream`): steps, sampling copies, page writes, graph
replays and the jobs all go to it, and the kernels launch on it
(`kernels._build.stream_handle` reads the thread's current stream), so
replicas that share a card overlap and never wait for each other.  A
fatal step error ends the loop: every watcher and every later job
fails, and the engine's flight recorder is dumped for the postmortem.

At tp > 1 the driver runs on rank 0, and the engine's other ranks
replay what it does (`repro_torch.dist.lockstep.follow`).  The three
jobs that change the engine's state, `submit`, `cancel` and
`extract_queued`, are replicated: the engine records each as an op of
its next tick.  The loop sends a tick with each step (the engine's
`step()` does) and one without a step when ops were applied while the
engine was idle, and none while it idles without them.  Every other
`call(fn)` job (a metrics snapshot, the fleet tap) must only read: it
runs on rank 0 alone.  On shutdown the loop sends the STOP tick, after a
fatal step error the ABORT tick, before it marks itself dead.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs.trace import get_tracer


class EngineDriver:
    def __init__(self, engine, idle_wait_s: float = 0.05, tap=None):
        """`tap(engine)`, when given, runs on the driver thread once per
        loop iteration (after the step / job drain): the fleet replica
        uses it to publish an occupancy + prefix-fingerprint snapshot
        that the router reads lock-free per dispatch.  A tap exception
        never kills the serve loop."""
        lockstep = getattr(engine, "lockstep", None)
        if lockstep is not None and not lockstep.leader:
            raise ValueError("an engine of rank >= 1 follows rank 0's "
                             "ticks (dist.lockstep.follow), not a driver")
        self.engine = engine
        self._tap = tap
        self._jobs: "queue.Queue[Tuple[Callable, Future]]" = queue.Queue()
        self._watch: List[Tuple[Any, Callable]] = []
        self._wake = threading.Event()
        self._stop = threading.Event()
        # guards the dead flag vs. job enqueue: without it a job could
        # land in the queue after the thread's final drain and leave
        # its Future unresolved forever
        self._lock = threading.Lock()
        self._dead = False
        self._idle_wait_s = idle_wait_s
        self._thread = threading.Thread(target=self._run,
                                        name="engine-driver", daemon=True)
        self.steps = 0
        self.error: Optional[BaseException] = None   # fatal step failure
        self.tracer = get_tracer()
        self.flight_path: Optional[str] = None   # postmortem dump, set
        #   when a fatal step error makes the engine's flight recorder
        #   write its ring to disk

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "EngineDriver":
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        """The loop runs and no step failed (a failed loop may still be
        sending its ABORT tick at tp > 1)."""
        return self._thread.is_alive() and self.error is None

    # -- cross-thread API ----------------------------------------------
    def call(self, fn: Callable[[Any], Any]) -> Future:
        """Schedule `fn(engine)` on the driver thread (between steps);
        returns a Future with its result or exception.  A job sent to a
        driver that already died (fatal step error / stopped) fails
        immediately instead of hanging its caller forever."""
        fut: Future = Future()
        with self._lock:
            if self._dead:
                fut.set_exception(RuntimeError(
                    f"engine driver not running"
                    f"{f' ({self.error!r})' if self.error else ''}"))
                return fut
            self._jobs.put((fn, fut))
        self._wake.set()
        return fut

    def submit(self, reqs: List, on_done: Callable) -> Future:
        """Submit requests in order on the engine thread (fork children
        must follow their parent) and watch each for completion;
        resolves to the engine-assigned eids."""
        def job(engine):
            eids = []
            for r in reqs:
                engine.submit(r)
                self._watch.append((r, on_done))
                eids.append(r.eid)
            return eids
        return self.call(job)

    def cancel(self, eids: List[int]) -> Future:
        """Cancel by engine id; resolves to the number actually
        cancelled (watchers fire via the normal done sweep)."""
        return self.call(
            lambda engine: sum(bool(engine.cancel(e)) for e in eids))

    def extract_queued(self) -> Future:
        """Fleet drain: pull every not-yet-started request out of the
        engine's scheduler queue AND this driver's watchlist, so the
        router can resubmit them (with their original on_done watchers)
        on a healthy replica.  Runs as a job, so it serializes with
        step() like everything else.  The pulled requests' telemetry
        traces are forgotten (`engine.drain_queued`) — they re-enqueue
        (and count) where they land — and any fork link is severed:
        engine ids are per-engine, so adopting parent KV across replicas
        would adopt an unrelated sequence's pages.  Resolves to
        [(req, on_done)]."""
        def job(engine):
            pulled = engine.drain_queued()
            by_id = {id(r): r for r in pulled}
            out, still = [], []
            for req, cb in self._watch:
                if id(req) in by_id:
                    out.append((req, cb))
                else:
                    still.append((req, cb))
            self._watch = still
            watched = {id(r) for r, _ in out}
            for req in pulled:
                req.eid = -1
                req.fork_from = None
                req.forked_tokens = 0
                if id(req) not in watched:      # submitted without a
                    out.append((req, None))     # watcher: still re-home
            return out
        return self.call(job)

    # -- loop -----------------------------------------------------------
    def _drain_jobs(self) -> None:
        while True:
            try:
                fn, fut = self._jobs.get_nowait()
            except queue.Empty:
                return
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                with self.tracer.span("driver_job", cat="driver",
                                      thread=self._thread.name):
                    fut.set_result(fn(self.engine))
            except BaseException as e:   # the loop must survive any job
                fut.set_exception(e)

    def _sweep_done(self) -> None:
        if not self._watch:
            return
        still = []
        for req, on_done in self._watch:
            if req.done:
                try:
                    on_done(req)
                except Exception:       # a dead client callback must
                    pass                # never kill the serve loop
            else:
                still.append((req, on_done))
        self._watch = still

    def _run_tap(self) -> None:
        if self._tap is None:
            return
        try:
            self._tap(self.engine)
        except Exception:       # a broken snapshot publisher must
            pass                # never take the engine down

    def _run(self) -> None:
        stream = getattr(self.engine, "stream", None)
        if stream is None:              # a CPU engine (or a stand-in)
            ctx = contextlib.nullcontext()
        else:
            import torch
            ctx = torch.cuda.stream(stream)
        with ctx:
            self._loop()

    def _loop(self) -> None:
        engine = self.engine
        lockstep = getattr(engine, "lockstep", None)    # tp > 1, rank 0
        while not self._stop.is_set():
            self._drain_jobs()
            self._sweep_done()
            if engine.busy:
                try:
                    engine.step()
                except BaseException as e:
                    # the engine's host/device state may be corrupt:
                    # stop serving rather than limp on.  The recorded
                    # error surfaces through /healthz (503), so a
                    # liveness probe restarts the instance.  Dump the
                    # engine's flight recorder first: the dead-replica
                    # eviction that follows needs a postmortem, not
                    # silence.
                    self.error = e
                    recorder = getattr(engine, "recorder", None)
                    if recorder is not None:
                        recorder.record("fatal", error=repr(e))
                        self.flight_path = recorder.dump(reason=repr(e))
                    break
                self.steps += 1
                # publish AFTER the step but BEFORE the next sweep
                # fires done-watchers: by the time a client sees its
                # completion, the fleet snapshot (incl. any prefix
                # pages this step committed) is already visible
                self._run_tap()
            else:
                if lockstep is not None:
                    try:            # ops applied while idle
                        lockstep.flush()
                    except Exception as e:
                        self.error = e
                        break
                self._run_tap()
                self._wake.wait(self._idle_wait_s)
                self._wake.clear()
        if lockstep is not None:    # the other ranks stop (abort) too
            lockstep.finish(abort=self.error is not None)
        # shutdown / fatal error: mark dead under the lock (new call()s
        # now fail fast), drain whatever was already queued, and fail
        # every request still in flight — a watcher left un-notified
        # would hang its gateway handler forever and pin its inflight
        # budget slot
        with self._lock:
            self._dead = True
            self._drain_jobs()
        for req, _ in self._watch:
            if not req.done:
                req.done = True
                req.cancelled = True
        self._sweep_done()
