"""Rank 0 leads a tensor-parallel engine's group: the tick.

At tp > 1 one engine runs in every rank of its group, and the ranks meet
in a step's collectives only while their schedulers make the same
decisions.  Those decisions read a clock (a request's enqueue stamp, the
`now` a step's admission expires queued deadlines against) and follow the
calls that change the engine's state (submit, cancel, the fleet drain),
and only rank 0 receives those from the gateway.  So rank 0 leads: it
reads the clock for every decision, applies every call, and once a step
call it broadcasts a tick to the other ranks of the engine:

  now    rank 0's clock reading for the step (its float64 bits)
  ops    the state-changing calls rank 0 applied since the last tick, in
         order: ("submit", eid, stamp, fields) with rank 0's enqueue
         stamp, ("cancel", eid), ("drain",)
  flags  STEP (take a step at `now`), STOP (rank 0 stopped serving),
         ABORT (rank 0 failed)

The followers (ranks >= 1) apply the ops in order, so engine ids come out
equal (they are assigned in order), and take the same step at the tick's
`now`: a follower never reads its own clock for a decision.  Two ways:

  replicated  every rank makes the same calls itself (`run(requests)`,
              the offline launcher, a test): a follower's `step()`
              receives the tick and takes only the submits' stamps from
              it, re-keying its queue before the step admits
              (`Scheduler.restamp`).
  driven      only rank 0 is called (the gateway's `EngineDriver`);
              ranks >= 1 run `follow(engine)`, which replays the ops and
              steps until a STOP tick (or raises at an ABORT one).  The
              driver sends an op-only tick when calls were applied while
              the engine was idle, and no tick at all while it is idle
              without calls.

A tick is one broadcast of a four-int64 header (payload bytes, now,
flags, sequence number) and, only when there are ops, a second one of
the pickled ops: at most two a step call.  Ticks are counted here
(`tick_counts`, `tick_seconds`), apart from the step's collectives
(`shard.collective_counts`).  A driven follower waits in the header's
broadcast for as long as rank 0 is idle, so a gateway gives each engine
a tick group with no timeout to speak of beside the bounded one of its
step's collectives (`shard.replica_groups`).

A fleet of such engines (a gateway's replicas at tp > 1) has one more
channel, `FleetChannel`, on a group of its own (`shard.fleet_group`):
rank 0 tells the other ranks when a replica joins (ADD: every rank
makes the new engine's groups, in the same order, so the followers are
told before rank 0 makes them) and when the fleet stopped (STOP).
"""
from __future__ import annotations

import contextlib
import pickle
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

STEP, STOP, ABORT = 1, 2, 4
FINISH_WAIT_S = 1.0     # how long rank 0 waits for the followers to take
#   its STOP / ABORT tick: a follower waiting for a tick takes it at once,
#   one that died (or sits in a failed step's collective) takes none

_COUNTS: Dict[str, int] = {"ticks": 0, "broadcasts": 0}
_SECONDS = {"ticks": 0.0}
_COUNT_LOCK = threading.Lock()


def tick_counts() -> Dict[str, int]:
    """Ticks this process sent or received since the last reset, and the
    broadcasts they took."""
    with _COUNT_LOCK:
        return dict(_COUNTS)


def tick_seconds() -> float:
    """Host seconds spent in those ticks: rank 0's sends, a follower's
    receives from the header's arrival on (its wait for rank 0 to reach
    the tick is not the tick's cost)."""
    with _COUNT_LOCK:
        return _SECONDS["ticks"]


def reset_tick_counts() -> None:
    with _COUNT_LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0
        _SECONDS["ticks"] = 0.0


def _count(broadcasts: int, t0: float) -> None:
    dt = time.perf_counter() - t0
    with _COUNT_LOCK:
        _COUNTS["ticks"] += 1
        _COUNTS["broadcasts"] += broadcasts
        _SECONDS["ticks"] += dt


def _bits(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", x))[0]


def _float(bits: int) -> float:
    return struct.unpack("<d", struct.pack("<q", bits))[0]


@dataclass
class Tick:
    now: float
    flags: int
    ops: List[Tuple] = field(default_factory=list)


class LockstepError(RuntimeError):
    """A follower received what rank 0 cannot have sent in lockstep (a
    tick out of sequence, no step where a step was due), or rank 0
    aborted."""


class Lockstep:
    """One engine's tick channel on `group` (its ranks) and `tick_group`
    (the same ranks; `group` itself when not given).  Rank 0 of the group
    leads: `record` keeps its ops, `send` broadcasts them with a clock
    reading; a follower's `recv` returns the next tick."""

    def __init__(self, group, clock: Callable[[], float],
                 tick_group=None):
        import torch.distributed as dist
        self.tick_group = tick_group if tick_group is not None else group
        self.rank = dist.get_rank(group)
        self.leader = self.rank == 0
        self._src = dist.get_global_rank(self.tick_group, 0)
        self._clock = clock
        self.now = 0.0          # the last tick's reading (a follower's
        #   clock between ticks)
        self.ops: List[Tuple] = []      # rank 0's, since the last tick
        self.seq = 0            # ticks this engine sent or received
        self.closed = False     # a STOP or ABORT went through

    def clock(self) -> float:
        """The clock a decision reads: rank 0's own, a follower's the
        last tick's reading."""
        return self._clock() if self.leader else self.now

    def record(self, op: Tuple) -> None:
        if self.leader:
            self.ops.append(op)

    def send(self, now: float, flags: int,
             wait_s: Optional[float] = None) -> None:
        """Rank 0: broadcast one tick with the ops recorded since the
        last one; with `wait_s`, give up waiting for the followers to
        take an op-less tick after that many seconds (gloo's send waits
        for the receiver)."""
        import datetime

        import torch.distributed as dist
        assert self.leader and not self.closed
        t0 = time.perf_counter()
        payload = (pickle.dumps(self.ops, protocol=pickle.HIGHEST_PROTOCOL)
                   if self.ops else b"")
        self.ops = []
        self.now = now
        head = torch.tensor([len(payload), _bits(now), flags, self.seq],
                            dtype=torch.int64)
        self.seq += 1
        self.closed = bool(flags & (STOP | ABORT))
        if wait_s is not None:
            assert not payload
            dist.broadcast(head, src=self._src, group=self.tick_group,
                           async_op=True).wait(
                timeout=datetime.timedelta(seconds=wait_s))
            _count(1, t0)
            return
        dist.broadcast(head, src=self._src, group=self.tick_group)
        if payload:
            body = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
            dist.broadcast(body, src=self._src, group=self.tick_group)
        _count(2 if payload else 1, t0)

    def recv(self) -> Tick:
        """A follower: the next tick from rank 0."""
        import torch.distributed as dist
        assert not self.leader
        head = torch.empty(4, dtype=torch.int64)
        dist.broadcast(head, src=self._src, group=self.tick_group)
        t0 = time.perf_counter()        # waiting for rank 0 is not a tick
        n, bits, flags, seq = (int(v) for v in head.tolist())
        if seq != self.seq:
            raise LockstepError(f"tick {seq} arrived where tick {self.seq} "
                                f"was due: two engines share a tick group")
        self.seq += 1
        ops: List[Tuple] = []
        if n:
            body = torch.empty(n, dtype=torch.uint8)
            dist.broadcast(body, src=self._src, group=self.tick_group)
            ops = pickle.loads(body.numpy().tobytes())
        self.now = _float(bits)
        self.closed = bool(flags & (STOP | ABORT))
        _count(2 if n else 1, t0)
        return Tick(self.now, flags, ops)

    def flush(self) -> None:
        """Rank 0, idle: send the ops applied since the last tick, with
        no step (nothing when there are none)."""
        if self.ops:
            self.send(self._clock(), 0)

    def finish(self, abort: bool) -> None:
        """Rank 0 stops serving: the STOP tick (ABORT after a failure),
        once, without the ops left (the followers stop at it).  Best
        effort: it waits `FINISH_WAIT_S` at most, and a broken group's
        error is dropped (the peers may be gone already)."""
        if not self.leader or self.closed:
            return
        self.ops = []
        try:
            self.send(self._clock(), ABORT if abort else STOP,
                      wait_s=FINISH_WAIT_S)
        except RuntimeError:
            self.closed = True


def follow(engine) -> None:
    """Ranks >= 1 of a driven engine: apply each of rank 0's ticks (its
    ops, then its step at its clock reading) until a STOP tick, when it
    returns; an ABORT tick raises `LockstepError`, and any error of a
    step propagates.  On the card everything runs with the engine's
    stream current, as a driver's loop does."""
    ls = engine.lockstep
    if ls is None or ls.leader:
        raise ValueError("follow() runs an engine of rank >= 1 at tp > 1")
    stream = getattr(engine, "stream", None)
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        while True:
            tick = ls.recv()
            engine.replay(tick.ops)
            if tick.flags & ABORT:
                raise LockstepError("rank 0 aborted the engine's group")
            if tick.flags & STOP:
                return
            if tick.flags & STEP:
                engine.step_at(tick.now)


def follow_all(engines, first: int = 0
               ) -> Tuple[List[threading.Thread], List[Any]]:
    """`follow` each engine on a daemon thread of its own (a rank >= 1
    of a gateway's replicas; thread i named for replica `first` + i).
    Returns (the threads, their outcomes): outcome i is None while
    thread i runs, then "stop" or the exception it ended with."""
    outcomes: List[Any] = [None] * len(engines)

    def run(i, eng):
        try:
            follow(eng)
            outcomes[i] = "stop"
        except Exception as e:      # the thread's end: its caller reads it
            outcomes[i] = e
    threads = [threading.Thread(target=run, args=(i, e), daemon=True,
                                name=f"follower-{first + i}")
               for i, e in enumerate(engines)]
    for t in threads:
        t.start()
    return threads, outcomes


class FleetChannel:
    """Rank 0's messages to the other ranks of a tensor-parallel fleet
    about the fleet itself, on `group` (`shard.fleet_group`): (ADD, n)
    -- the n-th replica joins, so make its groups and build its engine
    now, where rank 0 does (`launch.serve.add_tp_replica`) -- and
    (STOP, n): the fleet of n replicas stopped serving.  A message is
    one broadcast of two int64; it is not a tick (`tick_counts` leaves
    it out)."""

    ADD, STOP = 1, 2

    def __init__(self, group):
        import torch.distributed as dist
        self.group = group
        self.leader = dist.get_rank(group) == 0
        self._src = dist.get_global_rank(group, 0)
        self.closed = False

    def send(self, op: int, n: int) -> None:
        """Rank 0: one message.  STOP waits `FINISH_WAIT_S` at most for
        the followers to take it and drops a broken group's error (the
        peers may be gone already), as `Lockstep.finish` does."""
        import datetime

        import torch.distributed as dist
        assert self.leader and not self.closed
        head = torch.tensor([op, n], dtype=torch.int64)
        if op != self.STOP:
            dist.broadcast(head, src=self._src, group=self.group)
            return
        self.closed = True
        try:
            dist.broadcast(head, src=self._src, group=self.group,
                           async_op=True).wait(
                timeout=datetime.timedelta(seconds=FINISH_WAIT_S))
        except RuntimeError:
            pass

    def recv(self) -> Tuple[int, int]:
        """A follower: rank 0's next message, (op, n)."""
        import torch.distributed as dist
        assert not self.leader
        head = torch.empty(2, dtype=torch.int64)
        dist.broadcast(head, src=self._src, group=self.group)
        op, n = (int(v) for v in head.tolist())
        if op not in (self.ADD, self.STOP):
            raise LockstepError(f"fleet message {op} is neither ADD nor "
                                f"STOP")
        return op, n
