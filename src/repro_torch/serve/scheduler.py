"""Request scheduler: admission control, priorities, deadlines, chunked
prefill accounting.

Queue discipline: a heap ordered by (priority, absolute deadline,
arrival).  Admission is gated on BOTH a batch-lane budget and the paged
cache's free-page count — a request enters the running batch only when
its whole prompt fits in free pages (plus one growth page), so decode
never deadlocks on a half-prefilled request.  Requests whose deadline
passed while queued are rejected, not run: at the edge a late answer is
a wasted answer (EdgeCIM's latency-bound regime).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .paged_cache import OutOfPagesError
from .sampling import SamplingParams


@dataclass
class ServeRequest:
    prompt: np.ndarray                       # (prompt_len,) int32
    max_new_tokens: int = 32
    rid: int = 0                             # caller's label (not unique)
    priority: int = 0                        # lower value = more urgent
    deadline_s: Optional[float] = None       # relative to enqueue
    sampling: SamplingParams = field(default_factory=SamplingParams)
    spec: bool = True                        # opt out of speculative decode
    #   (only meaningful on an engine built with a SpecConfig; such an
    #   engine still serves spec=False lanes, one token per step, in the
    #   same shape-stable verify call with an empty draft window)
    on_token: Optional[Callable[[int, int], None]] = None  # (rid, token)
    logprobs: bool = False                   # record per-token (logprob,
    #   entropy) under the processed sampling distribution into
    #   `out_logprobs` (host-side O(vocab) per token; free when off)
    # parallel sampling: a request carrying `fork_from` (a sibling
    # ServeRequest over the SAME prompt, submitted first) adopts the
    # parent's prompt KV pages via `PagedKVCache.fork` at admission and
    # prefills only the final prompt token — n samples off one prompt
    # share its pages copy-on-write.  If the parent is gone before the
    # child admits (finished, cancelled, rejected) the child falls back
    # to a plain admission (possibly a prefix-cache hit).
    fork_from: Optional["ServeRequest"] = None

    # lifecycle (engine-owned)
    out_tokens: List[int] = field(default_factory=list)
    out_logprobs: List = field(default_factory=list)  # [(logprob, entropy)]
    #   parallel to out_tokens, filled only when `logprobs` is set
    done: bool = False
    rejected: bool = False                   # never ran: deadline/too big
    reject_reason: str = ""                  # expired | empty | too-big
    truncated: bool = False                  # evicted mid-generation
    cancelled: bool = False                  # aborted by the caller
    trace_id: int = -1                       # process-unique tracing id
    #   (gateway-assigned via Tracer.next_request_id; -1 = untraced
    #   caller).  Unlike rid it never collides, so one value correlates
    #   gateway lifecycle, router dispatch, and engine span events.
    prefill_done: int = 0                    # prompt tokens consumed
    prefix_cached: int = 0                   # prompt tokens adopted from
    t_enqueue: float = 0.0                   #   the prefix cache at admit
    forked_tokens: int = 0                   # prompt tokens adopted by fork
    prompt_folded: int = 0                   # out_tokens already folded
    #   into prompt by preemption rebuilds (out_tokens[:prompt_folded]
    #   appear in prompt; concatenating past this cursor, never the
    #   whole list, is what keeps a twice-preempted prompt and the
    #   suffix-cache commit free of duplicated token runs)
    eid: int = -1                            # engine-assigned unique id
    # preempted recurrent state (StateArena host snapshot): restored on
    # re-admission instead of re-prefilling prompt + generated tokens
    saved_state: Any = None
    saved_length: int = 0
    saved_prefill_done: int = 0

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def prefill_remaining(self) -> int:
        return self.prompt_len - self.prefill_done

    @property
    def tokens_resident(self) -> int:
        """Tokens the lane must hold at admission: the prompt, or — for
        a preempted request resuming from a saved StateArena snapshot —
        everything it had already consumed (admission's page budget must
        cover the restored position, not just the prompt)."""
        return max(self.prompt_len, self.saved_length)


class Scheduler:
    def __init__(self, max_batch: int, prefill_chunk: int = 16):
        assert max_batch > 0 and prefill_chunk > 0
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        self._heap: List = []
        self._order = itertools.count()
        self.tracer = None      # set by the engine (obs.trace.Tracer)

    # -- queue ----------------------------------------------------------
    def submit(self, req: ServeRequest, now: float,
               resubmit: bool = False) -> None:
        """resubmit=True (preemption) keeps the ORIGINAL enqueue time, so
        a deadline is measured from first arrival, not from eviction."""
        if not resubmit:
            req.t_enqueue = now
        abs_deadline = (req.t_enqueue + req.deadline_s
                        if req.deadline_s is not None else float("inf"))
        heapq.heappush(self._heap, (req.priority, abs_deadline,
                                    next(self._order), req))

    def restamp(self, stamps: Dict[int, float]) -> None:
        """Give the queued requests `stamps` names (engine id -> enqueue
        time) that time and re-key the heap on it: a tensor-parallel
        follower's submits take rank 0's stamps from the next tick
        (`dist.lockstep`), before anything is popped.  The entries keep
        their arrival order."""
        if not stamps:
            return
        for i, (prio, _, order, req) in enumerate(self._heap):
            t = stamps.get(req.eid)
            if t is not None:
                req.t_enqueue = t
                abs_deadline = (t + req.deadline_s
                                if req.deadline_s is not None
                                else float("inf"))
                self._heap[i] = (prio, abs_deadline, order, req)
        heapq.heapify(self._heap)

    @property
    def n_queued(self) -> int:
        return len(self._heap)

    def drain_queue(self) -> List[ServeRequest]:
        """Remove and return every queued request that has NOT started,
        in heap-priority order — the fleet router's drain path re-homes
        them onto healthy replicas.  Requests already in lanes are
        untouched (drain lets in-flight work finish where it runs), and
        a preempted request stays queued here too: its progress —
        folded prompt, StateArena snapshot, telemetry trace — belongs
        to this engine and will resume on it."""
        out: List[ServeRequest] = []
        keep: List = []
        while self._heap:
            item = heapq.heappop(self._heap)
            req = item[3]
            if req.cancelled:
                continue
            if (req.out_tokens or req.prefill_done
                    or req.saved_state is not None):
                keep.append(item)
            else:
                out.append(req)
        for item in keep:
            heapq.heappush(self._heap, item)
        return out

    def cancel(self, eid: int) -> Optional[ServeRequest]:
        """Remove a queued request by engine id; returns it (marked
        cancelled) or None when it is not queued.  The heap is small
        (bounded by admission backpressure), so an eager O(n) sweep
        beats carrying tombstones through every admit pass."""
        for i, (_, _, _, req) in enumerate(self._heap):
            if req.eid == eid:
                req.cancelled = True
                self._heap[i] = self._heap[-1]
                self._heap.pop()
                heapq.heapify(self._heap)
                return req
        return None

    # -- admission ------------------------------------------------------
    def admit(self, now: float, n_running: int, cache,
              on_reject=None) -> List[ServeRequest]:
        """Pop admissible requests: respects the lane budget and the
        allocator (fresh prompt pages + 1 growth page must be free or
        reclaimable from the prefix cache).  Prompt prefixes resident in
        the prefix index are adopted by refcount, so chunked prefill
        starts at the first unmatched token.  Expired requests are
        marked rejected and dropped.  Returns newly admitted requests
        with their pages already allocated."""
        admitted: List[ServeRequest] = []
        deferred: List = []
        max_tokens = cache.max_pages * cache.page_size
        while self._heap and n_running + len(admitted) < self.max_batch:
            prio, abs_dl, order, req = heapq.heappop(self._heap)
            if req.cancelled:       # cancelled while queued (belt and
                continue            # braces next to the eager sweep)
            need = cache.pages_needed(req.tokens_resident) + 1
            if (now > abs_dl or req.prompt_len == 0
                    or req.tokens_resident >= max_tokens
                    or need > cache.allocator.n_pages):
                # expired in queue; empty prompt; prompt can never fit
                # max_seq; or needs more pages than the pool HAS (not
                # merely has free) — deferring any of these would spin
                # forever.  A preempted request that already generated
                # output is TRUNCATED (partial result stands); one that
                # never ran is REJECTED.
                req.reject_reason = ("expired" if now > abs_dl
                                     else "empty" if req.prompt_len == 0
                                     else "too-big")
                if req.out_tokens:
                    req.truncated = True
                else:
                    req.rejected = True
                req.done = True
                if self.tracer is not None and self.tracer.enabled:
                    self.tracer.instant(
                        "queue_reject", cat="sched", eid=req.eid,
                        rid=req.trace_id, reason=req.reject_reason,
                        truncated=req.truncated)
                if on_reject is not None:   # let the engine close the
                    on_reject(req)          # telemetry trace
                continue
            parent = req.fork_from
            if parent is not None and (parent.done or parent.cancelled):
                parent = req.fork_from = None   # parent gone: the child
                #   admits on its own (prefix-cache hit if the parent's
                #   prompt pages were committed before release)
            if parent is not None:
                pseq = cache.seqs.get(parent.eid)
                if pseq is None or parent.prefill_remaining > 0:
                    # parent queued / mid-prefill / preempted: wait
                    # WITHOUT head-of-line blocking — a preempted parent
                    # may sit BEHIND this child in the very same heap,
                    # and blocking here would deadlock its re-admission
                    deferred.append((prio, abs_dl, order, req))
                    continue
                # share every full prompt page plus the partial tail;
                # the final prompt token is always re-prefilled so this
                # lane samples its OWN first token from its own logits
                # (COW copies the tail page on that write)
                prefix_len = min(max(req.prompt_len - 1, 0), pseq.length)
                try:
                    cache.fork(req.eid, parent.eid, prefix_len)
                except OutOfPagesError:
                    deferred.append((prio, abs_dl, order, req))
                    break
                req.prefill_done = prefix_len
                req.forked_tokens = prefix_len
                admitted.append(req)
                continue
            match = cache.probe_admit(req.tokens_resident, req.prompt)
            if match is None:
                # keep it queued; lower-priority requests behind it may
                # still fit, but skipping ahead would starve this one —
                # stop admitting (head-of-line, by design)
                deferred.append((prio, abs_dl, order, req))
                break
            try:
                seq = cache.admit(req.eid, req.tokens_resident, match=match)
            except OutOfPagesError:
                # the probe's evictable count was optimistic (e.g. a
                # refcount-1 interior trie node shielded by shared
                # children): wait, head-of-line, like any full pool
                deferred.append((prio, abs_dl, order, req))
                break
            req.prefill_done = req.prefix_cached = seq.length
            admitted.append(req)
        for item in deferred:
            heapq.heappush(self._heap, item)
        return admitted

    # -- chunked prefill ------------------------------------------------
    def prefill_quota(self, req: ServeRequest) -> int:
        """Prompt tokens this request may consume in the current step."""
        return min(self.prefill_chunk, req.prefill_remaining)
