"""Serving telemetry: latency percentiles, throughput, KV occupancy.

Per-request timeline: enqueue -> admit (queue time) -> first token
(TTFT) -> done; TPOT is the mean inter-token gap after the first.
Engine-level gauges (KV occupancy, batch size) are sampled every step.
All clocks are caller-supplied monotonic seconds, so tests can drive
synthetic time.

A decode step is NOT one token: speculative decoding emits a variable
number of tokens per lane per step.  Tokens are therefore counted where
they are emitted (`token`), while `step` separately counts decode-graph
invocations and the lane-steps behind them, so throughput and
tokens-per-step stay honest for any emission width (for the plain
engine `tokens_per_decode_step` is exactly 1.0).  `spec` accumulates
the drafted/accepted ledger behind the acceptance rate.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..obs.digest import QuantileDigest


@dataclass
class RequestTrace:
    rid: int
    t_enqueue: float = 0.0
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None
    t_done: Optional[float] = None
    n_tokens: int = 0
    cancelled: bool = False

    @property
    def queue_s(self) -> Optional[float]:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_enqueue

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_enqueue

    @property
    def tpot_s(self) -> Optional[float]:
        if self.t_done is None or self.t_first_token is None \
                or self.n_tokens < 2:
            return None
        return (self.t_done - self.t_first_token) / (self.n_tokens - 1)


class _Window:
    """Bounded sample window with a cached numpy view.

    Percentile/histogram rollups need the samples as an ndarray; before
    this class every `/metrics` scrape rebuilt that array by scanning
    the retained traces.  Here samples are appended once at the
    lifecycle event that produces them, and the array is materialized
    at most ONCE between appends — a scrape storm against an idle
    server costs one build total.  The cap halves the window when
    exceeded (amortized O(1)), same policy the ITL buffer always had.
    """

    __slots__ = ("_vals", "_cap", "_arr")

    def __init__(self, cap: int):
        self._vals: List[float] = []
        self._cap = cap
        self._arr: Optional[np.ndarray] = None

    def append(self, v: float) -> None:
        self._vals.append(v)
        if len(self._vals) > self._cap:
            del self._vals[:self._cap // 2]
        self._arr = None

    def array(self) -> np.ndarray:
        if self._arr is None:
            self._arr = np.asarray(self._vals, np.float64)
        return self._arr

    def __len__(self) -> int:
        return len(self._vals)

    def __iter__(self):
        return iter(self._vals)

    def mean(self, default: float = float("nan")) -> float:
        return float(self.array().mean()) if self._vals else default

    def peak(self, default: float = float("nan")) -> float:
        return float(self.array().max()) if self._vals else default


# log-spaced latency buckets: 100 us .. 10 s plus an overflow bin — wide
# enough for a jitted CPU smoke run and a loaded TPU server alike
_HIST_EDGES = np.logspace(-4, 1, 11)


def _hist(vals) -> Dict[str, List]:
    """Fixed-bucket histogram of latency seconds: `edges_s` brackets
    every count; the first bucket reaches down to 0 and the last is
    unbounded above, so no sample is ever silently dropped."""
    arr = vals.array() if isinstance(vals, _Window) \
        else np.asarray(vals, np.float64)
    edges = [0.0] + list(_HIST_EDGES) + [float("inf")]
    counts, _ = np.histogram(arr, bins=edges)
    return {"edges_s": [0.0] + [float(e) for e in _HIST_EDGES] + ["inf"],
            "counts": [int(c) for c in counts]}


# retention caps: the gateway turned the engine into a long-running
# server, so per-request traces and per-token gap samples can no longer
# grow with total traffic served.  Percentiles/histograms roll over the
# most recent window; monotonic counters (requests, tokens, ...) are
# kept separately and never pruned.  Offline runs and every test/bench
# config sit far below both caps, so their rollups are exact.
MAX_DONE_TRACES = 4096
MAX_ITL_SAMPLES = 16384


class Telemetry:
    def __init__(self):
        self.traces: Dict[int, RequestTrace] = {}
        self.requests_total = 0
        self._done_order: List[int] = []     # finished eids, oldest first
        self.occupancy_samples = _Window(MAX_ITL_SAMPLES)
        self.state_occupancy_samples = _Window(MAX_ITL_SAMPLES)
        self.decode_family: Optional[str] = None     # labels lane_steps_*
        self.batch_samples = _Window(MAX_ITL_SAMPLES)
        # latency sample windows, appended at the lifecycle event that
        # defines each metric (queue at admit, ttft at first token,
        # tpot at retire) — summary() never scans traces again
        self._ttft = _Window(MAX_DONE_TRACES)
        self._tpot = _Window(MAX_DONE_TRACES)
        self._queue = _Window(MAX_DONE_TRACES)
        # mergeable quantile sketches behind every reported percentile:
        # cumulative (never pruned — bounded by construction), appended
        # at the same lifecycle events as the windows above.  Windows
        # stay for means + fixed-bucket histograms; rank statistics come
        # from the sketches so fleet rollups can MERGE instead of
        # averaging percentiles (obs/digest.py).
        self._digests: Dict[str, QuantileDigest] = {
            "ttft_s": QuantileDigest(), "tpot_s": QuantileDigest(),
            "itl_s": QuantileDigest(), "queue_s": QuantileDigest(),
        }
        # bumped on every digest append so publishers (the replica tap)
        # can skip re-serializing an unchanged sketch, like the prefix
        # fingerprint's version gate
        self.digest_version = 0
        self.decode_s = 0.0
        self.prefill_s = 0.0
        self.steps = 0
        self.decode_steps = 0        # decode-graph invocations
        self.decode_lane_steps = 0   # active lanes summed over decode steps
        self.tokens = 0
        self.decode_tokens = 0       # emitted by the decode graph
        self.prefill_tokens = 0
        self.spec_drafted = 0        # draft tokens sent to verification
        self.spec_accepted = 0       # draft tokens the target accepted
        self.prefix_lookups = 0      # admissions probing the prefix cache
        self.prefix_hits = 0         # admissions that adopted >= 1 page
        self.prefill_tokens_skipped = 0   # prompt tokens never prefilled
        self.fork_admissions = 0     # lanes admitted via PagedKVCache.fork
        self.cancelled = 0           # requests aborted before completion
        self.itl_samples = _Window(MAX_ITL_SAMPLES)  # emitted-token gaps
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None

    # -- request lifecycle ---------------------------------------------
    def enqueue(self, rid: int, now: float):
        self.traces[rid] = RequestTrace(rid=rid, t_enqueue=now)
        self.requests_total += 1
        if self.t_start is None:
            self.t_start = now

    def _retire(self, rid: int):
        """Bound trace retention: finished traces past the window are
        dropped oldest-first (live traces are never touched).  The
        closing trace's TPOT lands in its sample window here — `done`
        and `cancel` both retire, so cancelled requests keep
        contributing their measured inter-token pace, as the
        trace-scanning rollup always had them."""
        tr = self.traces.get(rid)
        if tr is not None and tr.tpot_s is not None:
            self._tpot.append(tr.tpot_s)
            self._digests["tpot_s"].add(tr.tpot_s)
            self.digest_version += 1
        self._done_order.append(rid)
        while len(self._done_order) > MAX_DONE_TRACES:
            self.traces.pop(self._done_order.pop(0), None)

    def admit(self, rid: int, now: float):
        tr = self.traces[rid]
        tr.t_admit = now
        self._queue.append(tr.queue_s)
        self._digests["queue_s"].add(tr.queue_s)
        self.digest_version += 1

    def token(self, rid: int, now: float, decode: bool = True):
        """decode=False marks a token emitted by the prefill graph (each
        request's first), kept out of the decode-rate denominator."""
        tr = self.traces[rid]
        if tr.t_first_token is None:
            tr.t_first_token = now
            self._ttft.append(tr.ttft_s)
            self._digests["ttft_s"].add(tr.ttft_s)
            self.digest_version += 1
        elif tr.t_last_token is not None:
            # measured gap between consecutive emissions of one request
            # (the streaming client's experience, unlike tpot's
            # first-to-done mean)
            gap = max(now - tr.t_last_token, 0.0)
            self.itl_samples.append(gap)
            self._digests["itl_s"].add(gap)
            self.digest_version += 1
        tr.t_last_token = now
        tr.n_tokens += 1
        self.tokens += 1
        if decode:
            self.decode_tokens += 1
        self.t_end = now

    def done(self, rid: int, now: float):
        self.traces[rid].t_done = now
        self.t_end = now
        self._retire(rid)

    def forget(self, rid: int):
        """Request handed off to another engine before running here
        (fleet drain/requeue): drop its trace AND its requests_total
        count — it is re-enqueued (and counted) on the replica that
        actually serves it, so leaving it here would double-count every
        fleet-level rollup.  Only legal for a request that never
        admitted; a trace with progress must close via done/cancel."""
        tr = self.traces.get(rid)
        if tr is not None and tr.t_admit is None and tr.t_done is None:
            del self.traces[rid]
            self.requests_total -= 1

    def cancel(self, rid: int, now: float):
        """Request aborted (client disconnect / explicit cancel): the
        trace closes so percentile rollups stay well-defined, and the
        request is counted separately from clean completions."""
        tr = self.traces[rid]
        tr.t_done = now
        tr.cancelled = True
        self.cancelled += 1
        self.t_end = now
        self._retire(rid)

    # -- engine gauges --------------------------------------------------
    def step(self, occupancy: float, batch: int, decode_s: float = 0.0,
             prefill_s: float = 0.0, decode_lanes: int = 0,
             state_occupancy: Optional[float] = None,
             family: Optional[str] = None):
        """`decode_lanes`: lanes the decode graph advanced this step (0
        on prefill-only steps) — the denominator of tokens-per-step,
        which `token` alone cannot provide once steps emit more than one
        token.  `state_occupancy` is the StateArena lane-slot fill
        (None when the model has no recurrent state); `family` labels
        the `lane_steps_<family>` rollup (one engine serves one model,
        so this is a label, not a second counter)."""
        self.occupancy_samples.append(occupancy)
        if state_occupancy is not None:
            self.state_occupancy_samples.append(state_occupancy)
        self.batch_samples.append(batch)
        self.decode_s += decode_s
        self.prefill_s += prefill_s
        self.steps += 1
        if decode_lanes:
            self.decode_steps += 1
            self.decode_lane_steps += decode_lanes
            if family is not None:
                self.decode_family = family

    def spec(self, drafted: int, accepted: int):
        """One verify step's ledger: `drafted` tokens proposed across
        the batch, `accepted` of them kept by the target."""
        self.spec_drafted += drafted
        self.spec_accepted += accepted

    def prefix(self, cached_tokens: int):
        """One admission's prefix-cache outcome: `cached_tokens` prompt
        tokens were adopted from resident pages (0 = miss)."""
        self.prefix_lookups += 1
        if cached_tokens > 0:
            self.prefix_hits += 1
            self.prefill_tokens_skipped += cached_tokens

    def fork(self, cached_tokens: int):
        """One admission served by `PagedKVCache.fork` (parallel
        sampling): `cached_tokens` prompt tokens were adopted from the
        parent lane instead of prefilled.  Kept out of the prefix-cache
        hit rate — the trie was never probed."""
        self.fork_admissions += 1
        self.prefill_tokens_skipped += cached_tokens

    # -- cheap gauge view ----------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """O(1) counter view for per-dispatch polling: no percentile
        math, no trace scans, no numpy — a fleet router reads this (via
        the driver's step tap) on every routing decision, where
        `summary()` would be orders of magnitude too heavy."""
        return {
            "requests_total": float(self.requests_total),
            "tokens": float(self.tokens),
            "decode_tokens": float(self.decode_tokens),
            "prefill_tokens": float(self.prefill_tokens),
            "prefix_lookups": float(self.prefix_lookups),
            "prefix_hits": float(self.prefix_hits),
            "prefill_tokens_skipped": float(self.prefill_tokens_skipped),
            "fork_admissions": float(self.fork_admissions),
            "cancelled": float(self.cancelled),
            "decode_s": float(self.decode_s),
        }

    # -- rollup ---------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        # latency percentiles come from the cumulative sketches; a
        # metric with no samples yet is ABSENT from the rollup (not
        # NaN) — exporters render nothing, fleet merges skip it, and
        # check_bench never diffs a number that does not exist
        ttft = self._ttft
        pct: Dict[str, float] = {}
        for name, dig in self._digests.items():
            if dig.count == 0:
                continue
            for p in (50, 95, 99):
                pct[f"{name[:-2]}_p{p}_s"] = dig.quantile(p)
        wall = ((self.t_end - self.t_start)
                if self.t_start is not None and self.t_end is not None
                and self.t_end > self.t_start else 0.0)
        return {
            "requests": float(self.requests_total),
            "tokens": float(self.tokens),
            "prefill_tokens": float(self.prefill_tokens),
            "steps": float(self.steps),
            "decode_steps": float(self.decode_steps),
            "tokens_per_s": self.tokens / wall if wall else float("nan"),
            "decode_tokens_per_s": (self.decode_tokens / self.decode_s
                                    if self.decode_s else float("nan")),
            "tokens_per_decode_step": (
                self.decode_tokens / self.decode_lane_steps
                if self.decode_lane_steps else float("nan")),
            "spec_drafted": float(self.spec_drafted),
            "spec_accepted": float(self.spec_accepted),
            "spec_acceptance_rate": (self.spec_accepted / self.spec_drafted
                                     if self.spec_drafted else float("nan")),
            "prefix_lookups": float(self.prefix_lookups),
            "prefix_hits": float(self.prefix_hits),
            "prefix_hit_rate": (self.prefix_hits / self.prefix_lookups
                                if self.prefix_lookups else float("nan")),
            "prefill_tokens_skipped": float(self.prefill_tokens_skipped),
            "fork_admissions": float(self.fork_admissions),
            "cancelled": float(self.cancelled),
            "ttft_mean_s": ttft.mean(),
            **pct,
            "kv_occupancy_mean": self.occupancy_samples.mean(0.0),
            "kv_occupancy_peak": self.occupancy_samples.peak(0.0),
            "state_slot_occupancy_mean":
                self.state_occupancy_samples.mean(),
            "state_slot_occupancy_peak":
                self.state_occupancy_samples.peak(),
            "batch_mean": self.batch_samples.mean(0.0),
            **({f"lane_steps_{self.decode_family}":
                float(self.decode_lane_steps)}
               if self.decode_family is not None else {}),
        }

    def digests(self) -> Dict[str, Dict]:
        """Serialized quantile sketches keyed by metric — the mergeable
        form of every percentile in `summary()`.  The replica tap
        publishes these (version-gated on `digest_version`); the fleet
        router merges them for mathematically correct fleet p95/p99."""
        return {name: dig.to_dict()
                for name, dig in self._digests.items()}

    def histograms(self) -> Dict[str, Dict[str, List]]:
        """Latency distributions as fixed log-spaced buckets (the
        gateway `/metrics` payload: percentiles compress, histograms
        compose across scrapes).  Fed by the same incrementally
        maintained windows as `summary()` — no trace scan."""
        return {"ttft_s": _hist(self._ttft), "queue_s": _hist(self._queue),
                "itl_s": _hist(self.itl_samples)}
