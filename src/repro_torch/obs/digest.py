"""Mergeable quantile sketch (DDSketch-style log-bucketed histogram).

The fleet problem with percentiles: each replica's `Telemetry` used to
keep a rolling sample window and report p95/p99 from it, and the router
AVERAGED those per-replica percentiles into a "fleet p95" — which is
not a percentile of anything (router.py acknowledged the lie).  The
fix is a sketch whose merge operation is exact over its own state:
log-spaced buckets with counts, so merging two sketches is bucket-wise
addition and the merged quantile carries the SAME relative-error
guarantee as each input.

Guarantee: for any quantile q over the inserted values, the reported
value v' satisfies |v' - v| <= alpha * v for the true q-quantile v
(values below `min_value` collapse into an exact zero bucket, and
bucket collapsing under memory pressure can additionally bias the
LOWEST quantiles upward — never the tail, which is what SLOs watch).

Properties the SLO layer leans on:
  mergeable     merge(a, b) == merge(b, a); merge is associative; a
                merged sketch's quantiles match a sketch built from the
                pooled samples exactly (same buckets, same counts)
  bounded       at most `max_buckets` buckets regardless of insert
                count; for latencies 1e-6..1e2 s at alpha=0.01 the
                natural bucket span is ~920, under the default cap, so
                collapsing never engages in practice
  serializable  `to_dict()`/`from_dict()` round-trip through JSON (the
                driver thread publishes dicts; the router merges them
                lock-free on the event loop)

Pure stdlib + numpy (vectorized bulk insert); no jax.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

DEFAULT_ALPHA = 0.01            # 1% relative error (spec asks <= ~2%)
DEFAULT_MAX_BUCKETS = 2048
# values at or below this are counted in the exact zero bucket: latency
# measurements below a microsecond are clock noise, not signal
MIN_VALUE = 1e-6


class QuantileDigest:
    """DDSketch-style quantile sketch over non-negative values.

    Bucket i covers (gamma^(i-1), gamma^i] with gamma = (1+a)/(1-a);
    a value is reported as the bucket midpoint 2*gamma^i/(gamma+1),
    which is within alpha (relative) of anywhere in the bucket.
    """

    __slots__ = ("alpha", "max_buckets", "min_value", "_gamma",
                 "_log_gamma", "_buckets", "zero_count", "count",
                 "sum", "min", "max", "collapsed")

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 max_buckets: int = DEFAULT_MAX_BUCKETS,
                 min_value: float = MIN_VALUE):
        assert 0.0 < alpha < 1.0 and max_buckets >= 2
        self.alpha = alpha
        self.max_buckets = max_buckets
        self.min_value = min_value
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self._gamma)
        self._buckets: Dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.collapsed = 0      # buckets folded under memory pressure

    # -- insertion ------------------------------------------------------
    def _key(self, v: float) -> int:
        return math.ceil(math.log(v) / self._log_gamma)

    def add(self, v: float, count: int = 1) -> None:
        """Insert `v` with multiplicity `count`.  Negative values clamp
        to the zero bucket (latencies are non-negative; a clock skew
        artifact must not crash the metrics path)."""
        if count <= 0 or not math.isfinite(v):
            return
        v = max(float(v), 0.0)
        self.count += count
        self.sum += v * count
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= self.min_value:
            self.zero_count += count
            return
        k = self._key(v)
        self._buckets[k] = self._buckets.get(k, 0) + count
        if len(self._buckets) > self.max_buckets:
            self._collapse()

    def extend(self, values: Iterable[float]) -> None:
        """Vectorized bulk insert (numpy): one log + one bincount for
        the whole batch — 1e6 inserts cost milliseconds, which is what
        makes the bounded-memory property test cheap to run."""
        arr = np.asarray(list(values) if not isinstance(values, np.ndarray)
                         else values, np.float64).ravel()
        arr = arr[np.isfinite(arr)]
        if arr.size == 0:
            return
        arr = np.maximum(arr, 0.0)
        self.count += int(arr.size)
        self.sum += float(arr.sum())
        self.min = min(self.min, float(arr.min()))
        self.max = max(self.max, float(arr.max()))
        zero = arr <= self.min_value
        self.zero_count += int(zero.sum())
        pos = arr[~zero]
        if pos.size:
            keys = np.ceil(np.log(pos) / self._log_gamma).astype(np.int64)
            uniq, cnts = np.unique(keys, return_counts=True)
            for k, c in zip(uniq.tolist(), cnts.tolist()):
                self._buckets[k] = self._buckets.get(k, 0) + c
            if len(self._buckets) > self.max_buckets:
                self._collapse()

    def _collapse(self) -> None:
        """Fold the lowest buckets together until under the cap.  The
        DDSketch trade: tails (the SLO-relevant quantiles) keep their
        guarantee; the smallest values lose resolution."""
        keys = sorted(self._buckets)
        while len(self._buckets) > self.max_buckets and len(keys) > 1:
            lo = keys.pop(0)
            self._buckets[keys[0]] = (self._buckets.pop(lo)
                                      + self._buckets.get(keys[0], 0))
            self.collapsed += 1

    # -- merge ----------------------------------------------------------
    def merge(self, other: "QuantileDigest") -> "QuantileDigest":
        """In-place merge (bucket-wise addition).  Requires matching
        alpha: merging sketches of different resolution would silently
        void the error bound."""
        if not math.isclose(self.alpha, other.alpha):
            raise ValueError(
                f"cannot merge sketches of different alpha "
                f"({self.alpha} vs {other.alpha})")
        for k, c in other._buckets.items():
            self._buckets[k] = self._buckets.get(k, 0) + c
        self.zero_count += other.zero_count
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.collapsed += other.collapsed
        if len(self._buckets) > self.max_buckets:
            self._collapse()
        return self

    def copy(self) -> "QuantileDigest":
        out = QuantileDigest(self.alpha, self.max_buckets, self.min_value)
        out._buckets = dict(self._buckets)
        out.zero_count = self.zero_count
        out.count = self.count
        out.sum = self.sum
        out.min = self.min
        out.max = self.max
        out.collapsed = self.collapsed
        return out

    # -- queries --------------------------------------------------------
    def __len__(self) -> int:
        return self.count

    @property
    def n_buckets(self) -> int:
        return len(self._buckets) + (1 if self.zero_count else 0)

    def mean(self, default: float = float("nan")) -> float:
        return self.sum / self.count if self.count else default

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile `q` in [0, 100] (percentile convention, to
        match np.percentile call sites); None when empty."""
        if self.count == 0:
            return None
        q = min(max(q / 100.0, 0.0), 1.0)
        rank = q * (self.count - 1)
        if rank < self.zero_count:
            return 0.0
        cum = self.zero_count
        key = 0
        for key in sorted(self._buckets):
            cum += self._buckets[key]
            if cum > rank:
                break
        # bucket (gamma^(k-1), gamma^k]: midpoint is within alpha of
        # every value in it; clamp into the observed range so q=0/q=100
        # report the exact min/max
        v = 2.0 * self._gamma ** key / (self._gamma + 1.0)
        return float(min(max(v, self.min), self.max))

    def quantiles(self, qs: Iterable[float]) -> List[Optional[float]]:
        return [self.quantile(q) for q in qs]

    def count_above(self, threshold: float) -> int:
        """Number of inserted values > `threshold` (within the sketch's
        relative error at the bucket containing the threshold).  This
        is what turns a cumulative latency digest into an SLO
        good/bad-event counter: bad(t) = count_above(objective)."""
        if threshold < 0:
            return self.count
        if self.count and threshold >= self.max:
            return 0
        thr_key = (self._key(threshold) if threshold > self.min_value
                   else 0)
        n = 0
        for k, c in self._buckets.items():
            if threshold <= self.min_value or k > thr_key:
                n += c
        return n

    def count_below(self, threshold: float) -> int:
        return self.count - self.count_above(threshold)

    # -- serialization --------------------------------------------------
    def to_dict(self) -> Dict:
        """JSON-ready snapshot (string bucket keys).  The driver thread
        publishes these; the router merges them without ever touching
        the live object."""
        return {
            "alpha": self.alpha,
            "zero": self.zero_count,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "collapsed": self.collapsed,
            "buckets": {str(k): c for k, c in self._buckets.items()},
        }

    @classmethod
    def from_dict(cls, d: Dict, max_buckets: int = DEFAULT_MAX_BUCKETS
                  ) -> "QuantileDigest":
        out = cls(alpha=float(d["alpha"]), max_buckets=max_buckets)
        out._buckets = {int(k): int(c)
                        for k, c in (d.get("buckets") or {}).items()}
        out.zero_count = int(d.get("zero", 0))
        out.count = int(d.get("count", 0))
        out.sum = float(d.get("sum", 0.0))
        out.min = float(d["min"]) if d.get("min") is not None else math.inf
        out.max = (float(d["max"]) if d.get("max") is not None
                   else -math.inf)
        out.collapsed = int(d.get("collapsed", 0))
        if len(out._buckets) > out.max_buckets:
            out._collapse()
        return out


def merge_digest_dicts(dicts: Iterable[Optional[Dict]]
                       ) -> Optional[QuantileDigest]:
    """Merge serialized digests (skipping Nones) into one sketch; None
    when nothing mergeable was given.  The fleet rollup path: each
    replica publishes `Telemetry.digests()`, the router pools them
    here, and fleet p95/p99 come out mathematically correct."""
    out: Optional[QuantileDigest] = None
    for d in dicts:
        if not d:
            continue
        dig = QuantileDigest.from_dict(d)
        out = dig if out is None else out.merge(dig)
    return out


# the summary keys whose per-replica values are rank statistics and
# therefore must NEVER be averaged across replicas — the fleet value is
# recomputed from merged sketches keyed by the metric's digest name
PERCENTILE_KEYS: Dict[str, Tuple[str, float]] = {
    f"{metric}_p{p}_s": (f"{metric}_s", float(p))
    for metric in ("ttft", "tpot", "itl", "queue")
    for p in (50, 95, 99)
}
