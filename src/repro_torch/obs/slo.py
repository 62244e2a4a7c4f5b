"""SLO engine: declarative objectives + multi-window burn-rate alerting.

Telemetry exports numbers; nothing so far judged them.  This module
holds the judgment: an `SLOSpec` states an objective ("95% of requests
see TTFT under 500 ms", "error rate under 1%", "goodput at least
10 tok/s"), and an `SLOMonitor` evaluates each replica's (and the
fleet's) measured stream against it with Google-SRE multi-window
burn-rate rules, driving an `ok -> warn -> page` alert state machine
per (scope, objective).

Burn rate is error-budget consumption speed: with budget b (the
allowed bad-event fraction — 0.05 for a p95 objective), a window whose
bad fraction is f burns at f/b.  Burn 1.0 exactly exhausts the budget
over the SLO period; the SRE multi-window rule pages when BOTH a long
and a short window burn faster than a factor (long window = sustained,
short window = still happening), which suppresses both blips and
stale alerts:

    page  burn >= 14.4 over (1h  long, 5m  short)   [scaled]
    warn  burn >=  6.0 over (6h  long, 30m short)   [scaled]

`BurnRatePolicy.timescale` compresses the canonical SRE windows so a
30-second bench run exercises the same math a production day would
(timescale=1/600 turns 1h into 6s).

Event counting is uniform across SLO kinds — every tick contributes
(total_delta, bad_delta) to a time-bucketed series per (scope, slo):

    latency_p<q>   events = latency digest count delta, bad = delta of
                   `count_above(threshold)` on the SAME cumulative
                   sketch (obs/digest.py) — the sketch, not a sample
                   window, so fleet math stays exact under merge
    error_rate     events = requests delta, bad = cancelled delta
    goodput floor  events = 1 per tick with decode activity, bad = 1
                   when the tick's measured decode rate sat below the
                   floor (budget defaults to 5% of ticks)

The monitor is clock-driven and thread-free: `ingest()` +
`evaluate()` run wherever the caller likes (FleetRouter.poll_slo runs
them on the event loop from published snapshots).  Transitions land in
a bounded ring, fire subscribed callbacks (`FleetRouter.on_alert`),
and are mirrored into the owning replica's flight recorder by the
router so a postmortem dump explains a degraded death.
"""
from __future__ import annotations

import re
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from .digest import QuantileDigest

# alert levels, ordered; exported as a Prometheus gauge by obs/export
LEVELS = ("ok", "warn", "page")
LEVEL_VALUE = {name: i for i, name in enumerate(LEVELS)}

_SPEC_RE = re.compile(
    r"^\s*(?P<metric>[a-zA-Z_][a-zA-Z0-9_]*?)"
    r"(?:_p(?P<pct>\d+(?:\.\d+)?))?(?P<unit>_s)?"
    r"\s*(?P<op><|>)\s*(?P<value>[-+0-9.eE]+)\s*$")

# latency metrics backed by a Telemetry digest (obs/digest.py names)
LATENCY_METRICS = ("ttft", "tpot", "itl", "queue")

# the stock objective set (--slo with no specs, api_bench --slo):
# interactive-serving targets loose enough for a CPU smoke cell
DEFAULT_SLOS = ("ttft_p95_s < 2.0", "itl_p99_s < 1.0",
                "error_rate < 0.05")


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective.

    kind "latency": `threshold` is the objective latency in seconds
    and `budget` the allowed fraction of requests above it (p95 ->
    0.05).  kind "error_rate": `budget` IS the ceiling.  kind
    "goodput": `threshold` is the floor in tokens/s; `budget` bounds
    the fraction of evaluation ticks allowed below it.
    """
    name: str
    kind: str                   # "latency" | "error_rate" | "goodput"
    metric: str                 # digest name for latency ("ttft_s")
    threshold: float
    budget: float
    spec: str                   # the source text, echoed in payloads

    @staticmethod
    def parse(text: str) -> "SLOSpec":
        """Parse one spec string:

            "ttft_p95_s < 0.5"            95% of TTFTs under 500 ms
            "itl_p99_s < 0.1"             99% of token gaps under 100 ms
            "error_rate < 0.01"           under 1% requests cancelled
            "goodput_tokens_per_s > 10"   decode rate floor 10 tok/s
        """
        m = _SPEC_RE.match(text)
        if m is None:
            raise ValueError(f"unparseable SLO spec {text!r}")
        metric, pct, op, value = (m.group("metric"), m.group("pct"),
                                  m.group("op"), float(m.group("value")))
        if pct is not None:
            if metric not in LATENCY_METRICS:
                raise ValueError(
                    f"SLO spec {text!r}: percentile objectives cover "
                    f"{LATENCY_METRICS}, not {metric!r}")
            if op != "<":
                raise ValueError(f"SLO spec {text!r}: latency "
                                 "objectives are upper bounds (<)")
            q = float(pct)
            if not 0.0 < q < 100.0:
                raise ValueError(f"SLO spec {text!r}: percentile must "
                                 "be in (0, 100)")
            return SLOSpec(name=f"{metric}_p{pct}", kind="latency",
                           metric=f"{metric}_s", threshold=value,
                           budget=1.0 - q / 100.0, spec=text)
        if metric == "error_rate":
            if op != "<" or not 0.0 < value < 1.0:
                raise ValueError(f"SLO spec {text!r}: error_rate takes "
                                 "'< fraction' in (0, 1)")
            return SLOSpec(name="error_rate", kind="error_rate",
                           metric="error_rate", threshold=value,
                           budget=value, spec=text)
        # the optional _s suffix group may have eaten the unit off
        # "goodput_tokens_per_s" — accept both shapes
        if metric in ("goodput", "goodput_tokens_per",
                      "goodput_tokens_per_s"):
            if op != ">":
                raise ValueError(f"SLO spec {text!r}: goodput is a "
                                 "floor (>)")
            return SLOSpec(name="goodput", kind="goodput",
                           metric="goodput_tokens_per_s",
                           threshold=value, budget=0.05, spec=text)
        raise ValueError(
            f"SLO spec {text!r}: unknown metric {metric!r} (know "
            f"{LATENCY_METRICS} percentiles, error_rate, "
            "goodput_tokens_per_s)")


def parse_slos(specs) -> Tuple[SLOSpec, ...]:
    """Parse a mixed list of spec strings / SLOSpec objects; duplicate
    names are an error (two objectives driving one state machine would
    silently shadow each other)."""
    out: List[SLOSpec] = []
    for s in specs or ():
        out.append(s if isinstance(s, SLOSpec) else SLOSpec.parse(s))
    names = [s.name for s in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate SLO names in {names}")
    return tuple(out)


@dataclass(frozen=True)
class BurnRatePolicy:
    """Multi-window burn-rate thresholds (canonical SRE numbers),
    uniformly compressed by `timescale` so bench-scale runs evaluate
    the same shape: timescale=1/600 maps the 1h page window to 6s."""
    page_long_s: float = 3600.0
    page_short_s: float = 300.0
    page_burn: float = 14.4
    warn_long_s: float = 21600.0
    warn_short_s: float = 1800.0
    warn_burn: float = 6.0
    timescale: float = 1.0

    def windows(self) -> Dict[str, Tuple[float, float, float]]:
        t = self.timescale
        return {
            "page": (self.page_long_s * t, self.page_short_s * t,
                     self.page_burn),
            "warn": (self.warn_long_s * t, self.warn_short_s * t,
                     self.warn_burn),
        }

    @property
    def max_window_s(self) -> float:
        return max(self.page_long_s, self.warn_long_s) * self.timescale


class _Series:
    """Time-bucketed (total, bad) event deltas with bounded retention:
    one bucket per ingest tick, pruned past the longest policy window.
    Rates over a window are bucket sums — O(window/tick) per query,
    tiny at any sane poll interval."""

    __slots__ = ("_buckets", "_horizon_s", "last_total", "last_bad")

    def __init__(self, horizon_s: float):
        self._buckets: Deque[Tuple[float, float, float]] = deque()
        self._horizon_s = horizon_s
        self.last_total: Optional[float] = None     # cumulative marks
        self.last_bad: Optional[float] = None

    def push_cumulative(self, now: float, total: float,
                        bad: float) -> Tuple[float, float]:
        """Ingest cumulative counters; appends the positive delta since
        the previous tick (a replica restart that rewinds a counter
        contributes zero, never a negative bucket)."""
        d_total = d_bad = 0.0
        if self.last_total is not None:
            d_total = max(total - self.last_total, 0.0)
            d_bad = max(bad - self.last_bad, 0.0)
        self.last_total, self.last_bad = total, bad
        self.push_delta(now, d_total, d_bad)
        return d_total, d_bad

    def push_delta(self, now: float, d_total: float, d_bad: float) -> None:
        self._buckets.append((now, d_total, d_bad))
        cutoff = now - self._horizon_s
        while self._buckets and self._buckets[0][0] < cutoff:
            self._buckets.popleft()

    def window(self, window_s: float, now: float) -> Tuple[float, float]:
        cutoff = now - window_s
        total = bad = 0.0
        for t, dt, db in reversed(self._buckets):
            if t < cutoff:
                break
            total += dt
            bad += db
        return total, bad


@dataclass
class AlertState:
    """Per-(scope, slo) alert machine.  Level follows the burn-rate
    evaluation directly — the multi-window rule itself provides the
    hysteresis (the long window must drain before de-escalation), so no
    extra dwell timers."""
    scope: str
    slo: str
    level: str = "ok"
    since: float = 0.0
    transitions: int = 0
    burn: Dict[str, float] = field(default_factory=dict)
    bad_total: float = 0.0
    events_total: float = 0.0

    def to_dict(self) -> Dict:
        return {"scope": self.scope, "slo": self.slo,
                "level": self.level, "since_s": self.since,
                "transitions": self.transitions,
                "burn": dict(self.burn),
                "events_total": self.events_total,
                "bad_total": self.bad_total}


class SLOMonitor:
    """Evaluates SLO specs over per-scope measured streams.

    One monitor serves every scope: per-replica scopes ("replica-0")
    and the synthetic "fleet" scope the router feeds with summed
    counters + merged digests.  `on_transition(cb)` subscribes to
    alert-level changes; `FleetRouter.on_alert` is a thin wrapper.
    """

    def __init__(self, slos, *, policy: Optional[BurnRatePolicy] = None,
                 clock=time.monotonic, max_transitions: int = 256):
        self.slos: Tuple[SLOSpec, ...] = parse_slos(slos)
        self.policy = policy or BurnRatePolicy()
        self._clock = clock
        self._series: Dict[Tuple[str, str], _Series] = {}
        self.states: Dict[Tuple[str, str], AlertState] = {}
        self.transitions: Deque[Dict] = deque(maxlen=max_transitions)
        self._subs: List[Callable[[Dict], None]] = []

    # -- subscriptions --------------------------------------------------
    def on_transition(self, cb: Callable[[Dict], None]) -> None:
        self._subs.append(cb)

    # -- ingest (one scope, one tick) -----------------------------------
    def _serie(self, scope: str, slo: str) -> _Series:
        key = (scope, slo)
        s = self._series.get(key)
        if s is None:
            # keep 2x the longest window so a query at the horizon edge
            # never reads a half-pruned bucket
            s = self._series[key] = _Series(2.0 * self.policy.max_window_s)
        return s

    def ingest(self, scope: str, *, digests: Optional[Dict] = None,
               counters: Optional[Dict] = None,
               now: Optional[float] = None) -> None:
        """One evaluation tick of cumulative state for `scope`:
        `digests` maps digest names to serialized sketches
        (`Telemetry.digests()`), `counters` is the telemetry snapshot
        (requests_total / cancelled / decode_tokens / decode_s)."""
        now = self._clock() if now is None else now
        digests = digests or {}
        counters = counters or {}
        for slo in self.slos:
            serie = self._serie(scope, slo.name)
            if slo.kind == "latency":
                d = digests.get(slo.metric)
                if d is None:
                    continue
                sketch = QuantileDigest.from_dict(d)
                serie.push_cumulative(
                    now, float(sketch.count),
                    float(sketch.count_above(slo.threshold)))
            elif slo.kind == "error_rate":
                serie.push_cumulative(
                    now, float(counters.get("requests_total", 0.0)),
                    float(counters.get("cancelled", 0.0)))
            elif slo.kind == "goodput":
                # per-tick gauge: measured decode rate over this tick's
                # (decode_tokens, decode_s) delta; idle ticks don't vote
                tokens = float(counters.get("decode_tokens", 0.0))
                busy_s = float(counters.get("decode_s", 0.0))
                lt, lb = serie.last_total, serie.last_bad
                d_tok = tokens - lt if lt is not None else 0.0
                d_s = busy_s - lb if lb is not None else 0.0
                serie.last_total, serie.last_bad = tokens, busy_s
                if d_tok > 0 and d_s > 0:
                    rate = d_tok / d_s
                    serie.push_delta(now, 1.0,
                                     1.0 if rate < slo.threshold else 0.0)
                else:
                    serie.push_delta(now, 0.0, 0.0)

    # -- evaluation -----------------------------------------------------
    def _burn(self, serie: _Series, slo: SLOSpec, window_s: float,
              now: float) -> float:
        total, bad = serie.window(window_s, now)
        if total <= 0:
            return 0.0
        return (bad / total) / slo.budget

    def evaluate(self, now: Optional[float] = None) -> List[Dict]:
        """Re-derive every alert level from the windowed series;
        returns the transitions this call produced (already pushed to
        the ring and delivered to subscribers)."""
        now = self._clock() if now is None else now
        fired: List[Dict] = []
        for (scope, name), serie in self._series.items():
            slo = next(s for s in self.slos if s.name == name)
            burns: Dict[str, float] = {}
            level = "ok"
            for lvl, (long_s, short_s, factor) in \
                    self.policy.windows().items():
                b_long = self._burn(serie, slo, long_s, now)
                b_short = self._burn(serie, slo, short_s, now)
                burns[f"{lvl}_long"] = b_long
                burns[f"{lvl}_short"] = b_short
                if b_long >= factor and b_short >= factor:
                    if LEVEL_VALUE[lvl] > LEVEL_VALUE[level]:
                        level = lvl
            st = self.states.get((scope, name))
            if st is None:
                st = self.states[(scope, name)] = AlertState(
                    scope=scope, slo=name, since=now)
            st.burn = burns
            total, bad = serie.window(self.policy.max_window_s, now)
            st.events_total, st.bad_total = total, bad
            if level != st.level:
                ev = {"t_s": now, "kind": "slo_alert", "scope": scope,
                      "slo": name, "from": st.level, "to": level,
                      "spec": slo.spec,
                      "burn_long": burns.get(f"{level}_long",
                                             burns.get("page_long", 0.0)),
                      "burn_short": burns.get(f"{level}_short",
                                              burns.get("page_short",
                                                        0.0))}
                st.level = level
                st.since = now
                st.transitions += 1
                self.transitions.append(ev)
                fired.append(ev)
                for cb in self._subs:
                    try:
                        cb(ev)
                    except Exception:
                        pass    # a broken subscriber must not stop
                        # evaluation or starve later subscribers
        return fired

    # -- views ----------------------------------------------------------
    def worst_level(self, scope: Optional[str] = None) -> str:
        """Highest active alert level, optionally restricted to one
        scope — /healthz's `degraded` flag reads this."""
        worst = "ok"
        for (sc, _), st in self.states.items():
            if scope is not None and sc != scope:
                continue
            if LEVEL_VALUE[st.level] > LEVEL_VALUE[worst]:
                worst = st.level
        return worst

    def payload(self) -> Dict:
        """JSON body for GET /debug/slo."""
        return {
            "slos": [{"name": s.name, "kind": s.kind, "spec": s.spec,
                      "threshold": s.threshold, "budget": s.budget}
                     for s in self.slos],
            "policy": {
                "timescale": self.policy.timescale,
                "windows": {lvl: {"long_s": lo, "short_s": sh,
                                  "burn": f}
                            for lvl, (lo, sh, f)
                            in self.policy.windows().items()}},
            "states": [st.to_dict() for st in self.states.values()],
            "worst": self.worst_level(),
            "transitions": list(self.transitions),
        }
