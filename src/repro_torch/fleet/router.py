"""FleetRouter: N data-parallel engine replicas behind one gateway
(PyTorch port of `repro.fleet.router`).

One `PagedServeEngine` caps goodput at its own lane/page pools, and a
single long prefill inflates every stream's tail latency.  The router
scales the serving story out: it owns N replicas of the SAME model
(one `EngineDriver` thread each), dispatches every request group to
exactly one replica under a pluggable policy (policy.py), and turns the
per-engine admission machinery into fleet-level load shedding — a
request is 429'd only when EVERY live replica is at its pending cap,
with a Retry-After estimated from the least-loaded replica's measured
decode rate.

Dispatch stays on the caller's event loop: routing reads only
router-side pending ledgers and the lock-free snapshots each driver
tap publishes (replica.py), so picking a replica costs dict lookups,
not thread round-trips.  A request group (a primary and its fork
children) always lands on one replica — forked KV pages cannot span
engines.

Lifecycle:
  drain(i)   stop dispatching to replica i, re-home its not-yet-started
             queue onto healthy replicas (watchers travel along; fork
             links are severed — engine ids are per-engine), and let
             its in-flight requests finish where they run.
  death      a driver that died fail-fast (fatal step error) drops out
             of every policy's candidate set automatically; its
             in-flight requests were already failed by the driver's
             shutdown sweep.  The gateway keeps serving on survivors —
             /healthz stays 200 while >= 1 replica is live.

At tp > 1 (one engine a replica over the same ranks, rank 0 leading
each; `repro_torch.dist.lockstep`) the replicas share their ranks >= 1,
so one dead replica means a rank left or rank 0 aborted its group: the
fleet is alive only while every replica is, and /healthz and
/v1/completions answer 503 otherwise.  `drain` re-homes through the
replicated driver jobs (`extract_queued`, `submit`), so the other ranks
see both.  `add_replica` takes rank 0's engine of a replica every rank
built while the fleet serves, on a pair of groups of its own, over the
rank's one shard (`repro_torch.launch.serve.add_tp_replica` tells the
other ranks first, on the fleet's channel): its ticks start at 0, the
other ranks follow it on a thread of their own, and from then on the
fleet is alive only while it is too.
"""
from __future__ import annotations

import asyncio
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.digest import PERCENTILE_KEYS, merge_digest_dicts
from repro_torch.obs.slo import BurnRatePolicy, SLOMonitor
from repro_torch.obs.trace import get_tracer

from .policy import Policy, PrefixAffinityPolicy, make_policy
from .replica import Replica


# summary keys that SUM across replicas (counters and parallel rates);
# *_peak keys take the max; percentile keys are recomputed from merged
# quantile sketches when the caller provides them (the only correct
# fleet percentile — obs/digest.py) and dropped otherwise; everything
# else (means) is nan-averaged — approximate for a fleet, exact for one
# replica, and the per-replica breakdown always carries the honest
# numbers
_SUM_KEYS = frozenset({
    "requests", "requests_total", "tokens", "decode_tokens",
    "prefill_tokens", "steps", "decode_steps", "spec_drafted",
    "spec_accepted", "prefix_lookups", "prefix_hits",
    "prefill_tokens_skipped", "fork_admissions", "cancelled",
    "cow_copies", "kv_pages_shared", "prefix_pages_resident",
    "prefix_pages_evicted", "state_bytes", "tokens_per_s",
    "decode_tokens_per_s", "decode_s",
    "sim_energy_j", "sim_decode_energy_j", "sim_prefill_energy_j",
    "sim_time_s", "sim_decode_time_s", "sim_decode_tokens",
})


def _nanagg(vals: np.ndarray, fn) -> float:
    return float(fn(vals)) if not np.all(np.isnan(vals)) else float("nan")


def aggregate_summaries(summaries: Sequence[Dict],
                        digests: Optional[Sequence[Dict]] = None
                        ) -> Optional[Dict]:
    """Fleet rollup of per-engine `summary()` dicts: counters sum,
    peaks max; ratio metrics are recomputed from the summed numerators
    (a mean of per-replica hit rates is not the fleet hit rate).

    `digests`: per-replica `Telemetry.digests()` payloads.  When given,
    every percentile key is RECOMPUTED from the merged sketches —
    bucket-wise addition, so the fleet p95 is the p95 of the pooled
    samples (within the sketch's relative-error bound), not an average
    of per-replica p95s (which is not a percentile of anything).
    Without digests the old nan-averaging stands as a last resort for
    direct callers that only hold summaries."""
    if not summaries:
        return None
    have_digests = digests is not None
    out: Dict[str, float] = {}
    for k in sorted(set().union(*map(set, summaries))):
        if have_digests and k in PERCENTILE_KEYS:
            continue            # recomputed from merged sketches below
        vals = np.asarray([float(s[k]) for s in summaries if k in s],
                          np.float64)
        if k in _SUM_KEYS or k.startswith("lane_steps_"):
            out[k] = float(np.nansum(vals))
        elif k.endswith("_peak"):
            out[k] = _nanagg(vals, np.nanmax)
        else:
            out[k] = _nanagg(vals, np.nanmean)
    if have_digests:
        merged = merge_digests(digests)
        for key, (metric, p) in PERCENTILE_KEYS.items():
            dig = merged.get(metric)
            if dig is not None and dig.count:
                out[key] = dig.quantile(p)
    if out.get("prefix_lookups"):
        out["prefix_hit_rate"] = out["prefix_hits"] / out["prefix_lookups"]
    if out.get("spec_drafted"):
        out["spec_acceptance_rate"] = (out["spec_accepted"]
                                       / out["spec_drafted"])
    if out.get("sim_energy_j"):
        out["sim_tokens_per_j"] = (out.get("sim_decode_tokens", 0.0)
                                   / out["sim_energy_j"])
    if out.get("sim_time_s"):
        out["sim_tokens_per_s"] = (out.get("sim_decode_tokens", 0.0)
                                   / out["sim_time_s"])
    return out


def merge_digests(digests: Sequence[Dict]) -> Dict:
    """Merge per-replica `Telemetry.digests()` payloads into one
    `QuantileDigest` per metric (skipping replicas that lack one)."""
    merged = {}
    for metric in sorted(set().union(*map(set, digests)) if digests
                         else ()):
        dig = merge_digest_dicts(d.get(metric) for d in digests)
        if dig is not None:
            merged[metric] = dig
    return merged


def aggregate_histograms(hists: Sequence[Dict]) -> Optional[Dict]:
    """Histograms compose exactly: same log-spaced edges everywhere, so
    the fleet distribution is the per-bucket sum."""
    if not hists:
        return None
    out: Dict[str, Dict] = {}
    for name in hists[0]:
        counts = np.sum([h[name]["counts"] for h in hists if name in h],
                        axis=0)
        out[name] = {"edges_s": list(hists[0][name]["edges_s"]),
                     "counts": [int(c) for c in counts]}
    return out


class FleetRouter:
    def __init__(self, engines: Sequence, *, policy=None,
                 max_pending: Optional[int] = None):
        """`engines`: one built `PagedServeEngine` per replica, same
        model/params each (asserted on the config).  `max_pending` is
        the PER-REPLICA admission cap in samples; fleet capacity is
        `max_pending * n_live`.  Policy and cap default to the engines'
        shared `ServeConfig` (the single object the launcher threads
        through), overridable per-router for tests."""
        assert engines, "a fleet needs at least one engine"
        serve_cfg = engines[0].config
        if policy is None:
            policy = serve_cfg.policy
        if max_pending is None:
            max_pending = serve_cfg.max_pending
        self.serve_config = serve_cfg
        self.tp = getattr(serve_cfg, "tp", 1)
        self.max_pending = max_pending
        for e in engines[1:]:
            self._check_same_model(e, engines[0])
        self.replicas = [Replica(e, i, max_pending)
                         for i, e in enumerate(engines)]
        self.policy: Policy = make_policy(policy)
        self.counters: Dict[str, int] = {"dispatched": 0, "requeued": 0,
                                         "requeue_failed": 0, "drains": 0,
                                         "adds": 0}
        self._owner: Dict[int, Replica] = {}    # id(req) -> replica
        self.tracer = get_tracer()
        # SLO layer (obs/slo.py): None until set_slos(); the drift
        # audit (per-replica, obs/drift.py) runs unconditionally on
        # every poll_slo tick — it needs no configuration
        self.slo: Optional[SLOMonitor] = None
        self._alert_subs: List[Callable[[Dict], None]] = []

    # -- SLOs / drift ----------------------------------------------------
    def set_slos(self, slos, *,
                 policy: Optional[BurnRatePolicy] = None) -> None:
        """Install declarative objectives (spec strings or `SLOSpec`s)
        evaluated per replica AND fleet-wide on every `poll_slo` tick."""
        self.slo = SLOMonitor(slos, policy=policy)

    def on_alert(self, cb: Callable[[Dict], None]) -> None:
        """Subscribe to alert events: SLO level transitions
        (kind="slo_alert") and drift alarms (kind="drift_alarm") — the
        hook a future autoscaler/drain controller consumes.  Callbacks
        run on whatever thread/loop calls `poll_slo`; exceptions are
        swallowed (a broken subscriber must not stop evaluation)."""
        self._alert_subs.append(cb)

    def poll_slo(self, now: Optional[float] = None) -> List[Dict]:
        """One evaluation tick, thread-free: reads only the lock-free
        snapshots/digests the driver taps publish.  Per live replica it
        advances the drift auditor over the measured-vs-simulated
        decode clocks; with SLOs configured it ingests every replica
        scope plus a synthetic "fleet" scope (summed counters + merged
        sketches) and re-evaluates burn rates.  Alert events are
        recorded into the scoped replica's flight recorder (fleet-scope
        events into every live replica's — a postmortem dump of any
        survivor explains the page) and delivered to `on_alert`
        subscribers.  Returns the events this tick produced."""
        now = time.monotonic() if now is None else now
        events: List[Dict] = []
        live = [rep for rep in self.replicas if rep.alive]
        for rep in live:
            snap = rep.snapshot
            if "sim_decode_s" in snap:
                ev = rep.drift.observe(now, snap.get("decode_s", 0.0),
                                       snap["sim_decode_s"])
                if ev is not None:
                    ev = {**ev, "scope": f"replica-{rep.id}"}
                    rep.engine.recorder.record(
                        "drift_alarm",
                        **{k: v for k, v in ev.items() if k != "kind"})
                    events.append(ev)
            if self.slo is not None:
                self.slo.ingest(f"replica-{rep.id}", digests=rep.digests,
                                counters=snap, now=now)
        if self.slo is not None and live:
            fleet_counters: Dict[str, float] = {}
            for rep in live:
                for k, v in rep.snapshot.items():
                    fleet_counters[k] = fleet_counters.get(k, 0.0) \
                        + float(v)
            fleet_digests = {m: d.to_dict() for m, d in
                            merge_digests([rep.digests
                                           for rep in live]).items()}
            self.slo.ingest("fleet", digests=fleet_digests,
                            counters=fleet_counters, now=now)
            for ev in self.slo.evaluate(now):
                scope = ev.get("scope", "")
                # the event dict already carries "kind" — strip it, the
                # recorder takes kind positionally
                fields = {k: v for k, v in ev.items() if k != "kind"}
                for rep in live:
                    if scope == "fleet" or scope == f"replica-{rep.id}":
                        rep.engine.recorder.record("slo_alert", **fields)
                events.append(ev)
        for ev in events:
            for cb in self._alert_subs:
                try:
                    cb(ev)
                except Exception:
                    pass
        return events

    def worst_alert_level(self) -> str:
        """Highest active SLO alert level across every scope ("ok"
        when no SLOs are configured) — /healthz's `degraded` flag."""
        return self.slo.worst_level() if self.slo is not None else "ok"

    def slo_payload(self) -> Dict:
        """JSON body for GET /debug/slo: objectives + policy + alert
        states + recent transitions, plus the per-replica drift audit."""
        payload = (self.slo.payload() if self.slo is not None
                   else {"slos": [], "states": [], "worst": "ok",
                         "transitions": []})
        payload["drift"] = {
            str(rep.id): {**rep.drift.summary(),
                          "events": list(rep.drift.events)}
            for rep in self.replicas}
        return payload

    @staticmethod
    def _check_same_model(engine, ref) -> None:
        assert (engine.model.cfg.name == ref.model.cfg.name
                and engine.model.cfg.vocab == ref.model.cfg.vocab
                and engine.max_seq == ref.max_seq), \
            "fleet replicas must serve the same model"

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "FleetRouter":
        for rep in self.replicas:
            rep.driver.start()
        return self

    def add_replica(self, engine) -> Replica:
        """Scale out at runtime — the inverse of `drain()`: wrap a
        freshly built engine (same model, typically sharing the first
        replica's params) in a `Replica`, start its driver thread, and
        enter it into rotation.  The next `route()` call sees it: every
        policy reads the live candidate list per dispatch, so rr cycles
        through it, least-loaded finds its empty queues immediately,
        and prefix-affinity starts matching once its tap publishes a
        fingerprint.  Replica ids are list indices and drained replicas
        keep their slot, so the new id is always `len(replicas)` —
        `cancel`/`/metrics` lookups stay index-stable.  Returns the new
        replica (already live; no request in flight is disturbed).  At
        tp > 1 `engine` is rank 0's, led on groups no other replica uses
        (`launch.serve.add_tp_replica` has every rank build it)."""
        self._check_same_model(engine, self.replicas[0].engine)
        if self.tp > 1:
            ls = engine.lockstep
            if ls is None or not ls.leader or any(
                    rep.engine.lockstep.tick_group is ls.tick_group
                    for rep in self.replicas):
                raise ValueError(
                    f"add_replica at tp={self.tp} takes rank 0's engine "
                    f"on a pair of groups of its own (every rank builds "
                    f"it: launch.serve.add_tp_replica)")
        rep = Replica(engine, len(self.replicas), self.max_pending)
        rep.driver.start()
        self.replicas.append(rep)
        self.counters["adds"] += 1
        if self.tracer.enabled:
            self.tracer.instant("replica_add", cat="router", replica=rep.id,
                                n_replicas=len(self.replicas))
        return rep

    def stop(self, timeout: float = 10.0) -> None:
        for rep in self.replicas:
            rep.driver.stop(timeout)

    @property
    def alive(self) -> bool:
        """Any replica's driver still running (drain-ing counts: it is
        serving its in-flight work); at tp > 1 every replica's, an added
        one's from the moment it joins, as they share their ranks."""
        if self.tp > 1:
            return all(rep.alive for rep in self.replicas)
        return any(rep.alive for rep in self.replicas)

    @property
    def n_live(self) -> int:
        return sum(rep.live for rep in self.replicas)

    # -- dispatch (event-loop side) ------------------------------------
    def route(self, prompt, n: int = 1) -> Optional[Replica]:
        """Pick the replica for a group of `n` samples over `prompt`,
        or None when every live replica is saturated (fleet-level
        shed) or none is live."""
        cands = [rep for rep in self.replicas
                 if rep.live and rep.has_capacity(n)]
        if not cands:
            return None
        return self.policy.pick(cands, prompt)

    def dispatch(self, rep: Replica, reqs: List, on_done: Callable):
        """Account the group against `rep` and submit it; returns the
        driver Future of engine ids.  Accounting happens NOW (before
        the future resolves) so a burst of arrivals sees each other's
        reservations."""
        rep.dispatches += 1
        rep.pending += len(reqs)
        self.counters["dispatched"] += 1
        if self.tracer.enabled:
            # the routing decision, with what the policy saw: per-
            # replica queue depth / liveness at pick time
            self.tracer.instant(
                "route_dispatch", cat="router",
                rid=getattr(reqs[0], "trace_id", -1),
                rids=[getattr(r, "trace_id", -1) for r in reqs],
                replica=rep.id, policy=self.policy.name,
                depths={str(r.id): r.depth() for r in self.replicas},
                live={str(r.id): r.live for r in self.replicas})
        for r in reqs:
            self._owner[id(r)] = rep
        return rep.driver.submit(reqs, on_done)

    def dispatch_failed(self, rep: Replica, reqs: List) -> None:
        """Roll back `dispatch` accounting after its future failed (the
        driver died between route and submit)."""
        rep.dispatches -= 1
        rep.pending -= len(reqs)
        self.counters["dispatched"] -= 1
        for r in reqs:
            self._owner.pop(id(r), None)

    def release(self, req) -> None:
        """One sample finished (done sweep landed on the event loop):
        free its replica's admission slot."""
        rep = self._owner.pop(id(req), None)
        if rep is not None:
            rep.pending -= 1

    async def cancel(self, reqs: List) -> int:
        """Cancel requests wherever they currently live (the owner map
        follows drain re-homes); returns how many were actually
        cancelled."""
        by_rep: Dict[int, List[int]] = {}
        for req in reqs:
            rep = self._owner.get(id(req))
            if rep is not None and rep.alive and req.eid >= 0:
                by_rep.setdefault(rep.id, []).append(req.eid)
        total = 0
        for rid, eids in by_rep.items():
            try:
                total += await asyncio.wrap_future(
                    self.replicas[rid].driver.cancel(eids))
            except RuntimeError:
                pass        # died mid-cancel: its requests died with it
        return total

    def retry_after_s(self) -> int:
        """Honest Retry-After for a fleet-level shed: the least-loaded
        live replica's pending depth times its measured per-token
        decode time (floor 1s) — an estimate of when a slot frees, not
        a constant."""
        best = None
        for rep in self.replicas:
            if not rep.live:
                continue
            s = rep.snapshot
            t_tok = (s["decode_s"] / s["decode_tokens"]
                     if s.get("decode_tokens") else 0.01)
            est = rep.pending * t_tok
            best = est if best is None else min(best, est)
        return max(1, int(np.ceil(best))) if best else 1

    # -- drain / re-home ------------------------------------------------
    def _requeue_target(self, n: int = 1) -> Optional[Replica]:
        """Least-loaded live replica for a drain re-home; capacity
        preferred, but an over-cap live replica still beats dropping a
        request (its engine-side queue absorbs the overflow)."""
        cands = [rep for rep in self.replicas
                 if rep.live and rep.has_capacity(n)]
        if not cands:
            cands = [rep for rep in self.replicas if rep.live]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.depth(), r.occupancy(), r.id))

    async def _resubmit(self, req, on_done) -> bool:
        on_done = on_done or (lambda r: None)
        for _ in range(len(self.replicas)):
            target = self._requeue_target()
            if target is None:
                break
            target.pending += 1
            self._owner[id(req)] = target
            try:
                await asyncio.wrap_future(target.driver.submit([req],
                                                               on_done))
                return True
            except RuntimeError:        # target died mid-re-home: next
                target.pending -= 1
                self._owner.pop(id(req), None)
        # no healthy replica anywhere: fail the request LOUDLY (watcher
        # fires, budgets release) — never silently drop it
        req.done = True
        req.cancelled = True
        try:
            on_done(req)
        except Exception:
            pass
        return False

    async def drain(self, index: int) -> int:
        """Drain replica `index`: no new dispatches land on it, its
        not-yet-started queue is re-homed onto healthy replicas, and
        its in-flight requests finish where they run.  Returns the
        number of requests re-homed.  The driver stays up (serving its
        tail); stop it afterwards if the replica is being retired."""
        rep = self.replicas[index]
        rep.draining = True
        self.counters["drains"] += 1
        if not rep.alive:
            return 0
        try:
            pulled = await asyncio.wrap_future(rep.driver.extract_queued())
        except RuntimeError:
            return 0
        requeued = 0
        for req, on_done in pulled:
            old = self._owner.pop(id(req), None)
            if old is not None:
                old.pending -= 1
            if await self._resubmit(req, on_done):
                requeued += 1
                self.counters["requeued"] += 1
            else:
                self.counters["requeue_failed"] += 1
        return requeued

    # -- metrics --------------------------------------------------------
    def policy_stats(self) -> Dict[str, int]:
        if isinstance(self.policy, PrefixAffinityPolicy):
            return {"affinity_hits": self.policy.hits,
                    "affinity_misses": self.policy.misses}
        return {}

    async def fleet_metrics(self) -> Dict:
        """Aggregate + per-replica metrics payload.  A drained or dead
        replica yields its router-side entry (state, counters, last
        snapshot) instead of a KeyError; the aggregate covers live
        replicas only."""
        per: Dict[str, Dict] = {}
        summaries, hists, digests = [], [], []
        n_running = n_queued = kv_free = 0
        for rep in self.replicas:
            entry = rep.describe()
            if rep.alive:
                try:
                    snap = await asyncio.wrap_future(rep.driver.call(
                        lambda eng: {
                            "engine": eng.summary(),
                            "histograms": eng.telemetry.histograms(),
                            "digests": eng.telemetry.digests(),
                            "n_running": eng.n_running,
                            "n_queued": eng.scheduler.n_queued,
                            "kv_pages_free": eng.cache.allocator.n_free}))
                    # sketches feed the fleet merge only — per-replica
                    # bucket maps would bloat every /metrics scrape
                    digests.append(snap.pop("digests"))
                    entry.update(snap)
                    summaries.append(snap["engine"])
                    hists.append(snap["histograms"])
                    n_running += snap["n_running"]
                    n_queued += snap["n_queued"]
                    kv_free += snap["kv_pages_free"]
                except RuntimeError:    # died between the alive check
                    entry["alive"] = False      # and the job: report it
                    entry["error"] = repr(rep.error) if rep.error else \
                        "engine driver not running"
            per[str(rep.id)] = entry
        payload = {
            "engine": aggregate_summaries(summaries, digests),
            "histograms": aggregate_histograms(hists),
            # the RESOLVED serving config (precision, kv dtype, pool
            # geometry): what the fleet is actually serving at, not
            # what the operator asked for
            "config": self.serve_config.as_dict(),
            "n_running": n_running, "n_queued": n_queued,
            "kv_pages_free": kv_free,
            "fleet": {"policy": self.policy.name,
                      "n_replicas": len(self.replicas),
                      "n_live": self.n_live,
                      "counters": dict(self.counters),
                      **self.policy_stats(),
                      "replicas": per}}
        if self.slo is not None:
            payload["slo"] = self.slo.payload()
        if not summaries:
            payload["error"] = "no live replica"
        return payload
