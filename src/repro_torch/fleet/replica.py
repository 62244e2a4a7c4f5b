"""One data-parallel engine replica behind the fleet router (PyTorch
port of `repro.fleet.replica`).

A replica is an `EngineDriver` (the one thread that owns its
`PagedServeEngine`) plus the host-side state the router needs to make
per-dispatch decisions WITHOUT crossing the thread boundary:

  pending      samples dispatched here and not yet done — event-loop-
               side, authoritative, updated synchronously at dispatch /
               release (the driver thread never touches it)
  snapshot     occupancy gauges published by the driver loop's tap
               after every step (`Telemetry.snapshot` + lane/page
               counts): at most one step stale, read lock-free (a dict
               swap is atomic in CPython)
  fingerprint  path-hash set of the engine's resident `PrefixIndex`
               prefixes, republished only when the trie's version
               moved — the prefix-affinity policy matches prompts
               against it with `prompt_page_hashes`, never touching
               the trie itself

Lifecycle: LIVE replicas take dispatches; a DRAINING replica takes no
new work but keeps stepping until its in-flight requests finish; a
replica whose driver died fail-fast (`alive == False`) is skipped by
every policy and reported per-replica in /metrics — the gateway stays
up on the survivors.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.api.driver import EngineDriver
from repro_torch.obs.drift import DriftAuditor


class Replica:
    def __init__(self, engine, rid: int, max_pending: int = 32):
        assert max_pending >= 0
        self.engine = engine
        self.id = rid
        self.max_pending = max_pending
        self.page_size = engine.cache.page_size     # for prompt hashing
        # label the engine's flight recorder with the fleet identity so
        # a postmortem dump says WHICH replica died (and the driver
        # thread name shows up as its own track in a Chrome trace)
        engine.recorder.label = f"replica-{rid}"
        self.driver = EngineDriver(engine, tap=self._publish)
        self.driver._thread.name = f"engine-driver-{rid}"
        self.pending = 0            # samples in flight (event-loop side)
        self.draining = False
        self.dispatches = 0         # request groups routed here
        self._fp_version = -1
        self.fingerprint: frozenset = frozenset()
        self._digest_version = -1
        # serialized quantile sketches (Telemetry.digests()), published
        # by the tap like the snapshot: the router's SLO poll and fleet
        # percentile merges read these lock-free
        self.digests: Dict[str, Dict] = {}
        # digital-twin audit: predicted vs measured decode clock,
        # ticked by FleetRouter.poll_slo from the published snapshot
        self.drift = DriftAuditor()
        self.snapshot: Dict[str, float] = {
            "n_running": 0.0, "n_queued": 0.0, "kv_occupancy": 0.0,
            "kv_pages_free": float(engine.cache.allocator.n_pages)}

    # -- state ----------------------------------------------------------
    @property
    def alive(self) -> bool:
        return self.driver.alive

    @property
    def live(self) -> bool:
        """Eligible for new dispatches."""
        return self.alive and not self.draining

    def has_capacity(self, n: int) -> bool:
        return self.pending + n <= self.max_pending

    @property
    def error(self) -> Optional[BaseException]:
        return self.driver.error

    # -- snapshot publisher (driver thread) -----------------------------
    def _publish(self, engine) -> None:
        """Driver-loop tap: build the routing snapshot ON the engine
        thread (where reading engine state is safe) and publish it by
        attribute swap.  The prefix fingerprint is rebuilt only when
        the trie's version moved — steady-state cost is a few dict
        reads per step."""
        snap = engine.telemetry.snapshot()
        snap["n_running"] = float(engine.n_running)
        snap["n_queued"] = float(engine.scheduler.n_queued)
        snap["kv_pages_free"] = float(engine.cache.allocator.n_free)
        snap["kv_occupancy"] = engine.cache.occupancy()
        energy = getattr(engine, "energy", None)
        if energy is not None:
            # the drift audit's predicted decode clock, tp-scaled like
            # sim_time_s (a tp=2 engine streams each step in half the
            # modeled single-device time)
            snap["sim_decode_s"] = energy.decode_sim_s / energy.tp
        if engine.prefix is not None:
            version = engine.prefix.version
            if version != self._fp_version:
                self._fp_version = version
                _, self.fingerprint = engine.prefix.fingerprint()
        dv = engine.telemetry.digest_version
        if dv != self._digest_version:
            self._digest_version = dv
            self.digests = engine.telemetry.digests()
        self.snapshot = snap

    # -- load metric ----------------------------------------------------
    def depth(self) -> float:
        """Pending depth for least-loaded comparison: samples dispatched
        and not yet finished (authoritative) plus the engine-side queue
        the router cannot see through `pending` alone after a drain
        re-home or direct submission."""
        return float(self.pending)

    def occupancy(self) -> float:
        return float(self.snapshot.get("kv_occupancy", 0.0))

    def describe(self) -> Dict:
        """Router-side (thread-free) view for /metrics: state + gauges;
        the engine's full summary is fetched separately via a driver
        job when the replica is alive."""
        return {"id": self.id, "alive": self.alive,
                "draining": self.draining, "pending": self.pending,
                "dispatches": self.dispatches,
                "error": repr(self.error) if self.error else None,
                "snapshot": dict(self.snapshot),
                "drift": self.drift.summary()}
