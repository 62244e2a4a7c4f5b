"""The port's fleet router (`repro_torch.fleet`) against the JAX
package's (`repro.fleet`), on the CPU.

Every behaviour of `tests/test_fleet.py` is one case run against both
packages (parametrised over `repro` and `repro_torch`): the dispatch
policies pick the same replica on the same snapshots,
`aggregate_summaries` / `aggregate_histograms` give equal rollups,
prefix affinity routes a repeated prompt to the replica holding its
pages, drain and add-replica-under-load lose and duplicate no request
and free every page, a dead replica is evicted with partial-fleet
/metrics and /healthz, the fleet sheds (429) only when every replica is
saturated, and greedy streams through two replicas equal the offline
engine's (and, across packages, each other's).

Deterministic: a driver is parked on a gate (a job that waits on an
event) right after the step whose state the test needs, via its tap, so
no test polls a replica's state against a deadline.  Same tiny model and
pairing as `tests/test_torch_gateway.py`.
"""
import asyncio
import json
import math
import threading

import numpy as np
import pytest

import repro.fleet as jax_fleet
import repro.obs as jax_obs
import repro.serve.prefix as jax_prefix

import repro_torch.fleet as port_fleet
import repro_torch.obs as port_obs
import repro_torch.serve.prefix as port_prefix

from test_torch_gateway import (PKGS, PROMPTS, body, count_dispatches,
                                get, offline, on_driver, page_audit, pkg,
                                post, status, stream_tokens)

FLEET = {"repro": (jax_fleet, jax_prefix, jax_obs),
         "repro_torch": (port_fleet, port_prefix, port_obs)}


# ----------------------------------------------------------------------------
# policies on stand-in replicas
# ----------------------------------------------------------------------------
class FakeReplica:
    def __init__(self, rid, depth=0.0, occ=0.0, fingerprint=()):
        self.id = rid
        self.page_size = 8
        self._depth = depth
        self._occ = occ
        self.fingerprint = frozenset(fingerprint)

    def depth(self):
        return self._depth

    def occupancy(self):
        return self._occ


@pytest.mark.parametrize("name", PKGS)
def test_round_robin_cycles_replica_ids_not_candidate_slots(name):
    fleet = FLEET[name][0]
    a, b, c = (FakeReplica(i) for i in range(3))
    pol = fleet.RoundRobinPolicy()
    assert [pol.pick([a, b, c], None).id for _ in range(4)] == [0, 1, 2, 0]
    assert [pol.pick([a, c], None).id for _ in range(3)] == [2, 0, 2]


@pytest.mark.parametrize("name", PKGS)
def test_least_loaded_prefers_depth_then_occupancy_then_id(name):
    pol = FLEET[name][0].LeastLoadedPolicy()
    a = FakeReplica(0, depth=2.0, occ=0.1)
    b = FakeReplica(1, depth=1.0, occ=0.9)
    c = FakeReplica(2, depth=1.0, occ=0.2)
    d = FakeReplica(3, depth=1.0, occ=0.2)
    assert pol.pick([a, b, c, d], None).id == 2
    assert pol.pick([d, c], None).id == 2


@pytest.mark.parametrize("name", PKGS)
def test_prefix_affinity_scores_and_picks_as_jax(name):
    fleet, prefix, _ = FLEET[name]
    prompt = np.arange(24, dtype=np.int32)
    hashes = prefix.prompt_page_hashes(prompt, 8)
    assert hashes == jax_prefix.prompt_page_hashes(prompt, 8)
    assert len(hashes) == 2
    assert hashes[0] == prefix.combine_hash(
        prefix.ROOT_HASH, tuple(int(t) for t in prompt[:8]))
    holder = FakeReplica(0, depth=5.0, fingerprint=hashes)
    cold = FakeReplica(1, depth=0.0)
    gapped = FakeReplica(2, depth=0.0, fingerprint=hashes[1:])
    half = FakeReplica(3, depth=1.0, fingerprint=hashes[:1])
    pol = fleet.PrefixAffinityPolicy()
    assert [pol.score(r, hashes) for r in (holder, cold, gapped, half)] \
        == [2, 0, 0, 1]
    assert pol.pick([holder, cold, gapped, half], prompt) is holder
    assert pol.pick([cold, half], prompt) is half
    assert (pol.hits, pol.misses) == (2, 0)
    assert pol.pick([FakeReplica(0, depth=3.0), cold], prompt) is cold
    assert pol.pick([cold], None) is cold
    assert (pol.hits, pol.misses) == (2, 2)


@pytest.mark.parametrize("name", PKGS)
def test_make_policy_names(name):
    fleet = FLEET[name][0]
    for key, cls in (("rr", fleet.RoundRobinPolicy),
                     ("round-robin", fleet.RoundRobinPolicy),
                     ("least-loaded", fleet.LeastLoadedPolicy),
                     ("prefix", fleet.PrefixAffinityPolicy),
                     ("prefix-affinity", fleet.PrefixAffinityPolicy)):
        assert isinstance(fleet.make_policy(key), cls)
    pol = fleet.PrefixAffinityPolicy()
    assert fleet.make_policy(pol) is pol
    with pytest.raises(ValueError) as port_err:
        fleet.make_policy("nope")
    with pytest.raises(ValueError) as jax_err:
        jax_fleet.make_policy("nope")
    assert str(port_err.value) == str(jax_err.value)


# ----------------------------------------------------------------------------
# fleet rollups
# ----------------------------------------------------------------------------
def _summaries(obs, case):
    rng = np.random.default_rng(21)
    summaries, digests, hists = [], [], []
    for r in range(3):
        samples = rng.lognormal(-4 + r, 0.3, 500 * (r + 1))
        d = obs.QuantileDigest()
        d.extend(samples)
        summaries.append({
            "requests_total": float(len(samples)), "tokens": 10.0 * r,
            "prefix_lookups": 4.0, "prefix_hits": float(r),
            "spec_drafted": 6.0, "spec_accepted": float(r + 1),
            "sim_energy_j": 0.5 * (r + 1), "sim_decode_tokens": 7.0,
            "sim_time_s": 0.25, "kv_occupancy_peak": 0.1 * r,
            "ttft_p95_s": float(np.percentile(samples, 95)),
            "tpot_mean_s": float("nan") if r == 1 else 0.01 * r,
            "lane_steps_2": float(r)})
        digests.append({"ttft_s": d.to_dict()})
        edges = [0.0, 0.01, 0.1, "inf"]
        hists.append({"ttft_s": {"edges_s": edges,
                                 "counts": [r, 2 * r, 1]}})
    if case == "empty-replica":
        summaries.append({"requests_total": 0.0})
        digests.append({})
        hists.append({"ttft_s": {"edges_s": hists[0]["ttft_s"]["edges_s"],
                                 "counts": [0, 0, 0]}})
    return summaries, (digests if case != "no-digests" else None), hists


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


@pytest.mark.parametrize("case", ["digests", "no-digests", "empty-replica"])
@pytest.mark.parametrize("name", PKGS)
def test_aggregate_summaries_and_histograms_equal_jax(name, case):
    fleet, _, obs = FLEET[name]
    s, d, h = _summaries(obs, case)
    js, jd, jh = _summaries(jax_obs, case)
    got = fleet.aggregate_summaries(s, d)
    want = jax_fleet.aggregate_summaries(js, jd)
    assert _same(got, want)
    assert got["requests_total"] == sum(x["requests_total"] for x in s)
    assert got["prefix_hit_rate"] == 3.0 / 12.0
    assert _same(fleet.aggregate_histograms(h),
                 jax_fleet.aggregate_histograms(jh))
    assert fleet.aggregate_summaries([]) is None
    assert fleet.aggregate_histograms([]) is None


# ----------------------------------------------------------------------------
# e2e through the gateway
# ----------------------------------------------------------------------------
def park_after(driver, cond):
    """Park `driver`'s thread on a gate right after the first step whose
    engine satisfies `cond`: its tap (run after each step, on the driver
    thread) queues a job that waits on the gate, and the loop runs queued
    jobs before its next step.  Returns (seen, gate) events."""
    seen, gate = threading.Event(), threading.Event()
    tap = driver._tap

    def parked_tap(engine):
        tap(engine)
        if not seen.is_set() and cond(engine):
            seen.set()
            driver.call(lambda e: gate.wait(30))
    driver._tap = parked_tap
    return seen, gate


async def wait_event(evt, timeout=30):
    assert await asyncio.get_running_loop().run_in_executor(
        None, evt.wait, timeout)


@pytest.mark.parametrize("name", PKGS)
def test_fleet_prefix_affinity_routes_repeat_to_holder(name):
    p = pkg(name)
    prompt = list(range(1, 13))     # 12 tokens: 1 committable page of 8

    async def run():
        router = p.fleet.FleetRouter([p.engine() for _ in range(2)],
                                     policy="prefix", max_pending=8)
        gw = p.api.Gateway(router)
        host, port = await gw.start()
        try:
            first = await post(host, port, {"prompt": prompt,
                                            "max_tokens": 4})
            holder = max(router.replicas, key=lambda r: r.dispatches)
            # the tap published the trie's fingerprint after the step
            # that committed the pages, before the done sweep answered
            fingerprint = holder.fingerprint
            rest = [await post(host, port, {"prompt": prompt,
                                            "max_tokens": 4})
                    for _ in range(2)]
            m = json.loads(body(await get(host, port, "/metrics")))
        finally:
            await gw.stop()
        return (first, rest, m, fingerprint, router.policy.hits,
                router.policy.misses, holder.dispatches, holder.id)

    first, rest, m, fp, hits, misses, holder_n, holder_id = \
        asyncio.run(run())
    assert fp, "the holder's fingerprint was published"
    for raw in [first] + rest:
        assert status(raw) == 200
    assert (hits, misses) == (2, 1) and holder_n == 3
    eng = m["fleet"]["replicas"][str(holder_id)]["engine"]
    assert eng["prefix_hits"] >= 2 and eng["prefill_tokens_skipped"] >= 16
    assert m["fleet"]["affinity_hits"] == 2
    assert m["engine"]["prefix_hit_rate"] > 0
    assert stream_tokens(p, first)[0] == stream_tokens(p, rest[0])[0] \
        == stream_tokens(p, rest[1])[0]


DRAIN_PROMPTS = [[1, 2, 3], [5, 6, 7, 8], [9, 10, 11], [13, 14]]


@pytest.mark.parametrize("name", PKGS)
def test_fleet_drain_requeues_without_loss_or_leaks(name):
    p = pkg(name)
    prompts = DRAIN_PROMPTS[:3]
    ref = offline(p, prompts, 8)

    async def run():
        # one lane a replica: all three groups go to replica 0, one runs
        # and two wait in its queue until the drain re-homes them
        router = p.fleet.FleetRouter(
            [p.engine(max_batch=1) for _ in range(2)],
            policy="least-loaded", max_pending=8).start()
        rep0, rep1 = router.replicas
        done, done_evt = [], threading.Event()

        def on_done(req):           # driver thread
            done.append(req)
            router.release(req)
            if len(done) == 3:
                done_evt.set()

        first = threading.Event()
        rep0.driver.call(lambda e: first.wait(30))  # all three land at once
        seen, gate = park_after(rep0.driver, lambda e: (
            e.n_running, e.scheduler.n_queued) == (1, 2))
        try:
            reqs = [p.serve.ServeRequest(prompt=np.asarray(q, np.int32),
                                         max_new_tokens=8, rid=i)
                    for i, q in enumerate(prompts)]
            futs = [router.dispatch(rep0, [r], on_done) for r in reqs]
            first.set()
            for f in futs:
                await asyncio.wrap_future(f)
            await wait_event(seen)
            drain = asyncio.ensure_future(router.drain(0))
            await asyncio.sleep(0)      # its extract job queues behind
            gate.set()                  # the gate
            requeued = await drain
            live_after = (rep0.live, rep0.alive)
            routed = router.route(np.asarray(prompts[0]), 1)
            await wait_event(done_evt)
            audit = [await on_driver(rep.driver, page_audit)
                     + (rep.engine.telemetry.requests_total,)
                     for rep in (rep0, rep1)]
        finally:
            gate.set()
            first.set()
            router.stop()
        return (reqs, done, requeued, live_after, routed is rep1, audit,
                dict(router.counters), (rep0.pending, rep1.pending))

    reqs, done, requeued, live_after, routed_rep1, audit, counters, \
        pending = asyncio.run(run())
    assert requeued == 2 and counters["requeued"] == 2
    assert counters["requeue_failed"] == 0 and counters["drains"] == 1
    assert live_after == (False, True) and routed_rep1
    assert len(done) == 3 and len({id(r) for r in done}) == 3
    for r, want in zip(reqs, ref):
        assert not r.cancelled and not r.rejected
        assert r.out_tokens == want
    for free_or_cached, n_pages, running, queued, _, _ in audit:
        assert (running, queued) == (0, 0)
        assert free_or_cached == n_pages
    assert [a[5] for a in audit] == [1.0, 2.0]
    assert pending == (0, 0)


@pytest.mark.parametrize("name", PKGS)
def test_fleet_add_replica_under_load_zero_loss(name):
    p = pkg(name)
    prompts = DRAIN_PROMPTS
    ref = offline(p, prompts, 8)

    async def run():
        router = p.fleet.FleetRouter([p.engine(max_batch=1)],
                                     policy="least-loaded",
                                     max_pending=8).start()
        rep0 = router.replicas[0]
        done, done_evt = [], threading.Event()

        def on_done(req):
            done.append(req)
            router.release(req)
            if len(done) == len(prompts):
                done_evt.set()

        first = threading.Event()
        rep0.driver.call(lambda e: first.wait(30))
        seen, gate = park_after(rep0.driver, lambda e: (
            e.n_running, e.scheduler.n_queued) == (1, 1))
        try:
            reqs = [p.serve.ServeRequest(prompt=np.asarray(q, np.int32),
                                         max_new_tokens=8, rid=i)
                    for i, q in enumerate(prompts)]
            futs = [router.dispatch(rep0, [r], on_done) for r in reqs[:2]]
            first.set()
            for f in futs:
                await asyncio.wrap_future(f)
            await wait_event(seen)      # under load: one runs, one waits
            rep1 = router.add_replica(p.engine(max_batch=1))
            assert rep1.id == 1 and rep1.live and rep1.driver.alive
            picked = []
            for r in reqs[2:]:
                rep = router.route(r.prompt, 1)
                picked.append(rep.id)
                await asyncio.wrap_future(router.dispatch(rep, [r],
                                                          on_done))
            gate.set()
            await wait_event(done_evt)
            audit = [await on_driver(rep.driver, page_audit)
                     for rep in router.replicas]
        finally:
            gate.set()
            first.set()
            router.stop()
        return (reqs, done, picked, audit, dict(router.counters),
                [rep.pending for rep in router.replicas])

    reqs, done, picked, audit, counters, pending = asyncio.run(run())
    assert counters["adds"] == 1 and picked == [1, 1]
    assert len(done) == 4 and len({id(r) for r in done}) == 4
    for r, want in zip(reqs, ref):
        assert not r.cancelled and not r.rejected and not r.truncated
        assert r.out_tokens == want
    for free_or_cached, n_pages, running, queued, _ in audit:
        assert (running, queued) == (0, 0)
        assert free_or_cached == n_pages
    assert pending == [0, 0]


@pytest.mark.parametrize("name", PKGS)
def test_fleet_refuses_a_replica_of_another_model(name):
    p = pkg(name)
    router = p.fleet.FleetRouter([p.engine()])
    other = type(p.model)(p.model.cfg.replace(name="other"))
    with pytest.raises(AssertionError, match="same model"):
        router.add_replica(p.engine(model=other))


@pytest.mark.parametrize("name", PKGS)
def test_fleet_dead_replica_evicted_and_partial_metrics(name):
    p = pkg(name)

    async def run():
        router = p.fleet.FleetRouter([p.engine() for _ in range(2)],
                                     policy="rr", max_pending=8)
        gw = p.api.Gateway(router)
        host, port = await gw.start()
        try:
            router.replicas[0].driver.stop()
            health = await get(host, port, "/healthz")
            raws = [await post(host, port, {"prompt": [1, 2, 3],
                                            "max_tokens": 3})
                    for _ in range(3)]
            m = json.loads(body(await get(host, port, "/metrics")))
            router.replicas[1].driver.stop()
            dead_health = await get(host, port, "/healthz")
            dead_post = await post(host, port, {"prompt": [1, 2],
                                                "max_tokens": 2})
            dead_m = json.loads(body(await get(host, port, "/metrics")))
        finally:
            await gw.stop()
        return health, raws, m, dead_health, dead_post, dead_m, \
            router.replicas[1].dispatches

    health, raws, m, dead_health, dead_post, dead_m, surv = \
        asyncio.run(run())
    assert status(health) == 200
    assert json.loads(body(health))["n_live"] == 1
    assert all(status(raw) == 200 for raw in raws) and surv == 3
    assert m["fleet"]["n_live"] == 1
    assert m["fleet"]["replicas"]["0"]["alive"] is False
    assert "engine" not in m["fleet"]["replicas"]["0"]
    assert m["fleet"]["replicas"]["1"]["alive"] is True
    assert m["engine"]["requests"] == 3.0
    assert m["gateway"]["accepted_samples"] == 3
    assert status(dead_health) == 503 and status(dead_post) == 503
    assert dead_m["engine"] is None and "error" in dead_m


@pytest.mark.parametrize("name", PKGS)
def test_fleet_429_only_when_all_replicas_saturated(name):
    p = pkg(name)

    async def run():
        router = p.fleet.FleetRouter([p.engine() for _ in range(2)],
                                     policy="least-loaded", max_pending=1)
        gw = p.api.Gateway(router)
        host, port = await gw.start()
        accepted = count_dispatches(router)
        gates = [threading.Event(), threading.Event()]
        try:
            for rep, gate in zip(router.replicas, gates):
                rep.driver.call(lambda e, g=gate: g.wait(30))
            first = asyncio.ensure_future(
                post(host, port, {"prompt": [1, 2], "max_tokens": 2}))
            second = asyncio.ensure_future(
                post(host, port, {"prompt": [3, 4], "max_tokens": 2}))
            on = await accepted(2)
            third = await post(host, port, {"prompt": [5, 6],
                                            "max_tokens": 2})
            for g in gates:
                g.set()
            first_raw, second_raw = await first, await second
        finally:
            for g in gates:
                g.set()
            await gw.stop()
        return first_raw, second_raw, third, dict(gw.counters), on

    first_raw, second_raw, third, counters, on = asyncio.run(run())
    assert sorted(on) == [0, 1]
    assert status(first_raw) == 200 and status(second_raw) == 200
    assert status(third) == 429 and b"retry-after" in third.lower()
    assert counters["rejected_429"] == 1


@pytest.mark.parametrize("precision", ["fp", "int4"])
def test_fleet_sse_greedy_equal_offline_and_jax(precision):
    prompts = PROMPTS + [[17, 3]]
    streams = {}
    for name in PKGS:
        p = pkg(name, precision)

        async def run():
            router = p.fleet.FleetRouter([p.engine() for _ in range(2)],
                                         policy="rr", max_pending=16)
            gw = p.api.Gateway(router)
            host, port = await gw.start()
            try:
                raws = await asyncio.gather(*[
                    post(host, port, {"prompt": q, "max_tokens": 6})
                    for q in prompts])
            finally:
                await gw.stop()
            return raws, [rep.dispatches for rep in router.replicas]

        raws, dispatches = asyncio.run(run())
        assert dispatches == [2, 2]
        got = []
        for raw in raws:
            assert status(raw) == 200
            toks, fins = stream_tokens(p, raw)
            assert fins[0] == "length"
            got.append(toks[0])
        assert got == offline(p, prompts, 6), name
        streams[name] = got
    assert streams["repro_torch"] == streams["repro"]


@pytest.mark.parametrize("name", PKGS)
def test_replica_tap_publishes_the_drift_clock(name):
    """The replica's tap publishes the engine's simulated decode clock
    (`energy.decode_sim_s`) beside the measured one; `poll_slo` feeds
    both to the drift auditor."""
    p = pkg(name)

    async def run():
        router = p.fleet.FleetRouter([p.engine()], max_pending=8)
        gw = p.api.Gateway(router, slo_poll_s=3600)
        host, port = await gw.start()
        try:
            await post(host, port, {"prompt": [1, 2, 3], "max_tokens": 6})
            rep = router.replicas[0]
            snap = dict(rep.snapshot)
            sim = await on_driver(rep.driver,
                                  lambda e: e.energy.decode_sim_s)
            router.poll_slo(now=1.0)
            ticks = rep.drift.summary()
        finally:
            await gw.stop()
        return snap, sim, ticks

    snap, sim, ticks = asyncio.run(run())
    assert snap["sim_decode_s"] == sim > 0
    assert snap["decode_s"] > 0 and snap["decode_tokens"] == 5.0
    assert set(ticks) >= {"sim_drift_ratio", "sim_drift_alarm",
                          "sim_measured_ratio"}
