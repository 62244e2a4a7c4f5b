"""What each rank of the 2-rank gloo groups of
tests/test_torch_tp_serving.py, tests/test_torch_tp_moe_mla.py,
tests/test_torch_tp_recurrent.py and tests/test_torch_tp_gateway.py
runs (a module of its own, so a spawned rank imports torch, numpy and
repro_torch, and neither JAX nor the JAX package).

`rank_main(rank, init, cases, queue)` serves every case of `cases` at
tp = 2 on the CPU and puts (rank, results) on `queue`: each case's
greedy streams and summary, the collectives it ran and its step calls,
the rank's pool and weight shapes, two requests with deadlines decided
on rank 0's clock, then the page-conservation trials and the refusals
(a group of the wrong size; the MoE, MLA, recurrent and hybrid families
admitted).  `moe_rank_main` does the same for the MoE and MLA cases,
with every leaf's shape on the rank and the slots the router dropped;
`recurrent_rank_main` for the xlstm and zamba cases, with the rank's
arena, its preemptions and the recurrent families' refusals;
`gateway_rank_main` runs tests/test_torch_tp_gateway.py's cases (the
gateway at tp = 2, rank 0 leading, rank 1 following).  A rank that
raises puts (rank, the traceback).

An arch is a dict of `ModelConfig` fields whose `moe` / `mla` / `ssm` /
`zamba` entries are dicts of their configs' fields (`port_config`), so
that each package builds its own config objects from one description.
"""
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.dist import collective_counts, reset_collective_counts
from repro_torch.models import DecoderLM, ModelConfig
from repro_torch.models import ffn as port_ffn
from repro_torch.models.common import init_params
from repro_torch.models.config import (MLAConfig, MoEConfig, SSMConfig,
                                       ZambaConfig)
from repro_torch.quant.qarray import QTensor
from repro_torch.serve import (PagedServeEngine, SamplingParams, ServeConfig,
                               ServeRequest)
from repro_torch.spec import SpecConfig


def port_config(arch) -> ModelConfig:
    """The port's f32 ModelConfig of an arch dict (`moe` / `mla` / `ssm`
    / `zamba` given as dicts of their fields, or as None)."""
    kw = dict(arch, dtype="float32", remat=False)
    for k, cls in (("moe", MoEConfig), ("mla", MLAConfig),
                   ("ssm", SSMConfig), ("zamba", ZambaConfig)):
        if isinstance(kw.get(k), dict):
            kw[k] = cls(**kw[k])
    return ModelConfig(**kw)


def serve(arch, params, serve_kw, prompts, new, spec_k=0, drafter="ngram"):
    """(streams, engine) of one engine run on the CPU; `drafter="model"`
    drafts with the launcher's 1-layer draft model (float, seed 7),
    whole on every rank."""
    model = DecoderLM(port_config(arch))
    spec = None
    if spec_k and drafter == "model":
        from repro_torch.launch.serve import build_draft
        draft, dparams = build_draft(model.cfg, "cpu")
        spec = SpecConfig(k=spec_k, drafter="model", draft_model=draft,
                          draft_params=dparams,
                          draft_page_size=serve_kw["page_size"])
    elif spec_k:
        spec = SpecConfig(k=spec_k)
    eng = PagedServeEngine(model, from_numpy_tree(params),
                           ServeConfig(**serve_kw), spec=spec, device="cpu")
    reqs = [ServeRequest(prompt=p.copy(), max_new_tokens=new, rid=i)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    return [r.out_tokens for r in reqs], eng


def conservation(arch, params, trials=2):
    """JAX's page-conservation property (tests/test_tp_serving.py) on
    this rank's sharded int4 pools: random submits, aborts, fork
    children and preemptions; returns each trial's checks, then those
    of a run whose pool of 9 pages cannot hold its three lanes' growth
    (tests/test_torch_model.py's preemption case), so lanes are
    preempted and rebuilt."""
    model = DecoderLM(port_config(arch))
    params = from_numpy_tree(params)
    rng = np.random.default_rng(11)
    out = []
    for trial in range(trials):
        cfg = ServeConfig(precision="int4", quant_group=16, max_batch=2,
                          max_seq=32, page_size=4,
                          n_pages=int(rng.integers(10, 16)),
                          prefill_chunk=4, seed=trial, tp=2)
        eng = PagedServeEngine(model, params, cfg, device="cpu")
        n_pages = eng.cache.allocator.n_pages
        reqs, pending = [], []
        for i in range(int(rng.integers(5, 8))):
            prompt = rng.integers(0, arch["vocab"], int(rng.integers(2, 12))
                                  ).astype(np.int32)
            r = ServeRequest(prompt=prompt, rid=i,
                             max_new_tokens=int(rng.integers(2, 8)),
                             sampling=SamplingParams(
                                 temperature=float(rng.choice([0., 1.]))))
            if reqs and rng.random() < 0.3:
                r.prompt = reqs[-1].prompt.copy()
                r.fork_from = reqs[-1]
            reqs.append(r)
            pending.append(r)
        leaks = 0
        for _ in range(300):
            if pending and (rng.random() < 0.4 or not eng.busy):
                eng.submit(pending.pop(0))
            elif eng.busy:
                eng.step()
            live = [r for r in reqs if r.eid >= 0 and not r.done]
            if live and rng.random() < 0.2:
                eng.cancel(live[int(rng.integers(0, len(live)))].eid)
            alloc = eng.cache.allocator
            held = {p for pages in alloc._held.values() for p in pages}
            leaks += alloc.n_free + len(held) != n_pages
            if not pending and not eng.busy:
                break
        while eng.busy:
            eng.step()
        out.append({"leaks": leaks,
                    "drained": eng.cache.n_free_or_cached() == n_pages
                    and all(r is None for r in eng.lanes),
                    "preemptions": sum(e["kind"] == "preempt" for e in
                                       eng.recorder.snapshot()),
                    "forks": sum(r.fork_from is not None for r in reqs),
                    "streams": [r.out_tokens for r in reqs],
                    "pool_heads": eng.cache.pools["attn"]["k"].shape[-2]})
    eng = PagedServeEngine(model, params, ServeConfig(
        precision="int4", quant_group=16, max_batch=3, max_seq=32,
        page_size=4, n_pages=9, prefill_chunk=8, prefix_cache=False, tp=2),
        device="cpu")
    reqs = [ServeRequest(prompt=rng.integers(0, arch["vocab"], n)
                         .astype(np.int32), max_new_tokens=10, rid=i)
            for i, n in enumerate((3, 9, 6))]
    eng.run(reqs)
    out.append({"leaks": 0, "drained": eng.cache.n_free_or_cached() == 9
                and all(r.done for r in reqs),
                "preemptions": sum(e["kind"] == "preempt" for e in
                                   eng.recorder.snapshot()),
                "forks": 0, "streams": [r.out_tokens for r in reqs],
                "pool_heads": eng.cache.pools["attn"]["k"].shape[-2]})
    return out


def refusals(refused):
    """The message each refused engine raises at tp = 2 on this group:
    tp = 3 on 2 ranks, then each family `refused["families"]` names;
    "admitted" for each family of `refused["admitted"]` (an engine built
    at tp = 2 on random smoke weights)."""
    out = {}
    kw = dict(max_batch=2, max_seq=32, page_size=4)
    arch = refused["tp3"]
    model = DecoderLM(ModelConfig(**arch))
    try:
        PagedServeEngine(model, {}, ServeConfig(tp=3, **kw), device="cpu")
    except ValueError as e:
        out["tp3"] = str(e)
    for arch_id in refused["families"]:
        model = DecoderLM(get_smoke_config(arch_id))
        try:
            PagedServeEngine(model, {}, ServeConfig(tp=2, **kw),
                             device="cpu")
        except NotImplementedError as e:
            out[arch_id] = str(e)
    for arch_id in refused.get("admitted", ()):
        model = DecoderLM(get_smoke_config(arch_id).replace(
            dtype="float32"))
        params = init_params(model.param_specs(),
                             torch.Generator().manual_seed(0))
        eng = PagedServeEngine(model, params, ServeConfig(tp=2, **kw),
                               device="cpu")
        out[arch_id] = f"admitted, tp {eng.config.tp}"
    return out


def leaf_shapes(tree, prefix=""):
    """{path: shape} of every leaf of a param or pool tree (a QTensor's
    orig_shape)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaf_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.orig_shape if isinstance(tree, QTensor)
                          else tree.shape)}


class DropCount:
    """Counts the (token, k) slots `dispatch_slots` drops at capacity
    (its sentinel row) while on, and the slots it routes."""

    def __enter__(self):
        self.orig, self.dropped, self.slots = port_ffn.dispatch_slots, 0, 0

        def spy(ids, n_experts, cap, groups=1):
            slot, counts = self.orig(ids, n_experts, cap, groups)
            self.dropped += int((slot == n_experts * groups * cap).sum())
            self.slots += slot.numel()
            return slot, counts
        port_ffn.dispatch_slots = spy
        return self

    def __exit__(self, *exc):
        port_ffn.dispatch_slots = self.orig


def moe_rank_main(rank, init, cases, queue):
    """One rank of tests/test_torch_tp_moe_mla.py's group: every MoE /
    MLA case at tp = 2."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=2)
        res = {}
        for name, case in cases.items():
            reset_collective_counts()
            with DropCount() as drops:
                streams, eng = serve(case["arch"], case["params"],
                                     dict(case["serve"], tp=2),
                                     case["prompts"], case["new"],
                                     case["spec_k"])
            res[name] = {
                "streams": streams,
                "summary": eng.summary(),
                "collectives": collective_counts(),
                "calls": eng.prefill_calls + eng.decode_calls
                + eng.verify_calls,
                "verify_calls": eng.verify_calls,
                "dropped": drops.dropped, "slots": drops.slots,
                "params": leaf_shapes(eng.params),
                "pools": leaf_shapes(eng.cache.pools),
                "drained": eng.cache.n_free_or_cached()
                == eng.cache.allocator.n_pages,
            }
        dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, traceback.format_exc()))


def rank_main(rank, init, cases, queue):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=2)
        res = {}
        for name, case in cases["streams"].items():
            reset_collective_counts()
            streams, eng = serve(case["arch"], case["params"],
                                 dict(case["serve"], tp=2), case["prompts"],
                                 case["new"], case["spec_k"],
                                 case["drafter"])
            blocks = eng.params["blocks"]
            res[name] = {
                "streams": streams,
                "summary": eng.summary(),
                "collectives": collective_counts(),
                "calls": eng.prefill_calls + eng.decode_calls
                + eng.verify_calls,
                "verify_calls": eng.verify_calls,
                "pool_heads": eng.cache.pools["attn"]["k"].shape[-2],
                "wq_cols": blocks["attn"]["wq"].shape[-1],
                "w_down_rows": blocks["ffn"]["w_down"].shape[-2],
                "vocab_rows": eng.params["embed"].shape[0],
                "drained": eng.cache.n_free_or_cached()
                == eng.cache.allocator.n_pages,
            }
            if name == "fp":
                res["deadline"] = deadline_decisions(eng,
                                                     case["prompts"][0])
        c = cases["conservation"]
        res["conservation"] = conservation(c["arch"], c["params"])
        res["refusals"] = refusals(cases["refused"])
        dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, traceback.format_exc()))


def deadline_decisions(eng, prompt):
    """Two requests with deadlines on `eng`, one due long after its
    admission and one due before it was queued, served to the end: each
    one's (rejected, reason, tokens)."""
    reqs = [ServeRequest(prompt=prompt.copy(), max_new_tokens=3, rid=i,
                         deadline_s=dl) for i, dl in enumerate((60.0, -1.0))]
    for r in reqs:
        eng.submit(r)
    while eng.busy:
        eng.step()
    return [(r.rejected, r.reject_reason, list(r.out_tokens)) for r in reqs]


def recurrent_refusals(case, tp=2):
    """The message of each capability a recurrent engine refuses at `tp`
    (speculation, the prefix cache, a fork), and how it decides two
    requests with deadlines after that (`deadline_decisions`)."""
    model = DecoderLM(port_config(case["arch"]))
    params = from_numpy_tree(case["params"])
    kw = dict(case["serve"], tp=tp)
    out = {}
    try:
        PagedServeEngine(model, params, ServeConfig(**kw),
                         spec=SpecConfig(k=4), device="cpu")
    except ValueError as e:
        out["spec"] = str(e)
    try:
        PagedServeEngine(model, params, ServeConfig(**kw, prefix_cache=True),
                         device="cpu")
    except ValueError as e:
        out["prefix"] = str(e)
    eng = PagedServeEngine(model, params, ServeConfig(**kw), device="cpu")
    parent = ServeRequest(prompt=case["prompts"][0], max_new_tokens=2)
    eng.submit(parent)
    try:
        eng.submit(ServeRequest(prompt=case["prompts"][0], fork_from=parent))
    except ValueError as e:
        out["fork"] = str(e)
    out["deadline"] = deadline_decisions(eng, case["prompts"][0])
    return out


def recurrent_rank_main(rank, init, cases, queue):
    """One rank of tests/test_torch_tp_recurrent.py's group: every xlstm
    / zamba case at tp = 2, then the refusals."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=2)
        res = {}
        for name, case in cases["streams"].items():
            reset_collective_counts()
            streams, eng = serve(case["arch"], case["params"],
                                 dict(case["serve"], tp=2),
                                 case["prompts"], case["new"], 0)
            events = eng.recorder.snapshot()
            res[name] = {
                "streams": streams,
                "summary": eng.summary(),
                "collectives": collective_counts(),
                "calls": eng.prefill_calls + eng.decode_calls,
                "params": leaf_shapes(eng.params),
                "pools": leaf_shapes(eng.cache.pools),
                "arena": leaf_shapes(eng.arena.state),
                "state_bytes": eng.arena.state_bytes(),
                "preemptions": sum(e["kind"] == "preempt" for e in events),
                "resumed": sum(e["kind"] == "admit" and e["resumed"]
                               for e in events),
                "drained": eng.cache.n_free_or_cached()
                == eng.cache.allocator.n_pages
                and all(r is None for r in eng.lanes),
            }
        res["refusals"] = recurrent_refusals(cases["refused"])
        dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, traceback.format_exc()))


# ----------------------------------------------------------------------------
# tests/test_torch_tp_gateway.py: rank 0 leads, the gateway at tp = 2
# ----------------------------------------------------------------------------
class Clock:
    """A settable clock: `t` plus a fixed offset."""

    def __init__(self, offset=0.0):
        self.t, self.offset = 0.0, offset

    def __call__(self):
        return self.t + self.offset


def replica_engines(case, n, timeout_s=None, clock=None, driven=True):
    """`n` engines of `case` at tp = 2, each on its own pair of groups,
    every one after the first over the first one's shard; `driven=False`:
    the ticks on the step's group, bounded as the offline launcher's."""
    from repro_torch.dist import replica_groups
    model = DecoderLM(port_config(case["arch"]))
    params = from_numpy_tree(case["params"])
    kw = {} if clock is None else {"clock": clock}
    out = []
    for _ in range(n):
        group, tick_group = (replica_groups(2) if timeout_s is None
                             else replica_groups(2, timeout_s))
        out.append(PagedServeEngine(
            model, out[0].params if out else params,
            ServeConfig(**case["serve"], tp=2), device="cpu",
            group=group, tick_group=tick_group if driven else None, **kw))
    return out


def leaf_storage(eng):
    """(path, [(data_ptr, shape)] of the leaf's tensors) of every leaf of
    `eng`'s params: a QTensor's data and scales, a float leaf itself."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + "/" + k)
        else:
            ts = [t.data, t.scales] if isinstance(t, QTensor) else [t]
            out.append((path, [(x.data_ptr(), list(x.shape)) for x in ts]))
    walk(eng.params, "")
    return out


def engine_state(eng):
    """What must agree across ranks: engine ids, lanes, the queue in
    heap order, block tables, pages in use."""
    alloc = eng.cache.allocator
    return {"next_eid": eng._next_eid,
            "lanes": [r.eid if r is not None else None for r in eng.lanes],
            "queue": [item[3].eid for item in eng.scheduler._heap],
            "tables": {str(e): list(s.pages)
                       for e, s in sorted(eng.cache.seqs.items())},
            "free": alloc.n_free, "n_pages": alloc.n_pages,
            "free_or_cached": eng.cache.n_free_or_cached(),
            "steps": eng.telemetry.steps, "ticks": eng.lockstep.seq,
            "calls": eng.prefill_calls + eng.decode_calls}


def after_steps(eng, fn, method="step_at"):
    """Call `fn(eng)` after each of `eng`'s steps (rank 0's `step`, a
    follower's `step_at`)."""
    orig = getattr(eng, method)

    def step(*args):
        orig(*args)
        fn(eng)
    setattr(eng, method, step)


def follow_threads(engines):
    """Follow each engine on a thread (`follow_all`); returns a function
    that joins them and gives each one's outcome ("stop" or the
    error's text)."""
    from repro_torch.dist import follow_all
    threads, outcomes = follow_all(engines)

    def join(timeout=120):
        for t in threads:
            t.join(timeout)
        return [o if o is None or o == "stop" else
                f"{type(o).__name__}: {o}" for o in outcomes]
    return join


async def sse_post(host, port, body):
    """POST /v1/completions: (status, {index: tokens})."""
    import asyncio
    import json

    from repro_torch.api.protocol import iter_sse
    reader, writer = await asyncio.open_connection(host, port)
    payload = json.dumps(body).encode()
    writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(payload)}\r\n\r\n").encode()
                 + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    toks = {}
    for e in iter_sse(rest):
        if "token" in e:
            toks.setdefault(e["index"], []).append(e["token"])
    return int(head.split()[1]), toks


async def http_get(host, port, path):
    import asyncio
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return int(raw.split(b"\r\n", 1)[0].split()[1]), \
        raw.partition(b"\r\n\r\n")[2]


def gateway_streams(rank, case):
    """The gateway at tp = 2 over the launcher's two replicas
    (`launch.serve.replica_engines`, one shard a rank), least-loaded:
    every prompt posted at once (`case["n"]` samples each); once every
    lane is taken, both replicas parked between steps while a third
    joins (`add_tp_replica`; rank 1 builds it in `follow_engines`) and
    every prompt is posted again (one sample each); then the replicas
    let go and the gateway stopped.  Returns the streams (rank 0), each
    engine's state and leaf storage, and the counts."""
    import asyncio
    import functools
    import threading
    from types import SimpleNamespace

    import repro_torch.launch.serve as launch
    from repro_torch.api import Gateway
    from repro_torch.dist import (FleetChannel, fleet_group,
                                  reset_tick_counts, tick_counts)
    from repro_torch.fleet import FleetRouter
    model = DecoderLM(port_config(case["arch"]))
    engines = launch.replica_engines(
        SimpleNamespace(tp=2, replicas=2), model,
        from_numpy_tree(case["params"]), ServeConfig(**case["serve"], tp=2),
        None, "cpu")
    channel = FleetChannel(fleet_group(2))
    build = functools.partial(launch.replica_engine, model,
                              engines[0].params, engines[0].config, None,
                              "cpu")
    reset_collective_counts()
    reset_tick_counts()
    out = {}
    if rank == 0:
        router = FleetRouter(engines, policy="least-loaded")
        gw = Gateway(router)

        def post(host, port, p, n):
            return sse_post(host, port, {"prompt": [int(t) for t in p],
                                         "max_tokens": case["new"], "n": n})

        async def run():
            loop = asyncio.get_running_loop()
            host, port = await gw.start("127.0.0.1", 0)
            try:
                first = [asyncio.ensure_future(post(host, port, p, n))
                         for p, n in zip(case["prompts"], case["n"])]
                full = (engines[0].max_batch, engines[0].max_batch)
                while True:
                    lanes = tuple([await asyncio.wrap_future(
                        rep.driver.call(lambda e: e.n_running))
                        for rep in router.replicas])
                    if lanes == full or all(f.done() for f in first):
                        break
                    await asyncio.sleep(0.002)
                out["lanes_at_add"] = list(lanes)
                gate = threading.Event()
                parked = [rep.driver.call(lambda e: gate.wait(60))
                          for rep in router.replicas]
                try:
                    rep = await loop.run_in_executor(
                        None, launch.add_tp_replica, router, channel, build)
                    out["added"] = [rep.id, rep.live, rep.driver.alive]
                    out["routed_to"] = router.route(case["prompts"][0],
                                                    1).id
                    again = [asyncio.ensure_future(post(host, port, p, 1))
                             for p in case["prompts"]]
                    while router.counters["dispatched"] < len(first) \
                            + len(again):
                        await asyncio.sleep(0.002)
                finally:
                    gate.set()
                for f in parked:
                    await asyncio.wrap_future(f)
                return (await asyncio.gather(*first),
                        await asyncio.gather(*again))
            finally:
                await gw.stop()
                channel.send(FleetChannel.STOP, len(router.replicas))
        res, res_again = asyncio.run(run())
        out["status"] = [s for s, _ in res + res_again]
        out["streams"] = [[t[i] for i in sorted(t)] for _, t in res]
        out["streams_again"] = [t.get(0) for _, t in res_again]
        out["driver_steps"] = [rep.driver.steps for rep in router.replicas]
        out["dispatches"] = [rep.dispatches for rep in router.replicas]
        out["pending"] = [rep.pending for rep in router.replicas]
        out["counters"] = dict(router.counters)
        try:
            router.add_replica(engines[0])
        except ValueError as e:
            out["add_again"] = str(e)
        engines = [rep.engine for rep in router.replicas]
    else:       # returns once every engine's STOP came, or raises
        engines, _ = launch.follow_engines(engines, channel, build)
        out["followed"] = len(engines)
    out["states"] = [engine_state(e) for e in engines]
    out["storage"] = [leaf_storage(e) for e in engines]
    out["collectives"] = collective_counts()
    out["ticks"] = tick_counts()
    return out


def deadline_run(rank, case, driven):
    """`case["plan"]`'s requests ((priority, deadline, new tokens, the
    step before which it is submitted)) at tp = 2 under a settable clock
    the test advances by 1.0 after every step; rank 1's clock is rank
    0's plus 1e6.  Replicated: both ranks call submit and step.  Driven:
    rank 0's EngineDriver steps (the later submits from its thread,
    between steps), rank 1 follows.  Returns each request's (eid,
    rejected, truncated, reason, tokens), the preemptions, the state."""
    import time

    from repro_torch.api.driver import EngineDriver
    clock = Clock(1e6 if rank else 0.0)
    eng, = replica_engines(case, 1, clock=clock, driven=driven)
    reqs = [ServeRequest(prompt=p.copy(), max_new_tokens=n, rid=i,
                         priority=pr, deadline_s=dl)
            for i, (p, (pr, dl, n, _)) in enumerate(zip(case["prompts"],
                                                        case["plan"]))]
    last = max(at for *_, at in case["plan"])

    def submit_at(k):
        for r, (*_, at) in zip(reqs, case["plan"]):
            if at == k:
                eng.submit(r)
    followed = None
    if not driven:
        k = 0
        while True:
            submit_at(k)
            if not eng.busy and k > last:
                break
            if eng.busy:
                eng.step()
            clock.t += 1.0
            k += 1
    elif rank == 0:
        steps = [0]

        def advance(eng):    # on the driver thread, between steps
            clock.t += 1.0
            steps[0] += 1
            submit_at(steps[0])
        after_steps(eng, advance, "step")
        drv = EngineDriver(eng)
        drv.submit([r for r, (*_, at) in zip(reqs, case["plan"])
                    if at == 0], lambda r: None)
        drv.start()
        t0 = time.monotonic()
        while not all(r.done for r in reqs) and time.monotonic() - t0 < 120:
            time.sleep(0.01)
        drv.stop()
    else:       # the requests this rank rebuilt, as each step left them
        seen = {}
        after_steps(eng, lambda e: seen.update(e._followed))
        followed = follow_threads([eng])()
        reqs = [seen[e] for e in sorted(seen)]
    events = eng.recorder.snapshot()
    return {"requests": [(r.eid, r.rejected, r.truncated, r.reject_reason,
                          list(r.out_tokens)) for r in reqs],
            "preemptions": sum(e["kind"] == "preempt" for e in events),
            "state": engine_state(eng), "followers": followed}


def mixed_run(rank, case):
    """Two replicas at tp = 2 behind a FleetRouter: A and B decode on
    replica 0, C-F queue behind them; C is cancelled while queued, the
    drain of replica 0 re-homes D-F onto replica 1, A is cancelled
    mid-decode.  Each engine's state after every step, on both ranks."""
    import asyncio

    from repro_torch.fleet import FleetRouter
    engines = replica_engines(case, 2)
    trail = [[] for _ in engines]

    def snap(eng):
        trail[engines.index(eng)].append(engine_state(eng))
    out = {}
    for eng in engines:
        after_steps(eng, snap, "step" if rank == 0 else "step_at")
    if rank == 0:
        router = FleetRouter(engines, policy="rr")
        reqs = [ServeRequest(prompt=p.copy(), max_new_tokens=n, rid=i)
                for i, (p, n) in enumerate(zip(case["prompts"],
                                               case["new"]))]
        done = []

        async def run():
            loop = asyncio.get_running_loop()
            finished = asyncio.Event()

            def on_done(r):
                done.append(r.rid)
                if len(done) == len(reqs):
                    loop.call_soon_threadsafe(finished.set)
            rep0 = router.replicas[0]
            await asyncio.wrap_future(router.dispatch(rep0, reqs[:2],
                                                      on_done))
            while len(reqs[0].out_tokens) < 2:
                await asyncio.sleep(0.005)
            await asyncio.wrap_future(router.dispatch(rep0, reqs[2:],
                                                      on_done))
            out["cancel_queued"] = await router.cancel([reqs[2]])
            out["requeued"] = await router.drain(0)
            out["cancel_running"] = await router.cancel([reqs[0]])
            await asyncio.wait_for(finished.wait(), 120)
        router.start()
        try:
            asyncio.run(run())
        finally:
            router.stop()
        out["requests"] = [(r.rid, r.cancelled, list(r.out_tokens))
                           for r in reqs]
    else:
        out["followers"] = follow_threads(engines)()
    out["trail"] = trail
    out["states"] = [engine_state(e) for e in engines]
    return out


def dead_follower(rank, case, timeout_s):
    """Two replicas at tp = 2 on groups whose collectives time out after
    `timeout_s`; rank 1's follower of replica 0 raises at its second
    step.  Rank 0: the status of the post routed there, then seconds
    until /healthz answers 503, and /healthz's and a new post's status."""
    import asyncio
    import time

    from repro_torch.api import Gateway
    from repro_torch.fleet import FleetRouter
    engines = replica_engines(case, 2, timeout_s=timeout_s)
    out = {}
    if rank == 0:
        gw = Gateway(FleetRouter(engines, policy="rr"))

        async def run():
            host, port = await gw.start("127.0.0.1", 0)
            try:
                body = {"prompt": [int(t) for t in case["prompts"][0]],
                        "max_tokens": 8}
                t0 = time.monotonic()
                first = await sse_post(host, port, body)
                while (await http_get(host, port, "/healthz"))[0] != 503:
                    if time.monotonic() - t0 > timeout_s + 60:
                        break
                    await asyncio.sleep(0.05)
                out["seconds_to_503"] = time.monotonic() - t0
                out["first"] = [first[0], first[1]]
                out["healthz"] = (await http_get(host, port, "/healthz"))[0]
                out["post"] = (await sse_post(host, port, body))[0]
                out["errors"] = [repr(rep.error) for rep in
                                 gw.router.replicas]
            finally:
                await gw.stop()
        asyncio.run(run())
    else:
        calls = [0]
        orig = engines[0].step_at

        def step_at(now):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("follower step failed (injected)")
            orig(now)
        engines[0].step_at = step_at
        out["followers"] = follow_threads(engines)()
    return out


def failed_build(rank, case, timeout_s):
    """Two replicas at tp = 2 (their collectives timing out after
    `timeout_s`); rank 0 adds a third while it serves, and rank 1's
    build of it raises once its groups are made, so `follow_engines`
    raises there and the rank ends as the launcher's does (its process
    group destroyed).  Rank 0: the added id, seconds until /healthz
    answers 503 (posting until it does), /healthz's and a new post's
    status.  Last: it ends rank 1's groups."""
    import asyncio
    import functools
    import time

    import repro_torch.launch.serve as launch
    from repro_torch.api import Gateway
    from repro_torch.dist import FleetChannel, fleet_group, replica_groups
    from repro_torch.fleet import FleetRouter
    engines = replica_engines(case, 2, timeout_s=timeout_s)
    channel = FleetChannel(fleet_group(2))
    out = {}
    if rank == 0:
        router = FleetRouter(engines, policy="least-loaded")
        gw = Gateway(router)
        build = functools.partial(launch.replica_engine, engines[0].model,
                                  engines[0].params, engines[0].config,
                                  None, "cpu")

        async def run():
            host, port = await gw.start("127.0.0.1", 0)
            try:
                rep = await asyncio.get_running_loop().run_in_executor(
                    None, launch.add_tp_replica, router, channel, build)
                out["added"] = rep.id
                body = {"prompt": [int(t) for t in case["prompts"][0]],
                        "max_tokens": 8}
                t0 = time.monotonic()
                while (await http_get(host, port, "/healthz"))[0] != 503:
                    if time.monotonic() - t0 > timeout_s + 60:
                        break
                    await sse_post(host, port, body)
                out["seconds_to_503"] = time.monotonic() - t0
                out["healthz"] = (await http_get(host, port, "/healthz"))[0]
                out["post"] = (await sse_post(host, port, body))[0]
            finally:
                await gw.stop()
                channel.send(FleetChannel.STOP, len(router.replicas))
        asyncio.run(run())
    else:
        def build():
            replica_groups(2)           # where rank 0 makes them
            raise RuntimeError("replica build failed (injected)")
        try:
            launch.follow_engines(engines, channel, build)
        except RuntimeError as e:
            out["error"] = f"{type(e).__name__}: {e}"
        finally:               # the launcher's rank ends here
            dist.destroy_process_group()
    return out


def gateway_rank_main(rank, init, payload, queue):
    """One rank of tests/test_torch_tp_gateway.py's group: the gateway's
    streams (fp, int4), the deadline runs (replicated, driven), the mixed
    run, then the dead follower (it leaves replica 0's group broken) and
    the failed build (last: it ends rank 1's groups)."""
    import datetime
    import os

    from repro_torch.dist.shard import GROUP_TIMEOUT_S
    torch.set_num_threads(1)
    # the dead follower's replica dumps its flight recorder there
    os.environ["REPRO_FLIGHT_DIR"] = payload["flight_dir"]
    try:
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=2,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        res = {name: gateway_streams(rank, payload[name])
               for name in ("fp", "int4")}
        res["deadline_replicated"] = deadline_run(rank, payload["deadline"],
                                                  driven=False)
        res["deadline_driven"] = deadline_run(rank, payload["deadline"],
                                              driven=True)
        res["mixed"] = mixed_run(rank, payload["mixed"])
        res["dead"] = dead_follower(rank, payload["fp"],
                                    payload["dead_timeout_s"])
        res["failed_build"] = failed_build(rank, payload["fp"],
                                           payload["dead_timeout_s"])
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
