"""Rank 0 leads the tensor-parallel group (`repro_torch.dist.lockstep`):
the port's gateway at tp = 2 and request deadlines there, against the
JAX package's tp = 2 engine and the port's tp = 1 gateway, on the CPU.

One spawn of a 2-rank gloo group (`init_method="file://..."` under the
test's tmp dir; `torch_tp_ranks.gateway_rank_main`) runs every case
while this process computes the references and runs a real launcher
(`python -m repro_torch.launch.serve --gateway --tp 2 --replicas 2`).
The dense smoke config, its weights drawn with numpy from a seed (the
int4 case's packed once for both packages, `test_torch_dist.packed`).
Held:

  * greedy SSE streams through the port's gateway at tp = 2 over the
    launcher's two replicas (`launch.serve.replica_engines`, each on its
    own groups), n = 1 and n = 2 forks, in fp and int4, equal to JAX's
    tp = 2 engine's and to the port's tp = 1 gateway's; both ranks end
    with the same engine ids, lanes and pages;
  * a third replica added at tp = 2 while every lane is taken
    (`launch.serve.add_tp_replica`, JAX's add-under-load test at tp =
    2): its id, least-loaded routing to it, the prompts posted again
    answered with JAX's streams, nothing lost, every admission slot and
    page back, both ranks agreeing on all three replicas;
  * one shard a rank: every leaf of every replica is replica 0's tensor
    (data_ptr) at the rank's shapes; `rank_params` keeps such a tree,
    shards a full one and refuses any other (no spawn, every family);
  * ticks: one a step call on each engine and one STOP each, the
    followers receiving what rank 0 sent, at most two broadcasts a tick;
    the step's collectives still 2 L + 2 a call on both ranks;
  * deadlines and priorities under a settable clock advanced by 1.0
    after every step, rank 1's offset by 1e6 (never read for a
    decision): rejections, reasons and streams equal to JAX's tp = 2
    engine's, a preempted request truncated on its first stamp; with
    every rank calling submit / step, and with rank 0's EngineDriver
    stepping while rank 1 follows;
  * the ranks' states agree after every step of a mixed run (a cancel
    while queued, a drain re-homing queued requests onto the other
    replica, a cancel mid-decode), and every page comes back;
  * a follower whose step raises, or whose build of an added replica
    raises, turns /healthz and /v1/completions to 503 on rank 0 within
    the group's timeout;
  * the launcher: two posts answered with JAX's tp = 2 streams,
    /metrics showing two replicas, SIGINT ending every rank with
    `[api] gateway stopped`.
"""
import asyncio
import functools
import json
import os
import signal
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import get_smoke_config as jax_smoke
from repro.models import DecoderLM as JaxLM
from repro.models import ModelConfig as JaxConfig
from repro.quant.qarray import QTensor as JaxQTensor
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxRequest

import repro_torch.launch.serve as port_launch
from repro_torch.api import Gateway
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.dist import rank_params, recurrent_splits, shard_tree
from repro_torch.fleet import FleetRouter
from repro_torch.models import DecoderLM, init_params
from repro_torch.quant.ptq import quantize_leaf
from repro_torch.quant.qarray import QTensor
from repro_torch.serve import PagedServeEngine, ServeConfig

import torch_tp_ranks
from test_torch_dist import host_weights, packed
from test_torch_model import SMOKE

GEOM = dict(max_batch=2, max_seq=48, page_size=4, prefill_chunk=8)
N_SAMPLES = [1, 2, 1, 2, 1]
PROMPT_LENGTHS = (3, 9, 17, 6, 12)
NEW = 9
# the deadline runs: (priority, deadline_s, new tokens, the step before
# which it is submitted); a pool of 9 pages preempts request 0, which
# then expires on its first stamp (truncated)
DEADLINE_GEOM = dict(max_batch=3, max_seq=32, page_size=4, n_pages=9,
                     prefill_chunk=8, prefix_cache=False)
DEADLINE_PLAN = [(0, 6.5, 10, 0), (0, 12.5, 10, 0), (0, None, 10, 0),
                 (1, 3.5, 6, 0), (0, None, 5, 0), (0, 1.5, 4, 3),
                 (1, None, 6, 3), (0, 2.5, 5, 3)]
MIXED_NEW = [24, 24, 6, 6, 6, 6]
DEAD_TIMEOUT_S = 3.0
LAUNCH = ["--smoke", "--device", "cpu", "--max-seq", "32", "--page-size",
          "8", "--port", "0"]
LAUNCH_PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9]]


def _prompts(seed, lengths, vocab=SMOKE["vocab"]):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in lengths]


def _jax_engine(arch, weights, serve_kw, clock=None):
    jm = JaxLM(JaxConfig(**dict(arch, dtype="float32", remat=False)))
    kw = {} if clock is None else {"clock": clock}
    return JaxEngine(jm, weights, JaxServeConfig(**serve_kw, tp=2), **kw)


def _jax_streams(arch, weights, serve_kw, prompts, n_samples, new):
    """JAX's tp = 2 engine, each prompt's samples forked off its first."""
    eng = _jax_engine(arch, weights, serve_kw)
    groups = []
    for i, (p, n) in enumerate(zip(prompts, n_samples)):
        first = JaxRequest(prompt=p.copy(), max_new_tokens=new, rid=i)
        groups.append([first] + [
            JaxRequest(prompt=p.copy(), max_new_tokens=new, rid=i,
                       fork_from=first) for _ in range(n - 1)])
    eng.run([r for g in groups for r in g])
    return [[r.out_tokens for r in g] for g in groups]


def _jax_deadlines(weights, prompts):
    """JAX's tp = 2 engine on the deadline plan, as `deadline_run` drives
    the port's."""
    clock = torch_tp_ranks.Clock()
    eng = _jax_engine(SMOKE, weights, DEADLINE_GEOM, clock)
    reqs = [JaxRequest(prompt=p.copy(), max_new_tokens=n, rid=i,
                       priority=pr, deadline_s=dl)
            for i, (p, (pr, dl, n, _)) in enumerate(zip(prompts,
                                                        DEADLINE_PLAN))]
    last, k = max(at for *_, at in DEADLINE_PLAN), 0
    while True:
        for r, (*_, at) in zip(reqs, DEADLINE_PLAN):
            if at == k:
                eng.submit(r)
        if not eng.busy and k > last:
            break
        if eng.busy:
            eng.step()
        clock.t += 1.0
        k += 1
    return ([(r.eid, r.rejected, r.truncated, r.reject_reason,
              list(r.out_tokens)) for r in reqs],
            sum(e["kind"] == "preempt" for e in eng.recorder.snapshot()))


def _port_tp1_gateway(params, serve_kw, prompts):
    """The port's tp = 1 gateway over two replicas, the same posts."""
    model = DecoderLM(torch_tp_ranks.port_config(SMOKE))
    engines = [PagedServeEngine(model, from_numpy_tree(params),
                                ServeConfig(**serve_kw), device="cpu")
               for _ in range(2)]
    gw = Gateway(FleetRouter(engines, policy="rr"))

    async def run():
        host, port = await gw.start("127.0.0.1", 0)
        try:
            return await asyncio.gather(*[
                torch_tp_ranks.sse_post(host, port, {
                    "prompt": [int(t) for t in p], "max_tokens": NEW,
                    "n": n}) for p, n in zip(prompts, N_SAMPLES)])
        finally:
            await gw.stop()
    return [[t[i] for i in sorted(t)] for _, t in asyncio.run(run())]


def _launcher_reference():
    """JAX's tp = 2 streams of the launcher's two posts: the launcher's
    smoke weights (`build_model`, seed 0, INT4 in groups of 16) carried
    into JAX QTensors, its ServeConfig."""
    cfg = get_smoke_config("qwen2.5-3b").replace(dtype="float32",
                                                 remat=False)
    _, params = port_launch.build_model(cfg, "int4", 16, "cpu", 0)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, QTensor):
            return JaxQTensor(jnp.asarray(t.data.numpy()),
                              jnp.asarray(t.scales.numpy()), t.bits,
                              t.group, t.axis, tuple(t.orig_shape))
        return jnp.asarray(t.numpy())
    jcfg = jax_smoke("qwen2.5-3b").replace(dtype="float32", remat=False)
    eng = JaxEngine(JaxLM(jcfg), walk(params), JaxServeConfig(
        precision="int4", kv_dtype="auto", quant_group=16, max_batch=4,
        max_seq=32, page_size=8, prefix_cache=True, seed=0, tp=2))
    reqs = [JaxRequest(prompt=np.asarray(p, np.int32), max_new_tokens=16,
                       rid=i) for i, p in enumerate(LAUNCH_PROMPTS)]
    eng.run(reqs)
    return [r.out_tokens for r in reqs]


def _drive_launcher(proc):
    """Two posts and /metrics against the launcher's gateway, then
    SIGINT: (statuses, streams, metrics, stdout, stderr, exit code)."""
    try:
        for line in proc.stdout:
            if line.startswith("[api] gateway listening on http://"):
                break
        else:
            pytest.fail(f"no gateway line: {proc.stderr.read()}")
        host, port = line.split("http://")[1].split()[0].rsplit(":", 1)

        async def run():
            res = await asyncio.gather(*[
                torch_tp_ranks.sse_post(host, int(port), {
                    "prompt": p, "max_tokens": 16})
                for p in LAUNCH_PROMPTS])
            st, raw = await torch_tp_ranks.http_get(host, int(port),
                                                    "/metrics")
            return res, json.loads(raw)
        res, metrics = asyncio.run(run())
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    return ([s for s, _ in res], [t.get(0) for _, t in res], metrics, out,
            err, proc.returncode)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Everything, computed once: the ranks' results, JAX's tp = 2 and
    the port's tp = 1 references, the launcher's run."""
    host = host_weights(SMOKE)
    fp = (jax.tree_util.tree_map(jnp.asarray, host), host)
    int4 = packed(host, 16)
    prompts = _prompts(1, PROMPT_LENGTHS)
    dl_prompts = _prompts(3, (3, 9, 6, 7, 6, 4, 8, 5))
    mixed_prompts = _prompts(5, (5, 7, 4, 6, 3, 8))
    cases = {"fp": dict(GEOM), "int4": dict(GEOM, precision="int4",
                                            quant_group=16)}
    weights = {"fp": fp, "int4": int4}
    payload = {name: dict(arch=SMOKE, params=weights[name][1], serve=kw,
                          prompts=prompts, n=N_SAMPLES, new=NEW)
               for name, kw in cases.items()}
    payload["deadline"] = dict(arch=SMOKE, params=host,
                               serve=DEADLINE_GEOM, prompts=dl_prompts,
                               plan=DEADLINE_PLAN)
    payload["mixed"] = dict(arch=SMOKE, params=host, serve=dict(GEOM),
                            prompts=mixed_prompts, new=MIXED_NEW)
    payload["dead_timeout_s"] = DEAD_TIMEOUT_S
    payload["flight_dir"] = str(tmp_path_factory.mktemp("flight"))

    env = dict(os.environ, PYTHONUNBUFFERED="1")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--gateway",
         "--tp", "2", "--replicas", "2", *LAUNCH], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = "file://" + str(tmp_path_factory.mktemp("tp_gw") / "store")
    procs = [ctx.Process(target=torch_tp_ranks.gateway_rank_main,
                         args=(r, init, payload, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        ref = {name: _jax_streams(SMOKE, weights[name][0], kw, prompts,
                                  N_SAMPLES, NEW)
               for name, kw in cases.items()}
        tp1 = {name: _port_tp1_gateway(weights[name][1], kw, prompts)
               for name, kw in cases.items()}
        deadlines = _jax_deadlines(fp[0], dl_prompts)
        mixed_ref, _ = torch_tp_ranks.serve(SMOKE, host, dict(GEOM),
                                            mixed_prompts, max(MIXED_NEW))
        launch_ref = _launcher_reference()
        launch = _drive_launcher(launcher)
        ranks = dict(queue.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
        if launcher.poll() is None:
            launcher.kill()
    for r, res in ranks.items():
        assert isinstance(res, dict), f"rank {r} failed:\n{res}"
    return dict(ranks=ranks, jax=ref, tp1=tp1, deadlines=deadlines,
                mixed_ref=mixed_ref, launch=launch, launch_ref=launch_ref,
                weights={name: w[1] for name, w in weights.items()})


# ----------------------------------------------------------------------------
# the gateway's streams, the ranks' states, the counts
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["fp", "int4"])
def test_gateway_tp2_streams_equal_jax_tp2_and_port_tp1(served, name):
    r0, r1 = served["ranks"][0][name], served["ranks"][1][name]
    assert r0["status"] == [200] * (len(N_SAMPLES) + len(PROMPT_LENGTHS))
    assert r0["streams"] == served["jax"][name]
    assert r0["streams"] == served["tp1"][name]
    assert [len(s) for s in r0["streams"]] == N_SAMPLES
    assert all(len(t) == NEW for s in r0["streams"] for t in s)
    assert r0["states"] == r1["states"], "the ranks left lockstep"
    for st in r0["states"]:
        assert st["lanes"] == [None, None] and st["queue"] == []
        assert st["free_or_cached"] == st["n_pages"]
    assert sum(st["next_eid"] for st in r0["states"]) == \
        sum(N_SAMPLES) + len(PROMPT_LENGTHS)
    assert r1["followed"] == 3


@pytest.mark.parametrize("name", ["fp", "int4"])
def test_ticks_one_a_step_call_and_collectives_unchanged(served, name):
    """Each engine: one tick a step call and its STOP tick, rank 1
    receiving every one; a tick is one broadcast, two with ops.  The
    step's collectives stay 2 L + 2 a call on both ranks."""
    r0, r1 = served["ranks"][0][name], served["ranks"][1][name]
    L = SMOKE["n_layers"]
    steps = r0["driver_steps"]
    assert [st["steps"] for st in r0["states"]] == steps
    assert [st["ticks"] for st in r0["states"]] == [s + 1 for s in steps]
    assert r0["ticks"]["ticks"] == r1["ticks"]["ticks"] == \
        sum(steps) + len(steps)
    assert r0["ticks"] == r1["ticks"]
    assert r0["ticks"]["ticks"] < r0["ticks"]["broadcasts"] \
        <= 2 * r0["ticks"]["ticks"]
    for res in (r0, r1):
        calls = sum(st["calls"] for st in res["states"])
        assert res["collectives"] == {"all_reduce": (2 * L + 1) * calls,
                                      "all_gather": calls}


# ----------------------------------------------------------------------------
# a replica added under load; one shard a rank
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["fp", "int4"])
def test_add_replica_at_tp2_under_load_loses_nothing(served, name):
    """JAX's `test_fleet_add_replica_under_load_zero_loss` at tp = 2:
    the replica joins while every lane of the other two is taken (both
    parked between steps until every post is routed), takes id 2, is
    live at once and is least-loaded's pick; every request, those in
    flight and those posted again, answers with JAX's tp = 2 stream."""
    r0 = served["ranks"][0][name]
    want = served["jax"][name]
    assert r0["lanes_at_add"] == [GEOM["max_batch"]] * 2
    assert r0["added"] == [2, True, True]
    assert r0["routed_to"] == 2
    assert r0["dispatches"][2] >= 1, "the added replica must absorb load"
    assert sum(r0["dispatches"]) == len(N_SAMPLES) + len(PROMPT_LENGTHS)
    assert r0["counters"]["adds"] == 1
    assert r0["counters"]["requeue_failed"] == 0
    assert r0["pending"] == [0, 0, 0], "admission ledger must return to 0"
    assert r0["streams"] == want
    assert r0["streams_again"] == [g[0] for g in want]
    assert r0["add_again"].startswith(
        "add_replica at tp=2 takes rank 0's engine on a pair of groups of "
        "its own")


@pytest.mark.parametrize("name", ["fp", "int4"])
def test_ranks_agree_on_every_replica_after_an_add(served, name):
    """Both ranks' states agree on all three replicas; the added one
    stepped, its ticks one a step call and its STOP; every page back."""
    r0, r1 = served["ranks"][0][name], served["ranks"][1][name]
    assert len(r0["states"]) == len(r1["states"]) == 3
    assert r0["states"] == r1["states"], "the ranks left lockstep"
    added = r0["states"][2]
    assert added["steps"] == r0["driver_steps"][2] >= 1
    assert added["ticks"] == added["steps"] + 1
    assert added["next_eid"] == r0["dispatches"][2]
    for st in r0["states"]:
        assert st["free_or_cached"] == st["n_pages"]
    L = SMOKE["n_layers"]
    for res in (r0, r1):
        calls = sum(st["calls"] for st in res["states"])
        assert res["collectives"]["all_reduce"] == (2 * L + 1) * calls


@pytest.mark.parametrize("name", ["fp", "int4"])
def test_replicas_share_the_rank_shard(served, name):
    """Every leaf of every replica, the added one too, is replica 0's
    tensor on each rank (its data_ptr), at the rank's shapes: those of
    `shard_tree` of the full weights."""
    model = DecoderLM(torch_tp_ranks.port_config(SMOKE))
    params = from_numpy_tree(served["weights"][name])
    for rank in (0, 1):
        storage = served["ranks"][rank][name]["storage"]
        assert len(storage) == 3
        for other in storage[1:]:
            assert other == storage[0]
        eng = SimpleNamespace(params=shard_tree(params, model.param_specs(),
                                                rank, 2))
        want = torch_tp_ranks.leaf_storage(eng)
        assert [(p, [s for _, s in ts]) for p, ts in storage[0]] == \
            [(p, [s for _, s in ts]) for p, ts in want]
        assert any(s != f for (_, ts), (_, fs) in zip(
            storage[0], torch_tp_ranks.leaf_storage(
                SimpleNamespace(params=params)))
            for (_, s), (_, f) in zip(ts, fs)), "no leaf is sharded"


RANK_PARAMS_ARCHS = ["qwen2.5-3b", "qwen3-moe-235b-a22b",
                     "deepseek-v2-lite-16b", "xlstm-1.3b", "zamba2-7b"]


@pytest.mark.parametrize("precision", ["fp", "int4"])
@pytest.mark.parametrize("arch", RANK_PARAMS_ARCHS)
def test_rank_params_keeps_a_shard_and_refuses_a_mixed_tree(arch,
                                                            precision):
    """`rank_params` at tp = 2 on every family's smoke config (the GQA,
    MoE / MLA and recurrent split tables): a full tree comes back as
    `shard_tree`'s copy; that copy comes back as the very tree; a tree
    with one leaf full and the rest the rank's, or with a leaf of
    neither shape, raises."""
    import warnings
    cfg = get_smoke_config(arch).replace(dtype="float32", remat=False)
    model = DecoderLM(cfg)
    specs = model.param_specs()
    leaf_fn = None if precision == "fp" else functools.partial(
        quantize_leaf, bits=4, group=16)
    with warnings.catch_warnings():     # xlstm's K = 85 leaf stays float
        warnings.simplefilter("ignore", UserWarning)
        full = init_params(specs, torch.Generator().manual_seed(0), "cpu",
                           dtype_override=torch.float32, leaf_fn=leaf_fn)
    splits = recurrent_splits(cfg, 2)
    for rank in (0, 1):
        mine = rank_params(full, specs, rank, 2, splits=splits)
        want = shard_tree(full, specs, rank, 2, splits=splits)
        assert len(_tensors(mine)) == len(_tensors(want))
        assert all(p == q and torch.equal(a, b) for (p, a), (q, b) in
                   zip(_tensors(mine), _tensors(want)))
        assert rank_params(mine, specs, rank, 2, splits=splits) is mine
        mixed = dict(mine, embed=full["embed"])
        with pytest.raises(ValueError, match="neither the full tree nor"):
            rank_params(mixed, specs, rank, 2, splits=splits)
        odd = dict(full, embed=full["embed"][:-1])
        with pytest.raises(ValueError, match="neither the full tree nor"):
            rank_params(odd, specs, rank, 2, splits=splits)


def _tensors(tree, path=""):
    """(path, tensor) of every tensor of `tree`, a QTensor's data and
    scales apart, in path order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensors(tree[k],
                                                           f"{path}/{k}")]
    if isinstance(tree, QTensor):
        return [(path + ":data", tree.data), (path + ":scales", tree.scales)]
    return [(path, tree)]


# ----------------------------------------------------------------------------
# deadlines on rank 0's clock
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["replicated", "driven"])
def test_deadlines_at_tp2_are_decided_as_jax_tp2_decides(served, mode):
    want, want_pre = served["deadlines"]
    r0 = served["ranks"][0][f"deadline_{mode}"]
    r1 = served["ranks"][1][f"deadline_{mode}"]
    assert r0["requests"] == want
    assert r1["requests"] == want
    assert r0["preemptions"] == r1["preemptions"] == want_pre == 1
    reasons = {(rej, trunc, why) for _, rej, trunc, why, _ in want}
    assert reasons == {(False, False, ""), (True, False, "expired"),
                       (False, True, "expired")}
    assert r0["state"] == r1["state"]
    assert r0["state"]["free_or_cached"] == r0["state"]["n_pages"]
    if mode == "driven":
        assert r1["followers"] == ["stop"]
        assert r0["state"]["ticks"] == r0["state"]["steps"] + 1


# ----------------------------------------------------------------------------
# cancels and a drain: the ranks agree after every step
# ----------------------------------------------------------------------------
def test_ranks_agree_after_cancels_and_a_drain(served):
    r0, r1 = served["ranks"][0]["mixed"], served["ranks"][1]["mixed"]
    assert r1["followers"] == ["stop", "stop"]
    assert r0["cancel_queued"] == 1 and r0["cancel_running"] == 1
    assert r0["requeued"] == 3
    assert all(len(t) > 0 for t in r0["trail"])
    assert r0["trail"] == r1["trail"], "the ranks left lockstep"
    assert r0["states"] == r1["states"]
    for st in r0["states"]:         # JAX's page conservation
        assert st["free_or_cached"] == st["n_pages"]
        assert st["lanes"] == [None, None] and st["queue"] == []
    ref = served["mixed_ref"]
    for rid, cancelled, toks in r0["requests"]:
        want = ref[rid][:MIXED_NEW[rid]]
        if rid in (0, 2):
            assert cancelled and toks == want[:len(toks)]
            assert len(toks) < MIXED_NEW[rid]
        else:
            assert not cancelled and toks == want


# ----------------------------------------------------------------------------
# a dead follower
# ----------------------------------------------------------------------------
def test_a_dead_follower_turns_the_gateway_to_503(served):
    r0, r1 = served["ranks"][0]["dead"], served["ranks"][1]["dead"]
    assert r1["followers"][0] == \
        "RuntimeError: follower step failed (injected)"
    assert r1["followers"][1] == "stop"
    assert r0["healthz"] == 503 and r0["post"] == 503
    assert r0["seconds_to_503"] < DEAD_TIMEOUT_S + 30
    assert "RuntimeError" in r0["errors"][0] and r0["errors"][1] == "None"


def test_a_follower_that_fails_to_build_an_added_replica_ends_its_rank(
        served):
    """Rank 1's build of an added replica raises once its groups are
    made: `follow_engines` raises, the rank ends (its groups destroyed,
    as the launcher's), and rank 0's gateway answers 503."""
    r0 = served["ranks"][0]["failed_build"]
    r1 = served["ranks"][1]["failed_build"]
    assert r1["error"] == "RuntimeError: replica build failed (injected)"
    assert r0["added"] == 2
    assert r0["healthz"] == 503 and r0["post"] == 503
    assert r0["seconds_to_503"] < DEAD_TIMEOUT_S + 30


# ----------------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------------
def test_launcher_gateway_tp2_replicas2_answers_with_jax_tp2_streams(
        served):
    statuses, streams, metrics, out, err, rc = served["launch"]
    assert rc == 0, err
    assert statuses == [200, 200]
    assert streams == served["launch_ref"]
    assert metrics["fleet"]["n_replicas"] == 2
    assert metrics["config"]["replicas"] == 2 and metrics["config"]["tp"] == 2
    assert metrics["engine"]["requests"] == 2.0
    assert "[api] gateway stopped" in out, err
