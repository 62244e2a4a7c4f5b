"""Tensor-parallel serving in the PyTorch port (`ServeConfig(tp=2)`,
`--tp 2`) against the JAX package's tp = 2 engine and the port's tp = 1,
on the CPU.

One spawn of a 2-rank gloo group (`init_method="file://..."` under the
test's tmp dir, so xdist workers never share a port; one thread a rank;
tests/torch_tp_ranks.py) serves every case while this process computes
the references: JAX's `PagedServeEngine` at tp = 2 on its forced
2-device host mesh (tests/conftest.py) and the port at tp = 1, from the
same weights (drawn with numpy from a seed; the int4 cases' packed
once for both packages, `test_torch_dist.packed`) and prompts.  Held:

  * greedy streams: the dense smoke config in fp and int4, n-gram
    speculation, the gemma3-4b smoke config (its sliding window of 8
    keys), and a config whose packed `w_down` (3 groups of 8 rows) the
    sharding rule leaves whole on each rank, equal to JAX's tp = 2 and
    the port's tp = 1, and the same on both ranks (lockstep); with the
    launcher's draft model, whole on each rank, the fp streams again;
  * each rank holds its slices (pool heads, wq columns, w_down rows,
    vocab rows) and runs 2 L + 2 collectives a step call (L + 1
    all-reduces and L + 1 gathers where w_down is whole; none in a
    draft model's steps);
  * JAX's page-conservation property on the ranks' sharded int4 pools
    under random submits, aborts, forks and preemptions;
  * the `sim_*` keys of the int4 run equal JAX's tp = 2 engine's;
  * the refusals: dims tp does not divide, no group, a group of the
    wrong size; MoE, MLA, xlstm and zamba are admitted
    (tests/test_torch_tp_moe_mla.py and tests/test_torch_tp_recurrent.py
    serve them); requests with deadlines are admitted and decided as at
    tp = 1, on rank 0's clock (tests/test_torch_tp_gateway.py holds them
    to JAX's tp = 2 engine under a settable clock);
  * `python -m repro_torch.launch.serve --smoke --device cpu --tp 2`
    prints `--tp 1`'s streams, and `--gateway` is admitted with it.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.configs import get_smoke_config as jax_smoke
from repro.models import DecoderLM as JaxLM
from repro.models import ModelConfig as JaxConfig
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxRequest
from repro.spec import SpecConfig as JaxSpecConfig

import repro_torch.launch.serve as port_launch
from repro_torch.models import DecoderLM, ModelConfig
from repro_torch.serve import PagedServeEngine, ServeConfig

import torch_tp_ranks
from test_torch_dist import REPLICATED_LEAF, host_weights, packed
from test_torch_model import SMOKE

GEMMA3 = {f.name: getattr(jax_smoke("gemma3-4b"), f.name)
          for f in dataclasses.fields(jax_smoke("gemma3-4b"))}
GEOM = dict(max_batch=2, max_seq=48, page_size=4, prefill_chunk=8)
SPEC_PROMPTS = [np.array([1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3], np.int32),
                np.array([7, 9, 11], np.int32),
                np.arange(10, 30, dtype=np.int32) % 64]
LAUNCH = ["--smoke", "--device", "cpu", "--requests", "3", "--tokens", "6",
          "--max-seq", "32", "--page-size", "8"]


def _weights(arch, serve_kw):
    """(jax tree, numpy tree) of a case: float, or packed at the case's
    INT4 group."""
    host = host_weights(arch)
    if serve_kw.get("precision") == "int4":
        return packed(host, serve_kw["quant_group"])
    return jax.tree_util.tree_map(jnp.asarray, host), host


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in (3, 9, 17, 6, 12)]


def _cases():
    """name -> (arch, serve kwargs, prompts, new tokens, spec k,
    drafter)."""
    return {
        "fp": (SMOKE, dict(GEOM), _prompts(SMOKE["vocab"]), 9, 0),
        "draft_model": (SMOKE, dict(GEOM), _prompts(SMOKE["vocab"]), 9, 4,
                        "model"),
        "int4": (SMOKE, dict(GEOM, precision="int4", quant_group=16),
                 _prompts(SMOKE["vocab"]), 9, 0),
        "ngram": (SMOKE, dict(GEOM, max_seq=64, page_size=8),
                  SPEC_PROMPTS, 14, 4),
        "gemma3": (GEMMA3, dict(GEOM), _prompts(GEMMA3["vocab"]), 9, 0),
        "replicated_leaf": (REPLICATED_LEAF,
                            dict(GEOM, precision="int4", quant_group=8),
                            _prompts(REPLICATED_LEAF["vocab"]), 9, 0),
    }


def _jax_run(arch, weights, serve_kw, prompts, new, spec_k):
    jm = JaxLM(JaxConfig(**dict(arch, dtype="float32", remat=False)))
    eng = JaxEngine(jm, weights, JaxServeConfig(**serve_kw, tp=2),
                    spec=JaxSpecConfig(k=spec_k, drafter="ngram")
                    if spec_k else None)
    reqs = [JaxRequest(prompt=p.copy(), max_new_tokens=new, rid=i)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    return [r.out_tokens for r in reqs], eng.summary()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Everything, computed once: the ranks' results, JAX's tp = 2 and
    the port's tp = 1 streams, and the launcher's output at --tp 2."""
    cases = {k: (v + ("ngram",))[:6] for k, v in _cases().items()}
    weights = {name: _weights(arch, kw)
               for name, (arch, kw, *_rest) in cases.items()}
    payload = {
        "streams": {name: dict(arch=arch, params=weights[name][1],
                               serve=kw, prompts=prompts, new=new,
                               spec_k=k, drafter=dr)
                    for name, (arch, kw, prompts, new, k, dr)
                    in cases.items()},
        "conservation": dict(arch=SMOKE, params=weights["fp"][1]),
        "refused": {"tp3": dict(SMOKE, name="tp3", n_heads=3, n_kv_heads=3,
                                d_model=48, d_ff=96),
                    "families": [],
                    "admitted": ["qwen3-moe-235b-a22b",
                                 "deepseek-v2-lite-16b", "xlstm-1.3b",
                                 "zamba2-7b"]},
    }
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH,
         "--tp", "2"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = "file://" + str(tmp_path_factory.mktemp("tp_group") / "store")
    procs = [ctx.Process(target=torch_tp_ranks.rank_main,
                         args=(r, init, payload, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        # the references, while the ranks serve
        ref = {name: _jax_run(arch, weights[name][0], kw, prompts, new, k)
               for name, (arch, kw, prompts, new, k, dr) in cases.items()
               if dr == "ngram"}
        ref["draft_model"] = ref["fp"]      # speculation keeps the stream
        tp1 = {}
        for name, (arch, kw, prompts, new, k, dr) in cases.items():
            streams, eng = torch_tp_ranks.serve(
                arch, weights[name][1], kw, prompts, new, k, dr)
            tp1[name] = streams
            if name == "fp":
                tp1["deadline"] = torch_tp_ranks.deadline_decisions(
                    eng, prompts[0])
        _, launch_reqs = port_launch.main(LAUNCH + ["--tp", "1"])
        ranks = dict(queue.get(timeout=600) for _ in procs)
        out, err = launcher.communicate(timeout=600)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
        if launcher.poll() is None:
            launcher.kill()
    for r, res in ranks.items():
        assert isinstance(res, dict), f"rank {r} failed:\n{res}"
    return dict(ranks=ranks, jax=ref, tp1=tp1, launch=(launcher.returncode,
                out, err, [r.out_tokens for r in launch_reqs]))


# ----------------------------------------------------------------------------
# streams
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["fp", "int4", "ngram", "gemma3",
                                  "replicated_leaf", "draft_model"])
def test_tp2_streams_equal_jax_tp2_and_port_tp1(served, name):
    r0, r1 = served["ranks"][0][name], served["ranks"][1][name]
    assert r0["streams"] == r1["streams"], "the ranks left lockstep"
    assert r0["streams"] == served["tp1"][name]
    assert r0["streams"] == served["jax"][name][0]
    assert all(len(s) for s in r0["streams"]) and r0["drained"]
    if name in ("ngram", "draft_model"):
        assert r0["verify_calls"] > 0 and r0["summary"]["spec_drafted"] > 0


@pytest.mark.parametrize("name", ["int4", "replicated_leaf", "draft_model"])
def test_each_rank_holds_its_slices_and_counts_its_collectives(served,
                                                               name):
    """The draft model's steps run no collective: the counts are the
    target's step calls'."""
    arch = REPLICATED_LEAF if name == "replicated_leaf" else SMOKE
    L, hd = arch["n_layers"], arch["head_dim"]
    for r in (0, 1):
        res = served["ranks"][r][name]
        assert res["pool_heads"] == arch["n_kv_heads"] // 2
        assert res["wq_cols"] == arch["n_heads"] * hd // 2
        assert res["vocab_rows"] == arch["vocab"] // 2
        whole = name == "replicated_leaf"
        assert res["w_down_rows"] == (arch["d_ff"] if whole
                                      else arch["d_ff"] // 2)
        per_step = ({"all_reduce": L + 1, "all_gather": L + 1} if whole
                    else {"all_reduce": 2 * L + 1, "all_gather": 1})
        assert res["collectives"] == {k: v * res["calls"]
                                      for k, v in per_step.items()}
        assert res["summary"]["step_graphs"] == 0.0
        assert res["summary"]["tp"] == 2.0


def test_tp2_sim_keys_equal_jax_tp2(served):
    mine = served["ranks"][0]["int4"]["summary"]
    ref = served["jax"]["int4"][1]
    keys = sorted(k for k in ref if k.startswith("sim_"))
    assert keys == sorted(k for k in mine if k.startswith("sim_"))
    assert "sim_tp" in keys
    for k in keys:
        np.testing.assert_allclose(mine[k], ref[k], rtol=1e-12, err_msg=k)


# ----------------------------------------------------------------------------
# page conservation on the sharded pools
# ----------------------------------------------------------------------------
def test_tp2_page_conservation_random_interleavings(served):
    trials = [served["ranks"][r]["conservation"] for r in (0, 1)]
    assert trials[0] == trials[1], "the ranks left lockstep"
    for t in trials[0]:
        assert t["leaks"] == 0 and t["drained"], t
        assert t["pool_heads"] == SMOKE["n_kv_heads"] // 2
    assert sum(t["preemptions"] for t in trials[0]) > 0
    assert sum(t["forks"] for t in trials[0]) > 0


# ----------------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------------
def test_engine_refuses_non_dividing_dims_and_a_missing_group():
    model = DecoderLM(ModelConfig(**dict(SMOKE, n_heads=3, n_kv_heads=3,
                                         d_model=48, d_ff=96)))
    kw = dict(max_batch=2, max_seq=32, page_size=8)
    with pytest.raises(ValueError, match="does not divide"):
        PagedServeEngine(model, {}, ServeConfig(tp=2, **kw), device="cpu")
    with pytest.raises(ValueError, match="n_heads=3"):
        model.validate_tp(2)
    with pytest.raises(ValueError, match="group of 3 ranks but no torch"):
        PagedServeEngine(model, {}, ServeConfig(tp=3, **kw), device="cpu")


def test_engine_refuses_a_wrong_sized_group_and_families_outside_the_slice(
        served):
    got = served["ranks"][0]["refusals"]
    assert got == served["ranks"][1]["refusals"]
    # a deadline is admitted at tp = 2 and decided as at tp = 1: one
    # served, one expired before its admission
    deadline = served["ranks"][0]["deadline"]
    assert deadline == served["ranks"][1]["deadline"] == \
        served["tp1"]["deadline"]
    assert [d[:2] for d in deadline] == [(False, ""), (True, "expired")]
    assert len(deadline[0][2]) == 3 and deadline[1][2] == []
    assert "tp=3 needs a torch.distributed group of 3 ranks but the " \
        "torch.distributed group has 2 ranks" in got["tp3"]
    # no family is outside tensor-parallel serving since the recurrent
    # and hybrid families joined (tests/test_torch_tp_recurrent.py)
    assert set(got) == {"tp3", "qwen3-moe-235b-a22b",
                        "deepseek-v2-lite-16b", "xlstm-1.3b", "zamba2-7b"}
    for arch_id in ("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b",
                    "xlstm-1.3b", "zamba2-7b"):
        assert got[arch_id] == "admitted, tp 2"


# ----------------------------------------------------------------------------
# launcher
# ----------------------------------------------------------------------------
def test_launcher_tp2_on_cpu_prints_tp1_streams(served, monkeypatch):
    rc, out, err, tp1 = served["launch"]
    assert rc == 0, err
    assert "tp 2 (2 ranks over gloo, steps eager)" in out
    line = [ln for ln in out.splitlines() if ln.startswith("[serve] streams")]
    assert len(line) == 1, out                  # rank 0 prints, alone
    assert json.loads(line[0][len("[serve] streams "):]) == tp1
    # --gateway with --tp 2 is admitted: the launcher spawns its ranks
    # (tests/test_torch_tp_gateway.py serves through them)
    spawned = []
    monkeypatch.setattr(port_launch, "spawn_ranks", lambda args, precision:
                        spawned.append((args.tp, args.gateway, precision)))
    port_launch.main(LAUNCH + ["--tp", "2", "--gateway"])
    assert spawned == [(2, True, "int4")]
    with pytest.raises(SystemExit, match="--tp 0"):
        port_launch.main(LAUNCH + ["--tp", "0"])
