"""Tensor-parallel serving of the MoE and MLA families in the PyTorch
port (`ServeConfig(tp=2)` for qwen3-moe and deepseek-v2-lite: expert
parallelism, MLA's heads over whole latent pools) against the JAX
package's tp = 2 engine and the port's tp = 1, on the CPU.

One spawn of a 2-rank gloo group (`init_method="file://..."` under the
test's tmp dir; one thread a rank; `torch_tp_ranks.moe_rank_main`)
serves every case while this process computes the references: JAX's
`PagedServeEngine` at tp = 2 on its forced 2-device host mesh
(tests/conftest.py) and the port at tp = 1, from the same weights (drawn
with numpy from a seed; the int4 cases' packed once for both packages,
`test_torch_dist.packed`) and prompts.  Held:

  * greedy streams of the `qwen3-moe-smoke` and `deepseek-v2-lite-smoke`
    configs in fp and int4, n-gram speculation (k = 4) on qwen3-moe, a
    prefill chunk whose slots overrun the experts' capacity (onehot
    dispatch, capacity factor 1: slots are dropped at tp = 1 and the
    ranks drop the same ones), a deepseek variant whose packed `ws_down`
    (3 groups of 16 rows) the sharding rule leaves whole, and a qwen3-moe
    variant of 5 experts, whose stacks two ranks cannot split: equal to
    JAX's tp = 2 and the port's tp = 1, the same on both ranks;
  * each rank holds n_experts / 2 experts of every stack, n_heads / 2
    heads of wq / w_uk / w_uv and their rows of wo, the whole router,
    w_dkv, ckv_norm and latent pools, and qwen3-moe's pools at
    n_kv_heads / 2 heads;
  * the collectives a step call, exactly: 2 L + 1 all-reduces (after each
    `wo`, one per FFN, the embedding) and one gather of the logits; with
    `ws_down` whole one gather more a MoE layer, with the stacks whole no
    all-reduce for a MoE layer without shared experts;
  * the `sim_*` keys of the int4 runs equal JAX's tp = 2 engine's;
  * outside `use_tp` (tp = 1) the step logits and pools of both
    families are bitwise those of the code before expert / MLA
    parallelism (kept here, `_pre_slice_*`);
  * `python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    --smoke --device cpu --tp 2` prints `--tp 1`'s streams.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.models import DecoderLM as JaxLM
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxRequest
from repro.spec import SpecConfig as JaxSpecConfig

import repro_torch.launch.serve as port_launch
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels.ops import qmatmul as qmm
from repro_torch.models import DecoderLM
from repro_torch.models import attention as tattn
from repro_torch.models import ffn as tffn
from repro_torch.models.common import ACTIVATIONS, init_params, take_rows

import torch_tp_ranks
from test_torch_dist import _smoke_kw, host_weights, jax_config, packed

Q3M = _smoke_kw("qwen3-moe-235b-a22b")
DS = _smoke_kw("deepseek-v2-lite-16b")
# onehot dispatch at capacity factor 1: a chunk of 2 x 16 rows has 8
# slots an expert for its 64 (cap = max(8, ceil(32 * 2 / 8))), so any
# imbalance drops slots
CROWD = dict(Q3M, name="qwen3-moe-crowd",
             moe=dict(Q3M["moe"], dispatch="onehot", capacity_factor=1.0))
# the shared experts' 48 rows pack into 3 groups of 16, which 2 ranks
# cannot split: JAX's rule (and the port's) keeps ws_down whole
DS_REP = dict(DS, name="ds-rep-leaf", moe=dict(DS["moe"], d_ff_expert=48))
# 5 experts: the rule keeps every stack whole on both ranks
Q3M_ODD = dict(Q3M, name="qwen3-moe-odd", moe=dict(Q3M["moe"], n_experts=5))
GEOM = dict(max_batch=2, max_seq=48, page_size=4, prefill_chunk=8)
INT4 = dict(precision="int4", quant_group=16)
SPEC_PROMPTS = [np.array([1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3], np.int32),
                np.array([7, 9, 11], np.int32),
                np.arange(10, 30, dtype=np.int32) % 64]
LAUNCH = ["--arch", "deepseek-v2-lite-16b", "--smoke", "--device", "cpu",
          "--requests", "3", "--tokens", "6", "--max-seq", "32",
          "--page-size", "8"]


def _prompts(vocab, lengths=(3, 9, 17, 6)):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in lengths]


# name -> (arch, serve kwargs, prompts, new tokens, spec k)
CASES = {
    "q3m_fp": (Q3M, GEOM, _prompts(128), 8, 0),
    "q3m_int4": (Q3M, dict(GEOM, **INT4), _prompts(128), 8, 0),
    "ds_fp": (DS, GEOM, _prompts(128), 8, 0),
    "ds_int4": (DS, dict(GEOM, **INT4), _prompts(128), 8, 0),
    "q3m_ngram": (Q3M, dict(GEOM, max_seq=64, page_size=8), SPEC_PROMPTS,
                  14, 4),
    "crowd": (CROWD, dict(GEOM, prefill_chunk=16),
              _prompts(128, (13, 16)), 6, 0),
    "ds_rep_leaf": (DS_REP, dict(GEOM, **INT4), _prompts(128), 8, 0),
    "q3m_odd": (Q3M_ODD, GEOM, _prompts(128), 8, 0),
}


def _weights(arch, serve_kw):
    """(jax tree, numpy tree) of a case: float, or packed at INT4."""
    host = host_weights(arch)
    if serve_kw.get("precision") == "int4":
        return packed(host, serve_kw["quant_group"])
    return jax.tree_util.tree_map(jnp.asarray, host), host


def _jax_run(arch, weights, serve_kw, prompts, new, spec_k):
    eng = JaxEngine(JaxLM(jax_config(arch)), weights,
                    JaxServeConfig(**serve_kw, tp=2),
                    spec=JaxSpecConfig(k=spec_k, drafter="ngram")
                    if spec_k else None)
    reqs = [JaxRequest(prompt=p.copy(), max_new_tokens=new, rid=i)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    return [r.out_tokens for r in reqs], eng.summary()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks' results, JAX's tp = 2 and the port's tp = 1 streams
    (with the slots its router dropped), and the launcher's output at
    --tp 2, computed once."""
    weights = {name: _weights(arch, kw)
               for name, (arch, kw, *_rest) in CASES.items()}
    payload = {name: dict(arch=arch, params=weights[name][1], serve=kw,
                          prompts=prompts, new=new, spec_k=k)
               for name, (arch, kw, prompts, new, k) in CASES.items()}
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH,
         "--tp", "2"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = "file://" + str(tmp_path_factory.mktemp("tp_moe") / "store")
    procs = [ctx.Process(target=torch_tp_ranks.moe_rank_main,
                         args=(r, init, payload, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        ref = {name: _jax_run(arch, weights[name][0], kw, prompts, new, k)
               for name, (arch, kw, prompts, new, k) in CASES.items()}
        tp1 = {}
        for name, (arch, kw, prompts, new, k) in CASES.items():
            with torch_tp_ranks.DropCount() as drops:
                streams, _ = torch_tp_ranks.serve(
                    arch, weights[name][1], kw, prompts, new, k)
            tp1[name] = (streams, drops.dropped, drops.slots)
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
    return dict(ranks=ranks, jax=ref, tp1=tp1, launch=(
        launcher.returncode, out, err, [r.out_tokens for r in launch_reqs]))


# ----------------------------------------------------------------------------
# streams
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_tp2_streams_equal_jax_tp2_and_port_tp1(served, name):
    r0, r1 = served["ranks"][0][name], served["ranks"][1][name]
    assert r0["streams"] == r1["streams"], "the ranks left lockstep"
    assert r0["streams"] == served["tp1"][name][0]
    assert r0["streams"] == served["jax"][name][0]
    assert all(len(s) for s in r0["streams"]) and r0["drained"]
    if name == "q3m_ngram":
        assert r0["verify_calls"] > 0 and r0["summary"]["spec_drafted"] > 0


def test_crowded_chunk_drops_the_slots_tp1_drops(served):
    """The routing and the capacity are global: both ranks route every
    row and drop as many slots as tp = 1 (the streams' equality says
    they are the same ones)."""
    _, dropped, slots = served["tp1"]["crowd"]
    assert dropped > 0
    for r in (0, 1):
        res = served["ranks"][r]["crowd"]
        assert (res["dropped"], res["slots"]) == (dropped, slots)


# ----------------------------------------------------------------------------
# each rank's slices, and its collectives
# ----------------------------------------------------------------------------
def _want_shapes(arch, kw):
    """{path: shape} a rank must hold: the expert stacks at n_experts /
    2 (all of them where 2 does not divide), the heads' columns of wq
    (w_uk / w_uv) and rows of wo halved, the router, MLA's w_dkv /
    ckv_norm and latent pools whole, GQA pools at n_kv_heads / 2."""
    moe, L = arch["moe"], arch["n_layers"]
    d, H, ps = arch["d_model"], arch["n_heads"], kw["page_size"]
    E = moe["n_experts"]
    El = E // 2 if E % 2 == 0 else E
    n_first = moe["first_dense_layers"]
    Lm = L - n_first
    pages = 2 * kw["max_seq"] // ps + 1
    fe = moe["d_ff_expert"]
    want = {"/blocks/ffn/router": (Lm, d, E),
            "/blocks/ffn/we_gate": (Lm, El, d, fe),
            "/blocks/ffn/we_up": (Lm, El, d, fe),
            "/blocks/ffn/we_down": (Lm, El, fe, d)}
    pools = {}
    if moe["n_shared_experts"]:
        fs = fe * moe["n_shared_experts"]
        whole = fs // 16 % 2 and kw.get("precision") == "int4"
        want["/blocks/ffn/ws_gate"] = (Lm, d, fs // 2)
        want["/blocks/ffn/ws_down"] = (Lm, fs if whole else fs // 2, d)
    stacks = [("blocks", "attn", Lm)]
    if n_first:
        stacks.append(("first_blocks", "attn_first", n_first))
        want["/first_blocks/ffn/w_down"] = (n_first,
                                            moe["first_dense_d_ff"] // 2, d)
    for blocks, pool, n in stacks:
        if arch["mla"] is None:
            hd, g = arch["head_dim"], arch["n_kv_heads"]
            want[f"/{blocks}/attn/wq"] = (n, d, H * hd // 2)
            want[f"/{blocks}/attn/wk"] = (n, d, g * hd // 2)
            want[f"/{blocks}/attn/wo"] = (n, H * hd // 2, d)
            pools[f"/{pool}/k"] = (n, pages, ps, g // 2, hd)
            continue
        m = arch["mla"]
        r, rd = m["kv_lora_rank"], m["qk_rope_head_dim"]
        nope, vd = m["qk_nope_head_dim"], m["v_head_dim"]
        want[f"/{blocks}/attn/wq"] = (n, d, H // 2 * (nope + rd))
        want[f"/{blocks}/attn/w_uk"] = (n, r, H // 2 * nope)
        want[f"/{blocks}/attn/w_uv"] = (n, r, H // 2 * vd)
        want[f"/{blocks}/attn/wo"] = (n, H // 2 * vd, d)
        want[f"/{blocks}/attn/w_dkv"] = (n, d, r + rd)
        want[f"/{blocks}/attn/ckv_norm"] = (n, r)
        pools[f"/{pool}/c_kv"] = (n, pages, ps, r)
        pools[f"/{pool}/k_rope"] = (n, pages, ps, rd)
    return want, pools


@pytest.mark.parametrize("name", ["q3m_int4", "ds_fp", "ds_int4",
                                  "ds_rep_leaf", "q3m_odd"])
def test_each_rank_holds_its_experts_heads_and_latent_pools(served, name):
    arch, kw = CASES[name][:2]
    want, pools = _want_shapes(arch, kw)
    for r in (0, 1):
        res = served["ranks"][r][name]
        for path, shape in want.items():
            assert res["params"][path] == shape, (r, path)
        for path, shape in pools.items():
            assert res["pools"][path] == shape, (r, path)
        assert res["summary"]["step_graphs"] == 0.0
        assert res["summary"]["tp"] == 2.0


@pytest.mark.parametrize("name", ["q3m_int4", "ds_int4", "q3m_ngram",
                                  "ds_rep_leaf", "q3m_odd"])
def test_collectives_a_step_call_exactly(served, name):
    """2 L + 2 a call: an all-reduce after each `wo`, one per FFN (a
    dense layer's `w_down`, a MoE layer's routed + shared partials), one
    for the embedding, a gather of the logits.  `ws_down` whole: its
    input gathered, one gather more a MoE layer; the stacks whole (and
    no shared experts): nothing to reduce for a MoE layer."""
    arch = CASES[name][0]
    L = arch["n_layers"]
    n_moe = L - arch["moe"]["first_dense_layers"]
    per_call = {"all_reduce": 2 * L + 1, "all_gather": 1}
    if name == "ds_rep_leaf":
        per_call["all_gather"] += n_moe
    if name == "q3m_odd":
        per_call["all_reduce"] -= n_moe
    for r in (0, 1):
        res = served["ranks"][r][name]
        assert res["calls"] > 0
        assert res["collectives"] == {k: v * res["calls"]
                                      for k, v in per_call.items()}


@pytest.mark.parametrize("name", ["q3m_int4", "ds_int4"])
def test_tp2_sim_keys_equal_jax_tp2(served, name):
    mine = served["ranks"][0][name]["summary"]
    ref = served["jax"][name][1]
    keys = sorted(k for k in ref if k.startswith("sim_"))
    assert keys == sorted(k for k in mine if k.startswith("sim_"))
    assert "sim_tp" in keys and mine["sim_tp"] == 2.0
    for k in keys:
        np.testing.assert_allclose(mine[k], ref[k], rtol=1e-12, err_msg=k)


# ----------------------------------------------------------------------------
# tp = 1 is unchanged
# ----------------------------------------------------------------------------
def _pre_slice_moe_ffn(p, cfg, x):
    """`ffn.moe_ffn` (with `moe_routed`) as it was before expert
    parallelism."""
    m = cfg.moe
    b, s, d = x.shape
    T, k, E = b * s, m.top_k, m.n_experts
    groups, cap = tffn.capacity(cfg, T)
    xf = x.reshape(T, d)
    w, ids = tffn._router(p, cfg, xf)
    slot, counts = tffn.dispatch_slots(ids, E, cap, groups)
    C = groups * cap
    buf = torch.zeros(E * C + 1, d, dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, xf[:, None].expand(T, k, d).reshape(T * k, d))
    ye = tffn._expert_ffn(p, cfg, buf[:E * C].view(E, C, d), counts)
    ye = torch.cat([ye.reshape(E * C, d), ye.new_zeros(1, d)])
    out = (take_rows(ye, slot) * w.reshape(T * k, 1).to(x.dtype)
           ).reshape(T, k, d)
    out = out.sum(dim=1).reshape(b, s, d)
    if cfg.moe.n_shared_experts > 0:
        act = ACTIVATIONS[cfg.ffn_act]
        out = out + qmm(act(qmm(x, p["ws_gate"])) * qmm(x, p["ws_up"]),
                        p["ws_down"])
    return out


def _pre_slice_mla_paged_step(p, cfg, x, cache, tables, lengths, n_new,
                              rows, rope, is_local=False, verify=False):
    """`attention.mla_paged_step` as it was before MLA's heads were
    sharded."""
    m = cfg.mla
    b, s, _ = x.shape
    H = cfg.n_heads
    nope, rope_d, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    q = qmm(x, p["wq"]).reshape(b, s, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = qmm(x, p["w_dkv"])
    c_new = tattn.rms_norm(dkv[..., :r], p["ckv_norm"], cfg.norm_eps)
    kr_new = dkv[..., r:][:, :, None, :]
    cos, sin = rope
    q_rope = tattn.apply_rope(q_rope, cos, sin)
    kr_new = tattn.apply_rope(kr_new, cos, sin)
    tattn._page_scatter(cache["c_kv"], c_new, rows)
    tattn._page_scatter(cache["k_rope"], kr_new[:, :, 0, :], rows)
    out = tattn.mla_attend(p, cfg, q_nope, q_rope, cache, tables,
                           rows.slots, lengths + n_new, x.dtype)
    return qmm(out, p["wo"])


def _steps(model, params):
    """Logits of a prefill chunk (lanes of 8 and 5 tokens), a decode
    step and a verify window over fresh zero pools, and the pools."""
    pools = init_params(model.decode_state_specs(2, 12, 4)["paged"],
                        torch.Generator().manual_seed(0))
    tables = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    rng = np.random.default_rng(3)
    outs = []
    for s, lengths, n_new, verify in ((8, [0, 0], [8, 5], False),
                                      (1, [8, 5], [1, 1], False),
                                      (3, [9, 6], [3, 2], True)):
        tokens = torch.from_numpy(rng.integers(0, model.cfg.vocab, (2, s))
                                  .astype(np.int32))
        fn = model.paged_verify_step if verify else model.serve_step
        logits, _ = fn(params, pools, {"tokens": tokens}, tables,
                       torch.tensor(lengths, dtype=torch.int32),
                       torch.tensor(n_new, dtype=torch.int32))
        outs.append(logits.clone())
    return outs, pools


@pytest.mark.parametrize("arch,precision", [
    (dict(Q3M, name="q3m-shared-first", n_layers=3,
          moe=dict(Q3M["moe"], n_shared_experts=1, first_dense_layers=1,
                   first_dense_d_ff=128)), "fp"),
    (DS, "fp"), (DS, "int4")], ids=["q3m-shared-first-fp", "ds-fp",
                                    "ds-int4"])
def test_tp1_logits_are_bitwise_the_pre_slice_code(arch, precision,
                                                   monkeypatch):
    host = host_weights(arch)
    if precision == "int4":
        host = packed(host, 16)[1]
    model = DecoderLM(torch_tp_ranks.port_config(arch))
    params = from_numpy_tree(host)
    new, new_pools = _steps(model, params)
    monkeypatch.setattr(tffn, "moe_ffn", _pre_slice_moe_ffn)
    monkeypatch.setattr(tattn, "mla_paged_step", _pre_slice_mla_paged_step)
    old, old_pools = _steps(model, params)
    for a, b in zip(new, old):
        assert torch.equal(a, b)
        assert torch.isfinite(a).all()
    flat_new = torch_tp_ranks.leaf_shapes(new_pools)
    assert flat_new == torch_tp_ranks.leaf_shapes(old_pools)
    for pool in new_pools:
        for k in new_pools[pool]:
            assert torch.equal(new_pools[pool][k], old_pools[pool][k])


# ----------------------------------------------------------------------------
# launcher
# ----------------------------------------------------------------------------
def test_launcher_tp2_on_deepseek_prints_tp1_streams(served):
    rc, out, err, tp1 = served["launch"]
    assert rc == 0, err
    assert "tp 2 (2 ranks over gloo, steps eager)" in out
    line = [ln for ln in out.splitlines() if ln.startswith("[serve] streams")]
    assert len(line) == 1, out
    assert json.loads(line[0][len("[serve] streams "):]) == tp1
    assert all(len(t) == 6 for t in tp1)
