"""Tensor-parallel serving of the recurrent and hybrid families in the
PyTorch port (`ServeConfig(tp=2)` for xlstm and zamba: the split table
`dist.shard.recurrent_splits`, the cells on a rank's heads, the
StateArena at a rank's layout) against the JAX package's tp = 2 engine
and the port's tp = 1, on the CPU.

One spawn of a 2-rank gloo group (`init_method="file://..."` under the
test's tmp dir; one thread a rank; `torch_tp_ranks.recurrent_rank_main`)
serves every case while this process computes the references: JAX's
`PagedServeEngine` at tp = 2 on its forced 2-device host mesh
(tests/conftest.py) for both families (zamba runs there too), and the
port at tp = 1, from the same weights (drawn with numpy from a seed; the
int4 cases' packed once for both packages, `test_torch_dist.packed`,
JAX fed the mLSTM's and the shared block's q / k / v dequantized to f32,
as tests/test_torch_recurrent.py's int4f32 route: JAX's own route rounds
them to bf16 in every step) and prompts.  Held:

  * greedy streams of the `xlstm-smoke` and `zamba2-smoke` configs in fp
    and int4, an xlstm of d_model 96 whose sLSTM FFN (f_up 128) the
    ranks split (int4), and one of 3 mLSTM heads, which two ranks cannot
    split, so its mLSTM cells run whole on both: equal to JAX's tp = 2
    and the port's tp = 1, the same on both ranks;
  * a pool of 9 pages that forces preemptions: xlstm's lanes resume from
    their arena snapshots, zamba's re-prefill; the streams equal the
    unpreempted run and every page is free at the end;
  * each rank's leaves (its heads of in_proj / up_proj / the stacks /
    the arena, B and C and the sLSTM whole) and its arena's
    `state_bytes`;
  * each rank's slice of every recurrent leaf is the JAX leaf cut at the
    same segment boundaries, byte for byte (packed data and scales);
  * the collectives a step call, exactly;
  * outside `use_tp` the step logits and arena of both families are
    bitwise those of the code before this slice (kept here,
    `_pre_slice_*`);
  * `python -m repro_torch.launch.serve --arch xlstm-1.3b --smoke
    --device cpu --tp 2` prints `--tp 1`'s streams;
  * the refusals at tp = 2: speculation, the prefix cache and a fork in
    JAX's words; requests with deadlines admitted and decided as at
    tp = 1.
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
from repro.quant.qarray import QTensor as JaxQTensor
from repro.serve import PagedServeEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeRequest as JaxRequest
from repro.spec import SpecConfig as JaxSpecConfig

import repro_torch.launch.serve as port_launch
from repro_torch.convert import from_numpy_tree
from repro_torch.dist.shard import recurrent_splits, shard_specs, shard_tree
from repro_torch.kernels.ops import qmatmul as qmm
from repro_torch.models import DecoderLM
from repro_torch.models import blocks as tblocks
from repro_torch.models import ssm as tssm
from repro_torch.models.common import (ACTIVATIONS, init_params, rms_norm,
                                       swish)
from repro_torch.quant.qarray import QTensor

import torch_tp_ranks
from test_torch_dist import _flat, _smoke_kw, host_weights, jax_config, packed

XL = _smoke_kw("xlstm-1.3b")
ZA = _smoke_kw("zamba2-7b")
# f_up = int(4 / 3 * 96) = 128: the sLSTM FFN splits (the smoke config's
# 85 does not)
XL_FUP = dict(XL, name="xlstm-fup", d_model=96)
# f_up = int(4 / 3 * 68) = 90 splits by columns, but a rank's 45 rows of
# ffn_down (and 68 of down_proj's 136, 8.5 groups of 8) do not start on
# a packed byte (a group): at INT4 both stay whole and their input is
# gathered, as xlstm-1.3b's ffn_down (1365 of 2730 rows) is
XL_ROWS = dict(XL, name="xlstm-rows", d_model=68)
# 3 mLSTM heads: two ranks cannot split them, the mLSTM cells run whole
XL_ODD = dict(XL, name="xlstm-odd", d_model=96,
              ssm=dict(XL["ssm"], mlstm_heads=3))
GEOM = dict(max_batch=2, max_seq=48, page_size=4, prefill_chunk=8)
INT4 = dict(precision="int4", quant_group=16)
NEW = 8
LAUNCH = ["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu",
          "--requests", "3", "--tokens", "6", "--max-seq", "32",
          "--page-size", "8"]


def _prompts(vocab, lengths=(3, 9, 17, 6)):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in lengths]


# name -> (arch, serve kwargs, the case whose references it is held to)
CASES = {
    "xlstm_fp": (XL, GEOM, None),
    "xlstm_int4": (XL, dict(GEOM, **INT4), None),
    "zamba_fp": (ZA, GEOM, None),
    "zamba_int4": (ZA, dict(GEOM, **INT4), None),
    "xlstm_fup": (XL_FUP, dict(GEOM, **INT4), None),
    "xlstm_rows": (XL_ROWS, dict(GEOM, **INT4), None),
    "xlstm_odd": (XL_ODD, GEOM, None),
    # lanes of 17 + 8 and 9 + 8 tokens need 12 pages of 4: preemptions
    "xlstm_preempt": (XL, dict(GEOM, n_pages=9), "xlstm_fp"),
    "zamba_preempt": (ZA, dict(GEOM, n_pages=9), "zamba_fp"),
}
REFS = [name for name, case in CASES.items() if case[2] is None]

# the leaves JAX dequantizes to bf16 in every step: fed to it in f32
BF16_ROUTE = {"mlstm": ("wq", "wk", "wv"), "shared": ("wq", "wk", "wv")}


def _weights(arch, serve_kw):
    """(jax tree, numpy tree) of a case: float, or packed at INT4 with
    JAX's BF16_ROUTE leaves dequantized to f32."""
    host = host_weights(arch)
    if serve_kw.get("precision") != "int4":
        return jax.tree_util.tree_map(jnp.asarray, host), host
    jp, host = packed(host, serve_kw["quant_group"])
    for top, names in BF16_ROUTE.items():
        if top not in jp:
            continue
        sub = jp[top]["cell" if top == "mlstm" else "attn"]
        for k in names:
            if isinstance(sub[k], JaxQTensor):
                sub[k] = sub[k].dequantize(jnp.float32)
    return jp, host


def _jax_run(arch, weights, serve_kw, prompts, new):
    eng = JaxEngine(JaxLM(jax_config(arch)), weights,
                    JaxServeConfig(**serve_kw, tp=2))
    reqs = [JaxRequest(prompt=p.copy(), max_new_tokens=new, rid=i)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    return [r.out_tokens for r in reqs]


def _jax_refusals(arch, weights):
    """JAX's words for speculation, the prefix cache and a fork on a
    recurrent model at tp = 2."""
    model = JaxLM(jax_config(arch))
    out = {}
    for name, kw, spec in (("spec", {}, JaxSpecConfig(k=4)),
                           ("prefix", {"prefix_cache": True}, None)):
        try:
            JaxEngine(model, weights, JaxServeConfig(**GEOM, **kw, tp=2),
                      spec=spec)
        except ValueError as e:
            out[name] = str(e)
    eng = JaxEngine(model, weights, JaxServeConfig(**GEOM, tp=2))
    parent = JaxRequest(prompt=_prompts(XL["vocab"])[0], max_new_tokens=2)
    eng.submit(parent)
    try:
        eng.submit(JaxRequest(prompt=parent.prompt, fork_from=parent))
    except ValueError as e:
        out["fork"] = str(e)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks' results, JAX's tp = 2 and the port's tp = 1 streams,
    JAX's refusals and the launcher's output at --tp 2, computed once."""
    weights = {name: _weights(arch, kw)
               for name, (arch, kw, ref) in CASES.items() if ref is None}
    weights.update({name: weights[ref] for name, (_, _, ref)
                    in CASES.items() if ref is not None})
    payload = {"streams": {
        name: dict(arch=arch, params=weights[name][1], serve=kw,
                   prompts=_prompts(arch["vocab"]), new=NEW)
        for name, (arch, kw, _) in CASES.items()},
        "refused": dict(arch=XL, params=weights["xlstm_fp"][1], serve=GEOM,
                        prompts=_prompts(XL["vocab"]))}
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH,
         "--tp", "2"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = "file://" + str(tmp_path_factory.mktemp("tp_rec") / "store")
    procs = [ctx.Process(target=torch_tp_ranks.recurrent_rank_main,
                         args=(r, init, payload, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        ref = {name: _jax_run(CASES[name][0], weights[name][0],
                              CASES[name][1],
                              _prompts(CASES[name][0]["vocab"]), NEW)
               for name in REFS}
        jax_refusals = _jax_refusals(XL, weights["xlstm_fp"][0])
        tp1_refusals = torch_tp_ranks.recurrent_refusals(payload["refused"],
                                                         tp=1)
        tp1 = {}
        for name in REFS:
            arch, kw, _ = CASES[name]
            tp1[name] = torch_tp_ranks.serve(
                arch, weights[name][1], kw, _prompts(arch["vocab"]), NEW,
                0)[0]
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
    return dict(ranks=ranks, jax=ref, tp1=tp1, jax_refusals=jax_refusals,
                tp1_refusals=tp1_refusals,
                launch=(launcher.returncode, out, err,
                        [r.out_tokens for r in launch_reqs]))


# ----------------------------------------------------------------------------
# streams
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_tp2_streams_equal_jax_tp2_and_port_tp1(served, name):
    ref = CASES[name][2] or name
    r0, r1 = served["ranks"][0][name], served["ranks"][1][name]
    assert r0["streams"] == r1["streams"], "the ranks left lockstep"
    assert r0["streams"] == served["tp1"][ref]
    assert r0["streams"] == served["jax"][ref]
    assert all(len(s) == NEW for s in r0["streams"]) and r0["drained"]
    assert r0["summary"]["tp"] == 2.0 and r0["summary"]["step_graphs"] == 0


@pytest.mark.parametrize("name,resumed", [("xlstm_preempt", True),
                                          ("zamba_preempt", False)])
def test_preempted_lanes_resume_or_reprefill_and_free_every_page(
        served, name, resumed):
    """xlstm (no attention layer) snapshots a preempted lane's arena
    slice on each rank and restores it; zamba re-prefills the lane."""
    for r in (0, 1):
        res = served["ranks"][r][name]
        assert res["preemptions"] > 0 and res["drained"]
        assert (res["resumed"] > 0) == resumed
        assert res["resumed"] == served["ranks"][0][name]["resumed"]


# ----------------------------------------------------------------------------
# each rank's leaves and arena
# ----------------------------------------------------------------------------
def _dims(arch):
    d, ssm = arch["d_model"], arch["ssm"]
    if arch["family"] == "zamba":
        di = ssm["expand"] * d
        return dict(d=d, di=di, nh=di // ssm["head_dim"],
                    hd=ssm["head_dim"], ds=ssm["d_state"],
                    k=ssm["d_conv"])
    di = int(ssm["proj_factor_mlstm"] * d)
    nh = ssm["mlstm_heads"]
    return dict(d=d, di=di, nh=nh, dh=di // nh, k=ssm["conv_width"],
                f_up=int(ssm["proj_factor_slstm"] * d))


def _want(arch, b):
    """{path: shape} of the recurrent leaves and arena leaves a rank must
    hold at tp = 2 (the row-parallel projections left out: whether a
    packed one splits depends on its groups, which the byte test holds)."""
    m = _dims(arch)
    d, di, nh, k = m["d"], m["di"], m["nh"], m["k"]
    if arch["family"] == "zamba":
        per = arch["zamba"]["shared_every"]
        G, T = arch["n_layers"] // per, arch["n_layers"] % per
        ds, hd = m["ds"], m["hd"]
        cell = {"in_proj": (d, di + 2 * ds + nh // 2),
                "conv_w": (k, di // 2 + 2 * ds), "a_log": (nh // 2,),
                "dt_bias": (nh // 2,), "norm": (di // 2,)}
        state = {"state": (b, nh // 2, hd, ds),
                 "conv": (b, k - 1, di // 2 + 2 * ds)}
        H, hq = arch["n_heads"], arch["head_dim"]
        want = {f"/mamba/cell/{n}": (G, per, *s) for n, s in cell.items()}
        want.update({f"/mamba_tail/cell/{n}": (T, *s)
                     for n, s in cell.items()})
        want.update({"/shared/attn/wq": (d, H * hq // 2),
                     "/lora/lora_b_q": (G, arch["zamba"]["lora_rank"],
                                        H * hq // 2),
                     "/lora/out_proj": (G, d, d)})
        arena = {f"/mamba/{n}": (G, per, *s) for n, s in state.items()}
        arena.update({f"/mamba_tail/{n}": (T, *s) for n, s in state.items()})
        return want, arena
    every = arch["ssm"]["slstm_every"]
    G = arch["n_layers"] // every
    split = nh % 2 == 0
    mine = nh // 2 if split else nh
    cell = {"up_proj": (d, 2 * di * mine // nh),
            "wq": (mine, m["dh"], m["dh"]),
            "w_o": (di, di * mine // nh), "hnorm": (di * mine // nh,),
            "conv_w": (k, di), "w_if": (di, 2 * nh)}
    f_up = m["f_up"]
    f_mine = f_up // 2 if f_up % 2 == 0 else f_up
    want = {f"/mlstm/cell/{n}": (G, every - 1, *s) for n, s in cell.items()}
    want.update({"/slstm/cell/ffn_up": (G, d, 2 * f_mine),
                 "/slstm/cell/w_gates": (G, d, 4 * d),
                 "/slstm/cell/r_gates": (G, nh, d // nh, 4 * d // nh)})
    arena = {f"/mlstm/{n}": (G, every - 1, *s) for n, s in {
        "C": (b, mine, m["dh"], m["dh"]), "n": (b, mine, m["dh"]),
        "m": (b, mine), "conv": (b, k - 1, di)}.items()}
    arena.update({f"/slstm/{n}": (G, b, d) for n in ("c", "n", "h")})
    arena["/slstm/m"] = (G, b, nh)
    return want, arena


@pytest.mark.parametrize("name", REFS)
def test_each_rank_holds_its_heads_and_its_arena(served, name):
    arch, kw, _ = CASES[name]
    want, arena = _want(arch, kw["max_batch"])
    tp1 = DecoderLM(torch_tp_ranks.port_config(arch)).arena_state_specs(
        kw["max_batch"])
    whole = sum(int(np.prod(s.shape)) * s.dtype.itemsize
                for s in _flat(tp1).values())
    for r in (0, 1):
        res = served["ranks"][r][name]
        for path, shape in want.items():
            assert res["params"][path] == shape, (r, path)
        assert res["arena"] == arena, r
        # the arena's bytes: its shapes at the dtypes of tp = 1's leaves
        nbytes = sum(int(np.prod(shape)) * _flat(tp1)[p].dtype.itemsize
                     for p, shape in arena.items())
        assert res["state_bytes"] == nbytes
        assert res["state_bytes"] <= whole
        if arch["family"] == "zamba":
            assert res["pools"]["/attn/k"][-2] == arch["n_kv_heads"] // 2


def test_the_arena_is_cut_by_the_table_alone():
    """Every arena leaf of both families has a rule in the split table,
    so none goes through `shard_specs`' even cut."""
    for arch in (XL, ZA, XL_ODD):
        model = DecoderLM(torch_tp_ranks.port_config(arch))
        splits = recurrent_splits(model.cfg, 2)
        cells = {"mamba": "mamba2", "mamba_tail": "mamba2",
                 "mlstm": "mlstm", "slstm": "slstm"}
        for path in _flat(model.arena_state_specs(2)):
            top, leaf = path.split("/")[1], path.split("/")[-1]
            assert (cells[top], leaf) in splits, path
        assert recurrent_splits(model.cfg, 1) == {}


# ----------------------------------------------------------------------------
# each rank's bytes against the JAX leaf cut at the segment boundaries
# ----------------------------------------------------------------------------
def _cuts(arch):
    """{(stack, leaf): (dim, [(start, length) of rank 0's pieces], [rank
    1's])} of the recurrent leaves at tp = 2, from the segment sizes
    (None: whole)."""
    m = _dims(arch)
    di, nh = m["di"], m["nh"]

    def halves(*segments):
        """(dim, rank pieces) of segments (size, split) side by side."""
        out = ([], [])
        start = 0
        for size, split in segments:
            for r in (0, 1):
                out[r].append((start + r * size // 2, size // 2) if split
                              else (start, size))
            start += size
        return out

    if arch["family"] == "zamba":
        ds = m["ds"]
        xbc = ((di, True), (ds, False), (ds, False))
        rules = {"in_proj": (-1, halves((di, True), *xbc, (nh, True))),
                 "conv_w": (-1, halves(*xbc)), "conv_b": (-1, halves(*xbc)),
                 "a_log": (-1, halves((nh, True))),
                 "d_skip": (-1, halves((nh, True))),
                 "dt_bias": (-1, halves((nh, True))),
                 "norm": (-1, halves((di, True))),
                 "out_proj": (-2, halves((di, True)))}
        return {(s, k): v for s in ("mamba", "mamba_tail")
                for k, v in rules.items()}
    out = {}
    if nh % 2 == 0:
        out.update({("mlstm", "up_proj"): (-1, halves((di, True),
                                                       (di, True))),
                    ("mlstm", "w_o"): (-1, halves((di, True))),
                    ("mlstm", "hnorm"): (-1, halves((di, True))),
                    ("mlstm", "down_proj"): (-2, halves((di, True)))})
        for k in ("wq", "wk", "wv"):
            out["mlstm", k] = (-3, halves((nh, True)))
    f_up = m["f_up"]
    if f_up % 2 == 0:
        out["slstm", "ffn_up"] = (-1, halves((f_up, True), (f_up, True)))
        out["slstm", "ffn_down"] = (-2, halves((f_up, True)))
    return out


def _np_cut(a, dim, pieces):
    return np.concatenate([np.take(a, np.arange(s, s + n), axis=dim)
                           for s, n in pieces], axis=dim)


@pytest.mark.parametrize("name", REFS)
def test_each_ranks_slice_is_the_jax_leaf_cut_at_the_segments(name):
    arch, kw, _ = CASES[name]
    host = host_weights(arch)
    if kw.get("precision") == "int4":
        jp, host = packed(host, kw["quant_group"])
    else:
        jp = jax.tree_util.tree_map(jnp.asarray, host)
    params = from_numpy_tree(host)
    model = DecoderLM(torch_tp_ranks.port_config(arch))
    splits = recurrent_splits(model.cfg, 2)
    ranks = [_flat(shard_tree(params, model.param_specs(), r, 2,
                              splits=splits)) for r in (0, 1)]
    cuts = _cuts(arch)
    flat = _flat(jp)
    split_rows = 0
    for path, leaf in flat.items():
        parts = path.split("/")
        if parts[1] not in ("mamba", "mamba_tail", "mlstm", "slstm") \
                or parts[-2] != "cell":
            continue
        rule = cuts.get((parts[1], parts[-1]))
        for r in (0, 1):
            mine = ranks[r][path]
            if isinstance(leaf, JaxQTensor):
                data, scales = np.asarray(leaf.data), np.asarray(
                    leaf.scales)
                if rule is not None:
                    dim, pieces = rule[0], rule[1][r]
                    if dim == -2:      # the packed rows: bytes and groups
                        unit = np.lcm(leaf.group, 2)
                        if all(s % unit == 0 and n % unit == 0
                               for s, n in pieces):
                            split_rows += 1
                            data = _np_cut(data, dim, [
                                (s // 2, n // 2) for s, n in pieces])
                            scales = _np_cut(scales, dim, [
                                (s // leaf.group, n // leaf.group)
                                for s, n in pieces])
                    else:
                        data = _np_cut(data, dim, pieces)
                        scales = _np_cut(scales, dim, pieces)
                assert isinstance(mine, QTensor), path
                assert mine.data.numpy().tobytes() == data.tobytes(), path
                assert mine.data.shape == data.shape, path
                assert mine.scales.numpy().tobytes() == scales.tobytes(), \
                    path
                assert mine.scales.shape == scales.shape, path
                continue
            want = np.asarray(leaf)
            if rule is not None:
                want = _np_cut(want, rule[0], rule[1][r])
            got = mine.numpy()
            assert got.shape == want.shape and \
                got.tobytes() == want.tobytes(), path
    if kw.get("precision") == "int4":
        # packed rows split on their groups, but for the case built to
        # keep them whole
        assert (split_rows > 0) == (arch is not XL_ROWS)


# ----------------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------------
def _per_call(name, shapes):
    """Collectives a step call: the embedding's all-reduce and the
    logits' gather; a split Mamba2 layer gathers for its norm, a split
    mLSTM layer gathers x_m and h; a row-parallel projection of a split
    cell (out_proj, down_proj, ffn_down) reduces after it, or gathers its
    input where its rows stay whole (`shapes`: the rank's leaves); the
    shared block reduces after wo and w_down.  A whole cell runs none."""
    arch = CASES[name][0]
    L, m = arch["n_layers"], _dims(arch)

    def split_rows(path, rows):
        return shapes[path][-2] == rows // 2
    if arch["family"] == "zamba":
        shared = L // arch["zamba"]["shared_every"]
        rows = split_rows("/mamba/cell/out_proj", m["di"])
        return {"all_reduce": 1 + L * rows + 2 * shared,
                "all_gather": 1 + L * (2 - rows)}
    n_slstm = L // arch["ssm"]["slstm_every"]
    n_mlstm = (L - n_slstm) if m["nh"] % 2 == 0 else 0
    n_ffn = n_slstm if m["f_up"] % 2 == 0 else 0
    down = split_rows("/mlstm/cell/down_proj", m["di"]) if n_mlstm else 0
    ffn_down = split_rows("/slstm/cell/ffn_down", m["f_up"]) if n_ffn else 0
    return {"all_reduce": 1 + n_mlstm * down + n_ffn * ffn_down,
            "all_gather": 1 + n_mlstm * (3 - down)
            + n_ffn * (1 - ffn_down)}


def test_the_rows_case_keeps_its_row_parallel_leaves_whole(served):
    res = served["ranks"][0]["xlstm_rows"]["params"]
    m = _dims(XL_ROWS)
    assert res["/slstm/cell/ffn_up"][-1] == m["f_up"]      # 2 x 45
    assert res["/slstm/cell/ffn_down"][-2] == m["f_up"]    # whole
    assert res["/mlstm/cell/down_proj"][-2] == m["di"]     # whole


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_a_step_call_exactly(served, name):
    for r in (0, 1):
        res = served["ranks"][r][name]
        want = _per_call(name, res["params"])
        assert res["calls"] > 0
        assert res["collectives"] == {k: v * res["calls"]
                                      for k, v in want.items()}


# ----------------------------------------------------------------------------
# refusals and the launcher
# ----------------------------------------------------------------------------
def test_refusals_at_tp2_in_jax_words(served):
    got = served["ranks"][0]["refusals"]
    assert got == served["ranks"][1]["refusals"]
    for k in ("spec", "prefix", "fork"):
        assert got[k] == served["jax_refusals"][k], k
        assert "recurrent per-lane state" in got[k]
    # a deadline is admitted at tp = 2 and decided as at tp = 1
    assert got["deadline"] == served["tp1_refusals"]["deadline"]
    assert [d[:2] for d in got["deadline"]] == [(False, ""),
                                                (True, "expired")]


def test_launcher_tp2_on_xlstm_prints_tp1_streams(served):
    rc, out, err, tp1 = served["launch"]
    assert rc == 0, err
    assert "tp 2 (2 ranks over gloo, steps eager)" in out
    line = [ln for ln in out.splitlines() if ln.startswith("[serve] streams")]
    assert len(line) == 1, out
    assert json.loads(line[0][len("[serve] streams "):]) == tp1
    assert all(len(t) == 6 for t in tp1)


# ----------------------------------------------------------------------------
# tp = 1 is unchanged
# ----------------------------------------------------------------------------
def _pre_slice_mamba2_in(p, cfg, x):
    di, nh, ds = tssm.mamba2_dims(cfg)
    proj = qmm(x, p["in_proj"])
    dt = tssm.softplus(proj[..., 2 * di + 2 * ds:].to(torch.float32)
                       + p["dt_bias"].to(torch.float32))
    return (proj[..., :di], proj[..., di:2 * di + 2 * ds], dt,
            -torch.exp(p["a_log"].to(torch.float32)))


def _pre_slice_mamba2_out(p, cfg, y, z):
    return qmm(rms_norm(y * swish(z), p["norm"], cfg.norm_eps),
               p["out_proj"])


def _pre_slice_mamba2_serve_step(p, cfg, x, cache, valid, n_new):
    b, s, _ = x.shape
    di, nh, ds = tssm.mamba2_dims(cfg)
    hd = cfg.ssm.head_dim
    z, xbc, dt, A = _pre_slice_mamba2_in(p, cfg, x)
    xc, conv = tssm._conv_prefix(cache["conv"], xbc, p["conv_w"],
                                 p["conv_b"], n_new)
    xc = swish(xc)
    xs = xc[..., :di].reshape(b, s, nh, hd)
    B = xc[..., di:di + ds].to(torch.float32)
    C = xc[..., di + ds:].to(torch.float32)
    dA = torch.where(valid[..., None], torch.exp(dt * A), 1.0)
    u = torch.where(valid[..., None, None],
                    dt[..., None] * xs.to(torch.float32), 0.0)
    d_skip = p["d_skip"].to(x.dtype)[None, :, None]
    state = cache["state"]
    ys = []
    for t in range(s):
        state.mul_(dA[:, t, :, None, None])
        state.addcmul_(u[:, t, :, :, None], B[:, t, None, None, :])
        y = torch.matmul(state, C[:, t, None, :, None])[..., 0]
        ys.append(y.to(x.dtype) + xs[:, t] * d_skip)
    cache["conv"].copy_(conv)
    return _pre_slice_mamba2_out(p, cfg, torch.stack(ys, dim=1).reshape(
        b, s, di), z)


def _pre_slice_mlstm_qkvif(p, cfg, xc):
    di, nh, dh = tssm.mlstm_dims(cfg)
    b, s, _ = xc.shape
    xh = xc.reshape(b * s, nh, dh).transpose(0, 1).contiguous()

    def heads(w, scale=None):
        out = tssm.headwise(xh, w).to(xc.dtype)
        if scale is not None:
            out = out / scale
        return out.transpose(0, 1).reshape(b, s, nh, dh).to(torch.float32)
    q, k, v = heads(p["wq"]), heads(p["wk"], dh ** 0.5), heads(p["wv"])
    gates = (tssm._mm(xc, p["w_if"]) + p["b_if"]).to(torch.float32)
    return q, k, v, gates[..., :nh], gates[..., nh:]


def _pre_slice_mlstm_in(p, cfg, x):
    di = tssm.mlstm_dims(cfg)[0]
    up = qmm(x, p["up_proj"])
    x_m, z = up[..., :di], up[..., di:]
    return x_m, z, torch.sigmoid(qmm(x_m, p["w_o"]))


def _pre_slice_mlstm_out(p, cfg, h, o, z, dtype):
    b, s = h.shape[:2]
    h = h.reshape(b, s, -1).to(dtype)
    h = rms_norm(h, p["hnorm"], cfg.norm_eps) * o
    return qmm(h * swish(z), p["down_proj"])


def _pre_slice_slstm_ffn(p, cfg, y):
    y = rms_norm(y, p["gnorm"], cfg.norm_eps)
    up = qmm(y, p["ffn_up"])
    f_up = up.shape[-1] // 2
    y = ACTIVATIONS["gelu"](up[..., :f_up]) * up[..., f_up:]
    return qmm(y, p["ffn_down"])


def _steps(model, params):
    """Logits of a prefill chunk (lanes of 8 and 5 tokens) and a decode
    step over a fresh zero arena and pools, and the state after."""
    specs = model.decode_state_specs(2, 12, 4)
    state = init_params({**specs["paged"], **specs["arena"]},
                        torch.Generator().manual_seed(0))
    tables = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    rng = np.random.default_rng(3)
    outs = []
    for s, lengths, n_new in ((8, [0, 0], [8, 5]), (1, [8, 5], [1, 1])):
        tokens = torch.from_numpy(rng.integers(0, model.cfg.vocab, (2, s))
                                  .astype(np.int32))
        logits, _ = model.serve_step(params, state, {"tokens": tokens},
                                     tables,
                                     torch.tensor(lengths, dtype=torch.int32),
                                     torch.tensor(n_new, dtype=torch.int32))
        outs.append(logits.clone())
    return outs, _flat(state)


@pytest.mark.parametrize("arch,precision", [
    (XL, "fp"), (XL, "int4"), (ZA, "fp"), (ZA, "int4"), (XL_FUP, "int4"),
    (XL_ROWS, "int4")],
    ids=["xlstm-fp", "xlstm-int4", "zamba-fp", "zamba-int4",
         "xlstm-fup-int4", "xlstm-rows-int4"])
def test_tp1_logits_and_arena_are_bitwise_the_pre_slice_code(
        arch, precision, monkeypatch):
    host = host_weights(arch)
    if precision == "int4":
        host = packed(host, 16)[1]
    model = DecoderLM(torch_tp_ranks.port_config(arch))
    params = from_numpy_tree(host)
    new, new_state = _steps(model, params)
    monkeypatch.setattr(tblocks, "mamba2_serve_step",
                        _pre_slice_mamba2_serve_step)
    monkeypatch.setattr(tssm, "mlstm_qkvif", _pre_slice_mlstm_qkvif)
    monkeypatch.setattr(tssm, "_mlstm_in", _pre_slice_mlstm_in)
    monkeypatch.setattr(tssm, "_mlstm_out", _pre_slice_mlstm_out)
    monkeypatch.setattr(tssm, "_slstm_ffn", _pre_slice_slstm_ffn)
    old, old_state = _steps(model, params)
    for a, b in zip(new, old):
        assert torch.equal(a, b)
        assert torch.isfinite(a).all()
    assert new_state.keys() == old_state.keys()
    for k in new_state:
        assert torch.equal(new_state[k], old_state[k]), k
    # the table leaves tp = 1 alone: nothing to split
    assert shard_specs(model.decode_state_specs(2, 12, 4)["arena"], 1,
                       splits=recurrent_splits(model.cfg, 1)) == \
        model.decode_state_specs(2, 12, 4)["arena"]
