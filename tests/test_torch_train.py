"""PyTorch port vs the JAX package, on the CPU: AdamW and its schedule,
the Trainer (loss trajectories, events, resume), checkpoints read by
either package, the synthetic data, gradient compression, and the
training launcher.

Weights cross as numpy (`repro_torch.convert`).  Tolerances:
  * one AdamW update: 1e-5 relative + 1e-8 (elementwise f32; the two
    frameworks may fuse a multiply-add differently);
  * loss trajectories: 1e-4 relative over 5 steps (f32 sums in another
    order, compounding through the updates);
  * the port's own resume, checkpoints, data and INT8 codes: exact.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.dist import compress as jax_compress
from repro.models import DecoderLM as JaxLM
from repro.models import init_params as jax_init
from repro.train import AdamW as JaxAdamW
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train import checkpoint as jax_ckpt
from repro.train import cosine_schedule as jax_cosine
from repro.train import global_norm as jax_global_norm
from repro.configs import get_smoke_config as jax_get_smoke_config

from repro_torch.convert import adamw_state_from_numpy, from_numpy_tree
from repro_torch.data import DataConfig, FrontendStub, SyntheticLM
from repro_torch.dist import compress
from repro_torch.models import DecoderLM
from repro_torch.train import (AdamW, TrainConfig, Trainer, checkpoint,
                               cosine_schedule, global_norm)
from repro_torch.train.adamw import tree_leaves

from test_torch_forward import port_cfg

TRAJ_TOL = 1e-4
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _rand_tree(seed=0):
    """Leaves like a stacked model's: (L, d, f), a stacked norm (L, d),
    a vector (d,) and a table."""
    rng = np.random.default_rng(seed)
    shapes = {"blocks": {"w": (2, 8, 12), "ln": (2, 8)}, "bias": (8,),
              "embed": (16, 8)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)
    return draw(shapes)


# ----------------------------------------------------------------------------
# AdamW, schedule, norm
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("clip_norm", [1e-2, 1e6],
                         ids=["clipped", "unclipped"])
def test_adamw_updates_match_jax(clip_norm):
    """JAX's state after one update carried into the port
    (`adamw_state_from_numpy`), then one more update in both, with the
    cosine schedule and weight decay; the stacked (L, d) norm decays,
    the (d,) vector does not (its gradient is zero, so only decay could
    move it)."""
    params, grads = _rand_tree(0), _rand_tree(1)
    grads["bias"][:] = 0.0
    grads["blocks"]["ln"][:] = 0.0
    kw = dict(lr=None, weight_decay=0.1, clip_norm=clip_norm)
    jopt = JaxAdamW(**dict(kw, lr=jax_cosine(1e-2, 1, 4)))
    topt = AdamW(**dict(kw, lr=cosine_schedule(1e-2, 1, 4)))
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    assert (float(jax_global_norm(jg)) > clip_norm) == (clip_norm < 1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jp, js = jopt.update(jg, jopt.init(jp), jp)
    tp = from_numpy_tree(_np(jp))
    ts = adamw_state_from_numpy(np.asarray(js.step), _np(js.mu), _np(js.nu))
    assert topt.init(tp).step.dtype == ts.step.dtype == torch.int32
    jp, js = jopt.update(jg, js, jp)
    ts = topt.update(from_numpy_tree(grads), ts, tp)
    assert int(ts.step) == int(js.step) == 2
    for a, b in zip(tree_leaves(tp) + tree_leaves(ts.mu) + tree_leaves(ts.nu),
                    jax.tree_util.tree_leaves((jp, js.mu, js.nu))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-8)
    assert not np.array_equal(tp["blocks"]["ln"].numpy(),
                              params["blocks"]["ln"])
    np.testing.assert_array_equal(tp["bias"].numpy(), params["bias"])


def test_cosine_schedule_and_global_norm_match_jax():
    jfn, tfn = jax_cosine(3e-4, 10, 50), cosine_schedule(3e-4, 10, 50)
    steps = np.arange(0, 60, dtype=np.int32)
    np.testing.assert_allclose(
        tfn(torch.from_numpy(steps)).numpy(), np.asarray(jfn(steps)),
        rtol=1e-6, atol=0)
    tree = _rand_tree(2)
    np.testing.assert_allclose(
        float(global_norm(from_numpy_tree(tree))),
        float(jax_global_norm(jax.tree_util.tree_map(jnp.asarray, tree))),
        rtol=1e-6)


# ----------------------------------------------------------------------------
# Trainer against JAX's
# ----------------------------------------------------------------------------
def _setup(arch_id, steps, microbatches=1, ckpt_dir=None, **tc_kw):
    """(jax trainer, port trainer) on one smoke config, batch 4 x 16 (a
    frontend stub for embedding archs), synchronous checkpoints unless
    `tc_kw` asks otherwise."""
    jcfg = jax_get_smoke_config(arch_id).replace(dtype="float32",
                                                 remat=False)
    jm, tm = JaxLM(jcfg), DecoderLM(port_cfg(jcfg))
    data = SyntheticLM(DataConfig(vocab=jcfg.vocab, seq_len=16,
                                  global_batch=4))
    feed = data if jcfg.embed_inputs else FrontendStub(data, jcfg.d_model)
    kw = dict(dict(steps=steps, microbatches=microbatches, log_every=2,
                   ckpt_every=3, ckpt_dir=ckpt_dir, async_checkpoint=False),
              **tc_kw)
    jt = JaxTrainer(jm, JaxAdamW(lr=jax_cosine(1e-2, 2, steps)), feed,
                    JaxTrainConfig(**kw))
    tt = Trainer(tm, AdamW(lr=cosine_schedule(1e-2, 2, steps)), feed,
                 TrainConfig(**kw), device="cpu")
    return jt, tt


def _jax_params(arch_id):
    jm = JaxLM(jax_get_smoke_config(arch_id))
    return jax_init(jm.param_specs(), jax.random.PRNGKey(0),
                    dtype_override=jnp.float32)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch_id", ["qwen2.5-3b", "musicgen-medium"])
def test_trainer_loss_trajectory_matches_jax(arch_id, microbatches):
    jt, tt = _setup(arch_id, 5, microbatches)
    jp = _jax_params(arch_id)
    ref = jt.run(params=jp)["losses"]
    got = tt.run(params=from_numpy_tree(_np(jp), requires_grad=True))
    np.testing.assert_allclose(got["losses"], ref, rtol=TRAJ_TOL)
    assert ref[-1] < ref[0]
    assert got["step"] == 5 and int(got["opt_state"].step) == 5


def test_preemption_and_straggler_events_follow_jax(tmp_path):
    """The flag file appears while STEP@4 is emitted: a checkpoint
    every 3 steps, then one at the preemption, then the stop; and the
    same straggler events from the same step times."""
    kinds = {}
    for name in ("jax", "port"):
        flag = str(tmp_path / f"PREEMPT_{name}")

        def hook(ev, flag=flag):
            if ev.kind == "STEP" and ev.step == 4:
                open(flag, "w").close()
        jt, tt = _setup("qwen2.5-3b", 8, ckpt_dir=str(tmp_path / name),
                        preempt_flag=flag, straggler_factor=1e9)
        tr = jt if name == "jax" else tt
        tr.event_hook = hook
        out = tr.run()
        assert out["step"] == 4
        tr._step_times.clear()          # then step times given, not timed
        tr.tc.straggler_factor = 3.0
        for dt in [0.1] * 9 + [1.0, 0.1, 2.0]:
            tr._check_straggler(dt, 99)
        kinds[name] = [(e.kind, e.step, e.payload.get("median"))
                       for e in tr.events]
    assert kinds["port"] == kinds["jax"]
    assert [k[:2] for k in kinds["port"]] == [
        ("STEP", 2), ("CKPT", 3), ("STEP", 4), ("CKPT", 4), ("PREEMPT", 4),
        ("STRAGGLER", 99), ("STRAGGLER", 99)]


def test_resume_is_bit_identical(tmp_path):
    """The port's seed params (bf16, as the specs): 20 steps straight,
    and 10 then a resume from LATEST for 10 more (async saves)."""
    d = str(tmp_path / "ck")

    def run(steps, ckpt_dir=None, resume=False):
        _, tt = _setup("qwen2.5-3b", 20, ckpt_dir=ckpt_dir,
                       async_checkpoint=True)
        tt.tc.steps = steps             # one schedule, over 20 steps
        return tt.run(resume=resume)
    full = run(20)
    first = run(10, ckpt_dir=d)
    second = run(20, ckpt_dir=d, resume=True)
    assert second["step"] == 20
    assert first["losses"] + second["losses"] == full["losses"]
    for a, b in zip(tree_leaves(second["params"]),
                    tree_leaves(full["params"])):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# ----------------------------------------------------------------------------
# checkpoints, both ways
# ----------------------------------------------------------------------------
def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX's trainer (its seed params, bf16) saves at step 3 and runs
    to 5; the port resumes from JAX's step 3 and runs steps 4 and 5."""
    d = str(tmp_path / "ck")
    jt, _ = _setup("qwen2.5-3b", 5, ckpt_dir=d)
    ref = jt.run()["losses"]
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("3")                     # LATEST back to step 3
    _, tt = _setup("qwen2.5-3b", 5, ckpt_dir=str(tmp_path / "unused"))
    tt.tc.ckpt_dir = d
    got = tt.run(resume=True)
    assert got["step"] == 5
    np.testing.assert_allclose(got["losses"], ref[3:], rtol=TRAJ_TOL)


def test_port_checkpoint_is_read_exactly_by_jax(tmp_path):
    d = str(tmp_path / "ck")
    jp = _jax_params("qwen2.5-3b")
    _, tt = _setup("qwen2.5-3b", 2, ckpt_dir=d)
    out = tt.run(params=from_numpy_tree(_np(jp), requires_grad=True))
    like = {"params": jp, "opt": tuple(JaxAdamW().init(jp))}
    tree, meta = jax_ckpt.restore(d, like)
    assert meta["step"] == 2 and meta["next_batch_index"] == 2
    jleaves = jax.tree_util.tree_leaves(tree)
    tleaves = ([out["opt_state"].step] + tree_leaves(out["opt_state"].mu)
               + tree_leaves(out["opt_state"].nu)
               + tree_leaves(out["params"]))
    # jax orders the tree's top keys: "opt" (step, mu, nu), then "params"
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def test_async_save_snapshots_before_an_in_place_step(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"params": from_numpy_tree(_rand_tree(3)),
            "opt": (torch.tensor(7, dtype=torch.int32),
                    {"x": torch.ones(3, dtype=torch.bfloat16)})}
    before = [t.clone() for t in tree_leaves(tree["params"])]
    t = checkpoint.save(d, 1, tree, blocking=False)
    for p in tree_leaves(tree["params"]):
        p.add_(1.0)                      # an optimizer step, in place
    t.join()
    out, meta = checkpoint.restore(d, tree)
    assert meta["keys"] == sorted(
        ["params/blocks/w", "params/blocks/ln", "params/bias",
         "params/embed", "opt/0", "opt/1/x"])
    for a, b in zip(tree_leaves(out["params"]), before):
        assert torch.equal(a, b)
    assert int(out["opt"][0]) == 7 and out["opt"][1]["x"].dtype == \
        torch.bfloat16


# ----------------------------------------------------------------------------
# data, compression, launcher
# ----------------------------------------------------------------------------
def test_synthetic_data_is_jax_byte_for_byte():
    here = os.path.join(SRC, "repro_torch", "data", "synthetic.py")
    with open(here, "rb") as a, \
            open(os.path.join(SRC, "repro", "data", "synthetic.py"),
                 "rb") as b:
        assert a.read() == b.read()
    cfg = dict(vocab=97, seq_len=12, global_batch=6, seed=3)
    mine, ref = SyntheticLM(DataConfig(**cfg)), \
        JaxSyntheticLM(JaxDataConfig(**cfg))
    for index, shard, n in ((0, 0, 1), (5, 1, 3), (9, 2, 3)):
        a, b = mine.batch(index, shard, n), ref.batch(index, shard, n)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()
    for (i, a), (j, b) in zip(mine.stream(4), ref.stream(4)):
        assert i == j and a["tokens"].tobytes() == b["tokens"].tobytes()
        if i == 6:
            break
    assert mine.bigram_entropy() == ref.bigram_entropy()


def test_compress_with_feedback_matches_jax():
    grads, err = _rand_tree(4), _rand_tree(5)
    grads["bias"][:] = 0.0               # a zero leaf: scale 0
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    je = jax.tree_util.tree_map(lambda x: jnp.asarray(x) * 1e-3, err)
    tg = from_numpy_tree(grads)
    te = from_numpy_tree(jax.tree_util.tree_map(np.asarray, je))
    for name in ("embed", "bias"):
        q, s = compress._q8(tg[name])
        jq, js = jax_compress._q8(jg[name])
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
    jdec, jerr = jax_compress.compress_with_feedback(jg, je)
    tdec, terr = compress.compress_with_feedback(tg, te)
    for a, b in zip(tree_leaves(tdec) + tree_leaves(terr),
                    jax.tree_util.tree_leaves((jdec, jerr))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    zero = compress.init_error_state(tg)
    assert all(z.dtype == torch.float32 and not z.any()
               for z in tree_leaves(zero))


def test_launcher_trains_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "20"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[train] qwen2.5-smoke: 0.1M params" in r.stdout
    assert "STEP @20" in r.stdout and "[train] done @step 20" in r.stdout
