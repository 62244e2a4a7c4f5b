"""The recurrent families' full-sequence forward in the PyTorch port vs
the JAX package, on the CPU in f32: `DecoderLM.forward` / `loss` and
every gradient leaf of the xlstm and zamba smoke configs, and the three
cells' forwards alone at their boundaries: `mlstm_forward` (the port's
stabilised parallel form against JAX's scan) at s = 1, 7 and 64 with
gates that saturate, its cell against JAX's `_mlstm_cell` in f64,
`mamba2_forward` below, at and past its chunk, `slstm_forward` across
JAX's `time_chunk`; remat; the launcher.

The same numpy inputs from a seed go to both packages, and the same
weights: drawn with numpy at the JAX specs' distributions (`np_params`:
`jax.random` compiles a kernel per leaf shape, seconds a model) and
carried across with `repro_torch.convert` (zamba's `lora_b`, whose
init is zeros, drawn nonzero so the LoRA term shows).
Tolerances are `tests/test_torch_forward.py`'s: logits 1e-5 of max
|logit|, loss 1e-5 relative, each gradient leaf 1e-4 of its max |g|
plus 1e-7; a cell's output 1e-5 of its max, its gradients as the
leaves'; the mLSTM cell in f64 1e-9 of the max (measured at most
2.6e-12).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import DecoderLM as JaxLM
from repro.models import ssm as jssm
from repro.models.common import is_spec, rms_norm

from repro_torch.convert import from_numpy_tree
from repro_torch.models import DecoderLM
from repro_torch.models import ssm as tssm
from repro_torch.train.adamw import tree_leaves

from test_torch_forward import GRAD_TOL, LOGIT_TOL, _batch, _check, port_cfg


def np_params(specs, seed=0):
    """f32 JAX params of a ParamSpec tree, drawn with numpy at the specs'
    distributions (normal, std `scale` or 1/sqrt(fan_in); zeros; ones);
    every `lora_b` (zeros at init) drawn at std 0.2."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        lora_b = "lora_b" in jax.tree_util.keystr(path)
        if s.init == "zeros" and not lora_b:
            return jnp.zeros(s.shape, jnp.float32)
        if s.init == "ones":
            return jnp.ones(s.shape, jnp.float32)
        if lora_b:
            std = 0.2
        elif s.scale is not None:
            std = s.scale
        else:
            std = 1.0 if s.init == "embed" else 1.0 / np.sqrt(
                max(s.fan_in(), 1))
        return jnp.asarray((std * rng.standard_normal(s.shape))
                           .astype(np.float32))
    return jax.tree_util.tree_map_with_path(leaf, specs, is_leaf=is_spec)


def models(arch_id, **kw):
    """(jax model, jax params, port model, port params requiring grad)
    of an arch's smoke config in f32, remat off, cut or changed by `kw`;
    the params from `np_params`."""
    cfg = jax_get_smoke_config(arch_id).replace(dtype="float32",
                                                 remat=False, **kw)
    jm = JaxLM(cfg)
    jp = np_params(jm.param_specs())
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                         requires_grad=True)
    return jm, jp, DecoderLM(port_cfg(cfg)), tp


@pytest.mark.parametrize("arch_id", ["xlstm-1.3b", "zamba2-7b"])
def test_forward_loss_and_grads_match_jax(arch_id):
    """20 positions: zamba's smoke chunk is 16, so its Mamba2 layers
    carry state across a chunk boundary and pad the second chunk."""
    jm, jp, tm, tp = models(arch_id)
    _check(jm, jp, tm, tp, _batch(jm.cfg, 2, 20))


@pytest.mark.parametrize("arch_id", ["xlstm-1.3b", "zamba2-7b"])
def test_remat_gives_identical_gradients(arch_id):
    _, _, tm, tp = models(arch_id)
    cfg = tm.cfg
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1, 8).items()}
    out = {}
    for remat in (False, True):
        loss = DecoderLM(cfg.replace(remat=remat)).loss(tp, tb)
        out[remat] = [loss] + list(torch.autograd.grad(
            loss, tree_leaves(tp)))
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------------
# the cells alone: values and gradients (x and every parameter)
# ----------------------------------------------------------------------------
def _jax_grads(jfn, jcfg, jp, x, r):
    """JAX's cell output and the gradients of sum(out * r), x's under
    "x"."""
    def jloss(p, xx):
        out = jfn(p, jcfg, xx)
        return jnp.sum(out * r), out
    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    return np.asarray(jout), dict(jg, x=jgx)


def _cell_check(jfn, tfn, jcfg, tcfg, specs, x, edit=None, seed=0,
                reference=_jax_grads, residue=()):
    """out = cell(p, cfg, x) in both packages, then the gradients of
    sum(out * r) for a random r, x's and every parameter's but those
    named in `residue`, against `reference`'s (JAX's by default)."""
    jp = np_params(specs, seed)
    if edit:
        jp = dict(jp, **{k: jnp.asarray(v) for k, v in edit.items()})
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                         requires_grad=True)
    r = np.random.default_rng(seed + 1).standard_normal(
        x.shape).astype(np.float32)
    jout, jg = reference(jfn, jcfg, jp, x, r)
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = tfn(tp, tcfg, tx)
    names = sorted(tp)
    grads = torch.autograd.grad((tout * torch.from_numpy(r)).sum(),
                                [tp[k] for k in names] + [tx])
    np.testing.assert_allclose(tout.detach().numpy(), jout, rtol=0,
                               atol=LOGIT_TOL * np.abs(jout).max())
    for name, g in zip(names + ["x"], grads):
        if name in residue:
            continue
        ref = np.asarray(jg[name])
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=0,
            atol=GRAD_TOL * np.abs(ref).max() + 1e-7, err_msg=name)


def _cfgs(arch_id, **ssm):
    import dataclasses
    jcfg = jax_get_smoke_config(arch_id).replace(dtype="float32")
    jcfg = jcfg.replace(ssm=dataclasses.replace(jcfg.ssm, **ssm))
    return jcfg, port_cfg(jcfg)


def _jax_cell_scan(q, k, v, i_raw, f_raw):
    """JAX's `_mlstm_cell` scanned over s from its zero state (C = 0,
    n = 0, m = -1e30) in q's dtype: (b, s, nh, dh) -> h (b, s, nh, dh)."""
    b, _, nh, dh = q.shape
    state = (jnp.zeros((b, nh, dh, dh), q.dtype),
             jnp.zeros((b, nh, dh), q.dtype),
             jnp.full((b, nh), -1e30, q.dtype))
    _, hs = jax.lax.scan(lambda c, inp: jssm._mlstm_cell(*inp, c), state,
                         tuple(a.swapaxes(0, 1)
                               for a in (q, k, v, i_raw, f_raw)))
    return hs.swapaxes(0, 1)


def _pulled(fn):
    """(args, g) -> (fn(*args), the vjp of cotangent g), as one jit."""
    def both(args, g):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(g)
    return jax.jit(both)


def _f64_cell_grads(jfn, jcfg, jp, x, r):
    """JAX's `mlstm_forward` cut at its cell, with the cell's output and
    backward taken in f64 (`_jax_cell_scan` under x64) and the rest in
    f32: the reference for saturated gates, where JAX's f32 scan's own
    q / k gradients are 1.3e-3 of their max off the f64 ones at s = 64
    (the port's parallel form: 1.4e-6)."""
    di = jssm.mlstm_dims(jcfg)[0]

    def pre(p, xx):
        up = jssm.qmm(xx, p["up_proj"])
        x_m, z = up[..., :di], up[..., di:]
        x_c = jax.nn.silu(jssm._causal_conv(x_m, p["conv_w"], p["conv_b"]))
        return (jssm._mlstm_qkvif(p, jcfg, x_c),
                jax.nn.sigmoid(jssm.qmm(x_m, p["w_o"])), z)

    def post(p, h, o, z):
        h = rms_norm(h.reshape(*h.shape[:2], di), p["hnorm"],
                     jcfg.norm_eps) * o
        return jssm.qmm(h * jax.nn.silu(z), p["down_proj"])

    def f64(tree):
        return tuple(jnp.asarray(np.asarray(a), jnp.float64) for a in tree)

    x = jnp.asarray(x)
    cell_in, o, z = jax.jit(pre)(jp, x)
    with jax.enable_x64(True):
        cell64 = f64(cell_in)
        h = np.asarray(jax.jit(_jax_cell_scan)(*cell64))
    out, (g_post, g_h, g_o, g_z) = _pulled(post)(
        (jp, jnp.asarray(h, jnp.float32), o, z), jnp.asarray(r))
    with jax.enable_x64(True):
        _, g_cell = _pulled(_jax_cell_scan)(cell64, f64([g_h])[0])
        g_cell = tuple(jnp.asarray(np.asarray(g), jnp.float32)
                       for g in g_cell)
    _, (g_pre, g_x) = _pulled(pre)((jp, x), (g_cell, g_o, g_z))
    grads = {k: np.asarray(g_pre[k]) + np.asarray(g_post[k]) for k in jp}
    return np.asarray(out), dict(grads, x=g_x)


# the mLSTM's input / forget gate biases per head: moderate, both gates
# saturated open, both saturated shut (log sigmoid(-25) = -25: the
# stabiliser m runs far below the scores' scale and exp(-m) wins the
# denominator), and mixed
_GATES = {"moderate": ([0.0, 0.5, -0.5, 1.0], [2.0, 0.0, -1.0, 3.0]),
          "saturated": ([12.0, -12.0, 20.0, -6.0], [25.0, -25.0, -25.0,
                                                    25.0])}
# saturated gates: leaves whose gradient is the rounding residue of an
# exact cancellation, measured against `_f64_cell_grads` (max |g|, then
# the port's error over it; the block's largest leaf gradient is 12 to
# 92): b_if sums the input gates' gradients over positions, and a head
# normalised by |sum_j S_tj| does not change under a common shift of
# them (s = 7: 4.8e-4, 7.5e-4; s = 64: 6.2e-4, 6.2e-3); at s = 1 a head
# with its input gate open is q.k v / |q.k| = +-v, with no q or k
# gradient (wq 4.3e-4, 3.2e-3; wk 2.4e-4, 7.1e-3).  The cell's own
# gradients, which these sum, are held in f64 by
# `test_mlstm_cell_matches_the_jax_cell_in_f64`.
_RESIDUE = {1: ("wq", "wk"), 7: ("b_if",), 64: ("b_if",)}


@pytest.mark.parametrize("gates", sorted(_GATES))
@pytest.mark.parametrize("s", [1, 7, 64])
def test_mlstm_forward_matches_the_jax_scan(s, gates):
    """From m = -1e30: the first step's m is its input gate, as JAX's.
    Values and gradients in both regimes: moderate gates against
    `jax.grad` of JAX's `mlstm_forward`; saturated gates against
    `_f64_cell_grads` (JAX's f32 scan is itself 1e-3 off there), every
    leaf but the residue of `_RESIDUE`."""
    jcfg, tcfg = _cfgs("xlstm-1.3b")
    ig, fg = _GATES[gates]
    x = np.random.default_rng(s).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    saturated = gates == "saturated"
    _cell_check(jssm.mlstm_forward, tssm.mlstm_forward, jcfg, tcfg,
                jssm.mlstm_specs(jcfg), x,
                edit={"b_if": np.asarray(ig + fg, np.float32)},
                reference=_f64_cell_grads if saturated else _jax_grads,
                residue=_RESIDUE[s] if saturated else ())


@pytest.mark.parametrize("gates", sorted(_GATES))
@pytest.mark.parametrize("s", [1, 7, 64])
def test_mlstm_cell_matches_the_jax_cell_in_f64(s, gates):
    """The port's `mlstm_parallel` against JAX's `_mlstm_cell` scanned,
    both in f64: h and the gradients of q, k, v and both gates within
    1e-9 of their max (exact arithmetic gives equality); in f32 the
    port's are within GRAD_TOL of the f64 ones.  Gates: the head's bias
    plus N(0, 1)."""
    rng = np.random.default_rng(s)
    b, nh, dh = 2, 4, 16
    q, k, v = (rng.standard_normal((b, s, nh, dh)) for _ in range(3))
    k = k / np.sqrt(dh)
    i_raw, f_raw = (np.asarray(bias) + rng.standard_normal((b, s, nh))
                    for bias in _GATES[gates])
    r = rng.standard_normal(q.shape)
    with jax.enable_x64(True):
        h, grads = _pulled(_jax_cell_scan)(tuple(
            jnp.asarray(a, jnp.float64) for a in (q, k, v, i_raw, f_raw)),
            jnp.asarray(r))
        refs = [np.asarray(a) for a in (h, *grads)]
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, GRAD_TOL)):
        ins = [torch.tensor(a, dtype=dtype, requires_grad=True)
               for a in (q, k, v, i_raw, f_raw)]
        out = tssm.mlstm_parallel(*ins)
        grads = torch.autograd.grad(
            (out * torch.tensor(r, dtype=dtype)).sum(), ins)
        for name, got, ref in zip(("h", "q", "k", "v", "i", "f"),
                                  [out.detach()] + list(grads), refs):
            np.testing.assert_allclose(
                got.double().numpy(), ref, rtol=0,
                atol=tol * np.abs(ref).max() + 1e-12,
                err_msg=f"{name} {dtype}")


@pytest.mark.parametrize("s", [5, 16, 37])
def test_mamba2_forward_below_at_and_past_its_chunk(s):
    """Chunk 16: one short chunk; one whole chunk; three chunks, the
    last padded, the state carried across both boundaries.  Nonzero
    a_log / dt_bias so the decays differ by head."""
    jcfg, tcfg = _cfgs("zamba2-7b")
    nh = jssm.mamba2_dims(jcfg)[1]
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    _cell_check(jssm.mamba2_forward, tssm.mamba2_forward, jcfg, tcfg,
                jssm.mamba2_specs(jcfg), x,
                edit={"a_log": 0.5 * rng.standard_normal(nh),
                      "dt_bias": 0.5 * rng.standard_normal(nh)})


def test_slstm_forward_across_time_chunks():
    """time_chunk 8 over 20 steps: JAX scans three checkpointed chunks
    (the last padded); the port loops straight."""
    jcfg, tcfg = _cfgs("xlstm-1.3b", time_chunk=8)
    x = np.random.default_rng(3).standard_normal(
        (2, 20, jcfg.d_model)).astype(np.float32)
    _cell_check(jssm.slstm_forward, tssm.slstm_forward, jcfg, tcfg,
                jssm.slstm_specs(jcfg), x)


def test_train_launcher_trains_xlstm_on_cpu():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "xlstm-1.3b", "--smoke", "--device", "cpu", "--steps", "2",
         "--seq-len", "16", "--global-batch", "2"],
        capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stderr
    assert "[train] xlstm-smoke" in r.stdout
    assert "done @step 2" in r.stdout
