"""`prefill`, `decode_step` and `cache_specs` on a contiguous cache in the
PyTorch port vs the JAX package, on the CPU.

Covered: `cache_specs` shapes and dtypes of all ten archs at full size
(and a zamba with no shared-block group); `decode_step` logits step by
step under teacher forcing, from the zero cache, for one arch of each
kind (qwen2.5; gemma2: window and softcaps, 12 steps past its window of
8; qwen3-moe; deepseek: MLA with a dense first layer, `attn_first`;
xlstm; zamba with nonzero LoRA; musicgen: embedding inputs), with f32
weights and f32 caches, and with packed INT4 weights; `prefill`'s
logits and kv trees; decode from the zero cache ending at `forward`'s
last logits, as `tests/test_models_smoke.py` holds the JAX package;
`gqa_decode` through `ops.decode_attention` (whose plain version the
CPU runs), float and INT4.

The same numpy inputs from a seed go to both packages, and the same
weights (`np_params` of tests/test_torch_recurrent_forward.py), carried
across with `repro_torch.convert`.
Tolerances, relative to the reference's max |value|:
  * STEP_TOL = 1e-5: f32 weights and caches, and INT4 weights with f32
    caches (JAX's fused dequantizing product and the port's `cim_gemv`
    plain version contract the same values in another order).  The port
    writes the fresh K/V row and attends rows <= pos; JAX attends the
    stale rows plus a rank-1 term for the fresh one: equal in exact
    arithmetic.
  * BF16_TOL = 2e-2 for a bf16 cache under f32 activations: the port
    reads the fresh row back rounded to bf16, JAX's rank-1 term keeps it
    in f32.
  * BF16_ROUTE_TOL = 2e-2 for INT4 xlstm against JAX's own route, which
    dequantizes the mLSTM's head-wise q/k/v to bf16 in every step (the
    divergence tests/test_torch_recurrent.py records).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import DecoderLM as JaxLM
from repro.models import attention as jattn
from repro.models.common import spec_structs
from repro.quant.ptq import quantize_params as jax_quantize_params
from repro.quant.qarray import QTensor as JaxQTensor

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.models import DecoderLM, init_params
from repro_torch.models import attention as tattn
from repro_torch.models.common import map_specs

from test_torch_forward import BF16_TOL
from test_torch_model import _to_numpy
from test_torch_recurrent import BF16_ROUTE_TOL, configs, jax_layer
from test_torch_recurrent_forward import models

STEP_TOL = 1e-5
DECODE_ARCHS = ("qwen2.5-3b", "gemma2-27b", "qwen3-moe-235b-a22b",
                "deepseek-v2-lite-16b", "xlstm-1.3b", "zamba2-7b",
                "musicgen-medium")
_PAIRS = {}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _leaves(tree, prefix=""):
    """{path: leaf} of a JAX or port tree (None stays None)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _pair(arch_id, precision="fp"):
    """(jax model, jax params, port model, port params), f32 weights
    (`np_params`: zamba's lora_b nonzero), or INT4 (groups of 16) packed
    by JAX and carried across byte for byte."""
    key = (arch_id, precision)
    if key not in _PAIRS:
        jm, jp, tm, _ = models(arch_id)
        if precision == "int4":       # jitted: eager PTQ takes seconds
            jp = jax.jit(lambda p: jax_quantize_params(p, bits=4,
                                                       group=16))(jp)
        _PAIRS[key] = (jm, jp, tm, from_numpy_tree(_to_numpy(jp)))
    return _PAIRS[key]


def _inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    return {"embeddings": rng.standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)}


def _zeros_jax(jm, b, S, dtype):
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  spec_structs(jm.cache_specs(b, S, dtype)))


def _zeros_port(tm, b, S, dtype):
    return map_specs(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                     tm.cache_specs(b, S, dtype))


def _decode_both(arch_id, precision="fp", kv="f32", steps=12, b=2, S=16):
    """Teacher-forced `decode_step` of both packages from the zero
    cache: each step's logits' error relative to JAX's max |logit|."""
    jm, jp, tm, tp = _pair(arch_id, precision)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[kv]
    jc, tc = _zeros_jax(jm, b, S, jdt), _zeros_port(tm, b, S, tdt)
    inputs = _inputs(jm.cfg, b, steps)
    jstep = jax.jit(jm.decode_step)
    errs = []
    for t in range(steps):
        x = {k: v[:, t:t + 1] for k, v in inputs.items()}
        jl, jc = jstep(jp, jc, {k: jnp.asarray(v) for k, v in x.items()},
                       jnp.int32(t))
        with torch.no_grad():
            tl, out = tm.decode_step(tp, tc, {k: torch.from_numpy(v)
                                              for k, v in x.items()}, t)
        assert out is tc and tl.shape == (b, 1, jm.cfg.vocab)
        errs.append(_rel(tl.numpy(), jl))
    return errs, jc, tc


# ----------------------------------------------------------------------------
# cache_specs
# ----------------------------------------------------------------------------
def _spec_table(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _leaves(tree).items()}


@pytest.mark.parametrize("arch_id", sorted(ARCH_IDS))
def test_cache_specs_equal_jax_at_full_size(arch_id):
    tm = DecoderLM(get_config(arch_id))
    jm = JaxLM(jax_get_config(arch_id))
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        mine = _spec_table(tm.cache_specs(4, 256, tdt))
        ref = {k: (shape, np.dtype(dt).name) for k, (shape, dt) in
               _spec_table(jm.cache_specs(4, 256, jdt)).items()}
        assert mine == ref


def test_cache_specs_of_a_zamba_with_no_group():
    """shared_every past n_layers: JAX keeps a zero-group "mamba"
    stack and an empty "attn" stack; so does the port."""
    jcfg, tcfg = configs("mamba2")
    mine = _spec_table(DecoderLM(tcfg).cache_specs(3, 32))
    ref = {k: (shape, np.dtype(dt).name) for k, (shape, dt) in
           _spec_table(JaxLM(jcfg).cache_specs(3, 32)).items()}
    assert mine == ref


# ----------------------------------------------------------------------------
# decode_step against JAX's
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", DECODE_ARCHS)
def test_decode_step_logits_match_jax(arch_id):
    errs, jc, tc = _decode_both(arch_id)
    assert max(errs) <= STEP_TOL, errs
    # the caches end equal too: rows 0..11 written, state advanced
    j, t = _leaves(jc), _leaves(tc)
    assert set(j) == set(t)
    for k in j:
        assert _rel(t[k].numpy(), j[k]) <= STEP_TOL, k


@pytest.mark.parametrize("arch_id,kv,tol", [
    ("qwen2.5-3b", "f32", STEP_TOL), ("qwen2.5-3b", "bf16", BF16_TOL),
    ("zamba2-7b", "f32", BF16_ROUTE_TOL),
    ("xlstm-1.3b", "f32", BF16_ROUTE_TOL)])
def test_decode_step_logits_match_jax_on_int4_weights(arch_id, kv, tol):
    errs, _, _ = _decode_both(arch_id, "int4", kv, steps=10)
    assert max(errs) <= tol, errs


# ----------------------------------------------------------------------------
# prefill
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", DECODE_ARCHS)
def test_prefill_logits_and_kv_trees_match_jax(arch_id):
    """The last position's logits, and the kv tree: {"attn"[,
    "attn_first"]} of {k, v} or MLA's {c_kv, k_rope} stacked over
    layers, zamba's {"attn"} over its groups, None for xlstm."""
    jm, jp, tm, tp = _pair(arch_id)
    inputs = _inputs(jm.cfg, 2, 11, seed=5)
    jl, jkv = jax.jit(jm.prefill)(jp, {k: jnp.asarray(v)
                                        for k, v in inputs.items()})
    with torch.no_grad():
        tl, tkv = tm.prefill(tp, {k: torch.from_numpy(v)
                                  for k, v in inputs.items()})
    assert tl.shape == jl.shape == (2, 1, jm.cfg.vocab)
    assert _rel(tl.numpy(), jl) <= STEP_TOL
    if jkv is None:
        assert tkv is None
        return
    j, t = _leaves(jkv), _leaves(tkv)
    assert sorted(j) == sorted(t) and j
    for k in j:
        assert tuple(t[k].shape) == j[k].shape, k
        assert _rel(t[k].numpy(), j[k]) <= STEP_TOL, k


# ----------------------------------------------------------------------------
# decode from the zero cache ends at forward's last logits (port only)
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", sorted(ARCH_IDS))
def test_decode_from_zero_cache_matches_forward(arch_id):
    """The tolerances of tests/test_models_smoke.py: 1e-3, MoE archs
    5e-2 (tokens may be dropped at capacity in the full forward)."""
    cfg = get_smoke_config(arch_id).replace(dtype="float32", remat=False)
    tm = DecoderLM(cfg)
    params = init_params(tm.param_specs(), torch.Generator().manual_seed(0),
                         "cpu", dtype_override=torch.float32)
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(cfg, 2, 16).items()}
    cache = _zeros_port(tm, 2, 16, torch.float32)
    with torch.no_grad():
        full = tm.forward(params, inputs)
        for t in range(16):
            logits, cache = tm.decode_step(
                params, cache, {k: v[:, t:t + 1] for k, v in inputs.items()},
                torch.tensor(t, dtype=torch.int32))
    tol = 5e-2 if cfg.moe is not None else 1e-3
    assert float((logits[:, 0] - full[:, -1]).abs().max()) < tol


# ----------------------------------------------------------------------------
# gqa_decode: the flash_decode route
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["fp", "int4"])
def test_gqa_decode_goes_through_decode_attention(precision, monkeypatch):
    """Layer 0 of qwen2.5's smoke config at pos 9 of a cache whose rows
    0..8 hold random values: output and the written rows against JAX's
    `gqa_decode`, and one `ops.decode_attention` call."""
    jm, jp, tm, tp = _pair("qwen2.5-3b", precision)
    jl = jax.tree_util.tree_map(lambda a: jax_layer(a, 1),
                                jp["blocks"]["attn"],
                                is_leaf=lambda a: isinstance(a, JaxQTensor))
    tl = tm._stack_views(tp["blocks"], "blocks")[0]["attn"]
    cfg = jm.cfg
    rng = np.random.default_rng(2)
    shape = (2, 16, cfg.n_kv_heads, cfg.hd())
    k0, v0 = (np.where(np.arange(16)[None, :, None, None] < 9,
                       rng.standard_normal(shape), 0).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jout, jcache = jattn.gqa_decode(jl, cfg, jnp.asarray(x),
                                    {"k": jnp.asarray(k0),
                                     "v": jnp.asarray(v0)},
                                    jnp.int32(9), jnp.bool_(False))
    calls = []
    real = tattn.decode_attention
    monkeypatch.setattr(tattn, "decode_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    pos = torch.tensor(9, dtype=torch.int32)
    rope = tattn.forward_ropes(tm.cfg, pos.reshape(1), [False])[
        tm.cfg.rope_theta]
    tcache = {"k": torch.from_numpy(k0.copy()),
              "v": torch.from_numpy(v0.copy())}
    tout = tattn.gqa_decode(tl, tm.cfg, torch.from_numpy(x), tcache, pos,
                            rope)
    assert calls == [1]
    assert _rel(tout.numpy(), jout) <= STEP_TOL
    for k in ("k", "v"):
        assert _rel(tcache[k].numpy(), jcache[k]) <= STEP_TOL
