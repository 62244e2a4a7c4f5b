"""PyTorch port vs the JAX package, on the CPU in f32: the full-sequence
forward, the loss and its gradients (`DecoderLM.forward` / `loss`), for
the smoke configs of the eight transformer archs.

The same numpy inputs from a seed go to both; weights are drawn by the
JAX package and carried across with `repro_torch.convert`.  Tolerances:
  * logits: 1e-5 of max |logit| (sum order; the f32 products of the two
    frameworks differ by ulps);
  * loss: 1e-5 relative;
  * every gradient leaf: 1e-4 of the leaf's max |g| plus 1e-7 (the
    backward sums more terms, in another order);
  * bf16 (weights and activations): 2e-2, two bf16 ulps (2^-8 each) of
    rounding where the frameworks round a product differently.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import DecoderLM as JaxLM
from repro.models import cross_entropy_loss as jax_ce
from repro.models import init_params as jax_init

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import DecoderLM, init_params
from repro_torch.models import attention as tattn
from repro_torch.models import config as tconfig
from repro_torch.serve import PagedServeEngine, ServeConfig
from repro_torch.train.adamw import tree_leaves

TRANSFORMERS = ("qwen2.5-3b", "gemma3-4b", "gemma2-27b", "phi3-medium-14b",
                "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b", "pixtral-12b",
                "musicgen-medium")
RECURRENT = ("xlstm-1.3b", "zamba2-7b")
LOGIT_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def port_cfg(cfg):
    """The port's ModelConfig with the fields of a JAX one (sub-configs
    as the port's classes of the same names)."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tconfig, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return tconfig.ModelConfig(**kw)


def _models(cfg, dtype="float32", param_dtype=jnp.float32, **kw):
    """(jax model, jax params, port model, port params requiring grad)
    for a config of either package, cut or changed by `kw`."""
    cfg = jax_get_smoke_config(cfg) if isinstance(cfg, str) else cfg
    cfg = cfg.replace(dtype=dtype, remat=False, **kw)
    jm = JaxLM(cfg)
    jp = jax_init(jm.param_specs(), jax.random.PRNGKey(0),
                  dtype_override=param_dtype)
    tm = DecoderLM(port_cfg(cfg))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                         requires_grad=True)
    return jm, jp, tm, tp


def _batch(cfg, b, s, seed=0):
    """numpy inputs: tokens or frontend-stub embeddings, and labels with
    one ignored position."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, 0] = -100
    if cfg.embed_inputs:
        inputs = {"tokens": rng.integers(0, cfg.vocab, (b, s))
                  .astype(np.int32)}
    else:
        inputs = {"embeddings": rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)}
    return dict(inputs, labels=labels)


def _jax_run(jm, jp, batch):
    """JAX's logits, loss and gradients in one jit, one forward
    (`jm.loss` is the cross entropy of `jm.forward`)."""
    def fn(p, bt):
        logits = jm.forward(p, bt)
        return jax_ce(logits, bt["labels"]), logits
    (loss, logits), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        jp, jax.tree_util.tree_map(jnp.asarray, batch))
    return (np.asarray(logits, np.float32), float(loss),
            [np.asarray(g, np.float32)
             for g in jax.tree_util.tree_leaves(grads)])


def _port_run(tm, tp, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = tm.forward(tp, tb)
    loss = tm.loss(tp, tb)
    grads = torch.autograd.grad(loss, tree_leaves(tp), allow_unused=True)
    return (logits.float().numpy(), float(loss.detach()),
            [np.zeros(p.shape, np.float32) if g is None
             else g.float().numpy() for p, g in zip(tree_leaves(tp), grads)])


def _check(jm, jp, tm, tp, batch, logit_tol=LOGIT_TOL, loss_tol=LOSS_TOL,
           grad_tol=GRAD_TOL):
    jl, jloss, jg = _jax_run(jm, jp, batch)
    tl, tloss, tg = _port_run(tm, tp, batch)
    assert tl.shape == jl.shape and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0,
                               atol=logit_tol * np.abs(jl).max())
    assert abs(tloss - jloss) <= loss_tol * abs(jloss), (tloss, jloss)
    names = _paths(jp)
    assert names == _paths(tp) and len(tg) == len(jg)
    for name, a, b in zip(names, tg, jg):
        np.testing.assert_allclose(
            a, b, rtol=0, atol=grad_tol * np.abs(b).max() + 1e-7,
            err_msg=name)


# ----------------------------------------------------------------------------
# per transformer arch
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", TRANSFORMERS)
def test_forward_loss_and_grads_match_jax(arch_id):
    """Logits, loss and every gradient leaf; 20 positions, past the
    gemma smoke configs' window of 8; pixtral and musicgen are fed
    embeddings (their configs take no tokens)."""
    jm, jp, tm, tp = _models(arch_id)
    _check(jm, jp, tm, tp, _batch(jm.cfg, 2, 20))


@pytest.mark.parametrize("arch_id", ("pixtral-12b", "musicgen-medium"))
def test_copied_configs_equal_jax_field_for_field(arch_id):
    for mine, ref in ((get_config(arch_id), jax_get_config(arch_id)),
                      (get_smoke_config(arch_id),
                       jax_get_smoke_config(arch_id))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


# ----------------------------------------------------------------------------
# single cases
# ----------------------------------------------------------------------------
def test_remat_gives_identical_gradients():
    """deepseek's smoke config: MLA, a dense first layer, routed and
    shared experts; each layer recomputed in the backward."""
    cfg = get_smoke_config("deepseek-v2-lite-16b").replace(dtype="float32")
    _, _, _, tp = _models("deepseek-v2-lite-16b")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 12).items()}
    out = {}
    for remat in (False, True):
        model = DecoderLM(cfg.replace(remat=remat))
        loss = model.loss(tp, tb)
        out[remat] = [loss] + list(torch.autograd.grad(
            loss, tree_leaves(tp)))
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


def test_windowed_layers_past_the_window():
    """gemma2's smoke config (every other layer local, window 8) at 40
    positions matches JAX, and the window changes the logits."""
    jm, jp, tm, tp = _models("gemma2-27b")
    batch = _batch(jm.cfg, 1, 40, seed=1)
    _check(jm, jp, tm, tp, batch)
    tb = {"tokens": torch.from_numpy(batch["tokens"])}
    with torch.no_grad():
        windowed = tm.forward(tp, tb)
        unwindowed = DecoderLM(tm.cfg.replace(local_window=0)).forward(tp,
                                                                       tb)
    assert torch.equal(windowed[:, :8], unwindowed[:, :8])
    assert (windowed[:, 9:] - unwindowed[:, 9:]).abs().max() > 1e-3


def test_query_blocks_past_q_chunk():
    """One tiny layer over 2100 positions: two query blocks (2048 + 52)
    in the port, a padded scan of two in JAX."""
    cfg = jax_get_smoke_config("qwen2.5-3b").replace(
        n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, head_dim=8,
        d_ff=32, vocab=32)
    assert 2100 > tattn.Q_CHUNK
    jm, jp, tm, tp = _models(cfg)
    _check(jm, jp, tm, tp, _batch(jm.cfg, 1, 2100))


def test_bf16_forward_loss_and_grads_match_jax():
    """bf16 weights (the specs' dtype) and bf16 activations."""
    jm, jp, tm, tp = _models("qwen2.5-3b", dtype="bfloat16",
                             param_dtype=None)
    assert tp["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    _check(jm, jp, tm, tp, _batch(jm.cfg, 2, 16), logit_tol=BF16_TOL,
           loss_tol=BF16_TOL, grad_tol=BF16_TOL)


# ----------------------------------------------------------------------------
# every registered arch at full size (specs only)
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", sorted(ARCH_IDS))
def test_full_configs_count_jax_params(arch_id):
    """And the recurrent families' forward runs (their smoke configs:
    finite logits of the expected shape)."""
    tm = DecoderLM(get_config(arch_id))
    assert tm.n_params() == JaxLM(jax_get_config(arch_id)).n_params()
    if arch_id in RECURRENT:
        sm = DecoderLM(get_smoke_config(arch_id).replace(dtype="float32"))
        params = init_params(sm.param_specs(),
                             torch.Generator().manual_seed(0), "cpu",
                             dtype_override=torch.float32)
        with torch.no_grad():
            logits = sm.forward(params, {"tokens": torch.zeros(
                1, 3, dtype=torch.long)})
        assert logits.shape == (1, 3, sm.cfg.vocab)
        assert torch.isfinite(logits).all()


# ----------------------------------------------------------------------------
# serving refuses frontend-stub archs, with the JAX package's wording
# ----------------------------------------------------------------------------
def test_engine_refuses_embedding_inputs():
    tm = DecoderLM(get_smoke_config("musicgen-medium"))
    with pytest.raises(ValueError, match="engine serves token-input models"):
        PagedServeEngine(tm, {}, ServeConfig(max_seq=32, page_size=8),
                         device="cpu")


def test_serve_launcher_refuses_embedding_inputs():
    with pytest.raises(SystemExit, match="pixtral-12b takes frontend-stub "
                       "embeddings; the token engine serves token-input "
                       "archs"):
        serve_main(["--arch", "pixtral-12b", "--smoke", "--device", "cpu"])
