"""The serving steps of the PyTorch port can be captured in CUDA graphs,
checked on the CPU.

  * Every step function the engine and the drafter call (`serve_step`
    for a prefill chunk and a decode step, `paged_verify_step`, a draft
    model's `paged_step`) runs under a dispatch mode that fails on a
    host read, an op whose output shape depends on data, and a tensor
    made from Python or numpy values: a stream capture refuses the
    first and the last, and a graph cannot hold the second.
  * The static-shape page-row write (`attention.page_rows`: all b * s
    rows, padding rows into the dump page) leaves the pools exactly as
    the earlier `nonzero` write did and as the JAX package's
    `_page_scatter(..., mode="drop")` does, from the same numpy inputs.
  * The dump page is never named by a table and never read.
  * `serve.graphs.StepRunner` on the CPU: the same static buffers, the
    same logits as direct calls.

The card half (capture, replay, bitwise-equal replays) is in
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models.attention import _page_scatter as jax_page_scatter

from repro_torch.models import DecoderLM, ModelConfig, MoEConfig, init_params
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.quant.ptq import quantize_params
from repro_torch.serve import (PagedServeEngine, ServeConfig, ServeRequest,
                               StepRunner)
from repro_torch.spec import SpecConfig

aten = torch.ops.aten

SMOKE = dict(name="graphs-smoke", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
             qkv_bias=True, tie_embeddings=True, dtype="float32",
             remat=False)
DRAFT = dict(SMOKE, name="graphs-draft", n_layers=1, d_model=32, n_heads=2,
             n_kv_heads=1, d_ff=64)
# gemma's features: local / global layers with two RoPE bases, softcaps,
# QK-norm, post-block norms, scaled embeddings, the unfused GELU FFN
GEMMA = dict(SMOKE, name="graphs-gemma", n_layers=3, qkv_bias=False,
             ffn_act="gelu_tanh", local_window=4, local_pattern=3,
             qk_norm=True, rope_theta=1e6, rope_theta_local=1e4,
             attn_softcap=1.0, final_softcap=2.0, post_block_norm=True,
             rms_scale_plus_one=True, embed_scale=True)
# MoE: routed experts (the onehot dispatch's slots, capacity 8 a step),
# a shared expert and a leading dense layer with its own pools
MOE = dict(SMOKE, name="graphs-moe", family="moe", n_layers=3,
           qkv_bias=False, qk_norm=True,
           moe=MoEConfig(n_experts=8, top_k=2, n_shared_experts=1,
                         d_ff_expert=96, dispatch="onehot",
                         first_dense_layers=1, first_dense_d_ff=128))
KV = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
_MODELS = {}


def _model(arch, precision):
    key = (arch["name"], precision)
    if key not in _MODELS:
        model = DecoderLM(ModelConfig(**arch))
        params = init_params(model.param_specs(),
                             torch.Generator().manual_seed(0), "cpu",
                             torch.float32)
        if precision == "int4":
            params = quantize_params(params, bits=4, group=128)
        _MODELS[key] = (model, params)
    return _MODELS[key]


def _pools(model, n_pages, ps, kv):
    return {name: {k: torch.zeros(v.shape, dtype=v.dtype)
                   for k, v in pools.items()}
            for name, pools in model.paged_cache_specs(n_pages, ps,
                                                       KV[kv]).items()}


# ----------------------------------------------------------------------------
# no host read, no data-dependent shape, no tensor from host values
# ----------------------------------------------------------------------------
HOST_READS = {aten._local_scalar_dense, aten.item, aten.equal,
              aten.is_nonzero}
DYNAMIC_SHAPES = {aten.nonzero, aten.masked_select, aten._unique,
                  aten._unique2, aten.unique_dim, aten.unique_consecutive,
                  aten.unique_dim_consecutive}
HOST_VALUES = {aten.lift_fresh, aten.lift_fresh_copy}
INDEXING = {aten.index, aten.index_put, aten.index_put_,
            aten._index_put_impl_}


class CaptureGuard(TorchDispatchMode):
    """Fails on what a CUDA graph cannot hold: a read of a device value
    to the host, an op whose output shape depends on data (boolean
    masks as indices too), and a tensor made from Python or numpy
    values (`torch.tensor`, `torch.from_numpy`: a copy from pageable
    host memory on the card)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = func.overloadpacket
        kind = ("a host read" if op in HOST_READS else
                "a data-dependent shape" if op in DYNAMIC_SHAPES else
                "a tensor from host values" if op in HOST_VALUES else None)
        if op in INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                            torch.uint8)
                for i in (args[1] or ())):
            kind = "a data-dependent shape (boolean index)"
        if kind is not None:
            raise AssertionError(f"{func} in a step: {kind}")
        return func(*args, **(kwargs or {}))


STEPS = [("serve_step", 8), ("serve_step", 1), ("paged_verify_step", 5),
         ("paged_step", 8), ("paged_step", 1)]


@pytest.mark.parametrize("arch,precision,kv", [
    (SMOKE, "int4", "int8"), (DRAFT, "fp", "bf16"), (GEMMA, "int4", "int8"),
    (MOE, "int4", "int8"), (MOE, "fp", "bf16")])
@pytest.mark.parametrize("fn,s", STEPS)
def test_steps_are_capturable(fn, s, arch, precision, kv):
    """The engine's steps (int4 weights, int8 KV), a draft model's (float
    weights, bf16 KV), a gemma-style model's and a MoE model's (the
    router's sort, the dispatch's counts and scatters, the expert-stack
    products), with an empty lane beside two live ones."""
    model, params = _model(arch, precision)
    pools = _pools(model, 12, 4, kv)
    tables = torch.tensor([[0, 0, 0, 0], [3, 7, 0, 9], [5, 1, 2, 4]],
                          dtype=torch.int32)
    lengths = torch.tensor([0, 6, 3], dtype=torch.int32)
    n_new = torch.tensor([0, s, max(1, s - 2)], dtype=torch.int32)
    tokens = torch.arange(3 * s, dtype=torch.int32).reshape(3, s) % 100
    step = getattr(model, fn)
    with CaptureGuard():
        logits, _ = step(params, pools, {"tokens": tokens}, tables,
                         lengths, n_new)
    assert logits.shape == (3, s, arch["vocab"])
    assert bool(torch.isfinite(logits).all())


def _nonzero_page_rows(tables, lengths, n_new, s, page_size,
                       dump_page=None):
    """The earlier write: only the real rows, picked with `nonzero` (a
    host sync and a data-dependent shape)."""
    max_pages = tables.shape[1]
    pos = torch.arange(s, dtype=lengths.dtype)
    slots = lengths[:, None] + pos[None, :]
    idx = (slots // page_size).clamp(max=max_pages - 1).long()
    page = tables.long().gather(1, idx)
    flat = page * page_size + (slots % page_size).long()
    valid = pos[None, :] < n_new[:, None]
    src = valid.reshape(-1).nonzero().squeeze(1)
    rows = tattn.PageRows(slots=slots, dst=flat.reshape(-1)[src])
    rows.src = src
    return rows


def _nonzero_page_scatter(pool, vals, rows):
    flat = pool.view(-1, *pool.shape[2:])
    src = vals.reshape(-1, *vals.shape[2:])[rows.src]
    flat.index_copy_(0, rows.dst, src.to(pool.dtype))


def test_guard_catches_the_nonzero_page_rows():
    """The guard has teeth: the earlier write fails under it."""
    args = (torch.zeros(2, 3, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
            torch.tensor([2, 0], dtype=torch.int32), 4, 4)
    with pytest.raises(AssertionError, match="nonzero"):
        with CaptureGuard():
            _nonzero_page_rows(*args)
    with CaptureGuard():
        tattn.page_rows(*args, dump_page=9)


# ----------------------------------------------------------------------------
# the page-row write: the earlier nonzero path and JAX's dropped scatter
# ----------------------------------------------------------------------------
PS, MAX_PAGES, N_PAGES = 4, 4, 9
# lane 0 is empty (table all zeros, n_new 0) beside lane 1, which owns
# page 0; lane 1's chunk crosses two page boundaries; lane 2 ends
# mid-page
TABLES = np.array([[0, 0, 0, 0], [6, 0, 3, 8], [2, 5, 0, 0]], np.int32)
WRITES = [(8, [0, 7, 2], [0, 3, 5]),          # (s, n_new, lengths)
          (1, [0, 1, 1], [0, 10, 7])]


def _write(kind, pools, vals_np, s, n_new, lengths, write):
    """One step's K/V rows into torch pools (k, and for int8 the
    scales) through `write` = (page_rows, page_scatter)."""
    rows_fn, scatter = write
    rows = rows_fn(torch.from_numpy(TABLES), torch.from_numpy(lengths),
                   torch.from_numpy(n_new), s, PS, dump_page=N_PAGES)
    if kind == "int8":
        q, sc = tattn._quantize_kv_rows(torch.from_numpy(vals_np))
        scatter(pools["k"], q, rows)
        scatter(pools["k_scale"], sc, rows)
        return {"k": q.numpy(), "k_scale": sc.numpy()}
    scatter(pools["k"], torch.from_numpy(vals_np), rows)
    return {"k": vals_np}


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
def test_page_row_write_matches_nonzero_path_and_jax(kind):
    """A prefill chunk, then a decode step: the static-shape write
    (padding rows into the dump page) leaves pages 0..n_pages-1 exactly
    as the earlier nonzero write and as JAX's `_page_scatter(...,
    mode="drop")` do; rows no step wrote keep their contents."""
    rng = np.random.default_rng(0)
    g, hd = 2, 8
    tdt = KV[kind]
    jdt = {"int8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}[kind]
    init = rng.integers(-100, 100, (N_PAGES, PS, g, hd))
    base = {"k": torch.from_numpy(init).to(tdt)}
    if kind == "int8":
        base["k_scale"] = torch.from_numpy(
            rng.random((N_PAGES, PS, g))).to(torch.float16)
    dump = {k: torch.full((1, *v.shape[1:]), 7, dtype=v.dtype)
            for k, v in base.items()}
    new = {k: torch.cat([v, dump[k]]) for k, v in base.items()}
    old = {k: v.clone() for k, v in base.items()}
    jpools = {k: jnp.asarray(v.to(torch.float32).numpy()).astype(
        jnp.float16 if k == "k_scale" else jdt) for k, v in base.items()}
    for s, n_new, lengths in WRITES:
        n_new = np.asarray(n_new, np.int32)
        lengths = np.asarray(lengths, np.int32)
        vals = rng.standard_normal((3, s, g, hd)).astype(np.float32)
        written = _write(kind, new, vals, s, n_new, lengths,
                         (tattn.page_rows, tattn._page_scatter))
        _write(kind, old, vals, s, n_new, lengths,
               (_nonzero_page_rows, _nonzero_page_scatter))
        slots = lengths[:, None] + np.arange(s)[None, :]
        for k, v in written.items():
            jpools[k] = jax_page_scatter(jpools[k], jnp.asarray(v),
                                         jnp.asarray(TABLES),
                                         jnp.asarray(slots),
                                         jnp.asarray(n_new))
    for k in base:
        assert new[k].shape[0] == N_PAGES + 1
        got = new[k][:N_PAGES]
        assert torch.equal(got, old[k]), k
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(jpools[k], np.float32))
        assert not torch.equal(got, base[k]), "nothing was written"


def test_dump_page_is_never_read():
    """Poisoning the dump page moves no logit of a prefill chunk, a
    decode step or a verify window (float pools: NaN; int8: NaN
    scales)."""
    for precision, kv in (("int4", "int8"), ("fp", "f32")):
        model, params = _model(SMOKE, precision)
        outs = []
        for poison in (False, True):
            pools = _pools(model, 8, 4, kv)
            if poison:
                for leaf in pools["attn"].values():
                    if leaf.is_floating_point():
                        leaf[:, 8] = float("nan")
            tables = torch.tensor([[0, 0, 0, 0], [3, 0, 5, 1]],
                                  dtype=torch.int32)
            got = []
            for fn, s, n_new, ln in (("serve_step", 8, [0, 7], [0, 0]),
                                     ("serve_step", 1, [0, 1], [0, 7]),
                                     ("paged_verify_step", 5, [0, 3],
                                      [0, 8])):
                tok = torch.arange(2 * s).reshape(2, s) * 5 % 128
                lg, _ = getattr(model, fn)(
                    params, pools, {"tokens": tok}, tables,
                    torch.tensor(ln, dtype=torch.int32),
                    torch.tensor(n_new, dtype=torch.int32))
                got.append(lg[1])
            outs.append(got)
        for a, b in zip(*outs):
            assert bool(torch.isfinite(b).all())
            assert torch.equal(a, b)


def test_engine_tables_never_name_the_dump_page():
    """Every table the engine and a draft model hand to a step names
    only the allocator's pages; the pools hold one page more."""
    model, params = _model(SMOKE, "int4")
    draft, dparams = _model(DRAFT, "fp")
    seen = []

    class Recording(StepRunner):
        def __call__(self, fn, params, pools, tokens, tables, lengths,
                     n_new, marks=None):
            seen.append((pools["attn"]["k"].shape[1], int(tables.max())))
            return super().__call__(fn, params, pools, tokens, tables,
                                    lengths, n_new, marks)

    eng = PagedServeEngine(model, params, ServeConfig(
        precision="int4", max_batch=2, max_seq=32, page_size=4,
        prefill_chunk=8), spec=SpecConfig(
            k=3, drafter="model", draft_model=draft, draft_params=dparams,
            draft_page_size=4), device="cpu")
    eng.runner = eng.spec.drafter.runner = Recording("cpu")
    motif = np.array([5, 9, 3, 17], np.int32)
    reqs = [ServeRequest(prompt=np.tile(motif, n), max_new_tokens=6)
            for n in (2, 3, 1)]
    eng.run(reqs)
    assert all(len(r.out_tokens) == 6 for r in reqs)
    assert eng.verify_calls > 0 and eng.spec.drafter.decode_calls > 0
    n_pages = {eng.cache.allocator.n_pages,
               eng.spec.drafter.cache.allocator.n_pages}
    assert {p for p, _ in seen} == {n + 1 for n in n_pages}
    assert all(t < p - 1 for p, t in seen)


def test_serve_steps_leave_pools_as_the_nonzero_path(monkeypatch):
    """A prefill chunk and a decode step through the model: the same
    logits and the same pages as with the earlier nonzero write."""
    model, params = _model(SMOKE, "int4")
    tables = torch.tensor([[0, 0, 0, 0], [4, 0, 6, 2], [1, 3, 0, 0]],
                          dtype=torch.int32)
    plan = [(8, [0, 7, 2], [0, 3, 5]), (1, [0, 1, 1], [0, 10, 7])]
    runs = []
    for write in ("static", "nonzero"):
        if write == "nonzero":
            monkeypatch.setattr(tmodel, "page_rows", _nonzero_page_rows)
            monkeypatch.setattr(tattn, "_page_scatter",
                                _nonzero_page_scatter)
        pools = _pools(model, 7, 4, "int8")
        logits = []
        for s, n_new, ln in plan:
            tok = torch.arange(3 * s).reshape(3, s) * 3 % 128
            lg, _ = model.serve_step(params, pools, {"tokens": tok}, tables,
                                     torch.tensor(ln, dtype=torch.int32),
                                     torch.tensor(n_new, dtype=torch.int32))
            logits.append(lg)
        runs.append((logits, pools["attn"]))
    (lg_a, pa), (lg_b, pb) = runs
    for a, b in zip(lg_a, lg_b):
        assert torch.equal(a, b)
    for k in pa:
        assert torch.equal(pa[k][:, :7], pb[k][:, :7]), k


# ----------------------------------------------------------------------------
# StepRunner on the CPU
# ----------------------------------------------------------------------------
def test_runner_on_cpu_matches_direct_calls():
    """Two calls of one shape with other inputs give the logits of
    direct calls, through one set of static buffers; other pools, or an
    input of another shape, for that step raise."""
    model, params = _model(SMOKE, "int4")
    runner = StepRunner("cpu")
    assert not runner.graphs
    pools = _pools(model, 8, 4, "int8")
    direct = _pools(model, 8, 4, "int8")
    tables = np.array([[0, 0, 0, 0], [3, 0, 5, 1]], np.int32)
    calls = [([0, 8], [0, 0], 8), ([0, 4], [0, 8], 8), ([0, 1], [0, 12], 1),
             ([0, 1], [0, 13], 1)]
    for n_new, ln, s in calls:
        tok = (np.arange(2 * s, dtype=np.int32).reshape(2, s) * (s + 3)
               + ln[1]) % 128
        args = [np.asarray(a, np.int32) for a in (n_new, ln)]
        got = runner(model.serve_step, params, pools, tok, tables,
                     args[1], args[0])
        want, _ = model.serve_step(params, direct, {
            "tokens": torch.from_numpy(tok)}, torch.from_numpy(tables),
            torch.from_numpy(args[1]), torch.from_numpy(args[0]))
        assert torch.equal(got, want)
    assert [(st["fn"], st["shape"]) for st in runner.steps()] == [
        ("graphs-smoke.serve_step", [2, 8]),
        ("graphs-smoke.serve_step", [2, 1])]
    for k in pools["attn"]:
        assert torch.equal(pools["attn"][k], direct["attn"][k])
    with pytest.raises(ValueError, match="other params or pools"):
        runner(model.serve_step, params, direct, tok, tables, args[1],
               args[0])
    with pytest.raises(ValueError, match="input"):
        runner(model.serve_step, params, pools, tok, tables[:, :2],
               args[1], args[0])
