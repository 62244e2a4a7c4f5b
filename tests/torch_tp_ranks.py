"""What each rank of the 2-rank gloo groups of
tests/test_torch_tp_serving.py, tests/test_torch_tp_moe_mla.py and
tests/test_torch_tp_recurrent.py runs (a module of its own, so a spawned
rank imports torch, numpy and repro_torch, and neither JAX nor the JAX
package).

`rank_main(rank, init, cases, queue)` serves every case of `cases` at
tp = 2 on the CPU and puts (rank, results) on `queue`: each case's
greedy streams and summary, the collectives it ran and its step calls,
the rank's pool and weight shapes, then the page-conservation trials
and the refusals (a deadline, a group of the wrong size, and the MoE,
MLA, recurrent and hybrid families admitted).  `moe_rank_main` does the
same for the MoE and MLA cases, with every leaf's shape on the rank and
the slots the router dropped; `recurrent_rank_main` for the xlstm and
zamba cases, with the rank's arena, its preemptions and the recurrent
families' refusals.  A rank that raises puts (rank, the traceback).

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
                try:
                    eng.submit(ServeRequest(prompt=case["prompts"][0],
                                            deadline_s=1.0))
                except ValueError as e:
                    res["deadline"] = str(e)
        c = cases["conservation"]
        res["conservation"] = conservation(c["arch"], c["params"])
        res["refusals"] = refusals(cases["refused"])
        dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, traceback.format_exc()))


def recurrent_refusals(case):
    """The message of each capability a recurrent engine refuses at tp =
    2 (speculation, the prefix cache, a fork) and of a deadline."""
    model = DecoderLM(port_config(case["arch"]))
    params = from_numpy_tree(case["params"])
    kw = dict(case["serve"], tp=2)
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
    for name, req in (("fork", ServeRequest(prompt=case["prompts"][0],
                                            fork_from=parent)),
                      ("deadline", ServeRequest(prompt=case["prompts"][0],
                                                deadline_s=1.0))):
        try:
            eng.submit(req)
        except ValueError as e:
            out[name] = str(e)
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
