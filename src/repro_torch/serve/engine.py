"""Paged-KV continuous-batching serve engine (PyTorch port of
`repro.serve.engine.PagedServeEngine`).

  allocator  (paged_cache.BlockAllocator) — refcounted free-list over KV
                                            pages (prefix cache / fork,
                                            copy-on-write)
  prefix     (prefix.PrefixIndex)         — radix trie over committed
                                            prompt pages
  scheduler  (scheduler.Scheduler)        — admission, priority,
                                            deadlines, chunked prefill
  engine     (this file)                  — dynamic batch against the
                                            paged pool, preemption,
                                            cancel, fork
  telemetry  (telemetry.Telemetry)        — TTFT/TPOT/queue percentiles

The decode state is the JAX engine's unified per-layer state: attention
layers keep paged KV pages, recurrent layers (Mamba2 conv + SSM state,
m/sLSTM cells) fixed per-lane slots in a `StateArena` (serve/state.py).
Both go to `DecoderLM.serve_step` as one dict of their leaves, so
admission, chunked prefill, sampling, deadlines and preemption are the
same for every family; hybrid zamba keeps paged attention pools and
arena slots in one lane.  For a family with no attention layer (xlstm)
`PagedKVCache` holds no pools and serves only as the token-budget
ledger that gates admission, growth and preemption.

Every step runs at most one chunked batch-prefill call (b = max_batch,
s = prefill_chunk) and one decode call (b = max_batch, s = 1) through
`DecoderLM.serve_step`, which writes the KV pools and the arena in
place.  Greedy lanes take an argmax on the device; only (b,) tokens
cross to the host.
Built with a `repro_torch.spec.SpecConfig`, the decode call becomes one
`paged_verify_step` (b = max_batch, s = k + 1) that verifies a drafted
window and emits a variable number of tokens per lane (speculative
decoding, see repro_torch/spec/); a step where nothing was drafted
takes the plain (b, 1) decode call.

Every model step goes through a `graphs.StepRunner`, the counterpart of
the JAX engine's `_jit_step`: on the card each (step, shape) is captured
once as a CUDA graph and replayed after; `eager=True` asks for eager
execution instead (for comparisons).  The greedy argmax and sampling
stay outside the graph, on the engine's `torch.Generator`.

Observability, as in the JAX engine: every lifecycle event (submit,
admit, finish, preempt, reject, cancel) lands in an always-on
`FlightRecorder` and, when the process tracer is enabled, in the tracer
as an instant; each phase records a `prefill_chunk`, `decode_step` or
`spec_verify` event and span (`spec_draft` too), and an `EnergyMeter`
charges every served token its EdgeCIM cost (the `sim_*` keys of
`summary()`: cost-model output, not a measurement).  A phase's span
starts before its model call and ends when the sampled tokens (or the
verify logits) reach the host.  A replayed CUDA graph runs
asynchronously until that copy, so unlike the JAX engine's spans, which
cover the jitted dispatch, the port's include the device's work.  The
port splits each model call further, into spans of category "step"
that the JAX engine does not record (`graphs.CallMarks`):
`step_inputs`, `step_replay` and `step_sample`, each with the device's
time between CUDA events at the same marks.  All spans are stamped by
the tracer's clock (`Tracer.now`).

Prefix caching, forks (parallel sampling) and speculative decoding act
on attention KV pages alone: a model with recurrent state layers cannot
adopt, clone or roll back that state, so asking for one raises a
ValueError naming the capability (`capability_error`, JAX's wording);
`prefix_cache=None` means on iff the model is fully paged.  A preempted
pure-recurrent lane snapshots its arena slot to the host and resumes
from it; a hybrid lane re-prefills (prompt + generated), as in JAX.

Runs on CUDA unless the caller passes `device="cpu"` (the plain PyTorch
versions of the kernels, run eagerly).  On the card each engine owns a
CUDA stream (`self.stream`) and runs every step on it, so engines that
share the card (fleet replicas, one driver thread each) never wait for
each other's work: a phase that must see its device work done
synchronizes that stream, not the device.

Tensor parallelism (`ServeConfig.tp > 1`), the counterpart of the JAX
engine's `_shard_runtime_state`: the engine runs in each of `tp` ranks
of a torch.distributed group (`dist.shard.serve_group`), takes the full
params and keeps its rank's slice of every leaf (`dist.shard.shard_tree`
by the specs' logical axes) or params that are the rank's slices
already (another replica's `params`, kept with no copy:
`dist.shard.rank_params`), and allocates its pools at n_kv_heads / tp
heads (MLA's latent pools whole).  Block tables, refcounts, the
scheduler and the prefix trie stay host-side and the same on every
rank; every step runs under `dist.shard.use_tp` (the all-reduces after
`wo` and `w_down`, one after each MoE layer's experts, the
vocab-parallel embedding, the logits gathered in rank order), so every
rank samples from the same logits with the same seeded generator.
Rank 0 leads the group (`dist.lockstep`): it reads the clock for every
scheduling decision (a request's enqueue stamp, the `now` a step admits
and expires deadlines at; `_preempt`'s reading goes to a resubmit, which
keeps the first stamp) and applies every call that changes the engine's
state (`submit`, `cancel`, `drain_queued`); each step call it sends one
tick with its clock reading and those calls, and the other ranks take
the same step at that reading, never at their own clock's.  Where every
rank makes the same calls (`run`, the offline launcher) a follower's
`step()` takes the tick's enqueue stamps for the requests it submitted
itself; behind the gateway only rank 0 is called, and the others replay
its ticks (`dist.lockstep.follow`, `replay`, `step_at`).  A MoE rank
runs its n_experts / tp experts of every stack on the global routing
(`ffn.moe_ffn`); an MLA rank its n_heads / tp heads over the whole
latent pools (`attention.mla_paged_step`).  The recurrent and hybrid
families (xlstm, zamba) take their cells' leaves and their StateArena
by the split table (`dist.shard.recurrent_splits`): Mamba2 and mLSTM
cells on the rank's heads, the sLSTM cell whole with its FFN split
(`models/ssm.py`); each rank resets, snapshots and restores its own
slice of a lane, on the same scheduling decisions.  The steps run
eagerly: the gloo group's collectives go through the host and cannot
be captured in a CUDA graph.  A model drafter stays whole on every
rank.  Every family the JAX
engine serves at tp > 1 is served, deadlines and priorities as at tp =
1.  An engine takes torch.distributed's default group unless it is
given its own (`group`, `tick_group`: `dist.shard.replica_groups`, one
pair a fleet replica).  At tp = 1 there is no tick and no collective.
Sliding-window / softcap models (gemma2, gemma3), MoE models (qwen3-moe)
and MLA models (deepseek) are served like any dense model;
`kv_dtype="auto"` gives them INT8 pools too, as in the JAX engine, but
for MLA, whose latent pools stay float: there "auto" pins bf16 into
`self.config` and an explicit "int8" raises.

`ServeEngine` + `Request` remain as the seed-API shim over this engine,
and the engine's pre-`ServeConfig` keyword arguments (`max_batch=...,
kv_dtype=...`) keep working with a `DeprecationWarning`, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.dist.lockstep import STEP, Lockstep, LockstepError
from repro_torch.dist.shard import (rank_params, recurrent_splits,
                                    serve_group, shard_state_specs, use_tp)
from repro_torch.models.common import tree_to
from repro_torch.obs.energy import EnergyMeter
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import get_tracer
from repro_torch.quant.ptq import quantize_params
from repro_torch.quant.qarray import QTensor, dequant_counters

from .config import ServeConfig
from .graphs import CallMarks, StepRunner
from .paged_cache import PagedKVCache
from .prefix import PrefixIndex
from .sampling import SamplingParams, processed_probs, sample_tokens
from .scheduler import Scheduler, ServeRequest
from .state import StateArena
from .telemetry import Telemetry

# attention-only capability guards: one message source for the engine
# and the launcher, so the policy and its wording cannot drift apart
_CAPABILITY_REASONS = {
    "speculative-decoding": "verify/rollback cannot rewind",
    "prefix-cache": "page adoption cannot reproduce",
    "parallel-sampling": "forked KV pages cannot clone",
}


def capability_error(model, capability: str) -> str:
    return (f"capability {capability!r} requires a paged-attention-only "
            f"model; family {model.cfg.family!r} carries recurrent "
            f"per-lane state that {_CAPABILITY_REASONS[capability]}")


_UNSET = object()
_legacy_warned = False      # deprecation shim warns once per process

_KV_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32",
                   torch.int8: "int8"}


def _config_from_legacy(max_batch, max_seq, page_size, n_pages,
                        prefill_chunk, kv_dtype, eos_id, seed,
                        prefix_cache) -> ServeConfig:
    """Map the pre-ServeConfig kwargs onto a ServeConfig (fp precision:
    the old engine always served float weights)."""
    kv = "bf16" if kv_dtype is _UNSET else _KV_DTYPE_NAMES[kv_dtype]
    return ServeConfig(
        precision="fp", kv_dtype=kv,
        max_batch=8 if max_batch is _UNSET else max_batch,
        max_seq=256 if max_seq is _UNSET else max_seq,
        page_size=16 if page_size is _UNSET else page_size,
        n_pages=None if n_pages is _UNSET else n_pages,
        prefill_chunk=16 if prefill_chunk is _UNSET else prefill_chunk,
        eos_id=None if eos_id is _UNSET else eos_id,
        seed=0 if seed is _UNSET else seed,
        prefix_cache=None if prefix_cache is _UNSET else prefix_cache)


def _fields(req: ServeRequest) -> Dict[str, Any]:
    """What a follower needs to rebuild a submitted request (a tick's
    submit op): its own fields, the fork parent as an engine id."""
    s = req.sampling
    return dict(prompt=np.asarray(req.prompt, np.int32),
                max_new_tokens=req.max_new_tokens, rid=req.rid,
                priority=req.priority, deadline_s=req.deadline_s,
                sampling=(s.temperature, s.top_k, s.top_p), spec=req.spec,
                logprobs=req.logprobs, trace_id=req.trace_id,
                fork_from=(req.fork_from.eid if req.fork_from is not None
                           else None))


def _has_qtensor(tree: Any) -> bool:
    if isinstance(tree, dict):
        return any(_has_qtensor(v) for v in tree.values())
    return isinstance(tree, QTensor)


class PagedServeEngine:
    def __init__(self, model, params: Any,
                 config: Optional[ServeConfig] = None, *,
                 max_batch=_UNSET, max_seq=_UNSET, page_size=_UNSET,
                 n_pages=_UNSET, prefill_chunk=_UNSET, kv_dtype=_UNSET,
                 eos_id=_UNSET, seed=_UNSET, prefix_cache=_UNSET,
                 spec: Optional[Any] = None, device=None,
                 eager: bool = False, clock=time.monotonic,
                 group=None, tick_group=None):
        legacy = {k: v for k, v in [
            ("max_batch", max_batch), ("max_seq", max_seq),
            ("page_size", page_size), ("n_pages", n_pages),
            ("prefill_chunk", prefill_chunk), ("kv_dtype", kv_dtype),
            ("eos_id", eos_id), ("seed", seed),
            ("prefix_cache", prefix_cache)] if v is not _UNSET}
        if config is None:
            if legacy:
                global _legacy_warned
                if not _legacy_warned:
                    _legacy_warned = True
                    warnings.warn(
                        "PagedServeEngine(max_batch=..., kv_dtype=..., ...)"
                        " kwargs are deprecated; pass a"
                        " serve.ServeConfig instead",
                        DeprecationWarning, stacklevel=2)
            config = _config_from_legacy(
                max_batch, max_seq, page_size, n_pages, prefill_chunk,
                kv_dtype, eos_id, seed, prefix_cache)
        elif legacy:
            raise ValueError(
                "pass either a ServeConfig or legacy kwargs, not both: "
                + ", ".join(sorted(legacy)))
        if (config.kv_dtype == "auto"
                and config.resolved_kv_dtype() == torch.int8
                and model.cfg.attn_kind == "mla"):
            # "auto" is the best supported: MLA's latent pools stay float
            # (attention.paged_cache_spec refuses int8), so it resolves to
            # bf16, pinned into the config as the JAX engine pins it; an
            # explicit kv_dtype="int8" raises there
            config = dataclasses.replace(config, kv_dtype="bf16")
        if not model.cfg.embed_inputs:
            raise ValueError("engine serves token-input models")
        # tensor parallelism: the dims first, then the group, so a
        # misconfigured tp fails before anything is built
        self.group = None
        self.lockstep: Optional[Lockstep] = None
        if config.tp > 1:
            model.validate_tp(config.tp)
            self.group = group if group is not None else \
                serve_group(config.tp)
            if dist.get_world_size(self.group) != config.tp:
                raise ValueError(
                    f"tp={config.tp} needs a group of {config.tp} ranks, "
                    f"got one of {dist.get_world_size(self.group)}")
            # rank 0 leads: a follower's clock is rank 0's last reading
            self.lockstep = Lockstep(self.group, clock, tick_group)
            clock = self.lockstep.clock
        self.config = config
        self.device = resolve_device(device)
        max_batch, max_seq = config.max_batch, config.max_seq
        page_size, n_pages = config.page_size, config.n_pages
        if max_seq % page_size:
            raise ValueError(f"max_seq {max_seq} must be a multiple of "
                             f"page_size {page_size}")
        if spec is not None and not model.supports_paged():
            raise ValueError(capability_error(model,
                                              "speculative-decoding"))
        prefix_cache = config.prefix_cache
        if prefix_cache is None:        # auto: on iff fully paged
            prefix_cache = model.supports_paged()
        elif prefix_cache and not model.supports_paged():
            raise ValueError(capability_error(model, "prefix-cache"))
        params = tree_to(params, self.device)
        if config.quantized() and not _has_qtensor(params):
            # the precision field is authoritative: quantize float params
            params = quantize_params(params, bits=config.weight_bits(),
                                     group=config.quant_group)
        if self.group is not None:      # full: sharded; the rank's: kept
            params = rank_params(params, model.param_specs(),
                                 dist.get_rank(self.group), config.tp,
                                 splits=recurrent_splits(model.cfg,
                                                         config.tp))
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = config.eos_id
        self._clock = clock
        if n_pages is None:      # dense-equivalent worst case: never OOM
            n_pages = max_batch * (max_seq // page_size)
        kv_dtype = config.resolved_kv_dtype()
        state_specs = model.decode_state_specs(max_batch, n_pages,
                                               page_size, kv_dtype)
        if self.group is not None:      # the rank's kv heads, its arena
            state_specs = shard_state_specs(state_specs, model.cfg,
                                            config.tp)
        self.cache = PagedKVCache(model, n_pages, page_size, max_seq,
                                  kv_dtype, specs=state_specs["paged"],
                                  device=self.device)
        self.arena: Optional[StateArena] = (
            StateArena(model, max_batch, specs=state_specs["arena"],
                       device=self.device)
            if model.has_recurrent_state() else None)
        # what every step call reads and writes in place: the pools, and
        # the arena's leaves beside them (their keys are disjoint); one
        # dict for the engine's life, as the captured graphs hold it
        self.state = self.cache.pools
        if self.arena is not None:
            self.state = {**self.cache.pools, **self.arena.state}
        self.prefix: Optional[PrefixIndex] = None
        if prefix_cache:
            self.prefix = PrefixIndex(self.cache.allocator, page_size)
            self.cache.prefix_index = self.prefix
        self.scheduler = Scheduler(
            max_batch, prefill_chunk=min(config.prefill_chunk, max_seq))
        self.telemetry = Telemetry()
        # observability: the process tracer (opt-in), the always-on
        # flight recorder, and the CIM energy meter (simulated J and
        # tokens/J in summary()) charging at the served precision
        self.tracer = get_tracer()
        self.scheduler.tracer = self.tracer
        self.recorder = FlightRecorder(label="engine", clock=clock)
        self._followed: Dict[int, ServeRequest] = {}    # replayed, by eid
        self.energy = EnergyMeter(
            model.cfg, w_bits=config.weight_bits(),
            a_bits=8 if config.quantized() else 16, tp=config.tp)
        self._cow_seen = 0          # deltas -> cow_copy / prefix_evict
        self._evict_seen = 0        # trace instants per step
        self.lanes: List[Optional[ServeRequest]] = [None] * max_batch
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.runner = StepRunner(self.device,
                                 eager=eager or self.group is not None)
        self._traced: Optional[CallMarks] = None    # a traced call's marks
        # the model's steps; at tp > 1 each runs its collectives on the
        # group (one wrapper per step, so the runner keys it stably)
        self._serve_fn = self._on_group(model.serve_step)
        # the engine's own stream: every step runs on it, after the work
        # that built the pools and the arena on the caller's stream
        self.stream: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self.prefill_calls = 0      # model step calls, by phase
        self.decode_calls = 0
        self.verify_calls = 0
        self._next_eid = 0
        self.spec = None
        if spec is not None:        # SpecConfig -> speculative decode
            from repro_torch.spec import SpecDecoder
            self.spec = SpecDecoder(model, spec, max_batch=max_batch,
                                    max_seq=max_seq, kv_dtype=kv_dtype,
                                    device=self.device, runner=self.runner)
            # the verify window runs the same sharded layout as decode;
            # a draft model's steps stay outside the group, whole
            self.spec.verify_fn = self._on_group(self.spec.verify_fn)

    def _on_group(self, fn):
        """`fn` with its collectives on the engine's group (`fn` itself
        at tp = 1)."""
        if self.group is None:
            return fn
        group = self.group

        @functools.wraps(fn)
        def step(*args):
            with use_tp(group):
                return fn(*args)
        return step

    # ------------------------------------------------------------------
    def _event(self, kind: str, **fields: Any) -> None:
        """One engine lifecycle event: always lands in the flight
        recorder, mirrored to the tracer as an instant when tracing is
        on."""
        self.recorder.record(kind, **fields)
        if self.tracer.enabled:
            self.tracer.instant(kind, cat="engine", **fields)

    # ------------------------------------------------------------------
    @property
    def n_running(self) -> int:
        return sum(r is not None for r in self.lanes)

    @property
    def busy(self) -> bool:
        return self.n_running > 0 or self.scheduler.n_queued > 0

    def submit(self, req: ServeRequest) -> None:
        """Queue `req`.  At tp > 1 rank 0 records it for the next tick; a
        follower that submits itself (every rank making the same calls)
        queues it at its last tick's reading, and the next tick re-keys
        it at rank 0's stamp before the step admits."""
        if req.fork_from is not None and not self.model.supports_paged():
            raise ValueError(capability_error(self.model,
                                              "parallel-sampling"))
        now = self._clock()
        self._submit(req, now)
        if self.lockstep is not None and self.lockstep.leader:
            self.lockstep.record(("submit", req.eid, now, _fields(req)))

    def _submit(self, req: ServeRequest, now: float) -> None:
        req.eid = self._next_eid      # rid is the caller's label and may
        self._next_eid += 1           # collide; eid keys cache/telemetry
        self.telemetry.enqueue(req.eid, now)
        self.scheduler.submit(req, now)
        self._event("submit", eid=req.eid, rid=req.trace_id,
                    prompt_len=req.prompt_len)

    def cancel(self, eid: int) -> bool:
        """Abort a submitted request wherever it is — queued,
        mid-prefill, mid-decode, or preempted (its arena snapshot dies
        with it).  Frees its KV pages (decref: pages shared with the
        prefix trie or a fork survive) and its lane.  False when `eid`
        is unknown or already done."""
        if self._cancel(eid):
            if self.lockstep is not None:
                self.lockstep.record(("cancel", eid))
            return True
        return False

    def _cancel(self, eid: int) -> bool:
        now = self._clock()
        queued = self.scheduler.cancel(eid)
        if queued is not None:
            queued.done = True
            queued.saved_state = None
            self.telemetry.cancel(eid, now)
            self._event("cancel", eid=eid, rid=queued.trace_id,
                        where="queued")
            return True
        for lane, req in enumerate(self.lanes):
            if req is not None and req.eid == eid:
                req.done = True
                req.cancelled = True
                self._free_lane(lane, eid)
                self.telemetry.cancel(eid, now)
                self._event("cancel", eid=eid, rid=req.trace_id,
                            where="lane", lane=lane)
                return True
        return False

    def drain_queued(self) -> List[ServeRequest]:
        """The fleet drain: pull every queued request that has not
        started (`Scheduler.drain_queue`) and forget its telemetry trace
        (it re-enqueues where it lands).  Rank 0 records it for the next
        tick."""
        pulled = self.scheduler.drain_queue()
        for req in pulled:
            self.telemetry.forget(req.eid)
        if self.lockstep is not None:
            self.lockstep.record(("drain",))
        return pulled

    def replay(self, ops: List[tuple]) -> None:
        """A follower applies rank 0's ops of one tick in order: each
        submit as a request of its own (at rank 0's stamp, its fork
        parent found by eid), each cancel and drain as rank 0 did."""
        for op in ops:
            if op[0] == "submit":
                _, eid, stamp, f = op
                if eid != self._next_eid:
                    raise LockstepError(f"rank 0 submitted eid {eid} where "
                                        f"this rank's next is "
                                        f"{self._next_eid}")
                req = ServeRequest(
                    prompt=f["prompt"], max_new_tokens=f["max_new_tokens"],
                    rid=f["rid"], priority=f["priority"],
                    deadline_s=f["deadline_s"],
                    sampling=SamplingParams(*f["sampling"]),
                    spec=f["spec"], logprobs=f["logprobs"],
                    trace_id=f["trace_id"],
                    fork_from=self._followed.get(f["fork_from"]))
                self._submit(req, stamp)
                self._followed[eid] = req
            elif op[0] == "cancel":
                self._cancel(op[1])
            else:
                self.drain_queued()
        self._followed = {e: r for e, r in self._followed.items()
                          if not r.done}

    def run(self, requests: List[ServeRequest]) -> List[ServeRequest]:
        for r in requests:
            self.submit(r)
        while self.busy:
            self.step()
        return requests

    # ------------------------------------------------------------------
    def _free_lane(self, lane: int, eid: int) -> None:
        """Release a request's pages, its lane and the drafter's state
        for that lane."""
        self.cache.release(eid)
        self.lanes[lane] = None
        if self.spec is not None:
            self.spec.drafter.release(lane)

    def _dispatch(self, tokens: np.ndarray, tables: np.ndarray,
                  lengths: np.ndarray, n_new: np.ndarray,
                  step_fn=None) -> torch.Tensor:
        """One model step call (`serve_step` unless `step_fn` is given)
        through the runner; the pools and the arena are updated in
        place.  The logits are the step's static output: every use of
        them ends before the next call of the same step."""
        return self.runner(step_fn or self._serve_fn, self.params,
                           self.state, tokens, tables, lengths, n_new,
                           self._traced)

    def _open_call(self, t0: float, phase: str, samples: bool, fn,
                   shape) -> None:
        """Open a traced model call's marks at `t0` (`graphs.CallMarks`:
        the call of `fn` on tokens of `shape`)."""
        self._traced = self.runner.marks(fn, shape)
        self._traced.open(self.tracer, t0, phase, samples)

    def _close_call(self, t_end: float) -> None:
        """After the call's own sync, at `t_end`: its step spans."""
        self._traced.close(t_end)
        self._traced = None

    def _drop_call(self) -> None:
        """A call that raised: close its open range, record no spans."""
        if self._traced is not None:
            self._traced.abort()
            self._traced = None

    def _tables(self) -> np.ndarray:
        tab = np.zeros((self.max_batch, self.cache.max_pages), np.int32)
        for i, req in enumerate(self.lanes):
            if req is not None:
                tab[i] = self.cache.table_for(req.eid)
        return tab

    def _lengths(self) -> np.ndarray:
        ln = np.zeros(self.max_batch, np.int32)
        for i, req in enumerate(self.lanes):
            if req is not None:
                ln[i] = self.cache.seqs[req.eid].length
        return ln

    def _sample_rows(self, rows: torch.Tensor) -> np.ndarray:
        """rows: (max_batch, vocab) on the device -> (max_batch,) host
        tokens under each lane's sampling params."""
        temp = np.zeros(self.max_batch, np.float32)
        topk = np.zeros(self.max_batch, np.int32)
        topp = np.ones(self.max_batch, np.float32)
        for i, req in enumerate(self.lanes):
            if req is not None:
                temp[i] = req.sampling.temperature
                topk[i] = req.sampling.top_k
                topp[i] = req.sampling.top_p
        toks = sample_tokens(self.generator, rows, temp, topk, topp)
        if self._traced is not None:
            self._traced.end_sample()
        return toks.cpu().numpy()

    def _emit(self, req: ServeRequest, token: int, now: float,
              decode: bool = True, row=None) -> None:
        req.out_tokens.append(token)
        if req.logprobs and row is not None:
            req.out_logprobs.append(
                self._logprob_entropy(row, token, req.sampling))
        self.telemetry.token(req.eid, now, decode=decode)
        if req.on_token is not None:
            req.on_token(req.rid, token)

    @staticmethod
    def _logprob_entropy(row: torch.Tensor, token: int,
                         sampling: SamplingParams):
        """(logprob, entropy) of `token` under the processed sampling
        distribution the token was drawn from (host-side, O(vocab))."""
        p = processed_probs(row.float().cpu().numpy(), sampling.temperature,
                            sampling.top_k, sampling.top_p)
        pt = float(p[token])
        nz = p[p > 0.0]
        ent = float(-np.sum(nz * np.log(nz)) + 0.0) if nz.size else 0.0
        return (float(np.log(max(pt, 1e-12))), ent)

    def _maybe_finish(self, lane: int, now: float) -> None:
        req = self.lanes[lane]
        seq = self.cache.seqs[req.eid]
        hit_eos = (self.eos_id is not None and req.out_tokens
                   and req.out_tokens[-1] == self.eos_id)
        if (len(req.out_tokens) >= req.max_new_tokens or hit_eos
                or seq.length >= self.max_seq):
            req.done = True
            self.telemetry.done(req.eid, now)
            self._event("finish", eid=req.eid, rid=req.trace_id,
                        lane=lane, tokens=len(req.out_tokens),
                        reason="eos" if hit_eos else "budget")
            if self.prefix is not None and seq.length > req.prompt_len:
                # generated-suffix caching: commit the full pages past the
                # prompt too (materialized tokens run to seq.length; the
                # final emitted token was never fed back)
                full = np.concatenate(
                    [np.asarray(req.prompt, np.int32),
                     np.asarray(req.out_tokens[req.prompt_folded:],
                                np.int32)])[:seq.length]
                self.prefix.insert(full, seq.pages)
            self._free_lane(lane, req.eid)

    def _preempt(self, lane: int) -> None:
        """Pool exhausted: evict this lane and requeue it.

        A pure-recurrent family snapshots the lane's arena slot to the
        host (constant size, exact) and resumes from it on re-admission
        without re-prefilling a token.  A family with attention layers
        loses its KV pages, so it requeues with (prompt + generated since
        the last fold) as its new prompt and rebuilds by prefill (a
        hybrid's restored Mamba2 state would be advanced twice by that
        rebuild, hence no snapshot)."""
        req = self.lanes[lane]
        self._event("preempt", eid=req.eid, rid=req.trace_id, lane=lane,
                    tokens=len(req.out_tokens))
        if self.arena is not None and self.model.n_paged_layers() == 0:
            req.saved_state = self.arena.save_lane(lane)
            req.saved_length = self.cache.seqs[req.eid].length
            req.saved_prefill_done = req.prefill_done
        else:
            req.prompt = np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(req.out_tokens[req.prompt_folded:], np.int32)])
            req.prompt_folded = len(req.out_tokens)
            req.prefill_done = 0
        req.fork_from = None
        req.forked_tokens = 0
        self._free_lane(lane, req.eid)
        self.scheduler.submit(req, self._clock(), resubmit=True)

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One engine step.  At tp > 1 rank 0 reads its clock and sends
        the tick; a follower receives it, takes its enqueue stamps, and
        steps at its reading."""
        ls = self.lockstep
        if ls is None:
            now = self._clock()
        elif ls.leader:
            now = self._clock()
            ls.send(now, STEP)
        else:
            tick = ls.recv()
            if tick.flags != STEP:
                raise LockstepError(f"rank 0 sent flags {tick.flags} where "
                                    f"this rank steps with it")
            stamps = {op[1]: op[2] for op in tick.ops if op[0] == "submit"}
            self.scheduler.restamp(stamps)
            for eid, t in stamps.items():
                trace = self.telemetry.traces.get(eid)
                if trace is not None:
                    trace.t_enqueue = t
            now = tick.now
        self.step_at(now)

    def step_at(self, now: float) -> None:
        """One step at clock reading `now`, on this engine's stream."""
        if self.stream is None:
            self._step(now)
            return
        with torch.cuda.stream(self.stream):     # this engine's stream
            self._step(now)

    def _step(self, now: float) -> None:
        def _reject(r: ServeRequest) -> None:
            self.telemetry.done(r.eid, now)
            self._event("reject", eid=r.eid, rid=r.trace_id,
                        reason=r.reject_reason, truncated=r.truncated)

        for req in self.scheduler.admit(
                now, self.n_running, self.cache, on_reject=_reject):
            lane = self.lanes.index(None)
            self.lanes[lane] = req
            self.telemetry.admit(req.eid, now)
            self._event("fork_admit" if req.fork_from is not None
                        else "admit",
                        eid=req.eid, rid=req.trace_id, lane=lane,
                        prompt_len=req.prompt_len,
                        prefix_cached=req.prefix_cached,
                        resumed=req.saved_state is not None)
            if self.arena is not None:
                if req.saved_state is not None:
                    # a resumed preemption: the host snapshot goes back
                    # and the lane picks up exactly where it left off
                    self.arena.restore_lane(lane, req.saved_state)
                    self.cache.seqs[req.eid].length = req.saved_length
                    req.prefill_done = req.saved_prefill_done
                    req.saved_state = None
                else:       # a fresh admission never inherits a dead
                    self.arena.reset_lane(lane)     # lane's state
            if req.fork_from is not None:
                self.telemetry.fork(req.forked_tokens)
            elif self.prefix is not None:
                self.telemetry.prefix(req.prefix_cached)

        prefill_s = self._prefill_phase()
        if self.spec is not None:
            decode_s, decode_lanes = self._decode_phase_spec()
        else:
            decode_s, decode_lanes = self._decode_phase()
        # page-sharing machinery reports deltas, not per-call hooks:
        # surface them as per-step instants when tracing
        evicted = self.prefix.pages_evicted if self.prefix is not None else 0
        if self.tracer.enabled:
            if self.cache.cow_copies > self._cow_seen:
                self.tracer.instant(
                    "cow_copy", cat="engine",
                    n=self.cache.cow_copies - self._cow_seen)
            if evicted > self._evict_seen:
                self.tracer.instant("prefix_evict", cat="engine",
                                    n=evicted - self._evict_seen)
        self._cow_seen = self.cache.cow_copies
        self._evict_seen = evicted
        # arena slots are engine lanes 1:1, so slot fill is running lanes
        # over max_batch, sampled only when an arena exists
        state_occ = (self.n_running / self.max_batch
                     if self.arena is not None else None)
        self.telemetry.step(self.cache.occupancy(), self.n_running,
                            decode_s=decode_s, prefill_s=prefill_s,
                            decode_lanes=decode_lanes,
                            state_occupancy=state_occ,
                            family=self.model.cfg.family)

    def _prefill_phase(self) -> float:
        """One chunked batch prefill call for every lane with prompt
        tokens left; lanes finishing their prompt sample their first
        output token from this call's logits.  Returns the call's
        seconds, sampling included."""
        pre = [i for i, r in enumerate(self.lanes)
               if r is not None and r.prefill_remaining > 0]
        if not pre:
            return 0.0
        s = self.scheduler.prefill_chunk
        tokens = np.zeros((self.max_batch, s), np.int32)
        n_new = np.zeros(self.max_batch, np.int32)
        finishing = False
        for i in list(pre):
            req = self.lanes[i]
            q = self.scheduler.prefill_quota(req)
            # a forked / resubmitted lane may start mid-page on a shared
            # page: copy-on-write it before the chunk lands
            if not self.cache.prepare_write(req.eid, q):
                self._preempt(i)
                pre.remove(i)
                continue
            tokens[i, :q] = req.prompt[req.prefill_done:req.prefill_done + q]
            n_new[i] = q
            finishing |= q == req.prefill_remaining
        if not pre:
            return 0.0
        t0 = self.tracer.now()
        if self.tracer.enabled:
            self._open_call(t0, "prefill", finishing, self._serve_fn,
                            tokens.shape)
        try:
            logits = self._dispatch(tokens, self._tables(), self._lengths(),
                                    n_new)
            self.prefill_calls += 1
            if finishing:   # only sample when some lane ends its prompt
                idx = torch.from_numpy(
                    np.maximum(n_new - 1, 0).astype(np.int64))
                last = logits[torch.arange(self.max_batch),
                              idx.to(logits.device)]
                nxt = self._sample_rows(last)
            elif self.stream is not None:     # this engine's work only
                self.stream.synchronize()
        except BaseException:
            self._drop_call()
            raise
        t1 = self.tracer.now()
        if self._traced is not None:
            self._close_call(t1)
        dt = t1 - t0
        now = self._clock()
        chunk_rids = [self.lanes[i].trace_id for i in pre]
        chunk_tokens = 0
        for i in pre:
            req = self.lanes[i]
            q = int(n_new[i])
            req.prefill_done += q
            chunk_tokens += q
            self.cache.seqs[req.eid].length += q
            self.telemetry.prefill_tokens += q
            if req.prefill_remaining == 0:
                if self.prefix is not None:
                    self.prefix.insert(np.asarray(req.prompt, np.int32),
                                       self.cache.seqs[req.eid].pages)
                self._emit(req, int(nxt[i]), now, decode=False,
                           row=last[i] if req.logprobs else None)
                self._maybe_finish(i, now)
        self.energy.charge_prefill(chunk_tokens)
        self.recorder.record("prefill_chunk", lanes=len(pre),
                             tokens=chunk_tokens, dur_s=dt)
        if self.tracer.enabled:
            self.tracer.complete(
                "prefill_chunk", t0, dt, cat="engine",
                rids=chunk_rids, lanes=len(pre), tokens=chunk_tokens)
        return dt

    def _decode_ready(self) -> List[int]:
        return [i for i, r in enumerate(self.lanes)
                if r is not None and r.prefill_remaining == 0
                and r.out_tokens]

    def _decode_phase(self) -> tuple:
        """One token for every decode-ready lane.  Returns (seconds of
        the call with sampling, lanes advanced)."""
        ready = []
        for i in self._decode_ready():
            req = self.lanes[i]
            # this call writes the lane's KV row at position seq.length
            # (prepare_write also copy-on-writes a shared tail page)
            if not self.cache.prepare_write(req.eid, 1):
                self._preempt(i)
                continue
            ready.append(i)
        if not ready:
            return 0.0, 0
        tokens = np.zeros((self.max_batch, 1), np.int32)
        n_new = np.zeros(self.max_batch, np.int32)
        for i in ready:
            tokens[i, 0] = self.lanes[i].out_tokens[-1]
            n_new[i] = 1
        t0 = self.tracer.now()
        if self.tracer.enabled:
            self._open_call(t0, "decode", True, self._serve_fn, tokens.shape)
        try:
            lens = self._lengths()
            logits = self._dispatch(tokens, self._tables(), lens, n_new)
            self.decode_calls += 1
            nxt = self._sample_rows(logits[:, 0, :])
        except BaseException:
            self._drop_call()
            raise
        t1 = self.tracer.now()
        if self._traced is not None:
            self._close_call(t1)
        dt = t1 - t0
        now = self._clock()
        rids = [self.lanes[i].trace_id for i in ready]
        self.energy.charge_decode(len(ready), float(lens[ready].mean()))
        self.recorder.record("decode_step", lanes=len(ready), dur_s=dt)
        if self.tracer.enabled:
            self.tracer.complete("decode_step", t0, dt, cat="engine",
                                 rids=rids, lanes=len(ready))
        for i in ready:
            req = self.lanes[i]
            self.cache.seqs[req.eid].length += 1
            self._emit(req, int(nxt[i]), now,
                       row=logits[i, 0] if req.logprobs else None)
            self._maybe_finish(i, now)
        return dt, len(ready)

    def _decode_phase_spec(self) -> tuple:
        """Speculative decode: draft up to k tokens per lane, verify the
        whole window in ONE `paged_verify_step` call (always (max_batch,
        k + 1) wide), emit the accepted prefix plus the bonus token, and
        trim the rejected rows' pages.

        Lanes with `req.spec == False`, or whose drafter found nothing,
        ride the same call with an empty window: for them it IS a plain
        decode step, so greedy output equals the non-speculative
        engine's.  Returns (seconds from drafting until the verify
        logits reach the host, lanes advanced); the `spec_draft` span
        covers drafting, `spec_verify` the call with the acceptance
        walk."""
        spec = self.spec
        k = spec.cfg.k              # verify width: always k + 1; autok
        k_draft = spec.current_k()  # narrows only what is drafted
        dec = self._decode_ready()
        if not dec:
            return 0.0, 0

        histories: List[Optional[np.ndarray]] = [None] * self.max_batch
        smp: List[Optional[SamplingParams]] = [None] * self.max_batch
        for i in dec:
            req = self.lanes[i]
            if req.spec:
                # out_tokens past the preemption fold cursor: a resumed
                # request's prompt already holds the earlier ones
                histories[i] = np.concatenate(
                    [np.asarray(req.prompt, np.int32),
                     np.asarray(req.out_tokens[req.prompt_folded:],
                                np.int32)])
                smp[i] = req.sampling
        # drafting counts toward the decode time speculation spends
        t0 = self.tracer.now()
        prop = spec.drafter.propose(histories, k_draft, smp)
        draft_s = self.tracer.now() - t0

        tokens = np.zeros((self.max_batch, k + 1), np.int32)
        n_new = np.zeros(self.max_batch, np.int32)
        ready: List[tuple] = []                 # (lane, n_draft)
        for i in dec:
            req = self.lanes[i]
            nd = int(prop.n[i]) if histories[i] is not None else 0
            # the window writes 1 + nd KV rows and may emit 1 + nd
            # tokens: cap at the sequence and the request's token
            # budgets, then shrink until the pool holds it (a shrunk
            # window beats a preemption)
            nd = max(0, min(nd,
                            self.max_seq
                            - self.cache.seqs[req.eid].length - 1,
                            req.max_new_tokens - len(req.out_tokens) - 1))
            while nd > 0 and not self.cache.prepare_write(req.eid, 1 + nd):
                nd -= 1
            if nd == 0 and not self.cache.prepare_write(req.eid, 1):
                self._preempt(i)
                continue
            tokens[i, 0] = req.out_tokens[-1]
            tokens[i, 1:1 + nd] = prop.tokens[i, :nd]
            n_new[i] = 1 + nd
            ready.append((i, nd))
        if not ready:       # nothing decoded: no decode time either
            return 0.0, 0
        lengths = self._lengths()

        # nothing drafted anywhere: the (b, k + 1) window would spend
        # (k + 1)x the decode compute on a plain step, so take (b, 1)
        plain = all(nd == 0 for _, nd in ready)
        t1 = self.tracer.now()
        if self.tracer.enabled:     # sampled: the logits' cast and copy
            if plain:
                self._open_call(t1, "decode", True, self._serve_fn,
                                (self.max_batch, 1))
            else:
                self._open_call(t1, "verify", True, spec.verify_fn,
                                tokens.shape)
        try:
            if plain:
                logits = self._dispatch(tokens[:, :1], self._tables(),
                                        lengths, n_new)
                self.decode_calls += 1
            else:
                logits = self._dispatch(tokens, self._tables(), lengths,
                                        n_new, step_fn=spec.verify_fn)
                self.verify_calls += 1
            rows = logits.float()
            if self._traced is not None:
                self._traced.end_sample()
            logits_np = rows.cpu().numpy()
        except BaseException:
            self._drop_call()
            raise
        t2 = self.tracer.now()
        if self._traced is not None:
            self._close_call(t2)
        dt = t2 - t0
        now = self._clock()
        drafted = accepted = n_emitted = 0
        lanes_idx = [i for i, _ in ready]
        rids = [self.lanes[i].trace_id for i in lanes_idx]
        for i, nd in ready:
            req = self.lanes[i]
            q_rows = prop.probs[i, :nd] if prop.probs is not None else None
            n_acc, emitted = spec.accept(
                logits_np[i, :nd + 1], tokens[i, 1:1 + nd], q_rows,
                req.sampling)
            drafted += nd
            accepted += n_acc
            seq = self.cache.seqs[req.eid]
            seq.length += n_acc + 1             # keep input + accepted rows
            self.cache.trim(req.eid, seq.length)  # free rejected pages
            if self.eos_id is not None and self.eos_id in emitted:
                emitted = emitted[:emitted.index(self.eos_id) + 1]
            budget = req.max_new_tokens - len(req.out_tokens)
            # emitted[j] came from verify-logits row j
            for j, tok in enumerate(emitted[:budget]):
                self._emit(req, tok, now,
                           row=logits[i, j] if req.logprobs else None)
                n_emitted += 1
            self._maybe_finish(i, now)
        self.telemetry.spec(drafted, accepted)
        spec.observe(drafted, accepted)
        verify_s = self.tracer.now() - t1
        self.energy.charge_decode(
            n_emitted, float(lengths[lanes_idx].mean()))
        self.recorder.record("spec_verify", lanes=len(ready),
                             drafted=drafted, accepted=accepted,
                             dur_s=dt)
        if self.tracer.enabled:
            if draft_s > 0.0:
                self.tracer.complete("spec_draft", t0, draft_s,
                                     cat="engine", rids=rids)
            self.tracer.complete("spec_verify", t1, verify_s,
                                 cat="engine", rids=rids,
                                 lanes=len(ready), drafted=drafted,
                                 accepted=accepted)
        return dt, len(ready)

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        s = self.telemetry.summary()
        s.update(self.energy.summary())
        dq = dequant_counters()
        s["weight_full_dequants"] = float(dq["full_dequant"])
        s["weight_fused_dequants"] = float(dq["fused_dequant"])
        s["cow_copies"] = float(self.cache.cow_copies)
        s["kv_pages_shared"] = float(self.cache.pages_shared)
        if self.spec is not None:
            s["spec_k_now"] = float(self.spec.current_k())
        if self.arena is not None:
            s["state_bytes"] = float(self.arena.state_bytes())
        if self.prefix is not None:
            s["prefix_pages_resident"] = float(self.prefix.n_pages)
            s["prefix_pages_evicted"] = float(self.prefix.pages_evicted)
        if self.group is not None:      # steps eager: see ServeConfig
            s["tp"] = float(self.config.tp)
            s["step_graphs"] = float(self.runner.graphs)
        return s

    def throughput(self) -> float:
        """Decode token rate (decode tokens over decode-call seconds)."""
        s = self.telemetry
        return s.decode_tokens / s.decode_s if s.decode_s else 0.0



# ============================================================================
# legacy compatibility shim
# ============================================================================
@dataclass
class Request:
    """Legacy request (seed API); prefer scheduler.ServeRequest."""
    prompt: np.ndarray
    max_new_tokens: int = 32
    rid: int = 0
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Seed-API shim over the paged runtime, as the JAX package's: every
    token-input family routes to `PagedServeEngine` (n_slots ->
    max_batch, worst-case page count so old workloads can never run out
    of pages), float weights and bf16 KV pools.  `device` as for
    `PagedServeEngine`."""

    def __init__(self, model, params: Any, n_slots: int = 4,
                 max_seq: int = 256, greedy: bool = True,
                 sampling: Optional[SamplingParams] = None, *,
                 device=None):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.greedy = greedy
        self.sampling = sampling
        # largest page size dividing max_seq (any max_seq works, as
        # the seed API allowed; page_size 1 = one token per page)
        page_size = next(p for p in (16, 8, 4, 2, 1)
                         if max_seq % p == 0)
        self.engine = PagedServeEngine(
            model, params, ServeConfig(
                precision="fp", kv_dtype="bf16", max_batch=n_slots,
                max_seq=max_seq, page_size=page_size,
                prefill_chunk=min(16, max_seq)), device=device)
        self.stats: Dict[str, float] = {"tokens": 0, "steps": 0,
                                        "decode_s": 0.0}

    def run(self, requests: List[Request]) -> List[Request]:
        sampling = self.sampling if self.sampling is not None else \
            SamplingParams(temperature=0.0 if self.greedy else 1.0)
        sreqs = [ServeRequest(prompt=np.asarray(r.prompt, np.int32),
                              max_new_tokens=r.max_new_tokens,
                              rid=i, sampling=sampling)
                 for i, r in enumerate(requests)]
        self.engine.run(sreqs)
        for r, sr in zip(requests, sreqs):
            r.out_tokens = sr.out_tokens
            r.done = sr.done
        t = self.engine.telemetry
        self.stats = {"tokens": t.tokens, "steps": t.steps,
                      "decode_tokens": t.decode_tokens,
                      "decode_s": t.decode_s}
        return requests

    def throughput(self) -> float:
        n = self.stats.get("decode_tokens", self.stats["tokens"])
        return n / self.stats["decode_s"] if self.stats["decode_s"] else 0.0
