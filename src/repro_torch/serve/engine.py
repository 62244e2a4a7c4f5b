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
cover the jitted dispatch, the port's include the device's work.

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
synchronizes that stream, not the device.  Not in this port yet, and
refused when asked for: tensor parallelism (`ServeConfig.tp`).
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
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.common import tree_to
from repro_torch.obs.energy import EnergyMeter
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import get_tracer
from repro_torch.quant.ptq import quantize_params
from repro_torch.quant.qarray import QTensor, dequant_counters

from .config import ServeConfig
from .graphs import StepRunner
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
                 eager: bool = False, clock=time.monotonic):
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
        self.energy = EnergyMeter(
            model.cfg, w_bits=config.weight_bits(),
            a_bits=8 if config.quantized() else 16)
        self._cow_seen = 0          # deltas -> cow_copy / prefix_evict
        self._evict_seen = 0        # trace instants per step
        self.lanes: List[Optional[ServeRequest]] = [None] * max_batch
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.runner = StepRunner(self.device, eager=eager)
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
        if req.fork_from is not None and not self.model.supports_paged():
            raise ValueError(capability_error(self.model,
                                              "parallel-sampling"))
        now = self._clock()
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
        return self.runner(step_fn or self.model.serve_step, self.params,
                           self.state, tokens, tables, lengths, n_new)

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
        return sample_tokens(self.generator, rows, temp, topk,
                             topp).cpu().numpy()

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
        if self.stream is None:
            self._step()
            return
        with torch.cuda.stream(self.stream):     # this engine's stream
            self._step()

    def _step(self) -> None:
        now = self._clock()

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
        t0 = time.monotonic()       # the tracer's clock: spans line up
        logits = self._dispatch(tokens, self._tables(), self._lengths(),
                                n_new)
        self.prefill_calls += 1
        if finishing:       # only sample when some lane ends its prompt
            idx = torch.from_numpy(np.maximum(n_new - 1, 0).astype(np.int64))
            last = logits[torch.arange(self.max_batch), idx.to(logits.device)]
            nxt = self._sample_rows(last)
        elif self.stream is not None:     # this engine's work only
            self.stream.synchronize()
        dt = time.monotonic() - t0
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
        t0 = time.monotonic()
        lens = self._lengths()
        logits = self._dispatch(tokens, self._tables(), lens, n_new)
        self.decode_calls += 1
        nxt = self._sample_rows(logits[:, 0, :])
        dt = time.monotonic() - t0
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
        t0 = time.monotonic()
        prop = spec.drafter.propose(histories, k_draft, smp)
        draft_s = time.monotonic() - t0

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
        t1 = time.monotonic()
        if plain:
            logits = self._dispatch(tokens[:, :1], self._tables(), lengths,
                                    n_new)
            self.decode_calls += 1
        else:
            logits = self._dispatch(tokens, self._tables(), lengths, n_new,
                                    step_fn=spec.verify_fn)
            self.verify_calls += 1
        logits_np = logits.float().cpu().numpy()
        dt = time.monotonic() - t0
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
        verify_s = time.monotonic() - t1
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
