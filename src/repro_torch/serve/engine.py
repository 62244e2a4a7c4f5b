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

Every step runs at most one chunked batch-prefill call (b = max_batch,
s = prefill_chunk) and one decode call (b = max_batch, s = 1) through
`DecoderLM.serve_step`, which writes the KV pools in place.  Greedy
lanes take an argmax on the device; only (b,) tokens cross to the host.
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

Runs on CUDA unless the caller passes `device="cpu"` (the plain PyTorch
versions of the kernels, run eagerly).  Not in this port yet, and
refused when asked for: tensor parallelism and replicas (`ServeConfig`),
recurrent families and their StateArena, sliding-window and softcap
models (`DecoderLM`).
"""
from __future__ import annotations

import time
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
from .telemetry import Telemetry


def _has_qtensor(tree: Any) -> bool:
    if isinstance(tree, dict):
        return any(_has_qtensor(v) for v in tree.values())
    return isinstance(tree, QTensor)


class PagedServeEngine:
    def __init__(self, model, params: Any,
                 config: Optional[ServeConfig] = None, *,
                 spec: Optional[Any] = None, device=None,
                 eager: bool = False, clock=time.monotonic):
        config = config if config is not None else ServeConfig()
        self.config = config
        self.device = resolve_device(device)
        max_batch, max_seq = config.max_batch, config.max_seq
        page_size, n_pages = config.page_size, config.n_pages
        if max_seq % page_size:
            raise ValueError(f"max_seq {max_seq} must be a multiple of "
                             f"page_size {page_size}")
        if spec is not None and not model.supports_paged():
            raise ValueError(
                f"{model.cfg.name}: speculative decoding needs a model "
                "whose every layer keeps paged KV (rollback trims pages)")
        params = tree_to(params, self.device)
        if config.quantized() and not _has_qtensor(params):
            # the precision field is authoritative: quantize float params
            params = quantize_params(params, bits=config.weight_bits(),
                                     group=config.quant_group)
        prefix_cache = config.prefix_cache is not False   # default on
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
        now = self._clock()
        req.eid = self._next_eid      # rid is the caller's label and may
        self._next_eid += 1           # collide; eid keys cache/telemetry
        self.telemetry.enqueue(req.eid, now)
        self.scheduler.submit(req, now)
        self._event("submit", eid=req.eid, rid=req.trace_id,
                    prompt_len=req.prompt_len)

    def cancel(self, eid: int) -> bool:
        """Abort a submitted request wherever it is — queued,
        mid-prefill, mid-decode, or preempted.  Frees its KV pages
        (decref: pages shared with the prefix trie or a fork survive)
        and its lane.  False when `eid` is unknown or already done."""
        now = self._clock()
        queued = self.scheduler.cancel(eid)
        if queued is not None:
            queued.done = True
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
        through the runner; the pools are updated in place.  The logits
        are the step's static output: every use of them ends before the
        next call of the same step."""
        return self.runner(step_fn or self.model.serve_step, self.params,
                           self.cache.pools, tokens, tables, lengths, n_new)

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
        """Pool exhausted: evict this lane and requeue it with (prompt +
        generated since the last fold) as its new prompt; its pages are
        rebuilt by prefill when they free up."""
        req = self.lanes[lane]
        self._event("preempt", eid=req.eid, rid=req.trace_id, lane=lane,
                    tokens=len(req.out_tokens))
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
        self.telemetry.step(self.cache.occupancy(), self.n_running,
                            decode_s=decode_s, prefill_s=prefill_s,
                            decode_lanes=decode_lanes,
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
        elif logits.is_cuda:
            torch.cuda.synchronize(logits.device)
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
        if self.prefix is not None:
            s["prefix_pages_resident"] = float(self.prefix.n_pages)
            s["prefix_pages_evicted"] = float(self.prefix.pages_evicted)
        return s

    def throughput(self) -> float:
        """Decode token rate (decode tokens over decode-call seconds)."""
        s = self.telemetry
        return s.decode_tokens / s.decode_s if s.decode_s else 0.0

