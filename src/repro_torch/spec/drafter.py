"""Drafters: cheap token-proposal sources behind one batched interface
(PyTorch port of `repro.spec.drafter`).

  NGramDrafter       model-free prompt lookup: the longest recent suffix
                     that re-occurs earlier in (prompt + generated)
                     predicts its historical continuation.  No FLOPs,
                     point-mass q.
  DraftModelDrafter  a small `DecoderLM` on the same paged runtime
                     (`paged_step` + its own `PagedKVCache`).  Its cache
                     holds only target-verified tokens at round
                     boundaries: proposals are drafted ahead, then the
                     draft cache is rolled back (`trim`) and re-fed the
                     accepted prefix next round.  Its steps run
                     through a `serve.graphs.StepRunner` (CUDA graphs
                     on the card, as JAX jits `paged_step`).

The engine calls `propose(histories, k, sampling)` once per decode step
with the full lane vector (inactive lanes None).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.serve.graphs import StepRunner
from repro_torch.serve.paged_cache import PagedKVCache
from repro_torch.serve.sampling import processed_probs, sample_tokens


@dataclass
class DraftProposal:
    """tokens: (b, k) int32 right-padded proposals; n: (b,) proposals
    per lane; probs: (b, k, v) draft distributions for the stochastic
    acceptance rule, or None for point-mass drafters."""
    tokens: np.ndarray
    n: np.ndarray
    probs: Optional[np.ndarray] = None


class Drafter:
    """Interface: `propose` every step; `release(lane)` when the engine
    finishes, cancels or preempts a lane, so a stateful drafter drops
    its state."""

    def propose(self, histories: List[Optional[np.ndarray]], k: int,
                sampling: List) -> DraftProposal:
        raise NotImplementedError

    def release(self, lane: int) -> None:
        pass


# ----------------------------------------------------------------------------
# model-free: prompt-lookup n-gram
# ----------------------------------------------------------------------------
class NGramDrafter(Drafter):
    """Propose the continuation of the most recent earlier occurrence of
    the current suffix (longest match wins, `ngram_max` down to
    `ngram_min` tokens)."""

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1,
                 lookback: int = 1024):
        assert 1 <= ngram_min <= ngram_max
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self.lookback = lookback     # bounds the per-step scan

    def _lookup(self, h: np.ndarray, k: int) -> np.ndarray:
        if len(h) > self.lookback:
            h = h[-self.lookback:]
        L = len(h)
        for n in range(min(self.ngram_max, L - 1), self.ngram_min - 1, -1):
            suffix = h[L - n:]
            # match only within h[:L-n]: the continuation starts before
            # the suffix begins, so at least one proposed token exists
            windows = np.lib.stride_tricks.sliding_window_view(
                h[:L - n], n) if L - n >= n else np.zeros((0, n), h.dtype)
            hits = np.nonzero((windows == suffix).all(axis=1))[0]
            if len(hits):
                start = int(hits[-1]) + n        # most recent match
                return h[start:start + k]
        return h[:0]

    def propose(self, histories: List[Optional[np.ndarray]], k: int,
                sampling: List) -> DraftProposal:
        b = len(histories)
        tokens = np.zeros((b, k), np.int32)
        n = np.zeros(b, np.int32)
        for i, h in enumerate(histories):
            if h is None or len(h) < self.ngram_min + 1:
                continue
            cont = self._lookup(np.asarray(h, np.int32), k)
            n[i] = len(cont)
            tokens[i, :len(cont)] = cont
        return DraftProposal(tokens=tokens, n=n, probs=None)


# ----------------------------------------------------------------------------
# small-model drafter on the paged runtime
# ----------------------------------------------------------------------------
class DraftModelDrafter(Drafter):
    def __init__(self, model, params, *, max_batch: int, max_seq: int,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 kv_dtype=None, chunk: int = 16, seed: int = 0,
                 device=None, runner: Optional[StepRunner] = None):
        assert model.supports_paged(), model.cfg.family
        assert max_seq % page_size == 0, (max_seq, page_size)
        self.model, self.params = model, params
        self.max_batch, self.max_seq = max_batch, max_seq
        self.chunk = min(chunk, max_seq)
        self.device = resolve_device(device)   # CUDA unless asked
        if n_pages is None:              # worst case: drafting never OOMs
            n_pages = max_batch * (max_seq // page_size)
        self.cache = PagedKVCache(model, n_pages, page_size, max_seq,
                                  kv_dtype or torch.bfloat16,
                                  device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.runner = runner if runner is not None else \
            StepRunner(self.device)
        self.decode_calls = 0            # paged_step calls, by width
        self.chunk_calls = 0
        # verified tokens materialized in the draft cache, per lane
        self._fed: List[np.ndarray] = [np.zeros(0, np.int32)
                                       for _ in range(max_batch)]

    def release(self, lane: int) -> None:
        self._fed[lane] = np.zeros(0, np.int32)
        if lane in self.cache.seqs:
            self.cache.release(lane)

    # ------------------------------------------------------------------
    def _run(self, tokens: np.ndarray, n_new: np.ndarray) -> torch.Tensor:
        tab = np.zeros((self.max_batch, self.cache.max_pages), np.int32)
        ln = np.zeros(self.max_batch, np.int32)
        for i in range(self.max_batch):
            if i in self.cache.seqs:
                tab[i] = self.cache.table_for(i)
                ln[i] = self.cache.seqs[i].length
        logits = self.runner(self.model.paged_step, self.params,
                             self.cache.pools, tokens, tab, ln, n_new)
        if tokens.shape[1] == 1:
            self.decode_calls += 1
        else:
            self.chunk_calls += 1
        for i in range(self.max_batch):
            if n_new[i]:
                self.cache.seqs[i].length += int(n_new[i])
        return logits

    def _catch_up(self, histories: List[Optional[np.ndarray]]) -> None:
        """Materialize each lane's verified prefix h[:-1] in the draft
        cache (h[-1] is the first draft input, fed by `propose`).  Lanes
        whose cached prefix diverged (preemption, lane reuse) reset."""
        pending = {}
        for i, h in enumerate(histories):
            if h is None:
                continue
            want = h[:len(h) - 1]
            fed = self._fed[i]
            if len(fed) > len(want) or not np.array_equal(
                    fed, want[:len(fed)]):
                self.release(i)
                fed = self._fed[i]
            if i not in self.cache.seqs:
                if len(h) > self.max_seq:
                    continue                 # too long to draft: skip lane
                self.cache.admit(i, 0)       # alloc grows via ensure_room
            if len(want) > len(fed):
                pending[i] = want
        while pending:
            tokens = np.zeros((self.max_batch, self.chunk), np.int32)
            n_new = np.zeros(self.max_batch, np.int32)
            for i, want in list(pending.items()):
                done = len(self._fed[i])
                q = min(self.chunk, len(want) - done)
                if not self.cache.ensure_room(i, q):
                    pending.pop(i)           # lane too long for the pool:
                    self.release(i)          # no draft this round
                    continue
                tokens[i, :q] = want[done:done + q]
                n_new[i] = q
            if not n_new.any():
                break
            self._run(tokens, n_new)
            for i in list(pending):
                q = int(n_new[i])
                self._fed[i] = np.concatenate(
                    [self._fed[i], pending[i][len(self._fed[i]):
                                              len(self._fed[i]) + q]])
                if len(self._fed[i]) == len(pending[i]):
                    pending.pop(i)

    def propose(self, histories: List[Optional[np.ndarray]], k: int,
                sampling: List) -> DraftProposal:
        self._catch_up(histories)
        b = self.max_batch
        vocab = self.model.cfg.vocab
        tokens = np.zeros((b, k), np.int32)
        n = np.zeros(b, np.int32)
        active = [i for i, h in enumerate(histories)
                  if h is not None and i in self.cache.seqs
                  and len(self._fed[i]) == len(h) - 1]
        if not active:
            return DraftProposal(tokens=tokens, n=n, probs=None)
        stochastic = any(sampling[i] is not None
                         and sampling[i].temperature > 0.0 for i in active)
        probs = np.zeros((b, k, vocab), np.float32) if stochastic else None
        base_len = {i: self.cache.seqs[i].length for i in active}

        cur = np.zeros(b, np.int32)
        for i in active:
            cur[i] = histories[i][-1]
        temp = np.zeros(b, np.float32)
        topk = np.zeros(b, np.int32)
        topp = np.ones(b, np.float32)
        for i in active:
            sp = sampling[i]
            if sp is not None:
                temp[i], topk[i], topp[i] = (sp.temperature, sp.top_k,
                                             sp.top_p)

        alive = set(active)
        for step in range(k):
            step_tokens = np.zeros((b, 1), np.int32)
            n_new = np.zeros(b, np.int32)
            for i in list(alive):
                if not self.cache.ensure_room(i, 1):
                    alive.discard(i)
                    continue
                step_tokens[i, 0] = cur[i]
                n_new[i] = 1
            if not alive:
                break
            rows = self._run(step_tokens, n_new)[:, 0, :]
            nxt = sample_tokens(self.generator, rows, temp, topk,
                                topp).cpu().numpy()
            rows_np = rows.float().cpu().numpy() if stochastic else None
            for i in list(alive):
                if stochastic and temp[i] > 0.0:
                    probs[i, step] = processed_probs(
                        rows_np[i], float(temp[i]), int(topk[i]),
                        float(topp[i]))
                tokens[i, step] = cur[i] = int(nxt[i])
                n[i] += 1

        # roll the speculative rows back: the draft cache keeps only
        # target-verified tokens across rounds
        for i in active:
            if i in self.cache.seqs:
                self.cache.trim(i, base_len[i])
        return DraftProposal(tokens=tokens, n=n, probs=probs)
