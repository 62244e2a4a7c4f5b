"""Deterministic, seekable synthetic token pipeline.

A fixed random Markov chain over the vocabulary generates sequences with
learnable structure (a model that learns the bigram table drives loss
well below the unigram entropy — the quickstart example shows this).

Determinism + seekability are the fault-tolerance substrate: batch `i` is
a pure function of (seed, i), so a restarted/rescaled job resumes from the
checkpointed cursor with bit-identical data order, and each DP shard draws
its own slice without coordination (no data server to fail).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int = 256
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    branching: int = 8      # out-degree of the Markov chain


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # sparse row-stochastic transition structure
        self.next_tokens = rng.integers(
            0, cfg.vocab, size=(cfg.vocab, cfg.branching), dtype=np.int64)
        logits = rng.standard_normal((cfg.vocab, cfg.branching))
        p = np.exp(logits - logits.max(1, keepdims=True))
        self.next_p = p / p.sum(1, keepdims=True)

    # ------------------------------------------------------------------
    def batch(self, index: int, shard: int = 0, n_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        """Batch `index`, data-parallel shard `shard` of `n_shards`.
        Pure function of (seed, index, shard) — seekable and elastic:
        re-sharding to a different n_shards re-partitions the same global
        batch."""
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0
        bs = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, index, shard]))
        tokens = np.empty((bs, cfg.seq_len + 1), np.int64)
        tokens[:, 0] = rng.integers(0, cfg.vocab, size=bs)
        for t in range(cfg.seq_len):
            cur = tokens[:, t]
            # vectorized categorical draw over the branching table
            u = rng.random(bs)
            cdf = np.cumsum(self.next_p[cur], axis=1)
            choice = (u[:, None] < cdf).argmax(axis=1)
            tokens[:, t + 1] = self.next_tokens[cur, choice]
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    def stream(self, start_index: int = 0, shard: int = 0, n_shards: int = 1
               ) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        i = start_index
        while True:
            yield i, self.batch(i, shard, n_shards)
            i += 1

    def bigram_entropy(self) -> float:
        """Achievable loss floor (nats/token) for a perfect bigram model."""
        h = -(self.next_p * np.log(self.next_p)).sum(axis=1)
        return float(h.mean())
