"""A frontend stub for the archs whose inputs are embeddings
(`embed_inputs=False`: pixtral-12b's vision encoder, musicgen-medium's
EnCodec): each token of a `SyntheticLM` batch becomes a fixed random
row, so a model fed `embeddings` learns the same Markov chain.  Numpy
only, so the JAX package's trainer can take the same batches."""
from __future__ import annotations

from typing import Dict

import numpy as np

from .synthetic import SyntheticLM


class FrontendStub:
    """`SyntheticLM` batches with `tokens` replaced by `embeddings` (b, s,
    d_model) f32: rows of a (vocab, d_model) table drawn from `seed`,
    std d_model ** -0.5 (the embedding table's init).  `labels` and
    the data cursor (`cfg.seed`, batch indices) are the wrapped
    stream's."""

    def __init__(self, data: SyntheticLM, d_model: int, seed: int = 0):
        self.data = data
        self.cfg = data.cfg
        rng = np.random.default_rng(seed)
        self.table = (rng.standard_normal((data.cfg.vocab, d_model))
                      * d_model ** -0.5).astype(np.float32)

    def batch(self, index: int, shard: int = 0, n_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        b = self.data.batch(index, shard, n_shards)
        return {"embeddings": self.table[b["tokens"]], "labels": b["labels"]}

    def bigram_entropy(self) -> float:
        return self.data.bigram_entropy()
