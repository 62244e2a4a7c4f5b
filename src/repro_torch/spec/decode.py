"""SpecDecoder: the engine-facing bundle of speculative decoding —
drafter + verify step + acceptance RNG (PyTorch port of
`repro.spec.decode`).

Decoding at small batch streams the whole packed weight set for every
token.  A verify step scores a (k + 1)-token window per lane in one pass
over those weights (`DecoderLM.paged_verify_step`, every projection a
GEMV of M = max_batch * (k + 1) rows), and the accept/reject walk keeps
the served distribution exactly the target's.  Every verify call is
(max_batch, k + 1) wide whatever the lanes drafted.  The engine runs
`verify_fn` through its `serve.graphs.StepRunner` (a CUDA graph per
shape on the card, as JAX jits it), and a draft model's steps go through
the same runner.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.serve.sampling import SamplingParams

from .drafter import Drafter, DraftModelDrafter, NGramDrafter
from .verify import accept_draft


@dataclass
class SpecConfig:
    """Engine-level speculation knobs (per-request opt-out via
    `ServeRequest.spec = False`)."""
    k: int = 4                       # draft window (tokens per verify)
    drafter: str = "ngram"           # "ngram" | "model"
    ngram_max: int = 3
    ngram_min: int = 1
    draft_model: Any = None          # DecoderLM, drafter == "model"
    draft_params: Any = None
    draft_page_size: int = 16
    draft_chunk: int = 16            # draft-cache catch-up chunk width
    seed: int = 0
    # drafter-k autotuning: an EMA of the measured acceptance rate
    # scales how much the drafter proposes each step, between 1 and k.
    # The verify window stays (b, k + 1); autok only stops paying draft
    # cost that speculation is not earning back.
    autok: bool = False
    autok_beta: float = 0.3          # EMA weight of the newest step


class SpecDecoder:
    def __init__(self, model, spec_cfg: SpecConfig, *, max_batch: int,
                 max_seq: int, kv_dtype=None, device=None,
                 runner=None):
        """`runner`: the engine's `StepRunner`, which a draft model's
        steps share (its own, on `device`, when None)."""
        assert spec_cfg.k >= 1
        self.cfg = spec_cfg
        self.verify_fn = model.paged_verify_step
        self.rng = np.random.default_rng(spec_cfg.seed)
        # autok: start the EMA mid-range, then let measurement move it
        self._accept_ema = 0.5
        if spec_cfg.drafter == "ngram":
            self.drafter: Drafter = NGramDrafter(spec_cfg.ngram_max,
                                                 spec_cfg.ngram_min)
        elif spec_cfg.drafter == "model":
            if spec_cfg.draft_model is None:
                raise ValueError("drafter='model' needs draft_model and "
                                 "draft_params")
            dm = spec_cfg.draft_model
            if dm.cfg.vocab != model.cfg.vocab:
                raise ValueError("draft and target models must share a "
                                 "vocabulary")
            page = spec_cfg.draft_page_size
            while max_seq % page:
                page //= 2
            self.drafter = DraftModelDrafter(
                dm, spec_cfg.draft_params, max_batch=max_batch,
                max_seq=max_seq, page_size=page, kv_dtype=kv_dtype,
                chunk=spec_cfg.draft_chunk, seed=spec_cfg.seed,
                device=resolve_device(device), runner=runner)
        else:
            raise ValueError(f"unknown drafter {spec_cfg.drafter!r} "
                             "(ngram or model)")

    def accept(self, p_logits: np.ndarray, draft: np.ndarray,
               q_probs: Optional[np.ndarray], sampling: SamplingParams
               ) -> Tuple[int, List[int]]:
        """One lane's walk with the decoder's RNG (one seeded stream for
        the whole engine)."""
        return accept_draft(p_logits, draft, q_probs, sampling, self.rng)

    # -- drafter-k autotuning ------------------------------------------
    def current_k(self) -> int:
        """Tokens the drafter proposes this step: cfg.k when autok is
        off, else 1..cfg.k scaled by the acceptance EMA."""
        if not self.cfg.autok or self.cfg.k == 1:
            return self.cfg.k
        return 1 + int(round(self._accept_ema * (self.cfg.k - 1)))

    def observe(self, drafted: int, accepted: int) -> None:
        """Fold one verify step's measured acceptance into the EMA
        (steps that drafted nothing carry no signal)."""
        if not self.cfg.autok or drafted == 0:
            return
        beta = self.cfg.autok_beta
        self._accept_ema = ((1.0 - beta) * self._accept_ema
                            + beta * accepted / drafted)
