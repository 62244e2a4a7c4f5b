"""Speculative accept/reject sampling (PyTorch port of
`repro.spec.verify`; numpy only, the same float64 walk).

Given the target model's logits over a draft window (one
`DecoderLM.paged_verify_step` call), walk the window left to right:

  greedy lanes     accept draft token j iff it IS the target argmax at
                   position j, so the emitted stream equals plain
                   decode's;
  sampling lanes   accept draft x_j ~ q_j with probability
                   min(1, p_j(x_j) / q_j(x_j)); on the first rejection
                   emit one token from the residual
                   norm(max(p_j - q_j, 0)) and stop.

The accepted-or-residual token is an exact sample from p_j (Leviathan et
al. / Chen et al.), so the drafter moves only the acceptance rate.  A
point-mass drafter (prompt-lookup n-gram) is q = one-hot.  Every step
emits the accepted prefix plus one token from the position after it.
The probabilities come from `processed_probs`, the distribution the
engine samples from, so a lane's top-k/top-p holds here too.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.sampling import SamplingParams, processed_probs


def _residual_draw(p: np.ndarray, q: np.ndarray,
                   rng: np.random.Generator) -> int:
    """Sample from norm(max(p - q, 0)); degenerates to p when p == q."""
    res = np.maximum(p - q, 0.0)
    z = res.sum()
    if z <= 0.0:
        return int(rng.choice(p.shape[0], p=p / p.sum()))
    return int(rng.choice(p.shape[0], p=res / z))


def accept_draft(p_logits: np.ndarray, draft: np.ndarray,
                 q_probs: Optional[np.ndarray], sampling: SamplingParams,
                 rng: np.random.Generator) -> Tuple[int, List[int]]:
    """One lane's accept/reject walk over a verified draft window.

    p_logits: (n_draft + 1, v) target logits, row j conditioned on the
    prefix plus draft[:j]; draft: (n_draft,) proposed tokens; q_probs:
    (n_draft, v) draft distributions, or None for a point-mass drafter.
    Returns (n_accepted, emitted), emitted = the accepted prefix plus the
    bonus/residual token (len == n_accepted + 1).
    """
    n_draft = int(len(draft))
    assert p_logits.shape[0] >= n_draft + 1

    if sampling.temperature <= 0.0:                      # greedy: exact match
        emitted: List[int] = []
        for j in range(n_draft):
            top = int(np.argmax(p_logits[j]))
            if int(draft[j]) != top:
                return j, emitted + [top]
            emitted.append(top)
        return n_draft, emitted + [int(np.argmax(p_logits[n_draft]))]

    emitted = []
    for j in range(n_draft):
        p = processed_probs(p_logits[j], sampling.temperature,
                            sampling.top_k, sampling.top_p)
        x = int(draft[j])
        if q_probs is None:                              # point-mass drafter
            q = np.zeros_like(p)
            q[x] = 1.0
        else:
            q = np.asarray(q_probs[j], np.float64)
        # q[x] == 0 would mean a draft not sampled from q; accepting on
        # the p side keeps the walk defined
        accept_p = 1.0 if q[x] <= 0.0 else min(1.0, p[x] / q[x])
        if p[x] > 0.0 and rng.random() < accept_p:
            emitted.append(x)
            continue
        return j, emitted + [_residual_draw(p, q, rng)]
    p_last = processed_probs(p_logits[n_draft], sampling.temperature,
                             sampling.top_k, sampling.top_p)
    return n_draft, emitted + [int(rng.choice(p_last.shape[0],
                                              p=p_last / p_last.sum()))]
