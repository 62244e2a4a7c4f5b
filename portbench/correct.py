"""The output check: what the window served against the plain reference.

After the window, a sample of the requests it finished, drawn from the
seed and always holding the longest, is run through the reference of the
configuration's family (`reference/<family>.py`), over each prompt with
its served tokens, from weights drawn again from the seed.  At each
served position the gap is read by which the served token's logit lies
below the reference's best.  The traffic is greedy, so a sound program
serves the reference's best token but where rounding splits a near tie,
and there the gap is small.  Three numbers come of the gaps
(`readings`): the widest gap, the mean gap over the served positions,
and the share of positions whose token is not the reference's best; the
configuration's `correct` table names the ones compared and their
limits (PERF.md gives the readings each limit was set from).

The control (`control_readings`) puts the reference computed on TF32
inputs in the program's place: at each position it takes the token the
control ranks first and reads that token's gap under the float32
reference.
"""
from __future__ import annotations

import importlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

import weights
from reference.common import exact_matmuls, mm

SAMPLE = 4                      # requests compared a run
ROWS = 512                      # logits rows at a time

Served = Tuple[np.ndarray, np.ndarray]        # (prompt, served tokens)


def sample(finished: list, seed: int) -> List[Served]:
    """The longest finished request and SAMPLE - 1 others drawn from the
    seed."""
    if not finished:
        return []
    by_len = sorted(range(len(finished)),
                    key=lambda i: -len(finished[i].req.out_tokens))
    rest = by_len[1:]
    rng = np.random.default_rng([seed, 2])
    pick = [by_len[0]] + [rest[i] for i in sorted(
        rng.choice(len(rest), min(SAMPLE - 1, len(rest)), replace=False))]
    return [(np.asarray(finished[i].req.prompt, np.int64),
             np.asarray(finished[i].req.out_tokens, np.int64))
            for i in pick]


def _hidden(conf, z, w, served: Sequence[Served], device, control):
    ref = importlib.import_module(f"reference.{z['family']}")
    n = len(served)
    s = max(len(p) + len(o) - 1 for p, o in served)
    tokens = torch.zeros(n, s, dtype=torch.long)
    for i, (p, o) in enumerate(served):
        seq = np.concatenate([p, o[:-1]])
        tokens[i, :len(seq)] = torch.from_numpy(seq)
    with torch.no_grad():
        h = ref.hidden(z, w, tokens.to(device), control)
        return h, ref.head_weight(z, w)


def _rows(served):
    """(sequence, first row, served tokens) of each sample."""
    return [(i, len(p) - 1, o) for i, (p, o) in enumerate(served)]


def readings(conf, z, seed, device, served: Sequence[Served],
             picks: List[torch.Tensor] = None) -> dict:
    """The numbers of the gaps, under the float32 reference, of the
    served tokens (or of `picks`, one token a served position)."""
    exact_matmuls()
    w = weights.draw(conf, seed, device)
    h, head = _hidden(conf, z, w, served, device, False)
    del w
    widest = total = 0.0
    n = off = 0
    with torch.no_grad():
        for i, first, out in _rows(served):
            tok = torch.as_tensor(out, device=device) if picks is None \
                else picks[i]
            for a in range(0, len(out), ROWS):
                b = min(a + ROWS, len(out))
                lg = mm(h[i, first + a:first + b], head, False)
                gap = lg.amax(-1) - lg.gather(1, tok[a:b, None])[:, 0]
                widest = max(widest, float(gap.max()))
                total += float(gap.sum())
                off += int((gap > 0).sum())
                n += b - a
    return {"widest_gap": widest, "mean_gap": total / n,
            "mismatch_share": off / n}


def control_picks(conf, z, seed, device, served: Sequence[Served]
                  ) -> List[torch.Tensor]:
    """The token the control (TF32 inputs) ranks first at each served
    position."""
    exact_matmuls()
    w = weights.draw(conf, seed, device)
    h, head = _hidden(conf, z, w, served, device, True)
    del w
    out = []
    with torch.no_grad():
        for i, first, toks in _rows(served):
            lg = mm(h[i, first:first + len(toks)], head, True)
            out.append(lg.argmax(-1))
    return out


def control_readings(conf, z, seed, device, served) -> dict:
    return readings(conf, z, seed, device, served,
                    control_picks(conf, z, seed, device, served))
