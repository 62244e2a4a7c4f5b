"""Token sampling: greedy / temperature / top-k / top-p (PyTorch port of
`repro.serve.sampling`).

Sampling runs on the logits' device with an explicit `torch.Generator`;
an all-greedy batch is one argmax, and only the (b,) tokens cross to the
host.  The truncation rules are the JAX package's: a kth-value top-k
cutoff, and a nucleus that keeps a token iff the probability mass
strictly before it is under top_p (so the argmax always survives).
`torch.Generator` draws differ from `jax.random`'s, so sampled streams
differ between the packages; `processed_probs` (numpy, copied as is) is
the distribution both sample from.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 -> greedy
    top_k: int = 0               # 0 -> full vocab
    top_p: float = 1.0           # 1 -> no nucleus truncation


def sample_tokens(generator: torch.Generator, logits: torch.Tensor,
                  temperature: np.ndarray, top_k: np.ndarray,
                  top_p: np.ndarray = None) -> torch.Tensor:
    """logits: (b, v); temperature, top_k, top_p: (b,) host arrays of
    per-lane params.  Returns (b,) int64 tokens on the logits' device."""
    lf = logits.to(torch.float32)
    greedy = torch.argmax(lf, dim=-1)
    temp_np = np.asarray(temperature, np.float32)
    if not np.any(temp_np > 0.0):
        return greedy
    dev = logits.device
    temp = torch.as_tensor(temp_np, device=dev)
    scaled = lf / temp.clamp_min(1e-6)[:, None]
    cut = torch.full((lf.shape[0], 1), -torch.inf, device=dev)
    topk_np = np.asarray(top_k, np.int64)
    kmax = min(int(topk_np.max(initial=0)), lf.shape[-1])
    if kmax > 0:
        top_vals = torch.topk(scaled, kmax, dim=-1).values
        k = torch.as_tensor(topk_np, device=dev)
        kth = top_vals.gather(1, (k.clamp(1, kmax) - 1)[:, None])
        cut = torch.where((k > 0)[:, None], kth, cut)
    if top_p is not None and np.any((np.asarray(top_p) < 1.0)
                                    & (temp_np > 0.0)):
        tp = torch.as_tensor(np.asarray(top_p, np.float32), device=dev)
        srt = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        keep = before < tp.clamp_min(1e-9)[:, None]
        p_cut = torch.where(keep, srt, torch.inf).amin(dim=-1, keepdim=True)
        p_cut = torch.where((tp < 1.0)[:, None], p_cut, -torch.inf)
        cut = torch.maximum(cut, p_cut)
    truncated = torch.where(scaled >= cut, scaled, -torch.inf)
    sampled = torch.multinomial(torch.softmax(truncated, dim=-1), 1,
                                generator=generator)[:, 0]
    return torch.where(temp <= 0.0, greedy, sampled)


def processed_probs(logits: np.ndarray, temperature: float, top_k: int,
                    top_p: float) -> np.ndarray:
    """The (v,) probability vector `sample_tokens` draws one lane from;
    temperature <= 0 returns the greedy one-hot."""
    lf = np.asarray(logits, np.float64)
    if temperature <= 0.0:
        out = np.zeros_like(lf)
        out[int(np.argmax(lf))] = 1.0
        return out
    scaled = lf / max(temperature, 1e-6)
    cut = -np.inf
    if 0 < top_k < lf.shape[-1]:
        cut = np.sort(scaled)[::-1][top_k - 1]
    if top_p < 1.0:
        srt = np.sort(scaled)[::-1]
        e = np.exp(srt - srt[0])
        probs = e / e.sum()
        before = np.cumsum(probs) - probs
        cut = max(cut, srt[before < max(top_p, 1e-9)].min())
    scaled = np.where(scaled >= cut, scaled, -np.inf)
    e = np.exp(scaled - scaled.max())
    return e / e.sum()
