"""Feed-forward layers (PyTorch port of `repro.models.ffn`'s serve path):
the dense FFN (fused SwiGLU, or gated / plain GELU-family) and
Mixture-of-Experts.

MoE routes each token to its top-k experts and packs the chosen (token,
expert) slots into per-expert buffers of a fixed capacity, dropping
what overflows, as the JAX package's drop-on-overflow dispatches do:
`_moe_gather` and `_moe_onehot` keep the same slots (an expert's slots
ranked in flattened (token, k) order, the first `cap` kept), and
`_moe_onehot_grouped` ranks them within groups of GROUP_TOKENS tokens
with a capacity per group.  The port runs one sort-based dispatch for
all three (`dispatch_slots`), at static shapes with no host read, so a
step stays capturable in a CUDA graph.  Expert weights are packed
`(E, K/2, N)` stacks; each projection over them is one `cim_gemv` call
in its stack layout, which computes only the rows an expert holds.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.dist.shard import (tp_all_gather, tp_all_reduce,
                                    tp_rank_and_size)
from repro_torch.kernels.ops import expert_qmatmul, rank_rows, row_parallel
from repro_torch.kernels.ops import qmatmul as qmm
from repro_torch.kernels.ops import swiglu

from .common import ACTIVATIONS, EXPERT, FSDP, NONE, TP, ParamSpec, take_rows
from .config import ModelConfig

Params = Dict[str, torch.Tensor]

GROUP_TOKENS = 512      # the JAX package's GShard group: with the onehot
                        # dispatch, a call of more (and a multiple of)
                        # 512 tokens has a capacity per group


def dense_ffn_specs(cfg: ModelConfig, d_ff: int = 0) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    sp = {"w_up": ParamSpec((d, f), axes=(FSDP, TP)),
          "w_down": ParamSpec((f, d), axes=(TP, FSDP))}
    if cfg.ffn_gated:
        sp["w_gate"] = ParamSpec((d, f), axes=(FSDP, TP))
    return sp


def dense_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU is the fused SwiGLU (one pass over the packed gate/up
    weights); every other activation takes the unfused route, one
    `cim_gemv` call per packed projection, as the JAX package does.
    Under tensor parallelism a rank holds its d_ff / tp columns of gate
    / up and rows of w_down, whose output is summed over the ranks
    (`row_parallel`)."""
    if cfg.ffn_gated and cfg.ffn_act == "silu":
        return row_parallel(swiglu(x, p["w_gate"], p["w_up"]), p["w_down"])
    act = ACTIVATIONS[cfg.ffn_act]
    up = qmm(x, p["w_up"])
    h = act(qmm(x, p["w_gate"])) * up if cfg.ffn_gated else act(up)
    return row_parallel(h, p["w_down"])


# ----------------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------------
def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m = cfg.moe
    d, fe, E = cfg.d_model, m.d_ff_expert, m.n_experts
    sp = {"router": ParamSpec((d, E), axes=(FSDP, NONE),
                              scale=1.0 / math.sqrt(d)),
          "we_gate": ParamSpec((E, d, fe), axes=(EXPERT, NONE, FSDP)),
          "we_up": ParamSpec((E, d, fe), axes=(EXPERT, NONE, FSDP)),
          "we_down": ParamSpec((E, fe, d), axes=(EXPERT, FSDP, NONE))}
    if m.n_shared_experts > 0:
        fs = fe * m.n_shared_experts
        sp["ws_gate"] = ParamSpec((d, fs), axes=(FSDP, TP))
        sp["ws_up"] = ParamSpec((d, fs), axes=(FSDP, TP))
        sp["ws_down"] = ParamSpec((fs, d), axes=(TP, FSDP))
    return sp


def _router(p: Params, cfg: ModelConfig, xf: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xf: (T, d) -> (weights (T, k) f32, expert ids (T, k) int64).  The
    top k by a stable descending sort: among equal probabilities the
    lower expert id comes first, as `lax.top_k` breaks ties
    (`torch.topk` does not promise an order)."""
    logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    w, ids = vals[:, :k], idx[:, :k]
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    return w, ids


def capacity(cfg: ModelConfig, T: int) -> Tuple[int, int]:
    """(groups, capacity per group) of a call over T tokens: one group
    of T tokens, or with the onehot dispatch T / GROUP_TOKENS groups when
    T is a multiple of GROUP_TOKENS above it (JAX's grouped dispatch)."""
    m = cfg.moe
    groups = (T // GROUP_TOKENS if m.dispatch == "onehot"
              and T > GROUP_TOKENS and T % GROUP_TOKENS == 0 else 1)
    tokens = T // groups
    return groups, max(8, int(math.ceil(tokens * m.top_k / m.n_experts
                                        * m.capacity_factor)))


def dispatch_slots(ids: torch.Tensor, n_experts: int, cap: int,
                   groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where each (token, k) slot goes, from the router's ids (T, k).

    Slots are ranked within their (group, expert) in flattened (token,
    k) order (a stable sort by key); the first `cap` of each are kept.
    Expert e's buffer holds C = groups * cap rows, its kept slots
    packed from row 0 group by group, so its rows [0, counts[e]) are
    exactly the kept ones.  Returns (slot (T * k,) int64: the row of the
    flat (E * C + 1) buffer, E * C (a sentinel) for a dropped slot;
    counts (E,) int32).  No host read: `scatter_add_` counts, where
    `bincount` would sync."""
    T, k = ids.shape
    n, E = T * k, n_experts
    dev = ids.device
    flat = ids.reshape(n).long()
    pos = torch.arange(n, device=dev)
    key = (pos // (n // groups)) * E + flat            # (group, expert)
    order = torch.argsort(key, stable=True)
    per_key = torch.zeros(groups * E, dtype=torch.long, device=dev)
    per_key.scatter_add_(0, key, torch.ones_like(key))
    first = torch.cumsum(per_key, 0) - per_key
    rank = torch.empty_like(pos).scatter_(0, order, pos - first[key[order]])
    kept = per_key.clamp(max=cap).reshape(groups, E)
    before = (torch.cumsum(kept, 0) - kept).reshape(-1)  # earlier groups
    C = groups * cap
    slot = torch.where(rank < cap, flat * C + before[key] + rank,
                       torch.full_like(flat, E * C))
    return slot, kept.sum(0).to(torch.int32)


def _expert_ffn(p: Params, cfg: ModelConfig, xe: torch.Tensor,
                counts: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, d) -> (E, C, d), the JAX order: act(x Wg) * (x Wu),
    then Wd, three products over the stacks (not the fused SwiGLU).  On
    the card rows past counts[e] are not computed."""
    act = ACTIVATIONS[cfg.ffn_act]
    h = act(expert_qmatmul(xe, p["we_gate"], counts)) \
        * expert_qmatmul(xe, p["we_up"], counts)
    return expert_qmatmul(h, p["we_down"], counts)


def _dispatch(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Route the b * s rows of x and place their slots: (xf (T, d), the
    top-k weights (T, k), slot (T * k,) and counts (E,) of
    `dispatch_slots`, the rows C of an expert's buffer)."""
    b, s, d = x.shape
    T = b * s
    groups, cap = capacity(cfg, T)
    xf = x.reshape(T, d)
    w, ids = _router(p, cfg, xf)
    slot, counts = dispatch_slots(ids, cfg.moe.n_experts, cap, groups)
    return xf, w, slot, counts, groups * cap


def _combine(p: Params, cfg: ModelConfig, xf: torch.Tensor,
             w: torch.Tensor, slot: torch.Tensor, counts: torch.Tensor,
             C: int) -> torch.Tensor:
    """Pack xf's slots into the stacks' (E, C, d) buffers (E the stacks'
    leading dim; slot E * C drops), run the experts, and gather each slot
    back times its weight: (T, k, d) in xf's dtype, a dropped slot 0."""
    T, k = w.shape
    E, d = p["we_gate"].shape[0], xf.shape[1]
    buf = torch.zeros(E * C + 1, d, dtype=xf.dtype, device=xf.device)
    buf.index_copy_(0, slot, xf[:, None].expand(T, k, d).reshape(T * k, d))
    ye = _expert_ffn(p, cfg, buf[:E * C].view(E, C, d), counts)
    # only kept rows are gathered: rows past an expert's count hold
    # whatever the card left there; a dropped slot reads the zero row
    ye = torch.cat([ye.reshape(E * C, d), ye.new_zeros(1, d)])
    return (take_rows(ye, slot) * w.reshape(T * k, 1).to(xf.dtype)
            ).reshape(T, k, d)


def moe_routed(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The routed experts of every token of x (b, s, d): route, pack into
    the experts' buffers, run them, gather the kept slots back and sum
    them weighted.  Every one of the b * s rows is routed, padding rows
    and idle lanes included, in the JAX engine's flattened order, so
    they take capacity as they do there.

    Under autograd (training, float stacks) gradients reach the router
    through the top-k weights `w` and the experts through `index_copy_`
    (its source's gradient is a gather) and the combine's gather
    (`take_rows`: a fixed-order segment sum, no atomics); only the
    choice of slots is discrete, as in JAX."""
    xf, w, slot, counts, C = _dispatch(p, cfg, x)
    return _combine(p, cfg, xf, w, slot, counts, C).sum(dim=1).reshape(
        x.shape)


def _moe_routed_rank(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     rank: int) -> torch.Tensor:
    """Expert parallelism: this rank's share of `moe_routed`, an f32
    partial (b, s, d) that the ranks' sum makes whole.  The routing and
    the capacity stay global, the same on every rank (the router is
    replicated), so the slots kept and dropped are those of tp = 1; the
    rank holds the stacks' experts [rank * El, (rank + 1) * El) (El their
    leading dim), packs only their slots into (El, C, d) buffers and
    sends every other slot to its own drop row El * C."""
    El = p["we_gate"].shape[0]
    xf, w, slot, counts, C = _dispatch(p, cfg, x)
    local = slot - rank * El * C
    local = torch.where((local >= 0) & (local < El * C), local,
                        torch.full_like(local, El * C))
    out = _combine(p, cfg, xf, w, local,
                   counts[rank * El:(rank + 1) * El], C)
    return out.to(torch.float32).sum(dim=1).reshape(x.shape)


def moe_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Routed experts plus, when the config has them, the shared experts:
    three packed products (not the fused SwiGLU), as the JAX package.

    Under tensor parallelism (`dist.shard.use_tp`) a rank runs its
    experts (`_moe_routed_rank`) and its columns of the shared gate / up
    and rows of the shared down projection; the two f32 partials are
    summed over the ranks in one all-reduce, then cast.  A leaf the
    sharding rule left whole (the stacks when the ranks do not divide
    the experts, `ws_down` when they do not divide its groups) is
    computed whole on every rank (the shared input gathered) and added
    after the sum.  Outside `use_tp` every leaf is whole and the sum is
    the identity: routed plus shared, in x's dtype."""
    rank, _ = tp_rank_and_size()
    whole = part = None
    if p["we_gate"].shape[0] == cfg.moe.n_experts:
        whole = moe_routed(p, cfg, x)
    else:
        part = _moe_routed_rank(p, cfg, x, rank)
    if cfg.moe.n_shared_experts > 0:
        act = ACTIVATIONS[cfg.ffn_act]
        h = act(qmm(x, p["ws_gate"])) * qmm(x, p["ws_up"])
        if p["ws_down"].shape[-2] != h.shape[-1]:
            sh = qmm(tp_all_gather(h, -1), p["ws_down"])
            whole = sh if whole is None else whole + sh
        else:
            sh = rank_rows(h, p["ws_down"]).to(torch.float32)
            part = sh if part is None else part + sh
    out = None if part is None else tp_all_reduce(part).to(x.dtype)
    if whole is None:
        return out
    return whole if out is None else out + whole


def ffn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return moe_specs(cfg) if cfg.moe is not None else dense_ffn_specs(cfg)


def ffn_forward(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.moe is not None:
        return moe_ffn(p, cfg, x)
    return dense_ffn(p, cfg, x)
