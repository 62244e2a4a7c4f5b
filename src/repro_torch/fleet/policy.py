"""Dispatch policies: which live replica serves the next request group
(PyTorch port of `repro.fleet.policy`).

Every policy picks from CANDIDATES — live replicas with admission
capacity — already filtered by the router, so a policy is pure routing
preference, never admission control.

  rr            cycle through replicas in id order: perfectly fair,
                ignores load and cache state (the baseline the bench
                compares against)
  least-loaded  min (pending depth, KV occupancy): pending is the
                router's own dispatch ledger (exact), occupancy comes
                from the replica's last published step snapshot (at
                most one step stale)
  prefix        prefix-affinity: route to the replica whose resident
                radix-trie fingerprint covers the longest page-aligned
                prefix of the prompt — it adopts the matched KV pages
                instead of re-prefilling them.  Depth ties break by
                least-loaded, and a miss everywhere IS least-loaded.

A fingerprint hash collision can only misroute (the engine still walks
its exact token trie at admission), so affinity is a pure optimization
with least-loaded's behavior as its floor.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serve.prefix import prompt_page_hashes

from .replica import Replica


class Policy:
    name = "base"

    def pick(self, candidates: Sequence[Replica],
             prompt: Optional[np.ndarray]) -> Replica:
        raise NotImplementedError


class RoundRobinPolicy(Policy):
    name = "rr"

    def __init__(self):
        self._next = 0

    def pick(self, candidates, prompt):
        # cycle over replica IDS, not the candidate list: a replica
        # dropping out (dead/saturated) must not re-deal everyone else
        cands = sorted(candidates, key=lambda r: r.id)
        chosen = next((r for r in cands if r.id >= self._next), cands[0])
        self._next = chosen.id + 1
        return chosen


class LeastLoadedPolicy(Policy):
    name = "least-loaded"

    def pick(self, candidates, prompt):
        return min(candidates,
                   key=lambda r: (r.depth(), r.occupancy(), r.id))


class PrefixAffinityPolicy(Policy):
    name = "prefix"

    def __init__(self):
        self.hits = 0       # dispatches routed by a fingerprint match
        self.misses = 0     # dispatches that fell back to least-loaded
        self._fallback = LeastLoadedPolicy()

    @staticmethod
    def score(replica: Replica, hashes: List[int]) -> int:
        """Consecutive-from-root page-prefix depth the replica's
        fingerprint covers (KV rows depend on the whole causal prefix,
        so a gap ends the usable match exactly like in the trie)."""
        fp = replica.fingerprint
        depth = 0
        for h in hashes:
            if h not in fp:
                break
            depth += 1
        return depth

    def pick(self, candidates, prompt):
        hashes: List[int] = []
        if prompt is not None and len(prompt) > 0:
            page_size = candidates[0].page_size
            hashes = prompt_page_hashes(np.asarray(prompt), page_size)
        best, best_depth = [], 0
        if hashes:
            for r in candidates:
                d = self.score(r, hashes)
                if d > best_depth:
                    best, best_depth = [r], d
                elif d == best_depth and best_depth > 0:
                    best.append(r)
        if not best:
            self.misses += 1
            return self._fallback.pick(candidates, prompt)
        self.hits += 1
        return self._fallback.pick(best, prompt)


def make_policy(policy) -> Policy:
    """Accept a policy name or an already-built Policy instance."""
    if isinstance(policy, Policy):
        return policy
    table = {"rr": RoundRobinPolicy, "round-robin": RoundRobinPolicy,
             "least-loaded": LeastLoadedPolicy,
             "prefix": PrefixAffinityPolicy,
             "prefix-affinity": PrefixAffinityPolicy}
    if policy not in table:
        raise ValueError(f"unknown dispatch policy {policy!r} "
                         f"(choose from {sorted(table)})")
    return table[policy]()
