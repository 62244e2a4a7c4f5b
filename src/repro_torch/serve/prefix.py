"""Prefix cache: a token-id radix trie over committed, full KV pages.

Edge serving traffic is dominated by shared prompt prefixes (chat
templates, few-shot preambles, spec-decode drafters re-seeing the same
context).  Every prefill token skipped is DRAM bandwidth and TTFT saved
— the exact axes EdgeCIM optimizes.  This index remembers the pages of
completed prompt prefills so later requests with the same prefix adopt
them by refcount instead of recomputing.

Structure: one trie level per FULL page (page_size tokens); a node's
key is its page's token tuple, so a path from the root spells out an
exact token prefix.  KV rows depend on the whole causal prefix, which
is why matching must walk from the root — two pages with identical
tokens under different parents hold different KV and live in different
nodes.

Ownership: the trie is one more allocator owner (`PREFIX_OWNER`).
Inserting a page increfs it; a sequence matching it increfs it again
(so eviction can never pull a page out from under a running request —
only refcount-1 pages, held by nobody but the trie, are evictable).
Eviction is leaf-first LRU, driven by allocation pressure from
`PagedKVCache._reclaim`.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

PREFIX_OWNER = -1          # allocator owner id reserved for the trie

# fingerprint root: the path hash of the empty prefix.  Path hashes fold
# the parent's hash into every level, so two identical page keys under
# different parents (different causal prefixes, different KV) hash
# differently.  A hash collision can only misroute a fleet dispatch
# (the replica still re-prefills on the real trie miss) — never corrupt
# KV, because adoption itself always walks the exact token trie.
ROOT_HASH = 0


def combine_hash(parent_hash: int, key: Tuple[int, ...]) -> int:
    """Path hash of a child page under `parent_hash`."""
    return hash((parent_hash,) + key)


def prompt_page_hashes(prompt: np.ndarray, page_size: int) -> List[int]:
    """Path hashes of every full-page prefix of `prompt` the trie could
    hold (same `len(prompt) - 1` cap as `match_nodes`) — the router
    side of the fingerprint: count how many consecutive entries a
    replica's fingerprint contains and you have its resident-prefix
    depth for this prompt, without touching the replica's thread."""
    limit = (len(prompt) - 1) // page_size
    h, out = ROOT_HASH, []
    for i in range(limit):
        h = combine_hash(h, tuple(int(t) for t in
                                  prompt[i * page_size:(i + 1) * page_size]))
        out.append(h)
    return out


class _Node:
    __slots__ = ("key", "page", "children", "parent", "last_use", "hash")

    def __init__(self, key: Optional[Tuple[int, ...]], page: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent
        self.last_use = 0
        self.hash = (ROOT_HASH if parent is None
                     else combine_hash(parent.hash, key))


class PrefixIndex:
    def __init__(self, allocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self.root = _Node(None, None, None)
        self._tick = itertools.count(1)
        # hit/skip rates live in serve Telemetry (counted once per
        # admission); the trie only tracks its own churn
        self.pages_inserted = 0
        self.pages_evicted = 0
        # fleet fingerprint: path hashes of every resident node,
        # maintained incrementally on insert/evict so exporting it is a
        # set copy, not a trie walk.  `version` bumps with every
        # membership change — a poller republishes only when it moved.
        self.version = 0
        self._hashes: Set[int] = set()

    def fingerprint(self) -> Tuple[int, frozenset]:
        """(version, resident path-hash set) — cheap to export per
        engine step; match against `prompt_page_hashes` output."""
        return self.version, frozenset(self._hashes)

    # -- size accounting ------------------------------------------------
    @property
    def n_pages(self) -> int:
        return sum(1 for _ in self._walk())

    def _walk(self, node: Optional[_Node] = None):
        node = node or self.root
        for child in node.children.values():
            yield child
            yield from self._walk(child)

    def n_evictable(self, exclude: Optional[Set[int]] = None,
                    limit: Optional[int] = None) -> int:
        """Pages only the trie holds (refcount 1) and not in `exclude` —
        what allocation pressure could reclaim right now.  `limit` stops
        the walk early once that many are found (admission probes only
        need to know 'at least n', not the exact count)."""
        exclude = exclude or set()
        count = 0
        for n in self._walk():
            if (self.allocator.refcount(n.page) == 1
                    and n.page not in exclude):
                count += 1
                if limit is not None and count >= limit:
                    break
        return count

    # -- lookup ---------------------------------------------------------
    def match_nodes(self, prompt: np.ndarray) -> List[_Node]:
        """Longest resident full-page prefix of `prompt` as trie nodes,
        capped at `len(prompt) - 1` tokens: at least the final prompt
        token is always recomputed so prefill emits the logits that
        sample the first output token.  Pure lookup — never touches LRU
        stamps (admission PROBES must not refresh recency: a request
        deferred every step would otherwise pin its prefix against
        eviction without ever running).  The caller stamps via `touch`
        when the match is actually adopted."""
        limit = (len(prompt) - 1) // self.page_size   # full pages usable
        node, nodes = self.root, []
        for i in range(limit):
            key = tuple(int(t) for t in
                        prompt[i * self.page_size:(i + 1) * self.page_size])
            child = node.children.get(key)
            if child is None:
                break
            nodes.append(child)
            node = child
        return nodes

    def touch(self, nodes: List[_Node]) -> None:
        """Refresh LRU recency of an adopted match path."""
        tick = next(self._tick)
        for node in nodes:
            node.last_use = tick

    def match(self, prompt: np.ndarray, touch: bool = True
              ) -> Tuple[int, List[int]]:
        """(tokens_matched, pages) convenience over `match_nodes`."""
        nodes = self.match_nodes(prompt)
        if touch and nodes:
            self.touch(nodes)
        return len(nodes) * self.page_size, [n.page for n in nodes]

    # -- commit ---------------------------------------------------------
    def insert(self, prompt: np.ndarray, pages: List[int]) -> int:
        """Commit the full-page prefix of a materialized prompt:
        `pages[i]` holds tokens `prompt[i*ps:(i+1)*ps]`.  New nodes
        incref their page under PREFIX_OWNER; a node that already exists
        keeps its original page (the duplicate stays solely with the
        sequence and dies on its release).  Returns pages adopted."""
        n_full = min(len(prompt) // self.page_size, len(pages))
        node, adopted = self.root, 0
        tick = next(self._tick)
        for i in range(n_full):
            key = tuple(int(t) for t in
                        prompt[i * self.page_size:(i + 1) * self.page_size])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, pages[i], node)
                self.allocator.share(PREFIX_OWNER, [pages[i]])
                node.children[key] = child
                self._hashes.add(child.hash)
                self.version += 1
                adopted += 1
            child.last_use = tick
            node = child
        self.pages_inserted += adopted
        return adopted

    # -- eviction -------------------------------------------------------
    def evict(self, n: int) -> int:
        """Free up to `n` pages, leaf-first in LRU order, skipping pages
        a live sequence still shares (refcount > 1).  Each outer pass
        collects ALL current evictable leaves and frees them
        oldest-first (one trie walk per generation of exposed parents,
        not per page).  Returns the number of pages actually freed."""
        freed = 0
        while freed < n:
            leaves = [node for node in self._walk()
                      if not node.children
                      and self.allocator.refcount(node.page) == 1]
            if not leaves:
                break
            for node in sorted(leaves, key=lambda x: x.last_use):
                if freed >= n:
                    break
                self.allocator.free_pages(PREFIX_OWNER, [node.page])
                del node.parent.children[node.key]
                self._hashes.discard(node.hash)
                self.version += 1
                self.pages_evicted += 1
                freed += 1
        return freed
