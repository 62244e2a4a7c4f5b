"""Paged KV cache: refcounted block allocator + per-request block tables
(PyTorch port of `repro.serve.paged_cache`).

The device side is a pool of `n_pages` fixed-size pages per layer,
allocated once; the host side is this allocator handing page ids to
requests as they grow.  Pages are REFCOUNTED so sequences can share
them: prefix caching (serve/prefix.py) pins full prompt pages in a
radix trie, and `PagedKVCache.fork` lets a new sequence adopt another's
prefix.  A sequence about to WRITE into a page with refcount > 1 first
copies it and patches its own block table (copy-on-write).  Unlike the
JAX package, pools are torch tensors updated in place: a page copy is an
indexed assignment into every pool leaf, not a donated rebuild.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List

import numpy as np
import torch


def _copy_pool_pages(pools, src: List[int], dst: List[int]) -> None:
    """Copy the rows of pages `src` to pages `dst` in every pool leaf, in
    place.  Page is axis 1 on every leaf (axis 0 is the layer)."""
    for leaf in pools.values():
        if isinstance(leaf, dict):
            _copy_pool_pages(leaf, src, dst)
        else:
            s = torch.as_tensor(src, dtype=torch.long, device=leaf.device)
            d = torch.as_tensor(dst, dtype=torch.long, device=leaf.device)
            leaf[:, d] = leaf[:, s]


class OutOfPagesError(RuntimeError):
    pass


class BlockAllocator:
    """Free-list allocator over `n_pages` page ids with owner tracking
    and per-page refcounts.

    Invariants (property-tested in tests/test_paged_cache.py and
    tests/test_prefix_cache.py):
      * a free page is never handed out twice without reaching
        refcount 0 in between
      * every allocated page has refcount == number of owner-ledger
        entries naming it, and refcounts are never negative
      * n_free + (unique allocated pages) == n_pages at all times
    `free`/`free_pages` DECREF and only collect pages that hit
    refcount 0; `share` increfs an allocated page into another owner's
    ledger.  Freeing under an unknown owner, or a page the owner does
    not hold, raises — a silent no-op there would mask double-frees.
    """

    def __init__(self, n_pages: int):
        assert n_pages > 0
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._held: Dict[int, List[int]] = {}
        self._ref: Dict[int, int] = {}      # page -> refcount (absent: free)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def n_held(self, owner: int) -> int:
        return len(self._held.get(owner, ()))

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.n_pages

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, owner: int, n: int = 1) -> List[int]:
        if len(self._free) < n:
            raise OutOfPagesError(
                f"need {n} pages, {len(self._free)} free of {self.n_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self._held.setdefault(owner, []).extend(pages)
        return pages

    def share(self, owner: int, pages: Iterable[int]) -> None:
        """Incref `pages` (which must be allocated) into `owner`'s
        ledger: the owner now holds them like its own, and `free`/
        `free_pages` decref symmetrically.  Sharing a free page raises
        (a hard error, not an assert: silently reviving a free page
        would hand it out twice)."""
        pages = list(pages)
        for p in pages:
            if self._ref.get(p, 0) <= 0:
                raise ValueError(f"share of free page {p}")
            self._ref[p] += 1
        if pages:
            self._held.setdefault(owner, []).extend(pages)

    def _decref(self, page: int, collected: List[int]) -> None:
        r = self._ref[page] - 1
        if r < 0:
            raise RuntimeError(f"refcount underflow on page {page}")
        if r == 0:
            del self._ref[page]
            self._free.append(page)
            collected.append(page)
        else:
            self._ref[page] = r

    def free(self, owner: int) -> List[int]:
        """Decref every page `owner` holds; returns the pages that hit
        refcount 0 (actually reclaimed).  Unknown owner raises."""
        if owner not in self._held:
            raise KeyError(f"free of unknown owner {owner}")
        collected: List[int] = []
        for p in self._held.pop(owner):
            self._decref(p, collected)
        return collected

    def free_pages(self, owner: int, pages: List[int]) -> List[int]:
        """Decref specific pages from `owner`'s holding (speculative
        rollback frees the TAIL of a block table, not the whole
        sequence).  Freeing a page the owner does not hold raises —
        it would double-free.  Returns the pages reclaimed."""
        if owner not in self._held:
            raise KeyError(f"free_pages of unknown owner {owner}")
        held = self._held[owner]
        collected: List[int] = []
        for p in pages:
            held.remove(p)      # ValueError on double-free, by design
            self._decref(p, collected)
        if not held:
            self._held.pop(owner, None)
        return collected


@dataclass
class SequenceState:
    """Host-side view of one request's cache residency."""
    rid: int
    pages: List[int] = field(default_factory=list)
    length: int = 0                     # tokens materialized in the pool

    def capacity(self, page_size: int) -> int:
        return len(self.pages) * page_size


class PagedKVCache:
    """Device pools + block tables for a dynamic batch.

    `pools` is the model's paged cache pytree (per-layer page pools);
    `table_for` assembles the padded (max_pages,) block-table row a lane
    feeds to `DecoderLM.serve_step`.  Page 0 pads unused table entries —
    padded slots are masked by length, never read into scores.  The
    pools hold one page more than the allocator's `n_pages`: the dump
    page of `models.attention.page_rows`, which no table names.

    When `prefix_index` is attached (serve/prefix.py), admission can
    adopt trie-resident prompt pages (`seq.length` starts past them) and
    allocation pressure reclaims refcount-1 trie pages LRU-first before
    giving up.  Writes go through `prepare_write`, which copy-on-writes
    any shared page in the write range.

    For families with no attention layers at all (xlstm, pure-mamba
    zamba) `pools` is {} and the cache degenerates to a host-side token
    budget: pages still gate admission/growth/preemption, so the
    scheduler and engine stay family-agnostic while the actual decode
    state lives in the per-lane StateArena (serve/state.py).
    """

    def __init__(self, model, n_pages: int, page_size: int, max_seq: int,
                 kv_dtype=torch.bfloat16, specs=None, device=None):
        """`specs` takes a precomputed pool ParamSpec tree (the "paged"
        half of `DecoderLM.decode_state_specs`); defaults to asking the
        model directly.  Pools are allocated on `device`."""
        assert max_seq % page_size == 0
        self.page_size = page_size
        self.max_pages = max_seq // page_size
        self.allocator = BlockAllocator(n_pages)
        self.seqs: Dict[int, SequenceState] = {}
        self.prefix_index = None            # set by the engine (optional)
        self.cow_copies = 0                 # pages copied on write
        self.pages_shared = 0               # pages adopted via share/fork
        if specs is None:
            specs = model.paged_cache_specs(n_pages, page_size, kv_dtype)
        from repro_torch.models.common import map_specs
        # allocated once and only ever written in place: the captured
        # step graphs (serve/graphs.py) hold these addresses
        self.pools = map_specs(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
            specs)

    # -- residency ------------------------------------------------------
    def _reclaim(self, n: int) -> bool:
        """True once `n` pages are free, evicting refcount-1 prefix-trie
        pages (LRU) to get there if an index is attached."""
        if self.allocator.can_alloc(n):
            return True
        if self.prefix_index is not None:
            self.prefix_index.evict(n - self.allocator.n_free)
        return self.allocator.can_alloc(n)

    def probe_admit(self, prompt_len: int, prompt=None):
        """Admission probe: fresh prompt pages + 1 growth page must be
        free or reclaimable (matched trie pages are excluded from the
        reclaimable count — admission would pin, not evict, them).
        Probes never touch LRU stamps: only an actual admission
        refreshes a prefix's recency.  Returns the matched trie node
        path (possibly empty) to pass into `admit` — the prompt is
        walked once per admission, not once for the probe and again for
        the adoption — or None when the request cannot fit now."""
        nodes = []
        if self.prefix_index is not None and prompt is not None:
            nodes = self.prefix_index.match_nodes(
                np.asarray(prompt, np.int32))
        fresh = self.pages_needed(prompt_len) - len(nodes) + 1
        need = fresh - self.allocator.n_free
        if need <= 0:       # free pages suffice: skip the trie walk (the
            return nodes    # common case on the per-step scheduler path)
        if self.prefix_index is None:
            return None
        shared = {n.page for n in nodes}
        if self.prefix_index.n_evictable(exclude=shared,
                                         limit=need) < need:
            return None
        return nodes

    def can_admit(self, prompt_len: int, prompt=None) -> bool:
        return self.probe_admit(prompt_len, prompt) is not None

    def admit(self, rid: int, prompt_len: int, prompt=None,
              match=None) -> SequenceState:
        """Allocate residency for a prompt.  With a prefix index and the
        prompt's tokens, trie-matched full pages are ADOPTED (shared,
        refcount+1) and `seq.length` starts at the matched token count —
        the caller prefills only the tail.  `match` takes a node path
        from `probe_admit` to reuse instead of re-walking the trie.
        Raises OutOfPagesError when the fresh remainder cannot be
        allocated even after eviction."""
        if match is None:
            match = []
            if self.prefix_index is not None and prompt is not None:
                match = self.prefix_index.match_nodes(
                    np.asarray(prompt, np.int32))
        shared = [n.page for n in match]
        cached = len(shared) * self.page_size
        # pin matched pages under this owner BEFORE any eviction runs:
        # a just-matched page must never be reclaimed out from under us
        self.allocator.share(rid, shared)
        fresh = self.pages_needed(prompt_len) - len(shared)
        if not self._reclaim(fresh):
            if shared:
                self.allocator.free(rid)
            raise OutOfPagesError(
                f"need {fresh} pages, {self.allocator.n_free} free of "
                f"{self.allocator.n_pages}")
        pages = shared + self.allocator.alloc(rid, fresh)
        if match:
            self.prefix_index.touch(match)
        seq = SequenceState(rid=rid, pages=pages, length=cached)
        self.pages_shared += len(shared)
        self.seqs[rid] = seq
        return seq

    def fork(self, new_rid: int, src_rid: int, prefix_len: int
             ) -> SequenceState:
        """New sequence sharing `src_rid`'s first `prefix_len` tokens
        (beam/parallel sampling from one prompt).  Shared pages are
        adopted by refcount; a later write into a partially-shared tail
        page triggers copy-on-write via `prepare_write`."""
        src = self.seqs[src_rid]
        assert 0 <= prefix_len <= src.length, (prefix_len, src.length)
        assert new_rid not in self.seqs, new_rid
        n_shared = -(-prefix_len // self.page_size)
        shared = src.pages[:n_shared]
        self.allocator.share(new_rid, shared)
        pages = list(shared)
        if not pages:               # every sequence holds >= 1 page, the
            if not self._reclaim(1):  # same floor admit() guarantees
                raise OutOfPagesError("fork: no page for empty prefix")
            pages = self.allocator.alloc(new_rid, 1)
        seq = SequenceState(rid=new_rid, pages=pages,
                            length=prefix_len)
        self.pages_shared += len(shared)
        self.seqs[new_rid] = seq
        return seq

    def pages_needed(self, prompt_len: int) -> int:
        return -(-max(prompt_len, 1) // self.page_size)

    def ensure_room(self, rid: int, extra_tokens: int = 1) -> bool:
        """Grow the request's page list to fit `extra_tokens` more; False
        if the pool is exhausted even after prefix-index eviction (caller
        may preempt/queue)."""
        seq = self.seqs[rid]
        need_total = seq.length + extra_tokens
        if need_total > self.max_pages * self.page_size:
            return False
        while seq.capacity(self.page_size) < need_total:
            if not self._reclaim(1):
                return False
            seq.pages.extend(self.allocator.alloc(rid, 1))
        return True

    # -- copy-on-write --------------------------------------------------
    def cow_for_write(self, rid: int, n_tokens: int) -> bool:
        """Copy-on-write every shared page the next `n_tokens`-token
        append will touch: copy their rows to fresh pages in ONE device
        call, patch this sequence's block table, decref the originals.
        False if the copy targets cannot be allocated (pool
        exhausted)."""
        seq = self.seqs[rid]
        if n_tokens <= 0:
            return True
        first = seq.length // self.page_size
        last = (seq.length + n_tokens - 1) // self.page_size
        idxs = [i for i in range(first, min(last + 1, len(seq.pages)))
                if self.allocator.refcount(seq.pages[i]) > 1]
        if not idxs:
            return True
        if not self._reclaim(len(idxs)):
            return False
        fresh = self.allocator.alloc(rid, len(idxs))
        olds = [seq.pages[i] for i in idxs]
        _copy_pool_pages(self.pools, olds, fresh)
        for i, new in zip(idxs, fresh):
            seq.pages[i] = new
        self.allocator.free_pages(rid, olds)    # decref, never collects
        self.cow_copies += len(idxs)
        return True

    def prepare_write(self, rid: int, n_tokens: int) -> bool:
        """Make the next `n_tokens`-token append safe: capacity grown
        (`ensure_room`) and shared pages in the write range copied
        (`cow_for_write`).  False on pool exhaustion."""
        return (self.ensure_room(rid, n_tokens)
                and self.cow_for_write(rid, n_tokens))

    def release(self, rid: int) -> None:
        self.allocator.free(rid)
        self.seqs.pop(rid, None)

    def trim(self, rid: int, new_length: int) -> int:
        """Roll back to `new_length` tokens (speculative reject): drop
        block-table entries past the last live page and decref them —
        a page the prefix trie (or a fork) still references survives
        with its rows intact.  Stale rows beyond `new_length` inside
        kept pages are never read (every consumer masks by length) and
        are overwritten in place by the next append.  Returns the number
        of table entries dropped."""
        seq = self.seqs[rid]
        assert 0 <= new_length <= seq.length, (new_length, seq.length)
        seq.length = new_length
        keep = -(-max(new_length, 1) // self.page_size)
        drop = seq.pages[keep:]
        if drop:
            seq.pages = seq.pages[:keep]
            self.allocator.free_pages(rid, drop)
        return len(drop)

    # -- device-facing views -------------------------------------------
    def table_for(self, rid: int) -> np.ndarray:
        seq = self.seqs[rid]
        row = np.zeros(self.max_pages, np.int32)
        row[:len(seq.pages)] = seq.pages
        return row

    def occupancy(self) -> float:
        return self.allocator.occupancy()

    def n_free_or_cached(self) -> int:
        """Pages free or held ONLY by the prefix index (reclaimable on
        demand) — the drain invariant tests check against n_pages."""
        n = self.allocator.n_free
        if self.prefix_index is not None:
            n += self.prefix_index.n_evictable()
        return n

    def kv_bytes(self) -> int:
        def walk(tree):
            if isinstance(tree, dict):
                return sum(walk(v) for v in tree.values())
            return tree.numel() * tree.element_size()
        return walk(self.pools)
