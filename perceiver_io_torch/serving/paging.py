"""KV page pool and per-request page arithmetic for the serving engine.

Port of the host half of ``perceiver_io_tpu/serving/paging.py``: a
refcounted free list over a fixed pool of physical KV pages with a
deterministic allocation order (no clocks, no randomness, no hashing), so a
replayed admission sequence allocates the same page layout.

Policy: page 0 is the reserved trash page (free slots' tables point at it and
it is never allocated); an admission reserves its whole ``pages_for_request``
up front (covering prefill bucket plus the full ``max_new_tokens`` budget,
capped at the window), so a running slot can never fault on a page and pool
exhaustion surfaces only as admission backpressure; eviction returns the
pages; the free list is a min-heap, so allocation always hands out the
lowest free ids. Refcounts (``retain``) are the prefix-sharing primitive:
the cross-request radix ``PrefixCache`` maps page-aligned prompt prefixes
(``page_keys_for_prompt``) onto page-id runs of the pool and holds one
reference per cached page, so a cached run outlives the request that built
it. The JAX package's environment kill-switches are TPU rollback levers and
are not ported.
"""

from __future__ import annotations

import itertools
from collections import Counter
from heapq import heapify, heappop, heappush
from typing import Dict, List, Optional, Sequence, Set, Tuple


def page_keys_for_prompt(prompt, page_size: int, max_latents: int) -> Tuple[Tuple[int, ...], ...]:
    """The prompt's cacheable page keys: one tuple of ``page_size`` token ids
    per full page strictly below the latent-region boundary (position
    ``n - max_latents``). Pages touching the latent region are never shared:
    the one-shot prefill normalizes latent-region rows with ``q_norm``, so
    their KV depends on the prompt length, not just the prefix."""
    n = len(prompt)
    full = max(n - max_latents, 0) // page_size
    return tuple(tuple(int(t) for t in prompt[k * page_size:(k + 1) * page_size]) for k in range(full))


def pages_for_tokens(tokens: int, page_size: int) -> int:
    """Pages needed to back ``tokens`` ring positions."""
    return -(-tokens // page_size)


def pages_for_request(bucket: int, max_new_tokens: int, window: int, page_size: int) -> int:
    """A request's up-front reservation: its covering prefill bucket plus the
    whole generation budget, capped at the window (the ring wraps into pages
    it already holds)."""
    return pages_for_tokens(min(bucket + max_new_tokens, window), page_size)


class PagePool:
    """Refcounted allocator over ``num_pages`` physical KV pages; ``allocate``
    always returns the lowest free ids in ascending order."""

    def __init__(self, num_pages: int, reserved: int = 1):
        if num_pages < reserved + 1:
            raise ValueError(f"num_pages must exceed the {reserved} reserved page(s), got {num_pages}")
        self.num_pages = num_pages
        self.reserved = reserved
        self._refcount = [0] * num_pages
        self._free: List[int] = list(range(reserved, num_pages))
        heapify(self._free)
        self.total_allocations = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - self.reserved) - len(self._free)

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def allocate(self, n: int) -> List[int]:
        """Claim ``n`` pages (refcount 1 each), lowest ids first. Callers gate
        on ``can_allocate``, so exhaustion here is a caller bug."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise RuntimeError(f"page pool exhausted: need {n}, have {len(self._free)} free "
                               f"(of {self.num_pages - self.reserved} allocatable)")
        pages = [heappop(self._free) for _ in range(n)]
        for p in pages:
            self._refcount[p] = 1
        self.total_allocations += n
        return pages

    def _validate_ids(self, pages: Sequence[int]) -> None:
        bad = [p for p in pages if not 0 <= p < self.num_pages]
        if bad:
            raise ValueError(f"page id(s) {bad} outside pool of {self.num_pages}")

    def refcount(self, page: int) -> int:
        self._validate_ids([page])
        return self._refcount[page]

    def shared_count(self, pages: Sequence[int]) -> int:
        """How many of ``pages`` are referenced more than once (one
        validation pass for the whole list)."""
        self._validate_ids(pages)
        return sum(1 for p in pages if self._refcount[p] >= 2)

    def retain(self, pages: Sequence[int]) -> None:
        """Add one reference to each page. The whole list is validated before
        any refcount moves."""
        self._validate_ids(pages)
        for p in pages:
            if self._refcount[p] < 1:
                raise ValueError(f"page {p} is not allocated")
        for p in pages:
            self._refcount[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; pages reaching 0 return to the free
        list. A double free (duplicates counted against the refcount) raises
        before any refcount moves."""
        self._validate_ids(pages)
        for p, n in Counter(pages).items():
            if self._refcount[p] < n:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                heappush(self._free, p)


class _TrieNode:
    """One cached page: its token key, its pool page id, children keyed by
    the next page's token tuple, and a last-used stamp from the cache's
    touch counter (no clocks)."""

    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key, page: int, parent, last_used: int):
        self.key = key
        self.page = page
        self.children: Dict[tuple, "_TrieNode"] = {}
        self.parent = parent
        self.last_used = last_used


class PrefixCache:
    """Cross-request radix prefix cache over a shared ``PagePool``: a trie
    keyed on exact page-aligned prompt-token tuples, one node per page,
    mapping each cached prefix to a run of page ids. The cache holds one pool
    reference per cached page (``retain`` at insert); a consumer of a probe
    retains the pages it uses itself. No KV bytes move.

    ``evict`` is refcount-aware LRU over leaves: only leaves whose page is
    held by the cache alone (refcount 1) are released, in (last_used, page
    id) order, cascading to parents that become such leaves. The LRU stamp
    is a counter driven by the probe/insert/touch history, so eviction is
    deterministic."""

    def __init__(self, pool: PagePool, page_size: int, kv_quant: Optional[str] = None):
        # the pages carry the pool's byte layout (codes and scales under
        # kv_quant), so the mode is part of the cache's identity
        self.pool = pool
        self.page_size = page_size
        self.kv_quant = kv_quant
        self._children: Dict[tuple, _TrieNode] = {}  # the root's children
        self._nodes: Set[_TrieNode] = set()
        self._clock = itertools.count()
        self.hits = 0  # probes that matched >= 1 page
        self.misses = 0  # probes with keys that matched none
        self.inserted_pages = 0
        self.evicted_pages = 0
        self.evictions = 0  # evict() calls that freed pages

    def ensure_mode(self, kv_quant: Optional[str]) -> None:
        """Raise unless a reader's quantization mode is the one this cache's
        pages were written in."""
        if kv_quant != self.kv_quant:
            raise ValueError(
                f"prefix cache holds {self.kv_quant or 'full-precision'} pages but the reader runs "
                f"{kv_quant or 'full-precision'} — a cache never serves pages across quantization modes")

    @property
    def cached_pages(self) -> int:
        return len(self._nodes)

    def reclaimable_page_ids(self) -> List[int]:
        """Ids of cached pages held by the cache alone (refcount 1): what an
        eviction could return to the free list."""
        return [n.page for n in self._nodes if self.pool.refcount(n.page) == 1]

    def reclaimable_pages(self) -> int:
        return len(self.reclaimable_page_ids())

    def cached_page_ids(self) -> Set[int]:
        return {n.page for n in self._nodes}

    def stats(self) -> Dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "cached_pages": self.cached_pages,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "evictions": self.evictions,
        }

    def probe(self, keys: Sequence[tuple]) -> List[int]:
        """The longest cached run matching ``keys`` (the prompt's page keys in
        order), without taking references; stamps the matched path root to
        leaf and counts a hit or a miss."""
        run: List[int] = []
        children = self._children
        for key in keys:
            node = children.get(key)
            if node is None:
                break
            node.last_used = next(self._clock)
            run.append(node.page)
            children = node.children
        if run:
            self.hits += 1
        elif keys:
            self.misses += 1
        return run

    def peek_match_pages(self, keys: Sequence[tuple]) -> List[int]:
        """The page ids a probe would match, with no stamp and no count (the
        admission accounting's walk)."""
        run: List[int] = []
        children = self._children
        for key in keys:
            node = children.get(key)
            if node is None:
                break
            run.append(node.page)
            children = node.children
        return run

    def peek_match(self, keys: Sequence[tuple]) -> int:
        return len(self.peek_match_pages(keys))

    def touch(self, keys: Sequence[tuple]) -> None:
        """Stamp the matched path without counting a hit (the admission gate
        does this before evicting, so a blocked head's own prefix goes last)."""
        children = self._children
        for key in keys:
            node = children.get(key)
            if node is None:
                break
            node.last_used = next(self._clock)
            children = node.children

    def insert(self, keys: Sequence[tuple], pages: Sequence[int]) -> int:
        """Cache a prompt's page run: a node, and the cache's reference, for
        each page not cached yet along ``keys``; nodes already cached are
        stamped. Returns the number of newly cached pages."""
        if len(pages) < len(keys):
            raise ValueError(f"page run ({len(pages)}) shorter than keys ({len(keys)})")
        added = 0
        children = self._children
        parent: Optional[_TrieNode] = None
        for key, page in zip(keys, pages):
            node = children.get(key)
            if node is None:
                self.pool.retain([page])
                node = _TrieNode(key, int(page), parent, next(self._clock))
                children[key] = node
                self._nodes.add(node)
                added += 1
            else:
                node.last_used = next(self._clock)
            parent = node
            children = node.children
        self.inserted_pages += added
        return added

    def _drop(self, node: _TrieNode) -> None:
        siblings = node.parent.children if node.parent is not None else self._children
        del siblings[node.key]
        self._nodes.discard(node)
        self.pool.release([node.page])

    def evict(self, pages_needed: int) -> int:
        """Free up to ``pages_needed`` pages by releasing cache-only leaves in
        LRU order, cascading into parents that become cache-only leaves.
        Returns the pages freed (fewer where live sessions pin prefixes)."""
        freed = 0
        # one scan builds a heap of reclaimable leaves; parents join it as the
        # cascade reaches them. (last_used, page) is unique per node.
        heap = [(n.last_used, n.page, n) for n in self._nodes
                if not n.children and self.pool.refcount(n.page) == 1]
        heapify(heap)
        while freed < pages_needed and heap:
            _, _, victim = heappop(heap)
            parent = victim.parent
            self._drop(victim)
            freed += 1
            if parent is not None and not parent.children and self.pool.refcount(parent.page) == 1:
                heappush(heap, (parent.last_used, parent.page, parent))
        if freed:
            self.evictions += 1
            self.evicted_pages += freed
        return freed

    def _subtree(self, root: _TrieNode) -> List[_TrieNode]:
        """``root``'s subtree, children after their parents."""
        stack, order = [root], []
        while stack:
            node = stack.pop()
            order.append(node)
            stack.extend(node.children.values())
        return order

    def invalidate(self, keys: Sequence[tuple]) -> int:
        """Drop the cached subtree reached through ``keys[0]`` (every cached
        prefix through that page), children before parents. Not counted as
        an eviction. Returns the pages released."""
        root = self._children.get(keys[0]) if keys else None
        if root is None:
            return 0
        order = self._subtree(root)
        for node in reversed(order):
            self._drop(node)
        return len(order)

    def clear(self) -> int:
        """Release every cached reference, leaves inward; pages live sessions
        share stay allocated under theirs. Returns the pages released."""
        released = 0
        for root in list(self._children.values()):
            for node in reversed(self._subtree(root)):
                self._drop(node)
                released += 1
        return released
