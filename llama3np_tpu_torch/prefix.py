"""Prefix caching: page-granular KV reuse across serving requests.

Counterpart of `llama3np_tpu.prefix`, the same host code (the port keeps
its own copy and imports nothing of the JAX package).  Requests that share
a prompt prefix (system prompts, few-shot headers, multi-turn
continuations) reuse the KV pages an earlier request computed: admission
skips the prefill of every fully covered page and prefills only the
suffix (`serving.BatchEngine(prefix_cache=True)`).

The paged pool ([NL, P, KVH, page, HD], kvcache.py) is already reached
through per-slot block tables, so sharing a page is host bookkeeping: two
slots' block tables name the same page id, and neither the plain gather
path nor the paged-attention kernel changes (the kernel only reads the
pool).  Shared pages are never written: only FULL pages strictly before
the first uncached token are shared, and decode writes land at pos >=
prompt length, past them.

  * Entries form hash-consed chains keyed by (parent entry, page tokens):
    exact dict keys, so no hash collision can match a wrong page.
  * The registry holds its own refcount on each cached page
    (PageAllocator refcounts); pages stay cached after their request
    finishes and are evicted LRU, leaves first, only under pool pressure.
  * Finished requests register their prompt + generated pages, so a
    follow-up turn that extends the conversation reuses its history.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class _Entry:
    eid: int
    key: Tuple[int, Tuple[int, ...]]  # (parent eid or -1, page token tuple)
    page: int
    children: int = 0
    last_use: int = 0


class PrefixRegistry:
    """Chain registry of cached full pages of token history.

    All methods are host-side and O(pages touched); the device never sees
    this structure — only the block tables it produces.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._by_key: Dict[Tuple[int, Tuple[int, ...]], _Entry] = {}
        self._by_id: Dict[int, _Entry] = {}
        self._ids = itertools.count()
        self._clock = itertools.count()
        # Observability counters (tests + stats lines).
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._by_id)

    # -- lookup ---------------------------------------------------------------

    def lookup(self, tokens: Sequence[int],
               max_pages: Optional[int] = None) -> Tuple[int, List[int]]:
        """Longest cached page-chain prefix of `tokens`.

        Returns (n_hit_pages, page_ids).  Only considers full pages, and at
        most `max_pages` of them (the caller caps so at least one suffix
        token remains to produce admission logits).  Bumps LRU clocks on the
        whole matched path.
        """
        page = self.page_size
        limit = len(tokens) // page
        if max_pages is not None:
            limit = min(limit, max_pages)
        parent, pages, path = -1, [], []
        for i in range(limit):
            chunk = tuple(tokens[i * page:(i + 1) * page])
            e = self._by_key.get((parent, chunk))
            if e is None:
                break
            pages.append(e.page)
            path.append(e)
            parent = e.eid
        now = next(self._clock)
        for e in path:
            e.last_use = now
        if pages:
            self.hits += 1
            self.hit_tokens += len(pages) * page
        else:
            self.misses += 1
        return len(pages), pages

    # -- registration -----------------------------------------------------------

    def register(self, tokens: Sequence[int], page_ids: Sequence[int],
                 allocator) -> int:
        """Cache the full pages of `tokens` whose K/V lives in `page_ids`.

        `page_ids[i]` holds tokens[i*page:(i+1)*page]; only full pages are
        registered.  Pages newly added to the registry gain a registry
        refcount (allocator.share) so they survive the owning request's
        free.  When a chain entry already exists (the same content was
        computed twice), the existing page is kept and the caller's copy is
        simply not registered — it is freed with the request as usual.
        Returns the number of newly registered pages.
        """
        page = self.page_size
        n_full = min(len(tokens) // page, len(page_ids))
        parent, added = -1, 0
        now = next(self._clock)
        for i in range(n_full):
            chunk = tuple(tokens[i * page:(i + 1) * page])
            key = (parent, chunk)
            e = self._by_key.get(key)
            if e is None:
                e = _Entry(next(self._ids), key, int(page_ids[i]),
                           last_use=now)
                allocator.share([e.page])
                self._by_key[key] = e
                self._by_id[e.eid] = e
                if parent != -1:
                    self._by_id[parent].children += 1
                added += 1
            else:
                e.last_use = now
            parent = e.eid
        return added

    # -- eviction ---------------------------------------------------------------

    def _evictable(self, allocator) -> List[_Entry]:
        """Leaf entries whose page only the registry holds (rc == 1):
        evicting one returns a page to the free list immediately."""
        return [e for e in self._by_id.values()
                if e.children == 0 and allocator.refcount(e.page) == 1]

    def evictable_pages(self, allocator) -> int:
        """Pages the registry could free right now if asked — counts whole
        evictable leaf-chains (evicting a leaf may expose its parent)."""
        # Walk leaves upward: a chain segment is reclaimable while each
        # entry is rc==1 and (after its child goes) has no other children.
        n = 0
        children = {e.eid: e.children for e in self._by_id.values()}
        stack = [e for e in self._by_id.values()
                 if children[e.eid] == 0 and allocator.refcount(e.page) == 1]
        seen = set()
        while stack:
            e = stack.pop()
            if e.eid in seen:
                continue
            seen.add(e.eid)
            n += 1
            pid = e.key[0]
            if pid != -1:
                children[pid] -= 1
                parent = self._by_id[pid]
                if children[pid] == 0 and allocator.refcount(parent.page) == 1:
                    stack.append(parent)
        return n

    def evict(self, n_pages: int, allocator) -> int:
        """Free up to `n_pages` cached pages, least-recently-used leaves
        first.  Returns how many pages actually went back to the free list."""
        freed = 0
        while freed < n_pages:
            cands = self._evictable(allocator)
            if not cands:
                break
            e = min(cands, key=lambda e: e.last_use)
            self._drop(e, allocator)
            freed += 1
        return freed

    def _drop(self, e: _Entry, allocator) -> None:
        del self._by_key[e.key]
        del self._by_id[e.eid]
        if e.key[0] != -1:
            self._by_id[e.key[0]].children -= 1
        allocator.free([e.page])
        self.evictions += 1

    def clear(self, allocator) -> None:
        for e in list(self._by_id.values()):
            del self._by_key[e.key]
            del self._by_id[e.eid]
            allocator.free([e.page])

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._by_id), "hits": self.hits,
                "misses": self.misses, "hit_tokens": self.hit_tokens,
                "evictions": self.evictions}
