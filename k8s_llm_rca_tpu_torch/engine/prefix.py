"""Page-granular prefix cache: the port of
``k8s_llm_rca_tpu/engine/prefix.py`` without its store tiers.

The RCA agent threads grow monotonically: every retry and every
per-entity audit re-submits the thread's whole history, so consecutive
runs share almost their entire prompt.  This cache shares the paged KV of
page-aligned prompt prefixes between sequences.

- The key of page ``i`` of a prompt is a chained digest of tokens
  ``[0, (i+1)*P)`` (P = page size): KV at a position depends on every
  earlier token, so a page is reusable only under an exact full-prefix
  match.
- Shared pages belong to the allocator owner tag ``CACHE_OWNER``; per-page
  refcounts track the sequences using them.  Pages at refcount 0 stay
  resident and chained in an LRU; ``evict`` frees them back to the
  allocator under pool pressure.  A page with refcount > 0 is never
  evicted, so running sequences' block tables stay valid.
- Sharing is read-only: a shared page covers positions < n_cached <=
  prompt length, and decode writes only at positions >= prompt length.
- ``insert`` keeps the shared run contiguous: it stops at the first full
  page whose key is already chained to a different page (a concurrent
  duplicate prefill), which stays private to its sequence.

The JAX cache can demote evicted pages into a host/disk ``PrefixStore``
and promote them back on a later match; those tiers are not ported
(ROADMAP Queue 1 item 3), so eviction here discards, as the JAX cache
does without a store.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from k8s_llm_rca_tpu_torch.utils.logging import METRICS

# allocator owner tag for shared pages (sequence ids are >= 0)
CACHE_OWNER = -2


def _page_keys(prompt_ids: Sequence[int], n_pages: int,
               page_size: int) -> List[bytes]:
    """Chained digests: key_i = H(key_{i-1} || tokens of page i), so each
    key depends on the full prefix at O(n) total cost."""
    keys: List[bytes] = []
    prev = b""
    arr = np.asarray(prompt_ids[:n_pages * page_size], np.int32)
    for i in range(n_pages):
        h = hashlib.sha1(prev)
        h.update(arr[i * page_size:(i + 1) * page_size].tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


class PrefixCache:
    """Host-side index of shared prompt-prefix pages.

    The allocator stays the single owner-of-record of page ids; this class
    only re-tags ownership (sequence <-> ``CACHE_OWNER`` via ``transfer``)
    and decides which refcount-0 pages to evict.  ``count`` is the engine's
    counter (``EngineBase._count``)."""

    def __init__(self, allocator, page_size: int,
                 count: Optional[Callable] = None):
        self.allocator = allocator
        self.page_size = page_size
        self._count = count or (
            lambda name, value=1.0: METRICS.inc(name, value))
        self._chain: Dict[bytes, int] = {}           # prefix digest -> page
        self._key_of: Dict[int, bytes] = {}          # page -> its digest
        self._ref: Dict[int, int] = {}               # page -> active users
        self._lru: OrderedDict[int, None] = OrderedDict()   # refcount-0 pages

    @property
    def n_resident(self) -> int:
        return len(self._key_of)

    @property
    def n_evictable(self) -> int:
        return len(self._lru)

    def match(self, prompt_ids: Sequence[int]) -> Tuple[List[int], int]:
        """Longest chained page-aligned prefix of ``prompt_ids``: (pages,
        n_cached_tokens), each returned page's refcount bumped.  Reuse
        stops at the last FULL page strictly before the prompt's end, so
        at least one token is re-prefilled (the sampler needs its
        logits)."""
        P = self.page_size
        limit = (len(prompt_ids) - 1) // P
        pages: List[int] = []
        for key in _page_keys(prompt_ids, limit, P):
            page = self._chain.get(key)
            if page is None:
                break
            pages.append(page)
        if pages:
            self._count("engine.prefix_hits_l0", len(pages))
        for p in pages:
            self._acquire(p)
        return pages, len(pages) * P

    def has_prefix(self, prompt_ids: Sequence[int]) -> bool:
        """Non-acquiring probe: would ``match`` return any pages?  Checks
        the first page's digest only, enough for admission grouping to
        route hits away from a miss batch."""
        P = self.page_size
        if (len(prompt_ids) - 1) // P < 1:
            return False
        (key,) = _page_keys(prompt_ids, 1, P)
        return key in self._chain

    def _acquire(self, page: int) -> None:
        if self._ref.get(page, 0) == 0:
            self._lru.pop(page, None)
        self._ref[page] = self._ref.get(page, 0) + 1

    def insert(self, prompt_ids: Sequence[int], table: Sequence[int],
               owner: int, n_matched_pages: int) -> int:
        """Chain the full prompt pages of a just-prefilled sequence.

        ``table`` holds its page ids in prompt order; pages ``[0,
        n_matched_pages)`` came from ``match``.  Each later FULL page moves
        from ``owner`` to the cache and is chained, up to the first digest
        already chained to a different page.  Returns how many leading
        shared pages the sequence now holds references to."""
        P = self.page_size
        n_full = len(prompt_ids) // P
        n_shared = n_matched_pages
        keys = _page_keys(prompt_ids, n_full, P)
        for i in range(n_matched_pages, n_full):
            key = keys[i]
            existing = self._chain.get(key)
            page = int(table[i])
            if existing is not None:
                if existing != page:
                    break                        # duplicate: keep private
                self._acquire(page)              # re-chained same page
            else:
                self.allocator.transfer([page], owner, CACHE_OWNER)
                self._chain[key] = page
                self._key_of[page] = key
                self._ref[page] = 1
            n_shared = i + 1
        return n_shared

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; refcount-0 pages become evictable
        (most recently released = last evicted)."""
        for p in pages:
            n = self._ref.get(p)
            if n is None or n <= 0:
                raise RuntimeError(f"release of unreferenced page {p}")
            if n == 1:
                self._ref[p] = 0
                self._lru[p] = None
                self._lru.move_to_end(p)
            else:
                self._ref[p] = n - 1

    def evict(self, n: int) -> int:
        """Free up to ``n`` least-recently-used refcount-0 pages back to
        the allocator; returns how many were freed."""
        victims: List[int] = []
        while len(victims) < n and self._lru:
            victims.append(self._lru.popitem(last=False)[0])
        for page in victims:
            key = self._key_of.pop(page)
            del self._chain[key]
            del self._ref[page]
            self.allocator.free([page], CACHE_OWNER)
        if victims:
            METRICS.inc("engine.prefix_evicted_pages", len(victims))
        return len(victims)
