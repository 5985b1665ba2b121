"""Page-granular prefix cache, tiered HBM (L0) -> host RAM (L1) -> disk
(L2): the port of ``k8s_llm_rca_tpu/engine/prefix.py``.

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

Tiers: with a ``PrefixStore`` attached, ``evict`` DEMOTES the victims'
KV into the store (one gather through the engine's hook, the page-record
layout of KV spill, ``utils/pages.py``) before freeing them, and
``match`` extends past the resident chain into the store, PROMOTING hits
back into fresh pages (one in-place write).  Entries are keyed by the same
chained digests, so a promoted page holds the bytes eviction demoted and a
promoted hit runs the prefix-hit prefill path of an L0 hit.  The store is
shareable across the engines of one sharding: a restarted engine
promotes the pages its predecessor published (``flush_to_store``,
``snapshot_sequences``).  Without a store, eviction discards.

Under a device mesh (``MeshTier``, attached by the paged engine) each rank
keeps its own store object.  L1 is rank-local and holds the rank's share
of a page (its lanes under TP, the whole page under EP and FSDP); the disk
tier holds whole pages in the JAX package's layout, the layout an
unsharded engine of either package writes and promotes.  Every rank runs the
same host loop, so its L1, its LRU order and its disk index evolve alike:
an L1 overflow gathers the lanes on every rank at the same point, and one
rank (the mesh's lowest) writes the file.  An L2 read is decided once: the
writer reads and decodes the file and broadcasts hit or miss, and only
then do the other ranks read it, so no rank can see a file the writer is
still writing and the ranks' collectives never part.
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from k8s_llm_rca_tpu_torch.utils.logging import METRICS, get_logger
from k8s_llm_rca_tpu_torch.utils.pages import (
    decode_page_record, encode_page_record, rank_page_record,
    whole_page_record,
)

log = get_logger(__name__)

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


class MeshTier:
    """How one rank of a device mesh uses the store's tiers: ``tp`` (the
    rank config's ``TensorParallel``, None without TP) names the lanes it
    holds, ``packed`` an int4 pool; ``writer`` is the one rank that writes
    and removes files; ``agree`` shares the writer's L2 decision over
    ``group`` (None: the default group; one rank: no collective).
    ``device``: where the lane gather runs (the card under nccl).
    ``gathered`` and ``decided`` count the pages gathered whole and the L2
    decisions shared (each a collective)."""

    def __init__(self, tp, packed: bool, ranks: Sequence[int], group,
                 device=None):
        import torch.distributed as dist

        self.tp = tp
        self.packed = packed
        self.ranks = list(ranks)
        self.group = group
        self.writer_rank = min(self.ranks)
        self.rank = dist.get_rank()
        self.writer = self.rank == self.writer_rank
        nccl = dist.get_backend(group) == "nccl"
        self.device = device if nccl else None
        self.gathered = 0
        self.decided = 0

    @classmethod
    def for_mesh(cls, mesh, tp, packed: bool, device) -> "MeshTier":
        """The tier of this rank of ``mesh``: the decision's group spans the
        mesh's ranks (``runtime.mesh.mesh_group``)."""
        from k8s_llm_rca_tpu_torch.runtime.mesh import mesh_group

        ranks = sorted(int(r) for r in mesh.mesh.flatten().tolist())
        return cls(tp, packed, ranks, mesh_group(mesh), device)

    def same_layout(self, other: "MeshTier") -> bool:
        return (self.packed == other.packed and self.ranks == other.ranks
                and (self.tp is None) == (other.tp is None)
                and (self.tp is None or (self.tp.size, self.tp.rank)
                     == (other.tp.size, other.tp.rank)))

    def whole(self, rec: Dict[str, object]) -> Dict[str, object]:
        """The whole page of a share (a collective under TP)."""
        if self.tp is None:
            return rec
        self.gathered += 1
        return whole_page_record(rec, self.tp.group, self.packed,
                                 self.device)

    def share(self, rec: Dict[str, object]) -> Dict[str, object]:
        """This rank's share of a whole page (no collective)."""
        if self.tp is None:
            return rec
        return rank_page_record(rec, self.tp.size, self.tp.rank,
                                self.packed)

    def agree(self, hit: bool) -> bool:
        """The writer's ``hit`` on every rank."""
        if len(self.ranks) == 1:
            return hit
        import torch

        from k8s_llm_rca_tpu_torch.runtime.mesh import broadcast

        self.decided += 1
        flag = torch.tensor([int(hit)], dtype=torch.int32,
                            device=self.device or "cpu")
        return bool(broadcast(flag, self.writer_rank, self.group).item())


class PrefixStore:
    """Host-RAM (L1) + disk (L2) tiers of demoted prefix-page KV.

    Entries are per-page records (utils/pages.py layout, page axis length
    1) keyed by the chain digest of the page they held.  L1 is an LRU
    ``OrderedDict`` capped at ``host_pages``; overflow (and every put
    when ``host_pages == 0``) lands on disk when ``disk_dir`` is set,
    else is dropped (plain discard — exactly the pre-tier behavior).

    Disk entries are written with the WAL atomic recipe (utils/wal.py
    ``scan_wal``'s temp + fsync + ``os.replace``): a crash mid-write
    leaves either no file or a whole file, and the CRC frame catches a
    torn/corrupt one at load — ``get`` then answers None (silent cold
    miss) and drops the entry, never raising.  A fresh store pointed at
    an existing ``disk_dir`` re-indexes the surviving ``*.page`` files,
    which is how a restarted process (or a new replica handed the same
    directory) warm-starts across process death.

    The store is shareable among the engines of one sharding: it never
    touches a page allocator — engines gather INTO it and scatter OUT of
    it through their own hooks.  Under a device mesh it holds one rank's
    ``MeshTier`` (``attach_mesh``), whose lane gather and L2 decision are
    collectives of that mesh (on the card under nccl).  Single-threaded
    by design, like the cluster pump that shares it.
    """

    def __init__(self, host_pages: int = 0,
                 disk_dir: Optional[str] = None,
                 disk_pages: int = 0):
        if host_pages < 0:
            raise ValueError(f"host_pages={host_pages} must be >= 0")
        if disk_pages < 0:
            raise ValueError(f"disk_pages={disk_pages} must be >= 0")
        if disk_pages and not disk_dir:
            raise ValueError(
                f"disk_pages={disk_pages} needs disk_dir: the cap bounds "
                f"a disk tier that does not exist without a directory")
        self.host_pages = host_pages
        self.disk_dir = disk_dir
        self.disk_pages = disk_pages
        self._l1: "OrderedDict[bytes, Dict[str, object]]" = OrderedDict()
        self._l2: "OrderedDict[bytes, str]" = OrderedDict()
        # set by a paged engine under a device mesh (module docstring)
        self.mesh_tier: Optional[MeshTier] = None
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
            # deterministic re-index order (sorted names, not mtime):
            # LRU age across a restart is unknowable anyway, and sorted
            # keeps which-entry-gets-capped a pure function of the set
            for name in sorted(os.listdir(disk_dir)):
                if name.endswith(".page"):
                    try:
                        key = bytes.fromhex(name[:-len(".page")])
                    except ValueError:
                        continue        # foreign file, not an entry
                    self._l2[key] = os.path.join(disk_dir, name)

    # ------------------------------------------------------------- stats

    def attach_mesh(self, tier: Optional[MeshTier]) -> None:
        """Serve one rank of a device mesh (``tier``) or an unsharded
        engine (None); the paged engine calls it with every store it is
        given.  A store serves one sharding for its life: under a mesh its
        host tier holds the rank's shares and its disk tier is written by
        one rank over the mesh's group, so a tier of another layout, an
        unsharded engine after a mesh engine, and a first tier over a host
        tier that already holds an unsharded engine's pages are refused."""
        if self.mesh_tier is None and tier is None:
            return
        if self.mesh_tier is None and self._l1:
            raise ValueError(
                "this PrefixStore's host tier holds an unsharded engine's "
                "pages; give the mesh engine its own store (they may share "
                "disk_dir: the disk tier holds whole pages)")
        if self.mesh_tier is not None and (
                tier is None or not self.mesh_tier.same_layout(tier)):
            raise ValueError(
                "this PrefixStore already serves another sharding of the "
                "pool (its host tier holds that rank's lanes); give each "
                "sharding its own store (they may share disk_dir: the "
                "disk tier holds whole pages)")
        self.mesh_tier = tier

    @property
    def n_host(self) -> int:
        return len(self._l1)

    @property
    def n_disk(self) -> int:
        return len(self._l2)

    def contains(self, key: bytes) -> bool:
        """Cheap probe (no load, no LRU touch): either tier holds it."""
        return key in self._l1 or key in self._l2

    # --------------------------------------------------------------- put

    def put(self, key: bytes, rec: Dict[str, object]) -> None:
        """Admit one demoted page record under its chain digest.  L1
        first; overflow demotes the LRU L1 entry to disk.  Re-putting a
        present key only refreshes recency — the digest pins the bytes,
        so rewriting them is pure waste."""
        if key in self._l1:
            self._l1.move_to_end(key)
            return
        if self.host_pages > 0:
            self._l1[key] = rec
            self._l1.move_to_end(key)
            while len(self._l1) > self.host_pages:
                old_key, old_rec = self._l1.popitem(last=False)
                self._to_disk(old_key, old_rec)
        else:
            self._to_disk(key, rec)

    def _to_disk(self, key: bytes, rec: Dict[str, object]) -> None:
        """Persist one record as ``<digest hex>.page`` with the atomic
        temp + fsync + ``os.replace`` recipe; without a ``disk_dir`` the
        record is dropped (legacy discard).  A record too large for the
        WAL frame is dropped too — persistence is best-effort, parity
        never depends on it (a missing entry is just a cold miss)."""
        if not self.disk_dir:
            return
        if key in self._l2:
            self._l2.move_to_end(key)
            return
        tier = self.mesh_tier
        if tier is not None:
            rec = tier.whole(rec)   # every rank, at the same point
        path = os.path.join(self.disk_dir, key.hex() + ".page")
        try:
            frame = encode_page_record(rec)
        except ValueError:
            return
        if tier is None or tier.writer:
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(frame)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        self._l2[key] = path
        while self.disk_pages and len(self._l2) > self.disk_pages:
            self._drop_disk(*self._l2.popitem(last=False))

    def _drop_disk(self, key: bytes, path: str) -> None:
        if self.mesh_tier is not None and not self.mesh_tier.writer:
            return
        try:
            os.remove(path)
        except OSError:
            pass                        # already gone: cap still holds

    @staticmethod
    def _read(path: str) -> Optional[Dict[str, object]]:
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            data = b""
        return decode_page_record(data)

    # --------------------------------------------------------------- get

    def get(self, key: bytes
            ) -> Optional[Tuple[Dict[str, object], int]]:
        """Fetch one record; returns ``(record, tier)`` with tier 1 (host
        RAM) or 2 (disk), or None.  A disk hit is CRC-verified and
        re-admitted to L1 (it may overflow another entry back to disk);
        any torn/corrupt/missing file drops the index entry and answers
        None — the caller re-prefills, exactly the cold path."""
        rec = self._l1.get(key)
        if rec is not None:
            self._l1.move_to_end(key)
            return rec, 1
        path = self._l2.get(key)
        if path is None:
            return None
        tier = self.mesh_tier
        if tier is None:
            rec = self._read(path)
        else:
            # decided once: the writer's read, then the others'
            rec = self._read(path) if tier.writer else None
            if tier.agree(rec is not None) and not tier.writer:
                rec = self._read(path)
                if rec is None:
                    raise RuntimeError(
                        f"prefix store: {os.path.basename(path)} decoded "
                        f"on the writing rank {tier.writer_rank} but not "
                        f"on rank {tier.rank}; the disk tier must be one "
                        f"directory all ranks see")
            if rec is not None:
                rec = tier.share(rec)
        if rec is None:
            self._l2.pop(key, None)
            self._drop_disk(key, path)
            log.warning("prefix store: corrupt/unreadable disk entry "
                        "%s dropped (cold miss)", os.path.basename(path))
            return None
        self._l2.move_to_end(key)
        if self.host_pages > 0:
            # promote into L1 without re-writing the (present) disk copy
            self._l1[key] = rec
            while len(self._l1) > self.host_pages:
                old_key, old_rec = self._l1.popitem(last=False)
                self._to_disk(old_key, old_rec)
        return rec, 2


class PrefixCache:
    """Host-side index of shared prompt-prefix pages.

    The allocator stays the single owner-of-record of page ids; this class
    only re-tags ownership (sequence <-> ``CACHE_OWNER`` via ``transfer``)
    and decides which refcount-0 pages to evict.

    Tier hooks (wired by the paged engine when a ``PrefixStore`` is
    attached; without them eviction discards):

    - ``demote(pages) -> per-page records | None``: ONE gather of resident
      pages to the host (``_demote_prefix_pages``);
    - ``promote(records) -> page ids | None``: allocate ``CACHE_OWNER``
      pages and write the records into them (``_promote_prefix_records``);
      None (no room, incompatible records) is a cold miss;
    - ``count(name, value)``: the engine's counter (``EngineBase._count``).
    """

    def __init__(self, allocator, page_size: int,
                 store: Optional[PrefixStore] = None,
                 demote: Optional[Callable] = None,
                 promote: Optional[Callable] = None,
                 count: Optional[Callable] = None):
        self.allocator = allocator
        self.page_size = page_size
        self.store = store
        self._demote = demote
        self._promote = promote
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
        """Longest chained page-aligned prefix of ``prompt_ids``, extended
        into the store: where the resident (L0) chain ends, store hits for
        the next keys are promoted into fresh pages and chained, so the
        caller sees one contiguous shared run.  Returns (pages,
        n_cached_tokens), each page's refcount bumped.  Reuse stops at the
        last FULL page strictly before the prompt's end, so at least one
        token is re-prefilled (the sampler needs its logits)."""
        P = self.page_size
        limit = (len(prompt_ids) - 1) // P
        keys = _page_keys(prompt_ids, limit, P)
        pages: List[int] = []
        for key in keys:
            page = self._chain.get(key)
            if page is None:
                break
            pages.append(page)
        if pages:
            self._count("engine.prefix_hits_l0", len(pages))
        pages += self._match_store(keys[len(pages):])
        for p in pages:
            self._acquire(p)
        return pages, len(pages) * P

    def _match_store(self, keys: Sequence[bytes]) -> List[int]:
        """Promote the store's run of consecutive key hits past the
        resident chain; returns the newly chained page ids ([] without a
        store, hooks, hits or room).  Promotion allocates WITHOUT evicting
        (no demotion inside a match); out of pages, the suffix re-prefills."""
        if self.store is None or self._promote is None or not keys:
            return []
        recs: List[Dict[str, object]] = []
        tiers: List[int] = []
        for key in keys:
            got = self.store.get(key)
            if got is None:
                break
            recs.append(got[0])
            tiers.append(got[1])
        if not recs:
            return []
        new_pages = self._promote(recs)
        if new_pages is None:
            return []
        assert len(new_pages) == len(recs)
        for key, page, tier in zip(keys, new_pages, tiers):
            self._chain[key] = page
            self._key_of[page] = key
            self._ref[page] = 0
            self._lru[page] = None      # _acquire pops it right after
            self._count(f"engine.prefix_hits_l{tier}", 1)
        return new_pages

    def has_prefix(self, prompt_ids: Sequence[int]) -> bool:
        """Non-acquiring probe: would ``match`` return any pages?  Checks
        the first page's digest (resident or in the store) only, enough
        for admission grouping to route hits away from a miss batch."""
        P = self.page_size
        if (len(prompt_ids) - 1) // P < 1:
            return False
        (key,) = _page_keys(prompt_ids, 1, P)
        if key in self._chain:
            return True
        return self.store is not None and self.store.contains(key)

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
        the allocator, demoting their KV into the store first when one is
        attached (one gather of the whole victim set, one ``put`` per
        page).  Returns how many pages were freed."""
        victims: List[int] = []
        while len(victims) < n and self._lru:
            victims.append(self._lru.popitem(last=False)[0])
        if not victims:
            return 0
        if self.store is not None and self._demote is not None:
            page_recs = self._demote(victims)
            if page_recs is not None:
                for page, rec in zip(victims, page_recs):
                    self.store.put(self._key_of[page], rec)
        for page in victims:
            key = self._key_of.pop(page)
            del self._chain[key]
            del self._ref[page]
            self.allocator.free([page], CACHE_OWNER)
        METRICS.inc("engine.prefix_evicted_pages", len(victims))
        return len(victims)

    def flush_to_store(self, limit: Optional[int] = None) -> int:
        """Copy up to ``limit`` resident pages into the store WITHOUT
        freeing them (refcounts, chain and LRU untouched), skipping digests
        the store holds.  Returns the number of pages copied."""
        if self.store is None or self._demote is None:
            return 0
        pending = [(p, k) for p, k in self._key_of.items()
                   if not self.store.contains(k)]
        if limit is not None:
            pending = pending[:limit]
        if not pending:
            return 0
        page_recs = self._demote([p for p, _ in pending])
        if page_recs is None:
            return 0
        for (_, key), rec in zip(pending, page_recs):
            self.store.put(key, rec)
        return len(pending)
