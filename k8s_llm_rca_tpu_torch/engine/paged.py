"""Paged KV cache engine: the port of ``k8s_llm_rca_tpu/engine/paged.py``.

- The pool is one [L, n_pages, page_size, n_kv*d] tensor per k/v, with
  kv-heads merged on the last axis, the JAX layout (``utils/pages.py``
  records keep their meaning).  The port updates it IN PLACE: prefill
  scatters whole pages, decode writes one token per slot, and the
  functions return the same pool object for the JAX call shape.
- Page 0 is the reserved trash page: block-table entries past a
  sequence's pages point at it, inactive slots write their garbage KV into
  it, and attention masks it by length.
- The page allocator, slot bookkeeping and block tables live on the host.
  Each tick copies the [B] tokens, [B] lengths and [B, pages_per_seq]
  tables into static device buffers, which the decode step and scans read
  (on the card through CUDA graphs, ``engine/graphs.py``).
- Decode attention is ``ops.paged_attention`` (the CUDA kernel on the card,
  its plain version on the CPU); prefill attention is
  ``ops.flash_attention`` through ``models.llama``.
- ``kv_cache_dtype`` "int8" or "int4" quantizes the pool per token (int4
  split-half packed along the merged kv axis) with f32 scale pools
  [L, n_pages, page_size]; decode then runs ``ops.paged_attention_quant``.
- A chunked tick runs ``decode_chunk`` steps as a Python loop over device
  tensors with one host fetch per chunk (``paged_decode_scan``); with
  compiled-DFA grammar slots the grammar rides inside that loop
  (``paged_decode_scan_dfa``).  An interpreted grammar forces stepwise
  ticks: the host builds each constrained slot's [V] mask, the device
  samples under it (``sample_tokens_masked``) and forced tokens override
  the sample.  A grammar slot's first token is constrained at admission,
  synchronously.

- The prefix cache (``engine/prefix.py``) shares the KV pages of a cached
  prompt prefix: a hit prefills only its suffix, attending over the
  gathered prefix pages (``paged_prefill_chunk_batch``).
  ``prefill_chunk_budget`` prefills a long prompt one page-aligned chunk
  per tick through the same function.
- ``speculative_k`` verifies n-gram drafts (``engine/speculative.py``)
  with one multi-token step (``paged_decode_multi``) and commits the
  longest agreeing prefix plus one token: greedy-exact.
- Hits, chunks and verification attend through ``attend_over_pages``: on
  the card the pages gather into a contiguous buffer indexed by absolute
  position and ``ops.flash_attention`` attends a query chunk at a per-row
  offset over it; on the CPU the plain version the JAX package computes
  in ``jnp``.
- ``host_overlap`` keeps the decode operands resident on the device and
  commits each step one tick late (``paged_overlap_step``), so the host
  syncs once per two steps at ``decode_chunk`` 1.
- Memory tiers.  ``max_spilled_pages`` turns preemption into a host round
  trip: the victim's written pages gather to the host in one sync
  (``utils/pages.py``) and come back by an in-place write when it
  resumes, instead of a re-prefill.  ``prefix_host_pages`` /
  ``prefix_disk_dir`` / ``prefix_disk_pages`` (or a shared
  ``prefix_store``) give the prefix cache host-RAM and disk tiers:
  evicted prefix pages demote there and a later match promotes them back;
  ``prefix_hbm_watermark`` demotes ahead of pressure and
  ``prefix_store_writethrough`` publishes resident chains every tick they
  grow.  Every restore writes the pool IN PLACE, so the captured graphs
  read the restored pages.
- ``EngineConfig.native`` builds the C++ page allocator (``native/``),
  counted as ``engine.allocator_native`` (the Python one, where the
  library cannot be built, as ``engine.allocator_python``).
- Tick faults (``faults/inject.py``): "preempt" waves through the spill
  path, "crash" drops every active sequence's KV for re-prefill, "oom"
  takes the whole free list for one tick, "stall" advances the clock;
  all between ticks, on the host, outside any captured region.

Not ported yet, and refused loudly when asked for: draft-model
speculation and the TP/PP/CP/EP/FSDP meshes (ROADMAP Queue 1), and the
disaggregated handoff's ``export_run``/``adopt_run`` (item 11).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from k8s_llm_rca_tpu_torch.config import EngineConfig, ModelConfig
from k8s_llm_rca_tpu_torch.engine.engine import (
    EngineBase, SequenceResult, _Active, _Pending, dfa_greedy_multi,
    dfa_scan_step,
)
from k8s_llm_rca_tpu_torch.engine.graphs import DecodeGraphs
from k8s_llm_rca_tpu_torch.engine.prefix import (
    CACHE_OWNER, PrefixCache, PrefixStore, _page_keys,
)
from k8s_llm_rca_tpu_torch.engine.speculative import DRAFT_MODEL_ITEM
from k8s_llm_rca_tpu_torch.engine.sampling import (
    SamplingParams, sample_tokens, sample_tokens_masked,
)
from k8s_llm_rca_tpu_torch.models import llama
from k8s_llm_rca_tpu_torch.models.quant import gather_rows, quantize_kv
from k8s_llm_rca_tpu_torch.ops.attention import (
    NEG_INF, decode_attention_multi, repeat_kv,
)
from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention
from k8s_llm_rca_tpu_torch.ops.norms import rms_norm
from k8s_llm_rca_tpu_torch.ops.paged_attention import (
    gather_dequant_pages, paged_attention, paged_attention_quant,
)
from k8s_llm_rca_tpu_torch.runtime.profiling import annotate
from k8s_llm_rca_tpu_torch.utils.device import resolve_device
from k8s_llm_rca_tpu_torch.utils.logging import get_logger
from k8s_llm_rca_tpu_torch.utils.pages import (
    gather_pages, record_nbytes, records_compatible, restore_pages,
    split_pages, stack_pages, suffix_bucket,
)
from k8s_llm_rca_tpu_torch.utils.tokenizer import Tokenizer

log = get_logger(__name__)

TRASH_PAGE = 0

# allocator owner tag for pages taken by an injected "oom" tick fault
# (sequence ids are >= 0; the prefix cache owns -2)
FAULT_OWNER = -3


class AllocatorError(RuntimeError):
    """Invariant violation (double free, alias, foreign page)."""


class OutOfPages(RuntimeError):
    """Pool exhausted; caller should preempt a sequence and retry."""


class PageAllocator:
    """Host-side free-list allocator over page ids 1..n_pages-1.

    Page 0 is never handed out.  Every page has at most one owner, and
    ``free`` checks it, so a double free or a cross-sequence free fails
    loudly instead of aliasing KV state."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        self._free: List[int] = list(range(1, n_pages))
        self._owner: Dict[int, int] = {}          # page -> owner tag

    @property
    def n_free(self) -> int:
        return len(self._free)

    def pages_of(self, owner: int) -> List[int]:
        return [p for p, o in self._owner.items() if o == owner]

    def alloc(self, n: int, owner: int) -> List[int]:
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} pages, {len(self._free)} free of {self.n_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = owner
        return pages

    def free(self, pages: Sequence[int], owner: int) -> None:
        for p in pages:
            if p == TRASH_PAGE:
                raise AllocatorError("attempt to free the trash page")
            got = self._owner.get(p)
            if got is None:
                raise AllocatorError(f"double free of page {p}")
            if got != owner:
                raise AllocatorError(
                    f"page {p} owned by {got}, freed by {owner}")
            del self._owner[p]
            self._free.append(p)

    def transfer(self, pages: Sequence[int], from_owner: int,
                 to_owner: int) -> None:
        """Re-tag ownership (a sequence's pages to the prefix cache).
        Validates every page first, so a failed transfer changes nothing."""
        for p in pages:
            if p == TRASH_PAGE:
                raise AllocatorError("attempt to transfer the trash page")
            got = self._owner.get(p)
            if got is None:
                raise AllocatorError(f"transfer of free page {p}")
            if got != from_owner:
                raise AllocatorError(
                    f"page {p} owned by {got}, transferred by {from_owner}")
        for p in pages:
            self._owner[p] = to_owner

    def check(self) -> None:
        """Global invariant: free and owned pages partition 1..n_pages-1."""
        free: Set[int] = set(self._free)
        owned: Set[int] = set(self._owner)
        if free & owned:
            raise AllocatorError(f"pages both free and owned: {free & owned}")
        if len(free) != len(self._free):
            raise AllocatorError("duplicate entries in free list")
        universe = set(range(1, self.n_pages))
        if free | owned != universe:
            raise AllocatorError(
                f"leaked pages: {sorted(universe - free - owned)}")


def make_allocator(n_pages: int, prefer_native: bool = True):
    """The page allocator: the C++ one (``native/``) when ``prefer_native``
    and the library builds, else the Python one (logged), with the same
    interface and invariants."""
    if prefer_native:
        from k8s_llm_rca_tpu_torch import native
        if native.available():
            return native.NativePageAllocator(n_pages)
        log.warning("serving with the Python page allocator: the native "
                    "library is unavailable")
    return PageAllocator(n_pages)


# ---------------------------------------------------------------------------
# paged model entry points
# ---------------------------------------------------------------------------


class PagePool(NamedTuple):
    """Paged KV pool: k/v [L, n_pages, page_size, kv_dim] in the model dtype,
    or int8 [.., kv_dim] ("int8") / split-half packed int8 [.., kv_dim/2]
    ("int4") with one f32 scale per written token in ``k_scale``/
    ``v_scale`` [L, n_pages, page_size].  Page ids index the pages and the
    scale pools alike."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


_KV_DTYPES = (None, "int8", "int4")


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     device=None, kv_dtype: Optional[str] = None) -> PagePool:
    """Zeroed pool on ``device`` (``None`` = the card); ``kv_dtype`` None
    (model dtype), "int8" or "int4" (anything else raises ``ValueError``,
    as the JAX engine does)."""
    if kv_dtype not in _KV_DTYPES:
        raise ValueError(f"unsupported kv_cache_dtype {kv_dtype!r} (None, "
                         f"'int8' or 'int4')")
    shape = (cfg.n_layers, n_pages, page_size, cfg.kv_dim)
    dev = resolve_device(device)
    if kv_dtype is None:
        dtype = llama.torch_dtype(cfg.dtype)
        return PagePool(torch.zeros(shape, dtype=dtype, device=dev),
                        torch.zeros(shape, dtype=dtype, device=dev))
    if kv_dtype == "int4":
        if cfg.kv_dim % 2:
            raise ValueError(f"int4 pools pack pairs: kv_dim {cfg.kv_dim} is "
                             f"odd")
        shape = (*shape[:3], cfg.kv_dim // 2)
    # scale pools in f32: 1/kv_dim of the page bytes
    return PagePool(torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape[:3], dtype=torch.float32, device=dev),
                    torch.zeros(shape[:3], dtype=torch.float32, device=dev))


def _pool_packed(cfg: ModelConfig, pool: PagePool) -> bool:
    """True when the pool stores nibble-packed int4 KV (kv_dim halved)."""
    return pool.k.shape[-1] != cfg.kv_dim


def _write_pool_pages(cfg: ModelConfig, pool: PagePool, new_k: torch.Tensor,
                      new_v: torch.Tensor, page_map: torch.Tensor,
                      n_seq_pages: int, page_size: int) -> PagePool:
    """Scatter [L, n_seq_pages * page_size, ...] prefill KV into the
    ``page_map`` pool pages, in place, quantizing per token first when the
    pool is quantized.  Repeated ids carry identical pages (padding rows)
    or land in the trash page."""
    idx = page_map.long()
    new_k = new_k.reshape(new_k.shape[0], n_seq_pages, page_size, cfg.kv_dim)
    new_v = new_v.reshape(new_v.shape[0], n_seq_pages, page_size, cfg.kv_dim)
    if pool.quantized:
        packed = _pool_packed(cfg, pool)
        new_k, ks = quantize_kv(new_k, packed)
        new_v, vs = quantize_kv(new_v, packed)
        pool.k_scale[:, idx] = ks.float()
        pool.v_scale[:, idx] = vs.float()
    pool.k[:, idx] = new_k
    pool.v[:, idx] = new_v
    return pool


def paged_prefill(cfg: ModelConfig, params, pool: PagePool,
                  tokens: torch.Tensor, length: int, page_map: torch.Tensor):
    """Prefill ONE sequence into ``page_map`` pages: tokens [1, S_pad]
    (S_pad a page multiple), page_map [S_pad // page_size].  Returns
    (pool, logits [1, V])."""
    s_pad = tokens.shape[1]
    page_size = pool.page_size
    assert s_pad % page_size == 0, (s_pad, page_size)
    new_k, new_v, logits = llama.prefill_kv(cfg, params, tokens, length)
    pool = _write_pool_pages(cfg, pool, new_k, new_v, page_map,
                             s_pad // page_size, page_size)
    return pool, logits


def paged_prefill_batch(cfg: ModelConfig, params, pool: PagePool,
                        tokens: torch.Tensor, lengths: torch.Tensor,
                        page_maps: torch.Tensor):
    """Prefill N sequences in ONE dispatch: tokens [N, S_pad] right-padded,
    lengths [N] int32, page_maps [N, S_pad // page_size] (padding rows
    repeat the last real row).  Returns (pool, logits [N, V])."""
    n, s_pad = tokens.shape
    page_size = pool.page_size
    assert s_pad % page_size == 0, (s_pad, page_size)
    new_k, new_v, logits = llama._prefill_batch_kv(cfg, params, tokens,
                                                   lengths)
    pool = _write_pool_pages(
        cfg, pool, new_k.reshape(cfg.n_layers, n * s_pad, cfg.kv_dim),
        new_v.reshape(cfg.n_layers, n * s_pad, cfg.kv_dim),
        page_maps.reshape(-1), n * (s_pad // page_size), page_size)
    return pool, logits


def _chunk_attention(cfg: ModelConfig, q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked fp32 softmax attention of chunked prefill: q [N, C, n_heads,
    d], k_all/v_all [N, S, n_kv, d], mask [N, C, S] built in ABSOLUTE
    positions (the gathered prefix is padded to a page count, so a buffer
    index is not a position).  Returns [N, C, n_heads, d] in q's dtype."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k = repeat_kv(k_all, n_rep).float()
    v = repeat_kv(v_all, n_rep).float()
    scale = 1.0 / torch.sqrt(torch.tensor(cfg.head_dim, dtype=torch.float32))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * scale
    logits = torch.where(mask[:, None], logits,
                         torch.tensor(NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def _gather_layer(cfg: ModelConfig, pool: PagePool, li: int,
                  tables: torch.Tensor, dtype):
    """Layer ``li``'s pages of ``tables`` [N, P] as dense [N, P * page,
    n_kv, d] K and V in ``dtype`` (dequantized from a quantized pool)."""
    packed = _pool_packed(cfg, pool)
    scales = ((pool.k_scale[li], pool.v_scale[li]) if pool.quantized
              else (None, None))
    return tuple(gather_dequant_pages(pages[li], sc, tables, cfg.n_kv_heads,
                                      cfg.head_dim, dtype, packed)
                 for pages, sc in zip((pool.k, pool.v), scales))


def pages_to_buffer(cfg: ModelConfig, pool: PagePool, li: int,
                    tables: torch.Tensor, q_offset: torch.Tensor,
                    fresh: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    n_pages: Optional[int] = None):
    """The card half of ``attend_over_pages`` before the kernel: layer
    ``li``'s pages of the first ``n_pages`` (all when None) columns of
    ``tables`` gathered into contiguous [N, S, n_kv, d] K and V in the
    model dtype, buffer index = absolute position, with ``fresh`` (k, v)
    scattered to [q_offset, q_offset + C) of each row (the buffer grows by
    C zero rows to hold it)."""
    dtype = llama.torch_dtype(cfg.dtype)
    if n_pages is not None:
        tables = tables[:, :n_pages]
    kb, vb = _gather_layer(cfg, pool, li, tables, dtype)
    if fresh is None:
        return kb, vb
    n, c = fresh[0].shape[:2]
    dev = kb.device
    rows = torch.arange(n, device=dev)[:, None]
    pos = q_offset.long()[:, None] + torch.arange(c, device=dev)[None, :]
    pad = torch.zeros((n, c) + kb.shape[2:], dtype=dtype, device=dev)
    kb, vb = torch.cat([kb, pad], dim=1), torch.cat([vb, pad], dim=1)
    kb[rows, pos] = fresh[0].to(dtype)
    vb[rows, pos] = fresh[1].to(dtype)
    return kb, vb


def attend_over_pages_plain(cfg: ModelConfig, q: torch.Tensor,
                            pool: PagePool, li: int, tables: torch.Tensor,
                            q_offset: torch.Tensor, seq_lens: torch.Tensor,
                            fresh: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None
                            ) -> torch.Tensor:
    """``attend_over_pages``' plain version, on any device: what the JAX
    package computes in ``jnp``.  With ``fresh``, the chunk attention over
    (gathered prefix + chunk) with its mask in absolute positions (the
    prefix is padded to a page count, so a buffer index is not a position);
    without, ``decode_attention_multi`` over the whole gathered table."""
    dtype = llama.torch_dtype(cfg.dtype)
    kp, vp = _gather_layer(cfg, pool, li, tables, dtype)
    if fresh is None:
        return decode_attention_multi(q, kp, vp, q_offset + 1)
    n, c_pad = q.shape[:2]
    dev = q.device
    prefix_lens = q_offset.long()
    positions = prefix_lens[:, None] + torch.arange(c_pad, device=dev)[None]
    pre = torch.arange(kp.shape[1], device=dev)[None, :]
    k_abs = torch.cat([pre.expand(n, -1), positions], dim=1)       # [N, S]
    k_valid = torch.cat([
        pre < prefix_lens[:, None],
        positions < seq_lens.long()[:, None]], dim=1)
    mask = ((positions[:, :, None] >= k_abs[:, None, :])
            & k_valid[:, None, :])                                 # [N, C, S]
    return _chunk_attention(cfg, q, torch.cat([kp, fresh[0]], dim=1),
                            torch.cat([vp, fresh[1]], dim=1), mask)


def attend_over_pages(cfg: ModelConfig, q: torch.Tensor, pool: PagePool,
                      li: int, tables: torch.Tensor, q_offset: torch.Tensor,
                      seq_lens: torch.Tensor,
                      fresh: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      n_pages: Optional[int] = None) -> torch.Tensor:
    """Causal attention of a query chunk over K/V held in pages: q [N, C,
    n_heads, d] at absolute positions ``q_offset + i`` sees the keys at
    positions <= its own and < ``seq_lens`` [N].  ``tables`` [N, P] holds
    the page ids of positions [0, P * page).  ``fresh`` (k, v) [N, C, n_kv,
    d] are the chunk's own unquantized K/V at positions ``q_offset + i``,
    not in the pool (prefix hits and chunked prefill); without it the pool
    already holds every key (speculative verification, after the T new
    tokens were written).  Returns [N, C, n_heads, d] in q's dtype.

    On the card the pages gather into one contiguous buffer whose index is
    the absolute position (``pages_to_buffer``; ``n_pages`` bounds the
    gather to each row's first pages) and the flash kernel attends over it
    with ``q_offset`` and ``seq_lens``; a call the kernel refuses raises.
    On the CPU it runs ``attend_over_pages_plain``.  No row may have
    ``seq_lens`` 0 (the kernel returns 0 there, the plain version the mean
    of v)."""
    if q.device.type == "cpu":
        return attend_over_pages_plain(cfg, q, pool, li, tables, q_offset,
                                       seq_lens, fresh)
    kb, vb = pages_to_buffer(cfg, pool, li, tables, q_offset, fresh, n_pages)
    return flash_attention(q, kb, vb, seq_lens.to(torch.int32),
                           q_offset.to(torch.int32))


def _chunk_layer(cfg: ModelConfig, layer, x: torch.Tensor,
                 angles: torch.Tensor, positions: torch.Tensor,
                 prefix_lens: torch.Tensor, seq_lens: torch.Tensor,
                 pool: PagePool, li: int, prefix_tables: torch.Tensor):
    """One layer of chunked prefill: attend chunk over (cached prefix +
    chunk) through ``attend_over_pages``, finish the block.  Returns (x',
    k, v), k/v the chunk's new KV [N, C, n_kv, d] (the caller writes them
    into the pool after the last layer)."""
    n, c_pad = x.shape[:2]
    h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
    q, k, v = llama._qkv(cfg, layer, h, angles, positions)
    attn = attend_over_pages(cfg, q, pool, li, prefix_tables, prefix_lens,
                             seq_lens, fresh=(k, v))
    x = x + llama._w_mm(cfg, attn.reshape(n, c_pad, cfg.q_dim), layer["wo"])
    hm = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
    return x + llama._mlp(cfg, layer, hm), k, v


def paged_prefill_chunk(cfg: ModelConfig, params, pool: PagePool,
                        tokens: torch.Tensor, chunk_len: int,
                        prefix_len: int, prefix_table: torch.Tensor,
                        page_map: torch.Tensor):
    """Prefill the SUFFIX of ONE prompt whose first ``prefix_len`` tokens'
    KV already sit in the ``prefix_table`` pages (a prefix hit, or the
    chunks a chunked prefill has written): the N = 1 case of
    ``paged_prefill_chunk_batch``.  Returns (pool, logits [1, V])."""
    dev = tokens.device
    return paged_prefill_chunk_batch(
        cfg, params, pool, tokens,
        torch.tensor([chunk_len], dtype=torch.int32, device=dev),
        torch.tensor([prefix_len], dtype=torch.int32, device=dev),
        prefix_table[None], page_map[None])


def paged_prefill_chunk_batch(cfg: ModelConfig, params, pool: PagePool,
                              tokens: torch.Tensor, chunk_lens: torch.Tensor,
                              prefix_lens: torch.Tensor,
                              prefix_tables: torch.Tensor,
                              page_maps: torch.Tensor):
    """Chunked prefill of N suffixes in ONE dispatch.  Attention runs
    through ``attend_over_pages`` (the flash kernel over the gathered pages
    on the card; the plain masked attention on the CPU, which the JAX
    function computes in ``jnp`` outside any Pallas kernel); projections
    and head go through ``qmm``/``qmm_head`` under ``fused_quant_matmul``.

    tokens [N, C_pad] right-padded (C_pad a page multiple), chunk_lens [N]
    valid tokens, prefix_lens [N] cached tokens, absolute positions
    ``prefix_len + i``; prefix_tables [N, PB] page ids whose first
    ``prefix_len // page`` entries hold the cached prefix (the rest is
    masked); page_maps [N, C_pad // page] pages receiving each row's chunk
    KV (padding rows repeat a real row: identical duplicate writes).
    Returns (pool, logits [N, V] at each row's last valid token)."""
    n, c_pad = tokens.shape
    page_size = pool.page_size
    assert c_pad % page_size == 0, (c_pad, page_size)
    dtype = llama.torch_dtype(cfg.dtype)
    dev = tokens.device
    angles = llama._angles(cfg, dev)
    positions = (prefix_lens.long()[:, None]
                 + torch.arange(c_pad, device=dev)[None, :])       # [N, C]
    seq_lens = prefix_lens + chunk_lens
    x = gather_rows(params["embedding"], tokens, dtype).to(dtype)
    ks, vs = [], []
    for li, layer in enumerate(params["layers"]):
        x, k, v = _chunk_layer(cfg, layer, x, angles, positions, prefix_lens,
                               seq_lens, pool, li, prefix_tables)
        ks.append(k.reshape(n * c_pad, cfg.kv_dim))
        vs.append(v.reshape(n * c_pad, cfg.kv_dim))
    pool = _write_pool_pages(cfg, pool, torch.stack(ks), torch.stack(vs),
                             page_maps.reshape(-1),
                             n * (c_pad // page_size), page_size)
    last = x[torch.arange(n, device=dev),
             (chunk_lens.long() - 1).clamp(min=0)][:, None]        # [N,1,H]
    return pool, llama._logits(cfg, params, last)[:, 0]


def paged_decode_step(cfg: ModelConfig, params, pool: PagePool,
                      tokens: torch.Tensor, lengths: torch.Tensor,
                      block_tables: torch.Tensor):
    """One decode step for all slots: tokens [B], lengths [B] int32 tokens
    already cached, block_tables [B, pages_per_seq] int32.  The new
    token's KV is written at position lengths[b] (page
    block_tables[b, lengths[b] // page], offset lengths[b] % page) BEFORE
    attention runs over lengths + 1 tokens.  Returns (pool, logits [B, V])."""
    b = tokens.shape[0]
    page_size = pool.page_size
    packed = _pool_packed(cfg, pool)
    lens = lengths.long()
    angles = llama._angles(cfg, tokens.device)
    dtype = llama.torch_dtype(cfg.dtype)
    x = gather_rows(params["embedding"], tokens.long()[:, None], dtype).to(dtype)
    page_ids = block_tables.long().gather(1, (lens // page_size)[:, None])[:, 0]
    offsets = lens % page_size
    attn_lens = (lengths + 1).to(torch.int32)
    for li, layer in enumerate(params["layers"]):
        q, k, v = llama._decode_qkv(cfg, layer, x, angles, lens[:, None])
        k_tok = k[:, 0].reshape(b, cfg.kv_dim)
        v_tok = v[:, 0].reshape(b, cfg.kv_dim)
        if pool.quantized:
            k_tok, ks = quantize_kv(k_tok, packed)
            v_tok, vs = quantize_kv(v_tok, packed)
            pool.k_scale[li, page_ids, offsets] = ks.float()
            pool.v_scale[li, page_ids, offsets] = vs.float()
        pool.k[li, page_ids, offsets] = k_tok
        pool.v[li, page_ids, offsets] = v_tok
        if pool.quantized:
            attn = paged_attention_quant(
                q[:, 0], pool.k[li], pool.v[li], pool.k_scale[li],
                pool.v_scale[li], attn_lens, block_tables, packed=packed)
        else:
            attn = paged_attention(q[:, 0], pool.k[li], pool.v[li],
                                   attn_lens, block_tables)
        x = llama._decode_finish(cfg, layer, x,
                                 attn.reshape(b, 1, cfg.q_dim))
    return pool, llama._logits(cfg, params, x)[:, 0]


def paged_decode_multi(cfg: ModelConfig, params, pool: PagePool,
                       tokens: torch.Tensor, lengths: torch.Tensor,
                       block_tables: torch.Tensor,
                       n_pages: Optional[int] = None):
    """Multi-token paged decode (speculative verification): tokens [B, T],
    tokens[b, 0] the current token and the rest drafts, at positions
    ``lengths[b] + i``.  All T writes of a slot land in ONE page (the
    engine bounds T by each slot's room in its current page), quantized
    per token for an int8/int4 pool; then each layer attends T queries
    over the slot's pages through ``attend_over_pages`` (``n_pages``: the
    pages the card gathers per row, enough for every ``lengths + T``).
    Returns (pool, greedy [B, T], logits [B, T, V])."""
    b, t = tokens.shape
    page_size = pool.page_size
    packed = _pool_packed(cfg, pool)
    dev = tokens.device
    lens = lengths.long()
    angles = llama._angles(cfg, dev)
    dtype = llama.torch_dtype(cfg.dtype)
    steps = torch.arange(t, device=dev)[None, :]
    positions = lens[:, None] + steps                              # [B, T]
    x = gather_rows(params["embedding"], tokens.long(), dtype).to(dtype)
    page_ids = block_tables.long().gather(1, (lens // page_size)[:, None])
    pages2d = page_ids.expand(b, t)                                # [B, T]
    offsets = (lens % page_size)[:, None] + steps
    seq_lens = lengths + t
    for li, layer in enumerate(params["layers"]):
        q, k, v = llama._decode_qkv(cfg, layer, x, angles, positions)
        k_tok = k.reshape(b, t, cfg.kv_dim)
        v_tok = v.reshape(b, t, cfg.kv_dim)
        if pool.quantized:
            k_tok, ks = quantize_kv(k_tok, packed)
            v_tok, vs = quantize_kv(v_tok, packed)
            pool.k_scale[li, pages2d, offsets] = ks.float()
            pool.v_scale[li, pages2d, offsets] = vs.float()
        pool.k[li, pages2d, offsets] = k_tok
        pool.v[li, pages2d, offsets] = v_tok
        attn = attend_over_pages(cfg, q, pool, li, block_tables, lengths,
                                 seq_lens, n_pages=n_pages)
        x = llama._decode_finish(cfg, layer, x,
                                 attn.reshape(b, t, cfg.q_dim))
    logits = llama._logits(cfg, params, x)                         # [B, T, V]
    return pool, logits.argmax(dim=-1), logits


def paged_overlap_step(cfg: ModelConfig, params, pool: PagePool,
                       cur_tokens: torch.Tensor, lengths: torch.Tensor,
                       block_tables: torch.Tensor,
                       generator: Optional[torch.Generator],
                       sampling: SamplingParams, cap: int):
    """One step of the overlapped hot loop: decode, sample, and advance
    every slot's length (clamped at ``cap``, the last in-table position),
    all on the device.  ``cur_tokens`` and ``lengths`` are the engine's
    resident operand buffers and take the new tokens and lengths IN PLACE,
    so the next step reads them where this one left them and the host
    never touches them between ticks.  A slot the host already retired
    decodes garbage into the trash page until the lagged commit drops
    its tokens.  Returns (pool, next_tokens [B], lengths)."""
    pool, logits = paged_decode_step(cfg, params, pool, cur_tokens, lengths,
                                     block_tables)
    nxt = sample_tokens(logits, generator, sampling)
    cur_tokens.copy_(nxt)
    lengths.copy_(torch.clamp(lengths + 1, max=cap))
    return pool, nxt, lengths


def paged_decode_scan(cfg: ModelConfig, params, pool: PagePool,
                      cur_tokens: torch.Tensor, lengths: torch.Tensor,
                      block_tables: torch.Tensor,
                      generator: Optional[torch.Generator], n_steps: int,
                      sampling: SamplingParams, eos_id: int):
    """``n_steps`` decode steps with no host sync: the caller bounds
    ``n_steps`` by each slot's pre-allocated page run.  Slots that hit
    ``eos_id`` stop advancing (their token repeats; the host trims).
    Returns (pool, tokens [n_steps, B], lengths)."""
    cur, lens = cur_tokens, lengths
    done = torch.zeros_like(cur_tokens, dtype=torch.bool)
    toks = []
    for _ in range(n_steps):
        pool, logits = paged_decode_step(cfg, params, pool, cur, lens,
                                         block_tables)
        nxt = sample_tokens(logits, generator, sampling)
        advance = ~done
        done = done | (nxt == eos_id)
        cur = torch.where(advance, nxt, cur)
        lens = lens + advance.to(lens.dtype)
        toks.append(cur)
    return pool, torch.stack(toks), lens


def paged_decode_scan_dfa(cfg: ModelConfig, params, pool: PagePool,
                          cur_tokens: torch.Tensor, lengths: torch.Tensor,
                          block_tables: torch.Tensor,
                          generator: Optional[torch.Generator], n_steps: int,
                          sampling: SamplingParams, eos_id: int,
                          states: torch.Tensor, remaining: torch.Tensor,
                          allow_t: torch.Tensor, next_t: torch.Tensor,
                          dist_t: torch.Tensor, close_t: torch.Tensor,
                          complete_t: torch.Tensor):
    """``paged_decode_scan`` with the compiled grammar DFA riding inside
    the loop (``dfa_scan_step``: budget-aware mask, sample, state
    transition, all on the device).  Returns (pool, tokens [n_steps, B],
    lengths, states)."""
    cur, lens = cur_tokens, lengths
    done = torch.zeros_like(cur_tokens, dtype=torch.bool)
    toks = []
    for _ in range(n_steps):
        pool, logits = paged_decode_step(cfg, params, pool, cur, lens,
                                         block_tables)
        cur, lens, done, states, remaining = dfa_scan_step(
            logits, cur, lens, done, states, remaining, generator, sampling,
            eos_id, allow_t, next_t, dist_t, close_t, complete_t)
        toks.append(cur)
    return pool, torch.stack(toks), lens, states


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def check_engine_config(engine_cfg: EngineConfig,
                        shared_store: bool = False) -> None:
    """Refuse what the JAX engine refuses: a negative or inconsistent
    tier or spill knob, a chunk budget off the page grid, a speculative
    draft past the page.  ``shared_store``: a ``PrefixStore`` is passed
    to the engine (it makes the cache tiered as the knobs do)."""
    msp = engine_cfg.max_spilled_pages
    if msp < 0:
        raise ValueError(
            f"max_spilled_pages={msp} must be >= 0 (0 disables "
            f"KV spill-to-host preemption)")
    tiered = bool(engine_cfg.prefix_host_pages or engine_cfg.prefix_disk_dir
                  or engine_cfg.prefix_disk_pages or shared_store)
    if tiered:
        if engine_cfg.prefix_host_pages < 0:
            raise ValueError(
                f"prefix_host_pages={engine_cfg.prefix_host_pages} "
                f"must be >= 0 (0 disables the host-RAM prefix tier)")
        if engine_cfg.prefix_disk_pages < 0:
            raise ValueError(
                f"prefix_disk_pages={engine_cfg.prefix_disk_pages} "
                f"must be >= 0 (0 with prefix_disk_dir = unbounded)")
        if engine_cfg.prefix_disk_pages and not engine_cfg.prefix_disk_dir:
            raise ValueError(
                f"prefix_disk_pages={engine_cfg.prefix_disk_pages} "
                f"needs prefix_disk_dir: the cap bounds a disk tier "
                f"that does not exist without a directory")
        if not engine_cfg.prefix_cache:
            raise ValueError(
                "the tiered prefix cache (prefix_host_pages / "
                "prefix_disk_dir / prefix_disk_pages / a shared "
                "prefix_store) requires prefix_cache=True: the tiers "
                "demote FROM and promote INTO the resident L0 chain "
                "— without it there is nothing to key pages by")
    wm = engine_cfg.prefix_hbm_watermark
    if wm:
        if wm < 0:
            raise ValueError(
                f"prefix_hbm_watermark={wm} must be >= 0 "
                f"(0 disables pressure-driven demotion)")
        if not engine_cfg.prefix_cache:
            raise ValueError(
                "prefix_hbm_watermark requires prefix_cache=True: "
                "pressure-driven demotion frees refcount-0 PREFIX "
                "pages — without a prefix cache there is nothing "
                "evictable to demote")
        if wm >= engine_cfg.num_pages:
            raise ValueError(
                f"prefix_hbm_watermark={wm} is over capacity "
                f"(num_pages={engine_cfg.num_pages}): a watermark at "
                f"or above the whole pool demotes every cached page "
                f"the moment one sequence admits; pick a watermark "
                f"below num_pages")
    if engine_cfg.prefix_store_writethrough and not tiered:
        raise ValueError(
            "prefix_store_writethrough=True without a store "
            "(prefix_host_pages / prefix_disk_dir / prefix_disk_pages "
            "/ a shared prefix_store): write-through publishes "
            "resident chains TO a store — with nowhere to write it "
            "is a config bug, not a degraded mode")
    pcb = engine_cfg.prefill_chunk_budget
    if pcb and (pcb < 0 or pcb % engine_cfg.page_size):
        raise ValueError(
            f"prefill_chunk_budget={pcb} must be a positive "
            f"multiple of page_size={engine_cfg.page_size}: each "
            f"per-tick chunk scatters whole pages, so its growing "
            f"prefix stays page-aligned for the next chunk's "
            f"gather")
    k = engine_cfg.speculative_k
    if k > 0 and k + 1 > engine_cfg.page_size:
        raise ValueError(
            f"speculative_k={k} needs k+1 <= page_size="
            f"{engine_cfg.page_size} (all verify-step writes must fit one "
            f"page)")


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class PagedInferenceEngine(EngineBase):
    """Continuous batching over the paged pool with on-demand page growth
    and preemption (youngest, lowest-priority sequence first, requeued
    with prompt + generated as its new prompt).  Admission never preempts.
    Runs on ``device`` (``None`` = the card); ``params`` must live there.

    With ``EngineConfig.prefix_cache`` admissions reuse the KV pages of a
    cached prompt prefix and prefill only the suffix; with
    ``prefill_chunk_budget`` a long prompt prefills one page-aligned chunk
    per tick.  On the card the decode step and scans replay CUDA graphs
    (``engine/graphs.py``) unless ``cuda_graphs=False``, which runs them
    eagerly; on the CPU they always run eagerly."""

    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params, tokenizer: Tokenizer, device=None, *,
                 cuda_graphs: bool = True, draft_model=None, tp_mesh=None,
                 cp_mesh=None, ep_mesh=None, pp_mesh=None, fsdp_mesh=None,
                 prefix_store: Optional[PrefixStore] = None):
        if draft_model is not None:
            raise NotImplementedError(
                f"draft-model speculation (draft_model=) runs its draft on "
                f"the contiguous engine, which is not ported yet (ROADMAP "
                f"{DRAFT_MODEL_ITEM}); n-gram drafts (speculative_k > 0) "
                f"are")
        if any(m is not None for m in (tp_mesh, cp_mesh, ep_mesh, pp_mesh,
                                       fsdp_mesh)):
            raise NotImplementedError(
                "device meshes (TP/CP/EP/PP/FSDP) are not ported yet (ROADMAP "
                "Queue 1 item 10, multi-GPU)")
        check_engine_config(engine_cfg, prefix_store is not None)
        self.device = resolve_device(device)
        for leaf in _leaves(params):
            if leaf.device != self.device:
                raise ValueError(f"params live on {leaf.device}, the engine "
                                 f"on {self.device}")
        self.model_cfg = model_cfg
        self.engine_cfg = engine_cfg
        self.params = params
        self.tokenizer = tokenizer
        self.sampling = SamplingParams(temperature=engine_cfg.temperature,
                                       top_k=engine_cfg.top_k,
                                       top_p=engine_cfg.top_p)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(engine_cfg.seed)

        b = engine_cfg.max_batch
        self.page_size = engine_cfg.page_size
        self.pages_per_seq = -(-engine_cfg.max_seq_len // self.page_size)
        if engine_cfg.num_pages - 1 < self.pages_per_seq:
            # any single sequence must be admittable once the pool is
            # drained, so preemption always makes progress
            raise ValueError(
                f"num_pages={engine_cfg.num_pages} cannot hold one full "
                f"sequence ({self.pages_per_seq} pages + trash page)")
        self.pool = init_paged_cache(model_cfg, engine_cfg.num_pages,
                                     self.page_size, self.device,
                                     kv_dtype=engine_cfg.kv_cache_dtype)
        self.allocator = make_allocator(engine_cfg.num_pages,
                                        engine_cfg.native)
        self._count("engine.allocator_native"
                    if type(self.allocator) is not PageAllocator
                    else "engine.allocator_python")
        # the tiered prefix cache: a passed store is SHARED (a restarted
        # engine warm-starts from it); otherwise the tier knobs build a
        # private one
        self.prefix_store = prefix_store
        if self.prefix_store is None and (engine_cfg.prefix_host_pages
                                          or engine_cfg.prefix_disk_dir
                                          or engine_cfg.prefix_disk_pages):
            self.prefix_store = PrefixStore(
                host_pages=engine_cfg.prefix_host_pages,
                disk_dir=engine_cfg.prefix_disk_dir,
                disk_pages=engine_cfg.prefix_disk_pages)
        self.prefix_cache = (
            PrefixCache(self.allocator, self.page_size,
                        store=self.prefix_store,
                        demote=self._demote_prefix_pages,
                        promote=self._promote_prefix_records,
                        count=self._count)
            if engine_cfg.prefix_cache else None)
        # watermark demotion and write-through, at tick boundaries;
        # _wt_resident: the resident count of the last flush
        self._hbm_watermark = int(engine_cfg.prefix_hbm_watermark)
        self._writethrough = bool(engine_cfg.prefix_store_writethrough
                                  and self.prefix_store is not None)
        self._wt_resident = 0
        # pages taken by an injected "oom" tick fault (one tick)
        self._fault_pages: List[int] = []
        # KV spill: seq_id -> host record {k, v, [k_scale, v_scale] (CPU
        # tensors [L, n, page, ...]), n_pages, n_shared, shared_pages,
        # length, cur_token}; the sequence itself waits in _pending
        self._spilled: Dict[int, Dict[str, object]] = {}
        self._spilled_pages_total = 0
        self.block_tables = np.full((b, self.pages_per_seq), TRASH_PAGE,
                                    np.int32)
        self.lengths = np.zeros((b,), np.int64)
        self.cur_tokens = np.zeros((b,), np.int64)
        self._free_slots = list(range(b))
        self._active: Dict[int, _Active] = {}
        self._pending: List[_Pending] = []
        self._admit_pending: List[Tuple[_Active, torch.Tensor, int]] = []
        # slot -> in-progress chunked prefill: the request, its page table
        # (kept OUT of block_tables until activation, so the idle slot's
        # decode garbage writes stay in the trash page), the cached-prefix
        # pages it holds, the pages it allocated and the tokens written
        self._prefilling: Dict[int, Dict[str, object]] = {}
        self._seq_counter = itertools.count()
        self._prompts: Dict[int, List[int]] = {}   # seq_id -> ORIGINAL prompt
        self._resumed: Dict[int, List[int]] = {}   # seq_id -> tokens generated
                                                   # before a preemption
        self._buckets = tuple(
            s for s in sorted(set(engine_cfg.prefill_buckets))
            if s <= engine_cfg.max_seq_len) or (engine_cfg.max_seq_len,)
        # the decode operands (tokens, lengths, block tables, DFA states
        # and budgets) in static device buffers, filled each tick from
        # staging buffers (pinned on the card), so a captured graph reads
        # them where it found them
        shapes = ((b,), (b,), (b, self.pages_per_seq), (b,), (b,))
        pin = self.device.type == "cuda"
        self._staging = tuple(torch.zeros(s, dtype=torch.int32,
                                          pin_memory=pin) for s in shapes)
        self._operands = tuple(torch.zeros(s, dtype=torch.int32,
                                           device=self.device)
                               for s in shapes)
        # padded DFA table size -> (static table buffers, the key, offsets
        # and tables of the combination they hold): _scan_dfa_setup's
        self._dfa_static: Dict[int, tuple] = {}
        # T -> (staging, device) [B, T] token buffers of the verify step
        self._multi_tokens: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        # the overlapped hot loop: with host_overlap the operand buffers
        # stay resident between ticks (uploaded only when _dev_dirty, then
        # edited slot by slot); _inflight_n counts each slot's dispatched
        # but uncommitted steps, so growth covers the device's length
        self._overlap = engine_cfg.host_overlap
        self._inflight = []
        self._flushed_out = []
        self._inflight_n: Dict[int, int] = {}
        self._dev_dirty = True
        # the overlapped step's clamp: the last in-table position
        self._dev_cap = self.pages_per_seq * self.page_size - 1
        self.graphs = (DecodeGraphs(self.device,
                                    None if self.sampling.greedy
                                    else self._gen, self._count)
                       if cuda_graphs and self.device.type == "cuda"
                       else None)

    # --------------------------------------------- device-side operands

    def _upload(self, i: int, array: np.ndarray) -> torch.Tensor:
        """Copy a host array into static operand ``i``.  The copy is
        asynchronous on the card: the staging buffer is rewritten only
        after the tick's fetch, which waits for it."""
        self._staging[i].numpy()[...] = array
        return self._operands[i].copy_(self._staging[i], non_blocking=True)

    def _device_state(self):
        """The decode operands (tokens, lengths, block tables) as the
        engine's static int32 device buffers.  Without ``host_overlap``
        every call uploads the three host mirrors; with it they upload only
        when dirty (the host changed them wholesale), and the slot edits
        below keep them current in between."""
        if self._overlap and not self._dev_dirty:
            return self._operands[:3]
        self._count("engine.h2d_uploads", 3)
        out = (self._upload(0, self.cur_tokens),
               self._upload(1, self.lengths),
               self._upload(2, self.block_tables))
        if self._overlap:
            self._dev_dirty = False
            # deferred first tokens exist only on the device so far
            for st, t, i in self._admit_pending:
                if self._active.get(st.slot) is st:
                    out[0][st.slot] = t[i]
        return out

    def _invalidate_device_state(self) -> None:
        self._dev_dirty = True

    def _dev_edit_token(self, slot: int, token) -> None:
        """Mirror one ``cur_tokens`` write (a host int or a device scalar)
        into the resident operand."""
        if self._overlap and not self._dev_dirty:
            self._operands[0][slot] = token

    def _dev_edit_len(self, slot: int, n: int) -> None:
        if self._overlap and not self._dev_dirty:
            self._operands[1][slot] = n

    def _dev_edit_bt_row(self, slot: int) -> None:
        """Mirror one block-table row (growth, admission, retirement): a
        freed slot's row back at the trash page is what keeps the
        overlapped step's garbage writes out of live pages."""
        if self._overlap and not self._dev_dirty:
            row = torch.from_numpy(self.block_tables[slot])
            if self.device.type == "cuda":
                # pinned and asynchronous: a pageable copy would wait for
                # the step in flight (the caching host allocator keeps the
                # pinned block until the copy has run)
                row = row.pin_memory()
            self._operands[2][slot].copy_(row, non_blocking=True)

    def _covered_len(self, slot: int) -> int:
        """The slot's length with its dispatched but uncommitted steps:
        what growth must cover, since the next dispatch writes there."""
        return int(self.lengths[slot]) + self._inflight_n.get(slot, 0)

    def _note_flush_entry(self, entry: dict) -> None:
        for s, _ in entry["slots"]:
            n = self._inflight_n.get(s, 0) - 1
            if n > 0:
                self._inflight_n[s] = n
            else:
                self._inflight_n.pop(s, None)

    def _overlap_post_commit(self, slot: int, token: int) -> None:
        # the host mirrors catch up with the device: the resident state
        # stays clean
        self.lengths[slot] += 1
        self.cur_tokens[slot] = token

    def _note_first_token(self, slot: int, token: int,
                          update_dev: bool) -> None:
        self.cur_tokens[slot] = token
        if update_dev:
            self._dev_edit_token(slot, token)

    def _decode(self, key: tuple, fn):
        """Run a decode function: eagerly, or through its bucket's CUDA
        graph."""
        if self.graphs is None:
            return fn()
        return self.graphs.run(key, fn)

    # ------------------------------------------------------------- tick

    def _tick(self) -> List[SequenceResult]:
        finished: List[SequenceResult] = self._reap_deadlines()
        if self._flushed_out:
            # results of a flush made outside a tick (cancel, deadlines)
            finished.extend(self._flushed_out)
            self._flushed_out = []
        fast = self._overlap_fast()
        if self._inflight and not fast:
            # a synchronous path runs this tick: commit the lag first
            finished.extend(self._overlap_flush())
        if self._prefilling:
            # every chunked prefill advances one chunk BEFORE admission, so
            # it makes progress while new admissions compete for pages
            finished.extend(self._tick_prefill_chunks())
        if self._pending and self._free_slots:
            with annotate("engine.tick.admission"):
                finished.extend(self._tick_admission())
        if not fast:
            # one fetch commits every first token sampled at admission
            finished.extend(self._drain_admission_commits())
        if not self._active:
            finished.extend(self._overlap_flush())
            return finished
        with annotate("engine.tick.eviction"):
            self._tick_pressure()
            self._tick_growth()
        active_slots = sorted(self._active)
        if not active_slots:
            finished.extend(self._overlap_flush())
            return finished

        if self._speculation_applies():
            finished.extend(self._speculative_tick(active_slots))
            return finished

        chunk = self._scan_chunk()
        if chunk > 1:
            finished.extend(self._scan_tick(chunk, active_slots))
            return finished

        if fast:
            finished.extend(self._overlap_step_tick(active_slots))
            return finished

        forced, allow = self._tick_constraints(
            active_slots, self.engine_cfg.max_batch,
            self.model_cfg.vocab_size)
        cur_d, lens_d, bt_d = self._device_state()
        cfg, params, pool = self.model_cfg, self.params, self.pool
        with annotate("engine.decode_step"):
            self._count("engine.dispatches")
            self._count("engine.decode_steps")
            logits = self._decode(("step",), lambda: paged_decode_step(
                cfg, params, pool, cur_d, lens_d, bt_d)[1])
            if allow is not None:
                next_tokens = sample_tokens_masked(
                    logits, self._gen, self.sampling,
                    torch.from_numpy(allow).to(self.device))
            else:
                next_tokens = sample_tokens(logits, self._gen,
                                            self.sampling)
        self._count("engine.decode_tokens", len(active_slots))
        (host_next,) = self._fetch(next_tokens)
        for slot in active_slots:
            self.lengths[slot] += 1
            st = self._active[slot]
            token = forced.get(slot, int(host_next[slot]))
            self.cur_tokens[slot] = token
            st.generated.append(token)
            if st.grammar is not None:
                st.grammar.advance(token)
            reason = self._finish_reason(st, token, int(self.lengths[slot]))
            if reason is not None:
                finished.append(self._retire(slot, reason))
        # the host commit is authoritative: re-upload before the next step
        self._invalidate_device_state()
        return finished

    def _overlap_step_tick(self, active_slots) -> List[SequenceResult]:
        """The overlapped fast path: ONE dispatch over the resident
        operands (``paged_overlap_step``), no fetch; the token vector
        joins ``_inflight`` and commits when the lag flushes
        (``decode_tokens`` count there, as on the plain path)."""
        # the device state first: a dirty upload re-applies the deferred
        # first tokens, so take them only after it
        cur_d, lens_d, bt_d = self._device_state()
        admits = self._take_admit_pending()
        slots = [(s, self._active[s].seq_id) for s in active_slots]
        cfg, params, pool = self.model_cfg, self.params, self.pool
        gen, sampling, cap = self._gen, self.sampling, self._dev_cap
        with annotate("engine.decode_step"):
            self._count("engine.dispatches")
            self._count("engine.decode_steps")
            nxt = self._decode(("overlap",), lambda: paged_overlap_step(
                cfg, params, pool, cur_d, lens_d, bt_d, gen, sampling,
                cap)[1])
        # a graph's output is rewritten by its next replay: keep a copy
        # until the lagged flush reads it
        toks = nxt.clone() if self.graphs is not None else nxt
        for s in active_slots:
            self._inflight_n[s] = self._inflight_n.get(s, 0) + 1
        self._inflight.append({"slots": slots, "toks": toks,
                               "admits": admits})
        if len(self._inflight) >= self._overlap_lag:
            return self._overlap_flush()
        return []

    # ------------------------------------------------ speculative decoding

    def _spec_room_ok(self, slot: int, t: int) -> bool:
        # all T writes land in the slot's CURRENT page, under the cap
        length = int(self.lengths[slot])
        return (length % self.page_size + t <= self.page_size
                and length + t <= self.engine_cfg.max_seq_len)

    def _multi_tokens_buffer(self, tokens_in: np.ndarray) -> torch.Tensor:
        """``tokens_in`` [B, T] in the verify step's static device buffer
        of its T (staging pinned on the card, as ``_upload``'s)."""
        t = tokens_in.shape[1]
        if t not in self._multi_tokens:
            pin = self.device.type == "cuda"
            self._multi_tokens[t] = (
                torch.zeros(tokens_in.shape, dtype=torch.int32,
                            pin_memory=pin),
                torch.zeros(tokens_in.shape, dtype=torch.int32,
                            device=self.device))
        staging, dev = self._multi_tokens[t]
        staging.numpy()[...] = tokens_in
        return dev.copy_(staging, non_blocking=True)

    def _verify_pages(self, active_slots, t: int) -> int:
        """Pages per row the card's verify attention gathers: enough for
        the batch's longest ``lengths + T``, rounded up to a power of two
        (one graph per bucket) and capped at the table."""
        need = max(int(self.lengths[s]) + t for s in active_slots)
        return min(_pow2_at_least(-(-need // self.page_size)),
                   self.pages_per_seq)

    def _speculative_tick(self, active_slots) -> List[SequenceResult]:
        """Verification tick: the n-gram drafts scored by ONE
        ``paged_decode_multi``, committed through ``_verify_and_commit``.
        Grammar slots sharing one compiled DFA verify constrained on the
        device (``dfa_greedy_multi``, inside the same graph); an
        interpreted grammar or mixed tables take [B, T, V] logits to the
        host."""
        tokens_in, drafts = self._build_drafts(active_slots, self.cur_tokens)
        t = tokens_in.shape[1]
        n_pages = self._verify_pages(active_slots, t)
        need_logits = self._need_spec_logits(active_slots)
        setup = (self._scan_dfa_setup()
                 if need_logits and self._uniform_dfa_tables() is not None
                 else None)
        # the [B, T] tokens are the verify step's own operand; lengths and
        # block tables are the uploads it pays
        self._count("engine.h2d_uploads", 2)
        toks_d = self._multi_tokens_buffer(tokens_in)
        lens_d = self._upload(1, self.lengths)
        bt_d = self._upload(2, self.block_tables)
        cfg, params, pool = self.model_cfg, self.params, self.pool
        logits_host = None
        with annotate("engine.decode_step"):
            self._count("engine.dispatches")
            self._count("engine.decode_steps")
            self._count("engine.verify_steps")
            if setup is None:
                greedy, logits = self._decode(
                    ("multi", t, n_pages), lambda: paged_decode_multi(
                        cfg, params, pool, toks_d, lens_d, bt_d,
                        n_pages)[1:])
                if need_logits:
                    greedy_host, logits_host = self._fetch(greedy, logits)
                else:
                    (greedy_host,) = self._fetch(greedy)
            else:
                tables, states, remaining = setup
                states_d = self._upload(3, states)
                remaining_d = self._upload(4, remaining)
                eos = self.tokenizer.eos_id
                greedy = self._decode(
                    ("multi-dfa", t, n_pages, tables[0].shape[0]),
                    lambda: dfa_greedy_multi(
                        paged_decode_multi(cfg, params, pool, toks_d,
                                           lens_d, bt_d, n_pages)[2],
                        states_d, remaining_d, eos, *tables))
                (greedy_host,) = self._fetch(greedy)

        def post_commit(slot: int, token: int) -> None:
            self.lengths[slot] += 1
            self.cur_tokens[slot] = token

        out = self._verify_and_commit(active_slots, drafts, greedy_host,
                                      logits_host, post_commit,
                                      constrained=setup is not None)
        # the host mirrors moved by a per-slot accepted count
        self._invalidate_device_state()
        return out

    def _tick_admission(self) -> List[SequenceResult]:
        """Admit pending requests into free slots until the queue, the
        slots or the pages run out: a prompt longer than the chunk budget
        through the chunked path, otherwise one group per dispatch (misses
        in one batched prefill, equal-prefix hits in one batched chunk
        prefill).  Admission never preempts running work.  Returns the
        grammar admissions whose constrained first token already finished
        them."""
        finished: List[SequenceResult] = []
        budget = self.engine_cfg.prefill_chunk_budget
        while self._pending and self._free_slots:
            if self._spilled and self._pending[0].seq_id in self._spilled:
                # a KV-spilled sequence resumes by restoring its pages: no
                # prefill, the decode state of the moment it left
                try:
                    self._admit_spilled(self._pending[0])
                except OutOfPages:
                    # the record stays; retirements refill the pool
                    self._count("engine.admission_rejections")
                    break
                del self._pending[:1]
                continue
            if budget and len(self._pending[0].prompt_ids) > budget:
                try:
                    early = self._admit_chunked(self._pending[0])
                except OutOfPages:
                    self._count("engine.admission_rejections")
                    break
                del self._pending[:1]
                if early is not None:
                    finished.append(early)
                continue
            group, matches = self._admission_group()
            try:
                if len(group) == 1:
                    early = self._admit(group[0], matches[0])
                    admitted = [early] if early is not None else []
                elif matches[0][1]:
                    admitted = self._admit_batch_hits(group, matches)
                else:
                    admitted = self._admit_batch(group)
            except OutOfPages:
                self._count("engine.admission_rejections")
                break
            del self._pending[:len(group)]
            finished.extend(admitted)
        return finished

    def _tick_growth(self) -> None:
        """Cover this tick's decode window with pages: the page holding
        position ``lengths`` is mandatory (a slot that cannot get it
        preempts a victim or is preempted itself); pages for the rest of
        the ``decode_chunk`` window are best-effort, so under pool
        pressure the slot's chunk bound shrinks instead.  Mandatory pages
        for every slot come before any lookahead."""
        chunk_goal = max(1, self.engine_cfg.decode_chunk)
        for slot in sorted(self._active):
            if slot not in self._active:
                continue     # evicted by an earlier slot's preemption
            # the covered length: with a lagged commit the next dispatch
            # writes at the device's length, ahead of the host mirror
            if self._covered_len(slot) % self.page_size == 0:
                while slot in self._active:
                    try:
                        self._grow(slot)
                        break
                    except OutOfPages:
                        if not self._preempt_victim(exclude=slot):
                            self._preempt_slot(slot)
                            break
        if chunk_goal > 1:
            for slot in sorted(self._active):
                st = self._active[slot]
                pos = self._covered_len(slot)
                last = min(pos + chunk_goal - 1,
                           self.pages_per_seq * self.page_size - 1)
                grew = False
                for idx in range(pos // self.page_size + 1,
                                 last // self.page_size + 1):
                    if self.block_tables[slot, idx] != TRASH_PAGE:
                        continue
                    try:
                        # best-effort: never evicts prefix pages
                        (page,) = self.allocator.alloc(1, owner=st.seq_id)
                    except OutOfPages:
                        break
                    self.block_tables[slot, idx] = page
                    grew = True
                if grew:
                    self._dev_edit_bt_row(slot)

    def _chunk_bound(self, slot: int) -> int:
        """The slot's contiguous allocated run from its current position:
        a scan may cross page boundaries only into pre-allocated pages."""
        pos = int(self.lengths[slot])
        idx = pos // self.page_size
        while (idx < self.pages_per_seq
               and self.block_tables[slot, idx] != TRASH_PAGE):
            idx += 1
        return idx * self.page_size - pos

    def _scan_tick(self, chunk: int, active_slots) -> List[SequenceResult]:
        """Commit ``chunk`` decode steps run in one device loop, with the
        fused grammar DFA inside it when a DFA slot is active."""
        setup = self._scan_dfa_setup()
        cur_d, lens_d, bt_d = self._device_state()
        cfg, params, pool = self.model_cfg, self.params, self.pool
        gen, sampling, eos = self._gen, self.sampling, self.tokenizer.eos_id
        if setup is None:
            with annotate("engine.decode_step"):
                self._count("engine.dispatches")
                self._count("engine.decode_steps", chunk)
                toks, lens = self._decode(
                    ("scan", chunk), lambda: paged_decode_scan(
                        cfg, params, pool, cur_d, lens_d, bt_d, gen, chunk,
                        sampling, eos)[1:])
        else:
            tables, states, remaining = setup
            states_d = self._upload(3, states)
            remaining_d = self._upload(4, remaining)
            with annotate("engine.decode_step"):
                self._count("engine.dispatches")
                self._count("engine.decode_steps", chunk)
                toks, lens = self._decode(
                    ("dfa", chunk, tables[0].shape[0]),
                    lambda: paged_decode_scan_dfa(
                        cfg, params, pool, cur_d, lens_d, bt_d, gen, chunk,
                        sampling, eos, states_d, remaining_d,
                        *tables)[1:3])
        if self._overlap:
            # the surviving slots' host mirrors advance to exactly these
            # values in the commit below (a slot that stops short retires),
            # so the resident operands stay clean for the next dispatch
            cur_d.copy_(toks[-1])
            lens_d.copy_(lens)
        (toks_host,) = self._fetch(toks)                # [chunk, B]

        def post_commit(slot: int, token: int) -> None:
            self.lengths[slot] += 1
            self.cur_tokens[slot] = token
            self._grammar_post_commit(slot, token)

        return self._commit_scanned(active_slots, toks_host, chunk,
                                    post_commit)

    # ------------------------------------------------------ admission

    def _bucket(self, n: int) -> int:
        """Prefill bucket of an n-token prompt, rounded up to whole pages."""
        for b in self._buckets:
            if n <= b:
                return -(-b // self.page_size) * self.page_size
        return self.pages_per_seq * self.page_size

    def _alloc_with_evict(self, n: int, owner: int) -> List[int]:
        """Allocate, evicting refcount-0 prefix-cache pages on pressure."""
        try:
            return self.allocator.alloc(n, owner=owner)
        except OutOfPages:
            if self.prefix_cache is None:
                raise
            need = n - self.allocator.n_free
            if self.prefix_cache.evict(need) < need:
                raise
            return self.allocator.alloc(n, owner=owner)

    def _admission_group(self) -> Tuple[List[_Pending],
                                        List[Tuple[List[int], int]]]:
        """Peek a FIFO run of same-bucket pending requests for one
        dispatch, with each member's prefix-cache match (acquired, so
        admission does not match twice).

        A head with a cached prefix groups with the following same-bucket
        requests whose match has the SAME cached length (one shared
        preamble), up to 16, for one batched chunk prefill.  A miss head
        groups up to 8 misses; a member with any cached prefix ends a miss
        group.  Both are bounded by the pages the pool can give (free plus
        evictable), since the batched allocation is all-or-nothing."""
        head = self._pending[0]
        matched: Tuple[List[int], int] = ([], 0)
        if self.prefix_cache is not None:
            matched = self.prefix_cache.match(head.prompt_ids)
        b0 = self._bucket(len(head.prompt_ids))
        group, matches = [head], [matched]
        evictable = (self.prefix_cache.n_evictable
                     if self.prefix_cache is not None else 0)
        supply = self.allocator.n_free + evictable
        if matched[1]:
            n_pages_hit = max(1, self._bucket(
                max(1, b0 - matched[1])) // self.page_size)
            cap = min(16, len(self._free_slots),
                      max(1, supply // n_pages_hit))
            for req in itertools.islice(self._pending, 1, None):
                if (len(group) >= cap
                        or self._bucket(len(req.prompt_ids)) != b0):
                    break
                m = self.prefix_cache.match(req.prompt_ids)
                if m[1] != matched[1]:
                    self.prefix_cache.release(m[0])
                    break
                group.append(req)
                matches.append(m)
            return group, matches
        n_pages = max(1, b0 // self.page_size)
        cap = min(8, len(self._free_slots), max(1, supply // n_pages))
        for req in itertools.islice(self._pending, 1, None):
            if len(group) >= cap or self._bucket(len(req.prompt_ids)) != b0:
                break
            if self.prefix_cache is not None \
                    and self.prefix_cache.has_prefix(req.prompt_ids):
                break
            group.append(req)
            matches.append(([], 0))
        return group, matches

    def _table_row(self, cached: Sequence[int],
                   pages: Sequence[int]) -> np.ndarray:
        table = np.full((self.pages_per_seq,), TRASH_PAGE, np.int32)
        table[:len(cached)] = cached
        table[len(cached):len(cached) + len(pages)] = pages
        return table

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _prefill_chunk(self, tokens: np.ndarray, chunk_len: int,
                       prefix_len: int, table: np.ndarray,
                       page_map: np.ndarray):
        """One chunk prefill over the first ``prefix_len // page`` pages of
        ``table``, the prefix table padded to a power of two of pages (the
        gather and the attention span the whole table).  Returns logits."""
        n_pre = prefix_len // self.page_size
        prefix_table = np.full((_pow2_at_least(n_pre),), TRASH_PAGE, np.int32)
        prefix_table[:n_pre] = table[:n_pre]
        self._count("engine.dispatches")
        self._count("engine.chunk_prefill_dispatches")
        self.pool, logits = paged_prefill_chunk(
            self.model_cfg, self.params, self.pool, self._to_device(tokens),
            chunk_len, prefix_len, self._to_device(prefix_table),
            self._to_device(page_map))
        return logits

    def _admit(self, req: _Pending,
               matched: Tuple[List[int], int]) -> Optional[SequenceResult]:
        """Admit one sequence: a prefix hit prefills only its suffix over
        the cached pages, a miss the whole prompt.  A grammar sequence
        commits its constrained first token now (the FSM needs it before
        the next dispatch); others at the tick's drain."""
        cached_pages, n_cached = matched
        n_cp = len(cached_pages)
        rest = req.prompt_ids[n_cached:]
        bucket, n_pages = suffix_bucket(self._bucket, len(rest), n_cp,
                                        self.page_size, self.pages_per_seq)
        try:
            pages = self._alloc_with_evict(n_pages, owner=req.seq_id)
        except OutOfPages:
            if cached_pages:
                self.prefix_cache.release(cached_pages)
            raise
        slot = self._free_slots.pop(0)
        table = self._table_row(cached_pages, pages)
        self.block_tables[slot] = table
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(rest)] = rest
        with annotate("engine.prefill"):
            if n_cached:
                logits = self._prefill_chunk(padded, len(rest), n_cached,
                                             table,
                                             table[n_cp:n_cp + n_pages])
                self._count("engine.prefix_hit_tokens", n_cached)
            else:
                self._count("engine.dispatches")
                self._count("engine.prefill_dispatches")
                self.pool, logits = paged_prefill(
                    self.model_cfg, self.params, self.pool,
                    self._to_device(padded), len(rest),
                    self._to_device(table[:n_pages]))
            first = sample_tokens(logits, self._gen, self.sampling)
        self._count("engine.prefill_tokens", len(rest))
        return self._activate_first(req, slot, table, n_cp, logits, first)

    def _activate_first(self, req: _Pending, slot: int, table: np.ndarray,
                        n_cp: int, logits, first: torch.Tensor,
                        idx: int = 0) -> Optional[SequenceResult]:
        """Activate an admission whose first token is row ``idx`` of
        ``first``: synchronously for a grammar sequence, at the tick's
        drain otherwise."""
        if req.grammar is not None:
            return self._activate_now(req, slot, table, n_cp,
                                      logits[idx:idx + 1],
                                      int(self._fetch(first)[0][idx]))
        st = self._activate(req, slot, table, n_cp)
        self._dev_edit_token(slot, first[idx])
        self._admit_pending.append((st, first, idx))
        return None

    def _admit_chunked(self, req: _Pending) -> Optional[SequenceResult]:
        """Admit a prompt longer than ``prefill_chunk_budget``: every page
        allocates now (all-or-nothing, as ``_admit``: a sequence stalled
        mid-prefill for pages would hold pages while blocking the pool),
        and the prefill runs one budget-sized chunk per tick through the
        chunk-prefill path of the prefix hits, the first chunk now.  A
        prompt whose suffix after a prefix hit fits the budget admits
        normally."""
        matched = (self.prefix_cache.match(req.prompt_ids)
                   if self.prefix_cache is not None else ([], 0))
        cached_pages, n_cached = matched
        rest = req.prompt_ids[n_cached:]
        if len(rest) <= self.engine_cfg.prefill_chunk_budget:
            return self._admit(req, matched)
        n_cp = len(cached_pages)
        _, n_pages = suffix_bucket(self._bucket, len(rest), n_cp,
                                   self.page_size, self.pages_per_seq)
        try:
            pages = self._alloc_with_evict(n_pages, owner=req.seq_id)
        except OutOfPages:
            if cached_pages:
                self.prefix_cache.release(cached_pages)
            raise
        slot = self._free_slots.pop(0)
        self._prefilling[slot] = {
            "req": req, "table": self._table_row(cached_pages, pages),
            "n_cp": n_cp, "cached": [int(p) for p in cached_pages],
            "pages": [int(p) for p in pages],
            "done": n_cached, "total": len(req.prompt_ids),
        }
        if n_cached:
            self._count("engine.prefix_hit_tokens", n_cached)
        return self._advance_prefill(slot)   # the first chunk goes now

    def _advance_prefill(self, slot: int) -> Optional[SequenceResult]:
        """Dispatch ONE chunk of a slot's chunked prefill; the final chunk
        samples the first token and activates the slot."""
        st = self._prefilling[slot]
        req, table = st["req"], st["table"]
        budget = self.engine_cfg.prefill_chunk_budget
        done, total = st["done"], st["total"]
        chunk_len = min(budget, total - done)
        ps = self.page_size
        # ``done`` is page-aligned: it starts at the cached prefix and
        # every non-final chunk advances it by the page-multiple budget.
        # Every chunk has the [1, budget] shape; the final one right-pads
        # and maps only its own pages, its padding to the trash page.
        n_pre = done // ps
        padded = np.zeros((1, budget), np.int32)
        padded[0, :chunk_len] = req.prompt_ids[done:done + chunk_len]
        page_map = np.full((budget // ps,), TRASH_PAGE, np.int32)
        n_chunk_pages = -(-chunk_len // ps)
        page_map[:n_chunk_pages] = table[n_pre:n_pre + n_chunk_pages]
        with annotate("engine.tick.prefill_chunk"):
            self._count("engine.prefill_chunks")
            logits = self._prefill_chunk(padded, chunk_len, done, table,
                                         page_map)
        self._count("engine.prefill_tokens", chunk_len)
        st["done"] = done + chunk_len
        if st["done"] < total:
            return None
        del self._prefilling[slot]
        self.block_tables[slot] = table
        first = sample_tokens(logits, self._gen, self.sampling)
        return self._activate_first(req, slot, table, st["n_cp"], logits,
                                    first)

    def _tick_prefill_chunks(self) -> List[SequenceResult]:
        """Advance every chunked prefill by one chunk."""
        finished: List[SequenceResult] = []
        for slot in sorted(self._prefilling):
            early = self._advance_prefill(slot)
            if early is not None:
                finished.append(early)
        return finished

    def _abort_prefilling(self, slot: int) -> None:
        """Cancel a chunked prefill: drop its prefix references, free its
        pages, return the slot."""
        st = self._prefilling.pop(slot)
        seq_id = st["req"].seq_id
        if st["cached"]:
            self.prefix_cache.release(st["cached"])
        if st["pages"]:
            self.allocator.free(st["pages"], owner=seq_id)
        self.block_tables[slot] = TRASH_PAGE
        self._dev_edit_bt_row(slot)
        self._free_slots.append(slot)
        self._prompts.pop(seq_id, None)
        self._resumed.pop(seq_id, None)
        if self._deadlines:
            self._deadlines.pop(seq_id, None)

    def _expire_extra(self, seq_id: int) -> Optional[SequenceResult]:
        for slot, pst in list(self._prefilling.items()):
            if pst["req"].seq_id == seq_id:
                res = self._expired_result(seq_id, pst["req"])
                self._abort_prefilling(slot)
                return res
        return None

    @property
    def has_work(self) -> bool:
        return bool(self._active or self._pending or self._prefilling)

    def cancel_seq(self, seq_id: int) -> bool:
        for slot, st in list(self._prefilling.items()):
            if st["req"].seq_id == seq_id:
                self._abort_prefilling(slot)
                return True
        return super().cancel_seq(seq_id)

    def _admit_batch_hits(self, reqs: List[_Pending],
                          matches: List[Tuple[List[int], int]]
                          ) -> List[SequenceResult]:
        """Admit N same-bucket prefix hits of EQUAL cached length with ONE
        batched chunk prefill, padded to a power of two by repeating the
        last real row (tokens, prefix AND pages: identical duplicate
        writes).  The matches arrive acquired; on OutOfPages every
        reference is released before it escapes."""
        n_cached = matches[0][1]
        n_cp = len(matches[0][0])
        rests = [r.prompt_ids[n_cached:] for r in reqs]
        bucket, n_pages = suffix_bucket(
            self._bucket, max(len(r) for r in rests), n_cp, self.page_size,
            self.pages_per_seq)
        n = len(reqs)
        allocated: List[List[int]] = []
        try:
            for r in reqs:
                allocated.append(
                    self._alloc_with_evict(n_pages, owner=r.seq_id))
        except OutOfPages:
            for r, pages in zip(reqs, allocated):
                self.allocator.free(pages, owner=r.seq_id)
            for m in matches:
                self.prefix_cache.release(m[0])
            raise
        slots = [self._free_slots.pop(0) for _ in range(n)]
        n_pad = _pow2_at_least(n)
        pb = _pow2_at_least(n_cp)
        tokens = np.zeros((n_pad, bucket), np.int32)
        clens = np.zeros((n_pad,), np.int32)
        plens = np.full((n_pad,), n_cached, np.int32)
        ptabs = np.full((n_pad, pb), TRASH_PAGE, np.int32)
        maps = np.zeros((n_pad, n_pages), np.int32)
        tables = []
        for i, (m, rest) in enumerate(zip(matches, rests)):
            tokens[i, :len(rest)] = rest
            clens[i] = len(rest)
            ptabs[i, :n_cp] = m[0]
            maps[i] = allocated[i]
            tables.append(self._table_row(m[0], allocated[i]))
            self.block_tables[slots[i]] = tables[i]
        for a in (tokens, clens, ptabs, maps):
            a[n:] = a[n - 1]
        with annotate("engine.prefill"):
            self._count("engine.dispatches")
            self._count("engine.chunk_prefill_dispatches")
            self.pool, logits = paged_prefill_chunk_batch(
                self.model_cfg, self.params, self.pool,
                *(self._to_device(a) for a in (tokens, clens, plens, ptabs,
                                               maps)))
            firsts = sample_tokens(logits, self._gen, self.sampling)
        self._count("engine.prefill_tokens", sum(len(r) for r in rests))
        self._count("engine.prefix_hit_tokens", n_cached * n)
        self._count("engine.prefix_batch_hit_admissions", n)
        return self._activate_group(reqs, slots, tables, n_cp, logits,
                                    firsts)

    def _admit_batch(self, reqs: List[_Pending]) -> List[SequenceResult]:
        """Admit N same-bucket prefix misses with ONE batched prefill,
        padded to a power of two by repeating the last real row's tokens
        AND pages (the duplicate page writes are identical)."""
        n = len(reqs)
        bucket, n_pages = suffix_bucket(
            self._bucket, max(len(r.prompt_ids) for r in reqs), 0,
            self.page_size, self.pages_per_seq)
        allocated: List[List[int]] = []
        try:
            for r in reqs:
                allocated.append(
                    self._alloc_with_evict(n_pages, owner=r.seq_id))
        except OutOfPages:
            for r, pages in zip(reqs, allocated):
                self.allocator.free(pages, owner=r.seq_id)
            raise
        slots = [self._free_slots.pop(0) for _ in range(n)]
        n_pad = _pow2_at_least(n)
        tokens = np.zeros((n_pad, bucket), np.int32)
        lens = np.zeros((n_pad,), np.int32)
        maps = np.zeros((n_pad, n_pages), np.int32)
        tables = []
        for i, r in enumerate(reqs):
            tokens[i, :len(r.prompt_ids)] = r.prompt_ids
            lens[i] = len(r.prompt_ids)
            maps[i] = allocated[i]
            tables.append(self._table_row((), allocated[i]))
            self.block_tables[slots[i]] = tables[i]
        for a in (tokens, lens, maps):
            a[n:] = a[n - 1]
        with annotate("engine.prefill"):
            self._count("engine.dispatches")
            self._count("engine.prefill_dispatches")
            self.pool, logits = paged_prefill_batch(
                self.model_cfg, self.params, self.pool,
                *(self._to_device(a) for a in (tokens, lens, maps)))
            firsts = sample_tokens(logits, self._gen, self.sampling)
        self._count("engine.prefill_tokens", int(lens[:n].sum()))
        self._count("engine.batched_admissions", n)
        return self._activate_group(reqs, slots, tables, 0, logits, firsts)

    def _activate_group(self, reqs: List[_Pending], slots: List[int],
                        tables: List[np.ndarray], n_cp: int, logits,
                        firsts: torch.Tensor) -> List[SequenceResult]:
        """Activate a batched admission: a group with a grammar member
        commits every first token now, in order (one fetch); others at
        the tick's drain."""
        finished: List[SequenceResult] = []
        if any(r.grammar is not None for r in reqs):
            (firsts_host,) = self._fetch(firsts)
            for i, req in enumerate(reqs):
                early = self._activate_now(req, slots[i], tables[i], n_cp,
                                           logits[i:i + 1],
                                           int(firsts_host[i]))
                if early is not None:
                    finished.append(early)
            return finished
        for i, req in enumerate(reqs):
            st = self._activate(req, slots[i], tables[i], n_cp)
            self._dev_edit_token(slots[i], firsts[i])
            self._admit_pending.append((st, firsts, i))
        return finished

    def _activate(self, req: _Pending, slot: int, table: np.ndarray,
                  n_cp: int) -> _Active:
        """Register an admitted sequence in its slot and chain its full
        prompt pages into the prefix cache; its first token commits at
        the tick's drain (``_drain_admission_commits``)."""
        n_shared = n_cp
        if self.prefix_cache is not None:
            n_shared = self.prefix_cache.insert(req.prompt_ids, table,
                                                req.seq_id, n_cp)
        st = _Active(seq_id=req.seq_id, slot=slot,
                     prompt_tokens=len(req.prompt_ids),
                     max_new_tokens=req.max_new_tokens,
                     stop_strings=req.stop_strings, grammar=req.grammar,
                     n_shared=n_shared, priority=req.priority)
        self._active[slot] = st
        self.lengths[slot] = len(req.prompt_ids)
        self._dev_edit_len(slot, len(req.prompt_ids))
        self._dev_edit_bt_row(slot)
        return st

    def _activate_now(self, req: _Pending, slot: int, table: np.ndarray,
                      n_cp: int, logits_1v,
                      first_token: int) -> Optional[SequenceResult]:
        """Synchronous activation: grammar-constrain the first token (cache
        room as the budget), advance the FSM and commit it."""
        st = self._activate(req, slot, table, n_cp)
        token = first_token
        if st.grammar is not None:
            remaining = min(st.max_new_tokens,
                            self.engine_cfg.max_seq_len
                            - st.prompt_tokens - 1)
            token = self._grammar_first_token(st.grammar, logits_1v, token,
                                              remaining)
            st.grammar.advance(token)
        return self._commit_first(st, token)

    # ------------------------------------------------ growth / preemption

    def _grow(self, slot: int) -> None:
        st = self._active[slot]
        idx = self._covered_len(slot) // self.page_size
        if idx >= self.pages_per_seq:
            return                              # at cap; finish_reason handles
        if self.block_tables[slot, idx] != TRASH_PAGE:
            return                              # page already present
        (page,) = self._alloc_with_evict(1, owner=st.seq_id)
        self.block_tables[slot, idx] = page
        self._dev_edit_bt_row(slot)

    def _preempt_victim(self, exclude: Optional[int] = None,
                        spill: bool = True) -> bool:
        """Evict one active sequence: the lowest priority class first,
        the youngest within it.  ``spill=False`` forces the free-and-
        re-prefill path even with spill on (the "crash" tick fault)."""
        candidates = [s for s in self._active if s != exclude]
        if not candidates:
            return False
        slot = max(candidates, key=lambda s: (self._active[s].priority,
                                              self._active[s].seq_id))
        self._preempt_slot(slot, spill=spill)
        return True

    def _release_slot_pages(self, slot: int, st: _Active) -> None:
        """Return a slot's pages: the shared prefix to the prefix cache
        (one reference each), the private pages to the allocator."""
        table = self.block_tables[slot]
        shared = [int(p) for p in table[:st.n_shared]]
        private = [int(p) for p in table[st.n_shared:] if p != TRASH_PAGE]
        if shared:
            self.prefix_cache.release(shared)
        if private:
            self.allocator.free(private, owner=st.seq_id)

    def _preempt_slot(self, slot: int, spill: bool = True) -> None:
        """Take a slot's sequence off the card and requeue it at the front
        of its class with prompt + generated so far as the new prompt.  Its
        KV spills to the host when ``_maybe_spill`` takes it (it then
        resumes by a page restore), else its pages are freed and a
        re-prefill resumes it."""
        st = self._active.pop(slot)
        spilled = spill and self._maybe_spill(slot, st)
        if not spilled:
            self._release_slot_pages(slot, st)
        self.block_tables[slot] = TRASH_PAGE
        self._dev_edit_bt_row(slot)     # contain in-flight garbage writes
        self.lengths[slot] = 0     # the scan advances idle slots too
        self._free_slots.append(slot)
        prefix = self._resumed.get(st.seq_id, []) + st.generated
        self._resumed[st.seq_id] = prefix
        resumed_prompt = self._prompts[st.seq_id] + prefix
        remaining = max(1, st.max_new_tokens - len(st.generated))
        log.info("preempting seq %d (slot %d, %d tokens, %s) to free pages",
                 st.seq_id, slot, len(resumed_prompt),
                 "kv spilled" if spilled else "re-prefill")
        self._count("engine.preemptions", 1)
        # the grammar FSM rides along: its state already reflects every
        # generated token now baked into the resume prompt
        self._enqueue(_Pending(st.seq_id, resumed_prompt, remaining,
                               st.stop_strings, st.grammar,
                               priority=st.priority), front=True)

    # ------------------------------------------------------- memory tiers

    def _maybe_spill(self, slot: int, st: _Active) -> bool:
        """Spill a preempted slot's written private pages to the host (ONE
        gather, one sync) so it resumes by a page restore instead of a
        re-prefill.  Returns False, leaving the caller on the re-prefill
        path, when spill is off, the slot's first token has not committed
        (a deferred admission: its covered length is ambiguous), a written
        page is the trash page, or the ``max_spilled_pages`` budget would
        be exceeded (counted as ``engine.spill_budget_fallbacks``).  On
        success the private pages go back to the allocator; the shared
        prefix pages keep their references (held by the record, handed
        back to the slot at restore), so they cannot be evicted meanwhile."""
        if not self.engine_cfg.max_spilled_pages:
            return False
        prefix = self._resumed.get(st.seq_id, []) + st.generated
        if not prefix:
            return False
        # committed state: lengths == prompt_tokens + len(generated) - 1
        length = int(self.lengths[slot])
        if length + 1 != st.prompt_tokens + len(st.generated):
            return False
        ps = self.page_size
        n_written = -(-length // ps)
        table = self.block_tables[slot]
        shared = [int(p) for p in table[:st.n_shared]]
        spill_idx = [int(p) for p in table[st.n_shared:n_written]]
        if any(p == TRASH_PAGE for p in spill_idx):
            return False
        if (self._spilled_pages_total + len(spill_idx)
                > self.engine_cfg.max_spilled_pages):
            self._count("engine.spill_budget_fallbacks")
            return False
        extra = [int(p) for p in table[n_written:] if p != TRASH_PAGE]
        with annotate("engine.spill"):
            rec: Dict[str, object] = {
                "n_pages": len(spill_idx), "n_shared": st.n_shared,
                "shared_pages": shared, "length": length,
                "cur_token": int(self.cur_tokens[slot]),
            }
            if spill_idx:
                # on the card the gather runs on the engine's stream after
                # every dispatched step, so it sees their writes
                rec.update(gather_pages(self.pool, self._fetch_host,
                                        spill_idx))
            self._spilled[st.seq_id] = rec
            self._spilled_pages_total += len(spill_idx)
            self._count("engine.spilled_pages", len(spill_idx))
        if spill_idx or extra:
            self.allocator.free(spill_idx + extra, owner=st.seq_id)
        return True

    def _admit_spilled(self, req: _Pending) -> None:
        """Resume a KV-spilled sequence: a fresh page run (the bucket math
        of a re-prefill, so allocator state evolves alike either way), its
        pages written back IN PLACE, and the slot registered at its exact
        preemption state: no prefill, no re-sampled token."""
        rec = self._spilled[req.seq_id]
        ps = self.page_size
        n_shared = int(rec["n_shared"])
        length = int(rec["length"])
        # the resume prompt is prompt + generated: length + 1 tokens (the
        # last generated one is the current token, its KV not yet written)
        resume_len = length + 1
        assert resume_len == len(req.prompt_ids), (resume_len,
                                                   len(req.prompt_ids))
        _, n_pages = suffix_bucket(self._bucket, resume_len - n_shared * ps,
                                   n_shared, ps, self.pages_per_seq)
        pages = self._alloc_with_evict(n_pages, owner=req.seq_id)
        n_spill = int(rec["n_pages"])
        with annotate("engine.restore"):
            if n_spill:
                restore_pages(self.pool, rec, pages[:n_spill])
            slot = self._free_slots.pop(0)
            table = np.full((self.pages_per_seq,), TRASH_PAGE, np.int32)
            table[:n_shared] = rec["shared_pages"]
            table[n_shared:n_shared + n_pages] = pages
            self.block_tables[slot] = table
            # prompt_tokens counts the RESUME prompt, as a re-prefill's
            # does; the shared pages' references pass from the record to
            # the slot
            st = _Active(seq_id=req.seq_id, slot=slot,
                         prompt_tokens=resume_len,
                         max_new_tokens=req.max_new_tokens,
                         stop_strings=req.stop_strings, grammar=req.grammar,
                         n_shared=n_shared, priority=req.priority)
            self._active[slot] = st
            self.lengths[slot] = length
            self.cur_tokens[slot] = int(rec["cur_token"])
            self._dev_edit_len(slot, length)
            self._dev_edit_token(slot, int(rec["cur_token"]))
            self._dev_edit_bt_row(slot)
            del self._spilled[req.seq_id]
            self._spilled_pages_total -= n_spill
            self._count("engine.restored_pages", n_spill)

    def _drop_spill(self, seq_id: int) -> None:
        """Discard a spill record (cancel, deadline expiry while queued):
        its host copies go, and the shared-prefix references it held are
        released."""
        rec = self._spilled.pop(seq_id, None)
        if rec is None:
            return
        self._spilled_pages_total -= int(rec["n_pages"])
        if rec["shared_pages"] and self.prefix_cache is not None:
            self.prefix_cache.release(rec["shared_pages"])

    def _demote_prefix_pages(self, pages: List[int]
                             ) -> Optional[List[Dict[str, object]]]:
        """PrefixCache demote hook: ONE gather of resident prefix pages to
        the host, split into per-page store records (counted per page as
        ``engine.prefix_demotions``).  Demoted pages live under the store's
        own caps; ``max_spilled_pages`` governs spilled sequences only."""
        with annotate("engine.prefix_demote"):
            rec = gather_pages(self.pool, self._fetch_host, pages)
            self._count("engine.prefix_demotions", len(pages))
            return split_pages(rec)

    def _promote_prefix_records(self, recs: List[Dict[str, object]]
                                ) -> Optional[List[int]]:
        """PrefixCache promote hook: fresh ``CACHE_OWNER`` pages with the
        records written into them in place.  Returns the page ids, or None
        (a cold miss) when a record does not fit this pool (a store shared
        across configs) or the allocator has no room; allocation never
        evicts (demoting L0 to promote L1 inside a match gains nothing)."""
        if not recs or not all(records_compatible(self.pool, r)
                               for r in recs):
            return None
        try:
            pages = self.allocator.alloc(len(recs), owner=CACHE_OWNER)
        except OutOfPages:
            return None
        with annotate("engine.prefix_promote"):
            rec = stack_pages(recs, pin=self.device.type == "cuda")
            restore_pages(self.pool, rec, pages)
            self._count("engine.prefix_promoted_pages", len(pages))
            self._count("engine.prefix_bytes_restored", record_nbytes(rec))
        return pages

    def flush_prefix_store(self, limit: Optional[int] = None) -> int:
        """Publish resident prefix pages into the store WITHOUT freeing
        them (one gather; digests the store holds are skipped), so an
        engine sharing the store promotes instead of re-prefilling.
        Returns the pages copied; 0 without a store."""
        if self.prefix_cache is None or self.prefix_store is None:
            return 0
        self._overlap_barrier()
        return self.prefix_cache.flush_to_store(limit)

    def _publish_sequence_pages(self) -> int:
        """Push every ACTIVE sequence's full written pages (prompt AND
        generated so far) into the store, keyed by the chained digests
        ``PrefixCache.match`` probes, so whoever restores a snapshot of
        this engine promotes them and re-prefills only the sub-page tail.
        One gather for the whole set; digests the store holds and pages
        shared between sequences are skipped.  Returns the pages
        published (``engine.prefix_snapshot_published``)."""
        if self.prefix_cache is None or self.prefix_store is None:
            return 0
        self._overlap_barrier()
        P = self.page_size
        pend_pages: List[int] = []
        pend_keys: List[bytes] = []
        seen = set()
        for slot in sorted(self._active):
            st = self._active[slot]
            n_full = int(self.lengths[slot]) // P
            if n_full <= 0:
                continue
            tokens = (list(self._prompts.get(st.seq_id, []))
                      + list(self._resumed.get(st.seq_id, ()))
                      + list(st.generated))
            if len(tokens) < n_full * P:
                continue            # defensive: mirrors out of sync
            table = self.block_tables[slot]
            for i, key in enumerate(_page_keys(tokens, n_full, P)):
                page = int(table[i])
                if page == TRASH_PAGE or key in seen:
                    continue
                seen.add(key)
                if self.prefix_store.contains(key):
                    continue
                pend_pages.append(page)
                pend_keys.append(key)
        if not pend_pages:
            return 0
        with annotate("engine.prefix_publish"):
            rec = gather_pages(self.pool, self._fetch_host, pend_pages)
            for key, page_rec in zip(pend_keys, split_pages(rec)):
                self.prefix_store.put(key, page_rec)
        self._count("engine.prefix_snapshot_published", len(pend_keys))
        return len(pend_keys)

    def _tick_pressure(self) -> None:
        """The prefix cache's tick-boundary policies.  Watermark: when the
        free count dips below ``prefix_hbm_watermark``, refcount-0 prefix
        pages demote through ``evict`` (oldest first) until the mark holds
        or nothing is evictable, so this tick's growth already sees the
        pages.  Write-through: when the resident set changed since the last
        flush, new chains publish to the store without being freed.
        Prefix pages are read-only, so no overlap barrier is needed."""
        if self.prefix_cache is None:
            return
        if self._hbm_watermark:
            deficit = self._hbm_watermark - self.allocator.n_free
            if deficit > 0:
                demoted = self.prefix_cache.evict(deficit)
                if demoted:
                    self._count("engine.prefix_watermark_demotions",
                                demoted)
        if self._writethrough:
            resident = self.prefix_cache.n_resident
            if resident != self._wt_resident:
                flushed = self.prefix_cache.flush_to_store()
                self._wt_resident = resident
                if flushed:
                    self._count("engine.prefix_writethrough_pages",
                                flushed)

    def snapshot_sequences(self) -> Dict[str, object]:
        """``EngineBase.snapshot_sequences`` aware of chunked prefills: a
        mid-prefill sequence exports as a pending entry (original prompt,
        nothing generated), between the active sequences and the queue.
        With a store attached, the active sequences' written pages publish
        first (``_publish_sequence_pages``), so a restore promotes them."""
        self._publish_sequence_pages()
        snap = super().snapshot_sequences()
        if not self._prefilling:
            return snap
        pre = []
        for slot in sorted(self._prefilling):
            req = self._prefilling[slot]["req"]
            pre.append(self._snapshot_entry(
                req.seq_id,
                list(self._prompts.get(req.seq_id, req.prompt_ids)),
                list(self._resumed.get(req.seq_id, ())),
                req.max_new_tokens, req.stop_strings, req.grammar,
                req.priority))
        seqs = snap["sequences"]
        n_active = len(self._active)
        snap["sequences"] = seqs[:n_active] + pre + seqs[n_active:]
        return snap

    def export_run(self, *args, **kwargs):
        raise NotImplementedError(
            "export_run/adopt_run (the disaggregated KV handoff) serve "
            "cluster/disagg.py, which is not ported yet (ROADMAP Queue 1 "
            "item 11, fleet)")

    adopt_run = export_run

    # -------------------------------------------------------- tick faults

    def _tick_fault(self) -> None:
        # pages taken by the previous tick's "oom" come back first, so the
        # exhaustion lasts one tick
        self._release_fault_pages()
        super()._tick_fault()

    def _release_fault_pages(self) -> None:
        if self._fault_pages:
            self.allocator.free(self._fault_pages, owner=FAULT_OWNER)
            self._fault_pages = []

    def _apply_tick_fault(self, fault, plan) -> None:
        """Paged tick faults: "preempt" evicts the ``wave`` youngest
        sequences through the normal victim path, spill included;
        "crash" drops every active sequence's device KV (youngest first,
        so the oldest ends at the queue's head) for re-prefill, never
        spilling; "oom" takes the whole free list for one tick, so that
        tick's growth runs the real pool-pressure path; the rest as the
        base engine."""
        if fault.kind == "preempt":
            for _ in range(max(1, fault.wave)):
                if not self._preempt_victim():
                    break
        elif fault.kind == "crash":
            n = 0
            while self._preempt_victim(spill=False):
                n += 1
            log.warning("tick fault 'crash': dropped device KV of %d "
                        "active sequence(s); all requeued for re-prefill",
                        n)
            self._count("engine.crash_evictions", n)
        elif fault.kind == "oom":
            n = self.allocator.n_free
            if n:
                self._fault_pages = self.allocator.alloc(n,
                                                         owner=FAULT_OWNER)
                plan.add_cleanup(self._release_fault_pages)
        else:
            super()._apply_tick_fault(fault, plan)

    def _retire(self, slot: int, reason: str) -> SequenceResult:
        st = self._active.pop(slot)
        if self._deadlines:
            self._deadlines.pop(st.seq_id, None)
        self._release_slot_pages(slot, st)
        self.allocator.check()
        self.block_tables[slot] = TRASH_PAGE
        self._dev_edit_bt_row(slot)     # contain in-flight garbage writes
        self.lengths[slot] = 0     # the scan advances idle slots too
        self._free_slots.append(slot)
        # report against the ORIGINAL prompt, with any pre-preemption
        # tokens stitched back on
        orig_prompt = self._prompts.pop(st.seq_id)
        generated = self._resumed.pop(st.seq_id, []) + st.generated
        return SequenceResult(
            seq_id=st.seq_id, token_ids=list(generated),
            text=self._final_text(generated, reason, st.stop_strings),
            finish_reason=reason, prompt_tokens=len(orig_prompt),
            completion_tokens=len(generated))


def _leaves(tree):
    """Every tensor of a param tree (a quantized weight's q and scale)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield from (tree if isinstance(tree, tuple) else (tree,))
