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
  Each tick ships the [B] tokens, [B] lengths and [B, pages_per_seq] tables
  to the device.
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

Not ported yet, and refused loudly when configured: the prefix cache and
its tiers, chunked prefill, speculative decoding, host overlap, KV spill
and the TP/PP/CP/EP/FSDP meshes (ROADMAP Queue 1).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from k8s_llm_rca_tpu_torch.config import EngineConfig, ModelConfig
from k8s_llm_rca_tpu_torch.engine.engine import (
    EngineBase, SequenceResult, _Active, _Pending, dfa_scan_step,
)
from k8s_llm_rca_tpu_torch.engine.sampling import (
    SamplingParams, sample_tokens, sample_tokens_masked,
)
from k8s_llm_rca_tpu_torch.models import llama
from k8s_llm_rca_tpu_torch.models.quant import gather_rows, quantize_kv
from k8s_llm_rca_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_quant,
)
from k8s_llm_rca_tpu_torch.utils.device import resolve_device
from k8s_llm_rca_tpu_torch.utils.logging import get_logger
from k8s_llm_rca_tpu_torch.utils.tokenizer import Tokenizer

log = get_logger(__name__)

TRASH_PAGE = 0


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

_REST_OF_ENGINE = "Queue 1 item 3, the rest of the paged engine"
_UNPORTED_KNOBS = (
    # (EngineConfig field, its only supported value, what it turns on,
    #  the ROADMAP item that ports it)
    ("prefix_cache", False, "the prefix cache (engine/prefix.py)",
     _REST_OF_ENGINE),
    ("prefill_chunk_budget", 0, "chunked prefill", _REST_OF_ENGINE),
    ("speculative_k", 0, "speculative decoding (engine/speculative.py)",
     _REST_OF_ENGINE),
    ("host_overlap", False, "the overlapped host loop", _REST_OF_ENGINE),
    ("max_spilled_pages", 0, "KV spill-to-host preemption", _REST_OF_ENGINE),
    ("prefix_host_pages", 0, "the tiered prefix store", _REST_OF_ENGINE),
    ("prefix_disk_dir", None, "the tiered prefix store", _REST_OF_ENGINE),
    ("prefix_disk_pages", 0, "the tiered prefix store", _REST_OF_ENGINE),
    ("prefix_hbm_watermark", 0, "pressure-driven prefix demotion",
     _REST_OF_ENGINE),
    ("prefix_store_writethrough", False, "prefix store write-through",
     _REST_OF_ENGINE),
)


def check_engine_config(engine_cfg: EngineConfig) -> None:
    """Refuse every EngineConfig knob this slice does not port."""
    for name, supported, what, item in _UNPORTED_KNOBS:
        value = getattr(engine_cfg, name)
        if value != supported:
            raise NotImplementedError(
                f"EngineConfig.{name}={value!r} turns on {what}, which is not "
                f"ported yet (ROADMAP {item}); set {name}={supported!r}")


class PagedInferenceEngine(EngineBase):
    """Continuous batching over the paged pool with on-demand page growth
    and preemption (youngest, lowest-priority sequence first, requeued
    with prompt + generated as its new prompt).  Admission never preempts.
    Runs on ``device`` (``None`` = the card); ``params`` must live there."""

    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params, tokenizer: Tokenizer, device=None, *,
                 tp_mesh=None, cp_mesh=None, ep_mesh=None, pp_mesh=None,
                 fsdp_mesh=None):
        if any(m is not None for m in (tp_mesh, cp_mesh, ep_mesh, pp_mesh,
                                       fsdp_mesh)):
            raise NotImplementedError(
                "device meshes (TP/CP/EP/PP/FSDP) are not ported yet (ROADMAP "
                "Queue 1 item 10, multi-GPU)")
        check_engine_config(engine_cfg)
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
        self.allocator = PageAllocator(engine_cfg.num_pages)
        self.block_tables = np.full((b, self.pages_per_seq), TRASH_PAGE,
                                    np.int32)
        self.lengths = np.zeros((b,), np.int64)
        self.cur_tokens = np.zeros((b,), np.int64)
        self._free_slots = list(range(b))
        self._active: Dict[int, _Active] = {}
        self._pending: List[_Pending] = []
        self._admit_pending: List[Tuple[_Active, torch.Tensor, int]] = []
        self._seq_counter = itertools.count()
        self._prompts: Dict[int, List[int]] = {}   # seq_id -> ORIGINAL prompt
        self._resumed: Dict[int, List[int]] = {}   # seq_id -> tokens generated
                                                   # before a preemption
        self._buckets = tuple(
            s for s in sorted(set(engine_cfg.prefill_buckets))
            if s <= engine_cfg.max_seq_len) or (engine_cfg.max_seq_len,)
        self._dfa_fused: Dict[tuple, tuple] = {}   # _scan_dfa_setup's LRU

    # --------------------------------------------- device-side operands

    def _device_state(self):
        """The decode operands (tokens, lengths, block tables) as int32
        tensors on the engine's device."""
        self._count("engine.h2d_uploads", 3)
        return tuple(torch.tensor(a, dtype=torch.int32, device=self.device)
                     for a in (self.cur_tokens, self.lengths,
                               self.block_tables))

    # ------------------------------------------------------------- tick

    def _tick(self) -> List[SequenceResult]:
        finished: List[SequenceResult] = self._reap_deadlines()
        if self._pending and self._free_slots:
            finished.extend(self._tick_admission())
        # one fetch commits every first token sampled at admission
        finished.extend(self._drain_admission_commits())
        if not self._active:
            return finished
        self._tick_growth()
        active_slots = sorted(self._active)
        if not active_slots:
            return finished

        chunk = self._scan_chunk()
        if chunk > 1:
            finished.extend(self._scan_tick(chunk, active_slots))
            return finished

        forced, allow = self._tick_constraints(
            active_slots, self.engine_cfg.max_batch,
            self.model_cfg.vocab_size)
        cur_d, lens_d, bt_d = self._device_state()
        self._count("engine.dispatches")
        self._count("engine.decode_steps")
        self.pool, logits = paged_decode_step(
            self.model_cfg, self.params, self.pool, cur_d, lens_d, bt_d)
        if allow is not None:
            next_tokens = sample_tokens_masked(
                logits, self._gen, self.sampling,
                torch.from_numpy(allow).to(self.device))
        else:
            next_tokens = sample_tokens(logits, self._gen, self.sampling)
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
        return finished

    def _tick_admission(self) -> List[SequenceResult]:
        """Admit pending requests into free slots, one same-bucket group
        per prefill dispatch, until the queue, the slots or the pages run
        out (admission never preempts running work).  Returns the grammar
        admissions whose constrained first token already finished them."""
        finished: List[SequenceResult] = []
        while self._pending and self._free_slots:
            group = self._admission_group()
            try:
                if len(group) == 1:
                    admitted = self._admit(group[0])
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
            if int(self.lengths[slot]) % self.page_size == 0:
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
                pos = int(self.lengths[slot])
                last = min(pos + chunk_goal - 1,
                           self.pages_per_seq * self.page_size - 1)
                for idx in range(pos // self.page_size + 1,
                                 last // self.page_size + 1):
                    if self.block_tables[slot, idx] != TRASH_PAGE:
                        continue
                    try:
                        (page,) = self.allocator.alloc(1, owner=st.seq_id)
                    except OutOfPages:
                        break
                    self.block_tables[slot, idx] = page

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
        self._count("engine.dispatches")
        self._count("engine.decode_steps", chunk)
        if setup is None:
            self.pool, toks, _ = paged_decode_scan(
                self.model_cfg, self.params, self.pool, cur_d, lens_d, bt_d,
                self._gen, chunk, self.sampling, self.tokenizer.eos_id)
        else:
            tables, states, remaining = setup
            self.pool, toks, _, _ = paged_decode_scan_dfa(
                self.model_cfg, self.params, self.pool, cur_d, lens_d, bt_d,
                self._gen, chunk, self.sampling, self.tokenizer.eos_id,
                torch.from_numpy(states).to(self.device),
                torch.from_numpy(remaining).to(self.device), *tables)
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

    def _admission_group(self) -> List[_Pending]:
        """A FIFO run of same-bucket pending requests for one prefill,
        bounded so every member's pages fit the current free list (the
        batched allocation is all-or-nothing)."""
        head = self._pending[0]
        b0 = self._bucket(len(head.prompt_ids))
        n_pages = max(1, b0 // self.page_size)
        cap = min(8, len(self._free_slots),
                  max(1, self.allocator.n_free // n_pages))
        group = [head]
        for req in itertools.islice(self._pending, 1, None):
            if len(group) >= cap or self._bucket(len(req.prompt_ids)) != b0:
                break
            group.append(req)
        return group

    def _table_row(self, pages: List[int]) -> np.ndarray:
        table = np.full((self.pages_per_seq,), TRASH_PAGE, np.int32)
        table[:len(pages)] = pages
        return table

    def _admit(self, req: _Pending) -> List[SequenceResult]:
        """Admit one sequence through the single-sequence prefill.  A
        grammar sequence commits its constrained first token now (the FSM
        needs it before the next dispatch); others at the tick's drain."""
        n = len(req.prompt_ids)
        bucket = min(self._bucket(n), self.pages_per_seq * self.page_size)
        n_pages = bucket // self.page_size
        pages = self.allocator.alloc(n_pages, owner=req.seq_id)
        slot = self._free_slots.pop(0)
        self.block_tables[slot] = self._table_row(pages)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = req.prompt_ids
        self._count("engine.dispatches")
        self._count("engine.prefill_dispatches")
        self.pool, logits = paged_prefill(
            self.model_cfg, self.params, self.pool,
            torch.from_numpy(padded).to(self.device), n,
            torch.tensor(pages, dtype=torch.int32, device=self.device))
        first = sample_tokens(logits, self._gen, self.sampling)
        self._count("engine.prefill_tokens", n)
        if req.grammar is not None:
            early = self._activate_now(req, slot, logits,
                                       int(self._fetch(first)[0][0]))
            return [early] if early is not None else []
        self._admit_pending.append((self._activate(req, slot), first, 0))
        return []

    def _admit_batch(self, reqs: List[_Pending]) -> List[SequenceResult]:
        """Admit N same-bucket sequences with ONE batched prefill, padded
        to a power of two by repeating the last real row's tokens AND
        pages (the duplicate page writes are identical).  A group with a
        grammar member commits every first token now, in order."""
        n = len(reqs)
        bucket = min(self._bucket(max(len(r.prompt_ids) for r in reqs)),
                     self.pages_per_seq * self.page_size)
        n_pages = bucket // self.page_size
        allocated: List[List[int]] = []
        try:
            for r in reqs:
                allocated.append(self.allocator.alloc(n_pages,
                                                      owner=r.seq_id))
        except OutOfPages:
            for r, pages in zip(reqs, allocated):
                self.allocator.free(pages, owner=r.seq_id)
            raise
        slots = [self._free_slots.pop(0) for _ in range(n)]
        n_pad = 1
        while n_pad < n:
            n_pad *= 2
        tokens = np.zeros((n_pad, bucket), np.int32)
        lens = np.zeros((n_pad,), np.int32)
        maps = np.zeros((n_pad, n_pages), np.int32)
        for i, r in enumerate(reqs):
            tokens[i, :len(r.prompt_ids)] = r.prompt_ids
            lens[i] = len(r.prompt_ids)
            maps[i] = allocated[i]
            self.block_tables[slots[i]] = self._table_row(allocated[i])
        tokens[n:] = tokens[n - 1]
        lens[n:] = lens[n - 1]
        maps[n:] = maps[n - 1]
        self._count("engine.dispatches")
        self._count("engine.prefill_dispatches")
        self.pool, logits = paged_prefill_batch(
            self.model_cfg, self.params, self.pool,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(lens).to(self.device),
            torch.from_numpy(maps).to(self.device))
        firsts = sample_tokens(logits, self._gen, self.sampling)
        self._count("engine.prefill_tokens", int(lens[:n].sum()))
        self._count("engine.batched_admissions", n)
        if any(r.grammar is not None for r in reqs):
            finished: List[SequenceResult] = []
            (firsts_host,) = self._fetch(firsts)
            for i, req in enumerate(reqs):
                early = self._activate_now(req, slots[i], logits[i:i + 1],
                                           int(firsts_host[i]))
                if early is not None:
                    finished.append(early)
            return finished
        for i, req in enumerate(reqs):
            self._admit_pending.append((self._activate(req, slots[i]),
                                        firsts, i))
        return []

    def _activate(self, req: _Pending, slot: int) -> _Active:
        """Register an admitted sequence in its slot; its first token
        commits at the tick's drain (``_drain_admission_commits``)."""
        st = _Active(seq_id=req.seq_id, slot=slot,
                     prompt_tokens=len(req.prompt_ids),
                     max_new_tokens=req.max_new_tokens,
                     stop_strings=req.stop_strings, grammar=req.grammar,
                     priority=req.priority)
        self._active[slot] = st
        self.lengths[slot] = len(req.prompt_ids)
        return st

    def _activate_now(self, req: _Pending, slot: int, logits_1v,
                      first_token: int) -> Optional[SequenceResult]:
        """Synchronous activation: grammar-constrain the first token (cache
        room as the budget), advance the FSM and commit it."""
        st = self._activate(req, slot)
        token = first_token
        if st.grammar is not None:
            remaining = min(st.max_new_tokens,
                            self.engine_cfg.max_seq_len
                            - st.prompt_tokens - 1)
            token = self._grammar_first_token(st.grammar, logits_1v, token,
                                              remaining)
            st.grammar.advance(token)
        return self._commit_first(st, token)

    def _commit_first(self, st: _Active,
                      token: int) -> Optional[SequenceResult]:
        """Commit an admission's first token; it may already finish the
        sequence."""
        st.generated.append(token)
        self.cur_tokens[st.slot] = token
        reason = self._finish_reason(st, token, st.prompt_tokens)
        if reason is not None:
            return self._retire(st.slot, reason)
        return None

    def _drain_admission_commits(self) -> List[SequenceResult]:
        """Fetch every admission's first token in ONE sync and commit them
        in admission order (the first token may already finish a
        sequence)."""
        pend, self._admit_pending = self._admit_pending, []
        if not pend:
            return []
        uniq: Dict[int, int] = {}
        order: List[torch.Tensor] = []
        for _, t, _ in pend:
            if id(t) not in uniq:
                uniq[id(t)] = len(order)
                order.append(t)
        hosts = self._fetch(*order)
        out: List[SequenceResult] = []
        for st, t, i in pend:
            done = self._commit_first(st, int(hosts[uniq[id(t)]][i]))
            if done is not None:
                out.append(done)
        return out

    # ------------------------------------------------ growth / preemption

    def _grow(self, slot: int) -> None:
        st = self._active[slot]
        idx = int(self.lengths[slot]) // self.page_size
        if idx >= self.pages_per_seq:
            return                              # at cap; finish_reason handles
        if self.block_tables[slot, idx] != TRASH_PAGE:
            return                              # page already present
        (page,) = self.allocator.alloc(1, owner=st.seq_id)
        self.block_tables[slot, idx] = page

    def _preempt_victim(self, exclude: Optional[int] = None) -> bool:
        """Evict one active sequence: the lowest priority class first,
        the youngest within it."""
        candidates = [s for s in self._active if s != exclude]
        if not candidates:
            return False
        slot = max(candidates, key=lambda s: (self._active[s].priority,
                                              self._active[s].seq_id))
        self._preempt_slot(slot)
        return True

    def _release_slot_pages(self, slot: int, st: _Active) -> None:
        private = [int(p) for p in self.block_tables[slot] if p != TRASH_PAGE]
        if private:
            self.allocator.free(private, owner=st.seq_id)

    def _preempt_slot(self, slot: int) -> None:
        """Free a slot's pages and requeue its sequence at the front of its
        class with prompt + generated so far as the new prompt; re-prefill
        resumes it."""
        st = self._active.pop(slot)
        self._release_slot_pages(slot, st)
        self.block_tables[slot] = TRASH_PAGE
        self.lengths[slot] = 0     # the scan advances idle slots too
        self._free_slots.append(slot)
        prefix = self._resumed.get(st.seq_id, []) + st.generated
        self._resumed[st.seq_id] = prefix
        resumed_prompt = self._prompts[st.seq_id] + prefix
        remaining = max(1, st.max_new_tokens - len(st.generated))
        log.info("preempting seq %d (slot %d, %d tokens) to free pages",
                 st.seq_id, slot, len(resumed_prompt))
        self._count("engine.preemptions", 1)
        # the grammar FSM rides along: its state already reflects every
        # generated token now baked into the resume prompt
        self._enqueue(_Pending(st.seq_id, resumed_prompt, remaining,
                               st.stop_strings, st.grammar,
                               priority=st.priority), front=True)

    def _retire(self, slot: int, reason: str) -> SequenceResult:
        st = self._active.pop(slot)
        if self._deadlines:
            self._deadlines.pop(st.seq_id, None)
        self._release_slot_pages(slot, st)
        self.allocator.check()
        self.block_tables[slot] = TRASH_PAGE
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
