"""Pipeline parallelism: layer stages over the ``stage`` mesh axis; the port
of ``k8s_llm_rca_tpu/parallel/pipeline.py``.

JAX runs every stage under one ``shard_map``: each device computes all
M + P - 1 ticks of ``_gpipe_loop``, masks the warm-up and drain ticks
with ``valid``, and a ``psum`` of a one-hot contribution hands the last
stage's outputs to every device.  Here each rank is a process holding
only its stage's layers (``runtime.sharding.shard_stage_params``) and a
paged pool of only those layers (``RankModelConfig.n_layers`` is L/P;
pool layer ``li`` is the stage's ``li``-th layer, while RoPE positions
and block tables stay global).  A forward runs a static Python schedule
over the same ticks (``_gpipe_loop``):

- on tick t a rank computes microbatch t - stage when it is in range and
  nothing otherwise (no masked compute); stage 0 takes its input from the
  embedding, the others from the previous tick's ring step;
- every rank then calls ``runtime.mesh.ppermute`` over its stage group
  (the ring i -> i + 1; stage 0 ignores what the last stage sends), every
  tick, in the same order;
- after the last tick, ONE ``all_reduce_sum`` over the stage group of the
  last stage's outputs (zeros elsewhere: adding zeros is exact) gives
  every rank the same final activations, so every rank computes the same
  logits from the replicated head and samples the same tokens, which
  keeps the ranks' host schedulers in lockstep.

The embedding and the head are whole on every rank (JAX computes them
outside its ``shard_map``): they run under the rank's config with its TP
group taken off.  The stage bodies are the port's own layer functions
under the rank's config, so TP inside a stage is the TP block of
``models/llama.py`` (sum all-reduces over the stage's "model" group) and
EP the all-to-all MoE of ``parallel/moe.py`` over the stage's "expert"
group.  The paged decode attention is the paged kernel on the stage's own pool
at each microbatch's rows (JAX reads a gathered XLA page view there).

Collectives per forward, on every rank (M microbatches, P stages, L/P
the stage's layers): M + P - 1 ``ppermute`` calls (a copy on one rank)
and 1 ``all_reduce_sum`` for the broadcast, for a batched prefill, a
decode step and a multi-token decode alike; a chunk prefill (M = 1) makes
P ring steps and 1 broadcast.  Inside a stage, per microbatch: under TP 2
``all_reduce_sum`` a layer (wo, w_down; no embedding all-gather and no
logits all-reduce: those are replicated), over a quantized pool 2
``all_reduce_max`` a layer at decode and 2 per pool write of a prefill or
chunk; under EP 2 ``all_to_all`` and 1 ``all_gather`` a layer.

The contiguous engine's entry points (``llama_pp_prefill``,
``llama_pp_decode_step``, ``llama_pp_decode_multi``) run the same schedule
over a stage-local contiguous cache (``RankModelConfig.n_layers`` = L/P
layers, every slot): a stage writes its layers' K/V into the rows of its
microbatch's slots and the decode attends over them in plain torch
(``llama._decode_layers``), with the same collectives per forward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from k8s_llm_rca_tpu_torch.runtime.mesh import (
    all_reduce_sum, axis_group, ppermute,
)


def _gpipe_loop(stage_apply: Callable[[torch.Tensor, int], torch.Tensor],
                x_mb: torch.Tensor, group,
                out: Optional[torch.Tensor] = None,
                select: Optional[Callable] = None) -> torch.Tensor:
    """The GPipe schedule, shared by every pipelined entry point.

    ``x_mb`` [M, ...]: the microbatches (stage 0's inputs; the other
    stages read only its shape).  ``stage_apply(h, mb)`` runs this rank's
    layers over microbatch ``mb`` (and owns its KV writes).  The last
    stage keeps ``select(h_out, mb)`` (default: all of it) at row ``mb`` of
    a buffer shaped like ``out`` (default ``x_mb``); the buffer, zeros on
    the other stages, is summed over ``group``, so every rank returns the
    last stage's outputs."""
    m = x_mb.shape[0]
    n_st, me = dist.get_world_size(group), dist.get_rank(group)
    out_buf = torch.zeros_like(x_mb if out is None else out)
    cur = idle = None
    for t in range(m + n_st - 1):
        mb = t - me
        if 0 <= mb < m:
            h = stage_apply(x_mb[mb] if me == 0 else cur, mb)
            if me == n_st - 1:
                out_buf[mb] = h if select is None else select(h, mb)
        else:
            # warm-up or drain: nothing to compute, the ring step still runs
            if idle is None:
                idle = torch.zeros_like(x_mb[0])
            h = idle
        cur = ppermute(h, group)
    return all_reduce_sum(out_buf, group)


def pipeline_apply(fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_mb: torch.Tensor, mesh,
                   stage_axis: str = "stage") -> torch.Tensor:
    """Apply ``fn`` through the P stages of ``mesh[stage_axis]``.

    ``stage_params``: THIS rank's stage's params (JAX takes the stacked
    tree of every stage; each rank here holds its own).  x_mb: [M, ...]
    microbatches, the same on every rank.  Returns [M, ...] =
    stage_{P-1}(... stage_0(x) ...) per microbatch, on every rank."""
    return _gpipe_loop(lambda h, mb: fn(stage_params, h), x_mb,
                       axis_group(mesh, stage_axis))


def _replicated(cfg):
    """The rank's config for the replicated embedding and head: its TP
    group taken off (under PP they are whole on every rank)."""
    if getattr(cfg, "tp", None) is None:
        return cfg
    return dataclasses.replace(cfg, tp=None)


def _pp(cfg):
    pp = getattr(cfg, "pp", None)
    if pp is None:
        raise ValueError("a pipelined entry point needs a rank's config "
                         "under a pp_mesh (runtime.sharding.rank_config)")
    return pp


def _microbatches(n: int, m: int) -> int:
    if n % m:
        raise ValueError(f"batch {n} must divide into {m} microbatches")
    return n // m


def llama_pipeline_forward(cfg, params: Any, tokens: torch.Tensor, mesh,
                           microbatches: int,
                           stage_axis: str = "stage") -> torch.Tensor:
    """Pipeline-parallel scoring forward: tokens [B, S] -> logits [B, S, V]
    (fp32) on every rank, matching ``models.llama.forward``.  ``cfg`` is
    the model's config; ``params`` this rank's stage
    (``runtime.sharding.shard_stage_params``).  The embedding and the head
    run on every rank outside the pipeline, as JAX's do."""
    from k8s_llm_rca_tpu_torch.models import llama

    b, s = tokens.shape
    bm = _microbatches(b, microbatches)
    dev = tokens.device
    angles = llama._angles(cfg, dev)
    positions = torch.arange(s, device=dev)[None, :].expand(bm, s)
    seq_lens = torch.full((bm,), s, dtype=torch.int32, device=dev)
    x = llama.embed(cfg, params, tokens)

    def stage_fn(stage_params, h):
        for layer in stage_params["layers"]:
            h, _, _ = llama._block_prefill(cfg, layer, h, angles, positions,
                                           seq_lens)
        return h

    out = pipeline_apply(stage_fn, params,
                         x.reshape(microbatches, bm, s, x.shape[-1]), mesh,
                         stage_axis)
    return llama._logits(cfg, params, out.reshape(b, s, -1))


# ---------------------------------------------------------------------------
# paged-pool PP serving
# ---------------------------------------------------------------------------


def paged_pp_prefill(cfg, params, pool, tokens: torch.Tensor,
                     lengths: torch.Tensor, page_maps: torch.Tensor,
                     microbatches: Optional[int] = None):
    """Pipeline-parallel paged prefill of N sequences: tokens [N, S_pad]
    right-padded (S_pad a page multiple), lengths [N], page_maps [N,
    S_pad // page] (padding rows repeat a real row: identical duplicate
    writes), N a multiple of the microbatch count (``cfg.pp``'s unless
    given).  Each stage runs its layers over each microbatch and scatters
    their K/V into its own pool (``paged.paged_prefill_batch``'s write).
    Returns (pool, logits [N, V] at each row's last valid token), the same
    on every rank."""
    from k8s_llm_rca_tpu_torch.engine.paged import _write_pool_pages
    from k8s_llm_rca_tpu_torch.models import llama

    pp = _pp(cfg)
    m = microbatches or pp.microbatches
    n, s_pad = tokens.shape
    bm = _microbatches(n, m)
    page_size = pool.page_size
    assert s_pad % page_size == 0, (s_pad, page_size)
    dev = tokens.device
    rep = _replicated(cfg)
    x = llama.embed(rep, params, tokens)                    # [N, S, H]
    x_mb = x.reshape(m, bm, s_pad, x.shape[-1])
    angles = llama._angles(cfg, dev)
    positions = torch.arange(s_pad, device=dev)[None, :].expand(bm, s_pad)
    last = lengths.long() - 1
    rows = torch.arange(bm, device=dev)

    def stage_apply(h, mb):
        r = slice(mb * bm, (mb + 1) * bm)
        ks, vs = [], []
        for layer in params["layers"]:
            h, k, v = llama._block_prefill(cfg, layer, h, angles, positions,
                                           lengths[r])
            ks.append(k.reshape(bm * s_pad, cfg.kv_dim))
            vs.append(v.reshape(bm * s_pad, cfg.kv_dim))
        _write_pool_pages(cfg, pool, torch.stack(ks), torch.stack(vs),
                          page_maps[r].reshape(-1),
                          bm * (s_pad // page_size), page_size)
        return h

    # the last stage keeps each row's last valid token only
    out = _gpipe_loop(stage_apply, x_mb, pp.group, out=x_mb[:, :, 0],
                      select=lambda h, mb: h[rows, last[mb * bm:
                                                      (mb + 1) * bm]])
    return pool, llama._logits(rep, params, out.reshape(n, 1, -1))[:, 0]


def paged_pp_decode_step(cfg, params, pool, tokens: torch.Tensor,
                         lengths: torch.Tensor, block_tables: torch.Tensor,
                         microbatches: Optional[int] = None):
    """One pipeline-parallel paged decode step for ALL slots: tokens [B],
    lengths [B], block_tables [B, pages_per_seq].  The T = 1 case of
    ``paged_pp_decode_multi`` (the engine's step and its scans go through
    it).  Returns (pool, logits [B, V]) matching
    ``paged.paged_decode_step``."""
    pool, _, logits = paged_pp_decode_multi(
        cfg, params, pool, tokens[:, None], lengths, block_tables,
        microbatches)
    return pool, logits[:, 0]


def paged_pp_decode_multi(cfg, params, pool, tokens: torch.Tensor,
                          lengths: torch.Tensor, block_tables: torch.Tensor,
                          microbatches: Optional[int] = None,
                          n_pages: Optional[int] = None):
    """Pipeline-parallel paged decode of T tokens a slot: tokens [B, T] at
    positions ``lengths[b] + i`` (all T in the slot's current page).  The
    slots split into microbatches of B / M rows that flow through the
    stages; each stage writes its layers' new K/V into its own pool and
    attends over it (``paged._decode_layers``: the paged kernel at T = 1,
    on the microbatch's rows of the block tables, made contiguous for
    it).  Returns (pool, greedy [B, T], logits [B, T, V]) matching
    ``paged.paged_decode_multi``."""
    from k8s_llm_rca_tpu_torch.engine.paged import _decode_layers
    from k8s_llm_rca_tpu_torch.models import llama

    pp = _pp(cfg)
    m = microbatches or pp.microbatches
    b, t = tokens.shape
    bm = _microbatches(b, m)
    rep = _replicated(cfg)
    x = llama.embed(rep, params, tokens.long())             # [B, T, H]

    def stage_apply(h, mb):
        r = slice(mb * bm, (mb + 1) * bm)
        return _decode_layers(cfg, params["layers"], h, pool,
                              lengths[r].contiguous(),
                              block_tables[r].contiguous(), n_pages)

    out = _gpipe_loop(stage_apply, x.reshape(m, bm, t, x.shape[-1]),
                      pp.group)
    logits = llama._logits(rep, params, out.reshape(b, t, -1))  # [B, T, V]
    return pool, logits.argmax(dim=-1), logits


def paged_pp_prefill_chunk(cfg, params, pool, tokens: torch.Tensor,
                           chunk_len: int, prefix_len: int,
                           prefix_table: torch.Tensor,
                           page_map: torch.Tensor):
    """Pipeline-parallel chunked prefill of ONE prompt's suffix (a prefix
    hit): tokens [1, C_pad], the first ``prefix_len`` tokens' K/V already
    in the ``prefix_table`` pages of every stage's pool.  One sequence, so
    the schedule runs M = 1 (stages in turn, no overlap): each stage
    attends over its own layers' cached pages and writes its chunk K/V
    into ``page_map`` (``paged._chunk_layers``).  Returns (pool, logits
    [1, V]) matching ``paged.paged_prefill_chunk``."""
    from k8s_llm_rca_tpu_torch.engine.paged import _chunk_layers
    from k8s_llm_rca_tpu_torch.models import llama

    pp = _pp(cfg)
    dev = tokens.device
    rep = _replicated(cfg)
    chunk_lens = torch.tensor([chunk_len], dtype=torch.int32, device=dev)
    prefix_lens = torch.tensor([prefix_len], dtype=torch.int32, device=dev)
    x = llama.embed(rep, params, tokens)                    # [1, C, H]

    def stage_apply(h, mb):
        return _chunk_layers(cfg, params["layers"], h, pool, chunk_lens,
                             prefix_lens, prefix_table[None], page_map[None])

    out = _gpipe_loop(stage_apply, x[None], pp.group, out=x[None, :, 0],
                      select=lambda h, mb: h[:, max(chunk_len, 1) - 1])
    return pool, llama._logits(rep, params, out.reshape(1, 1, -1))[:, 0]


# ---------------------------------------------------------------------------
# contiguous-cache PP serving
# ---------------------------------------------------------------------------


def _rows(cache, r: slice):
    """The contiguous cache's slots ``r`` as a cache of their own: views,
    so the layers' writes land in ``cache``."""
    return type(cache)(*(None if t is None else t[:, r] for t in cache))


def llama_pp_prefill(cfg, params, cache, tokens: torch.Tensor,
                     lengths: torch.Tensor, slots: torch.Tensor,
                     microbatches: Optional[int] = None):
    """Pipeline-parallel batched prefill into the contiguous cache (the
    port of JAX's ``llama_pp_prefill``): tokens [N, S_pad] right-padded,
    lengths [N], ``slots`` [N] the cache rows (padding rows repeat a real
    row: identical duplicate writes), N a multiple of the microbatch count
    (``cfg.pp``'s unless given).  Each stage runs its layers over each
    microbatch and writes their K/V into its own layers of the cache
    (``llama.prefill_batch``'s write).  Returns (cache, logits [N, V] at
    each row's last valid token), the same on every rank."""
    from k8s_llm_rca_tpu_torch.models import llama

    pp = _pp(cfg)
    m = microbatches or pp.microbatches
    n, s_pad = tokens.shape
    bm = _microbatches(n, m)
    dev = tokens.device
    rep = _replicated(cfg)
    x = llama.embed(rep, params, tokens)                    # [N, S, H]
    x_mb = x.reshape(m, bm, s_pad, x.shape[-1])
    angles = llama._angles(cfg, dev)
    positions = torch.arange(s_pad, device=dev)[None, :].expand(bm, s_pad)
    last = lengths.long() - 1
    rows = torch.arange(bm, device=dev)

    def stage_apply(h, mb):
        r = slice(mb * bm, (mb + 1) * bm)
        ks, vs = [], []
        for layer in params["layers"]:
            h, k, v = llama._block_prefill(cfg, layer, h, angles, positions,
                                           lengths[r])
            ks.append(k.reshape(bm, s_pad, cfg.kv_dim))
            vs.append(v.reshape(bm, s_pad, cfg.kv_dim))
        llama._store_kv(cfg, cache, slice(None),
                        (slots[r].long(), slice(0, s_pad)), torch.stack(ks),
                        torch.stack(vs))
        return h

    # the last stage keeps each row's last valid token only
    out = _gpipe_loop(stage_apply, x_mb, pp.group, out=x_mb[:, :, 0],
                      select=lambda h, mb: h[rows, last[mb * bm:
                                                      (mb + 1) * bm]])
    return cache, llama._logits(rep, params, out.reshape(n, 1, -1))[:, 0]


def llama_pp_decode_step(cfg, params, cache, tokens: torch.Tensor,
                         lengths: torch.Tensor,
                         microbatches: Optional[int] = None):
    """One pipeline-parallel decode step for ALL slots of the contiguous
    cache: tokens [B], lengths [B].  The T = 1 case of
    ``llama_pp_decode_multi``, as in JAX.  Returns (cache, logits [B, V])
    matching ``llama.decode_step``."""
    cache, _, logits = llama_pp_decode_multi(cfg, params, cache,
                                             tokens[:, None], lengths,
                                             microbatches)
    return cache, logits[:, 0]


def llama_pp_decode_multi(cfg, params, cache, tokens: torch.Tensor,
                          lengths: torch.Tensor,
                          microbatches: Optional[int] = None):
    """Pipeline-parallel decode of T tokens a slot over the contiguous
    cache (speculative verification; T = 1 the decode step): tokens [B, T]
    at positions ``lengths[b] + i``.  The slots split into microbatches
    of B / M rows; each stage writes its layers' new K/V into its slots of
    the cache and attends over them (``llama._decode_layers`` on a view of
    the microbatch's rows).  Returns (cache, greedy [B, T], logits [B, T,
    V]), JAX's return, matching ``llama.decode_multi``'s logits."""
    from k8s_llm_rca_tpu_torch.models import llama

    pp = _pp(cfg)
    m = microbatches or pp.microbatches
    b, t = tokens.shape
    bm = _microbatches(b, m)
    rep = _replicated(cfg)
    x = llama.embed(rep, params, tokens.long())             # [B, T, H]

    def stage_apply(h, mb):
        r = slice(mb * bm, (mb + 1) * bm)
        return llama._decode_layers(cfg, params["layers"], h,
                                    _rows(cache, r), lengths[r])

    out = _gpipe_loop(stage_apply, x.reshape(m, bm, t, x.shape[-1]),
                      pp.group)
    logits = llama._logits(rep, params, out.reshape(b, t, -1))  # [B, T, V]
    return cache, logits.argmax(dim=-1), logits
