#!/usr/bin/env python3
"""Drive the PyTorch port (``k8s_llm_rca_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Each phase
prints one JSON line; any failure exits non-zero without the result line.

1. env: the card, its power limit, the software versions.
2. build: the six CUDA sources compiled from ``k8s_llm_rca_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together), with each kernel's
   registers, shared memory and spills as ``ptxas -v`` reports them, and
   the count of wgmma (HGMMA), TMA load (UTMALDG) and mma.sync (HMMA)
   instructions in the kn tile and weight-streaming bodies and the nk
   head's tensor-core body (``cuobjdump -sass``): the tile body must have
   the first two, the other two the third.
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes, in bf16 (row-relative error at most 2^-6, see
   ``TOL``) and fp32 with TF32 off (atol 1e-4), with its device time, the
   plain version's, the least time the card could take (bound) and one
   PyTorch library call as a yardstick (timed here only; the port never
   calls it): paged and flash attention (slice 1; paged also at lengths
   2400 x 4, flash also at the slice's batched 2560 bucket, seq_lens 1500
   and 2300), the int4 matmul at decode and at the three prefill buckets
   (M = 512, 1024, 5120), paged attention over int8 and int4 pools (slice
   2), the lm heads at decode (Llama-3-8B's int4 [128256, 4096], Mixtral's
   int8 and int4 [32000, 4096]), and the int8 matmul (wq at decode and
   prefill, the router at N = 8 and 4, and the int4 one at those widths)
   and the int8 and int4 stacked-expert matmuls in both einsum forms at
   decode and prefill (int8 at all three buckets; slice 3); attention over
   KV pages (``engine/paged.py::attend_over_pages``: the pages gathered
   into a buffer indexed by position, then the flash kernel) at three
   batched prefix hits (512-token chunks over 1536 cached tokens) and at
   a speculative verify step (T = 5 at lengths 400-2300), with the
   gather's time apart and masked SDPA over the same buffers; and the
   int4 and int8 kn and the int4 head at the verify step's M = 20
   (slice 11); paged attention at the CLI engine's shapes (B=8, page 16,
   1024 pages, tables 160 wide) and flash at its 1024 bucket of four
   prompts and at two prefix hits over 16-token pages (slice 13); in bf16
   at a mesh rank's shapes (slice 15, ``shard_kernels``): paged attention
   over a TP-2 and TP-4 rank's 16/4 and 8/2 heads (bf16, int8 and a
   per-rank int4 pool), flash with 16/4 heads, the int4 kn on a rank's
   grouped-repacked column block of w_gate and row block of w_down at
   decode and M = 5120, the int4 head on a rank's hidden block, and the
   int8 experts on a local stack of 4 and 2 experts in the per-expert
   form; and in bf16 at a CP-2 rank's share (slice 16,
   ``cp_lse_kernels``): paged attention over the bf16, int8 and int4
   pools with ``return_lse`` over half of each 40-page table at both
   length mixes and both ranks (lse held at atol 1e-3, timed with and
   without it).  Every matmul case names the kn or nk body it took.
The engines on the card replay CUDA graphs of their decode step and
scans (``engine/graphs.py``) unless built with ``cuda_graphs=False``, which
only phases 5-5d do, for their eager half; every phase's launch counters
count the launches a replay makes.

4. cross-device: the graphed engine on the card and the engine on the
   CPU give the same greedy tokens for a 2-layer model (head_dim 128, GQA 4, fp32), for
   TINY (head_dim 32, GQA 2, fp32) with its own weights, with int4 weights
   under ``fused_quant_matmul`` over int4 and int8 KV pools and with int8
   weights over an int8 pool, and for TINY_MOE with int8 weights over an
   int8 pool and int4 weights over an int4 pool; and for TINY when a slot
   retires near max_seq_len and the next batch decodes with it idle.
   Then TINY with the prefix cache on, four prompts sharing four pages in
   three waves (a seed, one hit alone, two hits batched), with
   ``prefill_chunk_budget`` 0 and 32: equal tokens and equal prefix
   counters.  Then TINY at decode_chunk 1 with ``speculative_k`` 4 against
   plain greedy, free and under a DFA grammar (verified on the device in
   the verify graph), and against the CPU's speculative run; and
   ``host_overlap`` on against off: equal streams, or a first differing
   token whose logit margin is at most 1e-3 (printed).  Then the RCA
   sweep on TINY (fp32, the soak engine, two incidents at concurrency 2)
   on the card and on the CPU with the same weights: at vocab 512 every
   grammar compiles to DFA tables, so the card runs the constrained scan
   (``paged_decode_scan_dfa``, a graph over the padded tables); the
   report bytes must be equal, with no failed incident and the engine
   left clean; and the card's sweep with ``speculative_k`` 4 must give
   the same bytes.
5. slice: Llama-3-8B at full depth and width in bf16 (seeded random
   weights) behind ``AssistantService`` answers four requests of ~400,
   900, 1500 and 2300 prompt tokens, once on an eager engine
   (``cuda_graphs=False``) and once on a graphed one, same weights, each
   warmed by one short request first; the greedy tokens must be equal.
   For each: TTFT, decode tok/s, the engine's own decode step at batch 4
   (wall ms per step; device ms and kernels of one profiled step, and
   that device time over the wall time, the busy share; the port's
   kernels in that profile, by name, must equal what the launch counters
   gained over the step, replayed or not), graph captures,
   replays, capture seconds and pool bytes; the
   paged and flash kernels' launch counters must be 32 x (decode steps)
   and 32 x (prefill dispatches).
   Then, on the same weights and graphed: the four requests with
   ``speculative_k`` 4 (drafts, acceptance, tokens per dispatch, the share
   of tokens before the stream parts from the plain run's at a bf16
   near-tie, the verify step's wall and device ms), and at
   ``decode_chunk`` 1 with ``host_overlap`` off and on (tok/s, device
   syncs per token); flash counts 32 per verify step.
5b. int4 slice: the same with int4 weights, ``fused_quant_matmul`` and an
   int4 KV pool; quant_matmul launches 224 x (decode steps + prefill
   dispatches), quant_matmul_head 1 x that, paged_attention_quant 32 x
   decode steps and flash_attention 32 x prefill dispatches.
5c. Mixtral-8x7B at full depth and width with int8 weights (~47 GB), an
   int8 KV pool and ``fused_quant_matmul``, the same four requests: per
   layer and per decode step or prefill dispatch 5 int8 kn launches (4
   projections and the router) and 3 int8 expert launches, one int8 head
   per step or dispatch.
5d. the same Mixtral with int4 weights and an int4 pool (the int4 kn, head
   and expert kernels).
5e. prefix: Llama-3-8B bf16 on the same engine with the prefix cache on
   (graphed): four prompts share exactly 1536 tokens (24 pages), BOS
   included; one goes alone, then the other three together, which must
   hit 3 x 1536 tokens in one batched chunk prefill.  Then the same with
   ``prefill_chunk_budget`` 512, and with the prefix cache off (all
   misses, the TTFT the cache is measured against).  Each wave's TTFT,
   the prefix and chunk counters; flash counts the miss dispatches and,
   since slice 11, the hit and chunk prefills over their gathered pages.
6. rca: the agent loop at full width.  Llama-3-8B in bf16 (seeded random
   weights) behind the soak engine (max_seq_len 2560, one 2560 bucket,
   page 64, 168 pages, decode_chunk 16, greedy) runs the four fixture
   incidents at concurrency 4 through locator -> cyphergen -> auditor
   (``faults/soak.py::run_pipelined_sweep``).  At vocab 128256 the
   grammars do not compile to DFA tables: every stage decodes under the
   interpreted grammar, one stepwise tick per token.  It prints the
   incidents' wall seconds, ticks, dispatches against decode steps, the
   graph replays, the grammar kinds taken, the host time of the grammar
   masks and the launch counts (paged = 32 x decode steps,
   flash = 32 x prefill dispatches), and fails unless every incident
   completes, every stage reply that decodes parses and the engine is
   left clean.  A cypher stage whose prompt leaves less budget than its
   skeleton grammar needs is refused (``BudgetError``) and falls back to
   the compiled query, as in the JAX pipeline: the phase counts the
   cypher replies parsed and the stages refused, one or the other for
   each analysis.  Then the same sweep with ``speculative_k`` 4, which
   must complete the same way; both print drafts and acceptance.  Then
   two incidents at concurrency 1 on the degradation ladder
   (``resilience=True``): with no fault plan no stage may degrade and no
   query retry; under a plan failing graph queries 4-15 both incidents
   complete and every degraded stage is a graph stage dropped to its
   graph rung (``locate.srcKind`` to the Pod default, ``locate.metapath``
   skipped), so an engine stage that raises fails the phase instead of
   hiding behind the ladder's fallbacks.  The phase first prints the
   host's state (threads, tracked objects, resident and pinned memory,
   load), since its time is mostly host time.

7. memory: the slice engine on Llama-3-8B bf16 and int4 serves the four
   prompts uninterrupted, spilled to host memory and restored, and
   re-prefilled under a preempt fault (``phase_memory``).
8. durable: serving durability and the drivers.  (a) On the slice engine
   (batch 4, max_seq_len 2560, page 64, 168 pages, greedy) with
   Llama-3-8B bf16 and with int4 weights over an int4 pool, the four
   requests go through ``AssistantService`` with a ``RunJournal``; once
   every sequence has decoded a few tokens the stack is torn down as
   ``CrashSupervisor.crash_restart`` does (journal closed, live handles
   cancelled) and ``recover_service`` resubmits the runs onto a fresh
   backend: with the prefix cache off the replies must be byte-equal to
   the uninterrupted run's; with it on the resubmissions must hit (the
   share of tokens before the streams part and the margin where they do
   are printed).  Records, journal bytes, ms per fsync'd append, TTFT of
   the resubmitted runs, prefix-hit tokens and exact launch counts; the
   native allocator's check and every page free at the end.  (b) The CLI
   (``python -m k8s_llm_rca_tpu_torch.sweeps.run_file --backend engine
   --paged --model llama3-8b --max-seq-len 2560 --fresh-threads
   --concurrency 4 --slice 0:4``; the default EngineConfig otherwise:
   batch 8, page 16, 1024 pages, prefix cache on) through
   ``run_file.main`` in this process, the 8B cut to ``CUT_LAYERS`` (4)
   layers at full width: 4 incidents, no failure, 4
   records, ``decode_tokens_per_sec`` and the memory keys in its summary,
   and the launches its engine's counters require (phase 3 holds the
   paged and flash kernels at this engine's shapes too).  (c) ``run_file`` on TINY with 4 workers over 3x the
   corpus, SIGKILLed once 4 records have landed, then ``--resume``: the
   final records are the input as a multiset.  (d) The TINY engine chaos
   soak (seed 5, 3 incidents) with a supervised crash after incident 1
   on the card: report bytes equal to the unsupervised soak's on the card
   and on the CPU.  (e) The recovered service's Prometheus text parses
   line by line and carries the engine's phase timers and gauges.

9. rerank: rerank, loading and the contiguous engine (``--rerank`` runs
   it alone, after the build, with no result line).  (a) Llama-3-8B at
   full width cut to 2 layers (bf16, seeded) exported through
   ``llama_params_to_hf`` into a two-shard dir with its
   ``model.safetensors.index.json`` and loaded back by ``load_llama``:
   every tensor bit-equal and the last-position logits of a 64-token
   prompt equal; e5-large at full size through an HF BERT state dict
   (``bert.`` prefix) and ``load_encoder``: bit-equal, equal embeddings;
   write and read GB/s and the peak host RSS of each load.  (b) e5-large
   bf16: ms per batch of 32 and passages/s at buckets 128 and 512; bf16
   against an fp32 copy of the same weights (least cosine, rerank top-1);
   TINY_ENCODER on the card against the CPU (max abs error, at most
   1e-4).  (c) phase 6's sweep (8B bf16, the soak engine, four incidents
   at concurrency 4) with ``Reranker(Embedder(E5_LARGE))`` and
   ``rerank_fields_top_k`` 2, then without a reranker: both complete on a
   clean engine with exact launches, and the analyzer's audit runs read
   fewer prompt tokens with the reranker; the encoder's seconds.  (d) the
   contiguous engine (``EngineConfig(paged=False)``, eager) serves the
   slice's four requests on 8B at ``CUT_LAYERS`` layers, bf16 and int4
   weights over an int4
   cache (exact launches: flash per prefill, the int4 matmuls and head
   per step and prefill; decode attention is plain torch), against the
   paged engine on the same weights (equal tokens, or each first
   divergence with its logit margin); TTFT, decode tok/s, eager step ms,
   peak GB; then ``draft_model=`` (a seeded 2-layer draft at the 8B's
   widths, ``speculative_k`` 4) against plain greedy (equal, or parting
   only at a near-tie, ``NEAR_TIE``) with its acceptance; then the CLI
   without ``--paged`` on 8B at ``CUT_LAYERS`` layers, one incident.

Phases 10-14 and 15b-15c run Llama-3-8B cut to 2 layers and
Mixtral-8x7B cut to 4 (``MESH_LAYERS``; at full width) wherever they do
not cut it further; 12d and 13d run 8B at 2 layers (``GLOO4_LAYERS``).

10. mesh: tensor and expert parallelism (slice 15; ``--mesh`` runs it
   alone after phase 3's mesh-rank cases, with no result line) under a
   1-rank nccl process group.  (a) Llama-3-8B bf16 on the slice engine
   with the prefix cache on, the unsharded graphed engine and then
   ``make_engine(..., tp_mesh=)`` on the rank's shard (the tree itself):
   equal streams or a near-tie (``NEAR_TIE``, margins printed), the
   launches and the collectives the layer count requires (per forward 2
   sum all-reduces a layer, one for the logits, one all-gather), the
   graphed step's wall ms beside the unsharded one's; (b) the same with
   int4 weights over an int4 pool (2 max all-reduces a layer per step for
   the KV scales); (c) Mixtral-8x7B int8 over an int8 pool, dense and
   through ``mixtral.make_ep_engine`` (2 all-to-alls and one all-gather a
   layer), no token dropped; (d) Llama-3-8B cut to 2 layers at TP = 2 as
   two processes on the one card over gloo (eager), held to the same
   model on the 1-rank mesh.

11. cp: context parallelism (slice 16; ``--cp`` runs it alone after
   phase 3's CP-rank lse cases, with no result line) under a 1-rank nccl
   process group, the slice engine (prefix cache off, as CP requires).
   (a) Llama-3-8B bf16, the unsharded graphed engine and then
   ``make_engine(..., cp_mesh=, cp_mode=)`` ring and Ulysses: equal
   streams or a near-tie (``NEAR_TIE``, margins printed), the launches
   and collectives the layer count requires (per prefill 2 all-gathers
   and, a layer, 2 x P ring steps or 4 all-to-alls; per decode step one
   all-gather a layer; flash only under Ulysses), TTFT, decode tok/s,
   the graphed step's wall and event ms both ways; (b) int4 weights over
   an int4 pool, ring (row 2 with ``return_lse``); (c) Llama-3-8B cut to
   2 layers at CP = 2 as two gloo processes on the one card, eager, ring
   and Ulysses: the ranks equal, and equal to the 1-rank run or parting
   at a near-tie.  Every served run here and in phase 5 carries the
   analytic model's fields (``runtime/profiling.py``, reported, not
   gated): ``mfu``, ``decode_roofline_share``, ``ttft_roofline_share``.

12. pp: pipeline parallelism (slice 17; ``--pp`` runs it alone after
   phase 3's microbatch cases, rows 1 and 2 at B = 2, with no result
   line) under a 1-rank nccl process group, ``pp_microbatches`` 2.  (a)
   Llama-3-8B bf16 on the slice engine with the prefix cache on, the
   unsharded graphed engine and then ``make_engine(..., pp_mesh=)`` on
   the rank's stage (the tree itself), graphed: equal streams or a
   near-tie (``NEAR_TIE``), the launches and collectives the schedule
   requires (a layer's kernels once per microbatch; per forward M + P - 1
   ring steps and one broadcast), TTFT, decode tok/s, the graphed step's
   wall and event ms beside the unsharded one's, the peak GB, the bubble
   fraction; then the first prompt resubmitted, which must hit through
   the pipelined chunk prefill; (b) the same with int4 weights over an
   int4 pool; (c) Llama-3-8B bf16 at PP = 2 as two gloo processes on
   the one card (eager), each making only its stage's layers:
   the ranks equal, held to the 1-rank run to a near-tie, each rank's
   peak GB; (d) 8B cut to 4 layers with int4 weights over an int4 pool
   at PP = 2 x TP = 2 as four gloo processes: the ranks equal; (e)
   Mixtral-8x7B int8 cut to 4 layers over an int8 pool (prefix cache
   off), dense and at PP x EP on the 1-rank stage x expert mesh, graphed:
   equal or a near-tie, no token dropped.

13. fsdp: FSDP and Megatron sequence parallelism (``--fsdp`` runs it
   alone, with no result line) under a 1-rank nccl process group.  (a) Llama-3-8B bf16 on the slice engine with the prefix cache
   on, the unsharded graphed engine and then ``make_engine(...,
   fsdp_mesh=)`` on the rank's fsdp shard (the tree itself), graphed:
   equal streams (the same arithmetic on the same bytes), the unsharded
   engine's kernel launches, the gathers the docstring of
   ``models/llama.py`` states (7 a layer and the head per forward),
   TTFT, decode tok/s, the graphed step's wall and event ms both ways,
   the peak GB, the parameter bytes a rank holds and the bytes a forward
   gathers (``runtime/profiling.py``, with the least NVLink time of those
   at fsdp 2); then the first prompt resubmitted, which must hit through
   the chunk prefill; (b) the same with int4 weights over an int4 pool;
   (c) Llama-3-8B bf16 at fsdp = 2 as two gloo processes on the one card
   (eager), each making only its fsdp block of the parent's weights: one
   prompt, one token, the ranks equal and byte-equal to the 1-rank
   unsharded eager run, each rank's peak GB (the memory split FSDP
   exists for); (d) 8B cut to 4 layers, int4 over an
   int4 pool, at fsdp 2 x tp 2 as four gloo processes: the ranks equal
   and equal to TP 2's engine (data 2 x model 2) in the same processes;
   (e) ``sp=True`` on a 1-rank nccl TP mesh, 8B bf16 graphed: equal to
   the TP engine without it, TTFT both ways, the reduce-scatters counted;
   then 8B cut to 2 layers at TP 2 with and without ``sp`` as two gloo
   processes: the ranks equal, and ``sp`` equal to no ``sp`` or parting
   at a near-tie (``NEAR_TIE``, margins printed); (f) Mixtral-8x7B int8
   cut to 4 layers over an int8 pool (prefix cache off), dense and at
   fsdp on the 1-rank mesh, graphed: equal streams.

14. contiguous_mesh: the contiguous engine's meshes (slice 19;
   ``--contiguous-mesh`` runs it alone, with no result line) under a
   1-rank nccl process group, eager, the slice's four requests at
   ``CONTIGUOUS_MESH_NEW`` new tokens, the models at ``MESH_LAYERS``
   depth.  (a) Llama-3-8B bf16 by the
   unsharded contiguous engine, then ``make_engine(..., paged=False)``
   on the rank's cut of the same weights (the tree itself on one rank)
   at TP, fsdp, TP with ``sp``, CP ring, CP Ulysses and PP at M = 2:
   equal streams or a near-tie (``NEAR_TIE``, margins printed), launches
   exact against ``expected_counts(..., contiguous=True)`` (flash once a
   microbatch under PP, none under the ring), the collectives per forward
   by kind, TTFT, decode tok/s, the eager step's wall ms and the peak GB
   both ways; (b) int4 weights over an int4 cache at TP and
   PP (rows 5 and 7); (c) Mixtral-8x7B int8 at EP and PP x EP (rows 4,
   6 and 8), no token dropped; (d) Llama-3-8B bf16 cut to 2
   layers as two gloo processes on the one card at TP 2, CP 2, PP 2 and
   fsdp 2, two prompts, stepwise, a few tokens: the ranks equal, launches
   exact, equal to the unsharded run or a near-tie.
15. mesh_tiers: the memory tiers, snapshots and the overlapped loop under
   a mesh (``--mesh-tiers`` runs it alone, with no result
   line) under a 1-rank nccl process group, graphed, against the
   unsharded engine with the same knobs.  (a) Llama-3-8B bf16 at full
   depth and width under TP: a preemption at tick 2 with spill (gather
   and restore GB/s against the 64 GB/s link, restored pages byte-equal,
   streams equal or a near-tie); the lone prompt of ``prefix_prompts``,
   every page evicted into L1 (64 host pages) or L2 (the disk alone),
   the three hits promoted (TTFT beside the unsharded engine's, equal
   tokens); ``host_overlap`` off and on at ``decode_chunk`` 1 (ms per
   step, tok/s, syncs per token, equal streams); a snapshot after two
   ticks restored into a fresh TP engine on the same store (the
   uninterrupted stream or a near-tie).  Launches exact, the tiers'
   collectives included (``expected_with_tiers``).  (b) int4 weights over
   an int4 pool at ``MESH_LAYERS``: the TP engine's ``.page`` files byte
   for byte the unsharded engine's.  (c) Mixtral-8x7B int8 under EP with
   spill and ``host_overlap``; Llama-3-8B bf16 at ``MESH_LAYERS`` under
   FSDP (an L1 hit, ``host_overlap``) and PP (``host_overlap``).  (d)
   Llama-3-8B cut to 2 layers over an int4 pool at TP 2 as two gloo
   processes on the one card: the ``.page`` files are the unsharded
   engine's set, each the two ranks' shares joined apart from the port's
   code (``page_lanes_joined``), written by one rank, and they promote
   into the unsharded engine with its own L2 hits' streams (or a
   near-tie); prints how many files are byte-equal to the unsharded
   engine's.  (d) runs with ``--mesh-tiers`` only: the whole script
   leaves it out to end within its 1200 s.
16. mesh_spec: speculation under a mesh (``--mesh-spec`` runs phase 3's
   CP fold cases and it alone, with no result line) under a 1-rank nccl
   process group, ``speculative_k`` 4 at ``decode_chunk`` 1, greedy,
   the slice's four requests at ``MESH_SPEC_NEW`` new tokens, against
   the unsharded speculative engine with the same knobs: streams equal
   or a near-tie (``NEAR_TIE``, margins printed), equal streams with
   equal ``verify_steps``, ``spec_drafted`` and ``spec_accepted``,
   launches exact, one verify step's collectives by kind equal to one
   decode step's, and the verify and the decode step's wall and device
   ms both ways.  (a) Llama-3-8B bf16 at ``MESH_LAYERS``, paged and
   graphed, n-gram drafts, at TP, FSDP, PP (M = 2) and CP ring (the
   verify step's T queries folded into one paged call a layer with the
   rows' lse); (b) int4 weights over an int4 pool with the target's own
   weights as its draft model at TP and CP: drafts accepted in every run
   (so rows 1..k of each verify step decide the streams), one broadcast
   of the drafts a verify tick, its host ms; (c) Mixtral-8x7B int8 at
   EP, no token dropped; (d) the contiguous engine (eager) on 8B bf16 at
   ``CUT_LAYERS`` at TP, PP and CP; (e) 8B cut to 2 layers at TP 2 and
   CP 2 as two gloo processes on the one card: the ranks equal, launches
   exact, equal to the unsharded speculative engine or a near-tie.  (e)
   runs with ``--mesh-spec`` only.

Then the kernel table (one JSON line), the ``nvidia-smi`` name and power
limit line, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
The kernel table sums the launches of phases 5-16.
``--spec`` builds every source and runs only the attention-over-pages
cases of phase 3 and the speculative, overlap and TINY sweep cases of
phase 4 (no result line).  ``--profile-decode`` runs only a profile of one decode step at the slice's
shapes (Llama-3-8B bf16 and int4, Mixtral-8x7B int8), and the host time
per call of the int4 step's extra eager work (the sources of PERF.md's
decode-step breakdowns), and prints no result line.  ``--paged`` builds
the two paged sources and runs only phase 3's paged cases (their build
report and times), and ``--heads`` the two matmul sources with a head and
only phase 3's head cases; neither prints a result line.  ``--rca``
builds every source and the native library and runs only phase 6, in a
fresh process (with ``--after-memory``, after phase 7's bf16 half), and
prints no result line.  ``--durable`` builds every source and the native
library and runs only phase 8 (no result line); ``--mesh``, ``--cp``,
``--pp``, ``--fsdp``, ``--contiguous-mesh``, ``--mesh-tiers`` and
``--mesh-spec`` run only phases 10, 11, 12, 13, 14, 15 and 16 (no result
line).
"""


from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the script's start: every record carries the seconds since (``emit``)
STARTED = time.perf_counter()
PAGED_SRC = "k8s_llm_rca_tpu_torch/csrc/paged_attention.cu"
FLASH_SRC = "k8s_llm_rca_tpu_torch/csrc/flash_attention.cu"
QMM_SRC = "k8s_llm_rca_tpu_torch/csrc/quant_matmul.cu"
PAGED_QUANT_SRC = "k8s_llm_rca_tpu_torch/csrc/paged_attention_quant.cu"
QMM8_SRC = "k8s_llm_rca_tpu_torch/csrc/quant_matmul_int8.cu"
EKN_SRC = "k8s_llm_rca_tpu_torch/csrc/quant_matmul_experts.cu"
KERNELS = ("paged_attention", "flash_attention", "quant_matmul",
           "paged_attention_quant", "quant_matmul_int8",
           "quant_matmul_experts")
PAGED_KERNELS = ("paged_attention", "paged_attention_quant")
HEAD_KERNELS = ("quant_matmul", "quant_matmul_int8")
# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# fp32: max |out - ref|.  bf16: max over output rows (one token and head,
# d values) of the row's largest |out - ref| over its largest |ref|, so the
# limit scales with the values compared (|out| is ~0.03 after a softmax
# over thousands of keys).  The two sides round an element to bf16 once
# each, at most one ulp apart: 2^-7 of the row's largest value; the bf16
# flash body's bf16 probabilities and the plain matmuls' bf16-rounded
# dequantized weights (the kernels scale in fp32) add a fraction of that.
# For the matmuls a row is one token's N (or V) outputs.  The int8 and
# expert matmuls of slice 3 are held against the plain version on the same
# values in fp32 (``exact``): the bf16 plain version rounds every
# dequantized weight to bf16, which over a router row of 4 or 8 outputs is
# not a fraction of the row's largest value.
TOL = {"bfloat16": 2 ** -6, "float32": 1e-4}


def emit(phase: str, **fields) -> None:
    """Print one record; every record carries the card's name and power
    limit, read when the record is made unless the caller read them, and
    the seconds since the script started (``elapsed_s``)."""
    fields.setdefault("nvidia_smi", nvidia_smi_name_power())
    fields["elapsed_s"] = time.perf_counter() - STARTED
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


HOST_COVER_CYCLES = 300_000   # ~0.15 ms of device sleep before each launch


def time_ms(fn, iters: int, flush_bytes: int = 0) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after warm-up).  With ``flush_bytes`` a buffer that size is rewritten
    before every launch, outside the timed span, so each launch finds the
    L2 cache cold, as a layer's call does on the serving path.  A device
    sleep before each start event keeps the card busy while the host
    enqueues the call, so the span holds the call's device time and not
    the host's Python and launch overhead (which the eager wrappers spend
    in tens of microseconds, as long as a small kernel runs)."""
    import torch

    flush = (torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
             if flush_bytes else None)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(HOST_COVER_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


# ------------------------------------------------------------------ phase 3


PAGED_LENGTHS = {"mixed": [1, 64, 65, 2400], "long": [2400] * 4}
# the CLI's engine (phase 8b, the default EngineConfig at max_seq_len
# 2560): batch 8, page 16, 1024 pages, tables 160 wide; lengths across
# page edges and up to 2500
CLI_PAGED = {"lengths": [1, 16, 17, 250, 700, 1100, 1800, 2500],
             "page": 16, "n_pages": 1024, "pps": 160}


def paged_case(dtype, gen, lengths=PAGED_LENGTHS["mixed"], page=64,
               n_pages=168, pps=40, heads=(32, 8)):
    """The decode shapes of the slice: B=4, 32 heads over 8 kv-heads,
    d=128, page 64, over shuffled page ids of a 168-page pool (table width
    40 = 2560 / 64); lengths 1 / 64 / 65 / 2400 (a new request beside long
    ones) or 2400 x 4 (a batch of long RCA prompts in steady state).  The
    batch is ``len(lengths)``; ``page``, ``n_pages`` and ``pps`` give
    another engine's pool (``CLI_PAGED``), ``heads`` (query, kv) a TP
    rank's share of them."""
    import torch

    b, (h, n_kv), d = len(lengths), heads, 128
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((n_pages, page, n_kv * d), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((n_pages, page, n_kv * d), generator=gen,
                     device="cuda").to(dtype)
    ids = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1).cpu()
    tables = torch.zeros((b, pps), dtype=torch.int32)
    used = 0
    for i, n in enumerate(lengths):
        n_p = -(-n // page)
        tables[i, :n_p] = ids[used:used + n_p]
        used += n_p
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, lens, tables.cuda()


def errors(out, ref) -> dict:
    """The max absolute error and the max row-relative error (``TOL``)."""
    diff = (out.float() - ref.float()).abs()
    scale = ref.float().abs().amax(-1).clamp_min(1e-30)
    return {"max_abs_err": diff.max().item(),
            "max_row_rel_err": (diff.amax(-1) / scale).max().item()}


def held(errs: dict, dtype_name: str) -> float:
    """The error that ``TOL[dtype_name]`` limits."""
    return errs["max_row_rel_err" if dtype_name == "bfloat16"
                else "max_abs_err"]


def bound(nbytes: int, flops: int, dtype_name: str):
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the HBM rate and the operations over the peak for the type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def paged_bound(q, kp, lens, dtype_name, scale_bytes: int = 0,
                extra_bytes: int = 0):
    """Bytes: q and out, the pages' rows the lengths need (with
    ``scale_bytes`` of scales per row and pool), lengths and table entries
    (and ``extra_bytes`` of further outputs: the lse); operations: q.k and
    p.v at 2 flops per MAC."""
    b, h, d = q.shape
    page = kp.shape[1]
    tokens = int(lens.sum())
    pages_read = sum(-(-int(n) // page) for n in lens.tolist())
    row_bytes = kp.shape[2] * kp.element_size() + scale_bytes
    nbytes = (2 * b * h * d * q.element_size() + 2 * tokens * row_bytes
              + 4 * b + 4 * pages_read + extra_bytes)
    return bound(nbytes, 4 * tokens * h * d, dtype_name)


def sdpa_decode_fn(q, k, v, lens):
    """One SDPA call over a gathered KV view [B, S, n_kv, d], head-expanded
    before timing: the library yardstick for paged decode attention."""
    import torch
    import torch.nn.functional as F

    h = q.shape[1]
    n_kv = k.shape[2]
    k = k.transpose(1, 2).repeat_interleave(h // n_kv, dim=1).contiguous()
    v = v.transpose(1, 2).repeat_interleave(h // n_kv, dim=1).contiguous()
    mask = (torch.arange(k.shape[2], device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    qq = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


def paged_library_fn(q, kp, vp, lens, tables):
    """SDPA over the pages gathered before timing."""
    b, _, d = q.shape
    n_kv = kp.shape[2] // d
    return sdpa_decode_fn(q, kp[tables.long()].reshape(b, -1, n_kv, d),
                          vp[tables.long()].reshape(b, -1, n_kv, d), lens)


def flash_cases(dtype, gen):
    """The prefill shapes of the slice: one 2560-token bucket with
    seq_len 2300, a 512-query chunk at offset 1800 over 2400 keys, and the
    2560 bucket as the slice dispatches it, two prompts of 1500 and 2300
    tokens batched."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def ints(*vals):
        return torch.tensor(vals, dtype=torch.int32, device="cuda")

    s, h, n_kv, d = 2560, 32, 8, 128
    full = (rnd(1, s, h, d), rnd(1, s, n_kv, d), rnd(1, s, n_kv, d),
            ints(2300), None)
    chunk = (rnd(1, 512, h, d), rnd(1, s, n_kv, d), rnd(1, s, n_kv, d),
             ints(2400), ints(1800))
    batch2 = (rnd(2, s, h, d), rnd(2, s, n_kv, d), rnd(2, s, n_kv, d),
              ints(1500, 2300), None)
    # the CLI's engine (page 16, buckets up to 1024): four prompts in the
    # 1024 bucket; two prefix hits of a 64-token suffix bucket over 93
    # and 25 cached 16-token pages, gathered to 93 * 16 + 64 = 1552 keys
    cli_bucket = (rnd(4, 1024, h, d), rnd(4, 1024, n_kv, d),
                  rnd(4, 1024, n_kv, d), ints(300, 700, 1000, 1024), None)
    cli_hit = (rnd(2, 64, h, d), rnd(2, 1552, n_kv, d), rnd(2, 1552, n_kv, d),
               ints(1500, 452), ints(1488, 400))
    return {"full": full, "chunk": chunk, "batch2": batch2,
            "cli_bucket": cli_bucket, "cli_hit": cli_hit}


def flash_bound(q, k, seq_lens, q_offset, dtype_name):
    """Bytes: q and out, the valid keys' k and v rows, lengths and offsets;
    operations: the visible (query, key) pairs' q.k and p.v, 2 flops per
    MAC, summed over the batch rows."""
    b, s_q, h, d = q.shape
    s_k, n_kv = k.shape[1], k.shape[2]
    es = q.element_size()
    nbytes, visible = 2 * b * s_q * h * d * es + 8 * b, 0
    for i in range(b):
        n = min(int(seq_lens[i]), s_k)
        off = 0 if q_offset is None else int(q_offset[i])
        visible += sum(min(off + j + 1, n) for j in range(s_q))
        nbytes += 2 * n * n_kv * d * es
    return bound(nbytes, 4 * visible * h * d, dtype_name)


def flash_library_fn(q, k, v, seq_lens, q_offset):
    """One SDPA call with ``enable_gqa`` over the same layout transposed to
    [B, H, S, d]: causal for a full bucket of one row, else with the mask
    q_pos >= k_pos and k_pos < seq_len built before timing."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q_offset is None and q.shape[0] == 1:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    b, s_q = q.shape[:2]
    off = (torch.zeros(b, dtype=torch.int32, device="cuda")
           if q_offset is None else q_offset)
    k_pos = torch.arange(k.shape[1], device="cuda")
    q_pos = off[:, None] + torch.arange(s_q, device="cuda")[None, :]
    mask = ((q_pos[:, :, None] >= k_pos[None, None, :])
            & (k_pos[None, None, :] < seq_lens[:, None, None]))[:, None]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def flash_kernels(table, dtype_name, gen, cases=None) -> None:
    """Each flash case (``flash_cases`` unless ``cases`` are given) against
    the plain version, timed with its SDPA yardstick and bound."""
    import torch

    from k8s_llm_rca_tpu_torch.ops.attention import causal_attention
    from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention

    dtype = getattr(torch, dtype_name)
    cases = flash_cases(dtype, gen) if cases is None else cases
    for case, (q, k, v, lens, off) in cases.items():
        rec = held_record(
            "flash_attention", dtype_name,
            flash_attention(q, k, v, lens, off),
            causal_attention(q, k, v, lens, off), case=case,
            shapes=f"q {list(q.shape)} k/v {list(k.shape)} seq_lens "
            f"{lens.tolist()} q_offset "
            f"{0 if off is None else off.tolist()}")
        rec["kernel_ms"] = time_ms(
            lambda: flash_attention(q, k, v, lens, off), 20)
        rec["plain_ms"] = time_ms(
            lambda: causal_attention(q, k, v, lens, off), 3)
        rec["library_ms"] = time_ms(flash_library_fn(q, k, v, lens, off), 20)
        rec["bound_ms"], rec["bound_by"] = flash_bound(q, k, lens, off,
                                                       dtype_name)
        emit("kernels", **rec)
        table[("flash_attention", dtype_name, case)] = rec
        del q, k, v
        torch.cuda.empty_cache()


def pages_cases(dtype, gen):
    """Llama-3-8B's attention over KV pages (one layer of a 168-page pool
    of page 64, shuffled page ids): "hit", three batched prefix hits of
    512-token chunks over the same 24 cached pages (1536 tokens, the
    table padded to 32 pages) with their fresh K/V; "verify", four slots
    verifying T = 5 tokens at lengths 400 / 900 / 1500 / 2300 (already in
    the pool) over 40-page tables.  Returns {case: (q, pool, tables,
    q_offset, seq_lens, fresh, n_pages)}."""
    import torch

    from k8s_llm_rca_tpu_torch.engine.paged import PagePool

    h, n_kv, d, page, n_pages = 32, 8, 128, 64, 168

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device="cuda")

    pool = PagePool(rnd(1, n_pages, page, n_kv * d),
                    rnd(1, n_pages, page, n_kv * d))
    ids = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1)
    hit_tables = torch.zeros((3, 32), dtype=torch.int32, device="cuda")
    hit_tables[:, :24] = ids[:24].int()
    hit = (rnd(3, 512, h, d), pool, hit_tables, ints([1536] * 3),
           ints([2048] * 3), (rnd(3, 512, n_kv, d), rnd(3, 512, n_kv, d)),
           None)
    lengths, t = [400, 900, 1500, 2300], 5
    tables = torch.zeros((4, 40), dtype=torch.int32, device="cuda")
    used = 24
    for i, n in enumerate(lengths):
        n_p = -(-(n + t) // page)
        tables[i, :n_p] = ids[used:used + n_p].int()
        used += n_p
    verify = (rnd(4, t, h, d), pool, tables, ints(lengths),
              ints([n + t for n in lengths]), None, 40)
    return {"hit": hit, "verify": verify}


def pages_kernels(table, dtype_name, gen) -> None:
    """``attend_over_pages`` on the card (the gather into a buffer indexed
    by position, then the flash kernel) against its plain version on the
    same pages, at the hit and verify shapes: the helper's time, the
    gather's and the kernel's apart, the kernel's operations bound and
    masked SDPA over the same gathered buffers."""
    import torch

    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine.paged import (
        attend_over_pages, attend_over_pages_plain, pages_to_buffer,
    )
    from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention

    dtype = getattr(torch, dtype_name)
    cfg = LLAMA3_8B.replace(dtype=dtype_name)
    for case, (q, pool, tabs, off, lens, fresh, n_p) in pages_cases(
            dtype, gen).items():
        rec = held_record(
            "flash_attention", dtype_name,
            attend_over_pages(cfg, q, pool, 0, tabs, off, lens, fresh, n_p),
            attend_over_pages_plain(cfg, q, pool, 0, tabs, off, lens, fresh),
            case=case, shapes=f"q {list(q.shape)} tables {list(tabs.shape)} "
            f"q_offset {off.tolist()} seq_lens {lens.tolist()} fresh "
            f"{fresh is not None}")
        kb, vb = pages_to_buffer(cfg, pool, 0, tabs, off, fresh, n_p)
        rec["buffer"] = list(kb.shape)
        rec["helper_ms"] = time_ms(lambda: attend_over_pages(
            cfg, q, pool, 0, tabs, off, lens, fresh, n_p), 20)
        rec["gather_ms"] = time_ms(lambda: pages_to_buffer(
            cfg, pool, 0, tabs, off, fresh, n_p), 20)
        rec["kernel_ms"] = time_ms(
            lambda: flash_attention(q, kb, vb, lens, off), 20)
        rec["plain_ms"] = time_ms(lambda: attend_over_pages_plain(
            cfg, q, pool, 0, tabs, off, lens, fresh), 3)
        rec["library_ms"] = time_ms(flash_library_fn(q, kb, vb, lens, off),
                                    20)
        rec["bound_ms"], rec["bound_by"] = flash_bound(q, kb, lens, off,
                                                       dtype_name)
        emit("kernels", **rec)
        table[("flash_attention", dtype_name, case)] = rec
        del q, pool, kb, vb
        torch.cuda.empty_cache()


def quant_weight(gen, k, n, axis=-1, bits=4, experts=0):
    """A weight quantized as the model's (bf16 scales) from N(0, 1/K)
    values, so outputs are of order one: [K, N] (axis -1), [N, K] (axis 0)
    or stacked [experts, K, N] (axis (0, -1))."""
    import torch

    from k8s_llm_rca_tpu_torch.models.quant import quantize

    if experts:
        shape, axis = (experts, k, n), (0, -1)
    else:
        shape = (k, n) if axis == -1 else (n, k)
    w = torch.randn(shape, generator=gen, device="cuda") / k ** 0.5
    return quantize(w, axis=axis, compute_dtype=torch.bfloat16, bits=bits)


def weight_bound(w, x, out_elems, flops, dtype_name):
    """Quantized weights and scales, x and out once each; ``flops`` at 2
    per multiply-add."""
    nbytes = (w.q.numel() + w.scale.numel() * w.scale.element_size()
              + (x.numel() + out_elems) * x.element_size())
    return bound(nbytes, flops, dtype_name)


def paged_quant_case(args, packed):
    """The slice's paged shapes with the pools quantized per token."""
    from k8s_llm_rca_tpu_torch.models.quant import quantize_kv

    q, kp, vp, lens, tables = args
    kq, ks = quantize_kv(kp, packed)
    vq, vs = quantize_kv(vp, packed)
    return q, kq, vq, ks.float(), vs.float(), lens, tables


def paged_quant_library_fn(q, kq, vq, ks, vs, lens, tables, packed):
    """SDPA over KV gathered, dequantized and head-expanded before timing."""
    from k8s_llm_rca_tpu_torch.ops.paged_attention import gather_dequant_pages

    d = q.shape[2]
    n_kv = kq.shape[2] * (2 if packed else 1) // d
    return sdpa_decode_fn(
        q, gather_dequant_pages(kq, ks, tables, n_kv, d, q.dtype, packed),
        gather_dequant_pages(vq, vs, tables, n_kv, d, q.dtype, packed), lens)


def held_record(kernel, dtype_name, out, ref, **fields) -> dict:
    """The check record of one case; exits unless ``out`` holds ``ref``
    within ``TOL`` and is finite."""
    import torch

    torch.cuda.synchronize()
    errs = errors(out, ref)
    tol = TOL[dtype_name]
    err = held(errs, dtype_name)
    finite = bool(torch.isfinite(out).all())
    rec = {"kernel": kernel, "dtype": dtype_name, **fields, **errs,
           "tol": tol, "finite": finite}
    if not (err <= tol and finite):
        emit("kernels", **rec)
        raise SystemExit(f"{kernel} disagrees with its plain version "
                         f"({fields}, {dtype_name}): {err} > {tol}")
    return rec


def timed_case(table, key, kernel, dtype_name, run, exact, plain, library,
               bnd, iters, plain_iters, flush, **fields) -> None:
    """Check ``run()`` against ``exact`` (the plain version on the same
    values in fp32, see ``TOL``), time it, the plain version in the working
    dtype and the library call, and record the bound."""
    rec = held_record(kernel, dtype_name, run(), exact, **fields)
    rec["kernel_ms"] = time_ms(run, iters, flush_bytes=flush)
    rec["plain_ms"] = time_ms(plain, plain_iters, flush_bytes=flush)
    rec["library_ms"] = time_ms(library, iters, flush_bytes=flush)
    rec["bound_ms"], rec["bound_by"] = bnd
    emit("kernels", **rec)
    table[key] = rec


def slice3_weights(gen) -> dict:
    """Mixtral-8x7B's int8 weights at full width (wq, the router, w_gate
    and w_down), the router and experts in int4 too."""
    return {"wq8": quant_weight(gen, 4096, 4096, bits=8),
            "router8": quant_weight(gen, 4096, 8, bits=8),
            "router8_4": quant_weight(gen, 4096, 4, bits=8),
            "router4": quant_weight(gen, 4096, 8, bits=4),
            "router4_4": quant_weight(gen, 4096, 4, bits=4),
            "gate8": quant_weight(gen, 4096, 14336, bits=8, experts=8),
            "down8": quant_weight(gen, 14336, 4096, bits=8, experts=8),
            "gate4": quant_weight(gen, 4096, 14336, bits=4, experts=8),
            "down4": quant_weight(gen, 14336, 4096, bits=4, experts=8)}


def slice3_kernels(table, ws, dtype_name, gen, flush) -> None:
    """The int8 kn (wq at decode and prefill, the router at N = 8 and 4),
    the int4 kn at the router's widths, and the int8/int4 expert matmuls
    in both einsum forms at M = 4 and 5120."""
    import torch

    from k8s_llm_rca_tpu_torch.models.quant import dq
    from k8s_llm_rca_tpu_torch.ops.quant_matmul import (
        kn_body, quant_matmul, quant_matmul_experts,
        quant_matmul_experts_plain, quant_matmul_plain,
    )

    dtype = getattr(torch, dtype_name)
    fp32 = dtype_name == "float32"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    kn = [("quant_matmul_int8", "wq8", "decode", 4, 200, 20),
          ("quant_matmul_int8", "wq8", "verify", 20, 200, 20),
          ("quant_matmul_int8", "wq8", "prefill", 5120, 5, 3)]
    for name, bits in (("quant_matmul_int8", 8), ("quant_matmul", 4)):
        for n in (8, 4):
            wkey = f"router{bits}" + ("" if n == 8 else "_4")
            for case, m in (("decode", 4), ("prefill", 5120)):
                kn.append((name, wkey, f"router N={n} {case}", m, 20, 5))
    for name, wkey, case, m, iters, plain_iters in kn:
        w = ws[wkey]
        x = rnd(m, 4096)
        n = w.shape[1]
        bits = 8 if "int8" in name else 4
        w_dense = dq(w, dtype).to(dtype)
        fl = flush if m <= 20 else 0
        timed_case(table, (name, dtype_name, case), name, dtype_name,
                   lambda: quant_matmul(x, w),
                   quant_matmul_plain(x.float(), w),
                   lambda: quant_matmul_plain(x, w),
                   lambda: torch.matmul(x, w_dense),
                   weight_bound(w, x, m * n, 2 * m * 4096 * n, dtype_name),
                   iters, plain_iters, fl, case=case,
                   body=kn_body(bits, m, 4096, n),
                   shapes=f"x [{m}, 4096] @ int{bits} [4096, {n}]")
        del w_dense

    for bits in (8, 4):
        name = f"quant_matmul_experts_int{bits}"
        for form, wkey, k in (("3d", f"gate{bits}", 4096),
                              ("4d", f"down{bits}", 14336)):
            w = ws[wkey]
            e, _, n = w.shape
            w_dense = dq(w, dtype).to(dtype)
            # int8: also the slice's 512 and 1024 prefill buckets
            buckets = ((512, 1024) if bits == 8 else ())
            for case, m in (("decode", 4),
                            *((f"prefill {b}", b) for b in buckets),
                            ("prefill", 5120)):
                x = rnd(1, m, k) if form == "3d" else rnd(1, m, e, k)
                if form == "3d":
                    xe = x[0].expand(e, m, k)
                    lib = lambda: torch.matmul(xe, w_dense)  # noqa: E731
                else:
                    xt = x[0].transpose(0, 1).contiguous()  # before timing
                    lib = lambda: torch.bmm(xt, w_dense)  # noqa: E731
                big = m > 16
                iters = (2 if fp32 else 3 if m > 1024 else 10) if big else 50
                timed_case(table, (name, dtype_name, f"{form} {case}"), name,
                           dtype_name, lambda: quant_matmul_experts(x, w),
                           quant_matmul_experts_plain(x.float(), w),
                           lambda: quant_matmul_experts_plain(x, w), lib,
                           weight_bound(w, x, m * e * n, 2 * m * e * k * n,
                                        dtype_name),
                           iters, 1 if big else 5, 0 if big else flush,
                           case=f"{form} {case}",
                           body=kn_body(bits, m, k, n, experts=True),
                           shapes=f"x {list(x.shape)} @ int{bits} [{e}, {k}, "
                                  f"{n}]")
                del x, lib
                torch.cuda.empty_cache()
            del w_dense


def head_weights(gen) -> dict:
    """The slices' lm heads at full width, by case: Llama-3-8B's int4
    table [128256, 4096] and Mixtral-8x7B's int8 and int4 [32000, 4096]."""
    return {"llama3-8b int4": quant_weight(gen, 4096, 128256, axis=0),
            "mixtral-8x7b int8": quant_weight(gen, 4096, 32000, axis=0,
                                              bits=8),
            "mixtral-8x7b int4": quant_weight(gen, 4096, 32000, axis=0)}


def head_body(bits, m, k, v, dtype):
    """The nk body a head call takes (``nk_body``), or None under a package
    that has no such query (an older tree run with this script, the parent
    side of an A/B)."""
    from k8s_llm_rca_tpu_torch.ops import quant_matmul

    query = getattr(quant_matmul, "nk_body", None)
    return None if query is None else query(bits, m, k, v, dtype)


def head_kernels(table, ws, dtype_name, gen, flush) -> None:
    """Each head at decode, x [4, 4096], and the 8B int4 head at the
    verify step's M = 20 (speculative_k 4 at batch 4), against the plain
    version on the same values in fp32, with the body it took, L2 flushed
    before each launch as in a decode step."""
    import torch

    from k8s_llm_rca_tpu_torch.models.quant import QuantTensor4, dq
    from k8s_llm_rca_tpu_torch.ops.quant_matmul import (
        quant_matmul_head, quant_matmul_head_plain,
    )

    dtype = getattr(torch, dtype_name)
    for case, w in ws.items():
        bits = 4 if isinstance(w, QuantTensor4) else 8
        name = "quant_matmul_head" + ("" if bits == 4 else "_int8")
        v = w.shape[0]
        w_dense = dq(w, dtype).to(dtype)    # dequantized before timing
        for m in ((4, 20) if case == "llama3-8b int4" else (4,)):
            x = torch.randn((m, 4096), generator=gen,
                            device="cuda").to(dtype)
            label = case if m == 4 else f"{case} verify"
            timed_case(table, (name, dtype_name, label), name, dtype_name,
                       lambda: quant_matmul_head(x, w),
                       quant_matmul_head_plain(x.float(), w),
                       lambda: quant_matmul_head_plain(x, w),
                       lambda: torch.matmul(x, w_dense.t()),
                       weight_bound(w, x, m * v, 2 * m * 4096 * v,
                                    dtype_name),
                       50, 5, flush, case=label,
                       body=head_body(bits, m, 4096, v, dtype),
                       shapes=f"x [{m}, 4096] @ int{bits} [{v}, 4096]^T")
        del w_dense
        torch.cuda.empty_cache()


def paged_kernels(table, dtype_name, gen, flush, heads=(32, 8),
                  label: str = "") -> None:
    """The paged cases of phase 3: the bf16 or fp32 pool at the mixed and
    the long lengths, the int8 and int4 pools at the mixed lengths.  With
    ``heads`` (query, kv) a TP rank's share, only the mixed lengths, the
    cases named ``label``, ``label int8`` and ``label int4`` (an int4 pool
    packed over the rank's own lanes, as the engine's is)."""
    import torch

    from k8s_llm_rca_tpu_torch.ops.paged_attention import (
        launched_splits, paged_attention, paged_attention_plain,
        paged_attention_quant, paged_attention_quant_plain,
    )

    dtype = getattr(torch, dtype_name)
    cases = {name: dict(lengths=lengths, page=64, n_pages=168, pps=40)
             for name, lengths in PAGED_LENGTHS.items()
             if not label or name == "mixed"}
    if not label:
        cases["cli"] = CLI_PAGED
    h, n_kv = heads
    for lens_name, shape in cases.items():
        args = paged_case(dtype, gen, heads=heads, **shape)
        rec = held_record(
            "paged_attention", dtype_name, paged_attention(*args),
            paged_attention_plain(*args), case=label or lens_name,
            shapes=f"B={len(shape['lengths'])} H={h} n_kv={n_kv} d=128 "
            f"page={shape['page']} pages={shape['n_pages']} "
            f"pps={shape['pps']} lens=" + ",".join(map(str, shape["lengths"])),
            splits=launched_splits(args[0], args[1], args[4]))
        rec["kernel_ms"] = time_ms(lambda: paged_attention(*args), 200,
                                   flush_bytes=flush)
        rec["plain_ms"] = time_ms(lambda: paged_attention_plain(*args), 20,
                                  flush_bytes=flush)
        rec["library_ms"] = time_ms(paged_library_fn(*args), 200,
                                    flush_bytes=flush)
        rec["bound_ms"], rec["bound_by"] = paged_bound(args[0], args[1],
                                                       args[3], dtype_name)
        emit("kernels", **rec)
        table[("paged_attention", dtype_name, label or lens_name)] = rec
        if lens_name != "mixed":
            continue
        for packed, kind in ((False, "int8"), (True, "int4")):
            qargs = paged_quant_case(args, packed)
            kind = f"{label} {kind}".strip()
            rec = held_record(
                "paged_attention_quant", dtype_name,
                paged_attention_quant(*qargs, packed=packed),
                paged_attention_quant_plain(*qargs, packed=packed),
                case=kind, shapes=f"B=4 H={h} n_kv={n_kv} d=128 page=64 "
                "lens=1,64,65,2400",
                splits=launched_splits(qargs[0], qargs[1], qargs[6], packed))
            rec["kernel_ms"] = time_ms(
                lambda: paged_attention_quant(*qargs, packed=packed), 200,
                flush_bytes=flush)
            rec["plain_ms"] = time_ms(
                lambda: paged_attention_quant_plain(*qargs, packed=packed),
                20, flush_bytes=flush)
            rec["library_ms"] = time_ms(
                paged_quant_library_fn(*qargs, packed), 200,
                flush_bytes=flush)
            rec["bound_ms"], rec["bound_by"] = paged_bound(
                qargs[0], qargs[1], qargs[5], dtype_name, scale_bytes=4)
            emit("kernels", **rec)
            table[("paged_attention_quant", dtype_name, kind)] = rec


def phase_kernels() -> dict:
    import torch

    from k8s_llm_rca_tpu_torch.models.quant import dq
    from k8s_llm_rca_tpu_torch.ops.quant_matmul import (
        kn_body, quant_matmul, quant_matmul_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = {}
    # the slice's int4 MLP matmul [4096, 14336], the heads, Mixtral's
    w_mlp = quant_weight(gen, 4096, 14336)
    heads = head_weights(gen)
    ws = slice3_weights(gen)
    flush = 256 << 20
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        paged_kernels(table, dtype_name, gen, flush)
        flash_kernels(table, dtype_name, gen)
        pages_kernels(table, dtype_name, gen)

        # decode: one weight stream per call, cold in L2 as in a decode
        # step; verify: speculative_k 4 at batch 4 (M = 20); prefill: the
        # 512 and 1024 buckets and two 2560-token prompts batched
        for case, m, iters, plain_iters in (("decode", 4, 200, 20),
                                            ("verify", 20, 200, 20),
                                            ("prefill 512", 512, 20, 3),
                                            ("prefill 1024", 1024, 20, 3),
                                            ("prefill", 5120, 5, 3)):
            x = torch.randn((m, 4096), generator=gen, device="cuda").to(dtype)
            rec = held_record("quant_matmul", dtype_name,
                              quant_matmul(x, w_mlp),
                              quant_matmul_plain(x, w_mlp), case=case,
                              body=kn_body(4, m, 4096, 14336),
                              shapes=f"x [{m}, 4096] @ int4 [4096, 14336]")
            fl = flush if m <= 20 else 0
            rec["kernel_ms"] = time_ms(lambda: quant_matmul(x, w_mlp), iters,
                                       flush_bytes=fl)
            rec["plain_ms"] = time_ms(lambda: quant_matmul_plain(x, w_mlp),
                                      plain_iters, flush_bytes=fl)
            w_dense = dq(w_mlp, dtype).to(dtype)    # dequantized before timing
            rec["library_ms"] = time_ms(lambda: torch.matmul(x, w_dense),
                                        iters, flush_bytes=fl)
            del w_dense
            rec["bound_ms"], rec["bound_by"] = weight_bound(
                w_mlp, x, m * 14336, 2 * m * 4096 * 14336, dtype_name)
            emit("kernels", **rec)
            table[("quant_matmul", dtype_name, case)] = rec

        head_kernels(table, heads, dtype_name, gen, flush)
        slice3_kernels(table, ws, dtype_name, gen, flush)
    shard_kernels(table, ws, heads, w_mlp, gen, flush)
    cp_lse_kernels(table, gen, flush)
    microbatch_paged_kernels(table, gen, flush)
    return table


# ------------------------------------------------------------------ phase 4


def launch_counters():
    """Every kernel's launch counter, by the short name the phases report:
    (wrapper, attribute); the matmul wrappers count int4 launches in
    ``launches`` and int8 launches in ``launches_int8``.  The collectives
    of a mesh (``runtime/mesh.py``) count their calls under their names."""
    from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention
    from k8s_llm_rca_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_quant,
    )
    from k8s_llm_rca_tpu_torch.ops.quant_matmul import (
        quant_matmul, quant_matmul_experts, quant_matmul_head,
    )
    from k8s_llm_rca_tpu_torch.runtime.mesh import COLLECTIVES

    return {**{fn.__name__: (fn, "calls") for fn in COLLECTIVES},
            "paged": (paged_attention, "launches"),
            "flash": (flash_attention, "launches"),
            "paged_quant": (paged_attention_quant, "launches"),
            "qmm": (quant_matmul, "launches"),
            "qmm_head": (quant_matmul_head, "launches"),
            "qmm_experts": (quant_matmul_experts, "launches"),
            "qmm8": (quant_matmul, "launches_int8"),
            "qmm_head8": (quant_matmul_head, "launches_int8"),
            "qmm_experts8": (quant_matmul_experts, "launches_int8")}


def reset_counts() -> None:
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in
            launch_counters().items()}


def expected_counts(cfg, c: dict, quantized_kv: bool, bits=None,
                    contiguous: bool = False, cp_mode=None) -> dict:
    """The launches an engine run with the counters ``c`` (an engine's
    ``_counts``, or their gain over a window) must have made: per layer,
    one decode attention per single-token decode step, and one flash call
    per prefill dispatch of a miss, per chunk prefill (a prefix hit or a
    chunked prompt, over its gathered pages) and per speculative verify
    step (T queries over the gathered pages; under PP once a microbatch;
    under CP none: its T queries fold into the paged call a layer that a
    decode step makes).  The ``contiguous`` engine
    (``InferenceEngine``) attends its decode and verify steps in plain
    torch over its cache rows: only its prefills launch flash.  Under
    fused_quant_matmul
    over ``bits``-wide weights, per layer and per decode or verify step or
    dispatch of either prefill 7 kn matmuls (dense) or 5 kn matmuls (4
    projections and the router) and 3 expert matmuls (MoE), and one head
    per step and per prefill dispatch of either kind.  Replayed CUDA
    graphs count their launches at every replay.  Under a mesh (``cfg`` a
    rank's config) every forward (decode step or either prefill dispatch)
    calls, with TP, 2 sum all-reduces a layer (wo, w_down), one for the
    logits and one all-gather (the embedding), and over a quantized pool 2
    max all-reduces a layer per decode step and 2 per prefill dispatch
    (the k and v scales); with EP, 2 all-to-alls and one all-gather a
    layer.  Under PP (``cfg.pp``, ``cfg.n_layers`` the stage's) a rank runs
    its layers once per microbatch of a decode step or batched prefill and
    once per chunk prefill, the head once per forward on every rank; per
    forward M + P - 1 ring steps (P for a chunk prefill) and one sum
    all-reduce (the last stage's broadcast); the embedding and the head
    are whole, so TP adds only its 2 sums a layer pass (and 2 max
    all-reduces a layer pass of a decode step, 2 a pass of a prefill over
    a quantized pool).  Under FSDP (``cfg.fsdp``) every forward gathers 7
    weights a layer and the head (``all_gather_into``) and sums the
    embedding rows once; with ``sp`` (``cfg.sp``, TP) a miss prefill
    dispatch gathers the sequence 2 a layer and its last rows once and
    reduce-scatters 2 a layer in place of its 2 sums a layer."""
    steps = int(c.get("engine.decode_steps", 0))
    verify = int(c.get("engine.verify_steps", 0))
    prefills = int(c.get("engine.prefill_dispatches", 0))
    chunks = int(c.get("engine.chunk_prefill_dispatches", 0))
    pp = getattr(cfg, "pp", None)
    cp = getattr(cfg, "cp", None)
    m = pp.microbatches if pp is not None else 1
    # a paged verify step attends through flash (once a microbatch under
    # PP), under CP through the paged kernel over its folded queries
    flash_verify = 0 if contiguous or cp is not None else verify
    counts = {k: 0 for k in launch_counters()}
    counts["paged_quant" if quantized_kv else "paged"] = (
        0 if contiguous else cfg.n_layers * m * (steps - flash_verify))
    counts["flash"] = cfg.n_layers * m * (prefills + flash_verify) \
        + cfg.n_layers * chunks
    fwd = steps + prefills + chunks
    passes = m * (steps + prefills) + chunks      # layer passes a forward
    if cfg.fused_quant_matmul:
        sfx = "8" if bits == 8 else ""
        calls = cfg.n_layers * passes
        moe = cfg.n_experts > 0
        counts["qmm" + sfx] = (5 if moe else 7) * calls
        counts["qmm_experts" + sfx] = 3 * calls if moe else 0
        counts["qmm_head" + sfx] = fwd
    if getattr(cfg, "tp", None) is not None:
        if pp is None:
            counts["all_reduce_sum"] = (2 * cfg.n_layers + 1) * fwd
            counts["all_gather"] = fwd
            if getattr(cfg, "sp", False):
                counts["all_reduce_sum"] -= 2 * cfg.n_layers * prefills
                counts["all_gather_into"] += (2 * cfg.n_layers + 1) * prefills
                counts["reduce_scatter_sum"] += 2 * cfg.n_layers * prefills
        else:
            counts["all_reduce_sum"] = 2 * cfg.n_layers * passes
        if quantized_kv:
            counts["all_reduce_max"] = 2 * (cfg.n_layers * m * steps
                                            + m * prefills + chunks)
    if getattr(cfg, "ep", None) is not None:
        counts["all_to_all"] = 2 * cfg.n_layers * passes
        counts["all_gather"] += cfg.n_layers * passes
    if pp is not None:
        counts["ppermute"] += ((m + pp.size - 1) * (steps + prefills)
                               + pp.size * chunks)
        counts["all_reduce_sum"] += fwd
    if getattr(cfg, "fsdp", None) is not None:
        counts["all_gather_into"] += (7 * cfg.n_layers + 1) * fwd
        counts["all_reduce_sum"] += fwd
    if cp is not None:
        counts["all_gather"] += 2 * prefills + cfg.n_layers * steps
        if cp_mode == "ring":
            counts["flash"] -= cfg.n_layers * prefills
            counts["ppermute"] += 2 * cp.size * cfg.n_layers * prefills
        else:
            counts["all_to_all"] += 4 * cfg.n_layers * prefills
    return counts


def graph_stats(engine) -> dict:
    """An engine's CUDA graph counters: captures, replays, the seconds of
    warm-up and capture, and the bytes the captures reserved."""
    c, g = engine._counts, engine.graphs
    return {"graph_captures": int(c.get("engine.graph_captures", 0)),
            "graph_replays": int(c.get("engine.graph_replays", 0)),
            "capture_s": g.capture_s if g is not None else 0.0,
            "graph_pool_bytes": g.pool_bytes if g is not None else 0}


def phase_cross_device() -> None:
    """Same weights, same prompts: the engine on the card and on the CPU
    must emit the same greedy tokens (fp32, TF32 off), for a 2-layer
    head_dim-128 GQA-4 model and for TINY (head_dim 32, GQA 2) in fp32, with
    int4 weights under fused_quant_matmul over int4 and int8 KV pools, int8
    weights over an int8 pool, and for TINY_MOE with int8 weights over an
    int8 pool and int4 weights over an int4 pool; then the retired-slot
    case."""
    import numpy as np

    from k8s_llm_rca_tpu_torch.config import (
        TINY, TINY_MOE, EngineConfig, ModelConfig,
    )
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    gqa4 = ModelConfig(name="smoke-gqa4", vocab_size=512, hidden_size=1024,
                       n_layers=2, n_heads=8, n_kv_heads=2, head_dim=128,
                       intermediate_size=2048, max_seq_len=1024,
                       dtype="float32", tie_embeddings=False)
    fused = TINY.replace(fused_quant_matmul=True)
    moe = TINY_MOE.replace(fused_quant_matmul=True)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (7, 100, 150, 300)]
    for cfg, kv, bits in ((gqa4, None, None), (TINY, None, None),
                          (fused, "int4", 4), (fused, "int8", 4),
                          (fused, "int8", 8), (moe, "int8", 8),
                          (moe, "int4", 4)):
        ecfg = EngineConfig(max_batch=4, max_seq_len=512,
                            prefill_buckets=(128, 256), max_new_tokens=32,
                            paged=True, page_size=16, num_pages=168,
                            prefix_cache=False, decode_chunk=16,
                            kv_cache_dtype=kv)
        cpu_params, gpu_params = x3_params(cfg, bits)
        tok = get_tokenizer(vocab_size=cfg.vocab_size)
        t0 = time.perf_counter()
        cpu = make_engine(cfg, ecfg, cpu_params, tok, device="cpu").generate(
            prompts)
        t1 = time.perf_counter()
        engine = make_engine(cfg, ecfg, gpu_params, tok)
        reset_counts()
        gpu = engine.generate(prompts)
        counts = read_counts()
        t2 = time.perf_counter()
        same = [a.token_ids == b.token_ids for a, b in zip(cpu, gpu)]
        expect = expected_counts(cfg, engine._counts, kv is not None, bits)
        label = cfg.name + (f"-int{bits}-fused" if bits else "")
        graphs = graph_stats(engine)
        emit("cross_device", model=label, head_dim=cfg.head_dim,
             kv_cache_dtype=kv, prompts=[len(p) for p in prompts],
             tokens_per_seq=[len(r.token_ids) for r in gpu],
             distinct_tokens=[len(set(r.token_ids)) for r in gpu],
             equal_streams=same, launches=counts, expected_launches=expect,
             **graphs, cpu_s=t1 - t0, gpu_s=t2 - t1)
        if not all(same):
            i = same.index(False)
            a, b = cpu[i].token_ids, gpu[i].token_ids
            j = next(k for k in range(min(len(a), len(b))) if a[k] != b[k])
            raise SystemExit(f"{label} kv={kv}: card and CPU greedy streams "
                             f"differ: seq {i} token {j}: cpu {a[j]} gpu "
                             f"{b[j]}")
        if counts != expect:
            raise SystemExit(f"{label} kv={kv}: launch counts {counts} != "
                             f"expected {expect}")
        if not graphs["graph_replays"]:
            raise SystemExit(f"{label} kv={kv}: the card engine replayed no "
                             f"CUDA graph")
    retired_slot_case()
    for budget in (0, 32):
        prefix_case(budget)
    spec_overlap_case()
    sweep_case()
    memory_tier_cases()


def sweep_case() -> None:
    """The RCA sweep on TINY (fp32, ``faults/soak.py``'s engine, two
    incidents at concurrency 2) on the CPU and on the card with the same
    seeded weights: equal report bytes, no failed incident, both engines
    clean, and the card's paged and flash launches exact."""
    import torch

    from k8s_llm_rca_tpu_torch.config import TINY
    from k8s_llm_rca_tpu_torch.faults.soak import (
        report_bytes, run_pipelined_sweep,
    )
    from k8s_llm_rca_tpu_torch.models.llama import init_params

    cfg = TINY.replace(max_seq_len=2560)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_params = {k: ([{n: _to_cuda(t) for n, t in layer.items()}
                       for layer in v] if k == "layers" else _to_cuda(v))
                  for k, v in cpu_params.items()}
    t0 = time.perf_counter()
    cpu = run_pipelined_sweep(backend="engine", n_incidents=2,
                              concurrency=2, model_cfg=cfg,
                              params=cpu_params, device="cpu")
    t1 = time.perf_counter()
    reset_counts()
    gpu = run_pipelined_sweep(backend="engine", n_incidents=2,
                              concurrency=2, model_cfg=cfg,
                              params=gpu_params)
    torch.cuda.synchronize()
    counts = read_counts()
    t2 = time.perf_counter()
    engine = gpu["engines"][0]
    expect = expected_counts(cfg, engine._counts, False)
    report = gpu["report"]
    same = report_bytes(report) == report_bytes(cpu["report"])
    graphs = graph_stats(engine)
    emit("cross_device", model="tiny-rca-sweep", incidents=2, concurrency=2,
         equal_report_bytes=same, completed=report["completed"],
         failed=report["failed"], engine_clean=report["engine_clean"],
         decode_steps=int(engine._counts["engine.decode_steps"]),
         dispatches=int(engine._counts["engine.dispatches"]),
         graph_keys=sorted(map(str, engine.graphs.buckets)), **graphs,
         launches=counts, expected_launches=expect, cpu_s=t1 - t0,
         gpu_s=t2 - t1)
    if not same:
        raise SystemExit("TINY sweep: card and CPU report bytes differ")
    if report["failed"] or not report["engine_clean"] \
            or not cpu["report"]["engine_clean"]:
        raise SystemExit(f"TINY sweep: failed {report['failed']}, "
                         f"engine_clean {report['engine_clean']}")
    if counts != expect:
        raise SystemExit(f"TINY sweep: launch counts {counts} != expected "
                         f"{expect}")
    if not any(k[0] == "dfa" for k in engine.graphs.buckets):
        raise SystemExit("TINY sweep: no DFA scan ran as a CUDA graph")
    # the same sweep with speculative_k 4: greedy-exact, so the same bytes
    reset_counts()
    spec = run_pipelined_sweep(backend="engine", n_incidents=2,
                               concurrency=2, model_cfg=cfg,
                               params=gpu_params,
                               engine_overrides={"speculative_k": 4})
    torch.cuda.synchronize()
    counts = read_counts()
    engine = spec["engines"][0]
    c = engine._counts
    expect = expected_counts(cfg, c, False)
    same = report_bytes(spec["report"]) == report_bytes(cpu["report"])
    emit("cross_device", model="tiny-rca-sweep-speculative", incidents=2,
         concurrency=2, speculative_k=4, equal_report_bytes=same,
         completed=spec["report"]["completed"],
         engine_clean=spec["report"]["engine_clean"],
         spec_drafted=int(c.get("engine.spec_drafted", 0)),
         spec_accepted=int(c.get("engine.spec_accepted", 0)),
         verify_steps=int(c.get("engine.verify_steps", 0)),
         decode_steps=int(c["engine.decode_steps"]),
         dispatches=int(c["engine.dispatches"]),
         graph_keys=sorted(map(str, engine.graphs.buckets)),
         launches=counts, expected_launches=expect, **graph_stats(engine))
    if not same:
        raise SystemExit("TINY sweep, speculative_k 4: report bytes differ "
                         "from the plain sweep's and the CPU's")
    if counts != expect:
        raise SystemExit(f"TINY speculative sweep: launch counts {counts} "
                         f"!= expected {expect}")


SPEC_SCHEMA = {"type": "object", "properties": [
    ("kind", {"enum": ["ConfigMap", "Job", "Pod", "Secret"]}),
    ("count", {"type": "integer", "max_digits": 3}),
    ("note", {"type": "string", "max_len": 24}),
]}


def first_divergence(cfg, params, prompt, a, b) -> dict:
    """Where two greedy streams of one prompt part: the position, both
    tokens, and the logit margin between them after the common prefix
    (the CPU's plain fp32 prefill of prompt + common tokens)."""
    import torch

    from k8s_llm_rca_tpu_torch.models.llama import prefill_kv

    j = next(k for k in range(min(len(a), len(b))) if a[k] != b[k])
    ctx = list(prompt) + list(a[:j])
    _, _, logits = prefill_kv(cfg, params, torch.tensor([ctx]), len(ctx))
    return {"token": j, "a": a[j], "b": b[j],
            "logit_margin": abs(float(logits[0, a[j]] - logits[0, b[j]]))}


def equal_or_near_tie(label, cfg, cpu_params, prompts, want, got) -> None:
    """Hold two runs' streams equal; where one differs, print its first
    differing token with the logit margin, and fail unless that margin is
    at most 1e-3 (a near-tie that fp32 rounding may flip: verification
    attends through flash, the plain step through the paged kernel)."""
    for i, (a, b) in enumerate(zip(want, got)):
        if a == b:
            continue
        div = first_divergence(cfg, cpu_params, prompts[i], a, b)
        emit("cross_device", model=label, seq=i, first_divergence=div)
        if div["logit_margin"] > 1e-3:
            raise SystemExit(f"{label}: seq {i} differs at token "
                             f"{div['token']} with logit margin "
                             f"{div['logit_margin']}")


def spec_overlap_case() -> None:
    """TINY (fp32, x3 projections, page 64, decode_chunk 1) on the card:
    speculative_k 4 (one-token n-grams, so random-weight slots draft too)
    against plain greedy, without a grammar and with a DFA grammar slot
    (verified on the device inside the graph), the speculative run also
    against the CPU's; host_overlap on against off.  Equal streams (or a
    near-tie, ``equal_or_near_tie``), exact launches, drafts verified, and
    under the grammar accepted."""
    import numpy as np
    import torch

    from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.engine.constrain import DFAGrammar
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cpu_params, gpu_params = x3_params(TINY)
    tok = get_tokenizer(vocab_size=TINY.vocab_size)
    rng = np.random.default_rng(4)
    example = ('{"kind": "Pod", "count": 12, "note": "crash loop"} '
               '{"kind": "Job", "count": 3, "note": "oom killed"} ')
    prompts = [tok.encode(example * 2, add_bos=True),
               list(range(5, 25)) * 6] + [
        [int(t) for t in rng.integers(0, 256, n)] for n in (130, 300)]

    def run(device, params, grammar=False, **over):
        ecfg = EngineConfig(**{**dict(
            max_batch=4, max_seq_len=512, prefill_buckets=(128, 256),
            max_new_tokens=40, paged=True, page_size=64, num_pages=48,
            prefix_cache=False, decode_chunk=1, speculative_ngram=1),
            **over})
        engine = make_engine(TINY, ecfg, params, tok, device=device)
        reset_counts()
        ids = [engine.submit(p, grammar=DFAGrammar(SPEC_SCHEMA, tok)
                             if grammar and i == 0 else None)
               for i, p in enumerate(prompts)]
        res = {r.seq_id: r.token_ids for r in engine.run_to_completion()}
        if device != "cpu":
            torch.cuda.synchronize()
        return engine, [res[i] for i in ids], read_counts()

    for grammar in (False, True):
        label = "tiny-speculative" + ("-dfa" if grammar else "")
        _, plain, _ = run(None, gpu_params, grammar)
        engine, spec, counts = run(None, gpu_params, grammar,
                                   speculative_k=4)
        _, spec_cpu, _ = run("cpu", cpu_params, grammar, speculative_k=4)
        c = engine._counts
        expect = expected_counts(TINY, c, False)
        emit("cross_device", model=label, equal_to_plain=[
            a == b for a, b in zip(plain, spec)],
             equal_to_cpu=[a == b for a, b in zip(spec_cpu, spec)],
             spec_drafted=int(c.get("engine.spec_drafted", 0)),
             spec_accepted=int(c.get("engine.spec_accepted", 0)),
             verify_steps=int(c.get("engine.verify_steps", 0)),
             dispatches=int(c["engine.dispatches"]),
             decode_tokens=int(c["engine.decode_tokens"]),
             graph_keys=sorted(map(str, engine.graphs.buckets)),
             launches=counts, expected_launches=expect,
             **graph_stats(engine))
        equal_or_near_tie(label, TINY, cpu_params, prompts, plain, spec)
        equal_or_near_tie(label + "-cpu", TINY, cpu_params, prompts,
                          spec_cpu, spec)
        if counts != expect:
            raise SystemExit(f"{label}: launch counts {counts} != "
                             f"expected {expect}")
        if not c.get("engine.spec_drafted") or (
                grammar and not c.get("engine.spec_accepted")):
            raise SystemExit(f"{label}: no draft was verified (or, under "
                             f"the grammar, accepted)")
        if grammar and not any(k[0] == "multi-dfa"
                               for k in engine.graphs.buckets):
            raise SystemExit(f"{label}: the DFA verify ran outside a graph")
    _, plain, _ = run(None, gpu_params)
    engine, over, counts = run(None, gpu_params, host_overlap=True)
    c = engine._counts
    expect = expected_counts(TINY, c, False)
    emit("cross_device", model="tiny-host-overlap",
         equal_to_plain=[a == b for a, b in zip(plain, over)],
         d2h_syncs=int(c["engine.d2h_syncs"]),
         h2d_uploads=int(c["engine.h2d_uploads"]),
         dispatches=int(c["engine.dispatches"]),
         decode_tokens=int(c["engine.decode_tokens"]),
         graph_keys=sorted(map(str, engine.graphs.buckets)),
         launches=counts, expected_launches=expect, **graph_stats(engine))
    equal_or_near_tie("tiny-host-overlap", TINY, cpu_params, prompts, plain,
                      over)
    if counts != expect:
        raise SystemExit(f"host overlap: launch counts {counts} != "
                         f"expected {expect}")
    if ("overlap",) not in engine.graphs.buckets:
        raise SystemExit("host overlap: the overlapped step ran outside a "
                         "graph")


def retired_slot_case() -> None:
    """A slot freed near max_seq_len (ROADMAP Queue 3 fault 2): TINY (fp32,
    x3 projections, page 16, decode_chunk 16) runs a 470-token prompt to
    its 40 tokens and retires it at length 510, then decodes two short
    prompts with that slot idle.  The card engine's tokens must equal the
    CPU engine's, and the card must survive the scan over the idle slot."""
    import numpy as np
    import torch

    from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    ecfg = EngineConfig(max_batch=4, max_seq_len=512,
                        prefill_buckets=(128, 256), max_new_tokens=40,
                        temperature=0.0, paged=True, page_size=16,
                        num_pages=168, prefix_cache=False, decode_chunk=16)
    cpu_params, gpu_params = x3_params(TINY)
    rng = np.random.default_rng(3)
    first = [[int(t) for t in rng.integers(0, 256, 470)]]
    then = [list(range(5, 15)), list(range(5, 75))]
    streams = []
    for params, device in ((cpu_params, "cpu"), (gpu_params, None)):
        engine = make_engine(TINY, ecfg, params,
                             get_tokenizer(vocab_size=TINY.vocab_size),
                             device=device)
        tokens = [r.token_ids for r in engine.generate(first)]
        tokens += [r.token_ids for r in engine.generate(then,
                                                        max_new_tokens=5)]
        streams.append(tokens)
    torch.cuda.synchronize()
    emit("cross_device", model="tiny-retired-slot",
         tokens_per_seq=[len(t) for t in streams[1]],
         equal_streams=[a == b for a, b in zip(*streams)])
    if streams[0] != streams[1]:
        raise SystemExit(f"retired-slot case: card and CPU streams differ: "
                         f"cpu {streams[0][1:]} gpu {streams[1][1:]}")


PREFIX_COUNTERS = ("engine.prefix_hit_tokens",
                   "engine.prefix_batch_hit_admissions",
                   "engine.prefill_tokens", "engine.prefill_chunks")


def prefix_case(budget: int) -> None:
    """TINY (fp32, x3 projections) with the prefix cache on and
    ``prefill_chunk_budget`` ``budget``: four prompts share a 64-token
    prefix (four pages); the first seeds the cache, the second hits it
    alone, the last two together (one batched chunk prefill unless the
    budget sends them one by one through the chunked path).  The card
    engine's tokens and prefix counters must equal the CPU engine's, and
    its launches be exact."""
    import numpy as np
    import torch

    from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    ecfg = EngineConfig(max_batch=4, max_seq_len=512,
                        prefill_buckets=(128, 256), max_new_tokens=32,
                        paged=True, page_size=16, num_pages=168,
                        prefix_cache=True, prefill_chunk_budget=budget,
                        decode_chunk=16)
    rng = np.random.default_rng(5)
    common = [int(t) for t in rng.integers(0, 256, 64)]
    prompts = [common + [int(t) for t in rng.integers(0, 256, n)]
               for n in (20, 35, 50, 27)]
    waves = [prompts[:1], prompts[1:2], prompts[2:]]
    cpu_params, gpu_params = x3_params(TINY)
    runs = []
    for params, device in ((cpu_params, "cpu"), (gpu_params, None)):
        engine = make_engine(TINY, ecfg, params,
                             get_tokenizer(vocab_size=TINY.vocab_size),
                             device=device)
        reset_counts()
        tokens = [r.token_ids for w in waves for r in engine.generate(w)]
        runs.append((engine, tokens, read_counts(),
                     {k: int(engine._counts.get(k, 0))
                      for k in PREFIX_COUNTERS}))
    torch.cuda.synchronize()
    (_, cpu_tokens, _, cpu_c), (engine, gpu_tokens, counts, gpu_c) = runs
    expect = expected_counts(TINY, engine._counts, False)
    emit("cross_device", model=f"tiny-prefix-budget{budget}",
         equal_streams=[a == b for a, b in zip(cpu_tokens, gpu_tokens)],
         counters=gpu_c, cpu_counters=cpu_c, launches=counts,
         expected_launches=expect, **graph_stats(engine))
    if gpu_tokens != cpu_tokens or gpu_c != cpu_c:
        raise SystemExit(f"prefix case (budget {budget}): card and CPU "
                         f"differ: counters {gpu_c} vs {cpu_c}")
    if gpu_c["engine.prefix_hit_tokens"] != 3 * 64:
        raise SystemExit(f"prefix case (budget {budget}): "
                         f"{gpu_c['engine.prefix_hit_tokens']} hit tokens, "
                         f"expected {3 * 64}")
    if counts != expect:
        raise SystemExit(f"prefix case (budget {budget}): launch counts "
                         f"{counts} != expected {expect}")


MEMORY_COUNTERS = ("engine.spilled_pages", "engine.restored_pages",
                   "engine.preemptions", "engine.spill_budget_fallbacks",
                   "engine.crash_evictions", "engine.prefix_demotions",
                   "engine.prefix_hits_l0", "engine.prefix_hits_l1",
                   "engine.prefix_hits_l2", "engine.prefix_promoted_pages",
                   "engine.prefix_bytes_restored",
                   "engine.prefix_snapshot_published",
                   "engine.prefill_tokens", "engine.d2h_syncs")


def memory_case(label: str, run) -> dict:
    """One memory-tier case of phase 4 on TINY (fp32, x3 projections),
    on the CPU and on the card: ``run(params, device, tmpdir)`` returns
    (engines, tokens).  Tokens and the memory counters must be equal on
    both, the card's launches exact, its allocator the native one and
    whole.  Returns the card's counters."""
    import tempfile

    import torch

    from k8s_llm_rca_tpu_torch.config import TINY

    cpu_params, gpu_params = x3_params(TINY)
    out = []
    for params, device in ((cpu_params, "cpu"), (gpu_params, None)):
        with tempfile.TemporaryDirectory() as d:
            reset_counts()
            engines, tokens = run(params, device, d)
            if device is None:
                torch.cuda.synchronize()
            counts = read_counts()
        counters = {k: 0 for k in MEMORY_COUNTERS}
        for engine in engines:
            engine.allocator.check()
            for k in MEMORY_COUNTERS:
                counters[k] += int(engine._counts.get(k, 0))
        out.append((engines, tokens, counts, counters))
    (_, cpu_tokens, _, cpu_c), (engines, gpu_tokens, counts, gpu_c) = out
    expect = {k: 0 for k in launch_counters()}
    for engine in engines:
        for k, v in expected_counts(TINY, engine._counts, False).items():
            expect[k] += v
    allocators = sorted({type(e.allocator).__name__ for e in engines})
    emit("cross_device", model=f"tiny-{label}",
         equal_streams=[a == b for a, b in zip(cpu_tokens, gpu_tokens)],
         counters=gpu_c, cpu_counters=cpu_c, allocator=allocators,
         launches=counts, expected_launches=expect,
         nvidia_smi=nvidia_smi_name_power(), **graph_stats(engines[-1]))
    if gpu_tokens != cpu_tokens or gpu_c != cpu_c:
        raise SystemExit(f"{label}: card and CPU differ: counters {gpu_c} "
                         f"vs {cpu_c}")
    if counts != expect:
        raise SystemExit(f"{label}: launch counts {counts} != expected "
                         f"{expect}")
    if allocators != ["NativePageAllocator"]:
        raise SystemExit(f"{label}: the engine built {allocators}, not the "
                         f"native allocator")
    return gpu_c


def memory_tier_cases() -> None:
    """Phase 4's memory tiers, TINY, card against CPU (``memory_case``):
    KV spill under a "preempt" tick fault (``max_spilled_pages`` 64); the
    prefix cache's host (L1) and disk (L2) tiers, every resident page
    demoted by ``evict(10**6)`` and the prompts served again from the
    promoted pages; a snapshot taken mid-decode and restored into a fresh
    engine sharing the store; and ``run_chaos_soak(backend="engine")``,
    whose report bytes must be equal."""
    import numpy as np
    import torch

    from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.faults import inject
    from k8s_llm_rca_tpu_torch.faults.plan import Fault, FaultPlan
    from k8s_llm_rca_tpu_torch.faults.soak import (
        default_plan_spec, report_bytes, run_chaos_soak,
    )
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    tok = get_tokenizer(vocab_size=TINY.vocab_size)
    base = dict(max_batch=4, max_seq_len=512, prefill_buckets=(128, 256),
                max_new_tokens=32, paged=True, page_size=16, num_pages=168,
                prefix_cache=False, decode_chunk=16)
    rng = np.random.default_rng(0)
    mixed = [[int(t) for t in rng.integers(0, 256, n)]
             for n in (7, 100, 150, 300)]
    rng = np.random.default_rng(5)
    common = [int(t) for t in rng.integers(0, 256, 64)]
    shared = [common + [int(t) for t in rng.integers(0, 256, n)]
              for n in (20, 35, 50, 27)]

    def spill(params, device, d):
        engine = make_engine(TINY, EngineConfig(**base, max_spilled_pages=64),
                             params, tok, device=device)
        with inject.armed(FaultPlan([Fault(inject.SITE_ENGINE_TICK, 1,
                                           "preempt", wave=2)])):
            tokens = [r.token_ids for r in engine.generate(mixed)]
        return [engine], tokens

    c = memory_case("spill", spill)
    if not c["engine.restored_pages"] or c["engine.spill_budget_fallbacks"]:
        raise SystemExit(f"tiny spill: nothing spilled and restored: {c}")

    for tier, store in (("l1", {"prefix_host_pages": 64}),
                        ("l2", {"prefix_host_pages": 0})):
        def tiers(params, device, d, store=store):
            over = dict(base, prefix_cache=True, **store)
            if tier == "l2":
                over["prefix_disk_dir"] = d
            engine = make_engine(TINY, EngineConfig(**over), params, tok,
                                 device=device)
            tokens = []
            for _ in range(2):
                tokens += [r.token_ids for w in (shared[:1], shared[1:])
                           for r in engine.generate(w)]
                engine.prefix_cache.evict(10 ** 6)
            return [engine], tokens

        c = memory_case(f"prefix-{tier}", tiers)
        if not c[f"engine.prefix_hits_{tier}"]:
            raise SystemExit(f"tiny {tier}: no page was promoted: {c}")

    def snapshot(params, device, d):
        cfg = EngineConfig(**dict(base, prefix_cache=True,
                                  prefix_host_pages=64))
        first = make_engine(TINY, cfg, params, tok, device=device)
        for p in mixed:
            first.submit(p)
        first.step()
        snap = first.snapshot_sequences()
        fresh = make_engine(TINY, cfg, params, tok, device=device,
                            prefix_store=first.prefix_store)
        fresh.restore_sequences(snap)
        res = {r.seq_id: r.token_ids for r in fresh.run_to_completion()}
        return [first, fresh], [res[i] for i in sorted(res)]

    c = memory_case("snapshot", snapshot)
    if not c["engine.prefix_promoted_pages"]:
        raise SystemExit(f"tiny snapshot: no published page was promoted: "
                         f"{c}")

    cfg = TINY.replace(max_seq_len=2560)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_params = {k: ([{n: _to_cuda(t) for n, t in layer.items()}
                       for layer in v] if k == "layers" else _to_cuda(v))
                  for k, v in cpu_params.items()}
    spec = default_plan_spec()
    spec[inject.SITE_ENGINE_TICK] = {
        "indices": {3: "preempt", 9: "oom", 15: "crash", 21: "stall"},
        "delay_s": 0.01}
    reports = []
    for params, device in ((cpu_params, "cpu"), (gpu_params, None)):
        t0 = time.perf_counter()
        reports.append((run_chaos_soak(
            backend="engine", n_incidents=1, plan_spec=spec, model_cfg=cfg,
            params=params, device=device,
            engine_overrides={"max_spilled_pages": 64}),
            time.perf_counter() - t0))
    (cpu_r, cpu_s), (gpu_r, gpu_s) = reports
    same = report_bytes(gpu_r) == report_bytes(cpu_r)
    emit("cross_device", model="tiny-chaos-soak", equal_report_bytes=same,
         completed=gpu_r["completed"], degraded=gpu_r["degraded"],
         failed=gpu_r["failed"], engine_clean=gpu_r["engine_clean"],
         fired=gpu_r["faults"]["fired"], retries=gpu_r["retries"],
         cpu_s=cpu_s, gpu_s=gpu_s, nvidia_smi=nvidia_smi_name_power())
    if not same or gpu_r["failed"] or not gpu_r["engine_clean"]:
        raise SystemExit("tiny chaos soak: card and CPU reports differ or "
                         "an incident failed")


def x3_params(cfg, bits=None):
    """Seeded weights on the CPU and the same on the card, projections x3
    (greedy decode then walks many distinct tokens), quantized to ``bits``
    when given."""
    import torch

    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.models.quant import quantize_params

    cpu_params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for layer in cpu_params["layers"]:
        for name in layer:
            if name.startswith("w"):
                layer[name] = layer[name] * 3.0
    if bits is not None:
        cpu_params = quantize_params(cpu_params, bits=bits)
    gpu_params = {k: ([{n: _to_cuda(t) for n, t in layer.items()}
                       for layer in v] if k == "layers" else _to_cuda(v))
                  for k, v in cpu_params.items()}
    return cpu_params, gpu_params


def _to_cuda(w):
    """A parameter on the card (a quantized weight field by field)."""
    if isinstance(w, tuple):
        return type(w)(*(t.cuda() for t in w))
    return w.cuda()


# ------------------------------------------------------------------ phase 5


@contextlib.contextmanager
def watch_logits():
    """Record, on the device and without a sync, whether every logits
    tensor the engine samples from is finite: each sample folds into one
    flag in place.  A CUDA graph captured inside the ``with`` records the
    fold, so each of its replays folds in again, after the ``with`` too:
    the flag must live as long as such a graph.  Both engines' samplers
    (the paged and the contiguous one) are watched.  Yields the flag."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import engine as contiguous, paged

    sample = paged.sample_tokens
    finite = torch.ones((), dtype=torch.bool, device="cuda")

    def watched(logits, generator, params):
        finite.logical_and_(torch.isfinite(logits).all())
        return sample(logits, generator, params)

    paged.sample_tokens = contiguous.sample_tokens = watched
    try:
        yield finite
    finally:
        paged.sample_tokens = contiguous.sample_tokens = sample


def incident_text(n_chars: int) -> str:
    line = ("event: pod payment-7f9c4 in namespace prod Back-off restarting "
            "failed container; node ip-10-0-3-7 memory pressure 93%; ")
    return (line * (n_chars // len(line) + 1))[:n_chars]


def slice_model(name: str, bits=None):
    """(config, weight transform) of a slice model: ``bits`` None keeps
    bf16 weights; 8 or 4 quantizes each weight as it is created, under
    fused_quant_matmul."""
    from k8s_llm_rca_tpu_torch.config import MODEL_REGISTRY
    from k8s_llm_rca_tpu_torch.models.quant import quantizing_transform

    cfg = MODEL_REGISTRY[name].replace(fused_quant_matmul=bits is not None)
    return cfg, None if bits is None else quantizing_transform(bits=bits)


# the depth of the models of the mesh phases (10-14, 15b-15c): at full
# depth the whole script outgrew its 1200 s once phase 14 ran beside them
# (1197 s and 1340 s on an H100 80GB HBM3 at 700 W, two runs of one
# tree); with phase 15 beside 8B at 8 layers in phases 10-13 and at full
# depth in phase 14 it took 1232 s, at 4 layers in 10-14 854 s and 1127 s
# (two cards of one kind, the host-bound phases 1.3x apart)
MESH_LAYERS = {"llama3-8b": 2, "mixtral-8x7b": 4}
# the depth of the four-rank gloo cases 12d (PP 2 x TP 2) and 13d (fsdp
# 2 x tp 2), Llama-3-8B with int4 weights
GLOO4_LAYERS = 2


def mesh_model(name: str, bits=None):
    """``slice_model`` cut to its depth in the mesh phases
    (``MESH_LAYERS``)."""
    cfg, transform = slice_model(name, bits)
    return cfg.replace(n_layers=MESH_LAYERS[name]), transform


def slice_engine_config(**over):
    """The soak engine at 8B: batch 4, max_seq_len 2560, buckets (512,
    1024, 2560), page 64, 168 pages, decode_chunk 16, greedy, 64 new
    tokens; no prefix cache unless ``over`` turns it on."""
    from k8s_llm_rca_tpu_torch.config import EngineConfig

    kw = dict(max_batch=4, max_seq_len=2560,
              prefill_buckets=(512, 1024, 2560), max_new_tokens=64,
              temperature=0.0, paged=True, page_size=64, num_pages=168,
              prefix_cache=False, decode_chunk=16)
    kw.update(over)
    return EngineConfig(**kw)


def warm_engine(engine, new_tokens: int = 33) -> dict:
    """One short request (20 tokens, 33 new: one prefill, two 16-step
    scans, no full page to cache) before a timed run, so the run does not
    pay the kernels' first launches or, graphed, the scan's capture.  An
    eager engine captures nothing: 2 new tokens (a prefill and one step)
    launch every kernel of its path.  Returns the engine's counters after
    it, to subtract."""
    engine.generate([list(range(1, 21))], max_new_tokens=new_tokens)
    return dict(engine._counts or {})


def counts_since(engine, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in engine._counts.items()}


def stamp_first_tokens(engine, stamps: list) -> None:
    """Stamp the host clock after each commit of admission first tokens."""
    drain = engine._drain_admission_commits

    def drain_stamped():
        out = drain()
        if out or engine._active:
            stamps.append(time.perf_counter())
        return out

    engine._drain_admission_commits = drain_stamped


def serve_four(engine, cfg, kv, bits, max_new: int = 64,
               warm_new: int = 33) -> dict:
    """The slice's four requests (~400, 900, 1500 and 2300 prompt tokens,
    ``max_new`` new tokens each) behind AssistantService on an engine
    warmed with ``warm_new`` new tokens (``warm_engine``): tokens, launch
    counts against the expected, TTFT, decode tok/s, total seconds."""
    import torch

    from k8s_llm_rca_tpu_torch.serve.api import (
        AssistantService, Message, RunStatus, Thread, render_prompt,
    )
    from k8s_llm_rca_tpu_torch.serve.backend import EngineBackend, GenOptions

    service = AssistantService(EngineBackend(engine))
    asst = service.create_assistant(
        "You are the root-cause analyst for a Kubernetes cluster.",
        "analyst", gen=GenOptions(max_new_tokens=max_new))
    stamps, results, prompts = [], [], {}
    step, register = engine.step, engine._register

    def recorded():
        out = step()
        results.extend(out)
        return out

    def registered(seq_id, prompt_ids):
        prompts[seq_id] = list(prompt_ids)
        register(seq_id, prompt_ids)

    runs = []
    with watch_logits() as finite:
        # warmed inside the watch: the scan graph it captures folds every
        # replay's logits into the flag, which lives with the engine
        before = warm_engine(engine, warm_new)
        draft = engine._draft
        draft_before = ((draft.prefills, draft.scan_steps)
                        if draft is not None else None)
        engine.logits_finite = finite
        stamp_first_tokens(engine, stamps)
        engine.step = recorded
        engine._register = registered
        reset_counts()
        t_submit = time.perf_counter()
        # one token per byte: the template around an empty message, + BOS
        overhead = len(render_prompt(
            asst, Thread("t", [Message("m", "user", "", 0.0)]))) + 1
        for target in (400, 900, 1500, 2300):
            thread = service.create_thread()
            service.add_message(thread.id, incident_text(target - overhead))
            runs.append(service.create_run(thread.id, asst.id))
        while any(r.status not in RunStatus.TERMINAL for r in runs):
            service.pump_once()
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = read_counts()
    c = counts_since(engine, before)
    usage = [dict(r.usage) for r in runs]
    completion = sum(u["completion_tokens"] for u in usage)
    if any(r.status != RunStatus.COMPLETED for r in runs):
        raise SystemExit(f"runs did not complete: {[r.status for r in runs]}")
    if any(u["completion_tokens"] <= 0 for u in usage):
        raise SystemExit("a reply has no tokens")
    if not bool(finite):
        raise SystemExit("non-finite logits on the slice run")
    expect = expected_counts(engine.model_cfg, c, kv is not None, bits,
                             contiguous=not engine.engine_cfg.paged,
                             cp_mode=getattr(engine, "cp_mode", None))
    if draft is not None:
        # a draft model's own launches: its re-prefills attend through
        # flash, and over quantized weights its re-prefills and scan steps
        # run the kn matmuls and the head
        drafted = expected_counts(draft.cfg, {
            "engine.prefill_dispatches": draft.prefills - draft_before[0],
            "engine.decode_steps": draft.scan_steps - draft_before[1]},
            False, bits, contiguous=True)
        for k, n in drafted.items():
            expect[k] += n
    if getattr(engine, "_draft_agree", None) is not None:
        # under a mesh its drafts are broadcast once a verify tick
        expect["broadcast"] += int(c.get("engine.verify_steps", 0))
    if counts != expect:
        raise SystemExit(f"launch counts {counts} != expected {expect}")
    return {"tokens": [r.token_ids for r in
                       sorted(results, key=lambda r: r.seq_id)],
            "prompts": [prompts[r.seq_id] for r in
                        sorted(results, key=lambda r: r.seq_id)],
            "prompt_tokens": [u["prompt_tokens"] for u in usage],
            "completion_tokens": [u["completion_tokens"] for u in usage],
            "launches": counts, "expected_launches": expect,
            "prefill_dispatches": int(c["engine.prefill_dispatches"]),
            "decode_steps": int(c["engine.decode_steps"]),
            "dispatches": int(c["engine.dispatches"]),
            **{k.split(".")[1]: int(c.get(k, 0)) for k in (
                "engine.verify_steps", "engine.spec_drafted",
                "engine.spec_accepted", "engine.decode_tokens",
                "engine.d2h_syncs", "engine.h2d_uploads")},
            "ttft_s": stamps[0] - t_submit,
            "decode_tok_per_s": (completion - len(runs)) / (t_end - stamps[0]),
            "total_s": t_end - t_submit}


def decode_step_fn(engine, verify_t: int = 0):
    """The engine's own decode step (its static operands, then the eager
    step or the step graph's replay) at the slice's decode shapes: batch 4
    at 400/900/1500/2300 cached tokens over pages of the engine's pool;
    with ``verify_t`` the speculative verify step of T = ``verify_t``
    tokens a slot (``paged_decode_multi``, its graph) at 400/900/1500/
    2290.  Returns the step as a function of no arguments."""
    import numpy as np

    from k8s_llm_rca_tpu_torch.engine.paged import (
        paged_decode_multi, paged_decode_step,
    )

    # the verify step's T writes must fit the slot's current page (the
    # engine's _spec_room_ok): its longest slot sits at 2290, not 2300
    lens = [400, 900, 1500, 2290 if verify_t else 2300]
    engine.lengths[:] = lens
    engine.cur_tokens[:] = 0
    engine.block_tables[:] = 0
    used = 1
    for i, n in enumerate(lens):
        assert not verify_t or engine._spec_room_ok(i, verify_t)
        n_p = -(-(n + max(1, verify_t)) // engine.page_size)
        engine.block_tables[i, :n_p] = range(used, used + n_p)
        used += n_p
    cfg, params, pool = engine.model_cfg, engine.params, engine.pool

    def step():
        cur, lengths, tables = engine._device_state()
        return engine._decode(("step",), lambda: paged_decode_step(
            cfg, params, pool, cur, lengths, tables)[1])

    if verify_t:
        drafts = np.zeros((len(lens), verify_t), np.int32)
        n_pages = engine._verify_pages(range(len(lens)), verify_t)

        def step():                                   # noqa: F811
            toks = engine._multi_tokens_buffer(drafts)
            lengths = engine._upload(1, engine.lengths)
            tables = engine._upload(2, engine.block_tables)
            return engine._decode(
                ("multi", verify_t, n_pages), lambda: paged_decode_multi(
                    cfg, params, pool, toks, lengths, tables, n_pages)[1:])

    return step


# seconds the host waits, with the card idle, after the profiler opens its
# active window and before it closes it (ROADMAP Queue 3, fault 6, open):
# one profile of an eager step saw 221 of the 224 kn4 launches its
# counters gained (the first layer's wq, wk and wv).  The cause is not
# known (another profile kept a kernel stamped 0.4 ms before the window's
# start); the guard puts the step's kernels well inside the window.
# ``tools/profile_window.py`` profiles that step over and over with the
# guard and without it.
PROFILE_GUARD_S = 0.02


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profile_step(step) -> dict:
    """One profiled call of ``step`` after a discarded warm-up call under
    the same profiler (a profile started cold missed an eager step's first
    kernels: ROADMAP Queue 3, fault 6), with ``PROFILE_GUARD_S`` of idle
    host time at both ends of the active window.  Returns the step's kernel events
    (``key_averages``, the schedule's ``ProfilerStep*`` range left out: it
    carries the whole step's device time), the launch counters' gain over
    the profiled call, and the gaps, in microseconds, from the window's
    start to its first kernel and from its last kernel's end to the
    window's end."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_GUARD_S)
        counted = read_counts()
        step()
        torch.cuda.synchronize()
        time.sleep(PROFILE_GUARD_S)
        prof.step()
    gain = {k: v - counted[k] for k, v in read_counts().items()}
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0
              and not e.key.startswith("ProfilerStep")]
    window = [e for e in prof.events() if e.name.startswith("ProfilerStep")
              and not str(e.device_type).endswith("CUDA")]
    kernels = [e for e in prof.events()
               if str(e.device_type).endswith("CUDA")
               and not e.name.startswith("ProfilerStep")]
    gaps = {"first_kernel_us": None, "last_kernel_us": None}
    if window and kernels:
        w0 = min(e.time_range.start for e in window)
        w1 = max(e.time_range.end for e in window)
        gaps = {"first_kernel_us": min(e.time_range.start
                                       for e in kernels) - w0,
                "last_kernel_us": w1 - max(e.time_range.end
                                           for e in kernels)}
    return {"events": events, "gain": gain, **gaps}


def decode_step_times(engine, steps: int = 8, verify_t: int = 0,
                      profiled: bool = True) -> dict:
    """The engine's own decode step (``decode_step_fn``) at the slice's
    decode shapes.  Wall ms per step over ``steps`` steps, the device ms
    and kernel launches of one profiled step (``profile_step``), and the
    device's busy share: that device time over the unprofiled wall time
    (the profiler's own host work would stretch a profiled step).
    ``profiled=False`` skips the profile: wall ms and the CUDA events'
    device ms only."""
    import torch

    step = decode_step_fn(engine, verify_t)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    if not profiled:
        # the mesh phases: the device time between CUDA events only
        return {"wall_ms_per_step": wall_ms,
                "event_device_ms_per_step": time_ms(step, steps)}
    prof = profile_step(step)
    events = prof["events"]
    device_ms = sum(dev_us(e) for e in events) / 1e3
    seen = profiled_launches(events)
    want = counted_launches(prof["gain"])
    # the device time between CUDA events around the step, the host's
    # enqueue covered by a device sleep (``time_ms``): it needs no trace
    events_ms = time_ms(step, steps)
    mode = "eager" if engine.graphs is None else "graphed"
    if verify_t:
        # the verify graph holds more nodes than the plain step's, and
        # the profiler reported only some of a replay's kernels there
        # (11 of 32 flash calls in one run): its device time comes from
        # the events, and its profile may show fewer port kernels than
        # counted, never more, and none that was not counted
        if any(n > want.get(k, 0) for k, n in seen.items()) \
                or set(want) - set(seen):
            raise SystemExit(f"one {mode} verify step: the profiler saw "
                             f"the port's kernels {seen}, the launch "
                             f"counters gained {want}")
        device_ms = events_ms
    elif seen != want:
        raise SystemExit(f"one {mode} decode step: the profiler saw the "
                         f"port's kernels {seen}, the launch counters "
                         f"gained {want} (window gaps: first kernel "
                         f"{prof['first_kernel_us']} us, last "
                         f"{prof['last_kernel_us']} us)")
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "event_device_ms_per_step": events_ms,
            "kernels_per_step": sum(e.count for e in events),
            "port_kernels_per_step": seen, "counted_per_step": want,
            "device_busy_share": device_ms / wall_ms,
            "profile_first_kernel_us": prof["first_kernel_us"],
            "profile_last_kernel_us": prof["last_kernel_us"]}


# a port kernel's name in a profile (demangled ``kn_gemv_mma_kernel<4,
# ...`` or mangled ``kn_gemv_mma_kernelILi4E...``): its body and, for the
# matmuls, the weight bits (the first template argument)
PORT_KERNEL = re.compile(r"(?<![A-Za-z_])(paged_decode_kernel"
                         r"|flash_(?:fma|wgmma)_kernel|kn_\w*?kernel"
                         r"|nk_(?:mma_)?kernel)(?:(?:<|ILi)(\d+))?")


def profiled_launches(events) -> dict:
    """The port's kernels among a profile's CUDA events, one count per
    wrapper call: paged attention (bf16 or quantized pools), flash, and the
    kn (dense and expert) and nk (head) matmuls by weight bits.  The kn
    split-K reduction follows its body in the same call, so it is not
    counted."""
    seen = {}
    for e in events:
        m = PORT_KERNEL.search(e.key)
        if m is None or m.group(1) == "kn_reduce_kernel":
            continue
        body = m.group(1)
        group = ("paged" if body == "paged_decode_kernel" else
                 "flash" if body.startswith("flash_") else
                 f"{body[:2]}{m.group(2)}")
        seen[group] = seen.get(group, 0) + e.count
    return seen


def counted_launches(gain: dict) -> dict:
    """The launch counters' gain, in ``profiled_launches``' groups."""
    want = {"paged": gain["paged"] + gain["paged_quant"],
            "flash": gain["flash"],
            "kn4": gain["qmm"] + gain["qmm_experts"],
            "kn8": gain["qmm8"] + gain["qmm_experts8"],
            "nk4": gain["qmm_head"], "nk8": gain["qmm_head8"]}
    return {k: v for k, v in want.items() if v}


def roofline_fields(cfg, run: dict, bits=None, kv=None) -> dict:
    """A served run against the analytic model (``runtime/profiling.py``,
    the card's peaks): the MFU of its decode tok/s at the run's mean
    decode context, that tok/s as a share of ``roofline_decode_tps`` at
    the batch of four, and the least time the four prefills could take
    (each prompt over ``roofline_prefill_tps``) as a share of the TTFT,
    which covers them all.  Reported, not gated."""
    from k8s_llm_rca_tpu_torch.runtime import profiling

    prompts, comp = run["prompt_tokens"], run["completion_tokens"]
    ctx = int(statistics.mean(p + c / 2 for p, c in zip(prompts, comp)))
    kv_bits = {None: 16, "int8": 8, "int4": 4}[kv]
    roof = profiling.roofline_decode_tps(cfg, ctx, len(prompts), bits or 16,
                                         kv_bits)
    prefill_s = sum(p / profiling.roofline_prefill_tps(cfg, p)
                    for p in prompts)
    return {"mfu": profiling.mfu(cfg, run["decode_tok_per_s"], ctx),
            "roofline_context": ctx, "decode_roofline_tok_per_s": roof,
            "decode_roofline_share": run["decode_tok_per_s"] / roof,
            "ttft_roofline_s": prefill_s,
            "ttft_roofline_share": prefill_s / run["ttft_s"]}


def phase_slice(phase: str, name: str, bits=None, kv=None) -> dict:
    """A slice model behind AssistantService, four requests, served eagerly
    (``cuda_graphs=False``) and then through the engine's CUDA graphs, on
    the same weights: Llama-3-8B in bf16 (phase 5) or int4 with an int4
    pool (5b), Mixtral-8x7B in int8 with an int8 pool (5c) or int4 with an
    int4 pool (5d).  The two runs' greedy tokens must be equal.  Returns
    the graphed run's launch counts."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, transform = slice_model(name, bits)
    ecfg = slice_engine_config(kv_cache_dtype=kv)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    runs = {}
    for mode, graphs in (("eager", False), ("graphed", True)):
        engine = make_engine(cfg, ecfg, params, tok, cuda_graphs=graphs)
        run = serve_four(engine, cfg, kv, bits)
        run.update(graph_stats(engine))
        run.update(decode_step_times(engine))
        runs[mode] = run
        del engine
        free_card()
    eager, graphed = runs["eager"], runs["graphed"]
    same = eager["tokens"] == graphed["tokens"]
    emit(phase, model=cfg.name, layers=cfg.n_layers,
         weights=f"int{bits}" if bits else "bfloat16",
         kv_cache_dtype=kv, fused_quant_matmul=cfg.fused_quant_matmul,
         prompt_tokens=graphed["prompt_tokens"],
         completion_tokens=graphed["completion_tokens"],
         equal_tokens=same, init_s=init_s,
         **{f"{mode}_{k}": v for mode, run in runs.items()
            for k, v in run.items() if k not in ("tokens", "prompts")},
         **{f"{mode}_{k}": v for mode, run in runs.items()
            for k, v in roofline_fields(cfg, run, bits, kv).items()},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         nvidia_smi=nvidia_smi_name_power())
    if not same:
        raise SystemExit(f"{phase}: eager and graphed tokens differ")
    if not graphed["graph_replays"]:
        raise SystemExit(f"{phase}: the graphed engine replayed nothing")
    out = {phase: graphed["launches"]}
    if cfg.n_experts == 0:
        out[phase + "_spec"] = speculative_runs(phase, cfg, ecfg, params,
                                                tok, kv, bits, graphed)
    return out


def common_share(want: list, got: list) -> float:
    """The share of ``want``'s tokens that ``got`` repeats before the two
    streams part, over all sequences."""
    same = 0
    for a, b in zip(want, got):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        same += n
    return same / max(1, sum(len(a) for a in want))


def speculative_runs(phase, cfg, ecfg, params, tok, kv, bits,
                     graphed) -> dict:
    """The Llama slices' engine features on the same weights, graphed:
    the four requests with ``speculative_k`` 4 (drafts, acceptance,
    tokens per dispatch, the verify step's wall and device ms beside the
    decode step's), then at ``decode_chunk`` 1 with ``host_overlap`` off
    and on (decode tok/s, device syncs per token).  bf16 verification
    takes other matmul and attention shapes than the plain step, so its
    tokens may part from the plain run's at a near-tie: the phase reports
    the share of tokens before the streams part.  Returns the speculative
    run's launch counts."""
    import dataclasses

    from k8s_llm_rca_tpu_torch.engine import make_engine

    engine = make_engine(cfg, dataclasses.replace(ecfg, speculative_k=4),
                         params, tok)
    spec = serve_four(engine, cfg, kv, bits)
    spec.update(graph_stats(engine))
    spec.update({f"verify_{k}": v for k, v in
                 decode_step_times(engine, verify_t=5).items()})
    del engine
    free_card()
    if not spec["verify_steps"]:
        raise SystemExit(f"{phase}: speculative_k 4 verified nothing")
    chunk1 = {}
    for overlap in (False, True):
        engine = make_engine(cfg, dataclasses.replace(
            ecfg, decode_chunk=1, host_overlap=overlap), params, tok)
        run = serve_four(engine, cfg, kv, bits)
        run.update(graph_stats(engine))
        chunk1["overlap" if overlap else "plain"] = run
        del engine
        free_card()
    emit(phase + "_spec", model=cfg.name,
         weights=f"int{bits}" if bits else "bfloat16", kv_cache_dtype=kv,
         speculative_k=4,
         equal_token_share=common_share(graphed["tokens"], spec["tokens"]),
         tokens_per_dispatch=spec["decode_tokens"] / spec["dispatches"],
         graphed_step_wall_ms=graphed["wall_ms_per_step"],
         graphed_step_device_ms=graphed["device_ms_per_step"],
         **{f"spec_{k}": v for k, v in spec.items()
            if k not in ("tokens", "prompts")},
         **{f"chunk1_{mode}_{k}": v for mode, run in chunk1.items()
            for k, v in run.items() if k not in ("tokens", "prompts")},
         chunk1_d2h_per_token={
             mode: run["d2h_syncs"] / max(1, run["decode_tokens"])
             for mode, run in chunk1.items()},
         overlap_equal_tokens=(chunk1["plain"]["tokens"]
                               == chunk1["overlap"]["tokens"]),
         nvidia_smi=nvidia_smi_name_power())
    return spec["launches"]


def prefix_prompts(tok) -> list:
    """Four prompts sharing exactly 1536 tokens (24 pages of 64), BOS
    included, with tails of 400, 550, 700 and 800 tokens."""
    import random

    rng = random.Random(0)
    shared = incident_text(1535)
    tails = ["".join(rng.choice("abcdefghij klmnop") for _ in range(n))
             for n in (400, 550, 700, 800)]
    prompts = [tok.encode(shared + t, add_bos=True) for t in tails]
    head = tok.encode(shared, add_bos=True)
    assert len(head) == 1536 and all(p[:1536] == head for p in prompts)
    return prompts


def phase_prefix() -> dict:
    """Phase 5e: Llama-3-8B bf16 on the soak engine with the prefix cache
    on (the port's default), graphed.  Four requests share a 1536-token
    prefix: one goes alone, then the other three together, which hit its
    24 pages (one batched chunk prefill of their suffixes).  Then the same
    four on a fresh engine with ``prefill_chunk_budget`` 512, and on one
    with the prefix cache off (every wave a flash miss), the yardstick of
    the cache's TTFT.  Prints each wave's TTFT and the prefix and chunk
    counters; launches exact."""
    import torch

    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = LLAMA3_8B
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    prompts = prefix_prompts(tok)
    out = {}
    for cached, budget in ((True, 0), (True, 512), (False, 0)):
        engine = make_engine(cfg, slice_engine_config(
            prefix_cache=cached, prefill_chunk_budget=budget), params, tok)
        before = warm_engine(engine)
        stamps = []
        stamp_first_tokens(engine, stamps)
        reset_counts()
        ttft, tokens = [], []
        for wave in (prompts[:1], prompts[1:]):
            stamps.clear()
            t0 = time.perf_counter()
            ids = [engine.submit(p) for p in wave]
            res = {r.seq_id: r for r in engine.run_to_completion()}
            ttft.append(stamps[0] - t0)
            tokens += [res[i].token_ids for i in ids]
        torch.cuda.synchronize()
        counts = read_counts()
        c = counts_since(engine, before)
        expect = expected_counts(cfg, c, False)
        run = {"ttft_s": ttft,
               "prefix_hit_tokens": int(c.get("engine.prefix_hit_tokens",
                                              0)),
               "prefix_batch_hit_admissions": int(c.get(
                   "engine.prefix_batch_hit_admissions", 0)),
               "prefill_chunks": int(c.get("engine.prefill_chunks", 0)),
               "prefill_dispatches": int(c.get("engine.prefill_dispatches",
                                               0)),
               "chunk_prefill_dispatches": int(c.get(
                   "engine.chunk_prefill_dispatches", 0)),
               "decode_steps": int(c.get("engine.decode_steps", 0)),
               "launches": counts, "expected_launches": expect,
               **graph_stats(engine)}
        out[cached, budget] = (run, tokens)
        emit("prefix", model=cfg.name, prefix_cache=cached,
             prefill_chunk_budget=budget,
             prompt_tokens=[len(p) for p in prompts],
             completion_tokens=[len(t) for t in tokens], **run,
             nvidia_smi=nvidia_smi_name_power())
        label = f"prefix phase (cache {cached}, budget {budget})"
        if run["prefix_hit_tokens"] != (3 * 1536 if cached else 0):
            raise SystemExit(f"{label}: {run['prefix_hit_tokens']} hit "
                             f"tokens")
        if (cached and budget == 0
                and run["prefix_batch_hit_admissions"] != 3):
            raise SystemExit(f"{label}: the three hits did not admit as "
                             f"one batch")
        if counts != expect:
            raise SystemExit(f"{label}: launch counts {counts} != expected "
                             f"{expect}")
        del engine
        free_card()
    emit("prefix", model=cfg.name,
         chunked_tokens_equal=out[True, 512][1] == out[True, 0][1],
         uncached_tokens_equal=out[False, 0][1] == out[True, 0][1])
    counts = dict(out[True, 0][0]["launches"])
    for tier in ("l1", "l2"):
        for k, v in prefix_tier_run(cfg, params, tok, prompts, tier,
                                    out[True, 0][1]).items():
            counts[k] += v
        free_card()
    return counts


# the PCIe Gen5 x16 host link of an H100 SXM, one direction (bytes/s)
PCIE_BYTES_PER_S = 64e9


@contextlib.contextmanager
def watch_page_moves(moves: list):
    """Time every page gather and restore the engines make: the card
    synchronised before each, the host clock around it (a gather ends in
    its own sync, a restore is followed by one).  Each restore's pages are
    held byte-equal (``torch.equal``) to the record it wrote, after the
    timed window.  Appends (kind, pages, bytes, seconds, equal, seconds
    the check took) to ``moves``."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import paged
    from k8s_llm_rca_tpu_torch.utils.pages import pool_fields, record_nbytes

    gather, restore = paged.gather_pages, paged.restore_pages

    def timed_gather(pool, fetch, ids):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = gather(pool, fetch, ids)
        moves.append(("gather", len(ids), record_nbytes(rec),
                      time.perf_counter() - t0, True, 0.0))
        return rec

    def timed_restore(pool, rec, ids):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = restore(pool, rec, ids)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        equal = all(torch.equal(getattr(pool, f)[:, list(ids)].cpu(),
                                rec[f].cpu()) for f in pool_fields(pool))
        moves.append(("restore", len(ids), record_nbytes(rec), t1 - t0,
                      equal, time.perf_counter() - t1))
        return out

    paged.gather_pages, paged.restore_pages = timed_gather, timed_restore
    try:
        yield moves
    finally:
        paged.gather_pages, paged.restore_pages = gather, restore


def move_stats(moves: list, kind: str) -> dict:
    """Pages, bytes, seconds and GB/s of one kind of page move, beside the
    least time the PCIe link could take for those bytes."""
    sel = [m for m in moves if m[0] == kind]
    nbytes = sum(m[2] for m in sel)
    secs = sum(m[3] for m in sel)
    return {f"{kind}_calls": len(sel), f"{kind}_pages": sum(m[1] for m in sel),
            f"{kind}_bytes": nbytes, f"{kind}_ms": secs * 1e3,
            f"{kind}_gb_per_s": nbytes / secs / 1e9 if secs else None,
            f"{kind}_pcie_bound_ms": nbytes / PCIE_BYTES_PER_S * 1e3,
            f"{kind}_equal": all(m[4] for m in sel)}


def prefix_tier_run(cfg, params, tok, prompts, tier: str,
                    l0_tokens: list) -> dict:
    """Phase 5e's tiers: the lone prompt admits (a miss), then every
    resident page is evicted into the store (``prefix_host_pages`` 64: host
    RAM, L1; 0 with a disk directory: L2, one fsynced file per page), and
    the three batched hits come back from the promoted pages.  Tokens must
    equal the L0-hit run's.  Prints the hits' TTFT, the pages promoted, the
    bytes restored and the promotion scatter's GB/s, the demotion's gather
    and, for L2, the write seconds per page.  Returns the launch counts."""
    import tempfile

    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine

    with tempfile.TemporaryDirectory() as d:
        store = ({"prefix_host_pages": 64} if tier == "l1"
                 else {"prefix_host_pages": 0, "prefix_disk_dir": d})
        engine = make_engine(cfg, slice_engine_config(prefix_cache=True,
                                                      **store), params, tok)
        before = warm_engine(engine)
        stamps, moves, ttft, tokens = [], [], [], []
        stamp_first_tokens(engine, stamps)
        reset_counts()
        with watch_page_moves(moves):
            for i, wave in enumerate((prompts[:1], prompts[1:])):
                if i:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    demoted = engine.prefix_cache.evict(10 ** 6)
                    evict_s = time.perf_counter() - t0
                stamps.clear()
                checked = sum(m[5] for m in moves)
                t0 = time.perf_counter()
                ids = [engine.submit(p) for p in wave]
                res = {r.seq_id: r for r in engine.run_to_completion()}
                # the promotion's byte check ran before the first token
                ttft.append(stamps[0] - t0
                            - (sum(m[5] for m in moves) - checked))
                tokens += [res[i].token_ids for i in ids]
        torch.cuda.synchronize()
        counts = read_counts()
        c = counts_since(engine, before)
        engine.allocator.check()
        expect = expected_counts(cfg, c, False)
        run = {"ttft_s": ttft, "demoted_pages": demoted, "evict_s": evict_s,
               **{k.split(".")[1]: int(c.get(k, 0)) for k in (
                   "engine.prefix_hits_l0", "engine.prefix_hits_l1",
                   "engine.prefix_hits_l2", "engine.prefix_promoted_pages",
                   "engine.prefix_bytes_restored",
                   "engine.prefix_hit_tokens",
                   "engine.prefix_batch_hit_admissions")},
               **move_stats(moves, "gather"), **move_stats(moves, "restore"),
               "allocator": type(engine.allocator).__name__,
               "launches": counts, "expected_launches": expect,
               **graph_stats(engine)}
        if tier == "l2":
            run["l2_write_s_per_page"] = evict_s / max(1, demoted)
        same = tokens == l0_tokens
        emit("prefix_tiers", model=cfg.name, tier=tier,
             prefix_host_pages=store["prefix_host_pages"],
             disk=tier == "l2", equal_tokens_to_l0=same, **run,
             nvidia_smi=nvidia_smi_name_power())
        label = f"prefix tiers ({tier})"
        if not same:
            raise SystemExit(f"{label}: tokens differ from the L0 hits'")
        if not run[f"prefix_hits_{tier}"] or not run["restore_equal"]:
            raise SystemExit(f"{label}: no page promoted, or a restored "
                             f"page differs from its record")
        if counts != expect:
            raise SystemExit(f"{label}: launch counts {counts} != expected "
                             f"{expect}")
        if run["allocator"] != "NativePageAllocator":
            raise SystemExit(f"{label}: {run['allocator']} in use")
        del engine
    return counts


def card_divergence(cfg, params, prompt, a, b) -> dict:
    """Where two greedy streams of one prompt part (``first_divergence``
    on the card: its bf16 prefill of prompt + the common tokens)."""
    import torch

    from k8s_llm_rca_tpu_torch.models.llama import prefill_kv

    j = next(k for k in range(min(len(a), len(b))) if a[k] != b[k])
    ctx = list(prompt) + list(a[:j])
    padded = torch.zeros((1, -(-len(ctx) // 64) * 64), dtype=torch.int32,
                         device=params["final_norm"].device)
    padded[0, :len(ctx)] = torch.tensor(ctx, dtype=torch.int32)
    _, _, logits = prefill_kv(cfg, params, padded, len(ctx))
    return {"seq": None, "token": j, "a": a[j], "b": b[j],
            "logit_margin": abs(float(logits[0, a[j]] - logits[0, b[j]]))}


def divergences(cfg, params, prompts, want, got) -> list:
    """``card_divergence`` of every sequence whose streams part."""
    out = []
    for i, (a, b) in enumerate(zip(want, got)):
        n = min(len(a), len(b))
        if a[:n] != b[:n]:
            out.append(dict(card_divergence(cfg, params, prompts[i], a, b),
                            seq=i))
    return out


def page_record_round_trip(engine, gen) -> bool:
    """Four pages of random bytes through gather -> host -> encode ->
    decode -> restore into four other page ids of the engine's pool:
    byte-equal (``torch.equal``)."""
    import torch

    from k8s_llm_rca_tpu_torch.utils import pages

    pool = engine.pool
    ids = engine.allocator.alloc(8, owner=-7)
    src, dst = ids[:4], ids[4:]
    for f in pages.pool_fields(pool):
        t = getattr(pool, f)
        t[:, src] = torch.randint(-100, 100, t[:, src].shape,
                                  device=t.device, generator=gen).to(t.dtype)
    rec = pages.gather_pages(pool, pages.to_host, src)
    back = pages.stack_pages(
        [pages.decode_page_record(pages.encode_page_record(r))
         for r in pages.split_pages(rec)], pin=pool.k.is_cuda)
    pages.restore_pages(pool, back, dst)
    torch.cuda.synchronize()
    equal = all(torch.equal(getattr(pool, f)[:, dst], getattr(pool, f)[:, src])
                for f in pages.pool_fields(pool))
    engine.allocator.free(ids, owner=-7)
    return equal


def gather_twice(engine, n_pages: int) -> dict:
    """Two gathers of the same ``n_pages`` pages, the first record freed
    before the second: the first pays a fresh pinned host block, the
    second reuses it from the caching host allocator, so the two times
    split allocation from the copy."""
    import torch

    from k8s_llm_rca_tpu_torch.utils import pages

    ids = engine.allocator.alloc(n_pages, owner=-7)
    out = {}
    for name in ("first", "second"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = pages.gather_pages(engine.pool, pages.to_host, ids)
        out[f"gather_{name}_ms"] = (time.perf_counter() - t0) * 1e3
        nbytes = pages.record_nbytes(rec)
        del rec
    engine.allocator.free(ids, owner=-7)
    out["gather_twice_bytes"] = nbytes
    out["gather_second_gb_per_s"] = nbytes / out["gather_second_ms"] / 1e6
    return out


def memory_prompts(tok) -> list:
    """The slice's four prompts (~400, 900, 1500 and 2300 tokens, BOS
    included)."""
    return [tok.encode(incident_text(n - 1), add_bos=True)
            for n in (400, 900, 1500, 2300)]


def phase_memory(phase: str, name: str, bits=None, kv=None) -> dict:
    """Phase 7: the slice's engine (batch 4, page 64, 168 pages,
    decode_chunk 16, graphed) at full depth and width serves the four
    prompts uninterrupted, then under a FaultPlan that preempts the
    youngest sequence at tick 2 with spill on (its pages gather to pinned
    host memory and come back by an in-place restore) and with spill off
    (re-prefill).  Prints spilled and restored pages, the gather and
    restore ms and GB/s against the PCIe bound, TTFT and total s, and each
    run's token agreement with the uninterrupted run (share before the
    streams part; the logit margin where they part).  Requires restored
    pages byte-equal to the gathered record, a page-record round trip
    through the disk codec byte-equal, the native allocator, its check
    clean after every run, and exact launches.  For bf16 also a snapshot
    mid-decode restored into a fresh engine on the same store.  Returns
    the summed launch counts."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.faults import inject
    from k8s_llm_rca_tpu_torch.faults.plan import Fault, FaultPlan
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, transform = slice_model(name, bits)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    prompts = memory_prompts(tok)
    gen = torch.Generator(device="cuda").manual_seed(3)
    total = {k: 0 for k in launch_counters()}
    runs = {}
    for mode, spill in (("uninterrupted", 0), ("spill", 168),
                        ("re_prefill", 0)):
        engine = make_engine(cfg, slice_engine_config(
            kv_cache_dtype=kv, max_spilled_pages=spill), params, tok)
        before = warm_engine(engine)
        stamps, moves = [], []
        stamp_first_tokens(engine, stamps)
        plan = FaultPlan([] if mode == "uninterrupted" else
                         [Fault(inject.SITE_ENGINE_TICK, 2, "preempt")])
        reset_counts()
        t0 = time.perf_counter()
        with watch_page_moves(moves), inject.armed(plan):
            res = engine.generate(prompts)
        torch.cuda.synchronize()
        # the restores' byte checks are not the engine's work
        check_s = sum(m[5] for m in moves)
        total_s = time.perf_counter() - t0 - check_s
        counts = read_counts()
        c = counts_since(engine, before)
        engine.allocator.check()
        expect = expected_counts(cfg, c, kv is not None, bits)
        run = {"tokens": [r.token_ids for r in res],
               "ttft_s": stamps[0] - t0, "total_s": total_s,
               "check_s": check_s,
               **{k.split(".")[1]: int(c.get(k, 0)) for k in (
                   "engine.preemptions", "engine.spilled_pages",
                   "engine.restored_pages", "engine.prefill_dispatches",
                   "engine.prefill_tokens", "engine.decode_steps")},
               **move_stats(moves, "gather"), **move_stats(moves, "restore"),
               "allocator": type(engine.allocator).__name__,
               "launches": counts, "expected_launches": expect,
               **graph_stats(engine)}
        if mode == "spill":
            run["round_trip_equal"] = page_record_round_trip(engine, gen)
            run.update(gather_twice(engine, run["spilled_pages"]))
            engine.allocator.check()
        runs[mode] = run
        for k, v in counts.items():
            total[k] += v
        label = f"{phase} ({mode})"
        if counts != expect:
            raise SystemExit(f"{label}: launch counts {counts} != expected "
                             f"{expect}")
        if run["allocator"] != "NativePageAllocator":
            raise SystemExit(f"{label}: {run['allocator']} in use")
        del engine
        free_card()
    base = runs["uninterrupted"]["tokens"]
    for mode in ("spill", "re_prefill"):
        run = runs[mode]
        run["equal_token_share"] = common_share(base, run["tokens"])
        run["divergences"] = divergences(cfg, params, prompts, base,
                                         run["tokens"])
    spill = runs["spill"]
    if not (spill["restored_pages"] and spill["restored_pages"]
            == spill["spilled_pages"] and spill["restore_equal"]
            and spill["round_trip_equal"]):
        raise SystemExit(f"{phase}: spill/restore check failed: "
                         f"{ {k: spill[k] for k in ('spilled_pages', 'restored_pages', 'restore_equal', 'round_trip_equal')} }")
    if runs["re_prefill"]["spilled_pages"] or not runs["re_prefill"][
            "preemptions"]:
        raise SystemExit(f"{phase}: the re-prefill run did not re-prefill")
    snap = (memory_snapshot(cfg, params, tok, prompts, base, total)
            if bits is None else None)
    emit(phase, model=cfg.name, weights=f"int{bits}" if bits else "bfloat16",
         kv_cache_dtype=kv, prompt_tokens=[len(p) for p in prompts],
         **{f"{mode}_{k}": v for mode, run in runs.items()
            for k, v in run.items() if k != "tokens"},
         snapshot=snap, nvidia_smi=nvidia_smi_name_power())
    return total


def memory_snapshot(cfg, params, tok, prompts, base, total) -> dict:
    """An engine with the prefix cache and a 256-page host store decodes
    the four prompts for two ticks, snapshots (publishing its sequences'
    written pages into the store) and is dropped; a fresh engine on the
    same store restores the snapshot and finishes.  Returns TTFT of the
    restored sequences, pages promoted against tokens re-prefilled, and
    the token agreement with the uninterrupted run; adds its launches to
    ``total``."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine

    ecfg = slice_engine_config(prefix_cache=True, prefix_host_pages=256)
    first = make_engine(cfg, ecfg, params, tok)
    before = warm_engine(first)
    reset_counts()
    for p in prompts:
        first.submit(p)
    first.step()
    first.step()
    t0 = time.perf_counter()
    snap = first.snapshot_sequences()
    snapshot_s = time.perf_counter() - t0
    published = int(first._counts.get("engine.prefix_snapshot_published", 0))
    counts = read_counts()
    expect = expected_counts(cfg, counts_since(first, before), False)
    store = first.prefix_store
    del first
    free_card()
    fresh = make_engine(cfg, ecfg, params, tok, prefix_store=store)
    before = warm_engine(fresh)
    stamps = []
    stamp_first_tokens(fresh, stamps)
    reset_counts()
    t0 = time.perf_counter()
    fresh.restore_sequences(snap)
    res = {r.seq_id: r.token_ids for r in fresh.run_to_completion()}
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts2 = read_counts()
    c = counts_since(fresh, before)
    fresh.allocator.check()
    expect2 = expected_counts(cfg, c, False)
    tokens = [res[i] for i in sorted(res)]
    out = {"published_pages": published, "snapshot_s": snapshot_s,
           "ttft_s": stamps[0] - t0, "total_s": total_s,
           "promoted_pages": int(c.get("engine.prefix_promoted_pages", 0)),
           "prefix_hit_tokens": int(c.get("engine.prefix_hit_tokens", 0)),
           "reprefilled_tokens": int(c.get("engine.prefill_tokens", 0)),
           "equal_token_share": common_share(base, tokens),
           "launches": counts2, "expected_launches": expect2}
    for k in total:
        total[k] += counts[k] + counts2[k]
    if counts != expect or counts2 != expect2:
        raise SystemExit(f"memory snapshot: launch counts {counts} / "
                         f"{counts2} != expected {expect} / {expect2}")
    if not out["promoted_pages"]:
        raise SystemExit("memory snapshot: no published page was promoted")
    del fresh
    free_card()
    return out


@contextlib.contextmanager
def watch_grammars(kinds: dict, host_s: list):
    """Tally the grammar class each run's ``GenOptions.grammar`` compiles
    to, and add up the host seconds the engine spends building the
    stepwise ticks' constraints and, on verify ticks, applying them to
    each position's logits (the interpreted grammars' masks)."""
    from k8s_llm_rca_tpu_torch.engine.engine import EngineBase
    from k8s_llm_rca_tpu_torch.engine.paged import PagedInferenceEngine
    from k8s_llm_rca_tpu_torch.serve import backend

    make = backend.make_grammar
    constraints = PagedInferenceEngine._tick_constraints
    greedy = EngineBase._greedy_with_grammar

    def counted(spec, tokenizer, **kw):
        g = make(spec, tokenizer, **kw)
        if g is not None:
            name = type(g).__name__
            kinds[name] = kinds.get(name, 0) + 1
        return g

    def timer(fn):
        def timed(self, *args):
            t0 = time.perf_counter()
            try:
                return fn(self, *args)
            finally:
                host_s[0] += time.perf_counter() - t0
        return timed

    backend.make_grammar = counted
    PagedInferenceEngine._tick_constraints = timer(constraints)
    EngineBase._greedy_with_grammar = timer(greedy)
    try:
        yield kinds
    finally:
        backend.make_grammar = make
        PagedInferenceEngine._tick_constraints = constraints
        EngineBase._greedy_with_grammar = greedy


@contextlib.contextmanager
def watch_cypher(parsed: list, refused: list):
    """Count the cypher stages whose reply decoded and parsed, and those
    refused before decoding: when the prompt leaves a budget below the
    skeleton grammar's minimal document, the backend raises
    ``BudgetError`` and the pipeline falls back to the compiled query
    without a reply (the JAX pipeline's rule), so attempt counts alone do
    not show a parse."""
    from k8s_llm_rca_tpu_torch.rca import cyphergen
    from k8s_llm_rca_tpu_torch.serve.backend import BudgetError

    submit = cyphergen.submit_cypher_query
    parse = cyphergen.parse_cypher_query

    def submitted(*args, **kwargs):
        try:
            return submit(*args, **kwargs)
        except BudgetError:
            refused[0] += 1
            raise

    def counted(generator, run):
        query = parse(generator, run)
        parsed[0] += 1
        return query

    cyphergen.submit_cypher_query = submitted
    cyphergen.parse_cypher_query = counted
    try:
        yield
    finally:
        cyphergen.submit_cypher_query = submit
        cyphergen.parse_cypher_query = parse


def stage_replies_parse(report: dict, cypher_parsed: int,
                        cypher_refused: int) -> bool:
    """Every stage reply of a sweep report that was decoded parsed: the
    locator took one attempt, each analysis one cypher attempt whose reply
    parsed or was refused by its budget before decoding (``cypher_parsed``
    and ``cypher_refused`` of them in all), and every audit report is
    JSON."""
    from k8s_llm_rca_tpu_torch.utils.fenced import extract_json

    n_analyses = 0
    for row in report["incidents"]:
        if row.get("locator_attempts") != 1:
            return False
        for a in row["analyses"]:
            n_analyses += 1
            if a["cypher_attempts"] != 1:
                return False
            for text in a["reports"]:
                try:
                    json.loads(text)
                except (TypeError, ValueError):
                    try:
                        extract_json(text)
                    except (TypeError, ValueError):
                        return False
    return cypher_parsed + cypher_refused == n_analyses


def phase_rca() -> dict:
    """Phase 6: Llama-3-8B bf16 (seeded random weights) runs the four
    fixture incidents at concurrency 4 through the RCA pipeline on the
    soak engine, then again with ``speculative_k`` 4.  Returns each run's
    launch counts, by phase name."""
    import torch

    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.models.llama import init_params

    cfg = LLAMA3_8B
    emit("rca_host", **host_state())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = {}
    for name, spec_k in (("rca", 0), ("rca_spec", 4)):
        out[name] = rca_sweep(cfg, params, spec_k, init_s)
        free_card()
    out["rca_resilient"] = rca_resilient(cfg, params)
    free_card()
    return out


def host_state() -> dict:
    """What the host carries into a phase whose time is mostly host time:
    live threads, objects the collector tracks, resident and pinned
    memory, and the load average."""
    import threading

    import torch

    rss_kb = 0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss_kb = int(line.split()[1])
    stats = torch.cuda.host_memory_stats() if hasattr(
        torch.cuda, "host_memory_stats") else {}
    return {"threads": threading.active_count(),
            "gc_objects": len(gc.get_objects()),
            "rss_gb": rss_kb / 2 ** 20,
            "pinned_reserved_gb": stats.get("reserved_bytes.current",
                                            0) / 2 ** 30,
            "loadavg": list(os.getloadavg()),
            "torch_threads": torch.get_num_threads()}


# The stages whose only dependency is the graph, and the rung each drops
# to: a failed graph query may degrade these and nothing else.  A drop
# of ``locate.plan``, ``cypher`` or ``audit`` means an engine stage
# raised, which the ladder would otherwise hide behind its fallbacks.
GRAPH_STAGE_RUNGS = {"locate.srcKind": "default-Pod",
                     "locate.metapath": "skipped"}


def rca_resilient(cfg, params) -> dict:
    """Phase 6's resilient sweeps: two incidents at concurrency 1 with the
    degradation ladder (``run_pipelined_sweep(resilience=True)``), first
    with no plan armed, where no stage may degrade and no query retry,
    then under an armed plan that fails graph queries 4-15, where every
    incident completes and every degraded stage is a graph stage dropped
    to its graph rung.  Returns the launch counts of both sweeps."""
    from k8s_llm_rca_tpu_torch.faults import inject
    from k8s_llm_rca_tpu_torch.faults.plan import FaultPlan

    control, counts = resilient_sweep(cfg, params, None)
    if (control["annotations"] != [[], []] or control["degraded"]
            or control["policy"]["counters"] != {"retries": 0,
                                                 "degraded_stages": 0}):
        raise SystemExit(f"rca resilient sweep, no faults: "
                         f"{control['annotations']}, policy "
                         f"{control['policy']}")
    plan = FaultPlan.from_spec(0, {inject.SITE_GRAPH: {
        "indices": {i: "error" for i in range(4, 16)}}})
    faulted, more = resilient_sweep(cfg, params, plan)
    drops = [(a["stage"], a["rung"]) for row in faulted["annotations"]
             for a in row]
    if (not faulted["degraded"] or not faulted["fired"]
            or any(GRAPH_STAGE_RUNGS.get(stage) != rung
                   for stage, rung in drops)):
        raise SystemExit(f"rca resilient sweep, graph faults: "
                         f"{faulted['annotations']}, fired "
                         f"{faulted['fired']}")
    return {k: counts[k] + more[k] for k in counts}


def resilient_sweep(cfg, params, plan) -> tuple:
    """One resilient two-incident sweep, under ``plan`` when it is given:
    prints its record and fails unless both incidents complete on a clean
    engine with the expected launches.  Returns the record and the
    launch counts."""
    import torch

    from k8s_llm_rca_tpu_torch.faults import inject
    from k8s_llm_rca_tpu_torch.faults.soak import run_pipelined_sweep

    reset_counts()
    t0 = time.perf_counter()
    with (inject.armed(plan) if plan is not None
          else contextlib.nullcontext()):
        out = run_pipelined_sweep(backend="engine", n_incidents=2,
                                  concurrency=1, model_cfg=cfg,
                                  params=params, resilience=True)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    engine = out["engines"][0]
    report = out["report"]
    expect = expected_counts(cfg, engine._counts, False)
    record = dict(
        model=cfg.name, faults=plan is not None,
        incidents=report["n_incidents"], concurrency=1,
        completed=report["completed"], resolved=report["resolved"],
        degraded=report["degraded"], failed=report["failed"],
        engine_clean=report["engine_clean"],
        annotations=[row.get("degraded") for row in report["incidents"]],
        fired=plan.snapshot()["fired"] if plan is not None else [],
        policy=out["stats"]["policy"], total_s=total_s,
        allocator=type(engine.allocator).__name__, launches=counts,
        expected_launches=expect, nvidia_smi=nvidia_smi_name_power())
    emit("rca_resilient", **record)
    if report["completed"] != 2 or report["failed"]:
        raise SystemExit(f"rca resilient sweep: {report['completed']} of 2 "
                         f"completed, {report['failed']} failed")
    if not report["engine_clean"] or counts != expect:
        raise SystemExit(f"rca resilient sweep: engine clean "
                         f"{report['engine_clean']}, launches {counts} vs "
                         f"{expect}")
    return record, counts


def rca_sweep(cfg, params, spec_k: int, init_s: float) -> dict:
    """One four-incident sweep of phase 6 with ``speculative_k`` spec_k;
    prints its record and returns its launch counts."""
    import torch

    from k8s_llm_rca_tpu_torch.faults.soak import run_pipelined_sweep
    from k8s_llm_rca_tpu_torch.utils.logging import METRICS

    kinds, host_s, cypher_parsed, cypher_refused = {}, [0.0], [0], [0]
    timer = METRICS.timings["rca.incident"]
    n_before = timer.count
    reset_counts()
    t1 = time.perf_counter()
    with watch_grammars(kinds, host_s), \
            watch_cypher(cypher_parsed, cypher_refused):
        out = run_pipelined_sweep(
            backend="engine", n_incidents=4, concurrency=4, model_cfg=cfg,
            params=params,
            engine_overrides={"speculative_k": spec_k} if spec_k else None)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t1
    counts = read_counts()
    engine = out["engines"][0]
    c = engine._counts
    report = out["report"]
    expect = expected_counts(cfg, c, False)
    incident_s = sorted(timer.window()[-(timer.count - n_before):])
    parsed = stage_replies_parse(report, cypher_parsed[0],
                                 cypher_refused[0])
    label = "rca" + (f" (speculative_k {spec_k})" if spec_k else "")
    emit("rca", model=cfg.name, layers=cfg.n_layers, vocab=cfg.vocab_size,
         speculative_k=spec_k,
         incidents=report["n_incidents"], concurrency=4,
         completed=report["completed"], failed=report["failed"],
         engine_clean=report["engine_clean"], replies_parsed=parsed,
         incident_s=incident_s,
         incident_p50_s=statistics.median(incident_s),
         incident_max_s=max(incident_s), total_s=total_s, init_s=init_s,
         decode_steps=int(c["engine.decode_steps"]),
         dispatches=int(c["engine.dispatches"]),
         verify_steps=int(c.get("engine.verify_steps", 0)),
         spec_drafted=int(c.get("engine.spec_drafted", 0)),
         spec_accepted=int(c.get("engine.spec_accepted", 0)),
         prefill_dispatches=int(c["engine.prefill_dispatches"]),
         completion_tokens=int(c["engine.decode_tokens"]),
         graph_keys=sorted(map(str, engine.graphs.buckets)),
         **graph_stats(engine),
         runs=len(out["service"].runs), grammar_kinds=kinds,
         constraint_host_s=host_s[0],
         statepaths=[a["n_statepaths"] for row in report["incidents"]
                     for a in row["analyses"]],
         cypher_parsed=cypher_parsed[0], cypher_refused=cypher_refused[0],
         used_fallback=[a["used_fallback"] for row in report["incidents"]
                        for a in row["analyses"]],
         launches=counts, expected_launches=expect,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         nvidia_smi=nvidia_smi_name_power())
    if report["failed"] or report["completed"] != 4:
        raise SystemExit(f"{label}: {report['completed']} of 4 incidents "
                         f"completed, {report['failed']} failed: "
                         f"{[r.get('error') for r in report['incidents']]}")
    if not report["engine_clean"]:
        raise SystemExit(f"{label}: the engine was not left clean")
    if not parsed:
        raise SystemExit(f"{label}: a stage reply did not parse (cypher: "
                         f"{cypher_parsed[0]} parsed, {cypher_refused[0]} "
                         f"refused by their budget)")
    if counts != expect:
        raise SystemExit(f"{label}: launch counts {counts} != expected "
                         f"{expect}")
    if not c.get("engine.graph_replays"):
        raise SystemExit(f"{label}: the engine replayed no CUDA graph")
    if spec_k and not c.get("engine.verify_steps"):
        raise SystemExit(f"{label}: no verify step ran")
    return counts


# ------------------------------------------------------------------ phase 8


DURABLE_DIR = ROOT / "build" / "chip_smoke_durable"


def durable_service(engine, journal=None):
    """A service over ``engine`` (journaled when ``journal`` is given) and
    its analyst assistant (64 new tokens)."""
    from k8s_llm_rca_tpu_torch.serve.api import AssistantService
    from k8s_llm_rca_tpu_torch.serve.backend import EngineBackend, GenOptions

    svc = AssistantService(EngineBackend(engine), journal=journal)
    asst = svc.create_assistant(
        "You are the root-cause analyst for a Kubernetes cluster.",
        "analyst", gen=GenOptions(max_new_tokens=64))
    return svc, asst


def submit_four(svc, asst) -> list:
    """The slice's four requests (~400, 900, 1500 and 2300 prompt tokens),
    one thread each; returns the run ids."""
    from k8s_llm_rca_tpu_torch.serve.api import Message, Thread, render_prompt

    overhead = len(render_prompt(
        asst, Thread("t", [Message("m", "user", "", 0.0)]))) + 1
    ids = []
    for target in (400, 900, 1500, 2300):
        thread = svc.create_thread()
        svc.add_message(thread.id, incident_text(target - overhead))
        ids.append(svc.create_run(thread.id, asst.id).id)
    return ids


def run_seqs(svc, run_ids) -> list:
    """The engine sequence of each run (read while the runs are live)."""
    return [svc.backend._handle_seq[svc.runs[r].backend_handle]
            for r in run_ids]


def drain_runs(svc, run_ids) -> None:
    from k8s_llm_rca_tpu_torch.serve.api import RunStatus

    while any(svc.runs[r].status not in RunStatus.TERMINAL for r in run_ids):
        svc.pump_once()


def record_results(engine) -> dict:
    """Every SequenceResult the engine returns, by sequence id."""
    results, step = {}, engine.step

    def recorded():
        out = step()
        results.update((r.seq_id, r) for r in out)
        return out

    engine.step = recorded
    return results


def timed_appends(journal) -> list:
    """Seconds of each ``journal.append`` (its fsync included)."""
    times, append = [], journal.append

    def timed(kind, **fields):
        t0 = time.perf_counter()
        append(kind, **fields)
        times.append(time.perf_counter() - t0)

    journal.append = timed
    return times


def crash_and_recover(engine, results, stamps, path: Path) -> dict:
    """Phase 8a's cycle on ``engine``: the four requests through a
    journaled service, pumped until every sequence has decoded 4 tokens;
    then the teardown of ``CrashSupervisor.crash_restart`` (the journal
    closed, every live handle cancelled, the service's in-flight map
    dropped) and ``recover_service`` onto a fresh backend, drained.
    Returns the recovered runs' tokens, replies and prompts, the
    journal's records, bytes and ms per append, the resubmissions' TTFT
    and the prefix-hit tokens of the recovery."""
    import torch

    from k8s_llm_rca_tpu_torch.serve.api import RunStatus, run_reply_text
    from k8s_llm_rca_tpu_torch.serve.backend import EngineBackend
    from k8s_llm_rca_tpu_torch.serve.journal import RunJournal, read_journal
    from k8s_llm_rca_tpu_torch.serve.recover import recover_service

    if path.exists():
        path.unlink()
    journal = RunJournal(str(path))
    appends = timed_appends(journal)
    svc, asst = durable_service(engine, journal)
    ids = submit_four(svc, asst)
    seqs = set(run_seqs(svc, ids))
    for _ in range(200):
        svc.pump_once()
        gen = {st.seq_id: len(st.generated) for st in engine._active.values()}
        if all(gen.get(s, 0) >= 4 for s in seqs):
            break
    else:
        raise SystemExit(f"durable: the runs did not all decode 4 tokens: "
                         f"{gen}")
    if any(svc.runs[r].status in RunStatus.TERMINAL for r in ids):
        raise SystemExit("durable: a run settled before the crash")
    decoded_before = sorted(gen[s] for s in seqs)
    journal.close()
    backend = svc.backend
    for handle in list(backend._live):
        backend.cancel(handle)
    svc._inflight.clear()
    if engine.has_work:
        raise SystemExit("durable: the torn-down engine still has work")
    hits0 = engine._counts.get("engine.prefix_hit_tokens", 0)
    n_stamps = len(stamps)
    t0 = time.perf_counter()
    rec_svc, report = recover_service(str(path), EngineBackend(engine))
    if report["resubmitted"] != ids:
        raise SystemExit(f"durable: resubmitted {report['resubmitted']} "
                         f"!= {ids}")
    rseqs = run_seqs(rec_svc, ids)
    drain_runs(rec_svc, ids)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    if any(rec_svc.runs[r].status != RunStatus.COMPLETED for r in ids):
        raise SystemExit(f"durable: recovered runs did not complete: "
                         f"{[rec_svc.runs[r].status for r in ids]}")
    prompts = [r["prompt"] for r in read_journal(str(path))[0]
               if r["kind"] == "run_submit"]
    return {"service": rec_svc,
            "tokens": [results[s].token_ids for s in rseqs],
            "replies": [run_reply_text(rec_svc, rec_svc.runs[r])
                        for r in ids],
            "prompts": prompts,
            "records": len(read_journal(str(path))[0]),
            "journal_bytes": path.stat().st_size,
            "appends": len(appends),
            "append_ms_mean": 1e3 * statistics.mean(appends),
            "append_ms_max": 1e3 * max(appends),
            "decoded_before_crash": decoded_before,
            "resubmit_ttft_s": stamps[n_stamps] - t0,
            "recovery_total_s": total_s,
            "prefix_hit_tokens": int(engine._counts.get(
                "engine.prefix_hit_tokens", 0) - hits0)}


def durable_engine(cfg, params, tok, kv, cache: bool):
    """A slice engine (graphed, warmed) with the result recorder and the
    first-token stamps installed."""
    from k8s_llm_rca_tpu_torch.engine import make_engine

    engine = make_engine(cfg, slice_engine_config(
        kv_cache_dtype=kv, prefix_cache=cache), params, tok)
    before = warm_engine(engine)
    results, stamps = record_results(engine), []
    stamp_first_tokens(engine, stamps)
    return engine, before, results, stamps


def engine_left_clean(label: str, engine) -> None:
    """The native allocator's check passes and every page is free (cached
    prefix pages evicted first)."""
    engine.allocator.check()
    if engine.prefix_cache is not None:
        engine.prefix_cache.evict(10 ** 6)
    engine.allocator.check()
    if engine.allocator.n_free != engine.engine_cfg.num_pages - 1:
        raise SystemExit(f"{label}: {engine.allocator.n_free} pages free of "
                         f"{engine.engine_cfg.num_pages - 1}")


SAMPLE = re.compile(r'[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-z_]+="[^"]*"\})? '
                    r'-?[0-9][0-9.e+-]*')


def scrape_case(service) -> dict:
    """Phase 8e: the Prometheus text of a recovered service parses line
    by line and carries the engine's phase timers and gauges."""
    text = service.prometheus_metrics()
    families = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            families[name] = kind
        elif not line.startswith("# HELP ") and not SAMPLE.fullmatch(line):
            raise SystemExit(f"scrape: unparsable line {line!r}")
    want = {"k8s_llm_rca_engine_decode_step_seconds": "summary",
            "k8s_llm_rca_engine_prefill_seconds": "summary",
            "k8s_llm_rca_engine_free_pages": "gauge",
            "k8s_llm_rca_engine_running_seqs": "gauge",
            "k8s_llm_rca_serve_journal_records_total": "counter"}
    missing = {k: v for k, v in want.items() if families.get(k) != v}
    if missing:
        raise SystemExit(f"scrape: missing families {missing}")
    return {"families": len(families), "bytes": len(text),
            "engine_timers": sorted(k for k, v in families.items()
                                    if k.startswith("k8s_llm_rca_engine")
                                    and v == "summary")}


def durable_recovery(name: str, bits, kv) -> tuple:
    """Phase 8a on one model: the uninterrupted replies, then the crash
    and recovery with the prefix cache off (replies byte-equal required)
    and on (the resubmissions hit; tokens before the streams part and the
    margin where they do).  Returns (launch counts, the cached recovered
    service)."""
    import torch

    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.serve.api import run_reply_text
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    label = "durable" if bits is None else f"durable_int{bits}"
    cfg, transform = slice_model(name, bits)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    DURABLE_DIR.mkdir(parents=True, exist_ok=True)
    total = {k: 0 for k in launch_counters()}
    out, service = {}, None
    for cache in (False, True):
        engine, before, results, stamps = durable_engine(cfg, params, tok, kv,
                                                         cache)
        reset_counts()
        if not cache:
            svc, asst = durable_service(engine)
            ids = submit_four(svc, asst)
            seqs = run_seqs(svc, ids)
            drain_runs(svc, ids)
            ref_tokens = [results[s].token_ids for s in seqs]
            ref_replies = [run_reply_text(svc, svc.runs[r]) for r in ids]
        rec = crash_and_recover(engine, results, stamps,
                                DURABLE_DIR / f"{label}-{cache}.wal")
        torch.cuda.synchronize()
        counts = read_counts()
        expect = expected_counts(cfg, counts_since(engine, before),
                                 kv is not None, bits)
        if counts != expect:
            raise SystemExit(f"{label} (cache {cache}): launch counts "
                             f"{counts} != expected {expect}")
        for k, v in counts.items():
            total[k] += v
        engine_left_clean(f"{label} (cache {cache})", engine)
        mode = "cached" if cache else "uncached"
        run = {k: v for k, v in rec.items()
               if k not in ("service", "tokens", "replies", "prompts")}
        run["equal_replies"] = rec["replies"] == ref_replies
        run["equal_token_share"] = common_share(ref_tokens, rec["tokens"])
        ids_of = [tok.encode(p, add_bos=True) for p in rec["prompts"]]
        run["divergences"] = divergences(cfg, params, ids_of, ref_tokens,
                                         rec["tokens"])
        run["allocator"] = type(engine.allocator).__name__
        run.update(graph_stats(engine))
        out[mode] = run
        if cache:
            service = rec["service"]
        # the services and the recorder hold the engine: drop them all
        svc = rec = results = engine = None
        free_card()
    emit(label, model=cfg.name, weights=f"int{bits}" if bits else "bfloat16",
         kv_cache_dtype=kv,
         **{f"{mode}_{k}": v for mode, run in out.items()
            for k, v in run.items()},
         launches=total, nvidia_smi=nvidia_smi_name_power())
    un, ca = out["uncached"], out["cached"]
    if not (un["equal_replies"] and un["equal_token_share"] == 1.0):
        raise SystemExit(f"{label}: the uncached recovery's replies differ "
                         f"from the uninterrupted run's: {un['divergences']}")
    if not ca["prefix_hit_tokens"]:
        raise SystemExit(f"{label}: the cached resubmissions did not hit")
    if {un["allocator"], ca["allocator"]} != {"NativePageAllocator"}:
        raise SystemExit(f"{label}: an engine does not use the native "
                         f"allocator: {un['allocator']}, {ca['allocator']}")
    return total, service


# the depth of Llama-3-8B in phase 8b's CLI and phase 9d's contiguous
# engine and CLI: its full width, the first CUT_LAYERS layers (the whole
# script's time, PERF.md)
CUT_LAYERS = 4


@contextlib.contextmanager
def cli_depth(name: str, n_layers: int):
    """``--model name`` at ``n_layers`` layers, full width, while the CLI
    runs in this process (``MODEL_REGISTRY`` is the presets' table)."""
    from k8s_llm_rca_tpu_torch.config import MODEL_REGISTRY

    full = MODEL_REGISTRY[name]
    MODEL_REGISTRY[name] = full.replace(n_layers=n_layers)
    try:
        yield
    finally:
        MODEL_REGISTRY[name] = full


def cli_sweep_case() -> dict:
    """Phase 8b: the CLI on the card at full width (Llama-3-8B bf16 at
    ``CUT_LAYERS`` layers, four incidents at concurrency 4),
    ``run_file.main`` in this process on a fresh output file, between
    ``reset_counts()`` and ``read_counts()``: its summary line, 4 records
    that parse, and the launches its engine's counters require.  Returns
    the launch counts."""
    import torch

    from k8s_llm_rca_tpu_torch.sweeps import run_file
    from k8s_llm_rca_tpu_torch.utils.logging import METRICS

    out = DURABLE_DIR / "cli-8b.json"
    if out.exists():
        out.unlink()
    argv = ["--backend", "engine", "--paged", "--model", "llama3-8b",
            "--max-seq-len", "2560", "--fresh-threads", "--concurrency", "4",
            "--slice", "0:4", "--input", str(ROOT / "data" / "incidents.csv"),
            "--output", str(out)]
    services, build = [], run_file.build_service

    def built(*args, **kwargs):
        services.append(build(*args, **kwargs))
        return services[-1]

    run_file.build_service = built
    METRICS.reset()               # the summary's rates read this run alone
    reset_counts()
    t0 = time.perf_counter()
    try:
        with cli_depth("llama3-8b", CUT_LAYERS):
            summary = run_file.main(argv)
    finally:
        run_file.build_service = build
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    (service,) = services
    engine = service.backend.engine
    expect = expected_counts(engine.model_cfg, engine._counts, False)
    records, _ = run_file.scan_output(str(out))
    chip = summary["chip"]
    ecfg = engine.engine_cfg
    emit("durable_cli", command="python -m k8s_llm_rca_tpu_torch.sweeps."
         "run_file " + " ".join(argv), layers=engine.model_cfg.n_layers,
         seconds=seconds,
         engine={"max_batch": ecfg.max_batch, "page_size": ecfg.page_size,
                 "num_pages": ecfg.num_pages,
                 "pages_per_seq": engine.pages_per_seq,
                 "prefix_cache": ecfg.prefix_cache,
                 "allocator": type(engine.allocator).__name__},
         incidents=summary["incidents"], failures=summary["failures"],
         wall_s=summary["wall_s"],
         p50_incident_s=summary["p50_incident_s"], chip=chip,
         sweep_sched=summary.get("sweep_sched"), records=len(records),
         launches=counts, **graph_stats(engine),
         nvidia_smi=nvidia_smi_name_power())
    if (summary["incidents"], summary["failures"], len(records)) != (4, 0, 4):
        raise SystemExit(f"cli: {summary['incidents']} incidents, "
                         f"{summary['failures']} failures, {len(records)} "
                         f"records")
    if chip["decode_tokens_per_sec"] is None or "hbm_bytes_in_use" not in chip:
        raise SystemExit(f"cli: chip metrics incomplete: {chip}")
    if counts != expect or not (counts["paged"] and counts["flash"]):
        raise SystemExit(f"cli: launch counts {counts} != expected {expect}")
    return counts


def kill_resume_case() -> dict:
    """Phase 8c: ``run_file`` on TINY on the card with 4 workers over 3x
    the corpus, SIGKILLed once 4 records have landed, then rerun with
    ``--resume``: the final records are the input as a multiset."""
    import signal
    from collections import Counter

    from k8s_llm_rca_tpu_torch.sweeps.run_file import (
        load_corpus, scan_output, write_default_corpus,
    )

    inp, out = DURABLE_DIR / "kill.csv", DURABLE_DIR / "kill.json"
    for p in (inp, out):
        if p.exists():
            p.unlink()
    write_default_corpus(str(inp), repeat=3)
    corpus = load_corpus(str(inp))
    cmd = [sys.executable, "-m", "k8s_llm_rca_tpu_torch.sweeps.run_file",
           "--backend", "engine", "--paged", "--model", "tiny",
           "--fresh-threads", "--workers", "4", "--input", str(inp),
           "--output", str(out)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 300
        while time.time() < deadline and proc.poll() is None:
            if len(scan_output(str(out))[0]) >= 4:
                break
            time.sleep(0.05)
        killed = proc.poll() is None
        if killed:
            proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    survivors = len(scan_output(str(out))[0])
    resumed = subprocess.run(cmd + ["--resume"], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if resumed.returncode != 0:
        raise SystemExit(f"kill/resume: the resumed run exited "
                         f"{resumed.returncode}: {resumed.stderr[-3000:]}")
    summary = json.loads(resumed.stdout.strip().splitlines()[-1])
    final, _ = scan_output(str(out))
    same = Counter(final) == Counter(corpus)
    emit("durable_kill_resume", corpus=len(corpus), killed=killed,
         survivors=survivors, resumed_incidents=summary["incidents"],
         final=len(final), multiset_equal=same, seconds=seconds,
         nvidia_smi=nvidia_smi_name_power())
    if not (killed and 0 < survivors < len(corpus) and same
            and summary["incidents"] == len(corpus) - survivors):
        raise SystemExit("kill/resume: the sweep was not killed mid-flight "
                         "or the resumed records are not the input")
    return summary


def supervised_case() -> None:
    """Phase 8d: ``run_chaos_soak(seed=5, n_incidents=3, backend="engine")``
    on TINY with a supervised crash after incident 1, on the card, against
    the same soak unsupervised on the card and on the CPU (same seeded
    weights): equal report bytes."""
    import torch

    from k8s_llm_rca_tpu_torch.config import TINY
    from k8s_llm_rca_tpu_torch.faults import inject
    from k8s_llm_rca_tpu_torch.faults.plan import Fault, FaultPlan
    from k8s_llm_rca_tpu_torch.faults.soak import report_bytes, run_chaos_soak
    from k8s_llm_rca_tpu_torch.faults.supervisor import CrashSupervisor
    from k8s_llm_rca_tpu_torch.models.llama import init_params

    cfg = TINY.replace(max_seq_len=2560)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_params = {k: ([{n: _to_cuda(t) for n, t in layer.items()}
                       for layer in v] if k == "layers" else _to_cuda(v))
                  for k, v in cpu_params.items()}
    wal_dir = DURABLE_DIR / "soak"
    if (wal_dir / "serve.wal").exists():
        (wal_dir / "serve.wal").unlink()
    sup = CrashSupervisor(FaultPlan([Fault(inject.SITE_PROCESS, 1, "crash")]),
                          str(wal_dir / "serve.wal"))
    reports, seconds = {}, {}
    for mode, params, device, kw in (
            ("cpu", cpu_params, "cpu", {}),
            ("card", gpu_params, None, {}),
            ("card_supervised", gpu_params, None,
             {"durable_dir": str(wal_dir), "supervisor": sup})):
        t0 = time.perf_counter()
        reports[mode] = run_chaos_soak(seed=5, n_incidents=3,
                                       backend="engine", model_cfg=cfg,
                                       params=params, device=device, **kw)
        seconds[mode] = time.perf_counter() - t0
    sup_r = reports["card_supervised"]
    same = (report_bytes(sup_r) == report_bytes(reports["card"])
            == report_bytes(reports["cpu"]))
    emit("durable_supervised", model="tiny-chaos-soak", seed=5,
         incidents=3, equal_report_bytes=same, crashes=sup.crashes,
         recoveries=sup.recoveries, completed=sup_r["completed"],
         failed=sup_r["failed"], engine_clean=sup_r["engine_clean"],
         seconds=seconds, nvidia_smi=nvidia_smi_name_power())
    if not same or sup.crashes != 1 or sup_r["failed"] \
            or not sup_r["engine_clean"]:
        raise SystemExit("supervised soak: report bytes differ, or no "
                         "crash, a failed incident or an unclean engine")


def phase_durable() -> dict:
    """Phase 8: serving durability and the drivers.  Returns the launch
    counts of 8a and 8b by run ("durable", "durable_int4",
    "durable_cli")."""
    t0 = time.perf_counter()
    runs = {}
    runs["durable"], service = durable_recovery("llama3-8b", None, None)
    emit("durable_scrape", **scrape_case(service),
         nvidia_smi=nvidia_smi_name_power())
    del service
    free_card()
    runs["durable_int4"], service = durable_recovery("llama3-8b", 4, "int4")
    del service
    free_card()
    runs["durable_cli"] = cli_sweep_case()
    free_card()
    kill_resume_case()
    supervised_case()
    emit("durable_done", seconds=time.perf_counter() - t0,
         nvidia_smi=nvidia_smi_name_power())
    return runs


def phase_profile_decode(name: str, bits=None, kv=None,
                         steps: int = 8) -> None:
    """Where one decode step's time goes at the slice's shapes (Llama-3-8B
    in bf16 or int4 over an int4 pool, Mixtral-8x7B in int8 over an int8
    pool, quantized weights under fused_quant_matmul; batch 4 at
    400/900/1500/2300 cached tokens): wall time per step without and with
    the profiler, the device time of the step's kernels (torch.profiler),
    the device's busy share and the heaviest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from k8s_llm_rca_tpu_torch.engine.paged import (
        init_paged_cache, paged_decode_step,
    )
    from k8s_llm_rca_tpu_torch.models.llama import init_params

    cfg, transform = slice_model(name, bits)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    pool = init_paged_cache(cfg, 168, 64, "cuda", kv_dtype=kv)
    lens = [400, 900, 1500, 2300]
    tables = torch.zeros((4, 40), dtype=torch.int32)
    used = 1
    for i, n in enumerate(lens):
        n_p = -(-(n + steps + 4) // 64)
        tables[i, :n_p] = torch.arange(used, used + n_p)
        used += n_p
    tables = tables.cuda()
    tokens = torch.zeros(4, dtype=torch.int32, device="cuda")

    def run(n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            lengths = torch.tensor([x + i for x in lens], dtype=torch.int32,
                                   device="cuda")
            paged_decode_step(cfg, params, pool, tokens, lengths, tables)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    run(2)
    wall = run(steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_profiled = run(steps)

    # kernels only: a CPU-side op (aten::mm) also carries the device time of
    # the kernels it launched, which are listed on their own
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    device_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    top = sorted(events, key=dev_us, reverse=True)[:8]
    emit("profile_decode", model=cfg.name,
         weights=f"int{bits}" if bits else "bfloat16", kv_cache_dtype=kv,
         steps=steps, nvidia_smi=nvidia_smi_name_power(), wall_ms_per_step=1e3 * wall,
         wall_ms_per_step_profiled=1e3 * wall_profiled,
         device_ms_per_step=device_ms,
         device_busy_share=device_ms / (1e3 * wall_profiled),
         kernel_launches_per_step=sum(e.count for e in events) / steps,
         top=[{"name": e.key[:80], "ms_per_step": dev_us(e) / 1e3 / steps,
               "calls_per_step": e.count / steps} for e in top])


def phase_host_costs(calls: int = 2000) -> None:
    """Host time per call of the int4 decode step's extra eager work, at
    its shapes: one ``quant_matmul`` (x [4, 4096] @ int4 [4096, 4096]), the
    ``torch.matmul`` it replaces, and one ``quantize_kv`` of a token batch.
    The clock stops before the synchronize: the card finishes each call
    sooner than the host issues the next, so this is the host's time."""
    import torch

    from k8s_llm_rca_tpu_torch.models.quant import quantize_kv
    from k8s_llm_rca_tpu_torch.ops.quant_matmul import quant_matmul

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((4, 4096), generator=gen, device="cuda").bfloat16()
    w = quant_weight(gen, 4096, 4096)
    w_dense = torch.randn((4096, 4096), generator=gen,
                          device="cuda").bfloat16()
    kv = torch.randn((4, 1024), generator=gen, device="cuda").bfloat16()
    out = {}
    for name, fn in (("quant_matmul_us", lambda: quant_matmul(x, w)),
                     ("torch_matmul_us", lambda: torch.matmul(x, w_dense)),
                     ("quantize_kv_us", lambda: quantize_kv(kv, True))):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out[name] = 1e6 * (t1 - t0) / calls
    emit("host_costs", calls=calls, **out)


# ------------------------------------------------------------------ phase 9


LOAD_DIR = ROOT / "build" / "chip_smoke_load"
# the passages a rerank orders in 9b (BASELINE config[4]: evidence of an
# incident against its error message)
RERANK_PASSAGES = [
    "pod web-1 is pending: secret db-cred not found",
    "node ip-10-0-3-7 reports memory pressure",
    "configmap es-gen-white-list-configmap does not exist",
    "deployment payment has 3 replicas available",
    "service frontend selects no endpoints",
    "persistent volume claim data-0 is bound",
    "MountVolume.SetUp failed for volume pvc-f3788c43: nfs path missing",
    "container app exited with code 137 (OOMKilled)",
]
RERANK_QUERY = ('MountVolume.SetUp failed for volume "pvc-f3788c43" : mount '
                'failed: exit status 32')


def _tensors(tree):
    """Every tensor of a param tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def bit_equal(a, b) -> bool:
    """Two param trees hold the same bits, tensor by tensor."""
    import torch

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(bits(x), bits(y)) for x, y in zip(ta, tb))


@contextlib.contextmanager
def peak_rss():
    """Sample the process's resident memory every 5 ms in a thread; yields
    a dict whose ``peak_gb`` holds the largest sample when the ``with``
    ends."""
    import threading

    out, stop = {"peak_gb": 0.0}, threading.Event()

    def rss_gb() -> float:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2 ** 20
        return 0.0

    def sample():
        while not stop.is_set():
            out["peak_gb"] = max(out["peak_gb"], rss_gb())
            stop.wait(0.005)

    thread = threading.Thread(target=sample, daemon=True)
    out["before_gb"] = rss_gb()
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()
        out["peak_gb"] = max(out["peak_gb"], rss_gb())


def encoder_state_dict(params) -> dict:
    """An e5 tree as an HF BERT state dict under the ``bert.`` prefix
    (the inverse of ``loader.encoder_params_from_hf``): CPU tensors,
    projections back to [out, in]."""
    def host(t, transpose=False):
        t = t.detach()
        return (t.transpose(-2, -1) if transpose else t).contiguous().cpu()

    e = "bert.embeddings."
    sd = {e + "word_embeddings.weight": host(params["word_embedding"]),
          e + "position_embeddings.weight": host(params["position_embedding"]),
          e + "token_type_embeddings.weight": host(params["type_embedding"]),
          e + "LayerNorm.weight": host(params["embed_ln_w"]),
          e + "LayerNorm.bias": host(params["embed_ln_b"])}
    names = {"wq": "attention.self.query", "wk": "attention.self.key",
             "wv": "attention.self.value", "wo": "attention.output.dense",
             "w_in": "intermediate.dense", "w_out": "output.dense"}
    biases = {"bq": "wq", "bk": "wk", "bv": "wv", "bo": "wo", "b_in": "w_in",
              "b_out": "w_out"}
    norms = {"attn_ln": "attention.output.LayerNorm",
             "mlp_ln": "output.LayerNorm"}
    for i, layer in enumerate(params["layers"]):
        p = f"bert.encoder.layer.{i}."
        for k, name in names.items():
            sd[p + name + ".weight"] = host(layer[k], True)
        for k, w in biases.items():
            sd[p + names[w] + ".bias"] = host(layer[k])
        for k, name in norms.items():
            sd[p + name + ".weight"] = host(layer[k + "_w"])
            sd[p + name + ".bias"] = host(layer[k + "_b"])
    return sd


def load_case(label: str, params, write, load, compare) -> dict:
    """Write ``params`` to ``LOAD_DIR / label`` (``write``), load it back
    onto the card (``load``) under ``peak_rss``, and hold the loaded tree
    bit-equal to the written one and ``compare(params, loaded)`` (a pair
    of outputs) equal.  Returns the record."""
    import shutil

    import torch

    path = LOAD_DIR / label
    shutil.rmtree(path, ignore_errors=True)
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    t0 = time.perf_counter()
    write(str(path))
    write_s = time.perf_counter() - t0
    files = list(path.iterdir())
    file_bytes = sum(f.stat().st_size for f in files)
    gc.collect()
    with peak_rss() as rss:
        t0 = time.perf_counter()
        loaded = load(str(path))
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
    equal = bit_equal(params, loaded)
    want, got = compare(params, loaded)
    same_out = bool(torch.equal(want, got))
    shutil.rmtree(path, ignore_errors=True)
    record = {"label": label, "param_gb": nbytes / 1e9,
              "file_gb": file_bytes / 1e9, "files": len(files),
              "write_s": write_s,
              "write_gb_per_s": file_bytes / 1e9 / write_s,
              "read_s": read_s, "read_gb_per_s": file_bytes / 1e9 / read_s,
              "host_rss_before_gb": rss["before_gb"],
              "host_rss_peak_gb": rss["peak_gb"], "bit_equal": equal,
              "outputs_equal": same_out,
              "max_abs_out_diff": (want.float() - got.float()).abs()
              .max().item()}
    if not (equal and same_out):
        raise SystemExit(f"load {label}: bit-equal {equal}, outputs equal "
                         f"{same_out}")
    return record, loaded


def phase_load():
    """9a: Llama-3-8B at full width cut to 2 layers (bf16, seeded) through
    ``llama_params_to_hf`` into a two-shard dir with its index, then
    ``load_llama`` onto the card: bit-equal tensors and equal last-position
    logits of a 64-token prompt; e5-large at full size through an HF BERT
    state dict (``bert.`` prefix) and ``load_encoder``: bit-equal tensors
    and equal embeddings.  Write and read GB/s and the peak host RSS
    during each load.  Returns the loaded e5-large tree (9b's)."""
    import dataclasses

    import torch

    from k8s_llm_rca_tpu_torch.config import E5_LARGE, LLAMA3_8B
    from k8s_llm_rca_tpu_torch.models import encoder, llama, loader

    cfg = LLAMA3_8B.replace(n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(cfg, gen)
    prompt = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                           device="cuda", dtype=torch.int32)

    def write_llama(path):
        loader.write_sharded_safetensors(
            path, loader.llama_params_to_hf(cfg, params), 2)

    def logits(a, b):
        return (llama.prefill_kv(cfg, a, prompt, 64)[2],
                llama.prefill_kv(cfg, b, prompt, 64)[2])

    rec_llama, loaded = load_case(
        "llama3-8b-2-layers", params, write_llama,
        lambda path: loader.load_llama(cfg, path, "cuda"), logits)
    del params, loaded
    free_card()

    enc = E5_LARGE
    e5 = encoder.init_params(enc, torch.Generator(device="cuda")
                             .manual_seed(0))
    tokens = torch.randint(0, enc.vocab_size, (8, 128), generator=gen,
                           device="cuda", dtype=torch.int32)

    def write_e5(path):
        os.makedirs(path)
        loader.write_safetensors(os.path.join(path, "model.safetensors"),
                                 encoder_state_dict(e5))

    def embeddings(a, b):
        return encoder.embed(enc, a, tokens), encoder.embed(enc, b, tokens)

    rec_e5, e5_loaded = load_case(
        "e5-large", e5, write_e5,
        lambda path: loader.load_encoder(enc, path, "cuda"), embeddings)
    emit("load", llama=dict(rec_llama, model=cfg.name, layers=cfg.n_layers,
                            dtype=cfg.dtype),
         e5=dict(rec_e5, model=enc.name, layers=enc.n_layers,
                 dtype=enc.dtype),
         encoder_config=dataclasses.asdict(enc),
         nvidia_smi=nvidia_smi_name_power())
    del e5
    return e5_loaded


def phase_encoder(e5) -> None:
    """9b: ``encoder.embed`` on e5-large bf16 (the loaded seeded weights)
    at buckets 128 and 512, batch 32: ms per batch (CUDA events) and
    passages per second; an fp32 copy of the same weights against bf16 on
    the card (the least cosine over 33 texts, and whether a rerank's
    top-1 agrees); TINY_ENCODER on the card against the CPU (fp32, TF32
    off): max abs error of the embeddings."""
    import dataclasses

    import numpy as np
    import torch

    from k8s_llm_rca_tpu_torch.config import E5_LARGE, TINY_ENCODER
    from k8s_llm_rca_tpu_torch.models import encoder
    from k8s_llm_rca_tpu_torch.rca.rerank import Embedder, Reranker

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = E5_LARGE
    gen = torch.Generator(device="cuda").manual_seed(1)
    timing = {}
    for bucket in (128, 512):
        tokens = torch.randint(0, cfg.vocab_size, (32, bucket), generator=gen,
                               device="cuda", dtype=torch.int32)
        ms = time_ms(lambda: encoder.embed(cfg, e5, tokens), 10)
        timing[bucket] = {"ms_per_batch": ms,
                          "passages_per_s": 32 * 1e3 / ms}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    e5_32 = _float_tree(e5)
    texts = RERANK_PASSAGES * 4 + [RERANK_QUERY]
    bf16 = Embedder(cfg, e5).encode(texts)
    fp32 = Embedder(cfg32, e5_32).encode(texts)
    cosines = np.sum(bf16 * fp32, axis=-1)
    top = [Reranker(Embedder(c, p)).rerank(RERANK_QUERY, RERANK_PASSAGES)
           for c, p in ((cfg, e5), (cfg32, e5_32))]
    del e5_32
    tiny_cpu = encoder.init_params(TINY_ENCODER,
                                   torch.Generator().manual_seed(0), "cpu")
    tiny_gpu = _float_tree(tiny_cpu, "cuda")
    toks = torch.randint(0, TINY_ENCODER.vocab_size, (4, 64),
                         generator=torch.Generator().manual_seed(2))
    lens = torch.tensor([64, 40, 9, 1])
    want = encoder.embed(TINY_ENCODER, tiny_cpu, toks, lens)
    got = encoder.embed(TINY_ENCODER, tiny_gpu, toks.cuda(), lens.cuda())
    tiny_err = (got.cpu() - want).abs().max().item()
    emit("encoder", model=cfg.name, batch=32, timing=timing,
         bf16_vs_fp32_min_cosine=float(cosines.min()),
         top1_bf16=top[0][0], top1_fp32=top[1][0],
         top1_agrees=top[0][0][0] == top[1][0][0],
         tiny_card_vs_cpu_max_abs_err=tiny_err, tiny_tol=1e-4,
         nvidia_smi=nvidia_smi_name_power())
    if tiny_err > 1e-4 or not np.all(np.isfinite(bf16)):
        raise SystemExit(f"encoder: TINY card vs CPU {tiny_err}, finite "
                         f"{bool(np.all(np.isfinite(bf16)))}")


def _float_tree(tree, device=None):
    """A copy of a param tree in fp32 (on ``device`` when given)."""
    import torch

    if isinstance(tree, dict):
        return {k: _float_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float_tree(v, device) for v in tree]
    dtype = torch.float32 if tree.is_floating_point() else tree.dtype
    return tree.to(device=device or tree.device, dtype=dtype)


def rerank_sweep(label: str, cfg, params, reranker, fields_top_k: int
                 ) -> dict:
    """Phase 6's sweep (the soak engine, four fixture incidents at
    concurrency 4, fresh threads) with ``reranker`` on every pipeline and
    ``rerank_fields_top_k``: prints incidents completed, p50 s, the
    analyzer's prompt tokens, the encoder's seconds and the launches
    (exact, from the engine's counters).  Returns the record."""
    import torch

    from k8s_llm_rca_tpu_torch.config import RCAConfig
    from k8s_llm_rca_tpu_torch.faults.plan import VirtualClock
    from k8s_llm_rca_tpu_torch.faults.soak import (
        _build_service, _engine_clean,
    )
    from k8s_llm_rca_tpu_torch.graph import InMemoryGraphExecutor
    from k8s_llm_rca_tpu_torch.graph.fixtures import (
        INCIDENTS, build_metagraph, build_stategraph,
    )
    from k8s_llm_rca_tpu_torch.rca import RCAPipeline
    from k8s_llm_rca_tpu_torch.rca.scheduler import (
        IncidentFailure, SweepScheduler,
    )
    from k8s_llm_rca_tpu_torch.utils.logging import METRICS

    encode_s = [0.0, 0]
    if reranker is not None:
        encode = reranker.embedder.encode

        def timed(texts):
            t0 = time.perf_counter()
            out = encode(texts)          # ends in a host copy: synced
            encode_s[0] += time.perf_counter() - t0
            encode_s[1] += 1
            return out

        reranker.embedder.encode = timed
    service, engines, _ = _build_service("engine", VirtualClock(), cfg,
                                         params, None, None)
    meta = InMemoryGraphExecutor(build_metagraph())
    state = InMemoryGraphExecutor(build_stategraph())
    rca = RCAConfig(locator_max_new_tokens=192, cypher_max_new_tokens=96,
                    analyzer_max_new_tokens=96, fresh_threads=True,
                    rerank_fields_top_k=fields_top_k)
    pipelines = [RCAPipeline(service, meta, state, rca, reranker=reranker)
                 for _ in range(4)]
    # the audit runs (one STATE node's fields a prompt, what the field
    # rerank cuts) apart from the report runs that read their replies
    analyzers = {p.analyzer.assistant.id for p in pipelines}
    reporters = {p.analyzer.reporter.assistant.id for p in pipelines
                 if getattr(p.analyzer, "reporter", None) is not None}
    timer = METRICS.timings["rca.incident"]
    n_before = timer.count
    reset_counts()
    t0 = time.perf_counter()
    results = SweepScheduler(pipelines).run(
        [INCIDENTS[i].message for i in range(4)])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    (engine,) = engines
    expect = expected_counts(cfg, engine._counts, False)
    incident_s = sorted(timer.window()[-(timer.count - n_before):])
    failed = [r.error for r in results if isinstance(r, IncidentFailure)]
    clean = _engine_clean(engines)
    record = dict(
        label=label, model=cfg.name, reranker=None if reranker is None
        else reranker.embedder.cfg.name, rerank_fields_top_k=fields_top_k,
        incidents=4, concurrency=4, completed=4 - len(failed),
        failed=failed, engine_clean=clean, incident_p50_s=statistics.median(incident_s),
        incident_s=incident_s, total_s=total_s,
        analyzer_prompt_tokens=sum(
            r.usage["prompt_tokens"] for r in service.runs.values()
            if r.assistant_id in analyzers),
        analyzer_runs=sum(r.assistant_id in analyzers
                          for r in service.runs.values()),
        reporter_prompt_tokens=sum(
            r.usage["prompt_tokens"] for r in service.runs.values()
            if r.assistant_id in reporters),
        prompt_tokens=sum(r.usage["prompt_tokens"]
                          for r in service.runs.values()),
        encoder_s=encode_s[0], encoder_calls=encode_s[1],
        rerank_scores=[a.get("rerank_scores") for r in results
                       if not isinstance(r, IncidentFailure)
                       for a in r.get("analysis", [])],
        launches=counts, expected_launches=expect,
        nvidia_smi=nvidia_smi_name_power())
    emit("rerank_rca", **record)
    if failed or not clean or counts != expect or not (counts["paged"]
                                                       and counts["flash"]):
        raise SystemExit(f"{label}: failed {failed}, launches {counts} vs "
                         f"{expect}")
    return record


def phase_rerank_rca(e5) -> dict:
    """9c: Llama-3-8B bf16 (seeded) on the soak engine, the four fixture
    incidents at concurrency 4, with ``Reranker(Embedder(E5_LARGE))`` and
    ``rerank_fields_top_k`` 2, then without a reranker (the yardstick):
    both complete, and the reranked sweep's analyzer reads fewer prompt
    tokens.  Returns each sweep's launch counts."""
    import torch

    from k8s_llm_rca_tpu_torch.config import E5_LARGE, LLAMA3_8B
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.rca.rerank import Embedder, Reranker

    cfg = LLAMA3_8B
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    runs = {}
    for label, reranker, k in (
            ("rerank", Reranker(Embedder(E5_LARGE, e5)), 2),
            ("no_rerank", None, 0)):
        runs[label] = rerank_sweep(label, cfg, params, reranker, k)
        free_card()
    with_r, without = runs["rerank"], runs["no_rerank"]
    emit("rerank_rca_summary",
         analyzer_prompt_tokens={k: r["analyzer_prompt_tokens"]
                                 for k, r in runs.items()},
         incident_p50_s={k: r["incident_p50_s"] for k, r in runs.items()},
         encoder_s=with_r["encoder_s"], nvidia_smi=nvidia_smi_name_power())
    if not with_r["analyzer_prompt_tokens"] < \
            without["analyzer_prompt_tokens"]:
        raise SystemExit(f"rerank: the analyzer read "
                         f"{with_r['analyzer_prompt_tokens']} prompt tokens "
                         f"with the reranker, "
                         f"{without['analyzer_prompt_tokens']} without")
    return {"rerank_rca": with_r["launches"],
            "rerank_rca_yardstick": without["launches"]}


def contiguous_step_ms(engine, steps: int = 8, device: bool = True) -> dict:
    """The contiguous engine's eager decode step at batch 4 over 400, 900,
    1500 and 2300 cached tokens of its own cache rows: wall ms per step
    (host clock around ``steps`` steps ending in a sync) and, with
    ``device``, the device ms between CUDA events (``time_ms``).  The
    rows' contents are left as they were: the engine is not used
    after."""
    import torch

    engine.lengths[:] = [400, 900, 1500, 2300]
    engine.cur_tokens[:] = 0
    cur, lens = engine._device_state()
    cfg, params = engine.model_cfg, engine.params

    def step():
        # the engine's own step: under PP the pipelined one
        return engine._decode_fn(cfg, params, engine.cache, cur, lens)[1]

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    out = {"step_wall_ms": wall_ms}
    if device:
        out["step_device_ms"] = time_ms(step, steps)
    engine.lengths[:] = 0
    return out


def draft_case(cfg, params, tok, plain) -> dict:
    """``draft_model=`` on the contiguous engine: a 2-layer draft at the
    8B's widths (bf16, its own seed), ``speculative_k`` 4, the four
    requests; the streams against the plain engine's (``plain``), with
    the first divergence's logit margin where they part."""
    import dataclasses

    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params

    dcfg = cfg.replace(n_layers=2)
    dparams = init_params(dcfg, torch.Generator(device="cuda").manual_seed(7))
    ecfg = slice_engine_config(paged=False, speculative_k=4, decode_chunk=1)
    engine = make_engine(cfg, ecfg, params, tok, draft_model=(dcfg, dparams))
    run = serve_four(engine, cfg, None, None)
    c = engine._counts
    divs = divergences(cfg, params, plain["prompts"], plain["tokens"],
                       run["tokens"])
    out = {"draft_layers": dcfg.n_layers,
           "equal_tokens": run["tokens"] == plain["tokens"],
           "equal_token_share": common_share(plain["tokens"], run["tokens"]),
           "divergences": divs,
           "verify_steps": int(c.get("engine.verify_steps", 0)),
           "spec_drafted": int(c.get("engine.spec_drafted", 0)),
           "spec_accepted": int(c.get("engine.spec_accepted", 0)),
           "draft_prefills": engine._draft.prefills,
           "ttft_s": run["ttft_s"], "decode_tok_per_s":
           run["decode_tok_per_s"], "total_s": run["total_s"]}
    out["acceptance"] = out["spec_accepted"] / max(1, out["spec_drafted"])
    del engine, dparams
    free_card()
    return out


# a first differing token of two bf16 runs of the 8B whose logit margin is
# at most this is a near-tie (two ulps of bf16 at logits of 8-16): the
# verify step and the plain step compute other matmul shapes
NEAR_TIE = 2 ** -3


def phase_contiguous() -> dict:
    """9d: the contiguous engine (``EngineConfig(paged=False)``, eager) on
    Llama-3-8B at ``CUT_LAYERS`` layers (full width), bf16 and int4
    weights over an int4 cache, the slice's
    four requests (400-2300 tokens, batch 4, max_seq_len 2560, 64 new
    tokens) behind AssistantService, exact launches; then the paged
    engine on the same weights: equal tokens, or the first divergence
    with its logit margin.  TTFT, decode tok/s, step ms, peak GB.  In bf16
    also ``draft_model=`` (tokens equal plain greedy's, or a near-tie),
    and the CLI without ``--paged``.  Returns the launch counts."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import InferenceEngine, make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    out = {}
    for phase, bits, kv in (("contiguous", None, None),
                            ("contiguous_int4", 4, "int4")):
        cfg, transform = slice_model("llama3-8b", bits)
        cfg = cfg.replace(n_layers=CUT_LAYERS)
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), tensor_transform=transform)
        tok = get_tokenizer(vocab_size=cfg.vocab_size)
        engine = make_engine(cfg, slice_engine_config(paged=False,
                                                      kv_cache_dtype=kv),
                             params, tok)
        if not isinstance(engine, InferenceEngine):
            raise SystemExit(f"{phase}: make_engine built {type(engine)}")
        run = serve_four(engine, cfg, kv, bits)
        run.update(contiguous_step_ms(engine))
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        del engine
        free_card()
        paged = serve_four(make_engine(cfg, slice_engine_config(
            kv_cache_dtype=kv), params, tok), cfg, kv, bits)
        free_card()
        divs = divergences(cfg, params, run["prompts"], paged["tokens"],
                           run["tokens"])
        record = dict(
            model=cfg.name, layers=cfg.n_layers,
            weights=f"int{bits}" if bits else "bfloat16",
            kv_cache_dtype=kv, fused_quant_matmul=cfg.fused_quant_matmul,
            prompt_tokens=run["prompt_tokens"],
            completion_tokens=run["completion_tokens"],
            equal_tokens_vs_paged=run["tokens"] == paged["tokens"],
            equal_token_share_vs_paged=common_share(paged["tokens"],
                                                    run["tokens"]),
            divergences_vs_paged=divs,
            **{k: v for k, v in run.items()
               if k not in ("tokens", "prompts", "prompt_tokens",
                            "completion_tokens")},
            paged_ttft_s=paged["ttft_s"],
            paged_decode_tok_per_s=paged["decode_tok_per_s"],
            peak_mem_gb=peak_gb)
        counts = run["launches"]
        need = ["flash"] + (["qmm", "qmm_head"] if bits else [])
        if not all(counts[k] for k in need):
            raise SystemExit(f"{phase}: no launches of {need}: {counts}")
        if bits is None:
            record["draft"] = draft_case(cfg, params, tok, run)
            bad = [d for d in record["draft"]["divergences"]
                   if d["logit_margin"] > NEAR_TIE]
            if bad or not record["draft"]["verify_steps"]:
                emit(phase, **record, nvidia_smi=nvidia_smi_name_power())
                raise SystemExit(f"{phase}: draft speculation parts from "
                                 f"greedy beyond a near-tie: {bad}")
        emit(phase, **record, near_tie=NEAR_TIE,
             nvidia_smi=nvidia_smi_name_power())
        out[phase] = counts
        del params
        free_card()
    out["contiguous_cli"] = contiguous_cli_case()
    free_card()
    return out


def contiguous_cli_case() -> dict:
    """The CLI without ``--paged`` (the contiguous engine, the default
    EngineConfig otherwise: batch 8) on Llama-3-8B bf16 at ``CUT_LAYERS``
    layers, one incident,
    ``run_file.main`` in this process: one record, no failure, the
    launches its engine's counters require.  Returns the counts."""
    import torch

    from k8s_llm_rca_tpu_torch.sweeps import run_file
    from k8s_llm_rca_tpu_torch.utils.logging import METRICS

    out = LOAD_DIR / "cli-contiguous.json"
    os.makedirs(LOAD_DIR, exist_ok=True)
    if out.exists():
        out.unlink()
    argv = ["--backend", "engine", "--model", "llama3-8b", "--max-seq-len",
            "2560", "--fresh-threads", "--slice", "0:1", "--input",
            str(ROOT / "data" / "incidents.csv"), "--output", str(out)]
    services, build = [], run_file.build_service

    def built(*args, **kwargs):
        services.append(build(*args, **kwargs))
        return services[-1]

    run_file.build_service = built
    METRICS.reset()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with cli_depth("llama3-8b", CUT_LAYERS):
            summary = run_file.main(argv)
    finally:
        run_file.build_service = build
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    (service,) = services
    engine = service.backend.engine
    expect = expected_counts(engine.model_cfg, engine._counts, False,
                             contiguous=True)
    records, _ = run_file.scan_output(str(out))
    emit("contiguous_cli", command="python -m k8s_llm_rca_tpu_torch.sweeps."
         "run_file " + " ".join(argv), layers=engine.model_cfg.n_layers,
         seconds=seconds,
         engine=type(engine).__name__,
         max_batch=engine.engine_cfg.max_batch,
         incidents=summary["incidents"], failures=summary["failures"],
         wall_s=summary["wall_s"], p50_incident_s=summary["p50_incident_s"],
         chip=summary["chip"], records=len(records),
         decode_steps=int(engine._counts.get("engine.decode_steps", 0)),
         launches=counts, expected_launches=expect,
         nvidia_smi=nvidia_smi_name_power())
    if (summary["incidents"], summary["failures"], len(records)) != (1, 0, 1):
        raise SystemExit(f"contiguous cli: {summary['incidents']} "
                         f"incidents, {summary['failures']} failures, "
                         f"{len(records)} records")
    if type(engine).__name__ != "InferenceEngine" or counts != expect \
            or not counts["flash"]:
        raise SystemExit(f"contiguous cli: {type(engine).__name__}, "
                         f"launches {counts} vs {expect}")
    return counts


def phase_rerank() -> dict:
    """Phase 9: 9a loading, 9b the encoder, 9c rerank in the RCA loop,
    9d the contiguous engine, one model on the card at a time.  Returns
    the launch counts of 9c and 9d, by name."""
    e5 = phase_load()
    free_card()
    phase_encoder(e5)
    free_card()
    out = phase_rerank_rca(e5)
    del e5
    free_card()
    out.update(phase_contiguous())
    return out


# ------------------------------------------------------------------ phase 10


def shard_kernels(table, ws, heads, w_mlp, gen, flush) -> None:
    """Phase 3 at a mesh rank's shapes, bf16 (TP over t = 2 and 4 ranks of
    Llama-3-8B, EP over 2 and 4 of Mixtral-8x7B): paged attention over the
    rank's 32/t query and 8/t kv heads (bf16, int8 and an int4 pool
    packed over the rank's own lanes), flash with 16/4 heads, the int4 kn
    on the rank's column block of w_gate [4096, 14336/t] (repacked per
    group and handed over as a plain int4 weight,
    ``runtime.sharding.leaf_block``) and on its row block of w_down
    [14336/t, 4096], the int4 head on its hidden block [128256, 4096/t],
    and the int8 experts on a local stack of 8/p experts in the per-expert
    form of ``parallel/moe.py`` ([1, 8 slots, 8/p, 4096]), each against its
    plain version, timed beside its bound and library call."""
    import torch

    from k8s_llm_rca_tpu_torch.models.quant import dq
    from k8s_llm_rca_tpu_torch.ops.quant_matmul import (
        kn_body, quant_matmul, quant_matmul_experts,
        quant_matmul_experts_plain, quant_matmul_head,
        quant_matmul_head_plain, quant_matmul_plain,
    )
    from k8s_llm_rca_tpu_torch.runtime.sharding import leaf_block

    dn, dtype = "bfloat16", torch.bfloat16
    for t in (2, 4):
        paged_kernels(table, dn, gen, flush, heads=(32 // t, 8 // t),
                      label=f"tp{t}")
        torch.cuda.empty_cache()

    # flash: the 2560 bucket at seq_len 2300 over a TP-2 rank's 16/4 heads
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    flash_kernels(table, dn, gen, {"tp2 full": (
        rnd(1, 2560, 16, 128), rnd(1, 2560, 4, 128), rnd(1, 2560, 4, 128),
        torch.tensor([2300], dtype=torch.int32, device="cuda"), None)})

    w_down = quant_weight(gen, 14336, 4096)
    for t in (2, 4):
        col = leaf_block(w_mlp, ((1, 0), (t, 0)))       # w_gate's block
        row = leaf_block(w_down, ((t, 0), (1, 0)))      # w_down's block
        cases = [("col", col, 4096, 14336 // t, m) for m in (4, 5120)]
        cases += [("row", row, 14336 // t, 4096, m) for m in (4, 5120)]
        for kind, w, kk, n, m in cases:
            x = torch.randn((m, kk), generator=gen, device="cuda").to(dtype)
            w_dense = dq(w, dtype).to(dtype)
            case = f"tp{t} {kind} M={m}"
            timed_case(table, ("quant_matmul", dn, case), "quant_matmul", dn,
                       lambda: quant_matmul(x, w),
                       quant_matmul_plain(x, w),
                       lambda: quant_matmul_plain(x, w),
                       lambda: torch.matmul(x, w_dense),
                       weight_bound(w, x, m * n, 2 * m * kk * n, dn),
                       200 if m <= 20 else 10, 20 if m <= 20 else 3,
                       flush if m <= 20 else 0, case=case,
                       body=kn_body(4, m, kk, n),
                       shapes=f"x [{m}, {kk}] @ int4 [{kk}, {n}]")
            del w_dense
        head = leaf_block(heads["llama3-8b int4"], ((1, 0), (t, 0)))
        kk, vv = 4096 // t, head.shape[0]
        x = torch.randn((4, kk), generator=gen, device="cuda").to(dtype)
        w_dense = dq(head, dtype).to(dtype)
        case = f"tp{t} llama3-8b int4"
        timed_case(table, ("quant_matmul_head", dn, case),
                   "quant_matmul_head", dn, lambda: quant_matmul_head(x, head),
                   quant_matmul_head_plain(x.float(), head),
                   lambda: quant_matmul_head_plain(x, head),
                   lambda: torch.matmul(x, w_dense.t()),
                   weight_bound(head, x, 4 * vv, 2 * 4 * kk * vv, dn),
                   50, 5, flush, case=case,
                   body=head_body(4, 4, kk, vv, dtype),
                   shapes=f"x [4, {kk}] @ int4 [{vv}, {kk}]^T")
        del w_dense, head, col, row
        torch.cuda.empty_cache()

    gate = ws["gate8"]
    for p in (2, 4):
        w = leaf_block(gate, ((p, 0), (1, 0), (1, 0)))  # this rank's experts
        e, kk, n = w.shape
        x = torch.randn((1, 8, e, kk), generator=gen, device="cuda").to(dtype)
        w_dense = dq(w, dtype).to(dtype)
        xt = x[0].transpose(0, 1).contiguous()
        case = f"ep{p} per-expert M=8"
        timed_case(table, ("quant_matmul_experts_int8", dn, case),
                   "quant_matmul_experts_int8", dn,
                   lambda: quant_matmul_experts(x, w),
                   quant_matmul_experts_plain(x.float(), w),
                   lambda: quant_matmul_experts_plain(x, w),
                   lambda: torch.bmm(xt, w_dense),
                   weight_bound(w, x, 8 * e * n, 2 * 8 * e * kk * n, dn),
                   50, 5, flush, case=case,
                   body=kn_body(8, 8, kk, n, experts=True),
                   shapes=f"x {list(x.shape)} @ int8 [{e}, {kk}, {n}]")
        del w, w_dense
        torch.cuda.empty_cache()


def mesh_engine_config(**over):
    """The slice engine with the prefix cache on, as ``EngineConfig()``
    has it."""
    return slice_engine_config(prefix_cache=True, **over)


def mesh_run(engine, cfg, kv, bits) -> dict:
    """``serve_four`` and the decode step's times on a mesh engine or its
    unsharded yardstick."""
    run = serve_four(engine, cfg, kv, bits)
    run.update(graph_stats(engine))
    run.update(decode_step_times(engine, profiled=False))
    return run


def mesh_compare(phase, cfg, params, base, run, **record) -> None:
    """Emit the mesh run beside its unsharded yardstick; fail unless the
    streams are equal or part only at a near-tie (``NEAR_TIE``), and
    unless the graphed run replayed."""
    divs = divergences(cfg, params, run["prompts"], base["tokens"],
                       run["tokens"])
    bad = [d for d in divs if d["logit_margin"] > NEAR_TIE]
    keep = ("ttft_s", "decode_tok_per_s", "total_s", "wall_ms_per_step",
            "event_device_ms_per_step",
            "graph_captures", "graph_replays", "prefill_dispatches",
            "decode_steps")
    emit(phase, model=cfg.name, **record,
         prompt_tokens=run["prompt_tokens"],
         completion_tokens=run["completion_tokens"],
         equal_tokens=run["tokens"] == base["tokens"],
         equal_token_share=common_share(base["tokens"], run["tokens"]),
         divergences=divs, near_tie=NEAR_TIE,
         collectives={k: run["launches"][k] for k in (
             "all_reduce_sum", "all_reduce_max", "all_gather", "all_to_all",
             "ppermute", "all_gather_into", "reduce_scatter_sum")},
         launches=run["launches"],
         **{f"mesh_{k}": run[k] for k in keep},
         **{f"unsharded_{k}": base[k] for k in keep},
         nvidia_smi=nvidia_smi_name_power())
    if bad:
        raise SystemExit(f"{phase}: the mesh engine's streams part from the "
                         f"unsharded engine's beyond a near-tie: {bad}")
    if not run["graph_replays"]:
        raise SystemExit(f"{phase}: the graphed mesh engine replayed nothing")


def mesh_tp_case(phase, mesh, name, bits, kv) -> dict:
    """10a/10b: a slice model served by the unsharded graphed engine and by
    ``make_engine(..., tp_mesh=mesh)`` on the same weights (the rank's
    shard of a 1-rank mesh is the tree itself, no copy): equal streams
    (or a near-tie), the collectives the layer count requires (checked
    with the launches by ``serve_four``), step ms both ways."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.rules import flatten_with_names
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, transform = mesh_model(name, bits)
    ecfg = mesh_engine_config(kv_cache_dtype=kv)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    base = mesh_run(make_engine(cfg, ecfg, params, tok), cfg, kv, bits)
    free_card()
    shard = shard_params(params, llama_param_specs(cfg), mesh)
    copies = sum(a.data_ptr() != b.data_ptr() for (_, a), (_, b) in zip(
        flatten_with_names(_tensors_tree(params)),
        flatten_with_names(_tensors_tree(shard))))
    engine = make_engine(cfg, ecfg, shard, tok, tp_mesh=mesh)
    run = mesh_run(engine, cfg, kv, bits)
    mesh_compare(phase, cfg, params, base, run, mesh="tp 1 rank (nccl)",
                 weights=f"int{bits}" if bits else "bfloat16",
                 kv_cache_dtype=kv, shard_copies=copies,
                 pool_lanes=engine.pool.k.shape[-1])
    del engine, shard, params
    return run["launches"]


def _tensors_tree(tree):
    """A param tree with each quantized leaf split into its q and scale."""
    if isinstance(tree, dict):
        return {k: _tensors_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors_tree(v) for v in tree]
    if isinstance(tree, tuple):
        return {f: getattr(tree, f) for f in tree._fields}
    return tree


def mesh_ep_case(mesh) -> dict:
    """10c: Mixtral-8x7B int8 (int8 pool) by the dense graphed engine and by
    ``mixtral.make_ep_engine`` on a 1-rank mesh: equal streams (or a
    near-tie), no token dropped (lossless capacity, counted on the
    device), the ekn launches and all-to-alls counted."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models import mixtral
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    phase = "mesh_mixtral"
    cfg, transform = mesh_model("mixtral-8x7b", 8)
    ecfg = mesh_engine_config(kv_cache_dtype="int8")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    base = mesh_run(make_engine(cfg, ecfg, params, tok), cfg, "int8", 8)
    free_card()
    engine = mixtral.make_ep_engine(cfg, ecfg, params, tok, mesh=mesh)
    run = mesh_run(engine, cfg, "int8", 8)
    dropped = int(engine.model_cfg.ep.drops)
    mesh_compare(phase, cfg, params, base, run, mesh="ep 1 rank (nccl)",
                 weights="int8", kv_cache_dtype="int8", dropped=dropped)
    if dropped or not run["launches"]["qmm_experts8"]:
        raise SystemExit(f"{phase}: {dropped} tokens dropped, "
                         f"{run['launches']['qmm_experts8']} ekn launches")
    del engine, params
    return run["launches"]


def mesh_prompts(tok) -> list:
    """Four prompts of the slice's lengths (400-2300 tokens)."""
    return [tok.encode(incident_text(n - 1), add_bos=True)
            for n in (400, 900, 1500, 2300)]


def tp2_rank(rank: int, n_layers: int, max_new: int) -> dict:
    """One of two ranks on the one card (gloo collectives over CUDA
    tensors): Llama-3-8B cut to ``n_layers`` layers, seeded as the parent
    seeds it, this rank's TP shard, the eager engine over four prompts."""
    import torch

    sys.path.insert(0, str(ROOT))
    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import (
        collective_counts, local_mesh,
    )
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = LLAMA3_8B.replace(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    mesh = local_mesh(model=2)
    shard = shard_params(params, llama_param_specs(cfg), mesh)
    del params
    torch.cuda.empty_cache()
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    engine = make_engine(cfg, mesh_engine_config(), shard, tok,
                         cuda_graphs=False, tp_mesh=mesh)
    t0 = time.perf_counter()
    res = engine.generate(mesh_prompts(tok), max_new_tokens=max_new)
    torch.cuda.synchronize()
    engine.allocator.check()
    return {"tokens": [r.token_ids for r in res],
            "seconds": time.perf_counter() - t0,
            "collectives": collective_counts(),
            "pool_lanes": engine.pool.k.shape[-1]}


def mesh_tp2_case(mesh) -> None:
    """10d: Llama-3-8B cut to 2 layers at TP = 2 as two processes on the one
    card over gloo (``run_ranks``), eager, held to the same model served
    on the 1-rank nccl mesh, eager: equal streams or a near-tie, and both
    ranks' streams equal."""
    import torch

    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    n_layers, max_new = 2, 8
    cfg = LLAMA3_8B.replace(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    prompts = mesh_prompts(tok)
    one = make_engine(cfg, mesh_engine_config(),
                      shard_params(params, llama_param_specs(cfg), mesh),
                      tok, cuda_graphs=False, tp_mesh=mesh)
    want = [r.token_ids for r in one.generate(prompts,
                                              max_new_tokens=max_new)]
    del one
    t0 = time.perf_counter()
    ranks = run_ranks(tp2_rank, 2, str(ROOT / "build" / "mesh_ranks"),
                      args=(n_layers, max_new), timeout_s=600,
                      device="cuda-gloo")
    wall = time.perf_counter() - t0
    divs = divergences(cfg, params, prompts, want, ranks[0]["tokens"])
    bad = [d for d in divs if d["logit_margin"] > NEAR_TIE]
    emit("mesh_tp2", model=cfg.name, layers=n_layers, ranks=2,
         backend="gloo", cuda_graphs=False,
         equal_tokens=ranks[0]["tokens"] == want,
         equal_token_share=common_share(want, ranks[0]["tokens"]),
         ranks_equal=ranks[0]["tokens"] == ranks[1]["tokens"],
         divergences=divs, near_tie=NEAR_TIE,
         rank_seconds=[r["seconds"] for r in ranks], wall_s=wall,
         collectives=[r["collectives"] for r in ranks],
         pool_lanes=[r["pool_lanes"] for r in ranks],
         nvidia_smi=nvidia_smi_name_power())
    if ranks[0]["tokens"] != ranks[1]["tokens"] or bad:
        raise SystemExit(f"mesh_tp2: ranks equal "
                         f"{ranks[0]['tokens'] == ranks[1]['tokens']}, "
                         f"beyond a near-tie {bad}")
    del params


def phase_mesh() -> dict:
    """Phase 10 under a 1-rank nccl process group (destroyed after).
    Returns the launch counts of 10a-10c."""
    from k8s_llm_rca_tpu_torch.runtime import mesh as rmesh

    t0 = time.perf_counter()
    rmesh.initialize_distributed()
    out = {}
    try:
        mesh = rmesh.local_mesh()
        for phase, bits, kv in (("mesh", None, None),
                                ("mesh_int4", 4, "int4")):
            out[phase] = mesh_tp_case(phase, mesh, "llama3-8b", bits, kv)
            free_card()
        out["mesh_mixtral"] = mesh_ep_case(mesh)
        free_card()
        mesh_tp2_case(mesh)
        free_card()
    finally:
        rmesh.shutdown_distributed()
    emit("mesh_phase", seconds=time.perf_counter() - t0)
    return out


# ------------------------------------------------------------------ phase 11


def cp_lse_kernels(table, gen, flush) -> None:
    """Phase 3 at a CP-2 rank's share, bf16: rows 1 and 2 with
    ``return_lse`` (the rank-local decode of the page-sharded pool) over
    one half of each 40-page table, each slot's length clamped to the
    half's 1280 positions, at both length mixes and both ranks (rank 1's
    share of the mixed mix is empty for three slots: lse -1e30, output
    0), the bf16, int8 and int4 pools; and the CP verify step's fold
    (``cp_fold_case``: 20 rows, some of them empty on rank 1).  Out
    against the plain version (``TOL``), lse at atol 1e-3, timed beside
    the same call without the lse, its bound (the rank's rows, q, out and
    lse; a folded slot's pages once) and SDPA over the rank's gathered
    pages."""
    import torch

    from k8s_llm_rca_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_plain, paged_attention_quant,
        paged_attention_quant_plain,
    )

    dn, span = "bfloat16", 20 * 64
    cases = [(mix, paged_case(torch.bfloat16, gen, lengths=lengths), 1)
             for mix, lengths in PAGED_LENGTHS.items()]
    cases.append(("verify fold", cp_fold_case(gen), FOLD_T))
    for mix, args, t in cases:
        lens, tables = args[3], args[4]
        for rank in (0, 1):
            part = args[:3] + ((lens - rank * span).clamp(0, span)
                               .to(torch.int32),
                               tables[:, 20 * rank:20 * (rank + 1)]
                               .contiguous())
            for pool in ("bf16", "int8", "int4"):
                if pool == "bf16":
                    pargs, packed, kernel = part, None, "paged_attention"
                    run = lambda: paged_attention(*pargs, return_lse=True)
                    no_lse = lambda: paged_attention(*pargs)
                    plain = lambda: paged_attention_plain(*pargs, True)
                    library = paged_library_fn(*pargs)
                else:
                    packed = pool == "int4"
                    pargs = paged_quant_case(part, packed)
                    kernel = "paged_attention_quant"
                    run = lambda: paged_attention_quant(
                        *pargs, packed=packed, return_lse=True)
                    no_lse = lambda: paged_attention_quant(*pargs,
                                                           packed=packed)
                    plain = lambda: paged_attention_quant_plain(
                        *pargs, packed, True)
                    library = paged_quant_library_fn(*pargs, packed)
                out, lse = run()
                ref, ref_lse = plain()
                case = f"cp2 rank{rank} {mix} {pool} lse"
                rec = held_record(kernel, dn, out, ref, case=case,
                                  shapes=f"B={out.shape[0]} H=32 n_kv=8 "
                                  f"d=128 page=64 pps=20 lens=" + ",".join(
                                      map(str, part[3].tolist())))
                if t > 1:
                    # rows of no key: lse -1e30 and a zero output
                    empty = part[3] == 0
                    rec["empty_rows"] = int(empty.sum())
                    if not (torch.all(lse[empty] == -1e30)
                            and torch.all(out[empty] == 0)):
                        emit("kernels", **rec)
                        raise SystemExit(f"{kernel} {case}: an empty row "
                                         f"is not lse -1e30 and zero")
                rec["lse_max_abs_err"] = (lse - ref_lse).abs().max().item()
                rec["lse_tol"] = 1e-3
                if rec["lse_max_abs_err"] > 1e-3:
                    emit("kernels", **rec)
                    raise SystemExit(f"{kernel} {case}: lse off its plain "
                                     f"version by {rec['lse_max_abs_err']}")
                rec["kernel_ms"] = time_ms(run, 200, flush_bytes=flush)
                rec["kernel_ms_without_lse"] = time_ms(no_lse, 200,
                                                       flush_bytes=flush)
                rec["plain_ms"] = time_ms(plain, 20, flush_bytes=flush)
                rec["library_ms"] = time_ms(library, 200, flush_bytes=flush)
                # a folded slot's pages are read once, for its last query
                rec["bound_ms"], rec["bound_by"] = paged_bound(
                    pargs[0], pargs[1], pargs[-2].reshape(-1, t).amax(-1),
                    dn, scale_bytes=0 if packed is None else 4,
                    extra_bytes=4 * out.shape[0] * out.shape[1])
                emit("kernels", **rec)
                table[(kernel, dn, case)] = rec


# the CP verify step at the slice's shapes: batch 4, T = speculative_k + 1
# queries a slot at these lengths (the third slot's queries cross rank 1's
# range at 1280)
FOLD_T = 5
FOLD_LENGTHS = [400, 900, 1276, 2290]


def cp_fold_case(gen):
    """The paged engine's CP verify step folded into the batch
    (``engine/paged.py::_cp_fold_view``): 20 rows, row (b, i) query i of
    slot b over slot b's table at ``FOLD_LENGTHS[b] + 1 + i`` positions,
    the slice's 168-page pool.  (q [20, 32, 128], k and v pages, lengths
    [20], tables [20, 40]) as ``paged_case`` gives them."""
    import torch

    _, kp, vp, _, tables = paged_case(
        torch.bfloat16, gen, lengths=[n + FOLD_T for n in FOLD_LENGTHS])
    q = torch.randn((len(FOLD_LENGTHS) * FOLD_T, 32, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    lens = torch.tensor([n + 1 + i for n in FOLD_LENGTHS
                         for i in range(FOLD_T)], dtype=torch.int32,
                        device="cuda")
    return (q, kp, vp, lens,
            tables.repeat_interleave(FOLD_T, dim=0).contiguous())


# one GPipe microbatch of the slice's decode batch (B = 4 over M = 2): the
# mixed mix's first two lengths, the long mix's half
MICROBATCH_LENGTHS = {"mixed": [1, 64], "long": [2400, 2400]}


def microbatch_paged_kernels(table, gen, flush) -> None:
    """Phase 3 at one PP microbatch's shape, bf16: rows 1 and 2 (bf16, int8
    and int4 pools) over B = 2 slots of the slice's 168-page pool and
    40-page tables, at ``MICROBATCH_LENGTHS``: each against its plain
    version (``TOL``), timed beside its bound and SDPA over the gathered
    pages.  The PP decode step makes these calls M = 2 times a layer."""
    import torch

    from k8s_llm_rca_tpu_torch.ops.paged_attention import (
        launched_splits, paged_attention, paged_attention_plain,
        paged_attention_quant, paged_attention_quant_plain,
    )

    dn = "bfloat16"
    for mix, lengths in MICROBATCH_LENGTHS.items():
        args = paged_case(torch.bfloat16, gen, lengths=lengths)
        for pool in ("bf16", "int8", "int4"):
            if pool == "bf16":
                pargs, packed, kernel = args, None, "paged_attention"
                run = lambda: paged_attention(*pargs)
                plain = lambda: paged_attention_plain(*pargs)
                library = paged_library_fn(*pargs)
                splits = launched_splits(pargs[0], pargs[1], pargs[4])
            else:
                packed = pool == "int4"
                pargs = paged_quant_case(args, packed)
                kernel = "paged_attention_quant"
                run = lambda: paged_attention_quant(*pargs, packed=packed)
                plain = lambda: paged_attention_quant_plain(*pargs,
                                                            packed=packed)
                library = paged_quant_library_fn(*pargs, packed)
                splits = launched_splits(pargs[0], pargs[1], pargs[6],
                                         packed)
            case = f"pp mb {mix} {pool}"
            rec = held_record(kernel, dn, run(), plain(), case=case,
                              splits=splits,
                              shapes="B=2 H=32 n_kv=8 d=128 page=64 "
                              "pages=168 pps=40 lens="
                              + ",".join(map(str, lengths)))
            rec["kernel_ms"] = time_ms(run, 200, flush_bytes=flush)
            rec["plain_ms"] = time_ms(plain, 20, flush_bytes=flush)
            rec["library_ms"] = time_ms(library, 200, flush_bytes=flush)
            rec["bound_ms"], rec["bound_by"] = paged_bound(
                pargs[0], pargs[1], pargs[-2], dn,
                scale_bytes=0 if packed is None else 4)
            emit("kernels", **rec)
            table[(kernel, dn, case)] = rec


def cp_engine_case(phase, mesh, name, bits, kv, modes) -> dict:
    """11a/11b: a slice model by the unsharded graphed engine and by
    ``make_engine(..., cp_mesh=mesh, cp_mode=)`` in each of ``modes`` on
    the same weights: equal streams (or a near-tie), the launches and the
    collectives the layer count requires, the graphed step's ms both
    ways, the analytic model's fields.  Returns the launches by phase."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, transform = mesh_model(name, bits)
    ecfg = slice_engine_config(kv_cache_dtype=kv)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    base = mesh_run(make_engine(cfg, ecfg, params, tok), cfg, kv, bits)
    free_card()
    out = {}
    for mode in modes:
        engine = make_engine(cfg, ecfg, params, tok, cp_mesh=mesh,
                             cp_mode=mode)
        run = mesh_run(engine, cfg, kv, bits)
        mesh_compare(f"{phase}_{mode}", cfg, params, base, run,
                     mesh=f"cp {mode} 1 rank (nccl)",
                     weights=f"int{bits}" if bits else "bfloat16",
                     kv_cache_dtype=kv, pool_pages=engine.pool.k.shape[1],
                     **{f"mesh_{k}": v for k, v in
                        roofline_fields(cfg, run, bits, kv).items()},
                     **{f"unsharded_{k}": v for k, v in
                        roofline_fields(cfg, base, bits, kv).items()})
        out[f"{phase}_{mode}"] = run["launches"]
        del engine
        free_card()
    del params
    return out


def cp2_rank(rank: int, n_layers: int, max_new: int) -> dict:
    """One of two ranks on the one card (gloo over CUDA tensors):
    Llama-3-8B cut to ``n_layers`` layers, seeded as the parent seeds it,
    on a seq = 2 mesh, the eager CP engine over four prompts, ring and
    then Ulysses."""
    import torch

    sys.path.insert(0, str(ROOT))
    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import (
        collective_counts, local_mesh, reset_collective_counts,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = LLAMA3_8B.replace(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    mesh = local_mesh(seq=2)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    out = {}
    for mode in ("ring", "ulysses"):
        reset_collective_counts()
        engine = make_engine(cfg, slice_engine_config(), params, tok,
                             cuda_graphs=False, cp_mesh=mesh, cp_mode=mode)
        t0 = time.perf_counter()
        res = engine.generate(mesh_prompts(tok), max_new_tokens=max_new)
        torch.cuda.synchronize()
        engine.allocator.check()
        out[mode] = {"tokens": [r.token_ids for r in res],
                     "seconds": time.perf_counter() - t0,
                     "collectives": collective_counts(),
                     "pool_pages": engine.pool.k.shape[1]}
        del engine
    return out


def cp_gloo_case(mesh) -> None:
    """11c: Llama-3-8B cut to 2 layers at CP = 2 as two processes on the
    one card over gloo (``run_ranks``), eager, ring and Ulysses, each held
    to the same model on the 1-rank nccl mesh in the same mode, eager:
    both ranks' streams equal, and equal to the 1-rank run's or parting
    at a near-tie (``NEAR_TIE``)."""
    import torch

    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    n_layers, max_new = 2, 8
    cfg = LLAMA3_8B.replace(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    prompts = mesh_prompts(tok)
    want = {}
    for mode in ("ring", "ulysses"):
        one = make_engine(cfg, slice_engine_config(), params, tok,
                          cuda_graphs=False, cp_mesh=mesh, cp_mode=mode)
        want[mode] = [r.token_ids for r in one.generate(
            prompts, max_new_tokens=max_new)]
        del one
    t0 = time.perf_counter()
    ranks = run_ranks(cp2_rank, 2, str(ROOT / "build" / "cp_ranks"),
                      args=(n_layers, max_new), timeout_s=600,
                      device="cuda-gloo")
    wall = time.perf_counter() - t0
    failed = []
    for mode in ("ring", "ulysses"):
        got = [r[mode] for r in ranks]
        divs = divergences(cfg, params, prompts, want[mode],
                           got[0]["tokens"])
        bad = [d for d in divs if d["logit_margin"] > NEAR_TIE]
        equal_ranks = got[0]["tokens"] == got[1]["tokens"]
        emit("cp_gloo", model=cfg.name, layers=n_layers, ranks=2,
             cp_mode=mode, backend="gloo", cuda_graphs=False,
             equal_tokens=got[0]["tokens"] == want[mode],
             equal_token_share=common_share(want[mode], got[0]["tokens"]),
             ranks_equal=equal_ranks, divergences=divs, near_tie=NEAR_TIE,
             rank_seconds=[r["seconds"] for r in got], wall_s=wall,
             collectives=[r["collectives"] for r in got],
             pool_pages=[r["pool_pages"] for r in got],
             nvidia_smi=nvidia_smi_name_power())
        if not equal_ranks or bad:
            failed.append((mode, equal_ranks, bad))
    if failed:
        raise SystemExit(f"cp_gloo: (mode, ranks equal, beyond a near-tie) "
                         f"{failed}")
    del params


def phase_cp() -> dict:
    """Phase 11 under a 1-rank nccl process group (destroyed after): 11a
    Llama-3-8B bf16 ring and Ulysses, 11b int4 weights over an int4 pool
    (ring), 11c CP = 2 over gloo.  Returns the launch counts of 11a-11b."""
    from k8s_llm_rca_tpu_torch.runtime import mesh as rmesh

    t0 = time.perf_counter()
    rmesh.initialize_distributed()
    out = {}
    try:
        mesh = rmesh.local_mesh()
        out.update(cp_engine_case("cp", mesh, "llama3-8b", None, None,
                                  ("ring", "ulysses")))
        free_card()
        out.update(cp_engine_case("cp_int4", mesh, "llama3-8b", 4, "int4",
                                  ("ring",)))
        free_card()
        cp_gloo_case(mesh)
        free_card()
    finally:
        rmesh.shutdown_distributed()
    emit("cp_phase", seconds=time.perf_counter() - t0)
    return out


# ------------------------------------------------------------------ phase 12


PP_MICROBATCHES = 2


def pp_fields(engine) -> dict:
    """A PP engine's schedule: stages, microbatches, the bubble fraction
    ((P - 1) / (M + P - 1), ``runtime/profiling.py``), its stage's layers
    and pool layers."""
    from k8s_llm_rca_tpu_torch.runtime import profiling

    pp = engine.model_cfg.pp
    return {"stages": pp.size, "microbatches": pp.microbatches,
            "bubble_fraction": profiling.pp_bubble_fraction(
                pp.size, pp.microbatches),
            "stage_layers": len(engine.params["layers"]),
            "pool_layers": engine.pool.k.shape[0]}


def pp_hit_case(engine, prompt, kv, bits, label: str = "pp") -> dict:
    """One prompt served before on ``engine`` submitted again: it must hit
    through the chunk prefill (under PP the pipelined one,
    ``paged_pp_prefill_chunk``), with the launches and collectives its
    counters require."""
    import torch

    before = dict(engine._counts)
    reset_counts()
    engine.generate([prompt], max_new_tokens=8)
    torch.cuda.synchronize()
    counts = read_counts()
    c = counts_since(engine, before)
    expect = expected_counts(engine.model_cfg, c, kv is not None, bits)
    hit = int(c.get("engine.prefix_hit_tokens", 0))
    chunks = int(c.get("engine.chunk_prefill_dispatches", 0))
    if counts != expect or not hit or not chunks:
        raise SystemExit(f"{label} resubmit: {hit} hit tokens, {chunks} chunk "
                         f"prefills, launches {counts} != {expect}")
    return {"hit_tokens": hit, "chunk_prefills": chunks, "launches": counts}


def pp_engine_case(phase, mesh, name, bits, kv) -> tuple:
    """12a/12b: a slice model (prefix cache on) by the unsharded graphed
    engine and by ``make_engine(..., pp_mesh=mesh, pp_microbatches=2)`` on
    the rank's stage of the same weights (on one rank the tree itself),
    graphed: equal streams or a near-tie (``NEAR_TIE``), exact launches
    and collectives, the graphed PP step's wall and event ms beside the
    unsharded step's, the peak GB, and the first prompt resubmitted as a
    prefix hit through the pipelined chunk prefill.  Returns (the serve
    run's launches, the config, the weights)."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.sharding import shard_stage_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, transform = mesh_model(name, bits)
    ecfg = mesh_engine_config(kv_cache_dtype=kv)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    base = mesh_run(make_engine(cfg, ecfg, params, tok), cfg, kv, bits)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    engine = make_engine(cfg, ecfg, shard_stage_params(params, cfg, mesh),
                         tok, pp_mesh=mesh, pp_microbatches=PP_MICROBATCHES)
    run = serve_four(engine, cfg, kv, bits)
    # the resubmit before the step timing, which writes its own tables
    hit = pp_hit_case(engine, run["prompts"][0], kv, bits)
    run.update(graph_stats(engine))
    run.update(decode_step_times(engine, profiled=False))
    mesh_compare(phase, cfg, params, base, run, mesh="pp 1 rank (nccl)",
                 weights=f"int{bits}" if bits else "bfloat16",
                 kv_cache_dtype=kv, **pp_fields(engine),
                 resubmit=hit,
                 peak_gb=torch.cuda.max_memory_allocated() / 2**30,
                 **{f"mesh_{k}": v for k, v in
                    roofline_fields(engine.model_cfg, run, bits, kv).items()},
                 **{f"unsharded_{k}": v for k, v in
                    roofline_fields(cfg, base, bits, kv).items()})
    del engine
    free_card()
    return run["launches"], cfg, params


def stage_transform(n_layers: int, stage: int, n_stages: int):
    """A ``tensor_transform`` for ``init_params`` that keeps the matmul
    weights of one stage's layers (and the embedding and head) and drops
    the others as they are made: the generator runs exactly as for the
    whole model, so the kept weights are the whole model's, but the rank
    never holds more than its stage."""
    import torch

    made = [0]
    per = n_layers // n_stages

    def keep(w, axis=-1):
        # a dense layer makes 7 (wq, wk, wv, wo, w_gate, w_up, w_down)
        layer = made[0] // 7
        made[0] += 1
        if layer < n_layers and not stage * per <= layer < (stage + 1) * per:
            return torch.empty(0, dtype=w.dtype, device=w.device)
        return w

    return keep


def rank_served(engine, prompts, max_new, kv, bits) -> dict:
    """An eager rank's engine over ``prompts``: tokens, seconds, and its
    launches and collectives held to its counters."""
    import torch

    reset_counts()
    before = dict(engine._counts)
    t0 = time.perf_counter()
    res = engine.generate(prompts, max_new_tokens=max_new)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    engine.allocator.check()
    counts = read_counts()
    expect = expected_counts(engine.model_cfg, counts_since(engine, before),
                             kv is not None, bits)
    return {"tokens": [r.token_ids for r in res], "seconds": seconds,
            "launches": counts, "launches_exact": counts == expect,
            "expected": expect}


def pp2_rank(rank: int, n_layers: int, max_new: int) -> dict:
    """One of two stages on the one card (gloo over CUDA tensors):
    Llama-3-8B bf16 cut to ``n_layers``, this rank's stage made by the
    parent's generator (``stage_transform``), the eager PP engine over
    four prompts, its peak GB."""
    import torch

    sys.path.insert(0, str(ROOT))
    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import local_mesh
    from k8s_llm_rca_tpu_torch.runtime.sharding import stage_layers
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = LLAMA3_8B.replace(n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    params = stage_layers(init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0),
        tensor_transform=stage_transform(cfg.n_layers, rank, 2)), 2, rank)
    mesh = local_mesh(stage=2)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    engine = make_engine(cfg, mesh_engine_config(), params, tok,
                         cuda_graphs=False, pp_mesh=mesh,
                         pp_microbatches=PP_MICROBATCHES)
    out = rank_served(engine, mesh_prompts(tok), max_new, None, None)
    out.update(pp_fields(engine),
               peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


def pptp_rank(rank: int, n_layers: int, max_new: int) -> dict:
    """One of four ranks (stage 2 x model 2) on the one card over gloo:
    Llama-3-8B cut to ``n_layers`` layers with int4 weights over an int4
    pool, this rank's stage and TP shard, the eager engine."""
    import torch

    sys.path.insert(0, str(ROOT))
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import local_mesh
    from k8s_llm_rca_tpu_torch.runtime.sharding import shard_stage_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, transform = slice_model("llama3-8b", 4)
    cfg = cfg.replace(n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    mesh = local_mesh(stage=2, model=2)
    shard = shard_stage_params(params, cfg, mesh)
    del params
    torch.cuda.empty_cache()
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    engine = make_engine(cfg, mesh_engine_config(kv_cache_dtype="int4"),
                         shard, tok, cuda_graphs=False, pp_mesh=mesh,
                         tp_mesh=mesh, pp_microbatches=PP_MICROBATCHES)
    out = rank_served(engine, mesh_prompts(tok), max_new, "int4", 4)
    out.update(pp_fields(engine), pool_lanes=engine.pool.k.shape[-1],
               peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


def pp_gloo_cases(mesh, cfg, params) -> None:
    """12c: Llama-3-8B bf16 (``MESH_LAYERS``) at PP = 2 as two gloo
    processes on the one card, eager, each holding its stage and its half of
    the pool: both ranks' streams equal, held to the same model on the
    1-rank nccl mesh (eager) to a near-tie, each rank's peak GB against
    the whole model's.  12d: 8B cut to 4 layers, int4 over an int4 pool,
    at PP = 2 x TP = 2 as four gloo processes: the four ranks equal.
    Every rank's launches and collectives exact."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks
    from k8s_llm_rca_tpu_torch.runtime.sharding import shard_stage_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    max_new = 8
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    prompts = mesh_prompts(tok)
    one = make_engine(cfg, mesh_engine_config(),
                      shard_stage_params(params, cfg, mesh), tok,
                      cuda_graphs=False, pp_mesh=mesh,
                      pp_microbatches=PP_MICROBATCHES)
    want = [r.token_ids for r in one.generate(prompts,
                                              max_new_tokens=max_new)]
    del one
    free_card()
    failed = []
    for phase, fn, n, args in (
            ("pp_gloo", pp2_rank, 2, (cfg.n_layers, max_new)),
            ("pp_tp_gloo", pptp_rank, 4, (GLOO4_LAYERS, max_new))):
        t0 = time.perf_counter()
        ranks = run_ranks(fn, n, str(ROOT / "build" / "pp_ranks"),
                          args=args, timeout_s=600, device="cuda-gloo")
        wall = time.perf_counter() - t0
        equal = all(r["tokens"] == ranks[0]["tokens"] for r in ranks)
        exact = all(r["launches_exact"] for r in ranks)
        rec = dict(ranks=n, backend="gloo", cuda_graphs=False,
                   ranks_equal=equal, launches_exact=exact,
                   rank_seconds=[r["seconds"] for r in ranks], wall_s=wall,
                   launches=[r["launches"] for r in ranks],
                   peak_gb=[r["peak_gb"] for r in ranks],
                   **{k: ranks[0][k] for k in (
                       "stages", "microbatches", "bubble_fraction",
                       "stage_layers", "pool_layers")})
        bad = []
        if phase == "pp_gloo":
            divs = divergences(cfg, params, prompts, want, ranks[0]["tokens"])
            bad = [d for d in divs if d["logit_margin"] > NEAR_TIE]
            rec.update(model=cfg.name, layers=cfg.n_layers, weights="bfloat16",
                       equal_tokens=ranks[0]["tokens"] == want,
                       equal_token_share=common_share(want,
                                                      ranks[0]["tokens"]),
                       divergences=divs, near_tie=NEAR_TIE)
        else:
            rec.update(model=cfg.name, layers=GLOO4_LAYERS, weights="int4",
                       kv_cache_dtype="int4", tp=2,
                       pool_lanes=[r["pool_lanes"] for r in ranks])
        emit(phase, **rec, nvidia_smi=nvidia_smi_name_power())
        if not equal or not exact or bad:
            failed.append((phase, equal, exact, bad))
        free_card()
    if failed:
        raise SystemExit(f"pp gloo: (phase, ranks equal, launches exact, "
                         f"beyond a near-tie) {failed}")


def pp_ep_case(mesh) -> dict:
    """12e: Mixtral-8x7B int8 cut to 4 layers at full width over an int8
    pool (prefix cache off, as PP x EP requires), the dense graphed engine
    and ``make_engine(..., pp_mesh=mesh, ep_mesh=mesh,
    pp_microbatches=2)`` on the 1-rank stage x expert mesh, graphed:
    equal streams or a near-tie, no token dropped, exact launches and
    collectives."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.sharding import shard_stage_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    phase = "pp_mixtral"
    cfg, transform = slice_model("mixtral-8x7b", 8)
    cfg = cfg.replace(n_layers=4)
    ecfg = slice_engine_config(kv_cache_dtype="int8")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    base = mesh_run(make_engine(cfg, ecfg, params, tok), cfg, "int8", 8)
    free_card()
    engine = make_engine(cfg, ecfg, shard_stage_params(params, cfg, mesh),
                         tok, pp_mesh=mesh, ep_mesh=mesh,
                         pp_microbatches=PP_MICROBATCHES)
    run = mesh_run(engine, cfg, "int8", 8)
    dropped = int(engine.model_cfg.ep.drops)
    mesh_compare(phase, cfg, params, base, run, mesh="pp x ep 1 rank (nccl)",
                 weights="int8", kv_cache_dtype="int8", layers=4,
                 dropped=dropped, **pp_fields(engine))
    if dropped or not run["launches"]["qmm_experts8"]:
        raise SystemExit(f"{phase}: {dropped} tokens dropped, "
                         f"{run['launches']['qmm_experts8']} ekn launches")
    del engine, params
    return run["launches"]


def phase_pp() -> dict:
    """Phase 12 under a 1-rank nccl process group (destroyed after): 12a
    Llama-3-8B bf16 and 12b int4 over int4 at PP on one rank, 12c PP = 2
    (``MESH_LAYERS``) and 12d PP = 2 x TP = 2 over gloo, 12e Mixtral int8 at
    PP x EP.  Returns the launch counts of 12a, 12b and 12e."""
    from k8s_llm_rca_tpu_torch.runtime import mesh as rmesh

    t0 = time.perf_counter()
    rmesh.initialize_distributed()
    out = {}
    try:
        mesh = rmesh.local_mesh()
        out["pp"], cfg, params = pp_engine_case("pp", mesh, "llama3-8b",
                                                None, None)
        pp_gloo_cases(mesh, cfg, params)
        del params
        free_card()
        out["pp_int4"], _, params = pp_engine_case("pp_int4", mesh,
                                                   "llama3-8b", 4, "int4")
        del params
        free_card()
        out["pp_mixtral"] = pp_ep_case(mesh)
        free_card()
    finally:
        rmesh.shutdown_distributed()
    emit("pp_phase", seconds=time.perf_counter() - t0)
    return out


# ------------------------------------------------------------------ phase 13


def fsdp_fields(engine) -> dict:
    """An FSDP engine's sizes (``runtime/profiling.py``, reported, not
    gated): the fsdp axis, the parameter bytes the rank holds, the bytes a
    forward gathers and the least NVLink time of those at this axis and at
    fsdp 2 (what two cards would add to a step at least)."""
    from k8s_llm_rca_tpu_torch.runtime import profiling

    cfg = engine.model_cfg
    n = cfg.fsdp.size
    per_rank = profiling.fsdp_gather_bytes(cfg, engine.params, 1)
    return {"fsdp": n, "param_bytes_rank": profiling.param_bytes(
                engine.params),
            "gather_bytes_forward": n * per_rank,
            "gather_link_ms": profiling.fsdp_gather_link_ms(n * per_rank, n),
            "gather_link_ms_at_fsdp2": profiling.fsdp_gather_link_ms(
                n * per_rank, 2)}


def kernel_launches(counts: dict) -> dict:
    """A launch count dict without the collectives."""
    from k8s_llm_rca_tpu_torch.runtime.mesh import COLLECTIVES

    names = {fn.__name__ for fn in COLLECTIVES}
    return {k: v for k, v in counts.items() if k not in names}


def require_equal(phase: str, base: dict, run: dict) -> None:
    """FSDP and SP compute what the unsharded (or TP) engine computes on
    the same bytes: the streams must be equal and the kernels the same."""
    if run["tokens"] != base["tokens"]:
        raise SystemExit(f"{phase}: the streams part from the reference "
                         f"engine's (share "
                         f"{common_share(base['tokens'], run['tokens'])})")
    if kernel_launches(run["launches"]) != kernel_launches(base["launches"]):
        raise SystemExit(f"{phase}: kernel launches "
                         f"{kernel_launches(run['launches'])} != the "
                         f"reference's {kernel_launches(base['launches'])}")


def fsdp_engine_case(phase, mesh, name, bits, kv) -> tuple:
    """13a/13b: a slice model (prefix cache on) by the unsharded graphed
    engine and by ``make_engine(..., fsdp_mesh=mesh)`` on the rank's fsdp
    shard of the same weights (on one rank the tree itself), graphed:
    equal streams and kernel launches, the gathers counted, the step's
    wall and event ms both ways, the peak GB, the rank's parameter and
    gathered bytes, and the first prompt resubmitted as a prefix hit.
    Returns (the serve run's launches, the config, the weights)."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, transform = mesh_model(name, bits)
    ecfg = mesh_engine_config(kv_cache_dtype=kv)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    base = mesh_run(make_engine(cfg, ecfg, params, tok), cfg, kv, bits)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    engine = make_engine(cfg, ecfg, shard_params(
        params, llama_param_specs(cfg, FSDP_LAYOUT), mesh), tok,
        fsdp_mesh=mesh)
    run = serve_four(engine, cfg, kv, bits)
    hit = pp_hit_case(engine, run["prompts"][0], kv, bits, label=phase)
    run.update(graph_stats(engine))
    run.update(decode_step_times(engine, profiled=False))
    mesh_compare(phase, cfg, params, base, run, mesh="fsdp 1 rank (nccl)",
                 weights=f"int{bits}" if bits else "bfloat16",
                 kv_cache_dtype=kv, **fsdp_fields(engine), resubmit=hit,
                 peak_gb=torch.cuda.max_memory_allocated() / 2**30,
                 pool_lanes=engine.pool.k.shape[-1])
    require_equal(phase, base, run)
    del engine
    free_card()
    return run["launches"], cfg, params


def fsdp_transform(cfg, mesh):
    """A ``tensor_transform`` for ``init_params`` that keeps only this
    rank's fsdp block of each matmul weight as it is made
    (``runtime.sharding.shard_leaf`` under ``FSDP_LAYOUT``): the generator
    runs exactly as for the whole model, so the blocks are the whole
    model's, but the rank never holds more than its blocks and one whole
    weight."""
    from k8s_llm_rca_tpu_torch.runtime.rules import flatten_with_names
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_leaf,
    )

    specs = dict(flatten_with_names(llama_param_specs(cfg, FSDP_LAYOUT)))
    # init_params makes a dense layer's 7 weights in this order, then the
    # embedding and the head
    order = [f"layers/{i}/{k}" for i in range(cfg.n_layers)
             for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
    order += ["embedding"] + ([] if cfg.tie_embeddings else ["lm_head"])
    made = iter(order)

    def keep(w, axis=-1):
        return shard_leaf(w, specs[next(made)], mesh)

    return keep


def fsdp2_rank(rank: int, n_layers: int, max_new: int) -> dict:
    """One of two fsdp ranks on the one card (gloo over CUDA tensors):
    Llama-3-8B bf16 cut to ``n_layers``, this rank's fsdp blocks made by the
    parent's generator (``fsdp_transform``), the eager engine over one
    prompt, its peak GB and parameter bytes."""
    import torch

    sys.path.insert(0, str(ROOT))
    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import local_mesh
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = LLAMA3_8B.replace(n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    mesh = local_mesh(fsdp=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=fsdp_transform(cfg, mesh))
    init_gb = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    engine = make_engine(cfg, mesh_engine_config(decode_chunk=1), params, tok,
                         cuda_graphs=False, fsdp_mesh=mesh)
    out = rank_served(engine, mesh_prompts(tok)[:1], max_new, None, None)
    serve_gb = torch.cuda.max_memory_allocated() / 2**30
    out.update(fsdp_fields(engine), init_peak_gb=init_gb,
               serve_peak_gb=serve_gb, peak_gb=max(init_gb, serve_gb))
    return out


def fsdp_tp_rank(rank: int, n_layers: int, max_new: int) -> dict:
    """One of four ranks (fsdp 2 x model 2) on the one card over gloo:
    Llama-3-8B cut to ``n_layers`` layers with int4 weights over an int4
    pool, this rank's fsdp x TP shard, the eager engine; then the TP-2
    engine (data 2 x model 2) on the same weights in the same process."""
    import torch

    sys.path.insert(0, str(ROOT))
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import local_mesh
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, transform = slice_model("llama3-8b", 4)
    cfg = cfg.replace(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    ecfg = mesh_engine_config(kv_cache_dtype="int4", decode_chunk=4)
    mesh = local_mesh(fsdp=2, model=2)
    tp = local_mesh(data=2, model=2)
    fsdp_shard = shard_params(params, llama_param_specs(cfg, FSDP_LAYOUT),
                              mesh)
    tp_shard = shard_params(params, llama_param_specs(cfg), tp)
    del params
    torch.cuda.empty_cache()
    engine = make_engine(cfg, ecfg, fsdp_shard, tok, cuda_graphs=False,
                         fsdp_mesh=mesh, tp_mesh=mesh)
    out = rank_served(engine, mesh_prompts(tok), max_new, "int4", 4)
    out.update(fsdp_fields(engine), pool_lanes=engine.pool.k.shape[-1])
    del engine
    tp_engine = make_engine(cfg, ecfg, tp_shard, tok, cuda_graphs=False,
                            tp_mesh=tp)
    out["tp_tokens"] = rank_served(tp_engine, mesh_prompts(tok), max_new,
                                   "int4", 4)["tokens"]
    return out


def sp2_rank(rank: int, n_layers: int, max_new: int) -> dict:
    """One of two TP ranks on the one card over gloo: Llama-3-8B bf16 cut
    to ``n_layers`` layers, this rank's TP shard, the eager engine with
    ``sp=True`` and then without, over the four prompts."""
    import torch

    sys.path.insert(0, str(ROOT))
    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import local_mesh
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = LLAMA3_8B.replace(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    mesh = local_mesh(model=2)
    shard = shard_params(params, llama_param_specs(cfg), mesh)
    del params
    torch.cuda.empty_cache()
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    out = {}
    for sp in (True, False):
        engine = make_engine(cfg, mesh_engine_config(), shard, tok,
                             cuda_graphs=False, tp_mesh=mesh, sp=sp)
        out[sp] = rank_served(engine, mesh_prompts(tok), max_new, None, None)
        del engine
    return out


def fsdp_gloo_cases(mesh, cfg, params) -> None:
    """13c: Llama-3-8B bf16 (``MESH_LAYERS``) at fsdp = 2 as two gloo processes
    on the one card, eager, one prompt and one token (the prefill): both
    ranks' streams equal, and
    equal to the 1-rank unsharded eager run; each rank's peak GB against
    the whole model's.  13d: 8B cut to 4 layers, int4 over an int4 pool,
    at fsdp 2 x tp 2 as four gloo processes: the ranks equal, and equal to
    the TP-2 engine's streams.  Every rank's launches and collectives
    exact."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    # one prompt, one token: a prefill, gathering 15 GB through host memory
    # a rank (the decode step's gathers run in 13d)
    max_new = 1
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    one = make_engine(cfg, mesh_engine_config(decode_chunk=1), params, tok,
                      cuda_graphs=False)
    want = [r.token_ids for r in one.generate(mesh_prompts(tok)[:1],
                                              max_new_tokens=max_new)]
    del one
    free_card()
    failed = []
    for phase, fn, n, args in (
            ("fsdp_gloo", fsdp2_rank, 2, (cfg.n_layers, max_new)),
            ("fsdp_tp_gloo", fsdp_tp_rank, 4, (GLOO4_LAYERS, 8))):
        t0 = time.perf_counter()
        ranks = run_ranks(fn, n, str(ROOT / "build" / "fsdp_ranks"),
                          args=args, timeout_s=600, device="cuda-gloo")
        wall = time.perf_counter() - t0
        equal = all(r["tokens"] == ranks[0]["tokens"] for r in ranks)
        exact = all(r["launches_exact"] for r in ranks)
        rec = dict(ranks=n, backend="gloo", cuda_graphs=False,
                   ranks_equal=equal, launches_exact=exact,
                   rank_seconds=[r["seconds"] for r in ranks], wall_s=wall,
                   launches=[r["launches"] for r in ranks],
                   **{k: [r[k] for r in ranks] for k in (
                       "fsdp", "param_bytes_rank", "gather_bytes_forward",
                       "gather_link_ms")})
        if phase == "fsdp_gloo":
            same = ranks[0]["tokens"] == want
            rec.update(model=cfg.name, layers=cfg.n_layers,
                       weights="bfloat16", prompts=1, max_new_tokens=max_new,
                       equal_tokens=same,
                       peak_gb=[r["peak_gb"] for r in ranks],
                       init_peak_gb=[r["init_peak_gb"] for r in ranks],
                       serve_peak_gb=[r["serve_peak_gb"] for r in ranks])
        else:
            same = all(r["tokens"] == r["tp_tokens"] for r in ranks)
            rec.update(model=cfg.name, layers=GLOO4_LAYERS, weights="int4",
                       kv_cache_dtype="int4", tp=2, equal_to_tp2=same,
                       pool_lanes=[r["pool_lanes"] for r in ranks])
        emit(phase, **rec, nvidia_smi=nvidia_smi_name_power())
        if not (equal and exact and same):
            failed.append((phase, equal, exact, same))
        free_card()
    if failed:
        raise SystemExit(f"fsdp gloo: (phase, ranks equal, launches exact, "
                         f"equal to the reference) {failed}")


def sp_cases(mesh, cfg, params) -> dict:
    """13e: Llama-3-8B bf16 on the 1-rank nccl TP mesh (the tree itself),
    graphed, with ``sp=True`` against the TP engine without it: equal
    streams, TTFT both ways, the reduce-scatters counted (checked with
    the launches).  Then 8B cut to 2 layers at TP 2 as two gloo processes,
    eager, with and without ``sp``: the ranks equal, ``sp`` equal to no
    ``sp`` or parting at a near-tie.  Returns the ``sp`` run's
    launches."""
    import torch

    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    phase = "fsdp_sp"
    ecfg = mesh_engine_config()
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    shard = shard_params(params, llama_param_specs(cfg), mesh)
    base = mesh_run(make_engine(cfg, ecfg, shard, tok, tp_mesh=mesh), cfg,
                    None, None)
    free_card()
    run = mesh_run(make_engine(cfg, ecfg, shard, tok, tp_mesh=mesh, sp=True),
                   cfg, None, None)
    mesh_compare(phase, cfg, params, base, run, mesh="tp 1 rank (nccl), sp",
                 weights="bfloat16", reference="tp 1 rank without sp",
                 reduce_scatters=run["launches"]["reduce_scatter_sum"])
    require_equal(phase, base, run)
    if not run["launches"]["reduce_scatter_sum"]:
        raise SystemExit(f"{phase}: no reduce-scatter ran")
    free_card()

    n_layers, max_new = 2, 8
    cut = LLAMA3_8B.replace(n_layers=n_layers)
    cut_params = init_params(cut, torch.Generator(device="cuda").manual_seed(0))
    prompts = mesh_prompts(tok)
    t0 = time.perf_counter()
    ranks = run_ranks(sp2_rank, 2, str(ROOT / "build" / "fsdp_ranks"),
                      args=(n_layers, max_new), timeout_s=600,
                      device="cuda-gloo")
    wall = time.perf_counter() - t0
    on = [r[True] for r in ranks]
    off = [r[False] for r in ranks]
    equal = on[0]["tokens"] == off[0]["tokens"]
    ranks_equal = (on[0]["tokens"] == on[1]["tokens"]
                   and off[0]["tokens"] == off[1]["tokens"])
    divs = divergences(cut, cut_params, prompts, off[0]["tokens"],
                       on[0]["tokens"])
    bad = [d for d in divs if d["logit_margin"] > NEAR_TIE]
    exact = all(r["launches_exact"] for r in on + off)
    emit("fsdp_sp_tp2", model=cut.name, layers=n_layers, ranks=2,
         backend="gloo", cuda_graphs=False, ranks_equal=ranks_equal,
         equal_tokens=equal, launches_exact=exact,
         equal_token_share=common_share(off[0]["tokens"], on[0]["tokens"]),
         divergences=divs, near_tie=NEAR_TIE,
         rank_seconds_sp=[r["seconds"] for r in on],
         rank_seconds_no_sp=[r["seconds"] for r in off], wall_s=wall,
         launches_sp=[r["launches"] for r in on],
         nvidia_smi=nvidia_smi_name_power())
    if not ranks_equal or bad or not exact:
        raise SystemExit(f"fsdp_sp_tp2: ranks equal {ranks_equal}, launches "
                         f"exact {exact}, beyond a near-tie {bad}")
    del cut_params
    return run["launches"]


def fsdp_moe_case(mesh) -> dict:
    """13f: Mixtral-8x7B int8 cut to 4 layers at full width over an int8
    pool (prefix cache off), the dense graphed engine and ``make_engine(...,
    fsdp_mesh=mesh)`` on the 1-rank mesh, graphed: equal streams and
    kernel launches, the stacked experts gathered (the router whole)."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    phase = "fsdp_mixtral"
    cfg, transform = slice_model("mixtral-8x7b", 8)
    cfg = cfg.replace(n_layers=4)
    ecfg = slice_engine_config(kv_cache_dtype="int8")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    base = mesh_run(make_engine(cfg, ecfg, params, tok), cfg, "int8", 8)
    free_card()
    engine = make_engine(cfg, ecfg, shard_params(
        params, llama_param_specs(cfg, FSDP_LAYOUT), mesh), tok,
        fsdp_mesh=mesh)
    run = mesh_run(engine, cfg, "int8", 8)
    mesh_compare(phase, cfg, params, base, run, mesh="fsdp 1 rank (nccl)",
                 weights="int8", kv_cache_dtype="int8", layers=4,
                 **fsdp_fields(engine))
    require_equal(phase, base, run)
    del engine, params
    return run["launches"]


def phase_fsdp() -> dict:
    """Phase 13 under a 1-rank nccl process group (destroyed after): 13a
    Llama-3-8B bf16 and 13b int4 over int4 at FSDP on one rank, 13c fsdp =
    2 (``MESH_LAYERS``) and 13d fsdp 2 x tp 2 over gloo, 13e SP, 13f Mixtral
    int8 at FSDP.  Returns the launch counts of 13a, 13b, 13e and 13f."""
    from k8s_llm_rca_tpu_torch.runtime import mesh as rmesh

    t0 = time.perf_counter()
    rmesh.initialize_distributed()
    out = {}
    try:
        mesh = rmesh.local_mesh()
        out["fsdp"], cfg, params = fsdp_engine_case("fsdp", mesh,
                                                    "llama3-8b", None, None)
        out["fsdp_sp"] = sp_cases(mesh, cfg, params)
        free_card()
        fsdp_gloo_cases(mesh, cfg, params)
        del params
        free_card()
        out["fsdp_int4"], _, params = fsdp_engine_case(
            "fsdp_int4", mesh, "llama3-8b", 4, "int4")
        del params
        free_card()
        out["fsdp_mixtral"] = fsdp_moe_case(mesh)
        free_card()
    finally:
        rmesh.shutdown_distributed()
    emit("fsdp_phase", seconds=time.perf_counter() - t0)
    return out


# ------------------------------------------------------------------ phase 14

# new tokens a request in phase 14, a quarter of the slice's 64: the
# whole script must end within its 1200 s (see ``MESH_LAYERS``); the gloo
# cases of phases 10-13 were cut to 8 new tokens and 13c to one, the
# prefill, for the same reason
CONTIGUOUS_MESH_NEW = 16
# the phases of 14a-14c's mesh runs (the kernel line sums their launches)
CONTIGUOUS_MESH_BF16 = tuple(f"contiguous_mesh_{m}" for m in (
    "tp", "fsdp", "sp", "cp_ring", "cp_ulysses", "pp"))
CONTIGUOUS_MESH_INT4 = ("contiguous_mesh_int4_tp", "contiguous_mesh_int4_pp")
CONTIGUOUS_MESH_MIXTRAL = ("contiguous_mesh_mixtral_ep",
                           "contiguous_mesh_mixtral_pp_ep")
COLLECTIVE_KEYS = ("all_reduce_sum", "all_reduce_max", "all_gather",
                   "all_to_all", "ppermute", "all_gather_into",
                   "reduce_scatter_sum")


def contiguous_mesh_run(engine, cfg, kv, bits) -> dict:
    """The slice's four requests on a contiguous engine (eager) with exact
    launches (``serve_four``), its eager step (``contiguous_step_ms``),
    the collectives per forward by kind and the peak GB since the last
    ``reset_peak_memory_stats``."""
    import torch

    run = serve_four(engine, cfg, kv, bits, max_new=CONTIGUOUS_MESH_NEW,
                     warm_new=2)
    run.update(contiguous_step_ms(engine, steps=4, device=False))
    fwd = run["prefill_dispatches"] + run["decode_steps"]
    run["collectives"] = {k: run["launches"][k] for k in COLLECTIVE_KEYS}
    run["collectives_per_forward"] = {
        k: v / fwd for k, v in run["collectives"].items() if v}
    run["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return run


def contiguous_mesh_compare(phase, cfg, params, base, run, **record) -> None:
    """Emit a contiguous mesh run beside its unsharded yardstick; fail
    unless the streams are equal or part only at a near-tie
    (``NEAR_TIE``, margins printed)."""
    divs = divergences(cfg, params, run["prompts"], base["tokens"],
                       run["tokens"])
    bad = [d for d in divs if d["logit_margin"] > NEAR_TIE]
    keep = ("ttft_s", "decode_tok_per_s", "total_s", "step_wall_ms",
            "peak_gb", "prefill_dispatches", "decode_steps")
    emit(phase, model=cfg.name, layers=cfg.n_layers, engine="contiguous",
         cuda_graphs=False, **record, prompt_tokens=run["prompt_tokens"],
         completion_tokens=run["completion_tokens"],
         equal_tokens=run["tokens"] == base["tokens"],
         equal_token_share=common_share(base["tokens"], run["tokens"]),
         divergences=divs, near_tie=NEAR_TIE, launches=run["launches"],
         launches_exact=run["launches"] == run["expected_launches"],
         collectives=run["collectives"],
         collectives_per_forward=run["collectives_per_forward"],
         **{f"mesh_{k}": run[k] for k in keep},
         **{f"unsharded_{k}": base[k] for k in keep},
         nvidia_smi=nvidia_smi_name_power())
    if bad:
        raise SystemExit(f"{phase}: the contiguous mesh engine's streams "
                         f"part from the unsharded engine's beyond a "
                         f"near-tie: {bad}")


def contiguous_mesh_cases(prefix, name, bits, kv, mesh, cases) -> dict:
    """14a-14c: a slice model by the unsharded contiguous engine, then by
    ``make_engine(..., paged=False)`` on each of ``cases`` (label, the
    meshes' keywords, how the rank's params are cut: "tp", "fsdp" or
    "stage"; on one rank each cut is the tree itself) on the same
    weights.  Returns the mesh runs' launches by phase."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import InferenceEngine, make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_params, shard_stage_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, transform = mesh_model(name, bits)
    ecfg = slice_engine_config(paged=False, kv_cache_dtype=kv)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    base = contiguous_mesh_run(make_engine(cfg, ecfg, params, tok), cfg, kv,
                               bits)
    free_card()
    cuts = {"tp": lambda: shard_params(params, llama_param_specs(cfg), mesh),
            "fsdp": lambda: shard_params(
                params, llama_param_specs(cfg, FSDP_LAYOUT), mesh),
            "stage": lambda: shard_stage_params(params, cfg, mesh)}
    out = {}
    for label, kw, cut in cases:
        phase = f"{prefix}_{label}"
        torch.cuda.reset_peak_memory_stats()
        engine = make_engine(cfg, ecfg, cuts[cut](), tok,
                             **{k: mesh if v == "mesh" else v
                                for k, v in kw.items()})
        if not isinstance(engine, InferenceEngine):
            raise SystemExit(f"{phase}: make_engine built {type(engine)}")
        run = contiguous_mesh_run(engine, cfg, kv, bits)
        ep = engine.model_cfg.ep
        dropped = int(ep.drops) if ep is not None else 0
        contiguous_mesh_compare(
            phase, cfg, params, base, run,
            mesh=f"{label} 1 rank (nccl)",
            weights=f"int{bits}" if bits else "bfloat16", kv_cache_dtype=kv,
            cache_shape=list(engine.cache.k.shape), dropped=dropped)
        if dropped:
            raise SystemExit(f"{phase}: {dropped} tokens dropped")
        out[phase] = run["launches"]
        del engine
        free_card()
    del params
    free_card()
    return out


# the gloo ranks of 14d: (label, the mesh's axes, the engine's meshes, the
# params' cut)
CONTIGUOUS_GLOO = (("tp2", dict(model=2), ("tp_mesh",), "tp"),
                   ("cp2", dict(seq=2), ("cp_mesh",), "tp"),
                   ("pp2", dict(stage=2), ("pp_mesh",), "stage"),
                   ("fsdp2", dict(fsdp=2), ("fsdp_mesh",), "fsdp"))
CONTIGUOUS_GLOO_NEW = 2


def contiguous_gloo_rank(rank: int, n_layers: int) -> dict:
    """One of two ranks on the one card over gloo: Llama-3-8B bf16 cut to
    ``n_layers`` layers, seeded as the parent seeds it, served by the
    contiguous engine (eager, stepwise) at TP 2, CP 2 (ring), PP 2 (M = 2)
    and fsdp 2 in turn, each on the rank's cut of the weights: tokens,
    seconds, launches held to the counters, cache shape."""
    import torch

    sys.path.insert(0, str(ROOT))
    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import local_mesh
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_params, shard_stage_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = LLAMA3_8B.replace(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    prompts = mesh_prompts(tok)[::3]
    ecfg = slice_engine_config(paged=False, decode_chunk=1)
    out = {}
    for label, axes, meshes, cut in CONTIGUOUS_GLOO:
        mesh = local_mesh(**axes)
        if cut == "stage":
            shard = shard_stage_params(params, cfg, mesh)
        else:
            shard = shard_params(params, llama_param_specs(
                cfg, FSDP_LAYOUT if cut == "fsdp" else None), mesh)
        kw = {k: mesh for k in meshes}
        if cut == "stage":
            kw["pp_microbatches"] = 2
        engine = make_engine(cfg, ecfg, shard, tok, **kw)
        reset_counts()
        before = dict(engine._counts or {})
        t0 = time.perf_counter()
        res = engine.generate(prompts, max_new_tokens=CONTIGUOUS_GLOO_NEW)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        expect = expected_counts(engine.model_cfg,
                                 counts_since(engine, before), False,
                                 contiguous=True, cp_mode=engine.cp_mode)
        out[label] = {"tokens": [r.token_ids for r in res],
                      "seconds": seconds, "launches": counts,
                      "launches_exact": counts == expect,
                      "cache_shape": list(engine.cache.k.shape)}
        del engine, shard
        torch.cuda.empty_cache()
    return out


def contiguous_gloo_case() -> None:
    """14d: Llama-3-8B bf16 cut to 2 layers as two gloo processes on the
    one card (eager, stepwise, two prompts, a few tokens), at TP 2, CP 2,
    PP 2 and fsdp 2 (``contiguous_gloo_rank``): the two ranks equal, every
    launch count exact, and the streams equal to the unsharded contiguous
    engine's on the same model in this process or parting at a
    near-tie."""
    import torch

    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    n_layers = 2
    cfg = LLAMA3_8B.replace(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    prompts = mesh_prompts(tok)[::3]
    want = [r.token_ids for r in make_engine(
        cfg, slice_engine_config(paged=False, decode_chunk=1), params,
        tok).generate(prompts, max_new_tokens=CONTIGUOUS_GLOO_NEW)]
    free_card()
    t0 = time.perf_counter()
    ranks = run_ranks(contiguous_gloo_rank, 2,
                      str(ROOT / "build" / "contiguous_ranks"),
                      args=(n_layers,), timeout_s=600, device="cuda-gloo")
    wall = time.perf_counter() - t0
    failed = []
    for label, axes, _, _ in CONTIGUOUS_GLOO:
        got = [r[label] for r in ranks]
        equal = got[0]["tokens"] == got[1]["tokens"]
        exact = all(g["launches_exact"] for g in got)
        divs = divergences(cfg, params, prompts, want, got[0]["tokens"])
        bad = [d for d in divs if d["logit_margin"] > NEAR_TIE]
        emit(f"contiguous_mesh_gloo_{label}", model=cfg.name,
             layers=n_layers, ranks=2, mesh=axes, backend="gloo",
             cuda_graphs=False, engine="contiguous", ranks_equal=equal,
             launches_exact=exact,
             equal_tokens=got[0]["tokens"] == want,
             equal_token_share=common_share(want, got[0]["tokens"]),
             divergences=divs, near_tie=NEAR_TIE,
             rank_seconds=[g["seconds"] for g in got],
             launches=[g["launches"] for g in got],
             cache_shape=[g["cache_shape"] for g in got],
             nvidia_smi=nvidia_smi_name_power())
        if not equal or not exact or bad:
            failed.append((label, equal, exact, bad))
    emit("contiguous_mesh_gloo", wall_s=wall)
    del params
    if failed:
        raise SystemExit(f"contiguous mesh gloo: (mesh, ranks equal, "
                         f"launches exact, beyond a near-tie) {failed}")


def phase_contiguous_mesh() -> dict:
    """Phase 14 under a 1-rank nccl process group (destroyed after): the
    contiguous engine's meshes, eager, the models at ``MESH_LAYERS``
    depth.  14a Llama-3-8B bf16 at TP, fsdp, TP with sp, CP ring and
    Ulysses and PP at M = 2; 14b int4 over an int4 cache at TP and PP; 14c
    Mixtral-8x7B int8 at EP and PP x EP; 14d two gloo processes.  Returns the launch counts of 14a-14c's
    mesh runs by phase."""
    from k8s_llm_rca_tpu_torch.runtime import mesh as rmesh

    t0 = time.perf_counter()
    rmesh.initialize_distributed()
    out = {}
    try:
        mesh = rmesh.local_mesh()
        out.update(contiguous_mesh_cases(
            "contiguous_mesh", "llama3-8b", None, None, mesh, (
                ("tp", {"tp_mesh": "mesh"}, "tp"),
                ("fsdp", {"fsdp_mesh": "mesh"}, "fsdp"),
                ("sp", {"tp_mesh": "mesh", "sp": True}, "tp"),
                ("cp_ring", {"cp_mesh": "mesh"}, "tp"),
                ("cp_ulysses", {"cp_mesh": "mesh", "cp_mode": "ulysses"},
                 "tp"),
                ("pp", {"pp_mesh": "mesh", "pp_microbatches": 2},
                 "stage"))))
        out.update(contiguous_mesh_cases(
            "contiguous_mesh_int4", "llama3-8b", 4, "int4", mesh, (
                ("tp", {"tp_mesh": "mesh"}, "tp"),
                ("pp", {"pp_mesh": "mesh", "pp_microbatches": 2},
                 "stage"))))
        out.update(contiguous_mesh_cases(
            "contiguous_mesh_mixtral", "mixtral-8x7b", 8, "int8", mesh, (
                ("ep", {"ep_mesh": "mesh"}, "tp"),
                ("pp_ep", {"pp_mesh": "mesh", "ep_mesh": "mesh",
                           "pp_microbatches": 2}, "stage"))))
        contiguous_gloo_case()
        free_card()
    finally:
        rmesh.shutdown_distributed()
    emit("contiguous_mesh_phase", seconds=time.perf_counter() - t0)
    return out


def ptxas_summary(report: str) -> list:
    """One line per kernel of a ``ptxas -v`` report: its name (demangled
    by ``c++filt`` where the toolchain has it, up to its parameter list),
    then its spill and its registers/shared-memory lines."""
    import re

    kernels = []
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            kernels.append([m.group(1)])
        elif kernels and ("registers" in ln or "spill" in ln):
            kernels[-1].append(ln.split(":", 1)[-1].strip()
                               if "registers" in ln else ln.strip())
    names = demangle([k[0] for k in kernels])
    return [f"{n}: {'; '.join(k[1:])}" for n, k in zip(names, kernels)]


def demangle(names: list) -> list:
    """Kernel names demangled by ``c++filt`` where the toolchain has it, up
    to the parameter list."""
    import shutil

    if not names or not shutil.which("c++filt"):
        return names
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()
    return [n.replace("(anonymous namespace)::", "").split("(")[0]
            for n in out]


# the machine instructions that show what the kn bodies run on: HGMMA is
# wgmma, UTMALDG a TMA tensor load, HMMA mma.sync
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_counts(cuobjdump: Path, lib: Path, names) -> dict:
    """Per kernel of ``lib`` whose mangled name holds one of ``names``, the
    count of each of ``SASS_OPS`` in its ``cuobjdump -sass`` listing."""
    listing = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                             capture_output=True, text=True, check=True,
                             timeout=300).stdout
    counts, current = {}, None
    for ln in listing.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            current = fn if any(n in fn for n in names) else None
            if current:
                counts[current] = dict.fromkeys(SASS_OPS, 0)
        elif current:
            for op in SASS_OPS:
                if f" {op}" in ln:
                    counts[current][op] += 1
    return counts


def kn_sass(build) -> dict:
    """The tensor-core bodies' instructions in each matmul library: the kn
    tile body (M > 16) must issue wgmma (HGMMA) on operands brought by TMA
    (UTMALDG), the kn weight-streaming body and, in the two libraries with
    a head, the nk body mma.sync (HMMA); exits if not."""
    from concurrent.futures import ThreadPoolExecutor

    out = {}
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")  # beside nvcc
    names = ("quant_matmul", "quant_matmul_int8", "quant_matmul_experts")
    with ThreadPoolExecutor(len(names)) as pool:    # the listings at once
        listed = list(pool.map(lambda name: sass_counts(
            cuobjdump, build.library_path(name),
            ("kn_wgmma_kernel", "kn_gemv_mma_kernel", "nk_mma_kernel")),
            names))
    for name, counts in zip(names, listed):
        tiles = {f: c for f, c in counts.items() if "kn_wgmma_kernel" in f}
        gemvs = {f: c for f, c in counts.items() if "kn_gemv_mma_kernel" in f}
        heads = {f: c for f, c in counts.items() if "nk_mma_kernel" in f}
        if (not tiles or not gemvs or (name in HEAD_KERNELS and not heads)
                or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0
                       for c in tiles.values())
                or any(c["HMMA"] == 0 for c in (gemvs | heads).values())):
            raise SystemExit(f"{name}: the matmul bodies lack their "
                             f"tensor-core or TMA instructions: {counts}")
        fns = sorted(counts)
        out[name] = dict(zip(demangle(fns), (counts[f] for f in fns)))
    return out


def free_card() -> None:
    """Return the memory of the models and tensors just dropped."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 15


def tier_counts(engine) -> tuple:
    """The pages an engine's prefix store gathered whole and the L2
    decisions it shared under a mesh (``engine/prefix.py::MeshTier``; (0,
    0) without one)."""
    tier = getattr(engine.prefix_store, "mesh_tier", None)
    return (0, 0) if tier is None else (tier.gathered, tier.decided)


def expected_with_tiers(engine, c: dict, kv, bits, before: tuple) -> dict:
    """``expected_counts`` of a mesh engine's run plus the collectives of
    its prefix store's tiers since ``before`` (``tier_counts``): two lane
    all-gathers (k, v) a page written whole to the disk tier under TP and
    one broadcast an L2 read decided over more than one rank."""
    expect = expected_counts(engine.model_cfg, c, kv is not None, bits)
    gathered, decided = tier_counts(engine)
    expect["all_gather"] += 2 * (gathered - before[0])
    expect["broadcast"] += decided - before[1]
    return expect


def tiers_spill_run(label, cfg, params, tok, prompts, kv, bits, base,
                    max_new=None, **kw) -> dict:
    """An engine with a spill budget (``kw``: its mesh and shard) serves
    ``prompts`` under a FaultPlan that preempts the youngest sequence at
    tick 2: the spill's gather and restore timed against the link
    (``watch_page_moves``), the restored pages byte-equal to the record,
    the launches exact and the streams ``base``'s or a near-tie."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.faults import inject
    from k8s_llm_rca_tpu_torch.faults.plan import Fault, FaultPlan

    shard = kw.pop("shard", params)
    engine = make_engine(cfg, slice_engine_config(
        kv_cache_dtype=kv, max_spilled_pages=168), shard, tok, **kw)
    before = warm_engine(engine)
    moves = []
    reset_counts()
    t0 = time.perf_counter()
    with watch_page_moves(moves), inject.armed(FaultPlan(
            [Fault(inject.SITE_ENGINE_TICK, 2, "preempt")])):
        res = engine.generate(prompts, max_new_tokens=max_new)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0 - sum(m[5] for m in moves)
    counts = read_counts()
    c = counts_since(engine, before)
    engine.allocator.check()
    expect = expected_counts(engine.model_cfg, c, kv is not None, bits)
    tokens = [r.token_ids for r in res]
    divs = divergences(cfg, params, prompts, base, tokens)
    run = {"total_s": total_s, "equal_tokens": tokens == base,
           "divergences": divs,
           **{k.split(".")[1]: int(c.get(k, 0)) for k in (
               "engine.preemptions", "engine.spilled_pages",
               "engine.restored_pages")},
           **move_stats(moves, "gather"), **move_stats(moves, "restore"),
           "launches": counts}
    if counts != expect:
        raise SystemExit(f"{label} spill: launch counts {counts} != "
                         f"expected {expect}")
    if not (run["spilled_pages"] and run["restored_pages"]
            == run["spilled_pages"] and run["restore_equal"]):
        raise SystemExit(f"{label} spill: spilled {run['spilled_pages']}, "
                         f"restored {run['restored_pages']}, restore equal "
                         f"{run['restore_equal']}")
    if any(d["logit_margin"] > NEAR_TIE for d in divs):
        raise SystemExit(f"{label} spill: streams part from the "
                         f"uninterrupted run beyond a near-tie: {divs}")
    del engine
    free_card()
    return run


def tiers_prefix_run(label, cfg, params, tok, tier: str, kv=None,
                     bits=None, max_new: int = 8, **kw) -> dict:
    """Phase 5e's tier protocol on an engine (``kw``: its mesh and shard):
    the lone prompt of ``prefix_prompts`` (a miss), every resident page
    evicted into the store (L1: 64 host pages; L2: the disk alone), then
    the three hits from the promoted pages.  The hits' TTFT, the pages
    promoted, the demotion's gather and the promotion's restore (byte
    equal); launches exact, the tiers' collectives included."""
    import tempfile

    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine

    shard = kw.pop("shard", params)
    prompts = prefix_prompts(tok)
    with tempfile.TemporaryDirectory() as d:
        store = ({"prefix_host_pages": 64} if tier == "l1"
                 else {"prefix_host_pages": 0, "prefix_disk_dir": d})
        engine = make_engine(cfg, slice_engine_config(
            prefix_cache=True, kv_cache_dtype=kv, max_new_tokens=max_new,
            **store), shard, tok, **kw)
        before = warm_engine(engine)
        tiers_before = tier_counts(engine)
        stamps, moves, ttft, tokens = [], [], [], []
        stamp_first_tokens(engine, stamps)
        reset_counts()
        with watch_page_moves(moves):
            for i, wave in enumerate((prompts[:1], prompts[1:])):
                if i:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    demoted = engine.prefix_cache.evict(10 ** 6)
                    evict_s = time.perf_counter() - t0
                stamps.clear()
                checked = sum(m[5] for m in moves)
                t0 = time.perf_counter()
                ids = [engine.submit(p) for p in wave]
                res = {r.seq_id: r for r in engine.run_to_completion()}
                ttft.append(stamps[0] - t0
                            - (sum(m[5] for m in moves) - checked))
                tokens += [res[i].token_ids for i in ids]
        torch.cuda.synchronize()
        counts = read_counts()
        c = counts_since(engine, before)
        engine.allocator.check()
        expect = expected_with_tiers(engine, c, kv, bits, tiers_before)
        run = {"tokens": tokens, "ttft_s": ttft, "demoted_pages": demoted,
               "evict_s": evict_s,
               **{k.split(".")[1]: int(c.get(k, 0)) for k in (
                   f"engine.prefix_hits_{tier}",
                   "engine.prefix_promoted_pages",
                   "engine.prefix_hit_tokens")},
               **move_stats(moves, "gather"), **move_stats(moves, "restore"),
               "launches": counts}
        if not run[f"prefix_hits_{tier}"] or not run["restore_equal"]:
            raise SystemExit(f"{label} {tier}: no page promoted, or a "
                             f"restored page differs from its record")
        if counts != expect:
            raise SystemExit(f"{label} {tier}: launch counts {counts} != "
                             f"expected {expect}")
        del engine
    free_card()
    return run


def tiers_overlap_run(label, cfg, params, tok, kv, bits, base=None,
                      overlap: bool = True, **kw) -> dict:
    """The slice's four requests (32 new tokens) at ``decode_chunk`` 1 with
    ``host_overlap`` on or off (``kw``: the mesh and shard), graphed where
    the engine graphs: decode tok/s, ms per decode step over the run,
    syncs per token, launches exact; the streams ``base``'s (a run at the
    same 32 tokens) or a near-tie."""
    from k8s_llm_rca_tpu_torch.engine import make_engine

    shard = kw.pop("shard", params)
    engine = make_engine(cfg, slice_engine_config(
        kv_cache_dtype=kv, decode_chunk=1, host_overlap=overlap), shard,
        tok, **kw)
    run = serve_four(engine, cfg, kv, bits, max_new=32)
    steps = max(1, run["decode_steps"])
    run["decode_ms_per_step"] = (1e3 * (sum(run["completion_tokens"])
                                        - len(run["completion_tokens"]))
                                 / run["decode_tok_per_s"] / steps)
    run["syncs_per_token"] = run["d2h_syncs"] / max(
        1, sum(run["completion_tokens"]))
    run.update(graph_stats(engine))
    if base is not None:
        run["divergences"] = divergences(cfg, params, run["prompts"], base,
                                         run["tokens"])
        if any(d["logit_margin"] > NEAR_TIE for d in run["divergences"]):
            raise SystemExit(f"{label} overlap: streams part beyond a "
                             f"near-tie: {run['divergences']}")
    del engine
    free_card()
    return run


def tiers_snapshot_run(label, cfg, params, tok, base, mesh, shard) -> dict:
    """A TP engine with the prefix cache and a 256-page host store decodes
    the four prompts two ticks and snapshots (publishing the sequences'
    pages); a fresh TP engine on the same store restores it and finishes:
    the uninterrupted stream (``base``) or a near-tie, promoted pages,
    launches exact."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine

    ecfg = slice_engine_config(prefix_cache=True, prefix_host_pages=256)
    prompts = memory_prompts(tok)
    first = make_engine(cfg, ecfg, shard, tok, tp_mesh=mesh)
    warm_engine(first)
    for p in prompts:
        first.submit(p)
    first.step()
    first.step()
    t0 = time.perf_counter()
    snap = first.snapshot_sequences()
    snapshot_s = time.perf_counter() - t0
    store = first.prefix_store
    del first
    free_card()
    fresh = make_engine(cfg, ecfg, shard, tok, tp_mesh=mesh,
                        prefix_store=store)
    before = warm_engine(fresh)
    reset_counts()
    t0 = time.perf_counter()
    fresh.restore_sequences(snap)
    res = {r.seq_id: r.token_ids for r in fresh.run_to_completion()}
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    c = counts_since(fresh, before)
    fresh.allocator.check()
    expect = expected_counts(fresh.model_cfg, c, False)
    tokens = [res[i] for i in sorted(res)]
    divs = divergences(cfg, params, prompts, base, tokens)
    run = {"snapshot_s": snapshot_s, "total_s": total_s,
           "sequences": len(snap["sequences"]),
           "promoted_pages": int(c.get("engine.prefix_promoted_pages", 0)),
           "equal_tokens": tokens == base, "divergences": divs,
           "launches": counts}
    if counts != expect:
        raise SystemExit(f"{label} snapshot: launch counts {counts} != "
                         f"expected {expect}")
    if not run["promoted_pages"] or any(d["logit_margin"] > NEAR_TIE
                                        for d in divs):
        raise SystemExit(f"{label} snapshot: promoted "
                         f"{run['promoted_pages']} pages; streams {divs}")
    del fresh
    free_card()
    return run


def l2_files(cfg, params, tok, kv, d, max_new: int = 2, **kw) -> dict:
    """The ``.page`` files an engine writes into ``d`` when it serves the
    lone prompt of ``prefix_prompts`` and demotes every resident page (the
    disk tier alone), by name; ``kw``: its mesh and shard."""
    from k8s_llm_rca_tpu_torch.engine import make_engine

    shard = kw.pop("shard", params)
    engine = make_engine(cfg, slice_engine_config(
        prefix_cache=True, kv_cache_dtype=kv, prefix_host_pages=0,
        prefix_disk_dir=d, max_new_tokens=max_new), shard, tok, **kw)
    engine.generate(prefix_prompts(tok)[:1])
    engine.prefix_cache.evict(10 ** 6)
    del engine
    free_card()
    return {n: (Path(d) / n).read_bytes()
            for n in sorted(os.listdir(d)) if n.endswith(".page")}


def mesh_tiers_8b(mesh, out: dict) -> None:
    """15a: Llama-3-8B bf16 at full depth and width, the unsharded graphed
    engine beside the 1-rank TP engine: a forced preemption with spill;
    L1 and L2 hits (TTFT next to the unsharded engine's); ``host_overlap``
    off and on; a snapshot restored into a fresh TP engine."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, _ = slice_model("llama3-8b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    shard = shard_params(params, llama_param_specs(cfg), mesh)
    prompts = memory_prompts(tok)
    engine = make_engine(cfg, slice_engine_config(), params, tok)
    warm_engine(engine)
    base = [r.token_ids for r in engine.generate(prompts)]
    del engine
    free_card()
    tp = {"shard": shard, "tp_mesh": mesh}
    spill = tiers_spill_run("15a", cfg, params, tok, prompts, None, None,
                            base, **tp)
    tiers = {}
    for tier in ("l1", "l2"):
        for who, kw in (("unsharded", {}), ("tp", tp)):
            tiers[who, tier] = tiers_prefix_run(f"15a {who}", cfg, params,
                                                tok, tier, **dict(kw))
        if tiers["tp", tier]["tokens"] != tiers["unsharded", tier]["tokens"]:
            raise SystemExit(f"15a {tier}: the TP engine's hits differ from "
                             f"the unsharded engine's")
    plain = tiers_overlap_run("15a", cfg, params, tok, None, None,
                              overlap=False, **tp)
    lagged = tiers_overlap_run("15a", cfg, params, tok, None, None,
                               plain["tokens"], **tp)
    snap = tiers_snapshot_run("15a", cfg, params, tok, base, mesh, shard)
    emit("mesh_tiers", model=cfg.name, layers=cfg.n_layers,
         weights="bfloat16", mesh="tp 1 rank (nccl)",
         spill={k: v for k, v in spill.items() if k != "launches"},
         **{f"{who}_{tier}": {k: v for k, v in run.items()
                              if k not in ("tokens", "launches")}
            for (who, tier), run in tiers.items()},
         overlap_off={k: plain[k] for k in (
             "decode_tok_per_s", "decode_ms_per_step", "syncs_per_token",
             "ttft_s", "graph_replays")},
         overlap_on={k: lagged[k] for k in (
             "decode_tok_per_s", "decode_ms_per_step", "syncs_per_token",
             "ttft_s", "graph_replays", "divergences")},
         overlap_equal_tokens=lagged["tokens"] == plain["tokens"],
         snapshot=snap, nvidia_smi=nvidia_smi_name_power())
    total = {k: 0 for k in launch_counters()}
    for run in (spill, *tiers.values(), plain, lagged, snap):
        for k in total:
            total[k] += run["launches"][k]
    out["mesh_tiers"] = total
    del shard, params


def page_lanes_joined(shares: list) -> dict:
    """Two TP ranks' shares of one int4 page joined here, in numpy and
    apart from the port's code: each rank's split-half bytes unpacked to
    its lanes, the lanes joined in rank order and packed split-half over
    all of them (the scale fields are the full row's on both ranks)."""
    import numpy as np

    def unpack(p):
        lo = (p & 0x0F).astype(np.int8)
        lo = np.where(lo >= 8, lo - 16, lo)
        return np.concatenate([lo, p >> 4], axis=-1).astype(np.int8)

    def pack(q):
        half = q.shape[-1] // 2
        b = ((q[..., half:].astype(np.uint8) & 0x0F) << 4) \
            | (q[..., :half].astype(np.uint8) & 0x0F)
        return b.astype(np.uint8).view(np.int8)

    import torch

    rec = {"n_pages": 1}
    for f in shares[0]:
        if f in ("k", "v"):
            lanes = np.concatenate([unpack(s[f].numpy()) for s in shares],
                                   axis=-1)
            rec[f] = torch.from_numpy(pack(lanes))
        else:
            if not all(torch.equal(s[f], shares[0][f]) for s in shares):
                raise SystemExit(f"15d: the ranks' {f} differ")
            rec[f] = shares[0][f]
    return rec


def tiers_tp2_rank(rank: int, n_layers: int, disk_dir: str) -> dict:
    """15d, one of two ranks on the one card (gloo): Llama-3-8B cut to
    ``n_layers`` layers, seeded as the parent seeds it, this rank's TP
    shard over an int4 pool, eager, the disk tier in ``disk_dir`` (one
    directory both ranks see): the lone prompt served, every resident page
    demoted.  Returns the shares each demotion gathered, by digest."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import (
        collective_counts, local_mesh,
    )
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = LLAMA3_8B.replace(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    mesh = local_mesh(model=2)
    shard = shard_params(params, llama_param_specs(cfg), mesh)
    del params
    torch.cuda.empty_cache()
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    engine = make_engine(cfg, slice_engine_config(
        prefix_cache=True, kv_cache_dtype="int4", prefix_host_pages=0,
        prefix_disk_dir=disk_dir, max_new_tokens=2), shard, tok,
        cuda_graphs=False, tp_mesh=mesh)
    shares = {}
    demote = engine.prefix_cache._demote

    def watched(pages):
        recs = demote(pages)
        for page, rec in zip(pages, recs):
            shares[engine.prefix_cache._key_of[page].hex()] = {
                f: v for f, v in rec.items() if f != "n_pages"}
        return recs

    engine.prefix_cache._demote = watched
    t0 = time.perf_counter()
    engine.generate(prefix_prompts(tok)[:1])
    demoted = engine.prefix_cache.evict(10 ** 6)
    torch.cuda.synchronize()
    dist.barrier()
    return {"shares": shares, "demoted": demoted,
            "seconds": time.perf_counter() - t0,
            "gathered": engine.prefix_store.mesh_tier.gathered,
            "writer": engine.prefix_store.mesh_tier.writer,
            "collectives": collective_counts(),
            "pool_lanes": engine.pool.k.shape[-1]}


def mesh_tiers_tp2() -> None:
    """15d: Llama-3-8B cut to 2 layers over an int4 pool at TP = 2 as two
    gloo processes on the one card: the demoted ``.page`` files are the
    unsharded engine's set, each byte for byte the page joined from the
    two ranks' shares (``page_lanes_joined``, written once), and they
    promote into the unsharded engine with its own L2 hits' streams (or a
    near-tie).  Prints how many files are byte-equal to the unsharded
    engine's and the largest scale difference."""
    import shutil

    import torch

    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks
    from k8s_llm_rca_tpu_torch.utils.pages import (
        decode_page_record, encode_page_record,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    n_layers = 2
    work = ROOT / "build" / "mesh_tiers"
    shutil.rmtree(work, ignore_errors=True)
    tp_dir, u_dir = work / "tp2", work / "unsharded"
    t0 = time.perf_counter()
    ranks = run_ranks(tiers_tp2_rank, 2, str(work / "ranks"),
                      args=(n_layers, str(tp_dir)), timeout_s=600,
                      device="cuda-gloo")
    wall = time.perf_counter() - t0
    cfg = LLAMA3_8B.replace(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    theirs = l2_files(cfg, params, tok, "int4", str(u_dir))
    mine = {n: (tp_dir / n).read_bytes()
            for n in sorted(os.listdir(tp_dir)) if n.endswith(".page")}
    joined = all(
        data == encode_page_record(page_lanes_joined(
            [r["shares"][n[:-len(".page")]] for r in ranks]))
        for n, data in mine.items())
    scale_diff = 0.0
    for n in set(mine) & set(theirs):
        a, b = decode_page_record(mine[n]), decode_page_record(theirs[n])
        for f in ("k_scale", "v_scale"):
            scale_diff = max(scale_diff, (a[f].float() - b[f].float())
                             .abs().max().item())
    hits = {}
    for name, d in (("own", u_dir), ("tp2", tp_dir)):
        engine = make_engine(cfg, slice_engine_config(
            prefix_cache=True, kv_cache_dtype="int4", prefix_host_pages=0,
            prefix_disk_dir=str(d), max_new_tokens=8), params, tok)
        res = engine.generate(prefix_prompts(tok)[1:])
        hits[name] = {"tokens": [r.token_ids for r in res],
                      "l2": int(engine._counts.get("engine.prefix_hits_l2",
                                                   0))}
        del engine
        free_card()
    divs = divergences(cfg, params, prefix_prompts(tok)[1:],
                       hits["own"]["tokens"], hits["tp2"]["tokens"])
    emit("mesh_tiers_tp2", model=cfg.name, layers=n_layers, ranks=2,
         backend="gloo", kv_cache_dtype="int4", files=len(mine),
         same_files=sorted(mine) == sorted(theirs),
         files_byte_equal_to_unsharded=sum(mine[n] == theirs.get(n)
                                           for n in mine),
         files_equal_joined_shares=joined, max_scale_diff=scale_diff,
         writers=[r["writer"] for r in ranks],
         gathered=[r["gathered"] for r in ranks],
         demoted=[r["demoted"] for r in ranks],
         l2_hits={k: v["l2"] for k, v in hits.items()},
         promoted_equal_tokens=hits["own"]["tokens"] == hits["tp2"]["tokens"],
         divergences=divs, rank_seconds=[r["seconds"] for r in ranks],
         wall_s=wall, pool_lanes=[r["pool_lanes"] for r in ranks],
         nvidia_smi=nvidia_smi_name_power())
    if not (mine and sorted(mine) == sorted(theirs) and joined):
        raise SystemExit(f"15d: {len(mine)} files, the unsharded set "
                         f"{sorted(mine) == sorted(theirs)}, the joined "
                         f"shares' bytes {joined}")
    if not hits["tp2"]["l2"] or any(d["logit_margin"] > NEAR_TIE
                                    for d in divs):
        raise SystemExit(f"15d: {hits['tp2']['l2']} L2 hits; streams {divs}")
    del params


def phase_mesh_tiers(gloo: bool = True) -> dict:
    """Phase 15 under a 1-rank nccl process group (destroyed after): the
    memory tiers, snapshots and the overlapped loop under TP, EP, FSDP and
    PP (``mesh_tiers_8b``: 15a; 15b-15c below), then, with ``gloo``, 15d's
    two gloo ranks (``--mesh-tiers``; the whole script leaves 15d out to
    end within its 1200 s).  Returns the launch counts by phase."""
    import tempfile

    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models import mixtral
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime import mesh as rmesh
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_params, shard_stage_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    t0 = time.perf_counter()
    rmesh.initialize_distributed()
    out = {}
    try:
        mesh = rmesh.local_mesh()
        mesh_tiers_8b(mesh, out)
        # 15b: int4 over an int4 pool at MESH_LAYERS, the L2 records of
        # the unsharded and the TP engine byte for byte
        cfg, transform = mesh_model("llama3-8b", 4)
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), tensor_transform=transform)
        tok = get_tokenizer(vocab_size=cfg.vocab_size)
        with tempfile.TemporaryDirectory() as d:
            reset_counts()
            theirs = l2_files(cfg, params, tok, "int4", d + "/u")
            mine = l2_files(cfg, params, tok, "int4", d + "/tp",
                            shard=shard_params(params,
                                               llama_param_specs(cfg), mesh),
                            tp_mesh=mesh)
            out["mesh_tiers_int4"] = read_counts()
        equal = bool(mine) and mine == theirs
        emit("mesh_tiers_int4", model=cfg.name, layers=cfg.n_layers,
             weights="int4", kv_cache_dtype="int4", mesh="tp 1 rank (nccl)",
             files=len(mine), files_byte_equal=equal,
             nvidia_smi=nvidia_smi_name_power())
        if not equal:
            raise SystemExit("15b: the TP engine's L2 records differ from "
                             "the unsharded engine's")
        del params
        free_card()
        # 15c: Mixtral int8 under EP with spill and host_overlap
        cfg, transform = mesh_model("mixtral-8x7b", 8)
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), tensor_transform=transform)
        tok = get_tokenizer(vocab_size=cfg.vocab_size)
        prompts = memory_prompts(tok)
        engine = make_engine(cfg, slice_engine_config(kv_cache_dtype="int8"),
                             params, tok)
        warm_engine(engine)
        base = [r.token_ids for r in engine.generate(prompts)]
        del engine
        free_card()
        base32 = tiers_overlap_run("15c unsharded", cfg, params, tok, "int8",
                                   8, overlap=False)["tokens"]
        ep = {"shard": mixtral.shard_params_ep(cfg, params, mesh),
              "ep_mesh": mesh}
        spill = tiers_spill_run("15c ep", cfg, params, tok, prompts, "int8",
                                8, base, **dict(ep))
        lagged = tiers_overlap_run("15c ep", cfg, params, tok, "int8", 8,
                                   base32, **dict(ep))
        emit("mesh_tiers_mixtral", model=cfg.name, layers=cfg.n_layers,
             weights="int8", kv_cache_dtype="int8", mesh="ep 1 rank (nccl)",
             spill={k: v for k, v in spill.items() if k != "launches"},
             overlap_on={k: lagged[k] for k in (
                 "decode_tok_per_s", "decode_ms_per_step",
                 "syncs_per_token", "graph_replays", "divergences")},
             nvidia_smi=nvidia_smi_name_power())
        out["mesh_tiers_mixtral"] = {k: spill["launches"][k]
                                     + lagged["launches"][k]
                                     for k in spill["launches"]}
        del ep, params
        free_card()
        # 15c: 8B bf16 at MESH_LAYERS under FSDP (L1 hit, overlap) and PP
        # (overlap)
        cfg, _ = mesh_model("llama3-8b")
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
        tok = get_tokenizer(vocab_size=cfg.vocab_size)
        base32 = tiers_overlap_run("15c unsharded", cfg, params, tok, None,
                                   None, overlap=False)["tokens"]
        l1 = tiers_prefix_run("15c unsharded", cfg, params, tok, "l1")
        fsdp = {"shard": shard_params(params, llama_param_specs(
            cfg, FSDP_LAYOUT), mesh), "fsdp_mesh": mesh}
        fsdp_l1 = tiers_prefix_run("15c fsdp", cfg, params, tok, "l1",
                                   **dict(fsdp))
        if fsdp_l1["tokens"] != l1["tokens"]:
            raise SystemExit("15c fsdp: the L1 hits' tokens differ from the "
                             "unsharded engine's")
        fsdp_lagged = tiers_overlap_run("15c fsdp", cfg, params, tok, None,
                                        None, base32, **dict(fsdp))
        del fsdp
        free_card()
        pp = {"shard": shard_stage_params(params, cfg, mesh),
              "pp_mesh": mesh, "pp_microbatches": PP_MICROBATCHES}
        pp_lagged = tiers_overlap_run("15c pp", cfg, params, tok, None, None,
                                      base32, **dict(pp))
        del pp
        emit("mesh_tiers_cut", model=cfg.name, layers=cfg.n_layers,
             weights="bfloat16", mesh="fsdp, pp 1 rank (nccl)",
             unsharded_l1={k: v for k, v in l1.items()
                           if k not in ("tokens", "launches")},
             fsdp_l1={k: v for k, v in fsdp_l1.items()
                      if k not in ("tokens", "launches")},
             **{f"{name}_overlap_on": {k: run[k] for k in (
                 "decode_tok_per_s", "decode_ms_per_step",
                 "syncs_per_token", "graph_replays", "divergences")}
                for name, run in (("fsdp", fsdp_lagged),
                                  ("pp", pp_lagged))},
             nvidia_smi=nvidia_smi_name_power())
        out["mesh_tiers_cut"] = {k: sum(r["launches"][k] for r in (
            l1, fsdp_l1, fsdp_lagged, pp_lagged)) for k in l1["launches"]}
        del params
        free_card()
    finally:
        rmesh.shutdown_distributed()
    if gloo:
        mesh_tiers_tp2()
        free_card()
    emit("mesh_tiers_phase", seconds=time.perf_counter() - t0)
    return out


# ------------------------------------------------------------------ phase 16

# speculation under a mesh: k, the new tokens of a served run (the slice's
# four requests), and the phases whose launches the kernel line sums
MESH_SPEC_K = 4
MESH_SPEC_NEW = 32
MESH_SPEC_BF16 = tuple(f"mesh_spec_{m}" for m in ("tp", "fsdp", "pp", "cp"))
MESH_SPEC_INT4 = ("mesh_spec_int4_tp", "mesh_spec_int4_cp")
MESH_SPEC_MIXTRAL = ("mesh_spec_mixtral_ep",)
MESH_SPEC_CONTIGUOUS = tuple(f"mesh_spec_contiguous_{m}"
                             for m in ("tp", "pp", "cp"))
SPEC_COUNTER_KEYS = ("verify_steps", "spec_drafted", "spec_accepted")


def mesh_spec_config(**over):
    """The slice engine with ``speculative_k`` 4 at ``decode_chunk`` 1,
    greedy."""
    return slice_engine_config(speculative_k=MESH_SPEC_K, decode_chunk=1,
                               **over)


def step_collectives(engine) -> dict:
    """The collectives of one verify step (T = k + 1) and of one decode
    step at the slice's decode shapes (``decode_step_fn``), by kind: each
    step run once (captured where the engine graphs), then counted over
    one more call.  The engine is not used after."""
    import torch

    out = {}
    for label, t in (("verify", MESH_SPEC_K + 1), ("decode", 0)):
        step = decode_step_fn(engine, t)
        step()
        torch.cuda.synchronize()
        reset_counts()
        step()
        torch.cuda.synchronize()
        c = read_counts()
        out[f"{label}_step_collectives"] = {
            k: c[k] for k in COLLECTIVE_KEYS + ("broadcast",) if c[k]}
    return out


def time_draft_broadcasts(engine) -> list:
    """Wrap a mesh engine's draft broadcast (``speculative.
    DraftAgreement``): the host ms of each call, appended to the list
    returned."""
    agree, ms = engine._draft_agree, []

    def timed(tokens_in):
        t0 = time.perf_counter()
        out = agree(tokens_in)
        ms.append(1e3 * (time.perf_counter() - t0))
        return out

    engine._draft_agree = timed
    return ms


def mesh_spec_run(engine, cfg, kv, bits, paged: bool = True) -> dict:
    """The slice's four requests on a speculative engine (``serve_four``:
    launches exact, a draft's broadcasts among them), its speculation
    counters; on the paged engine (graphed) the verify step's and the
    decode step's wall and device ms and collectives by kind."""
    draft_ms = (time_draft_broadcasts(engine)
                if engine._draft_agree is not None else None)
    if paged:
        run = serve_four(engine, cfg, kv, bits, max_new=MESH_SPEC_NEW)
    else:
        run = serve_four(engine, cfg, kv, bits, max_new=CONTIGUOUS_MESH_NEW,
                         warm_new=2)
    # the contiguous engine runs eagerly: it has no graphs
    run.update(graph_stats(engine) if paged
               else {"graph_captures": 0, "graph_replays": 0})
    if not run["verify_steps"]:
        raise SystemExit(f"{cfg.name}: speculative_k {MESH_SPEC_K} verified "
                         f"nothing")
    if draft_ms is not None:
        run["draft_broadcasts"] = len(draft_ms)
        run["draft_broadcast_host_ms"] = statistics.mean(draft_ms)
        run["draft_broadcast_host_ms_max"] = max(draft_ms)
    run["collectives"] = {k: run["launches"][k]
                          for k in COLLECTIVE_KEYS + ("broadcast",)}
    if paged:
        run.update({f"verify_{k}": v for k, v in decode_step_times(
            engine, verify_t=MESH_SPEC_K + 1, profiled=False).items()})
        run.update(decode_step_times(engine, profiled=False))
        run.update(step_collectives(engine))
    return run


def mesh_spec_compare(phase, cfg, params, base, run, **record) -> None:
    """Emit a speculative mesh run beside the unsharded speculative engine
    with the same knobs; fail unless the streams are equal or part only
    at a near-tie (``NEAR_TIE``), unless equal streams come with equal
    speculation counters, unless a verify step issues a decode step's
    collectives by kind, and unless a draft model's drafts went through
    one broadcast a verify tick (none without one)."""
    divs = divergences(cfg, params, run["prompts"], base["tokens"],
                       run["tokens"])
    bad = [d for d in divs if d["logit_margin"] > NEAR_TIE]
    equal = run["tokens"] == base["tokens"]
    counters = {k: (base[k], run[k]) for k in SPEC_COUNTER_KEYS}
    keep = ("ttft_s", "decode_tok_per_s", "total_s", "wall_ms_per_step",
            "event_device_ms_per_step", "verify_wall_ms_per_step",
            "verify_event_device_ms_per_step", "graph_captures",
            "graph_replays", "prefill_dispatches", "decode_steps",
            "draft_broadcast_host_ms", "draft_broadcast_host_ms_max")
    emit(phase, model=cfg.name, layers=cfg.n_layers,
         speculative_k=MESH_SPEC_K, **record,
         prompt_tokens=run["prompt_tokens"],
         completion_tokens=run["completion_tokens"], equal_tokens=equal,
         equal_token_share=common_share(base["tokens"], run["tokens"]),
         divergences=divs, near_tie=NEAR_TIE,
         spec_counters_unsharded_mesh=counters,
         collectives=run["collectives"],
         verify_step_collectives=run.get("verify_step_collectives"),
         decode_step_collectives=run.get("decode_step_collectives"),
         launches=run["launches"],
         launches_exact=run["launches"] == run["expected_launches"],
         **{f"mesh_{k}": run[k] for k in keep if k in run},
         **{f"unsharded_{k}": base[k] for k in keep if k in base},
         nvidia_smi=nvidia_smi_name_power())
    if bad:
        raise SystemExit(f"{phase}: the speculative mesh engine's streams "
                         f"part from the unsharded engine's beyond a "
                         f"near-tie: {bad}")
    if equal and any(a != b for a, b in counters.values()):
        raise SystemExit(f"{phase}: equal streams, other speculation "
                         f"counters (unsharded, mesh): {counters}")
    if run.get("verify_step_collectives") != run.get(
            "decode_step_collectives"):
        raise SystemExit(f"{phase}: a verify step's collectives "
                         f"{run['verify_step_collectives']} are not a "
                         f"decode step's {run['decode_step_collectives']}")
    broadcasts = run["verify_steps"] if "draft_broadcasts" in run else 0
    if run["collectives"]["broadcast"] != broadcasts:
        raise SystemExit(f"{phase}: {run['collectives']['broadcast']} "
                         f"broadcasts over {run['verify_steps']} verify "
                         f"steps")
    if record.get("cuda_graphs", True) and run["graph_captures"] \
            and not run["graph_replays"]:
        raise SystemExit(f"{phase}: the graphed mesh engine replayed nothing")


def mesh_spec_paged_cases(prefix, name, bits, kv, mesh, cases,
                          draft: bool = False) -> dict:
    """16a-16c: a slice model at ``MESH_LAYERS`` by the unsharded graphed
    speculative engine, then on each of ``cases`` (label, the meshes'
    keywords, the params' cut: "tp", "fsdp", "stage", "whole" or "ep") on
    the same weights, n-gram drafts or (``draft``) the target's own
    weights as its draft model, whole on the rank (as the card test does
    with TINY): its drafts are accepted, so the verify step's rows 1..k
    (under CP the folded queries) decide the streams; each run must
    accept some.  Returns the mesh runs' launches by phase."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models import mixtral
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_params, shard_stage_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, transform = mesh_model(name, bits)
    ecfg = mesh_spec_config(kv_cache_dtype=kv)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    kw = {"draft_model": (cfg, params)} if draft else {}

    def accepted(phase, run):
        if draft and not run["spec_accepted"]:
            raise SystemExit(f"{phase}: the draft model's drafts were never "
                             f"accepted ({run['spec_drafted']} drafted)")

    base = mesh_spec_run(make_engine(cfg, ecfg, params, tok, **kw), cfg, kv,
                         bits)
    accepted(f"{prefix}_unsharded", base)
    free_card()
    cuts = {"tp": lambda: shard_params(params, llama_param_specs(cfg), mesh),
            "fsdp": lambda: shard_params(
                params, llama_param_specs(cfg, FSDP_LAYOUT), mesh),
            "stage": lambda: shard_stage_params(params, cfg, mesh),
            "ep": lambda: mixtral.shard_params_ep(cfg, params, mesh),
            "whole": lambda: params}
    out = {}
    for label, meshes, cut in cases:
        phase = f"{prefix}_{label}"
        engine = make_engine(cfg, ecfg, cuts[cut](), tok, **kw,
                             **{k: mesh if v == "mesh" else v
                                for k, v in meshes.items()})
        run = mesh_spec_run(engine, cfg, kv, bits)
        ep = engine.model_cfg.ep
        dropped = int(ep.drops) if ep is not None else 0
        mesh_spec_compare(phase, cfg, params, base, run,
                          mesh=f"{label} 1 rank (nccl)", engine="paged",
                          weights=f"int{bits}" if bits else "bfloat16",
                          kv_cache_dtype=kv, dropped=dropped,
                          drafts="model" if draft else "ngram",
                          draft_layers=cfg.n_layers if draft else None)
        accepted(phase, run)
        if dropped:
            raise SystemExit(f"{phase}: {dropped} tokens dropped")
        out[phase] = run["launches"]
        del engine
        free_card()
    del params, kw
    free_card()
    return out


def mesh_spec_contiguous_cases(mesh) -> dict:
    """16d: the contiguous engine (eager) on Llama-3-8B bf16 at
    ``CUT_LAYERS``, n-gram drafts, unsharded and at TP, PP (M = 2) and CP
    ring on the same weights.  Returns the mesh runs' launches by
    phase."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params, shard_stage_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = slice_model("llama3-8b")[0].replace(n_layers=CUT_LAYERS)
    ecfg = mesh_spec_config(paged=False)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    base = mesh_spec_run(make_engine(cfg, ecfg, params, tok), cfg, None,
                         None, paged=False)
    free_card()
    out = {}
    for label, kw, shard in (
            ("tp", {"tp_mesh": mesh},
             lambda: shard_params(params, llama_param_specs(cfg), mesh)),
            ("pp", {"pp_mesh": mesh, "pp_microbatches": PP_MICROBATCHES},
             lambda: shard_stage_params(params, cfg, mesh)),
            ("cp", {"cp_mesh": mesh}, lambda: params)):
        phase = f"mesh_spec_contiguous_{label}"
        engine = make_engine(cfg, ecfg, shard(), tok, **kw)
        run = mesh_spec_run(engine, cfg, None, None, paged=False)
        mesh_spec_compare(phase, cfg, params, base, run,
                          mesh=f"{label} 1 rank (nccl)", engine="contiguous",
                          cuda_graphs=False, weights="bfloat16",
                          drafts="ngram",
                          cache_shape=list(engine.cache.k.shape))
        out[phase] = run["launches"]
        del engine
        free_card()
    del params
    free_card()
    return out


# 16e's two gloo ranks: (label, the mesh's axes, the engine's mesh keyword)
MESH_SPEC_GLOO = (("tp2", dict(model=2), "tp_mesh"),
                  ("cp2", dict(seq=2), "cp_mesh"))
MESH_SPEC_GLOO_NEW = 8


def mesh_spec_gloo_rank(rank: int, n_layers: int) -> dict:
    """One of two ranks on the one card over gloo: Llama-3-8B bf16 cut to
    ``n_layers`` layers, seeded as the parent seeds it, the paged
    speculative engine (eager) at TP 2 and at CP 2 (ring) on the rank's
    cut of the weights: tokens, speculation counters, launches held to
    the counters."""
    import torch

    sys.path.insert(0, str(ROOT))
    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import local_mesh
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = LLAMA3_8B.replace(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    out = {}
    for label, axes, kw_name in MESH_SPEC_GLOO:
        mesh = local_mesh(**axes)
        shard = (params if kw_name == "cp_mesh"
                 else shard_params(params, llama_param_specs(cfg), mesh))
        engine = make_engine(cfg, mesh_spec_config(), shard, tok,
                             cuda_graphs=False, **{kw_name: mesh})
        reset_counts()
        t0 = time.perf_counter()
        res = engine.generate(mesh_prompts(tok),
                              max_new_tokens=MESH_SPEC_GLOO_NEW)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        c = engine._counts
        expect = expected_counts(engine.model_cfg, c, False,
                                 cp_mode=engine.cp_mode)
        out[label] = {"tokens": [r.token_ids for r in res],
                      "seconds": seconds, "launches": counts,
                      "launches_exact": counts == expect,
                      **{k: int(c.get(f"engine.{k}", 0))
                         for k in SPEC_COUNTER_KEYS}}
        del engine, shard
        torch.cuda.empty_cache()
    return out


def mesh_spec_gloo_case() -> None:
    """16e: Llama-3-8B bf16 cut to 2 layers as two gloo processes on the
    one card (eager), the paged speculative engine at TP 2 and CP 2 over
    the four prompts (``mesh_spec_gloo_rank``): the ranks equal, launches
    exact, the streams equal to the unsharded speculative engine's (eager,
    in this process) or parting at a near-tie."""
    import torch

    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    n_layers = 2
    cfg = LLAMA3_8B.replace(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    prompts = mesh_prompts(tok)
    engine = make_engine(cfg, mesh_spec_config(), params, tok,
                         cuda_graphs=False)
    want = [r.token_ids for r in engine.generate(
        prompts, max_new_tokens=MESH_SPEC_GLOO_NEW)]
    want_counts = {k: int(engine._counts.get(f"engine.{k}", 0))
                   for k in SPEC_COUNTER_KEYS}
    del engine
    free_card()
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_spec_gloo_rank, 2,
                      str(ROOT / "build" / "mesh_spec_ranks"),
                      args=(n_layers,), timeout_s=600, device="cuda-gloo")
    wall = time.perf_counter() - t0
    failed = []
    for label, axes, _ in MESH_SPEC_GLOO:
        got = [r[label] for r in ranks]
        equal = got[0]["tokens"] == got[1]["tokens"]
        exact = all(g["launches_exact"] for g in got)
        divs = divergences(cfg, params, prompts, want, got[0]["tokens"])
        bad = [d for d in divs if d["logit_margin"] > NEAR_TIE]
        emit(f"mesh_spec_gloo_{label}", model=cfg.name, layers=n_layers,
             ranks=2, mesh=axes, backend="gloo", cuda_graphs=False,
             engine="paged", speculative_k=MESH_SPEC_K, ranks_equal=equal,
             launches_exact=exact, equal_tokens=got[0]["tokens"] == want,
             equal_token_share=common_share(want, got[0]["tokens"]),
             divergences=divs, near_tie=NEAR_TIE,
             spec_counters_unsharded=want_counts,
             spec_counters_ranks=[{k: g[k] for k in SPEC_COUNTER_KEYS}
                                  for g in got],
             rank_seconds=[g["seconds"] for g in got],
             launches=[g["launches"] for g in got],
             nvidia_smi=nvidia_smi_name_power())
        if not equal or not exact or bad:
            failed.append((label, equal, exact, bad))
    emit("mesh_spec_gloo", wall_s=wall)
    del params
    if failed:
        raise SystemExit(f"mesh spec gloo: (mesh, ranks equal, launches "
                         f"exact, beyond a near-tie) {failed}")


def phase_mesh_spec(gloo: bool = True) -> dict:
    """Phase 16 under a 1-rank nccl process group (destroyed after):
    speculation under a mesh.  16a Llama-3-8B bf16 paged, n-gram drafts,
    at TP, FSDP, PP (M = 2) and CP ring; 16b int4 weights over an int4
    pool with the target as its own draft model at TP and CP; 16c
    Mixtral-8x7B int8 at EP; 16d the contiguous engine at TP, PP and CP; then, with
    ``gloo``, 16e's two gloo ranks (``--mesh-spec``).  Returns the launch
    counts of 16a-16d's mesh runs by phase."""
    from k8s_llm_rca_tpu_torch.runtime import mesh as rmesh

    t0 = time.perf_counter()
    rmesh.initialize_distributed()
    out = {}
    try:
        mesh = rmesh.local_mesh()
        out.update(mesh_spec_paged_cases(
            "mesh_spec", "llama3-8b", None, None, mesh, (
                ("tp", {"tp_mesh": "mesh"}, "tp"),
                ("fsdp", {"fsdp_mesh": "mesh"}, "fsdp"),
                ("pp", {"pp_mesh": "mesh",
                        "pp_microbatches": PP_MICROBATCHES}, "stage"),
                ("cp", {"cp_mesh": "mesh"}, "whole"))))
        out.update(mesh_spec_paged_cases(
            "mesh_spec_int4", "llama3-8b", 4, "int4", mesh, (
                ("tp", {"tp_mesh": "mesh"}, "tp"),
                ("cp", {"cp_mesh": "mesh"}, "whole")), draft=True))
        out.update(mesh_spec_paged_cases(
            "mesh_spec_mixtral", "mixtral-8x7b", 8, "int8", mesh, (
                ("ep", {"ep_mesh": "mesh"}, "ep"),)))
        out.update(mesh_spec_contiguous_cases(mesh))
    finally:
        rmesh.shutdown_distributed()
    if gloo:
        mesh_spec_gloo_case()
        free_card()
    emit("mesh_spec_phase", seconds=time.perf_counter() - t0)
    return out


# phases 5-5d: (phase, model, weight bits, kv_cache_dtype)
SLICES = (("slice", "llama3-8b", None, None),
          ("slice_int4", "llama3-8b", 4, "int4"),
          ("slice_mixtral_int8", "mixtral-8x7b", 8, "int8"),
          ("slice_mixtral_int4", "mixtral-8x7b", 4, "int4"))


def main(argv) -> int:
    if not (ROOT / "k8s_llm_rca_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py runs from the root of a checkout: "
              "k8s_llm_rca_tpu_torch/ is not beside it", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py drives the port on the card",
              file=sys.stderr)
        return 1
    from k8s_llm_rca_tpu_torch.ops import build

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_name_power()
    emit("env", device=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    if "--paged" in argv:
        t0 = time.perf_counter()
        reports = build.build(PAGED_KERNELS)
        emit("build", seconds=time.perf_counter() - t0,
             ptxas={name: ptxas_summary(rep) for name, rep in
                    reports.items()})
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype_name in ("bfloat16", "float32"):
            paged_kernels({}, dtype_name, gen, 256 << 20)
        return 0
    if "--heads" in argv:
        t0 = time.perf_counter()
        reports = build.build(HEAD_KERNELS)
        emit("build", seconds=time.perf_counter() - t0,
             ptxas={name: ptxas_summary(rep) for name, rep in
                    reports.items()})
        torch.backends.cuda.matmul.allow_tf32 = False
        gen = torch.Generator(device="cuda").manual_seed(0)
        heads = head_weights(gen)
        for dtype_name in ("bfloat16", "float32"):
            head_kernels({}, heads, dtype_name, gen, 256 << 20)
        return 0
    t0 = time.perf_counter()
    reports = build.build(KERNELS)
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={name: ptxas_summary(rep) for name, rep in reports.items()},
         sass=kn_sass(build))
    # the host library (page allocator, JSON grammar): g++ into
    # build/native/; a card machine without g++ fails here
    from k8s_llm_rca_tpu_torch import native

    t0 = time.perf_counter()
    native.load_library()
    emit("build_native", seconds=time.perf_counter() - t0,
         library=str(native.library_path().relative_to(ROOT)))

    if "--tiers" in argv:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        memory_tier_cases()
        phase_prefix()
        free_card()
        for phase, bits, kv in (("memory", None, None),
                                ("memory_int4", 4, "int4")):
            phase_memory(phase, "llama3-8b", bits, kv)
            free_card()
        return 0

    if "--durable" in argv:
        # phase 8 alone
        phase_durable()
        return 0

    if "--mesh" in argv:
        # phase 3's mesh-rank shapes and phase 10 alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gen = torch.Generator(device="cuda").manual_seed(0)
        shard_kernels({}, slice3_weights(gen), head_weights(gen),
                      quant_weight(gen, 4096, 14336), gen, 256 << 20)
        free_card()
        phase_mesh()
        return 0

    if "--cp" in argv:
        # phase 3's CP-rank lse cases and phase 11 alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cp_lse_kernels({}, torch.Generator(device="cuda").manual_seed(0),
                       256 << 20)
        free_card()
        phase_cp()
        return 0

    if "--pp" in argv:
        # phase 3's microbatch cases and phase 12 alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        microbatch_paged_kernels(
            {}, torch.Generator(device="cuda").manual_seed(0), 256 << 20)
        free_card()
        phase_pp()
        return 0

    if "--fsdp" in argv:
        # phase 13 alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_fsdp()
        return 0

    if "--mesh-tiers" in argv:
        # phase 15 alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_mesh_tiers()
        return 0

    if "--mesh-spec" in argv:
        # phase 3's CP fold cases and phase 16 alone, 16e with it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cp_lse_kernels({}, torch.Generator(device="cuda").manual_seed(0),
                       256 << 20)
        free_card()
        phase_mesh_spec()
        return 0

    if "--contiguous-mesh" in argv:
        # phase 14 alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_contiguous_mesh()
        return 0

    if "--rerank" in argv:
        # phase 9 alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_rerank()
        return 0

    if "--rca" in argv:
        # phase 6 alone, in a fresh process: ``--after-memory`` runs
        # phase 7's bf16 half before it, as the whole script does
        if "--after-memory" in argv:
            phase_memory("memory", "llama3-8b", None, None)
            free_card()
        phase_rca()
        return 0

    if "--spec" in argv:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype_name in ("bfloat16", "float32"):
            pages_kernels({}, dtype_name, gen)
        spec_overlap_case()
        sweep_case()
        return 0
    if "--slices" in argv:
        # phases 5-5d alone (their profiled steps: ROADMAP Queue 3, fault
        # 6)
        for phase, name, bits, kv in SLICES:
            phase_slice(phase, name, bits, kv)
            free_card()
        return 0
    if "--profile-decode" in argv:
        for name, bits, kv in (("llama3-8b", None, None),
                               ("llama3-8b", 4, "int4"),
                               ("mixtral-8x7b", 8, "int8")):
            phase_profile_decode(name, bits, kv)
            free_card()
        phase_host_costs()
        return 0
    table = phase_kernels()
    free_card()
    phase_cross_device()
    runs = {}
    for phase, name, bits, kv in SLICES:
        runs.update(phase_slice(phase, name, bits, kv))
        free_card()                   # one model on the card at a time
    runs["prefix"] = phase_prefix()
    free_card()
    for phase, bits, kv in (("memory", None, None),
                            ("memory_int4", 4, "int4")):
        runs[phase] = phase_memory(phase, "llama3-8b", bits, kv)
        free_card()
    runs.update(phase_rca())
    free_card()
    runs.update(phase_durable())
    free_card()
    runs.update(phase_rerank())
    free_card()
    runs.update(phase_mesh())
    free_card()
    runs.update(phase_cp())
    free_card()
    runs.update(phase_pp())
    free_card()
    runs.update(phase_fsdp())
    free_card()
    runs.update(phase_contiguous_mesh())
    free_card()
    runs.update(phase_mesh_tiers(gloo=False))
    free_card()
    runs.update(phase_mesh_spec(gloo=False))
    free_card()

    rows = []
    # launches: the main paths' runs of each kernel, summed (flash now
    # also attends the prefix hits, chunks and verify steps)
    for name, src, replaces, key, phases, count in (
            ("paged_attention", PAGED_SRC,
             "k8s_llm_rca_tpu/ops/paged_attention.py:90",
             ("paged_attention", "bfloat16", "mixed"),
             ("slice", "slice_spec", "prefix", "memory", "rca", "rca_spec",
              "rca_resilient", "durable", "durable_cli", "rerank_rca",
              "rerank_rca_yardstick", "mesh", "cp_ring", "cp_ulysses", "pp",
              "fsdp", "fsdp_sp", "mesh_tiers", "mesh_tiers_cut")
             + MESH_SPEC_BF16, "paged"),
            ("flash_attention", FLASH_SRC,
             "k8s_llm_rca_tpu/ops/flash_attention.py:31",
             ("flash_attention", "bfloat16", "full"),
             ("slice", "slice_spec", "prefix", "memory", "memory_int4",
              "rca", "rca_spec", "rca_resilient", "durable",
              "durable_int4", "durable_cli", "rerank_rca",
              "rerank_rca_yardstick", "contiguous", "contiguous_int4",
              "contiguous_cli", "mesh", "mesh_int4", "mesh_mixtral",
              "cp_ulysses", "pp", "pp_int4", "pp_mixtral", "fsdp",
              "fsdp_int4", "fsdp_sp", "fsdp_mixtral", "mesh_tiers",
              "mesh_tiers_int4", "mesh_tiers_mixtral", "mesh_tiers_cut")
             + CONTIGUOUS_MESH_BF16 + CONTIGUOUS_MESH_INT4
             + CONTIGUOUS_MESH_MIXTRAL + MESH_SPEC_BF16 + MESH_SPEC_INT4
             + MESH_SPEC_MIXTRAL + MESH_SPEC_CONTIGUOUS, "flash"),
            ("quant_matmul", QMM_SRC,
             "k8s_llm_rca_tpu/ops/quant_matmul.py:137",
             ("quant_matmul", "bfloat16", "decode"),
             ("slice_int4", "slice_int4_spec", "memory_int4",
              "durable_int4", "contiguous_int4", "mesh_int4",
              "cp_int4_ring", "pp_int4", "fsdp_int4", "mesh_tiers_int4")
             + CONTIGUOUS_MESH_INT4 + MESH_SPEC_INT4, "qmm"),
            ("quant_matmul_head", QMM_SRC,
             "k8s_llm_rca_tpu/ops/quant_matmul.py:177",
             ("quant_matmul_head", "bfloat16", "llama3-8b int4"),
             ("slice_int4", "slice_int4_spec", "memory_int4",
              "durable_int4", "contiguous_int4", "mesh_int4",
              "cp_int4_ring", "pp_int4", "fsdp_int4", "mesh_tiers_int4")
             + CONTIGUOUS_MESH_INT4 + MESH_SPEC_INT4, "qmm_head"),
            ("paged_attention_quant", PAGED_QUANT_SRC,
             "k8s_llm_rca_tpu/ops/paged_attention.py:141",
             ("paged_attention_quant", "bfloat16", "int4"),
             ("slice_int4", "slice_int4_spec", "memory_int4",
              "durable_int4", "mesh_int4", "mesh_mixtral", "cp_int4_ring",
              "pp_int4", "pp_mixtral", "fsdp_int4", "fsdp_mixtral",
              "mesh_tiers_int4", "mesh_tiers_mixtral")
             + MESH_SPEC_INT4 + MESH_SPEC_MIXTRAL, "paged_quant"),
            ("quant_matmul_int8", QMM8_SRC,
             "k8s_llm_rca_tpu/ops/quant_matmul.py:120",
             ("quant_matmul_int8", "bfloat16", "decode"),
             ("slice_mixtral_int8", "mesh_mixtral", "pp_mixtral",
              "fsdp_mixtral", "mesh_tiers_mixtral")
             + CONTIGUOUS_MESH_MIXTRAL + MESH_SPEC_MIXTRAL, "qmm8"),
            ("quant_matmul_head_int8", QMM8_SRC,
             "k8s_llm_rca_tpu/ops/quant_matmul.py:159",
             ("quant_matmul_head_int8", "bfloat16", "mixtral-8x7b int8"),
             ("slice_mixtral_int8", "mesh_mixtral", "pp_mixtral",
              "fsdp_mixtral", "mesh_tiers_mixtral")
             + CONTIGUOUS_MESH_MIXTRAL + MESH_SPEC_MIXTRAL, "qmm_head8"),
            ("quant_matmul_experts_int8", EKN_SRC,
             "k8s_llm_rca_tpu/ops/quant_matmul.py:201",
             ("quant_matmul_experts_int8", "bfloat16", "3d decode"),
             ("slice_mixtral_int8", "mesh_mixtral", "pp_mixtral",
              "fsdp_mixtral", "mesh_tiers_mixtral")
             + CONTIGUOUS_MESH_MIXTRAL + MESH_SPEC_MIXTRAL, "qmm_experts8"),
            ("quant_matmul_experts_int4", EKN_SRC,
             "k8s_llm_rca_tpu/ops/quant_matmul.py:218",
             ("quant_matmul_experts_int4", "bfloat16", "3d decode"),
             ("slice_mixtral_int4",), "qmm_experts")):
        rec = table[key]
        # the absolute error over the main path's dtype (bf16), every case
        err = max(r["max_abs_err"] for k, r in table.items()
                  if k[0] == name and k[1] == "bfloat16")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": sum(runs[p][count] for p in phases),
                     "max_abs_err": err, "ms": rec["kernel_ms"],
                     "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                     "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
