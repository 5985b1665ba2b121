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
   decode and prefill (int8 at all three buckets; slice 3).  Every matmul
   case names the kn or nk body it took.
4. cross-device: the engine on the card and on the CPU gives the same
   greedy tokens for a 2-layer model (head_dim 128, GQA 4, fp32), for
   TINY (head_dim 32, GQA 2, fp32) with its own weights, with int4 weights
   under ``fused_quant_matmul`` over int4 and int8 KV pools and with int8
   weights over an int8 pool, and for TINY_MOE with int8 weights over an
   int8 pool and int4 weights over an int4 pool; and for TINY when a slot
   retires near max_seq_len and the next batch decodes with it idle.  Then
   the RCA sweep on TINY (fp32, the soak engine, two incidents at
   concurrency 2) on the card and on the CPU with the same weights: at
   vocab 512 every grammar compiles to DFA tables, so the card runs the
   constrained scan (``paged_decode_scan_dfa``); the report bytes must be
   equal, with no failed incident and the engine left clean.
5. slice: Llama-3-8B at full depth and width in bf16 (seeded random
   weights) behind ``AssistantService`` answers four requests of ~400,
   900, 1500 and 2300 prompt tokens; the paged and flash kernels' launch
   counters must be 32 x (decode steps) and 32 x (prefill dispatches).
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
6. rca: the agent loop at full width.  Llama-3-8B in bf16 (seeded random
   weights) behind the soak engine (max_seq_len 2560, one 2560 bucket,
   page 64, 168 pages, decode_chunk 16, greedy) runs the four fixture
   incidents at concurrency 4 through locator -> cyphergen -> auditor
   (``faults/soak.py::run_pipelined_sweep``).  At vocab 128256 the
   grammars do not compile to DFA tables: every stage decodes under the
   interpreted grammar, one stepwise tick per token.  It prints the
   incidents' wall seconds, ticks, the grammar kinds taken, the host time
   of the grammar masks and the launch counts (paged = 32 x decode steps,
   flash = 32 x prefill dispatches), and fails unless every incident
   completes, every stage reply that decodes parses and the engine is
   left clean.  A cypher stage whose prompt leaves less budget than its
   skeleton grammar needs is refused (``BudgetError``) and falls back to
   the compiled query, as in the JAX pipeline: the phase counts the
   cypher replies parsed and the stages refused, one or the other for
   each analysis.

Then the kernel table (one JSON line), the ``nvidia-smi`` name and power
limit line, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
``--profile-decode`` runs only a profile of one decode step at the slice's
shapes (Llama-3-8B bf16 and int4, Mixtral-8x7B int8), and the host time
per call of the int4 step's extra eager work (the sources of PERF.md's
decode-step breakdowns), and prints no result line.  ``--paged`` builds
the two paged sources and runs only phase 3's paged cases (their build
report and times), and ``--heads`` the two matmul sources with a head and
only phase 3's head cases; neither prints a result line.
"""


from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
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


def paged_case(dtype, gen, lengths=PAGED_LENGTHS["mixed"]):
    """The decode shapes of the slice: B=4, 32 heads over 8 kv-heads,
    d=128, page 64, over shuffled page ids of a 168-page pool (table width
    40 = 2560 / 64); lengths 1 / 64 / 65 / 2400 (a new request beside long
    ones) or 2400 x 4 (a batch of long RCA prompts in steady state)."""
    import torch

    b, h, n_kv, d, page, n_pages, pps = 4, 32, 8, 128, 64, 168, 40
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


def paged_bound(q, kp, lens, dtype_name, scale_bytes: int = 0):
    """Bytes: q and out, the pages' rows the lengths need (with
    ``scale_bytes`` of scales per row and pool), lengths and table entries;
    operations: q.k and p.v at 2 flops per MAC."""
    b, h, d = q.shape
    page = kp.shape[1]
    tokens = int(lens.sum())
    pages_read = sum(-(-int(n) // page) for n in lens.tolist())
    row_bytes = kp.shape[2] * kp.element_size() + scale_bytes
    nbytes = (2 * b * h * d * q.element_size() + 2 * tokens * row_bytes
              + 4 * b + 4 * pages_read)
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
    return {"full": full, "chunk": chunk, "batch2": batch2}


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


def flash_kernels(table, dtype_name, gen) -> None:
    """Each flash case against the plain version, timed with its SDPA
    yardstick and bound."""
    import torch

    from k8s_llm_rca_tpu_torch.ops.attention import causal_attention
    from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention

    dtype = getattr(torch, dtype_name)
    for case, (q, k, v, lens, off) in flash_cases(dtype, gen).items():
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
        fl = flush if m == 4 else 0
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
    """Each head at decode, x [4, 4096], against the plain version on the
    same values in fp32, with the body it took, L2 flushed before each
    launch as in a decode step."""
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
        x = torch.randn((4, 4096), generator=gen, device="cuda").to(dtype)
        w_dense = dq(w, dtype).to(dtype)    # dequantized before timing
        timed_case(table, (name, dtype_name, case), name, dtype_name,
                   lambda: quant_matmul_head(x, w),
                   quant_matmul_head_plain(x.float(), w),
                   lambda: quant_matmul_head_plain(x, w),
                   lambda: torch.matmul(x, w_dense.t()),
                   weight_bound(w, x, 4 * v, 2 * 4 * 4096 * v, dtype_name),
                   50, 5, flush, case=case,
                   body=head_body(bits, 4, 4096, v, dtype),
                   shapes=f"x [4, 4096] @ int{bits} [{v}, 4096]^T")
        del w_dense
        torch.cuda.empty_cache()


def paged_kernels(table, dtype_name, gen, flush) -> None:
    """The paged cases of phase 3: the bf16 or fp32 pool at the mixed and
    the long lengths, the int8 and int4 pools at the mixed lengths."""
    import torch

    from k8s_llm_rca_tpu_torch.ops.paged_attention import (
        launched_splits, paged_attention, paged_attention_plain,
        paged_attention_quant, paged_attention_quant_plain,
    )

    dtype = getattr(torch, dtype_name)
    for lens_name, lengths in PAGED_LENGTHS.items():
        args = paged_case(dtype, gen, lengths)
        rec = held_record(
            "paged_attention", dtype_name, paged_attention(*args),
            paged_attention_plain(*args), case=lens_name,
            shapes="B=4 H=32 n_kv=8 d=128 page=64 lens="
            + ",".join(map(str, lengths)),
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
        table[("paged_attention", dtype_name, lens_name)] = rec
        if lens_name != "mixed":
            continue
        for packed, kind in ((False, "int8"), (True, "int4")):
            qargs = paged_quant_case(args, packed)
            rec = held_record(
                "paged_attention_quant", dtype_name,
                paged_attention_quant(*qargs, packed=packed),
                paged_attention_quant_plain(*qargs, packed=packed),
                case=kind, shapes="B=4 H=32 n_kv=8 d=128 page=64 "
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

        # decode: one weight stream per call, cold in L2 as in a decode
        # step; prefill: the 512 and 1024 buckets and two 2560-token
        # prompts batched
        for case, m, iters, plain_iters in (("decode", 4, 200, 20),
                                            ("prefill 512", 512, 20, 3),
                                            ("prefill 1024", 1024, 20, 3),
                                            ("prefill", 5120, 5, 3)):
            x = torch.randn((m, 4096), generator=gen, device="cuda").to(dtype)
            rec = held_record("quant_matmul", dtype_name,
                              quant_matmul(x, w_mlp),
                              quant_matmul_plain(x, w_mlp), case=case,
                              body=kn_body(4, m, 4096, 14336),
                              shapes=f"x [{m}, 4096] @ int4 [4096, 14336]")
            fl = flush if case == "decode" else 0
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
    return table


# ------------------------------------------------------------------ phase 4


def launch_counters():
    """Every kernel's launch counter, by the short name the phases report:
    (wrapper, attribute); the matmul wrappers count int4 launches in
    ``launches`` and int8 launches in ``launches_int8``."""
    from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention
    from k8s_llm_rca_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_quant,
    )
    from k8s_llm_rca_tpu_torch.ops.quant_matmul import (
        quant_matmul, quant_matmul_experts, quant_matmul_head,
    )

    return {"paged": (paged_attention, "launches"),
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


def expected_counts(cfg, engine, quantized_kv: bool, bits=None) -> dict:
    """The launches one engine run must have made: per layer, one decode
    attention per decode step and one flash prefill per prefill dispatch;
    under fused_quant_matmul over ``bits``-wide weights, per layer and per
    decode step or prefill dispatch 7 kn matmuls (dense) or 5 kn matmuls
    (4 projections and the router) and 3 expert matmuls (MoE), and one
    head per decode step and per prefill dispatch."""
    c = engine._counts
    steps = int(c["engine.decode_steps"])
    prefills = int(c["engine.prefill_dispatches"])
    counts = {k: 0 for k in launch_counters()}
    counts["paged_quant" if quantized_kv else "paged"] = cfg.n_layers * steps
    counts["flash"] = cfg.n_layers * prefills
    if cfg.fused_quant_matmul:
        sfx = "8" if bits == 8 else ""
        calls = cfg.n_layers * (steps + prefills)
        moe = cfg.n_experts > 0
        counts["qmm" + sfx] = (5 if moe else 7) * calls
        counts["qmm_experts" + sfx] = 3 * calls if moe else 0
        counts["qmm_head" + sfx] = steps + prefills
    return counts


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
        expect = expected_counts(cfg, engine, kv is not None, bits)
        label = cfg.name + (f"-int{bits}-fused" if bits else "")
        emit("cross_device", model=label, head_dim=cfg.head_dim,
             kv_cache_dtype=kv, prompts=[len(p) for p in prompts],
             tokens_per_seq=[len(r.token_ids) for r in gpu],
             distinct_tokens=[len(set(r.token_ids)) for r in gpu],
             equal_streams=same, launches=counts, expected_launches=expect,
             cpu_s=t1 - t0, gpu_s=t2 - t1)
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
    retired_slot_case()


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
    expect = expected_counts(cfg, engine, False)
    report = gpu["report"]
    same = report_bytes(report) == report_bytes(cpu["report"])
    emit("cross_device", model="tiny-rca-sweep", incidents=2, concurrency=2,
         equal_report_bytes=same, completed=report["completed"],
         failed=report["failed"], engine_clean=report["engine_clean"],
         decode_steps=int(engine._counts["engine.decode_steps"]),
         dispatches=int(engine._counts["engine.dispatches"]),
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
    sweep_case()


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
def watch_logits(flags: list):
    """Record, on the device and without a sync, whether every logits
    tensor the engine samples from is finite."""
    import torch

    from k8s_llm_rca_tpu_torch.engine import paged

    sample = paged.sample_tokens

    def watched(logits, generator, params):
        flags.append(torch.isfinite(logits).all())
        return sample(logits, generator, params)

    paged.sample_tokens = watched
    try:
        yield flags
    finally:
        paged.sample_tokens = sample


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


def phase_slice(phase: str, name: str, bits=None, kv=None) -> dict:
    """A slice model behind AssistantService, four requests: Llama-3-8B in
    bf16 (phase 5) or int4 with an int4 pool (5b), Mixtral-8x7B in int8
    with an int8 pool (5c) or int4 with an int4 pool (5d).  Returns the
    run's launch counts."""
    import torch

    from k8s_llm_rca_tpu_torch.config import EngineConfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.serve.api import (
        AssistantService, Message, RunStatus, Thread, render_prompt,
    )
    from k8s_llm_rca_tpu_torch.serve.backend import EngineBackend, GenOptions
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, transform = slice_model(name, bits)
    ecfg = EngineConfig(max_batch=4, max_seq_len=2560,
                        prefill_buckets=(512, 1024, 2560), max_new_tokens=64,
                        temperature=0.0, paged=True, page_size=64,
                        num_pages=168, prefix_cache=False, decode_chunk=16,
                        kv_cache_dtype=kv)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    engine = make_engine(cfg, ecfg, params, get_tokenizer(
        vocab_size=cfg.vocab_size))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    service = AssistantService(EngineBackend(engine))
    asst = service.create_assistant(
        "You are the root-cause analyst for a Kubernetes cluster.",
        "analyst", gen=GenOptions(max_new_tokens=64))
    stamps = []
    drain = engine._drain_admission_commits

    def drain_stamped():
        out = drain()
        stamps.append(time.perf_counter())
        return out

    engine._drain_admission_commits = drain_stamped
    flags = []
    runs = []
    reset_counts()
    t_submit = time.perf_counter()
    with watch_logits(flags):
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
    c = engine._counts
    expect = expected_counts(cfg, engine, kv is not None, bits)
    all_finite = bool(torch.stack(flags).all())
    usage = [dict(r.usage) for r in runs]
    completion = sum(u["completion_tokens"] for u in usage)
    ttft = stamps[0] - t_submit
    emit(phase, model=cfg.name, layers=cfg.n_layers,
         weights=f"int{bits}" if bits else "bfloat16",
         kv_cache_dtype=kv, fused_quant_matmul=cfg.fused_quant_matmul,
         prompt_tokens=[u["prompt_tokens"] for u in usage],
         completion_tokens=[u["completion_tokens"] for u in usage],
         statuses=[r.status for r in runs], logits_finite=all_finite,
         sampled_batches=len(flags), launches=counts,
         expected_launches=expect,
         prefill_dispatches=int(c["engine.prefill_dispatches"]),
         decode_steps=int(c["engine.decode_steps"]),
         init_s=init_s, ttft_s=ttft,
         decode_tok_per_s=(completion - len(runs)) / (t_end - stamps[0]),
         total_s=t_end - t_submit,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         nvidia_smi=nvidia_smi_name_power())
    if any(r.status != RunStatus.COMPLETED for r in runs):
        raise SystemExit(f"runs did not complete: {[r.status for r in runs]}")
    if any(u["completion_tokens"] <= 0 for u in usage):
        raise SystemExit("a reply has no tokens")
    if not all_finite:
        raise SystemExit("non-finite logits on the slice run")
    if counts != expect:
        raise SystemExit(f"launch counts {counts} != expected {expect}")
    return counts


@contextlib.contextmanager
def watch_grammars(kinds: dict, host_s: list):
    """Tally the grammar class each run's ``GenOptions.grammar`` compiles
    to, and add up the host seconds the engine spends building the
    stepwise ticks' constraints (the interpreted grammars' masks)."""
    from k8s_llm_rca_tpu_torch.engine.paged import PagedInferenceEngine
    from k8s_llm_rca_tpu_torch.serve import backend

    make = backend.make_grammar
    constraints = PagedInferenceEngine._tick_constraints

    def counted(spec, tokenizer):
        g = make(spec, tokenizer)
        if g is not None:
            name = type(g).__name__
            kinds[name] = kinds.get(name, 0) + 1
        return g

    def timed(self, *args):
        t0 = time.perf_counter()
        try:
            return constraints(self, *args)
        finally:
            host_s[0] += time.perf_counter() - t0

    backend.make_grammar = counted
    PagedInferenceEngine._tick_constraints = timed
    try:
        yield kinds
    finally:
        backend.make_grammar = make
        PagedInferenceEngine._tick_constraints = constraints


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
    soak engine.  Returns the run's launch counts."""
    import torch

    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.faults.soak import run_pipelined_sweep
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.logging import METRICS

    cfg = LLAMA3_8B
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kinds, host_s, cypher_parsed, cypher_refused = {}, [0.0], [0], [0]
    n_before = METRICS.timings["rca.incident"].count
    reset_counts()
    t1 = time.perf_counter()
    with watch_grammars(kinds, host_s), \
            watch_cypher(cypher_parsed, cypher_refused):
        out = run_pipelined_sweep(backend="engine", n_incidents=4,
                                  concurrency=4, model_cfg=cfg,
                                  params=params)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t1
    counts = read_counts()
    engine = out["engines"][0]
    c = engine._counts
    report = out["report"]
    expect = expected_counts(cfg, engine, False)
    timer = METRICS.timings["rca.incident"]
    incident_s = sorted(timer.window()[-(timer.count - n_before):])
    parsed = stage_replies_parse(report, cypher_parsed[0],
                                 cypher_refused[0])
    emit("rca", model=cfg.name, layers=cfg.n_layers, vocab=cfg.vocab_size,
         incidents=report["n_incidents"], concurrency=4,
         completed=report["completed"], failed=report["failed"],
         engine_clean=report["engine_clean"], replies_parsed=parsed,
         incident_s=incident_s,
         incident_p50_s=statistics.median(incident_s),
         incident_max_s=max(incident_s), total_s=total_s, init_s=init_s,
         decode_steps=int(c["engine.decode_steps"]),
         dispatches=int(c["engine.dispatches"]),
         prefill_dispatches=int(c["engine.prefill_dispatches"]),
         completion_tokens=int(c["engine.decode_tokens"]),
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
        raise SystemExit(f"rca: {report['completed']} of 4 incidents "
                         f"completed, {report['failed']} failed: "
                         f"{[r.get('error') for r in report['incidents']]}")
    if not report["engine_clean"]:
        raise SystemExit("rca: the engine was not left clean")
    if not parsed:
        raise SystemExit(f"rca: a stage reply did not parse (cypher: "
                         f"{cypher_parsed[0]} parsed, {cypher_refused[0]} "
                         f"refused by their budget)")
    if counts != expect:
        raise SystemExit(f"rca: launch counts {counts} != expected {expect}")
    return counts


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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

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
    out = {}
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")  # beside nvcc
    for name in ("quant_matmul", "quant_matmul_int8", "quant_matmul_experts"):
        counts = sass_counts(cuobjdump, build.library_path(name),
                             ("kn_wgmma_kernel", "kn_gemv_mma_kernel",
                              "nk_mma_kernel"))
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
    for phase, name, bits, kv in (("slice", "llama3-8b", None, None),
                                  ("slice_int4", "llama3-8b", 4, "int4"),
                                  ("slice_mixtral_int8", "mixtral-8x7b", 8,
                                   "int8"),
                                  ("slice_mixtral_int4", "mixtral-8x7b", 4,
                                   "int4")):
        runs[phase] = phase_slice(phase, name, bits, kv)
        free_card()                   # one model on the card at a time
    runs["rca"] = phase_rca()
    free_card()

    rows = []
    for name, src, replaces, key, phase, count in (
            ("paged_attention", PAGED_SRC,
             "k8s_llm_rca_tpu/ops/paged_attention.py:90",
             ("paged_attention", "bfloat16", "mixed"), "slice", "paged"),
            ("flash_attention", FLASH_SRC,
             "k8s_llm_rca_tpu/ops/flash_attention.py:31",
             ("flash_attention", "bfloat16", "full"), "slice", "flash"),
            ("quant_matmul", QMM_SRC,
             "k8s_llm_rca_tpu/ops/quant_matmul.py:137",
             ("quant_matmul", "bfloat16", "decode"), "slice_int4", "qmm"),
            ("quant_matmul_head", QMM_SRC,
             "k8s_llm_rca_tpu/ops/quant_matmul.py:177",
             ("quant_matmul_head", "bfloat16", "llama3-8b int4"),
             "slice_int4", "qmm_head"),
            ("paged_attention_quant", PAGED_QUANT_SRC,
             "k8s_llm_rca_tpu/ops/paged_attention.py:141",
             ("paged_attention_quant", "bfloat16", "int4"), "slice_int4",
             "paged_quant"),
            ("quant_matmul_int8", QMM8_SRC,
             "k8s_llm_rca_tpu/ops/quant_matmul.py:120",
             ("quant_matmul_int8", "bfloat16", "decode"),
             "slice_mixtral_int8", "qmm8"),
            ("quant_matmul_head_int8", QMM8_SRC,
             "k8s_llm_rca_tpu/ops/quant_matmul.py:159",
             ("quant_matmul_head_int8", "bfloat16", "mixtral-8x7b int8"),
             "slice_mixtral_int8", "qmm_head8"),
            ("quant_matmul_experts_int8", EKN_SRC,
             "k8s_llm_rca_tpu/ops/quant_matmul.py:201",
             ("quant_matmul_experts_int8", "bfloat16", "3d decode"),
             "slice_mixtral_int8", "qmm_experts8"),
            ("quant_matmul_experts_int4", EKN_SRC,
             "k8s_llm_rca_tpu/ops/quant_matmul.py:218",
             ("quant_matmul_experts_int4", "bfloat16", "3d decode"),
             "slice_mixtral_int4", "qmm_experts")):
        rec = table[key]
        # the absolute error over the main path's dtype (bf16), every case
        err = max(r["max_abs_err"] for k, r in table.items()
                  if k[0] == name and k[1] == "bfloat16")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": runs[phase][count],
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
