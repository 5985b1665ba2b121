#!/usr/bin/env python3
"""Drive the PyTorch port (``k8s_llm_rca_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Each phase
prints one JSON line; any failure exits non-zero without the result line.

1. env: the card, its power limit, the software versions.
2. build: both CUDA kernels compiled from ``k8s_llm_rca_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together).
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes, in bf16 (row-relative error at most 2^-6, see
   ``TOL``) and fp32 with TF32 off (atol 1e-4), with its time, the plain
   version's, the least time the card could take (bound) and one PyTorch
   library call as a yardstick (timed here only; the port never calls it).
4. cross-device: a 2-layer model (head_dim 128, GQA 4, fp32) served by the
   engine on the card and on the CPU gives the same greedy tokens.
5. slice: Llama-3-8B at full depth and width in bf16 (seeded random
   weights) behind ``AssistantService`` answers four requests of ~400,
   900, 1500 and 2300 prompt tokens; both kernels' launch counters must be
   32 x (decode steps) and 32 x (prefill dispatches) of that run.

Then the kernel table (one JSON line), the ``nvidia-smi`` name and power
limit line, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
``--profile-decode`` runs only a profile of one decode step at the slice's
shapes (the source of PERF.md's decode-step breakdown) and prints no
result line.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PAGED_SRC = "k8s_llm_rca_tpu_torch/csrc/paged_attention.cu"
FLASH_SRC = "k8s_llm_rca_tpu_torch/csrc/flash_attention.cu"
# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# fp32: max |out - ref|.  bf16: max over output rows (one token and head,
# d values) of the row's largest |out - ref| over its largest |ref|, so the
# limit scales with the values compared (|out| is ~0.03 after a softmax
# over thousands of keys).  The two sides round an element to bf16 once
# each, at most one ulp apart: 2^-7 of the row's largest value; the bf16
# flash body's bf16 probabilities add a small fraction of that.
TOL = {"bfloat16": 2 ** -6, "float32": 1e-4}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int, flush_bytes: int = 0) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after warm-up).  With ``flush_bytes`` a buffer that size is rewritten
    before every launch, outside the timed span, so each launch finds the
    L2 cache cold, as a layer's call does on the serving path."""
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
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


# ------------------------------------------------------------------ phase 3


def paged_case(dtype, gen):
    """The decode shapes of the slice: B=4, 32 heads over 8 kv-heads,
    d=128, page 64, lengths 1 / 64 / 65 / 2400 over shuffled page ids of a
    168-page pool (table width 40 = 2560 / 64)."""
    import torch

    b, h, n_kv, d, page, n_pages, pps = 4, 32, 8, 128, 64, 168, 40
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((n_pages, page, n_kv * d), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((n_pages, page, n_kv * d), generator=gen,
                     device="cuda").to(dtype)
    lengths = [1, 64, 65, 2400]
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


def paged_bound(q, kp, lens, dtype_name):
    b, h, d = q.shape
    kv_dim, page = kp.shape[2], kp.shape[1]
    tokens = int(lens.sum())
    es = q.element_size()
    pages_read = sum(-(-int(n) // page) for n in lens.tolist())
    nbytes = (2 * b * h * d * es            # q in, out
              + 2 * tokens * kv_dim * es    # the keys and values it needs
              + 4 * b + 4 * pages_read)     # lengths, table entries used
    flops = 4 * tokens * h * d              # q.k and p.v, 2 flops per MAC
    return bound(nbytes, flops, dtype_name)


def paged_library_fn(q, kp, vp, lens, tables):
    """One SDPA call over a KV view gathered (and head-expanded) before
    timing: the library yardstick for paged decode attention."""
    import torch
    import torch.nn.functional as F

    b, h, d = q.shape
    n_kv = kp.shape[2] // d
    k = kp[tables.long()].reshape(b, -1, n_kv, d).transpose(1, 2)
    v = vp[tables.long()].reshape(b, -1, n_kv, d).transpose(1, 2)
    k = k.repeat_interleave(h // n_kv, dim=1).contiguous()
    v = v.repeat_interleave(h // n_kv, dim=1).contiguous()
    mask = (torch.arange(k.shape[2], device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    qq = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


def flash_cases(dtype, gen):
    """The prefill shapes of the slice: one 2560-token bucket with
    seq_len 2300, and a 512-query chunk at offset 1800 over 2400 keys."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    s, h, n_kv, d = 2560, 32, 8, 128
    full = (rnd(1, s, h, d), rnd(1, s, n_kv, d), rnd(1, s, n_kv, d),
            torch.tensor([2300], dtype=torch.int32, device="cuda"), None)
    chunk = (rnd(1, 512, h, d), rnd(1, s, n_kv, d), rnd(1, s, n_kv, d),
             torch.tensor([2400], dtype=torch.int32, device="cuda"),
             torch.tensor([1800], dtype=torch.int32, device="cuda"))
    return {"full": full, "chunk": chunk}


def flash_bound(q, k, seq_lens, q_offset, dtype_name):
    _, s_q, h, d = q.shape
    s_k, n_kv = k.shape[1], k.shape[2]
    n = min(int(seq_lens[0]), s_k)
    off = 0 if q_offset is None else int(q_offset[0])
    visible = sum(min(off + i + 1, n) for i in range(s_q))
    es = q.element_size()
    nbytes = 2 * s_q * h * d * es + 2 * n * n_kv * d * es + 8
    flops = 4 * visible * h * d
    return bound(nbytes, flops, dtype_name)


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from k8s_llm_rca_tpu_torch.ops.attention import causal_attention
    from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention
    from k8s_llm_rca_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        tol = TOL[dtype_name]

        args = paged_case(dtype, gen)
        out = paged_attention(*args)
        ref = paged_attention_plain(*args)
        torch.cuda.synchronize()
        errs = errors(out, ref)
        err = held(errs, dtype_name)
        finite = bool(torch.isfinite(out).all())
        rec = {"kernel": "paged_attention", "dtype": dtype_name,
               "shapes": "B=4 H=32 n_kv=8 d=128 page=64 lens=1,64,65,2400",
               **errs, "tol": tol, "finite": finite}
        if not (err <= tol and finite):
            emit("kernels", **rec)
            raise SystemExit(f"paged_attention disagrees with its plain "
                             f"version in {dtype_name}: {err} > {tol}")
        rec["kernel_ms"] = time_ms(lambda: paged_attention(*args), 200,
                            flush_bytes=256 << 20)
        rec["plain_ms"] = time_ms(lambda: paged_attention_plain(*args), 20,
                                  flush_bytes=256 << 20)
        rec["library_ms"] = time_ms(paged_library_fn(*args), 200,
                                    flush_bytes=256 << 20)
        rec["bound_ms"], rec["bound_by"] = paged_bound(args[0], args[1],
                                                       args[3], dtype_name)
        emit("kernels", **rec)
        table[("paged_attention", dtype_name)] = rec

        for case, (q, k, v, lens, off) in flash_cases(dtype, gen).items():
            out = flash_attention(q, k, v, lens, off)
            ref = causal_attention(q, k, v, lens, off)
            torch.cuda.synchronize()
            errs = errors(out, ref)
            err = held(errs, dtype_name)
            finite = bool(torch.isfinite(out).all())
            rec = {"kernel": "flash_attention", "dtype": dtype_name,
                   "case": case, "shapes": f"q {list(q.shape)} k/v "
                   f"{list(k.shape)} seq_len {int(lens[0])} q_offset "
                   f"{0 if off is None else int(off[0])}",
                   **errs, "tol": tol, "finite": finite}
            if not (err <= tol and finite):
                emit("kernels", **rec)
                raise SystemExit(f"flash_attention disagrees with its plain "
                                 f"version ({case}, {dtype_name}): {err} > "
                                 f"{tol}")
            rec["kernel_ms"] = time_ms(
                lambda: flash_attention(q, k, v, lens, off),
                                20)
            rec["plain_ms"] = time_ms(
                lambda: causal_attention(q, k, v, lens, off), 5)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if off is None:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            else:
                # the chunk's mask, q_pos >= k_pos and k_pos < seq_len,
                # built before timing
                k_pos = torch.arange(k.shape[1], device="cuda")
                q_pos = int(off[0]) + torch.arange(q.shape[1], device="cuda")
                mask = ((q_pos[:, None] >= k_pos[None, :])
                        & (k_pos[None, :] < int(lens[0])))
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
            rec["library_ms"] = time_ms(lib, 20)
            rec["bound_ms"], rec["bound_by"] = flash_bound(q, k, lens, off,
                                                           dtype_name)
            emit("kernels", **rec)
            table[("flash_attention", dtype_name, case)] = rec
    return table


# ------------------------------------------------------------------ phase 4


def phase_cross_device() -> None:
    """Same weights, same prompts: the engine on the card and on the CPU
    must emit the same greedy tokens (fp32, TF32 off)."""
    import numpy as np
    import torch

    from k8s_llm_rca_tpu_torch.config import EngineConfig, ModelConfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention
    from k8s_llm_rca_tpu_torch.ops.paged_attention import paged_attention
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = ModelConfig(name="smoke-gqa4", vocab_size=512, hidden_size=1024,
                      n_layers=2, n_heads=8, n_kv_heads=2, head_dim=128,
                      intermediate_size=2048, max_seq_len=1024,
                      dtype="float32", tie_embeddings=False)
    ecfg = EngineConfig(max_batch=4, max_seq_len=512,
                        prefill_buckets=(128, 256), max_new_tokens=32,
                        paged=True, page_size=16, num_pages=168,
                        prefix_cache=False, decode_chunk=16)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    # x3 projections: greedy decode walks many distinct tokens
    for layer in cpu_params["layers"]:
        for name in layer:
            if name.startswith("w"):
                layer[name] = layer[name] * 3.0
    gpu_params = {k: ([{n: t.cuda() for n, t in layer.items()}
                       for layer in v] if k == "layers" else v.cuda())
                  for k, v in cpu_params.items()}
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (7, 100, 150, 300)]
    t0 = time.perf_counter()
    cpu = make_engine(cfg, ecfg, cpu_params, tok, device="cpu").generate(
        prompts)
    t1 = time.perf_counter()
    engine = make_engine(cfg, ecfg, gpu_params, tok)
    paged_attention.launches = flash_attention.launches = 0
    gpu = engine.generate(prompts)
    counts = {"paged": paged_attention.launches,
              "flash": flash_attention.launches}
    t2 = time.perf_counter()
    same = [a.token_ids == b.token_ids for a, b in zip(cpu, gpu)]
    c = engine._counts
    expect = {"paged": cfg.n_layers * int(c["engine.decode_steps"]),
              "flash": cfg.n_layers * int(c["engine.prefill_dispatches"])}
    emit("cross_device", model=cfg.name, prompts=[len(p) for p in prompts],
         tokens_per_seq=[len(r.token_ids) for r in gpu],
         distinct_tokens=[len(set(r.token_ids)) for r in gpu],
         equal_streams=same, launches=counts, expected_launches=expect,
         cpu_s=t1 - t0, gpu_s=t2 - t1)
    if not all(same):
        i = same.index(False)
        a, b = cpu[i].token_ids, gpu[i].token_ids
        j = next(k for k in range(min(len(a), len(b))) if a[k] != b[k])
        raise SystemExit(f"card and CPU greedy streams differ: seq {i} "
                         f"token {j}: cpu {a[j]} gpu {b[j]}")
    if counts != expect:
        raise SystemExit(f"launch counts {counts} != expected {expect}")


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


def phase_slice() -> dict:
    import torch

    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B, EngineConfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention
    from k8s_llm_rca_tpu_torch.ops.paged_attention import paged_attention
    from k8s_llm_rca_tpu_torch.serve.api import (
        AssistantService, Message, RunStatus, Thread, render_prompt,
    )
    from k8s_llm_rca_tpu_torch.serve.backend import EngineBackend, GenOptions
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = LLAMA3_8B
    ecfg = EngineConfig(max_batch=4, max_seq_len=2560,
                        prefill_buckets=(512, 1024, 2560), max_new_tokens=64,
                        temperature=0.0, paged=True, page_size=64,
                        num_pages=168, prefix_cache=False, decode_chunk=16)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
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
    paged_attention.launches = flash_attention.launches = 0
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
    counts = {"paged": paged_attention.launches,
              "flash": flash_attention.launches}
    c = engine._counts
    expect = {"paged": cfg.n_layers * int(c["engine.decode_steps"]),
              "flash": cfg.n_layers * int(c["engine.prefill_dispatches"])}
    all_finite = bool(torch.stack(flags).all())
    usage = [dict(r.usage) for r in runs]
    completion = sum(u["completion_tokens"] for u in usage)
    ttft = stamps[0] - t_submit
    emit("slice", model=cfg.name, layers=cfg.n_layers,
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
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    if any(r.status != RunStatus.COMPLETED for r in runs):
        raise SystemExit(f"runs did not complete: {[r.status for r in runs]}")
    if any(u["completion_tokens"] <= 0 for u in usage):
        raise SystemExit("a reply has no tokens")
    if not all_finite:
        raise SystemExit("non-finite logits on the slice run")
    if counts != expect:
        raise SystemExit(f"launch counts {counts} != expected {expect}")
    return counts


def phase_profile_decode(steps: int = 8) -> None:
    """Where one decode step's time goes at the slice's shapes (Llama-3-8B,
    bf16, batch 4 at 400/900/1500/2300 cached tokens): wall time per step
    without and with the profiler, the device time of the step's kernels
    (torch.profiler), the device's busy share and the heaviest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B
    from k8s_llm_rca_tpu_torch.engine.paged import (
        init_paged_cache, paged_decode_step,
    )
    from k8s_llm_rca_tpu_torch.models.llama import init_params

    cfg = LLAMA3_8B
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    pool = init_paged_cache(cfg, 168, 64, "cuda")
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
    emit("profile_decode", steps=steps, wall_ms_per_step=1e3 * wall,
         wall_ms_per_step_profiled=1e3 * wall_profiled,
         device_ms_per_step=device_ms,
         device_busy_share=device_ms / (1e3 * wall_profiled),
         kernel_launches_per_step=sum(e.count for e in events) / steps,
         top=[{"name": e.key[:80], "ms_per_step": dev_us(e) / 1e3 / steps,
               "calls_per_step": e.count / steps} for e in top])


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

    t0 = time.perf_counter()
    reports = build.build(["paged_attention", "flash_attention"])
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={name: [ln.strip() for ln in rep.splitlines()
                       if "registers" in ln or "spill" in ln]
                for name, rep in reports.items()})

    if "--profile-decode" in argv:
        phase_profile_decode()
        return 0
    table = phase_kernels()
    phase_cross_device()
    launches = phase_slice()

    rows = []
    for name, src, replaces, key, count in (
            ("paged_attention", PAGED_SRC,
             "k8s_llm_rca_tpu/ops/paged_attention.py:90",
             ("paged_attention", "bfloat16"), launches["paged"]),
            ("flash_attention", FLASH_SRC,
             "k8s_llm_rca_tpu/ops/flash_attention.py:31",
             ("flash_attention", "bfloat16", "full"), launches["flash"])):
        rec = table[key]
        # the absolute error over the main path's dtype (bf16), every case
        err = max(r["max_abs_err"] for k, r in table.items()
                  if k[0] == name and k[1] == "bfloat16")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": count,
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
