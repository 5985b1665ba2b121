"""Metered batch driver (the port of ``k8s_llm_rca_tpu/sweeps/run_file.py``,
the reference's test_with_file.py equivalent).

Reads incidents from a CSV (one message per row, header skipped), runs the
full pipeline, and APPENDS one JSON record per incident to the output file —
the sweep is resumable at incident granularity, exactly like the reference
(test_with_file.py:42-53,200-204).  Each record carries the reference's
schema: error_message, locator_attempts, analysis[{extend_metapath,
cypher_query, cypher_attempts, human_cypher_query?, statepath[{report,
clue}]}], time_cost, token_usage.

Usage:
    python -m k8s_llm_rca_tpu_torch.sweeps.run_file \
        --input data/incidents.csv --output output/rca-results.json \
        [--backend oracle|engine --paged] [--device cuda|cpu]

``--backend engine`` runs the paged engine on the card (``--device cpu``
for the CPU); ``--replicas`` places one engine per card round-robin.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import time

from k8s_llm_rca_tpu_torch.config import RCAConfig, SweepConfig
from k8s_llm_rca_tpu_torch.graph.fixtures import INCIDENTS
from k8s_llm_rca_tpu_torch.rca import RCAPipeline
from k8s_llm_rca_tpu_torch.runtime import profiling
from k8s_llm_rca_tpu_torch.sweeps.common import (
    add_common_args, build_executors, build_service,
)
from k8s_llm_rca_tpu_torch.utils.logging import METRICS, get_logger

log = get_logger(__name__)


def chip_metrics(elapsed_s: float, device=None) -> dict:
    """Device-level observability for the sweep summary: decode tokens/sec
    over the engine's ``engine.decode_step`` phase timer and over the
    sweep, and the memory of ``device`` (``hbm_*``; none without an
    engine device, ``{}`` on the CPU)."""
    decode_tokens = METRICS.count("engine.decode_tokens")
    decode_s = METRICS.total("engine.decode_step")
    out = {
        "decode_tokens": decode_tokens,
        "prefill_tokens": METRICS.count("engine.prefill_tokens"),
        "decode_tokens_per_sec": round(decode_tokens / decode_s, 2)
        if decode_s > 0 else None,
        "sweep_tokens_per_sec": round(decode_tokens / elapsed_s, 2)
        if elapsed_s > 0 else None,
    }
    if device is not None:
        out.update({f"hbm_{k}": v for k, v in
                    profiling.device_memory_stats(device).items()})
    return out


def write_default_corpus(path: str, repeat: int = 1) -> None:
    """Materialize the built-in incident corpus as a driver CSV."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["error_message"])
        for _ in range(repeat):
            for incident in INCIDENTS:
                writer.writerow([incident.message])


def load_corpus(path: str) -> list:
    messages = []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        next(reader)                      # header
        for row in reader:
            if row:
                messages.append(row[0])
    return messages


def scan_output(output_path: str, truncate_partial: bool = False):
    """Resumability scan: (completed records' error_messages, character
    offset past the last COMPLETE record).  The file is a stream of
    concatenated pretty-printed JSON objects (reference format); a crash
    mid-append leaves a partial tail object, which the offset excludes —
    ``truncate_partial`` rewrites the file without it (one read, in here,
    so resume doesn't re-read the whole output just to truncate)."""
    if not os.path.exists(output_path):
        return [], 0
    with open(output_path) as f:
        text = f.read()
    decoder = json.JSONDecoder()
    idx, msgs, end = 0, [], 0
    while idx < len(text):
        while idx < len(text) and text[idx].isspace():
            idx += 1
        if idx >= len(text):
            break
        try:
            obj, idx = decoder.raw_decode(text, idx)
        except ValueError:
            break                         # trailing partial record
        msgs.append(obj.get("error_message"))
        end = idx
    if truncate_partial and len(text.rstrip()) > end:
        log.warning("truncating partial tail record in %s (crash artifact)",
                    output_path)
        # atomic: a crash between truncate and rewrite must not lose the
        # completed records, so write a sibling temp file and rename over
        tmp = output_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text[:end] + ("\n" if end else ""))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, output_path)
    return msgs, end


def completed_incidents(output_path: str) -> int:
    """Count of complete records already in the output."""
    return len(scan_output(output_path)[0])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--input", default="data/incidents.csv")
    parser.add_argument("--output", default="output/rca-results.json")
    parser.add_argument("--slice", default=":",
                        help="incident slice lo:hi")
    parser.add_argument("--resume", action="store_true",
                        help="skip incidents already present in --output")
    parser.add_argument("--replicas", type=int, default=1,
                        help="data-parallel serving: N pipeline replicas "
                             "(engine replicas pinned round-robin to local "
                             "devices) drain one incident queue "
                             "(BASELINE configs[2] pod-sweep shape)")
    parser.add_argument("--workers", type=int, default=1,
                        help="N worker threads sharing ONE engine/service: "
                             "concurrent incidents' runs merge into shared "
                             "continuous-batching decode ticks (per-chip "
                             "batching; --replicas scales across chips)")
    parser.add_argument("--concurrency", type=int, default=1,
                        help="K incidents in flight on ONE engine via the "
                             "single-threaded pipelined sweep scheduler "
                             "(rca/scheduler.py): async run submission + "
                             "shared pump, deterministic interleave, "
                             "byte-identical outputs to the sequential "
                             "sweep under greedy (requires "
                             "--fresh-threads)")
    args = parser.parse_args(argv)
    if args.replicas > 1 and args.workers > 1:
        parser.error("--replicas and --workers are mutually exclusive: "
                     "replicas build one engine per device, workers share "
                     "one engine (use replicas x workers via one process "
                     "per device if both are wanted)")
    if args.concurrency > 1 and (args.replicas > 1 or args.workers > 1):
        parser.error("--concurrency is the single-threaded pipelined "
                     "scheduler over ONE engine; it composes with neither "
                     "--replicas (engine per device) nor --workers "
                     "(thread per incident)")
    if args.concurrency > 1 and not args.fresh_threads:
        parser.error("--concurrency > 1 requires --fresh-threads: "
                     "interleaved incidents on persistent stage threads "
                     "would make prompts depend on completion order")

    if not os.path.exists(args.input):
        log.info("input %s missing; writing the built-in corpus", args.input)
        write_default_corpus(args.input)

    messages = load_corpus(args.input)
    lo, hi = (int(x) if x else None for x in args.slice.split(":"))
    messages = messages[lo:hi]
    if args.resume:
        # Resume matches completed records to input incidents by MESSAGE
        # (multiset), not by count: under --workers/--replicas incidents
        # complete out of input order, so "skip the first N" would both
        # duplicate unfinished early incidents and drop finished late
        # ones.  A crash mid-append can also leave a partial tail record;
        # truncate it so the resumed appends keep the file parseable.
        done_msgs, _ = scan_output(args.output, truncate_partial=True)
        if done_msgs:
            log.info("resuming: %d incidents already in %s",
                     len(done_msgs), args.output)
            from collections import Counter

            done = Counter(done_msgs)
            remaining = []
            for m in messages:
                if done[m] > 0:
                    done[m] -= 1
                else:
                    remaining.append(m)
            messages = remaining

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    start = time.time()
    n_rep = max(1, args.replicas)
    sweep_sched = None
    if args.concurrency > 1:
        costs, failures, per_replica, sweep_sched = _drain_pipelined(
            args, messages, args.concurrency)
    elif args.workers > 1:
        costs, failures, per_replica = _drain_shared(args, messages,
                                                     args.workers)
    elif n_rep == 1:
        costs, failures, per_replica = _drain_serial(args, messages)
    else:
        costs, failures, per_replica = _drain_replicated(args, messages,
                                                         n_rep)
    elapsed = time.time() - start

    summary = {
        "incidents": len(messages),
        "failures": failures,
        "wall_s": elapsed,
        "p50_incident_s": sorted(costs)[len(costs) // 2] if costs else 0.0,
        "metrics": METRICS.snapshot(),
        "chip": chip_metrics(
            elapsed, args.device if args.backend == "engine" else None),
    }
    if per_replica is not None:
        summary["replicas"] = per_replica
    if args.workers > 1:
        summary["workers"] = args.workers
    if sweep_sched is not None:
        summary["sweep_sched"] = sweep_sched
    print(json.dumps({k: v for k, v in summary.items() if k != "metrics"}))
    return summary


def _build_pipeline(args, device=None):
    service = build_service(args, device)
    meta, state = build_executors(args)
    return RCAPipeline(
        service, meta, state, RCAConfig(model=args.model,
                      fresh_threads=args.fresh_threads),
        sweep=SweepConfig(input_csv=args.input, output_json=args.output))


def _run_one(pipeline, message, output_path, lock=None):
    t0 = time.time()
    try:
        result = pipeline.analyze_incident(message)
        failed = False
    except Exception as e:              # a failed incident must not kill the
        log.warning("incident failed: %s", e)   # sweep; the record keeps it
        result = {"error_message": message, "error": str(e),   # resumable
                  "time_cost": time.time() - t0}
        failed = True
    ctx = lock if lock is not None else contextlib.nullcontext()
    with ctx:
        with open(output_path, "a") as f:
            f.write(json.dumps(result, indent=4) + "\n")
    log.info("incident done in %.2fs -> %s", result["time_cost"],
             output_path)
    return result["time_cost"], failed


def _drain_serial(args, messages):
    pipeline = _build_pipeline(args)
    costs, failures = [], 0
    for message in messages:
        cost, failed = _run_one(pipeline, message, args.output)
        costs.append(cost)
        failures += failed
    pipeline.meta_executor.close()
    pipeline.state_executor.close()
    return costs, failures, None


def _drain_pipelined(args, messages, k):
    """Pipelined sweep: K incidents in flight on ONE service via the
    single-threaded ``SweepScheduler`` (rca/scheduler.py) — each pipeline
    submits its next LLM run and yields, the scheduler pumps the shared
    engine once per quiescent round, so one incident's decode overlaps
    another's graph work.  Unlike --workers there are no threads and no
    completion-order nondeterminism: results come back in input order and
    (under greedy + --fresh-threads) are byte-identical to --concurrency 1.
    Records are appended at sweep end, in input order."""
    from k8s_llm_rca_tpu_torch.rca.scheduler import (
        IncidentFailure, SweepScheduler,
    )

    service = build_service(args)       # ONE engine, shared by all slots
    executors = [build_executors(args) for _ in range(k)]
    pipelines = [
        RCAPipeline(
            service, meta, state, RCAConfig(model=args.model,
                      fresh_threads=True),
            sweep=SweepConfig(input_csv=args.input,
                              output_json=args.output))
        for meta, state in executors]
    sched = SweepScheduler(pipelines)
    t0 = time.time()
    results = sched.run(messages)
    elapsed = time.time() - t0
    costs, failures = [], 0
    with open(args.output, "a") as f:
        for message, result in zip(messages, results):
            if isinstance(result, IncidentFailure):
                log.warning("incident failed: %s", result.error)
                record = {"error_message": message,
                          "error": str(result.error)}
                failures += 1
            else:
                record = result
            # interleaved incidents share wall time, so per-incident
            # time_cost is not observable here; report the amortized cost
            record.setdefault("time_cost", elapsed / max(1, len(messages)))
            costs.append(record["time_cost"])
            f.write(json.dumps(record, indent=4) + "\n")
    for meta, state in executors:
        meta.close()
        state.close()
    return costs, failures, None, sched.stats.snapshot()


def _drain_shared(args, messages, n_workers):
    """Shared-engine concurrent sweep: ``n_workers`` threads — each with
    its OWN RCAPipeline (own assistants/threads, so incident conversations
    stay isolated) — submit to ONE AssistantService/engine.  The
    continuous batcher merges the workers' in-flight runs into shared
    decode ticks: on dispatch-latency-dominated hosts this divides the
    per-incident tick cost by the overlap factor, which is the configs[2]
    per-chip story (--replicas covers the across-chip axis)."""
    import queue
    import threading

    service = build_service(args)       # ONE engine, shared by all workers
    work: "queue.Queue[str]" = queue.Queue()
    for m in messages:
        work.put(m)
    lock = threading.Lock()
    costs, failures = [], [0]

    def drain(idx: int) -> None:
        meta, state = build_executors(args)
        pipeline = RCAPipeline(
            service, meta, state, RCAConfig(model=args.model,
                      fresh_threads=args.fresh_threads),
            sweep=SweepConfig(input_csv=args.input,
                              output_json=args.output))
        while True:
            try:
                message = work.get_nowait()
            except queue.Empty:
                break
            cost, failed = _run_one(pipeline, message, args.output, lock)
            with lock:
                costs.append(cost)
                failures[0] += failed
        meta.close()
        state.close()

    threads = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return costs, failures[0], None


def _replica_devices(args):
    """The devices engine replicas go to, round-robin: every card for
    ``--device cuda`` (``cuda:0`` ... ``cuda:{n-1}``), else the one device
    named; None for the oracle backend."""
    if args.backend != "engine":
        return None
    import torch

    from k8s_llm_rca_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda" and args.device == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [str(dev)]


def _drain_replicated(args, messages, n_rep):
    """Data-parallel sweep serving: ``n_rep`` full pipeline replicas — each
    with its OWN assistants and (for --backend engine) its own engine whose
    arrays live on a round-robin-pinned local device — drain one shared
    incident queue.  This is the single-host shape of BASELINE configs[2]
    (a 100-incident sweep across a pod: one replica per chip, DP over
    incidents); multi-host runs launch one process per host with a slice.

    A replica that fails to build counts as one failure, and the queue
    drains through the others; when none builds, the sweep raises the
    first replica's error.
    """
    import queue
    import threading

    work: "queue.Queue[str]" = queue.Queue()
    for m in messages:
        work.put(m)
    lock = threading.Lock()
    costs, failures, per_replica, errors = [], [0], [], []

    devices = _replica_devices(args)

    def drain(idx: int) -> None:
        dev = devices[idx % len(devices)] if devices else None
        try:                           # engine tensors land on ``dev``
            pipeline = _build_pipeline(args, dev)
        except Exception as e:
            log.exception("replica %d failed to build", idx)
            with lock:
                failures[0] += 1
                errors.append((idx, e))
                per_replica.append({"replica": idx, "incidents": 0,
                                    "error": str(e)})
            return
        count = 0
        while True:
            try:
                message = work.get_nowait()
            except queue.Empty:
                break
            cost, failed = _run_one(pipeline, message, args.output, lock)
            with lock:
                costs.append(cost)
                failures[0] += failed
            count += 1
        with lock:
            per_replica.append({"replica": idx, "incidents": count,
                                "device": str(dev) if dev else "host"})
        pipeline.meta_executor.close()
        pipeline.state_executor.close()

    threads = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(n_rep)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if len(errors) == n_rep:
        raise RuntimeError(f"no replica of {n_rep} built") from min(
            errors, key=lambda e: e[0])[1]
    per_replica.sort(key=lambda r: r["replica"])
    return costs, failures[0], per_replica


if __name__ == "__main__":
    main()
