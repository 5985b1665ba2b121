"""Interactive end-to-end driver (the port of
``k8s_llm_rca_tpu/sweeps/run_all.py``, the reference's test_all.py
equivalent).

Runs the full pipeline over a slice of the built-in incident corpus and
prints the reports plus wall-clock bracketing (reference :52,143-151).

Usage:
    python -m k8s_llm_rca_tpu_torch.sweeps.run_all [--backend oracle|engine
        --paged] [--slice 0:4] [--model tiny] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

from k8s_llm_rca_tpu_torch.config import RCAConfig
from k8s_llm_rca_tpu_torch.graph.fixtures import INCIDENTS
from k8s_llm_rca_tpu_torch.rca import RCAPipeline
from k8s_llm_rca_tpu_torch.sweeps.common import (
    add_common_args, build_executors, build_service,
)
from k8s_llm_rca_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--slice", default="0:4",
                        help="incident corpus slice, python syntax lo:hi")
    parser.add_argument("--concurrency", type=int, default=1,
                        help="K incidents in flight via the pipelined "
                             "sweep scheduler (requires --fresh-threads; "
                             "reports stay in input order, byte-identical "
                             "to --concurrency 1 under greedy)")
    args = parser.parse_args(argv)
    if args.concurrency > 1 and not args.fresh_threads:
        parser.error("--concurrency > 1 requires --fresh-threads: "
                     "interleaved incidents on persistent stage threads "
                     "would make prompts depend on completion order")

    lo, hi = (int(x) if x else None for x in args.slice.split(":"))
    messages = [i.message for i in INCIDENTS[lo:hi]]

    service = build_service(args)
    start = time.time()
    if args.concurrency > 1:
        results, failures, closers = _run_pipelined(args, service, messages)
    else:
        meta, state = build_executors(args)
        pipeline = RCAPipeline(service, meta, state,
                               RCAConfig(model=args.model,
                          fresh_threads=args.fresh_threads))
        closers = [meta, state]
        results, failures = [], 0
        for message in messages:
            try:
                results.append(pipeline.analyze_incident(message))
            except Exception as e:
                # an exhausted retry budget on one incident must not kill
                # the sweep (run_file records failures the same way)
                log.warning("incident failed: %s", e)
                results.append(None)
                failures += 1
    for message, result in zip(messages, results):
        print("=" * 100)
        print(message)
        if result is None:
            continue
        for analysis in result["analysis"]:
            for sp in analysis["statepath"]:
                print("-" * 100)
                print(sp["report"])
    elapsed = time.time() - start
    print("*" * 100)
    print(f"analyzed {len(messages)} incident(s) in {elapsed:.2f}s "
          f"({elapsed / max(len(messages), 1):.2f}s per incident, "
          f"{failures} failure(s))")
    for ex in closers:
        ex.close()


def _run_pipelined(args, service, messages):
    """K-in-flight variant of the incident loop: same reports, printed in
    the same input order, via rca/scheduler.py instead of blocking waits."""
    from k8s_llm_rca_tpu_torch.rca.scheduler import (
        IncidentFailure, SweepScheduler,
    )

    executors = [build_executors(args) for _ in range(args.concurrency)]
    pipelines = [
        RCAPipeline(service, meta, state,
                    RCAConfig(model=args.model, fresh_threads=True))
        for meta, state in executors]
    raw = SweepScheduler(pipelines).run(messages)
    results, failures = [], 0
    for r in raw:
        if isinstance(r, IncidentFailure):
            log.warning("incident failed: %s", r.error)
            results.append(None)
            failures += 1
        else:
            results.append(r)
    return results, failures, [ex for pair in executors for ex in pair]


if __name__ == "__main__":
    main()
