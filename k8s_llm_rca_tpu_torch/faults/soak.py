"""The plan-free pipelined RCA sweep: the port of
``k8s_llm_rca_tpu/faults/soak.py::run_pipelined_sweep`` and the pieces of
that module it needs (``_build_engine_service``, ``_incident_row``,
``report_bytes``).

``run_pipelined_sweep`` drives ``concurrency`` incidents at a time through
the RCA pipeline over one shared service (``rca/scheduler.py``) and
returns a report whose bytes are a pure function of the weights, the
incidents and the config: greedy decode on a fresh engine, deadlines on a
``VirtualClock``, and only scheduling-invariant fields in the report.  On
the same weights the port's report bytes equal the JAX package's.

Only the ``engine`` and ``oracle`` backends are ported.  The chaos soak
(fault plans, the resilience ladder), the run journal and the cluster
backends are not (ROADMAP Queue 1 items 3, 4 and 11); asking for them
raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from k8s_llm_rca_tpu_torch.faults.plan import VirtualClock


def _build_engine_service(clock, model_cfg=None, params=None, device=None,
                          engine_overrides=None):
    """The soak's engine stack: TINY with max_seq_len 2560 by default, one
    prefill bucket, page 64, 168 pages, decode_chunk 16, 96 new tokens,
    greedy, no prefix cache; ``engine_overrides`` replaces EngineConfig
    fields (speculative decoding, host overlap, the prefix cache ...).
    ``params`` must already live on ``device`` (``None`` = the card); when
    omitted, seeded port weights are made there.  Returns (service,
    engine)."""
    import dataclasses

    import torch

    from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models import llama
    from k8s_llm_rca_tpu_torch.serve.api import AssistantService
    from k8s_llm_rca_tpu_torch.serve.backend import EngineBackend
    from k8s_llm_rca_tpu_torch.utils.device import resolve_device
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = model_cfg if model_cfg is not None else TINY.replace(
        max_seq_len=2560)
    if params is None:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = llama.init_params(cfg, gen, dev)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    ecfg = EngineConfig(max_batch=4, max_seq_len=2560,
                        prefill_buckets=(2560,),
                        max_new_tokens=96, temperature=0.0,
                        paged=True, page_size=64, num_pages=168,
                        prefix_cache=False, decode_chunk=16)
    if engine_overrides:
        ecfg = dataclasses.replace(ecfg, **engine_overrides)
    engine = make_engine(cfg, ecfg, params, tok, device)
    # deadlines on the sweep's virtual clock: on wall time the first
    # prefill alone could pass the 1.5 s run deadline
    engine.clock = clock
    return (AssistantService(EngineBackend(engine),
                             run_timeout_s=_RUN_TIMEOUT_S, clock=clock),
            engine)


def _build_oracle_service(clock):
    from k8s_llm_rca_tpu_torch.rca.oracle import OracleBackend
    from k8s_llm_rca_tpu_torch.serve.api import AssistantService
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    return AssistantService(OracleBackend(get_tokenizer()),
                            run_timeout_s=_RUN_TIMEOUT_S, clock=clock)


def _incident_row(message: str, result: Dict[str, Any]) -> Dict[str, Any]:
    """Deterministic report row for one completed incident (wall-clock
    cost and windowed token usage excluded)."""
    row: Dict[str, Any] = {"error_message": message}
    degraded = result.get("degraded", [])
    row["status"] = "degraded" if degraded else "resolved"
    row["degraded"] = degraded
    row["locator_attempts"] = result.get("locator_attempts")
    row["analyses"] = [
        {"cypher_attempts": a.get("cypher_attempts"),
         "used_fallback": "human_cypher_query" in a,
         "n_statepaths": len(a.get("statepath", []))}
        for a in result.get("analysis", [])]
    return row


def report_bytes(report: Dict[str, Any]) -> bytes:
    """Canonical bytes of a sweep report (the byte-identity check)."""
    return json.dumps(report, sort_keys=True,
                      separators=(",", ":")).encode()


# the JAX sweep's run deadline, on the sweep's virtual clock
_RUN_TIMEOUT_S = 1.5

# the JAX sweep's options that the port does not take yet, by ROADMAP item
_ITEMS = {
    "resilience": "Queue 1 item 3, fault injection and faults/policy.py",
    "durable_dir": "Queue 1 item 4, serve/journal.py",
    "cluster_replicas": "Queue 1 item 11, fleet",
    **dict.fromkeys(("seed", "run_timeout_s", "incidents", "tracer",
                     "rca_overrides"),
                    "Queue 1 item 5, the port's bench"),
}


def run_pipelined_sweep(n_incidents: int = 10, backend: str = "engine",
                        concurrency: int = 4, model_cfg=None, params=None,
                        device=None, engine_overrides=None,
                        **unported) -> Dict[str, Any]:
    """Plan-free pipelined RCA sweep: ``concurrency`` incidents in flight
    over one shared backend (``rca/scheduler.py::SweepScheduler``), the
    fixture corpus cycled ``n_incidents`` times.

    ``report`` carries only scheduling-invariant fields (statuses, attempt
    counts, the decoded cypher queries and audit reports, token usage by
    run id), so ``report_bytes(out["report"])`` is the parity surface;
    pump counts and inflight samples go to ``out["stats"]``.
    ``backend``: "engine" (``_build_engine_service`` over ``model_cfg``,
    ``params``, ``device`` and ``engine_overrides``, EngineConfig field
    overrides) or "oracle" (the scripted backend, no model).  Any other option of the JAX sweep raises
    ``NotImplementedError`` naming its ROADMAP item.  Returns
    ``{"report", "stats", "service", "engines"}``."""
    from k8s_llm_rca_tpu_torch.config import RCAConfig
    from k8s_llm_rca_tpu_torch.graph import InMemoryGraphExecutor
    from k8s_llm_rca_tpu_torch.graph.fixtures import (
        INCIDENTS, build_metagraph, build_stategraph,
    )
    from k8s_llm_rca_tpu_torch.rca import RCAPipeline
    from k8s_llm_rca_tpu_torch.rca.scheduler import (
        IncidentFailure, SweepScheduler,
    )

    for name in unported:
        if name not in _ITEMS:
            raise TypeError(f"run_pipelined_sweep() got an unexpected "
                            f"keyword argument {name!r}")
        raise NotImplementedError(
            f"run_pipelined_sweep({name}=...) is not ported yet "
            f"(ROADMAP {_ITEMS[name]})")
    if concurrency < 1:
        raise ValueError(f"concurrency must be >= 1, got {concurrency}")

    clock = VirtualClock()
    if backend == "engine":
        service, engine = _build_engine_service(clock, model_cfg, params,
                                                device, engine_overrides)
        engines = [engine]
    elif backend == "oracle":
        service = _build_oracle_service(clock)
        engines = []
    elif backend in ("cluster", "cluster-oracle", "proc-cluster",
                     "net-cluster", "disagg-cluster"):
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet (ROADMAP "
            f"{_ITEMS['cluster_replicas']})")
    else:
        raise ValueError(f"unknown backend {backend!r}")

    meta = InMemoryGraphExecutor(build_metagraph())
    state = InMemoryGraphExecutor(build_stategraph())
    # fresh stage threads: persistent ones would make prompts depend on
    # incident completion order
    cfg = RCAConfig(locator_max_new_tokens=192, cypher_max_new_tokens=96,
                    analyzer_max_new_tokens=96, fresh_threads=True)

    pipelines = [RCAPipeline(service, meta, state, cfg)
                 for _ in range(concurrency)]

    messages = [INCIDENTS[i % len(INCIDENTS)].message
                for i in range(n_incidents)]
    sched = SweepScheduler(pipelines)
    results = sched.run(messages)

    rows: List[Dict[str, Any]] = []
    n_resolved = n_degraded = n_failed = 0
    for message, result in zip(messages, results):
        if isinstance(result, IncidentFailure):
            rows.append({"error_message": message, "status": "failed",
                         "error": result.error})
            n_failed += 1
            continue
        row = _incident_row(message, result)
        # the decoded artifacts make byte-identity attest greedy decode
        # parity, not just structural agreement
        row["token_usage"] = result.get("token_usage")
        for ra, a in zip(row["analyses"], result.get("analysis", [])):
            ra["cypher_query"] = a.get("human_cypher_query",
                                       a.get("cypher_query"))
            ra["reports"] = [sp.get("report")
                             for sp in a.get("statepath", [])]
        if row["status"] == "degraded":
            n_degraded += 1
        else:
            n_resolved += 1
        rows.append(row)

    report: Dict[str, Any] = {
        "seed": 0,        # the JAX report's field, at its default
        "backend": backend,
        "n_incidents": len(messages),
        "completed": n_resolved + n_degraded,
        "resolved": n_resolved,
        "degraded": n_degraded,
        "failed": n_failed,
        "incidents": rows,
    }
    if engines:
        # the sweep must leave every engine drained with its allocator
        # invariants intact (the port has no prefix cache to hold pages)
        clean = True
        for eng in engines:
            eng.allocator.check()
            clean = clean and bool(
                not eng.has_work
                and eng.allocator.n_free == eng.engine_cfg.num_pages - 1)
        report["engine_clean"] = clean

    stats: Dict[str, Any] = dict(sched.stats.snapshot())
    stats["concurrency"] = concurrency
    return {"report": report, "stats": stats, "service": service,
            "engines": engines}
