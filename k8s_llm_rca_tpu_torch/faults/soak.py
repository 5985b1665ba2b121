"""The chaos soak and the pipelined RCA sweep: the port of
``k8s_llm_rca_tpu/faults/soak.py`` for the ``engine`` and ``oracle``
backends.

``run_chaos_soak`` drives the incidents one at a time through the
resilient pipeline (graph executors behind ``ResilientExecutor``, the
degradation ladder armed) under a seeded ``FaultPlan``, and returns a
report whose bytes are a pure function of ``(seed, spec, config)`` and the
weights: the plan is sampled once from the seed, decode is greedy, backoff
and deadlines run on the plan's ``VirtualClock``, and the report holds only
deterministic fields.  On the same weights its bytes equal the JAX
package's.

``run_pipelined_sweep`` drives ``concurrency`` incidents at a time through
the RCA pipeline over one shared service (``rca/scheduler.py``) and
returns a report whose bytes are a pure function of the weights, the
incidents and the config: greedy decode on a fresh engine, deadlines on a
``VirtualClock``, and only scheduling-invariant fields in the report.  On
the same weights the port's report bytes equal the JAX package's.

Both take ``durable_dir``, where every service mutation goes to the run
journal ``serve.wal`` (``serve/journal.py``) without changing the report,
and the chaos soak takes a ``faults/supervisor.py::CrashSupervisor`` that
kills the serving stack at incident boundaries and recovers it from that
journal, again with the same report bytes.  Only the ``engine`` and
``oracle`` backends are ported.  Replica killers, self-healing, the store
fabric and the cluster backends are not (ROADMAP Queue 1 item 11); asking
for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from k8s_llm_rca_tpu_torch.faults import inject
from k8s_llm_rca_tpu_torch.faults.plan import FaultPlan, VirtualClock
from k8s_llm_rca_tpu_torch.faults.policy import (
    ResiliencePolicy, ResilientExecutor, RetryPolicy,
)


def default_plan_spec() -> Dict[str, Dict[str, Any]]:
    """The standard chaos mix: graph faults, backend run faults (stalls
    the serve deadline must reap among them) and engine tick faults
    (preemption waves, allocator exhaustion, host stalls)."""
    return {
        inject.SITE_GRAPH: {
            "rate": 0.10, "horizon": 160, "delay_s": 0.01,
            "kinds": ("error", "timeout", "empty", "slow", "poison"),
        },
        inject.SITE_BACKEND: {
            "rate": 0.15, "horizon": 48,
            "kinds": ("error", "stall", "budget"),
        },
        inject.SITE_ENGINE_TICK: {
            "rate": 0.02, "horizon": 400, "delay_s": 0.01, "wave": 1,
            "kinds": ("preempt", "oom", "stall"),
        },
    }


def _resilience_policy(seed: int, clock) -> ResiliencePolicy:
    """The soak's ladder policy (the JAX soak's constants)."""
    return ResiliencePolicy(
        retry=RetryPolicy(max_attempts=3, base_delay_s=0.01,
                          max_delay_s=0.1, deadline_s=5.0, seed=seed,
                          clock=clock),
        failure_threshold=4, reset_timeout_s=0.5, reduced_tokens=256)


def _slot_policy(policy: ResiliencePolicy) -> ResiliencePolicy:
    """Another slot's ladder policy: the same constants and the shared
    retry; ``degradations`` is per-incident state, so interleaved
    incidents must not share one."""
    return ResiliencePolicy(retry=policy.retry,
                            failure_threshold=policy.failure_threshold,
                            reset_timeout_s=policy.reset_timeout_s,
                            reduced_tokens=policy.reduced_tokens)


def _build_engine_service(clock, model_cfg=None, params=None, device=None,
                          engine_overrides=None,
                          run_timeout_s: float = 1.5, journal=None):
    """The soak's engine stack: TINY with max_seq_len 2560 by default, one
    prefill bucket, page 64, 168 pages, decode_chunk 16, 96 new tokens,
    greedy, no prefix cache; ``engine_overrides`` replaces EngineConfig
    fields (speculative decoding, host overlap, the prefix cache ...).
    ``params`` must already live on ``device`` (``None`` = the card); when
    omitted, seeded port weights are made there.  ``journal``: the
    service's RunJournal.  Returns (service, engine, backend factory); the
    factory hands the SAME engine to a restarted backend, standing in for
    the restarted worker's engine on identical weights."""
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

    def factory():
        return EngineBackend(engine)

    return (AssistantService(factory(), run_timeout_s=run_timeout_s,
                             clock=clock, journal=journal),
            engine, factory)


def _build_oracle_service(clock, run_timeout_s: float = 1.5, journal=None):
    """(service, None, backend factory) of the scripted oracle."""
    from k8s_llm_rca_tpu_torch.rca.oracle import OracleBackend
    from k8s_llm_rca_tpu_torch.serve.api import AssistantService
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    def factory():
        return OracleBackend(get_tokenizer())

    return (AssistantService(factory(), run_timeout_s=run_timeout_s,
                             clock=clock, journal=journal),
            None, factory)


def _engine_clean(engines) -> bool:
    """Every engine drained with its allocator invariants intact and no
    page held beyond prefix residency."""
    clean = True
    for eng in engines:
        eng.allocator.check()
        resident = (eng.prefix_cache.n_resident
                    if eng.prefix_cache is not None else 0)
        clean = clean and bool(
            not eng.has_work
            and eng.allocator.n_free + resident
            == eng.engine_cfg.num_pages - 1)
    return clean


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


# the JAX sweeps' options that the port does not take yet, by ROADMAP item
_ITEMS = {
    **dict.fromkeys(("cluster_replicas", "killer", "selfheal", "tier_split",
                     "handoff_plan", "fleet_telemetry", "store_fabric"),
                    "Queue 1 item 11, fleet"),
    **dict.fromkeys(("run_timeout_s", "incidents", "tracer",
                     "rca_overrides"),
                    "Queue 1 item 5, the port's bench"),
}
_CLUSTER_BACKENDS = ("cluster", "cluster-oracle", "proc-cluster",
                     "net-cluster", "disagg-cluster")


def _refuse_unported(fn: str, unported: Dict[str, Any]) -> None:
    for name in unported:
        if name not in _ITEMS:
            raise TypeError(f"{fn}() got an unexpected keyword argument "
                            f"{name!r}")
        raise NotImplementedError(
            f"{fn}({name}=...) is not ported yet (ROADMAP {_ITEMS[name]})")


def _build_service(backend: str, clock, model_cfg, params, device,
                   engine_overrides, run_timeout_s: float = 1.5,
                   journal=None):
    """(service, engines, backend factory) of an ``engine`` or ``oracle``
    backend."""
    if backend == "engine":
        service, engine, factory = _build_engine_service(
            clock, model_cfg, params, device, engine_overrides,
            run_timeout_s, journal)
        return service, [engine], factory
    if backend == "oracle":
        service, _, factory = _build_oracle_service(clock, run_timeout_s,
                                                    journal)
        return service, [], factory
    if backend in _CLUSTER_BACKENDS:
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet (ROADMAP "
            f"{_ITEMS['cluster_replicas']})")
    raise ValueError(f"unknown backend {backend!r}")


def _open_journal(durable_dir: Optional[str]):
    """The run journal ``serve.wal`` under ``durable_dir`` (None without
    one)."""
    if durable_dir is None:
        return None
    from k8s_llm_rca_tpu_torch.serve.journal import RunJournal

    os.makedirs(durable_dir, exist_ok=True)
    return RunJournal(os.path.join(durable_dir, "serve.wal"))


def _close_journal(service) -> None:
    """Close the service's CURRENT journal (a supervised crash may have
    swapped in one reopened on the same path)."""
    journal = getattr(service, "_journal", None)
    if journal is not None:
        journal.close()


def run_chaos_soak(seed: int = 0, n_incidents: int = 3,
                   backend: str = "engine",
                   plan_spec: Optional[Dict[str, Any]] = None,
                   concurrency: int = 1, model_cfg=None, params=None,
                   device=None, engine_overrides=None,
                   durable_dir: Optional[str] = None,
                   supervisor: Optional[Any] = None,
                   **unported) -> Dict[str, Any]:
    """Drive ``n_incidents`` of the fixture corpus through the resilient
    pipeline under an armed FaultPlan (``plan_spec``, default
    ``default_plan_spec()``, sampled from ``seed``); returns the
    deterministic report (``report_bytes`` is the parity surface).
    ``backend``: "engine" (the paged TINY engine of
    ``_build_engine_service`` over ``model_cfg``, ``params``, ``device`` and
    ``engine_overrides``: tick faults and stalls bite) or "oracle" (the
    scripted backend: graph and backend faults).  ``concurrency`` > 1 runs
    the pipelined scheduler and needs a plan with no scheduled fault, as in
    the JAX soak.  ``durable_dir``: a directory for the run journal
    (``serve.wal``); the report is the same with or without it.
    ``supervisor``: a ``faults/supervisor.py::CrashSupervisor`` (requires
    ``durable_dir``) polled once at every incident boundary; on its
    scheduled "crash" the serving stack dies and is recovered from the
    journal, and the report is still the same.  The JAX soak's killers,
    self-heal, store fabric, tracer and cluster backends raise
    ``NotImplementedError`` naming their ROADMAP item."""
    from k8s_llm_rca_tpu_torch.config import RCAConfig
    from k8s_llm_rca_tpu_torch.graph import InMemoryGraphExecutor
    from k8s_llm_rca_tpu_torch.graph.fixtures import (
        INCIDENTS, build_metagraph, build_stategraph,
    )
    from k8s_llm_rca_tpu_torch.rca import RCAPipeline
    from k8s_llm_rca_tpu_torch.rca.scheduler import (
        IncidentFailure, SweepScheduler,
    )

    _refuse_unported("run_chaos_soak", unported)
    clock = VirtualClock()
    plan = FaultPlan.from_spec(seed, plan_spec or default_plan_spec(),
                               clock=clock)
    if concurrency < 1:
        raise ValueError(f"concurrency must be >= 1, got {concurrency}")
    if concurrency > 1 and plan.has_faults:
        raise ValueError(
            "chaos soak with concurrency > 1 is not supported: "
            "scheduled faults are attributed to incidents by poll "
            "order, which is interleaving-dependent — the report "
            "could never match the sequential run.  Run chaos at "
            "concurrency=1, or pass an empty plan_spec (plan-free "
            "pipelined sweeps: run_pipelined_sweep)")
    if concurrency > 1 and supervisor is not None:
        raise ValueError(
            "the crash supervisor polls once per incident BOUNDARY; a "
            "pipelined sweep has no global incident order, so "
            "concurrency > 1 requires supervisor=None")
    if supervisor is not None and durable_dir is None:
        raise ValueError("supervisor requires durable_dir: the run "
                         "journal is the only recovery source a crash "
                         "leaves behind")
    policy = _resilience_policy(seed, clock)
    run_timeout_s = 1.5
    journal = _open_journal(durable_dir)
    service, engines, factory = _build_service(
        backend, clock, model_cfg, params, device, engine_overrides,
        run_timeout_s, journal)
    meta = ResilientExecutor(InMemoryGraphExecutor(build_metagraph()),
                             policy, dep="graph.meta")
    state = ResilientExecutor(InMemoryGraphExecutor(build_stategraph()),
                              policy, dep="graph.state")
    # build (and seed) the pipelines BEFORE arming: the vocabulary
    # bootstrap queries are setup, not chaos surface
    cfg = RCAConfig(locator_max_new_tokens=192, cypher_max_new_tokens=96,
                    analyzer_max_new_tokens=96, fresh_threads=True)
    pipeline = RCAPipeline(service, meta, state, cfg, resilience=policy)
    pipelines = [pipeline] + [
        RCAPipeline(service, meta, state, cfg,
                    resilience=_slot_policy(policy))
        for _ in range(concurrency - 1)]

    incidents: List[Dict[str, Any]] = []
    n_resolved = n_degraded = n_failed = 0
    messages = [INCIDENTS[i % len(INCIDENTS)].message
                for i in range(n_incidents)]
    with inject.armed(plan):
        if concurrency > 1:
            results = SweepScheduler(pipelines).run(messages)
        else:
            results = []
            for message in messages:
                try:
                    results.append(pipeline.analyze_incident(message))
                except Exception as e:  # noqa: BLE001 — must never happen:
                    # the ladder's bottom rungs are infallible; a row here
                    # is a soak FAILURE the tests assert against
                    results.append(IncidentFailure(
                        message, f"{type(e).__name__}: {e}"))
                if supervisor is not None:
                    # the incident boundary, one poll per incident on
                    # either outcome: the supervisor's own plan decides
                    # whether the "process" dies here; the recovered
                    # service replaces ours (the pipeline rebound inside)
                    service = supervisor.checkpoint(
                        pipeline, service, factory, run_timeout_s, clock)
    _close_journal(service)
    for message, result in zip(messages, results):
        if isinstance(result, IncidentFailure):
            incidents.append({"error_message": message, "status": "failed",
                              "error": result.error})
            n_failed += 1
            continue
        row = _incident_row(message, result)
        if row["status"] == "degraded":
            n_degraded += 1
        else:
            n_resolved += 1
        incidents.append(row)

    report = {
        "seed": seed,
        "backend": backend,
        "n_incidents": n_incidents,
        "completed": n_resolved + n_degraded,
        "resolved": n_resolved,
        "degraded": n_degraded,
        "failed": n_failed,
        "retries": policy.counters["retries"],
        "policy": policy.snapshot(),
        "faults": plan.snapshot(),
        "virtual_elapsed_s": round(clock.time(), 6),
        "incidents": incidents,
    }
    if engines:
        # the chaos run must leave every engine clean
        report["engine_clean"] = _engine_clean(engines)
    return report


def run_pipelined_sweep(n_incidents: int = 10, backend: str = "engine",
                        concurrency: int = 4, model_cfg=None, params=None,
                        device=None, engine_overrides=None, seed: int = 0,
                        resilience: bool = False,
                        durable_dir: Optional[str] = None,
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
    overrides) or "oracle" (the scripted backend, no model).
    ``resilience``: the graph executors behind ``ResilientExecutor`` and
    every slot's pipeline on the degradation ladder (the chaos soak's
    policy constants, retry jitter seeded by ``seed``); the summed ladder
    counters go to ``stats["policy"]``.  ``durable_dir``: a directory for
    the run journal (``serve.wal``; the report does not change), closed
    when the sweep ends.  A FaultPlan armed by the caller
    applies (at concurrency 1 when it schedules faults).  Any other option
    of the JAX sweep raises ``NotImplementedError`` naming its ROADMAP
    item.  Returns ``{"report", "stats", "service", "engines"}``."""
    from k8s_llm_rca_tpu_torch.config import RCAConfig
    from k8s_llm_rca_tpu_torch.graph import InMemoryGraphExecutor
    from k8s_llm_rca_tpu_torch.graph.fixtures import (
        INCIDENTS, build_metagraph, build_stategraph,
    )
    from k8s_llm_rca_tpu_torch.rca import RCAPipeline
    from k8s_llm_rca_tpu_torch.rca.scheduler import (
        IncidentFailure, SweepScheduler,
    )

    _refuse_unported("run_pipelined_sweep", unported)
    if concurrency < 1:
        raise ValueError(f"concurrency must be >= 1, got {concurrency}")

    clock = VirtualClock()
    service, engines, _ = _build_service(
        backend, clock, model_cfg, params, device, engine_overrides,
        journal=_open_journal(durable_dir))

    meta: Any = InMemoryGraphExecutor(build_metagraph())
    state: Any = InMemoryGraphExecutor(build_stategraph())
    policy = None
    slot_policies: List[Optional[ResiliencePolicy]] = [None] * concurrency
    if resilience:
        policy = _resilience_policy(seed, clock)
        meta = ResilientExecutor(meta, policy, dep="graph.meta")
        state = ResilientExecutor(state, policy, dep="graph.state")
        slot_policies = [policy] + [_slot_policy(policy)
                                    for _ in range(concurrency - 1)]
    # fresh stage threads: persistent ones would make prompts depend on
    # incident completion order
    cfg = RCAConfig(locator_max_new_tokens=192, cypher_max_new_tokens=96,
                    analyzer_max_new_tokens=96, fresh_threads=True)

    pipelines = [RCAPipeline(service, meta, state, cfg,
                             resilience=slot_policies[i])
                 for i in range(concurrency)]

    messages = [INCIDENTS[i % len(INCIDENTS)].message
                for i in range(n_incidents)]
    sched = SweepScheduler(pipelines)
    results = sched.run(messages)
    _close_journal(service)

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
        "seed": seed,
        "backend": backend,
        "n_incidents": len(messages),
        "completed": n_resolved + n_degraded,
        "resolved": n_resolved,
        "degraded": n_degraded,
        "failed": n_failed,
        "incidents": rows,
    }
    if engines:
        # as the chaos soak: every engine drained, its allocator intact
        report["engine_clean"] = _engine_clean(engines)

    stats: Dict[str, Any] = dict(sched.stats.snapshot())
    stats["concurrency"] = concurrency
    if policy is not None:
        # ladder counters accumulate per SLOT policy; the sums do not
        # depend on the interleaving
        snap = policy.snapshot()
        for p in slot_policies[1:]:
            for k, v in p.counters.items():
                snap["counters"][k] = snap["counters"].get(k, 0) + v
        stats["policy"] = snap
    return {"report": report, "stats": stats, "service": service,
            "engines": engines}
