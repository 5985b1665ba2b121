"""Injection points: arming a FaultPlan and applying faults at call sites
(the port of ``k8s_llm_rca_tpu/faults/inject.py``).

Threading model — zero overhead when disarmed: hot call sites (the engine
tick loops, graph ``run_query``, ``EngineBackend.start``) guard with a
single ``inject._ARMED is not None`` check and only then poll the plan.
``_ARMED`` is a module-level slot, so the disarmed cost is one global
load + identity test per call — nothing allocates, nothing is looked up
in a dict: inert sites must not perturb greedy parity, and the engine hot
path gains no per-tick Python work beyond the ``is None`` check.

Sites in the real stack:

- ``SITE_GRAPH`` (``graph/executor.py``): Neo4j/in-memory query failure,
  timeout, slow call, empty rows, poisoned payload;
- ``SITE_BACKEND`` (``serve/backend.py::EngineBackend.start``): engine
  run failure, BudgetError, stalled run (result withheld until the serve
  deadline expires it);
- ``SITE_ENGINE_TICK`` (``engine/engine.py`` / ``engine/paged.py``
  ``step``): host stall (virtual clock), allocator exhaustion ("oom":
  the free list is stolen for one tick), forced preemption wave, and
  "crash" (every active sequence loses its device KV between ticks and
  is requeued for re-prefill — the in-engine half of a worker kill);
- ``SITE_PROCESS``, ``SITE_REPLICA``, ``SITE_PROC``, ``SITE_NET``,
  ``SITE_HANDOFF``, ``SITE_STORE``: the JAX package's supervisor, cluster
  and store-fabric sites, each polled from its own plan there; the modules
  that poll them are not ported (ROADMAP Queue 1 items 4 and 11), the
  names are kept so plans and reports read alike.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional

from k8s_llm_rca_tpu_torch.faults.plan import Fault, FaultPlan

SITE_GRAPH = "graph.query"
SITE_BACKEND = "backend.start"
SITE_ENGINE_TICK = "engine.tick"
SITE_PROCESS = "serve.process"
SITE_REPLICA = "cluster.replica"
SITE_PROC = "cluster.proc"
SITE_NET = "cluster.net"
SITE_HANDOFF = "cluster.handoff"
SITE_STORE = "cluster.store"

# the armed plan; hot paths read this directly (see module docstring)
_ARMED: Optional[FaultPlan] = None


class InjectedFault(RuntimeError):
    """A scheduled transient dependency failure (retryable)."""


class InjectedTimeout(InjectedFault, TimeoutError):
    """A scheduled dependency timeout (retryable)."""


class PoisonedRecord:
    """Deterministic stand-in for a corrupted wire row: every field access
    raises, forcing the consumer's error path (the pipeline's retry /
    fallback ladder) instead of silently propagating garbage."""

    def __getitem__(self, key):
        raise KeyError(f"poisoned payload: field {key!r} unreadable")

    def get(self, key, default=None):
        raise KeyError(f"poisoned payload: field {key!r} unreadable")

    def __repr__(self) -> str:  # deterministic in reports
        return "PoisonedRecord()"


def arm(plan: FaultPlan) -> FaultPlan:
    global _ARMED
    if _ARMED is not None:
        raise RuntimeError("a FaultPlan is already armed")
    _ARMED = plan
    return plan


def disarm() -> None:
    global _ARMED
    plan, _ARMED = _ARMED, None
    if plan is not None:
        plan.run_cleanups()


def active() -> Optional[FaultPlan]:
    return _ARMED


@contextlib.contextmanager
def armed(plan: FaultPlan):
    """``with inject.armed(plan): ...`` — arms for the block, disarms and
    runs plan cleanups on exit (even on error)."""
    arm(plan)
    try:
        yield plan
    finally:
        disarm()


@contextlib.contextmanager
def readmission():
    """Suppress injection polls for a re-admission of an ALREADY-admitted
    run (cluster failover / drain re-starts an orphan's ``(prompt, opts)``
    on a survivor).  A logical run draws its admission fault exactly once,
    at its first ``start``: re-polling on failover would let the re-run
    draw a DIFFERENT fault than the original admission (breaking the
    byte-identical-failover contract whenever SITE_BACKEND is armed) and
    would shift every later draw's poll index in the plan snapshot, so
    kill-and-heal reports could never match the unkilled run."""
    global _ARMED
    plan, _ARMED = _ARMED, None
    try:
        yield
    finally:
        _ARMED = plan


def apply_query_fault(fault: Fault, plan: FaultPlan,
                      run: Callable[[], List[Any]]) -> List[Any]:
    """Apply a graph-query fault: raise, degrade, or distort the rows the
    real ``run()`` would return.  One implementation for every executor so
    the fault semantics cannot drift between backends."""
    if fault.kind == "error":
        raise InjectedFault(
            f"injected graph failure at {fault.site}[{fault.index}]")
    if fault.kind == "timeout":
        raise InjectedTimeout(
            f"injected graph timeout at {fault.site}[{fault.index}]")
    if fault.kind == "empty":
        return []
    if fault.kind == "slow":
        plan.clock.sleep(fault.delay_s or 0.05)
        return run()
    if fault.kind == "poison":
        rows = run()
        # corrupt, don't hide: same cardinality, unreadable payloads
        return [PoisonedRecord() for _ in rows] or [PoisonedRecord()]
    raise InjectedFault(
        f"injected fault kind {fault.kind!r} at {fault.site}[{fault.index}]")
