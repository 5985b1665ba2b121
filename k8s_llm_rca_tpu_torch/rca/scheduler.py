"""Pipelined cross-incident sweep scheduler: K incidents in flight over
one shared engine pump loop.

The RCA sweep's occupancy gap (BENCH_r05: decode occupancy 0.99 inside a
run vs 0.41 across the 100-incident sweep) is a SCHEDULING gap, not a
kernel gap: every stage of the blocking pipeline parks in
``serve/api.py::wait_run`` while the continuous batcher idles between
that incident's stages.  The reference sweep has the same shape — one
incident at a time, one blocking OpenAI call at a time
(test_all.py:140-160 drives incidents strictly sequentially).

This module closes the gap without touching the stage logic: the
incident is already a resumable state machine
(``RCAPipeline.incident_steps`` yields each pending ``Run`` instead of
waiting), so a scheduler can hold K machines and multiplex their decode
time on ONE backend:

- **K slots**, each owning its own ``RCAPipeline`` (own assistant
  threads) over ONE shared ``AssistantService`` — the engine batches
  across incidents exactly as it batches across a single incident's
  concurrent audit fanout.
- **Deterministic cooperative loop**, single-threaded: incidents are
  admitted in input order, machines advance in slot order, and the
  shared backend is pumped exactly once whenever every in-flight machine
  is blocked on an unsettled run.  No threads, no races: the interleave
  is a pure function of (inputs, concurrency).
- **Parity by construction**: the machines run the SAME generator code
  the blocking driver (``serve.api.drive_steps``) runs, prompts depend
  only on per-incident thread history (``cfg.fresh_threads``), and
  greedy decode is batch-invariant — so the pipelined sweep's per-
  incident outputs are byte-identical to the sequential sweep's
  (asserted in tests/test_sweep_sched.py, and the acceptance bar of
  ISSUE 11).
- **Loud exclusions** (ValueError) for every composition whose outputs
  WOULD depend on scheduling: shared threads, disjoint services, reused
  pipelines, armed fault plans at concurrency > 1.

Token usage is attributed by run ids (``usage_by_runs=True`` →
``AssistantService.usage_for_runs``): the reference's wall-clock window
double-counts the moment incidents overlap in time, exact attribution
cannot (reference window semantics kept on the sequential default path,
common/openai_generic_assistant.py:117-135).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from k8s_llm_rca_tpu_torch.obs import trace as obs_trace
from k8s_llm_rca_tpu_torch.serve.api import AssistantService, Run, RunStatus
from k8s_llm_rca_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class IncidentFailure:
    """A per-incident exception captured by the scheduler — the sweep
    keeps going, mirroring ``run_chaos_soak``'s failed-incident rows."""
    error_message: str
    error: str  # "ExceptionType: message"


@dataclasses.dataclass
class SweepStats:
    """Scheduling telemetry for one ``SweepScheduler.run`` call.  Kept
    OUT of any parity-checked report: pump counts and inflight samples
    are deterministic per (inputs, concurrency) but differ across
    concurrencies by design."""
    pumps: int = 0
    resumes: int = 0
    errors: int = 0
    inflight_samples: List[int] = dataclasses.field(default_factory=list)

    def inflight_mean(self) -> Optional[float]:
        if not self.inflight_samples:
            return None
        return sum(self.inflight_samples) / len(self.inflight_samples)

    def snapshot(self) -> Dict[str, Any]:
        return {"pumps": self.pumps, "resumes": self.resumes,
                "errors": self.errors,
                "inflight_mean": self.inflight_mean(),
                "inflight_max": max(self.inflight_samples, default=0)}


@dataclasses.dataclass
class _Machine:
    """One in-flight incident: its step generator plus the run it is
    parked on (None = ready to advance)."""
    index: int              # position in the input list (= result slot)
    message: str
    gen: Any                # RCAPipeline.incident_steps generator
    started: bool = False
    waiting: Optional[Run] = None
    wait_t0: Optional[float] = None  # tracer clock at park time


class SweepScheduler:
    """Drive N incidents through K slot pipelines over one shared
    service.  ``run`` returns results in INPUT order; element i is the
    pipeline's incident result dict, or an ``IncidentFailure`` when the
    incident's machine raised (resilience exhausted, malformed plan
    after retries, ...)."""

    def __init__(self, pipelines: Sequence[Any],
                 usage_by_runs: bool = True):
        if not pipelines:
            raise ValueError("SweepScheduler needs at least one pipeline")
        if len(set(map(id, pipelines))) != len(pipelines):
            raise ValueError(
                "each sweep slot needs its OWN RCAPipeline: a pipeline "
                "reused across slots shares its assistant threads, so "
                "interleaved incidents would splice into each other's "
                "prompts — not supported")
        service = pipelines[0].service
        for p in pipelines:
            if p.service is not service:
                raise ValueError(
                    "all sweep pipelines must share ONE AssistantService: "
                    "the scheduler pumps a single backend, so a machine on "
                    "a disjoint service would park forever on a run nobody "
                    "pumps — not supported")
        if len(pipelines) > 1:
            for p in pipelines:
                if not p.cfg.fresh_threads:
                    raise ValueError(
                        "pipelined sweep with concurrency > 1 requires "
                        "fresh_threads=True: persistent stage threads make "
                        "every prompt depend on previously completed "
                        "incidents, so outputs would depend on completion "
                        "ORDER — not supported")
        self.pipelines = list(pipelines)
        self.service: AssistantService = service
        self.concurrency = len(pipelines)
        self.usage_by_runs = usage_by_runs
        self.stats = SweepStats()

    # ------------------------------------------------------------- loop

    def run(self, error_messages: Sequence[str],
            fault_plan: Optional[Any] = None) -> List[Any]:
        """``fault_plan``: the JAX scheduler refuses an armed FaultPlan at
        concurrency > 1; the port has no fault injection to arm, so any
        plan raises."""
        if fault_plan is not None:
            raise NotImplementedError(
                "a FaultPlan needs faults/inject.py, which is not ported yet "
                "(ROADMAP Queue 1 item 3, fault injection)")
        self.stats = st = SweepStats()
        results: List[Any] = [None] * len(error_messages)
        queue = deque(enumerate(error_messages))
        slots: List[Optional[_Machine]] = [None] * self.concurrency

        while True:
            progressed = False
            for si in range(self.concurrency):
                if slots[si] is None and queue:
                    idx, msg = queue.popleft()
                    gen = self.pipelines[si].incident_steps(
                        msg, usage_by_runs=self.usage_by_runs,
                        pipelined=True)
                    slots[si] = _Machine(index=idx, message=msg, gen=gen)
                m = slots[si]
                if m is None:
                    continue
                if (m.waiting is not None
                        and m.waiting.status not in RunStatus.TERMINAL):
                    continue  # still parked
                self._advance(m, si, slots, results, st)
                progressed = True
            if not queue and not any(s is not None for s in slots):
                break
            if not progressed:
                # every in-flight machine is parked on an unsettled run:
                # first reap runs the backend silently dropped (the
                # wait_run liveness check, externalized — without it a
                # dropped run under a frozen VirtualClock would pump
                # forever), then pump the shared backend one tick — one
                # tick decodes ALL parked runs at once
                reaped = False
                for s in slots:
                    if s is not None and s.waiting is not None:
                        r = self.service.reap_dropped_run(s.waiting.id)
                        reaped |= r.status in RunStatus.TERMINAL
                if not reaped:
                    self.service.pump_once()
                    st.pumps += 1
                    st.inflight_samples.append(
                        sum(1 for s in slots if s is not None))
        return results

    def _advance(self, m: _Machine, si: int,
                 slots: List[Optional[_Machine]], results: List[Any],
                 st: SweepStats) -> None:
        """Advance one machine until it parks on an unsettled run,
        returns, or raises.  Runs that settle instantly (oracle backend,
        prefix-cache hits) are consumed in the same visit."""
        while True:
            if m.waiting is not None:
                self._end_queue_wait(m)
                m.waiting = None
                st.resumes += 1
            try:
                if m.started:
                    run = m.gen.send(None)
                else:
                    m.started = True
                    run = next(m.gen)
            except StopIteration as stop:
                results[m.index] = stop.value
                slots[si] = None
                return
            except Exception as e:  # noqa: BLE001 — soak row discipline
                log.warning("incident %d failed in sweep: %s: %s",
                            m.index, type(e).__name__, e)
                results[m.index] = IncidentFailure(
                    m.message, f"{type(e).__name__}: {e}")
                st.errors += 1
                slots[si] = None
                return
            m.waiting = run
            tr = obs_trace._ACTIVE
            m.wait_t0 = tr.now() if tr is not None else None
            if run.status not in RunStatus.TERMINAL:
                return

    def _end_queue_wait(self, m: _Machine) -> None:
        """Record the park interval as an explicit-times
        ``rca.stage.queue_wait`` span (registered obs site): decode time
        plus time spent behind other incidents' stages on the shared
        pump.  ``add_span``, not ``span()``: machines interleave on one
        thread, so a context-manager span held across yields would
        corrupt the tracer's LIFO stack (same reasoning as
        ``RCAPipeline._stage_span``)."""
        tr = obs_trace._ACTIVE
        if tr is None or m.wait_t0 is None:
            return
        tr.add_span("rca.stage.queue_wait", m.wait_t0, tr.now(), cat="rca",
                    args={"incident": m.message[:60], "run": m.waiting.id,
                          "status": m.waiting.status})
