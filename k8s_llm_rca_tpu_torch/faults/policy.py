"""Production-side resilience: retry, circuit breaking, degradation (the
port of ``k8s_llm_rca_tpu/faults/policy.py``, on the port's tracer).

The reference's only failure policy is retry-with-feedback around LLM
parses (test_all.py:63-83,99-131); dependency failures (Neo4j down, run
stuck) simply crash or hang a sweep.  This module adds the explicit
policies the chaos harness (faults/plan.py, faults/inject.py) exists to
exercise:

- ``RetryPolicy`` — capped exponential backoff with SEEDED jitter and a
  deadline-aware retry budget, on an injectable clock (so chaos runs
  neither sleep for real nor depend on the wall clock);
- ``CircuitBreaker`` — per-dependency closed/open/half-open breaker, so a
  persistently failing dependency stops eating each incident's retry
  budget and the sweep degrades instead of stalling;
- ``ResilientExecutor`` — a GraphQueryExecutor decorator wiring both
  around ``run_query`` with degrade-to-empty-rows as the last resort;
- ``ResiliencePolicy`` — the pipeline-facing bundle: shared retry/breaker
  state, degradation ledger, and the graceful-degradation ladder
  ``rca/pipeline.py`` walks per stage (full engine run -> reduced token
  budget -> scripted-oracle fallback -> annotated partial report).
"""

from __future__ import annotations

import random
import time as _time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from k8s_llm_rca_tpu_torch.obs import trace as obs_trace
from k8s_llm_rca_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class RetriesExhausted(RuntimeError):
    """The retry budget (attempts or deadline) ran out."""


class CircuitOpen(RuntimeError):
    """The dependency's breaker is open; the call was not attempted."""


@dataclass
class RetryPolicy:
    """Capped exponential backoff with seeded jitter and a deadline-aware
    total budget.  ``clock`` must expose ``time()``/``sleep()`` — the real
    ``time`` module in production, ``plan.VirtualClock`` under chaos."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.5            # delay *= 1 + jitter * U[0, 1)
    deadline_s: Optional[float] = None   # total budget incl. backoff waits
    seed: int = 0
    clock: Any = _time

    def delays(self):
        """The deterministic backoff sequence for one call: capped
        exponential, then seeded jitter (one RNG per call, so two calls
        with the same policy see identical delays)."""
        rng = random.Random(self.seed)
        for attempt in range(self.max_attempts - 1):
            delay = min(self.max_delay_s, self.base_delay_s * (2 ** attempt))
            yield delay * (1.0 + self.jitter * rng.random())

    def call(self, fn: Callable[[], Any],
             retry_on: Tuple[type, ...] = (Exception,),
             breaker: Optional["CircuitBreaker"] = None,
             on_retry: Optional[Callable[[BaseException], None]] = None):
        """Run ``fn`` with retries.  A breaker, when given, gates every
        attempt and records its outcome; an open breaker raises
        ``CircuitOpen`` without consuming the retry budget."""
        start = self.clock.time()
        backoffs = self.delays()
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            if breaker is not None and not breaker.allow():
                raise CircuitOpen(f"circuit {breaker.name!r} is open") \
                    from last
            try:
                out = fn()
            except retry_on as e:
                if breaker is not None:
                    breaker.record_failure()
                last = e
                delay = next(backoffs, None)
                if delay is None:
                    break
                if (self.deadline_s is not None
                        and self.clock.time() + delay - start
                        > self.deadline_s):
                    # the budget cannot absorb the wait: fail now rather
                    # than blow the caller's deadline sleeping
                    break
                if on_retry is not None:
                    on_retry(e)
                self.clock.sleep(delay)
                continue
            if breaker is not None:
                breaker.record_success()
            return out
        raise RetriesExhausted(
            f"retries exhausted after {self.max_attempts} attempts: "
            f"{last}") from last


class CircuitBreaker:
    """Per-dependency breaker: ``failure_threshold`` consecutive failures
    open it; after ``reset_timeout_s`` (on the policy clock) one probe call
    is allowed through (half-open) — success closes, failure re-opens."""

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0, clock: Any = _time):
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.clock = clock
        self.state = "closed"            # closed | open | half_open
        self.failures = 0
        self.opens = 0                   # lifetime open transitions
        self._opened_at = 0.0

    def allow(self) -> bool:
        if self.state == "open":
            if self.clock.time() - self._opened_at >= self.reset_timeout_s:
                self.state = "half_open"
                return True
            return False
        return True                      # closed or half_open (the probe)

    def record_success(self) -> None:
        self.failures = 0
        if self.state != "closed":
            # half_open probe succeeded (or an out-of-band success while
            # open): the dependency recovered — a flight-record event
            obs_trace.event("resilience.breaker_close", dep=self.name)
        self.state = "closed"

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half_open" or \
                self.failures >= self.failure_threshold:
            if self.state != "open":
                self.opens += 1
                log.warning("circuit %r opened after %d failures",
                            self.name, self.failures)
                obs_trace.event("resilience.breaker_open", dep=self.name,
                                failures=self.failures)
            self.state = "open"
            self._opened_at = self.clock.time()

    def snapshot(self) -> Dict[str, Any]:
        return {"state": self.state, "opens": self.opens,
                "failures": self.failures}


@dataclass(frozen=True)
class StageDegradation:
    """One rung-drop on the degradation ladder, kept in the incident's
    report so a degraded answer is always annotated as such."""

    stage: str
    rung: str           # the rung that finally served the stage
    error: str          # why the rung(s) above it failed

    def as_dict(self) -> Dict[str, str]:
        return {"stage": self.stage, "rung": self.rung, "error": self.error}


class ResiliencePolicy:
    """The pipeline-facing bundle: one RetryPolicy template, per-dependency
    breakers, counters, and the stage degradation ladder.

    ``ladder(stage, rungs)`` tries ``(name, fn)`` rungs in order; the first
    one that returns wins.  Serving from any rung below the first records
    a ``StageDegradation`` (the incident report's annotation).  If every
    rung fails the last error re-raises — by convention the bottom rung is
    infallible (scripted fallback / empty result), so a resilient incident
    always completes, merely degraded.
    """

    def __init__(self, retry: Optional[RetryPolicy] = None,
                 failure_threshold: int = 5, reset_timeout_s: float = 30.0,
                 reduced_tokens: int = 256):
        self.retry = retry if retry is not None else RetryPolicy()
        self.clock = self.retry.clock
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.reduced_tokens = reduced_tokens
        self.breakers: Dict[str, CircuitBreaker] = {}
        self.counters: Dict[str, int] = {"retries": 0, "degraded_stages": 0}
        self.degradations: List[StageDegradation] = []   # current incident

    # -------------------------------------------------------- dependencies

    def breaker(self, dep: str) -> CircuitBreaker:
        br = self.breakers.get(dep)
        if br is None:
            br = self.breakers[dep] = CircuitBreaker(
                dep, self.failure_threshold, self.reset_timeout_s,
                clock=self.clock)
        return br

    def call(self, dep: str, fn: Callable[[], Any]):
        """Retry + breaker around one dependency call."""
        return self.retry.call(fn, breaker=self.breaker(dep),
                               on_retry=self._count_retry)

    def _count_retry(self, _exc: BaseException) -> None:
        self.counters["retries"] += 1
        obs_trace.event("resilience.retry", error=type(_exc).__name__)

    # ------------------------------------------------------------- ladder

    def begin_incident(self) -> None:
        self.degradations = []

    def ladder(self, stage: str,
               rungs: Sequence[Tuple[str, Callable[[], Any]]]):
        last: Optional[BaseException] = None
        for i, (name, fn) in enumerate(rungs):
            try:
                out = fn()
            except Exception as e:      # noqa: BLE001 — each rung may fail
                log.warning("stage %s rung %s failed: %s", stage, name, e)
                last = e
                continue
            if i > 0:
                self.degradations.append(
                    StageDegradation(stage, name, str(last)))
                self.counters["degraded_stages"] += 1
                obs_trace.event("resilience.degraded", stage=stage,
                                rung=name)
            return out
        raise last if last is not None else RuntimeError(
            f"stage {stage}: empty ladder")

    # ------------------------------------------------------------- report

    def incident_snapshot(self) -> List[Dict[str, str]]:
        return [d.as_dict() for d in self.degradations]

    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": dict(self.counters),
            "breakers": {k: self.breakers[k].snapshot()
                         for k in sorted(self.breakers)},
        }


class ResilientExecutor:
    """GraphQueryExecutor decorator: retry + breaker around ``run_query``,
    degrading to empty rows (annotated in the policy counters) when the
    dependency stays down — the stage code's own zero-record fallbacks
    then carry the incident instead of an unhandled exception killing it.
    """

    def __init__(self, inner, policy: ResiliencePolicy,
                 dep: str = "graph", degrade_to_empty: bool = True):
        self.inner = inner
        self.policy = policy
        self.dep = dep
        self.degrade_to_empty = degrade_to_empty

    def run_query(self, query: str,
                  parameters: Optional[Dict[str, Any]] = None):
        try:
            return self.policy.call(
                self.dep, lambda: self.inner.run_query(query, parameters))
        except (RetriesExhausted, CircuitOpen) as e:
            if not self.degrade_to_empty:
                raise
            self.policy.counters[f"degraded_queries:{self.dep}"] = \
                self.policy.counters.get(f"degraded_queries:{self.dep}",
                                         0) + 1
            log.warning("dependency %s degraded to empty rows: %s",
                        self.dep, e)
            return []

    def close(self) -> None:
        self.inner.close()
