"""Seeded, fully deterministic fault schedules (the chaos half of the
faults subsystem; the production half is faults/policy.py): the port of
``k8s_llm_rca_tpu/faults/plan.py``, pure Python, so the same ``(seed,
spec)`` gives the JAX package's schedule.

A ``FaultPlan`` maps named injection sites to invocation indices and fault
kinds.  Sites are plain strings counted independently: the i-th call that
polls a site fires the fault scheduled at index i (or nothing).  Because
the schedule is a pure function of ``(seed, spec)`` and the counters
advance one per poll, any chaos run over deterministic code is exactly
reproducible — same seed, same faults, same report bytes (the virtual CPU
mesh and greedy decode keep the rest deterministic).

The plan carries an injectable ``VirtualClock``: slow-call and host-stall
faults advance *virtual* time instead of sleeping, and the retry/backoff
policies (faults/policy.py) read the same clock, so timeout arithmetic in
a chaos run neither sleeps for real nor depends on the wall clock.

The reference has no failure injection of any kind — its only resilience
artifact is the JSONDecodeError retry loop (test_all.py:63-83), which is
exercised by hoping the remote model misbehaves.  Here misbehavior is a
scheduled, replayable input.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

# the vocabulary of injectable behaviors; sites implement the subset that
# makes sense for them (graph queries: error/timeout/slow/poison/empty;
# backend runs: error/budget/stall; engine ticks: oom/preempt/stall/crash;
# the serve process boundary: crash — a supervised kill/restart,
# faults/supervisor.py; the parent<->worker network link at SITE_NET:
# partition (both directions die), halfopen (one direction), delay,
# trickle (byte-at-a-time), duplicate (frame delivered twice), corrupt
# (bit-flipped frame), and heal (clear any sticky link fault) —
# faults/netem.py; the prefill->decode KV handoff at SITE_HANDOFF:
# drop (EXPORT frame lost), corrupt/delay (shared kinds), and
# stale-fence (ADOPT ack loses the fencing race) — cluster/disagg.py)
FAULT_KINDS = ("error", "timeout", "slow", "poison", "empty",
               "budget", "stall", "oom", "preempt", "crash",
               "partition", "halfopen", "delay", "trickle",
               "duplicate", "corrupt", "heal", "drop", "stale-fence")


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: fire ``kind`` at the ``index``-th poll of
    ``site``.  ``delay_s`` is virtual-clock time for slow/stall kinds;
    ``wave`` is the preemption-wave width for the engine "preempt" kind."""

    site: str
    index: int
    kind: str
    delay_s: float = 0.0
    wave: int = 1


class VirtualClock:
    """Deterministic time source: ``sleep`` advances time instead of
    blocking.  Duck-compatible with the ``time`` module for the two
    methods the policies use (``time``/``sleep``), so production code
    takes the real module and chaos runs take this."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def time(self) -> float:
        return self._t

    def perf_counter(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self._t += max(0.0, float(seconds))

    advance = sleep


class FaultPlan:
    """Site -> invocation-index -> Fault schedule, with per-site poll
    counters and a fired-fault log (``snapshot`` summarizes a run)."""

    def __init__(self, faults: Sequence[Fault] = (),
                 seed: Optional[int] = None,
                 clock: Optional[VirtualClock] = None):
        self.seed = seed
        self.clock = clock if clock is not None else VirtualClock()
        self._by_site: Dict[str, Dict[int, Fault]] = {}
        for f in faults:
            if f.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {f.kind!r} "
                                 f"(one of {FAULT_KINDS})")
            self._by_site.setdefault(f.site, {})[f.index] = f
        self._counts: Dict[str, int] = {}
        self.fired: List[Fault] = []
        self._cleanups: List[Callable[[], None]] = []

    @property
    def has_faults(self) -> bool:
        """True when any fault is actually scheduled.  An empty plan is
        interleaving-safe (poll counters are per-site sums, and nothing
        fires), so the pipelined sweep scheduler only excludes armed
        plans for which this is True."""
        return bool(self._by_site)

    # ------------------------------------------------------------- build

    @classmethod
    def from_spec(cls, seed: int, spec: Dict[str, Dict[str, Any]],
                  clock: Optional[VirtualClock] = None) -> "FaultPlan":
        """Deterministic plan from ``(seed, spec)``.

        ``spec`` maps site -> rule; a rule combines:
        - ``indices``: {invocation index: kind} — explicit schedule;
        - ``rate`` + ``horizon`` + ``kinds``: each of the first ``horizon``
          invocations faults with probability ``rate``, kind drawn from
          ``kinds`` — sampled ONCE here from ``random.Random(seed)``, so
          the run itself contains no randomness;
        - ``delay_s`` / ``wave``: parameters applied to every fault of the
          rule.

        Sites are iterated sorted, so the same (seed, spec) dict produces
        the identical plan regardless of insertion order.
        """
        rng = random.Random(seed)
        faults: List[Fault] = []
        for site in sorted(spec):
            rule = spec[site]
            delay = float(rule.get("delay_s", 0.0))
            wave = int(rule.get("wave", 1))
            for idx in sorted(rule.get("indices", {})):
                faults.append(Fault(site, int(idx),
                                    rule["indices"][idx], delay, wave))
            rate = float(rule.get("rate", 0.0))
            if rate > 0.0:
                kinds = tuple(rule.get("kinds", ("error",)))
                for i in range(int(rule.get("horizon", 64))):
                    if rng.random() < rate:
                        faults.append(Fault(
                            site, i, kinds[rng.randrange(len(kinds))],
                            delay, wave))
        return cls(faults, seed=seed, clock=clock)

    # -------------------------------------------------------------- poll

    def poll(self, site: str) -> Optional[Fault]:
        """Count one invocation of ``site``; return its scheduled fault
        (logging it as fired) or None."""
        i = self._counts.get(site, 0)
        self._counts[site] = i + 1
        fault = self._by_site.get(site, {}).get(i)
        if fault is not None:
            self.fired.append(fault)
        return fault

    def reset(self) -> None:
        """Rewind every site counter and the fired log (re-arm the same
        schedule for a fresh run)."""
        self._counts.clear()
        self.fired.clear()

    # ---------------------------------------------------------- cleanups

    def add_cleanup(self, fn: Callable[[], None]) -> None:
        """Register state to undo at disarm time (e.g. the paged engine's
        stolen "oom" pages) — ``inject.disarm`` runs these."""
        self._cleanups.append(fn)

    def run_cleanups(self) -> None:
        while self._cleanups:
            self._cleanups.pop()()

    # ------------------------------------------------------------ report

    def snapshot(self) -> Dict[str, Any]:
        """Deterministic run summary for chaos reports."""
        return {
            "seed": self.seed,
            "polls": {s: self._counts[s] for s in sorted(self._counts)},
            "fired": [[f.site, f.index, f.kind] for f in self.fired],
        }
