"""Deterministic time for sweeps: the ``VirtualClock`` of
``k8s_llm_rca_tpu/faults/plan.py``.  The fault schedules of that module
(``Fault``, ``FaultPlan``) are not ported yet (ROADMAP Queue 1 item 3)."""

from __future__ import annotations


class VirtualClock:
    """Deterministic time source: ``sleep`` advances time instead of
    blocking.  Duck-compatible with the ``time`` module for the methods
    the engine, the service and the tracer use (``time``/``sleep``)."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def time(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self._t += max(0.0, float(seconds))
