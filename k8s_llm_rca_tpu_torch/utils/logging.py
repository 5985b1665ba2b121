"""Logger factory, process-local counters and phase timers (the parts of
the JAX package's ``utils/logging.py`` that the serving path, the RCA
pipeline, the sweep drivers and the Prometheus export use)."""

from __future__ import annotations

import contextlib
import logging
import statistics
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List


def get_logger(name: str = "k8s_llm_rca_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def _median(xs: List[float]) -> float:
    return float(statistics.median(xs)) if xs else 0.0


# retained samples per timer name: a newest-sample window, while total
# and count stay exact
TIMING_RESERVOIR = 512


class _Reservoir:
    """Exact ``total``/``count`` plus a ring of the newest samples."""

    __slots__ = ("total", "count", "_ring", "_cap", "_i")

    def __init__(self, capacity: int = TIMING_RESERVOIR):
        self.total = 0.0
        self.count = 0
        self._cap = capacity
        self._ring: List[float] = []
        self._i = 0

    def append(self, dt: float) -> None:
        self.total += dt
        self.count += 1
        if len(self._ring) < self._cap:
            self._ring.append(dt)
        else:
            self._ring[self._i] = dt
            self._i = (self._i + 1) % self._cap

    def window(self) -> List[float]:
        """Retained samples, oldest first."""
        return self._ring[self._i:] + self._ring[:self._i]


@dataclass
class Metrics:
    """Process-local counters and phase timers.  Mutations take a lock:
    ``counters[name] +=`` is a read-modify-write that loses increments
    under a thread switch."""

    counters: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    timings: Dict[str, _Reservoir] = field(
        default_factory=lambda: defaultdict(_Reservoir))
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    @contextlib.contextmanager
    def timer(self, name: str):
        """Time the block into the ``name`` phase (wall clock)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.timings[name].append(dt)

    def count(self, name: str) -> float:
        with self._lock:
            return self.counters.get(name, 0.0)

    def total(self, name: str) -> float:
        """Summed seconds of a timer phase over its whole life (0 if never
        timed)."""
        with self._lock:
            r = self.timings.get(name)
            return r.total if r is not None else 0.0

    def snapshot(self) -> Dict[str, float]:
        """Counters, and per timer ``.total_s``, ``.count`` and ``.p50_s``."""
        with self._lock:
            out = dict(self.counters)
            timings = {k: (v.total, v.count, v.window())
                       for k, v in self.timings.items()}
        for k, (total, count, window) in timings.items():
            out[f"{k}.total_s"] = total
            out[f"{k}.count"] = float(count)
            out[f"{k}.p50_s"] = _median(window)
        return out

    def reset(self) -> None:
        """Drop every counter and timer."""
        with self._lock:
            self.counters.clear()
            self.timings.clear()


METRICS = Metrics()
