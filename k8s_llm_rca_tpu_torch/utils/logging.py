"""Logger factory and process-local counters (the parts of the JAX
package's ``utils/logging.py`` that the serving path uses)."""

from __future__ import annotations

import logging
import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict


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


@dataclass
class Metrics:
    """Process-local counters.  Mutations take a lock:
    ``counters[name] +=`` is a read-modify-write that loses increments
    under a thread switch."""

    counters: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def count(self, name: str) -> float:
        with self._lock:
            return self.counters.get(name, 0.0)


METRICS = Metrics()
