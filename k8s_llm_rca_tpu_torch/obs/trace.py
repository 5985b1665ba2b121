"""Span tracer: the subset of the JAX package's ``obs/trace.py`` that the
serving path and the RCA pipeline emit into (``engine.tick`` spans,
``serve.run`` and ``rca.*`` explicit-time spans, ``graph.query`` spans,
instant events) and the flight digest of an incident.  Hot call sites
guard on the module slot ``_ACTIVE is not None``, so an inactive tracer
costs one identity test.  The JAX tracer's tick timeline is not ported
(ROADMAP Queue 1 item 11): a digest counts ticks as ``engine.tick``
spans."""

from __future__ import annotations

import contextlib
import itertools
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class SpanEvent:
    event_id: int
    parent_id: Optional[int]
    name: str
    ts: float
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Span:
    span_id: int
    parent_id: Optional[int]
    name: str
    cat: str
    t0: float
    t1: Optional[float] = None
    args: Dict[str, Any] = field(default_factory=dict)


class Tracer:
    """Span/event recorder with an injectable clock and a bounded store."""

    def __init__(self, clock: Any = None, max_spans: int = 100_000):
        self.clock = clock if clock is not None else _time
        self.max_spans = max_spans
        self.spans: List[Span] = []
        self.events: List[SpanEvent] = []
        self.dropped = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def now(self) -> float:
        return self.clock.time()

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _full(self) -> bool:
        if len(self.spans) + len(self.events) >= self.max_spans:
            self.dropped += 1
            return True
        return False

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "app", **args):
        stack = self._stack()
        with self._lock:
            sp = None
            if not self._full():
                parent = stack[-1].span_id if stack else None
                sp = Span(next(self._ids), parent, name, cat, self.now(),
                          args=dict(args))
                self.spans.append(sp)
        if sp is not None:
            stack.append(sp)
        try:
            yield sp
        finally:
            if sp is not None:
                if stack and stack[-1] is sp:
                    stack.pop()
                with self._lock:
                    sp.t1 = self.now()

    def add_span(self, name: str, t0: float, t1: float, cat: str = "app",
                 args: Optional[Dict[str, Any]] = None) -> Optional[Span]:
        """Record an already-elapsed span with explicit times (a serve
        run, whose start and settle are separate pump calls)."""
        stack = self._stack()
        with self._lock:
            if self._full():
                return None
            parent = stack[-1].span_id if stack else None
            sp = Span(next(self._ids), parent, name, cat, float(t0),
                      t1=float(t1), args=dict(args or {}))
            self.spans.append(sp)
            return sp

    def event(self, name: str, **args) -> None:
        stack = self._stack()
        with self._lock:
            if self._full():
                return
            parent = stack[-1].span_id if stack else None
            self.events.append(SpanEvent(next(self._ids), parent, name,
                                         self.now(), dict(args)))

    def mark(self) -> Tuple[int, int]:
        """Current (spans, events) position: pass to
        ``flight_summary(since=...)`` to digest just the work after it."""
        with self._lock:
            return (len(self.spans), len(self.events))

    def flight_summary(self, since: Optional[Tuple[int, int]] = None
                       ) -> Dict[str, Any]:
        """Compact digest: span/event/tick counts and the per-name span
        histogram, deterministic under a VirtualClock."""
        s0, e0 = since if since is not None else (0, 0)
        with self._lock:
            spans = self.spans[s0:]
            events = self.events[e0:]
            by_name: Dict[str, int] = {}
            for sp in spans:
                by_name[sp.name] = by_name.get(sp.name, 0) + 1
            ts = ([sp.t0 for sp in spans]
                  + [sp.t1 for sp in spans if sp.t1 is not None]
                  + [e.ts for e in events])
            duration = (max(ts) - min(ts)) if ts else 0.0
        return {
            "spans": len(spans),
            "events": len(events),
            "ticks": by_name.get("engine.tick", 0),
            "dropped": self.dropped,
            "duration_s": round(duration, 6),
            "by_name": {k: by_name[k] for k in sorted(by_name)},
        }


_ACTIVE: Optional[Tracer] = None

_NULL = contextlib.nullcontext()


def activate(tracer: Tracer) -> Tracer:
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a Tracer is already active")
    _ACTIVE = tracer
    return tracer


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[Tracer]:
    return _ACTIVE


@contextlib.contextmanager
def tracing(tracer: Tracer):
    """``with trace.tracing(tracer): ...`` activates for the block."""
    activate(tracer)
    try:
        yield tracer
    finally:
        deactivate()


def span(name: str, cat: str = "app", **args):
    """Span under the active tracer; a shared no-op context otherwise."""
    tr = _ACTIVE
    if tr is None:
        return _NULL
    return tr.span(name, cat, **args)


def event(name: str, **args) -> None:
    """Instant event under the active tracer; no-op otherwise."""
    tr = _ACTIVE
    if tr is not None:
        tr.event(name, **args)
