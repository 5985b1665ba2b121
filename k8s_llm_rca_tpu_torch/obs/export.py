"""Prometheus text exposition (the port of the Prometheus half of
``k8s_llm_rca_tpu/obs/export.py``): the text format (version 0.0.4) over
the global Metrics store plus optional live engine gauges.  Counters get a
``_total`` suffix, phase timers become summaries (p50 quantile + _sum +
_count), and HELP/TYPE headers are emitted exactly once per family with
HELP text escaped per the spec; for the same store and engine the text is
byte for byte the JAX package's.  ``AssistantService.prometheus_metrics``
surfaces it through the serve API.  The Chrome trace export needs the
tick timeline (``obs/timeline.py``) and comes with it (ROADMAP Queue 1
item 11)."""

from __future__ import annotations

from typing import Dict, List

_PREFIX = "k8s_llm_rca_"


def _sanitize(name: str) -> str:
    out = [c if (c.isalnum() or c in "_:") else "_" for c in name]
    if out and out[0].isdigit():
        out.insert(0, "_")
    return "".join(out)


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class _Family:
    """One metric family: HELP/TYPE emitted exactly once, then samples."""

    def __init__(self, name: str, kind: str, help_text: str):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.samples: List[str] = []

    def add(self, value: float, suffix: str = "",
            labels: str = "") -> None:
        self.samples.append(
            f"{self.name}{suffix}{labels} {_fmt(value)}")

    def render(self) -> str:
        return "\n".join(
            [f"# HELP {self.name} {_escape_help(self.help)}",
             f"# TYPE {self.name} {self.kind}"] + self.samples)


def prometheus_text(metrics=None, engine=None, router=None,
                    tracer=None, store=None) -> str:
    """Render the Metrics store (+ optional live engine gauges) as
    Prometheus text exposition.  Counters -> ``<name>_total`` counter
    families; phase timers -> summary families (p50 over the retained
    reservoir window, exact _sum/_count); engine (duck-typed, any object
    with the paged engine's attributes) -> scheduler/pool gauges (running
    and queued seqs, free and evictable pages, prefix-hit tokens, spill
    and tier counters, queue depth by priority).  The cluster families
    (``router``, ``store``, a tracer carrying worker counters shipped
    from a fleet) are not ported (ROADMAP Queue 1 item 11) and raise."""
    for name, given in (("router", router is not None),
                        ("store", store is not None),
                        ("tracer with remote counters",
                         bool(getattr(tracer, "remote", None)))):
        if given:
            raise NotImplementedError(
                f"prometheus_text({name}) renders the cluster families, "
                f"which are not ported yet (ROADMAP Queue 1 item 11, "
                f"fleet)")
    if metrics is None:
        from k8s_llm_rca_tpu_torch.utils.logging import METRICS as metrics

    families: Dict[str, _Family] = {}

    def family(name: str, kind: str, help_text: str) -> _Family:
        fam = families.get(name)
        if fam is None:
            fam = families[name] = _Family(name, kind, help_text)
        return fam

    with metrics._lock:
        counters = dict(metrics.counters)
        timings = {k: (v.total, v.count, v.window())
                   for k, v in metrics.timings.items()}

    for raw in sorted(counters):
        name = f"{_PREFIX}{_sanitize(raw)}_total"
        family(name, "counter", f"counter {raw!r}").add(counters[raw])
    for raw in sorted(timings):
        total, count, window = timings[raw]
        name = f"{_PREFIX}{_sanitize(raw)}_seconds"
        fam = family(name, "summary", f"phase timer {raw!r}")
        if window:
            ordered = sorted(window)
            fam.add(ordered[len(ordered) // 2], labels='{quantile="0.5"}')
        fam.add(total, suffix="_sum")
        fam.add(count, suffix="_count")

    if engine is not None:
        gauges = {
            "engine_running_seqs": len(getattr(engine, "_active", ())),
            "engine_queued_seqs": len(getattr(engine, "_pending", ())),
        }
        allocator = getattr(engine, "allocator", None)
        if allocator is not None:
            gauges["engine_free_pages"] = allocator.n_free
        prefix_cache = getattr(engine, "prefix_cache", None)
        if prefix_cache is not None:
            gauges["engine_evictable_pages"] = prefix_cache.n_evictable
        counts = getattr(engine, "_counts", None) or {}
        gauges["engine_prefix_hit_tokens"] = \
            counts.get("engine.prefix_hit_tokens", 0.0)
        gauges["engine_spilled_pages"] = \
            counts.get("engine.spilled_pages", 0.0)
        gauges["engine_restored_pages"] = \
            counts.get("engine.restored_pages", 0.0)
        gauges["engine_deadline_expirations"] = \
            counts.get("engine.deadline_expirations", 0.0)
        gauges["engine_prefix_hits_l0"] = \
            counts.get("engine.prefix_hits_l0", 0.0)
        gauges["engine_prefix_hits_l1"] = \
            counts.get("engine.prefix_hits_l1", 0.0)
        gauges["engine_prefix_hits_l2"] = \
            counts.get("engine.prefix_hits_l2", 0.0)
        gauges["engine_prefix_demotions"] = \
            counts.get("engine.prefix_demotions", 0.0)
        gauges["engine_prefix_promoted_pages"] = \
            counts.get("engine.prefix_promoted_pages", 0.0)
        gauges["engine_prefix_bytes_restored"] = \
            counts.get("engine.prefix_bytes_restored", 0.0)
        gauges["engine_idle_ticks"] = \
            counts.get("engine.idle_ticks", 0.0)
        # per-priority pending depth (guard: stub engines in tests queue
        # bare objects without a priority attribute)
        crit = norm = batch = 0
        for p in getattr(engine, "_pending", ()):
            pri = getattr(p, "priority", 1)
            if pri <= 0:
                crit += 1
            elif pri == 1:
                norm += 1
            else:
                batch += 1
        gauges["engine_queued_critical"] = crit
        gauges["engine_queued_normal"] = norm
        gauges["engine_queued_batch"] = batch
        for key in sorted(gauges):
            family(f"{_PREFIX}{key}", "gauge",
                   f"live engine gauge {key!r}").add(gauges[key])

    return "\n".join(families[n].render()
                     for n in sorted(families)) + "\n"
