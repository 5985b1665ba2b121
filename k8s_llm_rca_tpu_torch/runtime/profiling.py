"""Phase timers and device memory statistics: the part of
``k8s_llm_rca_tpu/runtime/profiling.py`` that the engine and the sweep
drivers use.  ``annotate`` names one region in the torch profiler's
timeline, the ``METRICS`` timers and the obs span tracer at once, so a
region found slow in one shows up under the same name in the others.  The
timer is host time around the dispatch (or the graph replay); nothing
here synchronizes with the device.  Trace capture and the analytic MFU
model stay with ROADMAP Queue 1 item 10."""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional

import torch

from k8s_llm_rca_tpu_torch.obs import trace as obs_trace
from k8s_llm_rca_tpu_torch.utils.logging import METRICS


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Time the block into the ``name`` phase of ``METRICS`` and record it
    as a ``record_function`` range and an obs span of the same name."""
    with torch.profiler.record_function(name):
        with METRICS.timer(name):
            with obs_trace.span(name, cat="xprof"):
                yield


def _largest_live_block(device: torch.device) -> Optional[int]:
    sizes = [b["size"] for seg in torch.cuda.memory_snapshot()
             if seg.get("device") == device.index
             for b in seg.get("blocks", ())
             if b.get("state") == "active_allocated"]
    return max(sizes) if sizes else None


def device_memory_stats(device: Optional[Any] = None) -> Dict[str, float]:
    """Device memory in bytes under the JAX package's keys:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching allocator's
    allocated bytes, now and at peak), ``bytes_limit`` (the card's total
    memory) and ``largest_alloc_size`` (the largest block allocated now).
    ``device`` None means the card; on the CPU, which reports nothing,
    the result is ``{}``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stats = torch.cuda.memory_stats(dev)
    out = {"bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
           "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak",
                                                0)),
           "bytes_limit": float(torch.cuda.mem_get_info(dev)[1])}
    largest = _largest_live_block(dev)
    if largest is not None:
        out["largest_alloc_size"] = float(largest)
    return out
