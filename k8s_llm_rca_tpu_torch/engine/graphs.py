"""CUDA graphs over the paged engine's decode shapes: the port's
counterpart of the JAX engine's jitted ``paged_decode_step``,
``paged_decode_scan``, ``paged_decode_scan_dfa``, ``paged_overlap_step``
and the speculative verify step (``paged_decode_multi``, with
``dfa_greedy_multi`` under a compiled grammar).

JAX compiles each decode step and scan into one XLA program that the
device runs without the host; eagerly, PyTorch issues every one of a
step's thousands of launches from Python.  ``DecodeGraphs`` records a
decode function once per bucket (the single step, a scan of each chunk
length, a DFA scan of each chunk length and padded table size) and
replays it after that, one host call per step or scan.  The engine's
keys: ("step",), ("scan", chunk), ("dfa", chunk, padded states),
("overlap",), ("multi", T, pages gathered) and ("multi-dfa", T, pages
gathered, padded states).

- The function captured reads only tensors that stay put: the engine's
  static operand buffers (tokens, lengths, block tables, DFA states and
  budgets, the verify step's [B, T] tokens, the padded DFA tables), the
  KV pool (written in place) and the params.  The overlapped step also
  writes its next tokens and lengths into those operand buffers, in
  place.  Its outputs live in the runner's shared memory pool, where
  any other graph of the runner may use the same bytes as scratch: they
  hold only until the next replay of any graph in the runner, so the
  engine reads them before it replays again.
- A bucket's first call runs the function once on a side stream (the
  warm-up: the kernels' first launches set their shared-memory
  attributes and fill their occupancy tables, which must not happen
  under capture), and that run's result is the call's result, as a jit's
  first call computes while it compiles.  Then it captures.
- All of a runner's graphs share one memory pool, released with the
  runner (the engine drops it with itself).
- The kernels' wrappers count a launch when Python calls them, so a
  replay counts nothing by itself: the runner takes back what the
  counters gained during capture, which launched nothing, and adds that
  gain again at every replay.
- No garbage is collected during a capture: the cyclic collector runs
  once before it and is off while it lasts.  A dead engine freed by the
  collector inside a capture invalidates the capture, and PyTorch no
  longer collects before a capture by itself.
- A capture or replay that fails raises, naming its bucket; nothing falls
  back to the eager step.
- Sampling at ``temperature > 0`` draws from the engine's generator,
  which each graph registers (``register_generator_state``), so the
  replays advance it.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch


def launch_counters() -> List[Tuple[object, str]]:
    """Every kernel wrapper's launch counter and every collective's call
    counter (``runtime/mesh.py``), as (function, attribute): a replay of
    a graph captured under a mesh repeats its collectives."""
    from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention
    from k8s_llm_rca_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_quant,
    )
    from k8s_llm_rca_tpu_torch.ops.quant_matmul import (
        quant_matmul, quant_matmul_experts, quant_matmul_head,
    )
    from k8s_llm_rca_tpu_torch.runtime.mesh import COLLECTIVES

    out = [(paged_attention, "launches"), (paged_attention_quant, "launches"),
           (flash_attention, "launches")]
    out += [(fn, "calls") for fn in COLLECTIVES]
    for fn in (quant_matmul, quant_matmul_head, quant_matmul_experts):
        out += [(fn, "launches"), (fn, "launches_int8")]
    return out


def _read(counters) -> List[int]:
    return [getattr(fn, attr) for fn, attr in counters]


class DecodeGraphs:
    """One engine's captured decode graphs, keyed by bucket.

    ``generator`` is registered with every graph (``None`` under greedy
    sampling, which draws nothing); ``count`` is the engine's counter
    (``engine.graph_captures``, ``engine.graph_replays``)."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator],
                 count: Callable[[str, float], None]):
        self.device = device
        self._gen = generator
        self._count = count
        self._pool = torch.cuda.graph_pool_handle()
        self._graphs: Dict[Hashable, tuple] = {}
        self.capture_s = 0.0       # warm-up and capture, all buckets

    @property
    def buckets(self) -> List[Hashable]:
        """The keys captured so far, in capture order."""
        return list(self._graphs)

    @property
    def pool_bytes(self) -> int:
        """Card memory the graphs' pool holds now (its segments)."""
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def run(self, key: Hashable, fn: Callable[[], object]):
        """``fn()``'s work for bucket ``key``: its graph's replay, or at the
        bucket's first call ``fn`` itself, run once, and the capture."""
        entry = self._graphs.get(key)
        if entry is None:
            return self._capture(key, fn)
        graph, outputs, gains = entry
        try:
            graph.replay()
        except RuntimeError as err:
            raise RuntimeError(f"CUDA graph replay of decode bucket {key} "
                               f"failed: {err}") from err
        for (wrapper, attr), gain in gains:
            setattr(wrapper, attr, getattr(wrapper, attr) + gain)
        self._count("engine.graph_replays", 1)
        return outputs

    def _capture(self, key: Hashable, fn: Callable[[], object]):
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            result = fn()                      # the warm-up is this call
        main.wait_stream(side)
        counters = launch_counters()
        before = _read(counters)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            if self._gen is not None:
                graph.register_generator_state(self._gen)
            with torch.cuda.graph(graph, pool=self._pool):
                outputs = fn()
        except Exception as err:
            raise RuntimeError(f"CUDA graph capture of decode bucket {key} "
                               f"failed: {err}") from err
        finally:
            if collecting:
                gc.enable()
            after = _read(counters)
            for (wrapper, attr), n in zip(counters, before):
                setattr(wrapper, attr, n)      # capture launched nothing
        gains = [(c, a - b) for c, a, b in zip(counters, after, before)
                 if a != b]
        self._graphs[key] = (graph, outputs, gains)
        self.capture_s += time.perf_counter() - t0
        self._count("engine.graph_captures", 1)
        return result
