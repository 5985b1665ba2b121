"""The engine behind the assistants service: the port of ``EngineBackend``
from ``k8s_llm_rca_tpu/serve/backend.py`` (free decode only).

Requests stream through the continuous-batching engine, so concurrent runs
share decode steps.  The fence opener of a run (``forced_prefix``) is
appended to its prompt and the closing fence is a stop string.  Grammar-
constrained decode is the next slice (ROADMAP Queue 1 item 1): a
``GenOptions.grammar`` raises.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Protocol, Tuple

from k8s_llm_rca_tpu_torch.obs import trace as obs_trace


class Priority:
    """Request priority classes (LOWER value = MORE urgent)."""

    CRITICAL = 0
    NORMAL = 1
    BATCH = 2


@dataclass(frozen=True)
class GenOptions:
    max_new_tokens: int = 256
    stop: Tuple[str, ...] = ()
    forced_prefix: str = ""     # emitted verbatim, prefilled as forced tokens
    suffix: str = ""            # appended verbatim after generation stops
    # grammar-constrained decode (engine/constrain.py in the JAX package);
    # not ported: anything but None raises at start()
    grammar: Optional[object] = None
    # routing metadata populated by AssistantService.create_run; the
    # engine backend ignores both
    assistant_name: str = ""
    session: str = ""
    # engine admission / preemption class and per-run deadline (seconds on
    # the engine clock; None = the service's run_timeout_s)
    priority: int = Priority.NORMAL
    deadline_s: Optional[float] = None


@dataclass
class BackendResult:
    text: str
    completion_tokens: int
    prompt_tokens: Optional[int] = None   # actual prefilled tokens if known
    error: Optional[str] = None
    # the engine reaped the sequence past its deadline
    expired: bool = False


class LMBackend(Protocol):
    def start(self, prompt: str, opts: GenOptions) -> int: ...
    def pump(self) -> Dict[int, BackendResult]: ...
    def busy(self, handle: int) -> bool: ...
    def cancel(self, handle: int) -> None: ...
    def count_tokens(self, text: str) -> int: ...


class EngineBackend:
    """Continuous-batching engine behind the assistants API.  Cancelling a
    live run retires its engine sequence at once, freeing its slot and
    pages."""

    def __init__(self, engine):
        self.engine = engine
        self.tokenizer = engine.tokenizer
        self._handles = itertools.count()
        self._seq_to_handle: Dict[int, int] = {}
        self._handle_seq: Dict[int, int] = {}
        self._opts: Dict[int, GenOptions] = {}
        self._live: Dict[int, bool] = {}

    def start(self, prompt: str, opts: GenOptions) -> int:
        if opts.grammar is not None:
            raise NotImplementedError(
                "grammar-constrained decode (GenOptions.grammar) is not "
                "ported yet (ROADMAP Queue 1 item 1, the RCA agent loop: "
                "engine/constrain.py)")
        handle = next(self._handles)
        ids = self.tokenizer.encode(prompt + opts.forced_prefix, add_bos=True)
        seq_id = self.engine.submit(
            ids, max_new_tokens=opts.max_new_tokens, stop_strings=opts.stop,
            priority=opts.priority, deadline_s=opts.deadline_s)
        self._seq_to_handle[seq_id] = handle
        self._handle_seq[handle] = seq_id
        self._opts[handle] = opts
        self._live[handle] = True
        return handle

    def pump(self) -> Dict[int, BackendResult]:
        results: Dict[int, BackendResult] = {}
        if not self.engine.has_work:
            if self._live:
                # pumped with live handles but nothing decodable
                self.engine._count("engine.idle_ticks")
                obs_trace.event("engine.idle_ticks", live=len(self._live))
            return results
        for res in self.engine.step():
            handle = self._seq_to_handle.pop(res.seq_id, None)
            if handle is None:
                continue
            self._handle_seq.pop(handle, None)
            opts = self._opts.pop(handle, GenOptions())
            if not self._live.pop(handle, False):    # cancelled: drop
                continue
            text = opts.forced_prefix + res.text + opts.suffix
            expired = res.finish_reason == "expired"
            results[handle] = BackendResult(
                text=text, completion_tokens=res.completion_tokens,
                prompt_tokens=res.prompt_tokens,
                error=("deadline exceeded (engine deadline reap)"
                       if expired else None),
                expired=expired)
        if results:
            obs_trace.event("backend.settled", n=len(results))
        return results

    def busy(self, handle: int) -> bool:
        return self._live.get(handle, False)

    def cancel(self, handle: int) -> None:
        if handle not in self._live:
            return
        self._live.pop(handle, None)
        self._opts.pop(handle, None)
        seq_id = self._handle_seq.pop(handle, None)
        if seq_id is not None:
            self._seq_to_handle.pop(seq_id, None)
            self.engine.cancel_seq(seq_id)

    def count_tokens(self, text: str) -> int:
        return self.tokenizer.count(text)
