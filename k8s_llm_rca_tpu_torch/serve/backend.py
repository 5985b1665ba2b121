"""LM backends for the assistants service: the port of ``EngineBackend``
and ``EchoBackend`` from ``k8s_llm_rca_tpu/serve/backend.py``.

Requests stream through the continuous-batching engine, so concurrent runs
share decode steps.  The fence opener of a run (``forced_prefix``) is
appended to its prompt and the closing fence is a stop string.  A
``GenOptions.grammar`` ("json" or a schema dict) compiles through
``engine/constrain.py::make_grammar`` and constrains the body; a budget
below the grammar's minimal document raises ``BudgetError``.  An armed
FaultPlan is polled at every ``start`` (``faults/inject.py``
``SITE_BACKEND``).  The JAX backend's snapshot/adopt and export/adopt
handoff are not ported (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Protocol, Set, Tuple

from k8s_llm_rca_tpu_torch.engine.constrain import make_grammar
from k8s_llm_rca_tpu_torch.faults import inject
from k8s_llm_rca_tpu_torch.obs import trace as obs_trace
from k8s_llm_rca_tpu_torch.utils.tokenizer import Tokenizer


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
    # grammar-constrained decode of the BODY (engine/constrain.py): "json"
    # guarantees the generated text parses; a schema dict forces the exact
    # shape.  Composes with forced_prefix / suffix carrying the fences.
    grammar: Optional[object] = None
    # routing metadata populated by AssistantService.create_run; the
    # engine backend ignores both (the scripted oracle routes on the name)
    assistant_name: str = ""
    session: str = ""
    # engine admission / preemption class and per-run deadline (seconds on
    # the engine clock; None = the service's run_timeout_s)
    priority: int = Priority.NORMAL
    deadline_s: Optional[float] = None


class BudgetError(ValueError):
    """The effective token budget cannot hold the grammar's minimal
    document: no valid output exists, so retrying the same request is
    futile (callers fall back, not retry)."""


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
    pages.

    Fault injection: with a plan armed, every ``start`` polls
    ``SITE_BACKEND``: "error" fails the run at the next pump, "budget"
    raises ``BudgetError`` at submission, "stall" accepts the run and
    never progresses it (a hung engine), so only the serve deadline ends
    it."""

    def __init__(self, engine):
        self.engine = engine
        self.tokenizer = engine.tokenizer
        self._handles = itertools.count()
        self._seq_to_handle: Dict[int, int] = {}
        self._handle_seq: Dict[int, int] = {}
        self._opts: Dict[int, GenOptions] = {}
        self._live: Dict[int, bool] = {}
        self._failed: Dict[int, str] = {}    # injected run failures
        self._stalled: Set[int] = set()      # injected stalls (no result)

    def start(self, prompt: str, opts: GenOptions) -> int:
        fault = None
        if inject._ARMED is not None:
            fault = inject._ARMED.poll(inject.SITE_BACKEND)
        if fault is not None and fault.kind == "budget":
            raise BudgetError(
                f"injected budget fault at {fault.site}[{fault.index}]: "
                f"no valid output exists under this budget")
        if fault is not None and fault.kind == "error":
            # fails engine-side: BackendResult.error at the next pump
            handle = next(self._handles)
            self._failed[handle] = (
                f"injected engine-run failure at "
                f"{fault.site}[{fault.index}]")
            self._live[handle] = True
            return handle
        if fault is not None and fault.kind == "stall":
            # accepted, never progressed: nothing reaches the engine, so
            # the stall cannot change its ticks
            handle = next(self._handles)
            self._stalled.add(handle)
            self._live[handle] = True
            return handle
        handle = next(self._handles)
        ids = self.tokenizer.encode(prompt + opts.forced_prefix, add_bos=True)
        grammar = make_grammar(opts.grammar, self.tokenizer,
                               prefer_native=self.engine.engine_cfg.native)
        min_budget = getattr(grammar, "min_budget", None)
        if min_budget is not None:
            # the budget AFTER engine clamping: a long prompt shrinks
            # max_new below the request, and a sub-minimal budget could
            # only produce truncated, unparseable output
            _, effective = self.engine._clamp_prompt(ids,
                                                     opts.max_new_tokens)
            if effective < min_budget():
                raise BudgetError(
                    f"effective token budget {effective} (requested "
                    f"{opts.max_new_tokens}, clamped by prompt length "
                    f"{len(ids)} vs cache cap "
                    f"{self.engine.engine_cfg.max_seq_len}) cannot hold "
                    f"the schema's minimal document ({min_budget()} tokens "
                    f"worst case); no valid output exists under this "
                    f"budget")
        # a grammar owns termination (forced EOS when the value closes):
        # a stop string such as "```" is legal INSIDE a JSON string and
        # would cut the body mid-string
        stop = () if grammar is not None else opts.stop
        seq_id = self.engine.submit(
            ids, max_new_tokens=opts.max_new_tokens, stop_strings=stop,
            grammar=grammar, priority=opts.priority,
            deadline_s=opts.deadline_s)
        self._seq_to_handle[seq_id] = handle
        self._handle_seq[handle] = seq_id
        self._opts[handle] = opts
        self._live[handle] = True
        return handle

    def pump(self) -> Dict[int, BackendResult]:
        results: Dict[int, BackendResult] = {}
        for handle in list(self._failed):
            msg = self._failed.pop(handle)
            if self._live.pop(handle, False):
                results[handle] = BackendResult("", 0, error=msg)
        if self._stalled and inject._ARMED is not None:
            # a stalled run ends only at the serve deadline: advance the
            # plan's virtual clock, so it comes after a fixed number of
            # pumps
            inject._ARMED.clock.sleep(0.05)
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
        if handle not in self._live and handle not in self._failed:
            return
        self._failed.pop(handle, None)
        self._stalled.discard(handle)
        self._live.pop(handle, None)
        self._opts.pop(handle, None)
        seq_id = self._handle_seq.pop(handle, None)
        if seq_id is not None:
            self._seq_to_handle.pop(seq_id, None)
            self.engine.cancel_seq(seq_id)

    def count_tokens(self, text: str) -> int:
        return self.tokenizer.count(text)


class EchoBackend:
    """Deterministic test backend: replies with a prompt-derived string
    after ``delay_pumps`` pump calls (to exercise the run-state machine's
    in_progress window).  The JAX backend's fixed ``reply`` and ``fail``
    options raise: the journal and recovery tests that set them come with
    ROADMAP Queue 1 item 4."""

    def __init__(self, tokenizer: Tokenizer, delay_pumps: int = 0,
                 **unported):
        for name in unported:
            if name not in ("reply", "fail"):
                raise TypeError(f"EchoBackend() got an unexpected keyword "
                                f"argument {name!r}")
            raise NotImplementedError(
                f"EchoBackend({name}=...) is not ported yet (ROADMAP "
                f"Queue 1 item 4, serve/journal.py and serve/recover.py)")
        self.tokenizer = tokenizer
        self.delay_pumps = delay_pumps
        self._handles = itertools.count()
        self._inflight: Dict[int, Tuple[str, GenOptions, int]] = {}

    def start(self, prompt: str, opts: GenOptions) -> int:
        handle = next(self._handles)
        self._inflight[handle] = (prompt, opts, self.delay_pumps)
        return handle

    def pump(self) -> Dict[int, BackendResult]:
        results: Dict[int, BackendResult] = {}
        for handle in list(self._inflight):
            prompt, opts, remaining = self._inflight[handle]
            if remaining > 0:
                self._inflight[handle] = (prompt, opts, remaining - 1)
                continue
            del self._inflight[handle]
            text = opts.forced_prefix + f"echo: {prompt[-64:]}" + opts.suffix
            results[handle] = BackendResult(
                text=text, completion_tokens=self.tokenizer.count(text))
        return results

    def busy(self, handle: int) -> bool:
        return handle in self._inflight

    def cancel(self, handle: int) -> None:
        self._inflight.pop(handle, None)

    def count_tokens(self, text: str) -> int:
        return self.tokenizer.count(text)
