"""Local assistants API (Assistant / Thread / Message / Run) on a local
backend: the port of ``k8s_llm_rca_tpu/serve/api.py``'s ``AssistantService``.

The run-state machine (``queued | in_progress | completed | cancelled |
failed | expired``), the prompt rendering, the usage accounting (windowed
and by run id), the newest-first listings, ``drive_steps`` and the
reference-compatible ``GenericAssistant`` client are the JAX package's, so
the same calls give the same replies and token usage.  With a
``serve/journal.py::RunJournal`` every mutation is appended (fsync'd)
before it is acknowledged, so ``serve/recover.py`` can rebuild the
service after a crash; without one each hook costs one ``is None`` test.
``prometheus_metrics`` is the scrape surface and ``save_service_state`` /
``load_service_state`` checkpoint the store.  The service is thread-safe:
one re-entrant lock serializes every public method and the backend pump.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from k8s_llm_rca_tpu_torch.obs import trace as obs_trace
from k8s_llm_rca_tpu_torch.serve.backend import GenOptions, LMBackend
from k8s_llm_rca_tpu_torch.serve.journal import encode_gen
from k8s_llm_rca_tpu_torch.utils.logging import METRICS, get_logger

log = get_logger(__name__)


class RunStatus:
    QUEUED = "queued"
    IN_PROGRESS = "in_progress"
    COMPLETED = "completed"
    CANCELLED = "cancelled"
    FAILED = "failed"
    EXPIRED = "expired"

    TERMINAL = (COMPLETED, CANCELLED, FAILED, EXPIRED)


# --- OpenAI-shaped message content (stage code reads .content[0].text.value)


@dataclass
class _Text:
    value: str


@dataclass
class _ContentPart:
    text: _Text
    type: str = "text"


@dataclass
class Message:
    id: str
    role: str
    raw_content: str
    created_at: float
    content: List[_ContentPart] = field(default_factory=list)

    def __post_init__(self):
        if not self.content:
            self.content = [_ContentPart(text=_Text(value=self.raw_content))]


@dataclass
class MessageList:
    data: List[Message]        # newest first, like the OpenAI listing


@dataclass
class Assistant:
    id: str
    name: str
    instructions: str
    model: str
    gen: GenOptions = field(default_factory=GenOptions)


@dataclass
class Thread:
    id: str
    messages: List[Message] = field(default_factory=list)  # oldest first


@dataclass
class Run:
    id: str
    thread_id: str
    assistant_id: str
    status: str = RunStatus.QUEUED
    created_at: Optional[int] = None
    completed_at: Optional[int] = None
    usage: Dict[str, int] = field(default_factory=lambda: {
        "prompt_tokens": 0, "completion_tokens": 0, "total_tokens": 0})
    error: Optional[str] = None
    instructions_override: Optional[str] = None
    backend_handle: Optional[int] = None
    deadline: Optional[float] = None
    response_message_id: Optional[str] = None
    # precise start time on the service clock, for the "serve.run" span
    t_started: Optional[float] = None


def render_prompt(assistant: Assistant, thread: Thread,
                  instructions_override: Optional[str] = None) -> str:
    """Chat-template rendering of instructions + the whole thread history."""
    instructions = instructions_override or assistant.instructions
    parts = [f"<|system|>\n{instructions}\n"]
    for m in thread.messages:
        parts.append(f"<|{m.role}|>\n{m.raw_content}\n")
    parts.append("<|assistant|>\n")
    return "".join(parts)


def _locked(fn):
    """Serialize a service method on the instance's re-entrant lock."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    return wrapper


class AssistantService:
    """The 'server': owns assistants/threads/runs and drives an LMBackend.
    ``clock``: injectable time source for run timestamps and deadlines."""

    def __init__(self, backend: LMBackend, run_timeout_s: float = 600.0,
                 clock=None, journal=None):
        # ``journal``: an optional serve.journal.RunJournal; each mutation
        # hook below is one ``is None`` test when it is absent
        self.backend = backend
        self.run_timeout_s = run_timeout_s
        self._clock = clock if clock is not None else time
        self.assistants: Dict[str, Assistant] = {}
        self.threads: Dict[str, Thread] = {}
        self.runs: Dict[str, Run] = {}
        self._thread_runs: Dict[str, List[str]] = {}
        self._inflight: Dict[int, str] = {}   # backend handle -> run id
        self._ids = itertools.count()
        self._lock = threading.RLock()
        self._waiters = 0       # concurrent wait_run count (handoff sleep)
        self._journal = journal

    @_locked
    def _next_id(self, prefix: str) -> str:
        return f"{prefix}_{next(self._ids):08d}"

    # ------------------------------------------------------------ lifecycle

    @_locked
    def create_assistant(self, instructions: str, name: str,
                         model: str = "local",
                         gen: Optional[GenOptions] = None) -> Assistant:
        a = Assistant(self._next_id("asst"), name, instructions, model,
                      gen or GenOptions())
        self.assistants[a.id] = a
        if self._journal is not None:
            self._journal.append("create_assistant", id=a.id, name=a.name,
                                 instructions=a.instructions, model=a.model,
                                 gen=encode_gen(a.gen))
        return a

    @_locked
    def retrieve_assistant(self, assistant_id: str) -> Assistant:
        return self.assistants[assistant_id]

    @_locked
    def create_thread(self) -> Thread:
        t = Thread(self._next_id("thread"))
        self.threads[t.id] = t
        self._thread_runs[t.id] = []
        if self._journal is not None:
            self._journal.append("create_thread", id=t.id)
        return t

    @_locked
    def retrieve_thread(self, thread_id: str) -> Thread:
        return self.threads[thread_id]

    @_locked
    def add_message(self, thread_id: str, content: str,
                    role: str = "user") -> Message:
        m = Message(self._next_id("msg"), role, content, time.time())
        self.threads[thread_id].messages.append(m)
        if self._journal is not None:
            self._journal.append("add_message", thread_id=thread_id,
                                 id=m.id, role=m.role, content=m.raw_content,
                                 created_at=m.created_at)
        return m

    @_locked
    def create_run(self, thread_id: str, assistant_id: str,
                   instructions: Optional[str] = None,
                   gen: Optional[GenOptions] = None) -> Run:
        assistant = self.assistants[assistant_id]
        run = Run(self._next_id("run"), thread_id, assistant_id,
                  created_at=int(self._clock.time()),
                  instructions_override=instructions)
        run.t_started = self._clock.time()
        self.runs[run.id] = run
        self._thread_runs[thread_id].append(run.id)

        prompt = render_prompt(assistant, self.threads[thread_id], instructions)
        # every run carries a concrete deadline into the engine: the
        # caller's GenOptions.deadline_s when set, else run_timeout_s
        base = gen or assistant.gen
        deadline_s = (base.deadline_s if base.deadline_s is not None
                      else self.run_timeout_s)
        run.deadline = self._clock.time() + min(self.run_timeout_s,
                                                deadline_s)
        opts = dataclasses.replace(base, assistant_name=assistant.name,
                                   session=thread_id, deadline_s=deadline_s)
        run.usage["prompt_tokens"] = self.backend.count_tokens(prompt)
        run.backend_handle = self.backend.start(prompt, opts)
        run.status = RunStatus.IN_PROGRESS
        self._inflight[run.backend_handle] = run.id
        if self._journal is not None:
            # after backend.start: a submission the backend refused
            # (BudgetError) never reaches the journal
            self._journal.append(
                "run_submit", id=run.id, thread_id=thread_id,
                assistant_id=assistant_id, created_at=run.created_at,
                instructions=instructions, gen=encode_gen(gen),
                prompt=prompt)
        METRICS.inc("serve.runs_started")
        obs_trace.event("serve.run_started", run=run.id,
                        assistant=assistant.name)
        return run

    @_locked
    def retrieve_run(self, run_id: str) -> Run:
        self._pump()
        return self.runs[run_id]

    @_locked
    def poll_run(self, run_id: str) -> Run:
        """Non-blocking probe: one pump, then the run, terminal or not."""
        self._pump()
        return self.runs[run_id]

    @_locked
    def pump_once(self) -> None:
        """Advance the backend one tick and settle any finished runs."""
        self._pump()

    @_locked
    def reap_dropped_run(self, run_id: str) -> Run:
        """Settle a non-terminal run whose backend no longer tracks its
        handle (``wait_run``'s liveness check, for non-blocking pollers
        such as the sweep scheduler); the handle leaves ``_inflight`` so a
        later deadline sweep cannot flip the FAILED run to EXPIRED."""
        run = self.runs[run_id]
        if (run.status not in RunStatus.TERMINAL
                and not self.backend.busy(run.backend_handle)):
            run.status = RunStatus.FAILED
            run.error = "backend dropped the run"
            self._inflight.pop(run.backend_handle, None)
            if self._journal is not None:
                self._journal_settle(run)
        return run

    @_locked
    def cancel_run(self, run_id: str) -> Run:
        run = self.runs[run_id]
        if run.status not in RunStatus.TERMINAL:
            self.backend.cancel(run.backend_handle)
            run.status = RunStatus.CANCELLED
            run.completed_at = int(self._clock.time())
            self._inflight.pop(run.backend_handle, None)
            if self._journal is not None:
                self._journal_settle(run)
            self._trace_run_settled(run)
        return run

    def _journal_settle(self, run: Run) -> None:
        """Append the run's terminal transition (only ever called behind
        ``self._journal is not None``)."""
        response = None
        if run.response_message_id is not None:
            for m in self.threads[run.thread_id].messages:
                if m.id == run.response_message_id:
                    response = {"id": m.id, "role": m.role,
                                "content": m.raw_content,
                                "created_at": m.created_at}
                    break
        self._journal.append(
            "run_settle", id=run.id, status=run.status,
            completed_at=run.completed_at, usage=dict(run.usage),
            error=run.error, response=response)

    def _trace_run_settled(self, run: Run) -> None:
        """Record the run's lifetime as one explicit-times 'serve.run'
        span.  No-op without an active tracer."""
        tr = obs_trace._ACTIVE
        if tr is None:
            return
        assistant = self.assistants.get(run.assistant_id)
        now = self._clock.time()
        t0 = run.t_started if run.t_started is not None else now
        tr.add_span("serve.run", t0, now, cat="serve",
                    args={"run": run.id, "status": run.status,
                          "assistant": assistant.name if assistant else "",
                          "completion_tokens":
                          run.usage["completion_tokens"]})

    @_locked
    def list_runs(self, thread_id: str, limit: int = 20,
                  order: str = "desc") -> List[Run]:
        ids = self._thread_runs.get(thread_id, [])
        runs = [self.runs[i] for i in ids]
        if order == "desc":
            runs = runs[::-1]
        return runs[:limit]

    @_locked
    def assistant_token_usage(self, assistant_id: str, tmin: int, tmax: int,
                              limit: int = 20) -> Dict[str, int]:
        """Windowed usage over all of an assistant's runs (any thread):
        the newest ``limit`` runs first, then the reference's window test
        (created_at and completed_at in [tmin, tmax))."""
        usage = {"prompt_tokens": 0, "completion_tokens": 0,
                 "total_tokens": 0}
        newest = sorted(
            (r for r in self.runs.values()
             if r.assistant_id == assistant_id and r.created_at is not None),
            key=lambda r: r.created_at, reverse=True)[:limit]
        for run in newest:
            if (run.completed_at is not None
                    and tmin <= run.created_at < tmax
                    and tmin <= run.completed_at < tmax):
                for k in usage:
                    usage[k] += run.usage[k]
        return usage

    @_locked
    def usage_for_runs(self, run_ids: Sequence[str],
                       critical_path: bool = False) -> Dict[str, Any]:
        """Usage of exactly the named terminal runs (exact attribution,
        where the wall-clock window double-counts overlapping incidents).
        ``critical_path`` needs obs/critical_path.py, not ported yet."""
        if critical_path:
            raise NotImplementedError(
                "usage_for_runs(critical_path=True) needs "
                "obs/critical_path.py, which is not ported yet (ROADMAP "
                "Queue 1 item 11, fleet)")
        usage: Dict[str, Any] = {"prompt_tokens": 0,
                                 "completion_tokens": 0,
                                 "total_tokens": 0}
        for rid in run_ids:
            run = self.runs.get(rid)
            if run is not None and run.status in RunStatus.TERMINAL:
                for k in ("prompt_tokens", "completion_tokens",
                          "total_tokens"):
                    usage[k] += run.usage[k]
        return usage

    @_locked
    def list_messages(self, thread_id: str, limit: Optional[int] = None
                      ) -> MessageList:
        msgs = self.threads[thread_id].messages[::-1]  # newest first
        if limit is not None:
            msgs = msgs[:limit]
        return MessageList(data=msgs)

    # -------------------------------------------------------- observability

    @_locked
    def prometheus_metrics(self) -> str:
        """Prometheus text exposition of the global METRICS store (the
        counters and phase-timer summaries) and, when the backend carries
        an engine, its live gauges (``obs/export.py::prometheus_text``).
        A cluster router backend (``queue_depths``) comes with ROADMAP
        Queue 1 item 11 and raises there."""
        from k8s_llm_rca_tpu_torch.obs.export import prometheus_text

        router = (self.backend
                  if hasattr(self.backend, "queue_depths") else None)
        return prometheus_text(METRICS,
                               engine=getattr(self.backend, "engine", None),
                               router=router, tracer=obs_trace._ACTIVE)

    # ------------------------------------------------------------ execution

    @_locked
    def _pump(self) -> None:
        """Advance the backend and settle any finished runs."""
        results = self.backend.pump()
        now = self._clock.time()
        for handle, run_id in list(self._inflight.items()):
            run = self.runs[run_id]
            if handle in results:
                res = results[handle]
                if res.error is not None:
                    run.status = (RunStatus.EXPIRED if res.expired
                                  else RunStatus.FAILED)
                    run.error = res.error
                else:
                    run.status = RunStatus.COMPLETED
                    msg = Message(self._next_id("msg"), "assistant",
                                  res.text, now)
                    self.threads[run.thread_id].messages.append(msg)
                    run.response_message_id = msg.id
                if res.prompt_tokens is not None:
                    # the engine's ground truth (BOS, forced prefix,
                    # overflow truncation included)
                    run.usage["prompt_tokens"] = res.prompt_tokens
                run.usage["completion_tokens"] = res.completion_tokens
                run.usage["total_tokens"] = (
                    run.usage["prompt_tokens"] + res.completion_tokens)
                run.completed_at = int(self._clock.time())
                del self._inflight[handle]
                if self._journal is not None:
                    self._journal_settle(run)
                self._trace_run_settled(run)
            elif run.deadline is not None and now > run.deadline:
                self.backend.cancel(run.backend_handle)
                run.status = RunStatus.EXPIRED
                run.completed_at = int(self._clock.time())
                del self._inflight[handle]
                if self._journal is not None:
                    self._journal_settle(run)
                self._trace_run_settled(run)
        if results:
            obs_trace.event("serve.settled", n=len(results))

    def wait_run(self, run_id: str, timeout_s: Optional[float] = None) -> Run:
        """Pump until the run is terminal.  The lock is taken per pump, not
        for the whole wait, so concurrent waiters interleave."""
        run = self.runs[run_id]
        t0 = self._clock.time()
        with self._lock:
            self._waiters += 1
        try:
            return self._wait_run_loop(run, t0, timeout_s)
        finally:
            with self._lock:
                self._waiters -= 1

    def _wait_run_loop(self, run: Run, t0: float,
                       timeout_s: Optional[float]) -> Run:
        while run.status not in RunStatus.TERMINAL:
            with self._lock:
                if run.status in RunStatus.TERMINAL:
                    break
                self._pump()
                if run.status in RunStatus.TERMINAL:
                    break
                if not self.backend.busy(run.backend_handle):
                    run.status = RunStatus.FAILED
                    run.error = "backend dropped the run"
                    if self._journal is not None:
                        self._journal_settle(run)
                    break
                if (timeout_s is not None
                        and self._clock.time() - t0 > timeout_s):
                    self.backend.cancel(run.backend_handle)
                    self._inflight.pop(run.backend_handle, None)
                    run.status = RunStatus.EXPIRED
                    run.completed_at = int(self._clock.time())
                    if self._journal is not None:
                        self._journal_settle(run)
                    self._trace_run_settled(run)
                    break
            # with peer waiters a real sleep hands the lock over
            if self._waiters > 1:
                time.sleep(0.001)
        return run


def drive_steps(gen, service: AssistantService):
    """Run a step generator (``rca/pipeline.py::incident_steps`` and its
    stages) to completion by blocking on each yielded run: the sequential
    scheduling of the code the sweep scheduler interleaves.
    ``StopIteration.value`` is the generator's result."""
    try:
        pending = next(gen)
        while True:
            service.wait_run(pending.id)
            pending = gen.send(None)
    except StopIteration as stop:
        return stop.value


def run_reply_text(service: AssistantService, run: Run) -> str:
    """Reply text of a COMPLETED run, located by its response_message_id."""
    for m in service.list_messages(run.thread_id).data:
        if m.id == run.response_message_id:
            return m.content[0].text.value
    raise RuntimeError(f"reply message for run {run.id} not found")


class GenericAssistant:
    """Reference-compatible client: the 13 methods of the reference's
    ``common/openai_generic_assistant.py``, same names, same shapes."""

    def __init__(self, service: AssistantService):
        self.service = service
        self.assistant: Optional[Assistant] = None
        self.thread: Optional[Thread] = None
        self.message: Optional[Message] = None
        self.run: Optional[Run] = None

    def create_assistant(self, instructions: str, name: str,
                         model: str = "local",
                         gen: Optional[GenOptions] = None) -> None:
        self.assistant = self.service.create_assistant(
            instructions, name, model, gen)

    def retrieve_assistant(self, assistant_id: str) -> None:
        self.assistant = self.service.retrieve_assistant(assistant_id)

    def create_thread(self) -> None:
        self.thread = self.service.create_thread()

    def retrieve_thread(self, thread_id: str) -> None:
        self.thread = self.service.retrieve_thread(thread_id)

    def add_message(self, content: str) -> None:
        self.message = self.service.add_message(self.thread.id, content)

    def run_assistant(self, instructions: Optional[str] = None,
                      gen: Optional[GenOptions] = None) -> None:
        """``gen``: per-run GenOptions override (e.g. the cypher skeleton
        grammar, which differs per metapath)."""
        self.run = self.service.create_run(
            self.thread.id, self.assistant.id, instructions, gen)

    def get_run_status(self) -> Run:
        return self.service.retrieve_run(self.run.id)

    def display_response(self) -> None:
        print(self.get_last_message().data[0])

    def get_last_message(self) -> MessageList:
        return self.service.list_messages(self.thread.id, limit=1)

    def get_all_message(self) -> MessageList:
        return self.service.list_messages(self.thread.id, limit=20)

    def get_last_k_message(self, num: int) -> MessageList:
        return self.service.list_messages(self.thread.id, limit=num)

    def wait_get_last_k_message(self, num: int = 1) -> Optional[MessageList]:
        """Block until the run settles; ``data[0]`` is THIS run's reply
        even when concurrent runs on the thread settled in the same pump."""
        run = self.service.wait_run(self.run.id)
        if run.status == RunStatus.COMPLETED:
            msgs = self.get_last_k_message(num)
            if run.response_message_id is not None and (
                    not msgs.data
                    or msgs.data[0].id != run.response_message_id):
                all_msgs = self.service.list_messages(self.thread.id)
                mine = [m for m in all_msgs.data
                        if m.id == run.response_message_id]
                rest = [m for m in all_msgs.data
                        if m.id != run.response_message_id]
                msgs = MessageList(data=(mine + rest)[:num])
            return msgs
        log.warning("run %s terminated with status=%s error=%s",
                    run.id, run.status, run.error)
        return None

    def get_token_usage(self, tmin: int, tmax: int, limit: int = 20
                        ) -> Dict[str, int]:
        """The reference's window: runs of this thread whose created_at
        and completed_at both fall in [tmin, tmax), newest first."""
        usage = {"prompt_tokens": 0, "completion_tokens": 0,
                 "total_tokens": 0}
        for run in self.service.list_runs(self.thread.id, limit=limit,
                                          order="desc"):
            if (run.created_at is not None and run.completed_at is not None
                    and tmin <= run.created_at < tmax
                    and tmin <= run.completed_at < tmax):
                for k in usage:
                    usage[k] += run.usage[k]
        return usage


# ---------------------------------------------------------------------------
# persistence (session checkpoint/resume)
# ---------------------------------------------------------------------------


def save_service_state(service: AssistantService, path: str) -> None:
    """Persist assistants, threads (full message history) and TERMINAL runs
    to a JSON file.

    The file is the JAX package's format, so either package loads the
    other's.  In-flight runs are not persisted (their engine state is not
    serializable mid-decode); callers should drain first.
    """
    import json

    # peek the id counter without consuming (itertools.count can only be
    # advanced, so re-seed it with the observed value)
    next_id = next(service._ids)
    service._ids = itertools.count(next_id)
    state = {
        "next_id": next_id,              # keeps restored ids collision-free
        "assistants": [
            {"id": a.id, "name": a.name, "instructions": a.instructions,
             "model": a.model,
             "gen": {"max_new_tokens": a.gen.max_new_tokens,
                     "stop": list(a.gen.stop),
                     "forced_prefix": a.gen.forced_prefix,
                     "suffix": a.gen.suffix,
                     "grammar": a.gen.grammar}}
            for a in service.assistants.values()
        ],
        "threads": [
            {"id": t.id,
             "messages": [
                 {"id": m.id, "role": m.role, "content": m.raw_content,
                  "created_at": m.created_at}
                 for m in t.messages
             ]}
            for t in service.threads.values()
        ],
        "runs": [
            {"id": r.id, "thread_id": r.thread_id,
             "assistant_id": r.assistant_id, "status": r.status,
             "created_at": r.created_at, "completed_at": r.completed_at,
             "usage": r.usage, "error": r.error,
             "response_message_id": r.response_message_id}
            for r in service.runs.values() if r.status in RunStatus.TERMINAL
        ],
        "thread_runs": service._thread_runs,
    }
    with open(path, "w") as f:
        json.dump(state, f)


def load_service_state(path: str, backend: LMBackend,
                       run_timeout_s: float = 600.0) -> AssistantService:
    """Rebuild an AssistantService from ``save_service_state`` output.

    Restored threads keep their ids, so stage code holding thread/assistant
    ids across a process restart resumes transparently (and
    ``get_token_usage`` windows over past runs still answer correctly).
    """
    import json

    with open(path) as f:
        state = json.load(f)

    service = AssistantService(backend, run_timeout_s=run_timeout_s)
    service._ids = itertools.count(state["next_id"])
    for a in state["assistants"]:
        g = a.get("gen", {})
        gen = GenOptions(
            max_new_tokens=g.get("max_new_tokens", 256),
            stop=tuple(g.get("stop", ())),
            forced_prefix=g.get("forced_prefix", ""),
            suffix=g.get("suffix", ""),
            grammar=g.get("grammar"))
        service.assistants[a["id"]] = Assistant(
            a["id"], a["name"], a["instructions"], a["model"], gen)
    for t in state["threads"]:
        thread = Thread(t["id"], [
            Message(m["id"], m["role"], m["content"], m["created_at"])
            for m in t["messages"]
        ])
        service.threads[thread.id] = thread
    for r in state["runs"]:
        run = Run(r["id"], r["thread_id"], r["assistant_id"],
                  status=r["status"], created_at=r["created_at"],
                  completed_at=r["completed_at"], usage=r["usage"],
                  error=r["error"])
        run.response_message_id = r["response_message_id"]
        service.runs[run.id] = run
    terminal = set(service.runs)
    service._thread_runs = {
        tid: [rid for rid in rids if rid in terminal]
        for tid, rids in state["thread_runs"].items()
    }
    for tid in service.threads:
        service._thread_runs.setdefault(tid, [])
    return service
