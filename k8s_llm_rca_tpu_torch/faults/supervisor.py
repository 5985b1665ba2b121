"""Supervised kill/restart of the serving stack — the process-level
"crash" fault (the port of ``rebind_pipeline`` and ``CrashSupervisor``
from ``k8s_llm_rca_tpu/faults/supervisor.py``; its replica, process,
network, handoff and store killers come with ROADMAP Queue 1 item 11).

A real worker kill destroys the Python process: the ``AssistantService``
store, every backend handle, and the engine's device KV all evaporate;
only two artifacts survive on disk — the run journal (serve/journal.py)
and the sweep output file.  ``CrashSupervisor`` reproduces exactly that
inside one test process, deterministically:

- it polls ``inject.SITE_PROCESS`` on its OWN FaultPlan at incident
  boundaries (``run_chaos_soak`` calls ``checkpoint`` after each
  incident).  The supervisor plan is deliberately separate from the armed
  chaos plan: a crash must not shift the armed plan's poll counters, or
  the crashed run's fault schedule — and therefore the report — would
  diverge from the uninterrupted run and the byte-identity proof would be
  comparing different fault histories;
- on a "crash" fault it tears the stack down the way a kill does: the
  journal file handle is closed, every live backend run is cancelled
  (releasing engine slots/pages, since the engine OBJECT stands in for
  the restarted worker's recompiled engine — recompiling identical
  weights per crash would buy no extra coverage and minutes of compile),
  and the service object is dropped;
- then it restarts: a fresh backend from the factory, a reopened journal
  (RunJournal's open drops any torn tail), ``recover_service`` replaying
  the journal, and the recovered service rebound into the RCA pipeline's
  stage clients.

What survives a supervised crash ON PURPOSE: the ResiliencePolicy
(breaker/retry counters model cluster-level state the report asserts on)
and the VirtualClock (monotonic across restarts, like wall time).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

from k8s_llm_rca_tpu_torch.faults import inject
from k8s_llm_rca_tpu_torch.faults.plan import FaultPlan
from k8s_llm_rca_tpu_torch.utils.logging import METRICS, get_logger

log = get_logger(__name__)


def rebind_pipeline(pipeline, service) -> None:
    """Point an RCAPipeline (and its three stage clients) at a recovered
    service.  Stage clients hold object references (assistant/thread)
    into the dead service's store; each is re-resolved by id against the
    replayed store — ids are journaled, so they match exactly."""
    pipeline.service = service
    for client in (pipeline.locator, pipeline.cypher_generator,
                   pipeline.analyzer):
        client.service = service
        if client.assistant is not None:
            client.assistant = service.assistants[client.assistant.id]
        if client.thread is not None:
            # a thread may predate journaling or belong to a finished
            # incident; rebind when replay knows it, else leave the stale
            # reference for reset_threads to replace
            t = service.threads.get(client.thread.id)
            if t is not None:
                client.thread = t


class CrashSupervisor:
    """Deterministic kill/restart harness for ``run_chaos_soak``.

    ``plan``: the supervisor's own FaultPlan scheduling "crash" faults at
    ``inject.SITE_PROCESS`` (never the armed chaos plan — see module
    docstring).  ``journal_path``: the run journal both halves share.
    """

    def __init__(self, plan: FaultPlan, journal_path: str):
        self.plan = plan
        self.journal_path = journal_path
        self.crashes = 0
        self.recoveries: List[Dict[str, Any]] = []

    def checkpoint(self, pipeline, service,
                   backend_factory: Callable[[], Any],
                   run_timeout_s: float, clock=None):
        """Incident-boundary poll: returns the service to keep using —
        the same one, or a journal-recovered replacement after a crash."""
        fault = self.plan.poll(inject.SITE_PROCESS)
        if fault is None:
            return service
        if fault.kind != "crash":
            log.warning("supervisor fault %r ignored: only 'crash' is "
                        "meaningful at %s", fault.kind, inject.SITE_PROCESS)
            return service
        return self.crash_restart(pipeline, service, backend_factory,
                                  run_timeout_s, clock)

    def crash_restart(self, pipeline, service,
                      backend_factory: Callable[[], Any],
                      run_timeout_s: float, clock=None):
        """Tear the stack down (process-kill semantics) and rebuild it
        from the journal.  See the module docstring for what dies and
        what survives."""
        from k8s_llm_rca_tpu_torch.serve.journal import RunJournal
        from k8s_llm_rca_tpu_torch.serve.recover import recover_service

        self.crashes += 1
        log.warning("supervised crash #%d: tearing down serving stack",
                    self.crashes)
        journal = getattr(service, "_journal", None)
        if journal is not None:
            journal.close()
        backend = service.backend
        # the dead process's engine sequences: cancel through the backend
        # so slots/pages are released on the engine object that stands in
        # for the restarted worker's engine
        for handle in list(getattr(backend, "_live", ())):
            backend.cancel(handle)
        service._inflight.clear()

        new_backend = backend_factory()
        new_journal = RunJournal(self.journal_path)
        svc, report = recover_service(
            self.journal_path, new_backend, run_timeout_s=run_timeout_s,
            clock=clock, journal=new_journal)
        self.recoveries.append(report)
        if pipeline is not None:
            rebind_pipeline(pipeline, svc)
        METRICS.inc("faults.supervised_crashes")
        log.warning("supervised restart #%d: %d records replayed, "
                    "%d runs resubmitted", self.crashes, report["records"],
                    len(report["resubmitted"]))
        return svc
