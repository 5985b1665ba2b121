"""Crash recovery: rebuild an ``AssistantService`` from its run journal
(the port of ``k8s_llm_rca_tpu/serve/recover.py``).

Replay contract (the invariants docs/durability.md spells out):

- Every mutation the crashed service ACKNOWLEDGED is in the journal
  (RunJournal.append fsyncs before the mutating method returns), so replay
  reconstructs assistants, threads, messages, and run outcomes exactly.
- A run with a ``run_settle`` record is terminal and is restored AS
  SETTLED — completed, failed, cancelled, and expired runs are never
  re-executed.  In particular a run cancelled before the crash stays
  cancelled; replay cannot resurrect it.
- A run with a ``run_submit`` record but no settle record was in flight
  when the process died.  Its engine state (KV pages, decode position) is
  gone with the process; recovery re-queues it through ``backend.start``
  with the journaled prompt and options — a fresh prefill that the paged
  engine's prefix cache turns into a mostly-HIT path when enabled
  (engine/prefix.py).  Generated-but-unsettled tokens are NOT recovered:
  the run never settled, so nothing was acknowledged to the caller.
- Reconciliation: the sweep output file is the layer of record ABOVE the
  journal (sweeps/run_file.py).  An interrupted run whose thread carries
  an incident already durable in the sweep output is not resubmitted —
  its result exists on disk; re-running it would burn compute to produce
  a record the resumed sweep will skip anyway.  Such runs are marked
  cancelled with an explanatory error.
- The id counter resumes past the highest journaled id, so post-recovery
  ids never collide with pre-crash ids.

What is NOT replayed: engine/backend internals (handles, KV pages — those
die with the process and are rebuilt by resubmission), METRICS counters,
tracer state, and runs whose submission was rejected by the backend
(BudgetError fires before the submit record is written).
"""

from __future__ import annotations

import dataclasses
import itertools
import re
import time as _time
from typing import Any, Dict, List, Optional, Tuple

from k8s_llm_rca_tpu_torch.obs import trace as obs_trace
from k8s_llm_rca_tpu_torch.serve.api import (
    Assistant, AssistantService, Message, Run, RunStatus, Thread,
)
from k8s_llm_rca_tpu_torch.serve.backend import BudgetError, GenOptions
from k8s_llm_rca_tpu_torch.serve.journal import decode_gen, read_journal
from k8s_llm_rca_tpu_torch.utils.logging import METRICS, get_logger

log = get_logger(__name__)

_ID_SUFFIX = re.compile(r"_(\d+)$")


def _id_number(s: Optional[str]) -> int:
    if not s:
        return -1
    m = _ID_SUFFIX.search(s)
    return int(m.group(1)) if m else -1


def recover_service(journal_path: str, backend, run_timeout_s: float = 600.0,
                    clock=None, journal=None,
                    sweep_output: Optional[str] = None,
                    resubmit: bool = True
                    ) -> Tuple[AssistantService, Dict[str, Any]]:
    """Rebuild a service from ``journal_path`` onto a fresh ``backend``.

    ``journal``: the RunJournal the RECOVERED service should keep writing
    to (typically opened on the same path — RunJournal's open already
    dropped any torn tail).  It is attached only after replay, so replayed
    mutations and resubmissions are never journaled twice.

    Returns ``(service, report)`` where report counts what replay saw and
    what was re-queued.
    """
    records, clean_end = read_journal(journal_path)
    svc = AssistantService(backend, run_timeout_s=run_timeout_s, clock=clock)
    interrupted: Dict[str, Dict[str, Any]] = {}   # run id -> submit record
    max_id = -1
    n_messages = 0

    with obs_trace.span("serve.recover.replay", cat="serve",
                        records=len(records)):
        for rec in records:
            kind = rec["kind"]
            max_id = max(max_id, _id_number(rec.get("id")))
            if kind == "create_assistant":
                a = Assistant(rec["id"], rec["name"], rec["instructions"],
                              rec["model"],
                              decode_gen(rec["gen"]) or GenOptions())
                svc.assistants[a.id] = a
            elif kind == "create_thread":
                t = Thread(rec["id"])
                svc.threads[t.id] = t
                svc._thread_runs[t.id] = []
            elif kind == "add_message":
                m = Message(rec["id"], rec["role"], rec["content"],
                            rec["created_at"])
                svc.threads[rec["thread_id"]].messages.append(m)
                n_messages += 1
            elif kind == "run_submit":
                run = Run(rec["id"], rec["thread_id"], rec["assistant_id"],
                          created_at=rec["created_at"],
                          instructions_override=rec["instructions"])
                svc.runs[run.id] = run
                svc._thread_runs[run.thread_id].append(run.id)
                interrupted[run.id] = rec
            elif kind == "run_settle":
                run = svc.runs[rec["id"]]
                run.status = rec["status"]
                run.completed_at = rec["completed_at"]
                run.usage = dict(rec["usage"])
                run.error = rec["error"]
                resp = rec["response"]
                if resp is not None:
                    m = Message(resp["id"], resp["role"], resp["content"],
                                resp["created_at"])
                    svc.threads[run.thread_id].messages.append(m)
                    run.response_message_id = m.id
                    max_id = max(max_id, _id_number(m.id))
                    n_messages += 1
                interrupted.pop(rec["id"], None)
            else:
                raise ValueError(
                    f"unknown journal record kind {kind!r} — refusing to "
                    f"skip a mutation (every replayed record after it "
                    f"would be built on corrupt state)")

        svc._ids = itertools.count(max_id + 1)

        # ---- reconcile interrupted runs against the sweep output file
        reconciled: List[str] = []
        if sweep_output is not None and interrupted:
            from k8s_llm_rca_tpu_torch.sweeps.run_file import scan_output

            durable = set(scan_output(sweep_output)[0])
            for run_id in list(interrupted):
                run = svc.runs[run_id]
                thread = svc.threads[run.thread_id]
                if any(m.raw_content in durable for m in thread.messages
                       if m.role == "user"):
                    run.status = RunStatus.CANCELLED
                    run.completed_at = int((clock or _time).time())
                    run.error = ("reconciled: incident already durable in "
                                 "sweep output")
                    del interrupted[run_id]
                    reconciled.append(run_id)

        # ---- re-queue the runs that never settled (journal order)
        resubmitted: List[str] = []
        failed_resubmit: List[str] = []
        if resubmit:
            now = (clock or _time).time
            for run_id, rec in interrupted.items():
                run = svc.runs[run_id]
                assistant = svc.assistants[run.assistant_id]
                # session = thread id, re-stamped exactly as create_run
                # does: a cluster router recovering the journal re-pins
                # the thread's affinity instead of scattering its runs
                base = decode_gen(rec["gen"]) or assistant.gen
                # deadline re-stamped exactly as create_run does: the
                # resubmitted run carries its priority AND a fresh engine
                # deadline (the journal keeps deadline_s, not the absolute
                # instant — a crash-restart grants the full window again)
                deadline_s = (base.deadline_s if base.deadline_s is not None
                              else run_timeout_s)
                opts = dataclasses.replace(
                    base,
                    assistant_name=assistant.name,
                    session=rec["thread_id"],
                    deadline_s=deadline_s)
                prompt = rec["prompt"]
                run.usage["prompt_tokens"] = backend.count_tokens(prompt)
                run.t_started = now()
                run.deadline = now() + min(run_timeout_s, deadline_s)
                try:
                    run.backend_handle = backend.start(prompt, opts)
                except BudgetError as e:
                    # the REPLAYED budget can shrink (e.g. a smaller
                    # recovery engine); surface it as a failed run rather
                    # than aborting the whole recovery
                    run.status = RunStatus.FAILED
                    run.error = f"resubmit rejected: {e}"
                    run.completed_at = int(now())
                    failed_resubmit.append(run_id)
                    continue
                run.status = RunStatus.IN_PROGRESS
                svc._inflight[run.backend_handle] = run.id
                resubmitted.append(run_id)

    svc._journal = journal
    report = {
        "records": len(records),
        "clean_end": clean_end,
        "assistants": len(svc.assistants),
        "threads": len(svc.threads),
        "messages": n_messages,
        "runs": len(svc.runs),
        "interrupted": len(interrupted) + len(reconciled),
        "resubmitted": resubmitted,
        "reconciled": reconciled,
        "failed_resubmit": failed_resubmit,
    }
    METRICS.inc("serve.recoveries")
    log.info("recovered service from %s: %d records, %d runs, "
             "%d resubmitted, %d reconciled", journal_path, len(records),
             len(svc.runs), len(resubmitted), len(reconciled))
    return svc, report
