"""Write-ahead run journal for ``AssistantService`` (the port of
``k8s_llm_rca_tpu/serve/journal.py``; for the same calls under the same
clock the file is byte for byte the JAX package's).

The reference pipeline keeps every assistant/thread/run server-side and
loses nothing when the client process dies; the in-tree service keeps them
in process memory and loses EVERYTHING (reference analyze_root_cause.py
holds only ids, the OpenAI backend holds the state).  This journal closes
that durability gap at run granularity: every service mutation —
create_assistant, create_thread, add_message, run submit, run settle — is
appended as a checksummed, length-prefixed record (utils/wal.py) with an
fsync before the mutation is acknowledged, so a crash at ANY point leaves
a journal from which ``serve/recover.py`` rebuilds the exact service
state and re-queues the runs that never settled.

Discipline (mirrors faults/inject.py): when no journal is configured the
service pays exactly one ``is None`` check per hook — no record building,
no I/O, nothing.  The journal is the armed path, not the default path.

Record format: each WAL payload is one compact JSON object
``{"kind": <str>, ...fields}`` with sorted keys.  Kinds:

- ``create_assistant``: id, name, instructions, model, gen (GenOptions
  fields minus the grammar OBJECT — grammar specs are journaled as given:
  "json" or a schema dict; compiled FSMs are rebuilt at recovery).
- ``create_thread``: id.
- ``add_message``: thread_id, id, role, content, created_at.
- ``run_submit``: id, thread_id, assistant_id, created_at, instructions
  (the per-run override or None), gen (per-run override or None), prompt
  (the rendered prompt actually sent to the backend — journaling it makes
  resubmission independent of prompt-rendering drift).
- ``run_settle``: id, status, completed_at, usage, error, response
  (message dict for completed runs, else None).  Written for EVERY
  terminal transition — completed, failed, cancelled, expired — so replay
  can tell a finished run from an interrupted one by the mere presence of
  this record.

A partial tail (the crash artifact: a record cut mid-write) is detected by
checksum/length and dropped atomically on open — same temp + fsync +
``os.replace`` recipe as ``sweeps/run_file.py:scan_output``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from k8s_llm_rca_tpu_torch.obs import trace as obs_trace
from k8s_llm_rca_tpu_torch.utils import wal
from k8s_llm_rca_tpu_torch.utils.logging import METRICS, get_logger

log = get_logger(__name__)


def encode_gen(gen) -> Optional[Dict[str, Any]]:
    """GenOptions -> JSON-safe dict (grammar kept as its SPEC: "json" or a
    schema dict survive; a pre-compiled FSM object cannot be journaled and
    fails loudly rather than silently dropping the constraint)."""
    if gen is None:
        return None
    grammar = gen.grammar
    if grammar is not None and not isinstance(grammar, (str, dict)):
        raise ValueError(
            "journal requires grammar as a spec (\"json\" or a schema "
            f"dict), got compiled object {type(grammar).__name__}; pass "
            "the spec to GenOptions and let the backend compile it")
    return {"max_new_tokens": gen.max_new_tokens, "stop": list(gen.stop),
            "forced_prefix": gen.forced_prefix, "suffix": gen.suffix,
            "grammar": grammar, "assistant_name": gen.assistant_name,
            "session": gen.session,
            "priority": gen.priority, "deadline_s": gen.deadline_s}


def decode_gen(d: Optional[Dict[str, Any]]):
    from k8s_llm_rca_tpu_torch.serve.backend import GenOptions

    if d is None:
        return None
    grammar = d.get("grammar")
    return GenOptions(
        max_new_tokens=int(d["max_new_tokens"]), stop=tuple(d["stop"]),
        forced_prefix=d["forced_prefix"], suffix=d["suffix"],
        grammar=grammar, assistant_name=d.get("assistant_name", ""),
        session=d.get("session", ""),   # pre-cluster journals lack it
        priority=d.get("priority", 1),  # pre-overload journals lack both
        deadline_s=d.get("deadline_s"))


class RunJournal:
    """Append-only, fsync'd, crash-tolerant journal of service mutations.

    Opening an existing journal first drops any torn tail (atomic
    truncate), so appends always start at a record boundary — a restarted
    service can keep writing to the same file it recovered from.
    """

    def __init__(self, path: str):
        self.path = path
        self.appended = 0           # records appended by THIS process
        self.bytes_written = 0
        if os.path.exists(path):
            _, clean_end = wal.scan_wal(path, truncate_partial=True)
            log.debug("journal %s opened at clean offset %d", path,
                      clean_end)
        self._f = open(path, "ab")

    def append(self, kind: str, **fields: Any) -> None:
        """Durably append one record; returns only after the fsync, so an
        acknowledged mutation survives a process kill."""
        rec = dict(fields)
        rec["kind"] = kind
        payload = json.dumps(rec, sort_keys=True,
                             separators=(",", ":")).encode("utf-8")
        with obs_trace.span("serve.journal.append", cat="serve", kind=kind,
                            bytes=len(payload)):
            n = wal.append_record(self._f, payload)
        self.appended += 1
        self.bytes_written += n
        METRICS.inc("serve.journal_records")
        METRICS.inc("serve.journal_bytes", n)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_journal(path: str, truncate_partial: bool = False
                 ) -> Tuple[List[Dict[str, Any]], int]:
    """Decode every intact record; returns ``(records, clean_end)``.

    A record that fails JSON decoding despite a valid checksum indicates a
    writer bug, not a crash artifact — that fails loudly instead of being
    silently skipped (skipping a mutation would corrupt every replayed
    record after it)."""
    payloads, clean_end = wal.scan_wal(path, truncate_partial=truncate_partial)
    records = [json.loads(p.decode("utf-8")) for p in payloads]
    return records, clean_end
