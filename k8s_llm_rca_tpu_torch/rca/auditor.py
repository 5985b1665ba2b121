"""RCA stage 3 — temporal state audit and final report.

Behavior-equivalent to the reference's check_state package
(check_state/analyze_root_cause.py):

- the analyzer assistant is seeded with the STATE rule ("an entity without a
  STATE node is a clear error") and the audit task protocol (:6-46);
- temporal lookups join entity->STATE through HasState with half-open
  ``[tmin, tmax)`` interval predicates — loose (interval overlap) and strict
  (point-in-interval) variants (:49-79);
- per-entity audit: a missing STATE fabricates an "apparent error" clue
  naming the entity (name resolved through the 5-way key switch) and seeds
  it into the analyzer thread as evidence; present STATEs get one semantic
  LLM round-trip each over a 12-field projection (:155-250);
- the statepath walk accumulates per-entity clues, then one summary run
  demands per-kind relevance scores 0-10, a conclusion, and a kubectl/bash
  resolution in a fixed JSON shape (:82-150).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

from k8s_llm_rca_tpu_torch.rca import entity
from k8s_llm_rca_tpu_torch.serve.api import AssistantService, GenericAssistant
from k8s_llm_rca_tpu_torch.serve.backend import GenOptions
from k8s_llm_rca_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

ANALYZER_INSTRUCTIONS = (
    "You are an expert in Kubernetes state analysis: given a JSON snapshot "
    "of a k8s object you find misconfigurations and decide whether they "
    "relate to a given error message.")

STATE_RULE = """\
Rule: in this Kubernetes system every entity must have a corresponding STATE
node capturing its existence and status.  An entity with no STATE node in the
relevant time range is a clear error — the entity does not exist or its
creation failed.  This applies uniformly to native resources (Secrets,
ConfigMaps, Pods, ...) and external ones (nfs directories, hostPath
directories, images, ...)."""

TASK_PROTOCOL = """\
Audit protocol: you will repeatedly receive (1) a JSON string with the
current state of one k8s object and (2) an incident error message.  For each:
parse the JSON; scrutinize 'spec' and 'status' (or the other significant
fields when those are absent); decide whether anything in the state aligns
with the error message; explain the connection or state clearly that the
object looks unrelated; keep each reply a concise list of concrete clues
with resource names and numbers."""


def report_schema() -> dict:
    """Structured-output schema for the final report: the exact JSON shape
    the reference's summary prompt demands (reference
    check_state/analyze_root_cause.py:119-139) — per-kind relevance scores
    0-10, a conclusion, and a resolution.  Constrained decode makes the
    shape a guarantee instead of a hope: every report parses, for any
    model.  The field lengths are sized so the compiled DFA fits the
    table budget even at 32k-token vocabularies (state count scales with
    the summed string max_lens; oversized schemas still work — they fall
    back to the interpreted FSM, off the on-device scan path)."""
    # conclusion/resolution carry quoted kubectl commands and JSON patches,
    # so they admit escape pairs (\" etc.); the short per-kind fields don't
    # (escapes ~double a field's DFA states)
    return {"type": "object", "properties": [
        ("summary", {"type": "array", "min_items": 1, "max_items": 4,
                     "items": {"type": "object", "properties": [
                         ("kind", {"type": "string", "max_len": 40}),
                         ("explanation", {"type": "string", "max_len": 100}),
                         ("relevance_score",
                          {"enum": [str(i) for i in range(11)]}),
                     ]}}),
        ("conclusion",
         {"type": "string", "max_len": 140, "escapes": True}),
        ("resolution",
         {"type": "string", "max_len": 200, "escapes": True}),
    ]}


def setup_state_semantic_analyzer(service: AssistantService,
                                  model: str = "local",
                                  max_new_tokens: int = 512,
                                  constrained: bool = True
                                  ) -> GenericAssistant:
    analyzer = GenericAssistant(service)
    analyzer.create_assistant(
        ANALYZER_INSTRUCTIONS, "k8s-state-semantic-analyzer", model,
        gen=GenOptions(max_new_tokens=max_new_tokens))
    seed_analyzer_thread(analyzer)
    # the summary run uses a SEPARATE assistant whose decode is schema-
    # constrained to the report shape; it runs ON the analyzer's thread so
    # it sees every audit exchange (the per-entity audits stay free text).
    # constrained=False drops the schema: the report must parse on the
    # model's own merits (distilled-checkpoint content validation)
    reporter = GenericAssistant(service)
    reporter.create_assistant(
        ANALYZER_INSTRUCTIONS, "k8s-rca-reporter", model,
        gen=GenOptions(max_new_tokens=max(max_new_tokens, 192),
                       grammar=report_schema() if constrained else None))
    analyzer.reporter = reporter
    return analyzer


def seed_analyzer_thread(analyzer: GenericAssistant) -> None:
    """Fresh analyzer thread seeded with the STATE rule + task protocol
    (reference analyze_root_cause.py:20-43); shared by setup and the
    per-incident thread reset (RCAPipeline.reset_threads)."""
    analyzer.create_thread()
    analyzer.add_message(STATE_RULE)
    analyzer.add_message(TASK_PROTOCOL)


# ---------------------------------------------------------------------------
# temporal state queries (string builders, matching the reference signatures;
# values are repr-escaped; labels — which Cypher cannot parameterize — are
# whitelisted to bare identifiers so graph-sourced kinds can't inject)
# ---------------------------------------------------------------------------

_LABEL_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*\Z")


def _safe_label(kind: str) -> str:
    """Cypher label positions can't take query parameters; restrict them to
    bare identifiers (the whole kind vocabulary is) so a hostile kind value
    coming out of the stategraph can't splice clauses into the query."""
    if not _LABEL_RE.match(kind or ""):
        raise ValueError(f"unsafe entity kind for a Cypher label: {kind!r}")
    return kind


def find_loose_states(entity_kind: str, entity_id: str,
                      tmin: str, tmax: str, limit: int = 10) -> str:
    """[E.tmin, E.tmax) must overlap [S.tmin, S.tmax)."""
    entity_kind = _safe_label(entity_kind)
    state_kind = entity_kind.upper()
    return f"""
    MATCH (n1:{entity_kind})-[r1:HasState]->(n2:{state_kind})
    WHERE n1.id = {entity_id!r}
    AND r1.tmin <= {tmax!r} AND r1.tmax > {tmin!r}
    RETURN n2
    LIMIT {limit};
    """


def find_strict_states(entity_kind: str, entity_id: str,
                       timestamp: str, limit: int = 10) -> str:
    """Event timestamp must fall in [S.tmin, S.tmax).  Half-open on the
    right so one timestamp lands in exactly one interval (the reference
    documents this rationale at :62-68)."""
    entity_kind = _safe_label(entity_kind)
    state_kind = entity_kind.upper()
    return f"""
    MATCH (n1:{entity_kind})-[r1:HasState]->(n2:{state_kind})
    WHERE n1.id = {entity_id!r}
    AND r1.tmin <= {timestamp!r} AND r1.tmax > {timestamp!r}
    RETURN n2
    LIMIT {limit};
    """


def ad_hoc_find_entity_name(entity_kind: str, entity_id: str,
                            query_executor) -> str:
    entity_kind = _safe_label(entity_kind)
    records = query_executor.run_query(f"""
    MATCH (n1:{entity_kind})
    WHERE n1.id = {entity_id!r}
    RETURN n1
    LIMIT 1
    """)
    if not records:
        return entity_id
    return entity.entity_name(records[0]["n1"], default=entity_id)


# ---------------------------------------------------------------------------
# semantic audit
# ---------------------------------------------------------------------------

IMPORTANT_FIELDS = ("status", "spec", "path", "server", "subsets", "roleRef",
                    "subjects", "rules", "webhooks", "secrets", "data",
                    "metadata")


def _project_fields(state_node, error_message: str, reranker=None,
                    fields_top_k: int = 0) -> List[str]:
    """The STATE fields entering the audit prompt.

    Default: every present IMPORTANT_FIELD (the reference's 12-field
    projection, analyze_root_cause.py:225-230).  With a reranker and a
    positive ``fields_top_k``, each candidate field embeds as a
    "key: value" passage against the error message and only the top-k
    most relevant fields survive — the rerank result now SHAPES what the
    auditor reads (BASELINE configs[4] "fused into the RCA prompt loop"),
    instead of only ordering records."""
    fields = [k for k in IMPORTANT_FIELDS if state_node[k] is not None]
    if reranker is None or fields_top_k <= 0 or len(fields) <= fields_top_k:
        return fields
    passages = [f"{k}: {state_node[k]}" for k in fields]
    ranked = reranker.rerank(error_message, passages, fields_top_k)
    keep = {fields[i] for i, _ in ranked}
    return [k for k in fields if k in keep]     # stable field order


def _semantic_prompt(state_node, error_message: str,
                     fields: List[str] = None) -> str:
    if fields is None:
        fields = _project_fields(state_node, error_message)
    projection = {k: state_node[k] for k in fields}
    kind = state_node["kind"]
    return f"""\
The following JSON comes from a {kind} object.  Focus on the 'spec' and
'status' fields (or other relevant fields if those are absent) and list
clues connecting it to the error message; ignore resolutions for now.
The error message is:
{error_message}

The JSON is:
{projection}
"""


def check_semantic(state_node, error_message: str,
                   analyzer: GenericAssistant, reranker=None,
                   fields_top_k: int = 0) -> str:
    """One semantic LLM round-trip for one STATE node, prompt projected onto
    the important fields to keep the context small (rerank-compressed when
    a reranker is fused in — see _project_fields)."""
    fields = _project_fields(state_node, error_message, reranker,
                             fields_top_k)
    analyzer.add_message(_semantic_prompt(state_node, error_message, fields))
    analyzer.run_assistant()
    messages = analyzer.wait_get_last_k_message(1)
    if messages is None:
        raise RuntimeError(
            f"analyzer run ended in state {analyzer.get_run_status().status}")
    return messages.data[0].content[0].text.value


def submit_semantic(state_node, error_message: str,
                    analyzer: GenericAssistant, reranker=None,
                    fields_top_k: int = 0):
    """Non-blocking variant: START the audit run on its OWN sub-thread.
    The per-entity audits on a statepath are independent until the summary
    barrier (SURVEY §3.4 — the reference serializes one blocking round-trip
    per entity at reference analyze_root_cause.py:97-115); submitting them
    all first lets the continuous-batching engine decode them in ONE batch.

    A sub-thread per run (seeded with the same rule + protocol the main
    analyzer thread carries) keeps the audits genuinely independent: on the
    SHARED thread, a later-submitted run's prompt would contain the earlier
    audits' still-unanswered prompts.  The sub-threads share their seeded
    prefix, which is exactly what the paged engine's prefix cache
    deduplicates.  The caller posts each resulting clue back to the main
    thread as evidence for the summary run."""
    service = analyzer.service
    sub = service.create_thread()
    service.add_message(sub.id, STATE_RULE)
    service.add_message(sub.id, TASK_PROTOCOL)
    fields = _project_fields(state_node, error_message, reranker,
                             fields_top_k)
    service.add_message(sub.id, _semantic_prompt(state_node, error_message,
                                                 fields))
    return service.create_run(sub.id, analyzer.assistant.id)


def parse_semantic(run, analyzer: GenericAssistant) -> str:
    """Parse half of ``await_semantic``: the run is already terminal (the
    caller waited, or the incident state machine was resumed on it)."""
    if run.status != "completed":
        raise RuntimeError(f"analyzer run ended in state {run.status}")
    service = analyzer.service
    for m in service.list_messages(run.thread_id).data:
        if m.id == run.response_message_id:
            return m.content[0].text.value
    raise RuntimeError(f"reply message for run {run.id} not found")


def await_semantic(run, analyzer: GenericAssistant) -> str:
    """Barrier for one submit_semantic run: wait, return its reply text."""
    run = analyzer.service.wait_run(run.id)
    return parse_semantic(run, analyzer)


def _missing_state_clue(entity_kind: str, entity_id: str,
                        query_executor) -> str:
    """The fabricated apparent-error clue for an entity with no STATE node
    (single source for the serial and concurrent audit paths)."""
    name = ad_hoc_find_entity_name(entity_kind, entity_id, query_executor)
    return (f"{entity_kind} ({entity_id}): there is not a STATE "
            f"({entity_kind.upper()}) node corresponding to the Entity "
            f"({entity_kind}) node, which is an apparent error. we "
            f"confirm that {name} does not exist.")


def check_states_of_entity(entity_kind: str, entity_id: str,
                           error_message: str, timestamp: str,
                           query_executor,
                           analyzer: GenericAssistant, reranker=None,
                           fields_top_k: int = 0) -> List[str]:
    """Audit one entity: missing STATE -> fabricated apparent-error clue
    pushed into the analyzer thread; present STATEs -> one semantic
    round-trip each."""
    records = query_executor.run_query(
        find_strict_states(entity_kind, entity_id, timestamp))
    clues: List[str] = []
    if not records:
        clue = _missing_state_clue(entity_kind, entity_id, query_executor)
        clues.append(clue)
        analyzer.add_message(clue)        # evidence for the summary run
    else:
        for record in records:
            state_node = record["n2"]
            semantic = check_semantic(state_node, error_message, analyzer,
                                      reranker, fields_top_k)
            clues.append(f"{state_node['kind'].upper()}({state_node['id']}): "
                         f"{semantic}")
    for clue in clues:
        log.info("clue: %s", clue)
    return clues


def check_states_existence_and_semantic(query_executor, cypher_query: str,
                                        analyzer: GenericAssistant,
                                        error_message: str) -> List[str]:
    """Single-query variant for stage-isolated harnesses: the caller builds
    the state query itself (strict or loose) and passes it in, as the
    reference's stage-3 harness does (reference :155-170; its
    test_check_state.py:48 calls this with a pinned query).  Exercised here
    by tests/test_auditor_stage.py."""
    clues: List[str] = []
    records = query_executor.run_query(cypher_query)
    if not records:
        clues.append("There is not a STATE node corresponds to the Entity node")
    else:
        for record in records:
            state_node = record["n2"]
            semantic = check_semantic(state_node, error_message, analyzer)
            clues.append(f"{state_node['kind']}({state_node['id']}): {semantic}")
    return clues


# ---------------------------------------------------------------------------
# statepath walk + report
# ---------------------------------------------------------------------------

REPORT_SHAPE = """\
Format the report in this JSON style:
{
"summary": [
        {
        "kind": "<k8s object kind>",
        "explanation": "<brief explanation with specific evidence>",
        "relevance_score": "<0-10>"
        },
        ...
        ],
"conclusion": "<summary of the overall findings>",
"resolution": "<actions to resolve the error, with kubectl/bash command>"
}
"""


def _is_node(ele) -> bool:
    return hasattr(ele, "labels") and hasattr(ele, "element_id")


def _cancel_fanout_runs(analyzer: GenericAssistant, fanout) -> None:
    """Cancel every submitted-but-unawaited audit run (terminal runs are a
    no-op for cancel_run)."""
    for _, items in fanout:
        for item in items:
            if item[0] == "run":
                analyzer.service.cancel_run(item[2].id)


def check_statepath(query_executor, analyzer: GenericAssistant,
                    statepath, concurrent: bool = True, reranker=None,
                    fields_top_k: int = 0
                    ) -> Tuple[str, Dict[str, List[str]]]:
    """Audit every entity on a matched statepath record, then one summary
    run producing the scored report.  Returns (report_text, path_clues).

    ``concurrent`` (default): all per-entity semantic runs are SUBMITTED
    first and awaited at a barrier before the summary, so the engine
    decodes them in one continuous batch instead of the reference's one
    blocking round-trip per entity (SURVEY §3.4).  The summary run is
    created only after the barrier, so it still sees every audit exchange
    in the thread.  ``concurrent=False`` reproduces the reference's serial
    order exactly."""
    timestamp = error_message = None
    for ele in statepath:
        if _is_node(ele) and ele["kind"] == "Event":
            timestamp = ele["timestamp"]
            error_message = ele["message"]
    if timestamp is None:
        raise ValueError("statepath record has no Event node")

    path_clues: Dict[str, List[str]] = {}
    kinds: List[str] = []
    fanout: List[Tuple[str, List[Any]]] = []   # (label, clues | pending runs)
    for ele in statepath:
        if not _is_node(ele):
            continue
        if ele["kind2"] == "Event" or ele["kind"] == "Event":
            continue
        if ele["kind"] == "EVENT":
            continue
        entity_kind = entity.entity_kind(ele)
        entity_id = ele["id"]
        kinds.append(entity_kind)
        label = f"{entity_kind}({entity_id})"
        if not concurrent:
            path_clues[label] = check_states_of_entity(
                entity_kind, entity_id, error_message, timestamp,
                query_executor, analyzer, reranker, fields_top_k)
            continue
        # fan-out: missing-STATE clues are synthesized inline; present
        # STATEs get their runs submitted (on sub-threads) without waiting.
        # ALL evidence posts to the main thread at the barrier, in path
        # order (mixing fan-out-time and barrier-time posts would reorder
        # the summary run's evidence vs the serial path).
        try:
            records = query_executor.run_query(
                find_strict_states(entity_kind, entity_id, timestamp))
            if not records:
                clue = _missing_state_clue(entity_kind, entity_id,
                                           query_executor)
                fanout.append((label, [("clue", clue)]))
            else:
                items: List[Any] = []
                # append incrementally so an exception mid-entity still
                # leaves every submitted run visible to the cleanup below
                fanout.append((label, items))
                for record in records:
                    run = submit_semantic(record["n2"], error_message,
                                          analyzer, reranker, fields_top_k)
                    items.append(("run", record["n2"], run))
        except Exception:
            _cancel_fanout_runs(analyzer, fanout)
            raise

    # barrier: collect in path order; every clue (fabricated or audited)
    # is posted to the MAIN analyzer thread here, so the summary run sees
    # the evidence coherently paired and in path order
    try:
        for label, items in fanout:
            clues: List[str] = []
            for item in items:
                if item[0] == "clue":
                    clues.append(item[1])
                else:
                    _, state_node, run = item
                    semantic = await_semantic(run, analyzer)
                    clues.append(f"{state_node['kind'].upper()}"
                                 f"({state_node['id']}): {semantic}")
            for clue in clues:
                analyzer.add_message(clue)
                log.info("clue: %s", clue)
            path_clues[label] = clues
    except Exception:
        # don't leave stragglers decoding onto the engine after a failed
        # barrier — later incidents reuse this analyzer
        _cancel_fanout_runs(analyzer, fanout)
        raise

    prompt = (
        f"Based on the previous analysis of {', '.join(kinds)}, summarize "
        "the root cause of the error message and pinpoint the most relevant "
        "parts.  For each kind give a relevance score (0-10).  Provide a "
        "resolution with a kubectl or bash command where applicable, using "
        "the actual resource names and namespaces for precision.  Include "
        "crucial details (resource names, IDs, numbers).\n" + REPORT_SHAPE)
    analyzer.add_message(prompt)
    reporter = getattr(analyzer, "reporter", None)
    service = analyzer.service
    if reporter is not None:
        # schema-constrained summary run on the ANALYZER's thread: same
        # evidence, guaranteed report shape
        run = service.create_run(analyzer.thread.id, reporter.assistant.id)
        return await_semantic(run, analyzer), path_clues
    analyzer.run_assistant()
    messages = analyzer.wait_get_last_k_message(1)
    if messages is None:
        raise RuntimeError(
            f"analyzer run ended in state {analyzer.get_run_status().status}")
    report = messages.data[0].content[0].text.value
    return report, path_clues


def check_statepath_steps(query_executor, analyzer: GenericAssistant,
                          statepath, concurrent: bool = True, reranker=None,
                          fields_top_k: int = 0):
    """Generator twin of ``check_statepath``: identical stage logic and
    identical prompts/evidence order, but every LLM round-trip YIELDS its
    pending Run instead of blocking in ``wait_run``.  The caller resumes
    the generator once the yielded run is terminal (``drive_steps`` does
    so by waiting — the sequential scheduling; the sweep scheduler polls
    and interleaves other incidents' stages in the meantime).  Runs are
    yielded one at a time in the exact order the blocking path waits on
    them, so failure ordering and straggler cancellation are unchanged.
    ``StopIteration.value`` is the blocking path's (report, path_clues).

    ``concurrent`` keeps its meaning: the fan-out still SUBMITS every
    audit run up front (the engine decodes them in one batch) — only the
    per-run settle points yield."""
    timestamp = error_message = None
    for ele in statepath:
        if _is_node(ele) and ele["kind"] == "Event":
            timestamp = ele["timestamp"]
            error_message = ele["message"]
    if timestamp is None:
        raise ValueError("statepath record has no Event node")

    path_clues: Dict[str, List[str]] = {}
    kinds: List[str] = []
    fanout: List[Tuple[str, List[Any]]] = []   # (label, clues | pending runs)
    for ele in statepath:
        if not _is_node(ele):
            continue
        if ele["kind2"] == "Event" or ele["kind"] == "Event":
            continue
        if ele["kind"] == "EVENT":
            continue
        entity_kind = entity.entity_kind(ele)
        entity_id = ele["id"]
        kinds.append(entity_kind)
        label = f"{entity_kind}({entity_id})"
        if not concurrent:
            # serial: one round-trip per entity on the MAIN analyzer
            # thread, in path order (check_states_of_entity's shape —
            # the reference's serial order, with the wait externalized)
            records = query_executor.run_query(
                find_strict_states(entity_kind, entity_id, timestamp))
            clues: List[str] = []
            if not records:
                clue = _missing_state_clue(entity_kind, entity_id,
                                           query_executor)
                clues.append(clue)
                analyzer.add_message(clue)   # evidence for the summary run
            else:
                for record in records:
                    state_node = record["n2"]
                    fields = _project_fields(state_node, error_message,
                                             reranker, fields_top_k)
                    analyzer.add_message(_semantic_prompt(
                        state_node, error_message, fields))
                    analyzer.run_assistant()
                    run = analyzer.run
                    yield run
                    semantic = parse_semantic(run, analyzer)
                    clues.append(
                        f"{state_node['kind'].upper()}({state_node['id']}):"
                        f" {semantic}")
            for clue in clues:
                log.info("clue: %s", clue)
            path_clues[label] = clues
            continue
        # fan-out: same as the blocking path — submit without waiting
        try:
            records = query_executor.run_query(
                find_strict_states(entity_kind, entity_id, timestamp))
            if not records:
                clue = _missing_state_clue(entity_kind, entity_id,
                                           query_executor)
                fanout.append((label, [("clue", clue)]))
            else:
                items: List[Any] = []
                fanout.append((label, items))
                for record in records:
                    run = submit_semantic(record["n2"], error_message,
                                          analyzer, reranker, fields_top_k)
                    items.append(("run", record["n2"], run))
        except Exception:
            _cancel_fanout_runs(analyzer, fanout)
            raise

    # barrier: yield each pending run in path order (the order the
    # blocking path waits on them); evidence posts at the barrier
    try:
        for label, items in fanout:
            clues = []
            for item in items:
                if item[0] == "clue":
                    clues.append(item[1])
                else:
                    _, state_node, run = item
                    yield run
                    semantic = parse_semantic(run, analyzer)
                    clues.append(f"{state_node['kind'].upper()}"
                                 f"({state_node['id']}): {semantic}")
            for clue in clues:
                analyzer.add_message(clue)
                log.info("clue: %s", clue)
            path_clues[label] = clues
    except Exception:
        _cancel_fanout_runs(analyzer, fanout)
        raise

    prompt = (
        f"Based on the previous analysis of {', '.join(kinds)}, summarize "
        "the root cause of the error message and pinpoint the most relevant "
        "parts.  For each kind give a relevance score (0-10).  Provide a "
        "resolution with a kubectl or bash command where applicable, using "
        "the actual resource names and namespaces for precision.  Include "
        "crucial details (resource names, IDs, numbers).\n" + REPORT_SHAPE)
    analyzer.add_message(prompt)
    reporter = getattr(analyzer, "reporter", None)
    service = analyzer.service
    if reporter is not None:
        run = service.create_run(analyzer.thread.id, reporter.assistant.id)
        yield run
        return parse_semantic(run, analyzer), path_clues
    analyzer.run_assistant()
    run = analyzer.run
    yield run
    if run.status != "completed":
        raise RuntimeError(f"analyzer run ended in state {run.status}")
    from k8s_llm_rca_tpu_torch.serve.api import run_reply_text
    return run_reply_text(service, run), path_clues
