"""RCA stage 1 — incident locator: srcKind discovery, destKind planning,
metapath search.

Behavior-equivalent to the reference's find_metapath package
(find_metapath/find_srckind_metapath_neo4j.py):

- srcKind: stategraph lookup (Event)-[HasEvent]->(EVENT) message CONTAINS,
  then ReferInternal(involvedObject_uid) to the involved entity (:75-90);
- kind vocabulary: metagraph category scan into sorted native/external
  lists (:63-72);
- destKind planning: an LLM run constrained to the vocabulary with a fenced
  JSON contract {SourceKind, DestinationKind, RelevantResources,
  PrimaryPath} (:178-196, 200-240) — here the fence is FORCED by the engine
  (GenOptions.forced_prefix) rather than hoped for;
- metapath search: the 4-rung fallback ladder (directed *1..3 -> undirected
  -> single hop -> via-Namespace), node uniqueness via single(), Event/
  Namespace exclusion, optional intermediate-kind membership, shortest-only
  pruning (:93-160).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from k8s_llm_rca_tpu_torch.serve.api import (
    AssistantService, GenericAssistant, Run, RunStatus, run_reply_text,
)
from k8s_llm_rca_tpu_torch.serve.backend import GenOptions
from k8s_llm_rca_tpu_torch.utils.fenced import extract_json
from k8s_llm_rca_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

LOCATOR_INSTRUCTIONS = """\
You are an expert in Kubernetes (k8s) diagnostics.  You know the native API
resource kinds (Pods, Deployments, StatefulSets, CronJobs, Jobs, Services,
ConfigMaps, Secrets, PersistentVolumes, PersistentVolumeClaims,
ResourceQuotas, ServiceAccounts, Namespaces, Nodes, ...) and the external
resources a cluster touches (NFS exports, hostPath directories, container
runtimes, images).  Given an error message from a cluster, you identify the
resource kinds implicated, reason about how they interact, and plan the
chain of resources to inspect from the failing object to the kind that can
resolve the problem.  You never invent kinds outside the provided lists and
you answer strictly in the requested JSON structure."""


def plan_schema(kind_vocabulary: Sequence[str]) -> Dict[str, Any]:
    """Structured-output schema for the destKind plan: the exact fenced-JSON
    contract of the reference prompt (reference
    find_metapath/find_srckind_metapath_neo4j.py:212-238), with every kind
    field constrained to the metagraph vocabulary.  Under this schema ANY
    model — including an un-finetuned or random-weight one — produces a
    structurally valid plan naming real kinds; the reference can only hope
    GPT-4 complies and retry when it doesn't."""
    kind = {"enum": sorted(set(kind_vocabulary))}
    return {"type": "object", "properties": [
        ("SourceKind", kind),
        ("DestinationKind", kind),
        ("RelevantResources",
         {"type": "array", "items": kind, "min_items": 1, "max_items": 6}),
        ("PrimaryPath",
         {"type": "array", "min_items": 1, "max_items": 5,
          "items": {"type": "object", "properties": [
              ("Edge", {"type": "integer", "max_digits": 2}),
              ("start", kind),
              ("end", kind)]}}),
    ]}


def setup_root_cause_locator(
        service: AssistantService, model: str = "local",
        max_new_tokens: int = 768,
        kind_vocabulary: Optional[Sequence[str]] = None,
        constrained: bool = True) -> GenericAssistant:
    """``kind_vocabulary``: when given, decode is schema-constrained to the
    plan contract with kinds restricted to this vocabulary (structured
    outputs); otherwise any-JSON grammar (the round-1 behavior).
    ``constrained=False`` drops the grammar entirely — plan validity then
    rests on the model (distilled-checkpoint content validation)."""
    grammar: Any = ((plan_schema(kind_vocabulary) if kind_vocabulary
                     else "json") if constrained else None)
    locator = GenericAssistant(service)
    locator.create_assistant(
        LOCATOR_INSTRUCTIONS, "k8s-root-cause-locator", model,
        gen=GenOptions(max_new_tokens=max_new_tokens,
                       forced_prefix="```json\n", stop=("```",),
                       suffix="\n```", grammar=grammar))
    locator.create_thread()
    return locator


def find_native_external_kinds(query_executor) -> Tuple[List[str], List[str]]:
    records = query_executor.run_query("""
        MATCH (n1)
        WHERE n1.category IN ['NativeEntity', 'ExternalEntity']
        RETURN n1.category AS category, n1.kind AS kind
        """)
    native = sorted(r["kind"] for r in records if r["category"] == "NativeEntity")
    external = sorted(r["kind"] for r in records if r["category"] == "ExternalEntity")
    return native, external


def find_srcKind(query_executor, message: str) -> str:
    records = query_executor.run_query("""
        MATCH (n1:Event)-[s1:HasEvent]->(N1:EVENT)
        WHERE N1.message CONTAINS $message
        WITH n1, N1, s1
        MATCH (n1:Event)-[r1:ReferInternal]->(n2)
        WHERE r1.key = 'involvedObject_uid'
        RETURN DISTINCT n2.kind2
        LIMIT 5;
        """, {"message": message})
    if not records:
        raise LookupError(f"no Event matches message {message[:80]!r}")
    src = records[0]["n2.kind2"]
    log.info("srcKind = %s", src)
    return src


PROMPT_TEMPLATE_HEADER = (
    "The predefined k8s API resource kinds and external resource kinds are "
    "the following:\n\n"
    "k8s-api-resource-kinds: {native}\n\n"
    "k8s-external-resource-kinds: {external}\n\n"
)

PROMPT_TEMPLATE_TASK = (
    "Perform an analysis of the Kubernetes error message below, which "
    "mentions a {involved_object}.  Steps:\n\n"
    "1. Treat the {involved_object} as the starting point of the issue.\n"
    "2. Choose the 'DestinationKind' — the kind, from the predefined lists "
    "above, whose state most directly explains or resolves the problem.\n"
    "3. List the most relevant resources for the incident, again strictly "
    "from the predefined kinds.\n"
    "4. Chart the primary progression of the fault from {involved_object} "
    "to the DestinationKind using those resources as waypoints.\n"
    "5. Reply ONLY with JSON inside a ```json fenced block, in exactly this "
    "structure:\n"
    "```json\n"
    "{{\n"
    '    "SourceKind": "{involved_object}",\n'
    '    "DestinationKind": "<kind from the predefined lists>",\n'
    '    "RelevantResources": ["Resource1", "Resource2", "...",'
    ' "{involved_object}", "<DestinationKind>"],\n'
    '    "PrimaryPath": [\n'
    '        {{"Edge": 1, "start": "{involved_object}", "end": "Resource1"}},\n'
    '        {{"Edge": 2, "start": "Resource1", "end": "<DestinationKind>"}}\n'
    "    ]\n"
    "}}\n"
    "```\n"
    "Analyze the following error message, keeping DestinationKind and every "
    "resource strictly within the provided lists:\n\n"
    "{error_message}\n"
)


def build_prompt_template(native_kinds: Sequence[str],
                          external_kinds: Sequence[str]) -> str:
    return PROMPT_TEMPLATE_HEADER.format(
        native=", ".join(native_kinds),
        external=", ".join(external_kinds)) + PROMPT_TEMPLATE_TASK


def submit_destKind_plan(error_message: str, src_kind: str,
                         prompt_template: str,
                         locator: GenericAssistant) -> Run:
    """Submit half of ``find_destKind_relevantResources``: post the plan
    prompt and start the run WITHOUT waiting.  The pipelined incident
    state machine yields the returned Run and resumes on
    ``parse_destKind_plan`` once it settles; the blocking wrapper below
    just waits in between — one code path, two schedulings."""
    prompt = prompt_template.format(error_message=error_message,
                                    involved_object=src_kind)
    locator.add_message(prompt)
    locator.run_assistant()
    return locator.run


def parse_destKind_plan(locator: GenericAssistant, run: Run
                        ) -> Dict[str, Any]:
    """Parse half: read the settled run's reply and extract the plan JSON.
    Raises the same RuntimeError text as the blocking path on any
    non-completed terminal state."""
    if run.status != RunStatus.COMPLETED:
        raise RuntimeError(f"locator run ended in state {run.status}")
    return extract_json(run_reply_text(locator.service, run))


def find_destKind_relevantResources(
        error_message: str, src_kind: str, prompt_template: str,
        locator: GenericAssistant) -> Dict[str, Any]:
    run = submit_destKind_plan(error_message, src_kind, prompt_template,
                               locator)
    locator.service.wait_run(run.id)
    return parse_destKind_plan(locator, run)


# ---------------------------------------------------------------------------
# metapath ladder
# ---------------------------------------------------------------------------

_Q_DIRECTED = """
    MATCH path = (n1)-[*1..{hops}]->(n2)
    WHERE n1.kind = $srcKind AND n2.kind = $destKind
    AND all(node IN nodes(path) WHERE single(x IN nodes(path) WHERE x = node))
    AND all(node IN nodes(path) WHERE NOT node.kind IN ['Event', 'Namespace'])
    AND ($intermediateKinds IS NULL
        OR size($intermediateKinds) = 0
        OR any(node IN nodes(path)[1..-1] WHERE node.kind IN $intermediateKinds))
    RETURN path
    """

_Q_UNDIRECTED = _Q_DIRECTED.replace("]->(n2)", "]-(n2)")

_Q_SINGLE = """
    MATCH path = (n1)-[r1]-(n2)
    WHERE n1.kind = $srcKind AND n2.kind = $destKind
    RETURN path
    """

_Q_NAMESPACE = """
    MATCH path = (n1)-[r1]-(n2)-[r2]-(n3)
    WHERE n1.kind = $srcKind AND n2.kind = 'Namespace' AND n3.kind = $destKind
    RETURN path
    """


def find_metapath(query_executor, src_kind: str, dest_kind: str,
                  intermediate_kinds: Optional[Sequence[str]] = None,
                  max_hops: int = 3) -> List[Any]:
    """4-rung fallback ladder; returns the shortest paths only (possibly
    several of equal length), as neo4j-shaped Path objects."""
    inter = [x for x in (intermediate_kinds or []) if x != "Namespace"]
    params = {"srcKind": src_kind, "destKind": dest_kind,
              "intermediateKinds": inter}

    ladder = [
        ("directed", _Q_DIRECTED.format(hops=max_hops)),
        ("undirected", _Q_UNDIRECTED.format(hops=max_hops)),
        ("single-hop", _Q_SINGLE),
        ("via-Namespace", _Q_NAMESPACE),
    ]
    records = []
    for rung, query in ladder:
        records = query_executor.run_query(query, params)
        if records:
            log.info("metapath found on the %s rung (%d candidates)",
                     rung, len(records))
            break
        log.info("no metapath on the %s rung, falling through", rung)
    if not records:
        return []

    min_len = min(len(r["path"]) for r in records)
    metapaths = [r["path"] for r in records if len(r["path"]) == min_len]
    for mp in metapaths:
        print_metapath(mp)
    return metapaths


def print_metapath(path) -> None:
    log.info("metapath nodes: %s", [node["kind"] for node in path.nodes])
    for rel in path.relationships:
        log.info("  %s %s->%s key=%s", rel.type, rel["srcKind"],
                 rel["destKind"], rel["key"])
