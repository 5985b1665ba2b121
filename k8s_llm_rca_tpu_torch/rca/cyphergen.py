"""RCA stage 2 — Cypher compilation: metapath -> executable stategraph query.

Behavior-equivalent to the reference's generate_query package
(generate_query/generate_query.py):

- metapath serialization prepends the two implicit edges
  (HasEvent Event->EVENT metadata_uid; ReferInternal Event->srcKind
  involvedObject_uid) before the metagraph edges (:46-57);
- the LLM path is few-shot: a labeled generation template is seeded into
  the thread at setup (:37-41, :134-211) and each request references the
  label; the ```cypher fence is engine-forced;
- the deterministic compiler is the guaranteed fallback (:214-266):
  EVENT-message CONTAINS prologue with LIMIT 1, kind-keyed alias
  allocation, chained MATCH with timely r.key filters, interleaved
  node/rel RETURN;
- results are filtered by message compatibility (:88-129): the destination
  node's name (5-way key switch) or kind (2-way switch) must appear in the
  Event message.
"""

from __future__ import annotations

from typing import Any, Dict, List

from k8s_llm_rca_tpu_torch.rca import entity
from k8s_llm_rca_tpu_torch.serve.api import (
    AssistantService, GenericAssistant, Run, RunStatus, run_reply_text,
)
from k8s_llm_rca_tpu_torch.serve.backend import GenOptions
from k8s_llm_rca_tpu_torch.utils.fenced import extract_cypher
from k8s_llm_rca_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

CYPHERGEN_INSTRUCTIONS = (
    "You are an expert in Neo4j and the Cypher query language; you compile "
    "metapath descriptions of a Kubernetes state graph into precise, "
    "label-faithful Cypher queries.")

GENERATION_TEMPLATE = """\
Cypher generation template (label: generation-template-1).

Input: a metapath — lines of `relType, srcKind, destKind, key;` — and an
error message.  Output: one Cypher query that walks the metapath through the
state graph, anchored at the EVENT carrying the message.

Rules:
1. Anchor first: match the EVENT node whose `message` property CONTAINS the
   full error message (never truncate it), and LIMIT 1 immediately:
       MATCH (evt:EVENT)
       WHERE evt.message CONTAINS '<error message>'
       WITH evt
       LIMIT 1
2. Then one MATCH per metapath edge, in order, with the filter applied
   immediately after it (timely filtering shrinks the search space):
       MATCH (src:srcKind)-[rN:relType]->(dst:destKind)
       WHERE rN.key = '<key>'
   Number the relationship aliases r1, r2, r3, ... in edge order.
3. Reuse one alias per node kind so consecutive edges chain through shared
   nodes; the EVENT anchor's alias is `evt`.
4. Copy labels and key values EXACTLY as written in the metapath — no case
   changes, no underscore edits ('nfs' stays 'nfs',
   'involvedObject_uid' stays 'involvedObject_uid').
5. Finish by returning every node and relationship interleaved in path
   order: RETURN node1, r1, node2, r2, ...

Worked example — metapath:
    HasEvent, Event, EVENT, metadata_uid;
    ReferInternal, Event, Pod, involvedObject_uid;
    ReferInternal, Pod, ConfigMap, spec_volumes_configMap_name;
error message:
    MountVolume.SetUp failed for volume "conf" : configmap "cm" not found
query:
    MATCH (evt:EVENT)
    WHERE evt.message CONTAINS 'MountVolume.SetUp failed for volume "conf" : configmap "cm" not found'
    WITH evt
    LIMIT 1
    MATCH (event:Event)-[r1:HasEvent]->(evt)
    WHERE r1.key = 'metadata_uid'
    MATCH (event)-[r2:ReferInternal]->(pod:Pod)
    WHERE r2.key = 'involvedObject_uid'
    MATCH (pod)-[r3:ReferInternal]->(configMap:ConfigMap)
    WHERE r3.key = 'spec_volumes_configMap_name'
    RETURN event, r1, evt, r2, pod, r3, configMap
"""


def setup_cypher_generator(service: AssistantService,
                           model: str = "local",
                           max_new_tokens: int = 512) -> GenericAssistant:
    gen = GenericAssistant(service)
    gen.create_assistant(
        CYPHERGEN_INSTRUCTIONS, "cypher-query-generator", model,
        gen=GenOptions(max_new_tokens=max_new_tokens,
                       forced_prefix="```cypher\n", stop=("```",),
                       suffix="\n```"))
    seed_generation_template(gen)
    return gen


def seed_generation_template(gen: GenericAssistant) -> None:
    """Fresh thread pre-loaded with the labeled few-shot template
    (reference generate_query.py:37-41); shared by setup and the
    per-incident thread reset (RCAPipeline.reset_threads)."""
    gen.create_thread()
    gen.add_message(
        "Label the following prompt template generation-template-1; use it "
        "for every cypher generation request that references it.")
    gen.add_message(GENERATION_TEMPLATE)


def extend_metapath_construct_string(partial_path) -> str:
    """Serialize a metagraph path, prepending the implicit Event edges."""
    src_kind = partial_path.nodes[0]["kind"]
    out = ("\n    HasEvent, Event, EVENT, metadata_uid;\n"
           f"    ReferInternal, Event, {src_kind}, involvedObject_uid;\n    ")
    for rel in partial_path.relationships:
        out += ", ".join([rel.type, rel["srcKind"], rel["destKind"],
                          rel["key"]]) + ";\n"
    return out


def cypher_query_schema(metapath_str: str, error_message: str
                        ) -> Dict[str, Any]:
    """Skeleton grammar for stage-2 decode (structured outputs).

    The metapath fully determines the query skeleton — the deterministic
    compiler below proves it.  So rather than hoping the model reproduces
    the skeleton (and retrying on syntax errors, reference
    test_all.py:99-122), the skeleton IS the grammar: decode is
    constrained to the compiled query text, with the model's remaining
    freedom a bounded CHOICE between complete well-formed variants
    (numeric aliases n1/n2/... vs kind-derived camelCase aliases, the two
    styles the few-shot template exhibits).  Cross-referenced aliases
    cannot be free slots in a stack-automaton grammar (the RETURN clause
    must repeat the MATCH aliases), which is why freedom lives at the
    whole-variant level.  Under this grammar ANY model emits a
    syntactically valid, label-faithful query on the first attempt."""
    variants = []
    for style in ("numeric", "kind"):
        q = compile_metapath_query(metapath_str, error_message,
                                   alias_style=style, quiet=True)
        if q not in variants:
            variants.append(q)
    return {"type": "choice", "options": variants}


def submit_cypher_query(metapath_str: str, error_message: str,
                        generator: GenericAssistant,
                        constrain: bool = True) -> Run:
    """Submit half of ``generate_cypher_query``: post the request (with
    the per-metapath skeleton grammar when constrained) and start the run
    WITHOUT waiting.  The incident state machine yields the Run and parses
    on settle; the blocking wrapper waits in between."""
    prompt = f"""\
Use generation-template-1 to generate a cypher query for the following case.
Strictly follow the (srcKind)-[rel]->(destKind) ordering, never reverse it.
Return the query inside a ```cypher fenced block.
the provided metapath is:
{metapath_str}
the error message to filtering is:
{error_message}
"""
    generator.add_message(prompt)
    gen = None
    if constrain:
        # per-run override: the skeleton grammar differs per metapath, so
        # it cannot live on the assistant's GenOptions; budget sized to
        # the worst-case one-char-per-token decode of the longest variant
        import dataclasses

        schema = cypher_query_schema(metapath_str, error_message)
        budget = max(len(o) for o in schema["options"]) + 64
        gen = dataclasses.replace(
            generator.assistant.gen, grammar=schema,
            max_new_tokens=max(generator.assistant.gen.max_new_tokens,
                               budget))
    generator.run_assistant(gen=gen)
    return generator.run


def parse_cypher_query(generator: GenericAssistant, run: Run) -> str:
    """Parse half: extract the fenced query from the settled run's reply.
    Same RuntimeError text as the blocking path on non-completed runs."""
    if run.status != RunStatus.COMPLETED:
        raise RuntimeError(f"cypher run ended in state {run.status}")
    query = extract_cypher(run_reply_text(generator.service, run))
    log.info("generated cypher query:\n%s", query)
    return query


def generate_cypher_query(metapath_str: str, error_message: str,
                          generator: GenericAssistant,
                          constrain: bool = True) -> str:
    run = submit_cypher_query(metapath_str, error_message, generator,
                              constrain)
    generator.service.wait_run(run.id)
    return parse_cypher_query(generator, run)


# ---------------------------------------------------------------------------
# deterministic compiler (the reference's human_generate_cypher_query)
# ---------------------------------------------------------------------------


def parse_metapath_string(metapath_str: str) -> List[List[str]]:
    """'; '-separated edges, each 'relType, srcKind, destKind, key'."""
    edges = []
    for chunk in metapath_str.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = [p.strip() for p in chunk.split(",")]
        if len(parts) != 4:
            raise ValueError(f"malformed metapath edge {chunk!r}")
        edges.append(parts)
    return edges


def compile_metapath_query(metapath_str: str, error_message: str,
                           alias_style: str = "numeric",
                           quiet: bool = False) -> str:
    """Deterministic metapath -> Cypher compiler.  Unlike the LLM it cannot
    fail; used when generation exhausts its retries or returns zero rows
    (reference fallback wiring: test_all.py:127-131), and as the skeleton
    source for the stage-2 decode grammar (cypher_query_schema).

    ``alias_style``: "numeric" (n1, n2, ...) or "kind" (camelCase of the
    node kind, as the few-shot template's worked example writes them)."""
    if alias_style not in ("numeric", "kind"):
        raise ValueError(f"unknown alias_style {alias_style!r}")
    metapath = parse_metapath_string(metapath_str)

    aliases: Dict[str, str] = {"EVENT": "evt"}
    idx = 1
    for _, src_kind, dest_kind, _key in metapath:
        for kind in (src_kind, dest_kind):
            if kind not in aliases:
                if alias_style == "kind":
                    aliases[kind] = kind[0].lower() + kind[1:]
                else:
                    aliases[kind] = f"n{idx}"
                idx += 1

    parts = [
        "MATCH (evt:EVENT)",
        f"WHERE evt.message CONTAINS {error_message!r}",
        "WITH evt",
        "LIMIT 1",
    ]
    for i, (rel_type, src_kind, dest_kind, key) in enumerate(metapath, start=1):
        parts.append(
            f"MATCH ({aliases[src_kind]}:{src_kind})"
            f"-[r{i}:{rel_type}]->({aliases[dest_kind]}:{dest_kind})")
        parts.append(f"WHERE r{i}.key = {key!r}")

    nodes = list(aliases.values())
    rels = [f"r{i}" for i in range(1, len(metapath) + 1)]
    interleaved: List[str] = [None] * (len(nodes) + len(rels))
    interleaved[::2] = nodes
    interleaved[1::2] = rels
    parts.append("RETURN " + ", ".join(interleaved))
    query = "\n".join(parts)
    if not quiet:
        log.info("deterministically compiled cypher query:\n%s", query)
    return query


# ---------------------------------------------------------------------------
# result filtering
# ---------------------------------------------------------------------------


def message_compatible(record) -> bool:
    """Keep a record only if its destination node is actually mentioned by
    the Event message — by name (5-way key switch) or kind (2-way switch)
    (reference :104-129)."""
    message = None
    for ele in record:
        if hasattr(ele, "labels") and ele["kind"] == "Event":
            message = ele["message"]
    if message is None:
        return False
    dest = record[len(record) - 1]
    name = entity.entity_name(dest)
    kind = entity.entity_kind(dest)
    return bool((name is not None and name in message)
                or (kind is not None and kind in message))


def run_and_filter_query(query_executor, cypher_query: str) -> List[Any]:
    records = query_executor.run_query(cypher_query)
    kept = [r for r in records if message_compatible(r)]
    if records and not kept:
        log.warning("ALL %d records are not message compatible", len(records))
    return kept
