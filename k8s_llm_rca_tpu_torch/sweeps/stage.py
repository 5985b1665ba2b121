"""Stage-isolated operator harnesses, one CLI for four scenarios (the port
of ``k8s_llm_rca_tpu/sweeps/stage.py``).

The reference ships four hand-run scripts that exercise one slice of the
pipeline with pinned inputs — stage 1 only (reference
test_find_metapath.py:44-63), stage 2 with a hardcoded Pod->Secret
metapath (test_generate_query.py:23-31,47-53), stage 3 with pinned
entity/timestamp (test_check_state.py:39-48), and an assistants-API +
token-accounting smoke (test_token.py:13-47).  This module is their
equivalent, sharing the sweep drivers' backend/graph wiring:

    python -m k8s_llm_rca_tpu_torch.sweeps.stage locate   [--incident N] [...]
    python -m k8s_llm_rca_tpu_torch.sweeps.stage cypher   [...]
    python -m k8s_llm_rca_tpu_torch.sweeps.stage audit    [...]
    python -m k8s_llm_rca_tpu_torch.sweeps.stage token    [...]

All four take the common flags (--backend oracle|engine, --model,
--neo4j-*); hermetic by default against the canned fixture graphs.
"""

from __future__ import annotations

import argparse
import json
import time

from k8s_llm_rca_tpu_torch.graph.fixtures import INCIDENTS
from k8s_llm_rca_tpu_torch.rca import auditor, cyphergen, locator
from k8s_llm_rca_tpu_torch.sweeps.common import (
    add_common_args, build_executors, build_service,
)
from k8s_llm_rca_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# the reference's stage-2 pinned metapath: Pod -> Secret via the two
# implicit Event edges (reference test_generate_query.py:23-27)
PINNED_METAPATH = ("HasEvent, Event, EVENT, metadata_uid; "
                   "ReferInternal, Event, Pod, involvedObject_uid; "
                   "ReferInternal, Pod, Secret, "
                   "spec_volumes_secret_secretName; ")


def stage_locate(args, service, meta, state) -> dict:
    """Stage 1 only: srcKind discovery + destKind plan + metapath ladder."""
    message = INCIDENTS[args.incident % len(INCIDENTS)].message
    native, external = locator.find_native_external_kinds(meta)
    loc = locator.setup_root_cause_locator(
        service, args.model, kind_vocabulary=native + external)
    template = locator.build_prompt_template(native, external)
    src = locator.find_srcKind(state, message)
    plan = locator.find_destKind_relevantResources(message, src, template,
                                                   loc)
    # same intermediate derivation as the pipeline (rca/pipeline.py): drop
    # src/dest — leaving them in would make the directed rungs' interior-
    # membership clause unsatisfiable for short paths
    dest = plan["DestinationKind"]
    known = set(native) | set(external)
    intermediate = [k for k in plan.get("RelevantResources", [])
                    if k not in (src, dest) and k in known]
    metapaths = locator.find_metapath(meta, src, dest, intermediate)
    return {"message": message, "srcKind": src, "plan": plan,
            "metapaths": [[n["kind"] for n in mp.nodes]
                          for mp in metapaths]}


def stage_cypher(args, service, meta, state) -> dict:
    """Stage 2 only: LLM cypher generation for the pinned metapath, run +
    message-compatibility filter, deterministic compiler alongside."""
    message = INCIDENTS[args.incident % len(INCIDENTS)].message
    gen = cyphergen.setup_cypher_generator(service, args.model)
    out: dict = {"metapath": PINNED_METAPATH}
    try:
        query = cyphergen.generate_cypher_query(PINNED_METAPATH, message,
                                                gen)
        records = cyphergen.run_and_filter_query(state, query)
        out["cypher_query"] = query
        out["records"] = len(records)
    except Exception as e:            # scripted/weak models may misfire: the
        out["error"] = str(e)         # driver shows the failure, like the
    compiled = cyphergen.compile_metapath_query(PINNED_METAPATH, message)
    out["human_cypher_query"] = compiled
    out["human_records"] = len(cyphergen.run_and_filter_query(state,
                                                              compiled))
    return out


def stage_audit(args, service, meta, state) -> dict:
    """Stage 3 only: strict temporal state lookup + per-entity audit for a
    pinned entity (the reference pins a ResourceQuota case; our fixture's
    equivalent is the incident's involved Secret)."""
    message = INCIDENTS[args.incident % len(INCIDENTS)].message
    analyzer = auditor.setup_state_semantic_analyzer(service, args.model)
    records = state.run_query(
        "MATCH (n1:Event)-[s1:HasEvent]->(N1:EVENT) "
        "WHERE N1.message CONTAINS $message RETURN n1, N1 LIMIT 1",
        {"message": message})
    if not records:
        return {"error": f"no Event matches {message[:60]!r}"}
    timestamp = records[0]["N1"]["timestamp"]
    kind, ent_id = args.entity_kind, args.entity_id
    clues = auditor.check_states_of_entity(kind, ent_id, message, timestamp,
                                           state, analyzer)
    return {"entity": f"{kind}({ent_id})", "timestamp": timestamp,
            "clues": clues}


def stage_token(args, service, meta, state) -> dict:
    """Assistants-API smoke incl. token accounting (the test_token.py
    equivalent): unrelated math-tutor assistant, one run, windowed usage."""
    from k8s_llm_rca_tpu_torch.serve.api import GenericAssistant
    from k8s_llm_rca_tpu_torch.serve.backend import GenOptions

    tutor = GenericAssistant(service)
    tutor.create_assistant(
        "You are a personal math tutor; answer concisely.",
        "math-tutor", args.model, gen=GenOptions(max_new_tokens=32))
    tutor.create_thread()
    t0 = int(time.time())
    tutor.add_message("I need to solve the equation 3x + 11 = 14.")
    tutor.run_assistant()
    messages = tutor.wait_get_last_k_message(1)
    reply = (messages.data[0].content[0].text.value
             if messages is not None else None)
    usage = tutor.get_token_usage(t0, int(time.time()) + 1, limit=10)
    return {"run_status": tutor.get_run_status().status,
            "reply_chars": len(reply or ""), "token_usage": usage}


STAGES = {"locate": stage_locate, "cypher": stage_cypher,
          "audit": stage_audit, "token": stage_token}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("stage", choices=sorted(STAGES))
    add_common_args(parser)
    parser.add_argument("--incident", type=int, default=0,
                        help="index into the canned incident corpus")
    parser.add_argument("--entity-kind", default="Secret",
                        help="audit harness: pinned entity kind")
    parser.add_argument("--entity-id", default="sec-0001",
                        help="audit harness: pinned entity id (default: the "
                             "fixture incident's missing Secret)")
    args = parser.parse_args(argv)

    service = build_service(args)
    meta, state = build_executors(args)
    try:
        result = STAGES[args.stage](args, service, meta, state)
    finally:
        meta.close()
        state.close()
    print(json.dumps(result, indent=2, default=str))
    return result


if __name__ == "__main__":
    main()
