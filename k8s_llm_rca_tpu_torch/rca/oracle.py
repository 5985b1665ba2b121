"""Scripted oracle LM backend for hermetic pipeline tests.

No pretrained weights ship in this zero-egress image, so random-weight
models cannot emit valid JSON/Cypher.  The oracle is the deterministic
"small model" SURVEY §4 prescribes: an LMBackend that recognizes the three
stage prompt contracts and produces well-formed bodies (the fences come from
GenOptions, exactly as they would from the engine's forced prefix):

- destKind planning prompts -> a JSON plan chosen by keyword heuristics over
  the error message, constrained to the prompt's kind vocabulary;
- generation-template-1 prompts -> the deterministic metapath compiler's
  output (what a competent cypher LLM would produce);
- semantic-audit prompts -> a clue referencing the state fields;
- summary prompts -> the scored-report JSON shape with a kubectl resolution.

A ``chaos`` knob makes the first N runs of a category produce malformed
output, to exercise the pipeline's retry-with-feedback and deterministic-
fallback paths (reference failure handling: test_all.py:63-83,99-131).
"""

from __future__ import annotations

import itertools
import json
import re
from typing import Dict, List, Optional, Tuple

from k8s_llm_rca_tpu_torch.rca.cyphergen import compile_metapath_query
from k8s_llm_rca_tpu_torch.serve.backend import BackendResult, GenOptions
from k8s_llm_rca_tpu_torch.utils.tokenizer import Tokenizer

# (pattern, destKind, intermediate kinds) — first match wins
_DEST_RULES: List[Tuple[str, str, List[str]]] = [
    (r"secret \"", "Secret", []),
    (r"configmap \"", "ConfigMap", []),
    (r"exceeded quota", "ResourceQuota", []),
    (r"no such file or directory|stale nfs|mount -t nfs",
     "nfs", ["PersistentVolumeClaim", "PersistentVolume"]),
    (r"unbound immediate persistentvolumeclaims|pvc",
     "PersistentVolumeClaim", ["PersistentVolume"]),
    (r"network|sandbox", "container", []),
]


def scripted_plan(error_message: str, src_kind: str,
                  native_kinds: List[str],
                  external_kinds: List[str]) -> Dict[str, object]:
    """Deterministic destKind plan from the keyword rules — the oracle's
    planning brain without the prompt plumbing.  Doubles as the
    degradation ladder's scripted-oracle rung (faults/policy.py): when
    every engine-backed planning rung fails, the pipeline falls back to
    this, annotated as degraded."""
    allowed = set(native_kinds) | set(external_kinds)
    msg = error_message.lower()
    dest, inter = "Node", []
    for pattern, cand, cand_inter in _DEST_RULES:
        if re.search(pattern, msg) and cand in allowed:
            dest, inter = cand, [k for k in cand_inter if k in allowed]
            break
    resources = [src_kind] + inter + [dest]
    hops = [{"Edge": i + 1, "start": resources[i], "end": resources[i + 1]}
            for i in range(len(resources) - 1)]
    return {
        "SourceKind": src_kind,
        "DestinationKind": dest,
        "RelevantResources": resources,
        "PrimaryPath": hops,
    }


class OracleBackend:
    def __init__(self, tokenizer: Tokenizer,
                 chaos: Optional[Dict[str, int]] = None):
        """``chaos`` maps category ('plan' | 'cypher') to how many initial
        runs of that category produce malformed output."""
        self.tokenizer = tokenizer
        self._handles = itertools.count()
        self._inflight: Dict[int, Tuple[str, GenOptions]] = {}
        self._chaos = dict(chaos or {})

    # ------------------------------------------------------------- protocol

    def start(self, prompt: str, opts: GenOptions) -> int:
        handle = next(self._handles)
        self._inflight[handle] = (prompt, opts)
        return handle

    def pump(self) -> Dict[int, BackendResult]:
        results: Dict[int, BackendResult] = {}
        for handle, (prompt, opts) in list(self._inflight.items()):
            del self._inflight[handle]
            body = self._respond(prompt, opts.assistant_name)
            text = opts.forced_prefix + body + opts.suffix
            results[handle] = BackendResult(
                text=text, completion_tokens=self.tokenizer.count(text))
        return results

    def busy(self, handle: int) -> bool:
        return handle in self._inflight

    def cancel(self, handle: int) -> None:
        self._inflight.pop(handle, None)

    def count_tokens(self, text: str) -> int:
        return self.tokenizer.count(text)

    # ------------------------------------------------------------- behavior

    def _chaotic(self, category: str) -> bool:
        if self._chaos.get(category, 0) > 0:
            self._chaos[category] -= 1
            return True
        return False

    def _respond(self, prompt: str, assistant_name: str = "") -> str:
        """Route primarily on the assistant name the service attaches to the
        run (GenOptions.assistant_name) — stable under prompt rewordings.
        Within a stage, pick the NEWEST matching user message: the thread is
        shared across an incident sweep (reference design, SURVEY §3.4) and
        retry-with-feedback appends exception text as the newest message, so
        the newest *request-shaped* message is the one to answer."""
        msgs = _user_messages(prompt)
        if not msgs:
            return "Understood."
        last = msgs[-1]
        if assistant_name == "k8s-root-cause-locator":
            # "predefined" distinguishes the real planning request from
            # retry-feedback messages that merely quote the malformed output
            for m in reversed(msgs):
                if "DestinationKind" in m and "predefined" in m:
                    return self._plan_dest_kind(m)
            return "Understood."
        if assistant_name == "cypher-query-generator":
            for m in reversed(msgs):
                if "the provided metapath is:" in m:
                    return self._compile_cypher(m)
            return "Understood."
        if assistant_name == "k8s-rca-reporter":
            return self._summarize(last, prompt)
        if assistant_name == "k8s-state-semantic-analyzer":
            if "The following JSON comes from a" in last:
                return self._semantic_clue(last)
            if "summarize" in last and "relevance score" in last.lower():
                return self._summarize(last, prompt)
            return "Understood."   # seeded rules / pushed clue evidence
        # Fallback: legacy substring routing, for callers that drive the
        # backend directly without the assistants service (no name attached).
        if "DestinationKind" in last and "predefined" in last:
            return self._plan_dest_kind(last)
        if "generation-template-1" in last and \
                "the provided metapath is:" in last:
            return self._compile_cypher(last)
        if "summarize" in last and "relevance score" in last.lower():
            return self._summarize(last, prompt)
        if "The following JSON comes from a" in last:
            return self._semantic_clue(last)
        # retry-with-feedback: the newest message is the exception text; redo
        # the most recent matching request from the thread
        if "dest_relevant" in last:
            for m in reversed(msgs):
                if "DestinationKind" in m and "predefined" in m:
                    return self._plan_dest_kind(m)
        if "cypher" in last.lower():
            for m in reversed(msgs):
                if "the provided metapath is:" in m:
                    return self._compile_cypher(m)
        return "Understood."

    def _plan_dest_kind(self, prompt: str) -> str:
        if self._chaotic("plan"):
            return '{"DestinationKind": broken'   # malformed on purpose
        native = _list_after(prompt, "k8s-api-resource-kinds:")
        external = _list_after(prompt, "k8s-external-resource-kinds:")
        m = re.search(r"mentions a (\w+)", prompt)
        src = m.group(1) if m else "Pod"
        tail = prompt[prompt.rfind("strictly within the provided lists:"):]
        return json.dumps(scripted_plan(tail, src, native, external),
                          indent=2)

    def _compile_cypher(self, prompt: str) -> str:
        if self._chaotic("cypher"):
            return "MATCH (evt:EVENT WHERE RETURN"   # syntax error on purpose
        meta = prompt.split("the provided metapath is:")[1]
        meta, msg_part = meta.split("the error message to filtering is:")
        error_message = msg_part.strip()
        return compile_metapath_query(meta.strip(), error_message)

    def _semantic_clue(self, prompt: str) -> str:
        kind = re.search(r"JSON comes from a (\w+) object", prompt).group(1)
        status = re.search(r"'status': ([^\n]*)", prompt)
        clue = [f"The {kind} state was inspected against the error message."]
        if "used" in prompt and "hard" in prompt:
            clue.append(
                "The status shows usage at the hard limit (used == hard), "
                "which directly matches the exceeded-quota error.")
        elif status:
            clue.append(f"status fields reviewed: {status.group(1)[:120]}")
        else:
            clue.append("No spec/status anomaly clearly tied to the message.")
        return " ".join(clue)

    def _summarize(self, last: str, prompt: str) -> str:
        m = re.search(r"analysis of (.+?), summarize", last, re.DOTALL)
        kinds = [k.strip() for k in m.group(1).split(",")] if m else ["Pod"]
        # only count missing-STATE clues raised since the previous summary
        # reply (the shared thread carries earlier incidents' clues too)
        cur_start = prompt.rfind(last)
        prev_end = prompt.rfind('"resolution"', 0, cur_start)
        region = prompt[max(prev_end, 0):cur_start]
        missing = re.findall(r"(\w+) \([\w-]+\): there is not a STATE", region)
        summary = []
        for kind in kinds:
            score = "9" if kind in missing else "3"
            expl = (f"{kind} has no STATE node in the incident window — the "
                    f"entity does not exist" if kind in missing
                    else f"{kind} state was present and inspected")
            summary.append({"kind": kind, "explanation": expl,
                            "relevance_score": score})
        conclusion = (
            f"Root cause: missing {', '.join(missing)} referenced by the "
            f"workload" if missing else
            "Root cause: a present-but-misconfigured state on the path")
        resolution = (
            f"kubectl describe {kinds[-1].lower()} && kubectl apply -f "
            f"<manifest restoring {missing[0] if missing else kinds[-1]}>")
        return json.dumps({"summary": summary, "conclusion": conclusion,
                           "resolution": resolution}, indent=2)


def _list_after(prompt: str, marker: str) -> List[str]:
    m = re.search(re.escape(marker) + r" ([^\n]*)", prompt)
    if not m:
        return []
    return [k.strip() for k in m.group(1).split(",") if k.strip()]


def _user_messages(prompt: str) -> List[str]:
    """Split the rendered chat prompt (serve.api.render_prompt format) into
    the user messages, oldest first."""
    parts = prompt.split("<|user|>\n")[1:]
    return [p.split("<|", 1)[0].strip() for p in parts]
