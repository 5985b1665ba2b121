"""Fenced-output contracts.

The reference extracts LLM output from markdown code fences by naive
``str.split`` — ```` ```json ```` at find_metapath/find_srckind_metapath_neo4j.py:193-196
and ```` ```cypher ```` at generate_query/generate_query.py:83-85 — and drives a
retry-with-feedback loop off the resulting exceptions (test_all.py:63-83).

Here extraction is a first-class, tested utility.  The error types are stable
so the pipeline's retry loops can feed the exception text back into the thread
exactly like the reference does (the engine additionally *forces* the fence
prefix during decode — see engine/constrained.py — which removes most retries).
"""

from __future__ import annotations

import json
from typing import Any


class FencedBlockError(ValueError):
    """Raised when a response does not contain the requested fenced block."""


def extract_fenced(text: str, language: str) -> str:
    """Return the body of the first ```<language> ... ``` block in ``text``."""
    marker = f"```{language}"
    if marker not in text:
        raise FencedBlockError(
            f"no ```{language} fenced block found in response of {len(text)} chars"
        )
    body = text.split(marker, 1)[1]
    if "```" not in body:
        raise FencedBlockError(f"```{language} block is not closed")
    return body.split("```", 1)[0].strip()


def extract_json(text: str) -> Any:
    """Parse the first ```json block.  JSON errors propagate as
    ``json.JSONDecodeError`` so callers can retry-with-feedback
    (reference contract: test_all.py:70-76)."""
    body = extract_fenced(text, "json")
    try:
        return json.loads(body)
    except json.JSONDecodeError:
        # The reference's prompt examples use single quotes
        # (find_srckind_metapath_neo4j.py:225-234); models imitate them.
        # Tolerate that one deviation before giving up.
        return json.loads(body.replace("'", '"'))


def extract_cypher(text: str) -> str:
    """Return the body of the first ```cypher block."""
    return extract_fenced(text, "cypher")
