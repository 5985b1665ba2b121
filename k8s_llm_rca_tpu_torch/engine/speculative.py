"""Speculative decoding drafts: n-gram prompt lookup, the port of
``k8s_llm_rca_tpu/engine/speculative.py::ngram_draft``.

A slot's draft is the continuation of the most recent earlier occurrence
of its last n tokens.  One multi-token decode step
(``engine/paged.py::paged_decode_multi``) scores all draft positions at
once; the engine commits the longest draft prefix that agrees with the
model's own greedy (grammar-constrained) choice plus one bonus token, so
the output equals plain greedy decoding and only the tokens committed per
dispatch change.

The JAX package's draft MODEL (``ModelDraft``) runs on the contiguous
engine's scan, which the port does not have yet: ``draft_model=`` raises
(ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from typing import List, Sequence

DRAFT_MODEL_ITEM = "Queue 1 item 9, the contiguous engine"


def ngram_draft(context: Sequence[int], n: int, k: int) -> List[int]:
    """Propose up to ``k`` draft tokens by prompt lookup: the tokens that
    followed the most recent earlier occurrence of the last ``n`` tokens
    of ``context``.  Empty when that n-gram has no earlier occurrence."""
    if n <= 0 or k <= 0 or len(context) <= n:
        return []
    pattern = list(context[-n:])
    # right to left over earlier windows: the most recent prior occurrence
    # predicts the continuation best
    for start in range(len(context) - n - 1, -1, -1):
        if list(context[start:start + n]) == pattern:
            return list(context[start + n:start + n + k])
    return []
