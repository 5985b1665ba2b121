"""Token sampling on the logits' device: greedy / temperature / top-k /
top-p, and its grammar-masked variant.

The port of ``k8s_llm_rca_tpu/engine/sampling.py``.  Greedy is argmax (the
first maximum on ties, as in JAX).  Nothing here syncs with the host, so
the decode scans sample inside a CUDA graph.  Random draws come from an explicit
``torch.Generator`` on the logits' device; they are not JAX's bits, so
only greedy streams compare token for token across the two packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => disabled
    top_p: float = 1.0         # 1 => disabled

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def _apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k, dim=-1).values[:, -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def _apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # keep tokens whose exclusive cumulative probability is < p; always
    # keep the top one
    keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                      cum[:, :-1] < p], dim=-1)
    thresh = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF),
                       logits)


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                  params: SamplingParams) -> torch.Tensor:
    """Sampled token ids [B] (int32) from logits [B, V] (fp32)."""
    if params.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / params.temperature
    if params.top_k > 0:
        scaled = _apply_top_k(scaled, params.top_k)
    if params.top_p < 1.0:
        scaled = _apply_top_p(scaled, params.top_p)
    probs = torch.softmax(scaled, dim=-1)
    # one draw by the exponential race, argmax(p / q) with q ~ Exp(1): the
    # draw torch.multinomial makes for one sample, without the validity
    # check that syncs with the host (the scan samples under CUDA graph
    # capture)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / race, dim=-1).to(torch.int32)


def sample_tokens_masked(logits: torch.Tensor,
                         generator: Optional[torch.Generator],
                         params: SamplingParams,
                         allow: torch.Tensor) -> torch.Tensor:
    """Grammar-constrained variant: disallowed tokens (``allow`` [B, V]
    bool, False) are masked to ``NEG_INF`` before top-k/top-p, so the
    renormalized distribution stays inside the grammar."""
    return sample_tokens(
        torch.where(allow, logits, torch.full_like(logits, NEG_INF)),
        generator, params)
