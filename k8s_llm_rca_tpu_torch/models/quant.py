"""Weight access shims of ``k8s_llm_rca_tpu/models/quant.py``, bf16 subset.

Every weight read of the model goes through ``dq`` (matmul operand) or
``gather_rows`` (embedding lookup), as in the JAX package, so quantized
weights (``QuantTensor``/``QuantTensor4``, ROADMAP Queue 1 item 2) plug in here
later.  This slice serves plain tensors only: ``dq`` is the identity and
anything else raises.
"""

from __future__ import annotations

from typing import Any

import torch


def _plain(w: Any, op: str) -> torch.Tensor:
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"{op} of a {type(w).__name__}: quantized weights are not ported "
            f"yet (ROADMAP Queue 1 item 2, quantized paths)")
    return w


def dq(w: Any) -> torch.Tensor:
    """Plain weights pass through."""
    return _plain(w, "dq")


def gather_rows(w: Any, idx: torch.Tensor) -> torch.Tensor:
    """Row gather (embedding lookup)."""
    return _plain(w, "gather_rows")[idx.long()]
