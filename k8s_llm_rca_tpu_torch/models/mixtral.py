"""Mixtral-family sparse-MoE decoder LM: the port of
``k8s_llm_rca_tpu/models/mixtral.py``.

Architecturally this is the Llama stack with the MLP swapped for a
top-k-routed expert block, so the block lives in ``models/llama.py``
(``n_experts > 0`` switches it; ``llama._moe_mlp`` is the dense
soft-dispatch form, whose stacked-expert matmuls run the ekn kernels under
``fused_quant_matmul``).  This module re-exports the presets and the model
entry points, as the JAX module does.  Its expert-parallel serving assembly
(a (data, expert) mesh, expert-sharded weights, an engine dispatching
through all-to-all) is multi-GPU work and raises.

One card serves Mixtral-8x7B with int8 weights (~47 GB; bf16 is ~93 GB):
``init_params(MIXTRAL_8X7B, gen, tensor_transform=quantizing_transform())``
quantizes each weight as it is created.
"""

from __future__ import annotations

from k8s_llm_rca_tpu_torch.config import (  # noqa: F401
    MIXTRAL_8X7B, TINY_MOE, EngineConfig, ModelConfig,
)
from k8s_llm_rca_tpu_torch.models.llama import (  # noqa: F401
    init_params, params_from_numpy, prefill_kv,
)

_EP_ITEM = ("expert-parallel serving is not ported yet (ROADMAP Queue 1 "
            "item 10, multi-GPU); one card serves the dense soft-dispatch "
            "MoE through make_engine")


def build_ep_mesh(*args, **kwargs):
    """The (data, expert) mesh of EP serving: not ported."""
    raise NotImplementedError(f"build_ep_mesh: {_EP_ITEM}")


def shard_params_ep(*args, **kwargs):
    """Stacked expert weights over the "expert" axis: not ported."""
    raise NotImplementedError(f"shard_params_ep: {_EP_ITEM}")


def make_ep_engine(*args, **kwargs):
    """The expert-parallel serving engine: not ported."""
    raise NotImplementedError(f"make_ep_engine: {_EP_ITEM}")
