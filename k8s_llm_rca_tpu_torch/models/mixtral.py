"""Mixtral-family sparse-MoE decoder LM: the port of
``k8s_llm_rca_tpu/models/mixtral.py``.

Architecturally this is the Llama stack with the MLP swapped for a
top-k-routed expert block, so the block lives in ``models/llama.py``
(``n_experts > 0`` switches it; ``llama._moe_mlp`` is the dense
soft-dispatch form, whose stacked-expert matmuls run the ekn kernels under
``fused_quant_matmul``).  This module re-exports the presets and the model
entry points, as the JAX module does, and holds the expert-parallel
serving assembly: the (data, expert) mesh, this rank's shard of the
stacked expert weights, and an engine (paged or contiguous) whose every
MoE MLP (prefill and decode) dispatches through the all-to-all of
``parallel/moe.py``.
Every rank of the process group calls these with the same arguments.

One card serves Mixtral-8x7B with int8 weights (~47 GB; bf16 is ~93 GB):
``init_params(MIXTRAL_8X7B, gen, tensor_transform=quantizing_transform())``
quantizes each weight as it is created.
"""

from __future__ import annotations

from typing import Optional

from k8s_llm_rca_tpu_torch.config import (  # noqa: F401
    MIXTRAL_8X7B, TINY_MOE, EngineConfig, MeshConfig, ModelConfig,
)
from k8s_llm_rca_tpu_torch.models.llama import (  # noqa: F401
    init_params, params_from_numpy, prefill_kv,
)

def build_ep_mesh(n_expert_shards: int, n_data: int = 1, n_seq: int = 1,
                  device=None):
    """The (data, expert) mesh of EP serving over the ranks of the default
    process group: ``n_expert_shards`` ranks hold disjoint expert subsets,
    ``n_data`` replicas shard the token batch.  ``n_seq`` > 1 (the CP x EP
    composition) is not ported on either engine."""
    from k8s_llm_rca_tpu_torch.engine.engine import mesh_item
    from k8s_llm_rca_tpu_torch.runtime.mesh import build_mesh

    if n_seq > 1:
        raise NotImplementedError(
            f"build_ep_mesh(n_seq > 1): CP x EP is not ported yet "
            f"({mesh_item(9)})")
    return build_mesh(MeshConfig(data=n_data, expert=n_expert_shards),
                      device=device)


def shard_params_ep(cfg: ModelConfig, params, mesh, device=None):
    """This rank's shard: stacked expert weights over the "expert" axis,
    everything else as ``runtime.sharding.llama_param_specs`` places it
    (whole on a mesh whose "model" axis is 1)."""
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params,
    )

    return shard_params(params, llama_param_specs(cfg), mesh, device)


def make_ep_engine(cfg: ModelConfig, engine_cfg: EngineConfig, params,
                   tokenizer, n_expert_shards: Optional[int] = None,
                   n_data: int = 1, device=None, mesh=None, **engine_kw):
    """Expert-parallel serving engine on this rank (``device``: ``None`` =
    the card).  Builds the (data, expert) mesh over the process group (or
    takes ``mesh``), shards the FULL ``params`` to this rank's experts on
    ``device``, and returns the engine (paged when ``engine_cfg.paged``,
    else the contiguous ``InferenceEngine``) whose MoE MLPs run the
    all-to-all dispatch.  ``n_expert_shards`` defaults to every rank."""
    import torch.distributed as dist

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.utils.device import resolve_device

    if cfg.n_experts <= 0:
        raise ValueError(f"{cfg.name} is not an MoE config")
    device = resolve_device(device)
    if mesh is None:
        if n_expert_shards is None:
            n_expert_shards = dist.get_world_size() // n_data
        mesh = build_ep_mesh(n_expert_shards, n_data, device=device)
    sharded = shard_params_ep(cfg, params, mesh, device)
    return make_engine(cfg, engine_cfg, sharded, tokenizer, device,
                       ep_mesh=mesh, **engine_kw)
