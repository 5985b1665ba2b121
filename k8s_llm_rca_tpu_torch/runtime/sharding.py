"""Sharding specs and per-rank shards: the port of
``k8s_llm_rca_tpu/runtime/sharding.py``.

The specs are derived by matching ``runtime/rules.py``'s rule tables
against a shape-only template of each model's tree, as in JAX:

- wq/wk/wv  [H, heads*d]  -> P(None, "model")   (column parallel: heads)
- wo        [heads*d, H]  -> P("model", None)   (row parallel: summed)
- w_gate/w_up [H, I]      -> P(None, "model")
- w_down    [I, H]        -> P("model", None)
- embedding/lm_head [V, H] -> P(None, "model")  (hidden sharded)
- MoE stacked experts take a leading "expert" axis.

JAX places the whole tree with ``NamedSharding`` and lets GSPMD split it
(``shard_pytree``).  Here every rank is its own process, so
``shard_params`` takes the FULL tree (tensors on any device, or the numpy
tree ``jax.tree.map(np.asarray, params)`` gives) and returns THIS rank's
block of every leaf on the rank's device.  A quantized leaf's scale takes
its weight's spec with every size-1 (reduced) dimension whole.  An int4
leaf whose packed last axis is split is first repacked group-wise
(``models.quant.repack_nibbles_grouped``: byte i of split-half packing
pairs columns i and i + C/2, which a contiguous column block does not
keep) and the rank's group is handed over as a plain ``QuantTensor4`` of
its own columns, as JAX's ``parallel/pipeline.py::_stage_local_params``
unwraps it inside a stage body.

Under ``FSDP_LAYOUT`` a spec entry "fsdp" (the non-TP matmul dim: hidden
for the blocks, vocab for the embedding and head) splits the leaf only
for STORAGE: the rank keeps its fsdp block and the model gathers the
whole leaf on use (``models/llama.py``).  So the TP block is taken first,
as above, and the fsdp block is a contiguous slice of its result: of the
packed bytes for int4 (no repack: the gather reassembles the bytes, it
never computes on a block's columns), and of ``q`` only for any
quantized leaf, whose scale stays whole on every rank (1/K of the
weight's bytes), so a leaf is one gather.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from k8s_llm_rca_tpu_torch.config import ModelConfig
from k8s_llm_rca_tpu_torch.models.quant import (
    QuantTensor, QuantTensor4, QuantTensor4Grouped, repack_nibbles_grouped,
)
from k8s_llm_rca_tpu_torch.runtime.mesh import axis_rank, axis_size
from k8s_llm_rca_tpu_torch.runtime.rules import (  # noqa: F401 (re-exports)
    FSDP_LAYOUT, TP_LAYOUT, P, PartitionSpec, SpecLayout,
    encoder_param_template, encoder_rules, kv_cache_specs,
    llama_param_template, llama_rules, map_with_names, match_partition_rules,
    paged_pool_specs, validate_layout,
)

PyTree = Any
_QUANT = (QuantTensor, QuantTensor4, QuantTensor4Grouped)


def llama_param_specs(cfg: ModelConfig,
                      layout: Optional[SpecLayout] = None) -> Dict[str, Any]:
    """PartitionSpec tree matching ``models/llama.init_params``, derived
    from ``rules.llama_rules`` (dense + MoE) under ``layout``."""
    return match_partition_rules(
        llama_rules(cfg, layout), llama_param_template(cfg), table="llama")


def encoder_param_specs(cfg,
                        layout: Optional[SpecLayout] = None) -> Dict[str, Any]:
    """PartitionSpec tree matching ``models/encoder.init_params``, derived
    from ``rules.encoder_rules`` under ``layout``."""
    return match_partition_rules(
        encoder_rules(cfg, layout), encoder_param_template(cfg),
        table="encoder")


def dim_parts(spec: PartitionSpec, mesh) -> Tuple[Tuple[int, int], ...]:
    """(parts, this rank's part) of each dimension ``spec`` names; a ``None``
    entry is (1, 0)."""
    return tuple((1, 0) if entry is None
                 else (axis_size(mesh, entry), axis_rank(mesh, entry))
                 for entry in spec)


def local_block(x: torch.Tensor, parts) -> torch.Tensor:
    """This rank's contiguous block of ``x`` (``parts`` from ``dim_parts``;
    trailing dimensions past it are whole), as a view."""
    for d, (n, i) in enumerate(parts):
        if n <= 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                             f"split into {n} equal parts")
        size = x.shape[d] // n
        x = x.narrow(d, i * size, size)
    return x


def _scale_parts(scale: torch.Tensor, parts):
    """A scale splits where its weight does, except its size-1 dims."""
    return tuple((n, i) if scale.shape[d] > 1 else (1, 0)
                 for d, (n, i) in enumerate(parts))


def _as_torch(leaf):
    """A leaf of the numpy carry-over as a CPU tensor (quantized ones as the
    port's quantized types); tensors pass through."""
    if isinstance(leaf, np.ndarray) or np.isscalar(leaf):
        from k8s_llm_rca_tpu_torch.models.llama import _tensor_from_numpy

        return _tensor_from_numpy(leaf, "cpu", None)
    if (getattr(leaf, "_fields", None) == ("q", "scale")
            and not isinstance(leaf, _QUANT)):
        from k8s_llm_rca_tpu_torch.models.llama import _quant_leaf

        return _quant_leaf(leaf, "cpu")
    return leaf


def leaf_block(leaf, parts, device=None):
    """The block ``parts`` (``dim_parts``) of one leaf on ``device``
    (default: where the leaf lives), contiguous.  A block that is the whole
    tensor on its device is the tensor itself (no copy).  An int4 leaf
    whose packed last axis splits is repacked group-wise first and its
    group handed over as a plain ``QuantTensor4``."""
    leaf = _as_torch(leaf)
    if leaf is None:
        return None

    def place(t, p):
        t = local_block(t, p)
        return t.to(device or t.device).contiguous()

    if isinstance(leaf, QuantTensor4Grouped):
        raise ValueError("shard_params takes the plain tree: a "
                         "QuantTensor4Grouped leaf is already a repack "
                         "for a fixed group count")
    if isinstance(leaf, QuantTensor4) and len(parts) == leaf.ndim \
            and parts[-1][0] > 1:
        # the packed axis splits: repack per group, hand over the group
        grouped = repack_nibbles_grouped(leaf, parts[-1][0])
        return QuantTensor4(q=place(grouped.q, parts),
                            scale=place(leaf.scale,
                                        _scale_parts(leaf.scale, parts)))
    if isinstance(leaf, (QuantTensor, QuantTensor4)):
        return type(leaf)(q=place(leaf.q, parts),
                          scale=place(leaf.scale,
                                      _scale_parts(leaf.scale, parts)))
    return place(leaf, parts)


FSDP_AXIS = FSDP_LAYOUT.fsdp


def fsdp_block(leaf, dim: int, n: int, i: int, device=None):
    """Block ``i`` of ``n`` along ``dim`` of one (TP-sharded) leaf, on
    ``device`` (default: where the leaf lives), as a tensor of its own: a
    contiguous slice of ``q`` (the packed bytes of an int4 leaf) and the
    whole scale for a quantized leaf.  ``n`` <= 1 is the leaf itself."""
    leaf = _as_torch(leaf)
    if n <= 1:
        return leaf_block(leaf, (), device)

    def cut(t):
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split into {n} equal fsdp blocks")
        size = t.shape[dim] // n
        part = t.narrow(dim, i * size, size)
        out = torch.empty(part.shape, dtype=t.dtype,
                          device=device or t.device)
        return out.copy_(part)

    if isinstance(leaf, (QuantTensor, QuantTensor4)):
        return type(leaf)(q=cut(leaf.q),
                          scale=leaf.scale.to(device or leaf.scale.device))
    return cut(leaf)


def shard_leaf(leaf, spec: PartitionSpec, mesh, device=None):
    """This rank's block of one leaf under ``spec`` (``leaf_block``); an
    "fsdp" entry takes the rank's fsdp block of its TP block
    (``fsdp_block``)."""
    dims = [d for d, e in enumerate(spec) if e == FSDP_AXIS]
    if any(isinstance(e, tuple) and FSDP_AXIS in e for e in spec) \
            or len(dims) > 1:
        raise ValueError(f"spec {spec!r}: the fsdp axis shards one "
                         f"dimension of a leaf, on its own")
    if not dims:
        return leaf_block(leaf, dim_parts(spec, mesh), device)
    tp = PartitionSpec(*(None if e == FSDP_AXIS else e for e in spec))
    return fsdp_block(leaf_block(leaf, dim_parts(tp, mesh)), dims[0],
                      axis_size(mesh, FSDP_AXIS), axis_rank(mesh, FSDP_AXIS),
                      device)


def shard_params(tree: PyTree, specs: PyTree, mesh, device=None) -> PyTree:
    """THIS rank's shard of every leaf of ``tree`` under ``specs`` (a spec
    tree of the same structure), on ``device`` (default: each leaf's own).
    Every rank calls it with the same full tree and gets its own blocks;
    nothing is communicated."""
    flat_specs = dict(_flatten_specs(specs))

    def one(name, leaf):
        if name not in flat_specs:
            raise ValueError(f"no spec for param '{name}'")
        return shard_leaf(leaf, flat_specs[name], mesh, device)

    return map_with_names(one, tree)


def stage_layers(params: PyTree, n_stages: int, stage: int) -> PyTree:
    """``params`` with its layer list cut to ``stage``'s run [stage * L/P,
    (stage + 1) * L/P) of ``n_stages`` (list slicing: nothing is copied).
    The other leaves stay as they are."""
    layers = params["layers"]
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers do not divide into "
                         f"{n_stages} stages")
    per = len(layers) // n_stages
    return {**params, "layers": layers[stage * per:(stage + 1) * per]}


def shard_stage_params(params: PyTree, cfg: ModelConfig, mesh,
                       stage_axis: str = "stage", device=None) -> PyTree:
    """THIS rank's params under pipeline parallelism on ``mesh``: the layers
    of its stage along ``stage_axis``, each sharded by
    ``llama_param_specs(cfg)`` over the mesh's other axes ("model" for TP,
    "expert" for EP), and the embedding, final norm and head whole
    (replicated: JAX computes them outside its stage ``shard_map``), all
    on ``device`` (default: each leaf's own).  ``params`` is the full tree,
    as ``shard_params`` takes it."""
    part = stage_layers(params, axis_size(mesh, stage_axis),
                        axis_rank(mesh, stage_axis))
    spec = llama_param_specs(cfg)["layers"][0]
    whole = {k: shard_leaf(v, PartitionSpec(), mesh, device)
             for k, v in part.items() if k != "layers"}
    return {**whole, "layers": shard_params(
        part["layers"], [spec] * len(part["layers"]), mesh, device)}


def _flatten_specs(specs, prefix: str = ""):
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _flatten_specs(v, f"{prefix}{k}/")
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from _flatten_specs(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], specs


# ---------------------------------------------------------------------------
# the model as one rank runs it
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class TensorParallel:
    """This rank's place on the TP axis ("model"): the mesh, the group its
    all-reduces and all-gathers run over, its size and this rank's index,
    and the model's head counts (all ranks together)."""

    mesh: Any
    group: Any
    size: int
    rank: int
    n_heads: int
    n_kv_heads: int


@dataclass(frozen=True, eq=False)
class ExpertParallel:
    """This rank's EP: the mesh its MoE MLPs dispatch over (experts over
    "expert", tokens over "data" x "expert") and ``drops``, a device
    counter of the tokens the dispatch has dropped past capacity."""

    mesh: Any
    drops: Optional[torch.Tensor] = None


@dataclass(frozen=True, eq=False)
class ContextParallel:
    """This rank's place on the CP axis: the group of the ranks that share
    its other coordinates (the decode merge's all-gather runs over it),
    its size and this rank's index (the page partition it owns)."""

    group: Any
    size: int
    rank: int


@dataclass(frozen=True, eq=False)
class PipelineParallel:
    """This rank's place on the PP axis: the group of its peers along the
    pipeline (the ranks that share its other coordinates: the activations'
    ring step and the last stage's broadcast run over it), the stage count,
    this rank's stage and the GPipe microbatch count."""

    group: Any
    size: int
    rank: int
    microbatches: int


@dataclass(frozen=True, eq=False)
class FullyShardedDP:
    """This rank's place on the FSDP axis: the group that gathers each
    weight on use (``models/llama.py``), its size and this rank's index
    (the block of every weight it stores)."""

    group: Any
    size: int
    rank: int


@dataclass(frozen=True)
class RankModelConfig(ModelConfig):
    """A ``ModelConfig`` as one rank of a mesh runs it: ``n_heads`` and
    ``n_kv_heads`` are this rank's share (so ``q_dim``/``kv_dim`` are its
    lanes and its paged pool holds only its heads), ``n_layers`` its
    stage's under PP (so its pool holds only its layers), and ``tp``/
    ``ep``/``cp``/``pp``/``fsdp`` carry the groups of the collectives the
    forward calls.  ``sp``: the TP miss prefills keep the residual stream
    split along the sequence (Megatron SP).  Everything else is the
    model's."""

    tp: Optional[TensorParallel] = None
    ep: Optional[ExpertParallel] = None
    cp: Optional[ContextParallel] = None
    pp: Optional[PipelineParallel] = None
    fsdp: Optional[FullyShardedDP] = None
    sp: bool = False


def rank_config(cfg: ModelConfig, tp_mesh=None, ep_mesh=None,
                device=None, cp_mesh=None, cp_seq_axis: str = "seq",
                pp_mesh=None, pp_stage_axis: str = "stage",
                pp_microbatches: Optional[int] = None, fsdp_mesh=None,
                sp: bool = False) -> RankModelConfig:
    """``cfg`` for this rank of ``tp_mesh`` (heads divided over "model";
    ``sp`` the sequence-parallel TP prefill), ``fsdp_mesh`` (every
    matmul weight stored as its block over "fsdp", gathered on use),
    ``ep_mesh`` (experts over "expert", tokens over "data" x "expert"; the
    drop counter on ``device``), ``cp_mesh`` (the sequence and the paged
    pool's pages over ``cp_seq_axis``) and ``pp_mesh`` (the layers over
    ``pp_stage_axis``, ``pp_microbatches`` microbatches a forward, one per
    stage by default).  Every rank must call it at the same point: it
    creates the process groups the forward uses, all of them now, since
    under PP the stages reach their collectives at different times."""
    from k8s_llm_rca_tpu_torch.runtime.mesh import axis_group

    base = {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(ModelConfig)}
    tp = ep = cp = pp = fsdp = None
    if fsdp_mesh is not None:
        fsdp = FullyShardedDP(axis_group(fsdp_mesh, FSDP_AXIS),
                              axis_size(fsdp_mesh, FSDP_AXIS),
                              axis_rank(fsdp_mesh, FSDP_AXIS))
    if tp_mesh is not None:
        n = axis_size(tp_mesh, "model")
        tp = TensorParallel(tp_mesh, axis_group(tp_mesh, "model"), n,
                            axis_rank(tp_mesh, "model"), cfg.n_heads,
                            cfg.n_kv_heads)
        base.update(n_heads=cfg.n_heads // n, n_kv_heads=cfg.n_kv_heads // n)
    if ep_mesh is not None:
        axis_group(ep_mesh, ("data", "expert"))     # the token groups
        ep = ExpertParallel(ep_mesh, torch.zeros((), dtype=torch.int64,
                                                 device=device))
    if cp_mesh is not None:
        cp = ContextParallel(axis_group(cp_mesh, cp_seq_axis),
                             axis_size(cp_mesh, cp_seq_axis),
                             axis_rank(cp_mesh, cp_seq_axis))
    if pp_mesh is not None:
        n = axis_size(pp_mesh, pp_stage_axis)
        pp = PipelineParallel(axis_group(pp_mesh, pp_stage_axis), n,
                              axis_rank(pp_mesh, pp_stage_axis),
                              pp_microbatches or n)
        base.update(n_layers=cfg.n_layers // n)
    return RankModelConfig(**base, tp=tp, ep=ep, cp=cp, pp=pp, fsdp=fsdp,
                           sp=bool(sp and tp is not None))
