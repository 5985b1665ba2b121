"""Partition rules: regex over '/'-joined param names -> PartitionSpec; the
port of ``k8s_llm_rca_tpu/runtime/rules.py``.

- ``PartitionSpec`` stands in for ``jax.sharding.PartitionSpec``: a tuple
  with one entry per dimension, each a mesh axis name, a tuple of names
  (the dimension splits over their product, major to minor) or ``None``
  (not split).  ``P`` is its short name, as in JAX.
- ``SpecLayout`` maps the LOGICAL parallel axes (data/fsdp/tp/ep/cp/pp)
  to mesh axis names; the rules are written against the logical axes.
- ``match_partition_rules(rules, tree)`` joins each leaf's path with '/'
  ("layers/0/wq") and takes the FIRST rule whose regex ``re.search``-
  matches.  Scalars (ndim 0 or one element) replicate without a rule.  A
  param no rule matches is a ValueError naming it, never a silent
  replicate.
- The per-model rule tables (``llama_rules`` dense and MoE,
  ``encoder_rules``) and shape-only templates (plain shape tuples
  mirroring ``models/*.init_params``), so two-way coverage (every param
  matched, every rule used) is checked without a tensor.

Trees are the port's: nested dicts and lists whose leaves are tensors,
quantized weights (``QuantTensor``/``QuantTensor4``/``QuantTensor4Grouped``,
matched by their payload's shape), shape tuples or ``None``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

PyTree = Any

_LOGICAL_AXES = ("data", "fsdp", "tp", "ep", "cp", "pp")


class PartitionSpec(tuple):
    """One entry per dimension: a mesh axis name, a tuple of names, or
    ``None`` (``jax.sharding.PartitionSpec``'s meaning)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec
RuleTable = List[Tuple[str, PartitionSpec]]


@dataclass(frozen=True)
class SpecLayout:
    """Logical parallel axis -> mesh axis name (None = that mode unused).

    Defaults reproduce the historical layout: TP over "model", DP over
    "data", EP over "expert", CP over "seq", PP over "stage", and NO fsdp
    axis; ``SpecLayout(fsdp="fsdp")`` turns on parameter sharding along
    the mesh's "fsdp" axis."""

    data: Optional[str] = "data"
    fsdp: Optional[str] = None
    tp: Optional[str] = "model"
    ep: Optional[str] = "expert"
    cp: Optional[str] = "seq"
    pp: Optional[str] = "stage"

    def to_dict(self) -> Dict[str, Optional[str]]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Optional[str]]) -> "SpecLayout":
        """Inverse of to_dict.  Unknown keys are a loud error (a typo'd
        axis must not silently replicate)."""
        unknown = set(d) - set(_LOGICAL_AXES)
        if unknown:
            raise ValueError(
                f"SpecLayout.from_dict: unknown logical axes {sorted(unknown)}; "
                f"valid axes are {_LOGICAL_AXES}")
        base = cls()
        return cls(**{k: d.get(k, getattr(base, k)) for k in _LOGICAL_AXES})


TP_LAYOUT = SpecLayout()                     # the historical default
FSDP_LAYOUT = SpecLayout(fsdp="fsdp")        # fsdp (x tp when model > 1)


def _leaf_shape(x) -> Optional[Tuple[int, ...]]:
    """Shape for the scalar-replicate check; a quantized weight reports its
    payload's."""
    if x is None:
        return None
    q = getattr(x, "q", None)
    if q is not None and hasattr(x, "scale"):
        return tuple(q.shape)
    if isinstance(x, tuple):
        return tuple(x)
    shape = getattr(x, "shape", None)
    return tuple(shape) if shape is not None else ()


def flatten_with_names(tree: PyTree, prefix: str = ""
                       ) -> List[Tuple[str, Any]]:
    """(path, leaf) for every leaf, the path '/'-joined ("layers/0/wq")."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += flatten_with_names(v, f"{prefix}{k}/")
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_names(v, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def map_with_names(fn, tree: PyTree, prefix: str = "") -> PyTree:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_names(fn, v, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def match_partition_rules(rules: RuleTable, tree: PyTree, *,
                          table: str = "") -> PyTree:
    """PartitionSpec tree for ``tree``: the first rule whose regex matches
    the '/'-joined param path wins; scalars replicate; no match is a
    ValueError naming the param (no silent replicate default)."""

    def spec(name, leaf):
        shape = _leaf_shape(leaf)
        if shape is None:                     # optional/absent field
            return P()
        if len(shape) == 0 or math.prod(shape) == 1:
            return P()                        # scalars replicate
        for pattern, s in rules:
            if re.search(pattern, name):
                return s
        where = f" in rule table '{table}'" if table else ""
        raise ValueError(
            f"no partition rule matches param '{name}'{where}; add an "
            f"explicit rule — params are never silently replicated")

    return map_with_names(spec, tree)


def unused_rules(rules: RuleTable, tree: PyTree) -> List[str]:
    """Patterns in ``rules`` that match NO param in ``tree`` (the other
    direction of two-way coverage)."""
    names = []
    for name, leaf in flatten_with_names(tree):
        shape = _leaf_shape(leaf)
        if shape is None or len(shape) == 0 or math.prod(shape) == 1:
            continue
        names.append(name)
    return [pattern for pattern, _ in rules
            if not any(re.search(pattern, n) for n in names)]


# ---------------------------------------------------------------------------
# per-model rule tables: ordered, first match wins, so the MoE stacked-expert
# rules precede the dense MLP rules that would otherwise catch w_gate/w_up
# ---------------------------------------------------------------------------

def llama_rules(cfg, layout: Optional[SpecLayout] = None) -> RuleTable:
    """Rule table for ``models/llama.init_params`` (dense AND MoE:
    ``cfg.n_experts > 0`` prepends the stacked-expert rules).
    wq/wk/wv/w_gate/w_up column-parallel P(fsdp, tp), wo/w_down
    row-parallel P(tp, fsdp), embedding/lm_head hidden-sharded, norms
    replicated."""
    lo = layout or TP_LAYOUT
    f, t, e = lo.fsdp, lo.tp, lo.ep
    rules: RuleTable = []
    if cfg.n_experts > 0:
        rules += [
            (r"layers/\d+/router$", P(None, None)),
            # stacked experts [E, H, I] / [E, I, H]: experts over ep,
            # hidden over fsdp, the other matmul dim over tp
            (r"layers/\d+/(w_gate|w_up)$", P(e, f, t)),
            (r"layers/\d+/w_down$", P(e, t, f)),
        ]
    rules += [
        (r"layers/\d+/(attn_norm|mlp_norm)$", P(None)),
        (r"layers/\d+/(wq|wk|wv)$", P(f, t)),   # [H, heads*d] column-parallel
        (r"layers/\d+/wo$", P(t, f)),           # [heads*d, H] row-parallel
        (r"layers/\d+/(w_gate|w_up)$", P(f, t)),
        (r"layers/\d+/w_down$", P(t, f)),
        (r"^(embedding|lm_head)$", P(f, t)),    # [V, H]: vocab on fsdp
        (r"^final_norm$", P(None)),
    ]
    return rules


def encoder_rules(cfg=None, layout: Optional[SpecLayout] = None) -> RuleTable:
    """Rule table for ``models/encoder.init_params`` (the e5 tower): the
    decoder's TP layout; biases of sharded columns shard on the same axis;
    LayerNorms replicate; only word_embedding takes the fsdp axis."""
    lo = layout or TP_LAYOUT
    f, t = lo.fsdp, lo.tp
    return [
        (r"layers/\d+/(wq|wk|wv|w_in)$", P(f, t)),
        (r"layers/\d+/(bq|bk|bv|b_in)$", P(t)),
        (r"layers/\d+/(wo|w_out)$", P(t, f)),
        (r"layers/\d+/(bo|b_out)$", P(None)),
        (r"layers/\d+/(attn_ln_w|attn_ln_b|mlp_ln_w|mlp_ln_b)$", P(None)),
        (r"^word_embedding$", P(f, t)),
        (r"^(position_embedding|type_embedding)$", P(None, t)),
        (r"^(embed_ln_w|embed_ln_b)$", P(None)),
    ]


# ---------------------------------------------------------------------------
# shape-only templates mirroring models/*.init_params
# ---------------------------------------------------------------------------

def llama_param_template(cfg) -> Dict[str, Any]:
    """Shape tuples with the structure of ``models/llama.init_params``."""
    h, q, kv, inter = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                       cfg.intermediate_size)
    layer: Dict[str, Any] = {
        "attn_norm": (h,), "mlp_norm": (h,),
        "wq": (h, q), "wk": (h, kv), "wv": (h, kv), "wo": (q, h),
    }
    if cfg.n_experts > 0:
        e = cfg.n_experts
        layer.update({"router": (h, e), "w_gate": (e, h, inter),
                      "w_up": (e, h, inter), "w_down": (e, inter, h)})
    else:
        layer.update({"w_gate": (h, inter), "w_up": (h, inter),
                      "w_down": (inter, h)})
    tmpl: Dict[str, Any] = {
        "embedding": (cfg.vocab_size, h),
        "final_norm": (h,),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        tmpl["lm_head"] = (cfg.vocab_size, h)
    return tmpl


def encoder_param_template(cfg) -> Dict[str, Any]:
    """Shape tuples with the structure of ``models/encoder.init_params``."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    layer = {
        "wq": (h, h), "bq": (h,), "wk": (h, h), "bk": (h,),
        "wv": (h, h), "bv": (h,), "wo": (h, h), "bo": (h,),
        "attn_ln_w": (h,), "attn_ln_b": (h,),
        "w_in": (h, inter), "b_in": (inter,),
        "w_out": (inter, h), "b_out": (h,),
        "mlp_ln_w": (h,), "mlp_ln_b": (h,),
    }
    return {
        "word_embedding": (cfg.vocab_size, h),
        "position_embedding": (cfg.max_seq_len, h),
        "type_embedding": (2, h),
        "embed_ln_w": (h,),
        "embed_ln_b": (h,),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
    }


# ---------------------------------------------------------------------------
# serving state
# ---------------------------------------------------------------------------

def kv_cache_specs(layout: Optional[SpecLayout] = None) -> PartitionSpec:
    """Contiguous KV cache [L, B, S, n_kv*d]: batch on the data axis, the
    merged kv-head*head_dim axis on tp (whole heads when tp divides
    n_kv)."""
    lo = layout or TP_LAYOUT
    return P(None, lo.data, None, lo.tp)


def paged_pool_specs(layout: Optional[SpecLayout] = None
                     ) -> Tuple[PartitionSpec, PartitionSpec]:
    """Paged KV pool [L, n_pages, page, kv]: the merged kv axis over tp,
    pages replicated (page ids are host state).  Returns (pool_spec,
    scale_spec); the scale pools [L, n_pages, page] replicate."""
    lo = layout or TP_LAYOUT
    return P(None, None, None, lo.tp), P(None, None, None)


# ---------------------------------------------------------------------------
# layout pre-flight
# ---------------------------------------------------------------------------

def validate_layout(layout: SpecLayout, mesh,
                    peers: Sequence[Any] = ()) -> SpecLayout:
    """Cross-check a SpecLayout against the mesh before any weight is
    placed: a logical axis mapped to an axis the mesh lacks, or a
    non-default mapping onto a size-1 axis, is a named ValueError, as are
    ``peers`` (other tiers' meshes) sharing a rank with ``mesh``.  Returns
    the layout."""
    if layout is None:
        layout = TP_LAYOUT
    names = tuple(mesh.mesh_dim_names)
    default = SpecLayout()
    for logical, axis in layout.to_dict().items():
        if axis is None:
            continue
        if axis not in names:
            raise ValueError(
                f"SpecLayout.{logical} maps to mesh axis '{axis}' which is "
                f"undefined on a mesh with axes {names}")
        if (axis != getattr(default, logical)
                and int(mesh.mesh.shape[names.index(axis)]) <= 1):
            raise ValueError(
                f"SpecLayout.{logical} maps to mesh axis '{axis}' of size 1: "
                f"the layout requests sharding that cannot happen — widen "
                f"the axis or drop it from the layout")
    mine = set(mesh.mesh.flatten().tolist())
    for peer in peers:
        if peer is mesh:
            continue
        overlap = mine & set(peer.mesh.flatten().tolist())
        if overlap:
            raise ValueError(
                f"tier submeshes overlap on device ids {sorted(overlap)}: "
                f"per-tier layouts require disjoint device sets")
    return layout
