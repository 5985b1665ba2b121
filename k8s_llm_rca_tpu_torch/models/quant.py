"""Weight-only int8/int4 quantization (per-channel symmetric) and the
per-token KV quantization of the paged pool.

The port of ``k8s_llm_rca_tpu/models/quant.py`` (plus ``_quantize_kv`` and
``_dequant_layer`` of ``k8s_llm_rca_tpu/models/llama.py``).  The stored
tensors are bit-identical with the JAX package's: the same int8 bytes, the
same split-half nibble packing and the same scale bits, so a JAX tree
carries across (``models.llama.params_from_numpy``) and a tree quantized
here equals one quantized there.

- ``QuantTensor``: int8 ``q`` of the weight's shape plus a broadcast-ready
  per-channel ``scale`` (keepdims shape, compute dtype).
- ``QuantTensor4``: two signed 4-bit values per int8 byte along the LAST
  axis, split-half (byte i holds column i in its low nibble and column
  i + C/2 in its high nibble); ``scale`` keeps the logical channel size.

Every weight read of the model goes through ``dq`` (matmul operand) or
``gather_rows`` (embedding lookup), which pass plain tensors through, so
quantized and full-precision params run the same model code; under
``ModelConfig.fused_quant_matmul`` the matmuls go to ``ops.quant_matmul``
instead.  Both take the dtype of the consumer: inside the JAX engine's
jitted steps XLA keeps ``q * scale`` at f32 precision when an f32
activation consumes it (excess precision), and rounds it to bf16 only for
a bf16 one; ``dq(w, x.dtype)`` computes exactly that.

- ``QuantTensor4Grouped``: int4 whose packed axis is split-half WITHIN
  each contiguous column group (``repack_nibbles_grouped``), the layout
  that lets a column shard of an int4 weight be a plain ``QuantTensor4``
  of its own columns.  Only a shard is meaningful: ``dq``/``gather_rows``
  refuse the whole tensor (``_reject_grouped``), and
  ``runtime/sharding.py`` hands each rank its group as a ``QuantTensor4``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch


class QuantTensor(NamedTuple):
    """int8 weight + broadcast-ready per-channel scale (keepdims shape)."""

    q: torch.Tensor        # int8, original shape
    scale: torch.Tensor    # compute dtype, 1s except the channel axis

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self):
        return self.q.dim()


class QuantTensor4(NamedTuple):
    """Nibble-packed int4 weight + per-channel scale (logical channel size)."""

    q: torch.Tensor        # int8, logical shape with the last dim halved
    scale: torch.Tensor    # compute dtype, 1s except the channel axes

    @property
    def shape(self):
        return (*self.q.shape[:-1], self.q.shape[-1] * 2)

    @property
    def ndim(self):
        return self.q.dim()


class QuantTensor4Grouped(NamedTuple):
    """A ``repack_nibbles_grouped`` result: nibble-packed int4 whose packed
    axis is split-half WITHIN each contiguous column group, not globally.
    The distinct type is the guard: a global ``dq``/``gather_rows`` of it
    raises instead of interleaving columns wrongly."""

    q: torch.Tensor        # int8, grouped split-half packing, last dim halved
    scale: torch.Tensor    # compute dtype, 1s except the channel axes

    @property
    def shape(self):
        return (*self.q.shape[:-1], self.q.shape[-1] * 2)

    @property
    def ndim(self):
        return self.q.dim()


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], even last dim -> packed int8, last dim / 2
    (split-half: byte i = q[..., i] low, q[..., i + C/2] high)."""
    half = q.shape[-1] // 2
    lo, hi = q[..., :half], q[..., half:]
    return ((hi << 4) | (lo & 0x0F)).to(torch.int8)


def _unpack_nibbles(p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_pack_nibbles``: packed int8 -> sign-extended int8."""
    lo = p & 0x0F
    lo = torch.where(lo >= 8, lo - 16, lo)          # sign-extend low nibble
    hi = p >> 4                                      # arithmetic: sign-extends
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def quantize(w: torch.Tensor, axis=-1,
             compute_dtype: Optional[torch.dtype] = None,
             bits: int = 8) -> "QuantTensor | QuantTensor4":
    """Symmetric per-channel int8/int4: scale = max|w| / qmax reduced over
    every axis NOT in ``axis`` (an int or a tuple of surviving channel
    axes).  int4 uses [-7, 7] (never -8).  ``q`` is computed with the f32
    scale; the stored scale is then cast to ``compute_dtype`` (default: the
    weight's dtype), exactly as in JAX."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    compute_dtype = compute_dtype or w.dtype
    keep = {a % w.dim() for a in ((axis,) if isinstance(axis, int) else axis)}
    reduce_axes = tuple(i for i in range(w.dim()) if i not in keep)
    wf = w.float()
    amax = wf.abs().amax(dim=reduce_axes, keepdim=True)
    qmax = 127.0 if bits == 8 else 7.0
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    if bits == 4:
        if w.shape[-1] % 2:
            raise ValueError(f"int4 packing needs an even last dim, got "
                             f"{tuple(w.shape)}")
        return QuantTensor4(q=_pack_nibbles(q), scale=scale.to(compute_dtype))
    return QuantTensor(q=q, scale=scale.to(compute_dtype))


def repack_nibbles_grouped(w: QuantTensor4, groups: int
                           ) -> "QuantTensor4 | QuantTensor4Grouped":
    """Re-pack a split-half ``QuantTensor4`` so each of ``groups``
    CONTIGUOUS column groups is split-half packed within the group ("shard
    first, pack second"): after the packed last axis splits into
    ``groups`` equal blocks, each block unpacks to exactly its group's
    columns, in order, and the per-column scale's matching block goes with
    it.  Global split-half packing does not have this property (byte i
    pairs columns i and i + C/2).  ``groups`` <= 1 returns ``w``."""
    if groups <= 1:
        return w
    c = w.shape[-1]                               # logical column count
    if c % (2 * groups):
        raise ValueError(
            f"int4 per-shard packing needs the channel dim {c} divisible "
            f"by 2*groups={2 * groups} (each shard packs its own "
            f"split-half pairs)")
    unpacked = _unpack_nibbles(w.q)               # int8 [..., C]
    g = c // groups
    grouped = unpacked.reshape(*unpacked.shape[:-1], groups, g)
    packed = _pack_nibbles(grouped)               # [..., groups, g/2]
    return QuantTensor4Grouped(q=packed.reshape(*w.q.shape), scale=w.scale)


def _reject_grouped(w: Any, op: str) -> None:
    if isinstance(w, QuantTensor4Grouped):
        raise ValueError(
            f"{op} on a grouped-repacked int4 tensor "
            f"(QuantTensor4Grouped {tuple(w.q.shape)}): its packed axis is "
            f"split-half WITHIN each shard group, so a global unpack "
            f"interleaves columns wrongly.  Consume it shard-locally "
            f"(runtime.sharding.shard_params hands each rank its group as "
            f"a plain QuantTensor4) or keep the plain QuantTensor4 layout")


def _dequant_dtype(scale: torch.Tensor, dtype) -> torch.dtype:
    return scale.dtype if dtype is None else torch.promote_types(scale.dtype,
                                                                 dtype)


def dq(w: Any, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dequantize a QuantTensor/QuantTensor4 in the scale's dtype (JAX's
    ``dq``), or, for a consumer of ``dtype``, in its promotion with the
    scale's; plain tensors pass through.  A grouped-repacked int4 tensor
    raises (its layout is only meaningful per shard)."""
    _reject_grouped(w, "global dq()")
    if isinstance(w, (QuantTensor, QuantTensor4)):
        rt = _dequant_dtype(w.scale, dtype)
        q = _unpack_nibbles(w.q) if isinstance(w, QuantTensor4) else w.q
        return q.to(rt) * w.scale.to(rt)
    return w


def gather_rows(w: Any, idx: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Row gather (embedding lookup) without dequantizing the whole table:
    gathers the int8 rows and their row scales, dequantized as ``dq``
    does.  A quantized table must have per-row scales (``axis=0``); a
    grouped-repacked one raises."""
    _reject_grouped(w, "global gather_rows()")
    idx = idx.long()
    if isinstance(w, (QuantTensor, QuantTensor4)):
        if w.scale.shape[0] != w.q.shape[0]:
            raise ValueError(f"gather_rows needs per-row scales (axis=0 "
                             f"quantization); got scale "
                             f"{tuple(w.scale.shape)} for table "
                             f"{tuple(w.q.shape)}")
        rt = _dequant_dtype(w.scale, dtype)
        rows = w.q[idx]
        if isinstance(w, QuantTensor4):
            rows = _unpack_nibbles(rows)
        return rows.to(rt) * w.scale[idx].to(rt)
    return w[idx]


# weights quantized per row (axis 0): their channel axis is the vocab row
# (any key containing one of these names)
_ROW_QUANT = ("embedding", "lm_head")


def quantize_params(params: Any, compute_dtype=torch.bfloat16,
                    bits: int = 8) -> Any:
    """Quantize every floating rank>=2 weight of a param tree (nested dicts
    and lists).  1-D tensors and integer tensors stay as they are;
    ``embedding``/``lm_head`` get per-row scales, stacked [E, K, N] weights
    per-(expert, column) scales, everything else per-output-column scales.
    Already-quantized leaves pass through at the same width."""
    def walk(node, path):
        if isinstance(node, (QuantTensor, QuantTensor4)):
            have = 4 if isinstance(node, QuantTensor4) else 8
            if have != bits:
                raise ValueError(
                    f"param at {'/'.join(path)} is already int{have}-"
                    f"quantized; re-quantizing to int{bits} is not supported "
                    f"(dequantize first)")
            return node
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        if (not isinstance(node, torch.Tensor) or node.dim() < 2
                or not node.is_floating_point()):
            return node
        # a key CONTAINING a row-quant name (JAX matches against the
        # path's repr): the encoder's word/position/type embeddings too
        if any(name in key for key in path for name in _ROW_QUANT):
            axis = 0
        elif node.dim() >= 3:
            axis = (0, -1)
        else:
            axis = -1
        return quantize(node, axis=axis, compute_dtype=compute_dtype,
                        bits=bits)

    return walk(params, ())


def quantizing_transform(compute_dtype=torch.bfloat16, bits: int = 8):
    """``tensor_transform`` for ``llama.init_params``: quantize every matmul
    weight as it is created.  The ``axis`` hint selects per-row (embedding,
    lm head) or per-column scales."""
    def transform(w, axis=-1):
        return quantize(w, axis=axis, compute_dtype=compute_dtype, bits=bits)

    return transform


# --------------------------------------------------------------------------
# KV quantization (one scale per token), the paged pool's storage
# --------------------------------------------------------------------------


def quantize_kv(kv: torch.Tensor, packed: bool = False, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 (or split-half int4 when ``packed``) of
    ``llama._quantize_kv``: kv [..., kv_dim] -> (int8 [..., kv_dim] or
    packed [..., kv_dim/2], scale [...] in kv's dtype).  ``q`` uses the f32
    scale; the returned scale is cast to kv's dtype, as in JAX.

    ``group`` (the TP group, JAX's ``axis_name``): each rank holds only its
    lanes of the row; the max of the local amax over the group is the
    FULL-row scale, so every rank quantizes its lanes as the unsharded
    path quantizes the whole row and writes the same scale."""
    qmax = 7.0 if packed else 127.0
    kf = kv.float()
    amax = kf.abs().amax(dim=-1)
    if group is not None:
        from k8s_llm_rca_tpu_torch.runtime.mesh import all_reduce_max

        amax = all_reduce_max(amax, group)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(kf / scale[..., None]), -qmax,
                    qmax).to(torch.int8)
    if packed:
        q = _pack_nibbles(q)
    return q, scale.to(kv.dtype)


def dequant_kv(kv: torch.Tensor, scale: Optional[torch.Tensor], dtype,
               packed: bool = False) -> torch.Tensor:
    """``llama._dequant_layer``: [..., kv_dim] int8 (or [..., kv_dim/2]
    packed) + [...] scale -> ``dtype``, as ``convert * scale`` in
    ``dtype``; identity when ``scale`` is None."""
    if scale is None:
        return kv
    if packed:
        kv = _unpack_nibbles(kv)
    return kv.to(dtype) * scale[..., None].to(dtype)
