"""Llama-family decoder LM in PyTorch: the port of ``k8s_llm_rca_tpu/models/llama.py``.

Parameters are a plain nested dict with the JAX tree's names and layouts
(``embedding`` [V, H], ``layers[i]`` with ``attn_norm``, ``mlp_norm``,
``wq``, ``wk``, ``wv``, ``wo``, ``w_gate``, ``w_up``, ``w_down`` stored
[in, out] for ``x @ w``, ``final_norm``, and ``lm_head`` [V, H] unless
tied), so ``params_from_numpy`` carries a JAX tree across unchanged,
quantized leaves (``models.quant.QuantTensor``/``QuantTensor4``) included.
Projections, the MLP and the lm head are ``x @ dq(w)`` in ``torch.matmul``,
or, under ``ModelConfig.fused_quant_matmul``, the ``ops.quant_matmul``
shims (the int8/int4 CUDA kernels on the card); prefill attention is
``ops.flash_attention`` (the CUDA kernel on the card, its plain version on
the CPU).  ``n_experts > 0`` (Mixtral) swaps the MLP for the dense
soft-dispatch MoE block (``_moe_mlp``): ``router`` [H, E] and stacked
``w_gate``/``w_up`` [E, H, I], ``w_down`` [E, I, H], every expert run on
every token and the top-k router weights zeroing the rest, as in JAX.

Under a mesh every rank runs the same functions on its own shard with a
``runtime.sharding.RankModelConfig`` (this rank's head counts, the
collectives' groups), the manual-TP bodies of JAX's
``parallel/pipeline.py`` (``_block_prefill_tp``, ``_decode_finish_tp``):
column-parallel wq/wk/wv/w_gate/w_up give the rank's heads and MLP
columns, row-parallel wo/w_down end in one sum all-reduce each, the
hidden-sharded embedding in one all-gather along hidden, the lm head over
the rank's hidden slice in a sum all-reduce of the logits, and quantized
KV takes the max over the group so every rank writes the full-row scale.
With ``ep`` the MoE MLP dispatches through ``parallel.moe``'s all-to-all.

With ``fsdp`` (``RankModelConfig.fsdp``; alone or with ``tp``) a rank
stores only its block of each matmul weight (``runtime.sharding``: the
non-TP dim, hidden for the blocks, vocab for the embedding and head) and
gathers the whole weight (its TP shard of it) into one buffer over the
fsdp group just before the matmul that reads it (``_whole``), so every
matmul runs on the bytes and shapes of the unsharded model and the gathered
weight is dead after it.  A forward calls exactly ``7 * n_layers + 1``
``all_gather_into`` (wq, wk, wv, wo, w_gate, w_up, w_down a layer, the
stacked experts in place of the MLP's for MoE; the head once; the router
and the norms are whole) and one sum all-reduce for the embedding: each
rank looks up the rows of its vocab block, zeros the others, and the sum
over the group is the lookup (exact: one rank adds each row).

With ``sp`` (Megatron sequence parallelism, TP only) the miss prefills
(``prefill_kv``, ``_prefill_batch_kv``) keep the residual stream [B, S/t,
H] per rank: norms on the rank's tokens, one all-gather along the
sequence before each column-parallel pair (q/k/v, gate/up), a
reduce-scatter along the sequence after each row-parallel matmul (wo,
w_down) in place of the sum all-reduce, and one gather of the rows the
logits need: per dispatch ``2 * n_layers + 1`` ``all_gather_into`` and
``2 * n_layers`` ``reduce_scatter_sum``, and 1 sum all-reduce (the
logits).

With ``cp`` (context parallelism) a rank's contiguous cache holds its block
of every slot's sequence, S/P positions: ``prefill_cp`` keeps that block of
``prefill_kv_cp``'s K/V, a decode step writes each new token on the rank
whose block holds its position only, and every rank attends over its own
block with the log-sum-exp, merged over the seq group by one all-gather a
layer (``_cp_decode_attention``).  Under PP a rank holds one stage's
layers: the whole-stack entry points refuse its config, and
``parallel/pipeline.py``'s ``llama_pp_*`` run the stages.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from k8s_llm_rca_tpu_torch.config import ModelConfig
from k8s_llm_rca_tpu_torch.models.quant import (
    QuantTensor, QuantTensor4, QuantTensor4Grouped, dequant_kv, gather_rows,
    quantize_kv,
)
from k8s_llm_rca_tpu_torch.ops.attention import decode_attention_multi
from k8s_llm_rca_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_sharded,
)
from k8s_llm_rca_tpu_torch.ops.quant_matmul import (
    qmm, qmm_experts, qmm_head, quant_matmul_experts_plain,
    quant_matmul_head_plain, quant_matmul_plain,
)
from k8s_llm_rca_tpu_torch.ops.norms import rms_norm
from k8s_llm_rca_tpu_torch.ops.paged_attention import (
    attention_lse_plain, merge_partials,
)
from k8s_llm_rca_tpu_torch.ops.rope import apply_rope, rope_frequencies
from k8s_llm_rca_tpu_torch.runtime.mesh import (
    all_gather, all_gather_into, all_reduce_sum, reduce_scatter_sum,
)
from k8s_llm_rca_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r} (float32 or bfloat16)")
    return _DTYPES[name]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, tensor_transform=None) -> Params:
    """Random init (scaled normal, the JAX init's scales) from ``generator``,
    which must live on ``device`` (``None`` = the card).

    ``tensor_transform`` (e.g. ``models.quant.quantizing_transform``) is
    applied to every matmul weight as it is created, with ``axis=0`` for
    ``embedding``/``lm_head`` and ``axis=(0, -1)`` for stacked experts, so
    a quantized model never holds its full-precision weights all at once
    (Mixtral-8x7B is ~93 GB in bf16, ~47 GB in int8)."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    h, q, kv, inter = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                       cfg.intermediate_size)
    scale = 1.0 / math.sqrt(h)
    out_scale = scale / math.sqrt(2 * cfg.n_layers)

    def dense(shape, s, axis=-1):
        # scaled in place: one f32 copy of the weight at a time
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32).mul_(s).to(dtype)
        return w if tensor_transform is None else tensor_transform(w,
                                                                   axis=axis)

    def ones():
        return torch.ones((h,), device=device, dtype=dtype)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": ones(), "mlp_norm": ones(),
            "wq": dense((h, q), scale), "wk": dense((h, kv), scale),
            "wv": dense((h, kv), scale), "wo": dense((q, h), out_scale),
        }
        if cfg.n_experts > 0:
            e, stacked = cfg.n_experts, (0, -1)
            layer.update({
                "router": dense((h, e), scale),
                "w_gate": dense((e, h, inter), scale, axis=stacked),
                "w_up": dense((e, h, inter), scale, axis=stacked),
                "w_down": dense((e, inter, h), out_scale, axis=stacked)})
        else:
            layer.update({
                "w_gate": dense((h, inter), scale),
                "w_up": dense((h, inter), scale),
                "w_down": dense((inter, h), out_scale)})
        layers.append(layer)
    params: Params = {"embedding": dense((cfg.vocab_size, h), 1.0, axis=0),
                      "final_norm": ones(), "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((cfg.vocab_size, h), scale, axis=0)
    return params


def _tensor_from_numpy(a, device, dtype: Optional[torch.dtype]
                       ) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # bit-exact through the 16-bit pattern (no ml_dtypes needed)
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def _quant_leaf(tree, device) -> "QuantTensor | QuantTensor4":
    """A JAX ``QuantTensor``/``QuantTensor4`` (a NamedTuple of numpy arrays
    under ``jax.tree.map``), recognised by its fields, carried across byte
    for byte.  int4 is told by the class name or, for per-column scales, by
    the packed axis being half the scale's."""
    kind = type(tree).__name__
    q = _tensor_from_numpy(tree.q, device, None)
    scale = _tensor_from_numpy(tree.scale, device, None)
    if kind == "QuantTensor4Grouped":
        return QuantTensor4Grouped(q=q, scale=scale)
    packed = kind == "QuantTensor4" or (scale.shape[-1] > 1 and
                                        scale.shape[-1] == 2 * q.shape[-1])
    return (QuantTensor4 if packed else QuantTensor)(q=q, scale=scale)


def params_from_numpy(tree, device=None,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """Carry a JAX parameter tree across: ``tree`` is
    ``jax.tree.map(np.asarray, params)``; every leaf becomes a tensor on
    ``device`` (``None`` = the card) in ``dtype`` (``None`` keeps the
    leaf's).  bf16 leaves arrive bit-exact; quantized leaves keep their
    int8 bytes and scale bits whatever ``dtype``."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if getattr(tree, "_fields", None) == ("q", "scale"):
        return _quant_leaf(tree, device)
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return _tensor_from_numpy(tree, device, dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _w_mm(cfg: ModelConfig, x: torch.Tensor, w,
          fsdp_dim: Optional[int] = None) -> torch.Tensor:
    """Every weight matmul: ``x @ dq(w)``, or the fused kernel shim under
    ``cfg.fused_quant_matmul``.  ``fsdp_dim``: the dim along which ``w`` is
    stored fsdp-sharded (gathered whole first under ``cfg.fsdp``)."""
    if fsdp_dim is not None:
        w = _whole(cfg, w, fsdp_dim)
    if cfg.fused_quant_matmul:
        return qmm(x, w)
    return quant_matmul_plain(x, w)


def _tp(cfg: ModelConfig):
    """The rank's TP axis (``RankModelConfig.tp``), None without one."""
    return getattr(cfg, "tp", None)


def _fsdp(cfg: ModelConfig):
    """The rank's FSDP axis (``RankModelConfig.fsdp``), None without one."""
    return getattr(cfg, "fsdp", None)


def _whole(cfg: ModelConfig, w, dim: int):
    """The whole weight (the rank's TP shard of it) from the rank's fsdp
    block along ``dim``: one ``all_gather_into`` of ``q`` (int4 its packed
    bytes) or of the tensor; a quantized leaf keeps its whole scale.
    Without ``cfg.fsdp`` it is ``w``."""
    fsdp = _fsdp(cfg)
    if fsdp is None:
        return w
    if isinstance(w, (QuantTensor, QuantTensor4)):
        return type(w)(q=all_gather_into(w.q, fsdp.group, dim),
                       scale=w.scale)
    return all_gather_into(w, fsdp.group, dim)


def kv_group(cfg: ModelConfig):
    """The group whose max gives a quantized KV row its full-row scale
    (the TP group; None unsharded)."""
    tp = _tp(cfg)
    return None if tp is None else tp.group


def _tp_sum(cfg: ModelConfig, out: torch.Tensor, sp: bool = False
            ) -> torch.Tensor:
    """Under TP the sum of the ranks' partial ``out`` [B, S, H] (JAX's
    ``psum``); with ``sp`` the rank's block of it along the sequence
    (reduce-scatter)."""
    tp = _tp(cfg)
    if tp is None:
        return out
    if sp:
        return reduce_scatter_sum(out, tp.group, dim=1)
    return all_reduce_sum(out, tp.group)


def _row_mm(cfg: ModelConfig, x: torch.Tensor, w, sp: bool = False
            ) -> torch.Tensor:
    """A row-parallel matmul (wo, w_down; fsdp-stored along its output
    dim): under TP each rank's partial product over its rows, summed over
    the group (``_tp_sum``)."""
    return _tp_sum(cfg, _w_mm(cfg, x, w, fsdp_dim=-1), sp)


def embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor
          ) -> torch.Tensor:
    """The embedding lookup in the model dtype; under TP the table is
    hidden-sharded, each rank gathers its slice and one all-gather along
    hidden rebuilds the rows.  Under FSDP the table is vocab-sharded: each
    rank looks up the tokens of its block, zeros the others, and one sum
    over the fsdp group gives every rank the rows."""
    dtype = torch_dtype(cfg.dtype)
    table = params["embedding"]
    fsdp = _fsdp(cfg)
    if fsdp is None:
        x = gather_rows(table, tokens, dtype).to(dtype)
    else:
        rows = table.shape[0]
        if isinstance(table, (QuantTensor, QuantTensor4)):
            # the whole per-row scale: this block's rows of it
            table = type(table)(q=table.q, scale=table.scale.narrow(
                0, fsdp.rank * rows, rows))
        local = tokens.long() - fsdp.rank * rows
        mine = (local >= 0) & (local < rows)
        x = gather_rows(table, local.clamp(0, rows - 1), dtype).to(dtype)
        x = all_reduce_sum(torch.where(mine[..., None], x, 0.0).to(dtype),
                           fsdp.group)
    tp = _tp(cfg)
    if tp is not None:
        x = all_gather(x, tp.group, dim=-1).contiguous()
    return x


def prefill_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, seq_lens: torch.Tensor,
                      q_offset: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Causal attention of a prefill: ``ops.flash_attention``, under TP its
    sharded wrapper over the rank's heads."""
    tp = _tp(cfg)
    if tp is None:
        return flash_attention(q, k, v, seq_lens, q_offset)
    return flash_attention_sharded(q, k, v, seq_lens, tp.mesh, q_offset,
                                   global_heads=(tp.n_heads, tp.n_kv_heads))


def _qkv(cfg: ModelConfig, layer: Params, x: torch.Tensor,
         angles: torch.Tensor, positions: torch.Tensor):
    """x [B, S, H] -> q [B, S, n_heads, d], k/v [B, S, n_kv, d] (roped q, k)."""
    b, s, _ = x.shape
    q = _w_mm(cfg, x, layer["wq"], 0).reshape(b, s, -1, cfg.head_dim)
    k = _w_mm(cfg, x, layer["wk"], 0).reshape(b, s, -1, cfg.head_dim)
    v = _w_mm(cfg, x, layer["wv"], 0).reshape(b, s, -1, cfg.head_dim)
    return apply_rope(q, angles, positions), apply_rope(k, angles, positions), v


def _mlp(cfg: ModelConfig, layer: Params, x: torch.Tensor,
         sp: bool = False) -> torch.Tensor:
    """The MLP (or the MoE MLP) of a block; with ``sp`` the output is the
    rank's block along the sequence (``_tp_sum``)."""
    if cfg.n_experts > 0:
        if getattr(cfg, "ep", None) is not None:
            from k8s_llm_rca_tpu_torch.parallel.moe import moe_mlp_ep

            return moe_mlp_ep(cfg, layer, x)
        return _moe_mlp(cfg, layer, x, sp)
    gate = F.silu(_w_mm(cfg, x, layer["w_gate"], 0))
    return _row_mm(cfg, gate * _w_mm(cfg, x, layer["w_up"], 0),
                   layer["w_down"], sp)


def _moe_route(router_logits: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` routing: router_logits [B, S, E] f32 -> (the k
    chosen experts [B, S, k], largest first, the lower index first among
    equal logits; their softmax weights scattered to a dense [B, S, E]
    map).  ``torch.topk`` does not break ties toward the lower index; a
    stable descending sort does."""
    topi = torch.sort(router_logits, dim=-1, descending=True,
                      stable=True)[1][..., :k]
    weights = torch.softmax(router_logits.gather(-1, topi), dim=-1)
    return topi, torch.zeros_like(router_logits).scatter_(-1, topi, weights)


def _moe_mlp(cfg: ModelConfig, layer: Params, x: torch.Tensor,
             sp: bool = False) -> torch.Tensor:
    """Mixtral sparse-MoE MLP, the dense soft-dispatch form of JAX's
    ``llama._moe_mlp``: every expert runs on every token (padding rows
    included) and the top-k router weights zero out the rest.  The router
    logits are rounded to x's dtype before f32, as in JAX, so bf16 ties
    break the same way.  Under ``fused_quant_matmul`` the stacked einsums
    go through ``qmm_experts`` (the ekn kernels on the card); gate and up
    are combined in place, so a 5120-row prefill holds two [B, S, E, I]
    tensors, not four.  Under FSDP the stacked experts are stored along
    hidden ([E, H/f, I], [E, I, H/f]) and gathered on use; the router is
    whole."""
    router_logits = _w_mm(cfg, x, layer["router"]).float()       # [B,S,E]
    _, dense_w = _moe_route(router_logits, cfg.n_experts_per_tok)
    experts = (qmm_experts if cfg.fused_quant_matmul
               else quant_matmul_experts_plain)
    h = F.silu(experts(x, _whole(cfg, layer["w_gate"], 1)))
    h.mul_(experts(x, _whole(cfg, layer["w_up"], 1)))
    per_expert = experts(h, _whole(cfg, layer["w_down"], -1))    # [B,S,E,H]
    out = torch.einsum("bseh,bse->bsh", per_expert, dense_w.to(x.dtype))
    # under TP the experts' inner dim is the rank's: partial sums
    return _tp_sum(cfg, out, sp)


def _block_prefill(cfg: ModelConfig, layer: Params, x: torch.Tensor,
                   angles: torch.Tensor, positions: torch.Tensor,
                   seq_lens: Optional[torch.Tensor], attention_fn=None,
                   sp: bool = False):
    """One transformer block over full right-padded sequences; attention
    runs through ``ops.flash_attention``, or ``attention_fn(q, k, v)`` (the
    context-parallel ring or all-to-all).  With ``sp`` (TP) ``x`` is the
    rank's block [B, S/t, H] of the sequence: the normed stream is
    gathered along the sequence before q/k/v and before gate/up, and wo
    and w_down reduce-scatter back to the block; ``positions`` and the
    returned k/v cover the whole sequence."""
    group = _tp(cfg).group if sp else None
    h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
    if sp:
        h = all_gather_into(h, group, dim=1)
    q, k, v = _qkv(cfg, layer, h, angles, positions)
    attn = (prefill_attention(cfg, q, k, v, seq_lens) if attention_fn is None
            else attention_fn(q, k, v))
    b, s = attn.shape[:2]
    x = x + _row_mm(cfg, attn.reshape(b, s, cfg.q_dim), layer["wo"], sp)
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
    if sp:
        h = all_gather_into(h, group, dim=1)
    return x + _mlp(cfg, layer, h, sp), k, v


def _decode_qkv(cfg: ModelConfig, layer: Params, x: torch.Tensor,
                angles: torch.Tensor, positions: torch.Tensor):
    """Decode-block front half: pre-attention norm + roped q/k/v."""
    h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
    return _qkv(cfg, layer, h, angles, positions)


def _decode_finish(cfg: ModelConfig, layer: Params, x: torch.Tensor,
                   attn: torch.Tensor) -> torch.Tensor:
    """Decode-block back half: output projection + residual + MLP.
    ``attn`` is already [B, T, q_dim]."""
    x = x + _row_mm(cfg, attn, layer["wo"])
    return x + _mlp(cfg, layer,
                    rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps))


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits; under TP the head is hidden-sharded: each rank's
    partial logits over its hidden slice, summed over the group.  Under
    FSDP the head (vocab-sharded) is gathered whole first."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = _whole(cfg, params["embedding"] if cfg.tie_embeddings
                  else params["lm_head"], 0)
    tp = _tp(cfg)
    if tp is not None:
        h = x.shape[-1] // tp.size
        x = x[..., tp.rank * h:(tp.rank + 1) * h].contiguous()
    if cfg.fused_quant_matmul:
        logits = qmm_head(x, head).float()
    else:
        logits = quant_matmul_head_plain(x, head).float()
    return logits if tp is None else all_reduce_sum(logits, tp.group)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


_ANGLES: Dict[tuple, torch.Tensor] = {}


def _angles(cfg: ModelConfig, device) -> torch.Tensor:
    """The RoPE table of ``cfg`` on ``device``, built once per device and
    shape: building it copies theta to the device, which a decode step
    under CUDA graph capture must not do."""
    key = (cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, torch.device(device))
    table = _ANGLES.get(key)
    if table is None:
        table = _ANGLES[key] = rope_frequencies(
            cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device=device)
    return table


def _sp(cfg: ModelConfig) -> bool:
    """True when the rank's TP prefill is sequence-parallel
    (``RankModelConfig.sp``, set only with TP)."""
    return bool(getattr(cfg, "sp", False))


def _sp_block(cfg: ModelConfig, s_pad: int) -> slice:
    """The rank's block of a padded sequence under SP."""
    tp = _tp(cfg)
    if s_pad % tp.size:
        raise ValueError(
            f"sp=True shards the padded sequence over the model axis: "
            f"bucket {s_pad} is not divisible by its size {tp.size}")
    s_loc = s_pad // tp.size
    return slice(tp.rank * s_loc, (tp.rank + 1) * s_loc)


def _sp_last_rows(cfg: ModelConfig, x: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Each row's last valid token [N, 1, H] from the ranks' sequence
    blocks x [N, S/t, H]: every rank offers the row at its offset in its
    block, one gather, and each row takes its owner's (decided on the
    device)."""
    n, s_loc = x.shape[:2]
    last = lengths.long() - 1
    rows = torch.arange(n, device=x.device)
    mine = x[rows, last % s_loc][:, None]                       # [N, 1, H]
    parts = all_gather_into(mine, _tp(cfg).group)                # [t*N, 1, H]
    return parts.view(-1, n, 1, x.shape[-1])[last // s_loc, rows]


def prefill_kv(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
               length: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the stack over ONE right-padded sequence: tokens [1, S_pad],
    ``length`` valid tokens.  Returns (new_k [L, S_pad, n_kv, d], new_v,
    logits [1, V] of the last valid token).  Sequence-parallel under
    ``cfg.sp`` (module docstring)."""
    dev = tokens.device
    s_pad = tokens.shape[1]
    angles = _angles(cfg, dev)
    positions = torch.arange(s_pad, device=dev)[None, :]
    seq_lens = torch.tensor([int(length)], dtype=torch.int32, device=dev)
    sp = _sp(cfg)
    x = embed(cfg, params, tokens)
    if sp:
        # every rank looks up every token (the table is hidden-sharded),
        # then keeps its block of the sequence
        x = x[:, _sp_block(cfg, s_pad)].contiguous()
    ks, vs = [], []
    for layer in params["layers"]:
        x, k, v = _block_prefill(cfg, layer, x, angles, positions, seq_lens,
                                 sp=sp)
        ks.append(k[0])
        vs.append(v[0])
    if sp:
        last = _sp_last_rows(cfg, x, seq_lens)
    else:
        last = x[:, int(length) - 1:int(length)]            # [1, 1, H]
    return torch.stack(ks), torch.stack(vs), _logits(cfg, params, last)[:, 0]


def _prefill_batch_kv(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                      lengths: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched prefill without a cache write: tokens [N, S_pad], lengths
    [N] int32 -> (new_k [L, N, S_pad, kv_dim], new_v, logits [N, V] at each
    row's last valid token).  Sequence-parallel under ``cfg.sp``."""
    dev = tokens.device
    n, s_pad = tokens.shape
    angles = _angles(cfg, dev)
    positions = torch.arange(s_pad, device=dev)[None, :].expand(n, s_pad)
    sp = _sp(cfg)
    x = embed(cfg, params, tokens)
    if sp:
        # every rank looks up every token (the table is hidden-sharded),
        # then keeps its block of the sequence
        x = x[:, _sp_block(cfg, s_pad)].contiguous()
    ks, vs = [], []
    for layer in params["layers"]:
        x, k, v = _block_prefill(cfg, layer, x, angles, positions, lengths,
                                 sp=sp)
        ks.append(k.reshape(n, s_pad, cfg.kv_dim))
        vs.append(v.reshape(n, s_pad, cfg.kv_dim))
    if sp:
        last = _sp_last_rows(cfg, x, lengths)
    else:
        last = x[torch.arange(n, device=dev), lengths.long() - 1][:, None]
    return torch.stack(ks), torch.stack(vs), _logits(cfg, params, last)[:, 0]


# ---------------------------------------------------------------------------
# the contiguous KV cache (InferenceEngine's): one [S] row per slot
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """k/v [L, B, S, kv_dim] (int4: [L, B, S, kv_dim / 2], split-half
    packed), with per-token scales [L, B, S] in the model dtype when
    quantized.  The port's functions write it IN PLACE and return it, for
    the JAX call shape."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: ModelConfig, n_slots: int,
               max_seq_len: Optional[int] = None,
               kv_dtype: Optional[str] = None, device=None) -> KVCache:
    """A zeroed contiguous cache on ``device`` (``None`` = the card):
    ``kv_dtype`` None (the model dtype), "int8" or "int4" (per-token
    scales, as JAX's)."""
    device = resolve_device(device)
    s = max_seq_len or cfg.max_seq_len
    if s > cfg.max_seq_len:
        # positions past the RoPE table would clamp to its last row
        raise ValueError(
            f"cache max_seq_len {s} exceeds model max_seq_len {cfg.max_seq_len}")
    if kv_dtype not in (None, "int8", "int4"):
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (None, 'int8' "
                         f"or 'int4')")
    dtype = torch_dtype(cfg.dtype)
    shape = (cfg.n_layers, n_slots, s, cfg.kv_dim)
    if kv_dtype is None:
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))
    if kv_dtype == "int4":
        if cfg.kv_dim % 2:
            raise ValueError(f"int4 KV needs an even kv_dim, not {cfg.kv_dim}")
        shape = (*shape[:3], cfg.kv_dim // 2)

    def zeros(sh, dt):
        return torch.zeros(sh, dtype=dt, device=device)

    return KVCache(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                   k_scale=zeros(shape[:3], dtype),
                   v_scale=zeros(shape[:3], dtype))


def _kv_packed(cfg: ModelConfig, cache: KVCache) -> bool:
    """True when the cache stores nibble-packed int4 KV (kv_dim halved)."""
    return cache.k.shape[-1] != cfg.kv_dim


def _store_kv(cfg: ModelConfig, cache: KVCache, li, index,
              k_new: torch.Tensor, v_new: torch.Tensor,
              keep: Optional[torch.Tensor] = None) -> None:
    """Write new k/v rows ([..., kv_dim], model dtype) into layer(s) ``li``
    of the cache at ``index`` (a tuple indexing the [B, S] axes),
    quantizing per token when the cache is int8/int4 (under TP with the
    full-row scale, the max over the group: ``kv_group``).  ``keep`` (a
    bool mask [B, T] over a CP rank's ``_token_index`` entries): where
    False the cache keeps what it holds there (the rank does not own the
    position).  Such an entry's index is clamped onto the block's edge,
    where a write of T tokens straddling two ranks' blocks also has an
    owned entry: every entry onto that row writes the owned entry's value,
    as a write with repeated indices keeps one of them, unspecified
    which."""
    new = [k_new, v_new]
    if cache.quantized:
        packed = _kv_packed(cfg, cache)
        (k_q, ks), (v_q, vs) = (quantize_kv(t, packed, kv_group(cfg))
                                for t in new)
        new = [k_q, v_q, ks, vs]
    if keep is not None:
        local = index[1]
        onto = (local[:, :, None] == local[:, None, :]) & keep[:, None, :]
        owned = onto.any(-1)                          # [B, T]
        src = (torch.arange(keep.shape[0], device=keep.device)[:, None],
               onto.int().argmax(-1))
    for buf, t in zip(cache, new):
        if keep is not None:
            t = torch.where(owned[(...,) + (None,) * (t.dim() - keep.dim())],
                            t[src], buf[(li,) + index])
        buf[(li,) + index] = t


def _write_prefill_kv(cfg: ModelConfig, cache: KVCache, new_k: torch.Tensor,
                      new_v: torch.Tensor, slot: int) -> KVCache:
    """Write one sequence's full-depth prefill KV (new_k [L, S_pad, n_kv,
    d]) into cache slot ``slot`` at offset 0."""
    n_layers, s_pad = new_k.shape[:2]
    _store_kv(cfg, cache, slice(None), (int(slot), slice(0, s_pad)),
              new_k.reshape(n_layers, s_pad, cfg.kv_dim),
              new_v.reshape(n_layers, s_pad, cfg.kv_dim))
    return cache


def _no_pp(cfg: ModelConfig, name: str, pp_name: str) -> None:
    """Under PP a rank holds one stage's layers: the pipelined entry point
    ``pp_name`` of ``parallel/pipeline.py`` runs them."""
    if getattr(cfg, "pp", None) is not None:
        raise ValueError(f"{name} runs the whole stack, and a rank under a "
                         f"pp_mesh holds one stage: use "
                         f"parallel.pipeline.{pp_name}")


def prefill(cfg: ModelConfig, params: Params, cache: KVCache,
            tokens: torch.Tensor, length: int, slot: int
            ) -> Tuple[KVCache, torch.Tensor]:
    """Prefill ONE right-padded sequence (tokens [1, S_pad], ``length``
    valid) into cache slot ``slot``; attention is ``ops.flash_attention``
    (the kernel on the card).  Returns (cache, logits [1, V] of the last
    valid token)."""
    _no_pp(cfg, "prefill", "llama_pp_prefill")
    new_k, new_v, logits = prefill_kv(cfg, params, tokens, length)
    return _write_prefill_kv(cfg, cache, new_k, new_v, slot), logits


def prefill_batch(cfg: ModelConfig, params: Params, cache: KVCache,
                  tokens: torch.Tensor, lengths: torch.Tensor,
                  slots: torch.Tensor) -> Tuple[KVCache, torch.Tensor]:
    """Prefill N right-padded sequences (tokens [N, S_pad], lengths [N])
    into cache slots ``slots`` [N] in one batched forward.  Duplicate
    slots are allowed only for identical rows (the admission batcher pads
    a batch by repeating its last row: the duplicate writes are equal).
    Returns (cache, logits [N, V] at each row's last valid token)."""
    _no_pp(cfg, "prefill_batch", "llama_pp_prefill")
    s_pad = tokens.shape[1]
    new_k, new_v, logits = _prefill_batch_kv(cfg, params, tokens, lengths)
    _store_kv(cfg, cache, slice(None), (slots.long(), slice(0, s_pad)),
              new_k, new_v)
    return cache, logits


def _token_index(cfg: ModelConfig, cache: KVCache, lengths: torch.Tensor,
                 t: int = 1):
    """((slot, position) index of each slot's next ``t`` cache rows, the
    rows this rank writes: None = all of them).  A position past the
    sequence writes its last row instead, as a JAX ``dynamic_update_slice``
    clamps its start: only slots that are not live reach it, and the row
    is rewritten before it is attended.  Under CP (``cfg.cp``) the cache
    holds this rank's block of the sequence, [rank * S/P, (rank + 1) *
    S/P): the clamp is the whole sequence's, the index local, and a
    position outside the block is not written (its owner writes it)."""
    b = lengths.shape[0]
    dev = lengths.device
    cp = getattr(cfg, "cp", None)
    s_rows = cache.max_seq_len
    s_max = s_rows * (cp.size if cp is not None else 1)
    start = torch.clamp(lengths.long(), max=s_max - t)
    pos = start[:, None] + torch.arange(t, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    if cp is None:
        return (rows, pos), None
    local = pos - cp.rank * s_rows
    keep = (local >= 0) & (local < s_rows)
    return (rows, local.clamp(0, s_rows - 1)), keep


def _cached_layer(cfg: ModelConfig, cache: KVCache, li: int, dtype):
    """Layer ``li``'s K and V as [B, S, n_kv, d] in ``dtype`` (dequantized
    from an int8/int4 cache, as JAX's ``_dequant_layer`` at the read)."""
    b, s = cache.k.shape[1:3]
    packed = _kv_packed(cfg, cache)
    scales = ((None, None) if not cache.quantized
              else (cache.k_scale[li], cache.v_scale[li]))
    return tuple(
        dequant_kv(kv[li], sc, dtype, packed).reshape(
            b, s, cfg.n_kv_heads, cfg.head_dim)
        for kv, sc in zip((cache.k, cache.v), scales))


def cp_merge(cfg: ModelConfig, out: torch.Tensor, lse: torch.Tensor
             ) -> torch.Tensor:
    """The CP decode merge: every rank's partial attention out [B, H, d]
    over its own keys with its log-sum-exp lse [B, H]; one all-gather of
    (out, lse) over the seq group, then ``merge_partials`` (plain torch:
    JAX leaves the combine to GSPMD outside any kernel).  [B, H, d] in
    out's dtype.  A verify step passes its B * T query rows as the batch."""
    part = torch.cat([out.float(), lse[..., None]], dim=-1)     # [B, H, d+1]
    parts = all_gather(part[None], cfg.cp.group, dim=0)         # [P, B, H, d+1]
    return merge_partials(parts[..., :-1], parts[..., -1]).to(out.dtype)


def _cp_decode_attention(cfg: ModelConfig, q: torch.Tensor,
                         k_all: torch.Tensor, v_all: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over the sequence-sharded cache: q [B, T, H, d] at
    positions ``lengths + i``, k/v_all this rank's block [B, S/P, n_kv,
    d]; query i of row b sees ``lengths[b] + 1 + i`` positions, clamped to
    the block.  The plain attention over the block's valid positions with
    its lse (``attention_lse_plain``), merged over the seq group
    (``cp_merge``, the B * T query rows at once: one all-gather a layer).
    Returns [B, T, H, d]."""
    cp = cfg.cp
    b, t = q.shape[:2]
    s_rows = k_all.shape[1]
    steps = torch.arange(1, t + 1, device=q.device)
    lens = (lengths[:, None] + steps - cp.rank * s_rows).clamp(0, s_rows)
    out, lse = attention_lse_plain(q, k_all, v_all, lens)
    merged = cp_merge(cfg, out.reshape(b * t, *out.shape[2:]),
                      lse.reshape(b * t, -1))
    return merged.reshape(b, t, *merged.shape[1:])


def _decode_layers(cfg: ModelConfig, layers, x: torch.Tensor,
                   cache: KVCache, lengths: torch.Tensor) -> torch.Tensor:
    """The blocks of a decode of T = x.shape[1] tokens a slot, layer ``li``
    on cache layer ``li``: x [B, T, H] at positions ``lengths[b] + i``.
    Each layer writes its T new K/V rows (quantized per token in an
    int8/int4 cache) BEFORE attention, where query i sees ``lengths[b] +
    1 + i`` positions (``ops.attention.decode_attention_multi``, plain
    torch as JAX computes it outside any kernel; under CP
    ``_cp_decode_attention``).  Under CP a write of T tokens that
    straddles two ranks' blocks splits there (``_token_index``: each rank
    keeps its own rows).  Returns x."""
    b, t = x.shape[:2]
    dev = x.device
    dtype = torch_dtype(cfg.dtype)
    angles = _angles(cfg, dev)
    positions = lengths.long()[:, None] + torch.arange(t, device=dev)[None, :]
    cp = getattr(cfg, "cp", None)
    index, keep = _token_index(cfg, cache, lengths, t)
    for li, layer in enumerate(layers):
        q, k, v = _decode_qkv(cfg, layer, x, angles, positions)
        _store_kv(cfg, cache, li, index, k.reshape(b, t, cfg.kv_dim),
                  v.reshape(b, t, cfg.kv_dim), keep)
        k_all, v_all = _cached_layer(cfg, cache, li, dtype)
        if cp is None:
            attn = decode_attention_multi(q, k_all, v_all, lengths + 1)
        else:
            attn = _cp_decode_attention(cfg, q, k_all, v_all, lengths)
        x = _decode_finish(cfg, layer, x, attn.reshape(b, t, cfg.q_dim))
    return x


def decode_multi(cfg: ModelConfig, params: Params, cache: KVCache,
                 tokens: torch.Tensor, lengths: torch.Tensor
                 ) -> Tuple[KVCache, torch.Tensor]:
    """Multi-token decode step (speculative verification): tokens [B, T],
    tokens[b, 0] the current token and the rest drafts, written at
    lengths[b]..lengths[b] + T - 1 before attention; query i attends to
    lengths[b] + 1 + i positions (``ops.attention.decode_attention_multi``,
    plain torch as JAX computes it outside any kernel).  Rejected drafts
    need no rollback: attention masks by length.  Returns (cache, logits
    [B, T, V])."""
    _no_pp(cfg, "decode_multi", "llama_pp_decode_multi")
    x = embed(cfg, params, tokens.long())
    x = _decode_layers(cfg, params["layers"], x, cache, lengths)
    return cache, _logits(cfg, params, x)


def decode_step(cfg: ModelConfig, params: Params, cache: KVCache,
                tokens: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[KVCache, torch.Tensor]:
    """One decode step for ALL slots: tokens [B] current tokens, lengths
    [B] tokens already cached; the new token's KV is written at
    lengths[b] and attends to lengths[b] + 1 positions
    (``ops.attention.decode_attention``; under CP (``cfg.cp``) each rank
    over its block of the sequence, merged: ``_cp_decode_attention``).
    Returns (cache, logits [B, V])."""
    _no_pp(cfg, "decode_step", "llama_pp_decode_step")
    x = embed(cfg, params, tokens.long()[:, None])
    x = _decode_layers(cfg, params["layers"], x, cache, lengths)
    return cache, _logits(cfg, params, x)[:, 0]


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scoring forward: tokens [B, S] -> logits [B, S, V] (fp32), causal
    attention through ``ops.flash_attention``."""
    b, s = tokens.shape
    dev = tokens.device
    if seq_lens is None:
        seq_lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    angles = _angles(cfg, dev)
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    x = embed(cfg, params, tokens)
    for layer in params["layers"]:
        x, _, _ = _block_prefill(cfg, layer, x, angles, positions, seq_lens)
    return _logits(cfg, params, x)


def prefill_kv_cp(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  length: int, mesh, seq_axis: str = "seq",
                  cp_mode: str = "ring", head_axis: Optional[str] = None,
                  ep_mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Context-parallel prefill: ``prefill_kv`` with the sequence sharded
    over ``mesh[seq_axis]``.  Every rank of the axis passes the whole
    right-padded sequence, tokens [1, S_pad] (S_pad divisible by the axis
    size), and runs the stack on its block [p * S_pad/P, (p+1) * S_pad/P)
    only; attention is ``cp_mode`` "ring" (``parallel.ring_attention``)
    or "ulysses" (``parallel.ulysses``).  Right padding is safe under pure
    causal masking (padded keys sit at positions >= ``length``, which no
    valid query attends to).

    Returns what JAX's returns, on every rank: (new_k [L, S_pad, n_kv, d],
    new_v, logits [1, V] of the last valid token): one all-gather of the
    blocks' K/V over the axis (each rank then keeps the pages it owns) and
    one of the candidate last rows, from which every rank takes the
    owner's.

    ``head_axis``: the mesh axis that shards the heads (CP x TP, the rank's
    ``cfg`` a TP rank's): the ring or all-to-all runs per head shard.
    ``ep_mesh`` (CP x EP) is not ported and raises."""
    from k8s_llm_rca_tpu_torch.parallel.ring_attention import ring_attention
    from k8s_llm_rca_tpu_torch.parallel.ulysses import ulysses_attention
    from k8s_llm_rca_tpu_torch.runtime.mesh import (
        axis_group, axis_rank, axis_size,
    )

    if cp_mode not in ("ring", "ulysses"):
        raise ValueError(f"unknown cp_mode {cp_mode!r}")
    if ep_mesh is not None:
        from k8s_llm_rca_tpu_torch.engine.engine import mesh_item

        raise NotImplementedError(
            f"context-parallel prefill with ep_mesh (CP x EP) is not ported "
            f"yet ({mesh_item(9)})")
    cp_attn = ring_attention if cp_mode == "ring" else ulysses_attention
    n_cp = axis_size(mesh, seq_axis)
    p = axis_rank(mesh, seq_axis)
    group = axis_group(mesh, seq_axis)
    dev = tokens.device
    s_pad = tokens.shape[1]
    if s_pad % n_cp:
        raise ValueError(f"padded length {s_pad} not divisible by "
                         f"{seq_axis}={n_cp}")
    s_loc = s_pad // n_cp
    block = slice(p * s_loc, (p + 1) * s_loc)
    angles = _angles(cfg, dev)
    positions = torch.arange(s_pad, device=dev)[None, block]
    x = embed(cfg, params, tokens[:, block])
    tp = _tp(cfg)
    heads = None if tp is None else (tp.n_heads, tp.n_kv_heads)

    def attn(q, k, v):
        return cp_attn(q, k, v, mesh, seq_axis, head_axis, heads)

    ks, vs = [], []
    for layer in params["layers"]:
        x, k, v = _block_prefill(cfg, layer, x, angles, positions, None,
                                 attention_fn=attn)
        ks.append(k[0])
        vs.append(v[0])
    kv = all_gather(torch.stack([torch.stack(ks), torch.stack(vs)]), group,
                    dim=2)                         # [2, L, S_pad, n_kv, d]
    owner, row = divmod(int(length) - 1, s_loc)
    mine = x[:, row:row + 1] if owner == p else x[:, :1]
    last = all_gather(mine, group, dim=0)[owner:owner + 1]       # [1, 1, H]
    return kv[0], kv[1], _logits(cfg, params, last)[:, 0]


def prefill_cp(cfg: ModelConfig, params: Params, cache: KVCache,
               tokens: torch.Tensor, length: int, slot: int, mesh,
               seq_axis: str = "seq", cp_mode: str = "ring",
               head_axis: Optional[str] = None, ep_mesh=None
               ) -> Tuple[KVCache, torch.Tensor]:
    """Context-parallel prefill of ONE right-padded sequence into cache slot
    ``slot`` (the counterpart of JAX's ``prefill_cp``): ``prefill_kv_cp``
    (ring or Ulysses, per head shard under CP x TP), then each rank keeps
    its block of the sequence, positions [rank * S/P, (rank + 1) * S/P),
    of every layer: the rank's cache holds S/P positions a slot (``cfg``
    is the rank's config, ``cfg.cp`` its place on the seq axis).  Returns
    (cache, logits [1, V] of the last valid token), the same on every
    rank."""
    new_k, new_v, logits = prefill_kv_cp(cfg, params, tokens, length, mesh,
                                         seq_axis, cp_mode, head_axis,
                                         ep_mesh)
    s_rows = cache.max_seq_len
    lo = cfg.cp.rank * s_rows
    hi = min(lo + s_rows, tokens.shape[1])
    if hi > lo:
        # every rank of a TP group shares its seq rank: the quantized
        # write's max over the group runs on all of them or none
        n_layers = new_k.shape[0]
        _store_kv(cfg, cache, slice(None), (int(slot), slice(0, hi - lo)),
                  new_k[:, lo:hi].reshape(n_layers, hi - lo, cfg.kv_dim),
                  new_v[:, lo:hi].reshape(n_layers, hi - lo, cfg.kv_dim))
    return cache, logits
