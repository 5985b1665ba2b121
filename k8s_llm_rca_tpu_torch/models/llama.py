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
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from k8s_llm_rca_tpu_torch.config import ModelConfig
from k8s_llm_rca_tpu_torch.models.quant import (
    QuantTensor, QuantTensor4, gather_rows,
)
from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention
from k8s_llm_rca_tpu_torch.ops.quant_matmul import (
    qmm, qmm_experts, qmm_head, quant_matmul_experts_plain,
    quant_matmul_head_plain, quant_matmul_plain,
)
from k8s_llm_rca_tpu_torch.ops.norms import rms_norm
from k8s_llm_rca_tpu_torch.ops.rope import apply_rope, rope_frequencies
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
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        w = (w * s).to(dtype)
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
    if kind == "QuantTensor4Grouped":
        raise ValueError("grouped int4 (QuantTensor4Grouped) is a shard-local "
                         "layout of PP x TP, not ported (ROADMAP Queue 1 "
                         "item 10)")
    q = _tensor_from_numpy(tree.q, device, None)
    scale = _tensor_from_numpy(tree.scale, device, None)
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


def _w_mm(cfg: ModelConfig, x: torch.Tensor, w) -> torch.Tensor:
    """Every weight matmul: ``x @ dq(w)``, or the fused kernel shim under
    ``cfg.fused_quant_matmul``."""
    if cfg.fused_quant_matmul:
        return qmm(x, w)
    return quant_matmul_plain(x, w)


def _qkv(cfg: ModelConfig, layer: Params, x: torch.Tensor,
         angles: torch.Tensor, positions: torch.Tensor):
    """x [B, S, H] -> q [B, S, n_heads, d], k/v [B, S, n_kv, d] (roped q, k)."""
    b, s, _ = x.shape
    q = _w_mm(cfg, x, layer["wq"]).reshape(b, s, -1, cfg.head_dim)
    k = _w_mm(cfg, x, layer["wk"]).reshape(b, s, -1, cfg.head_dim)
    v = _w_mm(cfg, x, layer["wv"]).reshape(b, s, -1, cfg.head_dim)
    return apply_rope(q, angles, positions), apply_rope(k, angles, positions), v


def _mlp(cfg: ModelConfig, layer: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.n_experts > 0:
        return _moe_mlp(cfg, layer, x)
    gate = F.silu(_w_mm(cfg, x, layer["w_gate"]))
    return _w_mm(cfg, gate * _w_mm(cfg, x, layer["w_up"]), layer["w_down"])


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


def _moe_mlp(cfg: ModelConfig, layer: Params, x: torch.Tensor) -> torch.Tensor:
    """Mixtral sparse-MoE MLP, the dense soft-dispatch form of JAX's
    ``llama._moe_mlp``: every expert runs on every token (padding rows
    included) and the top-k router weights zero out the rest.  The router
    logits are rounded to x's dtype before f32, as in JAX, so bf16 ties
    break the same way.  Under ``fused_quant_matmul`` the stacked einsums
    go through ``qmm_experts`` (the ekn kernels on the card); gate and up
    are combined in place, so a 5120-row prefill holds two [B, S, E, I]
    tensors, not four."""
    router_logits = _w_mm(cfg, x, layer["router"]).float()       # [B,S,E]
    _, dense_w = _moe_route(router_logits, cfg.n_experts_per_tok)
    experts = (qmm_experts if cfg.fused_quant_matmul
               else quant_matmul_experts_plain)
    h = F.silu(experts(x, layer["w_gate"]))
    h.mul_(experts(x, layer["w_up"]))
    per_expert = experts(h, layer["w_down"])                     # [B,S,E,H]
    return torch.einsum("bseh,bse->bsh", per_expert, dense_w.to(x.dtype))


def _block_prefill(cfg: ModelConfig, layer: Params, x: torch.Tensor,
                   angles: torch.Tensor, positions: torch.Tensor,
                   seq_lens: torch.Tensor):
    """One transformer block over full right-padded sequences; attention
    runs through ``ops.flash_attention``."""
    h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv(cfg, layer, h, angles, positions)
    attn = flash_attention(q, k, v, seq_lens)
    b, s = attn.shape[:2]
    x = x + _w_mm(cfg, attn.reshape(b, s, cfg.q_dim), layer["wo"])
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
    return x + _mlp(cfg, layer, h), k, v


def _decode_qkv(cfg: ModelConfig, layer: Params, x: torch.Tensor,
                angles: torch.Tensor, positions: torch.Tensor):
    """Decode-block front half: pre-attention norm + roped q/k/v."""
    h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
    return _qkv(cfg, layer, h, angles, positions)


def _decode_finish(cfg: ModelConfig, layer: Params, x: torch.Tensor,
                   attn: torch.Tensor) -> torch.Tensor:
    """Decode-block back half: output projection + residual + MLP.
    ``attn`` is already [B, T, q_dim]."""
    x = x + _w_mm(cfg, attn, layer["wo"])
    return x + _mlp(cfg, layer,
                    rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps))


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
    if cfg.fused_quant_matmul:
        return qmm_head(x, head).float()
    return quant_matmul_head_plain(x, head).float()


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _angles(cfg: ModelConfig, device) -> torch.Tensor:
    return rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                            device=device)


def prefill_kv(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
               length: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the stack over ONE right-padded sequence: tokens [1, S_pad],
    ``length`` valid tokens.  Returns (new_k [L, S_pad, n_kv, d], new_v,
    logits [1, V] of the last valid token)."""
    dev = tokens.device
    s_pad = tokens.shape[1]
    angles = _angles(cfg, dev)
    positions = torch.arange(s_pad, device=dev)[None, :]
    seq_lens = torch.tensor([int(length)], dtype=torch.int32, device=dev)
    dtype = torch_dtype(cfg.dtype)
    x = gather_rows(params["embedding"], tokens, dtype).to(dtype)
    ks, vs = [], []
    for layer in params["layers"]:
        x, k, v = _block_prefill(cfg, layer, x, angles, positions, seq_lens)
        ks.append(k[0])
        vs.append(v[0])
    last = x[:, int(length) - 1:int(length)]                # [1, 1, H]
    return torch.stack(ks), torch.stack(vs), _logits(cfg, params, last)[:, 0]


def _prefill_batch_kv(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                      lengths: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched prefill without a cache write: tokens [N, S_pad], lengths
    [N] int32 -> (new_k [L, N, S_pad, kv_dim], new_v, logits [N, V] at each
    row's last valid token)."""
    dev = tokens.device
    n, s_pad = tokens.shape
    angles = _angles(cfg, dev)
    positions = torch.arange(s_pad, device=dev)[None, :].expand(n, s_pad)
    dtype = torch_dtype(cfg.dtype)
    x = gather_rows(params["embedding"], tokens, dtype).to(dtype)
    ks, vs = [], []
    for layer in params["layers"]:
        x, k, v = _block_prefill(cfg, layer, x, angles, positions, lengths)
        ks.append(k.reshape(n, s_pad, cfg.kv_dim))
        vs.append(v.reshape(n, s_pad, cfg.kv_dim))
    last = x[torch.arange(n, device=dev), lengths.long() - 1][:, None]
    return torch.stack(ks), torch.stack(vs), _logits(cfg, params, last)[:, 0]
