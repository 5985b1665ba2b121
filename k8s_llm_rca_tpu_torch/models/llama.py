"""Llama-family decoder LM in PyTorch: the port of ``k8s_llm_rca_tpu/models/llama.py``.

Parameters are a plain nested dict with the JAX tree's names and layouts
(``embedding`` [V, H], ``layers[i]`` with ``attn_norm``, ``mlp_norm``,
``wq``, ``wk``, ``wv``, ``wo``, ``w_gate``, ``w_up``, ``w_down`` stored
[in, out] for ``x @ w``, ``final_norm``, and ``lm_head`` [V, H] unless
tied), so ``params_from_numpy`` carries a JAX tree across unchanged.
Projections, the MLP and the lm head are ``torch.matmul``; prefill
attention is ``ops.flash_attention`` (the CUDA kernel on the card, its
plain version on the CPU).  Dense Llama only: the MoE MLP (ROADMAP Queue 1
item 8) and the fused quantized matmuls (Queue 1 item 2) are not ported.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from k8s_llm_rca_tpu_torch.config import ModelConfig
from k8s_llm_rca_tpu_torch.models.quant import dq, gather_rows
from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention
from k8s_llm_rca_tpu_torch.ops.norms import rms_norm
from k8s_llm_rca_tpu_torch.ops.rope import apply_rope, rope_frequencies
from k8s_llm_rca_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r} (float32 or bfloat16)")
    return _DTYPES[name]


def check_model_config(cfg: ModelConfig) -> None:
    """Refuse the model features this slice does not port."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE (n_experts > 0) is not ported yet (ROADMAP Queue 1 item 8)")
    if cfg.fused_quant_matmul:
        raise NotImplementedError(
            "fused_quant_matmul is not ported yet (ROADMAP Queue 1 item 2, "
            "quantized paths)")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random init (scaled normal, the JAX init's scales) from ``generator``,
    which must live on ``device`` (``None`` = the card)."""
    check_model_config(cfg)
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    h, q, kv, inter = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                       cfg.intermediate_size)
    scale = 1.0 / math.sqrt(h)
    out_scale = scale / math.sqrt(2 * cfg.n_layers)

    def dense(shape, s):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * s).to(dtype)

    def ones():
        return torch.ones((h,), device=device, dtype=dtype)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn_norm": ones(), "mlp_norm": ones(),
            "wq": dense((h, q), scale), "wk": dense((h, kv), scale),
            "wv": dense((h, kv), scale), "wo": dense((q, h), out_scale),
            "w_gate": dense((h, inter), scale), "w_up": dense((h, inter), scale),
            "w_down": dense((inter, h), out_scale),
        })
    params: Params = {"embedding": dense((cfg.vocab_size, h), 1.0),
                      "final_norm": ones(), "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((cfg.vocab_size, h), scale)
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


def params_from_numpy(tree, device=None,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """Carry a JAX parameter tree across: ``tree`` is
    ``jax.tree.map(np.asarray, params)``; every leaf becomes a tensor on
    ``device`` (``None`` = the card) in ``dtype`` (``None`` keeps the
    leaf's).  bf16 leaves arrive bit-exact."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return _tensor_from_numpy(tree, device, dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _w_mm(x: torch.Tensor, w) -> torch.Tensor:
    return torch.matmul(x, dq(w))


def _qkv(cfg: ModelConfig, layer: Params, x: torch.Tensor,
         angles: torch.Tensor, positions: torch.Tensor):
    """x [B, S, H] -> q [B, S, n_heads, d], k/v [B, S, n_kv, d] (roped q, k)."""
    b, s, _ = x.shape
    q = _w_mm(x, layer["wq"]).reshape(b, s, -1, cfg.head_dim)
    k = _w_mm(x, layer["wk"]).reshape(b, s, -1, cfg.head_dim)
    v = _w_mm(x, layer["wv"]).reshape(b, s, -1, cfg.head_dim)
    return apply_rope(q, angles, positions), apply_rope(k, angles, positions), v


def _mlp(layer: Params, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(_w_mm(x, layer["w_gate"]))
    return _w_mm(gate * _w_mm(x, layer["w_up"]), layer["w_down"])


def _block_prefill(cfg: ModelConfig, layer: Params, x: torch.Tensor,
                   angles: torch.Tensor, positions: torch.Tensor,
                   seq_lens: torch.Tensor):
    """One transformer block over full right-padded sequences; attention
    runs through ``ops.flash_attention``."""
    h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv(cfg, layer, h, angles, positions)
    attn = flash_attention(q, k, v, seq_lens)
    b, s = attn.shape[:2]
    x = x + _w_mm(attn.reshape(b, s, cfg.q_dim), layer["wo"])
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
    return x + _mlp(layer, h), k, v


def _decode_qkv(cfg: ModelConfig, layer: Params, x: torch.Tensor,
                angles: torch.Tensor, positions: torch.Tensor):
    """Decode-block front half: pre-attention norm + roped q/k/v."""
    h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
    return _qkv(cfg, layer, h, angles, positions)


def _decode_finish(cfg: ModelConfig, layer: Params, x: torch.Tensor,
                   attn: torch.Tensor) -> torch.Tensor:
    """Decode-block back half: output projection + residual + MLP.
    ``attn`` is already [B, T, q_dim]."""
    x = x + _w_mm(attn, layer["wo"])
    return x + _mlp(layer, rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps))


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, dq(head).t()).float()


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
    x = gather_rows(params["embedding"], tokens).to(torch_dtype(cfg.dtype))
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
    x = gather_rows(params["embedding"], tokens).to(torch_dtype(cfg.dtype))
    ks, vs = [], []
    for layer in params["layers"]:
        x, k, v = _block_prefill(cfg, layer, x, angles, positions, lengths)
        ks.append(k.reshape(n, s_pad, cfg.kv_dim))
        vs.append(v.reshape(n, s_pad, cfg.kv_dim))
    last = x[torch.arange(n, device=dev), lengths.long() - 1][:, None]
    return torch.stack(ks), torch.stack(vs), _logits(cfg, params, last)[:, 0]
