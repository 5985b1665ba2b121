"""e5-family bidirectional text encoder (BERT architecture) in PyTorch: the
port of ``k8s_llm_rca_tpu/models/encoder.py``.

The embedding side of the rerank path (``rca/rerank.py``): error messages
and graph evidence encode to unit vectors whose cosine similarity orders
the evidence before it reaches a prompt.

Params are a plain nested dict with the JAX tree's names and layouts
(``word_embedding`` [V, H], ``position_embedding`` [S, H],
``type_embedding`` [2, H], ``embed_ln_w``/``embed_ln_b`` and ``layers[i]``
with ``wq``/``wk``/``wv``/``wo`` [H, H], ``w_in`` [H, I], ``w_out`` [I, H]
stored [in, out] for ``x @ w``, their biases and the two LayerNorms), so
``models.llama.params_from_numpy`` carries a JAX tree across.  Weights
are read through ``models.quant.dq``/``gather_rows``, so int8 and int4
trees run the same code.  No TPU kernel is on this path: the JAX
encoder's attention is plain einsums, and so is this one (``torch.matmul``
projections, an fp32 masked softmax), so the numbers stay the
reference's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from k8s_llm_rca_tpu_torch.config import EncoderConfig
from k8s_llm_rca_tpu_torch.models.llama import torch_dtype
from k8s_llm_rca_tpu_torch.models.quant import dq, gather_rows
from k8s_llm_rca_tpu_torch.ops.norms import layer_norm
from k8s_llm_rca_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

NEG_INF = -1e30


def init_params(cfg: EncoderConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random init (the JAX init's scales) from ``generator``, which must
    live on ``device`` (``None`` = the card).  Real e5 checkpoints load
    through ``models.loader.load_encoder``."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    scale = 1.0 / math.sqrt(h)
    out_scale = scale / math.sqrt(2 * cfg.n_layers)

    def dense(shape, s):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * s).to(dtype)

    def full(n, value):
        return torch.full((n,), value, device=device, dtype=dtype)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "wq": dense((h, h), scale), "bq": full(h, 0.0),
            "wk": dense((h, h), scale), "bk": full(h, 0.0),
            "wv": dense((h, h), scale), "bv": full(h, 0.0),
            "wo": dense((h, h), out_scale), "bo": full(h, 0.0),
            "attn_ln_w": full(h, 1.0), "attn_ln_b": full(h, 0.0),
            "w_in": dense((h, inter), scale), "b_in": full(inter, 0.0),
            "w_out": dense((inter, h), out_scale), "b_out": full(h, 0.0),
            "mlp_ln_w": full(h, 1.0), "mlp_ln_b": full(h, 0.0),
        })
    return {
        "word_embedding": dense((cfg.vocab_size, h), 1.0),
        "position_embedding": dense((cfg.max_seq_len, h), 0.02),
        "type_embedding": dense((2, h), 0.02),
        "embed_ln_w": full(h, 1.0),
        "embed_ln_b": full(h, 0.0),
        "layers": layers,
    }


def _linear(x: torch.Tensor, w, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, dq(w, x.dtype)) + b


def _self_attention(cfg: EncoderConfig, layer: Params, x: torch.Tensor,
                    pad_mask: torch.Tensor) -> torch.Tensor:
    """Bidirectional multi-head attention.  x [B, S, H]; pad_mask [B, S]
    bool (True = valid token).  Padding keys are masked in fp32."""
    b, s, h = x.shape
    nh = cfg.n_heads
    d = h // nh
    q = _linear(x, layer["wq"], layer["bq"]).reshape(b, s, nh, d)
    k = _linear(x, layer["wk"], layer["bk"]).reshape(b, s, nh, d)
    v = _linear(x, layer["wv"], layer["bv"]).reshape(b, s, nh, d)

    logits = torch.einsum("bqnd,bknd->bnqk", q, k).float() / math.sqrt(d)
    logits = logits.masked_fill(~pad_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, s, h)
    return _linear(out, layer["wo"], layer["bo"])


def _pad_mask(tokens: torch.Tensor,
              lengths: Optional[torch.Tensor]) -> torch.Tensor:
    b, s = tokens.shape
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return torch.arange(s, device=tokens.device)[None, :] < lengths[:, None]


def forward(cfg: EncoderConfig, params: Params, tokens: torch.Tensor,
            lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] right-padded, lengths [B] -> hidden states [B, S, H].

    Post-LN transformer encoder (BERT/e5 ordering: residual add, then
    LayerNorm; GELU FFN in its tanh form, ``jax.nn.gelu``'s default)."""
    s = tokens.shape[1]
    pad_mask = _pad_mask(tokens, lengths)
    dtype = torch_dtype(cfg.dtype)
    x = (gather_rows(params["word_embedding"], tokens)
         + dq(params["position_embedding"])[None, :s]
         + dq(params["type_embedding"])[0][None, None]).to(dtype)
    x = layer_norm(x, params["embed_ln_w"], params["embed_ln_b"],
                   cfg.layer_norm_eps)
    for layer in params["layers"]:
        attn = _self_attention(cfg, layer, x, pad_mask)
        x = layer_norm(x + attn, layer["attn_ln_w"], layer["attn_ln_b"],
                       cfg.layer_norm_eps)
        ffn = F.gelu(_linear(x, layer["w_in"], layer["b_in"]),
                     approximate="tanh")
        ffn = _linear(ffn, layer["w_out"], layer["b_out"])
        x = layer_norm(x + ffn, layer["mlp_ln_w"], layer["mlp_ln_b"],
                       cfg.layer_norm_eps)
    return x


def embed(cfg: EncoderConfig, params: Params, tokens: torch.Tensor,
          lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sentence embedding: mean-pool the valid positions, L2-normalize.
    Returns [B, H] fp32 unit vectors (the e5 recipe)."""
    b, s = tokens.shape
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    hidden = forward(cfg, params, tokens, lengths).float()
    mask = _pad_mask(tokens, lengths).float()
    summed = torch.einsum("bsh,bs->bh", hidden, mask)
    pooled = summed / torch.clamp(lengths[:, None].float(), min=1.0)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-9)
