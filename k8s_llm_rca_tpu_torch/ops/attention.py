"""Attention ops, plain PyTorch: the versions every kernel is held against.

- ``causal_attention``: prefill, [B, S] queries attend causally to [B, S_k]
  keys (``q_offset`` places the queries at absolute positions for
  chunked prefill).  It is the plain version of
  ``ops/flash_attention.py``'s kernel.
- ``decode_attention``: one query per slot over a dense [B, S_max] cache
  with per-slot valid lengths.
- ``decode_attention_multi``: T queries per slot over that cache, query i
  seeing one more position than query i - 1 (speculative verification).

Masked scores are ``NEG_INF = -1e30``, not ``-inf``, as in the JAX
package, so a fully masked row stays finite.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, n_kv, d] -> [B, S, n_kv*n_rep, d] (GQA head expansion)."""
    if n_rep == 1:
        return kv
    b, s, h, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def causal_attention(
    q: torch.Tensor,          # [B, S, n_heads, d]
    k: torch.Tensor,          # [B, S_k, n_kv, d]
    v: torch.Tensor,          # [B, S_k, n_kv, d]
    seq_lens: torch.Tensor,   # [B] valid key lengths
    q_offset: Optional[torch.Tensor] = None,  # [B] absolute pos of q[:, 0]
) -> torch.Tensor:
    """Causal softmax attention for prefill.  Returns [B, S, n_heads, d]."""
    b, s, n_heads, d = q.shape
    s_k = k.shape[1]
    n_rep = n_heads // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)

    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale

    dev = q.device
    q_pos = torch.arange(s, device=dev)[None, :]                 # [1, S]
    if q_offset is not None:
        q_pos = q_pos + q_offset.to(dev)[:, None]                # [B, S]
    k_pos = torch.arange(s_k, device=dev)[None, :]               # [1, S_k]
    causal = q_pos[:, :, None] >= k_pos[:, None, :]              # [B, S, S_k]
    valid = k_pos[:, None, :] < seq_lens.to(dev)[:, None, None]
    mask = (causal & valid)[:, None, :, :]                       # [B, 1, S, S_k]

    logits = torch.where(mask, logits, torch.tensor(NEG_INF, device=dev))
    probs = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,          # [B, 1, n_heads, d]
    k_cache: torch.Tensor,    # [B, S_max, n_kv, d]
    v_cache: torch.Tensor,    # [B, S_max, n_kv, d]
    lengths: torch.Tensor,    # [B] tokens valid in cache (incl. current)
) -> torch.Tensor:
    """Single-step decode attention over a dense cache.  [B, 1, n_heads, d].
    The T = 1 case of ``decode_attention_multi``, as in JAX."""
    return decode_attention_multi(q, k_cache, v_cache, lengths)


def decode_attention_multi(
    q: torch.Tensor,          # [B, T, n_heads, d] queries at lengths - 1 + i
    k_cache: torch.Tensor,    # [B, S_max, n_kv, d]
    v_cache: torch.Tensor,    # [B, S_max, n_kv, d]
    lengths: torch.Tensor,    # [B] tokens valid incl. the FIRST query token
) -> torch.Tensor:
    """Multi-token decode attention (speculative verification): query i of
    slot b attends to cache positions < lengths[b] + i.  [B, T, n_heads, d]
    (``k8s_llm_rca_tpu/ops/attention.py::decode_attention_multi``).  The
    query heads of one kv head attend as a group (head g * n_rep + r reads
    kv head g, as ``repeat_kv`` lays them out), so the cache is not copied
    n_rep times: only once, to fp32, where JAX computes."""
    b, s_max, n_kv, d = k_cache.shape
    t, n_heads = q.shape[1], q.shape[2]
    n_rep = n_heads // n_kv

    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    qg = q.float().reshape(b, t, n_kv, n_rep, d)
    logits = torch.einsum("btgrd,bsgd->bgrts", qg,
                          k_cache.float()) * scale          # [B,G,R,T,S]
    dev = q.device
    k_pos = torch.arange(s_max, device=dev)[None, None, :]       # [1, 1, S]
    limit = (lengths.to(dev)[:, None, None]
             + torch.arange(t, device=dev)[None, :, None])       # [B, T, 1]
    mask = (k_pos < limit)[:, None, None]                        # [B,1,1,T,S]
    # a Python scalar, not a device tensor made from one: that copy from
    # pageable memory would synchronize the stream at every layer
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    out = torch.einsum("bgrts,bsgd->btgrd", probs, v_cache.float())
    return out.reshape(b, t, n_heads, d).to(q.dtype)
