"""Ring attention: context parallelism over the ``seq`` mesh axis; the port
of ``k8s_llm_rca_tpu/parallel/ring_attention.py``.

Each rank holds one contiguous block of the sequence (its queries stay put)
while the key/value blocks travel around the ring of the ``seq`` group, one
``runtime.mesh.ppermute`` per step, with a flash-style online softmax in
f32 so the [S, S] score matrix never exists on one rank.  Causality holds
per block pair (a key block wholly in a query block's future is masked
out) and elementwise inside the diagonal block.

JAX runs the body under ``shard_map`` on the global views; the port is
SPMD, so each rank calls ``ring_attention`` with its own block [B, S/P, h,
d] and gets its own block of the output.  The body is plain torch, as
JAX's is plain XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from k8s_llm_rca_tpu_torch.ops.attention import NEG_INF
from k8s_llm_rca_tpu_torch.runtime.mesh import (
    axis_group, axis_rank, axis_size, ppermute,
)


def _block_attention_step(q, k, v, q_pos, k_pos, acc, m, l):
    """One online-softmax accumulation step.

    q [B, Sq, H, D]; k/v [B, Skv, Kv, D], kv heads NOT expanded (grouped
    einsums carry GQA, so the ring moves 1/n_rep of the bytes); q_pos [Sq],
    k_pos [Skv]; acc [B, Sq, H, D] f32; m, l [B, Sq, H] f32 running max and
    denominator.  A row with no visible key so far keeps m = NEG_INF and
    weight 0."""
    b, sq, n_heads, d = q.shape
    n_kv = k.shape[2]
    n_rep = n_heads // n_kv
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    qg = q.float().reshape(b, sq, n_kv, n_rep, d)
    scores = torch.einsum("bqgrd,bkgd->bqgrk", qg, k.float()).reshape(
        b, sq, n_heads, -1) * scale                             # [B,Sq,H,Skv]
    causal = (q_pos[:, None] >= k_pos[None, :])[None, :, None, :]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    scores = torch.where(causal, scores, neg)

    m_new = torch.maximum(m, scores.amax(-1))                   # [B,Sq,H]
    # guard fully masked rows (m_new == NEG_INF): keep them at zero weight
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    m_safe = torch.where(m_new <= NEG_INF / 2, zero, m_new)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(causal, p, zero)
    correction = torch.where(m <= NEG_INF / 2, zero, torch.exp(m - m_safe))
    l_new = l * correction + p.sum(-1)
    pg = p.reshape(b, sq, n_kv, n_rep, -1)
    upd = torch.einsum("bqgrk,bkgd->bqgrd", pg, v.float()).reshape(
        b, sq, n_heads, d)
    acc_new = acc * correction[..., None] + upd
    return acc_new, m_new, l_new


def _global_heads(q, k, mesh, head_axis: Optional[str],
                  global_heads) -> Tuple[int, int, int]:
    """The model's (n_heads, n_kv) and the head axis size: this rank's
    heads times the axis, unless ``global_heads`` names them."""
    n_tp = axis_size(mesh, head_axis) if head_axis is not None else 1
    n_heads, n_kv = global_heads or (q.shape[2] * n_tp, k.shape[2] * n_tp)
    return n_heads, n_kv, n_tp


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   seq_axis: str = "seq", head_axis: Optional[str] = None,
                   global_heads=None) -> torch.Tensor:
    """Causal self-attention with the sequence sharded over ``seq_axis``,
    on THIS rank's block: q [B, S/P, h, d], k/v [B, S/P, kv, d], block p
    of the sequence on the rank at position p of the axis.  Returns its
    block of the output, [B, S/P, h, d] in q's dtype.

    A static loop of P steps: attend to the key block held, then pass it
    on (``ppermute`` of k and v, rank i to rank i + 1), so at step s the
    rank holds the block of rank p - s.

    ``head_axis``: the second mesh axis that shards the heads (CP x TP):
    the ring runs per head shard on the rank's own heads.  The model's
    ``global_heads`` (n_heads, n_kv; default this rank's times the axis)
    must both divide it, as the ring carries unexpanded GQA KV."""
    if head_axis is not None:
        n_heads, n_kv, n_tp = _global_heads(q, k, mesh, head_axis,
                                            global_heads)
        if n_heads % n_tp or n_kv % n_tp:
            raise ValueError(
                f"heads {n_heads}/{n_kv} not divisible by "
                f"{head_axis}={n_tp}")
    group = axis_group(mesh, seq_axis)
    n_dev = axis_size(mesh, seq_axis)
    my = axis_rank(mesh, seq_axis)
    b, s_local, n_heads, d = q.shape
    dev = q.device

    q_pos = my * s_local + torch.arange(s_local, device=dev)
    acc = torch.zeros((b, s_local, n_heads, d), dtype=torch.float32,
                      device=dev)
    m = torch.full((b, s_local, n_heads), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, s_local, n_heads), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for s in range(n_dev):                     # static unroll over ring steps
        src = (my - s) % n_dev                 # owner of the block we hold
        k_pos = src * s_local + torch.arange(s_local, device=dev)
        acc, m, l = _block_attention_step(q, k_cur, v_cur, q_pos, k_pos,
                                          acc, m, l)
        k_cur = ppermute(k_cur, group, 1)
        v_cur = ppermute(v_cur, group, 1)
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.to(q.dtype)
