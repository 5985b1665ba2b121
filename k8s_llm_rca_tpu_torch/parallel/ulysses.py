"""Ulysses sequence parallelism: an all-to-all between the sequence and
the heads; the port of ``k8s_llm_rca_tpu/parallel/ulysses.py``.

Activations arrive sequence-sharded over the ``seq`` axis.  One
all-to-all per tensor re-shards them to head-sharded with the whole
sequence on each rank, plain causal attention runs locally over the
rank's n_heads/P heads, and one all-to-all restores the sequence shard:
two collective rounds per attention instead of the ring's P steps.

The local attention is ``ops.flash_attention``: the flash kernel on the
card (over the rank's heads and the whole padded sequence), and on the CPU
its plain version, ``ops.attention.causal_attention``, the function JAX's
body calls.  The port is SPMD: each rank passes its own sequence block
[B, S/P, h, d] and gets its own block back.
"""

from __future__ import annotations

from typing import Optional

import torch

from k8s_llm_rca_tpu_torch.ops.attention import repeat_kv
from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention
from k8s_llm_rca_tpu_torch.parallel.ring_attention import _global_heads
from k8s_llm_rca_tpu_torch.runtime.mesh import (
    all_to_all, axis_group, axis_size,
)


def _ulysses_local(q, k, v, group, n_dev: int):
    """q/k/v [B, S/P, H, D] -> out [B, S/P, H, D].

    KV heads stay unexpanded through the all-to-all when they divide the
    axis size (rank r's q-head block [r*H/P, (r+1)*H/P) maps onto kv-head
    block [r*Kv/P, (r+1)*Kv/P) under blockwise GQA grouping), otherwise
    they are expanded first."""
    if k.shape[2] % n_dev != 0:
        n_rep = q.shape[2] // k.shape[2]
        k = repeat_kv(k, n_rep)
        v = repeat_kv(v, n_rep)

    def to_heads(x):                   # split heads, concat sequence
        return all_to_all(x, group, split_dim=2, concat_dim=1)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)   # [B, S, H/P, D]
    b, s = qh.shape[:2]
    seq_lens = torch.full((b,), s, dtype=torch.int32, device=q.device)
    out = flash_attention(qh, kh, vh, seq_lens)          # GQA inside
    return all_to_all(out, group, split_dim=1, concat_dim=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, seq_axis: str = "seq",
                      head_axis: Optional[str] = None,
                      global_heads=None) -> torch.Tensor:
    """Causal attention with the sequence sharded over ``seq_axis`` through
    head<->sequence all-to-alls, on THIS rank's block: q [B, S/P, h, d],
    k/v [B, S/P, kv, d] -> [B, S/P, h, d].  The rank's heads must divide
    the axis size (GQA kv heads are expanded first when they do not).

    ``head_axis``: the second mesh axis that shards the heads (CP x TP):
    each model shard runs the all-to-all on its own head block, so the
    model's n_heads / tp (``global_heads``, default this rank's times the
    axis) must still divide the ``seq_axis`` size."""
    axis = axis_size(mesh, seq_axis)
    n_heads, n_kv, n_tp = _global_heads(q, k, mesh, head_axis, global_heads)
    if n_heads % n_tp or (head_axis is not None and n_kv % n_tp):
        raise ValueError(
            f"heads {n_heads}/{n_kv} not divisible by "
            f"{head_axis}={n_tp}")
    if (n_heads // n_tp) % axis:
        raise ValueError(
            f"n_heads {n_heads}/{n_tp} per shard not divisible by "
            f"{seq_axis}={axis}")
    return _ulysses_local(q, k, v, axis_group(mesh, seq_axis), axis)
