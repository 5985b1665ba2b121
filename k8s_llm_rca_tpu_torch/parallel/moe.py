"""Expert parallelism: hard top-k dispatch with an all-to-all token
exchange; the port of ``k8s_llm_rca_tpu/parallel/moe.py``.

Experts are sharded over the ``expert`` mesh axis and tokens over
``data`` x ``expert``.  Each rank routes its own token slice, packs the
tokens into per-expert capacity slots, exchanges them with one all-to-all
so every rank holds exactly the slots of ITS experts, runs its experts'
MLPs, reverses the exchange, combines, and all-gathers the token slices
back so every rank holds the whole (replicated) activations again, as the
next attention needs them.

JAX packs and unpacks through one-hot ``[T, E, C]`` dispatch and combine
tensors (static shapes for XLA).  The port indexes the same slots
directly (``_route_slots``: expert, slot and weight of every (lane,
token) pair; a [T, E, C] tensor at a Mixtral prefill would be gigabytes)
and ``_route_exact`` densifies them into JAX's two tensors.  Slots fill in
JAX's order: lane 0 of every token first, then lane 1, each expert's
slots in token order; a pair past its expert's capacity is dropped.
With ``capacity_factor = n_experts`` (JAX's serving capacity) nothing
drops and the result is the dense soft-dispatch MoE.  Serving
(``moe_mlp_ep``) takes the least lossless capacity, one slot per local
token and expert, and combines in the dense form's einsum, so on one
rank it repeats the dense MoE's arithmetic.

The local experts' MLP (``"ech,ehi->eci"``) runs through the per-expert
form of the stacked-expert matmul ([1, C, E_local, K], the ekn kernels of
``ops.quant_matmul`` on the card) when ``fused`` and the weights are
quantized, and ``torch.einsum`` over the dequantized weights otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from k8s_llm_rca_tpu_torch.ops.quant_matmul import (
    qmm, qmm_experts, quant_matmul_experts_plain, quant_matmul_plain,
)
from k8s_llm_rca_tpu_torch.runtime.mesh import (
    all_gather, all_to_all, axis_group, axis_rank, axis_size,
)


def _route_slots(router_logits: torch.Tensor, top_k: int, capacity: int
                 ) -> Tuple[torch.Tensor, ...]:
    """router_logits [T, E] f32 -> (experts [K*T], slots [K*T], weights
    [K*T] f32, keep [K*T] bool), lane-major (entry k*T + t is token t's
    k-th choice).  Top-k as ``jax.lax.top_k`` (the lower index first among
    equal logits), softmax over the chosen logits, and each entry's slot
    the count of earlier entries routed to the same expert."""
    from k8s_llm_rca_tpu_torch.models.llama import _moe_route

    n_experts = router_logits.shape[-1]
    topi, _ = _moe_route(router_logits, top_k)                   # [T, K]
    weights = torch.softmax(router_logits.gather(-1, topi), dim=-1)
    experts = topi.t().reshape(-1)                               # [K*T]
    onehot = F.one_hot(experts, n_experts)
    slots = (onehot.cumsum(0) * onehot).sum(-1) - 1
    return experts, slots, weights.t().reshape(-1), slots < capacity


def _route_exact(x: torch.Tensor, router_w, n_experts: int, top_k: int,
                 capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's dispatch and combine [T, E, C] (f32) of tokens x [T, H] under
    the plain router weight ``router_w`` [H, E]: dispatch[t, e, c] is 1
    where token t fills slot c of expert e, combine holds its router
    weight there."""
    t = x.shape[0]
    logits = quant_matmul_plain(x, router_w).float()
    experts, slots, weights, keep = _route_slots(logits, top_k, capacity)
    tokens = torch.arange(t, device=x.device).repeat(top_k)
    dispatch = torch.zeros((t, n_experts, capacity), dtype=torch.float32,
                           device=x.device)
    combine = torch.zeros_like(dispatch)
    idx = (tokens[keep], experts[keep], slots[keep])
    dispatch[idx] = 1.0
    combine[idx] = weights[keep]
    return dispatch, combine


def _expert_mlp(x: torch.Tensor, layer: Dict, fused: bool) -> torch.Tensor:
    """x [E_local, C, H] through the local experts' SwiGLU MLPs, in the
    per-expert einsum form ([1, C, E_local, K] x [E_local, K, N])."""
    experts = qmm_experts if fused else quant_matmul_experts_plain
    xe = x.transpose(0, 1).contiguous()[None]                    # [1,C,E,H]
    h = F.silu(experts(xe, layer["w_gate"]))
    h = h * experts(xe, layer["w_up"])
    return experts(h, layer["w_down"])[0].transpose(0, 1)        # [E,C,H]


def _moe_local(x: torch.Tensor, layer: Dict, group, n_experts: int,
               top_k: int, capacity: int, fused: bool,
               drops: Optional[torch.Tensor]) -> torch.Tensor:
    """One rank's tokens x [T_local, H] through the exchange: route, pack
    into [E, C, H], all-to-all to [E/P, P*C, H] (this rank's experts, every
    rank's slots), the local experts, the reverse exchange, combine.
    ``drops`` (a device scalar) gains the pairs dropped past capacity."""
    t, h = x.shape
    p = torch.distributed.get_world_size(group)
    router = qmm if fused else quant_matmul_plain
    experts, slots, weights, keep = _route_slots(
        router(x, layer["router"]).float(), top_k, capacity)
    tokens = torch.arange(t, device=x.device).repeat(top_k)
    if drops is not None:
        drops.add_((~keep).sum())
    # pack: a dropped pair writes nothing (its index goes to a spare slot)
    flat = torch.where(keep, experts * capacity + slots,
                       torch.full_like(slots, n_experts * capacity))
    packed = torch.zeros((n_experts * capacity + 1, h), dtype=x.dtype,
                         device=x.device)
    packed[flat] = x[tokens]
    inputs = packed[:-1].reshape(n_experts, capacity, h)
    # exchange: rank j gets experts [j*E/P, (j+1)*E/P) of every rank
    e_local = n_experts // p
    recv = all_to_all(inputs, group)                   # [P*E/P, C, H]
    recv = recv.reshape(p, e_local, capacity, h).transpose(0, 1).reshape(
        e_local, p * capacity, h)
    out = _expert_mlp(recv, layer, fused)                         # [E/P,P*C,H]
    # reverse exchange: slot block j goes back to rank j
    out = out.reshape(e_local, p, capacity, h).transpose(0, 1)
    back = all_to_all(out, group).reshape(n_experts * capacity, h)
    # combine in the dense form's einsum: each kept pair's output at
    # (token, expert) with its router weight in x's dtype, zeros elsewhere
    # (a dropped pair goes to a spare row)
    at = torch.where(keep, tokens * n_experts + experts,
                     torch.full_like(experts, t * n_experts))
    per_expert = torch.zeros((t * n_experts + 1, h), dtype=x.dtype,
                             device=x.device)
    per_expert[at] = back[torch.where(keep, flat, torch.zeros_like(flat))]
    dense_w = torch.zeros((t * n_experts + 1,), dtype=torch.float32,
                          device=x.device)
    dense_w[at] = weights
    return torch.einsum("bseh,bse->bsh",
                        per_expert[:-1].reshape(1, t, n_experts, h),
                        dense_w[:-1].reshape(1, t, n_experts).to(x.dtype))[0]


def expert_parallel_moe(x: torch.Tensor, layer: Dict, mesh, top_k: int,
                        capacity_factor: float = 2.0,
                        expert_axis: str = "expert",
                        data_axis: str = "data", fused: bool = False,
                        drops: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """MoE forward with experts sharded over ``expert_axis`` and tokens over
    ``data_axis`` x ``expert_axis``, on THIS rank.

    x [B, S, H] is the whole batch (the same on every rank); ``layer``
    holds ``router`` [H, E] whole and this rank's experts of the stacked
    ``w_gate``/``w_up`` [E/P, H, I] and ``w_down`` [E/P, I, H] (their
    leading expert dim sharded, ``runtime.sharding.shard_params``).
    ``drops``: a device scalar that counts the (lane, token) pairs dropped
    past capacity, without a sync (a captured graph's replays add to it).
    Returns [B, S, H] on every rank."""
    b, s, h = x.shape
    e = layer["router"].shape[-1]
    tok_axes = (data_axis, expert_axis)
    n_tok_shards = axis_size(mesh, tok_axes)
    if (b * s) % n_tok_shards:
        raise ValueError(
            f"tokens {b * s} not divisible by data*expert={n_tok_shards}")
    if e % axis_size(mesh, expert_axis):
        raise ValueError(f"n_experts={e} not divisible by expert axis "
                         f"{axis_size(mesh, expert_axis)}")
    tokens_local = (b * s) // n_tok_shards
    capacity = max(1, int(capacity_factor * tokens_local * top_k / e))
    r = axis_rank(mesh, tok_axes)
    flat = x.reshape(b * s, h)[r * tokens_local:(r + 1) * tokens_local]
    out = _moe_local(flat, layer, axis_group(mesh, expert_axis), e, top_k,
                     capacity, fused, drops)
    return all_gather(out, axis_group(mesh, tok_axes), dim=0).reshape(b, s, h)


def moe_mlp_ep(cfg, layer: Dict, x: torch.Tensor) -> torch.Tensor:
    """The MoE MLP of a rank under EP (``RankModelConfig.ep``) at the least
    lossless capacity: as many slots per expert as the rank has tokens (a
    token picks an expert once), so serving under EP computes the dense
    soft-dispatch MoE and the drops it counts (``cfg.ep.drops``) stay 0.
    JAX's ``models/llama.py::_mlp`` takes twice that (``capacity_factor =
    n_experts``); the experts then run on as many rows as the dense form's
    and no more."""
    return expert_parallel_moe(
        x, layer, cfg.ep.mesh, top_k=cfg.n_experts_per_tok,
        capacity_factor=cfg.n_experts / cfg.n_experts_per_tok,
        fused=cfg.fused_quant_matmul, drops=cfg.ep.drops)
