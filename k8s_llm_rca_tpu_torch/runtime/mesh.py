"""Device mesh, process groups and collectives: the port of
``k8s_llm_rca_tpu/runtime/mesh.py``.

JAX is single-controller: one process places every shard with
``NamedSharding`` and GSPMD inserts the collectives.  PyTorch is SPMD: one
process per rank, each holding only its shard, each calling the
collectives itself.  So here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, shaped ``MeshConfig.shape`` with the JAX axis names
(``data``, ``fsdp``, ``model``, ``expert``, ``seq``, ``stage``).  Axes of
size 1 are kept, so a rule written for a wide mesh resolves unchanged on
one rank.

- ``initialize_distributed`` joins the default process group: ``nccl`` on
  the card, ``gloo`` when the caller asks for the CPU, always with an
  explicit timeout.  One rank needs no rendezvous (an in-memory store).
- ``run_ranks`` runs a function on N local ranks (``torch.multiprocessing``
  spawn, a ``file://`` rendezvous under a caller-given directory, a join
  timeout that raises): the tests' and ``chip_smoke.py``'s stand-in for
  JAX's ``cpu_mesh_for_tests``.
- The collectives the sharded model calls (sum and max all-reduce,
  all-gather along an axis, as parts or into one buffer, the sum
  reduce-scatter, all-to-all along any split and concat dims, the ring
  step ``ppermute``, and the broadcast of the prefix store's L2 decision)
  count their calls in ``.calls``,
  as the kernel wrappers count launches, so a run can prove that the
  sharded path ran.  They are called on every rank in the same order; a
  size-1 group still calls the backend, except ``ppermute``'s (a rank
  cannot send to itself: the step is a copy).
"""

from __future__ import annotations

import datetime
import os
import time
import uuid
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from k8s_llm_rca_tpu_torch.config import MeshConfig
from k8s_llm_rca_tpu_torch.utils.device import resolve_device

# seconds a collective (and a rendezvous) may wait before it raises
DEFAULT_TIMEOUT_S = 60.0

Axes = Union[str, Sequence[str]]


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: int = 1, rank: int = 0, device=None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the default process group as ``rank`` of ``world_size``:
    ``nccl`` when ``device`` is the card (``None``), ``gloo`` for the CPU.
    ``init_method`` is the rendezvous (``file://...`` or
    ``tcp://localhost:<port>``); one rank needs none.  Returns False when a
    group already exists (nothing is changed)."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is None:
        if world_size != 1:
            raise ValueError(f"{world_size} ranks need an init_method "
                             f"(file:// or tcp://localhost:<port>)")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
    return True


def shutdown_distributed() -> None:
    """Destroy the default process group (and every mesh built on it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH_GROUPS.clear()


def build_mesh(cfg: MeshConfig, ranks: Optional[Sequence[int]] = None,
               device=None):
    """The 6-axis mesh of ``cfg`` over ``ranks`` (default: every rank of the
    default group, in order; the fastest-varying axes are the last ones,
    as JAX lays devices out).  Every rank of the group must call it."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group: call "
                           "initialize_distributed first (or run under "
                           "run_ranks)")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if len(ranks) != cfg.n_devices:
        raise ValueError(f"mesh {cfg.shape} needs {cfg.n_devices} devices, "
                         f"have {len(ranks)}")
    kind = "cpu" if dist.get_backend() == "gloo" else resolve_device(
        device).type
    return DeviceMesh(kind, torch.tensor(ranks).reshape(cfg.shape),
                      mesh_dim_names=cfg.axis_names)


def local_mesh(model: int = 1, data: int = 1, expert: int = 1, seq: int = 1,
               stage: int = 1, fsdp: int = 1, device=None):
    """A mesh from axis sizes over the ranks of the default group."""
    return build_mesh(MeshConfig(data=data, fsdp=fsdp, model=model,
                                 expert=expert, seq=seq, stage=stage),
                      device=device)


def single_device_mesh(device=None):
    """A mesh of one rank, every axis of size 1 (specs still resolve)."""
    return build_mesh(MeshConfig(), ranks=[dist.get_rank()], device=device)


# ---------------------------------------------------------------------------
# axes of a mesh
# ---------------------------------------------------------------------------


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes: Axes) -> int:
    """The number of ranks along ``axes`` (one name or several, flattened)."""
    names = mesh.mesh_dim_names
    n = 1
    for a in _axes(axes):
        if a not in names:
            raise ValueError(f"mesh has no '{a}' axis (axes {names})")
        n *= mesh.mesh.shape[names.index(a)]
    return n


def axis_rank(mesh, axes: Axes) -> int:
    """This rank's index along ``axes`` (several axes flatten major to
    minor, as a JAX spec entry ``("data", "expert")`` does)."""
    names = mesh.mesh_dim_names
    idx = 0
    for a in _axes(axes):
        idx = idx * mesh.mesh.shape[names.index(a)] + mesh.get_local_rank(a)
    return idx


def axis_group(mesh, axes: Axes):
    """The process group of this rank's peers along ``axes``.  Several axes
    make one group per combination of the other axes' coordinates; every
    rank creates every such group the first time (in the same order, as
    ``new_group`` needs), and the mesh keeps this rank's."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_flat_groups", {})
    if axes not in cache:
        names = mesh.mesh_dim_names
        dims = [names.index(a) for a in axes]
        other = [i for i in range(len(names)) if i not in dims]
        rows = mesh.mesh.permute(*other, *dims).reshape(
            -1, axis_size(mesh, axes)).tolist()
        me = dist.get_rank()
        for row in rows:
            group = dist.new_group(row)
            if me in row:
                cache[axes] = group
    return cache[axes]


_MESH_GROUPS: dict = {}


def mesh_group(mesh):
    """The process group of all of ``mesh``'s ranks: None (the default
    group) when the mesh spans the world, else a group of the mesh's ranks
    alone.  A rank outside the mesh does not know of it, so the group is
    made with ``use_local_synchronization`` (only its members enter
    ``new_group``), once per set of ranks (torch names such a group by its
    ranks)."""
    ranks = sorted(int(r) for r in mesh.mesh.flatten().tolist())
    if len(ranks) == dist.get_world_size():
        return None
    key = tuple(ranks)
    if key not in _MESH_GROUPS:
        _MESH_GROUPS[key] = dist.new_group(ranks,
                                           use_local_synchronization=True)
    return _MESH_GROUPS[key]


# ---------------------------------------------------------------------------
# collectives (each counts its calls in ``.calls``)
# ---------------------------------------------------------------------------


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group``, in place; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    all_reduce_sum.calls += 1
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of ``x`` over ``group``, in place; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    all_reduce_max.calls += 1
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (a tiled ``jax.lax.all_gather``).  The list form: gloo takes it for
    CUDA tensors too."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    all_gather.calls += 1
    return torch.cat(parts, dim=dim)


def _on_gloo_card(x: torch.Tensor, group) -> bool:
    """True when ``x`` lies on the card and ``group`` is gloo: its
    point-to-point and all-to-all take host tensors only, so these
    collectives stage through host copies (several ranks on one card)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _pinned(shape, dtype) -> torch.Tensor:
    """A host buffer in page-locked memory (PyTorch's caching host
    allocator keeps it for the next request of its size): a gloo
    collective over card tensors stages through it, the copies at the
    link's rate and with no page faults."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def all_gather_into(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order, as
    ``all_gather``, but gathered into ONE buffer (``all_gather_into_tensor``)
    instead of n parts and a ``torch.cat``: along dim 0 the buffer is the
    result, so each gathered byte is written once.  Along another dim the
    rank-major buffer is moved into place, a second write where both the
    group and the dims before ``dim`` are wider than one.  Over gloo a card
    tensor goes through page-locked host copies."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    staged = _on_gloo_card(x, group)
    shape = (n * x.shape[0], *x.shape[1:])
    if staged:
        send = _pinned(x.shape, x.dtype).copy_(x)
        out = _pinned(shape, x.dtype)
    else:
        send = x
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, send, group=group)
    all_gather_into.calls += 1
    if staged:
        out = out.to(x.device)
    dim %= x.dim()
    if dim == 0:
        return out
    shape = list(x.shape)
    shape[dim] *= n
    return out.view(n, *x.shape).movedim(0, dim).reshape(shape)


def reduce_scatter_sum(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Split ``x`` along ``dim`` into one equal block per rank and return
    this rank's block summed over ``group`` (``reduce_scatter_tensor``):
    the sum all-reduce of ``x`` followed by taking the rank's block, with
    1/n of the result written.  Over gloo a card tensor goes through
    page-locked host copies."""
    n = dist.get_world_size(group)
    dim %= x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split into {n} equal parts")
    # the blocks rank-major: [n, ...block] (a view where dim is 0 or the
    # dims before it are all one)
    blocks = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    send = blocks.contiguous()
    staged = _on_gloo_card(send, group)
    if staged:
        send = _pinned(send.shape, send.dtype).copy_(send)
        out = _pinned(send.shape[1:], send.dtype)
    else:
        out = torch.empty(send.shape[1:], dtype=send.dtype,
                          device=send.device)
    dist.reduce_scatter_tensor(out, send.view(-1, *send.shape[2:]),
                               op=dist.ReduceOp.SUM, group=group)
    reduce_scatter_sum.calls += 1
    return out.to(x.device) if staged else out


def all_to_all(x: torch.Tensor, group, split_dim: int = 0,
               concat_dim: int = 0) -> torch.Tensor:
    """Split ``x`` along ``split_dim`` into one equal chunk per rank, send
    chunk j to rank j, and return the chunks received, in rank order,
    concatenated along ``concat_dim``: JAX's ``all_to_all(tiled=True)``.
    The default dims (0, 0) are ``all_to_all_single``.  Over gloo a card
    tensor goes through a host copy."""
    n = dist.get_world_size(group)
    tiled = bool(split_dim % x.dim() or concat_dim % x.dim())
    if tiled:
        x = torch.stack(x.chunk(n, dim=split_dim))       # [n, ...chunk]
    x = x.contiguous()
    staged = _on_gloo_card(x, group)
    send = x.cpu() if staged else x
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    all_to_all.calls += 1
    if staged:
        out = out.to(x.device)
    if tiled:
        return torch.cat(out.unbind(0), dim=concat_dim)
    return out


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """One ring step: send ``x`` to the rank ``shift`` places on in
    ``group`` and return what the rank ``shift`` places back sent
    (JAX's ``ppermute`` with the pairs (i, i + shift)), as one
    ``batch_isend_irecv`` of a send and a receive.  On a one-rank group
    the step is the identity (a copy: a rank cannot send to itself).  Over
    gloo a card tensor goes through a host copy."""
    n = dist.get_world_size(group)
    ppermute.calls += 1
    if n == 1 or shift % n == 0:
        return x.clone()
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    x = x.contiguous()
    staged = _on_gloo_card(x, group)
    send = x.cpu() if staged else x
    out = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device) if staged else out


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of the global rank ``src`` on every rank of ``group``, in
    place; returns ``x``.  Over gloo a card tensor goes through a host
    copy."""
    staged = _on_gloo_card(x, group)
    buf = x.cpu() if staged else x
    dist.broadcast(buf, src=src, group=group)
    broadcast.calls += 1
    if staged:
        x.copy_(buf)
    return x


COLLECTIVES = (all_reduce_sum, all_reduce_max, all_gather, all_to_all,
               ppermute, all_gather_into, reduce_scatter_sum, broadcast)
for _fn in COLLECTIVES:
    _fn.calls = 0


def reset_collective_counts() -> None:
    for fn in COLLECTIVES:
        fn.calls = 0


def collective_counts() -> dict:
    """``{name: calls}`` of every collective."""
    return {fn.__name__: fn.calls for fn in COLLECTIVES}


# ---------------------------------------------------------------------------
# N local ranks
# ---------------------------------------------------------------------------


def _rank_main(rank: int, fn: Callable, nprocs: int, init_file: str,
               result_file: str, args: tuple, timeout_s: float,
               device: str) -> None:
    torch.set_num_threads(1)
    if device == "cuda":            # nccl: one card per rank
        device = f"cuda:{rank % torch.cuda.device_count()}"
    initialize_distributed(f"file://{init_file}", nprocs, rank, device,
                           timeout_s)
    try:
        out = fn(rank, *args)
        torch.save(out, result_file.format(rank=rank))
    finally:
        shutdown_distributed()


def run_ranks(fn: Callable[..., Any], nprocs: int, workdir: str,
              args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S,
              device="cpu") -> list:
    """Run ``fn(rank, *args)`` on ``nprocs`` spawned local ranks joined in
    one process group and return each rank's result (``torch.save``-able),
    in rank order.  ``device``: "cpu" (gloo), "cuda" (nccl, rank r on card
    r, as many cards as ranks) or "cuda-gloo" (gloo over CUDA tensors,
    every rank on the current card: several ranks on one card, which nccl
    refuses).

    ``fn`` must be importable by the spawned ranks (a module-level
    function).  The rendezvous is a file under ``workdir``, so parallel
    callers never race for a port.  If the ranks have not all returned
    within ``timeout_s`` seconds (a hung collective) they are killed and
    ``TimeoutError`` is raised; a rank that raises re-raises here."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    tag = uuid.uuid4().hex
    init_file = os.path.join(workdir, f"pg-{tag}")
    result_file = os.path.join(workdir, f"rank{{rank}}-{tag}.pt")
    # the group's backend: gloo for "cpu" and "cuda-gloo" (CUDA tensors
    # through gloo: several ranks on one card, which nccl refuses)
    backend_device = "cpu" if device in ("cpu", "cuda-gloo") else device
    ctx = mp.start_processes(
        _rank_main, args=(fn, nprocs, init_file, result_file, args,
                          timeout_s, backend_device),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{nprocs} ranks of {getattr(fn, '__name__', fn)} did "
                    f"not finish within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [torch.load(result_file.format(rank=r), weights_only=False)
            for r in range(nprocs)]
