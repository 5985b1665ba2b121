"""Paged decode attention: the hand-written CUDA kernel and its plain version.

The counterpart of ``k8s_llm_rca_tpu/ops/paged_attention.py::paged_attention``.
One query token per sequence attends over that sequence's KV pages in the
shared pool; keys at or past the sequence's length are masked.  Layouts
are the JAX package's:

- ``q`` [B, n_heads, d];
- ``k_pages``/``v_pages`` [n_pages, page_size, n_kv*d], kv-heads merged on
  the last axis (the engine passes one layer of its pool);
- ``lengths`` [B] int32, valid tokens including the current one;
- ``block_tables`` [B, pages_per_seq] int32 page ids (``TRASH_PAGE`` = 0
  past a sequence's pages).

``paged_attention`` launches ``csrc/paged_attention.cu`` for CUDA tensors
and takes ``paged_attention_plain`` only for CPU tensors.  With
``return_lse`` both also return each row's log-sum-exp [B, n_heads] f32
(natural log of the softmax denominator over the scaled scores; -1e30 and
a zero output for a row with no key), by which a context-parallel rank's
partial outputs over its own pages merge (``merge_partials``).  There is no
fallback: a CUDA input the kernel does not take raises.  Each call is one
launch: a thread block cluster of up to ``max_splits`` splits per (kv-head,
sequence) that merge through distributed shared memory (the body is
``csrc/paged_attention.cuh``); no scratch is allocated.

``paged_attention_quant`` is the same over a quantized pool (the
counterpart of ``paged_attention_quant``): int8 pages [.., n_kv*d], or
split-half int4 pages [.., n_kv*d/2] when ``packed``, with one f32 scale
per token in ``k_scales``/``v_scales`` [n_pages, page_size].  It launches
``csrc/paged_attention_quant.cu`` for CUDA tensors and takes
``paged_attention_quant_plain`` for CPU tensors: the gather, dequantize
and masked softmax of the JAX engine's path without the kernel
(``engine/paged.py::_gather_dequant_pages`` + ``decode_attention``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from k8s_llm_rca_tpu_torch.models.quant import dequant_kv
from k8s_llm_rca_tpu_torch.ops import build
from k8s_llm_rca_tpu_torch.ops.attention import NEG_INF, decode_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_REP = 8           # query heads per kv-head the kernel holds (kMaxRep)
_HEAD_DIMS = (32, 64, 128)  # TINY is 32, LLAMA3_8B 128
_MAX_SPLITS = 8        # blocks of one cluster (kMaxSplits, portable)
_MIN_SPLIT_TOKENS = 256     # 32 tokens for each of a block's 8 warps
_BLOCKS_PER_SM = 2     # resident blocks an SM holds (kernel launch bounds)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def max_splits(n_kv: int, table_tokens: int, sm_count: int) -> int:
    """The most splits the kernel takes for a table of ``table_tokens``
    (pages_per_seq * page_size): enough that a full table's n_kv clusters
    give about one wave of busy blocks on ``sm_count`` SMs at two blocks an
    SM, at most one portable cluster of 8, at least 256 tokens a split.
    The kernel launches fewer when the batch's n_kv * B clusters would not
    all be resident at once, and splits the table into equal runs that are
    a multiple of its 8 warps (``paged::split_chunk``)."""
    return max(1, min(_MAX_SPLITS, -(-_BLOCKS_PER_SM * sm_count // n_kv),
                      -(-table_tokens // _MIN_SPLIT_TOKENS)))


def launched_splits(q: torch.Tensor, k_pages: torch.Tensor,
                    block_tables: torch.Tensor, packed=None) -> int:
    """The split count a kernel call on these CUDA inputs launches:
    ``max_splits``, or fewer when the batch's n_kv * B clusters would not
    all be resident at once.  ``packed`` None is a float pool, False an
    int8 pool, True an int4 pool."""
    b, n_heads, d = q.shape
    _, page_size, kv_store = k_pages.shape
    n_kv = kv_store * (2 if packed else 1) // d
    pps = block_tables.shape[1]
    n_split = max_splits(n_kv, pps * page_size, _sm_count(q.device))
    lib = build.load("paged_attention" if packed is None
                     else "paged_attention_quant")
    fn = (lib.paged_attention_splits if packed is None
          else lib.paged_attention_quant_splits)
    args = [b, n_heads, n_kv, d, page_size, pps, n_split]
    if packed is not None:
        args.append(int(packed))
    fn.argtypes = ([ctypes.c_int] * (len(args) + 1)
                   + [ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    rc = fn(*args, _DTYPES[q.dtype], ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"paged attention split query failed: CUDA error "
                           f"{rc}")
    return out.value


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor):
    """Query tokens over dense keys, with their log-sum-exp: q [B, n_heads,
    d] (one query a sequence) or [B, T, n_heads, d] (the CP verify step's
    T), k/v [B, S, n_kv, d], ``lengths`` [B] or [B, T]: query i of row b
    over the keys below ``lengths[b, i]``.  In f32, as the kernel: the
    scores' max is the shift (0 for a row with no key), the output is
    acc / l (0 where l is 0), the lse m + log l (-1e30 where l is 0).
    Returns (out in q's dtype, shaped as q; lse [B, n_heads] or [B, T,
    n_heads] f32)."""
    if q.dim() == 3:
        out, lse = attention_lse_plain(q[:, None], k, v, lengths[:, None])
        return out[:, 0], lse[:, 0]
    d = q.shape[3]
    n_rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(n_rep, dim=2).float()
    v = v.repeat_interleave(n_rep, dim=2).float()
    qf = q.float() / torch.sqrt(torch.tensor(float(d)))
    s = torch.einsum("bthd,bkhd->bthk", qf, k)
    k_pos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    valid = k_pos < lengths.to(q.device)[:, :, None, None]
    m = torch.where(valid, s, torch.tensor(NEG_INF, device=q.device)).amax(-1)
    m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    out = torch.einsum("bthk,bkhd->bthd", p, v) / torch.where(
        l == 0, torch.ones_like(l), l)[..., None]
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log(l))
    return out.to(q.dtype), lse


def merge_partials(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Merge P partial attention outputs over disjoint key sets: out [P, B,
    H, d], lse [P, B, H] f32 -> [B, H, d] in out's dtype, each part weighted
    by exp(lse - logsumexp(lse)).  A part with no key (lse -1e30) weighs 0;
    in f32, so one part merges to itself exactly."""
    top = lse.amax(0)
    top = torch.where(top <= NEG_INF / 2, torch.zeros_like(top), top)
    w = torch.exp(lse - top)                              # [P, B, H]
    total = w.sum(0)
    merged = (out.float() * w[..., None]).sum(0) / torch.where(
        total == 0, torch.ones_like(total), total)[..., None]
    return merged.to(out.dtype)


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, lengths: torch.Tensor,
                          block_tables: torch.Tensor,
                          return_lse: bool = False):
    """Gather + masked softmax (the counterpart of ``paged_attention_xla``);
    with ``return_lse`` ``attention_lse_plain`` over the gathered pages."""
    b, n_heads, d = q.shape
    _, page_size, kv_dim = k_pages.shape
    n_kv = kv_dim // d
    n_rep = n_heads // n_kv
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, -1, n_kv, d)          # [B, S_max, n_kv, d]
    v = v_pages[tables].reshape(b, -1, n_kv, d)
    if return_lse:
        return attention_lse_plain(q, k, v, lengths)
    k = k.repeat_interleave(n_rep, dim=2).float()
    v = v.repeat_interleave(n_rep, dim=2).float()
    qf = q.float() / torch.sqrt(torch.tensor(float(d)))
    s = torch.einsum("bhd,bkhd->bhk", qf, k)
    k_pos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    s = torch.where(k_pos < lengths.to(q.device)[:, None, None], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The built kernel's C entry point with its argument types declared
    (without them ctypes would pass each pointer as a 32-bit int)."""
    fn = build.load("paged_attention").paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, lengths, block_tables) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t, dtype in (("k_pages", k_pages, q.dtype),
                           ("v_pages", v_pages, q.dtype),
                           ("lengths", lengths, torch.int32),
                           ("block_tables", block_tables, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if q.dim() != 3 or k_pages.dim() != 3 or k_pages.shape != v_pages.shape:
        raise ValueError(f"q {tuple(q.shape)} must be [B, H, d] and the "
                         f"pools [n_pages, page, n_kv*d], got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    b, n_heads, d = q.shape
    kv_dim = k_pages.shape[2]
    if kv_dim % d or n_heads % (kv_dim // d):
        raise ValueError(f"pool width {kv_dim} is not n_kv * d with n_heads "
                         f"{n_heads} a multiple of n_kv (d = {d})")
    if n_heads // (kv_dim // d) > _MAX_REP or d not in _HEAD_DIMS:
        raise ValueError(f"kernel holds at most {_MAX_REP} query heads per "
                         f"kv-head and head_dim one of {_HEAD_DIMS}")
    if tuple(lengths.shape) != (b,) or block_tables.dim() != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"lengths {tuple(lengths.shape)} / block_tables "
                         f"{tuple(block_tables.shape)} do not match batch {b}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("lengths", lengths), ("block_tables", block_tables)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the pools must be 16-byte aligned (vector loads)")


def _lse_buffer(q: torch.Tensor, return_lse: bool):
    """The kernel's optional [B, n_heads] f32 lse output and its pointer
    (None: the kernel writes none)."""
    if not return_lse:
        return None, None
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    return lse, lse.data_ptr()


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, lengths: torch.Tensor,
                    block_tables: torch.Tensor, *, return_lse: bool = False):
    """Decode attention over a paged pool: [B, n_heads, d], and with
    ``return_lse`` also each row's log-sum-exp [B, n_heads] f32.

    CPU tensors take ``paged_attention_plain``; CUDA tensors launch the
    kernel on the current stream (``paged_attention.launches`` counts the
    launches) or raise."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, lengths,
                                     block_tables, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check(q, k_pages, v_pages, lengths, block_tables)
    b, n_heads, d = q.shape
    _, page_size, kv_dim = k_pages.shape
    pps = block_tables.shape[1]
    n_split = max_splits(kv_dim // d, pps * page_size, _sm_count(q.device))
    out = torch.empty_like(q)
    lse, lse_ptr = _lse_buffer(q, return_lse)
    rc = _launcher()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(), lse_ptr,
        b,
        n_heads, kv_dim // d, d, page_size, pps, n_split, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    return (out, lse) if return_lse else out


paged_attention.launches = 0


# ---------------------------------------------------------------------------
# quantized pools
# ---------------------------------------------------------------------------


def gather_dequant_pages(pages: torch.Tensor, scales: Optional[torch.Tensor],
                         block_tables: torch.Tensor, n_kv: int, d: int, dtype,
                         packed: bool) -> torch.Tensor:
    """A dense per-sequence view [B, S_max, n_kv, d] of a pool
    (``engine/paged.py::_gather_dequant_pages``): gather the table's pages
    and, for a quantized pool, their scales, unpack, and dequantize in
    ``dtype``; ``scales`` None leaves the pages as they are."""
    tables = block_tables.long()
    kv = dequant_kv(pages[tables], None if scales is None else scales[tables],
                    dtype, packed)
    return kv.reshape(tables.shape[0], -1, n_kv, d)


def paged_attention_quant_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, k_scales: torch.Tensor,
                                v_scales: torch.Tensor, lengths: torch.Tensor,
                                block_tables: torch.Tensor,
                                packed: bool = False,
                                return_lse: bool = False):
    """Gather, dequantize, masked softmax: [B, n_heads, d] in q's dtype
    (with ``return_lse``, ``attention_lse_plain`` and the lse).  The pages
    dequantize in f32, where ``decode_attention`` computes (and where XLA
    keeps the JAX engine's dequantized pages inside its jitted step)."""
    d = q.shape[2]
    n_kv = k_pages.shape[2] * (2 if packed else 1) // d
    k = gather_dequant_pages(k_pages, k_scales, block_tables, n_kv, d,
                             torch.float32, packed)
    v = gather_dequant_pages(v_pages, v_scales, block_tables, n_kv, d,
                             torch.float32, packed)
    if return_lse:
        return attention_lse_plain(q, k, v, lengths)
    return decode_attention(q[:, None], k, v, lengths)[:, 0]


@functools.lru_cache(maxsize=None)
def _quant_launcher():
    fn = build.load("paged_attention_quant").paged_attention_quant_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_quant(q, k_pages, v_pages, k_scales, v_scales, lengths,
                 block_tables, packed) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention_quant kernel takes float32 or "
                        f"bfloat16 queries, got {q.dtype}")
    for name, t, dtype in (("k_pages", k_pages, torch.int8),
                           ("v_pages", v_pages, torch.int8),
                           ("k_scales", k_scales, torch.float32),
                           ("v_scales", v_scales, torch.float32),
                           ("lengths", lengths, torch.int32),
                           ("block_tables", block_tables, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k_pages.dim() != 3 or k_pages.shape != v_pages.shape:
        raise ValueError(f"q {tuple(q.shape)} must be [B, H, d] and the "
                         f"pools [n_pages, page, kv], got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if (tuple(k_scales.shape) != tuple(k_pages.shape[:2])
            or k_scales.shape != v_scales.shape):
        raise ValueError(f"scales {tuple(k_scales.shape)} / "
                         f"{tuple(v_scales.shape)} must be [n_pages, page] "
                         f"of the pools {tuple(k_pages.shape)}")
    b, n_heads, d = q.shape
    kv_dim = k_pages.shape[2] * (2 if packed else 1)
    if kv_dim % d or n_heads % (kv_dim // d):
        raise ValueError(f"pool width {kv_dim} is not n_kv * d with n_heads "
                         f"{n_heads} a multiple of n_kv (d = {d})")
    if n_heads // (kv_dim // d) > _MAX_REP or d not in _HEAD_DIMS:
        raise ValueError(f"kernel holds at most {_MAX_REP} query heads per "
                         f"kv-head and head_dim one of {_HEAD_DIMS}")
    if tuple(lengths.shape) != (b,) or block_tables.dim() != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"lengths {tuple(lengths.shape)} / block_tables "
                         f"{tuple(block_tables.shape)} do not match batch {b}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the pools must be 16-byte aligned (vector loads)")


def paged_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, k_scales: torch.Tensor,
                          v_scales: torch.Tensor, lengths: torch.Tensor,
                          block_tables: torch.Tensor, *,
                          packed: bool = False, return_lse: bool = False):
    """Decode attention over a quantized paged pool: [B, n_heads, d], and
    with ``return_lse`` also each row's log-sum-exp [B, n_heads] f32.

    CPU tensors take ``paged_attention_quant_plain``; CUDA tensors launch
    the kernel on the current stream (``paged_attention_quant.launches``
    counts the launches) or raise."""
    if q.device.type == "cpu":
        return paged_attention_quant_plain(q, k_pages, v_pages, k_scales,
                                           v_scales, lengths, block_tables,
                                           packed, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_quant runs on cpu or cuda, not "
                         f"{q.device}")
    _check_quant(q, k_pages, v_pages, k_scales, v_scales, lengths,
                 block_tables, packed)
    b, n_heads, d = q.shape
    _, page_size, kv_store = k_pages.shape
    n_kv = kv_store * (2 if packed else 1) // d
    pps = block_tables.shape[1]
    n_split = max_splits(n_kv, pps * page_size, _sm_count(q.device))
    out = torch.empty_like(q)
    lse, lse_ptr = _lse_buffer(q, return_lse)
    rc = _quant_launcher()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr(), v_scales.data_ptr(), lengths.data_ptr(),
        block_tables.data_ptr(), out.data_ptr(), lse_ptr, b, n_heads, n_kv, d,
        page_size, pps, n_split, int(packed),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_quant kernel launch failed: "
                           f"CUDA error {rc}")
    paged_attention_quant.launches += 1
    return (out, lse) if return_lse else out


paged_attention_quant.launches = 0


# ---------------------------------------------------------------------------
# tensor parallelism: the kernel per head shard
# ---------------------------------------------------------------------------


def _validate_head_shard(n_heads: int, n_kv: int, n_tp: int) -> None:
    if n_heads % n_tp or n_kv % n_tp:
        raise ValueError(
            f"paged attention under TP needs n_heads={n_heads} and "
            f"n_kv={n_kv} divisible by the head axis size {n_tp} "
            f"(GQA groups must stay whole per shard)")


def _local_heads(q: torch.Tensor, lanes: int, mesh, head_axis: str,
                 global_heads) -> None:
    """Check this rank's shard against the model's head counts: both must
    split whole GQA groups over ``head_axis`` and the shard must be this
    rank's share of them."""
    from k8s_llm_rca_tpu_torch.runtime.mesh import axis_size

    n_tp = axis_size(mesh, head_axis)
    h_local, kv_local = q.shape[1], lanes // q.shape[-1]
    n_heads, n_kv = global_heads or (h_local * n_tp, kv_local * n_tp)
    _validate_head_shard(n_heads, n_kv, n_tp)
    if (h_local, kv_local) != (n_heads // n_tp, n_kv // n_tp):
        raise ValueError(
            f"this rank holds {h_local} query and {kv_local} kv heads, not "
            f"its share {n_heads // n_tp}/{n_kv // n_tp} of {n_heads}/{n_kv} "
            f"over {head_axis}={n_tp}")


def paged_attention_sharded(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, lengths: torch.Tensor,
                            block_tables: torch.Tensor, mesh,
                            head_axis: str = "model",
                            global_heads=None, return_lse: bool = False):
    """``paged_attention`` under tensor parallelism, on THIS rank's shard.

    Heads are independent, so each rank runs the kernel over its own
    kv-head shard: q [B, n_heads/t, d] from its column-parallel wq, the
    pool [n_pages, page, n_kv*d/t] holding its heads' lanes (the engine's
    per-rank pool, ``rules.paged_pool_specs``), tables and lengths whole.
    ``global_heads`` (n_heads, n_kv) are the model's counts: both must
    divide the ``head_axis`` size (whole GQA groups per shard).  Returns
    this rank's [B, n_heads/t, d] (JAX's ``shard_map`` out spec)."""
    _local_heads(q, k_pages.shape[-1], mesh, head_axis, global_heads)
    return paged_attention(q, k_pages, v_pages, lengths, block_tables,
                           return_lse=return_lse)


def paged_attention_quant_sharded(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  k_scales: torch.Tensor,
                                  v_scales: torch.Tensor,
                                  lengths: torch.Tensor,
                                  block_tables: torch.Tensor, mesh,
                                  head_axis: str = "model",
                                  global_heads=None,
                                  packed: bool = False,
                                  return_lse: bool = False):
    """``paged_attention_quant`` under tensor parallelism (int8 pools), on
    THIS rank's shard.  The per-token scale is the FULL-row scale (every
    rank writes the max over the TP group, ``quantize_kv(group=...)``), so
    the scale pools are whole on every rank and each shard's dequant is
    exact.

    A split-half int4 pool packed over ALL lanes is refused: byte i pairs
    lane i with lane i + kv_dim/2, so a contiguous lane shard unpacks to
    two unrelated head ranges.  The engine's int4 pool under TP is packed
    per rank over the rank's own lanes (the PP x TP layout), a whole pool
    of its heads, and runs ``paged_attention_quant`` itself."""
    if packed:
        raise ValueError(
            "paged_attention_quant_sharded does not support packed int4 "
            "pools (split-half packing does not commute with the head "
            "shard); pack each rank's lanes on their own and call "
            "paged_attention_quant")
    _local_heads(q, k_pages.shape[-1], mesh, head_axis, global_heads)
    return paged_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                                 lengths, block_tables, return_lse=return_lse)
