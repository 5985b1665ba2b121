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
and takes ``paged_attention_plain`` only for CPU tensors.  There is no
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


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, lengths: torch.Tensor,
                          block_tables: torch.Tensor) -> torch.Tensor:
    """Gather + masked softmax (the counterpart of ``paged_attention_xla``)."""
    b, n_heads, d = q.shape
    _, page_size, kv_dim = k_pages.shape
    n_kv = kv_dim // d
    n_rep = n_heads // n_kv
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, -1, n_kv, d)          # [B, S_max, n_kv, d]
    v = v_pages[tables].reshape(b, -1, n_kv, d)
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
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
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


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, lengths: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """Decode attention over a paged pool: [B, n_heads, d].

    CPU tensors take ``paged_attention_plain``; CUDA tensors launch the
    kernel on the current stream (``paged_attention.launches`` counts the
    launches) or raise."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, lengths,
                                     block_tables)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check(q, k_pages, v_pages, lengths, block_tables)
    b, n_heads, d = q.shape
    _, page_size, kv_dim = k_pages.shape
    pps = block_tables.shape[1]
    n_split = max_splits(kv_dim // d, pps * page_size, _sm_count(q.device))
    out = torch.empty_like(q)
    rc = _launcher()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(), b,
        n_heads, kv_dim // d, d, page_size, pps, n_split, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


# ---------------------------------------------------------------------------
# quantized pools
# ---------------------------------------------------------------------------


def gather_dequant_pages(pages: torch.Tensor, scales: torch.Tensor,
                         block_tables: torch.Tensor, n_kv: int, d: int, dtype,
                         packed: bool) -> torch.Tensor:
    """A dense per-sequence view [B, S_max, n_kv, d] of a quantized pool
    (``engine/paged.py::_gather_dequant_pages``): gather the table's pages
    and their scales, unpack, and dequantize in ``dtype``."""
    tables = block_tables.long()
    kv = dequant_kv(pages[tables], scales[tables], dtype, packed)
    return kv.reshape(tables.shape[0], -1, n_kv, d)


def paged_attention_quant_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, k_scales: torch.Tensor,
                                v_scales: torch.Tensor, lengths: torch.Tensor,
                                block_tables: torch.Tensor,
                                packed: bool = False) -> torch.Tensor:
    """Gather, dequantize, masked softmax: [B, n_heads, d] in q's dtype.
    The pages dequantize in f32, where ``decode_attention`` computes (and
    where XLA keeps the JAX engine's dequantized pages inside its jitted
    step)."""
    d = q.shape[2]
    n_kv = k_pages.shape[2] * (2 if packed else 1) // d
    k = gather_dequant_pages(k_pages, k_scales, block_tables, n_kv, d,
                             torch.float32, packed)
    v = gather_dequant_pages(v_pages, v_scales, block_tables, n_kv, d,
                             torch.float32, packed)
    return decode_attention(q[:, None], k, v, lengths)[:, 0]


@functools.lru_cache(maxsize=None)
def _quant_launcher():
    fn = build.load("paged_attention_quant").paged_attention_quant_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
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
                          packed: bool = False) -> torch.Tensor:
    """Decode attention over a quantized paged pool: [B, n_heads, d].

    CPU tensors take ``paged_attention_quant_plain``; CUDA tensors launch
    the kernel on the current stream (``paged_attention_quant.launches``
    counts the launches) or raise."""
    if q.device.type == "cpu":
        return paged_attention_quant_plain(q, k_pages, v_pages, k_scales,
                                           v_scales, lengths, block_tables,
                                           packed)
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
    rc = _quant_launcher()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr(), v_scales.data_ptr(), lengths.data_ptr(),
        block_tables.data_ptr(), out.data_ptr(), b, n_heads, n_kv, d,
        page_size, pps, n_split, int(packed),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_quant kernel launch failed: "
                           f"CUDA error {rc}")
    paged_attention_quant.launches += 1
    return out


paged_attention_quant.launches = 0
