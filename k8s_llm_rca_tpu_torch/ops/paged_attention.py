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
fallback: a CUDA input the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from k8s_llm_rca_tpu_torch.ops import build
from k8s_llm_rca_tpu_torch.ops.attention import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_REP = 8           # query heads per kv-head the kernel holds (kMaxRep)
_HEAD_DIMS = (64, 128)     # the configs' head_dims (TINY, LLAMA3_8B)
_SPLIT_TOKENS = 256    # tokens per pass-1 block of the kernel (kChunk)


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
    n_split = -(-pps * page_size // _SPLIT_TOKENS)
    out = torch.empty_like(q)
    # per (sequence, head, split): max, sum and a d-wide accumulator
    scratch = torch.empty(b * n_heads * n_split * (d + 2),
                          dtype=torch.float32, device=q.device)
    rc = _launcher()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b, n_heads, kv_dim // d, d, page_size, pps,
        n_split, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
