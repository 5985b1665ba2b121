"""Causal prefill attention: the hand-written CUDA flash kernel and its plain
version.

The counterpart of ``k8s_llm_rca_tpu/ops/flash_attention.py::flash_attention``:
q [B, S_q, n_heads, d] attends causally to k/v [B, S_k, n_kv, d], with
``q_offset`` [B] placing q[:, 0] at an absolute position (chunked prefill)
and ``seq_lens`` [B] masking padded keys.  ``flash_attention`` launches
``csrc/flash_attention.cu`` for CUDA tensors, reading q/k/v in that layout
through their strides, and takes the plain version
(``ops.attention.causal_attention``) only for CPU tensors.  The JAX engine
gates its kernel to padded prompts of 1024 tokens or more because XLA
materialises the [H, S, S] scores below it; on the card every prefill of
the port runs this kernel, whatever the bucket.

One difference from the plain version is kept from the Pallas kernel: a
row with no visible key (``seq_lens`` 0) is 0 here and the uniform mean of
v there.  The engines never prefill an empty sequence.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from k8s_llm_rca_tpu_torch.ops import build
from k8s_llm_rca_tpu_torch.ops.attention import causal_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)     # the configs' head_dims (TINY, LLAMA3_8B)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The built kernel's C entry point with its argument types declared
    (without them ctypes would pass each pointer as a 32-bit int)."""
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                  + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, seq_lens, q_offset) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t, dtype in (("k", k, q.dtype), ("v", v, q.dtype),
                           ("seq_lens", seq_lens, torch.int32),
                           ("q_offset", q_offset, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)} must be [B, S_q, H, d] and k/v "
                         f"[B, S_k, n_kv, d], got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    b, s_q, n_heads, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or n_heads % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, head_dim, GQA groups)")
    if d not in _HEAD_DIMS:
        raise ValueError(f"kernel head_dim must be one of {_HEAD_DIMS}, "
                         f"got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head_dim axis must be contiguous")
        if q.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"bf16 {name} must be 16-byte aligned with "
                             f"strides that are multiples of 8 (the kernel "
                             f"loads 16-byte vectors)")
    for name, t in (("seq_lens", seq_lens), ("q_offset", q_offset)):
        if tuple(t.shape) != (b,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B] vector")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seq_lens: torch.Tensor,
                    q_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal prefill attention: [B, S_q, n_heads, d].

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (``flash_attention.launches`` counts the launches)
    or raise."""
    if q.device.type == "cpu":
        return causal_attention(q, k, v, seq_lens, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if q_offset is None:
        q_offset = torch.zeros((q.shape[0],), dtype=torch.int32,
                               device=q.device)
    _check(q, k, v, seq_lens, q_offset)
    b, s_q, n_heads, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(),
        q_offset.data_ptr(), out.data_ptr(),
        b, s_q, k.shape[1], n_heads, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
