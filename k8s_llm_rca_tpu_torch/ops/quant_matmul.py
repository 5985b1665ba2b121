"""Fused int4 weight-dequant matmuls: the hand-written CUDA kernels, their
plain versions and the ``qmm`` shims.

The counterpart of ``k8s_llm_rca_tpu/ops/quant_matmul.py``.  Layouts are
the JAX package's (``models.quant``):

- kn (every projection and MLP matmul): ``QuantTensor4`` q [K, N/2]
  split-half packed (byte j = column j low, column j + N/2 high), scale
  [1, N]; ``quant_matmul(x, w) = x @ dq(w)``, x [..., K].
- nk (the lm head, per-row scales): q [V, K/2] packed along K, scale
  [V, 1]; ``quant_matmul_head(x, w) = x @ dq(w)^T``.

``quant_matmul``/``quant_matmul_head`` launch ``csrc/quant_matmul.cu`` for
CUDA tensors and take their plain versions only for CPU tensors.  The
plain versions compute ``x @ dq(w)`` in JAX's promoted dtype (an f32
activation times bf16-scaled weights is an f32 product, with ``q * scale``
kept in f32 as XLA keeps it inside the JAX engine's jitted steps), which is
what the JAX shims compute off the TPU.  int8 weights (``QuantTensor``) and
the stacked-expert matmuls are not ported: on CUDA they raise.

The ``qmm``/``qmm_head`` shims are the ``ModelConfig.fused_quant_matmul``
use sites: quantized weights go to the wrappers above, plain tensors to
``torch.matmul``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from k8s_llm_rca_tpu_torch.models.quant import QuantTensor, QuantTensor4, dq
from k8s_llm_rca_tpu_torch.ops import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GEMV_MAX_M = 16        # rows the weight-streaming body takes (kGemvMaxM)
_GEMV_MIN_ROWS = 128    # fewest rows of K a split walks (kGemvMinRows)
_HEAD_MT = 8            # rows of x a head block stages (kHeadMT)
_SMEM_BYTES = 232448    # shared memory a block can use on the H100
_INT8_ITEM = ("int8 weights (QuantTensor) are not ported to the card yet "
              "(ROADMAP Queue 2 items 3/4, the int8 kn and nk kernels)")


def _promoted(x: torch.Tensor, w):
    """x and the dequantized weight, both in their promoted dtype."""
    wd = dq(w, x.dtype)
    rt = torch.promote_types(x.dtype, wd.dtype)
    return x.to(rt), wd.to(rt)


def quant_matmul_plain(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ dq(w)`` in the promoted dtype."""
    return torch.matmul(*_promoted(x, w))


def quant_matmul_head_plain(x: torch.Tensor, w) -> torch.Tensor:
    """``einsum("...h,vh->...v", x, dq(w))`` in the promoted dtype."""
    a, b = _promoted(x, w)
    return torch.matmul(a, b.t())


@functools.lru_cache(maxsize=None)
def _launchers():
    """The built kernels' C entry points with their argument types declared
    (without them ctypes would pass each pointer as a 32-bit int)."""
    lib = build.load("quant_matmul")
    kn = lib.quant_matmul_kn4_launch
    kn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    kn.restype = ctypes.c_int
    nk = lib.quant_matmul_nk4_launch
    nk.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    nk.restype = ctypes.c_int
    return kn, nk


def _require_quant(w, who: str) -> None:
    if not isinstance(w, (QuantTensor, QuantTensor4)):
        raise ValueError(f"{who} needs a QuantTensor/QuantTensor4 weight, got "
                         f"{type(w).__name__} (plain tensors take "
                         f"torch.matmul: use the qmm shims)")
    if w.ndim != 2:
        raise ValueError(f"{who} takes 2-D weights, got {w.ndim}-D "
                         f"{w.shape} (stacked experts: ROADMAP Queue 1 "
                         f"item 8)")


def _check_cuda(x: torch.Tensor, w, who: str) -> None:
    """What the kernels take; raises on anything else."""
    if isinstance(w, QuantTensor):
        raise NotImplementedError(f"{who} on CUDA: {_INT8_ITEM}")
    if x.dtype not in _DTYPES or w.scale.dtype not in _DTYPES:
        raise TypeError(f"{who} kernel takes float32/bfloat16 activations and "
                        f"scales, got {x.dtype} / {w.scale.dtype}")
    if x.dtype == torch.bfloat16 and w.scale.dtype == torch.float32:
        raise TypeError(f"{who} kernel: bfloat16 activations with float32 "
                        f"scales would promote to a float32 product; cast "
                        f"the scales to bfloat16")
    if w.q.dtype != torch.int8:
        raise TypeError(f"{who}: packed weights must be int8, got "
                        f"{w.q.dtype}")
    for name, t in (("q", w.q), ("scale", w.scale)):
        if t.device != x.device:
            raise ValueError(f"{who}: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if w.q.data_ptr() % 16:
        raise ValueError(f"{who}: q must be 16-byte aligned (vector loads)")


def _rows(x: torch.Tensor, kdim: int) -> torch.Tensor:
    """x as a contiguous, 16-byte aligned [M, K] matrix (vector loads)."""
    x2 = x.reshape(-1, kdim).contiguous()
    return x2.clone() if x2.data_ptr() % 16 else x2


def quant_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ dq(w)`` for a 2-D weight [K, N] with per-column scales [1, N].

    CPU tensors take ``quant_matmul_plain``; CUDA tensors launch the int4 kn
    kernel on the current stream (``quant_matmul.launches`` counts the
    calls) or raise.  The output is in x's dtype."""
    _require_quant(w, "quant_matmul")
    kdim, n = w.shape
    if tuple(w.scale.shape) != (1, n):
        raise ValueError(f"quant_matmul needs per-column scales [1, {n}], got "
                         f"{tuple(w.scale.shape)} for weight {w.shape} "
                         f"(per-row tables: quant_matmul_head)")
    if x.shape[-1] != kdim:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} @ w {w.shape}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cpu or cuda, not {x.device}")
    _check_cuda(x, w, "quant_matmul")
    if kdim % 32 or n % 32:
        raise ValueError(f"quant_matmul kernel takes K and N multiples of 32, "
                         f"got K={kdim}, N={n}")
    lead = x.shape[:-1]
    x2 = _rows(x, kdim)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    # the weight-streaming body's fp32 partial sums, one set per K split
    # (the kernel picks the count, at most one per 128 rows of K)
    splits = max(1, kdim // _GEMV_MIN_ROWS)
    scratch = torch.empty((splits * m * n if m <= _GEMV_MAX_M else 1,),
                          dtype=torch.float32, device=x.device)
    rc = _launchers()[0](
        x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), m, kdim, n, splits, _DTYPES[x.dtype],
        _DTYPES[w.scale.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    quant_matmul.launches += 1
    return out.reshape(*lead, n)


quant_matmul.launches = 0


def quant_matmul_head(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ dq(w)^T`` for a [V, K] table with per-row scales [V, 1] (the lm
    head).  CPU tensors take ``quant_matmul_head_plain``; CUDA tensors
    launch the int4 nk kernel (``quant_matmul_head.launches``) or raise.
    The output is in x's dtype."""
    _require_quant(w, "quant_matmul_head")
    v, kdim = w.shape
    if tuple(w.scale.shape) != (v, 1):
        raise ValueError(f"quant_matmul_head needs per-row scales [{v}, 1], "
                         f"got {tuple(w.scale.shape)} for table {w.shape} "
                         f"(per-column weights: quant_matmul)")
    if x.shape[-1] != kdim:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} @ w^T "
                         f"{w.shape}")
    if x.device.type == "cpu":
        return quant_matmul_head_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul_head runs on cpu or cuda, not "
                         f"{x.device}")
    _check_cuda(x, w, "quant_matmul_head")
    if kdim % 32:
        raise ValueError(f"quant_matmul_head kernel takes K a multiple of "
                         f"32, got K={kdim}")
    lead = x.shape[:-1]
    x2 = _rows(x, kdim)
    m = x2.shape[0]
    if min(m, _HEAD_MT) * kdim * 4 > _SMEM_BYTES:
        raise ValueError(f"quant_matmul_head kernel stages up to {_HEAD_MT} "
                         f"rows of x in fp32 in {_SMEM_BYTES} bytes of shared "
                         f"memory; K={kdim} does not fit")
    out = torch.empty((m, v), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, v)
    rc = _launchers()[1](
        x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
        m, kdim, v, _DTYPES[x.dtype], _DTYPES[w.scale.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul_head kernel launch failed: CUDA "
                           f"error {rc}")
    quant_matmul_head.launches += 1
    return out.reshape(*lead, v)


quant_matmul_head.launches = 0


def quant_matmul_experts(x: torch.Tensor, w) -> torch.Tensor:
    """The stacked-expert matmuls of the MoE MLP: not ported."""
    raise NotImplementedError(
        "quant_matmul_experts (stacked MoE experts) is not ported yet "
        "(ROADMAP Queue 1 item 8, MoE)")


# --------------------------------------------------------------------------
# dispatch shims: the ModelConfig.fused_quant_matmul use sites
# --------------------------------------------------------------------------


def qmm(x: torch.Tensor, w) -> torch.Tensor:
    """Every ``x @ dq(w)`` GEMM site: quantized weights take
    ``quant_matmul``, plain tensors ``torch.matmul``."""
    if isinstance(w, (QuantTensor, QuantTensor4)):
        return quant_matmul(x, w)
    return quant_matmul_plain(x, w)


def qmm_head(x: torch.Tensor, w) -> torch.Tensor:
    """The lm-head ``einsum("bsh,vh->bsv")`` site."""
    if isinstance(w, (QuantTensor, QuantTensor4)):
        return quant_matmul_head(x, w)
    return quant_matmul_head_plain(x, w)


def qmm_experts(x: torch.Tensor, w) -> torch.Tensor:
    """The stacked-expert einsum sites: not ported."""
    return quant_matmul_experts(x, w)
