"""Fused int8/int4 weight-dequant matmuls: the hand-written CUDA kernels,
their plain versions and the ``qmm`` shims.

The counterpart of ``k8s_llm_rca_tpu/ops/quant_matmul.py``.  Layouts are
the JAX package's (``models.quant``):

- kn (every projection, MLP matmul and the MoE router): ``QuantTensor`` q
  [K, N] int8 or ``QuantTensor4`` q [K, N/2] split-half packed (byte j =
  column j low, column j + N/2 high), scale [1, N];
  ``quant_matmul(x, w) = x @ dq(w)``, x [..., K].
- nk (the lm head, per-row scales): q [V, K] int8 or [V, K/2] packed along
  K, scale [V, 1]; ``quant_matmul_head(x, w) = x @ dq(w)^T``.
- ekn (stacked MoE experts, per-(expert, column) scales): q [E, K, N] or
  [E, K, N/2], scale [E, 1, N]; ``quant_matmul_experts`` computes
  ``"bsh,ehi->bsei"`` for 3-D x and ``"bsei,eih->bseh"`` for 4-D x.

The wrappers launch ``csrc/quant_matmul.cu`` (int4 kn and nk),
``csrc/quant_matmul_int8.cu`` (int8 kn and nk) and
``csrc/quant_matmul_experts.cu`` (int8 and int4 ekn) for CUDA tensors and
take their plain versions only for CPU tensors.  Each counts its int4
launches in ``.launches`` and its int8 launches in ``.launches_int8``.  The
plain versions compute ``x @ dq(w)`` in JAX's promoted dtype (an f32
activation times bf16-scaled weights is an f32 product, with ``q * scale``
kept in f32 as XLA keeps it inside the JAX engine's jitted steps), which is
what the JAX shims compute off the TPU.

The ``qmm``/``qmm_head``/``qmm_experts`` shims are the
``ModelConfig.fused_quant_matmul`` use sites: quantized weights go to the
wrappers above, plain tensors to ``torch.matmul``/``torch.einsum``.
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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (source, C entry, argument types) of each launcher
_KN = {4: ("quant_matmul", "quant_matmul_kn4_launch"),
       8: ("quant_matmul_int8", "quant_matmul_kn8_launch")}
_NK = {4: ("quant_matmul", "quant_matmul_nk4_launch"),
       8: ("quant_matmul_int8", "quant_matmul_nk8_launch")}
_KN_ARGS = (_P,) * 5 + (_I,) * 6 + (_P,)
_NK_ARGS = (_P,) * 4 + (_I,) * 5 + (_P,)
_EKN_ARGS = (_P,) * 5 + (_I,) * 4 + (_L,) * 2 + (_I,) * 4 + (_P,)


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


def quant_matmul_experts_plain(x: torch.Tensor, w) -> torch.Tensor:
    """``einsum("bsh,ehi->bsei")`` (3-D x) or ``einsum("bsei,eih->bseh")``
    (4-D x) over ``dq(w)``, in the promoted dtype."""
    a, b = _promoted(x, w)
    return torch.einsum("bsh,ehi->bsei" if x.dim() == 3 else "bsei,eih->bseh",
                        a, b)


@functools.lru_cache(maxsize=None)
def _launcher(source: str, entry: str, argtypes: tuple):
    """A built kernel's C entry point with its argument types declared
    (without them ctypes would pass each pointer as a 32-bit int)."""
    fn = getattr(build.load(source), entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _body_query(bits: int, experts: bool):
    """The C query naming the kn body a call takes (builds the library)."""
    if experts:
        fn = build.load("quant_matmul_experts").quant_matmul_ekn_body
        fn.argtypes = [_I] * 4
    else:
        fn = getattr(build.load(_KN[bits][0]), f"quant_matmul_kn{bits}_body")
        fn.argtypes = [_I] * 3
    fn.restype = ctypes.c_char_p
    return fn


def kn_body(bits: int, m: int, k: int, n: int, experts: bool = False) -> str:
    """The body of ``csrc/quant_matmul.cuh`` that a kn call of x [m, k]
    over ``bits``-wide weights [k, n] takes on the card (``experts``: a
    ``quant_matmul_experts`` call, m rows per expert): "gemv", "tile",
    "narrow_split", "narrow_smem" or "narrow_bytes"."""
    args = (m, k, n, bits) if experts else (m, k, n)
    return _body_query(bits, experts)(*args).decode()


@functools.lru_cache(maxsize=None)
def nk_body(bits: int, m: int, k: int, v: int,
            dtype: torch.dtype = torch.bfloat16) -> str:
    """The body of ``csrc/quant_matmul.cuh`` that a head call of x [m, k]
    in ``dtype`` over a ``bits``-wide table [v, k] takes on the card:
    "mma" (bf16 x, tensor cores), "fma" (fp32 x, or int8 rows of K not a
    multiple of 16) or "invalid" (no body takes it).  Builds the library."""
    fn = getattr(build.load(_NK[bits][0]), f"quant_matmul_nk{bits}_body")
    fn.argtypes = [_I] * 4
    fn.restype = ctypes.c_char_p
    return fn(m, k, v, _DTYPES[dtype]).decode()


def _bits(w) -> int:
    return 4 if isinstance(w, QuantTensor4) else 8


def _count(fn, w) -> None:
    """One launch of ``fn``'s kernel, counted by the weight's width."""
    if isinstance(w, QuantTensor4):
        fn.launches += 1
    else:
        fn.launches_int8 += 1


def _require_quant(w, who: str, ndim: int = 2) -> None:
    if not isinstance(w, (QuantTensor, QuantTensor4)):
        raise ValueError(f"{who} needs a QuantTensor/QuantTensor4 weight, got "
                         f"{type(w).__name__} (plain tensors take "
                         f"torch.matmul: use the qmm shims)")
    if w.ndim != ndim:
        other = ("stacked experts: quant_matmul_experts" if ndim == 2
                 else "2-D weights: quant_matmul")
        raise ValueError(f"{who} takes {ndim}-D weights, got {w.ndim}-D "
                         f"{w.shape} ({other})")


def _check_cuda(x: torch.Tensor, w, who: str) -> None:
    """What the kernels take; raises on anything else."""
    if x.dtype not in _DTYPES or w.scale.dtype not in _DTYPES:
        raise TypeError(f"{who} kernel takes float32/bfloat16 activations and "
                        f"scales, got {x.dtype} / {w.scale.dtype}")
    if x.dtype == torch.bfloat16 and w.scale.dtype == torch.float32:
        raise TypeError(f"{who} kernel: bfloat16 activations with float32 "
                        f"scales would promote to a float32 product; cast "
                        f"the scales to bfloat16")
    if w.q.dtype != torch.int8:
        raise TypeError(f"{who}: quantized weights must be int8, got "
                        f"{w.q.dtype}")
    for name, t in (("q", w.q), ("scale", w.scale)):
        if t.device != x.device:
            raise ValueError(f"{who}: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if w.q.data_ptr() % 16:
        raise ValueError(f"{who}: q must be 16-byte aligned (vector loads)")


def _on_card(x: torch.Tensor, who: str) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA one (the
    kernel); raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{who} runs on cpu or cuda, not {x.device}")
    return True


def _rows(x: torch.Tensor, width: int, who: str) -> torch.Tensor:
    """x as a contiguous [M, width] matrix; raises unless it starts on 16
    bytes (the kernels' vector loads and the tile body's tensor maps)."""
    x2 = x.reshape(-1, width).contiguous()
    if x2.data_ptr() % 16:
        raise ValueError(f"{who}: x must start on a 16-byte boundary (vector "
                         f"loads, TMA), got data pointer {x2.data_ptr():#x}")
    return x2


def _scratch(x: torch.Tensor, m: int, kdim: int, n: int, e: int = 1):
    """Room for the fp32 partial sums of the bodies that meet their K
    splits in a second pass (fp32 x at M <= 16, and the narrow_split
    body), one set per split (the kernel picks the count, at most one per
    128 rows of K), and that count.  The bf16 weight-streaming body meets
    its splits in a thread block cluster and leaves it unused."""
    splits = max(1, kdim // _GEMV_MIN_ROWS)
    size = e * splits * m * n if m <= _GEMV_MAX_M else 1
    return torch.empty((size,), dtype=torch.float32, device=x.device), splits


def _raise_if_failed(rc: int, who: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {rc}")


def quant_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ dq(w)`` for a 2-D weight [K, N] with per-column scales [1, N].

    CPU tensors take ``quant_matmul_plain``; CUDA tensors launch the int8 or
    int4 kn kernel on the current stream (counted in
    ``quant_matmul.launches_int8`` / ``.launches``) or raise.  The output is
    in x's dtype."""
    _require_quant(w, "quant_matmul")
    kdim, n = w.shape
    if tuple(w.scale.shape) != (1, n):
        raise ValueError(f"quant_matmul needs per-column scales [1, {n}], got "
                         f"{tuple(w.scale.shape)} for weight {w.shape} "
                         f"(per-row tables: quant_matmul_head)")
    if x.shape[-1] != kdim:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} @ w {w.shape}")
    if not _on_card(x, "quant_matmul"):
        return quant_matmul_plain(x, w)
    _check_cuda(x, w, "quant_matmul")
    lead = x.shape[:-1]
    x2 = _rows(x, kdim, "quant_matmul")
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    scratch, splits = _scratch(x, m, kdim, n)
    rc = _launcher(*_KN[_bits(w)], _KN_ARGS)(
        x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), m, kdim, n, splits, _DTYPES[x.dtype],
        _DTYPES[w.scale.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _raise_if_failed(rc, "quant_matmul")
    _count(quant_matmul, w)
    return out.reshape(*lead, n)


quant_matmul.launches = 0
quant_matmul.launches_int8 = 0


def quant_matmul_head(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ dq(w)^T`` for a [V, K] table with per-row scales [V, 1] (the lm
    head).  CPU tensors take ``quant_matmul_head_plain``; CUDA tensors
    launch the int8 or int4 nk kernel (``quant_matmul_head.launches_int8``
    / ``.launches``; ``nk_body`` names the body a shape takes) or raise.
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
    if not _on_card(x, "quant_matmul_head"):
        return quant_matmul_head_plain(x, w)
    _check_cuda(x, w, "quant_matmul_head")
    # int4 rows pair k with k + K/2 in 4-byte words; int8 rows are words
    align = 32 if isinstance(w, QuantTensor4) else 4
    if kdim % align:
        raise ValueError(f"quant_matmul_head kernel takes K a multiple of "
                         f"{align} for int{_bits(w)}, got K={kdim}")
    lead = x.shape[:-1]
    x2 = _rows(x, kdim, "quant_matmul_head")
    m = x2.shape[0]
    out = torch.empty((m, v), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, v)
    if nk_body(_bits(w), m, kdim, v, x.dtype) == "invalid":
        raise ValueError(f"quant_matmul_head kernel stages the rows of x in "
                         f"shared memory; x [{m}, {kdim}] does not fit")
    rc = _launcher(*_NK[_bits(w)], _NK_ARGS)(
        x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
        m, kdim, v, _DTYPES[x.dtype], _DTYPES[w.scale.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_if_failed(rc, "quant_matmul_head")
    _count(quant_matmul_head, w)
    return out.reshape(*lead, v)


quant_matmul_head.launches = 0
quant_matmul_head.launches_int8 = 0


def quant_matmul_experts(x: torch.Tensor, w) -> torch.Tensor:
    """The stacked-expert einsums of the MoE MLP: ``w`` [E, K, N] with
    per-(expert, column) scales [E, 1, N]; ``x`` 3-D [B, S, K] computes
    ``"bsh,ehi->bsei"`` (every token through every expert), 4-D
    [B, S, E, K] computes ``"bsei,eih->bseh"``; both return [B, S, E, N].

    CPU tensors take ``quant_matmul_experts_plain``; CUDA tensors launch the
    int8 or int4 ekn kernel (``quant_matmul_experts.launches_int8`` /
    ``.launches``), which reads x through strides (no broadcast or
    transpose copy) and writes [B*S, E, N] directly, or raise.  The output
    is in x's dtype."""
    _require_quant(w, "quant_matmul_experts", ndim=3)
    e, kdim, n = w.shape
    if tuple(w.scale.shape) != (e, 1, n):
        raise ValueError(f"quant_matmul_experts needs per-(expert, column) "
                         f"scales [{e}, 1, {n}], got "
                         f"{tuple(w.scale.shape)} for weight {w.shape}")
    if x.dim() == 3:
        ok = x.shape[2] == kdim
    elif x.dim() == 4:
        ok = x.shape[2] == e and x.shape[3] == kdim
    else:
        raise ValueError(f"quant_matmul_experts takes 3-D [B,S,K] or 4-D "
                         f"[B,S,E,K] activations, got {tuple(x.shape)}")
    if not ok:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} @ w {w.shape}")
    if not _on_card(x, "quant_matmul_experts"):
        return quant_matmul_experts_plain(x, w)
    _check_cuda(x, w, "quant_matmul_experts")
    b, s = x.shape[:2]
    if x.dim() == 3:           # every expert reads the same rows
        x2, x_es, x_rs = _rows(x, kdim, "quant_matmul_experts"), 0, kdim
    else:                      # expert e's row r is x2[r, e]
        x2, x_es, x_rs = (_rows(x, e * kdim, "quant_matmul_experts"),
                          kdim, e * kdim)
    m = b * s
    out = torch.empty((b, s, e, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    scratch, splits = _scratch(x, m, kdim, n, e)
    rc = _launcher("quant_matmul_experts", "quant_matmul_ekn_launch",
                   _EKN_ARGS)(
        x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), m, kdim, n, e, x_es, x_rs, splits, _bits(w),
        _DTYPES[x.dtype], _DTYPES[w.scale.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_if_failed(rc, "quant_matmul_experts")
    _count(quant_matmul_experts, w)
    return out


quant_matmul_experts.launches = 0
quant_matmul_experts.launches_int8 = 0


# --------------------------------------------------------------------------
# dispatch shims: the ModelConfig.fused_quant_matmul use sites
# --------------------------------------------------------------------------


def _quantized(w) -> bool:
    return isinstance(w, (QuantTensor, QuantTensor4))


def qmm(x: torch.Tensor, w) -> torch.Tensor:
    """Every ``x @ dq(w)`` GEMM site: quantized weights take
    ``quant_matmul``, plain tensors ``torch.matmul``."""
    return quant_matmul(x, w) if _quantized(w) else quant_matmul_plain(x, w)


def qmm_head(x: torch.Tensor, w) -> torch.Tensor:
    """The lm-head ``einsum("bsh,vh->bsv")`` site."""
    if _quantized(w):
        return quant_matmul_head(x, w)
    return quant_matmul_head_plain(x, w)


def qmm_experts(x: torch.Tensor, w) -> torch.Tensor:
    """The stacked-expert einsum sites (3-D x: ``"bsh,ehi->bsei"``; 4-D x:
    ``"bsei,eih->bseh"``): quantized weights take ``quant_matmul_experts``,
    plain tensors ``torch.einsum``."""
    if _quantized(w):
        return quant_matmul_experts(x, w)
    return quant_matmul_experts_plain(x, w)
