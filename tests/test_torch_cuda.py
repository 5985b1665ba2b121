"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips on a host without a CUDA device (the
decision is made inside the fixture, never at import).  On a machine with
a card and no JAX, run them without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: fp32 atol 1e-4 with TF32 off (both sides fp32, different
summation orders).  bf16: for every output row (one token and head, d
values; for the matmuls one token's N or V outputs) the largest
|out - ref| is at most 2^-6 of the row's largest |ref|, a limit that
scales with the values compared.  Each side rounds an element to bf16
once, at most one ulp (2^-7 of the row's largest value) apart; the bf16
flash body's bf16 probabilities and the plain matmul's bf16-rounded
dequantized weights (the kernel scales in fp32) add a fraction of that.
"""

import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu_torch.models.quant import quantize, quantize_kv
from k8s_llm_rca_tpu_torch.ops.attention import causal_attention
from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention
from k8s_llm_rca_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_plain, paged_attention_quant,
    paged_attention_quant_plain,
)
from k8s_llm_rca_tpu_torch.ops.quant_matmul import (
    quant_matmul, quant_matmul_experts, quant_matmul_experts_plain,
    quant_matmul_head, quant_matmul_head_plain, quant_matmul_plain,
)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}


def _exact(plain, x, w):
    """The plain version on x's values in fp32: the reference of the int8
    and expert matmul cases.  The bf16 plain version rounds every
    dequantized weight to bf16 before its product; over the 4 or 8 outputs
    of a router row that rounding is not a fraction of the row's largest
    value, while the kernels scale their fp32 sums exactly."""
    return plain(x.float(), w)


def _err(out, ref):
    """fp32: max |out - ref|; bf16: max over rows of the row's largest
    |out - ref| over its largest |ref|."""
    diff = (out.float() - ref.float()).abs()
    if out.dtype != torch.bfloat16:
        return diff.max().item()
    scale = ref.float().abs().amax(-1).clamp_min(1e-30)
    return (diff.amax(-1) / scale).max().item()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _paged_inputs(gen, dtype, n_heads, n_kv, d, page, lengths, pps=None):
    """A pool of shuffled pages and each sequence's table over ``pps``
    entries (default: the longest length's pages + 1); a length past the
    table gets the whole table (an idle slot's stale length)."""
    pps = pps or max(-(-n // page) for n in lengths) + 1
    used_pages = [min(-(-n // page), pps) for n in lengths]
    n_pages = 1 + sum(used_pages) + 3
    q = torch.randn((len(lengths), n_heads, d), generator=gen,
                    device="cuda").to(dtype)
    kp = torch.randn((n_pages, page, n_kv * d), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((n_pages, page, n_kv * d), generator=gen,
                     device="cuda").to(dtype)
    ids = np.random.default_rng(0).permutation(np.arange(1, n_pages))
    tables = np.zeros((len(lengths), pps), np.int32)   # tails: trash page
    used = 0
    for i, n_p in enumerate(used_pages):
        tables[i, :n_p] = ids[used:used + n_p]
        used += n_p
    return (q, kp, vp, torch.tensor(lengths, dtype=torch.int32,
                                    device="cuda"),
            torch.from_numpy(tables).cuda())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_heads,n_kv,d,page", [
    (4, 2, 32, 16), (8, 1, 32, 16), (4, 4, 64, 16), (8, 2, 64, 16),
    (32, 8, 128, 64), (16, 2, 128, 64)])
def test_paged_kernel_matches_plain(card, dtype, n_heads, n_kv, d, page):
    args = _paged_inputs(card, dtype, n_heads, n_kv, d, page,
                         [1, page, page + 1, 5 * page + 7])
    before = paged_attention.launches
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_plain(*args)
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= TOL[dtype]


def test_paged_kernel_refuses_what_it_does_not_take(card):
    q, kp, vp, lens, tables = _paged_inputs(card, torch.float32, 4, 4, 64,
                                            16, [3])
    with pytest.raises(TypeError):
        paged_attention(q, kp, vp, lens.long(), tables)
    with pytest.raises(ValueError):
        paged_attention(q.transpose(1, 2).contiguous().transpose(1, 2), kp,
                        vp, lens, tables)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_heads,n_kv,d", [(4, 2, 32), (8, 8, 32),
                                            (4, 4, 64), (8, 2, 64),
                                            (6, 3, 64), (32, 8, 128)])
def test_flash_kernel_matches_plain(card, dtype, n_heads, n_kv, d):
    b, s = 2, 200                    # not a multiple of the 64-row tile
    # q is a strided view (every other head of a wider tensor): the kernel
    # reads through strides, not a contiguous copy
    wide = torch.randn((b, s, 2 * n_heads, d), generator=card,
                       device="cuda").to(dtype)
    q = wide[:, :, ::2]
    k = torch.randn((b, s, n_kv, d), generator=card, device="cuda").to(dtype)
    v = torch.randn((b, s, n_kv, d), generator=card, device="cuda").to(dtype)
    lens = torch.tensor([200, 131], dtype=torch.int32, device="cuda")
    out = flash_attention(q, k, v, lens)
    ref = causal_attention(q, k, v, lens)
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= TOL[dtype]


def test_flash_kernel_chunk_offset(card):
    q = torch.randn((2, 70, 8, 128), generator=card, device="cuda")
    k = torch.randn((2, 300, 2, 128), generator=card, device="cuda")
    v = torch.randn((2, 300, 2, 128), generator=card, device="cuda")
    lens = torch.tensor([300, 190], dtype=torch.int32, device="cuda")
    off = torch.tensor([230, 100], dtype=torch.int32, device="cuda")
    before = flash_attention.launches
    out = flash_attention(q, k, v, lens, off)
    assert flash_attention.launches == before + 1
    ref = causal_attention(q, k, v, lens, off)
    assert (out - ref).abs().max().item() <= TOL[torch.float32]


def test_flash_kernel_row_with_no_visible_key_is_zero(card):
    q = torch.randn((1, 64, 4, 64), generator=card, device="cuda")
    k = torch.randn((1, 64, 4, 64), generator=card, device="cuda")
    out = flash_attention(q, k, k, torch.zeros(1, dtype=torch.int32,
                                               device="cuda"))
    assert torch.equal(out, torch.zeros_like(out))


# (S_q, S_k, seq_lens, q_offset or None) of two batch rows
_FLASH_EDGES = {
    "s130": (130, 130, [130, 77], None),        # not a multiple of 64/128
    "s1000": (1000, 1000, [1000, 613], None),
    "chunk": (130, 1000, [1000, 700], [870, 300]),   # S_k well above S_q
    "empty": (70, 200, [0, 5], [0, 100]),       # a row with nothing visible
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("gqa", [1, 4, 8])
@pytest.mark.parametrize("case", sorted(_FLASH_EDGES))
def test_flash_kernel_tile_edges(card, dtype, d, gqa, case):
    """The bf16 body's 128-query tiles and 128-key TMA stages at their
    edges: ragged S_q, B = 2 with their own seq_lens and q_offsets, GQA 1/4/8
    at every head_dim, S_k well above S_q, and a strided q view (every
    other head of a wider tensor, read through its strides)."""
    s_q, s_k, lens, off = _FLASH_EDGES[case]
    n_kv = 2
    wide = torch.randn((2, s_q, 2 * n_kv * gqa, d), generator=card,
                       device="cuda").to(dtype)
    q = wide[:, :, ::2]
    k = torch.randn((2, s_k, n_kv, d), generator=card, device="cuda").to(dtype)
    v = torch.randn((2, s_k, n_kv, d), generator=card, device="cuda").to(dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if off is not None:
        off = torch.tensor(off, dtype=torch.int32, device="cuda")
    before = flash_attention.launches
    out = flash_attention(q, k, v, lens, off)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(out).all()
    ref = causal_attention(q, k, v, lens, off)
    if case == "empty":   # batch row 0 sees no key: 0, not the plain mean
        assert torch.equal(out[0], torch.zeros_like(out[0]))
        out, ref = out[1:], ref[1:]
    assert _err(out, ref) <= TOL[dtype]


# ------------------------------------------------- int4 and int8 matmuls


def _weight(gen, k, n, scale_dtype, axis=-1, bits=4):
    """A quantized weight from N(0, 1/K) values: outputs of order 1."""
    w = torch.randn((k, n) if axis == -1 else (n, k), generator=gen,
                    device="cuda") / k ** 0.5
    return quantize(w, axis=axis, compute_dtype=scale_dtype, bits=bits)


@pytest.mark.parametrize("dtype,scale_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("m,k,n", [
    (1, 256, 352), (4, 4096, 1024), (16, 512, 64), (4, 14336, 4096),
    (17, 256, 352), (300, 96, 416), (5120, 256, 160)])
def test_quant_matmul_matches_plain(card, dtype, scale_dtype, m, k, n):
    """GEMV body (M <= 16, split K) and tiled bodies (M > 16); N/2 = 176 and
    208 are not multiples of the 256/64/32-column blocks, K = 96 not of the
    64-deep tensor-core step."""
    w = _weight(card, k, n, scale_dtype)
    x = torch.randn((m, k), generator=card, device="cuda").to(dtype)
    before = quant_matmul.launches
    out = quant_matmul(x, w)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    ref = quant_matmul_plain(x, w)
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,v", [(1, 128, 512), (4, 4096, 1003),
                                   (8, 256, 64), (9, 256, 1000)])
def test_quant_matmul_head_matches_plain(card, dtype, m, k, v):
    w = _weight(card, k, v, torch.bfloat16, axis=0)
    x = torch.randn((m, 1, k), generator=card, device="cuda").to(dtype)
    before = quant_matmul_head.launches
    out = quant_matmul_head(x, w)
    torch.cuda.synchronize()
    assert quant_matmul_head.launches == before + 1
    assert out.shape == (m, 1, v)
    ref = quant_matmul_head_plain(x, w)
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype,scale_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("m,k,n", [
    (1, 256, 352), (4, 4096, 1024), (16, 512, 64), (17, 256, 352),
    (300, 96, 416), (5120, 256, 160), (4, 4096, 8), (5120, 4096, 8),
    (3, 128, 4), (301, 128, 4), (7, 100, 48)])
def test_quant_matmul_int8_matches_plain(card, dtype, scale_dtype, m, k, n):
    """int8 kn: the weight-streaming body (M <= 16), the tile bodies, and
    the narrow body for the router's rows of 8 and 4 bytes and for K not a
    multiple of 32."""
    w = _weight(card, k, n, scale_dtype, bits=8)
    x = torch.randn((m, k), generator=card, device="cuda").to(dtype)
    before = (quant_matmul.launches, quant_matmul.launches_int8)
    out = quant_matmul(x, w)
    torch.cuda.synchronize()
    assert (quant_matmul.launches, quant_matmul.launches_int8) == (
        before[0], before[1] + 1)
    assert out.dtype == dtype and out.shape == (m, n)
    assert torch.isfinite(out).all()
    assert _err(out, _exact(quant_matmul_plain, x, w)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 8), (4, 4096, 4), (300, 128, 8),
                                   (5120, 4096, 4), (9, 96, 40)])
def test_quant_matmul_int4_router_widths(card, dtype, m, k, n):
    """int4 kn with rows of 4 or 2 packed bytes (the router, N = 8 or 4) and
    N/2 not a multiple of 16: the narrow body."""
    w = _weight(card, k, n, torch.bfloat16)
    x = torch.randn((m, k), generator=card, device="cuda").to(dtype)
    before = quant_matmul.launches
    out = quant_matmul(x, w)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert _err(out, _exact(quant_matmul_plain, x, w)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,v", [(1, 128, 512), (4, 4096, 1003),
                                   (8, 256, 64), (9, 260, 1000)])
def test_quant_matmul_head_int8_matches_plain(card, dtype, m, k, v):
    w = _weight(card, k, v, torch.bfloat16, axis=0, bits=8)
    x = torch.randn((m, 1, k), generator=card, device="cuda").to(dtype)
    before = (quant_matmul_head.launches, quant_matmul_head.launches_int8)
    out = quant_matmul_head(x, w)
    torch.cuda.synchronize()
    assert (quant_matmul_head.launches,
            quant_matmul_head.launches_int8) == (before[0], before[1] + 1)
    assert out.shape == (m, 1, v)
    assert _err(out, _exact(quant_matmul_head_plain, x, w)) <= TOL[dtype]


def _experts(gen, e, k, n, bits, scale_dtype=torch.bfloat16):
    w = torch.randn((e, k, n), generator=gen, device="cuda") / k ** 0.5
    return quantize(w, axis=(0, -1), compute_dtype=scale_dtype, bits=bits)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("form", ["3d", "4d"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,e,k,n", [
    (1, 1, 1, 256, 352), (4, 1, 8, 512, 1024), (1, 17, 4, 256, 160),
    (2, 150, 8, 128, 96), (1, 5120, 8, 256, 128), (3, 5, 4, 128, 8)])
def test_quant_matmul_experts_matches_plain(card, bits, form, dtype, b, s, e,
                                            k, n):
    """ekn, both einsum forms: M = 1 to 5120 rows, E = 1/4/8, odd M, and
    the narrow body (N = 8)."""
    w = _experts(card, e, k, n, bits)
    shape = (b, s, k) if form == "3d" else (b, s, e, k)
    x = torch.randn(shape, generator=card, device="cuda").to(dtype)
    attr = "launches" if bits == 4 else "launches_int8"
    before = getattr(quant_matmul_experts, attr)
    out = quant_matmul_experts(x, w)
    torch.cuda.synchronize()
    assert getattr(quant_matmul_experts, attr) == before + 1
    assert out.dtype == dtype and out.shape == (b, s, e, n)
    assert torch.isfinite(out).all()
    assert _err(out, _exact(quant_matmul_experts_plain, x, w)) <= TOL[dtype]


def _narrow_body(m, k):
    """The narrow body a call with rows of x [m, k] takes: the vector bodies
    need K in whole 16-byte loads of x."""
    if k % 8:
        return "narrow_bytes"
    return "narrow_split" if m <= 16 else "narrow_smem"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [100, 4096])
@pytest.mark.parametrize("n", [2, 4, 8, 24])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 300, 5120])
def test_quant_matmul_narrow_bodies(card, dtype, bits, k, n, m):
    """kn with rows of 1 to 24 packed bytes (the router is N = 8 and 4):
    the split body at M <= 16, the shared-memory body above, the byte body
    for K = 100; the launch counted once and the body named by the C query."""
    from k8s_llm_rca_tpu_torch.ops.quant_matmul import kn_body

    assert kn_body(bits, m, k, n) == _narrow_body(m, k)
    w = _weight(card, k, n, torch.bfloat16, bits=bits)
    x = torch.randn((m, k), generator=card, device="cuda").to(dtype)
    before = (quant_matmul.launches, quant_matmul.launches_int8)
    out = quant_matmul(x, w)
    torch.cuda.synchronize()
    added = (1, 0) if bits == 4 else (0, 1)
    assert (quant_matmul.launches, quant_matmul.launches_int8) == (
        before[0] + added[0], before[1] + added[1])
    assert out.dtype == dtype and out.shape == (m, n)
    assert torch.isfinite(out).all()
    assert _err(out, _exact(quant_matmul_plain, x, w)) <= TOL[dtype]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("form", ["3d", "4d"])
@pytest.mark.parametrize("b,s,e,k,n", [
    (1, 4, 8, 4096, 8), (1, 300, 8, 4096, 4), (2, 9, 2, 4096, 24),
    (1, 40, 4, 100, 8)])
def test_quant_matmul_experts_narrow_bodies(card, bits, form, b, s, e, k, n):
    """ekn at the router's widths with E > 1: each expert's own weight
    slice, x read through the expert strides."""
    from k8s_llm_rca_tpu_torch.ops.quant_matmul import kn_body

    m = b * s
    assert kn_body(bits, m, k, n, experts=True) == _narrow_body(m, k)
    w = _experts(card, e, k, n, bits)
    shape = (b, s, k) if form == "3d" else (b, s, e, k)
    x = torch.randn(shape, generator=card, device="cuda").bfloat16()
    attr = "launches" if bits == 4 else "launches_int8"
    before = getattr(quant_matmul_experts, attr)
    out = quant_matmul_experts(x, w)
    torch.cuda.synchronize()
    assert getattr(quant_matmul_experts, attr) == before + 1
    assert out.shape == (b, s, e, n) and torch.isfinite(out).all()
    assert _err(out, _exact(quant_matmul_experts_plain, x, w)) <= TOL[
        torch.bfloat16]


def test_quant_matmul_experts_reads_a_strided_x(card):
    """A 4-D x that is a view (every other expert of a wider tensor) is
    copied to rows once; the result equals the plain version's."""
    w = _experts(card, 4, 128, 64, 8)
    wide = torch.randn((2, 3, 8, 128), generator=card, device="cuda")
    x = wide[:, :, ::2]
    out = quant_matmul_experts(x, w)
    assert _err(out, quant_matmul_experts_plain(x, w)) <= TOL[torch.float32]


# ------------------------------------- the redesigned kn bodies (bf16 x)


def _kn_call(gen, bits, form, m, k, n, e):
    """x and weights of a kn call: ``form`` "2d" (quant_matmul, [k, n]),
    "3d" or "4d" (quant_matmul_experts over [e, k, n], the two einsums);
    returns (call, exact reference, the launch counter's getter)."""
    if form == "2d":
        w = _weight(gen, k, n, torch.bfloat16, bits=bits)
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        fn, plain = quant_matmul, quant_matmul_plain
    else:
        w = _experts(gen, e, k, n, bits)
        shape = (1, m, k) if form == "3d" else (1, m, e, k)
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        fn, plain = quant_matmul_experts, quant_matmul_experts_plain
    attr = "launches" if bits == 4 else "launches_int8"
    return (lambda: fn(x, w)), _exact(plain, x, w), lambda: getattr(fn, attr)


def _check_kn(gen, bits, form, m, k, n, e, body):
    from k8s_llm_rca_tpu_torch.ops.quant_matmul import kn_body

    assert kn_body(bits, m, k, n, experts=form != "2d") == body
    call, ref, launches = _kn_call(gen, bits, form, m, k, n, e)
    before = launches()
    out = call()
    torch.cuda.synchronize()
    assert launches() == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= TOL[torch.bfloat16]


# int8 N = 16 and 352, int4 np = 176, 208 and 512: panels of 128 outputs
# that the weight's columns fill partly or not at all
_TILE_WIDTHS = [(8, 16), (8, 352), (4, 352), (4, 416), (4, 1024)]


@pytest.mark.parametrize("bits,n", _TILE_WIDTHS)
@pytest.mark.parametrize("k", [96, 256, 4096, 14336])
@pytest.mark.parametrize("m", [17, 129, 300, 512, 5120])
def test_quant_matmul_tile_body_edges(card, bits, n, k, m):
    """The TMA + wgmma tile body (M > 16): row tiles cut at 17, 129 and
    300, K = 96 ending inside a 64-deep stage, partial column panels."""
    _check_kn(card, bits, "2d", m, k, n, 1, "tile")


@pytest.mark.parametrize("bits,n", [(8, 352), (4, 416)])
@pytest.mark.parametrize("form", ["3d", "4d"])
@pytest.mark.parametrize("e", [1, 8])
@pytest.mark.parametrize("k", [96, 4096])
@pytest.mark.parametrize("m", [17, 300, 5120])
def test_quant_matmul_experts_tile_body_edges(card, bits, n, form, e, k, m):
    """The tile body over stacked experts: the 3-D einsum's x map without an
    expert axis (stride 0), the 4-D einsum's with one (x rows E * K apart)."""
    _check_kn(card, bits, form, m, k, n, e, "tile")


@pytest.mark.parametrize("bits,n", [(8, 352), (4, 416)])
@pytest.mark.parametrize("e,form", [(1, "2d"), (8, "3d"), (8, "4d")])
@pytest.mark.parametrize("k", [128, 4096, 14336])
@pytest.mark.parametrize("m", list(range(1, 17)))
def test_quant_matmul_gemv_body_shapes(card, bits, n, e, form, k, m):
    """The tensor-core weight-streaming body (M <= 16): one or two tiles of
    8 rows of x, K split over a cluster of one to eight blocks."""
    _check_kn(card, bits, form, m, k, n, e, "gemv")


@pytest.mark.parametrize("bits,n", [(8, 352), (4, 416)])
@pytest.mark.parametrize("form,m,k,e", [
    ("2d", 4, 14336, 1), ("2d", 13, 4096, 1), ("3d", 4, 4096, 8),
    ("4d", 4, 14336, 8), ("2d", 300, 4096, 1), ("4d", 129, 4096, 8)])
def test_quant_matmul_bodies_are_deterministic(card, bits, n, form, m, k, e):
    """Two launches on the same inputs give the same bits: the K splits
    meet in a fixed order, with no atomics."""
    call, _, _ = _kn_call(card, bits, form, m, k, n, e)
    first = call()
    second = call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_refuses_an_unaligned_x(card, bits):
    """x that does not start on 16 bytes (the tensor maps' and the vector
    loads' rule) raises before any launch."""
    w = _weight(card, 256, 352, torch.bfloat16, bits=bits)
    we = _experts(card, 2, 256, 352, bits)
    flat = torch.randn((300 * 256 + 1,), generator=card,
                       device="cuda").bfloat16()
    x = flat[1:].view(300, 256)            # 2 bytes past the allocation
    assert x.data_ptr() % 16
    counts = (quant_matmul.launches, quant_matmul.launches_int8,
              quant_matmul_experts.launches,
              quant_matmul_experts.launches_int8)
    with pytest.raises(ValueError, match="16-byte"):
        quant_matmul(x, w)
    with pytest.raises(ValueError, match="16-byte"):
        quant_matmul(x[:4], w)
    with pytest.raises(ValueError, match="16-byte"):
        quant_matmul_experts(x.view(1, 300, 256), we)
    assert counts == (quant_matmul.launches, quant_matmul.launches_int8,
                      quant_matmul_experts.launches,
                      quant_matmul_experts.launches_int8)


# --------------------------------------------------- the nk head bodies

# (bits, K) at the alignment edges: int8 rows of 4 and 260 bytes (not a
# multiple of 16: the FMA body) and 4096; int4 rows of 16, 48 (not a whole
# 64-byte step) and 2048 bytes
_HEAD_BITS_K = [(8, 4), (8, 260), (8, 4096), (4, 32), (4, 96), (4, 4096)]


def _head_body(bits, k, dtype):
    """The body a head call takes: tensor cores for bf16 x over rows of a
    multiple of 16 bytes, else the FMA body."""
    if dtype == torch.bfloat16 and (bits == 4 or k % 16 == 0):
        return "mma"
    return "fma"


def _head_call(gen, bits, dtype, scale_dtype, m, k, v):
    """(call, exact reference, the launch counter's getter) of a head call
    x [m, k] @ a bits-wide table [v, k]^T."""
    w = _weight(gen, k, v, scale_dtype, axis=0, bits=bits)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    attr = "launches" if bits == 4 else "launches_int8"
    return ((lambda: quant_matmul_head(x, w)),
            _exact(quant_matmul_head_plain, x, w),
            lambda: getattr(quant_matmul_head, attr))


def _check_head(gen, bits, dtype, scale_dtype, m, k, v):
    from k8s_llm_rca_tpu_torch.ops.quant_matmul import nk_body

    assert nk_body(bits, m, k, v, dtype) == _head_body(bits, k, dtype)
    call, ref, launches = _head_call(gen, bits, dtype, scale_dtype, m, k, v)
    before = launches()
    out = call()
    torch.cuda.synchronize()
    assert launches() == before + 1
    assert out.dtype == dtype and out.shape == (m, v)
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("bits,k", _HEAD_BITS_K)
@pytest.mark.parametrize("v", [1, 15, 16, 17, 1003, 32000, 128256])
@pytest.mark.parametrize("m", [1, 2, 4, 8, 9, 16, 17])
def test_quant_matmul_head_bodies_bf16(card, bits, k, v, m):
    """bf16 x: the tensor-core body over 64-row panels cut at V = 1..17 and
    1003, one or two tiles of 8 rows of x (M 9-16) and a second tile of
    rows (M 17), K split over the block's warps; int8 rows that are not
    a multiple of 16 bytes take the FMA body."""
    _check_head(card, bits, torch.bfloat16, torch.bfloat16, m, k, v)


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,k", _HEAD_BITS_K)
@pytest.mark.parametrize("v", [1, 17, 1003, 128256])
@pytest.mark.parametrize("m", [1, 4, 9, 17])
def test_quant_matmul_head_bodies_fp32(card, scale_dtype, bits, k, v, m):
    """fp32 x keeps the FMA body, with fp32 and bf16 scales."""
    _check_head(card, bits, torch.float32, scale_dtype, m, k, v)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,v", [(4, 128256), (4, 32000), (2, 32000),
                                 (9, 1003), (17, 17)])
def test_quant_matmul_head_is_deterministic(card, bits, m, v):
    """Two launches on the same inputs give the same bits: the warps' K
    runs meet in a fixed order, with no atomics."""
    call, _, _ = _head_call(card, bits, torch.bfloat16, torch.bfloat16, m,
                            4096, v)
    first = call()
    second = call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_quant_matmul_head_is_one_kernel_per_call(card):
    """The profiler sees exactly one CUDA kernel for each head call: the
    tensor-core body for bf16 x and the FMA body for fp32 x, over int8 and
    int4 tables.  One profiled window holds the four calls."""
    from torch.profiler import ProfilerActivity, profile

    calls = []
    for bits in (8, 4):
        for dtype in (torch.bfloat16, torch.float32):
            call, _, _ = _head_call(card, bits, dtype, torch.bfloat16, 4,
                                    4096, 32000)
            call()                          # build and warm up
            calls.append(call)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    assert sum(e.count for e in kernels) == len(calls), \
        [(e.key, e.count) for e in kernels]
    assert sum("nk_mma_kernel" in e.key for e in kernels) == 2
    assert sum("nk_kernel" in e.key for e in kernels) == 2


# ------------------------------------------------- quantized paged attention


def _quant_pools(args, packed):
    """The float pools of ``_paged_inputs`` quantized per token."""
    q, kp, vp, lens, tables = args
    kq, ks = quantize_kv(kp, packed)
    vq, vs = quantize_kv(vp, packed)
    return q, kq, vq, ks.float(), vs.float(), lens, tables


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_heads,n_kv,d,page", [
    (4, 2, 32, 16), (8, 1, 32, 16), (3, 3, 64, 16), (16, 2, 64, 16),
    (32, 8, 128, 64), (8, 1, 128, 64)])
def test_paged_quant_kernel_matches_plain(card, packed, dtype, n_heads, n_kv,
                                          d, page):
    """GQA 1-8, one kv-head (a head straddling the int4 split), lengths 1,
    a page, a page + 1 and several pages over shuffled page ids."""
    args = _quant_pools(_paged_inputs(card, dtype, n_heads, n_kv, d, page,
                                      [1, page, page + 1, 5 * page + 7]),
                        packed)
    before = paged_attention_quant.launches
    out = paged_attention_quant(*args, packed=packed)
    torch.cuda.synchronize()
    assert paged_attention_quant.launches == before + 1
    ref = paged_attention_quant_plain(*args, packed=packed)
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= TOL[dtype]


# ------------------------------------ paged attention: the one-launch body

_POOLS = ["float", "int8", "int4"]


def _pool_inputs(gen, dtype, pool, n_heads, n_kv, d, page, lengths,
                 pps=None):
    """``_paged_inputs`` as a pool of one kind: float, int8 or int4."""
    args = _paged_inputs(gen, dtype, n_heads, n_kv, d, page, lengths, pps)
    return args if pool == "float" else _quant_pools(args, pool == "int4")


def _pool_call(pool, args):
    """(kernel call, plain call, the wrapper whose launches it counts)."""
    if pool == "float":
        return (lambda: paged_attention(*args),
                lambda: paged_attention_plain(*args), paged_attention)
    packed = pool == "int4"
    return (lambda: paged_attention_quant(*args, packed=packed),
            lambda: paged_attention_quant_plain(*args, packed=packed),
            paged_attention_quant)


def _check_pool(pool, args):
    call, plain, wrapper = _pool_call(pool, args)
    before = wrapper.launches
    out = call()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.isfinite(out).all()
    assert _err(out, plain()) <= TOL[out.dtype]
    return out


@pytest.mark.parametrize("pool", _POOLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("gqa", [1, 4, 8])
def test_paged_body_gqa_head_dims_pages(card, pool, dtype, page, d, gqa):
    """GQA 1/4/8 at head_dim 32/64/128 and page 16/64, every pool and q
    dtype; lengths 1, a page, a page + 1 and several pages."""
    n_kv = 2
    _check_pool(pool, _pool_inputs(card, dtype, pool, gqa * n_kv, n_kv, d,
                                   page, [1, page, page + 1, 5 * page + 7]))


@pytest.mark.parametrize("pool", _POOLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ones", "full_table", "past_table",
                                  "split_edges", "long_table"])
def test_paged_body_length_edges(card, pool, dtype, case):
    """Lengths of 1 only (a fresh prompt's first step: every split but the
    first empty); a length that fills the table; a length past the table
    (the kernel clamps it: the plain version sees every table token);
    lengths on, one before and one past split boundaries of the host's
    plan; and a table of 8192 tokens, whose splits hold more stages than a
    warp's ring."""
    from k8s_llm_rca_tpu_torch.ops.paged_attention import launched_splits

    n_heads, n_kv, d, page, pps = 32, 8, 128, 64, 40
    if case == "ones":
        lengths = [1, 1, 1, 1]
    elif case == "full_table":
        lengths = [pps * page, 3, pps * page, 100]
    elif case == "past_table":
        lengths = [pps * page + 17, 5, pps * page + 1000, 64]
    elif case == "split_edges":
        # the split count this call launches (the plan's most, or fewer
        # when the batch's clusters would not all be resident) and the
        # tokens per split it gives (paged::split_chunk)
        args = _pool_inputs(card, dtype, pool, n_heads, n_kv, d, page,
                            [1] * 4, pps=pps)
        n_split = launched_splits(args[0], args[1], args[-1],
                                  None if pool == "float" else
                                  pool == "int4")
        per = -(-pps * page // n_split)
        chunk = -(-per // 8) * 8
        lengths = [chunk, 2 * chunk, chunk + 1, 3 * chunk - 1]
    else:
        page, pps = 64, 128
        lengths = [8192, 5000, 1, 8000]
    _check_pool(pool, _pool_inputs(card, dtype, pool, n_heads, n_kv, d,
                                   page, lengths, pps=pps))


@pytest.mark.parametrize("pool", _POOLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_body_is_deterministic(card, pool, dtype):
    """Two launches on the same inputs give the same bits: the warps and
    the splits meet in a fixed order, with no atomics."""
    args = _pool_inputs(card, dtype, pool, 32, 8, 128, 64,
                        [1, 64, 65, 2400], pps=40)
    call, _, _ = _pool_call(pool, args)
    first = call()
    second = call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_paged_body_is_one_kernel_per_call(card):
    """The profiler sees exactly one CUDA kernel for each wrapper call, the
    body's, over every pool: the splits merge inside the launch, with no
    second pass.  One profiled window holds the three calls."""
    from torch.profiler import ProfilerActivity, profile

    calls = []
    for pool in _POOLS:
        args = _pool_inputs(card, torch.bfloat16, pool, 32, 8, 128, 64,
                            [1, 64, 65, 2400], pps=40)
        call, _, _ = _pool_call(pool, args)
        call()                              # build and warm up
        calls.append(call)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    assert sum(e.count for e in kernels) == len(calls), \
        [(e.key, e.count) for e in kernels]
    assert all("paged_decode_kernel" in e.key for e in kernels)
    assert len(kernels) == len(calls)      # one body per pool kind
