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
    merge_partials, paged_attention, paged_attention_plain,
    paged_attention_quant, paged_attention_quant_plain,
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


def _lse_calls(pool, args):
    """(kernel, plain) of a pool kind, both with ``return_lse``."""
    if pool == "float":
        return (lambda a: paged_attention(*a, return_lse=True),
                lambda a: paged_attention_plain(*a, return_lse=True))
    packed = pool == "int4"
    return (lambda a: paged_attention_quant(*a, packed=packed,
                                            return_lse=True),
            lambda a: paged_attention_quant_plain(*a, packed=packed,
                                                  return_lse=True))


@pytest.mark.parametrize("pool", _POOLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gqa,d,page", [(4, 128, 64), (1, 32, 16),
                                        (8, 64, 16)])
def test_paged_lse_matches_plain_at_a_cp_rank(card, pool, dtype, gqa, d,
                                              page):
    """``return_lse`` of rows 1-2 at a CP-2 rank's share (its half of each
    table, lengths clamped to its range): out and lse against the plain
    version (lse atol 1e-3), the second rank's range empty for two rows
    (lse -1e30 and a zero output, exactly); the two ranks' outputs merged
    (``merge_partials``) equal the whole-table call; the output without
    lse is the same bits as with it."""
    pps, n_kv = 8, 2
    span = pps // 2 * page
    args = _pool_inputs(card, dtype, pool, gqa * n_kv, n_kv, d, page,
                        [1, span, span + 1, 2 * span - 3], pps=pps)
    kernel, plain = _lse_calls(pool, args)
    lens, tables = args[-2], args[-1]
    outs, lses = [], []
    for p in range(2):
        part = args[:-2] + (
            (lens - p * span).clamp(0, span).to(torch.int32),
            tables[:, p * pps // 2:(p + 1) * pps // 2].contiguous())
        out, lse = kernel(part)
        ref_out, ref_lse = plain(part)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert _err(out, ref_out) <= TOL[dtype]
        assert (lse - ref_lse).abs().max().item() <= 1e-3
        outs.append(out)
        lses.append(lse)
    assert torch.all(lses[1][:2] == -1e30) and torch.all(outs[1][:2] == 0)
    merged = merge_partials(torch.stack(outs), torch.stack(lses))
    whole = _pool_call(pool, args)[0]()
    assert _err(merged, whole) <= TOL[dtype]
    assert torch.equal(kernel(args)[0], whole)


@pytest.mark.parametrize("pool", _POOLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_lse_on_folded_verify_rows_at_a_cp_rank(card, pool, dtype):
    """The CP verify step's fold (``engine/paged.py::_cp_fold_view``): T
    = 5 queries of each of 4 slots as 20 rows of one call with
    ``return_lse``, row (b, i) over slot b's half of the table and
    ``lengths[b] + 1 + i`` positions clamped to the rank's range, 8B's
    32/8 heads at head_dim 128 over pages of 64.  Each rank's call is one
    launch; out and lse agree with the plain version (lse atol 1e-3);
    rank 1's rows of the slots that have not reached its range have
    length 0, lse -1e30 and a zero output; the two ranks merged equal the
    whole-table call on the same 20 rows."""
    b, t, pps, page, n_kv, d = 4, 5, 40, 64, 8, 128
    span = pps // 2 * page
    slot_lens = [400, 1270, 1276, 2290]
    args = _pool_inputs(card, dtype, pool, 32, n_kv, d, page,
                        [n + t for n in slot_lens], pps=pps)
    q = torch.randn((b * t, 32, d), generator=card,
                    device="cuda").to(dtype)
    rows = torch.tensor([n + 1 + i for n in slot_lens for i in range(t)],
                        dtype=torch.int32, device="cuda")
    tables = args[-1].repeat_interleave(t, dim=0).contiguous()
    kernel, plain = _lse_calls(pool, args)
    wrapper = paged_attention if pool == "float" else paged_attention_quant
    outs, lses = [], []
    for p in range(2):
        part = (q,) + args[1:-2] + (
            (rows - p * span).clamp(0, span).to(torch.int32),
            tables[:, p * pps // 2:(p + 1) * pps // 2].contiguous())
        before = wrapper.launches
        out, lse = kernel(part)
        assert wrapper.launches == before + 1
        ref_out, ref_lse = plain(part)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert _err(out, ref_out) <= TOL[dtype]
        assert (lse - ref_lse).abs().max().item() <= 1e-3
        outs.append(out)
        lses.append(lse)
    # rank 1's range starts at 1280: the first two slots' rows and four of
    # the third's see none of it
    empty = (rows <= span).nonzero().flatten()
    assert len(empty) == 14
    assert torch.all(lses[1][empty] == -1e30)
    assert torch.all(outs[1][empty] == 0)
    merged = merge_partials(torch.stack(outs), torch.stack(lses))
    whole = kernel((q,) + args[1:-2] + (rows, tables))[0]
    assert _err(merged, whole) <= TOL[dtype]


@pytest.mark.parametrize("drafts", ["ngram", "self"])
@pytest.mark.parametrize("mesh", ["tp_mesh", "cp_mesh"])
def test_speculation_on_a_one_rank_nccl_mesh_replays_graphs(card, mesh,
                                                            drafts):
    """Speculation (k 4, stepwise; one-token n-grams, or the model as its
    own draft, whose drafts are accepted) on a 1-rank nccl mesh, graphed:
    the streams and the speculation counters of the unsharded graphed
    engine, a draft model's drafts broadcast once a verify tick over nccl
    (through a card tensor), the verify step replayed as a graph (under
    CP one "multi" graph for every length: the fold gathers no pages) and,
    under CP, no flash launch (the ring prefill, and a verify step's paged
    kernel with the rows' lse, once a layer, as a decode step's)."""
    from k8s_llm_rca_tpu_torch.config import TINY
    from k8s_llm_rca_tpu_torch.runtime import mesh as rmesh

    over = dict(speculative_k=4, speculative_ngram=1, decode_chunk=1,
                page_size=64, num_pages=48)
    prompts = [list(range(5, 25)) * 5, list(range(40, 90))]
    keys = ("engine.spec_drafted", "engine.spec_accepted",
            "engine.verify_steps")
    self_draft = drafts == "self"
    base = _tiny_engine(True, self_draft=self_draft, **over)
    want = [r.token_ids for r in base.generate(prompts)]
    want_counts = {k: base._counts[k] for k in keys}
    assert rmesh.initialize_distributed()
    try:
        engine = _tiny_engine(True, meshes={
            mesh: rmesh.single_device_mesh()}, self_draft=self_draft,
            **over)
        rmesh.reset_collective_counts()
        flash, paged = flash_attention.launches, paged_attention.launches
        got = [r.token_ids for r in engine.generate(prompts)]
        flash = flash_attention.launches - flash
        paged = paged_attention.launches - paged
        broadcasts = rmesh.collective_counts()["broadcast"]
    finally:
        rmesh.shutdown_distributed()
    assert got == want
    assert {k: engine._counts[k] for k in keys} == want_counts
    c, n = engine._counts, TINY.n_layers
    if self_draft:
        assert c["engine.spec_accepted"] > 0
        assert broadcasts == c["engine.verify_steps"]
        # the draft's re-prefills attend through flash too
        flash -= n * engine._draft.prefills
    else:
        assert broadcasts == 0
    multi = [k for k in engine.graphs.buckets if k[0] == "multi"]
    assert multi and engine._counts["engine.graph_replays"] > 0
    if mesh == "cp_mesh":
        assert {k[2] for k in multi} == {0}
        assert flash == 0
        assert paged == n * c["engine.decode_steps"]


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


# --------------------------------------------- grammar steps (no kernel)


def _grammar_logits(vocab, rows=4, seed=0):
    """Seeded fp32 logits with exact ties in row 3 (argmax must take the
    first maximum on both devices)."""
    logits = np.random.default_rng(seed).standard_normal(
        (rows, vocab)).astype(np.float32)
    logits[3, ::7] = logits[3].max() + 1.0
    return logits


@pytest.mark.parametrize("vocab", [512, 128256])
def test_sample_tokens_masked_card_equals_cpu(card, vocab):
    """The masked greedy sample of the stepwise grammar tick on the card
    equals the CPU's: a sparse mask, an empty row (every logit NEG_INF),
    a single allowed token and tied maxima."""
    from k8s_llm_rca_tpu_torch.engine.sampling import (
        SamplingParams, sample_tokens_masked,
    )

    logits = _grammar_logits(vocab)
    allow = np.random.default_rng(1).random((4, vocab)) < 0.3
    allow[1] = False
    allow[2] = False
    allow[2, vocab - 1] = True
    allow[3, ::7] = True
    outs = [sample_tokens_masked(torch.from_numpy(logits).to(dev), None,
                                 SamplingParams(),
                                 torch.from_numpy(allow).to(dev)).cpu()
            for dev in ("cpu", "cuda")]
    assert torch.equal(outs[1], outs[0])
    assert outs[0][2].item() == vocab - 1 and outs[0][3].item() == 0


def _dfa_tables(vocab, n_states=9, seed=2):
    """Synthetic fused tables: the last row is FREE (all allowed, dist 0,
    self-loop); state 1 is complete; state 2 allows nothing."""
    rng = np.random.default_rng(seed)
    free = n_states - 1
    allow = rng.random((n_states, vocab)) < 0.2
    nxt = rng.integers(0, free, (n_states, vocab)).astype(np.int32)
    dist = rng.integers(0, 40, n_states).astype(np.int32)
    close = rng.integers(0, 256, n_states).astype(np.int32)
    complete = np.zeros(n_states, bool)
    complete[1] = True
    dist[1] = 0
    allow[1] = False
    allow[2] = False
    allow[free] = True
    nxt[free] = free
    dist[free] = 0
    return allow, nxt, dist, close, complete


@pytest.mark.parametrize("vocab", [512, 128256])
def test_dfa_scan_step_card_equals_cpu(card, vocab):
    """Three chained DFA scan steps on the card equal the CPU's: slots in
    an ordinary state, a complete state (EOS), an empty row (force
    close), a budget too small for any successor (force close), the FREE
    row and a slot already done."""
    from k8s_llm_rca_tpu_torch.engine.engine import dfa_scan_step
    from k8s_llm_rca_tpu_torch.engine.sampling import SamplingParams

    tables = _dfa_tables(vocab)
    free = len(tables[0]) - 1
    b = 6
    logits = _grammar_logits(vocab, rows=b, seed=3)
    eos = 258
    results = []
    for dev in ("cpu", "cuda"):
        t = [torch.from_numpy(a).to(dev) for a in tables]
        cur = torch.arange(b, dtype=torch.int32, device=dev)
        lens = torch.full((b,), 10, dtype=torch.int32, device=dev)
        done = torch.tensor([0, 0, 0, 0, 0, 1], dtype=torch.bool,
                            device=dev)
        states = torch.tensor([0, 1, 2, 3, free, 4], dtype=torch.int32,
                              device=dev)
        remaining = torch.tensor([60, 60, 60, 1, 1 << 30, 60],
                                 dtype=torch.int32, device=dev)
        lg = torch.from_numpy(logits).to(dev)
        steps = []
        for _ in range(3):
            cur, lens, done, states, remaining = dfa_scan_step(
                lg, cur, lens, done, states, remaining, None,
                SamplingParams(), eos, *t)
            steps.append([x.cpu() for x in (cur, lens, done, states,
                                            remaining)])
        results.append(steps)
    for cpu_step, card_step in zip(*results):
        for a, c in zip(cpu_step, card_step):
            assert torch.equal(c, a)
    first = results[0][0]
    assert first[0][1].item() == eos and first[2][1].item()   # complete
    assert first[0][2].item() == int(tables[3][2])            # force close
    assert first[0][5].item() == 5                            # done: held


# ------------------------------------------------ CUDA graphs of the engine


def _tiny_engine(graphs, bits=None, kv=None, meshes=None,
                 self_draft=False, **over):
    """TINY (fp32, projections x3) on the card, ``bits``-wide weights under
    fused_quant_matmul when given; replaying CUDA graphs or eager;
    ``meshes``: ``make_engine``'s mesh keywords (1-rank meshes, whose
    shard of the weights is the tree itself); ``self_draft``: the model
    drafts for itself (``draft_model=``)."""
    from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.models.quant import quantize_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = TINY.replace(fused_quant_matmul=bits is not None)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for layer in params["layers"]:
        for name in layer:
            if name.startswith("w"):
                layer[name] = layer[name] * 3.0
    if bits is not None:
        params = quantize_params(params, bits=bits)
    params = {k: ([{n: _card_leaf(t) for n, t in layer.items()}
                   for layer in v] if k == "layers" else _card_leaf(v))
              for k, v in params.items()}
    kw = dict(max_batch=4, max_seq_len=512, prefill_buckets=(128, 256),
              max_new_tokens=40, paged=True, page_size=16, num_pages=168,
              prefix_cache=False, decode_chunk=16, kv_cache_dtype=kv)
    kw.update(over)
    if self_draft:
        over_kw = dict(meshes or {}, draft_model=(cfg, params))
    else:
        over_kw = dict(meshes or {})
    return make_engine(cfg, EngineConfig(**kw), params,
                       get_tokenizer(vocab_size=cfg.vocab_size),
                       cuda_graphs=graphs, **over_kw)


def _card_leaf(w):
    if isinstance(w, tuple):
        return type(w)(*(t.cuda() for t in w))
    return w.cuda()


def _graph_workload(engine, case):
    """Greedy streams of a workload: ``step`` (decode_chunk 1), ``scan``
    (prompts near the cache cap, so the scans take chunks 16, 8, 4 and 2)
    or ``dfa`` (a compiled grammar slot beside a free one)."""
    from k8s_llm_rca_tpu_torch.engine.constrain import DFAGrammar

    rng = np.random.default_rng(1 if case == "scan" else 0)
    if case == "scan":
        out = []
        for n, m in ((466, 45), (469, 42)):
            out += [r.token_ids for r in engine.generate(
                [[int(t) for t in rng.integers(0, 256, n)]],
                max_new_tokens=m)]
        return out
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (7, 100, 150)]
    if case == "step":
        return [r.token_ids for r in engine.generate(prompts)]
    ids = [engine.submit(prompts[0], max_new_tokens=80,
                         grammar=DFAGrammar(MIXED_SCHEMA, engine.tokenizer)),
           engine.submit(prompts[1], max_new_tokens=60)]
    res = {r.seq_id: r for r in engine.run_to_completion()}
    return [res[i].token_ids for i in ids]


# test_torch_engine's mixed schema (that module imports jax)
MIXED_SCHEMA = {"type": "object", "properties": [
    ("kind", {"enum": ["ConfigMap", "Job", "Pod", "Secret"]}),
    ("count", {"type": "integer", "max_digits": 3}),
    ("note", {"type": "string", "max_len": 24}),
]}
_GRAPH_KEYS = {"step": {("step",)},
               "scan": {("scan", c) for c in (2, 4, 8, 16)},
               "dfa": {("dfa", 16, 1024)}}


@pytest.mark.parametrize("case", ["step", "scan", "dfa"])
def test_graphed_streams_equal_eager(card, case):
    """The graphed engine emits the eager engine's greedy tokens: the
    single step, every scan bucket and the DFA scan over the padded
    tables; each bucket is captured once and replayed after that."""
    over = {"decode_chunk": 1} if case == "step" else {}
    streams, keys = [], None
    for graphs in (False, True):
        engine = _tiny_engine(graphs, **over)
        streams.append(_graph_workload(engine, case))
        if graphs:
            keys = set(engine.graphs.buckets)
            c = engine._counts
            assert c["engine.graph_captures"] == len(keys)
            assert c["engine.graph_replays"] > 0
        else:
            assert engine.graphs is None
    assert streams[1] == streams[0]
    assert _GRAPH_KEYS[case] <= keys


def test_graph_replays_account_for_every_launch_counter(card):
    """int4 weights under fused_quant_matmul over an int4 pool (kn, nk,
    quantized paged attention, flash): the graphed engine's launch
    counters equal the eager engine's for the same work."""
    from k8s_llm_rca_tpu_torch.engine.graphs import launch_counters

    counts = []
    for graphs in (False, True):
        engine = _tiny_engine(graphs, bits=4, kv="int4")
        before = [getattr(f, a) for f, a in launch_counters()]
        _graph_workload(engine, "scan")
        counts.append([getattr(f, a) - b for (f, a), b in
                       zip(launch_counters(), before)])
        assert (engine._counts.get("engine.graph_replays", 0) > 0) == graphs
    assert counts[1] == counts[0]
    assert sum(counts[1]) > 0 and all(n >= 0 for n in counts[1])


def test_failed_capture_raises_naming_the_bucket(card):
    """A function that syncs with the host cannot be captured: the runner
    raises, naming the bucket, and the card stays usable."""
    from k8s_llm_rca_tpu_torch.engine.graphs import DecodeGraphs

    graphs = DecodeGraphs(torch.device("cuda"), None, lambda *a: None)
    x = torch.ones(4, device="cuda")
    with pytest.raises(RuntimeError, match=r"capture of decode bucket "
                                           r"\('scan', 8\)"):
        graphs.run(("scan", 8), lambda: (x * 2).sum().item())
    assert (x + 1).sum().item() == 8.0


def test_graph_replays_advance_the_generator(card):
    """A graph that samples registers the engine's generator: each replay
    draws new numbers, and a sampling engine (temperature 1) scans
    through its graphs."""
    from k8s_llm_rca_tpu_torch.engine.graphs import DecodeGraphs

    gen = torch.Generator(device="cuda").manual_seed(0)
    graphs = DecodeGraphs(torch.device("cuda"), gen, lambda *a: None)

    def draw():
        return torch.empty(8, device="cuda").exponential_(1.0, generator=gen)

    draws = [graphs.run(("scan", 2), draw).clone() for _ in range(3)]
    assert not torch.equal(draws[1], draws[2])
    assert not torch.equal(draws[0], draws[1])
    engine = _tiny_engine(True, temperature=1.0)
    res = engine.generate([[5, 6, 7]] * 2, max_new_tokens=40)
    assert all(len(r.token_ids) > 0 for r in res)
    assert engine._counts["engine.graph_replays"] > 0


def test_no_collection_inside_a_capture(card):
    """The cyclic collector is off while a capture lasts and back on after
    it: a dead engine in a reference cycle, freed by the collector inside a
    capture, invalidates the capture (phase 3 then phase 4 of
    ``chip_smoke.py`` failed so), and PyTorch no longer collects before a
    capture by itself.  The capture still replays."""
    import gc

    from k8s_llm_rca_tpu_torch.engine.graphs import DecodeGraphs

    x = torch.ones(4, device="cuda")
    enabled = []

    def fn():
        enabled.append(gc.isenabled())
        return x * 3

    graphs = DecodeGraphs(torch.device("cuda"), None, lambda *a: None)
    graphs.run(("scan", 2), fn)
    assert enabled == [True, False]            # the warm-up, the capture
    assert gc.isenabled()
    assert graphs.run(("scan", 2), fn).sum().item() == 12.0


def test_graph_pool_is_freed_with_the_engine(card):
    """An engine's graphs and their memory pool go with the engine: the
    runner is collected and no segment of its pool is left on the card."""
    import gc
    import weakref

    engine = _tiny_engine(True)
    _graph_workload(engine, "scan")
    runner = weakref.ref(engine.graphs)
    pool = tuple(engine.graphs._pool)
    assert engine.graphs.pool_bytes > 0
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    assert runner() is None
    assert not any(tuple(seg.get("segment_pool_id", ())) == pool
                   for seg in torch.cuda.memory_snapshot())


# ------------------------------------------ attention over KV pages (flash)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["hit", "verify"])
@pytest.mark.parametrize("shape", ["tiny", "8b"])
def test_attend_over_pages_matches_plain(card, shape, case, dtype):
    """``attend_over_pages`` on the card (the pages gathered into a buffer
    indexed by position, then one flash launch) against its plain version:
    "hit", two chunks over cached prefixes of different lengths with their
    fresh K/V, padded queries past a row's chunk length; "verify", T = 5
    queries at per-row lengths over the pool, one row on a page edge.  At
    TINY's heads (4 over 2, d 32, page 16) and Llama-3-8B's (32 over 8, d
    128, page 64)."""
    from k8s_llm_rca_tpu_torch.config import LLAMA3_8B, TINY
    from k8s_llm_rca_tpu_torch.engine.paged import (
        PagePool, attend_over_pages, attend_over_pages_plain,
    )

    base, page = (TINY, 16) if shape == "tiny" else (LLAMA3_8B, 64)
    cfg = base.replace(dtype="float32" if dtype == torch.float32
                       else "bfloat16")
    h, n_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def rnd(*s):
        return torch.randn(s, generator=card, device="cuda").to(dtype)

    def ints(v):
        return torch.tensor(v, dtype=torch.int32, device="cuda")

    n_pages = 48
    pool = PagePool(rnd(1, n_pages, page, n_kv * d),
                    rnd(1, n_pages, page, n_kv * d))
    ids = torch.randperm(n_pages - 1, generator=card, device="cuda") + 1
    if case == "hit":
        c = 2 * page
        tables = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
        tables[0, :3] = ids[:3].int()
        tables[1, :5] = ids[3:8].int()
        off = ints([3 * page, 5 * page])
        lens = off + ints([c, page + 3])
        q = rnd(2, c, h, d)
        fresh, n_p = (rnd(2, c, n_kv, d), rnd(2, c, n_kv, d)), None
    else:
        lengths, t = [3, page - 5, 3 * page + 1], 5
        tables = torch.zeros((3, 6), dtype=torch.int32, device="cuda")
        used = 0
        for i, n in enumerate(lengths):
            k = -(-(n + t) // page)
            tables[i, :k] = ids[used:used + k].int()
            used += k
        off, lens = ints(lengths), ints([n + t for n in lengths])
        q, fresh, n_p = rnd(3, t, h, d), None, 5
    before = flash_attention.launches
    out = attend_over_pages(cfg, q, pool, 0, tables, off, lens, fresh, n_p)
    assert flash_attention.launches == before + 1
    ref = attend_over_pages_plain(cfg, q, pool, 0, tables, off, lens, fresh)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    if case == "hit":        # row 1's padded queries need only be finite
        assert _err(out[1, :page + 3], ref[1, :page + 3]) <= TOL[dtype]
        out, ref = out[0], ref[0]
    assert _err(out, ref) <= TOL[dtype]


_FEATURES = {"speculative": {"speculative_k": 4, "speculative_ngram": 1},
             "speculative-dfa": {"speculative_k": 4,
                                 "speculative_ngram": 1},
             "overlap": {"host_overlap": True}}


@pytest.mark.parametrize("feature", list(_FEATURES))
def test_verify_and_overlap_graphs_replay_with_launch_counts(card, feature):
    """The verify step ("multi", and "multi-dfa" under a DFA grammar) and
    the overlapped step ("overlap") replay as graphs: their streams equal
    the eager engine's and every kernel's launch counter gains what the
    eager engine's does for the same work (flash per verify step, paged
    per overlapped step)."""
    from k8s_llm_rca_tpu_torch.engine.constrain import DFAGrammar
    from k8s_llm_rca_tpu_torch.engine.graphs import launch_counters

    over = dict(_FEATURES[feature], decode_chunk=1, page_size=64,
                num_pages=48)
    rng = np.random.default_rng(2)
    prompts = [list(range(5, 25)) * 5] + [
        [int(t) for t in rng.integers(0, 256, n)] for n in (40, 130)]
    streams, counts = [], []
    for graphs in (False, True):
        engine = _tiny_engine(graphs, **over)
        before = [getattr(f, a) for f, a in launch_counters()]
        ids = [engine.submit(p, grammar=DFAGrammar(MIXED_SCHEMA,
                                                   engine.tokenizer)
                             if feature.endswith("dfa") and i == 0
                             else None)
               for i, p in enumerate(prompts)]
        res = {r.seq_id: r.token_ids for r in engine.run_to_completion()}
        streams.append([res[i] for i in ids])
        counts.append([(f.__name__, a, getattr(f, a) - b) for (f, a), b in
                       zip(launch_counters(), before)])
        if graphs:
            keys = {k[0] for k in engine.graphs.buckets}
            want = {"speculative": "multi", "speculative-dfa": "multi-dfa",
                    "overlap": "overlap"}[feature]
            assert want in keys, keys
            assert engine._counts["engine.graph_replays"] > 0
    assert streams[1] == streams[0]
    assert counts[1] == counts[0]
    by_name = {n: c for n, a, c in counts[1] if a == "launches"}
    assert by_name["flash_attention"] > 0
    if feature != "overlap":
        assert engine._counts["engine.verify_steps"] > 0


# ------------------------------------------------------ memory tiers


@pytest.mark.parametrize("kv", [None, "int8", "int4"])
def test_pinned_gather_restores_byte_equal(card, kv):
    """``gather_pages`` on the card lands in one pinned buffer (one sync);
    encode -> decode -> restore into other page ids writes the same
    bytes back, for a bf16 pool and the int8 and int4 pools."""
    from k8s_llm_rca_tpu_torch.config import TINY
    from k8s_llm_rca_tpu_torch.engine.paged import init_paged_cache
    from k8s_llm_rca_tpu_torch.utils import pages

    cfg = TINY.replace(dtype="bfloat16")
    pool = init_paged_cache(cfg, 24, 16, "cuda", kv_dtype=kv)
    for t in pool:
        if t is not None:
            t.copy_(torch.randint(-100, 100, t.shape, device="cuda",
                                  generator=card).to(t.dtype))
    ids = [3, 17, 5, 9]
    rec = pages.gather_pages(pool, pages.to_host, ids)
    for f in pages.pool_fields(pool):
        assert rec[f].device.type == "cpu" and rec[f].is_pinned()
        assert torch.equal(rec[f], getattr(pool, f)[:, ids].cpu())
    back = pages.stack_pages(
        [pages.decode_page_record(pages.encode_page_record(r))
         for r in pages.split_pages(rec)], pin=True)
    k_ptr = pool.k.data_ptr()
    pages.restore_pages(pool, back, [20, 21, 22, 23])
    torch.cuda.synchronize()
    assert pool.k.data_ptr() == k_ptr
    for f in pages.pool_fields(pool):
        t = getattr(pool, f)
        assert torch.equal(t[:, [20, 21, 22, 23]], t[:, ids])


@pytest.mark.parametrize("kv", [None, "int4"])
def test_restore_in_place_keeps_a_captured_graph_right(card, kv):
    """A graphed engine captures its scans, a "preempt" tick fault spills
    the youngest sequence and the next admission restores its pages into
    other page ids: the replayed graphs read the restored pages, so the
    streams equal the eager engine's under the same fault."""
    from k8s_llm_rca_tpu_torch.faults import inject
    from k8s_llm_rca_tpu_torch.faults.plan import Fault, FaultPlan

    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (30, 100, 150, 200)]
    streams = []
    for graphs in (False, True):
        engine = _tiny_engine(graphs, bits=4 if kv else None, kv=kv,
                              max_spilled_pages=64)
        engine.generate(prompts[:1], max_new_tokens=40)   # capture first
        plan = FaultPlan([Fault(inject.SITE_ENGINE_TICK, 2, "preempt",
                                wave=2)])
        with inject.armed(plan):
            streams.append([r.token_ids for r in engine.generate(prompts)])
        c = engine._counts
        assert c["engine.restored_pages"] == c["engine.spilled_pages"] > 0
        if graphs:
            assert c["engine.graph_replays"] > 0
        engine.allocator.check()
        assert type(engine.allocator).__name__ == "NativePageAllocator"
    assert streams[1] == streams[0]


def test_recovered_engine_run_on_the_card_equals_the_cpu(card, tmp_path):
    """Slice 13: a journaled run interrupted mid-decode (its sequence
    cancelled, as a kill does) and recovered onto a fresh backend of the
    same TINY engine replies on the card as the uninterrupted run does on
    the CPU, on the same seeded weights."""
    from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.serve.api import AssistantService, RunStatus
    from k8s_llm_rca_tpu_torch.serve.backend import EngineBackend, GenOptions
    from k8s_llm_rca_tpu_torch.serve.journal import RunJournal
    from k8s_llm_rca_tpu_torch.serve.recover import recover_service
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = TINY.replace(max_seq_len=64)
    ecfg = EngineConfig(max_batch=4, max_seq_len=64, paged=True,
                        page_size=8, num_pages=24, prefill_buckets=(16, 32),
                        max_new_tokens=8, temperature=0.0, decode_chunk=1,
                        prefix_cache=False)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def lifecycle(service):
        a = service.create_assistant("test", "t")
        th = service.create_thread()
        service.add_message(th.id, "pod crashloop")
        return service.create_run(th.id, a.id,
                                  gen=GenOptions(max_new_tokens=8))

    def reply(service, run):
        return service.list_messages(run.thread_id).data[0].raw_content

    cpu_eng = make_engine(cfg, ecfg, cpu_params, tok, device="cpu")
    cpu_svc = AssistantService(EngineBackend(cpu_eng))
    want = reply(cpu_svc, cpu_svc.wait_run(lifecycle(cpu_svc).id))

    card_params = {k: ([{n: _card_leaf(t) for n, t in layer.items()}
                        for layer in v] if k == "layers" else _card_leaf(v))
                   for k, v in cpu_params.items()}
    eng = make_engine(cfg, ecfg, card_params, tok)
    path = str(tmp_path / "serve.wal")
    backend = EngineBackend(eng)
    service = AssistantService(backend, journal=RunJournal(path))
    run = lifecycle(service)
    service.retrieve_run(run.id)
    assert service.runs[run.id].status == RunStatus.IN_PROGRESS
    service._journal.close()
    for handle in list(backend._live):
        backend.cancel(handle)
    svc, report = recover_service(path, EngineBackend(eng))
    assert report["resubmitted"] == [run.id]
    got = svc.wait_run(run.id)
    assert got.status == RunStatus.COMPLETED
    assert reply(svc, got) == want
    eng.allocator.check()
    assert eng.allocator.n_free == ecfg.num_pages - 1


def test_cli_engine_defaults_to_the_card(card):
    """The sweep drivers' ``--device`` is ``cuda`` unless given: the
    engine they build lives on the card."""
    import argparse

    from k8s_llm_rca_tpu_torch.sweeps.common import (
        add_common_args, build_service,
    )

    parser = argparse.ArgumentParser()
    add_common_args(parser)
    args = parser.parse_args(["--backend", "engine", "--paged", "--model",
                              "tiny", "--max-seq-len", "256"])
    assert args.device == "cuda"
    engine = build_service(args).backend.engine
    assert engine.device.type == "cuda"
    assert engine.params["final_norm"].is_cuda


# ------------------------------------------------------------ slice 14


def _card_tree(tree):
    """A param tree on the card (quantized leaves field by field)."""
    if isinstance(tree, dict):
        return {k: _card_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_card_tree(v) for v in tree]
    return _card_leaf(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_on_the_card_equals_the_cpu(card, dtype):
    """Slice 14: TINY_ENCODER's embeddings on the card against the CPU on
    the same seeded weights (fp32 atol 1e-4, TF32 off; bf16 cosine above
    0.999), padded rows masked."""
    import dataclasses

    from k8s_llm_rca_tpu_torch.config import TINY_ENCODER
    from k8s_llm_rca_tpu_torch.models import encoder

    cfg = dataclasses.replace(TINY_ENCODER, dtype=dtype)
    cpu = encoder.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (3, 40),
                         generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([40, 17, 1])
    want = encoder.embed(cfg, cpu, toks, lens)
    got = encoder.embed(cfg, _card_tree(cpu), toks.cuda(), lens.cuda()).cpu()
    if dtype == "float32":
        assert (got - want).abs().max().item() <= 1e-4
    else:
        assert (got * want).sum(-1).min().item() > 0.999


@pytest.mark.parametrize("kv", [None, "int8", "int4"])
def test_contiguous_engine_on_the_card_equals_the_cpu(card, kv):
    """Slice 14: the contiguous-slot engine (TINY fp32, its projections
    x3, stepwise and at decode_chunk 8) gives the CPU engine's greedy
    streams on the card, with one flash launch per layer and prefill
    dispatch and no paged-attention launch."""
    from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cpu = init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    for layer in cpu["layers"]:
        for name in layer:
            if name.startswith("w"):
                layer[name] = layer[name] * 3.0
    prompts = [list(range(1, n)) for n in (6, 40, 130, 70)]
    tok = get_tokenizer(vocab_size=TINY.vocab_size)
    for chunk in (1, 8):
        ecfg = EngineConfig(max_batch=4, max_seq_len=256, max_new_tokens=20,
                            prefill_buckets=(64, 128, 256), decode_chunk=chunk,
                            kv_cache_dtype=kv)
        want = [r.token_ids for r in make_engine(
            TINY, ecfg, cpu, tok, device="cpu").generate(prompts)]
        flash0, paged0 = flash_attention.launches, paged_attention.launches
        eng = make_engine(TINY, ecfg, _card_tree(cpu), tok)
        got = [r.token_ids for r in eng.generate(prompts)]
        assert got == want
        assert flash_attention.launches - flash0 == TINY.n_layers * int(
            eng._counts["engine.prefill_dispatches"])
        assert paged_attention.launches == paged0


def test_draft_model_on_the_card_equals_greedy(card):
    """Slice 14: ``draft_model=`` (the target itself, every draft
    accepted) on the card's contiguous and paged engines gives plain
    greedy's streams."""
    from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    params = init_params(TINY, torch.Generator(device="cuda").manual_seed(0))
    tok = get_tokenizer(vocab_size=TINY.vocab_size)
    prompts = [list(range(1, n)) for n in (6, 40, 70)]
    kw = dict(max_batch=4, max_seq_len=256, max_new_tokens=20,
              decode_chunk=1, page_size=16, num_pages=64,
              prefix_cache=False)
    plain = [r.token_ids for r in make_engine(
        TINY, EngineConfig(**kw), params, tok).generate(prompts)]
    for paged in (False, True):
        eng = make_engine(TINY, EngineConfig(**kw, paged=paged,
                                             speculative_k=3), params, tok,
                          draft_model=(TINY, params))
        assert [r.token_ids for r in eng.generate(prompts)] == plain
        assert eng._counts["engine.spec_accepted"] > 0


def test_load_llama_onto_the_card_is_bit_equal(card, tmp_path):
    """Slice 14: a bf16 tree exported to a two-shard HF dir and loaded onto
    the card comes back bit-equal, every projection contiguous."""
    from k8s_llm_rca_tpu_torch.config import TINY
    from k8s_llm_rca_tpu_torch.models import llama, loader

    cfg = TINY.replace(dtype="bfloat16", tie_embeddings=False)
    params = llama.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0))
    loader.write_sharded_safetensors(str(tmp_path / "ck"),
                                     loader.llama_params_to_hf(cfg, params), 2)
    back = loader.load_llama(cfg, str(tmp_path / "ck"))
    for name in ("embedding", "lm_head", "final_norm"):
        assert torch.equal(back[name].view(torch.int16),
                           params[name].view(torch.int16))
    for a, b in zip(params["layers"], back["layers"]):
        for k in a:
            assert b[k].is_cuda and b[k].is_contiguous()
            assert torch.equal(a[k].view(torch.int16), b[k].view(torch.int16))
