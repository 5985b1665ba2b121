"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips on a host without a CUDA device (the
decision is made inside the fixture, never at import).  On a machine with
a card and no JAX, run them without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: fp32 atol 1e-4 with TF32 off (both sides fp32, different
summation orders).  bf16: for every output row (one token and head, d
values) the largest |out - ref| is at most 2^-6 of the row's largest
|ref|, a limit that scales with the values compared.  Each side rounds an
element to bf16 once, at most one ulp (2^-7 of the row's largest value)
apart; the bf16 flash body's bf16 probabilities add a small fraction of
that.
"""

import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu_torch.ops.attention import causal_attention
from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention
from k8s_llm_rca_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_plain,
)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}


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


def _paged_inputs(gen, dtype, n_heads, n_kv, d, page, lengths):
    pps = max(-(-n // page) for n in lengths) + 1
    n_pages = 1 + sum(-(-n // page) for n in lengths) + 3
    q = torch.randn((len(lengths), n_heads, d), generator=gen,
                    device="cuda").to(dtype)
    kp = torch.randn((n_pages, page, n_kv * d), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((n_pages, page, n_kv * d), generator=gen,
                     device="cuda").to(dtype)
    ids = np.random.default_rng(0).permutation(np.arange(1, n_pages))
    tables = np.zeros((len(lengths), pps), np.int32)   # tails: trash page
    used = 0
    for i, n in enumerate(lengths):
        n_p = -(-n // page)
        tables[i, :n_p] = ids[used:used + n_p]
        used += n_p
    return (q, kp, vp, torch.tensor(lengths, dtype=torch.int32,
                                    device="cuda"),
            torch.from_numpy(tables).cuda())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_heads,n_kv,d,page", [
    (4, 4, 64, 16), (8, 2, 64, 16), (32, 8, 128, 64), (16, 2, 128, 64)])
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
@pytest.mark.parametrize("n_heads,n_kv,d", [(4, 4, 64), (8, 2, 64),
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
