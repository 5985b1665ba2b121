"""The port's kernel wrappers on CPU tensors (their plain versions) vs the
JAX package's Pallas kernels, run as the JAX tests run them: in Pallas
interpret mode, auto-selected off-TPU, plus the XLA reference of the paged
kernel.  fp32 throughout; tolerance atol 1e-5 (fp32 on both sides, the
online softmax of the Pallas kernels against one-pass softmax here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.ops.flash_attention import flash_attention as j_flash
from k8s_llm_rca_tpu.ops.paged_attention import (
    paged_attention as j_paged, paged_attention_xla as j_paged_xla,
)
from k8s_llm_rca_tpu_torch.engine.paged import TRASH_PAGE
from k8s_llm_rca_tpu_torch.ops.flash_attention import flash_attention
from k8s_llm_rca_tpu_torch.ops.paged_attention import paged_attention

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False
ATOL = 1e-5


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _paged_case(n_heads, n_kv, seed):
    """Ragged lengths 1, page, page + 1 and a long one over scattered,
    non-contiguous page ids; table tails are TRASH_PAGE."""
    rng = np.random.default_rng(seed)
    b, d, page, n_pages, pps = 4, 32, 16, 40, 5
    q = _randn(rng, b, n_heads, d)
    kp = _randn(rng, n_pages, page, n_kv * d)
    vp = _randn(rng, n_pages, page, n_kv * d)
    ids = rng.permutation(np.arange(1, n_pages))
    lengths = np.array([1, page, page + 1, 4 * page + 3], np.int32)
    tables = np.full((b, pps), TRASH_PAGE, np.int32)
    used = 0
    for i, n in enumerate(lengths):
        n_p = -(-int(n) // page)
        tables[i, :n_p] = ids[used:used + n_p]
        used += n_p
    return q, kp, vp, lengths, tables


@pytest.mark.parametrize("n_heads,n_kv", [(4, 2), (8, 2)])
@pytest.mark.parametrize("reference", ["pallas", "xla"])
def test_paged_plain_matches_jax(n_heads, n_kv, reference):
    q, kp, vp, lengths, tables = _paged_case(n_heads, n_kv, seed=n_heads)
    before = paged_attention.launches
    out = paged_attention(*(torch.from_numpy(a)
                            for a in (q, kp, vp, lengths, tables)))
    ref_fn = j_paged if reference == "pallas" else j_paged_xla
    ref = ref_fn(*(jnp.asarray(a) for a in (q, kp, vp, lengths, tables)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    assert paged_attention.launches == before   # CPU: plain path, no launch


def _flash_case(n_heads, n_kv, seed, s_q=48, s_k=48):
    rng = np.random.default_rng(seed)
    b, d = 2, 32
    return (_randn(rng, b, s_q, n_heads, d), _randn(rng, b, s_k, n_kv, d),
            _randn(rng, b, s_k, n_kv, d))


@pytest.mark.parametrize("n_heads,n_kv", [(4, 4), (8, 2)])
def test_flash_plain_matches_jax(n_heads, n_kv):
    q, k, v = _flash_case(n_heads, n_kv, seed=1)
    lens = np.array([48, 29], np.int32)     # B=2, seq_len < S_pad on row 1
    before = flash_attention.launches
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(lens))
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(lens), block_q=32, block_k=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    assert flash_attention.launches == before


def test_flash_plain_matches_jax_with_q_offset():
    # a 24-query chunk at positions 40.. of a 64-wide kv prefix
    q, k, v = _flash_case(8, 2, seed=2, s_q=24, s_k=64)
    lens = np.array([64, 51], np.int32)
    off = np.array([40, 27], np.int32)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v, lens, off)))
    ref = j_flash(*(jnp.asarray(a) for a in (q, k, v, lens, off)),
                  block_q=32, block_k=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
