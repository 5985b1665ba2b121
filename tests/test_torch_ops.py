"""PyTorch port ops and sampling filters vs the JAX package's on the same
numpy inputs (CPU, fp32).  Tolerance atol 1e-5: both sides compute in fp32
and differ only in summation order and the last bits of exp/cos/sin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.engine import sampling as jsamp
from k8s_llm_rca_tpu.ops import attention as jatt
from k8s_llm_rca_tpu.ops import norms as jnorms
from k8s_llm_rca_tpu.ops import rope as jrope
from k8s_llm_rca_tpu_torch.engine import sampling as tsamp
from k8s_llm_rca_tpu_torch.ops import attention as tatt
from k8s_llm_rca_tpu_torch.ops import norms as tnorms
from k8s_llm_rca_tpu_torch.ops import rope as trope

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False
ATOL = 1e-5


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t: torch.Tensor, j) -> None:
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 5, 32), (1, 3, 128)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x, w = _randn(rng, *shape), _randn(rng, shape[-1])
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("head_dim,theta", [(32, 10000.0), (128, 500000.0)])
def test_rope(head_dim, theta):
    rng = np.random.default_rng(1)
    x = _randn(rng, 2, 7, 4, head_dim)
    pos = rng.integers(0, 512, (2, 7)).astype(np.int32)
    t_ang = trope.rope_frequencies(head_dim, 512, theta)
    j_ang = jrope.rope_frequencies(head_dim, 512, theta)
    _close(t_ang, j_ang)
    _close(trope.apply_rope(torch.from_numpy(x), t_ang,
                            torch.from_numpy(pos).long()),
           jrope.apply_rope(jnp.asarray(x), j_ang, jnp.asarray(pos)))


@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_repeat_kv(n_rep):
    x = _randn(np.random.default_rng(2), 2, 5, 2, 8)
    _close(tatt.repeat_kv(torch.from_numpy(x), n_rep),
           jatt.repeat_kv(jnp.asarray(x), n_rep))


@pytest.mark.parametrize("n_heads,n_kv,offset", [(4, 4, False), (8, 2, False),
                                                 (8, 2, True)])
def test_causal_attention(n_heads, n_kv, offset):
    rng = np.random.default_rng(3)
    b, s, s_k, d = 2, 24, 40 if offset else 24, 32
    q = _randn(rng, b, s, n_heads, d)
    k, v = _randn(rng, b, s_k, n_kv, d), _randn(rng, b, s_k, n_kv, d)
    lens = np.array([s_k, s_k - 7], np.int32)
    off = np.array([16, 9], np.int32) if offset else None
    t = tatt.causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens),
        None if off is None else torch.from_numpy(off))
    j = jatt.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens),
                              None if off is None else jnp.asarray(off))
    _close(t, j)


@pytest.mark.parametrize("n_heads,n_kv", [(4, 2), (8, 2)])
def test_decode_attention(n_heads, n_kv):
    rng = np.random.default_rng(4)
    b, s_max, d = 3, 33, 32
    q = _randn(rng, b, 1, n_heads, d)
    k, v = _randn(rng, b, s_max, n_kv, d), _randn(rng, b, s_max, n_kv, d)
    lens = np.array([1, 17, 33], np.int32)
    _close(tatt.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(lens)),
           jatt.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens)))


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.8), (7, 0.6)])
def test_sampling_filters_match_jax(top_k, top_p):
    """The top-k / top-p filters keep the same tokens as the JAX sampler;
    greedy is argmax; random draws stay inside the kept set (the draws
    themselves are each framework's own bits)."""
    logits = _randn(np.random.default_rng(5), 3, 64) * 3.0
    t_l, j_l = torch.from_numpy(logits), jnp.asarray(logits)
    t_kept, j_kept = t_l, j_l
    if top_k:
        t_kept = tsamp._apply_top_k(t_kept, top_k)
        j_kept = jsamp._apply_top_k(j_kept, top_k)
    if top_p < 1.0:
        t_kept = tsamp._apply_top_p(t_kept, top_p)
        j_kept = jsamp._apply_top_p(j_kept, top_p)
    allowed = t_kept.numpy() > tsamp.NEG_INF / 2
    np.testing.assert_array_equal(allowed, np.asarray(j_kept) > -1e29)
    greedy = tsamp.sample_tokens(t_l, None, tsamp.SamplingParams())
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.asarray(jnp.argmax(j_l, axis=-1)))
    params = tsamp.SamplingParams(temperature=1.0, top_k=top_k, top_p=top_p)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        drawn = tsamp.sample_tokens(t_l, gen, params).numpy()
        assert allowed[np.arange(3), drawn].all()
