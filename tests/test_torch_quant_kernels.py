"""The port's quantized-kernel wrappers on CPU tensors (their plain
versions) vs the JAX package's Pallas kernels, run as the JAX tests run
them: in Pallas interpret mode, auto-selected off-TPU, and vs the JAX
shims (``qmm``/``qmm_head`` under ``jax.jit``, the engine's path off the
TPU) and the engine's gather + dequantize path of decode attention.

Tolerances:
- fp32 activations: atol 1e-5 (outputs of order one; both sides fp32 with
  ``q * scale`` exact, differing in summation order and, for the Pallas
  kernels, in applying the scale after the sum).
- bf16 activations: per output row (one token's N or V values) the largest
  error is at most 2^-6 of the row's largest |ref|.  The plain version
  rounds each dequantized weight to bf16, the Pallas kernel scales the
  fp32 sum; each side rounds the output to bf16 once.
- attention: atol 1e-5 (fp32, the Pallas online softmax against a
  one-pass softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.engine import paged as jpaged
from k8s_llm_rca_tpu.models import llama as jllama
from k8s_llm_rca_tpu.models import quant as jquant
from k8s_llm_rca_tpu.ops import attention as jatt
from k8s_llm_rca_tpu.ops.paged_attention import (
    paged_attention_quant as j_paged_quant,
)
from k8s_llm_rca_tpu.ops.quant_matmul import qmm as j_qmm
from k8s_llm_rca_tpu.ops.quant_matmul import qmm_head as j_qmm_head
from k8s_llm_rca_tpu.ops.quant_matmul import quant_matmul as j_quant_matmul
from k8s_llm_rca_tpu.ops.quant_matmul import (
    quant_matmul_head as j_quant_matmul_head,
)
from k8s_llm_rca_tpu_torch.engine.paged import TRASH_PAGE
from k8s_llm_rca_tpu_torch.models import llama as tllama
from k8s_llm_rca_tpu_torch.ops import quant_matmul as tqmm
from k8s_llm_rca_tpu_torch.ops.paged_attention import (
    paged_attention_quant, paged_attention_quant_plain,
)

torch.backends.cuda.matmul.allow_tf32 = False
ATOL = 1e-5
ROW_TOL = 2 ** -6


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(out, ref, dtype) -> None:
    o, r = _f32(out), _f32(ref)
    if dtype == "float32":
        np.testing.assert_allclose(o, r, rtol=0, atol=ATOL)
        return
    diff = np.abs(o - r).max(-1)
    assert (diff / np.abs(r).max(-1)).max() <= ROW_TOL


def _weight(rng, shape, bits, axis):
    """A JAX-quantized weight (bf16 scales, ``quantize_params``' default)
    and its port twin, carried across byte for byte."""
    w = (rng.standard_normal(shape) / np.sqrt(shape[1 if axis == 0 else -2])
         ).astype(np.float32)
    jw = jquant.quantize(jnp.asarray(w), axis=axis, bits=bits,
                         compute_dtype=jnp.bfloat16)
    return jw, tllama.params_from_numpy(
        jax.tree.map(np.asarray, {"w": jw}), "cpu")["w"]


def _x(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,n", [(4, 128, 256), (2 * 64, 256, 96),
                                   (4, 128, 4), (6, 128, 8)])
def test_quant_matmul_plain_matches_jax(dtype, bits, m, k, n):
    """Projection shapes and the MoE router's (N = 4 and 8)."""
    rng = np.random.default_rng(m + bits)
    jw, tw = _weight(rng, (k, n), bits, -1)
    jx, tx = _x(rng, (m // 2, 2, k), dtype)
    before = (tqmm.quant_matmul.launches, tqmm.quant_matmul.launches_int8)
    out = tqmm.quant_matmul(tx, tw)
    assert (tqmm.quant_matmul.launches,
            tqmm.quant_matmul.launches_int8) == before   # CPU: no launch
    assert out.shape == (m // 2, 2, n)
    _close(out, j_quant_matmul(jx, jw), dtype)
    _close(out, jax.jit(j_qmm)(jx, jw), dtype)
    _close(tqmm.qmm(tx, tw), jax.jit(j_qmm)(jx, jw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quant_matmul_head_plain_matches_jax(dtype, bits):
    rng = np.random.default_rng(bits)
    jw, tw = _weight(rng, (512, 128), bits, 0)         # [V, K], per-row
    jx, tx = _x(rng, (4, 1, 128), dtype)
    before = (tqmm.quant_matmul_head.launches,
              tqmm.quant_matmul_head.launches_int8)
    out = tqmm.quant_matmul_head(tx, tw)
    assert (tqmm.quant_matmul_head.launches,
            tqmm.quant_matmul_head.launches_int8) == before
    assert out.shape == (4, 1, 512)
    _close(out, j_quant_matmul_head(jx, jw), dtype)
    _close(tqmm.qmm_head(tx, tw), jax.jit(j_qmm_head)(jx, jw), dtype)


def test_shape_and_layout_checks():
    rng = np.random.default_rng(0)
    _, tw = _weight(rng, (64, 32), 4, -1)
    _, th = _weight(rng, (32, 64), 4, 0)
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="per-column scales"):
        tqmm.quant_matmul(x, th)
    with pytest.raises(ValueError, match="per-row scales"):
        tqmm.quant_matmul_head(x, tw)
    with pytest.raises(ValueError, match="shape mismatch"):
        tqmm.quant_matmul(torch.zeros((2, 63)), tw)
    with pytest.raises(ValueError, match="QuantTensor"):
        tqmm.quant_matmul(x, torch.zeros((64, 32)))
    with pytest.raises(ValueError, match="stacked experts"):
        tqmm.quant_matmul(x, _weight(rng, (4, 64, 32), 8, (0, -1))[1])
    with pytest.raises(ValueError, match="3-D weights"):
        tqmm.qmm_experts(x, tw)
    # plain weights take torch.matmul through the shims
    np.testing.assert_allclose(
        tqmm.qmm(x + 1, torch.ones((64, 3))).numpy(), np.full((2, 3), 64.0))


def _quant_pool_case(n_heads, n_kv, packed, seed):
    """Pools quantized per token by the JAX ``_quantize_kv``; lengths 1, a
    page, a page + 1 and a long one over shuffled page ids, table tails on
    the trash page."""
    rng = np.random.default_rng(seed)
    b, d, page, n_pages, pps = 4, 32, 16, 40, 5
    q = rng.standard_normal((b, n_heads, d)).astype(np.float32)
    kv = rng.standard_normal((2, n_pages, page, n_kv * d)).astype(np.float32)
    pool, scales = jllama._quantize_kv(jnp.asarray(kv), packed)
    kp, vp = np.asarray(pool)
    ks, vs = np.asarray(scales)
    ids = rng.permutation(np.arange(1, n_pages))
    lengths = np.array([1, page, page + 1, 4 * page + 3], np.int32)
    tables = np.full((b, pps), TRASH_PAGE, np.int32)
    used = 0
    for i, n in enumerate(lengths):
        n_p = -(-int(n) // page)
        tables[i, :n_p] = ids[used:used + n_p]
        used += n_p
    return q, kp, vp, ks, vs, lengths, tables


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("n_heads,n_kv", [(4, 2), (8, 2), (4, 1)])
def test_paged_quant_plain_matches_jax(packed, n_heads, n_kv):
    case = _quant_pool_case(n_heads, n_kv, packed, seed=n_heads + n_kv)
    q, kp, vp, ks, vs, lengths, tables = case
    before = paged_attention_quant.launches
    out = paged_attention_quant(*(torch.tensor(a) for a in case),
                                packed=packed)
    assert paged_attention_quant.launches == before
    ref = j_paged_quant(*(jnp.asarray(a) for a in case), packed=packed)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    # the JAX engine's path without the kernel: gather, dequantize, softmax
    d = q.shape[2]
    gather = [jpaged._gather_dequant_pages(
        jnp.asarray(p), jnp.asarray(s), jnp.asarray(tables), n_kv, d,
        jnp.float32, packed) for p, s in ((kp, ks), (vp, vs))]
    xla = jatt.decode_attention(jnp.asarray(q)[:, None], *gather,
                                jnp.asarray(lengths))[:, 0]
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(
        out.numpy(), paged_attention_quant_plain(
            *(torch.tensor(a) for a in case), packed=packed).numpy())
