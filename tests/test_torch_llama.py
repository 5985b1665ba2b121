"""The port's Llama forward vs the JAX package's on TINY, with the JAX
parameters carried across by ``params_from_numpy``.

fp32: atol 1e-4 on logits and pool pages (two layers of fp32 matmuls in
two summation orders).  bf16: the weights must round-trip bit-exact; KV
pages (values of order one) agree to atol 3e-2, and logits to 3e-2 of
their largest magnitude: bf16 keeps ~3 significant digits (its ulp at a
TINY logit of ~100 is 0.5) and the two frameworks round intermediate
activations at different places."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.config import TINY as J_TINY
from k8s_llm_rca_tpu.engine import paged as jpaged
from k8s_llm_rca_tpu.models import llama as jllama
from k8s_llm_rca_tpu_torch.config import TINY
from k8s_llm_rca_tpu_torch.engine import paged as tpaged
from k8s_llm_rca_tpu_torch.models import llama as tllama

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dtype = request.param
    jcfg = J_TINY.replace(dtype=dtype)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    return dtype, jcfg, jparams, TINY.replace(dtype=dtype), tparams


def _close_logits(t, j, dtype) -> None:
    ref = _f32(j)
    scale = np.abs(ref).max() if dtype == "bfloat16" else 1.0
    np.testing.assert_allclose(_f32(t), ref, rtol=0, atol=TOL[dtype] * scale)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_params_from_numpy_bit_exact(models):
    dtype, _, jparams, _, tparams = models
    j = jax.tree.map(np.asarray, jparams)
    for name in ("wq", "w_down", "attn_norm"):
        src = j["layers"][1][name]
        got = tparams["layers"][1][name]
        assert str(got.dtype) == f"torch.{dtype}"
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          src.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), src)
    np.testing.assert_array_equal(_f32(tparams["embedding"]),
                                  _f32(jparams["embedding"]))


def test_prefill_kv_matches_jax(models):
    dtype, jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(0)
    tokens = np.zeros((1, 64), np.int32)
    tokens[0, :45] = rng.integers(0, 256, 45)
    jk, jv, jlog = jax.jit(jllama.prefill_kv, static_argnums=0)(
        jcfg, jparams, jnp.asarray(tokens), jnp.int32(45))
    tk, tv, tlog = tllama.prefill_kv(tcfg, tparams, torch.from_numpy(tokens),
                                     45)
    tol = TOL[dtype]
    _close_logits(tlog, jlog, dtype)
    np.testing.assert_allclose(_f32(tk)[:, :45], _f32(jk)[:, :45], rtol=0,
                               atol=tol)
    np.testing.assert_allclose(_f32(tv)[:, :45], _f32(jv)[:, :45], rtol=0,
                               atol=tol)


def test_paged_decode_step_matches_jax(models):
    """Prefill two sequences into pages, then one decode step for a batch
    of three slots (one inactive on trash-page tables): logits and the
    written pool pages agree."""
    dtype, jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(1)
    page, n_pages, pps = 16, 12, 4
    lens = np.array([37, 16], np.int32)
    tokens = np.zeros((2, 48), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, 256, n)
    maps = np.array([[3, 7, 1], [9, 2, 5]], np.int32)
    jpool = jpaged.init_paged_cache(jcfg, n_pages, page)
    tpool = tpaged.init_paged_cache(tcfg, n_pages, page, "cpu")
    jpool, _ = jax.jit(jpaged.paged_prefill_batch, static_argnums=0)(
        jcfg, jparams, jpool, jnp.asarray(tokens), jnp.asarray(lens),
        jnp.asarray(maps))
    tpool, _ = tpaged.paged_prefill_batch(tcfg, tparams, tpool,
                                          torch.from_numpy(tokens),
                                          torch.from_numpy(lens),
                                          torch.from_numpy(maps))
    cur = np.array([11, 200, 0], np.int32)
    cur_lens = np.array([37, 16, 0], np.int32)   # slot 1 opens a new page
    tables = np.zeros((3, pps), np.int32)
    tables[0, :3] = maps[0]
    tables[1, :2] = maps[1, :2]
    tables[1, 1] = 4
    jpool, jlog = jax.jit(jpaged.paged_decode_step, static_argnums=0,
                          static_argnames=("use_kernel",))(
        jcfg, jparams, jpool, jnp.asarray(cur), jnp.asarray(cur_lens),
        jnp.asarray(tables), use_kernel=False)
    tpool, tlog = tpaged.paged_decode_step(
        tcfg, tparams, tpool, torch.from_numpy(cur),
        torch.from_numpy(cur_lens), torch.from_numpy(tables))
    tol = TOL[dtype]
    _close_logits(tlog, jlog, dtype)
    live = [1, 2, 3, 4, 5, 7, 9]                  # every page but the trash
    np.testing.assert_allclose(_f32(tpool.k)[:, live], _f32(jpool.k)[:, live],
                               rtol=0, atol=tol)
    np.testing.assert_allclose(_f32(tpool.v)[:, live], _f32(jpool.v)[:, live],
                               rtol=0, atol=tol)
