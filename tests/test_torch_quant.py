"""The port's quantization vs the JAX package's, and the int4 slice end to
end on TINY.

- ``quantize``, the nibble packing, ``dq``, ``gather_rows``,
  ``quantize_params`` and the KV quantization are bit-exact with the JAX
  functions run eagerly (int8 and int4, axis 0 and -1, bf16 and fp32): the
  same int8 bytes, the same scale bits.  (Inside ``jax.jit`` XLA may turn
  ``amax / qmax`` into a multiply by the reciprocal and move a scale by one
  ulp; the engines tolerate that, and the parity below shows it.)
- A JAX tree quantized with ``bits=4`` arrives through
  ``params_from_numpy`` byte for byte.
- TINY with int4 weights, ``fused_quant_matmul`` and an int4 or int8 KV
  pool: prefill logits within atol 1e-4 of the JAX engine's (fp32, two
  summation orders), and greedy streams equal to the JAX paged engine's
  (``use_kernel=False``), one case under preemption.  Weights are scaled
  x3 before quantization, as in ``test_torch_engine.py``, so greedy decode
  walks many distinct tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.config import TINY as J_TINY
from k8s_llm_rca_tpu.config import EngineConfig as JEngineConfig
from k8s_llm_rca_tpu.engine import make_engine as j_make_engine
from k8s_llm_rca_tpu.models import llama as jllama
from k8s_llm_rca_tpu.models import quant as jquant
from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer as j_tokenizer
from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
from k8s_llm_rca_tpu_torch.engine import make_engine
from k8s_llm_rca_tpu_torch.models import llama as tllama
from k8s_llm_rca_tpu_torch.models import quant as tquant
from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bits(a) -> np.ndarray:
    """The raw bits of a tensor or array (bf16 through an int16 view)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(t, j) -> None:
    np.testing.assert_array_equal(_bits(t), _bits(j))


def _pair(rng, shape, dtype, scale=1.0):
    w = (rng.standard_normal(shape) * scale).astype(np.float32)
    return (torch.from_numpy(w).to(DTYPES[dtype]),
            jnp.asarray(w).astype(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("axis", [0, -1])
def test_quantize_dq_gather_bit_exact(dtype, bits, axis):
    rng = np.random.default_rng(bits + axis)
    wt, wj = _pair(rng, (48, 96), dtype, 0.05)
    for cd in (None, "bfloat16"):
        t = tquant.quantize(wt, axis=axis, bits=bits,
                            compute_dtype=DTYPES.get(cd))
        j = jquant.quantize(wj, axis=axis, bits=bits, compute_dtype=cd)
        assert type(t).__name__ == type(j).__name__
        assert t.shape == j.shape
        _same(t.q, j.q)
        _same(t.scale, j.scale)
        _same(tquant.dq(t), jquant.dq(j))
        if axis == 0:
            idx = rng.integers(0, 48, (3, 5))
            _same(tquant.gather_rows(t, torch.from_numpy(idx)),
                  jquant.gather_rows(j, jnp.asarray(idx)))


def test_nibble_packing_bit_exact():
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, (5, 64)).astype(np.int8)
    packed = tquant._pack_nibbles(torch.from_numpy(q))
    _same(packed, jquant._pack_nibbles(jnp.asarray(q)))
    _same(tquant._unpack_nibbles(packed), q)
    # byte i holds column i low and column i + 32 high
    assert int(packed[0, 3]) & 0xF == int(q[0, 3]) & 0xF
    assert int(packed[0, 3]) >> 4 == int(q[0, 35])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
def test_quantize_kv_bit_exact(dtype, packed):
    rng = np.random.default_rng(7)
    kt, kj = _pair(rng, (2, 6, 16, 64), dtype, 3.0)
    kt[0, 0, 0] = 0.0                    # an all-zero token keeps scale 1
    kj = kj.at[0, 0, 0].set(0.0)
    tq, ts = tquant.quantize_kv(kt, packed)
    jq, js = jllama._quantize_kv(kj, packed)
    _same(tq, jq)
    _same(ts, js)
    assert float(ts[0, 0, 0]) == 1.0
    _same(tquant.dequant_kv(tq, ts, DTYPES[dtype], packed),
          jllama._dequant_layer(jq, js, jnp.dtype(dtype), packed))


def _tiny_params():
    """TINY with the projection weights scaled x3 (module docstring)."""
    p = jllama.init_params(J_TINY, jax.random.PRNGKey(0))
    p["layers"] = [{k: (v * 3.0 if k.startswith("w") else v)
                    for k, v in layer.items()} for layer in p["layers"]]
    return p


def _leaves_equal(t, j) -> None:
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            _leaves_equal(t[k], j[k])
    elif isinstance(j, (jquant.QuantTensor, jquant.QuantTensor4)):
        assert type(t).__name__ == type(j).__name__
        _same(t.q, j.q)
        _same(t.scale, j.scale)
    elif isinstance(j, list):
        for a, b in zip(t, j):
            _leaves_equal(a, b)
    else:
        _same(t, j)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_and_carry_across_bit_exact(bits):
    """The port quantizes a carried-across tree to JAX's bytes, and a tree
    JAX quantized (``quantize_params`` or ``init_params`` with a quantizing
    transform) arrives byte for byte."""
    raw = _tiny_params()
    jq = jquant.quantize_params(raw, bits=bits)
    tq = tquant.quantize_params(
        tllama.params_from_numpy(jax.tree.map(np.asarray, raw), "cpu"),
        bits=bits)
    _leaves_equal(tq, jq)
    _leaves_equal(tllama.params_from_numpy(jax.tree.map(np.asarray, jq),
                                           "cpu"), jq)
    streamed = jllama.init_params(
        J_TINY.replace(tie_embeddings=False), jax.random.PRNGKey(1),
        tensor_transform=jquant.quantizing_transform(bits=bits))
    _leaves_equal(tllama.params_from_numpy(
        jax.tree.map(np.asarray, streamed), "cpu"), streamed)


def test_init_params_tensor_transform_quantizes_each_weight():
    cfg = TINY.replace(tie_embeddings=False)
    p = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                           tensor_transform=tquant.quantizing_transform(
                               bits=4))
    assert isinstance(p["layers"][0]["w_down"], tquant.QuantTensor4)
    assert tuple(p["layers"][0]["w_down"].scale.shape) == (1, cfg.hidden_size)
    for name in ("embedding", "lm_head"):        # per-row scales (axis 0)
        assert tuple(p[name].scale.shape) == (cfg.vocab_size, 1)
    assert p["final_norm"].dtype == torch.float32


def _int4_models():
    jparams = jquant.quantize_params(_tiny_params(), bits=4)
    tparams = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    return jparams, tparams


def test_int4_fused_prefill_logits_match_jax():
    jparams, tparams = _int4_models()
    rng = np.random.default_rng(0)
    tokens = np.zeros((1, 64), np.int32)
    tokens[0, :45] = rng.integers(0, 256, 45)
    jcfg = J_TINY.replace(fused_quant_matmul=True)
    jk, jv, jlog = jax.jit(jllama.prefill_kv, static_argnums=0)(
        jcfg, jparams, jnp.asarray(tokens), jnp.int32(45))
    tk, tv, tlog = tllama.prefill_kv(TINY.replace(fused_quant_matmul=True),
                                     tparams, torch.from_numpy(tokens), 45)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tk.numpy()[:, :45], np.asarray(jk)[:, :45],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("kv,num_pages,prompt_lens", [
    ("int4", 168, (5, 60, 130, 300)),
    ("int8", 168, (5, 60, 130, 300)),
    # 51 usable pages: growth past the buckets preempts the youngest
    ("int4", 52, (120, 120, 250, 250)),
], ids=["int4", "int8", "int4-preemption"])
def test_int4_fused_greedy_streams_match_jax(kv, num_pages, prompt_lens):
    jparams, tparams = _int4_models()
    kw = dict(max_batch=4, max_seq_len=512, prefill_buckets=(128, 256),
              max_new_tokens=40, temperature=0.0, paged=True, page_size=16,
              num_pages=num_pages, prefix_cache=False, decode_chunk=16,
              kv_cache_dtype=kv)
    je = j_make_engine(J_TINY.replace(fused_quant_matmul=True),
                       JEngineConfig(**kw), jparams,
                       j_tokenizer(vocab_size=J_TINY.vocab_size),
                       use_kernel=False)
    te = make_engine(TINY.replace(fused_quant_matmul=True),
                     EngineConfig(**kw), tparams,
                     get_tokenizer(vocab_size=TINY.vocab_size), device="cpu")
    assert te.pool.quantized and te.pool.k.dtype == torch.int8
    assert te.pool.k.shape[-1] == (TINY.kv_dim // 2 if kv == "int4"
                                   else TINY.kv_dim)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in prompt_lens]
    jres = je.generate(prompts)
    tres = te.generate(prompts)
    for j, t in zip(jres, tres):
        assert t.token_ids == j.token_ids
        assert (t.finish_reason, t.completion_tokens) == (
            j.finish_reason, j.completion_tokens)
    assert len(set(jres[0].token_ids)) > 5
    preempted = te._counts.get("engine.preemptions", 0)
    assert preempted == je._counts.get("engine.preemptions", 0)
    assert (preempted > 0) == (num_pages == 52)
    te.allocator.check()
