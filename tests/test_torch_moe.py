"""The port's MoE slice (Mixtral's dense soft-dispatch MLP) vs the JAX
package's, on TINY_MOE (4 experts, top 2, fp32).

- ``quant_matmul_experts`` on CPU tensors (its plain version) vs JAX
  ``quant_matmul_experts`` (the Pallas ``_ekn8_kernel``/``_ekn4_kernel`` in
  interpret mode) and the jitted ``qmm_experts`` shim, both einsum forms,
  int8 and int4: fp32 atol 1e-5 (both sides fp32 with ``q * scale``
  exact, different summation orders); bf16 per output row (one token's and
  expert's N values) the largest error at most 2^-6 of the row's largest
  |ref| (each side rounds an element to bf16 once; the plain version also
  rounds each dequantized weight to bf16).
- ``_moe_mlp`` vs JAX ``llama._moe_mlp``: fp32 atol 1e-5, with plain and
  quantized weights, and with planted router ties whose chosen experts
  must be ``jax.lax.top_k``'s (the lower index first).
- TINY_MOE prefill logits within atol 1e-4 of the JAX function's (fp32,
  two layers of summation-order differences), and stacked int8/int4
  leaves carried across byte for byte.
- The paged engine's greedy streams equal the jitted JAX paged engine's
  (``use_kernel=False``) with int8 weights fused over an int8 pool and int4
  over int4.  Projection weights are scaled x3, as in
  ``test_torch_engine.py``, so greedy decode walks many distinct tokens;
  the unit tests keep the init's scales (outputs of order one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.config import TINY_MOE as J_TINY_MOE
from k8s_llm_rca_tpu.config import EngineConfig as JEngineConfig
from k8s_llm_rca_tpu.engine import make_engine as j_make_engine
from k8s_llm_rca_tpu.models import llama as jllama
from k8s_llm_rca_tpu.models import quant as jquant
from k8s_llm_rca_tpu.ops.quant_matmul import qmm_experts as j_qmm_experts
from k8s_llm_rca_tpu.ops.quant_matmul import (
    quant_matmul_experts as j_quant_matmul_experts,
)
from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer as j_tokenizer
from k8s_llm_rca_tpu_torch import config
from k8s_llm_rca_tpu_torch.config import TINY_MOE, EngineConfig
from k8s_llm_rca_tpu_torch.engine import make_engine
from k8s_llm_rca_tpu_torch.models import llama as tllama
from k8s_llm_rca_tpu_torch.models import mixtral
from k8s_llm_rca_tpu_torch.models import quant as tquant
from k8s_llm_rca_tpu_torch.ops import quant_matmul as tqmm
from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

ATOL = 1e-5
ROW_TOL = 2 ** -6


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(out, ref, dtype, atol=ATOL) -> None:
    o, r = _f32(out), _f32(ref)
    assert o.shape == r.shape
    if dtype == "float32":
        np.testing.assert_allclose(o, r, rtol=0, atol=atol)
        return
    diff = np.abs(o - r).max(-1)
    assert (diff / np.abs(r).max(-1)).max() <= ROW_TOL


def _carry(tree):
    """A JAX tree on the port's CPU side, byte for byte."""
    return tllama.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ------------------------------------------------------------ rows 8 and 9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["3d", "4d"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_experts_plain_matches_jax(dtype, form, bits):
    rng = np.random.default_rng(bits + len(form) + len(dtype))
    e, k, n = 4, 128, 96
    w = (rng.standard_normal((e, k, n)) / np.sqrt(k)).astype(np.float32)
    jw = jquant.quantize(jnp.asarray(w), axis=(0, -1), bits=bits,
                         compute_dtype=jnp.bfloat16)
    tw = _carry({"w": jw})["w"]
    assert type(tw).__name__ == type(jw).__name__
    shape = (2, 3, k) if form == "3d" else (2, 3, e, k)
    x = rng.standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    before = (tqmm.quant_matmul_experts.launches,
              tqmm.quant_matmul_experts.launches_int8)
    out = tqmm.quant_matmul_experts(tx, tw)
    assert (tqmm.quant_matmul_experts.launches,
            tqmm.quant_matmul_experts.launches_int8) == before  # CPU: none
    assert out.shape == (2, 3, e, n)
    _close(out, j_quant_matmul_experts(jx, jw), dtype)
    _close(tqmm.qmm_experts(tx, tw), jax.jit(j_qmm_experts)(jx, jw), dtype)


def test_quant_matmul_experts_checks():
    rng = np.random.default_rng(0)
    w = tquant.quantize(torch.from_numpy(
        rng.standard_normal((4, 64, 32)).astype(np.float32)), axis=(0, -1))
    with pytest.raises(ValueError, match="shape mismatch"):
        tqmm.quant_matmul_experts(torch.zeros((2, 3, 63)), w)
    with pytest.raises(ValueError, match="shape mismatch"):
        tqmm.quant_matmul_experts(torch.zeros((2, 3, 5, 64)), w)
    with pytest.raises(ValueError, match="3-D"):
        tqmm.quant_matmul_experts(torch.zeros((2, 64)), w)
    with pytest.raises(ValueError, match="per-\\(expert, column\\)"):
        tqmm.quant_matmul_experts(torch.zeros((2, 3, 64)),
                                  tquant.QuantTensor(w.q, w.scale[:, :, :1]))
    # plain stacked tensors take torch.einsum through the shim
    plain = torch.ones((4, 64, 32))
    np.testing.assert_allclose(
        tqmm.qmm_experts(torch.ones((1, 2, 64)), plain).numpy(),
        np.full((1, 2, 4, 32), 64.0))


# ------------------------------------------------------------- the MoE MLP


def _jax_moe_params(scale=1.0):
    """TINY_MOE, with the projection weights scaled by ``scale`` (x3 for
    the engine: module docstring)."""
    p = jllama.init_params(J_TINY_MOE, jax.random.PRNGKey(0))
    p["layers"] = [{k: (v * scale if k.startswith("w") else v)
                    for k, v in layer.items()} for layer in p["layers"]]
    return p


@pytest.mark.parametrize("bits,fused", [(None, False), (8, True), (4, True),
                                        (8, False)],
                         ids=["plain", "int8-fused", "int4-fused", "int8"])
def test_moe_mlp_matches_jax(bits, fused):
    jparams = _jax_moe_params()
    if bits is not None:
        jparams = jquant.quantize_params(jparams, bits=bits)
    layer = jparams["layers"][0]
    x = np.random.default_rng(1).standard_normal((2, 5, 128)).astype(
        np.float32)
    jcfg = J_TINY_MOE.replace(fused_quant_matmul=fused)
    ref = jax.jit(jllama._moe_mlp, static_argnums=0)(jcfg, layer,
                                                     jnp.asarray(x))
    out = tllama._moe_mlp(TINY_MOE.replace(fused_quant_matmul=fused),
                          _carry(layer), torch.from_numpy(x))
    _close(out, ref, "float32")
    # the engine's entry to the block is _mlp (jitted JAX: inside jit XLA
    # keeps q * scale in f32 for an f32 consumer, as the port does)
    _close(tllama._mlp(TINY_MOE, _carry(layer), torch.from_numpy(x)),
           jax.jit(jllama._mlp, static_argnums=0)(J_TINY_MOE, layer,
                                                  jnp.asarray(x)), "float32")


def test_moe_routing_breaks_ties_like_jax_top_k():
    """Planted router ties: token i's hidden state is the unit vector e_i,
    so its logits are row i of the router weight exactly (sums of zeros
    and one product).  The chosen experts, the dense weights and the MLP
    output equal JAX's; for the pattern of the ROADMAP note (8 experts)
    too."""
    patterns = np.array([[1, 1, 1, 1], [.5, 1, .25, 1], [1, .5, 1, 1],
                         [0, 1, 1, 1], [.25, .25, 1, .25]], np.float32)
    jparams = _jax_moe_params()
    layer = dict(jparams["layers"][0])
    router = np.zeros((128, 4), np.float32)
    router[:len(patterns)] = patterns
    layer["router"] = jnp.asarray(router)
    x = np.eye(128, dtype=np.float32)[None, :len(patterns)]      # [1, 5, H]
    logits = torch.from_numpy(x) @ torch.from_numpy(router)
    topi, dense = tllama._moe_route(logits, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(topi[0].tolist(),
                                  [[0, 1], [1, 3], [0, 2], [1, 2], [2, 0]])
    onehot = jax.nn.one_hot(ji, 4, dtype=jnp.float32)
    jdense = jnp.einsum("bske,bsk->bse", onehot, jax.nn.softmax(jv, -1))
    # two softmax implementations: one ulp apart
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), rtol=0,
                               atol=1e-7)
    _close(tllama._moe_mlp(TINY_MOE, _carry(layer), torch.from_numpy(x)),
           jax.jit(jllama._moe_mlp, static_argnums=0)(
               J_TINY_MOE, layer, jnp.asarray(x)), "float32")
    eight = torch.tensor([[.5, 1, .25, 1, 1, .1, 0, 1]])
    np.testing.assert_array_equal(
        tllama._moe_route(eight, 2)[0].numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(eight.numpy()), 2)[1]))


# ------------------------------------------------ logits and carry-across


@pytest.mark.parametrize("bits", [None, 8], ids=["plain", "int8-fused"])
def test_tiny_moe_prefill_logits_match_jax(bits):
    jparams = _jax_moe_params()
    if bits is not None:
        jparams = jquant.quantize_params(jparams, bits=bits)
    fused = bits is not None
    rng = np.random.default_rng(0)
    tokens = np.zeros((1, 64), np.int32)
    tokens[0, :45] = rng.integers(0, 256, 45)
    jk, _, jlog = jax.jit(jllama.prefill_kv, static_argnums=0)(
        J_TINY_MOE.replace(fused_quant_matmul=fused), jparams,
        jnp.asarray(tokens), jnp.int32(45))
    tk, _, tlog = tllama.prefill_kv(TINY_MOE.replace(fused_quant_matmul=fused),
                                    _carry(jparams), torch.from_numpy(tokens),
                                    45)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tk.numpy()[:, :45], np.asarray(jk)[:, :45],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_stacked_quantized_leaves_carry_across_byte_for_byte(bits):
    """JAX's stacked [E, K, N] int8 and [E, K, N/2] int4 experts (and the
    [H, E] router) arrive with their bytes and scale bits; int4 is told
    apart by the scale's last axis alone, even without the class name."""
    jq = jquant.quantize_params(_jax_moe_params(), bits=bits)
    layer = _carry(jq)["layers"][1]
    jlayer = jq["layers"][1]
    kind = tquant.QuantTensor4 if bits == 4 else tquant.QuantTensor
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert isinstance(layer[name], kind)
        np.testing.assert_array_equal(_bits(layer[name].q),
                                      _bits(jlayer[name].q))
        np.testing.assert_array_equal(_bits(layer[name].scale),
                                      _bits(jlayer[name].scale))
    assert tuple(layer["w_down"].scale.shape) == (4, 1, 128)
    # a bare (q, scale) NamedTuple of another class name
    bare = tllama._quant_leaf(
        jquant.QuantTensor(*map(np.asarray, jlayer["w_gate"])), "cpu")
    assert isinstance(bare, kind)


def test_init_params_moe_quantizes_each_expert_stack():
    p = tllama.init_params(TINY_MOE, torch.Generator().manual_seed(0), "cpu",
                           tensor_transform=tquant.quantizing_transform(
                               bits=8))
    layer = p["layers"][0]
    assert tuple(layer["router"].scale.shape) == (1, 4)
    assert layer["w_gate"].shape == (4, 128, 256)
    assert tuple(layer["w_gate"].scale.shape) == (4, 1, 256)
    assert layer["w_down"].shape == (4, 256, 128)
    assert tuple(layer["w_down"].scale.shape) == (4, 1, 128)
    x = torch.randn((1, 3, 128), generator=torch.Generator().manual_seed(1))
    assert tllama._mlp(TINY_MOE.replace(fused_quant_matmul=True), layer,
                       x).shape == (1, 3, 128)


def test_mixtral_module_reexports_and_refuses_ep():
    """The presets and entry points re-export; the EP assembly refuses a
    dense config (it builds on a mesh: ``test_torch_isolation.py``)."""
    assert mixtral.MIXTRAL_8X7B is config.MIXTRAL_8X7B
    assert config.MODEL_REGISTRY["mixtral-8x7b"].n_experts == 8
    assert mixtral.init_params is tllama.init_params
    with pytest.raises(ValueError, match="not an MoE config"):
        mixtral.make_ep_engine(config.TINY, config.EngineConfig(), {}, None,
                               device="cpu")


# ----------------------------------------------------------------- engine


@pytest.mark.parametrize("bits,kv", [(8, "int8"), (4, "int4")],
                         ids=["int8", "int4"])
def test_tiny_moe_greedy_streams_match_jax(bits, kv):
    jparams = jquant.quantize_params(_jax_moe_params(3.0), bits=bits)
    # one prefill bucket keeps the JAX side to one prefill compile; decode
    # still crosses page boundaries
    kw = dict(max_batch=4, max_seq_len=256, prefill_buckets=(128,),
              max_new_tokens=32, temperature=0.0, paged=True, page_size=16,
              num_pages=84, prefix_cache=False, decode_chunk=16,
              kv_cache_dtype=kv)
    je = j_make_engine(J_TINY_MOE.replace(fused_quant_matmul=True),
                       JEngineConfig(**kw), jparams,
                       j_tokenizer(vocab_size=J_TINY_MOE.vocab_size),
                       use_kernel=False)
    te = make_engine(TINY_MOE.replace(fused_quant_matmul=True),
                     EngineConfig(**kw), _carry(jparams),
                     get_tokenizer(vocab_size=TINY_MOE.vocab_size),
                     device="cpu")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (5, 60, 100, 120)]
    jres = je.generate(prompts)
    tres = te.generate(prompts)
    for j, t in zip(jres, tres):
        assert t.token_ids == j.token_ids
        assert (t.finish_reason, t.completion_tokens) == (
            j.finish_reason, j.completion_tokens)
    assert len(set(jres[0].token_ids)) > 5
    te.allocator.check()
