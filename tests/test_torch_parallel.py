"""Tensor and expert parallelism of the port against the JAX package's.

The port is SPMD: each rank is a process holding its own shard and calling
the collectives itself.  Here two ranks run over gloo through the port's
launcher (``runtime.mesh.run_ranks``), once for the whole module (one
spawn: a fixture), and the JAX side runs in this process on the 8 virtual
CPU devices of ``tests/conftest.py``.  The ranks' body lives in this
module, which imports no JAX at its top: a spawned rank never imports JAX
(``jax`` is imported inside the tests).  Weights come from the JAX arrays
through numpy (``params_from_numpy``); greedy tokens compare exactly.

Counterparts: ``tests/test_sharding_rules.py`` (the partition specs),
``tests/test_parallel.py`` (the paged TP engine :522/:559/:592/:629, its
rejections :664, ``expert_parallel_moe`` :152/:169, the EP paged engine
:472) and ``test_pipeline.py``'s grouped int4 repack.
"""

import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu_torch import config
from k8s_llm_rca_tpu_torch.models import quant
from k8s_llm_rca_tpu_torch.runtime import rules
from k8s_llm_rca_tpu_torch.runtime.sharding import (
    encoder_param_specs, leaf_block, llama_param_specs,
)

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

# the join timeout of the spawned ranks (a hung collective fails the
# fixture, not the window)
RANKS_TIMEOUT_S = 55.0

# the JAX tests' engine configs (tests/test_parallel.py)
TP_CASES = {
    # name: (kv_cache_dtype, int4 weights under fused_quant_matmul,
    #        decode_chunk, prompts)
    "plain": (None, False, 4, ("pod pending unschedulable",
                                "pvc not bound")),
    "int8_pool": ("int8", False, 4, ("node notready kubelet stopped",
                                     "image pull backoff")),
    "int4_pool": ("int4", False, 16, ("node notready kubelet stopped",
                                      "image pull backoff")),
    "int4_weights": ("int4", True, 16, ("pod pending unschedulable",
                                        "pvc not bound")),
}
EP_PROMPTS = ("node notready kubelet stopped", "image pull backoff")


def _tp_engine_config(kv, chunk):
    return config.EngineConfig(
        max_batch=2, max_seq_len=64, paged=True, page_size=8, num_pages=32,
        prefill_buckets=(16, 32, 64), max_new_tokens=6, temperature=0.0,
        kv_cache_dtype=kv, decode_chunk=chunk)


def _ep_engine_config():
    return config.EngineConfig(
        max_batch=4, max_seq_len=64, paged=True, page_size=8, num_pages=48,
        prefill_buckets=(16, 32, 64), max_new_tokens=6, temperature=0.0)


def _tiny_moe():
    return config.TINY_MOE.replace(max_seq_len=64, n_experts=4)


def _prompts(texts):
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    tok = get_tokenizer(vocab_size=512)
    return [tok.encode(t, add_bos=True) for t in texts]


# ---------------------------------------------------------------------------
# the ranks' side (no JAX here)
# ---------------------------------------------------------------------------


def _tokens(engine, prompts):
    return [r.token_ids for r in engine.generate(prompts, max_new_tokens=6)]


def _rank_body(rank, inputs):
    """Everything the module checks on two ranks, in one spawn."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models import loader, mixtral
    from k8s_llm_rca_tpu_torch.ops.flash_attention import (
        flash_attention_sharded,
    )
    from k8s_llm_rca_tpu_torch.ops.paged_attention import (
        paged_attention_quant_sharded, paged_attention_sharded,
    )
    from k8s_llm_rca_tpu_torch.parallel.moe import expert_parallel_moe
    from k8s_llm_rca_tpu_torch.runtime.mesh import (
        collective_counts, local_mesh, reset_collective_counts,
    )
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        shard_leaf, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    out = {}
    tok = get_tokenizer(vocab_size=512)
    tp = local_mesh(model=2, device="cpu")
    tiny = config.TINY.replace(max_seq_len=64)
    for name, (kv, w4, chunk, texts) in TP_CASES.items():
        cfg = tiny.replace(fused_quant_matmul=w4)
        params = inputs["tiny_q4" if w4 else "tiny"]
        ecfg = _tp_engine_config(kv, chunk)
        prompts = _prompts(texts)
        reset_collective_counts()
        engine = make_engine(cfg, ecfg,
                             shard_params(params, llama_param_specs(cfg), tp),
                             tok, "cpu", tp_mesh=tp)
        got = _tokens(engine, prompts)
        engine.allocator.check()
        out[name] = {
            "tp": got, "collectives": collective_counts(),
            "pool_lanes": engine.pool.k.shape[-1],
            "unsharded": _tokens(make_engine(cfg, ecfg, params, tok, "cpu"),
                                 prompts)}

    # TP of the dense soft-dispatch MoE (the experts' inner dim split):
    # against the port's unsharded engine
    moe_cfg = _tiny_moe()
    ecfg = _ep_engine_config()
    prompts = _prompts(EP_PROMPTS)
    out["moe_tp"] = [_tokens(make_engine(moe_cfg, ecfg, p, tok, "cpu", **kw),
                             prompts)
                     for p, kw in ((inputs["moe"], {}),
                                   (shard_params(inputs["moe"],
                                                 llama_param_specs(moe_cfg),
                                                 tp), {"tp_mesh": tp}))]

    # rejections (JAX's :664): indivisible heads, cp_mesh composed with
    # ep_mesh (CP x EP, not ported), a packed pool handed to the sharded
    # quant wrapper
    errors = {}
    for key, build in (
            ("heads", lambda: make_engine(
                tiny.replace(n_heads=4, n_kv_heads=1), _tp_engine_config(
                    None, 4), inputs["tiny"], tok, "cpu", tp_mesh=tp)),
            ("cp", lambda: make_engine(tiny, _tp_engine_config(None, 4),
                                       inputs["tiny"], tok, "cpu",
                                       cp_mesh=tp, ep_mesh=tp)),
            ("packed", lambda: paged_attention_quant_sharded(
                *inputs["paged_quant"], tp, packed=True))):
        try:
            build()
        except (ValueError, NotImplementedError) as err:
            errors[key] = f"{type(err).__name__}: {err}"
    out["errors"] = errors

    # the sharded attention wrappers on this rank's heads
    q, k, v, lens = inputs["flash"]
    hq, hk = q.shape[2] // 2, k.shape[2] // 2
    out["flash"] = flash_attention_sharded(
        q[:, :, rank * hq:(rank + 1) * hq].contiguous(),
        k[:, :, rank * hk:(rank + 1) * hk].contiguous(),
        v[:, :, rank * hk:(rank + 1) * hk].contiguous(), lens, tp,
        global_heads=(q.shape[2], k.shape[2]))
    q, kp, vp, lens, tables = inputs["paged"]
    lanes = kp.shape[-1] // 2
    hq = q.shape[1] // 2
    out["paged"] = paged_attention_sharded(
        q[:, rank * hq:(rank + 1) * hq].contiguous(),
        kp[..., rank * lanes:(rank + 1) * lanes].contiguous(),
        vp[..., rank * lanes:(rank + 1) * lanes].contiguous(), lens, tables,
        tp)

    # EP: the MoE block alone, then the EP paged engine
    ep = mixtral.build_ep_mesh(2, device="cpu")
    moe_cfg = _tiny_moe()
    specs = llama_param_specs(moe_cfg)["layers"][0]
    layer = {k: shard_leaf(v, specs[k], ep)
             for k, v in inputs["moe_layer"].items()}
    x = inputs["moe_x"]
    out["moe"] = {cf: expert_parallel_moe(x, layer, ep, top_k=2,
                                          capacity_factor=cf)
                  for cf in (8.0, 0.01)}
    ecfg = _ep_engine_config()
    prompts = _prompts(EP_PROMPTS)
    reset_collective_counts()
    engine = mixtral.make_ep_engine(moe_cfg, ecfg, inputs["moe"], tok,
                                    device="cpu")
    out["ep_engine"] = {
        "ep": _tokens(engine, prompts), "collectives": collective_counts(),
        "experts": engine.params["layers"][0]["w_gate"].shape[0],
        "dense": _tokens(make_engine(moe_cfg, ecfg, inputs["moe"], tok,
                                     "cpu"), prompts)}
    engine.allocator.check()

    # the per-rank loader against the sharded full tree
    same = []
    for load, specs, path, cfg in (
            (loader.load_llama, llama_param_specs, inputs["ckpt"], tiny),
            (loader.load_encoder, encoder_param_specs, inputs["enc_ckpt"],
             config.TINY_ENCODER)):
        want = shard_params(load(cfg, path, "cpu"), specs(cfg), tp)
        got = load(cfg, path, "cpu", mesh=tp)
        same.append(all(
            a.dtype == b.dtype and torch.equal(a, b)
            for (_, a), (_, b) in zip(rules.flatten_with_names(want),
                                      rules.flatten_with_names(got))))
    out["loader_equal"] = same
    return out


# ---------------------------------------------------------------------------
# the JAX side and the module's one spawn
# ---------------------------------------------------------------------------


def _port_tree(jtree):
    import jax

    from k8s_llm_rca_tpu_torch.models.llama import params_from_numpy

    return params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def _numpy_params(cfg, seed: int, x: float = 1.0):
    """A Llama tree of ``cfg``'s shapes (``rules.llama_param_template``)
    made from a numpy seed at the JAX init's scales, the layers'
    projections times ``x``: norms 1, the embedding N(0, 1), every other
    matrix N(0, 1/H) (``wo``/``w_down`` also over sqrt(2 L))."""
    rng = np.random.default_rng(seed)
    scale = cfg.hidden_size ** -0.5

    def leaf(name, shape):
        if len(shape) == 1:
            return np.ones(shape, np.float32)
        w = rng.standard_normal(shape).astype(np.float32)
        if name in ("embedding", "lm_head"):
            return w * (1.0 if name == "embedding" else scale)
        s = scale * x
        if name.endswith(("wo", "w_down")):
            s /= (2 * cfg.n_layers) ** 0.5
        return (w * s).astype(np.float32)

    return rules.map_with_names(leaf, rules.llama_param_template(cfg))


@pytest.fixture(scope="module")
def jax_params():
    """TINY and TINY_MOE (4 experts) from numpy seeds, carried to JAX
    arrays; TINY's projections x3, so greedy decode walks many distinct
    tokens (at the plain scales it repeats one), TINY also in int4 (the
    port's quantization, byte for byte JAX's); the MoE block alone at the
    plain scales (outputs of order one, as the fp32 atol assumes)."""
    import jax
    import jax.numpy as jnp

    from k8s_llm_rca_tpu.models import quant as jquant

    def to_jax(tree):
        return jax.tree.map(jnp.asarray, tree)

    tiny = _numpy_params(config.TINY, 0, x=3.0)
    q4 = quant.quantize_params(rules.map_with_names(
        lambda _, a: torch.from_numpy(a), tiny), torch.float32, bits=4)
    return {"tiny": to_jax(tiny),
            "tiny_q4": rules.map_with_names(
                lambda _, w: (jquant.QuantTensor4(
                    q=jnp.asarray(w.q.numpy()),
                    scale=jnp.asarray(w.scale.numpy()))
                    if isinstance(w, quant.QuantTensor4)
                    else jnp.asarray(w.numpy())), q4),
            "moe_layer": to_jax(_numpy_params(_tiny_moe(), 1)["layers"][0]),
            "moe": to_jax(_numpy_params(_tiny_moe(), 2, x=3.0))}


@pytest.fixture(scope="module")
def ranks(jax_params, tmp_path_factory):
    from k8s_llm_rca_tpu_torch.models import loader
    from k8s_llm_rca_tpu_torch.models.encoder import init_params as enc_init
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks

    work = tmp_path_factory.mktemp("ranks")
    inputs = {k: _port_tree(v) for k, v in jax_params.items()}
    inputs["ckpt"] = str(work / "llama.safetensors")
    loader.write_safetensors(inputs["ckpt"], loader.llama_params_to_hf(
        config.TINY, inputs["tiny"]))
    enc = enc_init(config.TINY_ENCODER, torch.Generator().manual_seed(3),
                   "cpu")
    inputs["enc_ckpt"] = str(work / "encoder.safetensors")
    loader.write_safetensors(inputs["enc_ckpt"],
                             _encoder_state_dict(enc))
    rng = np.random.default_rng(5)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    inputs["flash"] = (rnd(2, 64, 4, 32), rnd(2, 64, 2, 32), rnd(2, 64, 2, 32),
                       torch.tensor([64, 40], dtype=torch.int32))
    tables = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([27, 9], dtype=torch.int32)
    inputs["paged"] = (rnd(2, 4, 32), rnd(6, 8, 64), rnd(6, 8, 64), lens,
                       tables)
    kq, ks = quant.quantize_kv(rnd(6, 8, 64), packed=True)
    vq, vs = quant.quantize_kv(rnd(6, 8, 64), packed=True)
    inputs["paged_quant"] = (rnd(2, 4, 32), kq, vq, ks, vs, lens, tables)
    inputs["moe_x"] = rnd(2, 16, 128)
    out = run_ranks(_rank_body, 2, str(work), args=(inputs,),
                    timeout_s=RANKS_TIMEOUT_S)
    return inputs, out


def _encoder_state_dict(params):
    """The port's encoder tree as an HF BERT state dict ([out, in])."""
    sd = {"embeddings.word_embeddings.weight": params["word_embedding"],
          "embeddings.position_embeddings.weight":
              params["position_embedding"],
          "embeddings.token_type_embeddings.weight": params["type_embedding"],
          "embeddings.LayerNorm.weight": params["embed_ln_w"],
          "embeddings.LayerNorm.bias": params["embed_ln_b"]}
    names = {"wq": "attention.self.query", "wk": "attention.self.key",
             "wv": "attention.self.value", "wo": "attention.output.dense",
             "w_in": "intermediate.dense", "w_out": "output.dense"}
    norms = {"attn_ln": "attention.output.LayerNorm",
             "mlp_ln": "output.LayerNorm"}
    for i, layer in enumerate(params["layers"]):
        p = f"encoder.layer.{i}."
        for key, hf in names.items():
            sd[p + hf + ".weight"] = layer[key].t().contiguous()
            sd[p + hf + ".bias"] = layer["b" + key[1:]]
        for key, hf in norms.items():
            sd[p + hf + ".weight"] = layer[key + "_w"]
            sd[p + hf + ".bias"] = layer[key + "_b"]
    return sd


# ---------------------------------------------------------------------------
# partition rules and the grouped int4 layout (no spawn)
# ---------------------------------------------------------------------------


def _jax_flat(tree):
    import jax
    from jax.sharding import PartitionSpec

    from k8s_llm_rca_tpu.runtime.rules import _path_name

    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {_path_name(p): tuple(s) for p, s in flat}


def _port_flat(tree):
    return {name: tuple(s) for name, s in rules.flatten_with_names(tree)}


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("model", ["tiny", "tiny_moe", "llama3-8b"])
def test_llama_param_specs_equal_jax(model, layout):
    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.runtime import rules as jrules
    from k8s_llm_rca_tpu.runtime import sharding as jsharding

    lo, jlo = {"tp": (rules.TP_LAYOUT, jrules.TP_LAYOUT),
               "fsdp": (rules.FSDP_LAYOUT, jrules.FSDP_LAYOUT)}[layout]
    cfg = config.MODEL_REGISTRY[model]
    jcfg = jconfig.MODEL_REGISTRY[model]
    want = _jax_flat(jsharding.llama_param_specs(jcfg, jlo))
    got = _port_flat(llama_param_specs(cfg, lo))
    assert got == want
    # two-way coverage: every param matched (above), every rule used
    assert rules.unused_rules(rules.llama_rules(cfg, lo),
                              rules.llama_param_template(cfg)) == []


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
def test_encoder_param_specs_and_pool_specs_equal_jax(layout):
    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.runtime import rules as jrules
    from k8s_llm_rca_tpu.runtime import sharding as jsharding

    lo, jlo = {"tp": (rules.TP_LAYOUT, jrules.TP_LAYOUT),
               "fsdp": (rules.FSDP_LAYOUT, jrules.FSDP_LAYOUT)}[layout]
    for cfg, jcfg in ((config.TINY_ENCODER, jconfig.TINY_ENCODER),
                      (config.E5_LARGE, jconfig.E5_LARGE)):
        assert (_port_flat(encoder_param_specs(cfg, lo))
                == _jax_flat(jsharding.encoder_param_specs(jcfg, jlo)))
    assert ([tuple(s) for s in rules.paged_pool_specs(lo)]
            == [tuple(s) for s in jrules.paged_pool_specs(jlo)])
    assert tuple(rules.kv_cache_specs(lo)) == tuple(jrules.kv_cache_specs(jlo))
    assert rules.SpecLayout.from_dict(lo.to_dict()) == lo
    with pytest.raises(ValueError, match="unknown logical axes"):
        rules.SpecLayout.from_dict({"tensor": "model"})
    with pytest.raises(ValueError, match="no partition rule matches param "
                                         "'layers/0/extra'"):
        rules.match_partition_rules(
            rules.llama_rules(config.TINY, lo),
            {"layers": [{"extra": (4, 4)}]}, table="llama")


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_int4_bytes_equal_jax_and_unwrap_to_rank_columns(groups):
    import jax.numpy as jnp

    from k8s_llm_rca_tpu.models import quant as jquant

    w = np.random.default_rng(groups).standard_normal(
        (24, 64)).astype(np.float32)
    tw = quant.quantize(torch.from_numpy(w), bits=4)
    # the port's int4 bytes are JAX's (tests/test_torch_quant.py)
    jw = jquant.QuantTensor4(q=jnp.asarray(tw.q.numpy()),
                             scale=jnp.asarray(tw.scale.numpy()))
    jg = jquant.repack_nibbles_grouped(jw, groups)
    tg = quant.repack_nibbles_grouped(tw, groups)
    assert isinstance(tg, quant.QuantTensor4Grouped)
    np.testing.assert_array_equal(tg.q.numpy(), np.asarray(jg.q))
    for refuse in (lambda: quant.dq(tg),
                   lambda: quant.gather_rows(tg, torch.tensor([0]))):
        with pytest.raises(ValueError, match="grouped-repacked"):
            refuse()
    full = np.asarray(jquant.dq(jw))
    width = 64 // groups
    for rank in range(groups):
        block = leaf_block(tw, ((1, 0), (groups, rank)))
        assert isinstance(block, quant.QuantTensor4)
        np.testing.assert_array_equal(
            quant.dq(block).numpy(), full[:, rank * width:(rank + 1) * width])


# ---------------------------------------------------------------------------
# two ranks against JAX
# ---------------------------------------------------------------------------


def _jax_tp_tokens(jax_params, cpu_devices, name):
    from k8s_llm_rca_tpu.config import TINY as J_TINY
    from k8s_llm_rca_tpu.config import EngineConfig as JEngineConfig
    from k8s_llm_rca_tpu.config import MeshConfig as JMeshConfig
    from k8s_llm_rca_tpu.engine import make_engine as jmake_engine
    from k8s_llm_rca_tpu.runtime.mesh import build_mesh
    from k8s_llm_rca_tpu.runtime.sharding import (
        llama_param_specs as jspecs, shard_pytree,
    )
    from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer

    kv, w4, chunk, texts = TP_CASES[name]
    cfg = J_TINY.replace(max_seq_len=64, fused_quant_matmul=w4)
    params = jax_params["tiny_q4" if w4 else "tiny"]
    ecfg = JEngineConfig(**{
        k: getattr(_tp_engine_config(kv, chunk), k)
        for k in ("max_batch", "max_seq_len", "paged", "page_size",
                  "num_pages", "prefill_buckets", "max_new_tokens",
                  "temperature", "kv_cache_dtype", "decode_chunk")})
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    if w4:
        # JAX's tp_mesh engine over int4 weights compiles for ~15 s on a
        # CPU: the int4 case holds the unsharded JAX engine
        engine = jmake_engine(cfg, ecfg, params, tok, use_kernel=False)
    else:
        mesh = build_mesh(JMeshConfig(data=1, model=2),
                          devices=cpu_devices[:2])
        engine = jmake_engine(cfg, ecfg,
                              shard_pytree(params, jspecs(cfg), mesh), tok,
                              tp_mesh=mesh)
    res = engine.generate(_prompts(texts), max_new_tokens=6)
    engine.allocator.check()
    return [r.token_ids for r in res]


@pytest.mark.parametrize("name", list(TP_CASES))
def test_paged_tp_engine_equals_jax_tp_engine(ranks, jax_params, cpu_devices,
                                              name):
    """The paged TP engine at t = 2 (TINY fp32 over a plain, an int8 and an
    int4 pool; int4 weights under fused_quant_matmul over an int4 pool):
    both ranks' streams equal each other, the port's unsharded engine's
    and JAX's ``tp_mesh`` engine's (the int4-weight case: JAX's unsharded
    engine); each rank's pool holds half the lanes; the collectives are
    the layer count's."""
    _, out = ranks
    want = _jax_tp_tokens(jax_params, cpu_devices, name)
    assert all(len(set(seq)) > 2 for seq in want), want   # not one token
    kv = TP_CASES[name][0]
    for rank in out:
        got = rank[name]
        assert got["tp"] == want
        assert got["unsharded"] == want
        lanes = config.TINY.kv_dim // 2
        assert got["pool_lanes"] == (lanes // 2 if kv == "int4" else lanes)
        c = got["collectives"]
        # per forward: 2 sum all-reduces a layer + the logits, 1 all-gather
        assert c["all_reduce_sum"] == (2 * config.TINY.n_layers + 1) \
            * c["all_gather"]
        assert (c["all_reduce_max"] > 0) == (kv is not None)


def test_tp_rejections_like_jax(ranks):
    """Indivisible kv heads, a CP mesh composed with EP (CP x EP, not
    ported; a CP mesh alone or with TP is served since the CP slice) and a
    packed int4 pool handed to the sharded quantized kernel are refused
    (``tests/test_parallel.py:664``)."""
    _, out = ranks
    errors = out[0]["errors"]
    assert errors["heads"].startswith("ValueError") \
        and "divisible" in errors["heads"]
    assert errors["cp"].startswith("NotImplementedError") \
        and "cp_mesh" in errors["cp"] and "Queue 1 item 10" in errors["cp"]
    assert errors["packed"].startswith("ValueError") \
        and "packed int4" in errors["packed"]


def test_sharded_attention_wrappers_equal_jax(ranks):
    """Each rank's flash and paged attention over its head shard equals the
    JAX reference's heads of that rank (fp32, atol 1e-5)."""
    import jax
    import jax.numpy as jnp

    from k8s_llm_rca_tpu.ops.attention import causal_attention
    from k8s_llm_rca_tpu.ops.paged_attention import paged_attention_xla

    inputs, out = ranks
    flash = np.asarray(jax.jit(causal_attention)(
        *(jnp.asarray(t.numpy()) for t in inputs["flash"])))
    paged = np.asarray(jax.jit(paged_attention_xla)(
        *(jnp.asarray(t.numpy()) for t in inputs["paged"])))
    for rank, got in enumerate(out):
        np.testing.assert_allclose(got["flash"].numpy(),
                                   flash[:, :, 2 * rank:2 * rank + 2],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["paged"].numpy(),
                                   paged[:, 2 * rank:2 * rank + 2],
                                   rtol=0, atol=1e-5)


def _jax_ep_mesh(cpu_devices):
    from k8s_llm_rca_tpu.config import MeshConfig as JMeshConfig
    from k8s_llm_rca_tpu.runtime.mesh import build_mesh

    return build_mesh(JMeshConfig(data=1, expert=2), devices=cpu_devices[:2])


def test_expert_parallel_moe_equals_jax_and_dense(ranks, jax_params,
                                                  cpu_devices):
    """``expert_parallel_moe`` over 2 ranks equals JAX's dense MLP at ample
    capacity and, under pressure (capacity ~0), JAX's
    ``expert_parallel_moe`` on a (data 1, expert 2) mesh: it drops exactly
    the tokens JAX drops (``tests/test_parallel.py:152``, ``:169``)."""
    import jax.numpy as jnp

    from k8s_llm_rca_tpu.models import llama as jllama
    from k8s_llm_rca_tpu.parallel import expert_parallel_moe as jep

    inputs, out = ranks
    mesh = _jax_ep_mesh(cpu_devices)
    layer = jax_params["moe_layer"]
    x = jnp.asarray(inputs["moe_x"].numpy())
    dense = np.asarray(jllama._moe_mlp(_jax_moe_cfg(), layer, x))
    tight = np.asarray(jep(x, layer, mesh, top_k=2, capacity_factor=0.01))
    for rank in out:
        np.testing.assert_allclose(rank["moe"][8.0].numpy(), dense, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(rank["moe"][0.01].numpy(), tight, rtol=0,
                                   atol=1e-5)
    assert np.abs(tight).sum() < np.abs(dense).sum()


def _jax_moe_cfg():
    from k8s_llm_rca_tpu.config import TINY_MOE as J_TINY_MOE

    return J_TINY_MOE.replace(max_seq_len=64, n_experts=4)


def test_ep_paged_engine_equals_dense_and_jax(ranks, jax_params,
                                              cpu_devices):
    """``mixtral.make_ep_engine`` on 2 ranks (2 experts each) gives the
    dense paged engine's streams and JAX's EP paged engine's
    (``tests/test_parallel.py:472``), through the all-to-alls."""
    from k8s_llm_rca_tpu.config import EngineConfig as JEngineConfig
    from k8s_llm_rca_tpu.models import mixtral as jmixtral
    from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer

    _, out = ranks
    ecfg = _ep_engine_config()
    jecfg = JEngineConfig(**{
        k: getattr(ecfg, k) for k in (
            "max_batch", "max_seq_len", "paged", "page_size", "num_pages",
            "prefill_buckets", "max_new_tokens", "temperature")})
    cfg = _jax_moe_cfg()
    engine = jmixtral.make_ep_engine(
        cfg, jecfg, jax_params["moe"], get_tokenizer(vocab_size=512),
        n_expert_shards=2, n_data=1, devices=cpu_devices[:2],
        use_kernel=False)
    want = [r.token_ids for r in engine.generate(_prompts(EP_PROMPTS),
                                                 max_new_tokens=6)]
    assert all(len(set(seq)) > 2 for seq in want), want
    for rank in out:
        got = rank["ep_engine"]
        assert got["ep"] == want
        assert got["dense"] == want
        assert got["experts"] == 2
        c = got["collectives"]
        assert c["all_to_all"] == 2 * c["all_gather"] > 0


def test_moe_tp_engine_equals_unsharded(ranks):
    """TP of the dense soft-dispatch MoE (each rank the experts' inner
    columns of w_gate/w_up and rows of w_down, the combine summed over the
    ranks) gives the unsharded engine's streams on both ranks."""
    _, out = ranks
    for rank in out:
        dense, tp = rank["moe_tp"]
        assert tp == dense and all(len(set(s)) > 2 for s in dense)


def test_loader_shards_equal_the_sharded_tree(ranks):
    """Each rank's ``load_llama(mesh=)`` and ``load_encoder(mesh=)`` read
    only their blocks and equal ``shard_params`` of the full load, byte for
    byte."""
    _, out = ranks
    assert [rank["loader_equal"] for rank in out] == [[True, True]] * 2


def test_several_ranks_need_a_rendezvous():
    from k8s_llm_rca_tpu_torch.runtime.mesh import initialize_distributed

    with pytest.raises(ValueError, match="need an init_method"):
        initialize_distributed(world_size=2, device="cpu")
