"""FSDP and Megatron sequence parallelism of the port against the JAX
package's.

The port is SPMD: under ``fsdp_mesh`` a rank stores its block of every
matmul weight (``runtime.sharding.shard_params`` under
``rules.FSDP_LAYOUT``) and ``models/llama.py`` gathers each weight whole
just before the matmul that reads it; under ``sp=True`` the TP miss
prefills keep the residual stream split along the sequence.  The ranks run
over gloo through ``runtime.mesh.run_ranks``: one spawn of four for the
whole module, started in the background when the module starts (a
fixture), on the meshes fsdp 4, fsdp 2 x model 2, data 2 x fsdp 2 and data
2 x model 2.  The JAX side runs in this process meanwhile, its engines on
threads.  The ranks' bodies live in this module, which imports no JAX at
its top.  Weights come from numpy seeds (the same arrays on both sides;
int4 and int8 the port's quantization, byte for byte JAX's).  Greedy
streams compare exactly; gathered leaves byte for byte.

Counterparts: ``tests/test_sharding_rules.py`` (``TestFsdpGreedyParity``
:376, marked slow there; the fsdp x CP refusal :430) and
``tests/test_parallel.py`` (``test_sp_engine_matches_unsharded`` :1239,
``test_sp_requires_tp`` :1274).
"""

import copy
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu_torch import config
from k8s_llm_rca_tpu_torch.models import quant
from k8s_llm_rca_tpu_torch.runtime import rules

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op.
torch.set_num_threads(1)

# the join timeout of the spawned ranks (a hung collective fails the
# fixture, not the window)
RANKS_TIMEOUT_S = 55.0

# the meshes of the spawn, by name
MESHES = {"f4": dict(fsdp=4), "f2t2": dict(fsdp=2, model=2),
          "d2f2": dict(data=2, fsdp=2), "d2t2": dict(data=2, model=2)}
# the shard round trips: tree -> its config
ROUND_TRIPS = ("bf16", "int8", "int4", "moe_int8")
# the fsdp engines: (tree, fsdp mesh, kv_cache_dtype, the TP-only mesh
# whose engine it is held to, None: the unsharded engine)
ENGINES = {"fsdp4": ("fp32", "f4", None, None),
           "fsdp4_int4": ("int4", "f4", "int4", None),
           "fsdp2_tp2": ("fp32", "f2t2", None, "d2t2"),
           "fsdp2_tp2_int4": ("int4", "f2t2", "int4", "d2t2"),
           "moe_fsdp2": ("moe_int8", "d2f2", "int8", None)}
# every engine serves three batches: two prompts (JAX's fsdp parity
# prompt first), the first again (a prefix hit through the chunk
# prefill), then the two prompts of tests/test_parallel.py:1250's SP test
BATCHES = (("node notready on node-3", "pvc not bound"),
           ("node notready on node-3",),
           ("pod crashloop kube-system", "node disk pressure taint"))


def _tiny(tree):
    cfg = (config.TINY_MOE if tree.startswith("moe") else config.TINY)
    return cfg.replace(max_seq_len=64,
                       fused_quant_matmul=tree.startswith(("int", "moe")),
                       dtype="bfloat16" if tree == "bf16" else "float32")


def _engine_config(kv=None):
    """JAX's ``TestFsdpGreedyParity`` paged engine (one 32-token bucket)
    with the prefix cache on, stepwise (one compile fewer on JAX's
    side)."""
    return config.EngineConfig(
        max_batch=2, max_seq_len=64, prefill_buckets=(32,),
        max_new_tokens=6, temperature=0.0, paged=True, page_size=8,
        num_pages=24, prefix_cache=True, kv_cache_dtype=kv, decode_chunk=1)


def _encode(texts):
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    tok = get_tokenizer(vocab_size=512)
    return [tok.encode(t, add_bos=True) for t in texts]


def _batches():
    return [_encode(b) for b in BATCHES]


# ---------------------------------------------------------------------------
# the ranks' side (no JAX here)
# ---------------------------------------------------------------------------


def _serve(engine):
    """The greedy streams of ``BATCHES``, served one batch after another."""
    out = []
    for prompts in _batches():
        out += [r.token_ids for r in engine.generate(prompts,
                                                     max_new_tokens=6)]
    engine.allocator.check()
    return out


def _leaves_equal(a, b) -> bool:
    if isinstance(a, (quant.QuantTensor, quant.QuantTensor4)):
        return (type(a) is type(b) and torch.equal(a.q, b.q)
                and torch.equal(a.scale, b.scale))
    return a.dtype == b.dtype and torch.equal(a, b)


def _round_trip(tree, cfg, mesh):
    """Every leaf's fsdp block gathered by the model's gather
    (``llama._whole``) against the TP-only rank's leaf on the same mesh:
    (all equal, leaves gathered, stored bytes over the TP-only bytes)."""
    from k8s_llm_rca_tpu_torch.models import llama
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_AXIS, FSDP_LAYOUT, llama_param_specs, rank_config, shard_params,
    )

    rcfg = rank_config(cfg, fsdp_mesh=mesh)
    stored = rules.flatten_with_names(
        shard_params(tree, llama_param_specs(cfg, FSDP_LAYOUT), mesh))
    tp_only = dict(rules.flatten_with_names(
        shard_params(tree, llama_param_specs(cfg), mesh)))
    specs = dict(rules.flatten_with_names(
        llama_param_specs(cfg, FSDP_LAYOUT)))
    equal, gathered, nbytes = True, 0, [0, 0]

    def size(w):
        return sum(t.numel() * t.element_size() for t in
                   ((w.q, w.scale) if hasattr(w, "q") else (w,)))

    for name, leaf in stored:
        dims = [d for d, e in enumerate(specs[name]) if e == FSDP_AXIS]
        whole = leaf
        if dims:
            whole = llama._whole(rcfg, leaf, dims[0])
            gathered += 1
        equal &= _leaves_equal(whole, tp_only[name])
        nbytes[0] += size(leaf)
        nbytes[1] += size(tp_only[name])
    return equal, gathered, nbytes[0] / nbytes[1]


def _engine_case(name, inputs, meshes, rank):
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.runtime.mesh import (
        collective_counts, reset_collective_counts,
    )
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    tree, fsdp, kv, ref = ENGINES[name]
    cfg = _tiny(tree)
    mesh = meshes[fsdp]
    tp = mesh if MESHES[fsdp].get("model", 1) > 1 else None
    tok = get_tokenizer(vocab_size=512)
    ecfg = _engine_config(kv)
    reset_collective_counts()
    engine = make_engine(cfg, ecfg, shard_params(
        inputs[tree], llama_param_specs(cfg, FSDP_LAYOUT), mesh), tok, "cpu",
        fsdp_mesh=mesh, tp_mesh=tp)
    out = {"streams": _serve(engine),
           "collectives": collective_counts(), "counts": dict(engine._counts),
           "wq": tuple(engine.params["layers"][0]["wq"].shape),
           "pool": tuple(engine.pool.k.shape)}
    if ref is not None:
        engine = make_engine(cfg, ecfg, shard_params(
            inputs[tree], llama_param_specs(cfg), meshes[ref]), tok, "cpu",
            tp_mesh=meshes[ref])
        out["tp_only"] = _serve(engine)
    elif rank == 0:
        out["unsharded"] = _serve(make_engine(cfg, ecfg, inputs[tree], tok,
                                              "cpu"))
    return out


def _sp_case(inputs, mesh):
    """TP 2 with and without ``sp``: streams and collectives."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.runtime.mesh import (
        collective_counts, reset_collective_counts,
    )
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = _tiny("fp32")
    params = shard_params(inputs["fp32"], llama_param_specs(cfg), mesh)
    out = {}
    for sp in (True, False):
        reset_collective_counts()
        engine = make_engine(cfg, _engine_config(), params,
                             get_tokenizer(vocab_size=512), "cpu",
                             tp_mesh=mesh, sp=sp)
        out[sp] = {"streams": _serve(engine),
                   "collectives": collective_counts(),
                   "counts": dict(engine._counts)}
    return out


def _ranks(rank, inputs):
    """Everything the module checks on its four ranks, in one spawn."""
    from k8s_llm_rca_tpu_torch.runtime.mesh import local_mesh

    meshes = {k: local_mesh(device="cpu", **axes)
              for k, axes in MESHES.items()}
    out = {"round_trip": {
        (tree, m): _round_trip(inputs[tree], _tiny(tree), meshes[m])
        for tree in ROUND_TRIPS for m in ("d2f2", "f2t2")}}
    for name in ENGINES:
        out[name] = _engine_case(name, inputs, meshes, rank)
    out["sp"] = _sp_case(inputs, meshes["d2t2"])
    return out


# ---------------------------------------------------------------------------
# inputs, the spawn and the JAX side
# ---------------------------------------------------------------------------


def _numpy_params(cfg, seed: int, x: float = 3.0):
    """A Llama tree of ``cfg``'s shapes from a numpy seed at the JAX init's
    scales, the layers' projections times ``x`` (at the plain scales
    greedy decode repeats one token)."""
    rng = np.random.default_rng(seed)
    scale = cfg.hidden_size ** -0.5

    def leaf(name, shape):
        if len(shape) == 1:
            return np.ones(shape, np.float32)
        w = rng.standard_normal(shape).astype(np.float32)
        if name in ("embedding", "lm_head"):
            return w
        s = scale * x
        if name.endswith(("wo", "w_down")):
            s /= (2 * cfg.n_layers) ** 0.5
        return (w * s).astype(np.float32)

    return rules.map_with_names(leaf, rules.llama_param_template(cfg))


def _torch_tree(tree, dtype=torch.float32):
    return rules.map_with_names(
        lambda _, a: torch.from_numpy(a).to(dtype), tree)


@pytest.fixture(scope="module")
def inputs():
    """The port's trees (torch): TINY in fp32, bf16, int8 and int4 (the
    port's quantization), TINY_MOE in int8."""
    tiny = _torch_tree(_numpy_params(config.TINY, 0))
    moe = _torch_tree(_numpy_params(config.TINY_MOE, 2))
    return {"fp32": tiny,
            "bf16": _torch_tree(_numpy_params(config.TINY, 0),
                                torch.bfloat16),
            "int8": quant.quantize_params(tiny, torch.float32, bits=8),
            "int4": quant.quantize_params(tiny, torch.float32, bits=4),
            "moe_int8": quant.quantize_params(moe, torch.float32, bits=8)}


@pytest.fixture(scope="module", autouse=True)
def spawned(inputs, tmp_path_factory):
    """The module's one spawn of four ranks, started in the background when
    the module starts: the JAX side runs meanwhile, and a test that needs
    the ranks waits for them."""
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks

    # the ranks get a copy: handing a tensor to a spawned process moves its
    # storage into shared memory and frees the old buffer, which a JAX
    # array made from it meanwhile (on the CPU JAX aliases the numpy
    # memory) would go on reading
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, _ranks, 4,
                          str(tmp_path_factory.mktemp("fsdp")),
                          args=(copy.deepcopy(inputs),),
                          timeout_s=RANKS_TIMEOUT_S)


@pytest.fixture(scope="module")
def ranks(spawned, jax_side):
    """The ranks' results; JAX's side first, while they run."""
    return spawned.result()


def _jax_tree(tree):
    """A port tree as JAX arrays, quantized leaves as JAX's (the same
    bytes)."""
    import jax.numpy as jnp

    from k8s_llm_rca_tpu.models import quant as jquant

    def leaf(_, w):
        if isinstance(w, quant.QuantTensor4):
            return jquant.QuantTensor4(q=jnp.asarray(w.q.numpy()),
                                       scale=jnp.asarray(w.scale.numpy()))
        if isinstance(w, quant.QuantTensor):
            return jquant.QuantTensor(q=jnp.asarray(w.q.numpy()),
                                      scale=jnp.asarray(w.scale.numpy()))
        return jnp.asarray(w.numpy())

    return rules.map_with_names(leaf, tree)


def _jax_engine(cfg, ecfg, params, **kw):
    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.engine.paged import PagedInferenceEngine
    from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer

    jcfg = jconfig.ModelConfig(**{f: getattr(cfg, f)
                                  for f in cfg.__dataclass_fields__})
    jecfg = jconfig.EngineConfig(**{
        f: getattr(ecfg, f) for f in ecfg.__dataclass_fields__
        if f in jconfig.EngineConfig.__dataclass_fields__})
    return PagedInferenceEngine(jcfg, jecfg, params,
                                get_tokenizer(vocab_size=512), **kw)


@pytest.fixture(scope="module")
def jax_side(inputs):
    """JAX's plain paged engine's greedy streams of ``BATCHES``, TINY fp32
    and TINY int4 over an int4 pool (the reference JAX's own fsdp engines
    are held to byte for byte), computed while the ranks run (on threads:
    XLA compiles with the interpreter lock released)."""

    def serve(tree, kv):
        return _serve(_jax_engine(_tiny(tree), _engine_config(kv),
                                  _jax_tree(inputs[tree]), use_kernel=False))

    with ThreadPoolExecutor(2) as pool:
        jobs = {"fp32": pool.submit(serve, "fp32", None),
                "int4": pool.submit(serve, "int4", "int4")}
        return {k: f.result() for k, f in jobs.items()}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["d2f2", "f2t2"])
@pytest.mark.parametrize("tree", ROUND_TRIPS)
def test_fsdp_blocks_gather_to_the_tp_rank_leaf(tree, mesh, ranks):
    """At fsdp 2 (data 2 x fsdp 2) and fsdp 2 x tp 2, for TINY bf16, int8
    and int4 and TINY_MOE int8: every leaf's fsdp block, gathered by the
    model's gather, equals the TP-only rank's leaf byte for byte (int4:
    the TP repack first, then a contiguous slice of the packed bytes); 7
    leaves a layer and the head are gathered (the tied embedding is the
    head), and a rank stores about half of the TP-only bytes."""
    layers = config.TINY.n_layers
    for r in ranks:
        equal, gathered, share = r["round_trip"][(tree, mesh)]
        assert equal
        assert gathered == 7 * layers + 1
        assert 0.5 <= share < 0.55, share


def _fsdp_counts_exact(got):
    """A forward gathers 7 leaves a layer and the head, and sums the
    embedding rows once over the fsdp group (module docstring of
    ``models/llama.py``)."""
    c, n = got["collectives"], got["counts"]
    fwd = (n["engine.prefill_dispatches"] + n["engine.decode_steps"]
           + n.get("engine.chunk_prefill_dispatches", 0))
    assert n["engine.chunk_prefill_dispatches"] == 1           # the hit
    assert c["all_gather_into"] == (7 * config.TINY.n_layers + 1) * fwd
    assert c["reduce_scatter_sum"] == 0
    return c, n, fwd


@pytest.mark.parametrize("name", ["fsdp4", "fsdp4_int4"])
def test_fsdp4_engine_equals_unsharded_and_jax(name, jax_side, ranks):
    """The paged engine at fsdp 4 (TINY fp32; TINY int4 weights over an int4
    pool), ``BATCHES`` (the second a prefix hit): every rank's
    greedy streams equal the port's unsharded engine's and JAX's plain
    paged engine's on the same weights, token for token (JAX's
    ``TestFsdpGreedyParity`` holds its fsdp engines byte-identical to that
    engine); each rank stores a quarter of wq's rows and the whole pool;
    the gathers are counted exactly."""
    tree, _, kv, _ = ENGINES[name]
    want = jax_side[tree]
    assert all(len(set(s)) > 2 for s in want), want
    assert ranks[0][name]["unsharded"] == want
    lanes = config.TINY.kv_dim // (2 if kv == "int4" else 1)
    for r in ranks:
        got = r[name]
        assert got["streams"] == want
        assert got["wq"] == (config.TINY.hidden_size // 4, config.TINY.q_dim)
        assert got["pool"][-1] == lanes
        c, _, fwd = _fsdp_counts_exact(got)
        # the embedding's sum; the int4 pool's scales are not TP-sharded
        assert c["all_reduce_sum"] == fwd
        assert c["all_reduce_max"] == 0


@pytest.mark.parametrize("name", ["fsdp2_tp2", "fsdp2_tp2_int4"])
def test_fsdp_tp_engine_equals_the_tp_engine(name, ranks):
    """fsdp 2 x tp 2 on one mesh (TINY fp32; int4 weights over an int4
    pool): every rank's streams equal the port's TP-2 engine's (data 2 x
    model 2) on the same weights; each rank stores half of its TP shard's
    rows and its TP share of the whole pool; the collectives are the
    gathers and TP's."""
    kv = ENGINES[name][2]
    for r in ranks:
        got = r[name]
        assert all(len(set(s)) > 2 for s in got["tp_only"])
        assert got["streams"] == got["tp_only"]
        assert got["wq"] == (config.TINY.hidden_size // 2,
                             config.TINY.q_dim // 2)
        lanes = config.TINY.kv_dim // 2
        assert got["pool"][-1] == (lanes // 2 if kv == "int4" else lanes)
        c, n, fwd = _fsdp_counts_exact(got)
        # TP: 2 sums a layer and the logits; the embedding's fsdp sum; one
        # all-gather along hidden (the embedding)
        assert c["all_reduce_sum"] == (2 * config.TINY.n_layers + 2) * fwd
        assert c["all_gather"] == fwd


def test_moe_fsdp_engine_equals_dense(ranks):
    """TINY_MOE in int8 over an int8 pool at fsdp 2 (data 2 x fsdp 2): the
    stacked experts are stored along hidden and gathered on use, the
    router whole; every rank's streams equal the port's dense engine's
    (held to JAX's in ``tests/test_torch_moe.py``)."""
    dense = ranks[0]["moe_fsdp2"]["unsharded"]
    assert all(len(set(s)) > 2 for s in dense), dense
    for r in ranks:
        got = r["moe_fsdp2"]
        assert got["streams"] == dense
        _fsdp_counts_exact(got)


def test_sp_engine_equals_tp_and_jax(jax_side, ranks):
    """``sp=True`` at TP 2 (data 2 x model 2), ``BATCHES`` (the last the
    prompts of ``tests/test_parallel.py:1239``): every rank's streams
    equal TP 2's without ``sp`` and JAX's plain engine's; a miss prefill
    dispatch gathers the sequence twice a layer and the last rows once,
    reduce-scatters twice a layer and sums only the logits; decode and the
    hit's chunk prefill are TP's."""
    want = jax_side["fp32"]
    layers = config.TINY.n_layers
    for r in ranks:
        on, off = r["sp"][True], r["sp"][False]
        assert on["streams"] == off["streams"] == want
        c, n = on["collectives"], on["counts"]
        prefills = n["engine.prefill_dispatches"]
        tp_fwd = n["engine.decode_steps"] + n["engine.chunk_prefill_dispatches"]
        assert prefills > 0 and n["engine.chunk_prefill_dispatches"] == 1
        assert c["all_gather_into"] == (2 * layers + 1) * prefills
        assert c["reduce_scatter_sum"] == 2 * layers * prefills
        assert c["all_reduce_sum"] == prefills + (2 * layers + 1) * tp_fwd
        assert c["all_gather"] == prefills + tp_fwd
        assert off["collectives"]["reduce_scatter_sum"] == 0


# ---------------------------------------------------------------------------
# the refusals, message for message (no spawn: the checks read only the
# meshes' axis names and sizes)
# ---------------------------------------------------------------------------


AXES = ("data", "fsdp", "model", "expert", "seq", "stage")


def _fake_mesh(axes=AXES, **sizes):
    """A stand-in for a port mesh: its axis names and sizes."""
    return types.SimpleNamespace(
        mesh_dim_names=axes, mesh=torch.zeros([sizes.get(a, 1) for a in axes]))


# name: (cfg overrides, max_batch, the fsdp mesh's axes, the other meshes
# by role ("fsdp": the same mesh, "other": a distinct one), sp)
FSDP_REFUSALS = {
    "no_fsdp_axis": ({}, 4, dict(data=1, model=2), {}, False),
    "distinct_tp": ({}, 4, dict(fsdp=2), {"tp": "other"}, False),
    "cp": ({}, 4, dict(fsdp=2), {"cp": "fsdp"}, False),
    "ep": ({"n_experts": 4}, 4, dict(fsdp=2), {"ep": "fsdp"}, False),
    "pp": ({}, 4, dict(fsdp=2), {"pp": "fsdp"}, False),
    "sp": ({}, 4, dict(fsdp=2, model=2), {"tp": "fsdp"}, True),
    "hidden": ({}, 4, dict(fsdp=3), {}, False),
    "vocab": ({"vocab_size": 510}, 4, dict(fsdp=4), {}, False),
    "max_batch": ({}, 3, dict(data=2, fsdp=2), {}, False),
}


@pytest.mark.parametrize("name", list(FSDP_REFUSALS))
def test_validate_fsdp_mesh_refuses_like_jax(name):
    """``validate_fsdp_mesh`` raises JAX's ValueError, message for message
    (``k8s_llm_rca_tpu/engine/engine.py:157``): a mesh without the fsdp
    axis, distinct fsdp and TP meshes, fsdp with CP, EP, PP and SP,
    hidden or vocab sizes the axis does not divide, and a batch the data
    axis does not divide."""
    import jax
    from jax.sharding import Mesh

    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.engine.engine import validate_fsdp_mesh as jvalidate
    from k8s_llm_rca_tpu_torch.engine.engine import validate_fsdp_mesh

    over, batch, axes, roles, sp = FSDP_REFUSALS[name]
    devs = jax.devices("cpu")

    def jax_mesh(shape, first=0):
        names = AXES if name != "no_fsdp_axis" else ("data", "model")
        sizes = [shape.get(a, 1) for a in names]
        n = int(np.prod(sizes))
        return Mesh(np.array(devs[first:first + n]).reshape(sizes), names)

    def port_mesh(shape, first=0):
        if name == "no_fsdp_axis":
            return _fake_mesh(("data", "model"), **shape)
        return _fake_mesh(**shape)

    errors = []
    for validate, cfg, ecfg, make in (
            (jvalidate, jconfig.TINY, jconfig.EngineConfig, jax_mesh),
            (validate_fsdp_mesh, config.TINY, config.EngineConfig,
             port_mesh)):
        mesh = make(axes)
        others = {role: mesh if key == "fsdp" else make(axes, 4)
                  for role, key in roles.items()}
        with pytest.raises(ValueError) as err:
            validate(mesh, cfg.replace(**over), ecfg(max_batch=batch),
                     tp_mesh=others.get("tp"), cp_mesh=others.get("cp"),
                     ep_mesh=others.get("ep"), pp_mesh=others.get("pp"),
                     sp=sp)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# the engine's sp refusals: the meshes given besides sp=True
SP_REFUSALS = {"no_tp": {}, "cp": {"tp_mesh": "m", "cp_mesh": "m"},
               "pp": {"tp_mesh": "m", "pp_mesh": "m"}}


@pytest.mark.parametrize("name", list(SP_REFUSALS))
def test_sp_refusals_like_jax(name):
    """``sp=True`` without ``tp_mesh``, with ``cp_mesh`` or with
    ``pp_mesh`` raises the JAX paged engine's ValueError
    (``k8s_llm_rca_tpu/engine/paged.py:908``), before it builds
    anything."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = _tiny("fp32")
    ecfg = _engine_config()
    port = _fake_mesh(model=2, seq=2, stage=2)
    with pytest.raises(ValueError) as mine:
        make_engine(cfg, ecfg, init_params(cfg, torch.Generator(), "cpu"),
                    get_tokenizer(vocab_size=512), "cpu", sp=True,
                    **{k: port for k in SP_REFUSALS[name]})
    with pytest.raises(ValueError) as theirs:
        _jax_engine(cfg, ecfg, None, sp=True,
                    **{k: object() for k in SP_REFUSALS[name]})
    assert str(mine.value) == str(theirs.value)


def test_sp_bucket_off_the_model_axis_is_refused():
    """Under ``sp=True`` every page-rounded prefill bucket must split over
    the model axis: a 15-token bucket (three 5-token pages) at TP 2 is a
    named ValueError at construction."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = _tiny("fp32")
    ecfg = config.EngineConfig(max_batch=2, max_seq_len=60, paged=True,
                               page_size=5, num_pages=32,
                               prefill_buckets=(11, 30), prefix_cache=False)
    mesh = _fake_mesh(model=2)
    with pytest.raises(ValueError, match="bucket 15 is not divisible by "
                                         "its size 2"):
        make_engine(cfg, ecfg, init_params(cfg, torch.Generator(), "cpu"),
                    get_tokenizer(vocab_size=512), "cpu", tp_mesh=mesh,
                    sp=True)


@pytest.mark.parametrize("case", ["whole_tree", "model_axis_without_tp"])
def test_fsdp_engine_refuses_a_tree_it_cannot_serve(case):
    """A whole tree handed to an fsdp 2 engine raises naming
    ``shard_params``, as TP's check does; an fsdp mesh with a model axis
    above 1 without ``tp_mesh`` (the rank's heads would be split with no
    TP rank to compute on them) asks for the same mesh as ``tp_mesh``."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = _tiny("fp32")
    params = init_params(cfg, torch.Generator(), "cpu")
    if case == "whole_tree":
        mesh, match = _fake_mesh(fsdp=2), ("the fsdp axis needs this rank's "
                                           "shard of the params")
    else:
        mesh, match = _fake_mesh(model=2), "pass the same mesh as tp_mesh"
    with pytest.raises(ValueError, match=match):
        make_engine(cfg, _engine_config(), params,
                    get_tokenizer(vocab_size=512), "cpu", fsdp_mesh=mesh)


def test_fsdp_param_bytes_and_gather_time(monkeypatch):
    """``runtime/profiling.py``'s FSDP counts (reported, not gated), on a
    Llama-3-8B tree of meta tensors: the parameter bytes a rank holds, the
    bytes a forward gathers (7 weights a layer and the untied head; the
    embedding is looked up per rank) and the least time a rank receives
    its peers' blocks of them over NVLink (450 GB/s each way on an H100;
    none off the table, none to receive on one rank)."""
    from k8s_llm_rca_tpu_torch.runtime import profiling

    cfg = config.LLAMA3_8B
    tree = rules.map_with_names(
        lambda _, shape: torch.empty(shape, dtype=torch.bfloat16,
                                     device="meta"),
        rules.llama_param_template(cfg))
    h, v, layers = cfg.hidden_size, cfg.vocab_size, cfg.n_layers
    per_layer = 2 * h * cfg.q_dim + 2 * h * cfg.kv_dim \
        + 3 * h * cfg.intermediate_size
    gathered = profiling.fsdp_gather_bytes(cfg, tree, 1)
    assert gathered == 2 * (layers * per_layer + v * h)
    assert profiling.param_bytes(tree) == \
        2 * (layers * (per_layer + 2 * h) + 2 * v * h + h)
    assert profiling.fsdp_gather_bytes(cfg, tree, 2) == 2 * gathered
    assert profiling.fsdp_gather_link_ms(gathered, 2, "cpu") is None
    monkeypatch.setattr(profiling, "_device_kind",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert profiling.fsdp_gather_link_ms(gathered, 1) == 0.0
    assert profiling.fsdp_gather_link_ms(gathered, 2) == pytest.approx(
        gathered / 2 / 450e9 * 1e3)
    w4 = quant.quantize(torch.ones(8, 16), bits=4)
    assert profiling.param_bytes({"a": [w4]}) == 8 * 8 + 16 * 4
