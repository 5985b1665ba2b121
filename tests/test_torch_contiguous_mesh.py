"""The contiguous engine's device meshes (``InferenceEngine``) against the
JAX package's unsharded contiguous engine.

The port is SPMD: a rank builds its ``InferenceEngine`` on its shard of
the weights with its rank's config, so its contiguous cache holds its TP
lanes, its PP stage's layers or its CP block of the sequence, and the
model calls the collectives itself.  The ranks run over gloo through
``runtime.mesh.run_ranks``: one spawn of four for the whole module,
started in the background when the module starts (a fixture), on eight
meshes of four ranks (TP, fsdp x TP, CP, CP x TP, PP, PP x TP, EP and PP x
EP, each with a "data" axis where it needs fewer than four ranks).  The
JAX side runs in this process meanwhile, its engines on threads.  The
ranks' bodies live in this module, which imports no JAX at its top.
Weights come from numpy seeds (the same arrays on both sides; int8 and
int4 the port's quantization, byte for byte JAX's).

Every engine serves three prompts through two slots (four for TINY_MOE):
two share the 32-token bucket (one batched prefill; under CP one prefill
each), the third fills the 64-token bucket, so a CP prefill spans both
blocks of the sequence and one stream decodes across the block boundary
at position 32.  Greedy streams compare exactly, at decode_chunk 1 and 4
against JAX's stepwise engine (JAX's scanned and stepwise engines emit
the same greedy tokens: ``tests/test_torch_contiguous.py``).  The direct
function checks hold ``prefill_cp``, the CP decode and
``llama_pp_decode_multi`` to the port's unsharded functions at fp32
tolerances (1e-5 of the logits' scale), and the TP ranks' int8 and int4
caches to JAX's unsharded cache (scales at rtol 1e-5, codes within one
step).

Cost: the spawn's four ranks run ~10 s of work each (after ~5 s of
start-up), the JAX side ~15 s of compiles on threads meanwhile.

Counterparts: ``tests/test_parallel.py`` (TP :216, :245, :701; CP :303,
:341, :822, :863; CP x TP :917, :957; EP :413, :441; SP :1239; PP :735,
:789, :1388, :1550; PP x TP :1586; PP x EP :1676).
"""

import copy
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
MESHES = {"d2t2": dict(data=2, model=2), "f2t2": dict(fsdp=2, model=2),
          "d2s2": dict(data=2, seq=2), "s2t2": dict(seq=2, model=2),
          "st2d2": dict(stage=2, data=2), "st2t2": dict(stage=2, model=2),
          "d2e2": dict(data=2, expert=2), "st2e2": dict(stage=2, expert=2)}
# the engines: (tree, kv_cache_dtype, mesh, what the mesh serves)
ENGINES = {"tp2": ("fp32", None, "d2t2", ("tp",)),
           "tp2_int4": ("int4", "int4", "d2t2", ("tp",)),
           "tp2_int8": ("int8", "int8", "d2t2", ("tp",)),
           "tp2_sp": ("fp32", None, "d2t2", ("tp", "sp")),
           "fsdp2_tp2": ("fp32", None, "f2t2", ("fsdp", "tp")),
           "cp2_ring": ("fp32", None, "d2s2", ("cp",)),
           "cp2_ulysses": ("fp32", None, "d2s2", ("cp", "ulysses")),
           "cp2_tp2": ("fp32", None, "s2t2", ("cp", "tp")),
           "pp2": ("fp32", None, "st2d2", ("pp",)),
           "pp2_tp2": ("fp32", None, "st2t2", ("pp", "tp")),
           "ep2": ("moe_int8", None, "d2e2", ("ep",)),
           "pp2_ep2": ("moe_int8", None, "st2e2", ("pp", "ep"))}
CHUNKS = (1, 4)
PROMPTS = ("oom killed container payments", "node notready on node-3",
           "node disk pressure taint on ip-10-0-3-7 worker")
MAX_NEW = 8


def _tiny(tree):
    cfg = config.TINY_MOE if tree.startswith("moe") else config.TINY
    return cfg.replace(max_seq_len=64,
                       fused_quant_matmul=tree.startswith(("int", "moe")))


def _engine_config(tree, kv=None, chunk=1):
    return config.EngineConfig(
        max_batch=4 if tree.startswith("moe") else 2, max_seq_len=64,
        prefill_buckets=(32, 64), max_new_tokens=MAX_NEW, temperature=0.0,
        paged=False, kv_cache_dtype=kv, decode_chunk=chunk)


def _encode(texts):
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    tok = get_tokenizer(vocab_size=512)
    return [tok.encode(t, add_bos=True) for t in texts]


def _serve(engine):
    return [r.token_ids for r in engine.generate(_encode(PROMPTS),
                                                 max_new_tokens=MAX_NEW)]


# ---------------------------------------------------------------------------
# the ranks' side (no JAX here)
# ---------------------------------------------------------------------------


def _rank_params(tree, cfg, mesh, roles):
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_params, shard_stage_params,
    )

    if "pp" in roles:
        return shard_stage_params(tree, cfg, mesh)
    layout = FSDP_LAYOUT if "fsdp" in roles else None
    return shard_params(tree, llama_param_specs(cfg, layout), mesh)


def _mesh_kwargs(mesh, roles):
    kw = {}
    for role, key in (("tp", "tp_mesh"), ("cp", "cp_mesh"),
                      ("pp", "pp_mesh"), ("ep", "ep_mesh"),
                      ("fsdp", "fsdp_mesh")):
        if role in roles:
            kw[key] = mesh
    if "pp" in roles:
        kw["pp_microbatches"] = 2
    if "ulysses" in roles:
        kw["cp_mode"] = "ulysses"
    if "sp" in roles:
        kw["sp"] = True
    return kw


def _engine_case(name, chunk, inputs, meshes):
    from k8s_llm_rca_tpu_torch.engine import InferenceEngine, make_engine
    from k8s_llm_rca_tpu_torch.runtime.mesh import (
        collective_counts, reset_collective_counts,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    tree, kv, key, roles = ENGINES[name]
    cfg = _tiny(tree)
    mesh = meshes[key]
    reset_collective_counts()
    engine = make_engine(cfg, _engine_config(tree, kv, chunk),
                         _rank_params(inputs[tree], cfg, mesh, roles),
                         get_tokenizer(vocab_size=512), "cpu",
                         **_mesh_kwargs(mesh, roles))
    assert isinstance(engine, InferenceEngine)
    streams = _serve(engine)
    ep = engine.model_cfg.ep
    return {"streams": streams, "collectives": collective_counts(),
            "counts": dict(engine._counts),
            "cache": tuple(engine.cache.k.shape),
            "dropped": int(ep.drops) if ep is not None else 0,
            "idle": not engine._active and not engine.lengths.any()}


def _cp_functions(inputs, mesh, mode):
    """``prefill_cp`` of one 47-token sequence (64-token bucket) into slot 1
    of a CP rank's cache and three CP decode steps from there, against the
    port's unsharded ``prefill`` and ``decode_step`` on the same weights:
    (largest logit error, largest cache error over the rank's block
    relative to its largest value, the scale of the logits)."""
    from k8s_llm_rca_tpu_torch.models import llama
    from k8s_llm_rca_tpu_torch.runtime.sharding import rank_config

    cfg = _tiny("fp32")
    params = inputs["fp32"]
    rcfg = rank_config(cfg, cp_mesh=mesh, device="cpu")
    p, s_loc = rcfg.cp.rank, 32
    full = llama.init_cache(cfg, 2, 64, None, "cpu")
    mine = llama.init_cache(rcfg, 2, s_loc, None, "cpu")
    (prompt,) = _encode(PROMPTS[2:])
    tokens = torch.zeros((1, 64), dtype=torch.int64)
    tokens[0, :len(prompt)] = torch.tensor(prompt)
    full, want = llama.prefill(cfg, params, full, tokens, len(prompt), 1)
    mine, got = llama.prefill_cp(rcfg, params, mine, tokens, len(prompt), 1,
                                 mesh, cp_mode=mode)
    errs = [float((got - want).abs().max())]
    scale = float(want.abs().max())
    cur = torch.tensor([0, int(want.argmax())])
    lengths = torch.tensor([0, len(prompt)], dtype=torch.int32)
    for _ in range(3):
        full, want = llama.decode_step(cfg, params, full, cur, lengths)
        mine, got = llama.decode_step(rcfg, params, mine, cur, lengths)
        errs.append(float((got - want)[1].abs().max()))
        cur, lengths = want.argmax(-1), lengths + 1
    n = int(lengths[1])
    block = slice(p * s_loc, min((p + 1) * s_loc, n))
    cache_err = max(float((a[:, 1, :block.stop - block.start]
                           - b[:, 1, block]).abs().max()
                          / b[:, 1, block].abs().max())
                    for a, b in ((mine.k, full.k), (mine.v, full.v)))
    return max(errs), cache_err, scale


def _pp_functions(inputs, mesh, tp):
    """``llama_pp_prefill`` of two rows, ``llama_pp_decode_step`` and
    ``llama_pp_decode_multi`` at T = 3 on a stage's cache, against the
    port's unsharded ``prefill_batch``, ``decode_step`` and
    ``decode_multi``: (largest logit error, largest error of the stage's
    cache layers (its TP lanes), the logits' scale, the greedy tokens
    equal to the logits' argmax); the cache errors are relative to the
    reference's largest value."""
    from k8s_llm_rca_tpu_torch.models import llama
    from k8s_llm_rca_tpu_torch.parallel import pipeline
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        rank_config, shard_stage_params,
    )

    cfg = _tiny("fp32").replace(n_layers=4)
    params = inputs["fp32_4"]
    rcfg = rank_config(cfg, tp_mesh=mesh if tp else None, pp_mesh=mesh,
                       pp_microbatches=2, device="cpu")
    stage, per = rcfg.pp.rank, rcfg.n_layers
    mine_p = shard_stage_params(params, cfg, mesh)
    full = llama.init_cache(cfg, 2, 64, None, "cpu")
    mine = llama.init_cache(rcfg, 2, 64, None, "cpu")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(1, 512, (2, 32)))
    lens = torch.tensor([30, 17], dtype=torch.int32)
    slots = torch.tensor([1, 0])
    full, want = llama.prefill_batch(cfg, params, full, tokens, lens, slots)
    mine, got = pipeline.llama_pp_prefill(rcfg, mine_p, mine, tokens, lens,
                                          slots)
    errs, scale = [float((got - want).abs().max())], float(want.abs().max())
    lengths = torch.tensor([17, 30], dtype=torch.int32)
    cur = torch.tensor([3, 4])
    full, want = llama.decode_step(cfg, params, full, cur, lengths)
    mine, got = pipeline.llama_pp_decode_step(rcfg, mine_p, mine, cur,
                                              lengths)
    errs.append(float((got - want).abs().max()))
    multi = torch.from_numpy(rng.integers(1, 512, (2, 3)))
    full, want = llama.decode_multi(cfg, params, full, multi, lengths + 1)
    mine, greedy, got = pipeline.llama_pp_decode_multi(
        rcfg, mine_p, mine, multi, lengths + 1)
    errs.append(float((got - want).abs().max()))
    lanes = slice(None)
    if tp:
        lanes = slice(rcfg.tp.rank * rcfg.kv_dim,
                      (rcfg.tp.rank + 1) * rcfg.kv_dim)
    layers = slice(stage * per, (stage + 1) * per)
    cache_err = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in ((mine.k, full.k[layers, ..., lanes]),
                                 (mine.v, full.v[layers, ..., lanes])))
    return (max(errs), cache_err, scale,
            bool(torch.equal(greedy, got.argmax(-1))))


def _tp_quant_cache(inputs, mesh, kv):
    """A prefill into slot 1, a batched prefill into slots 2 and 0 and two
    decode steps at TP 2 over an ``kv`` cache (``QUANT_STEPS``): the
    rank's cache fields as numpy."""
    from k8s_llm_rca_tpu_torch.models import llama
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, rank_config, shard_params,
    )

    cfg = _tiny("fp32")
    rcfg = rank_config(cfg, tp_mesh=mesh, device="cpu")
    params = shard_params(inputs["fp32"], llama_param_specs(cfg), mesh)
    cache = llama.init_cache(rcfg, 4, 64, kv, "cpu")
    one, two, lens, slots, steps = _quant_steps()
    cache, _ = llama.prefill(rcfg, params, cache, torch.from_numpy(one), 20,
                             1)
    cache, _ = llama.prefill_batch(rcfg, params, cache, *(
        torch.from_numpy(a) for a in (two, lens, slots)))
    for cur, lengths in steps:
        cache, _ = llama.decode_step(rcfg, params, cache,
                                     torch.from_numpy(cur),
                                     torch.from_numpy(lengths))
    return [t.numpy() for t in cache]


def _quant_steps():
    rng = np.random.default_rng(9)
    one = rng.integers(1, 512, (1, 32)).astype(np.int32)
    two = rng.integers(1, 512, (2, 32)).astype(np.int32)
    lens, slots = np.array([32, 9], np.int32), np.array([2, 0], np.int32)
    steps = [(rng.integers(1, 512, (4,)).astype(np.int32),
              np.array([9 + i, 20 + i, 32 + i, 0], np.int32))
             for i in range(2)]
    return one, two, lens, slots, steps


def _ranks(rank, inputs):
    """Everything the module checks on its four ranks, in one spawn."""
    from k8s_llm_rca_tpu_torch.runtime.mesh import local_mesh

    meshes = {k: local_mesh(device="cpu", **axes)
              for k, axes in MESHES.items()}
    out = {(name, chunk): _engine_case(name, chunk, inputs, meshes)
           for name in ENGINES for chunk in CHUNKS}
    out["cp_fn"] = {mode: _cp_functions(inputs, meshes["d2s2"], mode)
                    for mode in ("ring", "ulysses")}
    out["pp_fn"] = {tp: _pp_functions(inputs, meshes["st2t2" if tp
                                                     else "st2d2"], tp)
                    for tp in (False, True)}
    out["quant_cache"] = {kv: _tp_quant_cache(inputs, meshes["d2t2"], kv)
                          for kv in ("int8", "int4")}
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


def _torch_tree(tree):
    return rules.map_with_names(lambda _, a: torch.from_numpy(a), tree)


@pytest.fixture(scope="module")
def inputs():
    """The port's trees (torch): TINY in fp32, int8 and int4 (the port's
    quantization), TINY with 4 layers (the PP functions), TINY_MOE in
    int8."""
    tiny = _torch_tree(_numpy_params(config.TINY, 0))
    moe = _torch_tree(_numpy_params(config.TINY_MOE, 2))
    return {"fp32": tiny,
            "fp32_4": _torch_tree(_numpy_params(
                config.TINY.replace(n_layers=4), 4)),
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
                          str(tmp_path_factory.mktemp("contiguous_mesh")),
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


def _jax_cfg(tree):
    from k8s_llm_rca_tpu import config as jconfig

    cfg = _tiny(tree)
    # the XLA matmuls (the port's plain versions compute the same x @ dq(w))
    return jconfig.ModelConfig(**{f: getattr(cfg, f)
                                  for f in cfg.__dataclass_fields__}
                               ).replace(fused_quant_matmul=False)


def _jax_streams(tree, kv, params):
    """JAX's unsharded contiguous engine, stepwise."""
    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.engine.engine import InferenceEngine
    from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer

    ecfg = _engine_config(tree, kv)
    jecfg = jconfig.EngineConfig(**{
        f: getattr(ecfg, f) for f in ecfg.__dataclass_fields__
        if f in jconfig.EngineConfig.__dataclass_fields__})
    engine = InferenceEngine(_jax_cfg(tree), jecfg, params,
                             get_tokenizer(vocab_size=512))
    return _serve(engine)


def _jax_quant_cache(kv, params):
    """``_tp_quant_cache``'s steps on JAX's unsharded jitted functions."""
    import jax
    import jax.numpy as jnp

    from k8s_llm_rca_tpu.models import llama as jllama

    cfg = _jax_cfg("fp32")
    jit = jax.jit

    cache = jllama.init_cache(cfg, 4, 64, kv_dtype={"int8": jnp.int8,
                                                    "int4": "int4"}[kv])
    one, two, lens, slots, steps = _quant_steps()
    cache, _ = jit(jllama.prefill, static_argnums=0)(
        cfg, params, cache, jnp.asarray(one), jnp.int32(20), jnp.int32(1))
    cache, _ = jit(jllama.prefill_batch, static_argnums=0)(
        cfg, params, cache, *map(jnp.asarray, (two, lens, slots)))
    for cur, lengths in steps:
        cache, _ = jit(jllama.decode_step, static_argnums=0)(
            cfg, params, cache, jnp.asarray(cur), jnp.asarray(lengths))
    return [np.asarray(t) for t in cache]


@pytest.fixture(scope="module")
def jax_side(inputs):
    """JAX's unsharded contiguous engines' greedy streams (TINY fp32, int4
    weights over an int4 cache, int8 over int8, TINY_MOE int8) and its
    int8 and int4 caches after ``_quant_steps``, computed while the ranks
    run (on threads: XLA compiles with the interpreter lock released)."""
    trees = {k: _jax_tree(inputs[k]) for k in ("fp32", "int4", "int8",
                                                "moe_int8")}
    with ThreadPoolExecutor(6) as pool:
        jobs = {tree: pool.submit(_jax_streams, tree, kv, trees[tree])
                for tree, kv in (("fp32", None), ("int4", "int4"),
                                 ("int8", "int8"), ("moe_int8", None))}
        caches = {kv: pool.submit(_jax_quant_cache, kv, trees["fp32"])
                  for kv in ("int8", "int4")}
        return {"streams": {k: f.result() for k, f in jobs.items()},
                "caches": {k: f.result() for k, f in caches.items()}}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _expected_collectives(name, c, n):
    """The collectives a case's forwards must call (its ``counts``): the
    schedule's for PP, the lse merge's and the ring's or all-to-all's for
    CP, TP's sums and embedding gather."""
    layers = config.TINY.n_layers
    steps, prefills = n["engine.decode_steps"], n["engine.prefill_dispatches"]
    fwd = steps + prefills
    roles = ENGINES[name][3]
    want = {}
    if "pp" in roles:
        # M + P - 1 ring steps and one broadcast a forward
        want.update(ppermute=3 * fwd)
        if "ep" not in roles and "tp" not in roles:
            want.update(all_reduce_sum=fwd)
    if roles == ("cp",) or roles == ("cp", "ulysses"):
        # 2 gathers a prefill (K/V, last rows), 1 merge a layer a step
        want.update(all_gather=2 * prefills + layers * steps)
        if "ulysses" in roles:
            want.update(all_to_all=4 * layers * prefills)
        else:
            want.update(ppermute=2 * 2 * layers * prefills)
    if roles == ("tp",):
        want.update(all_reduce_sum=(2 * layers + 1) * fwd, all_gather=fwd)
    return {k: c[k] for k in want} == want, want


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", list(ENGINES))
def test_contiguous_mesh_engine_equals_jax(name, chunk, jax_side, ranks):
    """``make_engine(..., paged=False)`` on every mesh of ``ENGINES``, at
    decode_chunk 1 and 4: all four ranks' greedy streams equal JAX's
    unsharded contiguous engine's on the same weights, token for token;
    each rank's cache holds its lanes (TP), its stage's layers (PP) or its
    half of the sequence (CP), and the whole cache under fsdp; no token is
    dropped (EP); the forwards call the collectives their mesh needs."""
    tree, kv, key, roles = ENGINES[name]
    want = jax_side["streams"][tree]
    assert all(len(set(s)) > 2 for s in want), want
    cfg = _tiny(tree)
    shape = MESHES[key]
    lanes = cfg.kv_dim // shape.get("model", 1) // (2 if kv == "int4" else 1)
    rows = 64 // shape.get("seq", 1)
    layers = cfg.n_layers // shape.get("stage", 1)
    for r in ranks:
        got = r[(name, chunk)]
        assert got["streams"] == want, (got["streams"], want)
        assert got["cache"][0] == layers
        assert got["cache"][2:] == (rows, lanes)
        assert got["dropped"] == 0 and got["idle"]
        n = got["counts"]
        assert (n["engine.decode_steps"] > n["engine.dispatches"]) == \
            (chunk > 1)
        if "cp" not in roles:
            assert n.get("engine.batched_admissions", 0) >= 2
        ok, expect = _expected_collectives(name, got["collectives"], n)
        assert ok, (got["collectives"], expect)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_prefill_cp_and_cp_decode_equal_unsharded(mode, ranks):
    """``llama.prefill_cp`` of a 47-token prompt in the 64-token bucket at
    CP 2, then three decode steps over the sequence-sharded cache (each
    rank attends its block with the lse; the merge is one all-gather a
    layer): the logits on every rank equal the port's unsharded
    ``prefill`` and ``decode_step``'s within 1e-5 of their scale, and each
    rank's cache rows are the unsharded cache's rows of its block (within
    1e-5 of their largest value)."""
    for r in ranks:
        logit_err, cache_err, scale = r["cp_fn"][mode]
        assert logit_err <= 1e-5 * scale, (logit_err, scale)
        assert cache_err <= 1e-5, cache_err


@pytest.mark.parametrize("tp", [False, True], ids=["pp2", "pp2_tp2"])
def test_llama_pp_functions_equal_unsharded(tp, ranks):
    """``llama_pp_prefill``, ``llama_pp_decode_step`` and
    ``llama_pp_decode_multi`` (T = 3) at stage 2, M = 2 (x model 2), on
    TINY with 4 layers: the logits on every rank equal the port's
    unsharded ``prefill_batch``, ``decode_step`` and ``decode_multi``'s
    within 1e-5 of their scale, each stage's cache layers (its TP lanes)
    are the unsharded cache's within 1e-5 of their largest value (a
    microbatch's matmul rounds otherwise than the whole batch's), and the
    greedy tokens are the logits' argmax."""
    for r in ranks:
        logit_err, cache_err, scale, greedy = r["pp_fn"][tp]
        assert logit_err <= 1e-5 * scale, (logit_err, scale)
        assert cache_err <= 1e-5, cache_err
        assert greedy


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_tp_quantized_cache_equals_jax_unsharded(kv, jax_side, ranks):
    """At TP 2 every rank writes the FULL-row scale (the max over the TP
    group) into its int8 or int4 cache: after a prefill, a batched prefill
    and two decode steps the TP ranks' scales equal JAX's unsharded
    cache's (rtol 1e-5: the TP sums round otherwise), and their lanes,
    side by side (int4 unpacked per rank: packed over its own lanes), are
    JAX's codes within one step.  A rank-local scale would be the max over
    half the row."""
    from k8s_llm_rca_tpu_torch.models.quant import _unpack_nibbles

    want = jax_side["caches"][kv]
    packed = kv == "int4"

    def codes(a):
        t = torch.from_numpy(np.array(a))
        return (_unpack_nibbles(t) if packed else t).numpy().astype(np.int32)

    # model index t is the rank's minor coordinate on data 2 x model 2
    for d in range(2):
        pair = [ranks[2 * d + t]["quant_cache"][kv] for t in range(2)]
        for f in range(2):
            got = np.concatenate([codes(p[f]) for p in pair], axis=-1)
            diff = np.abs(got - codes(want[f]))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, \
                (f, diff.max(), (diff > 0).mean())
        for f in (2, 3):
            for p in pair:
                np.testing.assert_allclose(p[f], want[f], rtol=1e-5)
