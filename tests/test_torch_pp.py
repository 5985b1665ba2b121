"""Pipeline parallelism of the port against the JAX package's.

The port is SPMD: a rank of a ``stage`` mesh holds only its stage's layers
(``runtime.sharding.shard_stage_params``) and a pool of only those layers,
and ``parallel/pipeline.py`` runs the GPipe schedule over the stage group.
Its ranks run over gloo through ``runtime.mesh.run_ranks``, one spawn of
four for the whole module, started in the background (a fixture): the
stage-only cases on the first pipeline of ``stage`` 2 x ``data`` 2, then
``stage`` 2 x ``model`` 2 and ``stage`` 2 x ``expert`` 2.  The JAX side
runs in this process on the virtual CPU devices of ``tests/conftest.py``
meanwhile, its compiles on threads.  The ranks' bodies live in this
module, which imports no JAX at its top.
Weights come from numpy seeds (``params_from_numpy`` of the same arrays on
both sides; int4 the port's quantization, byte for byte JAX's).

Tolerances: logits and pages TOL[dtype] of the reference's largest value
(fp32 1e-4, bf16 3e-2: the port's torch and JAX's XLA reduce in other
orders); int8/int4 pool codes within one step of JAX's and their scales at
rtol 1e-4; ``pipeline_apply`` and ``llama_pipeline_forward`` (fp32) at
atol 1e-5.  Against the port's own unsharded functions on the same
microbatches each stage's pool layers are equal byte for byte (on the
whole batch at once they are not: a matmul of other rows rounds
otherwise).  Greedy streams are equal exactly.

Counterparts: ``tests/test_parallel.py`` (``pipeline_apply`` :64,
``llama_pipeline_forward`` :86, the PP prefix-cache engine :1460, the PP x
TP paged engine :1629, PP x EP :1676, the refusals :1864 and :1910).
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

TOL = {"float32": 1e-4, "bfloat16": 3e-2}

# the pipelined functions' cases: (model dtype, pool, int4 weights, TP)
FN_CASES = {"bf16": ("bfloat16", None, False, 1),
            "int8_pool": ("float32", "int8", False, 1),
            "tp_int4": ("float32", "int4", True, 2)}
PAGE, N_PAGES, PPS = 8, 16, 8

# the engine cases (tests/test_parallel.py :1460, :1629, :1676)
HIT_PROMPT = "incident pod crashloop in namespace prod"
TP_PROMPTS = ("pod pending unschedulable", "pvc not bound",
              "oom killed container", "node disk pressure taint",
              "dns resolution failing")
EP_PROMPTS = TP_PROMPTS[:3]
CHUNKS = (1, 4)
# the ranks of the stage-only pipeline (data 0 of stage 2 x data 2: a
# stage mesh lays "stage" out last, so it varies fastest)
STAGE_RANKS = slice(0, 2)


def _tiny(**kw):
    return config.TINY.replace(n_layers=4, max_seq_len=64, **kw)


def _tiny_moe():
    return config.TINY_MOE.replace(n_layers=4, n_experts=4, max_seq_len=64)


def _hit_engine_config():
    return config.EngineConfig(
        max_batch=2, max_seq_len=64, page_size=8, num_pages=64,
        prefill_buckets=(16, 32), max_new_tokens=6, temperature=0.0,
        prefix_cache=True, decode_chunk=1, kv_cache_dtype="int8",
        paged=True)


def _tp_engine_config(chunk):
    return config.EngineConfig(
        max_batch=4, max_seq_len=64, prefill_buckets=(16, 32),
        max_new_tokens=6, temperature=0.0, kv_cache_dtype="int4",
        paged=True, page_size=16, num_pages=32, prefix_cache=False,
        decode_chunk=chunk)


def _ep_engine_config(chunk):
    return config.EngineConfig(
        max_batch=4, max_seq_len=64, prefill_buckets=(16, 32),
        max_new_tokens=6, temperature=0.0, decode_chunk=chunk, paged=True,
        page_size=16, num_pages=32, prefix_cache=False)


def _encode(texts):
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    tok = get_tokenizer(vocab_size=512)
    return [tok.encode(t, add_bos=True) for t in texts]


def _fn_steps():
    """The pipelined functions' inputs, in order on one pool: a batched
    prefill of two rows, a decode at T = 1 and at T = 3 over those rows'
    pages, and a chunk prefill whose prefix is row 0's first page."""
    rng = np.random.default_rng(11)

    def ints(*shape):
        return rng.integers(1, 512, shape).astype(np.int32)

    tables = np.zeros((2, PPS), np.int32)
    tables[0, :2] = (1, 2)
    tables[1, :3] = (3, 4, 5)
    chunk = np.zeros((1, PAGE), np.int32)
    chunk[0, :5] = ints(5)
    return [("prefill", (ints(2, 16), np.array([11, 16], np.int32),
                         np.array([[1, 2], [3, 4]], np.int32))),
            ("decode1", (ints(2, 1), np.array([11, 16], np.int32), tables)),
            ("decode3", (ints(2, 3), np.array([12, 17], np.int32), tables)),
            ("chunk", (chunk, 5, 8, np.array([1], np.int32),
                       np.array([6], np.int32)))]


# ---------------------------------------------------------------------------
# the ranks' side (no JAX here)
# ---------------------------------------------------------------------------


def _pool_arrays(pool):
    return [t.clone() for t in pool if t is not None]


def _run_steps(cfg, params, pool, steps):
    """(logits, pool tensors after it) of each step, the pipelined
    functions when ``cfg`` is a PP rank's, else the unsharded ones."""
    from k8s_llm_rca_tpu_torch.engine import paged
    from k8s_llm_rca_tpu_torch.parallel import pipeline

    pp = getattr(cfg, "pp", None) is not None
    out = []
    for name, args in steps:
        a = [torch.from_numpy(x) if isinstance(x, np.ndarray) else x
             for x in args]
        if name == "prefill":
            fn = pipeline.paged_pp_prefill if pp else paged.paged_prefill_batch
            pool, logits = fn(cfg, params, pool, *a)
        elif name == "chunk":
            fn = (pipeline.paged_pp_prefill_chunk if pp
                  else paged.paged_prefill_chunk)
            pool, logits = fn(cfg, params, pool, *a)
        else:
            fn = (pipeline.paged_pp_decode_multi if pp
                  else paged.paged_decode_multi)
            pool, _, logits = fn(cfg, params, pool, *a)
        out.append((logits, _pool_arrays(pool)))
    return out


def _fn_case(name, inputs, mesh):
    from k8s_llm_rca_tpu_torch.engine.paged import init_paged_cache
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        rank_config, shard_stage_params,
    )

    dtype, kv, w4, tp = FN_CASES[name]
    cfg = _tiny(dtype=dtype, fused_quant_matmul=w4)
    rcfg = rank_config(cfg, tp_mesh=mesh if tp > 1 else None, device="cpu",
                       pp_mesh=mesh, pp_microbatches=2)
    params = shard_stage_params(inputs[name], cfg, mesh)
    pool = init_paged_cache(rcfg, N_PAGES, PAGE, "cpu", kv)
    return {"layers": len(params["layers"]),
            "steps": _run_steps(rcfg, params, pool, _fn_steps())}


def _serve(engine, prompts, **kw):
    out = [r.token_ids for r in engine.generate(prompts, max_new_tokens=6,
                                                **kw)]
    engine.allocator.check()
    return out


GRAMMAR_SCHEMA = {"type": "object", "properties": [
    ("kind", {"enum": ["Pod", "Service", "Node"]}),
    ("ok", {"type": "boolean"})]}


def _grammar_texts(cfg, params, mesh, tok):
    """A schema-constrained request on the PP engine stepwise
    (decode_chunk 1) and through the scanned DFA (decode_chunk 8), both
    through the pipelined step (JAX's ``tests/test_parallel.py``
    ``test_pp_engine_dfa_scan_parity``)."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.engine.constrain import make_grammar
    from k8s_llm_rca_tpu_torch.runtime.sharding import shard_stage_params

    prompt = tok.encode("diagnose:", add_bos=True)
    texts = {}
    for chunk in (1, 8):
        ecfg = config.EngineConfig(
            max_batch=4, max_seq_len=64, prefill_buckets=(16, 32),
            max_new_tokens=40, decode_chunk=chunk, paged=True, page_size=8,
            num_pages=64, prefix_cache=False)
        engine = make_engine(cfg, ecfg, shard_stage_params(params, cfg, mesh),
                             tok, "cpu", pp_mesh=mesh)
        rid = engine.submit(prompt, max_new_tokens=40,
                            grammar=make_grammar(GRAMMAR_SCHEMA, tok))
        texts[chunk] = {r.seq_id: r for r in
                        engine.run_to_completion()}[rid].text
    return texts


def _ranks(rank, inputs):
    """Everything the module checks on its four ranks, in one spawn: the
    stage-only cases on the first pipeline of stage 2 x data 2 (ranks 0
    and 1, ``STAGE_RANKS``), then stage 2 x model 2 and stage 2 x expert
    2 on all four."""
    from k8s_llm_rca_tpu_torch.runtime.mesh import axis_rank, local_mesh

    mesh = local_mesh(stage=2, data=2, device="cpu")
    # the second pipeline (data 1) would repeat the first: it waits
    out = (_stage_cases(inputs, mesh) if axis_rank(mesh, "data") == 0
           else {})
    out.update(_composed_cases(rank, inputs))
    return out


def _stage_cases(inputs, mesh):
    """Stage only: the schedule, the scoring forward, the bf16 and int8
    function chains, the grammar scans and the prefix-hit engine (int8
    pool)."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.parallel.pipeline import (
        llama_pipeline_forward, pipeline_apply,
    )
    from k8s_llm_rca_tpu_torch.runtime.mesh import (
        axis_rank, collective_counts, reset_collective_counts,
    )
    from k8s_llm_rca_tpu_torch.runtime.sharding import shard_stage_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    stage = axis_rank(mesh, "stage")
    w, b, x_mb = inputs["schedule"]
    out = {"apply": pipeline_apply(
        lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
        {"w": w[stage], "b": b[stage]}, x_mb, mesh)}
    cfg = _tiny()
    out["forward"] = llama_pipeline_forward(
        cfg, shard_stage_params(inputs["forward"], cfg, mesh),
        inputs["tokens"], mesh, microbatches=2)
    for name in ("bf16", "int8_pool"):
        out[name] = _fn_case(name, inputs, mesh)

    tok = get_tokenizer(vocab_size=512)
    out["grammar"] = _grammar_texts(cfg, inputs["engine"], mesh, tok)
    (prompt,) = _encode([HIT_PROMPT])
    reset_collective_counts()
    engine = make_engine(cfg, _hit_engine_config(),
                         shard_stage_params(inputs["engine"], cfg, mesh), tok,
                         "cpu", pp_mesh=mesh)
    first = _serve(engine, [prompt])
    hits = engine._counts.get("engine.prefix_hit_tokens", 0)
    second = _serve(engine, [prompt])
    out["hit_engine"] = {
        "streams": first + second, "collectives": collective_counts(),
        "hit_tokens": engine._counts["engine.prefix_hit_tokens"] - hits,
        "counts": dict(engine._counts), "layers": len(engine.params["layers"]),
        "pool": tuple(engine.pool.k.shape)}
    return out


def _composed_cases(rank, inputs):
    """Stage 2 x model 2: the int4 function chain and the int4 engine at
    decode_chunk 1 and 4; stage 2 x expert 2: the MoE engine, and on rank
    0 the port's dense engine it is held to."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.runtime.mesh import (
        collective_counts, local_mesh, reset_collective_counts,
    )
    from k8s_llm_rca_tpu_torch.runtime.sharding import shard_stage_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    tok = get_tokenizer(vocab_size=512)
    mesh = local_mesh(stage=2, model=2, device="cpu")
    out = {"tp_int4": _fn_case("tp_int4", inputs, mesh)}
    cfg = _tiny(fused_quant_matmul=True)
    params = shard_stage_params(inputs["tp_int4"], cfg, mesh)
    for chunk in CHUNKS:
        reset_collective_counts()
        engine = make_engine(cfg, _tp_engine_config(chunk), params, tok,
                             "cpu", pp_mesh=mesh, tp_mesh=mesh)
        out[f"tp_engine{chunk}"] = {
            "streams": _serve(engine, _encode(TP_PROMPTS)),
            "collectives": collective_counts(),
            "counts": dict(engine._counts),
            "layers": len(engine.params["layers"]),
            "pool": tuple(engine.pool.k.shape)}

    ep = local_mesh(stage=2, expert=2, device="cpu")
    moe = _tiny_moe()
    params = shard_stage_params(inputs["moe"], moe, ep)
    for chunk in CHUNKS:
        ecfg = _ep_engine_config(chunk)
        reset_collective_counts()
        engine = make_engine(moe, ecfg, params, tok, "cpu", pp_mesh=ep,
                             ep_mesh=ep)
        out[f"ep_engine{chunk}"] = {
            "streams": _serve(engine, _encode(EP_PROMPTS)),
            "collectives": collective_counts(),
            "dropped": int(engine.model_cfg.ep.drops),
            "experts": engine.params["layers"][0]["w_gate"].shape[0],
            "layers": len(engine.params["layers"]),
            "counts": dict(engine._counts),
            "dense": _serve(make_engine(moe, ecfg, inputs["moe"], tok, "cpu"),
                            _encode(EP_PROMPTS)) if rank == 0 else None}
    return out


# ---------------------------------------------------------------------------
# inputs, the spawns and the JAX side
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
            return w * (1.0 if name == "embedding" else scale)
        s = scale * x
        if name.endswith(("wo", "w_down")):
            s /= (2 * cfg.n_layers) ** 0.5
        return (w * s).astype(np.float32)

    return rules.map_with_names(leaf, rules.llama_param_template(cfg))


def _forward_params():
    """TINY with 4 layers at the init's scales, the tied embedding an
    eighth of it: logits of order one, where fp32 rounding stays under
    the scoring forward's atol 1e-5."""
    tree = _numpy_params(_tiny(), 1, x=1.0)
    tree["embedding"] = tree["embedding"] / 8
    return tree


def _torch_tree(tree, dtype=torch.float32):
    return rules.map_with_names(
        lambda _, a: torch.from_numpy(a).to(dtype), tree)


@pytest.fixture(scope="module")
def inputs():
    """The port's inputs (torch): the seeded trees, int4 TINY (the port's
    quantization), the schedule's stage weights and microbatches."""
    rng = np.random.default_rng(3)
    tiny = _numpy_params(_tiny(), 0)
    sched = (rng.standard_normal((2, 8, 8)).astype(np.float32) * 0.3,
             rng.standard_normal((2, 8)).astype(np.float32) * 0.1,
             rng.standard_normal((6, 2, 8)).astype(np.float32))
    return {"engine": _torch_tree(tiny),
            "forward": _torch_tree(_forward_params()),
            "bf16": _torch_tree(tiny, torch.bfloat16),
            "int8_pool": _torch_tree(tiny),
            "tp_int4": quant.quantize_params(_torch_tree(tiny),
                                             torch.float32, bits=4),
            "moe": _torch_tree(_numpy_params(_tiny_moe(), 2)),
            "schedule": tuple(torch.from_numpy(a) for a in sched),
            "tokens": torch.from_numpy(
                rng.integers(0, 512, (8, 16)).astype(np.int64))}


@pytest.fixture(scope="module", autouse=True)
def spawned(inputs, tmp_path_factory):
    """The module's one spawn of four ranks, started in the background when
    the module starts: the JAX side of the tests runs meanwhile, and a
    test that needs the ranks waits for them."""
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks

    # the ranks get a copy: handing a tensor to a spawned process moves its
    # storage into shared memory and frees the old buffer, which a JAX
    # array made from it meanwhile (on the CPU JAX aliases the numpy
    # memory) would go on reading
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, _ranks, 4,
                          str(tmp_path_factory.mktemp("pp")),
                          args=(copy.deepcopy(inputs),),
                          timeout_s=RANKS_TIMEOUT_S)


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned.result()


def _jax_tree(tree):
    """A port tree as JAX arrays, int4 leaves as JAX's ``QuantTensor4``
    (the same bytes)."""
    import jax.numpy as jnp

    from k8s_llm_rca_tpu.models import quant as jquant

    def leaf(_, w):
        if isinstance(w, quant.QuantTensor4):
            return jquant.QuantTensor4(q=jnp.asarray(w.q.numpy()),
                                       scale=jnp.asarray(w.scale.numpy()))
        if w.dtype == torch.bfloat16:
            return jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(w.numpy())

    return rules.map_with_names(leaf, tree)


def _jax_mesh(**axes):
    import jax

    from k8s_llm_rca_tpu.config import MeshConfig
    from k8s_llm_rca_tpu.runtime.mesh import build_mesh

    cfg = MeshConfig(**axes)
    return build_mesh(cfg, devices=jax.devices("cpu")[:cfg.n_devices])


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t).astype(np.float32)


def _rank(stage: int, t: int) -> int:
    """The rank of (stage, model or expert index) on a stage-2 mesh: the
    mesh lays "stage" out last, so it varies fastest."""
    return 2 * t + stage


def _global_pool(ranks, name, step, n_tp):
    """A step's pool as JAX holds it, as numpy: the stages' layers stacked,
    the TP ranks' lanes side by side (an int4 pool under TP is packed per
    rank, in JAX's stage bodies too); the scales are the TP ranks'
    (equal).  bf16 pages travel as float32 (exact) and are cast back."""
    import jax.numpy as jnp

    def rank_fields(r):
        return ranks[r][name]["steps"][step][1]

    fields = []
    for f in range(len(rank_fields(0))):
        stages = []
        for s in range(2):
            parts = [rank_fields(_rank(s, t))[f] for t in range(n_tp)]
            stages.append(torch.cat(parts, -1) if f < 2 else parts[0])
        full = torch.cat(stages, 0)
        fields.append(full.float().numpy().astype(jnp.bfloat16)
                      if full.dtype == torch.bfloat16 else full.numpy())
    return fields


def _quick_jit(fn, **kw):
    """``jax.jit`` compiling at LLVM -O0 (the reference runs once, on TINY
    shapes: compile time is what it costs)."""
    import jax

    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0},
                   **kw)


def _jax_chain(name, inputs):
    """JAX's ``paged_pp_*`` for ``FN_CASES[name]``, jitted: ``run(i,
    fields)`` runs step ``i`` of ``_fn_steps`` from a pool given by its
    fields (None: zeros) and returns (logits, pool fields) as numpy.  The
    whole chain runs once here on its own pools, which compiles every step
    for the pools' shapes and placement."""
    import jax.numpy as jnp

    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.engine.paged import PagePool, init_paged_cache
    from k8s_llm_rca_tpu.parallel import pipeline as jpp

    dtype, kv, w4, tp = FN_CASES[name]
    cfg = jconfig.TINY.replace(n_layers=4, max_seq_len=64, dtype=dtype,
                               fused_quant_matmul=w4)
    mesh = _jax_mesh(stage=2, model=tp)
    params = _jax_tree(inputs[name])
    tp_axis = "model" if tp > 1 else None
    stacked = jpp.shard_stacked_layers(
        jpp.stack_llama_stages(params, 2), mesh, "stage", cfg=cfg,
        tp_axis=tp_axis)
    kw = dict(mesh=mesh, stage_axis="stage", tp_axis=tp_axis)
    # the weights travel as arguments (closed over, XLA would fold them in
    # as constants), and XLA compiles at LLVM -O0: half the compile time,
    # the same results to far inside the tolerances
    fns = {
        "prefill": _quick_jit(lambda w, stk, p, *xs: jpp.paged_pp_prefill(
            cfg, w, p, *xs, microbatches=2, stacked_layers=stk, **kw)),
        "decode": _quick_jit(lambda w, stk, p, *xs: jpp.paged_pp_decode_multi(
            cfg, w, p, *xs, microbatches=2, stacked_layers=stk, **kw)[::2]),
        "chunk": _quick_jit(
            lambda w, stk, p, toks, n, pre, *xs: jpp.paged_pp_prefill_chunk(
                cfg, w, p, toks, n, pre, *xs, stacked_layers=stk, **kw),
            static_argnums=(4, 5)),
    }
    steps = _fn_steps()

    def run(i, fields):
        pool = (init_paged_cache(cfg, N_PAGES, PAGE, kv) if fields is None
                else PagePool(*(jnp.asarray(f) for f in fields),
                              *(() if kv else (None, None))))
        step, args = steps[i]
        new, logits = fns[step.rstrip("13")](
            params, stacked, pool,
            *(jnp.asarray(x) if isinstance(x, np.ndarray) else x
              for x in args))
        return (np.asarray(logits).astype(np.float32),
                [np.asarray(f) for f in new if f is not None])

    fields = None
    for i in range(len(steps)):
        fields = run(i, fields)[1]
    return run


def _jax_fn_outputs(name, run, ranks):
    """JAX's chain for ``name`` (``_jax_chain``), each step from the port's
    pool bytes of the step before (zeros first): [(logits, pool
    fields)]."""
    tp = FN_CASES[name][3]
    return [run(i, _global_pool(ranks, name, i - 1, tp) if i else None)
            for i in range(len(_fn_steps()))]


# ---------------------------------------------------------------------------
# the refusals, message for message (no spawn: the checks read only the
# meshes' axis names and sizes)
# ---------------------------------------------------------------------------


AXES = ("data", "fsdp", "model", "expert", "seq", "stage")


def _fake_mesh(**axes):
    """A stand-in for a port mesh: its axis names and sizes."""
    shape = [axes.get(a, 1) for a in AXES]
    return types.SimpleNamespace(mesh_dim_names=AXES,
                                 mesh=torch.zeros(shape))


def _int4_tree():
    w = quant.quantize(torch.ones((4, 8)), bits=4)
    return {"layers": [{"wq": w}]}


def _refusal_cases():
    """name: (cfg overrides, EngineConfig overrides, meshes as
    {role: mesh key}, microbatches, int4 params); mesh keys name one mesh
    shape, "pp" the stage 2 mesh, "pp_b" an equal but distinct one."""
    base = dict(max_batch=4, max_seq_len=64, prefill_buckets=(16, 32))
    return {
        "pp_cp": ({}, base, {"pp": "pp", "cp": "pp"}, None, False),
        "pp_tp_distinct": ({}, base, {"pp": "pptp", "tp": "pptp_b"}, None,
                           False),
        "int4_odd": ({"intermediate_size": 250}, base,
                     {"pp": "pptp", "tp": "pptp"}, None, True),
        "pp_tp_moe": ({"n_experts": 4}, base, {"pp": "pptp", "tp": "pptp"},
                      None, False),
        "pp_tp_ep": ({"n_experts": 4}, base,
                     {"pp": "pptp", "tp": "pptp", "ep": "pptp"}, None,
                     False),
        "pp_ep_distinct": ({"n_experts": 4}, base,
                           {"pp": "ppep", "ep": "ppep_b"}, None, False),
        "pp_ep_microbatch": ({"n_experts": 4}, {**base, "max_batch": 2},
                             {"pp": "ppep", "ep": "ppep"}, None, False),
        "no_stage": ({}, base, {"pp": "x"}, None, False),
        "n_layers": ({"n_layers": 3}, base, {"pp": "pp"}, None, False),
        "microbatches": ({}, base, {"pp": "pp"}, 3, False),
    }


REFUSALS = _refusal_cases()


def _meshes(spec, make):
    shapes = {"pp": dict(stage=2), "pptp": dict(stage=2, model=2),
              "ppep": dict(stage=2, expert=2)}
    made = {}
    out = {}
    for role, key in spec.items():
        if key not in made:
            made[key] = make(key, shapes.get(key.removesuffix("_b")))
        out[role] = made[key]
    return out


@pytest.mark.parametrize("name", list(REFUSALS))
def test_validate_pp_mesh_refuses_like_jax(name):
    """``validate_pp_mesh`` raises JAX's ValueError, message for message
    (``tests/test_parallel.py:1864``, ``:1910``): PP with CP, distinct PP
    and TP meshes, int4 weights whose channels do not split into 2 x
    model, MoE under PP x TP, PP x TP x EP, distinct PP and EP meshes, a
    microbatch that does not split over the experts, a mesh without a
    stage axis, layers or the batch that do not divide."""
    import jax
    from jax.sharding import Mesh

    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.engine.engine import validate_pp_mesh as jvalidate
    from k8s_llm_rca_tpu_torch.engine.engine import validate_pp_mesh

    over, ecfg_over, spec, m, w4 = REFUSALS[name]
    devs = jax.devices("cpu")

    def jax_mesh(key, shape):
        if shape is None:
            return Mesh(np.array(devs[:2]), ("x",))
        mesh = _jax_mesh(**shape)
        if key.endswith("_b"):
            from k8s_llm_rca_tpu.config import MeshConfig
            from k8s_llm_rca_tpu.runtime.mesh import build_mesh

            cfg = MeshConfig(**shape)
            mesh = build_mesh(cfg, devices=devs[4:4 + cfg.n_devices])
        return mesh

    def port_mesh(key, shape):
        if shape is None:
            return types.SimpleNamespace(mesh_dim_names=("x",),
                                         mesh=torch.zeros(2))
        return _fake_mesh(**shape)

    errors = []
    for validate, cfg, ecfg, make in (
            (jvalidate, jconfig.TINY, jconfig.EngineConfig, jax_mesh),
            (validate_pp_mesh, config.TINY, config.EngineConfig, port_mesh)):
        meshes = _meshes(spec, make)
        params = None
        if w4:
            params = (_int4_tree() if make is port_mesh else
                      {"layers": [{"wq": _jax_tree(_int4_tree())[
                          "layers"][0]["wq"]}]})
        with pytest.raises(ValueError) as err:
            validate(meshes["pp"], cfg.replace(**{"n_layers": 4, **over}),
                     ecfg(**ecfg_over), meshes.get("cp"), meshes.get("ep"),
                     meshes.get("tp"), m, "stage", params=params)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# the engine-level PP refusals (the JAX engine's constructor arm), as
# EngineConfig overrides at stage 2, and the mesh that carries them
ENGINE_REFUSALS = {
    "prefix_cache_ep": (dict(prefix_cache=True), "ppep"),
    "chunk_budget": (dict(prefill_chunk_budget=16), "pp"),
    "spill": (dict(max_spilled_pages=4), "pp"),
    "tiers": (dict(prefix_cache=True, prefix_host_pages=4), "pp"),
}


@pytest.mark.parametrize("name", list(ENGINE_REFUSALS))
def test_pp_engine_refuses_like_jax(name):
    """The paged engine under ``pp_mesh`` refuses the prefix cache under
    PP x EP, chunked prefill, KV spill and the prefix store tiers with the
    JAX engine's ValueErrors, before it builds anything."""
    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    over, key = ENGINE_REFUSALS[name]
    moe = key == "ppep"
    base = dict(max_batch=4, max_seq_len=64, prefill_buckets=(16, 32),
                paged=True, page_size=16, num_pages=32, prefix_cache=False)
    ecfg = config.EngineConfig(**{**base, **over})
    cfg = (_tiny_moe() if moe else _tiny())
    shape = dict(stage=2, expert=2) if moe else dict(stage=2)
    port = _fake_mesh(**shape)
    meshes = {"pp_mesh": port, **({"ep_mesh": port} if moe else {})}
    with pytest.raises(ValueError) as mine:
        make_engine(cfg, ecfg, init_params(cfg, torch.Generator(), "cpu"),
                    get_tokenizer(vocab_size=512), "cpu", **meshes)
    jcfg = (jconfig.TINY_MOE.replace(n_layers=4, n_experts=4, max_seq_len=64)
            if moe else jconfig.TINY.replace(n_layers=4, max_seq_len=64))
    jmesh = _jax_mesh(**shape)
    with pytest.raises(ValueError) as theirs:
        # the refusals come before the constructor reads the params
        _jax_engine(jcfg, ecfg, None, pp_mesh=jmesh, use_kernel=False,
                    **({"ep_mesh": jmesh} if moe else {}))
    assert str(mine.value) == str(theirs.value)


def test_fsdp_with_pp_raises_jax_refusal():
    """fsdp x PP raises the PP arm of JAX's ``validate_fsdp_mesh`` on both
    engines (fsdp alone is served since the FSDP slice).  The contiguous
    engine's PP entry points run since the contiguous-mesh slice: on a
    1-rank group at M = 2, ``llama_pp_prefill``, ``llama_pp_decode_step``
    and ``llama_pp_decode_multi`` give the unsharded ``prefill_batch``,
    ``decode_step`` and ``decode_multi``'s logits (within 1e-5 of their
    largest: a microbatch's matmuls round otherwise than the whole
    batch's) and cache rows, and the whole-stack functions refuse a stage's
    config."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models import llama
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.parallel import pipeline
    from k8s_llm_rca_tpu_torch.runtime import mesh as rmesh
    from k8s_llm_rca_tpu_torch.runtime.sharding import rank_config
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = _tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for paged in (True, False):
        with pytest.raises(ValueError, match="fsdp×PP is unsupported"):
            make_engine(cfg, config.EngineConfig(paged=paged,
                                                 prefix_cache=False),
                        params, get_tokenizer(vocab_size=512), "cpu",
                        fsdp_mesh=_fake_mesh(fsdp=2),
                        pp_mesh=_fake_mesh(stage=2))
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(1, 512, (2, 16)))
    lens = torch.tensor([16, 9], dtype=torch.int32)
    slots = torch.tensor([1, 0])
    lengths = torch.tensor([9, 16], dtype=torch.int32)
    cur = torch.tensor([5, 6])
    multi = torch.from_numpy(rng.integers(1, 512, (2, 3)))
    assert rmesh.initialize_distributed(device="cpu")
    try:
        rcfg = rank_config(cfg, pp_mesh=rmesh.local_mesh(device="cpu"),
                           pp_microbatches=2, device="cpu")
        caches = [llama.init_cache(c, 2, 64, "int8", "cpu")
                  for c in (cfg, rcfg)]
        outs = []
        for c, cache in zip((cfg, rcfg), caches):
            pp = c is rcfg
            mod = pipeline if pp else llama
            _, a = (mod.llama_pp_prefill if pp else mod.prefill_batch)(
                c, params, cache, tokens, lens, slots)
            _, b = (mod.llama_pp_decode_step if pp else mod.decode_step)(
                c, params, cache, cur, lengths)
            got = (mod.llama_pp_decode_multi if pp else mod.decode_multi)(
                c, params, cache, multi, lengths + 1)
            outs.append((a, b, got[-1]))
        for want, got in zip(*outs):
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-5 * scale
        for f in range(4):
            assert (caches[1][f].float() - caches[0][f].float()).abs().max() \
                <= (1 if f < 2 else 1e-5)
        with pytest.raises(ValueError, match="llama_pp_decode_step"):
            llama.decode_step(rcfg, params, caches[1], cur, lengths)
    finally:
        rmesh.shutdown_distributed()


def _jax_engine(cfg, ecfg, params, **meshes):
    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.engine.paged import PagedInferenceEngine
    from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer

    jecfg = jconfig.EngineConfig(**{
        f: getattr(ecfg, f) for f in ecfg.__dataclass_fields__
        if f in jconfig.EngineConfig.__dataclass_fields__})
    return PagedInferenceEngine(cfg, jecfg, params,
                                get_tokenizer(vocab_size=512), **meshes)


@pytest.fixture(scope="module")
def jax_side(inputs):
    """What the JAX side can do before the ranks are needed, done while
    they run: the compiled chains of the pipelined functions
    (``_jax_chain``), and the JAX engines' greedy streams, the prefix-hit
    engine (stage 2, int8 pool: one prompt served twice) and the PP x TP
    engine (stage 2 x model 2, int4 weights over an int4 pool) at
    decode_chunk 4.  The latter's streams are the same at decode_chunk 1
    (``tests/test_parallel.py:1629`` holds both to its plain engine), so
    one JAX engine is the reference of both port cases.  The five jobs
    run on threads: XLA compiles with the interpreter lock released, so
    they overlap."""
    from k8s_llm_rca_tpu import config as jconfig

    tiny = jconfig.TINY.replace(n_layers=4, max_seq_len=64)

    def hit():
        (prompt,) = _encode([HIT_PROMPT])
        engine = _jax_engine(tiny, _hit_engine_config(),
                             _jax_tree(inputs["engine"]),
                             pp_mesh=_jax_mesh(stage=2), use_kernel=False)
        return _serve(engine, [prompt]) + _serve(engine, [prompt])

    def tp():
        mesh = _jax_mesh(stage=2, model=2)
        return _serve(_jax_engine(
            tiny.replace(fused_quant_matmul=True), _tp_engine_config(4),
            _jax_tree(inputs["tp_int4"]), pp_mesh=mesh, tp_mesh=mesh),
            _encode(TP_PROMPTS))

    with ThreadPoolExecutor(5) as pool:
        jobs = {"hit": pool.submit(hit), "tp": pool.submit(tp)}
        chains = {name: pool.submit(_jax_chain, name, inputs)
                  for name in FN_CASES}
        return {**{k: f.result() for k, f in jobs.items()},
                "chains": {k: f.result() for k, f in chains.items()}}


def test_pp_prefix_hit_engine_equals_jax(jax_side, ranks):
    """Stage 2 over an int8 pool with the prefix cache on
    (``tests/test_parallel.py:1460``): one prompt served twice, the second
    admission a hit through the pipelined chunk prefill; both ranks' streams
    equal JAX's ``PagedInferenceEngine(pp_mesh=...)``'s exactly, each rank
    holds 2 of the 4 layers and a pool of 2 layers; the collectives are the
    schedule's (ring steps M + P - 1 a prefill or decode step, P a chunk;
    one broadcast a forward)."""
    want = jax_side["hit"]
    assert len(set(want[0])) > 2, want
    for r in ranks[STAGE_RANKS]:
        got = r["hit_engine"]
        assert got["streams"] == want
        assert got["hit_tokens"] > 0
        assert got["layers"] == 2 and got["pool"][0] == 2
        c, n = got["collectives"], got["counts"]
        fwd = (n["engine.prefill_dispatches"] + n["engine.decode_steps"]
               + n["engine.chunk_prefill_dispatches"])
        assert n["engine.chunk_prefill_dispatches"] == 1
        assert c["all_reduce_sum"] == fwd
        assert c["ppermute"] == 3 * (fwd - 1) + 2
        assert c["all_gather"] == c["all_to_all"] == 0


def test_pp_grammar_scan_equals_stepwise(ranks):
    """A schema-constrained request at stage 2: the DFA riding inside the
    scanned tick (decode_chunk 8) emits the stepwise tick's text, on both
    ranks, and it parses (``tests/test_parallel.py``
    ``test_pp_engine_dfa_scan_parity``)."""
    import json

    texts = [r["grammar"] for r in ranks[STAGE_RANKS]]
    assert all(t == texts[0] for t in texts)
    assert texts[0][1] == texts[0][8]
    assert json.loads(texts[0][1])["kind"] in ("Pod", "Service", "Node")


@pytest.mark.parametrize("chunk", CHUNKS)
def test_pp_tp_int4_engine_equals_jax(chunk, jax_side, ranks):
    """Stage 2 x model 2, int4 weights over an int4 pool
    (``tests/test_parallel.py:1629``), five prompts through four slots, at
    decode_chunk 1 and 4: all four ranks' streams equal JAX's PP x TP
    engine's exactly; each rank holds 2 layers and a pool of 2 layers of
    its packed lanes; the collectives are the schedule's and the stage TP
    block's."""
    want = jax_side["tp"]
    assert all(len(set(s)) > 2 for s in want), want
    for r in ranks:
        got = r[f"tp_engine{chunk}"]
        assert got["streams"] == want
        assert got["layers"] == 2
        assert got["pool"] == (2, 32, 16, config.TINY.kv_dim // 4)
        c, n = got["collectives"], got["counts"]
        fwd = n["engine.prefill_dispatches"] + n["engine.decode_steps"]
        # one broadcast a forward; 2 sums a layer a microbatch (M = 2);
        # the int4 pool's row scales: 2 max a layer a microbatch of a
        # decode step, 2 a microbatch's write of a prefill
        assert c["all_reduce_sum"] == fwd + 2 * 2 * 2 * fwd
        steps, prefills = (n["engine.decode_steps"],
                           n["engine.prefill_dispatches"])
        assert c["all_reduce_max"] == 2 * 2 * (2 * steps + prefills)
        assert c["ppermute"] == 3 * fwd


@pytest.mark.parametrize("chunk", CHUNKS)
def test_pp_ep_engine_equals_dense(chunk, ranks):
    """Stage 2 x expert 2 on TINY_MOE with 4 layers and 4 experts
    (``tests/test_parallel.py:1676``): every rank's streams equal the port's
    dense engine's (held to JAX's in ``tests/test_torch_moe.py``), no token
    dropped, 2 experts and 2 layers a rank, the all-to-alls counted."""
    dense = ranks[0][f"ep_engine{chunk}"]["dense"]
    assert all(len(set(s)) > 2 for s in dense), dense
    for r in ranks:
        got = r[f"ep_engine{chunk}"]
        assert got["streams"] == dense
        assert got["dropped"] == 0
        assert got["experts"] == 2 and got["layers"] == 2
        c, n = got["collectives"], got["counts"]
        fwd = n["engine.prefill_dispatches"] + n["engine.decode_steps"]
        # a layer pass: 2 all-to-alls and 1 all-gather; 2 layers x M = 2
        assert c["all_to_all"] == 2 * c["all_gather"] == 2 * 2 * 2 * fwd
        assert c["ppermute"] == 3 * fwd and c["all_reduce_sum"] == fwd


@pytest.mark.parametrize("name", list(FN_CASES))
def test_pipelined_functions_equal_jax(name, inputs, jax_side, ranks):
    """``paged_pp_prefill``, ``paged_pp_decode_multi`` at T = 1 and T = 3 and
    ``paged_pp_prefill_chunk`` at stage 2 (x model 2 for the int4 case) on
    TINY with 4 layers, each from the same pool bytes as JAX's function:
    every rank holds 2 layers and returns the same logits; the logits and
    each stage's (and TP rank's) pool layers hold JAX's at the file's
    tolerances; the stage-only chains' pools equal the port's unsharded
    functions' byte for byte on each stage's layers."""
    from k8s_llm_rca_tpu_torch.engine.paged import init_paged_cache

    dtype, kv, w4, tp = FN_CASES[name]
    want = _jax_fn_outputs(name, jax_side["chains"][name], ranks)
    ranks = ranks if tp > 1 else ranks[STAGE_RANKS]
    assert all(r[name]["layers"] == 2 for r in ranks)
    for i, (logits, pool) in enumerate(want):
        got = [r[name]["steps"][i] for r in ranks]
        for g in got[1:]:
            assert torch.equal(g[0], got[0][0])
        scale = np.abs(logits).max()
        np.testing.assert_allclose(_f32(got[0][0]), logits, rtol=0,
                                   atol=TOL[dtype] * scale)
        for s in range(2):
            for t in range(tp):
                fields = got[_rank(s, t)][1]
                for f, (mine, ref) in enumerate(zip(fields, pool)):
                    ref = ref[2 * s:2 * s + 2]
                    if f < 2:
                        w = ref.shape[-1] // tp
                        ref = ref[..., t * w:(t + 1) * w]
                    mine = _f32(mine)
                    ref = ref.astype(np.float32)
                    if kv is None:
                        np.testing.assert_allclose(
                            mine, ref, rtol=0,
                            atol=TOL[dtype] * np.abs(ref).max())
                    elif f < 2 and kv == "int8":
                        assert np.abs(mine - ref).max() <= 1
                    elif f < 2:             # packed nibbles: each within 1
                        for sh in (0, 4):
                            lo = ((mine.astype(np.int8) << (4 - sh)) >> 4)
                            rl = ((ref.astype(np.int8) << (4 - sh)) >> 4)
                            assert np.abs(lo.astype(int)
                                          - rl.astype(int)).max() <= 1
                    else:
                        np.testing.assert_allclose(mine, ref, rtol=1e-4,
                                                   atol=1e-7)
    if tp > 1:
        return
    # the port unsharded on the same microbatches (one row each): each
    # stage's layers byte for byte
    cfg = _tiny(dtype=dtype)
    plain = init_paged_cache(cfg, N_PAGES, PAGE, "cpu", kv)
    for i, (step, args) in enumerate(_fn_steps()):
        rows = [slice(0, 1), slice(1, 2)] if step != "chunk" else [None]
        for r in rows:
            (_, fields), = _run_steps(cfg, inputs[name], plain, [(step, tuple(
                a[r] if r is not None and isinstance(a, np.ndarray) else a
                for a in args))])
        for s in range(2):
            for mine, ref in zip(ranks[s][name]["steps"][i][1], fields):
                assert torch.equal(mine, ref[2 * s:2 * s + 2]), (i, s)


def test_pipeline_apply_equals_jax(inputs, ranks):
    """The generic schedule at stage 2 over six microbatches, each rank
    its stage's (w, b) of tanh(x @ w + b), equals JAX's ``pipeline_apply``
    on every rank (fp32, atol 1e-5; ``tests/test_parallel.py:64``)."""
    import jax.numpy as jnp

    from k8s_llm_rca_tpu.parallel import pipeline_apply as jpipeline_apply

    w, b, x_mb = (jnp.asarray(t.numpy()) for t in inputs["schedule"])
    mesh = _jax_mesh(stage=2)
    want = np.asarray(_quick_jit(lambda p, x: jpipeline_apply(
        lambda q, h: jnp.tanh(h @ q["w"] + q["b"]), p, x, mesh))(
        {"w": w, "b": b}, x_mb))
    for r in ranks[STAGE_RANKS]:
        np.testing.assert_allclose(r["apply"].numpy(), want, rtol=0,
                                   atol=1e-5)


def test_llama_pipeline_forward_equals_jax(inputs, ranks):
    """The scoring forward at stage 2 and two microbatches, TINY with 4
    layers at the init's scales (fp32), equals JAX's
    ``llama_pipeline_forward`` on every rank at atol 1e-5
    (``tests/test_parallel.py:86``)."""
    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.parallel import llama_pipeline_forward as jforward

    import jax.numpy as jnp

    import jax

    cfg, mesh = jconfig.TINY.replace(n_layers=4, max_seq_len=64), \
        _jax_mesh(stage=2)
    want = np.asarray(_quick_jit(lambda p, t: jforward(
        cfg, p, t, mesh, microbatches=2))(
        _jax_tree(inputs["forward"]), jnp.asarray(inputs["tokens"].numpy())))
    for r in ranks[STAGE_RANKS]:
        np.testing.assert_allclose(r["forward"].numpy(), want, rtol=0,
                                   atol=1e-5)


def test_pp_rank_analytic_model_counts_its_stage():
    """Under PP a rank's config has its stage's layers, so the analytic
    model counts the stage's weights and KV plus the whole embedding and
    head the rank holds (JAX's arithmetic on a config of L/P layers), and
    the bubble fraction is (P - 1) / (M + P - 1)."""
    import dataclasses

    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.runtime import profiling as jprofiling
    from k8s_llm_rca_tpu_torch.runtime import profiling
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        PipelineParallel, RankModelConfig,
    )

    cfg = config.LLAMA3_8B
    rank = RankModelConfig(
        **{**{f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(config.ModelConfig)},
           "n_layers": cfg.n_layers // 2},
        pp=PipelineParallel(None, 2, 1, 2))
    stage = jconfig.LLAMA3_8B.replace(n_layers=cfg.n_layers // 2)
    assert profiling.decoder_param_count(rank) == \
        jprofiling.decoder_param_count(stage)
    assert profiling.decode_bytes_per_token(rank, 2048, 4, 4, 4) == \
        jprofiling.decode_bytes_per_token(stage, 2048, 4, 4, 4)
    assert [profiling.pp_bubble_fraction(p, m)
            for p, m in ((1, 2), (2, 2), (4, 4))] == [0.0, 1 / 3, 3 / 7]
