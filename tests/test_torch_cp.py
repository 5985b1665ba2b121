"""Context parallelism of the port against the JAX package's.

The port is SPMD: ring and Ulysses attention, the CP paged engine and its
CP x TP composition run as gloo ranks spawned by ``runtime.mesh.run_ranks``
(one spawn of two ranks and one of four for the whole module: fixtures),
and the JAX side runs in this process on the virtual CPU devices of
``tests/conftest.py`` (a 2-device ``seq`` mesh).  The ranks' bodies live in
this module, which imports no JAX at its top (a spawned rank never imports
JAX).  Also here: the plain paged functions' log-sum-exp (the decode
merge of a page-sharded pool), ``PartitionedPageAllocator`` and the CP
refusals.

Counterparts: ``tests/test_parallel.py`` (ring :40, Ulysses :79, the CP
paged engine :363 and its rejections :392) and ``tests/test_kernels.py``
(the paged kernels in interpret mode).
"""

import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu_torch import config
from k8s_llm_rca_tpu_torch.runtime import rules

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op.
torch.set_num_threads(1)

# the join timeout of the spawned ranks (a hung collective fails the
# fixture, not the window)
RANKS_TIMEOUT_S = 55.0

# the JAX test's CP paged engine setting (tests/test_parallel.py:363)
PROMPTS = ("pod sandbox changed restarting", "oom killed container")
MODES = ("ring", "ulysses")


def _engine_config(**kw):
    base = dict(max_batch=2, max_seq_len=64, paged=True, page_size=8,
                num_pages=32, prefill_buckets=(16, 32, 64), max_new_tokens=6,
                temperature=0.0, prefix_cache=False)
    return config.EngineConfig(**{**base, **kw})


# the refusals, as EngineConfig overrides (JAX's :392 and the CP arm of
# its paged constructor); each must raise JAX's ValueError at seq = 2
REFUSALS = {
    "prefix_cache": dict(prefix_cache=True),
    "must_divide": dict(page_size=5, prefill_buckets=(15,)),
    "host_overlap": dict(host_overlap=True),
    "chunk_budget": dict(prefill_chunk_budget=16),
    "spill": dict(max_spilled_pages=4),
    "tiers": dict(prefix_cache=True, prefix_host_pages=4),
    "pages_per_seq": dict(max_seq_len=56, prefill_buckets=(16, 32, 56)),
    "num_pages": dict(num_pages=33),
}


def _prompts():
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    tok = get_tokenizer(vocab_size=512)
    return tok, [tok.encode(t, add_bos=True) for t in PROMPTS]


def _tiny():
    return config.TINY.replace(max_seq_len=64)


# ---------------------------------------------------------------------------
# the ranks' side (no JAX here)
# ---------------------------------------------------------------------------


def _serve(engine, prompts):
    got = [r.token_ids for r in engine.generate([list(p) for p in prompts],
                                                max_new_tokens=6)]
    engine.allocator.check()
    return got


def _cp_ranks(rank, inputs):
    """Two ranks on one seq axis: the attention functions, both engine
    modes and the refusals."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.parallel.ring_attention import ring_attention
    from k8s_llm_rca_tpu_torch.parallel.ulysses import ulysses_attention
    from k8s_llm_rca_tpu_torch.runtime.mesh import (
        collective_counts, local_mesh, reset_collective_counts,
    )

    mesh = local_mesh(seq=2, device="cpu")
    q, k, v = inputs["qkv"]
    s = q.shape[1] // 2
    blk = slice(rank * s, (rank + 1) * s)
    out = {fn.__name__: fn(q[:, blk], k[:, blk], v[:, blk], mesh)
           for fn in (ring_attention, ulysses_attention)}
    tok, prompts = _prompts()
    for mode in MODES:
        reset_collective_counts()
        engine = make_engine(_tiny(), _engine_config(), inputs["tiny"], tok,
                             "cpu", cp_mesh=mesh, cp_mode=mode)
        out[mode] = {"tokens": _serve(engine, prompts),
                     "collectives": collective_counts(),
                     "pool_pages": engine.pool.k.shape[1],
                     "allocator": type(engine.allocator).__name__}
    errors = {}
    for name, kw in REFUSALS.items():
        try:
            make_engine(_tiny(), _engine_config(**kw), inputs["tiny"], tok,
                        "cpu", cp_mesh=mesh)
        except ValueError as err:
            errors[name] = str(err)
    out["errors"] = errors
    return out


def _cp_tp_ranks(rank, inputs):
    """Four ranks on one mesh of seq 2 x model 2 (CP x TP)."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.runtime.mesh import local_mesh
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params,
    )

    mesh = local_mesh(seq=2, model=2, device="cpu")
    cfg = _tiny()
    params = shard_params(inputs["tiny"], llama_param_specs(cfg), mesh)
    tok, prompts = _prompts()
    out = {}
    for mode in MODES:
        engine = make_engine(cfg, _engine_config(kv_cache_dtype="int8"),
                             params, tok, "cpu", tp_mesh=mesh, cp_mesh=mesh,
                             cp_mode=mode)
        out[mode] = {"tokens": _serve(engine, prompts),
                     "pool": tuple(engine.pool.k.shape)}
    return out


# ---------------------------------------------------------------------------
# the JAX side and the module's spawns
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


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    qkv = tuple(rng.standard_normal(shape).astype(np.float32)
                for shape in ((2, 32, 4, 16), (2, 32, 2, 16),
                              (2, 32, 2, 16)))
    return {"tiny": _numpy_params(_tiny(), 0), "qkv": qkv}


def _port(inputs):
    return {"tiny": rules.map_with_names(lambda _, a: torch.from_numpy(a),
                                         inputs["tiny"]),
            "qkv": tuple(torch.from_numpy(a) for a in inputs["qkv"])}


@pytest.fixture(scope="module")
def cp_ranks(inputs, tmp_path_factory):
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks

    return run_ranks(_cp_ranks, 2, str(tmp_path_factory.mktemp("cp")),
                     args=(_port(inputs),), timeout_s=RANKS_TIMEOUT_S)


@pytest.fixture(scope="module")
def cp_tp_ranks(inputs, tmp_path_factory):
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks

    return run_ranks(_cp_tp_ranks, 4, str(tmp_path_factory.mktemp("cptp")),
                     args=(_port(inputs),), timeout_s=RANKS_TIMEOUT_S)


@pytest.fixture(scope="module")
def jax_seq_mesh():
    import jax

    from k8s_llm_rca_tpu.config import MeshConfig
    from k8s_llm_rca_tpu.runtime.mesh import build_mesh

    return build_mesh(MeshConfig(seq=2), devices=jax.devices("cpu")[:2])


def _jax_engine(mesh, params, ecfg, mode):
    import jax.numpy as jnp

    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.engine.paged import PagedInferenceEngine
    from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer

    import jax

    jecfg = jconfig.EngineConfig(**{
        f: getattr(ecfg, f) for f in ecfg.__dataclass_fields__
        if f in jconfig.EngineConfig.__dataclass_fields__})
    return PagedInferenceEngine(
        jconfig.TINY.replace(max_seq_len=64), jecfg,
        jax.tree.map(jnp.asarray, params), get_tokenizer(vocab_size=512),
        cp_mesh=mesh, cp_mode=mode)


@pytest.fixture(scope="module")
def jax_tokens(inputs, jax_seq_mesh):
    """The JAX CP engine's greedy tokens, ring and Ulysses (the module's
    two port-vs-JAX engine cases)."""
    _, prompts = _prompts()
    out = {}
    for mode in MODES:
        engine = _jax_engine(jax_seq_mesh, inputs["tiny"], _engine_config(),
                             mode)
        out[mode] = [r.token_ids for r in engine.generate(
            [list(p) for p in prompts], max_new_tokens=6)]
        engine.allocator.check()
    return out


@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention"])
def test_cp_attention_equals_jax(fn, cp_ranks, inputs, jax_seq_mesh):
    """Each rank's block of ring / Ulysses attention at 2 gloo ranks equals
    JAX's on a 2-device seq mesh (fp32, atol 1e-5)."""
    import jax.numpy as jnp

    from k8s_llm_rca_tpu.parallel.ring_attention import ring_attention
    from k8s_llm_rca_tpu.parallel.ulysses import ulysses_attention

    ref_fn = (ring_attention if fn == "ring_attention"
              else ulysses_attention)
    ref = np.asarray(ref_fn(*(jnp.asarray(a) for a in inputs["qkv"]),
                            jax_seq_mesh))
    got = torch.cat([r[fn] for r in cp_ranks], dim=1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_cp_engine_streams_equal_jax(mode, cp_ranks, jax_tokens):
    """The CP paged engine at 2 gloo ranks emits the JAX CP engine's greedy
    tokens on both ranks; the partitioned allocator's invariants hold
    after serving (checked in the ranks); the sequence crosses into the
    second rank's page range, so the decode merge runs over both."""
    want = jax_tokens[mode]
    _, prompts = _prompts()
    assert len(prompts[0]) + len(want[0]) > 32       # past rank 0's range
    for r in cp_ranks:
        assert r[mode]["tokens"] == want
        assert r[mode]["allocator"] == "PartitionedPageAllocator"
        assert r[mode]["pool_pages"] == 32 // 2 + 1   # partition + sink
        c = r[mode]["collectives"]
        assert c["all_gather"] > 0
        assert (c["ppermute"] > 0) == (mode == "ring")
        assert (c["all_to_all"] > 0) == (mode == "ulysses")


@pytest.mark.parametrize("mode", MODES)
def test_cp_tp_engine_streams_equal_jax(mode, cp_tp_ranks, jax_tokens):
    """CP x TP on one mesh (seq 2 x model 2, int8 pool): every rank emits
    the JAX CP engine's tokens; the pool is sharded on pages over seq and
    on lanes over model."""
    for r in cp_tp_ranks:
        assert r[mode]["tokens"] == jax_tokens[mode]
        assert r[mode]["pool"] == (config.TINY.n_layers, 32 // 2 + 1, 8,
                                   config.TINY.kv_dim // 2)


def test_cp_refusals_like_jax(cp_ranks, inputs, jax_seq_mesh):
    """Each refused CP setting raises the JAX CP engine's ValueError, with
    its message, on both ranks."""
    for name, kw in REFUSALS.items():
        with pytest.raises(ValueError) as err:
            _jax_engine(jax_seq_mesh, inputs["tiny"], _engine_config(**kw),
                        "ring")
        for r in cp_ranks:
            assert r["errors"][name] == str(err.value), name


def _paged_inputs(seed, quant=None):
    """A batch of 4 over a 6-page table (two CP halves of 3 pages): one
    sequence inside the first half (the second rank's range is empty), one
    ending on the boundary, two reaching into the second half."""
    from k8s_llm_rca_tpu_torch.models.quant import quantize_kv

    rng = np.random.default_rng(seed)
    b, h, n_kv, d, page, n_pages, pps = 4, 8, 2, 32, 8, 30, 6
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pages, page, n_kv * d)).astype(np.float32)) for _ in range(2))
    ids = rng.permutation(np.arange(1, n_pages))[:b * pps]
    tables = torch.from_numpy(ids.reshape(b, pps).astype(np.int32))
    lengths = torch.tensor([5, 24, 25, 48], dtype=torch.int32)
    if quant is None:
        return q, (kp, vp), lengths, tables
    (kq, ks), (vq, vs) = (quantize_kv(t, quant == "int4") for t in (kp, vp))
    return q, (kq, vq, ks.float(), vs.float()), lengths, tables


@pytest.mark.parametrize("pool", [None, "int8", "int4"])
def test_plain_paged_lse_merge_equals_unsplit_and_jax(pool):
    """The plain paged functions with ``return_lse`` over the two halves of
    each table (a CP-2 rank's share: its columns, its clamped lengths),
    merged by ``merge_partials``, equal the unsplit call and JAX's Pallas
    kernel in interpret mode (fp32, atol 1e-5); a rank with no position
    gives lse -1e30 and a zero output."""
    import jax.numpy as jnp

    from k8s_llm_rca_tpu.ops import paged_attention as jpa
    from k8s_llm_rca_tpu_torch.ops.paged_attention import (
        merge_partials, paged_attention, paged_attention_quant,
    )

    q, pages, lengths, tables = _paged_inputs(3, pool)
    if pool is None:
        def call(lens, tabs, **kw):
            return paged_attention(q, *pages, lens, tabs, **kw)

        ref = jpa.paged_attention(*(jnp.asarray(t.numpy()) for t in (
            q, *pages, lengths, tables)))
    else:
        packed = pool == "int4"

        def call(lens, tabs, **kw):
            return paged_attention_quant(q, *pages, lens, tabs,
                                         packed=packed, **kw)

        ref = jpa.paged_attention_quant(
            *(jnp.asarray(t.numpy()) for t in (q, *pages, lengths, tables)),
            packed=packed)
    whole = call(lengths, tables)
    span = 3 * 8
    outs, lses = zip(*(call((lengths - p * span).clamp(0, span).int(),
                            tables[:, 3 * p:3 * p + 3].contiguous(),
                            return_lse=True) for p in range(2)))
    assert torch.all(lses[1][0] == -1e30) and torch.all(outs[1][0] == 0)
    merged = merge_partials(torch.stack(outs), torch.stack(lses))
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(merged.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    # one part merges to itself exactly (the 1-rank mesh's decode)
    out1, lse1 = call(lengths, tables, return_lse=True)
    assert torch.equal(merge_partials(out1[None], lse1[None]), out1)


def test_partitioned_allocator_keeps_jax_invariants():
    """The same calls on the port's and JAX's ``PartitionedPageAllocator``
    give the same pages, free counts and errors; ``check`` holds after
    each step and catches a page pushed into the wrong partition."""
    from k8s_llm_rca_tpu.engine import paged as jpaged
    from k8s_llm_rca_tpu_torch.engine import paged

    allocs = (paged.PartitionedPageAllocator(32, 2),
              jpaged.PartitionedPageAllocator(32, 2))
    trace = []
    for a, mod in zip(allocs, (paged, jpaged)):
        steps = [a.alloc(3, owner=1, part=0), a.alloc(2, owner=1, part=1),
                 a.alloc(14, owner=2, part=1)]
        a.check()
        try:
            a.alloc(1, owner=3, part=1)
        except mod.OutOfPages as err:
            steps.append(str(err))
        a.free(steps[0][:2], owner=1)
        steps += [a.n_free, [a.part_of(p) for p in (0, 15, 16, 31)]]
        for bad in (lambda: a.free(steps[0][:1], owner=1),       # double
                    lambda: a.free(steps[1][:1], owner=2),       # foreign
                    lambda: a.free([0], owner=1)):               # trash
            try:
                bad()
            except mod.AllocatorError as err:
                steps.append(str(err))
        a.check()
        a._free_parts[1].append(a._free_parts[0].pop())
        try:
            a.check()
        except mod.AllocatorError as err:
            steps.append(str(err).split(" (")[0])
        trace.append(steps)
    assert trace[0] == trace[1] and len(trace[0]) == 10
    with pytest.raises(ValueError, match="not divisible into 3"):
        paged.PartitionedPageAllocator(32, 3)
