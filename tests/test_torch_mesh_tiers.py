"""The memory tiers, snapshots and the overlapped loop of the port under a
device mesh, against the JAX package's plain unsharded paged engine.

The port is SPMD: every rank runs the engine's host loop on its shard, so
a preemption spills the same sequence at the same tick on every rank
(each rank its own share of the pool), the prefix store's host tier holds
the rank's share, and its disk tier holds whole pages in JAX's layout,
written by one rank (``engine/prefix.py::MeshTier``).  The ranks run over
gloo through ``runtime.mesh.run_ranks``: one spawn of two for the whole
module, started in the background when the module starts, on the meshes
model 2 (TP), expert 2 (EP), fsdp 2 and stage 2 (PP).  The JAX side runs
in this process meanwhile.  The ranks' bodies live in this module, which
imports no JAX at its top.  Weights come from numpy seeds (the same
arrays on both sides; int4 the port's quantization, byte for byte JAX's).

The tier engine (TINY, page 8, 10 pages, the prefix cache on, a spill
budget, the disk tier alone) serves three prompts that share a preamble
cold (two at a time, so growth preempts and spills), demotes every
resident page with ``evict(10**6)`` and serves them again from the
promoted pages.  Every case's streams are JAX's plain unsharded engine's
with the same knobs: its paged engine without kernels, and its contiguous
engine for the contiguous engine's ``host_overlap``.  Counterparts:
``tests/test_torch_tiers.py`` and ``tests/test_torch_spill.py`` (the
unsharded port against JAX).
"""

import copy
import os
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

MESHES = {"tp": dict(model=2), "ep": dict(expert=2), "fsdp": dict(fsdp=2),
          "pp": dict(stage=2)}
_PRE = "shared rca preamble "
PROMPTS = (_PRE + "pod oom", _PRE + "etcd lost", _PRE + "pvc wait")
NEW_TOKENS = 16
# the overlapped-loop and snapshot cases: two prompts, stepwise
OVERLAP_PROMPTS = ("node notready on node-3", "pvc not bound")
OVERLAP_TOKENS = 8
SNAPSHOT_TICKS = 3
TIER_COUNTERS = ("engine.spilled_pages", "engine.restored_pages",
                 "engine.prefix_demotions", "engine.prefix_hits_l1",
                 "engine.prefix_hits_l2", "engine.prefix_promoted_pages")


def _tiny(tree="fp32"):
    cfg = config.TINY_MOE if tree == "moe" else config.TINY
    return cfg.replace(max_seq_len=64, fused_quant_matmul=tree == "int4")


def _tier_config(kv=None, **over):
    """Two slots, 10 pages of 8 tokens: two sequences growing to ~45
    tokens need more pages than the pool has, so growth preempts (and
    spills) one of them."""
    base = dict(max_batch=2, max_seq_len=64, prefill_buckets=(32, 64),
                max_new_tokens=NEW_TOKENS, temperature=0.0, paged=True,
                page_size=8, num_pages=10, prefix_cache=True,
                kv_cache_dtype=kv, decode_chunk=1, max_spilled_pages=16,
                prefix_host_pages=0)
    base.update(over)
    return config.EngineConfig(**base)


def _overlap_config(paged=True, overlap=False):
    return config.EngineConfig(
        max_batch=2, max_seq_len=64, prefill_buckets=(32,),
        max_new_tokens=OVERLAP_TOKENS, temperature=0.0, paged=paged,
        page_size=8, num_pages=24, prefix_cache=False, decode_chunk=1,
        host_overlap=overlap)


def _encode(texts):
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    tok = get_tokenizer(vocab_size=512)
    return [tok.encode(t, add_bos=True) for t in texts]


# ---------------------------------------------------------------------------
# the ranks' side (no JAX here)
# ---------------------------------------------------------------------------


def _run(engine, prompts, n=NEW_TOKENS):
    out = [r.token_ids for r in engine.generate([list(p) for p in prompts],
                                                max_new_tokens=n)]
    engine.allocator.check()
    return out


def _tiers(engine, what):
    return {k: int(engine._counts.get(k, 0)) for k in what}


def _watch_restores(engine):
    """Wrap the engine's spill resume: every restore's pages, gathered from
    the pool right after it, must equal the spilled record byte for
    byte.  Returns the list of verdicts it appends to."""
    from k8s_llm_rca_tpu_torch.utils.pages import gather_pages, pool_fields

    verdicts = []
    admit = engine._admit_spilled

    def watched(req):
        rec = engine._spilled[req.seq_id]
        n, shared = int(rec["n_pages"]), int(rec["n_shared"])
        admit(req)
        slot = next(s for s, st in engine._active.items()
                    if st.seq_id == req.seq_id)
        pages = [int(p) for p in engine.block_tables[slot][shared:
                                                          shared + n]]
        back = gather_pages(engine.pool, lambda *t: t, pages)
        verdicts.append(all(torch.equal(back[f], rec[f])
                            for f in pool_fields(engine.pool)))

    engine._admit_spilled = watched
    return verdicts


def _watch_demotes(engine):
    """Wrap the prefix cache's demote hook: each demoted page's record as
    this rank gathered it (its share), by the hex digest its file is
    named after."""
    shares = {}
    demote = engine.prefix_cache._demote

    def watched(pages):
        recs = demote(pages)
        for page, rec in zip(pages, recs):
            key = engine.prefix_cache._key_of[page].hex()
            shares[key] = {f: v.clone() for f, v in rec.items()
                           if f != "n_pages"}
        return recs

    engine.prefix_cache._demote = watched
    return shares


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(".page")}


def _tp_tiers(inputs, mesh, rank, workdir, tree, kv):
    """TP 2 with spill and the disk tier: the cold run (spilling) and the
    demotion of every page into this case's directory, then a fresh TP 2
    engine promoting from the files the unsharded engine wrote and a fresh
    unsharded engine promoting from the TP engine's files."""
    import torch.distributed as dist

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, tok = _tiny(tree), get_tokenizer(vocab_size=512)
    prompts = _encode(PROMPTS)
    u_dir = os.path.join(workdir, f"unsharded-{tree}")
    tp_dir = os.path.join(workdir, f"tp-{tree}")
    shard = shard_params(inputs[tree], llama_param_specs(cfg), mesh)
    out = {}
    if rank == 0:
        eng = make_engine(cfg, _tier_config(kv, prefix_disk_dir=u_dir),
                          inputs[tree], tok, "cpu")
        _run(eng, prompts)
        eng.prefix_cache.evict(10 ** 6)
    eng = make_engine(cfg, _tier_config(kv, prefix_disk_dir=tp_dir), shard,
                      tok, "cpu", tp_mesh=mesh)
    restores = _watch_restores(eng)
    out["shares"] = _watch_demotes(eng)
    out["cold"] = _run(eng, prompts)
    out["restores"] = restores
    out["demoted"] = eng.prefix_cache.evict(10 ** 6)
    out["counts"] = _tiers(eng, TIER_COUNTERS)
    out["pool_lanes"] = eng.pool.k.shape[-1]
    dist.barrier()
    out["files"] = _files(tp_dir)
    eng = make_engine(cfg, _tier_config(kv, prefix_disk_dir=u_dir), shard,
                      tok, "cpu", tp_mesh=mesh)
    out["warm_from_unsharded"] = _run(eng, prompts)
    out["warm_counts"] = _tiers(eng, TIER_COUNTERS)
    if rank == 0:
        eng = make_engine(cfg, _tier_config(kv, prefix_disk_dir=tp_dir),
                          inputs[tree], tok, "cpu")
        out["unsharded_from_tp"] = _run(eng, prompts)
        out["unsharded_counts"] = _tiers(eng, TIER_COUNTERS)
    dist.barrier()
    return out


def _l1_case(inputs, mesh, tree, kw_name):
    """EP 2 or FSDP 2 with spill and the host tier: the cold run, every
    page demoted to L1, the warm run."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, tok = _tiny(tree), get_tokenizer(vocab_size=512)
    prompts = _encode(PROMPTS)
    ecfg = _tier_config(prefix_host_pages=32)
    layout = FSDP_LAYOUT if kw_name == "fsdp_mesh" else None
    shard = shard_params(inputs[tree], llama_param_specs(cfg, layout), mesh)

    eng = make_engine(cfg, ecfg, shard, tok, "cpu", **{kw_name: mesh})
    restores = _watch_restores(eng)
    cold = _run(eng, prompts)
    eng.prefix_cache.evict(10 ** 6)
    warm = _run(eng, prompts)
    return {"cold": cold, "warm": warm, "restores": restores,
            "counts": _tiers(eng, TIER_COUNTERS)}


def _overlap_case(inputs, mesh, kw_name):
    """``host_overlap`` on and off on both engines under TP 2 or PP 2."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params, shard_stage_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, tok = _tiny(), get_tokenizer(vocab_size=512)
    prompts = _encode(OVERLAP_PROMPTS)
    kw = {kw_name: mesh}
    if kw_name == "pp_mesh":
        shard = shard_stage_params(inputs["fp32"], cfg, mesh)
        kw["pp_microbatches"] = 2
    else:
        shard = shard_params(inputs["fp32"], llama_param_specs(cfg), mesh)
    out = {}
    for paged in (True, False):
        for overlap in (False, True):
            eng = make_engine(cfg, _overlap_config(paged, overlap), shard,
                              tok, "cpu", **kw)
            out[(paged, overlap)] = {
                "streams": [r.token_ids for r in eng.generate(
                    prompts, max_new_tokens=OVERLAP_TOKENS)],
                "syncs": int(eng._counts.get("engine.d2h_syncs", 0))}
    return out


def _finish(engine):
    done = {}
    while engine.has_work:
        for r in engine.step():
            done[r.seq_id] = r.token_ids
    return [done[s] for s in sorted(done)]


def _snapshot_case(inputs, mesh):
    """A snapshot under TP 2 after a few ticks, restored into a fresh
    unsharded engine; and an unsharded engine's snapshot restored into a
    fresh TP 2 engine."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        llama_param_specs, shard_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, tok = _tiny(), get_tokenizer(vocab_size=512)
    ecfg = _overlap_config()
    shard = shard_params(inputs["fp32"], llama_param_specs(cfg), mesh)
    out = {}
    for name, src, dst in (("tp_to_unsharded", shard, inputs["fp32"]),
                           ("unsharded_to_tp", inputs["fp32"], shard)):
        kw_src = {"tp_mesh": mesh} if src is shard else {}
        kw_dst = {"tp_mesh": mesh} if dst is shard else {}
        eng = make_engine(cfg, ecfg, src, tok, "cpu", **kw_src)
        for p in _encode(OVERLAP_PROMPTS):
            eng.submit(p, max_new_tokens=OVERLAP_TOKENS)
        for _ in range(SNAPSHOT_TICKS):
            eng.step()
        snap = eng.snapshot_sequences()
        fresh = make_engine(cfg, ecfg, dst, tok, "cpu", **kw_dst)
        fresh.restore_sequences(snap)
        out[name] = {"snapshot": snap, "streams": _finish(fresh)}
    return out


def _ranks(rank, inputs, workdir):
    """Everything the module checks on its two ranks, in one spawn."""
    from k8s_llm_rca_tpu_torch.runtime.mesh import local_mesh

    meshes = {k: local_mesh(device="cpu", **axes)
              for k, axes in MESHES.items()}
    return {
        "tp_fp32": _tp_tiers(inputs, meshes["tp"], rank, workdir, "fp32",
                             None),
        "tp_int4": _tp_tiers(inputs, meshes["tp"], rank, workdir, "int4",
                             "int4"),
        "ep": _l1_case(inputs, meshes["ep"], "moe", "ep_mesh"),
        "fsdp": _l1_case(inputs, meshes["fsdp"], "fp32", "fsdp_mesh"),
        "overlap_tp": _overlap_case(inputs, meshes["tp"], "tp_mesh"),
        "overlap_pp": _overlap_case(inputs, meshes["pp"], "pp_mesh"),
        "snapshot": _snapshot_case(inputs, meshes["tp"]),
    }


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
    """The port's trees: TINY fp32 and int4 (the port's quantization),
    TINY_MOE fp32."""
    tiny = _torch_tree(_numpy_params(config.TINY, 0))
    return {"fp32": tiny,
            "int4": quant.quantize_params(tiny, torch.float32, bits=4),
            "moe": _torch_tree(_numpy_params(config.TINY_MOE, 2))}


@pytest.fixture(scope="module", autouse=True)
def spawned(inputs, tmp_path_factory):
    """The module's one spawn of two ranks, started in the background when
    the module starts: the JAX side runs meanwhile."""
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks

    workdir = str(tmp_path_factory.mktemp("mesh_tiers"))
    # the ranks get a copy: a tensor handed to a spawned process moves to
    # shared memory, which a JAX array made from it would go on reading
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, _ranks, 2, workdir,
                          args=(copy.deepcopy(inputs), workdir),
                          timeout_s=RANKS_TIMEOUT_S)


@pytest.fixture(scope="module")
def ranks(spawned, jax_side):
    """The ranks' results; JAX's side first, while they run."""
    return spawned.result()


def _jax_tree(tree):
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


def _jax_engine(cfg, ecfg, params):
    """JAX's plain unsharded engine: the paged engine without its kernels,
    or (``ecfg.paged`` off) the contiguous engine."""
    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.engine.engine import InferenceEngine
    from k8s_llm_rca_tpu.engine.paged import PagedInferenceEngine
    from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer

    jcfg = jconfig.ModelConfig(**{f: getattr(cfg, f)
                                  for f in cfg.__dataclass_fields__})
    jecfg = jconfig.EngineConfig(**{
        f: getattr(ecfg, f) for f in ecfg.__dataclass_fields__
        if f in jconfig.EngineConfig.__dataclass_fields__})
    tok = get_tokenizer(vocab_size=512)
    if not ecfg.paged:
        return InferenceEngine(jcfg, jecfg, params, tok)
    return PagedInferenceEngine(jcfg, jecfg, params, tok, use_kernel=False)


@pytest.fixture(scope="module")
def jax_side(inputs, tmp_path_factory):
    """JAX's plain unsharded engines, on threads while the ranks run.  The
    tier engine: the cold run's streams and counters, the ``.page`` files
    every resident page demotes to (the disk tier: fp32, and int4 weights
    over an int4 pool) or the host tier (TINY_MOE), and the warm run's
    streams.  The overlap prompts' streams on the paged and the
    contiguous engine."""
    root = tmp_path_factory.mktemp("jax_tiers")

    def serve(tree, kv):
        d = None if tree == "moe" else str(root / tree)
        ecfg = (_tier_config(prefix_host_pages=32) if d is None
                else _tier_config(kv, prefix_disk_dir=d))
        eng = _jax_engine(_tiny(tree), ecfg, _jax_tree(inputs[tree]))
        cold = _run(eng, _encode(PROMPTS))
        counts = {k: int(eng._counts.get(k, 0)) for k in TIER_COUNTERS}
        eng.prefix_cache.evict(10 ** 6)
        files = {} if d is None else _files(d)
        return {"cold": cold, "counts": counts, "files": files,
                "warm": _run(eng, _encode(PROMPTS))}

    def overlap(paged):
        eng = _jax_engine(_tiny(), _overlap_config(paged),
                          _jax_tree(inputs["fp32"]))
        return [r.token_ids for r in eng.generate(
            _encode(OVERLAP_PROMPTS), max_new_tokens=OVERLAP_TOKENS)]

    with ThreadPoolExecutor(3) as pool:
        jobs = {"fp32": pool.submit(serve, "fp32", None),
                "int4": pool.submit(serve, "int4", "int4"),
                "moe": pool.submit(serve, "moe", None),
                "overlap_paged": pool.submit(overlap, True),
                "overlap_contiguous": pool.submit(overlap, False)}
        return {k: f.result() for k, f in jobs.items()}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree", ["fp32", "int4"])
def test_tp_spill_streams_equal_jax_and_restores_are_byte_equal(
        tree, jax_side, ranks):
    """TP 2 (fp32; int4 weights over an int4 pool) with a spill budget:
    growth preempts and spills on every rank alike, each rank's restored
    pages equal what it spilled byte for byte, and the streams equal JAX's
    plain unsharded engine's with the same knobs (which spills too)."""
    want = jax_side[tree]
    assert all(len(set(s)) > 2 for s in want["cold"]), want["cold"]
    assert want["counts"]["engine.spilled_pages"] > 0
    lanes = config.TINY.kv_dim // 2
    for r in ranks:
        got = r[f"tp_{tree}"]
        assert got["cold"] == want["cold"]
        assert got["restores"] and all(got["restores"])
        c = got["counts"]
        assert c["engine.spilled_pages"] \
            == want["counts"]["engine.spilled_pages"]
        assert c["engine.restored_pages"] \
            == want["counts"]["engine.restored_pages"]
        assert got["pool_lanes"] == (lanes // 2 if tree == "int4" else lanes)
    assert ranks[0][f"tp_{tree}"]["counts"] == ranks[1][f"tp_{tree}"]["counts"]


def _jax_whole_page(shares, packed):
    """Two TP ranks' shares of one page joined in the test by JAX's own
    nibble packing (k and v along the lanes, rank 0 first; the scales are
    the full row's on both ranks): the record JAX's unsharded pool holds
    for those values."""
    import jax.numpy as jnp

    from k8s_llm_rca_tpu.models import quant as jquant

    rec = {"n_pages": 1}
    for f, mine in shares[0].items():
        parts = [np.asarray(r[f].numpy()) for r in shares]
        if f in ("k", "v"):
            if packed:
                lanes = [np.asarray(jquant._unpack_nibbles(jnp.asarray(p)))
                         for p in parts]
                rec[f] = np.asarray(jquant._pack_nibbles(
                    jnp.asarray(np.concatenate(lanes, axis=-1))))
            else:
                rec[f] = np.concatenate(parts, axis=-1)
        else:
            assert all(np.array_equal(parts[0], p) for p in parts)
            rec[f] = parts[0]
    return rec


@pytest.mark.parametrize("tree", ["fp32", "int4"])
def test_tp_page_files_are_jax_bytes_and_promote_both_ways(
        tree, jax_side, ranks):
    """TP 2: the disk tier holds whole pages in JAX's layout.  Every
    ``.page`` file is byte for byte what JAX's encoder writes for the page
    joined from the two ranks' shares by JAX's own packing (int4: the
    per-rank split-half lanes re-packed over all lanes), written once, for
    the same set of pages (the same chained digests) as JAX's unsharded
    engine demotes for the same prompts, with JAX's fields, dtypes and
    shapes.  The values equal that engine's files within fp32 rounding
    (the two packages' matmuls round the last bits differently, the
    port's unsharded engine too), and an int4 page's nibbles exactly.  A
    fresh unsharded port engine promotes the files with JAX's warm
    streams, and a fresh TP 2 engine promotes the unsharded engine's
    files with the same streams."""
    from k8s_llm_rca_tpu.utils import pages as jpages

    want = jax_side[tree]
    assert want["files"]
    got = [r[f"tp_{tree}"] for r in ranks]
    assert got[0]["files"] == got[1]["files"]
    files = got[0]["files"]
    assert sorted(files) == sorted(want["files"])
    for name, data in files.items():
        key = name[:-len(".page")]
        rec = _jax_whole_page([g["shares"][key] for g in got],
                              tree == "int4")
        assert data == jpages.encode_page_record(rec), name
        mine = jpages.decode_page_record(data)
        theirs = jpages.decode_page_record(want["files"][name])
        assert sorted(mine) == sorted(theirs)
        for f in ("k", "v", "k_scale", "v_scale"):
            if f not in theirs:
                continue
            assert mine[f].dtype == theirs[f].dtype
            assert mine[f].shape == theirs[f].shape
            if mine[f].dtype == np.int8:
                assert np.array_equal(mine[f], theirs[f]), (name, f)
            else:
                np.testing.assert_allclose(mine[f], theirs[f], rtol=1e-4,
                                           atol=1e-4)
    for g in got:
        assert g["demoted"] > 0
        assert g["warm_from_unsharded"] == want["warm"]
        assert g["warm_counts"]["engine.prefix_hits_l2"] > 0
    assert got[0]["unsharded_from_tp"] == want["warm"]
    assert got[0]["unsharded_counts"]["engine.prefix_hits_l2"] > 0
    if tree == "fp32":
        # over an int4 pool a hit attends over the dequantized pages, the
        # cold prefill over the unquantized K/V: the streams may part
        assert want["warm"] == want["cold"]


@pytest.mark.parametrize("name", ["ep", "fsdp"])
def test_ep_and_fsdp_spill_and_l1_hit_equal_the_unsharded_engine(
        name, jax_side, ranks):
    """EP 2 (TINY_MOE) and FSDP 2 (TINY) with spill and the host tier:
    every rank spills, restores byte for byte, demotes to L1 and promotes
    from it, with the streams and the spill counts of JAX's plain
    unsharded engine (TINY_MOE with the host tier under EP; the TINY fp32
    tier engine, which spills alike, under FSDP)."""
    ref = jax_side["moe" if name == "ep" else "fp32"]
    spilled = ref["counts"]["engine.spilled_pages"]
    assert all(len(set(s)) > 2 for s in ref["cold"]), ref["cold"]
    for r in ranks:
        got = r[name]
        assert got["cold"] == ref["cold"]
        assert got["warm"] == ref["warm"] == ref["cold"]
        assert got["restores"] and all(got["restores"])
        assert got["counts"]["engine.spilled_pages"] == spilled > 0
        assert got["counts"]["engine.restored_pages"] == spilled
        assert got["counts"]["engine.prefix_hits_l1"] > 0
    assert ranks[0][name]["counts"] == ranks[1][name]["counts"]


@pytest.mark.parametrize("mesh", ["tp", "pp"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_host_overlap_under_a_mesh_keeps_the_streams(mesh, paged, jax_side,
                                                   ranks):
    """``host_overlap`` under TP 2 and PP 2, on the paged and the
    contiguous engine: the streams of JAX's plain unsharded engine of the
    same kind, with and without ``host_overlap``, the overlapped loop with
    fewer host syncs, on both ranks alike."""
    want = jax_side["overlap_paged" if paged else "overlap_contiguous"]
    assert all(len(set(s)) > 2 for s in want), want
    for r in ranks:
        got = r[f"overlap_{mesh}"]
        plain, lagged = got[(paged, False)], got[(paged, True)]
        assert plain["streams"] == want
        assert lagged["streams"] == want
        assert lagged["syncs"] < plain["syncs"]
    assert ranks[0][f"overlap_{mesh}"] == ranks[1][f"overlap_{mesh}"]


@pytest.mark.parametrize("case", ["tp_to_unsharded", "unsharded_to_tp"])
def test_snapshot_under_tp_is_equal_on_both_ranks_and_restores(
        case, jax_side, ranks):
    """A snapshot taken under TP 2 mid-decode is the same on both ranks and
    restores into a fresh unsharded engine to the uninterrupted stream
    (JAX's plain unsharded paged engine's); an unsharded engine's
    snapshot restores into a fresh TP 2 engine alike."""
    whole = jax_side["overlap_paged"]
    a, b = (r["snapshot"][case] for r in ranks)
    assert a["snapshot"] == b["snapshot"]
    assert any(s["generated"] for s in a["snapshot"]["sequences"])
    assert a["streams"] == b["streams"] == whole
