"""Speculative decoding of the port under a device mesh, against the JAX
package's speculative engines.

The port is SPMD: every rank runs the engine's host loop on its shard, so
every rank drafts and verifies at the same tick.  n-gram drafts are a
function of the committed tokens, equal on every rank; a draft model runs
whole on every rank and the mesh's lowest rank broadcasts its drafts
(``engine/speculative.py::DraftAgreement``).  The verify step is the
multi-token decode of the rank's shard: TP's sums, EP's all-to-alls,
FSDP's gathers, PP's pipelined ``paged_pp_decode_multi`` /
``llama_pp_decode_multi`` and, under CP, the lse-merged attention over
each rank's own positions (the paged engine's T queries folded into the
batch of one paged-kernel call a layer; the contiguous engine's
multi-query ``attention_lse_plain``).

The ranks run over gloo through ``runtime.mesh.run_ranks``: one spawn of
two for the whole module, started in the background when the module
starts, on the meshes model 2 (TP), expert 2 (EP, TINY_MOE), fsdp 2,
stage 2 (PP, two microbatches) and seq 2 (CP, ring).  The JAX side runs
in this process meanwhile: its unsharded speculative engines (the paged
engine without kernels, the contiguous engine) with the same knobs, its
paged speculative engine under a 2-device TP mesh of the virtual CPU
devices (``tests/conftest.py``), and its ``paged_decode_multi`` /
``llama.decode_multi`` on the cache contents the CP ranks split.  The
ranks' bodies live in this module, which imports no JAX at its top.
Weights come from numpy seeds (the same arrays on both sides).
Counterparts: ``tests/test_torch_speculative.py`` (the unsharded port
against JAX) and the 1-rank cases of ``tests/test_torch_isolation.py``.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

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

# the layers' projections times 2: greedy decode repeats some tokens, so
# one-token n-grams draft and some are accepted; the draft model is the
# target's shapes and seed times 1.8 (some of its drafts accepted)
SCALE, DRAFT_SCALE = 2.0, 1.8
K, NGRAM = 3, 1
NEW_TOKENS = 16
PROMPTS = ("node notready on node-3", "pvc not bound")
# the contiguous CP case whose first verify step writes positions 30..33:
# two on rank 0's block of the sequence, two on rank 1's
STRADDLE_PROMPT = "kubelet evicted pod: disk low"
BLOCK = 32
# (mesh axes, make_engine keyword, weights) of each paged case
MESHES = {"tp": (dict(model=2), "tp_mesh", "fp32"),
          "ep": (dict(expert=2), "ep_mesh", "moe"),
          "fsdp": (dict(fsdp=2), "fsdp_mesh", "fp32"),
          "pp": (dict(stage=2), "pp_mesh", "fp32"),
          "cp": (dict(seq=2), "cp_mesh", "fp32")}
PAGED = [(m, d) for m in MESHES for d in ("ngram", "draft")]
CONTIGUOUS = [("tp", "ngram"), ("cp", "ngram"), ("pp", "draft")]
SPEC_COUNTERS = ("engine.spec_drafted", "engine.spec_accepted")
# the grammar case: one slot under a compiled DFA (verified on the device
# by ``dfa_greedy_multi``), its prompt showing the schema's JSON so the
# n-gram lookup drafts its keys, beside a free slot
GRAMMAR_SCHEMA = {"type": "object", "properties": [
    ("kind", {"enum": ["ConfigMap", "Job", "Pod", "Secret"]}),
    ("count", {"type": "integer", "max_digits": 3}),
    ("note", {"type": "string", "max_len": 12}),
]}
GRAMMAR_EXAMPLE = '{"kind": "Pod", "count": 12, "note": "oom"} '
GRAMMAR_TOKENS = 24


def _tiny(tree="fp32"):
    cfg = config.TINY_MOE if tree == "moe" else config.TINY
    return cfg.replace(max_seq_len=128 if tree == "grammar" else 64)


def _ecfg(paged=True, tree="fp32"):
    """Two slots, pages of 8, greedy, stepwise, k 3 over one-token
    n-grams; 64 positions (two CP blocks of 32), 128 for the grammar
    case."""
    seq = 128 if tree == "grammar" else 64
    return config.EngineConfig(
        max_batch=2, max_seq_len=seq,
        prefill_buckets=tuple(sorted({16, 32, 64, seq})),
        max_new_tokens=NEW_TOKENS, temperature=0.0, paged=paged,
        page_size=8, num_pages=48 if tree == "grammar" else 24,
        prefix_cache=False, decode_chunk=1, speculative_k=K,
        speculative_ngram=NGRAM)


def _encode(texts):
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    tok = get_tokenizer(vocab_size=512)
    return [tok.encode(t, add_bos=True) for t in texts]


# ---------------------------------------------------------------------------
# the ranks' side (no JAX here)
# ---------------------------------------------------------------------------


def _watch(engine) -> dict:
    """Record, each verify tick, the drafts the engine verified and (with
    a draft model) the ones this rank's own draft model made, before the
    broadcast; and the lengths each verify step wrote at."""
    seen = {"own": [], "verified": [], "lengths": []}
    commit = engine._verify_and_commit

    def verified(active_slots, drafts, *args, **kw):
        seen["verified"].append({int(s): list(d) for s, d in drafts.items()})
        return commit(active_slots, drafts, *args, **kw)

    engine._verify_and_commit = verified
    if engine._draft is not None:
        draft = engine._draft.draft

        def own(*args, **kw):
            out = draft(*args, **kw)
            seen["own"].append({int(s): list(d) for s, d in out.items()})
            return out

        engine._draft.draft = own
    if not engine.engine_cfg.paged:
        multi = engine._decode_multi_fn

        def watched(cfg, params, cache, tokens, lengths):
            seen["lengths"].append([int(n) for n in lengths])
            return multi(cfg, params, cache, tokens, lengths)

        engine._decode_multi_fn = watched
    return seen


def _serve(engine, prompts, grammar=None) -> dict:
    """The prompts' streams (the first under ``grammar``, a
    ``constrain.DFAGrammar`` schema), the speculation counters, the
    collectives by kind and what ``_watch`` saw."""
    from k8s_llm_rca_tpu_torch.runtime.mesh import (
        collective_counts, reset_collective_counts,
    )

    seen = _watch(engine)
    reset_collective_counts()
    if grammar is None:
        streams = [r.token_ids for r in engine.generate(
            [list(p) for p in prompts], max_new_tokens=NEW_TOKENS)]
    else:
        from k8s_llm_rca_tpu_torch.engine.constrain import DFAGrammar

        ids = [engine.submit(prompts[0], max_new_tokens=GRAMMAR_TOKENS,
                             grammar=DFAGrammar(grammar, engine.tokenizer))]
        ids += [engine.submit(p, max_new_tokens=GRAMMAR_TOKENS)
                for p in prompts[1:]]
        done = {r.seq_id: r.token_ids for r in engine.run_to_completion()}
        streams = [done[i] for i in ids]
    if engine.engine_cfg.paged:
        engine.allocator.check()
    return {"streams": streams, "collectives": collective_counts(),
            "counts": {k: int(engine._counts.get(k, 0))
                       for k in SPEC_COUNTERS + ("engine.verify_steps",
                                                 "engine.decode_steps")},
            **seen}


def _engine(inputs, meshes, name, paged, drafts, tree=None):
    """The paged or contiguous speculative engine of case ``name`` on this
    rank's shard, n-gram drafts or ``drafts == "draft"``'s model."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_params, shard_stage_params,
    )
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    _, kw_name, weights = MESHES[name]
    tree = tree or weights
    cfg, mesh = _tiny(tree), meshes[name]
    params = inputs["moe" if tree == "moe" else "fp32"]
    kw = {kw_name: mesh}
    if kw_name == "pp_mesh":
        shard = shard_stage_params(params, cfg, mesh)
        kw["pp_microbatches"] = 2
    elif kw_name == "cp_mesh":
        shard = params                       # CP shards the sequence
    else:
        layout = FSDP_LAYOUT if kw_name == "fsdp_mesh" else None
        shard = shard_params(params, llama_param_specs(cfg, layout), mesh)
    if drafts == "draft":
        kw["draft_model"] = (cfg, inputs["moe_draft" if tree == "moe"
                                          else "draft"])
    return make_engine(cfg, _ecfg(paged, tree), shard,
                       get_tokenizer(vocab_size=512), "cpu", **kw)


def _cp_functions(inputs, mesh) -> dict:
    """The verify step of a CP rank on the cache contents ``inputs``
    holds whole: ``paged_decode_multi`` over the rank's partition of the
    pool (and its sink page) with the global block tables, and
    ``llama.decode_multi`` over the rank's block of the contiguous cache.
    Returns both logits and what the rank's share holds after the
    writes."""
    from k8s_llm_rca_tpu_torch.engine.paged import PagePool, paged_decode_multi
    from k8s_llm_rca_tpu_torch.models import llama
    from k8s_llm_rca_tpu_torch.runtime.sharding import rank_config

    cfg = _tiny()
    rcfg = rank_config(cfg, cp_mesh=mesh, device="cpu")
    rank, case = rcfg.cp.rank, inputs["cp_case"]
    tokens, params = case["tokens"], inputs["fp32"]
    per = case["pool_k"].shape[1] // 2
    own = slice(rank * per, (rank + 1) * per)

    def share(pages):
        sink = torch.zeros_like(pages[:, :1])
        return torch.cat([pages[:, own], sink], dim=1).contiguous()

    pool = PagePool(share(case["pool_k"]), share(case["pool_v"]))
    pool, greedy, paged_logits = paged_decode_multi(
        rcfg, params, pool, tokens, case["paged_lengths"], case["tables"])
    rows = slice(rank * BLOCK, (rank + 1) * BLOCK)
    cache = llama.KVCache(case["cache_k"][:, :, rows].clone(),
                          case["cache_v"][:, :, rows].clone())
    cache, logits = llama.decode_multi(rcfg, params, cache, tokens,
                                       case["cache_lengths"])
    return {"paged_logits": paged_logits, "paged_greedy": greedy,
            "pool_k": pool.k[:, :per].clone(), "logits": logits,
            "cache_k": cache.k.clone()}


def _own_mesh_engine(inputs):
    """The paged engine with a draft model on a TP mesh of this rank alone,
    a part of the two-rank world: the draft broadcast's group is made by
    the mesh's one rank (``runtime.mesh.mesh_group``)."""
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.runtime.mesh import single_device_mesh
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    cfg = _tiny()
    return make_engine(cfg, _ecfg(), inputs["fp32"],
                       get_tokenizer(vocab_size=512), "cpu",
                       tp_mesh=single_device_mesh(device="cpu"),
                       draft_model=(cfg, inputs["draft"]))


def _ranks(rank, inputs):
    """Everything the module checks on its two ranks, in one spawn."""
    from k8s_llm_rca_tpu_torch.runtime.mesh import local_mesh

    meshes = {k: local_mesh(device="cpu", **axes)
              for k, (axes, _, _) in MESHES.items()}
    prompts = _encode(PROMPTS)
    out = {}
    for name, drafts in PAGED:
        out[("paged", name, drafts)] = _serve(
            _engine(inputs, meshes, name, True, drafts), prompts)
    for name, drafts in CONTIGUOUS:
        out[("contiguous", name, drafts)] = _serve(
            _engine(inputs, meshes, name, False, drafts), prompts)
    out["straddle"] = _serve(
        _engine(inputs, meshes, "cp", False, "ngram"),
        _encode([STRADDLE_PROMPT]))
    out["grammar"] = _serve(
        _engine(inputs, meshes, "tp", True, "ngram", tree="grammar"),
        _encode([GRAMMAR_EXAMPLE * 2, PROMPTS[0]]), GRAMMAR_SCHEMA)
    out["cp_functions"] = _cp_functions(inputs, meshes["cp"])
    out["own_mesh"] = _serve(_own_mesh_engine(inputs), prompts)
    return out


# ---------------------------------------------------------------------------
# inputs, the spawn and the JAX side
# ---------------------------------------------------------------------------


def _numpy_params(cfg, seed: int, x: float):
    """A Llama tree of ``cfg``'s shapes from a numpy seed at the JAX init's
    scales, the layers' projections times ``x``."""
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


def _cp_case():
    """The CP verify step's inputs: T = 4 tokens for two slots over a
    seeded 24-page pool (pages of 8; partition 0 is pages 0-11, positions
    0-31) at lengths 20 (rank 1 holds none of its keys) and 32 (its
    writes and part of its keys on rank 1), and over a seeded contiguous
    cache of 64 rows at lengths 20 and 30 (its writes straddle the two
    blocks)."""
    rng = np.random.default_rng(7)
    cfg = _tiny()
    pool = [(0.5 * rng.standard_normal((cfg.n_layers, 24, 8, cfg.kv_dim))
             ).astype(np.float32) for _ in range(2)]
    cache = [(0.5 * rng.standard_normal((cfg.n_layers, 2, 64, cfg.kv_dim))
              ).astype(np.float32) for _ in range(2)]
    tables = np.array([[1, 2, 3, 4, 12, 13, 14, 15],
                       [5, 6, 7, 8, 16, 17, 18, 19]], np.int32)
    return {"tokens": rng.integers(1, 512, (2, K + 1)).astype(np.int32),
            "tables": tables,
            "paged_lengths": np.array([20, 32], np.int32),
            "cache_lengths": np.array([20, 30], np.int32),
            "pool_k": pool[0], "pool_v": pool[1],
            "cache_k": cache[0], "cache_v": cache[1]}


@pytest.fixture(scope="module")
def inputs():
    """The port's trees (TINY and TINY_MOE targets and drafts) and the CP
    verify step's cache contents."""
    tiny, moe = config.TINY, config.TINY_MOE
    return {"fp32": _torch_tree(_numpy_params(tiny, 0, SCALE)),
            "draft": _torch_tree(_numpy_params(tiny, 0, DRAFT_SCALE)),
            "moe": _torch_tree(_numpy_params(moe, 2, SCALE)),
            "moe_draft": _torch_tree(_numpy_params(moe, 2, DRAFT_SCALE)),
            "cp_case": {k: torch.from_numpy(v)
                        for k, v in _cp_case().items()}}


@pytest.fixture(scope="module", autouse=True)
def spawned(inputs, tmp_path_factory):
    """The module's one spawn of two ranks, started in the background when
    the module starts: the JAX side runs meanwhile."""
    from k8s_llm_rca_tpu_torch.runtime.mesh import run_ranks

    workdir = str(tmp_path_factory.mktemp("mesh_spec"))
    # the ranks get a copy: a tensor handed to a spawned process moves to
    # shared memory, which a JAX array made from it would go on reading
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, _ranks, 2, workdir,
                          args=(copy.deepcopy(inputs),),
                          timeout_s=RANKS_TIMEOUT_S)


@pytest.fixture(scope="module")
def ranks(spawned, jax_side):
    """The ranks' results; JAX's side first, while they run."""
    return spawned.result()


def _jax_model(cfg, tree):
    import jax.numpy as jnp

    from k8s_llm_rca_tpu import config as jconfig

    return (jconfig.ModelConfig(**{f: getattr(cfg, f)
                                   for f in cfg.__dataclass_fields__}),
            rules.map_with_names(lambda _, w: jnp.asarray(w.numpy()), tree))


def _jax_engine(tree_name, ecfg, inputs, drafts="ngram", tp_mesh=None):
    """JAX's speculative engine: the paged engine without its kernels (or,
    under ``tp_mesh``, on its shard of the weights), or (``ecfg.paged``
    off) the contiguous engine, with n-gram drafts or the draft model."""
    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.engine import make_engine
    from k8s_llm_rca_tpu.engine.engine import InferenceEngine
    from k8s_llm_rca_tpu.engine.paged import PagedInferenceEngine
    from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer

    moe = tree_name == "moe"
    cfg = _tiny(tree_name)
    jcfg, params = _jax_model(cfg, inputs["moe" if moe else "fp32"])
    jecfg = jconfig.EngineConfig(**{
        f: getattr(ecfg, f) for f in ecfg.__dataclass_fields__
        if f in jconfig.EngineConfig.__dataclass_fields__})
    kw = {}
    if drafts == "draft":
        kw["draft_model"] = _jax_model(
            cfg, inputs["moe_draft" if moe else "draft"])
    tok = get_tokenizer(vocab_size=512)
    if tp_mesh is not None:
        from k8s_llm_rca_tpu.runtime.sharding import (
            llama_param_specs, shard_pytree,
        )

        return make_engine(jcfg, jecfg, shard_pytree(
            params, llama_param_specs(jcfg), tp_mesh), tok,
            tp_mesh=tp_mesh, **kw)
    if not ecfg.paged:
        return InferenceEngine(jcfg, jecfg, params, tok, **kw)
    return PagedInferenceEngine(jcfg, jecfg, params, tok, use_kernel=False,
                                **kw)


def _jax_serve(engine, prompts, grammar=None) -> dict:
    if grammar is None:
        streams = [r.token_ids for r in engine.generate(
            [list(p) for p in prompts], max_new_tokens=NEW_TOKENS)]
    else:
        from k8s_llm_rca_tpu.engine.constrain import DFAGrammar

        ids = [engine.submit(prompts[0], max_new_tokens=GRAMMAR_TOKENS,
                             grammar=DFAGrammar(grammar, engine.tokenizer))]
        ids += [engine.submit(p, max_new_tokens=GRAMMAR_TOKENS)
                for p in prompts[1:]]
        done = {r.seq_id: r.token_ids for r in engine.run_to_completion()}
        streams = [done[i] for i in ids]
    return {"streams": streams,
            "counts": {k: int(engine._counts.get(k, 0))
                       for k in SPEC_COUNTERS}}


def _jax_functions(inputs):
    """JAX's ``paged_decode_multi`` over the whole pool and
    ``llama.decode_multi`` over the whole cache of ``_cp_case``."""
    import jax.numpy as jnp

    from k8s_llm_rca_tpu.engine import paged as jpaged
    from k8s_llm_rca_tpu.models import llama as jllama

    jcfg, params = _jax_model(_tiny(), inputs["fp32"])
    case = {k: jnp.asarray(v.numpy()) for k, v in inputs["cp_case"].items()}
    pool, _, paged_logits = jpaged.paged_decode_multi(
        jcfg, params, jpaged.PagePool(case["pool_k"], case["pool_v"]),
        case["tokens"], case["paged_lengths"], case["tables"])
    cache, logits = jllama.decode_multi(
        jcfg, params, jllama.KVCache(case["cache_k"], case["cache_v"]),
        case["tokens"], case["cache_lengths"])
    return {"paged_logits": np.asarray(paged_logits),
            "pool_k": np.asarray(pool.k), "logits": np.asarray(logits),
            "cache_k": np.asarray(cache.k)}


@pytest.fixture(scope="module")
def jax_side(inputs):
    """JAX's engines and functions, on threads while the ranks run."""
    import jax

    from k8s_llm_rca_tpu.config import MeshConfig
    from k8s_llm_rca_tpu.runtime.mesh import build_mesh

    prompts = _encode(PROMPTS)
    tp_mesh = build_mesh(MeshConfig(data=1, model=2),
                         devices=jax.devices("cpu")[:2])
    jobs = {}
    with ThreadPoolExecutor(3) as pool:
        for tree in ("fp32", "moe"):
            for drafts in ("ngram", "draft"):
                jobs[("paged", tree, drafts)] = pool.submit(
                    lambda t=tree, d=drafts: _jax_serve(_jax_engine(
                        t, _ecfg(True, t), inputs, d), prompts))
        for drafts in ("ngram", "draft"):
            jobs[("contiguous", drafts)] = pool.submit(
                lambda d=drafts: _jax_serve(_jax_engine(
                    "fp32", _ecfg(False), inputs, d), prompts))
        jobs["straddle"] = pool.submit(lambda: _jax_serve(_jax_engine(
            "fp32", _ecfg(False), inputs), _encode([STRADDLE_PROMPT])))
        jobs["grammar"] = pool.submit(lambda: _jax_serve(
            _jax_engine("grammar", _ecfg(True, "grammar"), inputs),
            _encode([GRAMMAR_EXAMPLE * 2, PROMPTS[0]]), GRAMMAR_SCHEMA))
        jobs["tp_mesh"] = pool.submit(lambda: _jax_serve(_jax_engine(
            "fp32", _ecfg(True), inputs, tp_mesh=tp_mesh), prompts))
        jobs["functions"] = pool.submit(_jax_functions, inputs)
        return {k: f.result() for k, f in jobs.items()}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _both_ranks_equal_jax(got, want, drafts):
    """Both ranks' streams and speculation counters equal JAX's; the
    ranks verified the same drafts at every tick; with a draft model each
    rank's own drafts are the broadcast ones and every verify step made
    one broadcast, with n-gram drafts none."""
    assert all(len(set(s)) > 2 for s in want["streams"]), want
    for r in got:
        assert r["streams"] == want["streams"]
        assert {k: r["counts"][k] for k in SPEC_COUNTERS} == want["counts"]
        assert r["counts"]["engine.verify_steps"] > 0
        n_verify = r["counts"]["engine.verify_steps"]
        if drafts == "draft":
            assert r["own"] == r["verified"]
            assert r["collectives"]["broadcast"] == n_verify
        else:
            assert not r["own"] and r["collectives"]["broadcast"] == 0
    assert got[0]["verified"] == got[1]["verified"]
    assert got[0]["counts"] == got[1]["counts"]
    assert got[0]["collectives"] == got[1]["collectives"]


@pytest.mark.parametrize("mesh,drafts", PAGED,
                         ids=[f"{m}-{d}" for m, d in PAGED])
def test_paged_speculation_under_a_mesh_equals_jax(mesh, drafts, jax_side,
                                                   ranks):
    """The paged engine at TP 2, EP 2 (TINY_MOE), FSDP 2, PP 2 (two
    microbatches) and CP 2 (ring), with n-gram drafts and with a draft
    model: the streams, ``spec_drafted`` and ``spec_accepted`` of JAX's
    unsharded paged speculative engine with the same weights and knobs,
    on both ranks alike."""
    tree = MESHES[mesh][2]
    want = jax_side[("paged", tree, drafts)]
    assert want["counts"]["engine.spec_accepted"] > 0, want
    _both_ranks_equal_jax([r[("paged", mesh, drafts)] for r in ranks], want,
                          drafts)


@pytest.mark.parametrize("mesh,drafts", CONTIGUOUS,
                         ids=[f"{m}-{d}" for m, d in CONTIGUOUS])
def test_contiguous_speculation_under_a_mesh_equals_jax(mesh, drafts,
                                                        jax_side, ranks):
    """The contiguous engine at TP 2 and CP 2 with n-gram drafts and at PP
    2 with a draft model (``llama_pp_decode_multi``): JAX's unsharded
    contiguous speculative engine's streams and counters, both ranks
    alike."""
    want = jax_side[("contiguous", drafts)]
    assert want["counts"]["engine.spec_accepted"] > 0, want
    _both_ranks_equal_jax([r[("contiguous", mesh, drafts)] for r in ranks],
                          want, drafts)


def test_contiguous_cp_verify_write_straddles_the_blocks(jax_side, ranks):
    """A contiguous CP 2 verify step whose k + 1 writes straddle the two
    ranks' blocks of the sequence (positions 30..33 of 32-row blocks):
    each rank keeps its own rows, and the stream and counters are JAX's
    unsharded contiguous engine's."""
    got = [r["straddle"] for r in ranks]
    first = got[0]["lengths"][0][0]
    assert first < BLOCK < first + K + 1, got[0]["lengths"]
    _both_ranks_equal_jax(got, jax_side["straddle"], "ngram")


def test_draft_broadcast_on_a_mesh_of_part_of_the_world(jax_side, ranks):
    """Each rank serves with a draft model on a TP mesh of itself alone,
    a part of the two-rank world: the drafts' broadcast group is that
    mesh's, made by its one rank, one broadcast a verify step, and the
    streams and counters are JAX's unsharded paged engine's."""
    _both_ranks_equal_jax([r["own_mesh"] for r in ranks],
                          jax_side[("paged", "fp32", "draft")], "draft")


def test_grammar_verify_under_tp_equals_jax(jax_side, ranks):
    """TP 2 with a compiled DFA grammar slot beside a free slot: the
    verify step applies the grammar on the device (``dfa_greedy_multi``)
    and the streams and counters equal JAX's unsharded paged engine's."""
    want = jax_side["grammar"]
    assert want["counts"]["engine.spec_accepted"] > 0, want
    _both_ranks_equal_jax([r["grammar"] for r in ranks], want, "ngram")
    assert b"kind" in bytes(t for t in want["streams"][0] if t < 256)


def test_tp_speculation_counters_equal_jax_tp_mesh(jax_side, ranks):
    """JAX's paged speculative engine under a 2-device TP mesh (the
    virtual CPU devices) drafts and accepts what the port's TP 2 ranks
    do, with the same streams."""
    want = jax_side["tp_mesh"]
    for r in ranks:
        got = r[("paged", "tp", "ngram")]
        assert got["streams"] == want["streams"]
        assert {k: got["counts"][k] for k in SPEC_COUNTERS} \
            == want["counts"]


@pytest.mark.parametrize("engine", ["paged", "contiguous"])
def test_cp_verify_logits_equal_jax(engine, jax_side, ranks):
    """The CP 2 verify step on the cache contents JAX holds whole: the
    paged fold (one paged call a layer over each rank's pages, a slot
    whose keys are all on rank 0 and one whose writes and some keys are
    on rank 1) and the contiguous multi-query attention (a write that
    straddles the blocks) give JAX's ``paged_decode_multi`` /
    ``llama.decode_multi`` logits within 1e-4 (fp32) on both ranks, and
    each rank's share of the written cache is JAX's."""
    want = jax_side["functions"]
    key = "paged_logits" if engine == "paged" else "logits"
    for rank, r in enumerate(ranks):
        got = r["cp_functions"]
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4,
                                   atol=1e-4)
        if engine == "paged":
            per = got["pool_k"].shape[1]
            np.testing.assert_allclose(
                got["pool_k"].numpy(),
                want["pool_k"][:, rank * per:(rank + 1) * per],
                rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(
                got["paged_greedy"].numpy(), want[key].argmax(-1))
        else:
            np.testing.assert_allclose(
                got["cache_k"].numpy(),
                want["cache_k"][:, :, rank * BLOCK:(rank + 1) * BLOCK],
                rtol=1e-5, atol=1e-5)
