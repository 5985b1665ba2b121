"""The port's speculative decoding, the overlapped host loop and the
attention over KV pages against the JAX package's.

- ``ngram_draft``: the JAX ``TestNgramDraft`` cases against the JAX
  function.
- ``paged_decode_multi``: the verify step on the same TINY pool (fp32
  and int4), logits within 1e-4 (fp32, different reduction orders);
  greedy tokens and the written pages equal.
- ``dfa_greedy_multi``: tokens equal on seeded logits over a compiled
  grammar's tables.
- ``attend_over_pages``: its CPU path against JAX ``_chunk_attention`` (a
  hit's chunk over its cached prefix) and ``decode_attention_multi`` over
  the gathered pages (verification), row for row within 1e-5.
- Two engine cases against JAX: a speculative batch that mixes a DFA
  grammar slot with free slots under preemption (streams and the
  ``spec_drafted``/``spec_accepted``/``preemptions`` counters), and
  ``host_overlap`` at ``decode_chunk`` 1 (streams and the
  ``d2h_syncs``/``h2d_uploads`` counters).
- Port only, the JAX package's own invariants: speculation on equals off
  (stepwise, a DFA grammar, an interpreted grammar), overlap on equals
  off (with a cancel mid-run).

Engines are ``test_torch_engine``'s (TINY, projections x3, page 16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.config import TINY as J_TINY
from k8s_llm_rca_tpu.engine import constrain as jc
from k8s_llm_rca_tpu.engine import engine as jengine
from k8s_llm_rca_tpu.engine import paged as jpaged
from k8s_llm_rca_tpu.engine.speculative import ngram_draft as j_ngram
from k8s_llm_rca_tpu.ops.attention import decode_attention_multi as j_multi
from k8s_llm_rca_tpu_torch.config import TINY
from k8s_llm_rca_tpu_torch.engine import constrain as tc
from k8s_llm_rca_tpu_torch.engine import paged as tpaged
from k8s_llm_rca_tpu_torch.engine.engine import dfa_greedy_multi
from k8s_llm_rca_tpu_torch.engine.speculative import ngram_draft
from k8s_llm_rca_tpu_torch.models.llama import params_from_numpy
from k8s_llm_rca_tpu_torch.models.quant import dequant_kv

from test_torch_engine import MIXED_SCHEMA, engines, jax_params

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

PAGE = 16
N_PAGES = 24


@pytest.mark.parametrize("ctx,n,k", [
    ([5, 6, 7, 9, 5, 6, 8, 5, 6], 2, 3),      # most recent continuation
    ([1, 2, 3, 4], 2, 4),                      # no match
    ([1, 2], 3, 4),                            # context too short
    ([1, 2, 3, 4, 5, 6, 1, 2], 2, 2),          # clipped to k
], ids=["most-recent", "no-match", "short", "clipped"])
def test_ngram_draft_matches_jax(ctx, n, k):
    assert ngram_draft(ctx, n, k) == j_ngram(ctx, n, k)


def _pools(kv_dtype, seed=0):
    """The same random pool as a JAX PagePool and a port PagePool."""
    rng = np.random.default_rng(seed)
    shape = (J_TINY.n_layers, N_PAGES, PAGE, J_TINY.kv_dim)
    if kv_dtype is None:
        k, v = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        arrays = (k, v)
    else:
        shape = (*shape[:3], J_TINY.kv_dim // 2)
        arrays = tuple(rng.integers(-128, 128, shape, dtype=np.int8)
                       for _ in range(2)) + tuple(
            rng.uniform(0.05, 0.2, shape[:3]).astype(np.float32)
            for _ in range(2))
    return (jpaged.PagePool(*(jnp.asarray(a) for a in arrays)),
            tpaged.PagePool(*(torch.from_numpy(a.copy()) for a in arrays)))


def _params():
    p = jax_params()
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("kv_dtype", [None, "int4"], ids=["fp32", "int4"])
def test_paged_decode_multi_matches_jax(kv_dtype):
    """Four slots verify T = 5 tokens at lengths 3, 16, 27 and 0 (an idle
    slot) over shuffled page tables: the same logits, greedy tokens and
    written pages."""
    jp, tp = _params()
    jpool, tpool = _pools(kv_dtype)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 512, (4, 5)).astype(np.int32)
    lengths = np.array([3, 16, 27, 0], np.int32)
    tables = np.zeros((4, 4), np.int32)
    tables[:3] = rng.permutation(np.arange(1, N_PAGES))[:12].reshape(3, 4)
    jpool, jgreedy, jlogits = jpaged.paged_decode_multi(
        J_TINY, jp, jpool, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(tables))
    tpool, tgreedy, tlogits = tpaged.paged_decode_multi(
        TINY, tp, tpool, torch.from_numpy(tokens), torch.from_numpy(lengths),
        torch.from_numpy(tables))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tgreedy.numpy(), np.asarray(jgreedy))
    if kv_dtype is None:
        for a, b in ((tpool.k, jpool.k), (tpool.v, jpool.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
        return
    # quantized: the scales within fp32 rounding, the dequantized values
    # within one quantization step (a token's K/V differ in the last bits,
    # so a value on a rounding edge may take the neighbouring level)
    for a, sa, b, sb in ((tpool.k, tpool.k_scale, jpool.k, jpool.k_scale),
                         (tpool.v, tpool.v_scale, jpool.v, jpool.v_scale)):
        np.testing.assert_allclose(sa.numpy(), np.asarray(sb), rtol=1e-5)
        got = dequant_kv(a, sa, torch.float32, packed=True)
        want = dequant_kv(torch.from_numpy(np.array(b)),
                          torch.from_numpy(np.array(sb)), torch.float32,
                          packed=True)
        step = sa.numpy()[..., None] * 1.0001
        assert (np.abs(got.numpy() - want.numpy()) <= step).all()


def test_dfa_greedy_multi_matches_jax():
    """Seeded [4, 5, V] logits over the compiled MIXED_SCHEMA tables: slots
    at the start state, mid-way and with a tight budget, and a free slot."""
    from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer as j_tok
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    jg = jc.DFAGrammar(MIXED_SCHEMA, j_tok(vocab_size=512))
    tg = tc.DFAGrammar(MIXED_SCHEMA, get_tokenizer(vocab_size=512))
    for _ in range(3):
        tok = int(np.flatnonzero(tg.tables.allow[tg.state])[0])
        jg.advance(tok)
        tg.advance(tok)
    t = tg.tables
    states = np.array([t.start, tg.state, tg.state, t.free_state], np.int32)
    remaining = np.array([40, 30, 4, 1 << 30], np.int32)
    logits = np.random.default_rng(2).standard_normal(
        (4, 5, 512)).astype(np.float32)
    want = jengine.dfa_greedy_multi(
        jnp.asarray(logits), jnp.asarray(states), jnp.asarray(remaining),
        tg.tokenizer.eos_id, *(jnp.asarray(a) for a in (
            t.allow, t.token_next, t.dist, t.close_tok, t.complete)))
    got = dfa_greedy_multi(
        torch.from_numpy(logits), torch.from_numpy(states),
        torch.from_numpy(remaining), tg.tokenizer.eos_id,
        *(torch.from_numpy(a) for a in (t.allow, t.token_next, t.dist,
                                        t.close_tok, t.complete)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_dtype", [None, "int4"], ids=["fp32", "int4"])
def test_attend_over_pages_plain_matches_jax(kv_dtype):
    """The helper's CPU path, row for row: (a) three hit chunks of 32
    queries over cached prefixes of 2, 3 and 4 pages (tables padded to 4
    pages, chunk lengths 32, 20 and 7) against JAX ``_chunk_attention``
    with the engine's absolute-position mask; (b) T = 5 verify queries at
    lengths 3, 16 and 40 against ``decode_attention_multi`` over the
    gathered pages."""
    jpool, tpool = _pools(kv_dtype, seed=3)
    cfg = J_TINY
    rng = np.random.default_rng(4)
    tables = rng.permutation(np.arange(1, N_PAGES))[:12].reshape(
        3, 4).astype(np.int32)
    packed = kv_dtype == "int4"
    dtype = jnp.float32

    def jgather(li, tabs):
        return tuple(jpaged._gather_dequant_pages(
            p[li], s[li] if jpool.quantized else None, jnp.asarray(tabs),
            cfg.n_kv_heads, cfg.head_dim, dtype, packed)
            for p, s in ((jpool.k, jpool.k_scale), (jpool.v, jpool.v_scale)))

    # (a) hits
    c = 32
    prefix_lens = np.array([2, 3, 4], np.int32) * PAGE
    chunk_lens = np.array([32, 20, 7], np.int32)
    q = rng.standard_normal((3, c, cfg.n_heads, cfg.head_dim)).astype(
        np.float32)
    fk, fv = (rng.standard_normal((3, c, cfg.n_kv_heads, cfg.head_dim))
              .astype(np.float32) for _ in range(2))
    s_pre = 4 * PAGE
    pos = prefix_lens[:, None] + np.arange(c)[None]
    k_abs = np.concatenate([np.broadcast_to(np.arange(s_pre), (3, s_pre)),
                            pos], axis=1)
    k_valid = np.concatenate([np.arange(s_pre)[None] < prefix_lens[:, None],
                              np.arange(c)[None] < chunk_lens[:, None]], 1)
    mask = (pos[:, :, None] >= k_abs[:, None, :]) & k_valid[:, None, :]
    kp, vp = jgather(1, tables)
    want = jpaged._chunk_attention(
        cfg, jnp.asarray(q), jnp.concatenate([kp, jnp.asarray(fk)], 1),
        jnp.concatenate([vp, jnp.asarray(fv)], 1), jnp.asarray(mask))
    got = tpaged.attend_over_pages(
        TINY, torch.from_numpy(q), tpool, 1, torch.from_numpy(tables),
        torch.from_numpy(prefix_lens),
        torch.from_numpy(prefix_lens + chunk_lens),
        fresh=(torch.from_numpy(fk), torch.from_numpy(fv)))
    for row in range(3):
        n = int(chunk_lens[row])       # padded queries need only be finite
        np.testing.assert_allclose(got[row, :n].numpy(),
                                   np.asarray(want)[row, :n],
                                   rtol=1e-5, atol=1e-5)
    assert torch.isfinite(got).all()

    # (b) verification: the pool already holds the T new tokens
    lengths = np.array([3, 16, 40], np.int32)
    qv = rng.standard_normal((3, 5, cfg.n_heads, cfg.head_dim)).astype(
        np.float32)
    kp, vp = jgather(0, tables)
    want = j_multi(jnp.asarray(qv), kp, vp, jnp.asarray(lengths + 1))
    got = tpaged.attend_over_pages(
        TINY, torch.from_numpy(qv), tpool, 0, torch.from_numpy(tables),
        torch.from_numpy(lengths), torch.from_numpy(lengths + 5))
    for row in range(3):
        np.testing.assert_allclose(got[row].numpy(), np.asarray(want)[row],
                                   rtol=1e-5, atol=1e-5)


def _grammar_prompts(tok):
    """A grammar prompt that shows the schema's JSON (so the n-gram
    lookup drafts its keys), and three seeded free prompts."""
    example = ('{"kind": "Pod", "count": 12, "note": "crash loop"} '
               '{"kind": "Job", "count": 3, "note": "oom killed"} ')
    rng = np.random.default_rng(8)
    free = [[int(t) for t in rng.integers(0, 256, n)] for n in (118, 250, 250)]
    return tok.encode(example * 2, add_bos=True), free


def _spec_run(eng, grammar_mod, prompts):
    g_prompt, free = prompts
    ids = [eng.submit(g_prompt, max_new_tokens=60,
                      grammar=grammar_mod.DFAGrammar(MIXED_SCHEMA,
                                                     eng.tokenizer))]
    ids += [eng.submit(p, max_new_tokens=40) for p in free]
    res = {r.seq_id: r for r in eng.run_to_completion()}
    return [(res[i].token_ids, res[i].finish_reason) for i in ids]


SPEC_COUNTERS = ("engine.spec_drafted", "engine.spec_accepted",
                 "engine.preemptions", "engine.decode_tokens")


def test_speculative_grammar_batch_under_preemption_matches_jax():
    """speculative_k 4, stepwise: a DFA-grammar slot verifies its drafts
    constrained on the device (``dfa_greedy_multi``) beside three free
    slots; all four admit into 58 usable pages, which run dry as the slots
    grow, so the youngest is preempted and resumes by re-prefill.  Streams and the speculation and
    preemption counters equal JAX's."""
    je, te = engines(speculative_k=4, decode_chunk=1, num_pages=59)
    prompts = _grammar_prompts(te.tokenizer)
    want = _spec_run(je, jc, prompts)
    got = _spec_run(te, tc, prompts)
    assert got == want
    counts = [{k: e._counts.get(k, 0) for k in SPEC_COUNTERS}
              for e in (je, te)]
    assert counts[1] == counts[0]
    assert counts[1]["engine.preemptions"] > 0
    assert counts[1]["engine.spec_accepted"] > 0
    te.allocator.check()
    assert te.allocator.n_free == te.engine_cfg.num_pages - 1


def test_host_overlap_streams_and_host_traffic_match_jax():
    """host_overlap at decode_chunk 1: the lagged commit gives JAX's
    streams and counts the device syncs and uploads JAX counts (one
    upload of the three operands, one fetch per two steps)."""
    je, te = engines(host_overlap=True, decode_chunk=1)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (5, 60, 130, 300)]
    assert ([r.token_ids for r in te.generate(prompts)]
            == [r.token_ids for r in je.generate(prompts)])
    keys = ("engine.d2h_syncs", "engine.h2d_uploads", "engine.dispatches",
            "engine.decode_tokens")
    counts = [{k: e._counts.get(k, 0) for k in keys} for e in (je, te)]
    assert counts[1] == counts[0]
    assert counts[1]["engine.h2d_uploads"] == 3
    assert not te._inflight and not te._inflight_n


def _port_engine(**over):
    from k8s_llm_rca_tpu_torch.config import EngineConfig
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    from test_torch_engine import engine_kwargs

    return make_engine(TINY, EngineConfig(**engine_kwargs(**over)),
                       _params()[1], get_tokenizer(vocab_size=512),
                       device="cpu")


@pytest.mark.parametrize("grammar", [None, "dfa", "interpreted"])
def test_speculation_equals_plain_greedy(grammar):
    """Port only: speculative_k 4 gives plain greedy decoding's streams,
    with no grammar, a DFA grammar (verified on the device) or an
    interpreted grammar ([B, T, V] logits to the host).  One-token
    n-grams, so the free slots draft too."""
    prompts = _grammar_prompts(_port_engine().tokenizer)
    out = []
    for k in (0, 4):
        eng = _port_engine(speculative_k=k, speculative_ngram=1,
                           decode_chunk=1)
        g = None
        if grammar == "dfa":
            g = tc.DFAGrammar(MIXED_SCHEMA, eng.tokenizer)
        elif grammar == "interpreted":
            g = tc.SchemaGrammar(MIXED_SCHEMA, eng.tokenizer)
        ids = [eng.submit(prompts[0], max_new_tokens=50, grammar=g),
               eng.submit(prompts[1][0], max_new_tokens=30)]
        res = {r.seq_id: r.token_ids for r in eng.run_to_completion()}
        out.append([res[i] for i in ids])
        if k:
            assert eng._counts["engine.spec_drafted"] > 0
            assert eng._counts["engine.verify_steps"] > 0
    assert out[1] == out[0]


def test_overlap_equals_plain_with_a_cancel():
    """Port only: host_overlap on and off give equal streams when a
    sequence is cancelled while its tokens are in flight (the barrier
    commits them first; the next tick surfaces what the flush retired)."""
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in (30, 70)]
    out = []
    for overlap in (False, True):
        eng = _port_engine(host_overlap=overlap, decode_chunk=1)
        ids = [eng.submit(p, max_new_tokens=20) for p in prompts]
        results = []
        for _ in range(5):
            results += eng.step()
        assert eng.cancel_seq(ids[1])
        results += eng.run_to_completion()
        out.append(sorted((r.seq_id, r.token_ids) for r in results))
        assert eng.allocator.n_free == eng.engine_cfg.num_pages - 1
    assert out[1] == out[0]
