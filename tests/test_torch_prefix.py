"""The port's prefix cache and chunked prefill against the JAX engine's.

The engines are ``test_torch_engine``'s (TINY, projections x3, page 16,
max_seq_len 512, buckets 128/256, decode_chunk 16) with the prefix cache
on.  Prompts share a 64-token prefix (four pages) and differ in their
tails, so a later prompt hits four cached pages and prefills its suffix
through ``paged_prefill_chunk_batch``, alone or batched with equal hits.
Greedy streams and the prefix and prefill counters must equal JAX's."""

import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.engine import engine as jengine
from k8s_llm_rca_tpu.engine.constrain import DFAGrammar as JDFAGrammar
from k8s_llm_rca_tpu.engine.paged import PageAllocator as JPageAllocator
from k8s_llm_rca_tpu.engine.prefix import PrefixCache as JPrefixCache
from k8s_llm_rca_tpu_torch.engine import engine as tengine
from k8s_llm_rca_tpu_torch.engine.constrain import DFAGrammar
from k8s_llm_rca_tpu_torch.engine.paged import PageAllocator
from k8s_llm_rca_tpu_torch.engine.prefix import PrefixCache

from test_torch_engine import MIXED_SCHEMA, engines

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

COUNTERS = ("engine.prefix_hit_tokens", "engine.prefix_batch_hit_admissions",
            "engine.prefill_tokens", "engine.prefill_chunks",
            "engine.preemptions")


def _allocator_state(a):
    return sorted(a._free), dict(sorted(a._owner.items()))


def test_prefix_cache_unit_sequence_matches_jax():
    """insert / match / has_prefix / release / evict on the same calls:
    the same results, refcounts, LRU order and allocator state."""
    log = []
    for alloc_cls, cache_cls in ((JPageAllocator, JPrefixCache),
                                 (PageAllocator, PrefixCache)):
        a = alloc_cls(12)
        pc = cache_cls(a, page_size=4)
        prompt = list(range(1, 15))              # 3 full pages + 2 tokens
        other = prompt[:8] + [99] * 6            # shares 2 pages
        steps = []
        pages = a.alloc(4, owner=1)
        steps.append(pc.insert(prompt, pages, owner=1, n_matched_pages=0))
        steps.append(pc.match(other))
        steps.append((pc.has_prefix(other), pc.has_prefix([7] * 9),
                      pc.has_prefix(prompt[:4])))
        steps.append(pc.evict(10))               # all pages referenced
        own = a.alloc(2, owner=2)
        table = steps[1][0] + own
        steps.append(pc.insert(other, table, owner=2, n_matched_pages=2))
        pc.release(pages[:3])
        steps.append((pc.n_resident, pc.n_evictable, list(pc._lru)))
        steps.append(pc.match(prompt))           # re-acquires pages 0-2
        pc.release(table[:3])
        pc.release(steps[-1][0])
        steps.append(pc.evict(2))
        steps.append((pc.n_resident, pc.n_evictable, list(pc._lru)))
        with pytest.raises(RuntimeError, match="unreferenced"):
            pc.release([pages[0]])
        a.free([pages[3]], owner=1)
        a.free(own[1:], owner=2)
        steps.append(pc.evict(10))
        a.check()
        steps.append(_allocator_state(a))
        log.append(steps)
    assert log[1] == log[0]


def _shared_prompts(seed=5):
    rng = np.random.default_rng(seed)
    common = [int(t) for t in rng.integers(0, 256, 64)]
    return [common + [int(t) for t in rng.integers(0, 256, n)]
            for n in (20, 35, 50, 27)]


def _run_waves(eng, waves):
    out = []
    for wave in waves:
        out += [(r.token_ids, r.finish_reason) for r in eng.generate(wave)]
    return out


def _counts(eng):
    return {k: eng._counts.get(k, 0) for k in COUNTERS}


@pytest.mark.parametrize("case", ["single", "batched", "pressure"])
def test_shared_prefix_streams_and_counters_match_jax(case):
    """One prompt seeds the cache, then the other three hit its four
    shared pages: one at a time (``_admit``'s hit branch), together (one
    batched chunk prefill), or through a 40-page pool where earlier
    prompts' cached pages are evicted to admit later ones."""
    prompts = _shared_prompts()
    over = {"prefix_cache": True}
    if case == "single":
        waves = [[p] for p in prompts]
    elif case == "batched":
        waves = [prompts[:1], prompts[1:]]
    else:
        rng = np.random.default_rng(6)
        other = [[int(t) for t in rng.integers(0, 256, 100)]
                 for _ in range(4)]
        waves = [[p] for p in other + prompts]
        over.update(num_pages=41, max_batch=2)
    je, te = engines(**over)
    assert _run_waves(te, waves) == _run_waves(je, waves)
    assert _counts(te) == _counts(je)
    assert te._counts["engine.prefix_hit_tokens"] == 3 * 64
    batched = te._counts.get("engine.prefix_batch_hit_admissions", 0)
    assert batched == (3 if case == "batched" else 0)
    assert te.prefix_cache.n_resident == je.prefix_cache.n_resident
    assert te.allocator.n_free == je.allocator.n_free
    assert te.allocator.n_free + te.prefix_cache.n_resident == \
        te.engine_cfg.num_pages - 1
    if case == "pressure":
        assert te.prefix_cache.n_resident < 4 * 7 + 7   # some evicted
    te.allocator.check()


def test_chunked_prefill_matches_jax_and_budget_zero():
    """``prefill_chunk_budget`` 32 with the prefix cache on: the seed
    prompt prefills in three chunks, two hits in two each (their suffixes
    still exceed the budget), the third hit in one ordinary hit prefill
    (its 27-token suffix fits) and a 300-token prompt in ten.  Streams and
    counters equal JAX's, and the streams equal budget 0's."""
    prompts = _shared_prompts()
    rng = np.random.default_rng(7)
    waves = [prompts[:1], prompts[1:] + [[int(t) for t in
                                          rng.integers(0, 256, 300)]]]
    je, te = engines(prefix_cache=True, prefill_chunk_budget=32)
    chunked = _run_waves(te, waves)
    assert chunked == _run_waves(je, waves)
    assert _counts(te) == _counts(je)
    assert te._counts["engine.prefill_chunks"] == 3 + 2 * 2 + 10
    _, plain = engines(prefix_cache=True)
    assert _run_waves(plain, waves) == chunked
    te.allocator.check()


def test_padded_dfa_tables_match_jax():
    """``_scan_dfa_setup`` fuses two compiled grammars and pads the stack
    to a multiple of 1024 states, as JAX does: the same padded size, each
    grammar's rows equal where its slot's state offset puts them, dead
    rows zero, and equal per-slot budgets."""
    schemas = (MIXED_SCHEMA, {"type": "object", "properties": [
        ("ok", {"enum": ["yes", "no"]})]})
    je, te = engines()
    fused = []
    for eng, mod, dfa in ((je, jengine, JDFAGrammar), (te, tengine,
                                                       DFAGrammar)):
        grammars = [dfa(s, eng.tokenizer) for s in schemas]
        for slot, g in enumerate(grammars):
            eng._active[slot] = mod._Active(seq_id=slot, slot=slot,
                                            prompt_tokens=10,
                                            max_new_tokens=50, grammar=g)
        tables, states, remaining = eng._scan_dfa_setup()
        eng._active.clear()
        fused.append(([np.asarray(t) if not hasattr(t, "numpy")
                       else t.numpy() for t in tables],
                      states, remaining, grammars))
    (jt, js, jr, jg), (tt, ts, tr, tg) = fused
    np.testing.assert_array_equal(tr, jr)
    n_states = sum(g.tables.n_states for g in tg)
    assert tt[0].shape[0] == jt[0].shape[0] == 1024 * -(-n_states // 1024)
    used = np.zeros(tt[0].shape[0], bool)
    for slot, (g_j, g_t) in enumerate(zip(jg, tg)):
        n = g_t.tables.n_states
        oj = int(js[slot]) - g_j.state
        ot = int(ts[slot]) - g_t.state
        used[ot:ot + n] = True
        for a, b in zip(jt, tt):
            rows_j, rows_t = a[oj:oj + n], b[ot:ot + n]
            if a.ndim == 2 and a.dtype != bool:       # next states shift
                rows_j, rows_t = rows_j - oj, rows_t - ot
            np.testing.assert_array_equal(rows_t, rows_j)
    for b in tt:
        assert not b[~used].any()


def test_dfa_tables_live_once_per_padded_size():
    """Two grammar combinations of one padded size share one set of table
    buffers: switching combinations rewrites them in place (the buffers a
    captured DFA scan reads), and each switch gives the tables a fresh
    fusion would, dead rows zero."""
    schemas = (MIXED_SCHEMA, {"type": "object", "properties": [
        ("ok", {"enum": ["yes", "no"]})]})
    _, te = engines()
    grammars = [DFAGrammar(s, te.tokenizer) for s in schemas]

    def fuse(*slots_grammars):
        te._active.clear()
        for slot, g in slots_grammars:
            te._active[slot] = tengine._Active(seq_id=slot, slot=slot,
                                               prompt_tokens=10,
                                               max_new_tokens=50, grammar=g)
        tables, states, _ = te._scan_dfa_setup()
        return tables, states, [t.clone() for t in tables]

    first, s1, snap1 = fuse((0, grammars[0]))
    second, s2, snap2 = fuse((0, grammars[1]))
    assert first[0].shape == second[0].shape == (1024, first[0].shape[1])
    assert all(a is b for a, b in zip(first, second))
    assert len(te._dfa_static) == 1
    for (g, s, snap) in ((grammars[0], s1, snap1), (grammars[1], s2, snap2)):
        n = g.tables.n_states
        t = g.tables
        for got, want in zip(snap, (t.allow, t.token_next, t.dist,
                                    t.close_tok, t.complete)):
            np.testing.assert_array_equal(got[:n].numpy(), want)
            assert not got[n:].any()
        assert int(s[0]) == g.state
    again, _, snap3 = fuse((0, grammars[0]))
    assert all(a is b for a, b in zip(first, again))
    for a, b in zip(snap3, snap1):
        assert torch.equal(a, b)
    te._active.clear()
