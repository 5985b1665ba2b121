"""KV spill and snapshot/restore: the port's paged engine against the JAX
engine and against its own uninterrupted run.

The engines are ``test_torch_engine``'s (TINY, projections x3, page 16,
max_seq_len 512, decode_chunk 16).  A 52-page pool admits the four
prompts, then growth runs it dry and preempts the youngest: with
``max_spilled_pages`` its written pages go to the host and come back by an
in-place restore, with a 4-page budget it falls back to a re-prefill."""

import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu_torch.faults import inject
from k8s_llm_rca_tpu_torch.faults.plan import Fault, FaultPlan

from test_torch_engine import engines

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

SPILL_COUNTERS = ("engine.spilled_pages", "engine.restored_pages",
                  "engine.preemptions", "engine.spill_budget_fallbacks",
                  "engine.prefill_tokens", "engine.d2h_syncs")


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, 256, n)]
            for n in (120, 120, 250, 250)]


def _counts(eng):
    return {k: eng._counts.get(k, 0) for k in SPILL_COUNTERS}


@pytest.fixture(scope="module")
def uninterrupted():
    """The four prompts' streams with pages to spare (no preemption)."""
    _, te = engines(decode_chunk=16)
    return [r.token_ids for r in te.generate(_prompts())]


@pytest.mark.parametrize("budget", [64, 4], ids=["spill", "budget-fallback"])
def test_spill_streams_and_counters_match_jax(budget, uninterrupted):
    """Budget 64: the preempted sequence spills 16 pages and restores
    them (no re-prefill); budget 4: the spill would exceed it, so it is
    counted as a fallback and re-prefills.  Both: streams and counters
    equal JAX's, and the streams equal the uninterrupted run's."""
    je, te = engines(decode_chunk=16, num_pages=52, max_spilled_pages=budget)
    prompts = _prompts()
    got = [r.token_ids for r in te.generate(prompts)]
    assert got == [r.token_ids for r in je.generate(prompts)]
    assert _counts(te) == _counts(je)
    assert got == uninterrupted
    c = te._counts
    assert c["engine.preemptions"] >= 1
    if budget == 64:
        assert c["engine.spilled_pages"] == c["engine.restored_pages"] > 0
        assert not te._spilled and te._spilled_pages_total == 0
    else:
        assert c["engine.spill_budget_fallbacks"] >= 1
        assert c.get("engine.spilled_pages", 0) == 0
    te.allocator.check()
    assert te.allocator.n_free == te.engine_cfg.num_pages - 1


def test_preempt_fault_spills_and_restores_in_place(uninterrupted):
    """A "preempt" tick fault with spill on: the victim's pages gather to
    the host and come back into other page ids of the SAME pool tensors,
    and the streams stay those of the uninterrupted run; a cancel of a
    spilled, queued sequence drops its record."""
    _, te = engines(decode_chunk=16, max_spilled_pages=64)
    k_storage = te.pool.k.data_ptr()
    plan = FaultPlan([Fault(inject.SITE_ENGINE_TICK, 1, "preempt", wave=2)])
    with inject.armed(plan):
        got = [r.token_ids for r in te.generate(_prompts())]
    assert got == uninterrupted
    assert te._counts["engine.restored_pages"] > 0
    assert te.pool.k.data_ptr() == k_storage
    # between ticks a preempted sequence waits spilled in the queue (the
    # next tick's admission restores it): cancel it there
    sids = [te.submit(p, max_new_tokens=40) for p in _prompts()[:2]]
    for _ in range(2):
        te.step()
    assert te._preempt_victim()
    cancelled = list(te._spilled)
    assert len(cancelled) == 1
    for sid in cancelled:
        assert te.cancel_seq(sid)
    assert not te._spilled and te._spilled_pages_total == 0
    assert [r.seq_id for r in te.run_to_completion()] == [
        s for s in sids if s not in cancelled]
    te.allocator.check()
    assert te.allocator.n_free == te.engine_cfg.num_pages - 1


def _drive(eng, n_ticks):
    out = {}
    for _ in range(n_ticks):
        for r in eng.step():
            out[r.seq_id] = r.token_ids
    return out


def test_snapshot_mid_decode_and_restore_match_jax():
    """Snapshot both engines mid-decode, three sequences decoding and the
    fourth queued with its KV spilled: the ``sequences`` lists are equal.  Each
    snapshot restored into a fresh engine of its package finishes with
    the same streams, equal to the uninterrupted engine's."""
    prompts = _prompts()
    over = dict(decode_chunk=16, num_pages=52, max_spilled_pages=64,
                prefix_cache=True)
    je, te = engines(**over)
    for eng in (je, te):
        for p in prompts:
            eng.submit(p)
    early = [_drive(e, 3) for e in (je, te)]
    assert early[0] == early[1] == {}
    assert list(te._spilled) == [2] and len(te._active) == 3
    snaps = [e.snapshot_sequences() for e in (je, te)]
    assert snaps[1]["sequences"] == snaps[0]["sequences"]
    assert [s["seq_id"] for s in snaps[1]["sequences"]] == [0, 1, 3, 2]
    assert all(s["generated"] for s in snaps[1]["sequences"])
    assert len(snaps[1]["rng_key"]) == te._gen.get_state().numel()
    finished = []
    for snap, fresh in zip(snaps, engines(**over)):
        fresh.restore_sequences(snap)
        done = dict(early[0])
        done.update({sid: r.token_ids
                     for sid, r in ((r.seq_id, r)
                                    for r in fresh.run_to_completion())})
        finished.append([done[i] for i in range(len(prompts))])
    assert finished[1] == finished[0]
    _, ref = engines(**over)
    assert finished[1] == [r.token_ids for r in ref.generate(prompts)]
