"""The port's fault injection and resilience against the JAX package's:
seeded plans, the retry and breaker policy, the graph, backend and engine
tick injection sites, the chaos soak and the resilient pipelined sweep.

Plans and policies are pure Python in both packages, so the same seed and
spec give the same schedule and the same backoff.  The soaks run the JAX
package's stacks on the same weights (the JAX soak's ``PRNGKey(0)`` TINY
carried through numpy) and their report bytes must be equal."""

import jax
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.config import TINY as J_TINY
from k8s_llm_rca_tpu.faults import inject as jinject
from k8s_llm_rca_tpu.faults import plan as jplan
from k8s_llm_rca_tpu.faults import policy as jpolicy
from k8s_llm_rca_tpu.faults import soak as jsoak
from k8s_llm_rca_tpu.models import llama as jllama
from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
from k8s_llm_rca_tpu_torch.engine import make_engine
from k8s_llm_rca_tpu_torch.faults import inject, soak
from k8s_llm_rca_tpu_torch.faults.plan import Fault, FaultPlan, VirtualClock
from k8s_llm_rca_tpu_torch.faults.policy import (
    CircuitBreaker, CircuitOpen, ResiliencePolicy, ResilientExecutor,
    RetriesExhausted, RetryPolicy,
)
from k8s_llm_rca_tpu_torch.graph import InMemoryGraphExecutor
from k8s_llm_rca_tpu_torch.graph.fixtures import build_stategraph
from k8s_llm_rca_tpu_torch.models.llama import init_params, params_from_numpy
from k8s_llm_rca_tpu_torch.serve.api import AssistantService, RunStatus
from k8s_llm_rca_tpu_torch.serve.backend import (
    BudgetError, EngineBackend, GenOptions,
)
from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _disarmed():
    """Never leak an armed plan into other tests."""
    yield
    for mod in (inject, jinject):
        if mod.active() is not None:
            mod.disarm()


@pytest.fixture(scope="module")
def shared_engine():
    """The JAX fault tests' engine (TINY at max_seq_len 64, page 8, 24
    pages, decode_chunk 1, so tick indices count decode steps) on seeded
    port weights, with spill on; every test leaves it drained."""
    cfg = TINY.replace(max_seq_len=64)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    eng = make_engine(
        cfg, EngineConfig(max_batch=4, max_seq_len=64, paged=True,
                          page_size=8, num_pages=24,
                          prefill_buckets=(16, 32), max_new_tokens=8,
                          temperature=0.0, decode_chunk=1,
                          prefix_cache=False, max_spilled_pages=16),
        init_params(cfg, torch.Generator().manual_seed(0), "cpu"), tok,
        device="cpu")
    return eng, tok


def _schedule(p):
    return [(f.site, f.index, f.kind, f.delay_s, f.wave)
            for site in sorted(p._by_site)
            for f in sorted(p._by_site[site].values(),
                            key=lambda f: f.index)]


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fault_plan_schedules_match_jax(seed):
    """``FaultPlan.from_spec`` on the chaos soak's spec plus an explicit
    rule: the same faults as the JAX plan, and the same polls."""
    spec = soak.default_plan_spec()
    spec["extra.site"] = {"indices": {3: "preempt", 1: "crash"}, "wave": 2}
    ours = FaultPlan.from_spec(seed, spec)
    theirs = jplan.FaultPlan.from_spec(seed, spec)
    assert _schedule(ours) == _schedule(theirs)
    for site in (inject.SITE_GRAPH, inject.SITE_ENGINE_TICK, "extra.site"):
        for _ in range(50):
            a, b = ours.poll(site), theirs.poll(site)
            assert (a is None) == (b is None)
    assert ours.snapshot() == theirs.snapshot()
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan([Fault("x", 0, "meltdown")])
    with inject.armed(FaultPlan()):
        with pytest.raises(RuntimeError, match="already armed"):
            inject.arm(FaultPlan())


def test_retry_and_breaker_match_jax():
    """The seeded backoff, the deadline budget and the breaker's
    closed/open/half-open walk, on virtual clocks, equal JAX's."""
    def walk(mod_plan, mod_policy):
        clock = mod_plan.VirtualClock()
        log = [list(mod_policy.RetryPolicy(max_attempts=5, seed=3,
                                           clock=clock).delays())]
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("down")
            return "ok"
        pol = mod_policy.RetryPolicy(max_attempts=4, seed=1, clock=clock)
        log.append((pol.call(flaky), calls["n"], round(clock.time(), 9)))
        br = mod_policy.CircuitBreaker("dep", failure_threshold=2,
                                       reset_timeout_s=1.0, clock=clock)
        for step in ("f", "f", "a", "s", "f", "f", "a", "s", "a"):
            if step == "f":
                br.record_failure()
            elif step == "s":
                clock.sleep(1.0)
            else:
                log.append(br.allow())
            log.append(br.snapshot())
        pol = mod_policy.RetryPolicy(max_attempts=5, base_delay_s=1.0,
                                     deadline_s=1.5, clock=clock)
        try:
            pol.call(lambda: 1 / 0)
        except mod_policy.RetriesExhausted as e:
            log.append(str(e))
        return log
    assert walk(__import__("k8s_llm_rca_tpu_torch.faults.plan",
                           fromlist=["x"]),
                __import__("k8s_llm_rca_tpu_torch.faults.policy",
                           fromlist=["x"])) == walk(jplan, jpolicy)
    clock = VirtualClock()
    br = CircuitBreaker("g", failure_threshold=1, reset_timeout_s=9.0,
                        clock=clock)
    br.record_failure()
    with pytest.raises(CircuitOpen):
        RetryPolicy(clock=clock).call(lambda: 1, breaker=br)
    with pytest.raises(RetriesExhausted):
        RetryPolicy(max_attempts=2, clock=clock).call(lambda: 1 / 0)


def test_graph_injection_and_resilient_executor():
    """Each graph fault kind at its poll index, inert before and after;
    behind ``ResilientExecutor`` a dependency that stays down degrades to
    empty rows and is counted."""
    q = ("MATCH (n1:Event)-[s1:HasEvent]->(N1:EVENT) WHERE N1.message "
         "CONTAINS $message RETURN n1.kind")
    par = {"message": "secret"}
    ex = InMemoryGraphExecutor(build_stategraph())
    want = [r["n1.kind"] for r in ex.run_query(q, par)]
    assert want
    plan = FaultPlan([Fault(inject.SITE_GRAPH, 0, "error"),
                      Fault(inject.SITE_GRAPH, 1, "timeout"),
                      Fault(inject.SITE_GRAPH, 2, "empty"),
                      Fault(inject.SITE_GRAPH, 3, "slow", delay_s=0.5),
                      Fault(inject.SITE_GRAPH, 4, "poison")])
    with inject.armed(plan):
        with pytest.raises(inject.InjectedFault):
            ex.run_query(q, par)
        with pytest.raises(inject.InjectedTimeout):
            ex.run_query(q, par)
        assert ex.run_query(q, par) == []
        assert [r["n1.kind"] for r in ex.run_query(q, par)] == want
        assert plan.clock.time() == pytest.approx(0.5)
        with pytest.raises(KeyError, match="poisoned"):
            ex.run_query(q, par)[0]["n1.kind"]
        assert [r["n1.kind"] for r in ex.run_query(q, par)] == want
    clock = VirtualClock()
    policy = ResiliencePolicy(retry=RetryPolicy(max_attempts=2,
                                                clock=clock))
    rex = ResilientExecutor(ex, policy, dep="graph.state")
    down = FaultPlan([Fault(inject.SITE_GRAPH, i, "error")
                      for i in range(4)], clock=clock)
    with inject.armed(down):
        assert rex.run_query(q, par) == []
    assert policy.counters["degraded_queries:graph.state"] == 1
    assert policy.counters["retries"] == 1


@pytest.mark.parametrize("faults", [
    [Fault(inject.SITE_ENGINE_TICK, 2, "preempt", wave=2)],
    [Fault(inject.SITE_ENGINE_TICK, 1, "oom")],
    [Fault(inject.SITE_ENGINE_TICK, 3, "crash")],
    [Fault(inject.SITE_ENGINE_TICK, 2, "stall", delay_s=0.2)],
], ids=["preempt", "oom", "crash", "stall"])
def test_tick_faults_keep_greedy_output(shared_engine, faults):
    """A preemption wave (through spill), allocator exhaustion for one
    tick, a crash that drops every sequence's KV for re-prefill, and a
    host stall: the greedy streams equal the unfaulted run's, and the
    allocator ends whole."""
    eng, tok = shared_engine
    ids = [tok.encode(p, add_bos=True) for p in
           ("pod crashloop kube-system", "node disk pressure",
            "pvc not bound storageclass")]
    want = [r.token_ids for r in eng.generate([list(i) for i in ids])]
    before = dict(eng._counts)
    plan = FaultPlan(faults)
    with inject.armed(plan):
        got = [r.token_ids for r in eng.generate([list(i) for i in ids])]
    assert got == want
    assert len(plan.fired) == 1
    gained = {k: v - before.get(k, 0) for k, v in eng._counts.items()}
    kind = faults[0].kind
    if kind == "preempt":
        assert gained["engine.preemptions"] == 2
        assert gained["engine.restored_pages"] > 0
    elif kind == "crash":
        assert gained["engine.crash_evictions"] == 3
        assert gained.get("engine.spilled_pages", 0) == 0
    elif kind == "oom":
        assert not eng._fault_pages
    else:
        assert plan.clock.time() == pytest.approx(0.2)
    eng.allocator.check()
    assert not eng.has_work
    assert eng.allocator.n_free == eng.engine_cfg.num_pages - 1


def test_backend_faults(shared_engine):
    """"error" fails the run, "budget" raises ``BudgetError`` at create,
    "stall" expires on the virtual deadline with nothing left in the
    engine."""
    eng, _ = shared_engine
    clock = VirtualClock()
    service = AssistantService(EngineBackend(eng), run_timeout_s=0.5,
                               clock=clock)
    a = service.create_assistant("test", "t")

    def run():
        th = service.create_thread()
        service.add_message(th.id, "q")
        return service.create_run(th.id, a.id,
                                  gen=GenOptions(max_new_tokens=8))
    plan = FaultPlan([Fault(inject.SITE_BACKEND, 0, "error"),
                      Fault(inject.SITE_BACKEND, 1, "budget"),
                      Fault(inject.SITE_BACKEND, 2, "stall")], clock=clock)
    with inject.armed(plan):
        got = service.wait_run(run().id)
        assert got.status == RunStatus.FAILED and "injected" in got.error
        with pytest.raises(BudgetError, match="injected"):
            run()
        got = service.wait_run(run().id)
        assert got.status == RunStatus.EXPIRED
    assert not eng.has_work
    assert eng.allocator.n_free == eng.engine_cfg.num_pages - 1


@pytest.fixture(scope="module")
def soak_params():
    p = jllama.init_params(J_TINY.replace(max_seq_len=2560),
                           jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _tick_spec():
    """The soak's spec with every engine tick fault kind at a fixed tick
    (the default rate fires only a stall over one incident)."""
    spec = soak.default_plan_spec()
    spec[inject.SITE_ENGINE_TICK] = {
        "indices": {3: "preempt", 9: "oom", 15: "crash", 21: "stall"},
        "delay_s": 0.01}
    return spec


@pytest.mark.parametrize("backend", ["engine", "oracle"])
def test_chaos_soak_report_bytes_match_jax(backend, soak_params):
    """The chaos soak's report bytes equal JAX's: one incident on the
    engine under every tick fault kind, six on the scripted oracle under
    the default mix; every incident completes and the engine ends
    clean."""
    if backend == "engine":
        kw = dict(n_incidents=1, plan_spec=_tick_spec())
        ours = soak.run_chaos_soak(
            backend="engine", model_cfg=TINY.replace(max_seq_len=2560),
            params=soak_params, device="cpu", **kw)
    else:
        kw = dict(n_incidents=6)
        ours = soak.run_chaos_soak(backend="oracle", **kw)
    theirs = jsoak.run_chaos_soak(backend=backend, **kw)
    assert soak.report_bytes(ours) == jsoak.report_bytes(theirs)
    assert ours["failed"] == 0 and ours["completed"] == kw["n_incidents"]
    assert ours["faults"]["fired"]
    if backend == "engine":
        assert ours["engine_clean"] is True
        assert {f[2] for f in ours["faults"]["fired"]} >= {
            "preempt", "oom", "crash", "stall"}


def test_resilient_sweep_under_graph_faults_matches_jax():
    """``run_pipelined_sweep(resilience=True)`` at concurrency 1 under an
    armed plan that takes the graph down for a stretch: the report bytes
    and the summed ladder counters equal JAX's, and the degraded stages
    are annotated; at concurrency 2 the armed plan is refused."""
    spec = {inject.SITE_GRAPH: {"indices": {i: "error"
                                            for i in range(4, 16)}}}
    outs = []
    for mod_inject, mod_plan, mod_soak in ((inject, __import__(
            "k8s_llm_rca_tpu_torch.faults.plan", fromlist=["x"]), soak),
            (jinject, jplan, jsoak)):
        with mod_inject.armed(mod_plan.FaultPlan.from_spec(0, spec)):
            outs.append(mod_soak.run_pipelined_sweep(
                backend="oracle", n_incidents=3, concurrency=1,
                resilience=True))
    ours, theirs = outs
    assert soak.report_bytes(ours["report"]) == jsoak.report_bytes(
        theirs["report"])
    assert ours["stats"]["policy"] == theirs["stats"]["policy"]
    assert ours["report"]["degraded"] >= 1
    assert ours["report"]["completed"] == 3
    with inject.armed(FaultPlan.from_spec(0, spec)):
        with pytest.raises(ValueError, match="concurrency > 1"):
            soak.run_pipelined_sweep(backend="oracle", n_incidents=2,
                                     concurrency=2, resilience=True)
