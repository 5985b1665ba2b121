"""The port's serving durability against the JAX package's: the run
journal, crash recovery, service save/load, the supervised crash, the
Prometheus export, and the paged engine's phase timers.

The journal payload is compact sorted-key JSON in both packages, so the
same calls under the same clock write byte-identical files, and each
package replays the other's.  The engine cases run TINY on the JAX
durability tests' engine (max_seq_len 64, page 8, 24 pages, decode_chunk
1, no prefix cache) on the JAX ``PRNGKey(0)`` weights carried through
numpy; one JAX engine run, a module fixture, serves both."""

import json
import os
import re
import time

import jax
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.config import TINY as J_TINY
from k8s_llm_rca_tpu.config import EngineConfig as JEngineConfig
from k8s_llm_rca_tpu.engine import make_engine as j_make_engine
from k8s_llm_rca_tpu.faults import soak as jsoak
from k8s_llm_rca_tpu.models import llama as jllama
from k8s_llm_rca_tpu.obs import export as jexport
from k8s_llm_rca_tpu.serve import api as japi
from k8s_llm_rca_tpu.serve import backend as jbackend
from k8s_llm_rca_tpu.serve import journal as jjournal
from k8s_llm_rca_tpu.serve import recover as jrecover
from k8s_llm_rca_tpu.utils import logging as jlogging
from k8s_llm_rca_tpu.utils import tokenizer as jtokenizer
from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
from k8s_llm_rca_tpu_torch.engine import make_engine
from k8s_llm_rca_tpu_torch.faults import inject, soak
from k8s_llm_rca_tpu_torch.faults.plan import Fault, FaultPlan
from k8s_llm_rca_tpu_torch.faults.supervisor import CrashSupervisor
from k8s_llm_rca_tpu_torch.models.llama import params_from_numpy
from k8s_llm_rca_tpu_torch.obs import export
from k8s_llm_rca_tpu_torch.serve import api, backend, journal, recover
from k8s_llm_rca_tpu_torch.serve.api import AssistantService, RunStatus
from k8s_llm_rca_tpu_torch.serve.backend import (
    BudgetError, EchoBackend, EngineBackend, GenOptions,
)
from k8s_llm_rca_tpu_torch.serve.journal import (
    RunJournal, decode_gen, encode_gen, read_journal,
)
from k8s_llm_rca_tpu_torch.serve.recover import recover_service
from k8s_llm_rca_tpu_torch.sweeps.run_file import scan_output
from k8s_llm_rca_tpu_torch.utils import tokenizer
from k8s_llm_rca_tpu_torch.utils import wal
from k8s_llm_rca_tpu_torch.utils.logging import METRICS

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

PORT = {"api": api, "backend": backend, "journal": journal,
        "recover": recover, "tokenizer": tokenizer}
JAX = {"api": japi, "backend": jbackend, "journal": jjournal,
       "recover": jrecover, "tokenizer": jtokenizer}
# the JAX durability tests' engine
ECFG = dict(max_batch=4, max_seq_len=64, paged=True, page_size=8,
            num_pages=24, prefill_buckets=(16, 32), max_new_tokens=8,
            temperature=0.0, decode_chunk=1, prefix_cache=False)


class _FixedClock:
    """A service clock that never moves: run timestamps are constants and
    no deadline passes."""

    def time(self) -> float:
        return 1700000000.25

    def sleep(self, s: float) -> None:
        pass


@pytest.fixture
def fixed_time(monkeypatch):
    """``add_message`` stamps messages with ``time.time()`` in both
    packages: pin it too."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.5)


def _script(pkg, path):
    """The scripted sequence: an assistant, a thread, a message, then a
    run completed with the fixed reply, one left in flight, one cancelled
    and one failed, all on one EchoBackend whose options change between
    runs.  Returns (service, run ids by outcome)."""
    tok = pkg["tokenizer"].get_tokenizer()
    echo = pkg["backend"].EchoBackend(tok, reply="the answer",
                                      delay_pumps=0, fail=False)
    Gen = pkg["backend"].GenOptions
    svc = pkg["api"].AssistantService(
        echo, clock=_FixedClock(),
        journal=pkg["journal"].RunJournal(path))
    a = svc.create_assistant("triage", "analyst", gen=Gen(
        max_new_tokens=8, stop=("```",), grammar={"type": "object"}))
    th = svc.create_thread()
    svc.add_message(th.id, "pod crashloop in kube-system")
    done = svc.wait_run(svc.create_run(th.id, a.id).id)
    echo.delay_pumps = 10 ** 9
    inflight = svc.create_run(th.id, a.id, instructions="be brief")
    cancelled = svc.create_run(th.id, a.id, gen=Gen(max_new_tokens=4))
    svc.cancel_run(cancelled.id)
    echo.delay_pumps, echo.fail = 0, True
    failed = svc.wait_run(svc.create_run(th.id, a.id).id)
    svc._journal.close()
    ids = {"completed": done.id, "inflight": inflight.id,
           "cancelled": cancelled.id, "failed": failed.id}
    assert [svc.runs[i].status for i in ids.values()] == [
        RunStatus.COMPLETED, RunStatus.IN_PROGRESS, RunStatus.CANCELLED,
        RunStatus.FAILED]
    return svc, ids


@pytest.fixture
def journals(tmp_path, fixed_time):
    """The scripted sequence through both packages: (port path, JAX path,
    port service, JAX service, run ids)."""
    p, j = str(tmp_path / "port.wal"), str(tmp_path / "jax.wal")
    svc, ids = _script(PORT, p)
    jsvc, jids = _script(JAX, j)
    assert ids == jids
    return p, j, svc, jsvc, ids


def test_journal_files_are_byte_identical(journals):
    p, j, _, _, _ = journals
    with open(p, "rb") as f, open(j, "rb") as g:
        port_bytes, jax_bytes = f.read(), g.read()
    assert port_bytes == jax_bytes and len(port_bytes) > 0
    kinds = [r["kind"] for r in read_journal(p)[0]]
    assert kinds == ["create_assistant", "create_thread", "add_message",
                     "run_submit", "run_settle", "run_submit", "run_submit",
                     "run_settle", "run_submit", "run_settle"]


def test_each_package_reads_the_others_journal(journals, tmp_path):
    """``read_journal`` of either package decodes the other's file to the
    same records, and both drop a torn tail at the same clean offset."""
    p, j, _, _, _ = journals
    assert read_journal(j) == jjournal.read_journal(p)
    torn = str(tmp_path / "torn.wal")
    with open(torn, "wb") as f:
        f.write(open(j, "rb").read() + wal.pack_record(b'{"kind":"x"}')[:-3])
    want = (read_journal(p)[0], os.path.getsize(p))
    assert read_journal(torn) == jjournal.read_journal(torn) == want


def test_recovery_reports_equal_across_packages(journals):
    """Each package's ``recover_service`` replays the other's journal to
    the report its own journal gives under the other package."""
    p, j, _, _, ids = journals
    tok, jtok = tokenizer.get_tokenizer(), jtokenizer.get_tokenizer()
    for path in (p, j):
        svc, report = recover_service(path, EchoBackend(tok))
        jsvc, jreport = jrecover.recover_service(path, jbackend.EchoBackend(
            jtok))
        assert report == jreport
        assert report["resubmitted"] == [ids["inflight"]]
        assert {k: r.status for k, r in svc.runs.items()} == {
            k: r.status for k, r in jsvc.runs.items()}
        assert svc.create_thread().id == jsvc.create_thread().id


def _store_view(svc):
    """A service's store as plain data (assistants, threads, runs, the
    per-thread run lists and the next id)."""
    nxt = svc.create_thread().id
    return {
        "assistants": {a.id: (a.name, a.instructions, a.model,
                              a.gen.max_new_tokens, tuple(a.gen.stop),
                              a.gen.forced_prefix, a.gen.suffix,
                              a.gen.grammar)
                       for a in svc.assistants.values()},
        "threads": {t.id: [(m.id, m.role, m.raw_content, m.created_at)
                           for m in t.messages]
                    for t in svc.threads.values() if t.id != nxt},
        "runs": {r.id: (r.thread_id, r.assistant_id, r.status,
                        r.created_at, r.completed_at, dict(r.usage),
                        r.error, r.response_message_id)
                 for r in svc.runs.values()},
        "thread_runs": {k: v for k, v in svc._thread_runs.items()
                        if k != nxt},
        "next": nxt}


def test_saved_service_state_loads_in_either_package(journals, tmp_path):
    """``save_service_state`` of either package loads in the other to the
    same store (terminal runs only, as saved)."""
    _, _, svc, jsvc, _ = journals
    p, j = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    api.save_service_state(svc, p)
    japi.save_service_state(jsvc, j)
    assert open(p).read() == open(j).read()
    tok, jtok = tokenizer.get_tokenizer(), jtokenizer.get_tokenizer()
    views = [_store_view(api.load_service_state(path, EchoBackend(tok)))
             for path in (p, j)]
    views += [_store_view(japi.load_service_state(
        path, jbackend.EchoBackend(jtok))) for path in (p, j)]
    assert views[0]["runs"] and all(v == views[0] for v in views)


def _drive_lifecycle(service, text="pod crashloop", wait=True):
    a = service.create_assistant("test", "t")
    th = service.create_thread()
    service.add_message(th.id, text)
    run = service.create_run(th.id, a.id, gen=GenOptions(max_new_tokens=8))
    if wait:
        run = service.wait_run(run.id)
    return a, th, run


def _crashed_journal(tmp_path):
    """A journaled service with one run in flight, then "killed"."""
    path = str(tmp_path / "serve.wal")
    tok = tokenizer.get_tokenizer()
    service = AssistantService(EchoBackend(tok, delay_pumps=10 ** 9),
                               journal=RunJournal(path))
    _, _, run = _drive_lifecycle(service, wait=False)
    service._journal.close()
    return path, tok, run


def test_interrupted_run_is_resubmitted_with_its_session(tmp_path):
    path, tok, run = _crashed_journal(tmp_path)
    seen = []

    class Recording(EchoBackend):
        def start(self, prompt, opts):
            seen.append(opts)
            return super().start(prompt, opts)

    svc, report = recover_service(path, Recording(tok, reply="after"),
                                  run_timeout_s=30.0)
    assert report["resubmitted"] == [run.id] and report["interrupted"] == 1
    assert (seen[0].session, seen[0].deadline_s) == (run.thread_id, 30.0)
    got = svc.wait_run(run.id)
    assert got.status == RunStatus.COMPLETED
    assert svc.list_messages(got.thread_id).data[0].raw_content == "after"


def test_settled_run_is_replayed_not_reexecuted(tmp_path):
    path = str(tmp_path / "serve.wal")
    tok = tokenizer.get_tokenizer()
    service = AssistantService(EchoBackend(tok, reply="first answer"),
                               journal=RunJournal(path))
    _, th, run = _drive_lifecycle(service)
    service._journal.close()

    class NeverStarts(EchoBackend):
        def start(self, prompt, opts):
            raise AssertionError("settled run re-executed")

    svc, report = recover_service(path, NeverStarts(tok))
    assert report["resubmitted"] == []
    assert svc.runs[run.id].status == RunStatus.COMPLETED
    assert svc.runs[run.id].usage == run.usage
    assert "first answer" in [m.raw_content
                              for m in svc.threads[th.id].messages]


def test_cancelled_run_stays_cancelled(tmp_path):
    path = str(tmp_path / "serve.wal")
    tok = tokenizer.get_tokenizer()
    service = AssistantService(EchoBackend(tok, delay_pumps=10 ** 9),
                               journal=RunJournal(path))
    _, _, cancelled = _drive_lifecycle(service, wait=False)
    service.cancel_run(cancelled.id)
    _, _, inflight = _drive_lifecycle(service, wait=False)
    service._journal.close()
    svc, report = recover_service(path, EchoBackend(tok))
    assert svc.runs[cancelled.id].status == RunStatus.CANCELLED
    assert report["resubmitted"] == [inflight.id]
    assert svc.wait_run(inflight.id).status == RunStatus.COMPLETED


def test_run_durable_in_the_sweep_output_is_reconciled(tmp_path):
    path, tok, run = _crashed_journal(tmp_path)
    out = tmp_path / "rca.json"
    out.write_text(json.dumps({"error_message": "pod crashloop",
                               "analysis": []}, indent=4) + "\n")
    svc, report = recover_service(path, EchoBackend(tok),
                                  sweep_output=str(out))
    assert report["reconciled"] == [run.id] and report["resubmitted"] == []
    assert svc.runs[run.id].status == RunStatus.CANCELLED
    assert "already durable" in svc.runs[run.id].error


def test_budget_rejected_resubmission_fails_the_run(tmp_path):
    path, tok, run = _crashed_journal(tmp_path)

    class Shrunk(EchoBackend):
        def start(self, prompt, opts):
            raise BudgetError("prompt over the recovery budget")

    svc, report = recover_service(path, Shrunk(tok))
    assert report["failed_resubmit"] == [run.id]
    assert svc.runs[run.id].status == RunStatus.FAILED
    assert "resubmit rejected" in svc.runs[run.id].error


def test_id_counter_resumes_past_journaled_ids(tmp_path):
    path, tok, _ = _crashed_journal(tmp_path)
    svc, _ = recover_service(path, EchoBackend(tok))
    top = max(int(m.group(1)) for r in read_journal(path)[0]
              for m in [re.search(r"_(\d+)$", str(r.get("id", "")))] if m)
    fresh = svc.create_thread()
    assert int(re.search(r"_(\d+)$", fresh.id).group(1)) > top


def test_unknown_record_kind_refuses_to_replay(tmp_path):
    path = str(tmp_path / "serve.wal")
    with RunJournal(path) as j:
        j.append("frobnicate", id="x_1")
    with pytest.raises(ValueError, match="unknown journal record"):
        recover_service(path, EchoBackend(tokenizer.get_tokenizer()))


def test_compiled_grammar_cannot_be_journaled():
    gen = GenOptions(max_new_tokens=9, stop=("```",), forced_prefix="p",
                     suffix="s", grammar={"type": "object"},
                     assistant_name="a")
    assert decode_gen(encode_gen(gen)) == gen

    class CompiledFsm:
        pass

    with pytest.raises(ValueError, match="spec"):
        encode_gen(GenOptions(grammar=CompiledFsm()))


def test_no_journal_means_no_journal_work(monkeypatch):
    """Without a journal every run path (complete, cancel, expire) works
    with the whole journal surface made to raise."""
    def boom(*a, **k):
        raise AssertionError("journal I/O on the default path")

    monkeypatch.setattr(journal.RunJournal, "__init__", boom)
    monkeypatch.setattr(journal.RunJournal, "append", boom)
    monkeypatch.setattr(wal, "append_record", boom)
    tok = tokenizer.get_tokenizer()
    _, _, run = _drive_lifecycle(AssistantService(EchoBackend(tok)))
    assert run.status == RunStatus.COMPLETED
    slow = AssistantService(EchoBackend(tok, delay_pumps=10 ** 9))
    _, _, r_cancel = _drive_lifecycle(slow, wait=False)
    assert slow.cancel_run(r_cancel.id).status == RunStatus.CANCELLED
    _, _, r_expire = _drive_lifecycle(slow, wait=False)
    assert slow.wait_run(r_expire.id, timeout_s=0.0).status == \
        RunStatus.EXPIRED


def test_scan_output_drops_a_torn_tail_atomically(tmp_path):
    def record(msg):
        return json.dumps({"error_message": msg, "analysis": []},
                          indent=4) + "\n"

    out = tmp_path / "rca.json"
    out.write_text(record("a") + record("b")
                   + '{\n    "error_message": "c", "anal')
    msgs, end = scan_output(str(out))
    assert msgs == ["a", "b"] and '"c"' in out.read_text()
    assert scan_output(str(out), truncate_partial=True) == (msgs, end)
    assert '"c"' not in out.read_text()
    assert not os.path.exists(str(out) + ".tmp")
    with open(out, "a") as f:
        f.write(record("c"))
    assert scan_output(str(out))[0] == ["a", "b", "c"]


# ---------------------------------------------------------------------------
# the supervised crash
# ---------------------------------------------------------------------------


def test_supervised_crash_soak_bytes_equal_unsupervised_and_jax(tmp_path):
    """A soak killed at an incident boundary and recovered from its
    journal reports the bytes of the uninterrupted soak, the port's and
    the JAX package's."""
    base = soak.run_chaos_soak(seed=5, n_incidents=3, backend="oracle")
    sup = CrashSupervisor(FaultPlan([Fault(inject.SITE_PROCESS, 1,
                                           "crash")]),
                          str(tmp_path / "serve.wal"))
    resumed = soak.run_chaos_soak(seed=5, n_incidents=3, backend="oracle",
                                  durable_dir=str(tmp_path), supervisor=sup)
    jbase = jsoak.run_chaos_soak(seed=5, n_incidents=3, backend="oracle")
    assert sup.crashes == 1 and sup.recoveries[0]["records"] > 0
    assert soak.report_bytes(resumed) == soak.report_bytes(base) == \
        jsoak.report_bytes(jbase)
    assert (resumed["failed"], resumed["completed"]) == (0, 3)
    records, end = read_journal(str(tmp_path / "serve.wal"))
    assert records and end == os.path.getsize(str(tmp_path / "serve.wal"))


def test_journaled_soak_report_equals_unjournaled(tmp_path):
    plain = soak.run_chaos_soak(seed=7, n_incidents=2, backend="oracle")
    journaled = soak.run_chaos_soak(seed=7, n_incidents=2, backend="oracle",
                                    durable_dir=str(tmp_path))
    assert soak.report_bytes(plain) == soak.report_bytes(journaled)
    assert os.path.getsize(str(tmp_path / "serve.wal")) > 0


def test_journaled_pipelined_sweep_report_equals_unjournaled(tmp_path):
    plain = soak.run_pipelined_sweep(backend="oracle", n_incidents=2,
                                     concurrency=2)
    journaled = soak.run_pipelined_sweep(backend="oracle", n_incidents=2,
                                         concurrency=2,
                                         durable_dir=str(tmp_path))
    assert soak.report_bytes(plain["report"]) == \
        soak.report_bytes(journaled["report"])
    records, _ = read_journal(str(tmp_path / "serve.wal"))
    assert sum(r["kind"] == "run_settle" for r in records) == sum(
        r["kind"] == "run_submit" for r in records) > 0


def test_supervisor_requires_durable_dir():
    sup = CrashSupervisor(FaultPlan(), "never-used.wal")
    with pytest.raises(ValueError, match="durable_dir"):
        soak.run_chaos_soak(seed=0, n_incidents=1, backend="oracle",
                            supervisor=sup)


# ---------------------------------------------------------------------------
# Prometheus
# ---------------------------------------------------------------------------


class _Stub:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _stub_engine():
    """A duck-typed engine: the attributes ``prometheus_text`` reads."""
    return _Stub(_active={0: object(), 2: object()},
                 _pending=[_Stub(priority=0), _Stub(priority=1),
                           _Stub(priority=2), object()],
                 allocator=_Stub(n_free=17),
                 prefix_cache=_Stub(n_evictable=5),
                 _counts={"engine.prefix_hit_tokens": 128.0,
                          "engine.spilled_pages": 3,
                          "engine.prefix_hits_l1": 2.0})


def _fill(metrics):
    metrics.reset()
    metrics.inc("serve.runs_started", 3)
    metrics.inc("rca.incidents-done")
    metrics.inc("2xx.weird name", 0.5)
    for name, samples in (("engine.decode_step", (0.25, 0.5, 0.125)),
                          ("engine.prefill", (1.5,))):
        for dt in samples:
            metrics.timings[name].append(dt)


def test_prometheus_text_is_byte_equal_to_jax():
    try:
        _fill(METRICS)
        _fill(jlogging.METRICS)
        for engine in (None, "stub"):
            text = export.prometheus_text(
                METRICS, engine=_stub_engine() if engine else None)
            jtext = jexport.prometheus_text(
                jlogging.METRICS, engine=_stub_engine() if engine else None)
            assert text == jtext
        assert "k8s_llm_rca_engine_decode_step_seconds_count 3" in text
        assert "k8s_llm_rca_engine_queued_critical 1" in text
    finally:
        METRICS.reset()
        jlogging.METRICS.reset()


@pytest.mark.parametrize("kw", [
    {"router": object()}, {"store": object()},
    {"tracer": _Stub(remote={(0, 0): {"counters": {"x": 1.0}}})}],
    ids=["router", "store", "fleet_tracer"])
def test_cluster_families_raise_naming_item_11(kw):
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        export.prometheus_text(METRICS, **kw)


def test_service_scrape_carries_serve_counters():
    svc = AssistantService(EchoBackend(tokenizer.get_tokenizer()))
    _drive_lifecycle(svc)
    text = svc.prometheus_metrics()
    assert "# TYPE k8s_llm_rca_serve_runs_started_total counter" in text
    for line in text.splitlines():
        assert line.startswith("#") or re.fullmatch(
            r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.e+-]+", line), line


# ---------------------------------------------------------------------------
# the engine: phase timers and exact resume
# ---------------------------------------------------------------------------


def _timers(metrics) -> dict:
    with metrics._lock:
        return {k: v.count for k, v in metrics.timings.items()}


@pytest.fixture(scope="module")
def jax_engine_run():
    """One uninterrupted run of the lifecycle on the JAX engine: its reply,
    its METRICS timers, and the weights carried to the port."""
    cfg = J_TINY.replace(max_seq_len=64)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    tok = jtokenizer.get_tokenizer(vocab_size=cfg.vocab_size)
    eng = j_make_engine(cfg, JEngineConfig(**ECFG), params, tok,
                        use_kernel=False)
    jlogging.METRICS.reset()
    svc = japi.AssistantService(jbackend.EngineBackend(eng))
    a = svc.create_assistant("test", "t")
    th = svc.create_thread()
    svc.add_message(th.id, "pod crashloop")
    run = svc.wait_run(svc.create_run(
        th.id, a.id, gen=jbackend.GenOptions(max_new_tokens=8)).id)
    assert run.status == RunStatus.COMPLETED
    timers = _timers(jlogging.METRICS)
    jlogging.METRICS.reset()
    return {"text": svc.list_messages(th.id).data[0].raw_content,
            "timers": timers,
            "params": params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")}


@pytest.fixture(scope="module")
def port_engine(jax_engine_run):
    cfg = TINY.replace(max_seq_len=64)
    return make_engine(cfg, EngineConfig(**ECFG), jax_engine_run["params"],
                       tokenizer.get_tokenizer(vocab_size=cfg.vocab_size),
                       device="cpu")


def test_engine_phase_timers_match_jax(jax_engine_run, port_engine):
    """The same stepwise run records the JAX engine's phase timers under
    the same names, ``engine.decode_step`` as many times."""
    METRICS.reset()
    try:
        _, th, run = _drive_lifecycle(
            AssistantService(EngineBackend(port_engine)))
        timers = _timers(METRICS)
    finally:
        METRICS.reset()
    want = jax_engine_run["timers"]
    assert sorted(timers) == sorted(want)
    assert {"engine.decode_step", "engine.prefill",
            "engine.tick.admission", "engine.tick.eviction"} <= set(timers)
    assert timers["engine.decode_step"] == want["engine.decode_step"] > 0


def test_recovered_engine_run_equals_uninterrupted_and_jax(
        tmp_path, jax_engine_run, port_engine):
    """A journaled run interrupted mid-decode (its engine sequence
    cancelled, as a kill does) and recovered onto a fresh backend replies
    with the uninterrupted run's text, which is the JAX engine's."""
    eng = port_engine
    ref_svc = AssistantService(EngineBackend(eng))
    _, ref_th, _ = _drive_lifecycle(ref_svc)
    ref_text = ref_svc.list_messages(ref_th.id).data[0].raw_content
    assert ref_text == jax_engine_run["text"]

    path = str(tmp_path / "serve.wal")
    be = EngineBackend(eng)
    service = AssistantService(be, journal=RunJournal(path))
    _, _, run = _drive_lifecycle(service, wait=False)
    service.retrieve_run(run.id)           # prefill and a decode step
    assert service.runs[run.id].status == RunStatus.IN_PROGRESS
    service._journal.close()
    for handle in list(be._live):
        be.cancel(handle)
    assert not eng.has_work

    svc, report = recover_service(path, EngineBackend(eng))
    assert report["resubmitted"] == [run.id]
    got = svc.wait_run(run.id)
    assert got.status == RunStatus.COMPLETED
    assert svc.list_messages(got.thread_id).data[0].raw_content == ref_text
    eng.allocator.check()
    assert eng.allocator.n_free == eng.engine_cfg.num_pages - 1
