"""The port's RCA agent loop against the JAX package's: the plan-free
pipelined sweep (``faults/soak.py::run_pipelined_sweep``) gives equal
``report_bytes``.

- oracle: the scripted backend, no model, the four fixture incidents at
  concurrency 2 (the locator -> cyphergen -> auditor control flow, the
  graph executors and the scheduler);
- engine: the soak engine (TINY, max_seq_len 2560, page 64, decode_chunk
  16, greedy) on the JAX soak's own weights (``PRNGKey(0)``) carried into
  the port through numpy, two incidents at concurrency 2.  At vocab 512
  the plan and report schemas and the cypher skeletons compile to DFA
  tables, so the constrained scan decodes every stage reply.
"""

import jax
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.config import TINY as J_TINY
from k8s_llm_rca_tpu.faults.soak import report_bytes as j_report_bytes
from k8s_llm_rca_tpu.faults.soak import run_pipelined_sweep as j_sweep
from k8s_llm_rca_tpu.models import llama as jllama
from k8s_llm_rca_tpu_torch.config import TINY
from k8s_llm_rca_tpu_torch.faults.soak import report_bytes, run_pipelined_sweep
from k8s_llm_rca_tpu_torch.models.llama import params_from_numpy

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)


def test_oracle_sweep_report_bytes_equal_jax():
    jax_out = j_sweep(backend="oracle", n_incidents=4, concurrency=2)
    out = run_pipelined_sweep(backend="oracle", n_incidents=4, concurrency=2)
    assert report_bytes(out["report"]) == j_report_bytes(jax_out["report"])
    assert out["report"]["completed"] == 4
    assert out["stats"] == jax_out["stats"]


@pytest.fixture(scope="module")
def jax_engine_sweep():
    """The JAX engine sweep, run once for the module's engine tests."""
    return j_sweep(backend="engine", n_incidents=2, concurrency=2)


def test_jax_engine_sweep_reference_completes(jax_engine_sweep):
    """The reference the port's engine sweep is held to: both incidents
    complete and the JAX engine is left clean.  (First in the module, so
    the shared JAX run's time is spent here and the port's test below
    pays only for its own sweep.)"""
    report = jax_engine_sweep["report"]
    assert (report["completed"], report["failed"], report["engine_clean"]) \
        == (2, 0, True)


def test_engine_sweep_report_bytes_equal_jax(jax_engine_sweep):
    jax_out = jax_engine_sweep
    cfg = TINY.replace(max_seq_len=2560)
    params = jllama.init_params(J_TINY.replace(max_seq_len=2560),
                                jax.random.PRNGKey(0))
    out = run_pipelined_sweep(
        backend="engine", n_incidents=2, concurrency=2, model_cfg=cfg,
        params=params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        device="cpu")
    report = out["report"]
    assert report_bytes(report) == j_report_bytes(jax_out["report"])
    assert (report["completed"], report["failed"], report["engine_clean"]) \
        == (2, 0, True)
    counts = out["engines"][0]._counts
    # the scan carried the grammars: fewer dispatches than decode steps
    assert counts["engine.decode_steps"] > counts["engine.dispatches"]


@pytest.mark.parametrize("kw,item", [
    ({"rca_overrides": {}}, "Queue 1 item 5"),
    ({"durable_dir": "wal"}, None),
    ({"backend": "cluster-oracle"}, "Queue 1 item 11"),
    ({"tracer": object()}, "Queue 1 item 5"),
], ids=["rca_overrides", "durable_dir", "cluster", "tracer"])
def test_unported_sweep_options_raise(kw, item, tmp_path):
    """Options not ported raise naming their ROADMAP item; ``durable_dir``
    (Queue 1 item 4, which it used to name) is ported and journals the
    sweep into ``serve.wal``."""
    kw = {"backend": "oracle", "n_incidents": 1, **kw}
    if item is None:
        kw["durable_dir"] = str(tmp_path / kw["durable_dir"])
        assert run_pipelined_sweep(**kw)["report"]["completed"] == 1
        assert (tmp_path / "wal" / "serve.wal").stat().st_size > 0
        return
    with pytest.raises(NotImplementedError, match=item):
        run_pipelined_sweep(**kw)


def test_engine_overrides_reach_the_engine():
    """``engine_overrides`` replaces the soak engine's EngineConfig fields,
    as in the JAX sweep (no incident runs: only the build is checked)."""
    over = {"speculative_k": 4, "host_overlap": True, "decode_chunk": 1}
    out = run_pipelined_sweep(backend="engine", n_incidents=0,
                              concurrency=1, engine_overrides=over,
                              model_cfg=TINY.replace(max_seq_len=2560),
                              device="cpu")
    ecfg = out["engines"][0].engine_cfg
    assert {k: getattr(ecfg, k) for k in over} == over
    assert (ecfg.page_size, ecfg.num_pages) == (64, 168)
    assert out["report"]["n_incidents"] == 0


def test_unported_pipeline_attachments_raise():
    from k8s_llm_rca_tpu_torch.faults.plan import Fault, FaultPlan
    from k8s_llm_rca_tpu_torch.graph import InMemoryGraphExecutor
    from k8s_llm_rca_tpu_torch.graph.fixtures import (
        build_metagraph, build_stategraph,
    )
    from k8s_llm_rca_tpu_torch.rca import RCAPipeline
    from k8s_llm_rca_tpu_torch.rca.oracle import OracleBackend
    from k8s_llm_rca_tpu_torch.rca.scheduler import SweepScheduler
    from k8s_llm_rca_tpu_torch.serve.api import AssistantService
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    svc = AssistantService(OracleBackend(get_tokenizer()))
    meta = InMemoryGraphExecutor(build_metagraph())
    state = InMemoryGraphExecutor(build_stategraph())
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        RCAPipeline(svc, meta, state, reranker=object())
    # a plan with scheduled faults needs concurrency 1, as in JAX
    from k8s_llm_rca_tpu_torch.config import RCAConfig

    cfg = RCAConfig(fresh_threads=True)
    sched = SweepScheduler([RCAPipeline(svc, meta, state, cfg)
                            for _ in range(2)])
    with pytest.raises(ValueError, match="concurrency > 1"):
        sched.run(["x"], fault_plan=FaultPlan([Fault("graph.query", 0,
                                                     "error")]))
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        svc.usage_for_runs([], critical_path=True)
