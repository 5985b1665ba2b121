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

from k8s_llm_rca_tpu.config import TINY as J_TINY
from k8s_llm_rca_tpu.faults.soak import report_bytes as j_report_bytes
from k8s_llm_rca_tpu.faults.soak import run_pipelined_sweep as j_sweep
from k8s_llm_rca_tpu.models import llama as jllama
from k8s_llm_rca_tpu_torch.config import TINY
from k8s_llm_rca_tpu_torch.faults.soak import report_bytes, run_pipelined_sweep
from k8s_llm_rca_tpu_torch.models.llama import params_from_numpy


def test_oracle_sweep_report_bytes_equal_jax():
    jax_out = j_sweep(backend="oracle", n_incidents=4, concurrency=2)
    out = run_pipelined_sweep(backend="oracle", n_incidents=4, concurrency=2)
    assert report_bytes(out["report"]) == j_report_bytes(jax_out["report"])
    assert out["report"]["completed"] == 4
    assert out["stats"] == jax_out["stats"]


def test_engine_sweep_report_bytes_equal_jax():
    jax_out = j_sweep(backend="engine", n_incidents=2, concurrency=2)
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
    ({"resilience": True}, "Queue 1 item 3"),
    ({"durable_dir": "wal"}, "Queue 1 item 4"),
    ({"backend": "cluster-oracle"}, "Queue 1 item 11"),
    ({"tracer": object()}, "Queue 1 item 5"),
    ({"engine_overrides": {"decode_chunk": 4}}, "Queue 1 item 5"),
], ids=["resilience", "durable_dir", "cluster", "tracer", "engine_overrides"])
def test_unported_sweep_options_raise(kw, item):
    kw = {"backend": "oracle", "n_incidents": 1, **kw}
    with pytest.raises(NotImplementedError, match=item):
        run_pipelined_sweep(**kw)


def test_unported_pipeline_attachments_raise():
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
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        RCAPipeline(svc, meta, state, resilience=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        RCAPipeline(svc, meta, state, reranker=object())
    sched = SweepScheduler([RCAPipeline(svc, meta, state)])
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        sched.run(["x"], fault_plan=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        svc.usage_for_runs([], critical_path=True)
