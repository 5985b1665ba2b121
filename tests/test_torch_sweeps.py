"""The port's sweep drivers (``k8s_llm_rca_tpu_torch/sweeps/``) against the
JAX package's: the batch sweep's record schema and ``--resume``, the
replicated and shared-worker oracle sweeps, a SIGKILL mid-sweep and its
resume, the four stage harnesses, and the engine sweep on the CPU.  An
oracle sweep's records, ``time_cost`` aside, equal the JAX driver's."""

import json
import os
import signal
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.config import TINY as J_TINY
from k8s_llm_rca_tpu.models import llama as j_llama
from k8s_llm_rca_tpu.sweeps import run_file as j_run_file
from k8s_llm_rca_tpu_torch.models import llama
from k8s_llm_rca_tpu_torch.models.llama import params_from_numpy
from k8s_llm_rca_tpu_torch.sweeps import run_all, run_file, stage
from k8s_llm_rca_tpu_torch.utils.logging import METRICS

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_metrics():
    """``METRICS`` is process-global and every port engine test records
    ``engine.decode_step``: a worker that ran another port file first would
    hand its timers to ``chip_metrics``.  Each test starts and ends with an
    empty store (``run_file.main`` does not reset it, as JAX's does not)."""
    METRICS.reset()
    yield
    METRICS.reset()


class _FrozenClock:
    """A ``time`` module whose ``time()`` stands still (everything else is
    the real module's).  An incident's ``token_usage`` counts the runs in a
    window of whole seconds, so two sweeps compare only under one clock:
    on the wall clock the count depends on where each sweep crosses a
    second."""

    def __init__(self, now: float = 1_700_000_000.0):
        self._now = now

    def time(self) -> float:
        return self._now

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def one_clock(monkeypatch):
    """Both packages' RCA pipelines and assistant services read one frozen
    clock (patched into the modules; no file of either package changes)."""
    from k8s_llm_rca_tpu.rca import pipeline as j_pipeline
    from k8s_llm_rca_tpu.serve import api as j_api
    from k8s_llm_rca_tpu_torch.rca import pipeline
    from k8s_llm_rca_tpu_torch.serve import api

    clock = _FrozenClock()
    for module in (pipeline, api, j_pipeline, j_api):
        monkeypatch.setattr(module, "time", clock)
    return clock


def _records(path):
    text, decoder, idx, objs = open(path).read(), json.JSONDecoder(), 0, []
    while idx < len(text.rstrip()):
        obj, idx = decoder.raw_decode(text, idx)
        while idx < len(text) and text[idx].isspace():
            idx += 1
        objs.append(obj)
    return objs


def test_run_file_schema_and_resume(tmp_path):
    inp, out = str(tmp_path / "incidents.csv"), str(tmp_path / "out.json")
    summary = run_file.main(["--input", inp, "--output", out,
                             "--slice", "0:2"])
    assert summary["incidents"] == 2 and summary["p50_incident_s"] > 0
    assert summary["chip"]["decode_tokens_per_sec"] is None  # no engine
    assert run_file.completed_incidents(out) == 2
    first = _records(out)[0]
    assert {"error_message", "locator_attempts", "analysis", "time_cost",
            "token_usage"} <= set(first)
    a = first["analysis"][0]
    assert {"extend_metapath", "cypher_query", "cypher_attempts",
            "statepath"} <= set(a)
    assert {"report", "clue"} <= set(a["statepath"][0])
    summary2 = run_file.main(["--input", inp, "--output", out, "--resume"])
    assert summary2["incidents"] == 2          # 4 in the corpus, 2 done
    assert run_file.completed_incidents(out) == 4


def test_oracle_records_equal_the_jax_drivers(tmp_path, one_clock):
    inp = str(tmp_path / "incidents.csv")
    out, j_out = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    run_file.write_default_corpus(inp)
    run_file.main(["--input", inp, "--output", out])
    j_run_file.main(["--input", inp, "--output", j_out])
    port, jax_ = _records(out), _records(j_out)
    for r in port + jax_:
        r.pop("time_cost")
    assert port == jax_ and len(port) == 4


def test_run_file_replicated_oracle(tmp_path):
    inp, out = str(tmp_path / "incidents.csv"), str(tmp_path / "out.json")
    run_file.write_default_corpus(inp, repeat=2)    # 8 incidents
    summary = run_file.main(["--input", inp, "--output", out,
                             "--replicas", "3"])
    assert (summary["incidents"], summary["failures"]) == (8, 0)
    reps = summary["replicas"]
    assert [r["replica"] for r in reps] == [0, 1, 2]
    assert sum(r["incidents"] for r in reps) == 8
    assert {r["device"] for r in reps} == {"host"}
    assert [r["error_message"] for r in _records(out)] and \
        run_file.completed_incidents(out) == 8


def test_run_file_shared_workers_oracle(tmp_path):
    inp, out = str(tmp_path / "incidents.csv"), str(tmp_path / "out.json")
    run_file.write_default_corpus(inp, repeat=2)
    summary = run_file.main(["--input", inp, "--output", out,
                             "--workers", "4"])
    assert (summary["incidents"], summary["failures"],
            summary["workers"]) == (8, 0, 4)
    assert run_file.completed_incidents(out) == 8


def test_replica_that_fails_to_build_counts_as_a_failure(tmp_path,
                                                         monkeypatch):
    """A replica whose pipeline does not build is one failure and the
    queue drains through the others; when none builds the sweep raises."""
    inp, out = str(tmp_path / "incidents.csv"), str(tmp_path / "out.json")
    run_file.write_default_corpus(inp)
    build, calls = run_file._build_pipeline, []

    def first_fails(args, device=None):
        calls.append(device)
        if len(calls) == 1:
            raise RuntimeError("CUDA out of memory")
        return build(args, device)

    monkeypatch.setattr(run_file, "_build_pipeline", first_fails)
    summary = run_file.main(["--input", inp, "--output", out,
                             "--replicas", "2"])
    assert (summary["incidents"], summary["failures"]) == (4, 1)
    assert run_file.completed_incidents(out) == 4
    assert sorted(r.get("error", "") for r in summary["replicas"]) == [
        "", "CUDA out of memory"]

    def never(args, device=None):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(run_file, "_build_pipeline", never)
    with pytest.raises(RuntimeError, match="no replica of 2 built") as err:
        run_file.main(["--input", inp, "--output", out, "--replicas", "2"])
    assert "out of memory" in str(err.value.__cause__)


def test_workers_and_replicas_are_exclusive(tmp_path):
    inp = str(tmp_path / "incidents.csv")
    run_file.write_default_corpus(inp)
    with pytest.raises(SystemExit):
        run_file.main(["--input", inp, "--workers", "2", "--replicas", "2"])


def test_run_file_kill_and_resume(tmp_path):
    """SIGKILL the shared-service sweep mid-flight, then ``--resume``: the
    final records are the input as a multiset, none lost, none twice
    (workers finish out of input order, and the kill may tear a record)."""
    inp, out = str(tmp_path / "incidents.csv"), str(tmp_path / "out.json")
    run_file.write_default_corpus(inp, repeat=50)    # 200 incidents
    corpus = run_file.load_corpus(inp)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_llm_rca_tpu_torch.sweeps.run_file",
         "--input", inp, "--output", out, "--workers", "4"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and proc.poll() is None:
            if run_file.completed_incidents(out) >= 4:
                break
            time.sleep(0.01)
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    survivors, _ = run_file.scan_output(out)
    assert 0 < len(survivors) < len(corpus), len(survivors)
    summary = run_file.main(["--input", inp, "--output", out,
                             "--workers", "4", "--resume"])
    assert summary["incidents"] == len(corpus) - len(survivors)
    final, _ = run_file.scan_output(out)
    assert Counter(final) == Counter(corpus)


STAGE_CHECKS = {
    "locate": lambda out: (out["srcKind"] == "Pod"
                           and out["plan"]["DestinationKind"] == "Secret"
                           and ["Pod", "Secret"] in out["metapaths"]),
    "cypher": lambda out: (out["records"] >= 1 and out["human_records"] >= 1
                           and "MATCH" in out["human_cypher_query"]),
    "audit": lambda out: (out["entity"] == "Secret(sec-0001)"
                          and any("apparent error" in c
                                  for c in out["clues"])),
    "token": lambda out: (out["run_status"] == "completed"
                          and out["token_usage"]["total_tokens"] > 0),
}


@pytest.mark.parametrize("name", sorted(STAGE_CHECKS))
def test_stage_harness(name, capsys):
    out = stage.main([name])
    assert STAGE_CHECKS[name](out), out
    printed = capsys.readouterr().out.strip()
    assert json.loads(printed[printed.index("{"):]) == json.loads(
        json.dumps(out, default=str))


def test_run_all_pipelined(capsys):
    run_all.main(["--slice", "0:2", "--concurrency", "2",
                  "--fresh-threads"])
    printed = capsys.readouterr().out
    assert "analyzed 2 incident(s)" in printed and "0 failure(s)" in printed


def test_engine_sweep_on_the_cpu(tmp_path, monkeypatch, one_clock):
    """The paged TINY engine behind the CLI, asked for the CPU, on the JAX
    CLI's weights (``PRNGKey(0)``, carried across): two incidents, the
    engine's decode timer feeds tokens per second, and the records,
    ``time_cost`` aside, equal the JAX CLI's (TINY's vocabulary is the
    JAX CLI tokenizer's 512)."""
    inp = str(tmp_path / "incidents.csv")
    out, j_out = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    args = ["--input", inp, "--slice", "0:2", "--backend", "engine",
            "--paged", "--model", "tiny", "--max-seq-len", "1024",
            "--fresh-threads"]
    j_summary = j_run_file.main(args + ["--output", j_out])
    assert (j_summary["incidents"], j_summary["failures"]) == (2, 0)
    weights = params_from_numpy(
        jax.tree.map(np.asarray,
                     j_llama.init_params(J_TINY, jax.random.PRNGKey(0))),
        "cpu")
    monkeypatch.setattr(llama, "init_params",
                        lambda cfg, generator, device: weights)
    summary = run_file.main(args + ["--output", out, "--device", "cpu"])
    assert (summary["incidents"], summary["failures"]) == (2, 0)
    assert summary["chip"]["decode_tokens_per_sec"] > 0
    assert not any(k.startswith("hbm_") for k in summary["chip"])
    assert run_file.completed_incidents(out) == 2
    port, jax_ = _records(out), _records(j_out)
    for r in port + jax_:
        r.pop("time_cost")
    assert port == jax_


def _jax_cli_weights():
    """The JAX CLI's engine weights (TINY, ``PRNGKey(0)``) as a JAX tree."""
    return j_llama.init_params(J_TINY, jax.random.PRNGKey(0))


def test_engine_without_paged_raises_naming_item_9(tmp_path, monkeypatch):
    """``--backend engine`` without ``--paged`` raised naming Queue 1 item
    9 until the contiguous-slot engine was ported.  Now it builds that
    engine, as the JAX CLI does: on the JAX CLI's weights, one incident's
    records, ``time_cost`` aside, equal the JAX CLI's."""
    inp = str(tmp_path / "incidents.csv")
    out, j_out = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    args = ["--input", inp, "--slice", "0:1", "--backend", "engine",
            "--model", "tiny", "--max-seq-len", "1024", "--fresh-threads"]
    j_summary = j_run_file.main(args + ["--output", j_out])
    assert (j_summary["incidents"], j_summary["failures"]) == (1, 0)
    weights = params_from_numpy(jax.tree.map(np.asarray, _jax_cli_weights()),
                                "cpu")
    monkeypatch.setattr(llama, "init_params",
                        lambda cfg, generator, device: weights)
    from k8s_llm_rca_tpu_torch.engine import engine as port_engine

    built = []
    init = port_engine.InferenceEngine.__init__

    def record(self, *a, **kw):
        built.append(self)
        init(self, *a, **kw)

    monkeypatch.setattr(port_engine.InferenceEngine, "__init__", record)
    summary = run_file.main(args + ["--output", out, "--device", "cpu"])
    assert (summary["incidents"], summary["failures"]) == (1, 0)
    assert len(built) == 1 and summary["chip"]["decode_tokens_per_sec"] > 0
    port, jax_ = _records(out), _records(j_out)
    for r in port + jax_:
        r.pop("time_cost")
    assert port == jax_


def test_weights_raise_naming_item_7(tmp_path):
    """``--weights`` raised naming Queue 1 item 7 until loading was
    ported.  Now both CLIs load the same safetensors file (the JAX CLI's
    weights, exported by the JAX package) into the paged engine, and one
    incident's records, ``time_cost`` aside, are equal."""
    from k8s_llm_rca_tpu.models import loader as j_loader

    weights = str(tmp_path / "model.safetensors")
    j_loader.write_safetensors(
        weights, j_loader.llama_params_to_hf(J_TINY, _jax_cli_weights()))
    inp = str(tmp_path / "incidents.csv")
    out, j_out = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    args = ["--input", inp, "--slice", "0:1", "--backend", "engine",
            "--paged", "--model", "tiny", "--max-seq-len", "1024",
            "--fresh-threads", "--weights", weights]
    j_summary = j_run_file.main(args + ["--output", j_out])
    summary = run_file.main(args + ["--output", out, "--device", "cpu"])
    assert (summary["incidents"], summary["failures"]) == \
        (j_summary["incidents"], j_summary["failures"]) == (1, 0)
    port, jax_ = _records(out), _records(j_out)
    for r in port + jax_:
        r.pop("time_cost")
    assert port == jax_


def test_engine_device_defaults_to_the_card(tmp_path):
    """``--device`` is ``cuda`` unless given: without a card the engine
    sweep raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    inp = str(tmp_path / "incidents.csv")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_file.main(["--input", inp, "--output", str(tmp_path / "o.json"),
                       "--backend", "engine", "--paged"])
