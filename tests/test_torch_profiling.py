"""The port's analytic decoder model and trace capture
(``k8s_llm_rca_tpu_torch/runtime/profiling.py``) against the JAX
package's (``k8s_llm_rca_tpu/runtime/profiling.py``): the counts are the
same arithmetic, and MFU and the rooflines are JAX's formulas under the
card's peaks (the port's table holds the H100 row only)."""

import json
import os
import types

import pytest
import torch

from k8s_llm_rca_tpu import config as jconfig
from k8s_llm_rca_tpu.runtime import profiling as jprof
from k8s_llm_rca_tpu_torch import config
from k8s_llm_rca_tpu_torch.runtime import profiling

torch.set_num_threads(1)

CONFIGS = ("TINY", "LLAMA3_8B", "MIXTRAL_8X7B")
H100 = "NVIDIA H100 80GB HBM3"
# a JAX device kind with a table entry, and its bf16 peak and bandwidth
TPU = types.SimpleNamespace(device_kind="TPU v5 lite")
TPU_TFLOPS, TPU_GBPS = 197.0, 819.0


@pytest.fixture
def on_h100(monkeypatch):
    """The port's device lookup reads the card's name (no card here)."""
    monkeypatch.setattr(profiling, "_device_kind", lambda device=None: H100)


@pytest.mark.parametrize("name", CONFIGS)
def test_analytic_counts_equal_jax(name):
    cfg, jcfg = getattr(config, name), getattr(jconfig, name)
    assert profiling.decoder_param_count(cfg) == jprof.decoder_param_count(
        jcfg)
    for ctx in (0, 512, 2400):
        assert profiling.decode_flops_per_token(cfg, ctx) == \
            jprof.decode_flops_per_token(jcfg, ctx)
        for batch, wbits, kvbits in ((1, 16, 16), (4, 4, 4), (64, 8, 16)):
            assert profiling.decode_bytes_per_token(
                cfg, ctx, batch, wbits, kvbits) == \
                jprof.decode_bytes_per_token(jcfg, ctx, batch, wbits, kvbits)
            for n_intra in (2, 4, 16):
                assert profiling.stage_local_cp_vs_tp(
                    cfg, ctx, batch, n_intra, wbits, kvbits) == \
                    jprof.stage_local_cp_vs_tp(jcfg, ctx, batch, n_intra,
                                               wbits, kvbits)


@pytest.mark.parametrize("name", CONFIGS)
def test_mfu_and_rooflines_follow_jax_under_the_card_peaks(name, on_h100):
    cfg, jcfg = getattr(config, name), getattr(jconfig, name)
    for tps, ctx, batch in ((387.3, 1400, 4), (20.0, 64, 1)):
        port = profiling.mfu(cfg, tps, ctx)
        ref = jprof.mfu(jcfg, tps, ctx, device=TPU)
        assert port * 989e12 == pytest.approx(ref * TPU_TFLOPS * 1e12,
                                              rel=1e-12)
        flops = jprof.decode_flops_per_token(jcfg, ctx)
        nbytes = jprof.decode_bytes_per_token(jcfg, ctx, batch, 4, 4)
        assert profiling.roofline_decode_tps(cfg, ctx, batch, 4, 4) == \
            pytest.approx(min(989e12 / flops, 3350e9 / nbytes), rel=1e-12)
        # JAX's roofline is the same min under its own peaks
        assert jprof.roofline_decode_tps(jcfg, ctx, batch, 4, 4,
                                         device=TPU) == pytest.approx(
            min(TPU_TFLOPS * 1e12 / flops, TPU_GBPS * 1e9 / nbytes),
            rel=1e-12)
        assert profiling.roofline_prefill_tps(cfg, 2 * ctx) * \
            TPU_TFLOPS == pytest.approx(
                jprof.roofline_prefill_tps(jcfg, 2 * ctx, device=TPU)
                * 989.0, rel=1e-12)


def test_peak_tables_hold_the_card_row_only():
    assert profiling._PEAK_TFLOPS == {"NVIDIA H100": 989.0}
    assert profiling._HBM_GBPS == {"NVIDIA H100": 3350.0}
    assert profiling._longest_prefix(profiling._PEAK_TFLOPS, H100) == 989.0
    assert profiling._longest_prefix(profiling._HBM_GBPS, "TPU v5") is None
    # the CPU has no entry: None, as JAX's off its table
    cfg = config.LLAMA3_8B
    assert profiling.mfu(cfg, 100.0, 512, device="cpu") is None
    assert profiling.roofline_decode_tps(cfg, 512, 4, device="cpu") is None
    assert profiling.roofline_prefill_tps(cfg, 512, device="cpu") is None


def test_step_timer_reports_like_jax(on_h100):
    timer = profiling.StepTimer()
    timer.start()
    for _ in range(3):
        timer.tick(4)
    out = timer.report(config.TINY, context_len=256)
    assert (out["steps"], out["tokens"]) == (3, 12)
    assert out["tokens_per_sec"] > 0 and out["mfu"] is not None
    assert not any(k.startswith("hbm_") for k in out)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("test.region"):
            torch.ones(8).add_(1)
    (path,) = list((tmp_path / "trace").iterdir())
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "test.region" for e in events)
    assert os.path.getsize(path) > 0
