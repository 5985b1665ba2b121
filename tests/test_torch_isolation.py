"""The port stands alone: it imports neither ``jax`` nor the JAX package,
runs on the card unless asked for the CPU, and refuses what it has not
ported instead of ignoring it."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from k8s_llm_rca_tpu_torch import config
from k8s_llm_rca_tpu_torch.engine import make_engine
from k8s_llm_rca_tpu_torch.models import mixtral
from k8s_llm_rca_tpu_torch.models.llama import init_params
from k8s_llm_rca_tpu_torch.models.quant import quantize_params
from k8s_llm_rca_tpu_torch.serve.backend import EngineBackend, GenOptions
from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "k8s_llm_rca_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    # the port's own name starts with "k8s_llm_rca_tpu": match whole names
    return any(name == root or name.startswith(root + ".")
               for root in ("jax", "jaxlib", "k8s_llm_rca_tpu"))


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_imports_with_jax_and_the_jax_package_blocked():
    """Every port module and chip_smoke import in a fresh interpreter whose
    import system refuses jax and k8s_llm_rca_tpu (this test process has
    already imported jax through conftest, so it cannot check itself)."""
    script = f"""
import importlib, importlib.abc, sys

def forbidden(name):
    return any(name == r or name.startswith(r + ".")
               for r in ("jax", "jaxlib", "k8s_llm_rca_tpu"))

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
for mod in {list(_modules()) + ["chip_smoke"]!r}:
    importlib.import_module(mod)
leaked = sorted(m for m in sys.modules if forbidden(m))
assert not leaked, leaked
print("imported", len({list(_modules())!r}) + 1)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("imported")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_sources_cover_the_quantized_slice():
    names = {p.relative_to(PORT).as_posix() for p in SOURCES if PORT in
             p.parents}
    assert {"models/quant.py", "ops/quant_matmul.py",
            "ops/paged_attention.py", "engine/paged.py",
            "models/mixtral.py"} <= names


def test_sources_cover_the_rca_slice():
    """The agent loop's modules are the port's own copies (the import test
    above holds them to no jax and no JAX package)."""
    names = {p.relative_to(PORT).as_posix() for p in SOURCES if PORT in
             p.parents}
    assert {f"rca/{m}.py" for m in ("entity", "locator", "cyphergen",
                                     "auditor", "oracle", "scheduler",
                                     "pipeline")} <= names
    assert {f"graph/{m}.py" for m in ("store", "cypher", "fixtures",
                                       "executor")} <= names
    assert {"faults/plan.py", "faults/soak.py", "engine/constrain.py",
            "utils/fenced.py"} <= names


def test_sources_cover_the_tiers_slice():
    """The memory tiers, the native library and fault injection are the
    port's own copies, the C++ source among them (built by
    ``native/__init__.py``, not by the CUDA kernels' loader)."""
    names = {p.relative_to(PORT).as_posix() for p in SOURCES if PORT in
             p.parents}
    assert {"utils/wal.py", "utils/pages.py", "engine/prefix.py",
            "native/__init__.py", "faults/plan.py", "faults/inject.py",
            "faults/policy.py", "faults/soak.py"} <= names
    assert (PORT / "csrc" / "native.cpp").is_file()
    native_src = (PORT / "native" / "__init__.py").read_text()
    assert '"native.cpp"' in native_src and '"build"' in native_src


def test_sources_cover_the_speculative_slice():
    """``ngram_draft`` is the port's own copy, though the JAX module that
    holds it imports no jax at its top."""
    names = {p.relative_to(PORT).as_posix() for p in SOURCES if PORT in
             p.parents}
    assert {"engine/speculative.py", "engine/graphs.py"} <= names


def test_sources_cover_the_durability_slice():
    """Serving durability and the sweep drivers are the port's own copies
    (the import test above holds them to no jax and no JAX package)."""
    names = {p.relative_to(PORT).as_posix() for p in SOURCES if PORT in
             p.parents}
    assert {f"sweeps/{m}.py" for m in ("common", "run_file", "run_all",
                                        "stage")} <= names
    assert {"serve/journal.py", "serve/recover.py", "obs/export.py",
            "faults/supervisor.py", "runtime/profiling.py",
            "utils/wal.py"} <= names


def test_every_kernel_source_has_a_loader():
    """Each CUDA source under csrc/ is loaded by name from a port module
    (and so built by chip_smoke.py's KERNELS)."""
    text = "\n".join(p.read_text() for p in SOURCES)
    for cu in sorted((PORT / "csrc").glob("*.cu")):
        assert f'"{cu.stem}"' in text, cu.name


def test_forbidden_name_match_is_exact():
    assert _forbidden("k8s_llm_rca_tpu.ops.attention")
    assert _forbidden("jax.numpy")
    assert not _forbidden("k8s_llm_rca_tpu_torch.ops.attention")
    assert not _forbidden("jaxtyping")


def _tiny_engine_args(**engine_over):
    cfg = config.TINY
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ecfg = config.EngineConfig(paged=True, prefix_cache=False,
                               max_seq_len=256, prefill_buckets=(64,),
                               page_size=16, num_pages=32, **engine_over)
    return cfg, ecfg, params, get_tokenizer(vocab_size=cfg.vocab_size)


def test_default_device_is_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(*_tiny_engine_args())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(config.TINY, torch.Generator(), None)


def test_params_on_another_device_are_refused():
    cfg, ecfg, params, tok = _tiny_engine_args()
    params["layers"][1]["wq"] = params["layers"][1]["wq"].to("meta")
    with pytest.raises(ValueError, match="params live on meta"):
        make_engine(cfg, ecfg, params, tok, device="cpu")


UNPORTED = [
    ({"paged": False}, "Queue 1 item 9"),
]


@pytest.mark.parametrize("over,item", UNPORTED,
                         ids=[next(iter(o)) for o, _ in UNPORTED])
def test_unported_engine_knob_raises(over, item):
    cfg, ecfg, params, tok = _tiny_engine_args()
    with pytest.raises(NotImplementedError, match=item):
        make_engine(cfg, dataclasses.replace(ecfg, **over), params, tok,
                    device="cpu")


_TIERED = {"prefix_cache": True}


@pytest.mark.parametrize("over", [
    {"kv_cache_dtype": "int8"}, {"kv_cache_dtype": "int4"},
    {"prefix_cache": True}, {"prefill_chunk_budget": 16},
    {"speculative_k": 2}, {"host_overlap": True},
    {"max_spilled_pages": 8}, {**_TIERED, "prefix_host_pages": 8},
    {**_TIERED, "prefix_disk_dir": "store"},
    {**_TIERED, "prefix_disk_dir": "store", "prefix_disk_pages": 8},
    {**_TIERED, "prefix_hbm_watermark": 4},
    {**_TIERED, "prefix_host_pages": 8, "prefix_store_writethrough": True},
], ids=["int8", "int4", "prefix_cache", "prefill_chunk_budget",
        "speculative_k", "host_overlap", "max_spilled_pages",
        "prefix_host_pages", "prefix_disk_dir", "prefix_disk_pages",
        "prefix_hbm_watermark", "prefix_store_writethrough"])
def test_ported_engine_knob_is_accepted(over, tmp_path):
    """Knobs that used to raise: ``kv_cache_dtype`` int8/int4 quantize the
    pool, ``prefix_cache`` builds the prefix cache, a 40-token prompt
    under ``prefill_chunk_budget`` 16 prefills in three chunks,
    ``speculative_k`` verifies n-gram drafts, ``host_overlap`` keeps the
    decode operands resident, and the spill and prefix-store knobs build
    their tiers (a disk directory under the test's own)."""
    if "prefix_disk_dir" in over:
        over = {**over, "prefix_disk_dir": str(tmp_path / "store")}
    cfg, ecfg, params, tok = _tiny_engine_args(max_new_tokens=3)
    engine = make_engine(cfg, dataclasses.replace(ecfg, **over), params, tok,
                         device="cpu")
    assert engine.pool.quantized == ("kv_cache_dtype" in over)
    assert (engine.prefix_cache is not None) == ("prefix_cache" in over)
    assert (engine.prefix_store is not None) == any(
        k in over for k in ("prefix_host_pages", "prefix_disk_dir"))
    assert len(engine.generate([list(range(1, 41))])[0].token_ids) == 3
    chunks = engine._counts.get("engine.prefill_chunks", 0)
    assert chunks == (3 if "prefill_chunk_budget" in over else 0)


def test_draft_model_raises_naming_item_9():
    cfg, ecfg, params, tok = _tiny_engine_args(speculative_k=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        make_engine(cfg, ecfg, params, tok, device="cpu",
                    draft_model=(cfg, params))


def test_speculative_k_past_the_page_raises_like_jax():
    """All k + 1 verify writes must fit one page (JAX paged engine)."""
    cfg, ecfg, params, tok = _tiny_engine_args()
    with pytest.raises(ValueError, match="page_size=16"):
        make_engine(cfg, dataclasses.replace(ecfg, speculative_k=16),
                    params, tok, device="cpu")


def test_chunk_budget_off_the_page_grid_raises_like_jax():
    cfg, ecfg, params, tok = _tiny_engine_args()
    with pytest.raises(ValueError, match="multiple of page_size=16"):
        make_engine(cfg, dataclasses.replace(ecfg, prefill_chunk_budget=24),
                    params, tok, device="cpu")


def test_kv_cache_dtype_fp8_raises_like_jax():
    cfg, ecfg, params, tok = _tiny_engine_args()
    with pytest.raises(ValueError, match="unsupported kv_cache_dtype"):
        make_engine(cfg, dataclasses.replace(ecfg, kv_cache_dtype="fp8"),
                    params, tok, device="cpu")


@pytest.mark.parametrize("mesh", ["tp_mesh", "cp_mesh", "ep_mesh", "pp_mesh",
                                  "fsdp_mesh"])
def test_meshes_raise(mesh):
    cfg, ecfg, params, tok = _tiny_engine_args()
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        make_engine(cfg, ecfg, params, tok, device="cpu", **{mesh: object()})


@pytest.mark.parametrize("name,item", [
    ("build_ep_mesh", "Queue 1 item 10"), ("shard_params_ep", "Queue 1 item 10"),
    ("make_ep_engine", "Queue 1 item 10")])
def test_unported_model_features_raise(name, item):
    """MoE serves on one card; its expert-parallel assembly raises."""
    with pytest.raises(NotImplementedError, match=item):
        getattr(mixtral, name)(config.TINY_MOE)


@pytest.mark.parametrize("bits", [4, 8])
def test_ported_model_feature_is_accepted(bits):
    """``fused_quant_matmul`` over int4 and int8 weights serves (int8 used to
    raise)."""
    cfg, ecfg, params, tok = _tiny_engine_args(max_new_tokens=3)
    engine = make_engine(cfg.replace(fused_quant_matmul=True), ecfg,
                         quantize_params(params, bits=bits), tok, device="cpu")
    assert len(engine.generate([[1, 2, 3]])[0].token_ids) == 3


def test_moe_model_serves_on_the_cpu_when_asked():
    """TINY_MOE (it used to raise) with int8 weights under fused_quant_matmul."""
    cfg = config.TINY_MOE.replace(fused_quant_matmul=True)
    params = quantize_params(init_params(cfg, torch.Generator().manual_seed(0),
                                         "cpu"), bits=8)
    _, ecfg, _, tok = _tiny_engine_args(max_new_tokens=3,
                                        kv_cache_dtype="int8")
    engine = make_engine(cfg, ecfg, params, tok, device="cpu")
    assert len(engine.generate([[1, 2, 3]])[0].token_ids) == 3


def test_engine_backend_serves_on_cpu_when_asked():
    engine = make_engine(*_tiny_engine_args(max_new_tokens=4), device="cpu")
    backend = EngineBackend(engine)
    handle = backend.start("hi", GenOptions(max_new_tokens=4))
    results = {}
    while backend.busy(handle) and handle not in results:
        results.update(backend.pump())
    assert results[handle].completion_tokens == 4
