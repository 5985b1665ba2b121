"""The port stands alone: it imports neither ``jax`` nor the JAX package,
runs on the card unless asked for the CPU, and refuses what it has not
ported instead of ignoring it."""

import ast
import dataclasses
import functools
import os
import subprocess
import sys
import types
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
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tools" / "profile_window.py"]


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


def test_sources_cover_the_loading_slice():
    """Rerank, loading and the contiguous engine are the port's own
    copies (the import test above holds them to no jax and no JAX
    package)."""
    names = {p.relative_to(PORT).as_posix() for p in SOURCES if PORT in
             p.parents}
    assert {"models/encoder.py", "models/loader.py", "rca/rerank.py",
            "utils/checkpoint.py", "utils/tokenizer.py",
            "engine/engine.py", "engine/speculative.py"} <= names


def test_sources_cover_the_mesh_slice():
    """The mesh, the partition rules, the rank shards and expert
    parallelism are the port's own copies (no jax, no JAX package), and a
    spawned rank's entry point imports neither either."""
    names = {p.relative_to(PORT).as_posix() for p in SOURCES if PORT in
             p.parents}
    assert {"runtime/mesh.py", "runtime/rules.py", "runtime/sharding.py",
            "parallel/__init__.py", "parallel/moe.py"} <= names
    test_module = (ROOT / "tests" / "test_torch_parallel.py").read_text()
    top = test_module.split("\ndef ", 1)[0]
    assert "import jax" not in top and "k8s_llm_rca_tpu." not in top


def test_sources_cover_the_cp_slice():
    """Ring and Ulysses attention are the port's own copies (the import
    tests above hold them to no jax and no JAX package), and the CP test
    module's ranks import no JAX at its top."""
    names = {p.relative_to(PORT).as_posix() for p in SOURCES if PORT in
             p.parents}
    assert {"parallel/ring_attention.py", "parallel/ulysses.py",
            "runtime/profiling.py"} <= names
    test_module = (ROOT / "tests" / "test_torch_cp.py").read_text()
    top = test_module.split("\ndef ", 1)[0]
    assert "import jax" not in top and "k8s_llm_rca_tpu." not in top


def test_sources_cover_the_pp_slice():
    """Pipeline parallelism is the port's own copy (the import tests above
    hold it to no jax and no JAX package), and the PP test module's ranks
    import no JAX at its top."""
    names = {p.relative_to(PORT).as_posix() for p in SOURCES if PORT in
             p.parents}
    assert "parallel/pipeline.py" in names
    test_module = (ROOT / "tests" / "test_torch_pp.py").read_text()
    top = test_module.split("\ndef ", 1)[0]
    assert "import jax" not in top and "k8s_llm_rca_tpu." not in top


def test_sources_cover_the_fsdp_slice():
    """FSDP and sequence parallelism live in the port's own mesh, sharding,
    model and profiling modules (the import tests above hold them to no
    jax and no JAX package), and the FSDP test module's ranks import no
    JAX at its top."""
    names = {p.relative_to(PORT).as_posix() for p in SOURCES if PORT in
             p.parents}
    assert {"runtime/mesh.py", "runtime/sharding.py", "models/llama.py",
            "runtime/profiling.py", "engine/paged.py"} <= names
    for path in SOURCES:
        text = path.read_text()
        if "def validate_fsdp_mesh" in text or "def all_gather_into" in text:
            assert PORT in path.parents
    test_module = (ROOT / "tests" / "test_torch_fsdp.py").read_text()
    top = test_module.split("\ndef ", 1)[0]
    assert "import jax" not in top and "k8s_llm_rca_tpu." not in top


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


# a stand-in for a 1-rank mesh: the six axes of size one (the refusals
# come before anything else reads it)
_ONE_RANK = types.SimpleNamespace(
    mesh_dim_names=("data", "fsdp", "model", "expert", "seq", "stage"),
    mesh=torch.zeros((1,) * 6))


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
    """``draft_model=`` raised naming Queue 1 item 9 until the contiguous
    engine was ported; now the paged engine drafts with the model (here
    the target itself, so every draft is accepted) and a draft with
    another vocabulary is refused."""
    cfg, ecfg, params, tok = _tiny_engine_args(speculative_k=2)
    engine = make_engine(cfg, ecfg, params, tok, device="cpu",
                         draft_model=(cfg, params))
    plain = make_engine(cfg, dataclasses.replace(ecfg, speculative_k=0),
                        params, tok, device="cpu")
    prompt = [list(range(1, 30))]
    assert engine.generate(prompt, 12)[0].token_ids == \
        plain.generate(prompt, 12)[0].token_ids
    assert engine._counts["engine.spec_accepted"] > 0
    with pytest.raises(ValueError, match="draft vocab"):
        make_engine(cfg, ecfg, params, tok, device="cpu",
                    draft_model=(cfg.replace(vocab_size=1024), params))


def test_loading_needs_no_ml_dtypes_safetensors_or_orbax(tmp_path):
    """The loader and the checkpoints run with ``ml_dtypes``,
    ``safetensors``, ``orbax``, ``tokenizers`` and ``transformers``
    blocked, as on the card machine: a bf16 safetensors round trip and a
    param checkpoint round trip, in a fresh interpreter."""
    script = f"""
import importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "k8s_llm_rca_tpu", "ml_dtypes", "safetensors",
           "orbax", "tokenizers", "transformers")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in BLOCKED):
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
import torch
from k8s_llm_rca_tpu_torch.config import TINY
from k8s_llm_rca_tpu_torch.models import llama, loader
from k8s_llm_rca_tpu_torch.models.quant import quantize_params
from k8s_llm_rca_tpu_torch.utils import checkpoint
cfg = TINY.replace(dtype="bfloat16", tie_embeddings=False)
p = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
loader.write_sharded_safetensors({str(tmp_path / "ck")!r},
                                 loader.llama_params_to_hf(cfg, p), 2)
back = loader.load_llama(cfg, {str(tmp_path / "ck")!r}, "cpu")
assert torch.equal(back["layers"][1]["wq"].view(torch.int16),
                   p["layers"][1]["wq"].view(torch.int16))
q = quantize_params(p, bits=4)
checkpoint.save_params({str(tmp_path / "params")!r}, q)
r = checkpoint.restore_params({str(tmp_path / "params")!r})
assert torch.equal(r["layers"][0]["w_up"].q, q["layers"][0]["w_up"].q)
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


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


@pytest.mark.parametrize("meshes,error,match", [
    (("cp_mesh", "ep_mesh"), NotImplementedError, "Queue 1 item 10"),
    (("pp_mesh", "cp_mesh"), ValueError, "mutually exclusive by design"),
    (("fsdp_mesh", "cp_mesh"), ValueError, "fsdp×CP is unsupported"),
], ids=["cp_ep", "pp_cp", "fsdp_mesh"])
def test_meshes_raise(meshes, error, match):
    """The paged engine's compositions not ported yet, CP with EP (cp_mesh
    alone and with tp_mesh is served since the CP slice), and those JAX
    refuses: PP with CP, by design (pp_mesh alone, with tp_mesh or with
    ep_mesh is served since the PP slice), and FSDP with CP (fsdp_mesh
    alone and with tp_mesh is served since the FSDP slice).  The meshes
    are stand-ins with the six axes of size one: the refusals come before
    anything else reads them."""
    mesh = types.SimpleNamespace(
        mesh_dim_names=("data", "fsdp", "model", "expert", "seq", "stage"),
        mesh=torch.zeros((1,) * 6))
    cfg, ecfg, params, tok = _tiny_engine_args()
    with pytest.raises(error, match=match):
        make_engine(cfg, ecfg, params, tok, device="cpu",
                    **{name: mesh for name in meshes})


# the contiguous engine's refusals under a mesh: (the meshes, what else the
# engine is given, the error, its message).  JAX's ValueErrors
# (host_overlap with CP, sp without TP, a bucket off the CP axis or, under
# sp, off the TP axis) and the compositions neither engine serves (CP x
# EP, TP x EP: item 10.9).  host_overlap under the other meshes is served
# since the mesh-tiers slice (test_host_overlap_serves_on_one_rank), and
# speculation under every mesh since the mesh-speculation slice
# (test_speculation_serves_on_one_rank)
CONTIGUOUS_REFUSALS = {
    "cp_mesh-host_overlap": (("cp_mesh",), {"host_overlap": True}, ValueError,
                             "host_overlap=True is unsupported with cp_mesh"),
    "sp_without_tp": ((), {"sp": True}, ValueError, "requires tp_mesh"),
    "cp_bucket": (("cp_mesh",), {"seq": 2, "prefill_buckets": (33,)},
                  ValueError, "offending sizes: \\[33\\]"),
    "sp_bucket": (("tp_mesh",), {"model": 2, "sp": True,
                                 "prefill_buckets": (33,)}, ValueError,
                  "bucket 33 is not divisible by its size 2"),
    "cp_ep": (("cp_mesh", "ep_mesh"), {}, NotImplementedError,
              "CP x EP\\) is not ported yet \\(ROADMAP Queue 1 item 10.9"),
    "tp_ep": (("tp_mesh", "ep_mesh"), {}, NotImplementedError,
              "TP x EP\\) is not ported yet \\(ROADMAP Queue 1 item 10.9"),
}


@pytest.mark.parametrize("case", list(CONTIGUOUS_REFUSALS))
def test_contiguous_engine_meshes_raise(case):
    """The contiguous engine (``paged=False``) serves every mesh since the
    contiguous-mesh slice; it refuses the compositions the paged engine
    refuses (CP x EP, TP x EP: item 10.9, one shared list), and raises
    JAX's ValueErrors first (host_overlap with CP, sp without TP, a bucket
    the CP axis or, under sp, the TP axis does not divide).  The meshes
    are stand-ins with the six axes
    (of size one unless the case sizes one): the refusals come before
    anything else reads them."""
    names, over, error, match = CONTIGUOUS_REFUSALS[case]
    over = dict(over)
    sizes = {a: over.pop(a, 1) for a in ("seq", "model")}
    axes = ("data", "fsdp", "model", "expert", "seq", "stage")
    mesh = types.SimpleNamespace(
        mesh_dim_names=axes,
        mesh=torch.zeros([sizes.get(a, 1) for a in axes]))
    moe = "ep_mesh" in names
    cfg, ecfg, params, tok = _tiny_engine_args()
    if moe:
        cfg = config.TINY_MOE
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = {name: mesh for name in names}
    if "sp" in over:
        kw["sp"] = over.pop("sp")
    ecfg = dataclasses.replace(ecfg, paged=False, **over)
    with pytest.raises(error, match=match):
        make_engine(cfg, ecfg, params, tok, device="cpu", **kw)


@pytest.fixture
def one_rank_group():
    """A 1-rank gloo process group in this process, destroyed after."""
    from k8s_llm_rca_tpu_torch.runtime import mesh as rmesh

    assert rmesh.initialize_distributed(device="cpu")
    try:
        yield rmesh
    finally:
        rmesh.shutdown_distributed()


def _serves(engine, n_tokens=3) -> None:
    tok = engine.tokenizer
    out = engine.generate([tok.encode("pod pending", add_bos=True)],
                          max_new_tokens=n_tokens)
    assert len(out[0].token_ids) == n_tokens
    engine.allocator.check()


@pytest.mark.parametrize("mesh", ["tp_mesh", "ep_mesh", "pp_mesh",
                                  "fsdp_mesh", "sp"])
def test_meshes_build_and_serve_on_one_rank(one_rank_group, mesh):
    """tp_mesh, ep_mesh, pp_mesh (two microbatches), fsdp_mesh and tp_mesh
    with sp=True build the paged engine on a 1-rank gloo mesh and serve
    through the sharded, pipelined, gathered or sequence-parallel path
    (its collectives counted)."""
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_params, shard_stage_params,
    )

    cfg, ecfg, params, tok = _tiny_engine_args()
    if mesh == "ep_mesh":
        cfg = config.TINY_MOE
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    m = one_rank_group.single_device_mesh(device="cpu")
    one_rank_group.reset_collective_counts()
    if mesh == "pp_mesh":
        engine = make_engine(cfg, ecfg, shard_stage_params(params, cfg, m),
                             tok, device="cpu", pp_mesh=m, pp_microbatches=2)
    elif mesh == "fsdp_mesh":
        engine = make_engine(cfg, ecfg, shard_params(
            params, llama_param_specs(cfg, FSDP_LAYOUT), m), tok,
            device="cpu", fsdp_mesh=m)
    elif mesh == "sp":
        engine = make_engine(cfg, ecfg,
                             shard_params(params, llama_param_specs(cfg), m),
                             tok, device="cpu", tp_mesh=m, sp=True)
    else:
        engine = make_engine(cfg, ecfg,
                             shard_params(params, llama_param_specs(cfg), m),
                             tok, device="cpu", **{mesh: m})
    _serves(engine)
    counts = one_rank_group.collective_counts()
    key = {"tp_mesh": "all_reduce_sum", "ep_mesh": "all_to_all",
           "pp_mesh": "ppermute", "fsdp_mesh": "all_gather_into",
           "sp": "reduce_scatter_sum"}[mesh]
    assert counts[key] > 0, counts


def test_validate_layout_on_one_rank(one_rank_group):
    """``rules.validate_layout``: default mappings pass on size-1 axes, a
    remapped one (fsdp) onto a size-1 axis and an axis the mesh lacks are
    named ValueErrors, as in JAX."""
    from k8s_llm_rca_tpu_torch.runtime import rules

    m = one_rank_group.local_mesh(device="cpu")
    assert rules.validate_layout(rules.TP_LAYOUT, m) is rules.TP_LAYOUT
    with pytest.raises(ValueError, match="of size 1"):
        rules.validate_layout(rules.FSDP_LAYOUT, m)
    with pytest.raises(ValueError, match="undefined on a mesh"):
        rules.validate_layout(rules.SpecLayout(tp="tensor"), m)


@pytest.mark.parametrize("name", ["build_ep_mesh", "shard_params_ep",
                                  "make_ep_engine"])
def test_ep_assembly_builds_on_one_rank(one_rank_group, name):
    """Mixtral's expert-parallel assembly builds on a 1-rank gloo mesh (and
    the engine serves); the CP x EP mesh still raises."""
    cfg, ecfg, _, tok = _tiny_engine_args()
    moe = config.TINY_MOE
    params = init_params(moe, torch.Generator().manual_seed(0), "cpu")
    if name == "build_ep_mesh":
        m = mixtral.build_ep_mesh(1, device="cpu")
        assert m.mesh_dim_names == config.MeshConfig().axis_names
        with pytest.raises(NotImplementedError, match="Queue 1 item 10.9"):
            mixtral.build_ep_mesh(1, n_seq=2, device="cpu")
    elif name == "shard_params_ep":
        m = mixtral.build_ep_mesh(1, device="cpu")
        shard = mixtral.shard_params_ep(moe, params, m)
        assert shard["layers"][0]["w_gate"] is params["layers"][0]["w_gate"]
    else:
        _serves(mixtral.make_ep_engine(moe, ecfg, params, tok, device="cpu"))


# the pairs JAX's paged engine refuses under CP and PP, with its
# ValueErrors, before any other mesh check: speculative_k rides along
# (served under every mesh since the mesh-speculation slice) and raises
# nothing after them
JAX_PAIR_REFUSALS = {
    "cp_spill": ("cp_mesh", {"max_spilled_pages": 4},
                 "max_spilled_pages \\(KV spill-to-host\\) is unsupported "
                 "with cp_mesh"),
    "cp_tiers": ("cp_mesh", {"prefix_cache": True, "prefix_host_pages": 4},
                 "the tiered prefix cache is unsupported with cp_mesh"),
    "pp_spill": ("pp_mesh", {"max_spilled_pages": 4},
                 "max_spilled_pages \\(KV spill-to-host\\) is unsupported "
                 "with pp_mesh"),
    "pp_tiers": ("pp_mesh", {"prefix_cache": True, "prefix_host_pages": 4},
                 "the tiered prefix cache is unsupported with pp_mesh"),
}


@pytest.mark.parametrize("case", list(JAX_PAIR_REFUSALS))
def test_paged_engine_refuses_jax_pairs_first(case):
    """KV spill and the prefix store tiers under CP and PP raise the JAX
    paged engine's ValueErrors (``k8s_llm_rca_tpu/engine/paged.py:
    1011-1072``) first, with ``speculative_k`` riding along: speculation
    under a mesh is served since the mesh-speculation slice, so nothing
    raises after them; under TP, EP and FSDP spill and the tiers are served
    (``tests/test_torch_mesh_tiers.py``)."""
    name, over, match = JAX_PAIR_REFUSALS[case]
    cfg, ecfg, params, tok = _tiny_engine_args(speculative_k=2)
    ecfg = dataclasses.replace(ecfg, **over)
    with pytest.raises(ValueError, match=match):
        make_engine(cfg, ecfg, params, tok, device="cpu",
                    **{name: _ONE_RANK})


def _one_rank_engine(rmesh, mesh, ecfg, moe=False, params=None, **kw):
    """The paged or contiguous engine (``ecfg.paged``) under a 1-rank
    ``mesh`` (``tp_mesh``, ``ep_mesh``, ``pp_mesh``, ``fsdp_mesh`` or
    ``cp_mesh``) on ``params`` (default: ``_one_rank_params(moe)``'s);
    ``kw`` goes to ``make_engine``."""
    from k8s_llm_rca_tpu_torch.runtime.sharding import (
        FSDP_LAYOUT, llama_param_specs, shard_params, shard_stage_params,
    )

    cfg, params = params or _one_rank_params(moe)
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    m = rmesh.single_device_mesh(device="cpu")
    if mesh == "cp_mesh":
        # CP shards the sequence, not the weights
        return make_engine(cfg, ecfg, params, tok, device="cpu", cp_mesh=m,
                           **kw)
    if mesh == "pp_mesh":
        return make_engine(cfg, ecfg, shard_stage_params(params, cfg, m),
                           tok, device="cpu", pp_mesh=m, pp_microbatches=2,
                           **kw)
    layout = FSDP_LAYOUT if mesh == "fsdp_mesh" else None
    return make_engine(cfg, ecfg, shard_params(
        params, llama_param_specs(cfg, layout), m), tok, device="cpu",
        **{mesh: m}, **kw)


# the 1-rank served cases' prompt and tokens
ONE_RANK_PROMPT = list(range(1, 20))
ONE_RANK_TOKENS = 8


def _one_rank_params(moe=False, x=3.0):
    """The 1-rank cases' seeded weights: TINY, or TINY_MOE, the layers'
    matrices times ``x`` (at the init's scales greedy decode repeats the
    prompt's last token)."""
    cfg = config.TINY_MOE if moe else config.TINY
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for layer in params["layers"]:
        for w in layer.values():
            if w.dim() > 1:
                w.mul_(x)
    return cfg, params


def _one_rank_ecfg(paged):
    return dataclasses.replace(_tiny_engine_args(decode_chunk=1)[1],
                               paged=paged)


def _jax_engine(ecfg, model, draft=None):
    """JAX's plain unsharded engine (its paged engine without kernels, or
    its contiguous engine, by ``ecfg.paged``) on the port's (cfg, params)
    ``model``, with ``draft`` (cfg, params) as its draft model."""
    import jax.numpy as jnp

    from k8s_llm_rca_tpu import config as jconfig
    from k8s_llm_rca_tpu.engine.engine import InferenceEngine
    from k8s_llm_rca_tpu.engine.paged import PagedInferenceEngine
    from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer as jax_tok

    from k8s_llm_rca_tpu_torch.runtime import rules

    def jax_model(cfg, params):
        return (jconfig.ModelConfig(**{f: getattr(cfg, f)
                                       for f in cfg.__dataclass_fields__}),
                rules.map_with_names(lambda _, w: jnp.asarray(w.numpy()),
                                     params))

    jcfg, jparams = jax_model(*model)
    jecfg = jconfig.EngineConfig(**{
        f: getattr(ecfg, f) for f in ecfg.__dataclass_fields__
        if f in jconfig.EngineConfig.__dataclass_fields__})
    kw = {} if draft is None else {"draft_model": jax_model(*draft)}
    tok = jax_tok(vocab_size=jcfg.vocab_size)
    if ecfg.paged:
        return PagedInferenceEngine(jcfg, jecfg, jparams, tok,
                                    use_kernel=False, **kw)
    return InferenceEngine(jcfg, jecfg, jparams, tok, **kw)


@functools.lru_cache(maxsize=None)
def _jax_tokens(paged, moe=False):
    """JAX's plain unsharded engine (its paged engine without kernels, or
    its contiguous engine) on the 1-rank cases' weights, engine config and
    prompt: the greedy tokens."""
    engine = _jax_engine(_one_rank_ecfg(paged), _one_rank_params(moe))
    return engine.generate([ONE_RANK_PROMPT],
                           max_new_tokens=ONE_RANK_TOKENS)[0].token_ids


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("mesh", ["tp_mesh", "ep_mesh", "pp_mesh",
                                  "fsdp_mesh"])
def test_host_overlap_serves_on_one_rank(one_rank_group, mesh, paged):
    """``host_overlap`` under TP, EP, PP and FSDP on both engines (it
    raised naming item 10.7 before the mesh-tiers slice): on a 1-rank
    gloo mesh the plain and the overlapped loop serve the tokens of JAX's
    plain unsharded engine of the same kind (TINY_MOE under EP)."""
    moe = mesh == "ep_mesh"
    want = _jax_tokens(paged, moe)
    assert len(want) == ONE_RANK_TOKENS and len(set(want)) > 2, want
    for overlap in (False, True):
        engine = _one_rank_engine(one_rank_group, mesh, dataclasses.replace(
            _one_rank_ecfg(paged), host_overlap=overlap), moe)
        assert engine.generate([ONE_RANK_PROMPT], ONE_RANK_TOKENS)[
            0].token_ids == want, overlap


# the speculative 1-rank cases: weights times 2 (greedy decode repeats
# some tokens, so n-gram drafts of one token are made and some accepted),
# a draft model of the same shapes times 1.8 (some of its drafts
# accepted), k 3, 16 new tokens
SPEC_SCALE, DRAFT_SCALE = 2.0, 1.8
SPEC_TOKENS = 16
SPEC_COUNTERS = ("engine.spec_drafted", "engine.spec_accepted")


def _spec_ecfg(paged):
    return dataclasses.replace(_one_rank_ecfg(paged), speculative_k=3,
                               speculative_ngram=1)


def _spec_models(drafts, moe):
    """The target (cfg, params) and the draft model (None for n-gram
    drafts) of a speculative 1-rank case."""
    draft = (_one_rank_params(moe, DRAFT_SCALE) if drafts == "draft"
             else None)
    return _one_rank_params(moe, SPEC_SCALE), draft


def _spec_run(engine) -> dict:
    out = engine.generate([ONE_RANK_PROMPT], SPEC_TOKENS)[0].token_ids
    return {"tokens": out, **{k: int(engine._counts.get(k, 0))
                              for k in SPEC_COUNTERS}}


@functools.lru_cache(maxsize=None)
def _jax_spec(paged, drafts, moe):
    """JAX's unsharded speculative engine of the 1-rank cases: the stream
    and the speculation counters."""
    return _spec_run(_jax_engine(_spec_ecfg(paged),
                                 *_spec_models(drafts, moe)))


@pytest.mark.parametrize("drafts", ["ngram", "draft"])
@pytest.mark.parametrize("mesh", ["tp_mesh", "ep_mesh", "fsdp_mesh",
                                  "pp_mesh", "cp_mesh"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_speculation_serves_on_one_rank(one_rank_group, paged, mesh,
                                        drafts):
    """``speculative_k`` (n-gram drafts) and ``draft_model=`` under TP, EP
    (TINY_MOE), FSDP, PP (two microbatches) and CP on both engines (they
    raised naming item 10.8 before the mesh-speculation slice): on a
    1-rank gloo mesh the stream, ``spec_drafted``, ``spec_accepted`` and
    the verify steps are those of JAX's unsharded speculative engine of
    the same kind with the same weights and knobs (JAX counts no verify
    steps); a draft model's drafts go through one counted broadcast a
    verify step."""
    moe = mesh == "ep_mesh"
    want = _jax_spec(paged, drafts, moe)
    assert want["engine.spec_accepted"] > 0, want
    assert len(set(want["tokens"])) > 2, want
    model, draft = _spec_models(drafts, moe)
    engine = _one_rank_engine(one_rank_group, mesh, _spec_ecfg(paged), moe,
                              params=model, draft_model=draft)
    one_rank_group.reset_collective_counts()
    assert _spec_run(engine) == want
    verify = int(engine._counts["engine.verify_steps"])
    broadcasts = one_rank_group.collective_counts()["broadcast"]
    assert verify > 0 and broadcasts == (verify if draft else 0)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_snapshot_restores_across_shardings_on_one_rank(one_rank_group,
                                                        paged):
    """``snapshot_sequences`` / ``restore_sequences`` under a mesh (both
    raised naming item 10.7 before the mesh-tiers slice): a 1-rank TP
    engine's snapshot mid-decode restores into an unsharded engine to the
    uninterrupted stream, JAX's plain unsharded engine's."""
    cfg, params = _one_rank_params()
    ecfg = _one_rank_ecfg(paged)
    eng = _one_rank_engine(one_rank_group, "tp_mesh", ecfg)
    sid = eng.submit(ONE_RANK_PROMPT, max_new_tokens=ONE_RANK_TOKENS)
    for _ in range(3):
        eng.step()
    snap = eng.snapshot_sequences()
    assert snap["sequences"][0]["generated"]
    fresh = make_engine(cfg, ecfg, params, get_tokenizer(
        vocab_size=cfg.vocab_size), device="cpu")
    assert fresh.restore_sequences(snap) == [sid]
    done = {}
    while fresh.has_work:
        done.update({r.seq_id: r.token_ids for r in fresh.step()})
    assert done[sid] == _jax_tokens(paged)


@pytest.mark.parametrize("case", ["restarted_mesh_engine",
                                  "unsharded_after_mesh",
                                  "mesh_over_unsharded_pages"])
def test_prefix_store_serves_one_sharding(one_rank_group, case):
    """A passed ``PrefixStore`` serves one sharding for its life: a
    restarted 1-rank TP engine promotes its predecessor's host-tier pages
    with the same tokens, while an unsharded engine given a TP engine's
    store (whose tier would run that mesh's collectives and leave its
    files to the mesh's writer) and a TP engine given a store whose host
    tier holds an unsharded engine's whole pages are refused."""
    cfg, params = _one_rank_params()
    tok = get_tokenizer(vocab_size=cfg.vocab_size)
    ecfg = dataclasses.replace(_one_rank_ecfg(True), prefix_cache=True,
                               prefix_host_pages=16)
    prompt = [list(range(1, 40))]

    def build(mesh, store=None):
        if mesh:
            return _one_rank_engine(one_rank_group, "tp_mesh", ecfg,
                                    prefix_store=store)
        return make_engine(cfg, ecfg, params, tok, device="cpu",
                           prefix_store=store)

    first = build(case != "mesh_over_unsharded_pages")
    want = first.generate(prompt, 4)[0].token_ids
    first.prefix_cache.evict(10 ** 6)
    store = first.prefix_store
    assert store.n_host > 0
    if case == "restarted_mesh_engine":
        again = build(True, store)
        assert again.generate(prompt, 4)[0].token_ids == want
        assert again._counts["engine.prefix_hits_l1"] > 0
    else:
        match = ("already serves another sharding"
                 if case == "unsharded_after_mesh"
                 else "holds an unsharded engine's pages")
        with pytest.raises(ValueError, match=match):
            build(case == "mesh_over_unsharded_pages", store)


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
