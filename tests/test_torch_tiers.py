"""The port's memory tiers against the JAX package's: the page codec, the
prefix store (host RAM and disk), the tiered prefix cache, the knob checks
and the native allocator and JSON grammar.

The engines are ``tests/test_prefix_tiers.py``'s (TINY at max_seq_len 128,
page 16, 40 pages, the prefix cache on, three prompts sharing a 75-token
preamble).  Each runs the prompts cold, demotes every resident page with
``evict(10**6)`` and runs them again from the promoted pages: the port's
streams and tier counters must equal JAX's."""

import os

import jax
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.config import TINY as J_TINY
from k8s_llm_rca_tpu.config import EngineConfig as JEngineConfig
from k8s_llm_rca_tpu.engine import make_engine as j_make_engine
from k8s_llm_rca_tpu.engine.constrain import JsonGrammar as JJsonGrammar
from k8s_llm_rca_tpu.models import llama as jllama
from k8s_llm_rca_tpu.utils import pages as jpages
from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer as j_tokenizer
from k8s_llm_rca_tpu_torch import native
from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
from k8s_llm_rca_tpu_torch.engine import make_engine
from k8s_llm_rca_tpu_torch.engine.constrain import JsonGrammar, make_grammar
from k8s_llm_rca_tpu_torch.engine.paged import (
    AllocatorError, OutOfPages, PageAllocator, make_allocator,
)
from k8s_llm_rca_tpu_torch.engine.prefix import PrefixStore
from k8s_llm_rca_tpu_torch.models.llama import params_from_numpy
from k8s_llm_rca_tpu_torch.utils import pages
from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

_PRE = "shared incident preamble " * 3
PROMPTS = (_PRE + "kubelet crashloop on node-7",
           _PRE + "etcd leader lost quorum",
           _PRE + "pvc unbound on nfs chain")
TIER_COUNTERS = ("engine.prefix_demotions", "engine.prefix_hits_l0",
                 "engine.prefix_hits_l1", "engine.prefix_hits_l2",
                 "engine.prefix_promoted_pages",
                 "engine.prefix_bytes_restored", "engine.spilled_pages",
                 "engine.restored_pages", "engine.d2h_syncs",
                 "engine.prefix_watermark_demotions",
                 "engine.prefix_writethrough_pages")


@pytest.fixture(scope="module")
def setup():
    jcfg = J_TINY.replace(max_seq_len=128)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, TINY.replace(max_seq_len=128), tp


def _ecfg(cls, **over):
    base = dict(max_batch=2, max_seq_len=128, prefill_buckets=(64, 128),
                max_new_tokens=16, temperature=0.0, paged=True,
                page_size=16, num_pages=40, prefix_cache=True,
                decode_chunk=4)
    base.update(over)
    return cls(**base)


def _port_engine(setup, store=None, **over):
    _, _, cfg, tp = setup
    return make_engine(cfg, _ecfg(EngineConfig, **over), tp,
                       get_tokenizer(vocab_size=cfg.vocab_size),
                       device="cpu", prefix_store=store)


def _run(eng):
    tok = eng.tokenizer
    sids = [eng.submit(tok.encode(p)) for p in PROMPTS]
    out = {}
    while eng.has_work:
        for r in eng.step():
            out[r.seq_id] = r
    eng.allocator.check()
    resident = eng.prefix_cache.n_resident if eng.prefix_cache else 0
    assert eng.allocator.n_free + resident == eng.engine_cfg.num_pages - 1
    return [out[s].token_ids for s in sids]


# ----------------------------------------------------------- page codec


def _records():
    rng = np.random.default_rng(0)
    return {
        "fp32": {"n_pages": 1,
                 "k": rng.standard_normal((2, 1, 4, 8)).astype(np.float32),
                 "v": rng.standard_normal((2, 1, 4, 8)).astype(np.float32)},
        "int8": {"n_pages": 1,
                 "k": rng.integers(-128, 128, (2, 1, 4, 4), dtype=np.int8),
                 "v": rng.integers(-128, 128, (2, 1, 4, 4), dtype=np.int8),
                 "k_scale": rng.random((2, 1, 4), dtype=np.float32),
                 "v_scale": rng.random((2, 1, 4), dtype=np.float32)},
    }


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_page_files_are_byte_equal_both_ways(kind):
    """The port writes JAX's bytes for a record and each reads the other's
    file back to the same arrays."""
    rec = _records()[kind]
    jframe = jpages.encode_page_record(rec)
    tframe = pages.encode_page_record(
        {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in rec.items()})
    assert tframe == jframe
    back_t = pages.decode_page_record(jframe)
    back_j = jpages.decode_page_record(tframe)
    for f in pages.record_fields(rec):
        assert isinstance(back_t[f], torch.Tensor)
        assert np.array_equal(back_t[f].numpy(), rec[f])
        assert back_j[f].dtype == rec[f].dtype
        assert np.array_equal(back_j[f], rec[f])


def test_bf16_page_file_reads_as_bf16_in_the_port_only():
    """JAX writes a bf16 field under its ml_dtypes tag ``'<V2'``: its own
    decoder reads it back as ``|V2``, which ``records_compatible`` refuses
    (an L2 hit of a bf16 pool is a cold miss there).  The port writes the
    same bytes and reads the field back as bf16."""
    import ml_dtypes

    rng = np.random.default_rng(1)
    k = rng.standard_normal((2, 1, 4, 8)).astype(ml_dtypes.bfloat16)
    v = rng.standard_normal((2, 1, 4, 8)).astype(ml_dtypes.bfloat16)
    jframe = jpages.encode_page_record({"n_pages": 1, "k": k, "v": v})
    assert jpages.decode_page_record(jframe)["k"].dtype.str == "|V2"
    back = pages.decode_page_record(jframe)
    assert back["k"].dtype == torch.bfloat16
    assert np.array_equal(back["k"].view(torch.int16).numpy(),
                          k.view(np.int16))
    tk = torch.from_numpy(k.view(np.int16)).view(torch.bfloat16)
    tv = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    assert pages.encode_page_record({"n_pages": 1, "k": tk,
                                     "v": tv}) == jframe
    pool = type("Pool", (), {"quantized": False,
                             "k": torch.zeros((2, 5, 4, 8),
                                              dtype=torch.bfloat16),
                             "v": torch.zeros((2, 5, 4, 8),
                                              dtype=torch.bfloat16)})()
    assert pages.records_compatible(pool, back)


def test_codec_rejects_torn_and_corrupt_frames():
    rec = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in _records()["fp32"].items()}
    frame = pages.encode_page_record(rec)
    assert pages.decode_page_record(frame[:-3]) is None
    bad = bytearray(frame)
    bad[-1] ^= 0xFF
    assert pages.decode_page_record(bytes(bad)) is None
    assert pages.decode_page_record(b"") is None
    assert pages.decode_page_record(b"garbage that is not a frame") is None


def test_gather_split_stack_restore_round_trip():
    """gather -> split -> stack -> restore into other page ids writes the
    same bytes, in place (the pool's tensors are the same objects)."""
    from k8s_llm_rca_tpu_torch.engine.paged import init_paged_cache

    cfg = TINY.replace(max_seq_len=128)
    for kv in (None, "int8", "int4"):
        pool = init_paged_cache(cfg, 12, 16, "cpu", kv_dtype=kv)
        for t in pool:
            if t is not None:
                t.copy_(torch.randint(-100, 100, t.shape).to(t.dtype))
        ids = [5, 2, 7]
        rec = pages.gather_pages(pool, pages.to_host, ids)
        assert pages.pool_compatible(pool, rec)
        back = pages.stack_pages(pages.split_pages(rec))
        k_before = pool.k
        same = pages.restore_pages(pool, back, [9, 10, 11])
        assert same is pool and pool.k is k_before
        for f in pages.pool_fields(pool):
            t = getattr(pool, f)
            assert torch.equal(t[:, [9, 10, 11]], t[:, ids])


def _paged_record(kind):
    """A three-page record of 4-token pages: fp32 pages, or int8 pages
    with their per-token scales."""
    rng = np.random.default_rng(2)
    if kind == "fp32":
        return {"n_pages": 3,
                "k": rng.standard_normal((2, 3, 4, 8)).astype(np.float32),
                "v": rng.standard_normal((2, 3, 4, 8)).astype(np.float32)}
    return {"n_pages": 3,
            "k": rng.integers(-128, 128, (2, 3, 4, 8), dtype=np.int8),
            "v": rng.integers(-128, 128, (2, 3, 4, 8), dtype=np.int8),
            "k_scale": rng.random((2, 3, 4), dtype=np.float32),
            "v_scale": rng.random((2, 3, 4), dtype=np.float32)}


@pytest.mark.parametrize("kind", ["fp32", "int8"])
@pytest.mark.parametrize("length,dst", [(12, 4), (9, 8), (11, 3), (1, 16),
                                        (12, 12)])
def test_convert_page_record_matches_jax(kind, length, dst):
    """Re-chunking a record onto another page size gives JAX's arrays,
    zero tail included."""
    rec = _paged_record(kind)
    want = jpages.convert_page_record(rec, length, dst)
    got = pages.convert_page_record(
        {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in rec.items()}, length, dst)
    assert got["n_pages"] == want["n_pages"]
    assert pages.record_fields(got) == jpages.record_fields(want)
    for f in pages.record_fields(got):
        assert got[f].dtype == torch.from_numpy(want[f]).dtype
        assert np.array_equal(got[f].numpy(), want[f])


@pytest.mark.parametrize("length,dst,claim", [
    (0, 8, 3), (13, 8, 3), (12, 0, 3), (12, 8, 2)],
    ids=["empty", "past-end", "no-page-size", "torn"])
def test_convert_page_record_refuses_like_jax(length, dst, claim):
    rec = dict(_paged_record("fp32"), n_pages=claim)
    with pytest.raises(ValueError, match="convert_page_record"):
        jpages.convert_page_record(rec, length, dst)
    with pytest.raises(ValueError, match="convert_page_record"):
        pages.convert_page_record(
            {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in rec.items()}, length, dst)


# --------------------------------------------------------- prefix store


def _rec(fill=1.0):
    return {"n_pages": 1, "k": torch.full((2, 1, 4, 8), fill),
            "v": torch.full((2, 1, 4, 8), -fill)}


def test_store_l1_lru_and_overflow_order(tmp_path):
    store = PrefixStore(host_pages=2, disk_dir=str(tmp_path / "l2"))
    store.put(b"a" * 20, _rec(1))
    store.put(b"b" * 20, _rec(2))
    got = store.get(b"a" * 20)
    assert got is not None and got[1] == 1        # refreshed: now newest
    store.put(b"c" * 20, _rec(3))                 # overflows LRU "b"
    assert store.n_host == 2 and store.n_disk == 1
    got_b = store.get(b"b" * 20)
    assert got_b is not None and got_b[1] == 2    # served from disk
    assert torch.equal(got_b[0]["k"], _rec(2)["k"])
    assert store.contains(b"c" * 20)


def test_store_disk_cap_restart_and_bad_files(tmp_path):
    """The disk cap drops the oldest entry; a new store on the directory
    re-indexes what survived; foreign, torn and corrupt files are cold
    misses, never errors; knobs validate as JAX's store does."""
    d = str(tmp_path / "l2")
    store = PrefixStore(host_pages=0, disk_dir=d, disk_pages=3)
    keys = [bytes([i]) * 20 for i in range(5)]
    for i, key in enumerate(keys):
        store.put(key, _rec(i))
    assert store.n_disk == 3
    assert len([f for f in os.listdir(d) if f.endswith(".page")]) == 3
    assert store.get(keys[0]) is None and store.get(keys[4]) is not None
    for name in ("notes.txt", "zzzz.page"):
        with open(os.path.join(d, name), "w") as f:
            f.write("not a page record")
    again = PrefixStore(disk_dir=d)
    assert again.n_disk == 3
    names = sorted(f for f in os.listdir(d) if f.endswith(".page")
                   and f != "zzzz.page")
    with open(os.path.join(d, names[0]), "r+b") as f:
        f.seek(12)
        f.write(b"\xa5\x5a\xa5\x5a")
    size = os.path.getsize(os.path.join(d, names[1]))
    with open(os.path.join(d, names[1]), "r+b") as f:
        f.truncate(size // 2)
    hits = [again.get(bytes.fromhex(n[:-5])) for n in names]
    assert [h is not None for h in hits] == [False, False, True]
    assert again.n_disk == 1
    with pytest.raises(ValueError, match="must be >= 0"):
        PrefixStore(host_pages=-1)
    with pytest.raises(ValueError, match="needs disk_dir"):
        PrefixStore(disk_pages=4)


# ------------------------------------------------ tiered parity matrix

MATRIX = {
    "l1": dict(prefix_host_pages=64),
    "l2_only": dict(prefix_host_pages=0, disk=True),
    "l1_l2": dict(prefix_host_pages=4, disk=True),
    "l1_all": dict(prefix_host_pages=64, decode_chunk=1, host_overlap=True,
                   prefill_chunk_budget=32, max_spilled_pages=64),
    "watermark_writethrough": dict(prefix_host_pages=64,
                                   prefix_hbm_watermark=30,
                                   prefix_store_writethrough=True),
}


@pytest.mark.parametrize("feature", sorted(MATRIX))
def test_tiered_streams_and_counters_match_jax(setup, tmp_path, feature):
    """Cold run, demote every resident page, re-run from the promoted
    pages: the port's streams and tier counters equal JAX's, and the
    promoted run's streams equal the cold run's."""
    jcfg, jp, _, _ = setup
    out = []
    for side in ("jax", "port"):
        kw = dict(MATRIX[feature])
        if kw.pop("disk", False):
            kw["prefix_disk_dir"] = str(tmp_path / side)
        if side == "jax":
            eng = j_make_engine(jcfg, _ecfg(JEngineConfig, **kw), jp,
                                j_tokenizer(vocab_size=jcfg.vocab_size),
                                use_kernel=False)
        else:
            eng = _port_engine(setup, **kw)
        cold = _run(eng)
        assert eng.prefix_cache.evict(10 ** 6) > 0
        warm = _run(eng)
        out.append((cold, warm,
                    {k: (eng._counts or {}).get(k, 0)
                     for k in TIER_COUNTERS}))
    assert out[1] == out[0]
    cold, warm, counts = out[1]
    assert warm == cold
    hits = counts["engine.prefix_hits_l1"] + counts["engine.prefix_hits_l2"]
    assert hits > 0 and counts["engine.prefix_promoted_pages"] == hits
    if "prefix_hbm_watermark" in MATRIX[feature]:
        assert counts["engine.prefix_watermark_demotions"] > 0
        assert counts["engine.prefix_writethrough_pages"] > 0


def test_shared_store_warm_starts_a_fresh_engine(setup, tmp_path):
    """One engine publishes its chains (``flush_prefix_store``); a fresh
    engine on the same store serves the prompts from L2 with the first
    engine's tokens."""
    store = PrefixStore(host_pages=0, disk_dir=str(tmp_path / "l2"))
    first = _port_engine(setup, store=store)
    cold = _run(first)
    assert first.flush_prefix_store() > 0
    fresh = _port_engine(setup, store=PrefixStore(
        disk_dir=str(tmp_path / "l2")))
    assert _run(fresh) == cold
    assert fresh._counts.get("engine.prefix_hits_l2", 0) > 0


def test_watermark_and_writethrough(setup, tmp_path):
    """``prefix_hbm_watermark`` demotes at the tick boundary when the free
    count dips under it, ``prefix_store_writethrough`` publishes chains as
    they grow; neither changes a token."""
    cold = _run(_port_engine(setup))
    eng = _port_engine(setup, prefix_host_pages=64, prefix_hbm_watermark=30,
                       prefix_store_writethrough=True)
    assert _run(eng) == cold
    assert _run(eng) == cold
    c = eng._counts
    assert c.get("engine.prefix_watermark_demotions", 0) > 0
    assert c.get("engine.prefix_writethrough_pages", 0) > 0


@pytest.mark.parametrize("over,match", [
    ({"prefix_host_pages": -1}, "must be >= 0"),
    ({"prefix_disk_pages": 4}, "needs prefix_disk_dir"),
    ({"prefix_cache": False, "prefix_host_pages": 8}, "prefix_cache=True"),
    ({"max_spilled_pages": -1}, "must be >= 0"),
    ({"prefix_hbm_watermark": 40}, "over capacity"),
    ({"prefix_store_writethrough": True}, "without a store"),
], ids=["host-negative", "disk-cap-no-dir", "no-prefix-cache",
        "spill-negative", "watermark-over", "writethrough-no-store"])
def test_tier_knobs_refused_like_jax(setup, over, match):
    jcfg, jp, _, _ = setup
    with pytest.raises(ValueError, match=match):
        j_make_engine(jcfg, _ecfg(JEngineConfig, **over), jp,
                      j_tokenizer(vocab_size=jcfg.vocab_size),
                      use_kernel=False)
    with pytest.raises(ValueError, match=match):
        _port_engine(setup, **over)


# --------------------------------------------------------------- native


def test_native_allocator_op_for_op_against_python():
    """The same random alloc / transfer / free schedule on both
    allocators: the same pages, failures, owners and free counts, and the
    same errors on a foreign, double or trash-page free."""
    rng = np.random.default_rng(0)
    py, cc = PageAllocator(32), native.NativePageAllocator(32)
    held = {}
    for step in range(300):
        if rng.random() < 0.55 or not held:
            n, owner = int(rng.integers(1, 5)), int(rng.integers(0, 6))
            got = []
            for a in (py, cc):
                try:
                    got.append(a.alloc(n, owner))
                except OutOfPages:
                    got.append(None)
            assert got[0] == got[1], step
            if got[0] is not None:
                held.setdefault(owner, []).extend(got[0])
        elif rng.random() < 0.2:
            owner = list(held)[int(rng.integers(0, len(held)))]
            for a in (py, cc):
                a.transfer(held[owner], owner, -2)
            held.setdefault(-2, []).extend(held.pop(owner))
        else:
            owner = list(held)[int(rng.integers(0, len(held)))]
            for a in (py, cc):
                a.free(held[owner], owner)
            held.pop(owner)
        assert py.n_free == cc.n_free, step
        for owner in held:
            assert sorted(py.pages_of(owner)) == cc.pages_of(owner)
    for a in (py, cc):
        a.check()
        page = held[next(iter(held))][0] if held else a.alloc(1, 9)[0]
        with pytest.raises(AllocatorError):
            a.free([page], owner=77)
        with pytest.raises(AllocatorError):
            a.free([0], owner=1)
    assert type(make_allocator(8)) is native.NativePageAllocator
    assert type(make_allocator(8, prefer_native=False)) is PageAllocator


def test_python_allocator_when_the_library_is_unavailable(setup,
                                                          monkeypatch):
    """Where the library cannot be built, the engine logs, counts
    ``engine.allocator_python`` and serves with the Python allocator; the
    failure is remembered, not retried."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "native library unavailable: "
                        "no compiler")
    eng = _port_engine(setup)
    assert type(eng.allocator) is PageAllocator
    assert eng._counts["engine.allocator_python"] == 1
    assert "engine.allocator_native" not in eng._counts
    with pytest.raises(RuntimeError, match="no compiler"):
        native.load_library()
    assert _run(eng) == _run(_port_engine(setup, native=False))


def test_json_grammar_masks_equal_with_and_without_native():
    """Along random grammar-legal walks, the native JSON grammar's masks
    and forced tokens equal the Python grammar's and the JAX package's;
    ``make_grammar("json")`` returns the bounded DFA at this vocab either
    way, so the two grammars are held to each other directly."""
    tok = get_tokenizer()
    assert type(make_grammar("json", tok)) is type(
        make_grammar("json", tok, prefer_native=False))
    rng = np.random.default_rng(1)
    for _ in range(3):
        grammars = (JsonGrammar(tok), native.NativeJsonGrammar(tok),
                    JJsonGrammar(j_tokenizer()))
        for _ in range(30):
            cs = [g.constraint(40) for g in grammars]
            assert cs[0].force == cs[1].force == cs[2].force
            if cs[0].force is not None:
                token = cs[0].force
            else:
                assert np.array_equal(cs[0].allow, cs[1].allow)
                assert np.array_equal(cs[0].allow, cs[2].allow)
                token = int(rng.choice(np.flatnonzero(cs[0].allow)))
            if token == tok.eos_id:
                break
            for g in grammars:
                g.advance(token)
