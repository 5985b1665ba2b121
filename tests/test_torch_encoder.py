"""The port's rerank path against the JAX package's: the e5 encoder
(``models/encoder.py``), the embedder, cosine rerank and the reranker
(``rca/rerank.py``), and the oracle RCA pipeline with a reranker fused in.

Weights are the JAX encoder's ``PRNGKey(0)`` TINY_ENCODER tree carried
across through numpy.  fp32 holds to atol 1e-5; bf16 (both sides round
every matmul output) to a row-relative 2^-5; int8 and int4 trees are
quantized by each package and held byte for byte, then run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.config import RCAConfig as J_RCAConfig
from k8s_llm_rca_tpu.config import TINY_ENCODER as J_TINY_ENCODER
from k8s_llm_rca_tpu.models import encoder as j_encoder
from k8s_llm_rca_tpu.models import quant as j_quant
from k8s_llm_rca_tpu.ops import norms as j_norms
from k8s_llm_rca_tpu.rca import rerank as j_rerank
from k8s_llm_rca_tpu_torch.config import TINY_ENCODER, RCAConfig
from k8s_llm_rca_tpu_torch.models import encoder
from k8s_llm_rca_tpu_torch.models.llama import params_from_numpy
from k8s_llm_rca_tpu_torch.models.quant import quantize_params
from k8s_llm_rca_tpu_torch.ops.norms import layer_norm
from k8s_llm_rca_tpu_torch.rca import rerank

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

PASSAGES = [
    "pod web-1 is pending: secret db-cred not found",
    "node ip-10-0-3-7 reports memory pressure",
    "configmap es-gen-white-list-configmap does not exist",
    "deployment payment has 3 replicas available",
    "service frontend selects no endpoints",
    "persistent volume claim data-0 is bound",
]
QUERY = "MountVolume.SetUp failed: secret \"db-cred\" not found"


@pytest.fixture(scope="module")
def weights():
    """The JAX encoder tree (``PRNGKey(0)``) and the same on the port."""
    jp = j_encoder.init_params(J_TINY_ENCODER, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(seed=0, b=3, s=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, TINY_ENCODER.vocab_size, (b, s)).astype(np.int32)
    lens = np.array([s, 7, 1][:b], np.int32)
    return toks, lens


def _row_rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float((np.abs(a - b).max(-1) / np.abs(b).max(-1)).max())


def test_layer_norm_equals_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 7, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(j_norms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b)))
    got = layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fn", ["forward", "embed"])
def test_fp32_equals_jax(weights, fn):
    jp, pp = weights
    toks, lens = _tokens()
    want = jax.jit(getattr(j_encoder, fn), static_argnums=0)(
        J_TINY_ENCODER, jp, jnp.asarray(toks), jnp.asarray(lens))
    got = getattr(encoder, fn)(TINY_ENCODER, pp, torch.from_numpy(toks),
                               torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_bf16_embed_row_relative(weights):
    jp, _ = weights
    jcfg = J_TINY_ENCODER.__class__(**{**J_TINY_ENCODER.__dict__,
                                       "dtype": "bfloat16"})
    cfg = TINY_ENCODER.__class__(**{**TINY_ENCODER.__dict__,
                                    "dtype": "bfloat16"})
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    pb = params_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    toks, lens = _tokens(2)
    want = jax.jit(j_encoder.embed, static_argnums=0)(
        jcfg, jb, jnp.asarray(toks), jnp.asarray(lens))
    got = encoder.embed(cfg, pb, torch.from_numpy(toks),
                        torch.from_numpy(lens))
    assert _row_rel(got.numpy(), want) < 2 ** -5
    # the pooled vectors point the same way (unit vectors both)
    assert np.all(np.sum(got.numpy() * np.asarray(want), -1) > 0.999)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_trees_and_embeddings_equal_jax(weights, bits):
    """Each package quantizes the same fp32 tree (f32 scales): the bytes
    agree, the embedding tables get per-row scales in both (their keys
    contain ``embedding``), and the embeddings agree."""
    jp, pp = weights
    jq = j_quant.quantize_params(jp, compute_dtype=jnp.float32, bits=bits)
    pq = quantize_params(pp, compute_dtype=torch.float32, bits=bits)
    for jl, pl in zip(jax.tree.leaves(jq), _leaves(pq)):
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    toks, lens = _tokens(3)
    want = jax.jit(j_encoder.embed, static_argnums=0)(
        J_TINY_ENCODER, jq, jnp.asarray(toks), jnp.asarray(lens))
    got = encoder.embed(TINY_ENCODER, pq, torch.from_numpy(toks),
                        torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        yield from tree
    else:
        yield tree


def test_padding_does_not_leak(weights):
    """A row's embedding is the same alone, right-padded to 12, and in a
    batch with longer rows."""
    _, pp = weights
    toks, _ = _tokens(4, b=2, s=12)
    alone = encoder.embed(TINY_ENCODER, pp, torch.from_numpy(toks[1:2, :5]))
    padded = toks.copy()
    padded[1, 5:] = 7
    batch = encoder.embed(TINY_ENCODER, pp, torch.from_numpy(padded),
                          torch.tensor([12, 5], dtype=torch.int32))
    np.testing.assert_allclose(batch[1].numpy(), alone[0].numpy(),
                               atol=1e-6, rtol=0)


def test_embedder_buckets_equal_jax(weights):
    """Texts of 4 to 300 bytes over buckets (16, 64, 512) in batches of
    2: each batch pads to its own bucket, and the vectors equal JAX's."""
    jp, pp = weights
    texts = ["ab", "x" * 40, "pod " * 20, "y" * 300, "node", "z" * 63]
    kw = dict(buckets=(16, 64, 512), batch_size=2)
    want = j_rerank.Embedder(J_TINY_ENCODER, jp, **kw).encode(texts)
    emb = rerank.Embedder(TINY_ENCODER, pp, device="cpu", **kw)
    assert emb.buckets == (16, 64, 512)
    assert [emb._bucket(n) for n in (1, 16, 17, 65, 600)] == \
        [16, 16, 64, 512, 512]
    got = emb.encode(texts)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert emb.encode([]).shape == (0, TINY_ENCODER.hidden_size)


def test_cosine_rerank_equals_jax():
    rng = np.random.default_rng(6)
    pv = rng.standard_normal((9, 16)).astype(np.float32)
    pv[4] = pv[2]                          # a tie: the lower index first
    q = rng.standard_normal(16).astype(np.float32)
    assert rerank.cosine_rerank(q, pv) == j_rerank.cosine_rerank(q, pv)


def test_reranker_order_equals_jax(weights):
    """Same order as JAX's reranker over the passages (the adjacent score
    margins are far above the 1e-5 the vectors agree to, so no flip is a
    near tie), the same top-k, and the 16-entry query cache."""
    jp, pp = weights
    j_rr = j_rerank.Reranker(j_rerank.Embedder(J_TINY_ENCODER, jp))
    rr = rerank.Reranker(rerank.Embedder(TINY_ENCODER, pp, device="cpu"))
    want, got = j_rr.rerank(QUERY, PASSAGES), rr.rerank(QUERY, PASSAGES)
    assert [i for i, _ in got] == [i for i, _ in want]
    scores = [s for _, s in want]
    assert min(a - b for a, b in zip(scores, scores[1:])) > 1e-4
    np.testing.assert_allclose([s for _, s in got], scores, atol=1e-5)
    assert rr.rerank(QUERY, PASSAGES, top_k=2) == got[:2]
    assert rr.rerank(QUERY, []) == []
    for i in range(20):
        rr._query_vec(f"q{i}")
    assert len(rr._query_cache) == 16 and "q19" in rr._query_cache


def test_record_text_equals_jax():
    from k8s_llm_rca_tpu.graph.store import Node as JNode
    from k8s_llm_rca_tpu_torch.graph.store import Node

    props = [{"kind": "Pod", "name2": "web-1", "message": "pending"},
             {"kind": "Secret", "val": "db-cred", "ignored": "x"}]
    j_rec = [JNode(i, ["STATE"], p) for i, p in enumerate(props)]
    rec = [Node(i, ["STATE"], p) for i, p in enumerate(props)]
    assert rerank._record_text(rec) == j_rerank._record_text(j_rec)
    for odd in (5, [], ["plain", 3]):
        assert rerank._record_text(odd) == j_rerank._record_text(odd)


class _TwoWays:
    """A graph executor whose statepath queries (``RETURN evt, ...``)
    answer each record twice: first cut to its event, the entity event
    node and its last node, then as found.  The fixture graph has one record per metapath, and
    the pipeline reranks only two or more."""

    def __init__(self, inner):
        self.inner = inner

    def run_query(self, query, parameters=None):
        records = self.inner.run_query(query, parameters)
        if "RETURN evt" not in query:
            return records
        cut = [list(r)[:3] + list(r)[-1:] for r in records]
        return cut + list(records)

    def close(self):
        self.inner.close()


def _pipeline_run(pkg, weights, cfg, message):
    """One oracle incident through ``pkg``'s pipeline with a reranker on
    the shared weights: the result and the analyzer runs' prompts."""
    if pkg == "jax":
        from k8s_llm_rca_tpu.graph import InMemoryGraphExecutor
        from k8s_llm_rca_tpu.graph.fixtures import (
            build_metagraph, build_stategraph,
        )
        from k8s_llm_rca_tpu.rca import RCAPipeline
        from k8s_llm_rca_tpu.rca.oracle import OracleBackend
        from k8s_llm_rca_tpu.serve.api import AssistantService
        from k8s_llm_rca_tpu.utils import get_tokenizer
        rr = j_rerank.Reranker(j_rerank.Embedder(J_TINY_ENCODER, weights[0]))
    else:
        from k8s_llm_rca_tpu_torch.graph import InMemoryGraphExecutor
        from k8s_llm_rca_tpu_torch.graph.fixtures import (
            build_metagraph, build_stategraph,
        )
        from k8s_llm_rca_tpu_torch.rca import RCAPipeline
        from k8s_llm_rca_tpu_torch.rca.oracle import OracleBackend
        from k8s_llm_rca_tpu_torch.serve.api import AssistantService
        from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer
        rr = rerank.Reranker(rerank.Embedder(TINY_ENCODER, weights[1],
                                             device="cpu"))
    svc = AssistantService(OracleBackend(get_tokenizer()))
    pipe = RCAPipeline(svc, InMemoryGraphExecutor(build_metagraph()),
                       _TwoWays(InMemoryGraphExecutor(build_stategraph())),
                       cfg, reranker=rr)
    result = pipe.analyze_incident(message)
    result.pop("time_cost")
    analyzer = pipe.analyzer.assistant.id
    prompts = [(r.usage["prompt_tokens"], [m.raw_content for m in
                                           svc.threads[r.thread_id].messages])
               for r in svc.runs.values() if r.assistant_id == analyzer]
    return result, prompts


@pytest.mark.parametrize("fields_top_k", [0, 2])
def test_pipeline_with_reranker_equals_jax(weights, fields_top_k):
    """The oracle pipeline with a reranker: the same records in the same
    order, the same analyzer prompts and prompt tokens, rerank scores
    within 1e-5; at ``rerank_fields_top_k`` 2 the prompts shrink (JAX's
    shrink test) and the clue labels stay."""
    from k8s_llm_rca_tpu.graph.fixtures import INCIDENTS

    message = INCIDENTS[3].message
    runs = {}
    for k in (0, fields_top_k):
        want, j_prompts = _pipeline_run(
            "jax", weights, J_RCAConfig(rerank_fields_top_k=k), message)
        got, prompts = _pipeline_run(
            "port", weights, RCAConfig(rerank_fields_top_k=k), message)
        scored = [(a.pop("rerank_scores", None), b.pop("rerank_scores", None))
                  for a, b in zip(got["analysis"], want["analysis"])]
        assert any(s is not None for s, _ in scored)
        for s, js in scored:
            assert (s is None) == (js is None)
            if s is not None:
                assert s == sorted(s, reverse=True)
                np.testing.assert_allclose(s, js, atol=1e-5)
        assert got == want
        assert prompts == j_prompts and prompts
        runs[k] = got
    if fields_top_k:
        base, slim = runs[0], runs[fields_top_k]
        assert (slim["token_usage"]["prompt_tokens"]
                < base["token_usage"]["prompt_tokens"])

        def labels(r):
            return sorted(k for a in r["analysis"] for sp in a["statepath"]
                          for k in sp["clue"])
        assert labels(slim) == labels(base)
