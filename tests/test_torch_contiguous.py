"""The port's contiguous-slot engine (``InferenceEngine``, the JAX
package's default engine) and draft-model speculation against the JAX
package's.

- The model functions of the contiguous cache (``init_cache``,
  ``prefill``, ``prefill_batch``, ``decode_step``, ``decode_multi``) give
  JAX's logits and cache rows, over a model-dtype, int8 and int4 cache.
- The engine, on TINY with its projections scaled x3 (greedy decode then
  walks many distinct tokens), gives JAX's greedy streams stepwise, at
  ``decode_chunk`` 16 and with a compiled-DFA grammar slot riding inside
  the scan; ``draft_model=`` on both engines gives plain greedy's streams
  and JAX's acceptance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_rca_tpu.config import TINY as J_TINY
from k8s_llm_rca_tpu.config import EngineConfig as JEngineConfig
from k8s_llm_rca_tpu.engine import make_engine as j_make_engine
from k8s_llm_rca_tpu.models import llama as j_llama
from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer as j_tokenizer
from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
from k8s_llm_rca_tpu_torch.engine import InferenceEngine, make_engine
from k8s_llm_rca_tpu_torch.models import llama
from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)


def jax_params(cfg=J_TINY, seed=0):
    """TINY with the projection weights scaled x3."""
    p = j_llama.init_params(cfg, jax.random.PRNGKey(seed))
    p["layers"] = [{k: (v * 3.0 if k.startswith("w") else v)
                    for k, v in layer.items()} for layer in p["layers"]]
    return p


def port(tree):
    return llama.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def weights():
    jp = jax_params()
    return jp, port(jp)


def _t(a):
    return torch.from_numpy(np.asarray(a))


TOL = dict(atol=1e-4, rtol=2e-5)


def _jit(fn):
    """The JAX function jitted over its static config, as its engine runs
    it (eager JAX dispatches op by op, far slower)."""
    return jax.jit(fn, static_argnums=0)


@pytest.mark.parametrize("kv", [None, "int8", "int4"])
def test_cache_functions_equal_jax(weights, kv):
    """prefill into slot 1, a batched prefill into slots 2 and 0, three
    decode steps (slot 3 idle at length 0) and a T = 3 verify step: the
    logits (atol 1e-4 and rtol 2e-5: the x3 weights give logits near 20,
    and jitted XLA sums in its own order) and the quantized cache bytes
    equal JAX's."""
    jp, pp = weights
    j_kv = {None: None, "int8": jnp.int8, "int4": "int4"}[kv]
    jc = j_llama.init_cache(J_TINY, 4, 64, kv_dtype=j_kv)
    pc = llama.init_cache(TINY, 4, 64, kv, "cpu")
    assert pc.k.shape == jc.k.shape and pc.quantized == (kv is not None)
    rng = np.random.default_rng(0)
    one = rng.integers(0, 256, (1, 32)).astype(np.int32)
    jc, jl = _jit(j_llama.prefill)(J_TINY, jp, jc, jnp.asarray(one),
                                   jnp.int32(20), jnp.int32(1))
    pc, pl = llama.prefill(TINY, pp, pc, _t(one), 20, 1)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    two = rng.integers(0, 256, (2, 32)).astype(np.int32)
    lens, slots = np.array([32, 9], np.int32), np.array([2, 0], np.int32)
    jc, jl = _jit(j_llama.prefill_batch)(
        J_TINY, jp, jc, *map(jnp.asarray, (two, lens, slots)))
    pc, pl = llama.prefill_batch(TINY, pp, pc, _t(two), _t(lens), _t(slots))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    lengths = np.array([9, 20, 32, 0], np.int32)
    cur = np.array([5, 6, 7, 8], np.int32)
    for _ in range(3):
        jc, jl = _jit(j_llama.decode_step)(J_TINY, jp, jc, jnp.asarray(cur),
                                           jnp.asarray(lengths))
        pc, pl = llama.decode_step(TINY, pp, pc, _t(cur), _t(lengths))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        cur = np.asarray(jl).argmax(-1).astype(np.int32)
        lengths = lengths + 1
    multi = rng.integers(0, 256, (4, 3)).astype(np.int32)
    jc, jl = _jit(j_llama.decode_multi)(J_TINY, jp, jc, jnp.asarray(multi),
                                        jnp.asarray(lengths))
    pc, pl = llama.decode_multi(TINY, pp, pc, _t(multi), _t(lengths))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    if kv is not None:
        # the written rows: slots 0-2 up to their lengths + 3
        for s, n in ((0, 15), (1, 26), (2, 38)):
            np.testing.assert_array_equal(pc.k[:, s, :n].numpy(),
                                          np.asarray(jc.k)[:, s, :n])


def test_decode_past_the_row_clamps_like_jax(weights):
    """A length at the end of the row writes its last position (JAX's
    ``dynamic_update_slice`` clamps), instead of raising."""
    _, pp = weights
    pc = llama.init_cache(TINY, 2, 16, None, "cpu")
    pc, logits = llama.decode_step(TINY, pp, pc, torch.tensor([3, 4]),
                                   torch.tensor([16, 2], dtype=torch.int32))
    assert torch.isfinite(logits).all()
    assert pc.k[:, 0, 15].abs().sum() > 0 and pc.k[:, 0, :15].abs().sum() == 0


def engine_kwargs(**over):
    kw = dict(max_batch=4, max_seq_len=512, prefill_buckets=(128, 256),
              max_new_tokens=40, temperature=0.0, decode_chunk=1)
    kw.update(over)
    return kw


SCHEMA = {"type": "object", "properties": [
    ("kind", {"enum": ["ConfigMap", "Job", "Pod", "Secret"]}),
    ("count", {"type": "integer", "max_digits": 3}),
]}


def test_engine_streams_equal_jax(weights):
    """Stepwise, and at chunk 16 with a compiled-DFA grammar slot: five
    prompts through four slots (one waits for a freed slot; two share a
    bucket and admit in one batched prefill).  The DFA slot scans beside
    free ones (``decode_scan_dfa``) until its document closes, then the
    rest scan without it (``decode_scan``)."""
    from k8s_llm_rca_tpu.engine import constrain as jc
    from k8s_llm_rca_tpu_torch.engine import constrain as tc

    jp, pp = weights
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (5, 60, 130, 300, 17)]
    for chunk, grammar in ((1, False), (16, True)):
        kw = engine_kwargs(decode_chunk=chunk)
        je = j_make_engine(J_TINY, JEngineConfig(**kw), jp, j_tokenizer())
        te = make_engine(TINY, EngineConfig(**kw), pp, get_tokenizer(),
                         "cpu")
        assert isinstance(te, InferenceEngine)
        out = []
        for eng, mod in ((je, jc), (te, tc)):
            ids = [eng.submit(p, max_new_tokens=40 if i != 4 else 90,
                              grammar=mod.DFAGrammar(SCHEMA, eng.tokenizer)
                              if grammar and i == 4 else None)
                   for i, p in enumerate(prompts)]
            res = {r.seq_id: r for r in eng.run_to_completion()}
            out.append([(res[i].token_ids, res[i].finish_reason)
                        for i in ids])
        assert out[1] == out[0], (chunk, grammar)
        c = te._counts
        assert c["engine.batched_admissions"] >= 2
        assert (c["engine.decode_steps"] > c["engine.dispatches"]) == \
            (chunk > 1)
        assert not te._active and not te.lengths.any()


def test_draft_model_equals_greedy_and_jax(weights):
    """The target's own weights as the draft (every draft accepted: the
    path where the draft's extra scan step must have written the last
    draft's KV), on the contiguous and the paged engine: streams equal
    plain greedy's and JAX's, and so do the accepted drafts and the
    draft's re-prefills."""
    jp, pp = weights
    d_cfg, jd = J_TINY, jp
    draft = (TINY, pp)
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (5, 60, 130, 17)]
    plain = [r.token_ids for r in make_engine(
        TINY, EngineConfig(**engine_kwargs()), pp, get_tokenizer(),
        "cpu").generate(prompts)]
    for paged in (False, True):
        kw = engine_kwargs(speculative_k=3, paged=paged, page_size=16)
        je = j_make_engine(J_TINY, JEngineConfig(**kw), jp, j_tokenizer(),
                           draft_model=(d_cfg, jd))
        te = make_engine(TINY, EngineConfig(**kw), pp, get_tokenizer(),
                         "cpu", draft_model=draft)
        want = [r.token_ids for r in je.generate(prompts)]
        got = [r.token_ids for r in te.generate(prompts)]
        assert got == plain and got == want
        assert te._counts["engine.spec_accepted"] == \
            je._counts["engine.spec_accepted"] > 0
        assert te._draft.prefills == je._draft.prefills
    with pytest.raises(ValueError, match="speculative_k > 0"):
        make_engine(TINY, EngineConfig(**engine_kwargs()), pp,
                    get_tokenizer(), "cpu", draft_model=draft)
