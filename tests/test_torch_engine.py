"""The port's PagedInferenceEngine vs the JAX one: equal greedy token
streams.

The config is ``faults/soak.py::_build_engine_service``'s (TINY, paged,
greedy, no prefix cache) shrunk to tier-1 size: max_seq_len 512, buckets
(128, 256), page 16.  Every prompt decodes across page boundaries, the
300-token one overflows the buckets, and ``decode_chunk`` 16 scans up to
16 steps per tick over pre-allocated pages.  The projection weights are
scaled x3 so greedy decode walks many distinct tokens instead of
repeating one; a divergence would then show in the first differing
token.  On a mismatch, check the logit margin before calling it a bug
(random-weight near-ties, ROADMAP Queue 3)."""

import jax
import numpy as np
import pytest

from k8s_llm_rca_tpu.config import TINY as J_TINY
from k8s_llm_rca_tpu.config import EngineConfig as JEngineConfig
from k8s_llm_rca_tpu.engine import make_engine as j_make_engine
from k8s_llm_rca_tpu.models import llama as jllama
from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer as j_tokenizer
from k8s_llm_rca_tpu_torch.config import TINY, EngineConfig
from k8s_llm_rca_tpu_torch.engine import make_engine
from k8s_llm_rca_tpu_torch.models.llama import params_from_numpy
from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

PROMPT_LENS = (5, 60, 130, 300)


def engine_kwargs(**over):
    kw = dict(max_batch=4, max_seq_len=512, prefill_buckets=(128, 256),
              max_new_tokens=40, temperature=0.0, paged=True, page_size=16,
              num_pages=168, prefix_cache=False, decode_chunk=16)
    kw.update(over)
    return kw


def jax_params():
    """TINY with the projection weights scaled x3 (see module docstring)."""
    p = jllama.init_params(J_TINY, jax.random.PRNGKey(0))
    p["layers"] = [{k: (v * 3.0 if k.startswith("w") else v)
                    for k, v in layer.items()} for layer in p["layers"]]
    return p


def engines(**over):
    """The JAX engine and the port's CPU engine on the same weights."""
    params = jax_params()
    je = j_make_engine(J_TINY, JEngineConfig(**engine_kwargs(**over)), params,
                       j_tokenizer(vocab_size=J_TINY.vocab_size),
                       use_kernel=False)
    te = make_engine(TINY, EngineConfig(**engine_kwargs(**over)),
                     params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu"),
                     get_tokenizer(vocab_size=TINY.vocab_size), device="cpu")
    return je, te


@pytest.mark.parametrize("over,prompt_lens", [
    ({"decode_chunk": 1}, PROMPT_LENS),
    ({"decode_chunk": 16}, PROMPT_LENS),
    # 51 usable pages: all four admit (48 pages), then growth past the
    # buckets runs the pool dry and preempts the youngest, which resumes
    # by re-prefill
    ({"decode_chunk": 16, "num_pages": 52}, (120, 120, 250, 250)),
], ids=["stepwise", "scan16", "scan16-preemption"])
def test_greedy_streams_match_jax(over, prompt_lens):
    je, te = engines(**over)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in prompt_lens]
    jres = je.generate(prompts)
    tres = te.generate(prompts)
    for j, t in zip(jres, tres):
        assert t.token_ids == j.token_ids
        assert (t.finish_reason, t.text, t.prompt_tokens,
                t.completion_tokens) == (j.finish_reason, j.text,
                                         j.prompt_tokens, j.completion_tokens)
    assert len(set(jres[0].token_ids)) > 5        # not a repeated token
    preempted = te._counts.get("engine.preemptions", 0)
    assert preempted == je._counts.get("engine.preemptions", 0)
    assert (preempted > 0) == ("num_pages" in over)
    te.allocator.check()
    assert te.allocator.n_free == te.engine_cfg.num_pages - 1


def test_stop_strings_trim_like_jax():
    """Stop strings end a scanned chunk mid-way: the text and the tokens
    committed after the trim match the JAX engine."""
    je, te = engines()
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in (20, 90)]
    stop = je.generate(prompts)[1].text[5:7]
    jres = je.generate(prompts, stop_strings=(stop,))
    tres = te.generate(prompts, stop_strings=(stop,))
    assert [t.finish_reason for t in tres] == ["stop", "stop"]
    for j, t in zip(jres, tres):
        assert (t.token_ids, t.text, t.finish_reason) == \
            (j.token_ids, j.text, j.finish_reason)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def time(self):
        return self.t


def test_deadlines_reap_active_and_queued_like_jax():
    """One slot: the running sequence and the queued one both pass their
    deadline; the next tick reaps both, with what each generated."""
    engines_ = engines(max_batch=1)
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in (30, 40)]
    out = []
    for eng in engines_:
        eng.clock = _Clock()
        ids = [eng.submit(p, deadline_s=5.0) for p in prompts]
        eng.step()
        eng.step()
        eng.clock.t = 10.0
        res = sorted(eng.step(), key=lambda r: r.seq_id)
        assert [r.seq_id for r in res] == ids and not eng.has_work
        out.append([(r.finish_reason, r.token_ids, r.completion_tokens)
                    for r in res])
    assert out[1] == out[0]
    assert [o[0] for o in out[1]] == ["expired", "expired"]
    assert len(out[1][0][1]) > 0 and out[1][1][1] == []


@pytest.mark.parametrize("over,first,then", [
    # a 470-token prompt runs its 40 tokens and retires at length 510;
    # the next batch scans with that slot idle
    ({}, (470,), (range(5, 15), range(5, 75))),
    # 40 usable pages: the 470-token prompt holds 32, the 97-token one 8;
    # the short one's growth at 128 tokens preempts the long one at ~500
    # tokens, which cannot re-admit until the short one retires
    ({"max_batch": 2, "num_pages": 41}, (97, 470), ()),
], ids=["retired", "preempted-near-cap"])
def test_freed_slot_length_resets_like_jax(over, first, then):
    """A freed slot keeps no length: the decode scan advances idle slots
    too, and one left near ``max_seq_len`` would walk its position past
    the block table."""
    je, te = engines(**over)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in first]
    streams = []
    for eng in (je, te):
        tokens = [r.token_ids for r in eng.generate(prompts)]
        if then:
            tokens += [r.token_ids for r in eng.generate(
                [list(p) for p in then], max_new_tokens=5)]
        streams.append(tokens)
    assert streams[1] == streams[0]
    preempted = te._counts.get("engine.preemptions", 0)
    assert preempted == je._counts.get("engine.preemptions", 0)
    assert (preempted > 0) == ("num_pages" in over)
    assert not te.lengths.any()
    te.allocator.check()
