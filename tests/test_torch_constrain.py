"""The port's ``engine/constrain.py`` against the JAX package's, at TINY's
byte vocabulary (512): the compiled DFA tables of the report and plan
schemas are equal array for array, and a constraint/advance walk gives
equal constraints for ``DFAGrammar`` and for ``SchemaGrammar`` built
directly.  ``"json"`` is left out: its bounded DFA compiles 15340 states
in seconds.  The walk picks among allowed tokens with a seeded numpy
generator and shrinks the budget as it goes, so the budget-aware masks
and the force-close path are compared too."""

import numpy as np
import pytest

from k8s_llm_rca_tpu.engine import constrain as jc
from k8s_llm_rca_tpu.rca.auditor import report_schema as j_report
from k8s_llm_rca_tpu.rca.locator import plan_schema as j_plan
from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer as j_tokenizer
from k8s_llm_rca_tpu_torch.engine import constrain as tc
from k8s_llm_rca_tpu_torch.rca.auditor import report_schema
from k8s_llm_rca_tpu_torch.rca.locator import plan_schema
from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

KINDS = ["ConfigMap", "Job", "Namespace", "Pod", "Secret"]
SCHEMAS = {"report": (j_report, report_schema, ()),
           "plan": (j_plan, plan_schema, (KINDS,))}
FIELDS = ("token_next", "allow", "dist", "close_tok", "complete", "single")
SCALARS = ("start", "free_state", "close_margin", "eos_id", "n_states")


def _schemas(name):
    j_fn, t_fn, args = SCHEMAS[name]
    j_schema, t_schema = j_fn(*args), t_fn(*args)
    assert j_schema == t_schema
    return j_schema, t_schema


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_dfa_tables_equal_jax(name):
    j_schema, t_schema = _schemas(name)
    jt = jc.compile_schema_dfa(j_schema, j_tokenizer(vocab_size=512))
    tt = tc.compile_schema_dfa(t_schema, get_tokenizer(vocab_size=512))
    for f in FIELDS:
        a, b = getattr(jt, f), getattr(tt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in SCALARS:
        assert getattr(jt, f) == getattr(tt, f), f
    assert jt.n_states > 500          # a real automaton, not a stub


def _walk(grammar, budget, seed):
    """Constraints of a seeded walk: (force, allow bytes) per step."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(budget):
        c = grammar.constraint(budget - step)
        out.append((c.force, None if c.allow is None
                    else np.packbits(c.allow).tobytes()))
        if c.force is not None:
            token = c.force
        elif c.allow is not None:
            token = int(rng.choice(np.flatnonzero(c.allow)))
        else:
            token = 0
        if token == grammar.eos_id:
            break
        grammar.advance(token)
    return out


@pytest.mark.parametrize("kind", ["DFAGrammar", "SchemaGrammar"])
@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_constraint_walk_equals_jax(name, kind):
    j_schema, t_schema = _schemas(name)
    jg = getattr(jc, kind)(j_schema, j_tokenizer(vocab_size=512))
    tg = getattr(tc, kind)(t_schema, get_tokenizer(vocab_size=512))
    assert jg.min_budget() == tg.min_budget()
    # a budget a little above the minimal document: the walk must close
    budget = tg.min_budget() + 40
    jw, tw = _walk(jg, budget, 0), _walk(tg, budget, 0)
    assert tw == jw
    assert tw[-1][0] == tg.eos_id     # the document closed inside the budget
    assert any(a is not None for _, a in tw)    # masked steps were compared
