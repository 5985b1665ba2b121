"""The port's AssistantService + EngineBackend vs the JAX pair: the same
assistants, threads and messages give equal reply text and token usage.
Engines as in test_torch_engine (TINY, paged, greedy, weights x3)."""

import pytest
import torch

from k8s_llm_rca_tpu.serve.api import AssistantService as JService
from k8s_llm_rca_tpu.serve.api import run_reply_text as j_reply
from k8s_llm_rca_tpu.serve.backend import EngineBackend as JBackend
from k8s_llm_rca_tpu.serve.backend import GenOptions as JGen
from k8s_llm_rca_tpu_torch.serve.api import AssistantService, run_reply_text
from k8s_llm_rca_tpu_torch.serve.backend import EngineBackend, GenOptions
from test_torch_engine import engines

# One intra-op thread: the tier-1 run puts six pytest workers on the
# host's cores, and an oversubscribed OpenMP pool spins through every
# small op (a TINY engine case ran ~30x slower under that load).
torch.set_num_threads(1)

CONVERSATION = [
    # (assistant, thread, user message)
    ("locator", 0, "pod payment-7f9 CrashLoopBackOff since 09:12; which "
                   "kinds should we inspect first?"),
    ("auditor", 1, "node ip-10-0-3-7 NotReady, kubelet stopped posting "
                   "status."),
    ("locator", 0, "also: deployment payment has 0/3 replicas available."),
]


def _drive(service_cls, backend_cls, gen_cls, engine, reply):
    svc = service_cls(backend_cls(engine))
    gens = {"locator": gen_cls(max_new_tokens=24),
            "auditor": gen_cls(max_new_tokens=16, forced_prefix="```json\n",
                               suffix="\n```", stop=("```",))}
    asst = {name: svc.create_assistant(f"You are the {name}.", name,
                                       gen=gen)
            for name, gen in gens.items()}
    threads = [svc.create_thread(), svc.create_thread()]
    out = []
    # first wave: two runs in flight at once (one continuous batch)
    runs = []
    for name, ti, text in CONVERSATION[:2]:
        svc.add_message(threads[ti].id, text)
        runs.append(svc.create_run(threads[ti].id, asst[name].id))
    for run in runs:
        svc.wait_run(run.id)
    # second wave grows thread 0 (the reply of wave one is in its history)
    name, ti, text = CONVERSATION[2]
    svc.add_message(threads[ti].id, text)
    runs.append(svc.create_run(threads[ti].id, asst[name].id))
    svc.wait_run(runs[-1].id)
    for run in runs:
        out.append((run.status, reply(svc, run), dict(run.usage)))
    return out


def test_assistant_runs_match_jax():
    je, te = engines()
    jax_out = _drive(JService, JBackend, JGen, je, j_reply)
    port_out = _drive(AssistantService, EngineBackend, GenOptions, te,
                      run_reply_text)
    assert [o[0] for o in port_out] == ["completed"] * 3
    assert port_out == jax_out
    assert port_out[1][1].startswith("```json\n")


SCHEMA = {"type": "object", "properties": [
    ("kind", {"enum": ["ConfigMap", "Pod", "Secret"]}),
    ("score", {"enum": [str(i) for i in range(11)]}),
    ("note", {"type": "string", "max_len": 16}),
]}


def _grammar_gen(gen_cls, max_new_tokens):
    return gen_cls(max_new_tokens=max_new_tokens, forced_prefix="```json\n",
                   suffix="\n```", stop=("```",), grammar=SCHEMA)


def test_grammar_is_refused():
    """A grammar run whose budget cannot hold the schema's minimal
    document is refused with ``BudgetError`` at submission, as in JAX."""
    from k8s_llm_rca_tpu.serve.backend import BudgetError as JBudgetError
    from k8s_llm_rca_tpu_torch.serve.backend import BudgetError

    je, te = engines()
    for backend, gen_cls, err in ((JBackend(je), JGen, JBudgetError),
                                  (EngineBackend(te), GenOptions,
                                   BudgetError)):
        with pytest.raises(err, match="minimal document"):
            backend.start("hello", _grammar_gen(gen_cls, 8))
    assert not te.has_work


def test_grammar_runs_match_jax():
    """Schema-constrained runs through the service: two in one batch,
    reply text and usage equal to JAX's, and each body parses."""
    import json

    def drive(service_cls, backend_cls, gen_cls, engine, reply):
        svc = service_cls(backend_cls(engine))
        asst = svc.create_assistant("You are the reporter.", "reporter",
                                    gen=_grammar_gen(gen_cls, 60))
        runs = []
        for _, _, text in CONVERSATION[:2]:
            thread = svc.create_thread()
            svc.add_message(thread.id, text)
            runs.append(svc.create_run(thread.id, asst.id))
        for run in runs:
            svc.wait_run(run.id)
        return [(run.status, reply(svc, run), dict(run.usage))
                for run in runs]

    je, te = engines()
    jax_out = drive(JService, JBackend, JGen, je, j_reply)
    port_out = drive(AssistantService, EngineBackend, GenOptions, te,
                     run_reply_text)
    assert port_out == jax_out
    for status, text, _ in port_out:
        assert status == "completed" and text.startswith("```json\n")
        assert json.loads(text[len("```json\n"):-len("\n```")])["kind"]


def test_cancel_frees_the_slot_and_pages():
    _, te = engines()
    svc = AssistantService(EngineBackend(te))
    asst = svc.create_assistant("You are the locator.", "locator",
                                gen=GenOptions(max_new_tokens=40))
    thread = svc.create_thread()
    svc.add_message(thread.id, "pod payment-7f9 CrashLoopBackOff")
    run = svc.create_run(thread.id, asst.id)
    assert svc.poll_run(run.id).status == "in_progress"   # admitted, decoding
    assert te.allocator.n_free < te.engine_cfg.num_pages - 1
    assert svc.cancel_run(run.id).status == "cancelled"
    assert not te.has_work and len(te._free_slots) == te.engine_cfg.max_batch
    assert te.allocator.n_free == te.engine_cfg.num_pages - 1
    svc.pump_once()                       # nothing left to settle
    assert svc.runs[run.id].status == "cancelled"


def test_traced_run_records_engine_ticks_and_the_run_span():
    from k8s_llm_rca_tpu_torch.obs import trace

    _, te = engines()
    svc = AssistantService(EngineBackend(te))
    asst = svc.create_assistant("You are the auditor.", "auditor",
                                gen=GenOptions(max_new_tokens=8))
    thread = svc.create_thread()
    svc.add_message(thread.id, "node ip-10-0-3-7 NotReady")
    tracer = trace.Tracer()
    with trace.tracing(tracer):
        run = svc.wait_run(svc.create_run(thread.id, asst.id).id)
    names = [sp.name for sp in tracer.spans]
    assert "engine.tick" in names and names[-1] == "serve.run"
    assert tracer.spans[-1].args["completion_tokens"] == 8
    assert run.usage["completion_tokens"] == 8
    assert {e.name for e in tracer.events} >= {"serve.run_started",
                                               "backend.settled"}


@pytest.mark.parametrize("kw", [{"reply": "the answer"}, {"fail": True}],
                         ids=["reply", "fail"])
def test_echo_backend_unported_options_raise(kw):
    from k8s_llm_rca_tpu_torch.serve.backend import EchoBackend
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        EchoBackend(get_tokenizer(), **kw)


def test_generic_assistant_over_echo_matches_jax():
    """The reference-compatible client over the echo backend: the same
    calls give the same replies, listings and windowed usage as JAX's
    (two runs on one thread, the second still in flight for a pump)."""
    from k8s_llm_rca_tpu.serve.api import GenericAssistant as JClient
    from k8s_llm_rca_tpu.serve.backend import EchoBackend as JEcho
    from k8s_llm_rca_tpu.utils.tokenizer import get_tokenizer as j_tok
    from k8s_llm_rca_tpu_torch.serve.api import GenericAssistant
    from k8s_llm_rca_tpu_torch.serve.backend import EchoBackend
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    def drive(service_cls, client_cls, echo_cls, tok):
        svc = service_cls(echo_cls(tok, delay_pumps=2))
        client = client_cls(svc)
        client.create_assistant("You are the locator.", "locator")
        client.create_thread()
        out = []
        for text in ("pod payment-7f9 CrashLoopBackOff",
                     "deployment payment has 0/3 replicas"):
            client.add_message(text)
            client.run_assistant()
            out.append(client.get_run_status().status)
            msgs = client.wait_get_last_k_message(2)
            out.append([(m.role, m.content[0].text.value)
                        for m in msgs.data])
        client.retrieve_thread(client.thread.id)
        client.retrieve_assistant(client.assistant.id)
        out.append([m.content[0].text.value
                    for m in client.get_all_message().data])
        out.append(client.get_token_usage(0, 1 << 40))
        return out

    jax_out = drive(JService, JClient, JEcho, j_tok())
    port_out = drive(AssistantService, GenericAssistant, EchoBackend,
                     get_tokenizer())
    assert port_out == jax_out
    assert port_out[0] == "in_progress"
    assert port_out[-1]["completion_tokens"] > 0
