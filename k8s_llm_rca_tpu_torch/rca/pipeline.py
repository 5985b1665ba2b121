"""Full RCA pipeline: stages 1-3 wired with the reference's failure policy.

Mirrors the e2e drivers' control flow (test_all.py:18-161,
test_with_file.py:20-229): srcKind -> destKind planning with <=3
retry-with-feedback attempts (the exception text is appended to the thread)
-> metapath ladder -> per-metapath cypher generation with <=3 retries ->
deterministic compiler fallback on exhaustion OR zero records -> per-record
statepath audit -> per-incident result dict with time_cost and windowed
token usage (the exact batch-driver output schema,
test_with_file.py:67-204).

The port of ``k8s_llm_rca_tpu/rca/pipeline.py`` without its two optional
attachments: the resilience policy's degradation ladder (``faults/policy.py``,
ROADMAP Queue 1 item 3) and the embedding reranker (``rca/rerank.py``, Queue
1 item 7).  Passing either raises ``NotImplementedError``; without them the
control flow is the JAX package's fail-fast one above, line for line.

The incident is a **resumable state machine**: ``incident_steps`` is a
generator that SUBMITS every LLM run and yields it instead of blocking in
``wait_run``.  ``analyze_incident`` drives the generator sequentially
(``serve.api.drive_steps`` waits on each yielded run — byte-identical to
the historical blocking control flow); the sweep scheduler
(rca/scheduler.py) drives K incidents' generators interleaved over one
shared engine pump, so incident B's prefill admits while incident A's
audits decode.  Greedy outputs depend only on per-thread message history
(serve.api.render_prompt), so the two schedulings produce byte-identical
reports — scheduling is latency-only.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from k8s_llm_rca_tpu_torch.config import RCAConfig, SweepConfig
from k8s_llm_rca_tpu_torch.graph.executor import CypherSyntaxError
from k8s_llm_rca_tpu_torch.obs import trace as obs_trace
from k8s_llm_rca_tpu_torch.rca import auditor, cyphergen, locator
from k8s_llm_rca_tpu_torch.serve.api import AssistantService, drive_steps
from k8s_llm_rca_tpu_torch.utils.logging import METRICS, get_logger

log = get_logger(__name__)

IncidentResult = Dict[str, Any]


@dataclass
class RCAPipeline:
    """Owns the three assistants + two graph executors for a sweep."""

    service: AssistantService
    meta_executor: Any
    state_executor: Any
    cfg: RCAConfig = field(default_factory=RCAConfig)
    sweep: SweepConfig = field(default_factory=SweepConfig)
    # the JAX pipeline's embedding reranker and resilience policy; both
    # unported, so anything but None raises
    reranker: Optional[Any] = None
    resilience: Optional[Any] = None

    def __post_init__(self):
        if self.reranker is not None:
            raise NotImplementedError(
                "RCAPipeline(reranker=...) needs rca/rerank.py, which is not "
                "ported yet (ROADMAP Queue 1 item 7, rerank and loading)")
        if self.resilience is not None:
            raise NotImplementedError(
                "RCAPipeline(resilience=...) needs faults/policy.py, which is "
                "not ported yet (ROADMAP Queue 1 item 3, fault injection)")
        # vocabulary first: the locator's structured-output schema constrains
        # every kind field to it (locator.plan_schema)
        self.native_kinds, self.external_kinds = \
            locator.find_native_external_kinds(self.meta_executor)
        self.locator = locator.setup_root_cause_locator(
            self.service, self.cfg.model,
            max_new_tokens=self.cfg.locator_max_new_tokens,
            kind_vocabulary=self.native_kinds + self.external_kinds,
            constrained=self.cfg.constrained)
        self.prompt_template = locator.build_prompt_template(
            self.native_kinds, self.external_kinds)
        self.cypher_generator = cyphergen.setup_cypher_generator(
            self.service, self.cfg.model,
            max_new_tokens=self.cfg.cypher_max_new_tokens)
        self.analyzer = auditor.setup_state_semantic_analyzer(
            self.service, self.cfg.model,
            max_new_tokens=self.cfg.analyzer_max_new_tokens,
            constrained=self.cfg.constrained)

    def reset_threads(self) -> None:
        """Fresh stage threads with their seeds re-applied: bounds prompt
        growth for long sweeps (cfg.fresh_threads runs this per incident).
        The old threads stay in the service store, so windowed token
        accounting over past runs (get_token_usage) is unaffected."""
        self.locator.create_thread()
        cyphergen.seed_generation_template(self.cypher_generator)
        auditor.seed_analyzer_thread(self.analyzer)

    # ------------------------------------------------------------ stage 1

    def plan_destination(self, error_message: str, src_kind: str
                         ) -> (Dict[str, Any], int):
        """destKind planning with retry-with-feedback (test_all.py:63-83).
        Blocking driver of ``_plan_steps`` — one code path for both
        schedulings."""
        return drive_steps(self._plan_steps(error_message, src_kind),
                           self.service)

    def _plan_steps(self, error_message: str, src_kind: str):
        """Step generator for destKind planning: submit, YIELD the pending
        run, parse on resume — retry-with-feedback preserved verbatim."""
        last_err: Optional[Exception] = None
        for attempt in range(self.cfg.locator_max_attempts):
            try:
                run = locator.submit_destKind_plan(
                    error_message, src_kind, self.prompt_template,
                    self.locator)
                yield run
                plan = locator.parse_destKind_plan(self.locator, run)
                plan["DestinationKind"]   # missing keys retry with feedback,
                                          # like the reference's in-try dict
                                          # access (test_all.py:63-83)
                return plan, attempt + 1
            except json.JSONDecodeError as e:
                log.warning("locator JSON error (attempt %d): %s", attempt, e)
                self.locator.add_message(
                    "The dest_relevant reply raised this exception:\n"
                    f"JSON Error occurred: {e}\n"
                    "Return the output as JSON inside a ```json fence.")
                last_err = e
            except Exception as e:
                log.warning("locator error (attempt %d): %s", attempt, e)
                self.locator.add_message(
                    "The dest_relevant reply raised this exception:\n"
                    f"An unexpected error occurred: {e}\n"
                    "Based on the exception details above, generate a "
                    "correct dest_relevant.")
                last_err = e
        raise RuntimeError(
            f"destKind planning failed after "
            f"{self.cfg.locator_max_attempts} attempts") from last_err

    # ------------------------------------------------------------ stage 2

    def compile_and_run(self, metapath_str: str, error_message: str,
                        analysis: Dict[str, Any]) -> List[Any]:
        """Cypher generation with retries + deterministic fallback
        (test_all.py:99-131).  Mutates ``analysis`` with attempt metadata.
        Blocking driver of ``_cypher_steps``."""
        return drive_steps(
            self._cypher_steps(metapath_str, error_message, analysis),
            self.cypher_generator.service)

    def _cypher_steps(self, metapath_str: str, error_message: str,
                      analysis: Dict[str, Any]):
        from k8s_llm_rca_tpu_torch.serve.backend import BudgetError

        records: List[Any] = []
        cypher_query = None
        generated_ok = False
        attempt = 0
        for attempt in range(self.cfg.cypher_max_attempts):
            try:
                run = cyphergen.submit_cypher_query(
                    metapath_str, error_message, self.cypher_generator,
                    constrain=self.cfg.constrained)
                yield run
                cypher_query = cyphergen.parse_cypher_query(
                    self.cypher_generator, run)
                records = cyphergen.run_and_filter_query(
                    self.state_executor, cypher_query)
                generated_ok = True
                break
            except BudgetError as e:
                # the budget cannot hold ANY valid output for this request:
                # retrying replays the identical failure (and the feedback
                # message would only grow the prompt further) — go straight
                # to the deterministic fallback
                log.warning("cypher budget error (attempt %d): %s",
                            attempt, e)
                break
            except CypherSyntaxError as e:
                log.warning("cypher syntax error (attempt %d): %s", attempt, e)
                self.cypher_generator.add_message(
                    "The previously generated cypher query raised:\n"
                    f"Cypher Syntax Error occurred: {e}\n"
                    "Generate a corrected version of the Cypher query.")
            except Exception as e:
                log.warning("cypher error (attempt %d): %s", attempt, e)
                self.cypher_generator.add_message(
                    "The previously generated cypher query raised:\n"
                    f"An unexpected error occurred: {e}\n"
                    "Generate a corrected version of the Cypher query.")
        analysis["cypher_query"] = cypher_query
        analysis["cypher_attempts"] = attempt + 1

        # fall back when generation never succeeded, or succeeded but
        # matched nothing (usually a semantic error in the query)
        if not generated_ok or not records:
            fallback = cyphergen.compile_metapath_query(
                metapath_str, error_message)
            records = cyphergen.run_and_filter_query(
                self.state_executor, fallback)
            analysis["human_cypher_query"] = fallback
        return records

    # ------------------------------------------------------------ pipeline

    def analyze_incident(self, error_message: str,
                         usage_by_runs: bool = False) -> IncidentResult:
        """One incident end-to-end; returns the batch-driver result dict
        (schema of test_with_file.py:67-204).  With a tracer active
        (obs/trace.py) the incident runs under an ``rca.incident`` span
        with per-stage child spans, and the result dict carries a compact
        ``flight`` summary of everything recorded while it ran.

        Blocking driver of ``incident_steps`` — the exact code the sweep
        scheduler interleaves, scheduled sequentially.  ``usage_by_runs``
        switches token accounting from the reference's wall-clock window
        to exact attribution by the run ids this incident created (the
        window double-counts when incidents overlap in time — the
        pipelined sweep always uses exact attribution, on BOTH legs of a
        parity comparison)."""
        return drive_steps(
            self.incident_steps(error_message, usage_by_runs=usage_by_runs),
            self.service)

    @contextlib.contextmanager
    def _stage_span(self, name: str, pipelined: bool, **args):
        """Stage bracketing that survives generator suspension.  The
        sequential driver keeps the historical context-manager span
        (thread-local parentage intact).  Under the scheduler a span held
        open across a yield would corrupt the tracer's thread-local stack
        (machines interleave on ONE thread), so the pipelined path records
        an explicit-times span after the fact (Tracer.add_span — the
        serve.run pattern)."""
        if not pipelined:
            with obs_trace.span(name, cat="rca", **args):
                yield
            return
        tr = obs_trace.active()
        t0 = tr.now() if tr is not None else 0.0
        try:
            yield
        finally:
            tr = obs_trace.active()
            if tr is not None:
                tr.add_span(name, t0, tr.now(), cat="rca", args=dict(args))

    def _track(self, gen, run_ids: List[str]):
        """yield-from with run-id capture: every Run the inner step
        generator yields is recorded, giving the incident the exact set of
        run ids it created for ``usage_for_runs`` attribution."""
        try:
            pending = next(gen)
            while True:
                run_ids.append(pending.id)
                yield pending
                pending = gen.send(None)
        except StopIteration as stop:
            return stop.value

    def incident_steps(self, error_message: str,
                       usage_by_runs: bool = False,
                       pipelined: bool = False):
        """Resumable incident state machine: locate -> metapath -> per-
        metapath cypher -> per-record audits, with the retry-with-feedback
        loops intact — every LLM step SUBMITS
        its run and yields it instead of waiting.  The caller resumes the
        generator once the yielded run is terminal; ``StopIteration.value``
        is the incident result dict.

        ``pipelined`` only changes how stage spans are recorded (explicit
        times instead of a context manager held across yields — see
        ``_stage_span``); the submitted prompts, and therefore greedy
        outputs, are identical under both schedulings."""
        t0 = time.time()
        run_ids: List[str] = []
        if self.cfg.fresh_threads:
            self.reset_threads()
        result: IncidentResult = {"error_message": error_message}
        tracer = obs_trace.active()
        mark = tracer.mark() if tracer is not None else None
        with METRICS.timer("rca.incident"), \
                self._stage_span("rca.incident", pipelined,
                                 incident=error_message[:60]):
            with METRICS.timer("rca.stage.locate"), \
                    self._stage_span("rca.stage.locate", pipelined):
                src_kind = locator.find_srcKind(self.state_executor,
                                                error_message)
                plan, attempts = yield from self._track(
                    self._plan_steps(error_message, src_kind), run_ids)
            result["locator_attempts"] = attempts

            dest_kind = plan["DestinationKind"]
            relevant = plan.get("RelevantResources", [])
            known = set(self.native_kinds) | set(self.external_kinds)
            intermediate = [x for x in relevant
                            if x not in (src_kind, dest_kind) and x in known]

            with METRICS.timer("rca.stage.metapath"), \
                    self._stage_span("rca.stage.metapath", pipelined):
                metapaths = locator.find_metapath(
                    self.meta_executor, src_kind, dest_kind, intermediate,
                    self.cfg.metapath_max_hops)

            result["analysis"] = []
            for metapath in metapaths:
                metapath_str = cyphergen.extend_metapath_construct_string(
                    metapath)
                analysis: Dict[str, Any] = {"extend_metapath": metapath_str}
                with METRICS.timer("rca.stage.cypher"), \
                        self._stage_span("rca.stage.cypher", pipelined,
                                         metapath=metapath_str[:60]):
                    records = yield from self._track(
                        self._cypher_steps(metapath_str, error_message,
                                           analysis), run_ids)
                analysis["statepath"] = []
                for record in records:
                    with METRICS.timer("rca.stage.audit"), \
                            self._stage_span("rca.stage.audit", pipelined):
                        report, clues = yield from self._track(
                            auditor.check_statepath_steps(
                                self.state_executor, self.analyzer, record,
                                concurrent=self.cfg.concurrent_audits,
                                fields_top_k=self.cfg.rerank_fields_top_k),
                            run_ids)
                    analysis["statepath"].append(
                        {"report": report, "clue": clues})
                result["analysis"].append(analysis)

        t1 = time.time()
        result["time_cost"] = t1 - t0
        if usage_by_runs:
            # exact attribution by the run ids THIS incident created —
            # scheduling-invariant, so pipelined == sequential byte-wise
            result["token_usage"] = self.service.usage_for_runs(run_ids)
        else:
            result["token_usage"] = self.window_token_usage(
                int(t0), int(t1) + 1)
        if tracer is not None:
            # compact flight-recorder digest of everything recorded while
            # THIS incident ran (spans/events/ticks since the mark) — the
            # report-side breadcrumb pointing into the full Chrome trace
            result["flight"] = tracer.flight_summary(since=mark)
        return result

    def window_token_usage(self, tmin: int, tmax: int,
                           sweep: Optional[SweepConfig] = None) -> Dict[str, int]:
        """Aggregate usage across the three assistants in [tmin, tmax)
        (limits mirror the reference's retry arithmetic,
        test_with_file.py:177-198)."""
        sweep = sweep or self.sweep
        u1 = self.locator.get_token_usage(tmin, tmax, sweep.locator_usage_limit)
        u2 = self.cypher_generator.get_token_usage(
            tmin, tmax, sweep.cypher_usage_limit)
        # assistant-scoped for the analyzer: concurrent audits run on
        # sub-threads, which the thread-scoped window would miss
        u3 = self.service.assistant_token_usage(
            self.analyzer.assistant.id, tmin, tmax,
            sweep.analyzer_usage_limit)
        usages = [u1, u2, u3]
        reporter = getattr(self.analyzer, "reporter", None)
        if reporter is not None:       # the schema-constrained summary runs
            usages.append(self.service.assistant_token_usage(
                reporter.assistant.id, tmin, tmax,
                sweep.analyzer_usage_limit))
        return {k: sum(u[k] for u in usages) for k in u1}
