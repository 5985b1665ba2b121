"""Continuous-batching engine surface: the port of ``EngineBase`` from
``k8s_llm_rca_tpu/engine/engine.py``, the parts the paged engine uses.

Submission and prompt clamping, the priority queue, deadlines, cancel,
finish reasons and stop-string trimming, the chunk choice of the scanned
decode tick, the commit loop that trims after EOS and the grammar paths
(per-slot constraints of a stepwise tick, the constrained first token, the
fused DFA tables of a constrained scan and its device step
``dfa_scan_step``) all follow the JAX engine line for line, so the two
packages emit equal greedy token streams.  Host-overlap, speculative
decoding, snapshot/restore and fault injection are not ported (ROADMAP
Queue 1 item 3); the paged engine refuses the knobs that would turn them
on.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from k8s_llm_rca_tpu_torch.config import EngineConfig, ModelConfig
from k8s_llm_rca_tpu_torch.engine.sampling import (
    SamplingParams, sample_tokens_masked,
)
from k8s_llm_rca_tpu_torch.obs import trace as obs_trace
from k8s_llm_rca_tpu_torch.utils.logging import METRICS, get_logger
from k8s_llm_rca_tpu_torch.utils.tokenizer import Tokenizer

log = get_logger(__name__)


@dataclass
class SequenceResult:
    seq_id: int
    token_ids: List[int]
    text: str
    finish_reason: str          # "stop" | "eos" | "length" | "expired" | "cancelled"
    prompt_tokens: int
    completion_tokens: int


@dataclass
class _Active:
    seq_id: int
    slot: int
    prompt_tokens: int
    generated: List[int] = field(default_factory=list)
    max_new_tokens: int = 256
    stop_strings: Tuple[str, ...] = ()
    grammar: Optional[object] = None    # engine/constrain.py FSM (stateful)
    priority: int = 1           # serve.backend.Priority; lower = more urgent


@dataclass
class _Pending:
    seq_id: int
    prompt_ids: List[int]
    max_new_tokens: int
    stop_strings: Tuple[str, ...]
    grammar: Optional[object] = None
    priority: int = 1


class EngineBase:
    """Shared engine surface; subclasses implement ``_tick`` and
    ``_retire`` with their own slot/cache bookkeeping."""

    model_cfg: ModelConfig
    engine_cfg: EngineConfig
    tokenizer: Tokenizer
    # injectable time() source for deadlines; None = wall time
    clock = None
    _deadlines: Optional[Dict[int, float]] = None
    # per-engine mirror of the engine.* METRICS counters
    _counts: Optional[Dict[str, float]] = None

    def _now(self) -> float:
        return self.clock.time() if self.clock is not None else time.time()

    # -------------------------------------------------------- shared api

    def _clamp_prompt(self, prompt_ids: Sequence[int],
                      max_new_tokens: Optional[int]) -> Tuple[List[int], int]:
        """Fit prompt + generation into the per-sequence cache budget:
        shrink max_new first; if the prompt alone overflows keep its TAIL,
        reserving at least cap//4 tokens of generation room."""
        max_new = (self.engine_cfg.max_new_tokens
                   if max_new_tokens is None else max_new_tokens)
        prompt_ids = list(prompt_ids)
        cap = self.engine_cfg.max_seq_len
        if len(prompt_ids) + max_new + 1 > cap:
            reserve = min(max_new, max(1, cap // 4))
            budget = cap - reserve - 1
            if len(prompt_ids) > budget:
                log.warning(
                    "truncating prompt %d -> %d tokens (cache cap %d)",
                    len(prompt_ids), budget, cap)
                had_bos = prompt_ids[0] == self.tokenizer.bos_id
                prompt_ids = prompt_ids[-budget:]
                if had_bos:   # keep BOS conditioning after tail-truncation
                    prompt_ids[0] = self.tokenizer.bos_id
            max_new = min(max_new, cap - len(prompt_ids) - 1)
        return prompt_ids, max_new

    @property
    def has_work(self) -> bool:
        return bool(self._active or self._pending)

    def submit(self, prompt_ids: Sequence[int],
               max_new_tokens: Optional[int] = None,
               stop_strings: Sequence[str] = (),
               grammar: Optional[object] = None, priority: int = 1,
               deadline_s: Optional[float] = None) -> int:
        """Queue a sequence; returns its seq_id.  Non-blocking.
        ``grammar``: optional constrain.py FSM owned by this sequence; the
        engine consults it every tick (forced tokens / logit masks).
        ``deadline_s``: seconds from now on the engine clock; past it the
        tick reaps the sequence (finish_reason "expired")."""
        seq_id = next(self._seq_counter)
        prompt_ids, max_new = self._clamp_prompt(prompt_ids, max_new_tokens)
        self._register(seq_id, prompt_ids)
        self._enqueue(_Pending(seq_id, prompt_ids, max_new,
                               tuple(stop_strings), grammar,
                               priority=int(priority)))
        if deadline_s is not None:
            if self._deadlines is None:
                self._deadlines = {}
            self._deadlines[seq_id] = self._now() + float(deadline_s)
        return seq_id

    def _enqueue(self, req: _Pending, front: bool = False) -> None:
        """Stable priority insert: FIFO within a class, lower ints first;
        ``front`` (preemption requeue) goes ahead of its own class."""
        pri = req.priority
        for i, r in enumerate(self._pending):
            if (r.priority > pri) if not front else (r.priority >= pri):
                self._pending.insert(i, req)
                return
        self._pending.append(req)

    def _reap_deadlines(self) -> List[SequenceResult]:
        """Retire every sequence whose deadline has passed (top of tick)."""
        if not self._deadlines:
            return []
        now = self._now()
        expired = [sid for sid, dl in self._deadlines.items() if now >= dl]
        out: List[SequenceResult] = []
        for seq_id in expired:
            self._deadlines.pop(seq_id, None)
            if self._drop_pending(seq_id, out):
                self._count("engine.deadline_expirations")
                continue
            for slot, st in list(self._active.items()):
                if st.seq_id == seq_id:
                    out.append(self._retire(slot, "expired"))
                    self._count("engine.deadline_expirations")
                    break
        return out

    def _drop_pending(self, seq_id: int,
                      expired: Optional[List[SequenceResult]] = None) -> bool:
        """Remove a queued sequence; with ``expired`` given, append its
        terminal "expired" result (what it generated before preemption)."""
        for i, req in enumerate(self._pending):
            if req.seq_id == seq_id:
                del self._pending[i]
                gen = list(self._resumed.pop(seq_id, ()))
                prompt = self._prompts.pop(seq_id, req.prompt_ids)
                if expired is not None:
                    expired.append(SequenceResult(
                        seq_id=seq_id, token_ids=gen,
                        text=self._final_text(gen, "expired",
                                              req.stop_strings),
                        finish_reason="expired", prompt_tokens=len(prompt),
                        completion_tokens=len(gen)))
                return True
        return False

    def _register(self, seq_id: int, prompt_ids: List[int]) -> None:
        self._prompts[seq_id] = list(prompt_ids)

    def cancel_seq(self, seq_id: int) -> bool:
        """Abort a sequence now: a queued one leaves the queue, an active
        one retires its slot (and frees its pages).  Returns whether it
        was still live."""
        if self._drop_pending(seq_id):
            if self._deadlines:
                self._deadlines.pop(seq_id, None)
            return True
        for slot, st in list(self._active.items()):
            if st.seq_id == seq_id:
                self._retire(slot, "cancelled")
                return True
        return False

    # ------------------------------------------------ grammar application

    def _grammar_first_token(self, grammar, logits: torch.Tensor,
                             sampled: int, remaining: int) -> int:
        """Constrain the first post-prefill token: a forced token, or a
        masked resample off the prefill's [1, V] logits when the sampled
        one is not allowed."""
        c = grammar.constraint(remaining)
        if c.force is not None:
            return c.force
        if c.allow is not None and not bool(c.allow[sampled]):
            allow = torch.from_numpy(c.allow[None]).to(logits.device)
            masked = sample_tokens_masked(logits, self._gen, self.sampling,
                                          allow)
            return int(self._fetch(masked)[0][0])
        return sampled

    def _budget_remaining(self, st: _Active) -> int:
        """Tokens this sequence can still emit: min of its max_new budget
        and the cache room left (both can trigger "length")."""
        cache_room = (self.engine_cfg.max_seq_len
                      - (st.prompt_tokens + len(st.generated)) - 1)
        return min(st.max_new_tokens - len(st.generated), cache_room)

    def _tick_constraints(self, active_slots, n_slots: int, vocab: int):
        """Per-slot constraints of a stepwise tick: (forced {slot: token},
        allow [B, V] bool or None)."""
        forced = {}
        allow = None
        for slot in active_slots:
            st = self._active[slot]
            if st.grammar is None:
                continue
            c = st.grammar.constraint(self._budget_remaining(st))
            if c.force is not None:
                forced[slot] = c.force
            elif c.allow is not None:
                if allow is None:
                    allow = np.ones((n_slots, vocab), bool)
                allow[slot] = c.allow
        return forced, allow

    def _scan_dfa_setup(self):
        """Fused DFA tables and per-slot state/budget vectors for a
        constrained scan, or None when no grammar slot is active.

        Distinct compiled grammars fuse into one state space: each table's
        states shift by a fixed offset, the [S_i, V] tables stack along
        the state axis and each slot's state carries its table's offset.
        JAX pads the stack to a multiple of 1024 rows so that jit reuses
        its programs; eager torch compiles nothing, so the port does not.
        The device tensors are built once per combination of tables (an
        LRU of 4).  Returns ((allow, next, dist, close, complete) on the
        device, states [B] int32, remaining [B] int32), both on the
        host."""
        tabs, seen = [], set()
        for st in self._active.values():
            if st.grammar is not None:
                t = st.grammar.tables
                if id(t) not in seen:
                    seen.add(id(t))
                    tabs.append(t)
        if not tabs:
            return None
        tabs.sort(key=id)
        key = tuple(id(t) for t in tabs)
        cache = self._dfa_fused
        entry = cache.get(key)
        if entry is not None:
            cache[key] = cache.pop(key)       # LRU refresh
        else:
            offsets, off = {}, 0
            allow, nxt, dist, close, complete = [], [], [], [], []
            for t in tabs:
                offsets[id(t)] = off
                allow.append(t.allow)
                nxt.append(t.token_next.astype(np.int32) + np.int32(off))
                dist.append(t.dist)
                close.append(t.close_tok)
                complete.append(t.complete)
                off += t.n_states
            dev = tuple(torch.from_numpy(np.concatenate(a)).to(self.device)
                        for a in (allow, nxt, dist, close, complete))
            # the kept tabs tuple pins the id()s of the key
            entry = (dev, offsets, tabs[0].free_state, tuple(tabs))
            while len(cache) >= 4:
                cache.pop(next(iter(cache)))
            cache[key] = entry
        dev, offsets, free, _pin = entry
        b = self.engine_cfg.max_batch
        states = np.full((b,), free, np.int32)
        remaining = np.full((b,), np.int32(1 << 30), np.int32)
        for slot, st in self._active.items():
            if st.grammar is not None:
                states[slot] = (offsets[id(st.grammar.tables)]
                                + st.grammar.state)
                remaining[slot] = self._budget_remaining(st)
        return dev, states, remaining

    def _grammar_post_commit(self, slot: int, token: int) -> None:
        """Keep host grammar FSMs in lockstep with scan-emitted tokens."""
        st = self._active.get(slot)
        if st is not None and st.grammar is not None:
            st.grammar.advance(token)

    # -------------------------------------------------- tick + counters

    def _count(self, name: str, value: float = 1.0) -> None:
        """Increment a counter in METRICS and this engine's mirror."""
        METRICS.inc(name, value)
        c = self._counts
        if c is None:
            c = self._counts = {}
        c[name] = c.get(name, 0.0) + value

    def _fetch(self, *tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
        """One device->host sync point for the given tensors (counted as
        ``engine.d2h_syncs`` when any lives on the card)."""
        if any(t.device.type != "cpu" for t in tensors):
            self._count("engine.d2h_syncs")
        return tuple(t.cpu().numpy() for t in tensors)

    def step(self) -> List[SequenceResult]:
        """One engine tick, wrapped in an ``engine.tick`` span when a
        tracer is active."""
        tr = obs_trace._ACTIVE
        if tr is None:
            return self._tick()
        with tr.span("engine.tick", cat="engine"):
            return self._tick()

    def _tick(self) -> List[SequenceResult]:
        raise NotImplementedError

    def _retire(self, slot: int, reason: str) -> SequenceResult:
        raise NotImplementedError

    # ---------------------------------------- chunked scan tick (shared)

    def _chunk_bound(self, slot: int) -> int:
        """Subclass hook: extra per-slot cap on the scan chunk."""
        return self.engine_cfg.decode_chunk

    def _scan_chunk(self) -> int:
        """Device decode steps to run in ONE dispatch this tick: the
        largest power of two <= decode_chunk that fits every slot's cache
        headroom and subclass bound.  Token budgets do not bound it (a
        slot's tokens past its budget are never committed; DFA slots
        force-close in the scan); an interpreted (non-DFA) grammar forces
        stepwise ticks, and so do queued requests under
        ``prompt_admission``."""
        limit = self.engine_cfg.decode_chunk
        if limit <= 1:
            return 1
        if self.engine_cfg.prompt_admission and self._pending:
            return 1
        for slot, st in self._active.items():
            if (st.grammar is not None
                    and getattr(st.grammar, "tables", None) is None):
                return 1           # interpreted FSM: per-token host work
            headroom = self.engine_cfg.max_seq_len - (
                st.prompt_tokens + len(st.generated))
            limit = min(limit, max(1, headroom), self._chunk_bound(slot))
        chunk = 1
        while chunk * 2 <= limit:
            chunk *= 2
        return chunk

    def _commit_scanned(self, active_slots, toks_host, chunk: int,
                        post_commit=None) -> List[SequenceResult]:
        """Commit scanned tokens: append, per-token finish check at the
        stepwise-equivalent device length, mid-chunk retirement (tokens
        after EOS, a stop string or the budget are dropped)."""
        finished: List[SequenceResult] = []
        for slot in active_slots:
            st = self._active[slot]
            base_len = st.prompt_tokens + len(st.generated)
            committed = 0
            reason = None
            for j in range(chunk):
                token = int(toks_host[j, slot])
                st.generated.append(token)
                committed += 1
                if post_commit is not None:
                    post_commit(slot, token)
                reason = self._finish_reason(st, token, base_len + j)
                if reason is not None:
                    break
            self._count("engine.decode_tokens", committed)
            if reason is not None:
                finished.append(self._retire(slot, reason))
        return finished

    def run_to_completion(self) -> List[SequenceResult]:
        """Pump until queue and slots drain; returns all finished sequences."""
        out: List[SequenceResult] = []
        while self.has_work:
            out.extend(self.step())
        return out

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None,
                 stop_strings: Sequence[str] = ()) -> List[SequenceResult]:
        """Batch convenience: submit all, pump, return in submit order."""
        ids = [self.submit(p, max_new_tokens, stop_strings) for p in prompts]
        results = {r.seq_id: r for r in self.run_to_completion()}
        return [results[i] for i in ids]

    # ------------------------------------------------- shared termination

    def _finish_reason(self, st: _Active, token: int,
                       length: int) -> Optional[str]:
        if token == self.tokenizer.eos_id:
            return "eos"
        if len(st.generated) >= st.max_new_tokens:
            return "length"
        if length + 1 >= self.engine_cfg.max_seq_len:
            return "length"
        if st.stop_strings:
            # a bounded tail window always holds a just-completed stop
            # string (a token covers >= 1 char)
            window = max(len(s) for s in st.stop_strings) + 8
            text = self.tokenizer.decode(self._stop_context(st)[-window:])
            for s in st.stop_strings:
                if s in text:
                    return "stop"
        return None

    def _stop_context(self, st: _Active) -> List[int]:
        """Tokens for stop-string matching, with any pre-preemption
        generation prepended so a match can span the resume boundary."""
        prefix = self._resumed.get(st.seq_id)
        return prefix + st.generated if prefix else st.generated

    def _final_text(self, generated: List[int], reason: str,
                    stop_strings: Tuple[str, ...]) -> str:
        text = self.tokenizer.decode(generated)
        if reason == "eos":
            text = self.tokenizer.decode(generated[:-1])
        elif reason == "stop":
            for s in stop_strings:
                idx = text.find(s)
                if idx >= 0:
                    text = text[:idx]
                    break
        return text


def dfa_scan_step(logits: torch.Tensor, cur: torch.Tensor,
                  lens: torch.Tensor, done: torch.Tensor,
                  states: torch.Tensor, remaining: torch.Tensor,
                  generator: Optional[torch.Generator],
                  sampling: SamplingParams, eos_id: int,
                  allow_t: torch.Tensor, next_t: torch.Tensor,
                  dist_t: torch.Tensor, close_t: torch.Tensor,
                  complete_t: torch.Tensor):
    """One DFA-constrained sampling step on the logits' device (the port of
    ``k8s_llm_rca_tpu/engine/engine.py::dfa_scan_step``): budget-fits mask,
    masked sample, force-close of an empty row, EOS from a complete state,
    state transition.  ``states``/``remaining`` [B] int32 index the fused
    tables.  Returns (cur', lens', done', states', remaining')."""
    idx = states.long()
    nxt_states = next_t[idx]                                   # [B, V]
    fits = dist_t[nxt_states.long()] <= (remaining - 2)[:, None]
    rows = allow_t[idx] & fits
    sampled = sample_tokens_masked(logits, generator, sampling, rows)
    # an empty row (sub-minimal budget, refused at submit): force close
    nxt = torch.where(rows.any(dim=-1), sampled, close_t[idx])
    nxt = torch.where(complete_t[idx], torch.full_like(nxt, eos_id), nxt)
    newly_done = done | (nxt == eos_id)
    advance = ~done
    cur = torch.where(advance, nxt, cur)
    lens = lens + advance.to(lens.dtype)
    step_dfa = advance & (nxt != eos_id)
    states = torch.where(step_dfa, next_t[idx, nxt.long()], states)
    remaining = remaining - advance.to(remaining.dtype)
    return cur, lens, newly_done, states, remaining
