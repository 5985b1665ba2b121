"""Continuous-batching engines: the port of ``EngineBase`` and the
contiguous-slot ``InferenceEngine`` from ``k8s_llm_rca_tpu/engine/engine.py``.

Submission and prompt clamping, the priority queue, deadlines, cancel,
finish reasons and stop-string trimming, the chunk choice of the scanned
decode tick, the commit loop that trims after EOS and the grammar paths
(per-slot constraints of a stepwise tick, the constrained first token, the
fused DFA tables of a constrained scan and its device step
``dfa_scan_step``), n-gram speculative decoding (drafts, the greedy-exact
verify-and-commit loop, its grammar paths and the device step
``dfa_greedy_multi``) and the overlapped host loop (the one-tick-lagged
commit of ``host_overlap``) all follow the JAX engine line for line, so
the two packages emit equal greedy token streams.  So do snapshot/restore
(``snapshot_sequences`` exports every live sequence's token record,
``restore_sequences`` re-admits it through a normal prefill) and the
engine tick's fault site (``faults/inject.py``: ``step`` polls an armed
plan before the tick).  Drafts come from n-gram lookup or a draft model
(``engine/speculative.py::ModelDraft``).

``InferenceEngine`` is the contiguous-slot engine (the JAX package's
default, ``EngineConfig.paged=False``): one [max_seq_len] KV row per slot
(``models.llama.KVCache``), no page pool, no preemption.  Prefill attends
through ``ops.flash_attention`` (the CUDA kernel on the card) and decode
through the plain ``ops.attention.decode_attention(_multi)`` over the
whole row, as JAX computes it outside any kernel; the projections and the
lm head take the int8/int4 kernels under ``ModelConfig.fused_quant_matmul``.
Its steps run eagerly on the card (no CUDA graphs yet).  A tick follows
JAX's: admission (one prefill, or one batched prefill of a same-bucket
run), then speculation, a chunked scan (``decode_scan``, with the grammar
DFA inside it under ``decode_scan_dfa``), the overlapped step
(``overlap_step``) or one stepwise decode.  The host keeps the tokens and
lengths (numpy mirrors, uploaded into static device operands per
dispatch); ``host_overlap`` keeps them resident instead and commits one
tick late.

Under a device mesh (``tp_mesh``, ``ep_mesh``, ``fsdp_mesh``, ``sp`` with TP,
``cp_mesh`` ring or Ulysses, ``pp_mesh``, and the compositions the paged
engine serves) every rank runs its own ``InferenceEngine`` on its shard of
the weights with its rank's config (``runtime.sharding.rank_config``): the
cache holds the rank's lanes under TP, its stage's layers under PP and its
block of the sequence under CP (``models.llama.prefill_cp`` and the CP
decode); PP admits every group through ``parallel.pipeline.
llama_pp_prefill`` and decodes through ``llama_pp_decode_step``.  The
refusals are the paged engine's (``refuse_mesh_compositions``: CP x EP
and TP x EP, item 10.9).  ``host_overlap`` runs under every mesh but CP
(JAX's ValueError), and ``snapshot_sequences``/``restore_sequences``
under every mesh: a snapshot is host state, equal on every rank, and
restores into an engine of any sharding.  Speculation runs under every
mesh: the verify step is ``llama.decode_multi`` (under CP its lse-merged
attention over the rank's block of every row) or, under PP,
``parallel.pipeline.llama_pp_decode_multi``; n-gram drafts are host
state, equal on every rank, and a draft model runs whole on every rank,
its drafts broadcast from the mesh's lowest rank
(``speculative.DraftAgreement``).
"""

from __future__ import annotations

import functools
import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from k8s_llm_rca_tpu_torch.config import EngineConfig, ModelConfig
from k8s_llm_rca_tpu_torch.engine.sampling import (
    SamplingParams, sample_tokens, sample_tokens_masked,
)
from k8s_llm_rca_tpu_torch.engine.speculative import (
    DraftAgreement, ngram_draft, setup_draft,
)
from k8s_llm_rca_tpu_torch.faults import inject
from k8s_llm_rca_tpu_torch.models import llama
from k8s_llm_rca_tpu_torch.obs import trace as obs_trace
from k8s_llm_rca_tpu_torch.runtime.profiling import annotate
from k8s_llm_rca_tpu_torch.runtime.sharding import rank_config
from k8s_llm_rca_tpu_torch.utils.device import resolve_device
from k8s_llm_rca_tpu_torch.utils.pages import to_host
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
    n_shared: int = 0           # leading block-table pages held from the
                                # prefix cache (refcounted, not owned)
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
    # injectable time() source for deadlines; None = the armed fault
    # plan's VirtualClock when there is one, else wall time
    clock = None
    _deadlines: Optional[Dict[int, float]] = None
    # per-engine mirror of the engine.* METRICS counters
    _counts: Optional[Dict[str, float]] = None
    # the overlapped hot loop (``host_overlap``).  _inflight: dispatched
    # but uncommitted fast-path ticks, oldest first, each {"slots":
    # [(slot, seq_id)...], "toks": device [B], "admits": deferred first
    # tokens}; _admit_pending: admissions whose sampled first token has
    # not crossed to the host yet; _flushed_out: results of a flush made
    # outside a tick (cancel, deadlines), surfaced by the next tick.
    # the device mesh the engine's rank runs on (None: unsharded)
    mesh = None
    _overlap: bool = False
    _overlap_lag: int = 2
    _inflight: Optional[List[dict]] = None
    _admit_pending: Optional[list] = None
    _flushed_out: Optional[list] = None
    # a draft model's speculation state (speculative.ModelDraft), or None
    # for n-gram drafts
    _draft = None
    # under a mesh, the broadcast of a draft model's drafts
    # (speculative.DraftAgreement), or None
    _draft_agree = None

    def _now(self) -> float:
        if self.clock is not None:
            return self.clock.time()
        if inject._ARMED is not None:
            return inject._ARMED.clock.time()
        return time.time()

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
            self._deadline_set(seq_id, self._now() + float(deadline_s))
        return seq_id

    def _deadline_set(self, seq_id: int, deadline: float) -> None:
        if self._deadlines is None:
            self._deadlines = {}
        self._deadlines[seq_id] = float(deadline)

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
        if not expired:
            return []
        self._overlap_barrier()   # commit in-flight tokens before retiring
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
            else:
                res = self._expire_extra(seq_id)
                if res is not None:
                    out.append(res)
                    self._count("engine.deadline_expirations")
        return out

    def _expire_extra(self, seq_id: int) -> Optional[SequenceResult]:
        """Subclass hook: reap a deadline-expired sequence held outside the
        pending and active books (the paged engine's chunked prefills)."""
        return None

    def _drop_pending(self, seq_id: int,
                      expired: Optional[List[SequenceResult]] = None) -> bool:
        """Remove a queued sequence; with ``expired`` given, append its
        terminal "expired" result (what it generated before preemption)."""
        for i, req in enumerate(self._pending):
            if req.seq_id == seq_id:
                del self._pending[i]
                if expired is not None:
                    expired.append(self._expired_result(seq_id, req))
                self._drop_spill(seq_id)
                self._resumed.pop(seq_id, None)
                self._prompts.pop(seq_id, None)
                return True
        return False

    def _expired_result(self, seq_id: int, req: _Pending) -> SequenceResult:
        """Terminal result of a sequence that expired before it decoded in
        a slot: what it generated before a preemption, if anything."""
        gen = list(self._resumed.get(seq_id, ()))
        prompt = self._prompts.get(seq_id, req.prompt_ids)
        return SequenceResult(
            seq_id=seq_id, token_ids=gen,
            text=self._final_text(gen, "expired", req.stop_strings),
            finish_reason="expired", prompt_tokens=len(prompt),
            completion_tokens=len(gen))

    def _drop_spill(self, seq_id: int) -> None:
        """Subclass hook: discard a queued sequence's host-spilled KV
        record (cancel, deadline expiry)."""

    def _register(self, seq_id: int, prompt_ids: List[int]) -> None:
        self._prompts[seq_id] = list(prompt_ids)

    def cancel_seq(self, seq_id: int) -> bool:
        """Abort a sequence now: a queued one leaves the queue, an active
        one retires its slot (and frees its pages).  Returns whether it
        was still live."""
        self._overlap_barrier()   # commit in-flight tokens before retiring
        if self._drop_pending(seq_id):
            if self._deadlines:
                self._deadlines.pop(seq_id, None)
            return True
        for slot, st in list(self._active.items()):
            if st.seq_id == seq_id:
                self._retire(slot, "cancelled")
                return True
        return False

    # ------------------------------------------------- snapshot / restore

    def _snapshot_entry(self, seq_id: int, prompt: List[int],
                        generated: List[int], remaining: int,
                        stop_strings, grammar, priority: int
                        ) -> Dict[str, object]:
        return {
            "seq_id": seq_id,
            "prompt_ids": prompt,
            "generated": generated,
            "remaining_new_tokens": remaining,
            "stop_strings": list(stop_strings),
            "grammar": grammar is not None,
            "priority": priority,
            "deadline": (self._deadlines or {}).get(seq_id),
        }

    def snapshot_sequences(self) -> Dict[str, object]:
        """Export every live sequence's durable state: original prompt,
        every generated token (those before a preemption too), remaining
        budget, stop strings, a grammar marker, priority and deadline, plus
        the sampling generator's state.  KV is not exported (device memory
        laid out per engine); ``restore_sequences`` re-admits each sequence
        through a normal prefill, a prefix-cache hit where pages survive.
        Order: active sequences by seq_id, then the pending queue front to
        back, as in the JAX engine (whose ``sequences`` list this equals on
        the same run).  ``rng_key`` is the port generator's state as a list
        of ints: the port's random bits never matched JAX's.  Under a
        device mesh every rank returns the same snapshot: the host loop
        runs alike on every rank and each rank's generator is seeded
        with ``EngineConfig.seed`` and draws from the same (all-reduced
        or broadcast) logits."""
        self._overlap_barrier()
        resumed = self._resumed
        seqs = []
        for st in sorted(self._active.values(), key=lambda s: s.seq_id):
            gen = list(resumed.get(st.seq_id, [])) + list(st.generated)
            # a sequence at its budget retires within its tick, so between
            # ticks remaining >= 1; max() mirrors _preempt_slot's clamp
            seqs.append(self._snapshot_entry(
                st.seq_id, list(self._prompts.get(st.seq_id, [])), gen,
                max(1, st.max_new_tokens - len(st.generated)),
                st.stop_strings, st.grammar, st.priority))
        for req in self._pending:
            # a preempted (or KV-spilled) request's prompt_ids carry its
            # generated prefix: the ORIGINAL prompt is in _prompts
            seqs.append(self._snapshot_entry(
                req.seq_id,
                list(self._prompts.get(req.seq_id, req.prompt_ids)),
                list(resumed.get(req.seq_id, ())), req.max_new_tokens,
                req.stop_strings, req.grammar, req.priority))
        return {"rng_key": [int(x) for x in self._gen.get_state()],
                "sequences": seqs}

    def restore_sequences(self, snap: Dict[str, object],
                          grammars: Optional[Dict[int, object]] = None
                          ) -> List[int]:
        """Re-admit sequences exported by ``snapshot_sequences``, into this
        engine or a fresh one of the same model: each queues for a prefill
        of prompt + generated-so-far (the preemption resume path), so it
        finishes with the tokens an uninterrupted greedy run produces.
        ``grammars``: freshly compiled FSMs by seq_id for sequences
        snapshotted with ``grammar: true``, advanced here over the
        generated tokens; a missing one raises.  Returns the seq_ids.
        Under a device mesh every rank restores the same snapshot and
        queues the same prefills; a snapshot of any sharding (or none)
        restores into any other."""
        self._overlap_barrier()
        cap = self.engine_cfg.max_seq_len
        restored: List[int] = []
        max_seen = -1
        for s in snap["sequences"]:
            seq_id = int(s["seq_id"])
            if (seq_id in self._prompts
                    or any(r.seq_id == seq_id for r in self._pending)):
                raise ValueError(
                    f"restore collision: seq {seq_id} is already live in "
                    f"this engine")
            prompt = [int(t) for t in s["prompt_ids"]]
            gen = [int(t) for t in s["generated"]]
            remaining = int(s["remaining_new_tokens"])
            room = cap - len(prompt) - len(gen) - 1
            if room < 1:
                raise ValueError(
                    f"seq {seq_id} needs {len(prompt) + len(gen) + 2} "
                    f"cache positions but this engine caps at {cap}; "
                    f"restore into an engine with max_seq_len >= the "
                    f"snapshotting engine's")
            remaining = min(remaining, room)
            g = (grammars or {}).get(seq_id)
            if s.get("grammar") and g is None:
                raise ValueError(
                    f"seq {seq_id} was grammar-constrained; pass a "
                    f"freshly compiled FSM via grammars={{{seq_id}: fsm}} "
                    f"(FSM state is rebuilt by advancing over the "
                    f"generated tokens, never serialized)")
            if g is not None:
                for t in gen:
                    g.advance(t)
            self._register(seq_id, prompt)
            if gen:
                self._resumed[seq_id] = list(gen)
            self._enqueue(_Pending(
                seq_id, prompt + gen, remaining,
                tuple(s["stop_strings"]), g,
                priority=int(s.get("priority", 1))))
            if s.get("deadline") is not None:
                self._deadline_set(seq_id, float(s["deadline"]))
            restored.append(seq_id)
            max_seen = max(max_seen, seq_id)
        # later submits must not reuse a restored id
        nxt = next(self._seq_counter)
        self._seq_counter = itertools.count(max(nxt, max_seen + 1))
        key = snap.get("rng_key")
        if key is not None:
            state = torch.tensor(key, dtype=torch.uint8)
            n_state = self._gen.get_state().numel()
            if state.numel() != n_state:
                raise ValueError(
                    f"rng_key holds {state.numel()} values, not this "
                    f"engine's generator state ({n_state} bytes): restore "
                    f"a snapshot of a port engine on the same device type, "
                    f"or pass rng_key None")
            self._gen.set_state(state)
        return restored

    # ------------------------------------------------------ fault injection

    FAULT_SITE = inject.SITE_ENGINE_TICK

    def _tick_fault(self) -> None:
        """Apply this tick's scheduled fault (``faults/plan.py``), between
        ticks on the host; called only behind ``inject._ARMED is not None``
        at the top of ``step``."""
        plan = inject._ARMED
        if plan is None:
            return
        fault = plan.poll(self.FAULT_SITE)
        if fault is not None:
            # kinds that preempt or crash slots must see committed state
            self._overlap_barrier()
            self._apply_tick_fault(fault, plan)

    def _apply_tick_fault(self, fault, plan) -> None:
        """Base tick faults: a host stall (virtual-clock delay).  The paged
        engine adds allocator exhaustion, preemption waves and crashes."""
        if fault.kind in ("stall", "slow"):
            plan.clock.sleep(fault.delay_s or 0.05)
        else:
            log.warning("tick fault %r not applicable to engine ticks",
                        fault.kind)

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

    _DFA_FUSE_BUCKET = 1024   # fused state-count rounding

    def _scan_dfa_setup(self):
        """Fused DFA tables and per-slot state/budget vectors for a
        constrained scan, or None when no grammar slot is active.

        Distinct compiled grammars fuse into one state space: each table's
        states shift by a fixed offset, the [S_i, V] tables stack along
        the state axis and each slot's state carries its table's offset.
        The stack pads with dead rows (zero, never indexed) to a multiple
        of ``_DFA_FUSE_BUCKET`` states, as in JAX: distinct combinations
        then share one table shape.  The tables live once on the device,
        in one set of buffers per padded size (``_dfa_static``), which
        the paged engine's captured DFA scans read in place; a buffer is
        rewritten when another combination of its size comes.  Returns
        ((allow, next, dist, close, complete) on the device, states [B]
        int32, remaining [B] int32), both on the host."""
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
        n = sum(t.n_states for t in tabs)
        size = -(-n // self._DFA_FUSE_BUCKET) * self._DFA_FUSE_BUCKET
        key = tuple(id(t) for t in tabs)
        entry = self._dfa_static.get(size)
        if entry is None or entry[1] != key:
            offsets, off, bufs = {}, 0, None if entry is None else entry[0]
            for t in tabs:
                offsets[id(t)] = off
                rows = [torch.from_numpy(a) for a in (
                    t.allow, t.token_next.astype(np.int32) + np.int32(off),
                    t.dist, t.close_tok, t.complete)]
                if bufs is None:
                    bufs = tuple(torch.zeros((size,) + r.shape[1:],
                                             dtype=r.dtype, device=self.device)
                                 for r in rows)
                for dst, src in zip(bufs, rows):
                    dst[off:off + t.n_states].copy_(src)
                off += t.n_states
            for dst in bufs:
                dst[off:].zero_()
            # the kept tabs tuple pins the id()s of the key
            entry = self._dfa_static[size] = (bufs, key, offsets, tuple(tabs))
        bufs, _, offsets, _ = entry
        b = self.engine_cfg.max_batch
        states = np.full((b,), tabs[0].free_state, np.int32)
        remaining = np.full((b,), np.int32(1 << 30), np.int32)
        for slot, st in self._active.items():
            if st.grammar is not None:
                states[slot] = (offsets[id(st.grammar.tables)]
                                + st.grammar.state)
                remaining[slot] = self._budget_remaining(st)
        return bufs, states, remaining

    def _grammar_post_commit(self, slot: int, token: int) -> None:
        """Keep host grammar FSMs in lockstep with scan-emitted tokens."""
        st = self._active.get(slot)
        if st is not None and st.grammar is not None:
            st.grammar.advance(token)

    # --------------------------------------------- speculative decoding

    def _speculation_applies(self) -> bool:
        """Speculate only where the result is exactly greedy decoding's
        and every slot has room for the T = k + 1 token write (the
        subclass's ``_spec_room_ok``)."""
        k = self.engine_cfg.speculative_k
        if k <= 0 or self.engine_cfg.temperature != 0.0:
            return False
        return all(self._spec_room_ok(s, k + 1) for s in self._active)

    def _greedy_with_grammar(self, st: _Active, greedy_token: int,
                             logits_row) -> int:
        """The token a plain greedy tick would commit: the grammar's forced
        token, or its allow mask applied to the argmax."""
        if st.grammar is None:
            return greedy_token
        c = st.grammar.constraint(self._budget_remaining(st))
        if c.force is not None:
            return c.force
        if c.allow is not None:
            masked = np.where(np.asarray(c.allow), logits_row, -np.inf)
            return int(np.argmax(masked))
        return greedy_token

    def _build_drafts(self, active_slots, cur_host
                      ) -> Tuple[np.ndarray, Dict[int, List[int]]]:
        """Per-slot drafts, from the draft model when one is attached, else
        n-gram lookup: (tokens_in [B, k + 1] int32, {slot: draft}); row
        ``slot`` is the current token, then its draft."""
        k_spec = self.engine_cfg.speculative_k
        tokens_in = np.zeros((self.engine_cfg.max_batch, k_spec + 1),
                             np.int32)
        drafts: Dict[int, List[int]] = {}
        if self._draft is not None:
            for slot in active_slots:
                st = self._active[slot]
                ctx = (self._prompts.get(st.seq_id, [])
                       + self._stop_context(st))
                self._draft.sync(slot, st.seq_id, ctx)
            drafts = self._draft.draft(active_slots, k_spec,
                                       self.tokenizer.eos_id)
            for slot in active_slots:
                tokens_in[slot, 0] = cur_host[slot]
                tokens_in[slot, 1:1 + len(drafts[slot])] = drafts[slot]
            if self._draft_agree is not None:
                # every rank verifies the lowest rank's drafts, so no rank
                # can part from the others in the verify step's collectives
                tokens_in = self._draft_agree(tokens_in)
                drafts = {s: [int(x) for x in tokens_in[s, 1:1 + len(d)]]
                          for s, d in drafts.items()}
            return tokens_in, drafts
        for slot in active_slots:
            st = self._active[slot]
            # _stop_context: a resumed sequence's tokens from before its
            # preemption keep the lookup context contiguous
            ctx = self._prompts.get(st.seq_id, []) + self._stop_context(st)
            d = ngram_draft(ctx, self.engine_cfg.speculative_ngram, k_spec)
            drafts[slot] = d
            tokens_in[slot, 0] = cur_host[slot]
            tokens_in[slot, 1:1 + len(d)] = d
        return tokens_in, drafts

    def _uniform_dfa_tables(self):
        """The one compiled DFA table set every grammar slot shares, or
        None (no grammar slot, an interpreted grammar, or mixed tables)."""
        tables = None
        for st in self._active.values():
            if st.grammar is None:
                continue
            t = getattr(st.grammar, "tables", None)
            if t is None or (tables is not None and t is not tables):
                return None
            tables = t
        return tables

    def _verify_and_commit(self, active_slots, drafts, greedy_host,
                           logits_host, post_commit=None,
                           constrained: bool = False
                           ) -> List[SequenceResult]:
        """Commit the longest prefix of each slot's draft that agrees with
        the model's own greedy (grammar-constrained) choice, plus one
        bonus token from the first disagreeing position: greedy-exact by
        construction.  ``constrained``: the device already applied the
        grammar (``dfa_greedy_multi``); the FSM still advances per
        commit."""
        finished: List[SequenceResult] = []
        for slot in active_slots:
            st = self._active[slot]
            draft = drafts[slot]
            base_len = st.prompt_tokens + len(st.generated)
            committed: List[int] = []
            reason = None
            for j in range(len(draft) + 1):
                if constrained:
                    token = int(greedy_host[slot, j])
                else:
                    token = self._greedy_with_grammar(
                        st, int(greedy_host[slot, j]),
                        logits_host[slot, j]
                        if logits_host is not None else None)
                st.generated.append(token)
                if st.grammar is not None:
                    st.grammar.advance(token)
                committed.append(token)
                if post_commit is not None:
                    post_commit(slot, token)
                reason = self._finish_reason(st, token, base_len + j)
                if not (reason is None and j < len(draft)
                        and token == draft[j]):
                    break
            self._count("engine.decode_tokens", len(committed))
            self._count("engine.spec_drafted", len(draft))
            self._count("engine.spec_accepted", max(0, len(committed) - 1))
            if reason is not None:
                finished.append(self._retire(slot, reason))
            elif self._draft is not None:
                self._draft.advance(slot, st.seq_id, committed)
        return finished

    def _need_spec_logits(self, active_slots) -> bool:
        """[B, T, V] logits matter only when a grammar slot is active."""
        return any(self._active[s].grammar is not None
                   for s in active_slots)

    # -------------------------------------------------- tick + counters

    def _count(self, name: str, value: float = 1.0) -> None:
        """Increment a counter in METRICS and this engine's mirror."""
        METRICS.inc(name, value)
        c = self._counts
        if c is None:
            c = self._counts = {}
        c[name] = c.get(name, 0.0) + value

    def _fetch_host(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``_fetch`` for page records: one sync, counted as
        ``engine.d2h_syncs``, the results kept as CPU tensors in their own
        dtype (bf16 has no numpy dtype); on the card one pinned buffer
        (``utils/pages.py::to_host``)."""
        self._count("engine.d2h_syncs")
        return to_host(*tensors)

    def _fetch(self, *tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
        """One device->host sync point for the given tensors, counted as
        ``engine.d2h_syncs`` when any is a tensor (as the JAX engine counts
        any device array, also on its CPU backend); host arrays pass
        through uncounted."""
        if any(isinstance(t, torch.Tensor) for t in tensors):
            self._count("engine.d2h_syncs")
        return tuple(t.cpu().numpy() if isinstance(t, torch.Tensor) else t
                     for t in tensors)

    # ------------------------------------------ overlapped hot loop
    #
    # Invariants, as in the JAX engine:
    #  - host commit order per sequence is the plain engine's (admission
    #    first token, then decode tokens in dispatch order);
    #  - _inflight entries exist only across fast-path ticks; every other
    #    path (grammar, speculation, the scan, cancel, deadlines) flushes
    #    first and so sees committed state;
    #  - a slot retired or preempted while its tokens were in flight drops
    #    them at the flush (the seq_id guard): greedy re-prefill
    #    regenerates the same tokens.

    def _overlap_fast(self) -> bool:
        """Whether this tick may dispatch without waiting to commit (the
        one-tick-lagged fast path): only at ``decode_chunk`` 1, without
        speculation and with no grammar live or queued."""
        if not self._overlap:
            return False
        cfg = self.engine_cfg
        if cfg.decode_chunk > 1 or cfg.speculative_k > 0:
            return False
        if any(st.grammar is not None for st in self._active.values()):
            return False
        return not any(r.grammar is not None for r in self._pending)

    def _take_admit_pending(self) -> list:
        pend, self._admit_pending = self._admit_pending, []
        return pend

    # Both engines keep host mirrors of the tokens and lengths
    # (``cur_tokens``, ``lengths``) and static int32 device operands
    # (``_operands``, filled from ``_staging``: 0 tokens, 1 lengths); with
    # ``host_overlap`` the operands stay resident between ticks and are
    # edited slot by slot until ``_dev_dirty`` asks for a full upload.

    def _upload(self, i: int, array: np.ndarray) -> torch.Tensor:
        """Copy a host array into static operand ``i``.  The copy is
        asynchronous on the card: the staging buffer is rewritten only
        after the tick's fetch, which waits for it."""
        self._staging[i].numpy()[...] = array
        return self._operands[i].copy_(self._staging[i], non_blocking=True)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _dev_edit_token(self, slot: int, token) -> None:
        """Mirror one ``cur_tokens`` write (a host int or a device scalar)
        into the resident operand."""
        if self._overlap and not self._dev_dirty:
            self._operands[0][slot] = token

    def _dev_edit_len(self, slot: int, n: int) -> None:
        if self._overlap and not self._dev_dirty:
            self._operands[1][slot] = n

    def _note_first_token(self, slot: int, token: int,
                          update_dev: bool) -> None:
        """Reflect an admission's committed first token in the token
        mirror (and the resident operand, unless ``update_dev`` is False
        at a lagged flush: the device tokens already moved past it)."""
        self.cur_tokens[slot] = token
        if update_dev:
            self._dev_edit_token(slot, token)

    def _commit_first(self, st: _Active, token: int,
                      update_dev: bool = True) -> Optional[SequenceResult]:
        """Commit an admission's first token; it may already finish the
        sequence.  A slot preempted before the token reached the host
        drops it: the requeued prompt re-prefills and greedily samples
        the same token again."""
        if self._active.get(st.slot) is not st:
            return None
        st.generated.append(token)
        self._note_first_token(st.slot, token, update_dev)
        reason = self._finish_reason(st, token, st.prompt_tokens)
        if reason is not None:
            return self._retire(st.slot, reason)
        return None

    def _drain_admission_commits(self) -> List[SequenceResult]:
        """Fetch every deferred admission first token in ONE sync and
        commit them in admission order."""
        pend = self._take_admit_pending()
        if not pend:
            return []
        uniq: Dict[int, int] = {}
        order: List[torch.Tensor] = []
        for _, t, _ in pend:
            if id(t) not in uniq:
                uniq[id(t)] = len(order)
                order.append(t)
        hosts = self._fetch(*order)
        out: List[SequenceResult] = []
        for st, t, i in pend:
            done = self._commit_first(st, int(hosts[uniq[id(t)]][i]))
            if done is not None:
                out.append(done)
        return out

    def _note_flush_entry(self, entry: dict) -> None:
        """Subclass hook, called once per flushed entry before its commits
        (the paged engine counts down its per-slot in-flight steps)."""

    def _overlap_post_commit(self, slot: int, token: int) -> None:
        """A token committed at a lagged flush: the host mirrors catch up
        with the device, so the resident state stays clean."""
        self.lengths[slot] += 1
        self.cur_tokens[slot] = token

    def _overlap_flush(self) -> List[SequenceResult]:
        """Commit every in-flight fast-path tick: one fetch for all the
        entries' tokens and deferred first tokens, then the plain commit
        loop per entry in dispatch order.  A no-op with nothing in
        flight."""
        entries, self._inflight = self._inflight, []
        finished: List[SequenceResult] = []
        if entries:
            uniq: Dict[int, int] = {}
            order: List[torch.Tensor] = []
            for e in entries:
                for t in [e["toks"]] + [rec[1] for rec in e["admits"]]:
                    if id(t) not in uniq:
                        uniq[id(t)] = len(order)
                        order.append(t)
            hosts = self._fetch(*order)
            for e in entries:
                self._note_flush_entry(e)
                for st, t, i in e["admits"]:
                    done = self._commit_first(
                        st, int(hosts[uniq[id(t)]][i]), update_dev=False)
                    if done is not None:
                        finished.append(done)
                toks_host = hosts[uniq[id(e["toks"])]]
                # only slots still held by the sequence dispatched commit
                slots = [s for s, sid in e["slots"]
                         if s in self._active
                         and self._active[s].seq_id == sid]
                finished.extend(self._commit_scanned(
                    slots, toks_host[None, :], 1,
                    self._overlap_post_commit))
        finished.extend(self._drain_admission_commits())
        return finished

    def _overlap_barrier(self) -> None:
        """Flush outside a tick (cancel, deadlines); the results surface at
        the next tick."""
        if self._inflight or self._admit_pending:
            out = self._overlap_flush()
            if out:
                self._flushed_out.extend(out)
            self._invalidate_device_state()

    def _invalidate_device_state(self) -> None:
        """The host mirrors changed behind the resident device operands;
        upload them before the next dispatch."""
        self._dev_dirty = True

    def step(self) -> List[SequenceResult]:
        """One engine tick: apply an armed plan's tick fault first, then
        the tick, wrapped in an ``engine.tick`` span when a tracer is
        active."""
        if inject._ARMED is not None:          # disarmed cost: this check
            self._tick_fault()
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


def dfa_greedy_multi(logits: torch.Tensor, states: torch.Tensor,
                     remaining: torch.Tensor, eos_id: int,
                     allow_t: torch.Tensor, next_t: torch.Tensor,
                     dist_t: torch.Tensor, close_t: torch.Tensor,
                     complete_t: torch.Tensor) -> torch.Tensor:
    """Grammar-constrained greedy over a verification step's T positions,
    on the logits' device (the port of ``k8s_llm_rca_tpu/engine/engine.py::
    dfa_greedy_multi``): logits [B, T, V], states/remaining [B] int32
    (the FREE row for slots without a grammar, whose result is the plain
    argmax).  The DFA advances along the constrained choices: on the
    accepted draft prefix they are the draft, and the host never commits
    a position after the first disagreement.  Returns tokens [B, T]."""
    st = states.long()
    rem = remaining
    toks = []
    for j in range(logits.shape[1]):
        nxt_states = next_t[st]                                    # [B, V]
        fits = dist_t[nxt_states.long()] <= (rem - 2)[:, None]
        rows = allow_t[st] & fits
        tok = logits[:, j].masked_fill(~rows, float("-inf")).argmax(dim=-1)
        tok = torch.where(rows.any(dim=-1), tok, close_t[st].long())
        tok = torch.where(complete_t[st], torch.full_like(tok, eos_id), tok)
        st = torch.where(tok != eos_id, next_t[st, tok].long(), st)
        rem = rem - 1
        toks.append(tok)
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# the contiguous-slot engine and its device loops
# ---------------------------------------------------------------------------

def mesh_item(sub: int) -> str:
    """A step of ROADMAP Queue 1 item 10, multi-GPU (10.9: the
    compositions TP x EP and CP x EP)."""
    return f"ROADMAP Queue 1 item 10.{sub}, multi-GPU"


def _mesh_axis(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh needs a '{axis}' axis, has {names}")
    return int(mesh.mesh.shape[names.index(axis)])


def validate_cp_divisibility(cp_seq_axis: str, n_cp: int, sizes) -> None:
    """CP prefill shards the padded sequence over the mesh axis: every
    prefill bucket (and max_seq_len; paged callers pass page-rounded sizes)
    must split evenly across it."""
    bad = [s for s in sizes if s % n_cp]
    if bad:
        raise ValueError(
            f"cp mesh axis '{cp_seq_axis}' size {n_cp} must divide "
            f"every prefill bucket and max_seq_len; offending sizes: {bad}")


def validate_tp_mesh(tp_mesh, model_cfg: ModelConfig, cp_mesh=None,
                     cp_seq_axis: str = "seq") -> None:
    """TP serving preconditions: whole GQA groups per shard (both head
    counts divide the "model" axis) and a merged kv axis that splits into
    whole heads, packed int4 pairs included.

    CP composes with TP only on ONE mesh carrying both axes (the pool is
    sharded on pages over the seq axis and on lanes over "model", and the
    ring or all-to-all runs per head shard); two different mesh objects
    cannot both lay out the pool."""
    if tp_mesh is None:
        return
    _mesh_axis(tp_mesh, "data")
    n_tp = _mesh_axis(tp_mesh, "model")
    if cp_mesh is not None:
        if cp_mesh is not tp_mesh:
            raise ValueError(
                "cp_mesh and tp_mesh must be the SAME composed mesh "
                "(one Mesh carrying 'data', 'model' and the seq axis); "
                "two distinct meshes cannot both lay out the cache")
        if cp_seq_axis not in tuple(tp_mesh.mesh_dim_names or ()):
            raise ValueError(f"composed mesh lacks the '{cp_seq_axis}' axis")
        if model_cfg.n_heads % n_tp or model_cfg.n_kv_heads % n_tp:
            raise ValueError(
                f"n_heads={model_cfg.n_heads}/n_kv_heads="
                f"{model_cfg.n_kv_heads} not divisible by model axis "
                f"{n_tp} (required for CP×TP prefill)")
    if model_cfg.n_heads % n_tp or model_cfg.n_kv_heads % n_tp:
        raise ValueError(
            f"paged attention under TP needs n_heads={model_cfg.n_heads} "
            f"and n_kv={model_cfg.n_kv_heads} divisible by the head axis "
            f"size {n_tp} (GQA groups must stay whole per shard)")
    if model_cfg.kv_dim % (2 * n_tp):
        # the factor 2 keeps the nibble-packed int4 layout shardable too
        raise ValueError(f"kv_dim={model_cfg.kv_dim} not shardable over "
                         f"model axis {n_tp}")


def validate_ep_mesh(ep_mesh, model_cfg: ModelConfig,
                     engine_cfg: EngineConfig, cp_mesh=None,
                     cp_seq_axis: str = "seq") -> None:
    """EP serving preconditions: an MoE model; experts divide the "expert"
    axis; the decode batch, the prefill buckets and (with the prefix
    cache) a page divide the token sharding ("data" x "expert").

    CP composes with EP only on ONE mesh carrying "data", "expert" and the
    seq axis; the CP prefill's MoE tokens (the padded sequence itself)
    shard over (seq, expert), so the buckets divide by that product."""
    if ep_mesh is None:
        return
    if model_cfg.n_experts <= 0:
        raise ValueError("ep_mesh requires an MoE model (n_experts > 0)")
    if cp_mesh is not None and cp_mesh is not ep_mesh:
        raise ValueError(
            "cp_mesh and ep_mesh must be the SAME composed mesh (one "
            "Mesh carrying 'data', 'expert' and the seq axis); two "
            "distinct meshes cannot both lay out the token sharding")
    n_ep = _mesh_axis(ep_mesh, "expert")
    p_tok = _mesh_axis(ep_mesh, "data") * n_ep
    if model_cfg.n_experts % n_ep:
        raise ValueError(
            f"n_experts={model_cfg.n_experts} not divisible by expert "
            f"axis {n_ep}")
    if engine_cfg.max_batch % p_tok:
        raise ValueError(
            f"max_batch={engine_cfg.max_batch} not divisible by "
            f"data*expert={p_tok} (decode tokens shard over both)")
    # CP prefill is per sequence (B = 1): its MoE token dim is the padded
    # sequence, sharded over (seq, expert)
    p_pref = (_mesh_axis(ep_mesh, cp_seq_axis) * n_ep if cp_mesh is not None
              else p_tok)
    for b in tuple(engine_cfg.prefill_buckets) + (engine_cfg.max_seq_len,):
        if b % p_pref:
            raise ValueError(
                f"prefill bucket {b} not divisible by the prefill token "
                f"sharding {p_pref}")
    if engine_cfg.paged and engine_cfg.prefix_cache \
            and engine_cfg.page_size % p_tok:
        raise ValueError(
            f"page_size={engine_cfg.page_size} not divisible by "
            f"data*expert={p_tok}: the prefix-cache chunked prefill can "
            f"emit any page-multiple width; use a larger page_size or "
            f"prefix_cache=False")



def _mesh_shape(mesh) -> Dict[str, int]:
    """A mesh's axis sizes by name (a JAX ``Mesh.shape`` as a dict)."""
    names = tuple(mesh.mesh_dim_names or ())
    return {a: int(s) for a, s in zip(names, mesh.mesh.shape)}


def validate_fsdp_mesh(fsdp_mesh, model_cfg: ModelConfig,
                       engine_cfg: EngineConfig, tp_mesh=None, cp_mesh=None,
                       ep_mesh=None, pp_mesh=None, sp: bool = False) -> None:
    """FSDP serving preconditions, JAX's refusals with JAX's messages
    (``k8s_llm_rca_tpu/engine/engine.py::validate_fsdp_mesh``): parameters
    shard along the "fsdp" axis (``runtime/rules.py`` FSDP_LAYOUT: the
    non-TP matmul dim, hidden for the blocks, vocab for the embeddings)
    and each rank gathers every weight on use, so prefill and decode
    compute what the unsharded engine computes.

    Composes with TP on ONE mesh carrying both "fsdp" and "model"; PP, CP,
    EP and SP are refused.  The pool never shards on fsdp
    (``rules.paged_pool_specs``): only the weights do."""
    if fsdp_mesh is None:
        return
    shape = _mesh_shape(fsdp_mesh)
    for axis in ("data", "fsdp", "model"):
        if axis not in shape:
            raise ValueError(f"fsdp_mesh needs a '{axis}' axis, has "
                             f"{shape}")
    if tp_mesh is not None and tp_mesh is not fsdp_mesh:
        raise ValueError(
            "fsdp_mesh and tp_mesh must be the SAME composed mesh (one "
            "Mesh carrying 'fsdp' and 'model'); two distinct meshes "
            "cannot both lay out the weights")
    for other, what in ((cp_mesh, "CP"), (ep_mesh, "EP"), (pp_mesh, "PP")):
        if other is not None:
            raise ValueError(
                f"fsdp×{what} is unsupported until its greedy-parity "
                f"matrix lands (tests/test_sharding_rules.py): compose "
                f"fsdp with TP only")
    if sp:
        raise ValueError(
            "fsdp×SP is unsupported until its greedy-parity matrix lands: "
            "compose fsdp with TP only")
    n_f = shape["fsdp"]
    for dim, what in ((model_cfg.hidden_size, "hidden_size"),
                      (model_cfg.vocab_size, "vocab_size")):
        if dim % n_f:
            raise ValueError(
                f"{what}={dim} not divisible by fsdp axis {n_f} "
                f"(fsdp shards the hidden/vocab dim of every weight)")
    if engine_cfg.max_batch % shape["data"]:
        raise ValueError(
            f"max_batch={engine_cfg.max_batch} not divisible by data axis "
            f"{shape['data']}")


def validate_sp_buckets(tp_mesh, sizes) -> None:
    """Under ``sp`` the TP prefill splits the padded sequence over the model
    axis: every prefill bucket and max_seq_len (paged callers pass the
    page-rounded sizes) must divide by its size."""
    n_tp = _mesh_shape(tp_mesh)["model"]
    for b in sizes:
        if b % n_tp:
            raise ValueError(
                f"sp=True shards the padded sequence over the model "
                f"axis: bucket {b} is not divisible by its size {n_tp}")


def refuse_mesh_compositions(tp_mesh, cp_mesh, ep_mesh) -> None:
    """The compositions neither engine serves yet: CP x EP and TP x EP."""
    if cp_mesh is not None and ep_mesh is not None:
        raise NotImplementedError(
            f"cp_mesh with ep_mesh (CP x EP) is not ported yet "
            f"({mesh_item(9)})")
    if tp_mesh is not None and ep_mesh is not None:
        raise NotImplementedError(
            f"tp_mesh with ep_mesh (TP x EP) is not ported yet "
            f"({mesh_item(9)})")


def check_rank_params(model_cfg: ModelConfig, params, tp_mesh, ep_mesh,
                      fsdp_mesh, pp_mesh, pp_stage_axis: str = "stage"
                      ) -> None:
    """Refuse a param tree that is not this rank's shard of the meshes
    (``runtime.sharding.shard_params`` / ``shard_stage_params``)."""
    for m, axis, key, dim, total in (
            (tp_mesh, "model", "wq", -1, model_cfg.q_dim),
            (ep_mesh, "expert", "w_gate", 0, model_cfg.n_experts)):
        if m is None:
            continue
        want = total // int(m.mesh.shape[m.mesh_dim_names.index(axis)])
        got = params["layers"][0][key].shape[dim]
        if got != want:
            raise ValueError(
                f"the {axis} axis needs this rank's shard of the params "
                f"(runtime.sharding.shard_params): {key} has {got} along "
                f"dim {dim}, the rank's share is {want}")
    if fsdp_mesh is not None:
        want = model_cfg.hidden_size // _mesh_shape(fsdp_mesh)["fsdp"]
        got = params["layers"][0]["wq"].shape[0]
        if got != want:
            raise ValueError(
                f"the fsdp axis needs this rank's shard of the params "
                f"(runtime.sharding.shard_params under rules.FSDP_LAYOUT): "
                f"wq has {got} along dim 0, the rank's share is {want}")
        if tp_mesh is None and _mesh_shape(fsdp_mesh)["model"] > 1:
            # shard_params splits the heads over "model": only a TP rank's
            # model computes on them
            raise ValueError(
                "an fsdp_mesh with a 'model' axis above 1 is fsdp×tp: pass "
                "the same mesh as tp_mesh")
    if pp_mesh is not None:
        want = model_cfg.n_layers // int(pp_mesh.mesh.shape[
            pp_mesh.mesh_dim_names.index(pp_stage_axis)])
        if len(params["layers"]) != want:
            raise ValueError(
                f"the {pp_stage_axis} axis needs this rank's stage of the "
                f"params (runtime.sharding.shard_stage_params): "
                f"{len(params['layers'])} layers, the stage's share is "
                f"{want}")


def _int4_leaves(tree) -> bool:
    """True when any leaf of a param tree is an int4 weight."""
    from k8s_llm_rca_tpu_torch.models.quant import QuantTensor4

    if isinstance(tree, QuantTensor4):
        return True
    if isinstance(tree, dict):
        return any(_int4_leaves(v) for v in tree.values())
    if isinstance(tree, list):
        return any(_int4_leaves(v) for v in tree)
    return False


def validate_pp_mesh(pp_mesh, model_cfg: ModelConfig,
                     engine_cfg: EngineConfig, cp_mesh, ep_mesh, tp_mesh,
                     microbatches: Optional[int],
                     stage_axis: str = "stage", params=None
                     ) -> Optional[int]:
    """PP serving preconditions, JAX's refusals with JAX's messages
    (``k8s_llm_rca_tpu/engine/engine.py::validate_pp_mesh``).  Returns the
    microbatch count (None without ``pp_mesh``).

    PP composes with TP on ONE mesh carrying "stage" and "model" (the stage
    bodies run the TP block: column-parallel projections, row-parallel
    sums), int4 weights included when every sharded channel dim splits
    into 2 * model (per-shard split-half packing), but not with MoE; and
    with EP on ONE mesh carrying "stage" and "expert" (each expert peer
    routes its slice of a microbatch's tokens), but not with TP too.  CP is
    exclusive."""
    if pp_mesh is None:
        return None
    if cp_mesh is not None:
        raise ValueError(
            "pp_mesh and cp_mesh are mutually exclusive by design: "
            "stage-local CP replicates the matmul FLOPs and weight "
            "streaming that stage-local TP divides (1.5-3.6x the FLOPs, "
            "1.2-2.9x the HBM bytes per device at 4k-128k contexts — "
            "runtime.profiling.stage_local_cp_vs_tp and "
            "docs/parallelism.md 'PP×CP: a quantified no'); use PP×TP, "
            "or CP×TP for GQA-limited long contexts")
    if ep_mesh is not None:
        if ep_mesh is not pp_mesh:
            raise ValueError(
                "pp_mesh and ep_mesh must be the SAME composed mesh "
                "(one Mesh carrying 'stage' and 'expert'); two distinct "
                "meshes cannot both lay out the weights")
        if tp_mesh is not None:
            raise ValueError(
                "PP×TP×EP is unsupported (the manual-TP stage block "
                "computes a dense MLP; compose PP×EP or PP×TP)")
        n_ep = _mesh_axis(ep_mesh, "expert")
        m_ep = microbatches or _mesh_axis(pp_mesh, stage_axis)
        if (engine_cfg.max_batch // max(1, m_ep)) % n_ep:
            raise ValueError(
                f"PP×EP needs the microbatch size "
                f"{engine_cfg.max_batch}//{m_ep} divisible by the expert "
                f"axis {n_ep} (each expert peer routes a distinct token "
                f"slice of the microbatch)")
    if tp_mesh is not None:
        if tp_mesh is not pp_mesh:
            raise ValueError(
                "pp_mesh and tp_mesh must be the SAME composed mesh "
                "(one Mesh carrying 'stage' and 'model'); two distinct "
                "meshes cannot both lay out the weights and cache")
        n_tp = _mesh_axis(tp_mesh, "model")
        if model_cfg.n_heads % n_tp or model_cfg.n_kv_heads % n_tp:
            raise ValueError(
                f"n_heads={model_cfg.n_heads}/n_kv_heads="
                f"{model_cfg.n_kv_heads} not divisible by model axis "
                f"{n_tp} (required for PP×TP stage bodies)")
        if params is not None and _int4_leaves(params):
            for dim, what in ((model_cfg.q_dim, "q_dim"),
                              (model_cfg.kv_dim, "kv_dim"),
                              (model_cfg.intermediate_size,
                               "intermediate_size")):
                if dim % (2 * n_tp):
                    raise ValueError(
                        f"PP×TP with int4 weights needs {what}={dim} "
                        f"divisible by 2*model axis={2 * n_tp} "
                        f"(per-shard split-half nibble packing)")
        if model_cfg.n_experts > 0:
            raise ValueError(
                "PP×TP does not support MoE models (the manual-TP stage "
                "block computes a dense MLP; expert-stacked weights need "
                "the EP dispatch, which PP excludes)")
    names = tuple(pp_mesh.mesh_dim_names or ())
    if stage_axis not in names:
        shape = dict(zip(names, (int(n) for n in pp_mesh.mesh.shape)))
        raise ValueError(f"pp_mesh needs a '{stage_axis}' axis, has "
                         f"{shape}")
    n_stages = _mesh_axis(pp_mesh, stage_axis)
    if model_cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers={model_cfg.n_layers} not divisible into "
            f"{n_stages} pipeline stages")
    m = microbatches or n_stages
    if engine_cfg.max_batch % m:
        raise ValueError(
            f"max_batch={engine_cfg.max_batch} not divisible into "
            f"{m} PP microbatches")
    return m

def _leaves(tree):
    """Every tensor of a param tree (a quantized weight's q and scale)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield from (tree if isinstance(tree, tuple) else (tree,))


def check_params_device(params, device: torch.device) -> None:
    for leaf in _leaves(params):
        if leaf.device != device:
            raise ValueError(f"params live on {leaf.device}, the engine "
                             f"on {device}")


def overlap_step(cfg: ModelConfig, params, cache, cur_tokens: torch.Tensor,
                 lengths: torch.Tensor, generator: Optional[torch.Generator],
                 sampling: SamplingParams, cap: int, decode_fn=None):
    """One step of the overlapped hot loop: decode, sample, and advance
    every slot's length (clamped at ``cap``, the last cache row), all on
    the device; ``cur_tokens``/``lengths`` are the engine's resident
    operands and take the new values IN PLACE.  A slot the host already
    retired decodes garbage into its own row until the lagged commit drops
    its tokens.  ``decode_fn``: the decode step (default
    ``llama.decode_step``; under PP ``llama_pp_decode_step``).  Returns
    (cache, next_tokens [B], lengths)."""
    decode_fn = decode_fn or llama.decode_step
    cache, logits = decode_fn(cfg, params, cache, cur_tokens, lengths)
    nxt = sample_tokens(logits, generator, sampling)
    cur_tokens.copy_(nxt)
    lengths.copy_(torch.clamp(lengths + 1, max=cap))
    return cache, nxt, lengths


def decode_multi_greedy(cfg: ModelConfig, params, cache,
                        tokens: torch.Tensor, lengths: torch.Tensor):
    """The contiguous engine's verify step without PP: ``llama.
    decode_multi`` and its greedy choices on the device, returned as
    ``parallel.pipeline.llama_pp_decode_multi`` returns them (JAX's
    ``_verify_step``): (cache, greedy [B, T], logits [B, T, V])."""
    cache, logits = llama.decode_multi(cfg, params, cache, tokens, lengths)
    return cache, logits.argmax(dim=-1), logits


def decode_scan(cfg: ModelConfig, params, cache, cur_tokens: torch.Tensor,
                lengths: torch.Tensor, generator: Optional[torch.Generator],
                n_steps: int, sampling: SamplingParams = SamplingParams(),
                eos_id: int = -1, decode_fn=None):
    """``n_steps`` decode steps for the whole batch with no host sync.
    Slots that hit ``eos_id`` stop advancing (their token repeats; the
    host trims).  ``decode_fn`` as in ``overlap_step``.  Returns (cache,
    tokens [n_steps, B], lengths)."""
    decode_fn = decode_fn or llama.decode_step
    cur, lens = cur_tokens, lengths
    done = torch.zeros_like(cur_tokens, dtype=torch.bool)
    toks = []
    for _ in range(n_steps):
        cache, logits = decode_fn(cfg, params, cache, cur, lens)
        nxt = sample_tokens(logits, generator, sampling)
        advance = ~done
        done = done | (nxt == eos_id)
        cur = torch.where(advance, nxt, cur)
        lens = lens + advance.to(lens.dtype)
        toks.append(cur)
    return cache, torch.stack(toks), lens


def decode_scan_dfa(cfg: ModelConfig, params, cache,
                    cur_tokens: torch.Tensor, lengths: torch.Tensor,
                    generator: Optional[torch.Generator], n_steps: int,
                    sampling: SamplingParams, eos_id: int,
                    states: torch.Tensor, remaining: torch.Tensor,
                    allow_t: torch.Tensor, next_t: torch.Tensor,
                    dist_t: torch.Tensor, close_t: torch.Tensor,
                    complete_t: torch.Tensor, decode_fn=None):
    """``decode_scan`` with the compiled grammar DFA riding inside the loop
    (``dfa_scan_step``); ``decode_fn`` as in ``overlap_step``.  Returns
    (cache, tokens [n_steps, B], lengths, states)."""
    decode_fn = decode_fn or llama.decode_step
    cur, lens = cur_tokens, lengths
    done = torch.zeros_like(cur_tokens, dtype=torch.bool)
    toks = []
    for _ in range(n_steps):
        cache, logits = decode_fn(cfg, params, cache, cur, lens)
        cur, lens, done, states, remaining = dfa_scan_step(
            logits, cur, lens, done, states, remaining, generator, sampling,
            eos_id, allow_t, next_t, dist_t, close_t, complete_t)
        toks.append(cur)
    return cache, torch.stack(toks), lens, states


def _check_contiguous_config(engine_cfg: EngineConfig, prefix_store) -> None:
    """Refuse, as the JAX engine does, what needs a page pool."""
    if engine_cfg.prefill_chunk_budget:
        raise ValueError(
            "prefill_chunk_budget is a paged-engine feature: the "
            "contiguous cache has no chunked prefix-prefill path to "
            "spread a prompt across ticks (its prefill writes one "
            "monolithic slot slice).  Use paged=True "
            "(PagedInferenceEngine) or prefill_chunk_budget=0")
    if engine_cfg.max_spilled_pages:
        raise ValueError(
            "max_spilled_pages (KV spill-to-host preemption) requires "
            "the paged engine: the contiguous cache has no page pool "
            "to spill from and never preempts.  Use paged=True "
            "(PagedInferenceEngine) or max_spilled_pages=0")
    if (engine_cfg.prefix_host_pages or engine_cfg.prefix_disk_dir
            or engine_cfg.prefix_disk_pages or prefix_store is not None):
        raise ValueError(
            "the tiered prefix cache (prefix_host_pages / "
            "prefix_disk_dir / prefix_disk_pages / a shared "
            "prefix_store) requires the paged engine: the contiguous "
            "cache has no page pool to demote prefix pages from or "
            "promote them into.  Use paged=True "
            "(PagedInferenceEngine) or leave the tier knobs unset")
    if engine_cfg.prefix_hbm_watermark:
        raise ValueError(
            "prefix_hbm_watermark (pressure-driven prefix demotion) "
            "requires the paged engine: the contiguous cache has no "
            "page allocator whose free count could dip below a "
            "watermark.  Use paged=True (PagedInferenceEngine) or "
            "prefix_hbm_watermark=0")
    if engine_cfg.prefix_store_writethrough:
        raise ValueError(
            "prefix_store_writethrough requires the paged engine "
            "and a store: the contiguous cache has no prefix pages "
            "to publish.  Use paged=True (PagedInferenceEngine) or "
            "prefix_store_writethrough=False")


class InferenceEngine(EngineBase):
    """Continuous batching over the contiguous cache: each slot owns one
    [max_seq_len] KV row; a sequence keeps its slot until it retires.
    Runs on ``device`` (``None`` = the card); ``params`` must live there.
    ``draft_model=(cfg, params)`` of a small Llama with the same
    vocabulary drafts for ``speculative_k`` instead of n-gram lookup.
    ``tp_mesh``, ``ep_mesh``, ``fsdp_mesh``, ``cp_mesh`` (``cp_mode``
    "ring" or "ulysses" over its ``cp_seq_axis``; admission one sequence
    at a time), ``pp_mesh`` (``pp_microbatches`` over its
    ``pp_stage_axis``) and ``sp=True`` with TP serve the model over a
    device mesh, one engine per rank with its shard of the params; the
    meshes compose as on the paged engine."""

    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params, tokenizer: Tokenizer, device=None, *,
                 draft_model=None, tp_mesh=None, cp_mesh=None,
                 cp_seq_axis: str = "seq", cp_mode: str = "ring",
                 ep_mesh=None, pp_mesh=None,
                 pp_microbatches: Optional[int] = None,
                 pp_stage_axis: str = "stage", fsdp_mesh=None,
                 sp: bool = False, prefix_store=None):
        # JAX's ValueErrors first, in JAX's order
        if cp_mode not in ("ring", "ulysses"):
            raise ValueError(f"unknown cp_mode {cp_mode!r}")
        if sp and (tp_mesh is None or cp_mesh is not None
                   or pp_mesh is not None):
            raise ValueError("sp=True (Megatron sequence parallelism) "
                             "requires tp_mesh, is exclusive with cp_mesh "
                             "(CP already seq-shards activations), and is "
                             "unsupported on the PP paths (the pipelined "
                             "prefill/decode do not thread sp_mesh)")
        if engine_cfg.host_overlap and cp_mesh is not None:
            raise ValueError(
                "host_overlap=True is unsupported with cp_mesh: CP admits "
                "per-sequence through prefill_cp and its multi-process "
                "host_np collectives must line up SPMD-identically across "
                "processes — a lagged commit would reorder them.  Run CP "
                "engines with host_overlap=False")
        _check_contiguous_config(engine_cfg, prefix_store)
        sizes = tuple(engine_cfg.prefill_buckets) + (engine_cfg.max_seq_len,)
        n_cp = 0
        if cp_mesh is not None:
            n_cp = _mesh_axis(cp_mesh, cp_seq_axis)
            validate_cp_divisibility(cp_seq_axis, n_cp, sizes)
        validate_ep_mesh(ep_mesh, model_cfg, engine_cfg, cp_mesh,
                         cp_seq_axis)
        validate_tp_mesh(tp_mesh, model_cfg, cp_mesh, cp_seq_axis)
        validate_fsdp_mesh(fsdp_mesh, model_cfg, engine_cfg, tp_mesh,
                           cp_mesh, ep_mesh, pp_mesh, sp)
        pp_m = validate_pp_mesh(pp_mesh, model_cfg, engine_cfg, cp_mesh,
                                ep_mesh, tp_mesh, pp_microbatches,
                                pp_stage_axis, params)
        if engine_cfg.kv_cache_dtype not in (None, "int8", "int4"):
            raise ValueError(
                f"unsupported kv_cache_dtype {engine_cfg.kv_cache_dtype!r} "
                f"(None, 'int8' or 'int4')")
        if sp:
            # the contiguous buckets are not page-rounded
            validate_sp_buckets(tp_mesh, sizes)
        # then what neither engine serves yet, the paged engine's list
        self.mesh = next((m for m in (pp_mesh, tp_mesh, ep_mesh, cp_mesh,
                                      fsdp_mesh) if m is not None), None)
        if self.mesh is not None:
            refuse_mesh_compositions(tp_mesh, cp_mesh, ep_mesh)
            check_rank_params(model_cfg, params, tp_mesh, ep_mesh, fsdp_mesh,
                              pp_mesh, pp_stage_axis)
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        if self.mesh is not None:
            # this rank's model: its heads, its stage's layers (its cache's
            # depth), the collectives' groups, fsdp and sp
            model_cfg = rank_config(model_cfg, tp_mesh, ep_mesh, self.device,
                                    cp_mesh, cp_seq_axis, pp_mesh,
                                    pp_stage_axis, pp_m, fsdp_mesh, sp)
        # PP: every admission goes through the pipelined batched prefill,
        # padded to a multiple of the microbatches.  CP: one sequence at a
        # time through the ring or the all-to-all, each rank keeping its
        # block of the sequence
        self._pp_m = pp_m
        self.cp_mode = cp_mode if cp_mesh is not None else None
        self._batch_admission = cp_mesh is None
        self._prefill_one = llama.prefill
        self._prefill_batch = llama.prefill_batch
        self._decode_fn = llama.decode_step
        self._decode_multi_fn = decode_multi_greedy
        if cp_mesh is not None:
            self._prefill_one = functools.partial(
                llama.prefill_cp, mesh=cp_mesh, seq_axis=cp_seq_axis,
                cp_mode=cp_mode,
                head_axis="model" if tp_mesh is not None else None)
        if pp_mesh is not None:
            from k8s_llm_rca_tpu_torch.parallel import pipeline

            self._prefill_one = None
            self._prefill_batch = pipeline.llama_pp_prefill
            self._decode_fn = pipeline.llama_pp_decode_step
            self._decode_multi_fn = pipeline.llama_pp_decode_multi
        self.model_cfg = model_cfg
        self.engine_cfg = engine_cfg
        self.params = params
        self.tokenizer = tokenizer
        self.sampling = SamplingParams(temperature=engine_cfg.temperature,
                                       top_k=engine_cfg.top_k,
                                       top_p=engine_cfg.top_p)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(engine_cfg.seed)
        self._draft = setup_draft(draft_model, model_cfg, engine_cfg,
                                  self.device)
        if self._draft is not None:
            # the draft scan's token fetch is one of this engine's syncs
            self._draft.on_sync = lambda: self._count("engine.d2h_syncs")
            self._draft_agree = DraftAgreement.for_engine(self)

        b = engine_cfg.max_batch
        # under CP the rank's block of every row, under TP its lanes,
        # under PP its stage's layers; fsdp keeps the whole cache
        self.cache = llama.init_cache(
            model_cfg, b, engine_cfg.max_seq_len // max(n_cp, 1),
            engine_cfg.kv_cache_dtype, self.device)
        self.lengths = np.zeros((b,), np.int64)
        self.cur_tokens = np.zeros((b,), np.int64)
        self._free_slots = list(range(b))
        self._active: Dict[int, _Active] = {}
        self._pending: List[_Pending] = []
        self._seq_counter = itertools.count()
        self._prompts: Dict[int, List[int]] = {}   # seq_id -> ORIGINAL prompt
        # tokens generated before a crash restore (restore_sequences); the
        # contiguous engine never preempts
        self._resumed: Dict[int, List[int]] = {}
        self._buckets = tuple(
            s for s in sorted(set(engine_cfg.prefill_buckets))
            if s <= engine_cfg.max_seq_len) or (engine_cfg.max_seq_len,)
        # the decode operands (tokens, lengths, DFA states and budgets) in
        # static int32 device buffers, filled from staging buffers (pinned
        # on the card)
        pin = self.device.type == "cuda"
        self._staging = tuple(torch.zeros((b,), dtype=torch.int32,
                                          pin_memory=pin) for _ in range(4))
        self._operands = tuple(torch.zeros((b,), dtype=torch.int32,
                                           device=self.device)
                               for _ in range(4))
        self._dfa_static: Dict[int, tuple] = {}
        # the overlapped hot loop: the operands stay resident between
        # ticks (uploaded only when dirty, then edited slot by slot)
        self._overlap = engine_cfg.host_overlap
        self._inflight = []
        self._admit_pending = []
        self._flushed_out = []
        self._dev_dirty = True
        self._overlap_cap = engine_cfg.max_seq_len - 1

    # --------------------------------------------- device-side operands

    def _device_state(self):
        """(tokens, lengths) as the static device operands: uploaded from
        the host mirrors every call, or with ``host_overlap`` only when
        dirty (slot edits keep them current in between)."""
        if self._overlap and not self._dev_dirty:
            return self._operands[:2]
        self._count("engine.h2d_uploads", 2)
        out = (self._upload(0, self.cur_tokens), self._upload(1, self.lengths))
        if self._overlap:
            self._dev_dirty = False
            # deferred first tokens exist only on the device so far
            for st, t, i in self._admit_pending:
                if self._active.get(st.slot) is st:
                    out[0][st.slot] = t[i]
        return out

    def _spec_room_ok(self, slot: int, t: int) -> bool:
        return int(self.lengths[slot]) + t <= self.engine_cfg.max_seq_len

    # ------------------------------------------------------------- tick

    def _tick(self) -> List[SequenceResult]:
        """Admit pending requests into free slots, then one decode
        dispatch for every active slot (speculative verify, a scan chunk,
        the overlapped step or one step); returns the sequences finished
        this tick."""
        finished: List[SequenceResult] = self._reap_deadlines()
        if self._flushed_out:
            finished.extend(self._flushed_out)
            self._flushed_out = []
        fast = self._overlap_fast()
        if self._inflight and not fast:
            finished.extend(self._overlap_flush())
        while self._pending and self._free_slots:
            group = self._admission_group()
            # PP has no single-sequence prefill: every group goes through
            # the pipelined batched path
            if len(group) == 1 and self._prefill_one is not None:
                early = self._admit(group[0])
                if early is not None:    # first token already terminal
                    finished.append(early)
            else:
                finished.extend(self._admit_batch(group))
        if not fast:
            # one fetch commits every first token sampled at admission
            finished.extend(self._drain_admission_commits())
        if not self._active:
            finished.extend(self._overlap_flush())
            return finished

        if self._speculation_applies():
            finished.extend(self._speculative_tick())
            return finished

        chunk = self._scan_chunk()
        if chunk > 1:
            finished.extend(self._scan_tick(chunk))
            return finished

        if fast:
            finished.extend(self._overlap_step_tick())
            return finished

        active_slots = list(self._active)
        forced, allow = self._tick_constraints(
            active_slots, self.engine_cfg.max_batch,
            self.model_cfg.vocab_size)
        cur_d, lens_d = self._device_state()
        with annotate("engine.decode_step"):
            self._count("engine.dispatches")
            self._count("engine.decode_steps")
            self.cache, logits = self._decode_fn(
                self.model_cfg, self.params, self.cache, cur_d, lens_d)
            if allow is not None:
                next_tokens = sample_tokens_masked(
                    logits, self._gen, self.sampling,
                    torch.from_numpy(allow).to(self.device))
            else:
                next_tokens = sample_tokens(logits, self._gen, self.sampling)
        self._count("engine.decode_tokens", len(active_slots))
        (host_next,) = self._fetch(next_tokens)
        for slot in active_slots:
            self.lengths[slot] += 1
            st = self._active[slot]
            token = forced.get(slot, int(host_next[slot]))
            self.cur_tokens[slot] = token
            st.generated.append(token)
            if st.grammar is not None:
                st.grammar.advance(token)
            reason = self._finish_reason(st, token, int(self.lengths[slot]))
            if reason is not None:
                finished.append(self._retire(slot, reason))
        self._invalidate_device_state()
        return finished

    def _overlap_step_tick(self) -> List[SequenceResult]:
        """The overlapped fast path: one dispatch over the resident
        operands (``overlap_step``), no fetch; its tokens commit when the
        lag flushes."""
        # the device state first: a dirty upload re-applies the deferred
        # first tokens, so take them only after it
        cur_d, lens_d = self._device_state()
        admits = self._take_admit_pending()
        slots = [(s, self._active[s].seq_id) for s in sorted(self._active)]
        with annotate("engine.decode_step"):
            self._count("engine.dispatches")
            self._count("engine.decode_steps")
            self.cache, nxt, _ = overlap_step(
                self.model_cfg, self.params, self.cache, cur_d, lens_d,
                self._gen, self.sampling, self._overlap_cap,
                decode_fn=self._decode_fn)
        self._inflight.append({"slots": slots, "toks": nxt,
                               "admits": admits})
        if len(self._inflight) >= self._overlap_lag:
            return self._overlap_flush()
        return []

    def _scan_tick(self, chunk: int) -> List[SequenceResult]:
        """Commit ``chunk`` decode steps run in one device loop, with the
        fused grammar DFA inside it when a DFA slot is active."""
        active_slots = list(self._active)
        setup = self._scan_dfa_setup()
        cur_d, lens_d = self._device_state()
        cfg, params, eos = self.model_cfg, self.params, self.tokenizer.eos_id
        with annotate("engine.decode_step"):
            self._count("engine.dispatches")
            self._count("engine.decode_steps", chunk)
            if setup is None:
                self.cache, toks, lens = decode_scan(
                    cfg, params, self.cache, cur_d, lens_d, self._gen, chunk,
                    self.sampling, eos, decode_fn=self._decode_fn)
            else:
                tables, states, remaining = setup
                self.cache, toks, lens, _ = decode_scan_dfa(
                    cfg, params, self.cache, cur_d, lens_d, self._gen, chunk,
                    self.sampling, eos, self._upload(2, states),
                    self._upload(3, remaining), *tables,
                    decode_fn=self._decode_fn)
        if self._overlap:
            # the surviving slots' host mirrors advance to exactly these
            # values in the commit below, so the resident operands stay
            # clean
            cur_d.copy_(toks[-1])
            lens_d.copy_(lens)
        (toks_host,) = self._fetch(toks)                # [chunk, B]

        def post_commit(slot: int, token: int) -> None:
            self.lengths[slot] += 1
            self.cur_tokens[slot] = token
            self._grammar_post_commit(slot, token)

        return self._commit_scanned(active_slots, toks_host, chunk,
                                    post_commit)

    def _speculative_tick(self) -> List[SequenceResult]:
        """Verification tick: the drafts scored by ONE ``decode_multi``
        (``_decode_multi_fn``: under PP ``llama_pp_decode_multi``),
        committed through ``_verify_and_commit``.  Grammar slots sharing
        one compiled DFA verify constrained on the device
        (``dfa_greedy_multi``); otherwise [B, T, V] logits go to the host
        for the grammar slots."""
        active_slots = list(self._active)
        tokens_in, drafts = self._build_drafts(active_slots, self.cur_tokens)
        need_logits = self._need_spec_logits(active_slots)
        setup = (self._scan_dfa_setup()
                 if need_logits and self._uniform_dfa_tables() is not None
                 else None)
        self._count("engine.h2d_uploads", 2)
        toks_d = self._to_device(tokens_in)
        lens_d = self._upload(1, self.lengths)
        logits_host = None
        with annotate("engine.decode_step"):
            self._count("engine.dispatches")
            self._count("engine.decode_steps")
            self._count("engine.verify_steps")
            self.cache, greedy, logits = self._decode_multi_fn(
                self.model_cfg, self.params, self.cache, toks_d, lens_d)
            if setup is None:
                if need_logits:
                    greedy_host, logits_host = self._fetch(greedy, logits)
                else:
                    (greedy_host,) = self._fetch(greedy)
            else:
                tables, states, remaining = setup
                greedy = dfa_greedy_multi(
                    logits, self._upload(2, states),
                    self._upload(3, remaining), self.tokenizer.eos_id,
                    *tables)
                (greedy_host,) = self._fetch(greedy)

        def post_commit(slot: int, token: int) -> None:
            self.lengths[slot] += 1
            self.cur_tokens[slot] = token

        out = self._verify_and_commit(active_slots, drafts, greedy_host,
                                      logits_host, post_commit,
                                      constrained=setup is not None)
        self._invalidate_device_state()
        return out

    # ------------------------------------------------------- admission

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self.engine_cfg.max_seq_len

    def _admission_group(self) -> List[_Pending]:
        """Pop a FIFO run of pending requests sharing one prefill bucket,
        bounded by the free slots and 8: one batched prefill (under CP one
        request: ``prefill_cp`` is per sequence)."""
        group = [self._pending.pop(0)]
        if not self._batch_admission:
            return group                    # CP prefills one sequence
        b0 = self._bucket(len(group[0].prompt_ids))
        while (self._pending and len(group) < len(self._free_slots)
               and len(group) < 8
               and self._bucket(len(self._pending[0].prompt_ids)) == b0):
            group.append(self._pending.pop(0))
        return group

    def _admit(self, req: _Pending) -> Optional[SequenceResult]:
        """Prefill one sequence into the first free slot.  A grammar
        sequence commits its constrained first token now; others at the
        tick's drain."""
        slot = self._free_slots.pop(0)
        n = len(req.prompt_ids)
        padded = np.zeros((1, self._bucket(n)), np.int64)
        padded[0, :n] = req.prompt_ids
        with annotate("engine.prefill"):
            self._count("engine.dispatches")
            self._count("engine.prefill_dispatches")
            self.cache, logits = self._prefill_one(
                self.model_cfg, self.params, self.cache,
                self._to_device(padded), n, slot)
            first = sample_tokens(logits, self._gen, self.sampling)
        self._count("engine.prefill_tokens", n)
        if req.grammar is not None:
            return self._activate(req, slot, logits,
                                  int(self._fetch(first)[0][0]))
        st = self._preactivate(req, slot)
        self._dev_edit_token(slot, first[0])
        self._admit_pending.append((st, first, 0))
        return None

    def _admit_batch(self, reqs: List[_Pending]) -> List[SequenceResult]:
        """Admit N same-bucket sequences with one batched prefill, padded
        to a power of two (under PP then to a multiple of the microbatches)
        by repeating the last row (same slot: the duplicate writes are
        equal)."""
        n = len(reqs)
        bucket = self._bucket(max(len(r.prompt_ids) for r in reqs))
        n_pad = 1
        while n_pad < n:
            n_pad *= 2
        if self._pp_m and n_pad % self._pp_m:
            n_pad = -(-n_pad // self._pp_m) * self._pp_m
        slots = [self._free_slots.pop(0) for _ in range(n)]
        tokens = np.zeros((n_pad, bucket), np.int64)
        lens = np.zeros((n_pad,), np.int32)
        slot_arr = np.zeros((n_pad,), np.int64)
        for i, r in enumerate(reqs):
            tokens[i, :len(r.prompt_ids)] = r.prompt_ids
            lens[i] = len(r.prompt_ids)
            slot_arr[i] = slots[i]
        for a in (tokens, lens, slot_arr):
            a[n:] = a[n - 1]
        with annotate("engine.prefill"):
            self._count("engine.dispatches")
            self._count("engine.prefill_dispatches")
            self.cache, logits = self._prefill_batch(
                self.model_cfg, self.params, self.cache,
                *(self._to_device(a) for a in (tokens, lens, slot_arr)))
            firsts = sample_tokens(logits, self._gen, self.sampling)
        self._count("engine.prefill_tokens", int(lens[:n].sum()))
        self._count("engine.batched_admissions", n)
        if any(r.grammar is not None for r in reqs):
            # a grammar member makes the whole group synchronous
            finished: List[SequenceResult] = []
            (firsts_host,) = self._fetch(firsts)
            for i, req in enumerate(reqs):
                early = self._activate(req, slots[i], logits[i:i + 1],
                                       int(firsts_host[i]))
                if early is not None:
                    finished.append(early)
            return finished
        for i, req in enumerate(reqs):
            st = self._preactivate(req, slots[i])
            self._dev_edit_token(slots[i], firsts[i])
            self._admit_pending.append((st, firsts, i))
        return []

    def _preactivate(self, req: _Pending, slot: int) -> _Active:
        """Register the slot and its length (the first token commits
        separately)."""
        n = len(req.prompt_ids)
        st = _Active(seq_id=req.seq_id, slot=slot, prompt_tokens=n,
                     max_new_tokens=req.max_new_tokens,
                     stop_strings=req.stop_strings, grammar=req.grammar,
                     priority=req.priority)
        self._active[slot] = st
        self.lengths[slot] = n
        self._dev_edit_len(slot, n)
        return st

    def _activate(self, req: _Pending, slot: int, logits_1v,
                  first_token: int) -> Optional[SequenceResult]:
        """Synchronous activation: grammar-constrain the first token,
        register the slot, retire at once if it is already terminal."""
        st = self._preactivate(req, slot)
        token = first_token
        if st.grammar is not None:
            remaining = min(st.max_new_tokens,
                            self.engine_cfg.max_seq_len
                            - st.prompt_tokens - 1)
            token = self._grammar_first_token(st.grammar, logits_1v, token,
                                              remaining)
            st.grammar.advance(token)
        return self._commit_first(st, token)

    def _retire(self, slot: int, reason: str) -> SequenceResult:
        st = self._active.pop(slot)
        if self._deadlines:
            self._deadlines.pop(st.seq_id, None)
        self._free_slots.append(slot)
        # a freed slot's length goes back to 0 (the scan advances idle
        # slots too; writes past the row clamp to its last position)
        self.lengths[slot] = 0
        self._dev_edit_len(slot, 0)
        # a crash-restored sequence's prompt carried its earlier tokens:
        # report against the ORIGINAL prompt with them stitched back
        orig_prompt = self._prompts.pop(st.seq_id, None)
        generated = self._resumed.pop(st.seq_id, []) + st.generated
        return SequenceResult(
            seq_id=st.seq_id, token_ids=list(generated),
            text=self._final_text(generated, reason, st.stop_strings),
            finish_reason=reason,
            prompt_tokens=(len(orig_prompt) if orig_prompt is not None
                           else st.prompt_tokens),
            completion_tokens=len(generated))
