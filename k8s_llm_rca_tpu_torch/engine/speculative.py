"""Speculative decoding drafts: n-gram prompt lookup and a draft MODEL,
the port of ``k8s_llm_rca_tpu/engine/speculative.py``.

Draft tokens come either from the continuation of the most recent earlier
occurrence of a slot's last n tokens (``ngram_draft``, no model) or from
a small draft Llama running ahead greedily (``ModelDraft``).  Either way
one multi-token decode step scores all draft positions at once; the
engine commits the longest draft prefix that agrees with the model's own
greedy (grammar-constrained) choice plus one bonus token, so the output
equals plain greedy decoding and only the tokens committed per dispatch
change.  The draft's quality moves the acceptance rate, never the result.

Under a device mesh the draft is never sharded: as JAX runs its
``ModelDraft`` whole beside a sharded target, every rank builds the draft
on its own device from the whole draft params.  The ranks' drafts would
be equal, but the verify step's collectives need every rank to verify
the same tokens, so ``DraftAgreement`` broadcasts the mesh's lowest
rank's drafts once a verify tick.  n-gram drafts need no broadcast: they
are a function of the committed tokens, equal on every rank.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def ngram_draft(context: Sequence[int], n: int, k: int) -> List[int]:
    """Propose up to ``k`` draft tokens by prompt lookup: the tokens that
    followed the most recent earlier occurrence of the last ``n`` tokens
    of ``context``.  Empty when that n-gram has no earlier occurrence."""
    if n <= 0 or k <= 0 or len(context) <= n:
        return []
    pattern = list(context[-n:])
    # right to left over earlier windows: the most recent prior occurrence
    # predicts the continuation best
    for start in range(len(context) - n - 1, -1, -1):
        if list(context[start:start + n]) == pattern:
            return list(context[start + n:start + n + k])
    return []


class ModelDraft:
    """Draft-model speculation state: a small Llama with its own
    contiguous cache (``models.llama.init_cache``) on the engine's device
    mirrors the target engine's slots and proposes k greedy tokens per
    tick, one ``engine.engine.decode_scan`` over the whole batch.

    The target verifies every token, so the draft cache tolerates two
    approximations:

    - lazy slot sync: a slot whose (seq_id, context length) key diverged
      from the draft's bookkeeping (admission, a preemption's resume, a
      tick that did not speculate) re-prefills its draft row from the
      context; on the steady speculative path ``advance`` keeps the key
      current, so the re-prefill does not fire;
    - garbage past the committed length: rejected draft positions leave
      stale KV above ``lengths``, which later writes overwrite and
      attention masks by length.

    A context longer than the draft's cache keeps only its TAIL (a worse
    draft; verification is unaffected)."""

    def __init__(self, cfg, params, engine_cfg, device):
        from k8s_llm_rca_tpu_torch.engine.sampling import SamplingParams
        from k8s_llm_rca_tpu_torch.models import llama

        self.cfg = cfg
        self.params = params
        self.device = device
        b = engine_cfg.max_batch
        self.k = engine_cfg.speculative_k
        self.max_seq = min(cfg.max_seq_len, engine_cfg.max_seq_len)
        self.cache = llama.init_cache(cfg, b, self.max_seq, device=device)
        self.lengths = np.zeros((b,), np.int64)
        self.cur = np.zeros((b,), np.int64)
        self._owner: Dict[int, Tuple[int, int]] = {}   # slot -> (seq, ctxlen)
        self.prefills = 0          # sync re-prefills (diagnostics, tests)
        self.scan_steps = 0        # decode steps of the draft scans (same)
        self._buckets = tuple(
            s for s in sorted(set(engine_cfg.prefill_buckets))
            if s <= self.max_seq) or (self.max_seq,)
        self._greedy = SamplingParams()                # temperature 0
        # the owning engine counts the draft scan's blocking token fetch
        # as one of its own d2h syncs
        self.on_sync = None

    def _bucket(self, n: int) -> int:
        for s in self._buckets:
            if n <= s:
                return s
        return self.max_seq

    def sync(self, slot: int, seq_id: int, context: Sequence[int]) -> None:
        """Re-prefill ``slot``'s draft row from ``context`` unless its key
        is current."""
        from k8s_llm_rca_tpu_torch.models import llama

        if self._owner.get(slot) == (seq_id, len(context)):
            return
        # keep a drafting window (a quarter of the cache, at least one
        # k + 1 scan) free after the tail: clipping to the cache edge would
        # re-prefill the whole tail every tick or two
        window = max(self.k + 2, self.max_seq // 4)
        ctx = list(context[-max(2, self.max_seq - window):])
        n = len(ctx) - 1                               # cur token stays out
        if n <= 0:
            self.lengths[slot] = 0
            self.cur[slot] = ctx[-1] if ctx else 0
            self._owner[slot] = (seq_id, len(context))
            return
        padded = np.zeros((1, self._bucket(n)), np.int64)
        padded[0, :n] = ctx[:-1]
        self.prefills += 1
        self.cache, _ = llama.prefill(
            self.cfg, self.params, self.cache,
            torch.from_numpy(padded).to(self.device), n, slot)
        self.lengths[slot] = n
        self.cur[slot] = ctx[-1]
        self._owner[slot] = (seq_id, len(context))

    def draft(self, active_slots, k: int, eos_id: int
              ) -> Dict[int, List[int]]:
        """One greedy scan for the whole batch: {slot: k draft tokens}
        (empty for a slot without cache room).

        The scan runs k + 1 steps, one more than the drafts returned: step
        j writes the KV of its INPUT token, so k steps would leave the last
        draft's KV unwritten, and on full acceptance ``advance`` would mark
        that position valid.  The extra step writes it (its token is
        dropped)."""
        from k8s_llm_rca_tpu_torch.engine.engine import decode_scan

        roomy = {s for s in active_slots
                 if int(self.lengths[s]) + k + 1 < self.max_seq}
        if not roomy:
            # no scan ran, so not even cur's KV was written: drop the keys,
            # or the bonus token's commit would mark it valid
            for s in active_slots:
                self._owner.pop(s, None)
            return {s: [] for s in active_slots}
        cur = torch.from_numpy(self.cur.astype(np.int32)).to(self.device)
        lens = torch.from_numpy(self.lengths.astype(np.int32)).to(self.device)
        self.scan_steps += k + 1
        self.cache, toks, _ = decode_scan(
            self.cfg, self.params, self.cache, cur, lens, None, k + 1,
            self._greedy, eos_id)
        if self.on_sync is not None:
            self.on_sync()
        toks_host = toks.cpu().numpy()                 # [k + 1, B]
        out = {}
        for s in active_slots:
            if s in roomy:
                out[s] = [int(toks_host[j, s]) for j in range(k)]
            else:
                out[s] = []
                self._owner.pop(s, None)   # re-sync when room frees
        return out

    def advance(self, slot: int, seq_id: int,
                committed: Sequence[int]) -> None:
        """Record a verified commit: the accepted prefix's KV is already in
        the draft cache (the draft scan wrote those positions with the
        same tokens); the bonus token becomes the next cur.  Anything
        inconsistent drops the key and re-syncs."""
        owner = self._owner.get(slot)
        if owner is None or not committed:
            return
        seq, ctxlen = owner
        if seq != seq_id:
            self._owner.pop(slot, None)
            return
        new_len = int(self.lengths[slot]) + len(committed)
        if new_len >= self.max_seq:
            self._owner.pop(slot, None)                # tail re-prefill later
            return
        self.lengths[slot] = new_len
        self.cur[slot] = committed[-1]
        self._owner[slot] = (seq, ctxlen + len(committed))


def setup_draft(draft_model, model_cfg, engine_cfg, device):
    """Validate and build the ``ModelDraft`` of ``draft_model=(cfg,
    params)`` on ``device`` (both engines' constructors); None passes
    through."""
    if draft_model is None:
        return None
    if engine_cfg.speculative_k <= 0:
        raise ValueError("draft_model requires speculative_k > 0 "
                         "(the draft only exists to fill draft slots)")
    dcfg, dparams = draft_model
    if dcfg.vocab_size != model_cfg.vocab_size:
        raise ValueError(
            f"draft vocab {dcfg.vocab_size} != target vocab "
            f"{model_cfg.vocab_size} (draft tokens must be target tokens)")
    return ModelDraft(dcfg, dparams, engine_cfg, device)


class DraftAgreement:
    """The broadcast of a draft model's verify-step tokens under a device
    mesh: ``tokens_in`` [B, k + 1] int32 (each slot's current token, then
    its drafts) from the mesh's lowest rank to every rank of the mesh, one
    counted ``runtime.mesh.broadcast`` a verify tick (on one rank too).
    nccl takes only card tensors, so under nccl the array goes through
    one on the engine's device, and its fetch back is a host sync
    (``on_sync``, the owning engine's d2h counter); gloo takes it in host
    memory."""

    def __init__(self, ranks: Sequence[int], group, device: torch.device):
        import torch.distributed as dist

        self.src = min(ranks)
        self.group = group
        nccl = dist.get_backend(group) == "nccl"
        self.device = device if nccl else torch.device("cpu")
        self.on_sync = None

    @classmethod
    def for_engine(cls, engine) -> "DraftAgreement":
        """The agreement of a mesh engine with a draft model (None without
        a mesh), over the mesh's ranks (``runtime.mesh.mesh_group``)."""
        from k8s_llm_rca_tpu_torch.runtime.mesh import mesh_group

        mesh = engine.mesh
        if mesh is None:
            return None
        ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        agree = cls(ranks, mesh_group(mesh), engine.device)
        if agree.device.type == "cuda":
            agree.on_sync = lambda: engine._count("engine.d2h_syncs")
        return agree

    def __call__(self, tokens_in: np.ndarray) -> np.ndarray:
        from k8s_llm_rca_tpu_torch.runtime.mesh import broadcast

        buf = torch.from_numpy(np.ascontiguousarray(tokens_in, np.int32))
        buf = broadcast(buf.to(self.device), self.src, self.group)
        if self.on_sync is not None:
            self.on_sync()
        return buf.cpu().numpy()
