"""Embedding rerank of graph evidence: the port of
``k8s_llm_rca_tpu/rca/rerank.py``.

An e5-style encoder (``models/encoder.py``) embeds the error message as a
query and candidate evidence (statepath records, STATE field projections)
as passages; cosine similarity orders them, so prompts carry the most
relevant evidence first and ``RCAConfig.rerank_fields_top_k`` can cut the
fields an audit prompt carries.

Batching: texts pad to a few bucket lengths and encode in batches of
``batch_size``, shortest first, as in JAX.  The encoder runs on
``device`` (``None`` = the card).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from k8s_llm_rca_tpu_torch.config import EncoderConfig, TINY_ENCODER
from k8s_llm_rca_tpu_torch.models import encoder
from k8s_llm_rca_tpu_torch.utils.device import resolve_device
from k8s_llm_rca_tpu_torch.utils.tokenizer import Tokenizer, get_tokenizer

# e5 asymmetric-retrieval convention: queries and passages are prefixed so
# the encoder can specialize each side
QUERY_PREFIX = "query: "
PASSAGE_PREFIX = "passage: "


class Embedder:
    """Batched text -> unit-vector embeddings on ``device``.  Without
    ``params`` the weights are seeded random (``torch.Generator`` seed 0
    on the device)."""

    def __init__(self, cfg: EncoderConfig = TINY_ENCODER,
                 params: Optional[Any] = None,
                 tokenizer: Optional[Tokenizer] = None,
                 buckets: Sequence[int] = (32, 64, 128, 256, 512),
                 batch_size: int = 32, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params if params is not None else encoder.init_params(
            cfg, torch.Generator(device=self.device).manual_seed(0),
            self.device)
        self.tokenizer = tokenizer or get_tokenizer(vocab_size=cfg.vocab_size)
        self.buckets = tuple(b for b in sorted(buckets)
                             if b <= cfg.max_seq_len) or (cfg.max_seq_len,)
        self.batch_size = batch_size

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @torch.inference_mode()
    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """texts -> [N, H] fp32 unit vectors (host)."""
        if not texts:
            return np.zeros((0, self.cfg.hidden_size), np.float32)
        ids = [self.tokenizer.encode(t)[: self.cfg.max_seq_len]
               for t in texts]
        out = np.zeros((len(texts), self.cfg.hidden_size), np.float32)
        # shortest first, so each batch pads to the smallest bucket it can
        order = sorted(range(len(ids)), key=lambda i: len(ids[i]))
        for start in range(0, len(order), self.batch_size):
            group = order[start:start + self.batch_size]
            width = self._bucket(max(len(ids[i]) for i in group))
            tokens = np.zeros((len(group), width), np.int64)
            lengths = np.zeros((len(group),), np.int64)
            for row, i in enumerate(group):
                seq = ids[i][:width] or [0]
                tokens[row, : len(seq)] = seq
                lengths[row] = len(seq)
            vecs = encoder.embed(self.cfg, self.params,
                                 torch.from_numpy(tokens).to(self.device),
                                 torch.from_numpy(lengths).to(self.device))
            out[group] = vecs.cpu().numpy()
        return out


def cosine_rerank(query_vec: np.ndarray, passage_vecs: np.ndarray
                  ) -> List[Tuple[int, float]]:
    """Unit vectors in -> [(index, score)] by descending similarity, ties
    in index order (a stable sort)."""
    scores = passage_vecs @ query_vec
    order = np.argsort(-scores, kind="stable")
    return [(int(i), float(scores[i])) for i in order]


class Reranker:
    """Query-vs-passages reranker: the RCA pipeline orders statepath
    records with it and the auditor keeps a STATE node's most relevant
    fields (``rca/auditor.py::_project_fields``)."""

    def __init__(self, embedder: Optional[Embedder] = None):
        self.embedder = embedder or Embedder()
        # per-query embedding cache (FIFO, 16 entries): one incident
        # reranks its records and then every audited STATE node against
        # the same error message
        self._query_cache: dict = {}

    def _query_vec(self, query: str) -> np.ndarray:
        qv = self._query_cache.get(query)
        if qv is None:
            qv = self.embedder.encode([QUERY_PREFIX + query])[0]
            while len(self._query_cache) >= 16:
                self._query_cache.pop(next(iter(self._query_cache)))
            self._query_cache[query] = qv
        return qv

    def rerank(self, query: str, passages: Sequence[str],
               top_k: Optional[int] = None) -> List[Tuple[int, float]]:
        if not passages:
            return []
        qv = self._query_vec(query)
        pv = self.embedder.encode([PASSAGE_PREFIX + p for p in passages])
        ranked = cosine_rerank(qv, pv)
        return ranked[:top_k] if top_k else ranked

    def rerank_records(self, error_message: str, records: Sequence[Any],
                       top_k: Optional[int] = None
                       ) -> List[Tuple[Any, float]]:
        """Order statepath records by embedding relevance to the incident;
        records render through their graph elements (``_record_text``)."""
        texts = [_record_text(r) for r in records]
        ranked = self.rerank(error_message, texts, top_k)
        return [(records[i], score) for i, score in ranked]


def _record_text(record: Any) -> str:
    """Flatten a statepath record into text for embedding: node kinds and
    name-ish keys, edge types (enough signal without the JSON payloads)."""
    parts: List[str] = []
    try:
        elements = list(record)
    except TypeError:
        return str(record)
    for ele in elements:
        props = getattr(ele, "properties", None)
        if isinstance(props, dict):
            for key in ("kind", "kind2", "tag", "name2", "val", "path",
                        "containerName", "imageName", "message"):
                v = props.get(key)
                if v:
                    parts.append(str(v))
        else:
            parts.append(str(ele))
    return " ".join(parts) if parts else str(record)
