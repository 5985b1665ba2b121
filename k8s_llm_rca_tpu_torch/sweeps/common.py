"""Shared driver wiring: backend and graph executor construction from the
command line (the port of ``k8s_llm_rca_tpu/sweeps/common.py``).

Backends and graph endpoints are chosen by flags, and the hermetic
in-memory backends are the default.  One flag is the port's own:
``--device`` (default ``cuda``) places the engine; it runs on the card
unless ``--device cpu`` asks for the CPU, and it never falls back.
"""

from __future__ import annotations

import argparse
from typing import Tuple

from k8s_llm_rca_tpu_torch.config import MODEL_REGISTRY, TINY, EngineConfig
from k8s_llm_rca_tpu_torch.graph import InMemoryGraphExecutor
from k8s_llm_rca_tpu_torch.graph.fixtures import (
    build_metagraph, build_stategraph,
)
from k8s_llm_rca_tpu_torch.rca.oracle import OracleBackend
from k8s_llm_rca_tpu_torch.serve.api import AssistantService
from k8s_llm_rca_tpu_torch.utils.logging import get_logger
from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

log = get_logger(__name__)


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--backend", default="oracle",
                        choices=["oracle", "engine"],
                        help="LM backend: scripted oracle (hermetic) or the "
                             "inference engine")
    parser.add_argument("--model", default="tiny",
                        help=f"model preset for --backend engine: "
                             f"{sorted(MODEL_REGISTRY)}")
    parser.add_argument("--device", default="cuda",
                        help="where the engine runs: cuda (the default; "
                             "fails without a card) or cpu")
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--max-seq-len", type=int, default=2048)
    parser.add_argument("--decode-chunk", type=int, default=None,
                        help="decode steps per device dispatch (default: "
                             "EngineConfig's; semantics identical to "
                             "stepwise)")
    parser.add_argument("--paged", action="store_true",
                        help="paged KV cache engine (preemption + prefix "
                             "caching)")
    quant = parser.add_mutually_exclusive_group()
    quant.add_argument("--int8", action="store_true",
                       help="weight-only int8 quantization")
    quant.add_argument("--int4", action="store_true",
                       help="weight-only int4 quantization (nibble-packed)")
    parser.add_argument("--kv-dtype", default=None,
                        choices=["int8", "int4"],
                        help="quantized KV cache (default: model dtype)")
    parser.add_argument("--weights", default=None,
                        help="HF safetensors file/dir to load real weights "
                             "from (default: random init)")
    parser.add_argument("--neo4j-meta", default=None,
                        help="bolt://host:port for a live metagraph "
                             "(default: canned in-memory fixture)")
    parser.add_argument("--neo4j-state", default=None,
                        help="bolt://host:port for a live stategraph")
    parser.add_argument("--neo4j-auth", default="neo4j:neo4j",
                        help="user:password for live Neo4j")
    parser.add_argument("--fresh-threads", action="store_true",
                        help="start each incident on fresh stage threads "
                             "(re-seeded templates/rules) instead of the "
                             "reference's ever-growing sweep threads — "
                             "recommended for --backend engine sweeps, "
                             "whose max_seq_len is a real KV budget")


def build_service(args, device=None) -> AssistantService:
    """The service of ``--backend``: the scripted oracle, or the engine
    (paged with ``--paged``, else the contiguous-slot engine) on
    ``--weights`` or seeded random weights, on ``device`` (default
    ``--device``).  The engine's byte tokenizer spans the model's
    vocabulary, as the soak engine's does."""
    if args.backend == "oracle":
        return AssistantService(OracleBackend(get_tokenizer()))
    import torch

    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models import llama
    from k8s_llm_rca_tpu_torch.serve.backend import EngineBackend
    from k8s_llm_rca_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device if device is not None else args.device)
    model_cfg = MODEL_REGISTRY.get(args.model, TINY)
    if getattr(args, "weights", None):
        from k8s_llm_rca_tpu_torch.models.loader import load_llama

        params = load_llama(model_cfg, args.weights, dev)
    else:
        params = llama.init_params(
            model_cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if getattr(args, "int8", False) or getattr(args, "int4", False):
        from k8s_llm_rca_tpu_torch.models.quant import quantize_params

        params = quantize_params(
            params, bits=4 if getattr(args, "int4", False) else 8)
    # the CLI default (2048) may exceed a small preset's RoPE table; clamp
    # so `--backend engine` works out of the box for every --model
    max_seq = min(args.max_seq_len, model_cfg.max_seq_len)
    if max_seq < args.max_seq_len:
        log.warning("clamping --max-seq-len %d to %s's model maximum %d",
                    args.max_seq_len, model_cfg.name, max_seq)
    ecfg_kw = dict(max_batch=args.max_batch, max_seq_len=max_seq,
                   paged=getattr(args, "paged", False),
                   kv_cache_dtype=getattr(args, "kv_dtype", None))
    if getattr(args, "decode_chunk", None) is not None:
        ecfg_kw["decode_chunk"] = args.decode_chunk   # else EngineConfig's
    engine = make_engine(model_cfg, EngineConfig(**ecfg_kw), params,
                         get_tokenizer(vocab_size=model_cfg.vocab_size), dev)
    return AssistantService(EngineBackend(engine))


def build_executors(args) -> Tuple[object, object]:
    if args.neo4j_meta or args.neo4j_state:
        from k8s_llm_rca_tpu_torch.graph.executor import Neo4jQueryExecutor

        user, password = args.neo4j_auth.split(":", 1)
        meta = Neo4jQueryExecutor(args.neo4j_meta, user, password)
        state = Neo4jQueryExecutor(args.neo4j_state, user, password)
        return meta, state
    return (InMemoryGraphExecutor(build_metagraph()),
            InMemoryGraphExecutor(build_stategraph()))
