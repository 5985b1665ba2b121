"""Configuration layer of the PyTorch port.

A copy of the model, engine, RCA and sweep dataclasses of
``k8s_llm_rca_tpu/config.py``
(the port imports nothing of the JAX package).  Field names, defaults and
the presets are identical, so one configuration drives both packages.
Knobs whose feature this package does not implement yet are still
declared here: the engine refuses them loudly (``NotImplementedError``
naming the ROADMAP item) instead of ignoring them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Decoder-LM architecture config (Llama family; Mixtral via n_experts>0)."""

    name: str = "tiny"
    vocab_size: int = 512
    hidden_size: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 32
    intermediate_size: int = 256
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 1024
    dtype: str = "float32"          # compute/weight dtype ("bfloat16" on the card)
    tie_embeddings: bool = True
    # MoE (0 experts == dense Llama MLP)
    n_experts: int = 0
    n_experts_per_tok: int = 2
    # fused weight-dequant matmul kernels (quantized weights only)
    fused_quant_matmul: bool = False

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


TINY = ModelConfig(name="tiny")

TINY_MOE = ModelConfig(name="tiny_moe", n_experts=4, n_experts_per_tok=2)

TINYLLAMA_1B = ModelConfig(
    name="tinyllama-1.1b",
    vocab_size=32000,
    hidden_size=2048,
    n_layers=22,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    intermediate_size=5632,
    rope_theta=10000.0,
    max_seq_len=2048,
    dtype="bfloat16",
    tie_embeddings=False,
)

LLAMA3_8B = ModelConfig(
    name="llama3-8b",
    vocab_size=128256,
    hidden_size=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    intermediate_size=14336,
    rope_theta=500000.0,
    max_seq_len=8192,
    dtype="bfloat16",
    tie_embeddings=False,
)

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b",
    vocab_size=32000,
    hidden_size=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    intermediate_size=14336,
    rope_theta=1000000.0,
    max_seq_len=8192,
    dtype="bfloat16",
    tie_embeddings=False,
    n_experts=8,
    n_experts_per_tok=2,
)

MODEL_REGISTRY = {
    c.name: c for c in (TINY, TINY_MOE, TINYLLAMA_1B, LLAMA3_8B, MIXTRAL_8X7B)
}


@dataclass(frozen=True)
class EngineConfig:
    """Inference-engine config: batching, KV cache, sampling, limits."""

    max_batch: int = 8                 # decode slots (continuous batching width)
    max_seq_len: int = 1024            # per-slot KV capacity
    prefill_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    max_new_tokens: int = 256
    kv_cache_dtype: Optional[str] = None
    # paged KV cache
    paged: bool = False
    page_size: int = 16
    num_pages: int = 1024
    prefix_cache: bool = True
    # sampling defaults
    temperature: float = 0.0           # 0 == greedy
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # decode loop
    decode_chunk: int = 16             # device steps per host sync in scan mode
    prompt_admission: bool = False
    speculative_k: int = 0
    speculative_ngram: int = 3
    native: bool = True
    host_overlap: bool = False
    prefill_chunk_budget: int = 0
    max_spilled_pages: int = 0
    prefix_host_pages: int = 0
    prefix_disk_dir: Optional[str] = None
    prefix_disk_pages: int = 0
    prefix_hbm_watermark: int = 0
    prefix_store_writethrough: bool = False


@dataclass(frozen=True)
class RCAConfig:
    """Agent-pipeline config (retry budgets mirror the reference's:
    test_all.py:63,99; polling limits common/openai_generic_assistant.py:94-95)."""

    locator_max_attempts: int = 3
    cypher_max_attempts: int = 3
    metapath_max_hops: int = 3
    # per-stage decode budgets (tokens); the locator's must exceed its
    # structured-output schema's minimal document (constrain.SchemaGrammar
    # .min_budget — EngineBackend.start rejects budgets below it)
    locator_max_new_tokens: int = 768
    cypher_max_new_tokens: int = 512
    analyzer_max_new_tokens: int = 512
    srckind_limit: int = 5
    state_limit: int = 10
    # submit all per-entity audit runs before awaiting any (SURVEY §3.4:
    # they are independent until the summary barrier), so the engine
    # decodes them in one continuous batch; False = reference-serial order
    concurrent_audits: bool = True
    run_timeout_s: float = 600.0
    model: str = "tiny"                # serve-side model name
    rerank_top_k: int = 0              # cap audited records when reranking (0 = all)
    # cap the STATE fields entering each audit prompt to the k most
    # relevant by embedding (0 = all 12 reference fields); requires a
    # pipeline reranker — the rerank result then shapes prompt CONTENT,
    # not just record order (BASELINE configs[4])
    rerank_fields_top_k: int = 0
    # start every incident on FRESH stage threads (templates/rules
    # re-seeded).  The reference reuses one monotonically growing thread
    # per assistant across a whole sweep (test_with_file.py loops over
    # setup-once assistants) — viable only against a remote model with
    # effectively unbounded context; with an in-tree engine whose
    # max_seq_len is a real KV budget, long sweeps need re-anchoring.
    # Retry-with-feedback WITHIN an incident still accumulates.
    fresh_threads: bool = False
    # grammar-constrained decode for the three structured stages (plan
    # schema, cypher skeleton, report schema).  False = raw free decode:
    # output validity then rests entirely on the MODEL — the content-
    # validation mode for distilled checkpoints (rca/distill.py), and the
    # reference's own hope-and-retry regime (test_all.py:63-83)
    constrained: bool = True


@dataclass(frozen=True)
class SweepConfig:
    """Batch-driver config (reference: test_with_file.py:42-43,177-198)."""

    input_csv: str = "data/incidents.csv"
    output_json: str = "output/rca-results.json"
    locator_usage_limit: int = 10
    cypher_usage_limit: int = 20
    analyzer_usage_limit: int = 30
