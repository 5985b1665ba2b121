from k8s_llm_rca_tpu_torch.engine.engine import (  # noqa: F401
    InferenceEngine, SequenceResult,
)
from k8s_llm_rca_tpu_torch.engine.sampling import (  # noqa: F401
    SamplingParams, sample_tokens,
)


def make_engine(model_cfg, engine_cfg, params, tokenizer, device=None, **kw):
    """Engine factory on ``device`` (``None`` = the card; raises when no
    CUDA device is present): ``PagedInferenceEngine`` when
    ``engine_cfg.paged`` (page pool, preemption, prefix caching; on the
    card it replays CUDA graphs of its decode step and scans unless
    ``cuda_graphs=False``), else the contiguous-slot ``InferenceEngine``
    (eager).  Both expose the same ``EngineBase`` surface; ``kw`` goes to
    the constructor, so an unsupported keyword raises."""
    if engine_cfg.paged:
        from k8s_llm_rca_tpu_torch.engine.paged import PagedInferenceEngine

        return PagedInferenceEngine(model_cfg, engine_cfg, params, tokenizer,
                                    device, **kw)
    return InferenceEngine(model_cfg, engine_cfg, params, tokenizer, device,
                           **kw)
