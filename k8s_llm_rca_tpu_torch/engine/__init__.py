from k8s_llm_rca_tpu_torch.engine.engine import SequenceResult  # noqa: F401
from k8s_llm_rca_tpu_torch.engine.sampling import (  # noqa: F401
    SamplingParams, sample_tokens,
)


def make_engine(model_cfg, engine_cfg, params, tokenizer, device=None, **kw):
    """Engine factory: the paged engine on ``device`` (``None`` = the card;
    raises when no CUDA device is present).  The contiguous-slot engine is
    not ported yet."""
    if not engine_cfg.paged:
        raise NotImplementedError(
            "the contiguous-slot engine (EngineConfig.paged=False) is not "
            "ported yet (ROADMAP Queue 1 item 9); set paged=True")
    from k8s_llm_rca_tpu_torch.engine.paged import PagedInferenceEngine

    return PagedInferenceEngine(model_cfg, engine_cfg, params, tokenizer,
                                device, **kw)
