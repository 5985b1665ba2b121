from k8s_llm_rca_tpu_torch.rca.pipeline import (  # noqa: F401
    RCAPipeline, IncidentResult,
)
