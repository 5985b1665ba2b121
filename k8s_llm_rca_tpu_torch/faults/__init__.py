"""Deterministic fault injection and resilience, the port of
``k8s_llm_rca_tpu/faults/``: seeded ``FaultPlan`` schedules and the
``VirtualClock`` (``faults.plan``), arming and the call-site injection
points (``faults.inject``: graph executors, ``EngineBackend``, the engine
tick), the retry, breaker and degradation ladder (``faults.policy``) and
the sweeps (``faults.soak``, imported lazily: it pulls in the RCA
pipeline).  The JAX package's process supervisor and network faults are
not ported (ROADMAP Queue 1 items 4 and 11)."""

from k8s_llm_rca_tpu_torch.faults.plan import (  # noqa: F401
    FAULT_KINDS, Fault, FaultPlan, VirtualClock,
)
from k8s_llm_rca_tpu_torch.faults.inject import (  # noqa: F401
    SITE_BACKEND, SITE_ENGINE_TICK, SITE_GRAPH, SITE_PROCESS,
    InjectedFault, InjectedTimeout, arm, armed, disarm,
)
from k8s_llm_rca_tpu_torch.faults.policy import (  # noqa: F401
    CircuitBreaker, CircuitOpen, ResiliencePolicy, ResilientExecutor,
    RetriesExhausted, RetryPolicy, StageDegradation,
)
