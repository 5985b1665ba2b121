"""The fault layer of the port: so far the deterministic clock
(``faults.plan.VirtualClock``) and the plan-free pipelined sweep
(``faults.soak``, imported lazily: it pulls in the RCA pipeline).  Fault
plans, injection and the resilience policy are ROADMAP Queue 1 item 3."""

from k8s_llm_rca_tpu_torch.faults.plan import VirtualClock  # noqa: F401
