"""Parallel execution over a device mesh (``runtime/mesh.py``): expert
parallelism (``moe.py``) and context parallelism (``ring_attention.py``,
``ulysses.py``).  Tensor parallelism lives in the model itself
(``models/llama.py`` under a ``runtime.sharding.RankModelConfig``)."""
