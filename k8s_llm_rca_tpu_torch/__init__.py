"""k8s_llm_rca_tpu_torch: the PyTorch/CUDA port of ``k8s_llm_rca_tpu``.

A second package beside the JAX one, for an NVIDIA H100.  It mirrors the
JAX package's layout (``ops/``, ``models/``, ``engine/``, ``serve/``,
``utils/``, ``obs/``) and keeps its layouts at every public function, so
the tests feed the same arrays to both.  Every Pallas kernel on the ported
path is a hand-written CUDA kernel under ``csrc/``, built at first use;
CPU tensors take each kernel's plain PyTorch version.  The port imports
nothing of the JAX package.
"""

__version__ = "0.1.0"
