"""Profiling and the card-level model: the port of
``k8s_llm_rca_tpu/runtime/profiling.py``.

- ``annotate`` names one region in the torch profiler's timeline, the
  ``METRICS`` timers and the obs span tracer at once, so a region found
  slow in one shows up under the same name in the others.  The timer is
  host time around the dispatch (or the graph replay); nothing here
  synchronizes with the device.
- ``trace(log_dir)`` captures a ``torch.profiler`` trace of the block
  (CPU activity, and the card's kernels where there is one) and writes it
  as a Chrome trace under ``log_dir``: the counterpart of JAX's
  ``jax.profiler`` capture.
- ``device_memory_stats`` reads the caching allocator under JAX's keys.
- The analytic decoder model (``decoder_param_count``,
  ``decode_flops_per_token``, ``decode_bytes_per_token``,
  ``stage_local_cp_vs_tp``) is JAX's arithmetic, line for line; ``mfu``
  and the rooflines divide it by the card's peaks.  The peak tables hold
  the card's row only, keyed by ``torch.cuda.get_device_name`` with the
  longest matching prefix: NVIDIA H100 (SXM data sheet, dense bf16 989
  TFLOP/s, HBM3 3350 GB/s).  Any other device (the CPU included) has no
  entry and gets None, as JAX's do off its table.
- FSDP (reported, not gated; the counterparts of the JAX bench's
  ``fsdp_hbm_params_bytes_per_chip`` and ``fsdp_allgather_ms``):
  ``param_bytes`` of a rank's tree, ``fsdp_gather_bytes`` (what a forward
  gathers) and ``fsdp_gather_link_ms``, the least time a rank receives
  its peers' blocks of those over NVLink.
- Under PP a rank's config (``runtime.sharding.RankModelConfig``) has its
  stage's ``n_layers``, so the model counts the weights and KV of the
  stage's layers plus the whole embedding and head the rank holds: the
  work one rank does.  ``pp_bubble_fraction`` is the GPipe schedule's
  idle share beside it.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import torch

from k8s_llm_rca_tpu_torch.config import ModelConfig
from k8s_llm_rca_tpu_torch.obs import trace as obs_trace
from k8s_llm_rca_tpu_torch.utils.logging import METRICS, get_logger

log = get_logger(__name__)

# bf16 dense peak TFLOP/s per card, for MFU; a device without an entry
# reports None
_PEAK_TFLOPS = {
    "NVIDIA H100": 989.0,
}

# memory bandwidth GB/s per card (same keys): the roofline's memory leg,
# the ceiling of decode at small context
_HBM_GBPS = {
    "NVIDIA H100": 3350.0,
}

# NVLink GB/s each way per card (same keys): H100 SXM data sheet, 900 GB/s
# of NVLink 4 per card in both directions together, 450 each way; the
# floor of an fsdp gather between cards
_NVLINK_GBPS = {
    "NVIDIA H100": 450.0,
}


def _longest_prefix(table: Dict[str, float], kind: str) -> Optional[float]:
    """Longest-prefix device-name lookup (the longest key that prefixes
    ``kind`` wins)."""
    best = None
    for name, val in table.items():
        if kind.startswith(name) and (best is None or len(name) > best[0]):
            best = (len(name), val)
    return best[1] if best else None


def _device_kind(device: Optional[Any] = None) -> str:
    """``torch.cuda.get_device_name`` of ``device`` (``None`` = the
    current card); "" for the CPU or where no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            return ""
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return ""
    return torch.cuda.get_device_name(device)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block and write it to
    ``log_dir`` as a Chrome trace (``trace-<pid>-<ns>.json``, viewable in
    Perfetto or ``chrome://tracing``)::

        with profiling.trace("/tmp/rca-trace"):
            engine.step()

    The card's kernels are recorded where a card is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(log_dir,
                            f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Time the block into the ``name`` phase of ``METRICS`` and record it
    as a ``record_function`` range and an obs span of the same name."""
    with torch.profiler.record_function(name):
        with METRICS.timer(name):
            with obs_trace.span(name, cat="xprof"):
                yield


def _largest_live_block(device: torch.device) -> Optional[int]:
    sizes = [b["size"] for seg in torch.cuda.memory_snapshot()
             if seg.get("device") == device.index
             for b in seg.get("blocks", ())
             if b.get("state") == "active_allocated"]
    return max(sizes) if sizes else None


def device_memory_stats(device: Optional[Any] = None) -> Dict[str, float]:
    """Device memory in bytes under the JAX package's keys:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching allocator's
    allocated bytes, now and at peak), ``bytes_limit`` (the card's total
    memory) and ``largest_alloc_size`` (the largest block allocated now).
    ``device`` None means the card; on the CPU, which reports nothing,
    the result is ``{}``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stats = torch.cuda.memory_stats(dev)
    out = {"bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
           "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak",
                                                0)),
           "bytes_limit": float(torch.cuda.mem_get_info(dev)[1])}
    largest = _largest_live_block(dev)
    if largest is not None:
        out["largest_alloc_size"] = float(largest)
    return out


# ---------------------------------------------------------------------------
# analytic flops / MFU model (decoder)
# ---------------------------------------------------------------------------


def _layer_matmul_weights(cfg: ModelConfig, routed_only: bool) -> float:
    """Matmul weight count of ONE decoder layer (attention, MLP, router);
    ``routed_only`` counts only the top-k routed experts' MLPs of an MoE
    (the per-token active set) instead of all of them."""
    h, q, kv, inter = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                       cfg.intermediate_size)
    w = h * q + 2 * h * kv + q * h                         # qkv + out proj
    if cfg.n_experts > 0:
        w += h * cfg.n_experts                             # router
        n_mlp = cfg.n_experts_per_tok if routed_only else cfg.n_experts
        w += n_mlp * 3 * h * inter                         # expert MLPs
    else:
        w += 3 * h * inter
    return float(w)


def decoder_param_count(cfg: ModelConfig) -> int:
    """Parameter count of the Llama/Mixtral stack (embeddings included)."""
    h = cfg.hidden_size
    per_layer = _layer_matmul_weights(cfg, routed_only=False) + 2 * h  # norms
    total = cfg.n_layers * per_layer
    total += cfg.vocab_size * h                            # embedding
    total += h                                             # final norm
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * h                        # lm_head
    return int(total)


def decode_flops_per_token(cfg: ModelConfig, context_len: int) -> float:
    """FLOPs to decode ONE token at a KV context length: 2 per MAC of the
    routed weights, the attention's q.K and p.V over the context, the
    logits matmul."""
    per_layer = 2.0 * _layer_matmul_weights(cfg, routed_only=True)
    per_layer += 2.0 * 2 * cfg.n_heads * cfg.head_dim * context_len
    total = cfg.n_layers * per_layer
    total += 2.0 * cfg.hidden_size * cfg.vocab_size        # logits matmul
    return total


def mfu(cfg: ModelConfig, tokens_per_sec: float, context_len: int,
        device: Optional[Any] = None) -> Optional[float]:
    """Model FLOPs utilization in [0, 1] against the card's bf16 peak;
    None for a device without a table entry (the CPU)."""
    peak = _longest_prefix(_PEAK_TFLOPS, _device_kind(device))
    if peak is None:
        return None
    flops = decode_flops_per_token(cfg, context_len) * tokens_per_sec
    return flops / (peak * 1e12)


def decode_bytes_per_token(cfg: ModelConfig, context_len: int, batch: int,
                           weight_bits: int = 16, kv_bits: int = 16) -> float:
    """Least memory bytes moved to decode ONE token at a context: every
    routed weight byte once per step (shared by the batch), each
    sequence's KV history and its new entry; scales folded into a 1%
    overhead, as JAX's model does."""
    wbytes = weight_bits / 8.0
    per_layer = _layer_matmul_weights(cfg, routed_only=True)
    weight_per_token = (cfg.n_layers * per_layer
                        + cfg.vocab_size * cfg.hidden_size) * wbytes / batch
    kv_per_token = (cfg.n_layers * 2 * cfg.kv_dim
                    * (context_len + 1) * kv_bits / 8.0)
    return 1.01 * (weight_per_token + kv_per_token)


def stage_local_cp_vs_tp(cfg: ModelConfig, context_len: int, batch: int,
                         n_intra: int, weight_bits: int = 16,
                         kv_bits: int = 16) -> Dict[str, float]:
    """Per-device decode cost of spending ``n_intra`` devices on TP against
    CP: TP divides the matmul terms by ``n_intra`` and the attention/KV
    terms by their head limits (q heads, kv heads); CP divides only the
    attention/KV terms.  Returns per-device per-token {flops,bytes}_{tp,cp}
    and the cp/tp ratios (> 1: CP loses)."""
    f_attn = cfg.n_layers * 2.0 * 2 * cfg.n_heads * cfg.head_dim \
        * context_len
    f_matmul = decode_flops_per_token(cfg, context_len) - f_attn
    kv_per_token = (cfg.n_layers * 2 * cfg.kv_dim
                    * (context_len + 1) * kv_bits / 8.0)
    w_per_token = decode_bytes_per_token(
        cfg, context_len, batch, weight_bits, kv_bits) / 1.01 \
        - kv_per_token
    n_q = min(n_intra, cfg.n_heads)
    n_kv = min(n_intra, cfg.n_kv_heads)
    out = {
        "flops_tp": f_matmul / n_intra + f_attn / n_q,
        "flops_cp": f_matmul + f_attn / n_intra,
        "bytes_tp": w_per_token / n_intra + kv_per_token / n_kv,
        "bytes_cp": w_per_token + kv_per_token / n_intra,
    }
    out["flops_cp_over_tp"] = out["flops_cp"] / out["flops_tp"]
    out["bytes_cp_over_tp"] = out["bytes_cp"] / out["bytes_tp"]
    return out


def roofline_decode_tps(cfg: ModelConfig, context_len: int, batch: int,
                        weight_bits: int = 16, kv_bits: int = 16,
                        device: Optional[Any] = None) -> Optional[float]:
    """The card's ceiling on decode tokens/sec: the lesser of the compute
    roofline (bf16 peak over FLOPs per token) and the memory roofline
    (bandwidth over bytes per token).  None off the table."""
    kind = _device_kind(device)
    peak_tf = _longest_prefix(_PEAK_TFLOPS, kind)
    bw = _longest_prefix(_HBM_GBPS, kind)
    if peak_tf is None or bw is None:
        return None
    compute = peak_tf * 1e12 / decode_flops_per_token(cfg, context_len)
    memory = bw * 1e9 / decode_bytes_per_token(cfg, context_len, batch,
                                               weight_bits, kv_bits)
    return min(compute, memory)


def param_bytes(params) -> int:
    """The bytes of a rank's parameter tree (quantized leaves' codes and
    scales): under FSDP the rank's blocks, the counterpart of the JAX
    bench's ``fsdp_hbm_params_bytes_per_chip``."""
    from k8s_llm_rca_tpu_torch.runtime.rules import flatten_with_names

    total = 0
    for _, leaf in flatten_with_names(params):
        parts = tuple(leaf) if hasattr(leaf, "_fields") else (leaf,)
        total += sum(t.numel() * t.element_size() for t in parts
                     if t is not None)
    return total


# the leaves a forward gathers under FSDP (models/llama.py): every layer's
# matmul weights (MoE: the stacked experts; the router is whole) and the
# head
_GATHERED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def fsdp_gather_bytes(cfg: ModelConfig, params, n_fsdp: int) -> int:
    """The bytes one forward of a rank gathers under FSDP: ``n_fsdp`` times
    the stored codes (int4: packed bytes) or tensor of every gathered leaf
    of the rank's ``params``.  The embedding is looked up per rank, not
    gathered, unless it is the tied head."""
    def codes(w):
        return getattr(w, "q", w)

    leaves = [codes(layer[k]) for layer in params["layers"]
              for k in _GATHERED]
    leaves.append(codes(params["embedding"] if cfg.tie_embeddings
                        else params["lm_head"]))
    return n_fsdp * sum(t.numel() * t.element_size() for t in leaves)


def fsdp_gather_link_ms(gathered_bytes: int, n_fsdp: int,
                        device: Optional[Any] = None) -> Optional[float]:
    """The least ms a rank spends receiving its peers' blocks of
    ``gathered_bytes`` ((n - 1)/n of them) over NVLink at the card's
    rate each way; 0 on one rank, None off the table."""
    link = _longest_prefix(_NVLINK_GBPS, _device_kind(device))
    if link is None:
        return None
    return gathered_bytes * (n_fsdp - 1) / n_fsdp / (link * 1e9) * 1e3


def pp_bubble_fraction(n_stages: int, microbatches: int) -> float:
    """The share of a GPipe forward's M + P - 1 ticks a stage spends idle:
    (P - 1) / (M + P - 1).  Reported beside the rooflines, not gated."""
    return (n_stages - 1) / (microbatches + n_stages - 1)


def roofline_prefill_tps(cfg: ModelConfig, prompt_len: int,
                         device: Optional[Any] = None) -> Optional[float]:
    """The card's ceiling on prefill tokens/sec: the bf16 peak over the
    FLOPs per token at the mean causal context ``prompt_len / 2``.  None
    off the table."""
    peak_tf = _longest_prefix(_PEAK_TFLOPS, _device_kind(device))
    if peak_tf is None:
        return None
    return peak_tf * 1e12 / decode_flops_per_token(cfg, prompt_len // 2)


@dataclass
class StepTimer:
    """Rolling decode-step timing for sweeps: tokens/sec and MFU without a
    profiler attached (host time)."""

    started: float = 0.0
    steps: int = 0
    tokens: int = 0

    def start(self) -> None:
        self.started = time.perf_counter()
        self.steps = 0
        self.tokens = 0

    def tick(self, n_tokens: int) -> None:
        self.steps += 1
        self.tokens += n_tokens

    @property
    def tokens_per_sec(self) -> float:
        dt = time.perf_counter() - self.started
        return self.tokens / dt if dt > 0 else 0.0

    def report(self, cfg: Optional[ModelConfig] = None,
               context_len: int = 512) -> Dict[str, Any]:
        """Steps, tokens and tokens/sec; with ``cfg`` the MFU (None off the
        table); the card's memory as ``hbm_*`` (none on a host without
        one)."""
        out: Dict[str, Any] = {
            "steps": self.steps,
            "tokens": self.tokens,
            "tokens_per_sec": round(self.tokens_per_sec, 2),
        }
        if cfg is not None:
            u = mfu(cfg, self.tokens_per_sec, context_len)
            out["mfu"] = round(u, 4) if u is not None else None
        device = None if torch.cuda.is_available() else "cpu"
        out.update({f"hbm_{k}": v
                    for k, v in device_memory_stats(device).items()})
        return out
