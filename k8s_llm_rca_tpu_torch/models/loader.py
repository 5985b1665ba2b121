"""Checkpoint loading: HF safetensors -> the port's param trees; the port
of ``k8s_llm_rca_tpu/models/loader.py``.

Maps HuggingFace checkpoints (TinyLlama-1.1B, Llama-3-8B, Mixtral-8x7B,
e5-large) onto the trees of ``models/llama.py`` and ``models/encoder.py``.

The safetensors codec is self-contained (an 8-byte little-endian header
length, a JSON header with dtype/shape/data_offsets per tensor, then one
flat byte buffer) and needs neither the ``safetensors`` package nor
``ml_dtypes``: bf16 travels as its 16-bit pattern.  A file written here is
byte for byte the JAX writer's for the same tensors.  Sharded checkpoints
load through ``model.safetensors.index.json``.

Conventions:
- HF ``nn.Linear`` stores weight as [out, in]; the matmuls are ``x @ W``
  with W [in, out], so every projection transposes on load, into a
  contiguous tensor (the int8/int4 kernels' TMA alignment check refuses
  strided views).
- HF Llama checkpoints use the rotate-half (NeoX) rotary layout, which is
  ``ops/rope.py``'s: q/k load untransformed.
- Every tensor casts to ``cfg.dtype`` and moves to ``device`` (``None`` =
  the card) as it is mapped, and leaves the host dict as it goes, so the
  host copy and the device copy of a model never coexist.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from k8s_llm_rca_tpu_torch.config import EncoderConfig, ModelConfig
from k8s_llm_rca_tpu_torch.models.llama import (
    _tensor_from_numpy, torch_dtype,
)
from k8s_llm_rca_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------------------
# safetensors file format
# ---------------------------------------------------------------------------


def _host(t) -> torch.Tensor:
    """A CPU contiguous tensor of ``t`` (a tensor, or a numpy array, bf16
    ones from ``ml_dtypes`` included)."""
    if not isinstance(t, torch.Tensor):
        t = _tensor_from_numpy(t, "cpu", None)
    return t.detach().cpu().contiguous()


def _bytes_view(t: torch.Tensor) -> memoryview:
    """The raw bytes of a CPU contiguous tensor, without a copy."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read one .safetensors file into name -> CPU tensor.  Each tensor is
    read straight into its own storage, so the file is never held twice."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        base = 8 + header_len
        for name, info in header.items():
            if name == "__metadata__":
                continue
            start, end = info["data_offsets"]
            raw = torch.empty((end - start,), dtype=torch.uint8)
            f.seek(base + start)
            if f.readinto(raw.numpy()) != end - start:
                raise ValueError(f"{path}: tensor {name!r} is truncated")
            out[name] = raw.view(_DTYPES[info["dtype"]]).reshape(
                info["shape"])
    return out


# numpy carriers of each file dtype (bf16 rides as its 16-bit pattern)
_NP = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
       "BF16": np.int16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
       "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


class LazyTensor:
    """One tensor of a .safetensors file, read on demand: ``block(parts)``
    maps the file and copies only the block (``parts`` as
    ``runtime.sharding.dim_parts`` gives them; ``()`` = all of it)."""

    def __init__(self, path: str, offset: int, dtype: str, shape):
        self.path, self.offset, self.dtype = path, offset, dtype
        self.shape = tuple(shape)

    def block(self, parts) -> torch.Tensor:
        if 0 in self.shape:
            return torch.empty(self.shape, dtype=_DTYPES[self.dtype])
        idx = []
        for d, (n, i) in enumerate(parts):
            if self.shape[d] % n:
                raise ValueError(f"dimension {d} of {self.shape} does not "
                                 f"split into {n} equal parts")
            size = self.shape[d] // n
            idx.append(slice(i * size, (i + 1) * size))
        mm = np.memmap(self.path, dtype=_NP[self.dtype], mode="r",
                       offset=self.offset, shape=self.shape)
        # only the block's pages of the file are read
        out = torch.from_numpy(np.array(mm[tuple(idx)]))
        del mm
        return out.view(_DTYPES[self.dtype])


def read_safetensors_lazy(path: str) -> Dict[str, LazyTensor]:
    """The tensors of one .safetensors file as ``LazyTensor``s (the header
    only is read)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
    base = 8 + header_len
    return {name: LazyTensor(path, base + info["data_offsets"][0],
                             info["dtype"], info["shape"])
            for name, info in header.items() if name != "__metadata__"}


def write_safetensors(path: str, tensors: Dict[str, Any]) -> None:
    """Write name -> tensor (or numpy array) as a .safetensors file, the
    JAX writer's bytes for the same values."""
    header: Dict[str, Any] = {}
    hosts: List[torch.Tensor] = []
    offset = 0
    for name, t in tensors.items():
        t = _host(t)
        n = t.numel() * t.element_size()
        header[name] = {
            "dtype": _DTYPE_NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + n],
        }
        hosts.append(t)
        offset += n
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in hosts:
            if t.numel():
                f.write(_bytes_view(t))


def write_sharded_safetensors(directory: str, tensors: Dict[str, Any],
                              n_shards: int) -> List[str]:
    """Write ``tensors`` as an HF sharded checkpoint dir: ``n_shards``
    files of about equal bytes (tensors kept whole, in order) and the
    ``model.safetensors.index.json`` that maps each name to its file.
    Returns the shard paths."""
    os.makedirs(directory, exist_ok=True)
    names = list(tensors)
    sizes = [t.numel() * t.element_size() if isinstance(t, torch.Tensor)
             else np.asarray(t).nbytes
             for t in (tensors[k] for k in names)]
    total = sum(sizes)
    groups: List[List[str]] = [[] for _ in range(n_shards)]
    acc = 0
    for name, size in zip(names, sizes):
        idx = min(n_shards - 1, acc * n_shards // max(total, 1))
        groups[idx].append(name)
        acc += size
    weight_map, paths = {}, []
    for i, group in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"
        paths.append(os.path.join(directory, fname))
        write_safetensors(paths[-1], {k: tensors[k] for k in group})
        weight_map.update({k: fname for k in group})
    with open(os.path.join(directory, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return paths


def load_checkpoint_tensors(path: str, lazy: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """Load a checkpoint: a single .safetensors file, or an HF model dir
    (one ``model.safetensors`` or shards named by
    ``model.safetensors.index.json``).  ``lazy``: ``LazyTensor``s that read
    their data on demand."""
    reader = read_safetensors_lazy if lazy else read_safetensors
    if os.path.isfile(path):
        return reader(path)
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map: Dict[str, str] = json.load(f)["weight_map"]
        tensors: Dict[str, torch.Tensor] = {}
        for shard in sorted(set(weight_map.values())):
            tensors.update(reader(os.path.join(path, shard)))
        return tensors
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        return reader(single)
    raise FileNotFoundError(f"no safetensors checkpoint under {path}")


# ---------------------------------------------------------------------------
# HF name mapping
# ---------------------------------------------------------------------------


def _get(tensors: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    if name not in tensors:
        raise KeyError(
            f"checkpoint is missing {name!r} "
            f"(has {len(tensors)} tensors, e.g. {sorted(tensors)[:4]})")
    return tensors[name]


def _take(tensors: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """``_get`` and drop: the host dict shrinks as the device tree grows."""
    t = _get(tensors, name)
    del tensors[name]
    return t


def _cast(t: torch.Tensor, dtype: torch.dtype, device: torch.device,
          transpose: bool = False) -> torch.Tensor:
    """Move to ``device`` in ``dtype``; ``transpose`` swaps the last two
    axes into a contiguous tensor (on the device: a host transpose of an
    8B projection is slower than the copy)."""
    t = _host(t).to(device=device).to(dtype)
    return t.transpose(-2, -1).contiguous() if transpose else t


class _Block:
    """Reads this rank's block of each checkpoint tensor: ``specs`` the
    port tree's PartitionSpecs (``runtime/rules.py``), ``mesh`` the rank's
    mesh.  A checkpoint tensor lazily mapped from its file
    (``LazyTensor``) reads only the rows its block covers."""

    def __init__(self, specs, mesh):
        from k8s_llm_rca_tpu_torch.runtime.rules import flatten_with_names

        self.specs = dict(flatten_with_names(specs))
        self.mesh = mesh

    def parts(self, path: str):
        from k8s_llm_rca_tpu_torch.runtime.sharding import dim_parts

        if path not in self.specs:
            raise ValueError(f"no partition rule matches param '{path}'")
        return dim_parts(self.specs[path], self.mesh)

    @staticmethod
    def read(t, parts) -> torch.Tensor:
        """``parts`` of ``t`` (in the file's layout) as a CPU tensor."""
        from k8s_llm_rca_tpu_torch.runtime.sharding import local_block

        if isinstance(t, LazyTensor):
            return t.block(parts)
        return local_block(_host(t), parts).contiguous()


def _full(t) -> torch.Tensor:
    return t.block(()) if isinstance(t, LazyTensor) else _host(t)


def llama_params_from_hf(cfg: ModelConfig, tensors: Dict[str, Any],
                         device=None, block: Optional[_Block] = None
                         ) -> Params:
    """Map an HF Llama/TinyLlama/Mixtral state dict onto
    ``models/llama.py``'s tree on ``device`` (Mixtral when
    ``cfg.n_experts > 0``).  Tensors leave ``tensors`` as they are mapped.
    With ``block`` every leaf is this rank's block of it (``load_llama``
    with a mesh)."""
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    if cfg.tie_embeddings and "lm_head.weight" in tensors:
        embed = tensors.get("model.embed_tokens.weight")
        if embed is None or not torch.equal(_full(tensors["lm_head.weight"]),
                                            _full(embed)):
            raise ValueError(
                "checkpoint has a distinct lm_head.weight but the config "
                "ties embeddings — loading would silently discard the "
                "output head; use a config with tie_embeddings=False")

    def take(name: str, path: str, transpose: bool = False,
             parts=None, keep: bool = False) -> torch.Tensor:
        t = _get(tensors, name) if keep else _take(tensors, name)
        if block is not None:
            parts = block.parts(path) if parts is None else parts
            # the file holds [out, in]: its parts are the port's reversed
            t = block.read(t, parts[::-1] if transpose else parts)
        return _cast(t, dt, device, transpose)

    def experts(names: List[str], path: str) -> torch.Tensor:
        """The stacked [E, ., .] leaf from one file tensor per expert: this
        rank's experts only, each its block."""
        if block is None:
            return torch.stack([take(n, path, True) for n in names])
        (n_e, i_e), *rest = block.parts(path)
        per = len(names) // n_e
        mine = set(range(i_e * per, (i_e + 1) * per))
        out = []
        for e, name in enumerate(names):
            if e in mine:
                out.append(take(name, path, True, parts=tuple(rest)))
            else:
                del tensors[name]
        return torch.stack(out)

    layers: List[Params] = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        q = f"layers/{i}/"
        layer: Params = {
            "attn_norm": take(p + "input_layernorm.weight", q + "attn_norm"),
            "mlp_norm": take(p + "post_attention_layernorm.weight",
                             q + "mlp_norm"),
            "wq": take(p + "self_attn.q_proj.weight", q + "wq", True),
            "wk": take(p + "self_attn.k_proj.weight", q + "wk", True),
            "wv": take(p + "self_attn.v_proj.weight", q + "wv", True),
            "wo": take(p + "self_attn.o_proj.weight", q + "wo", True),
        }
        if cfg.n_experts > 0:
            moe = p + "block_sparse_moe."
            layer["router"] = take(moe + "gate.weight", q + "router", True)
            names = [f"{moe}experts.{e}." for e in range(cfg.n_experts)]
            # w1 gate [H, I], w2 down [I, H], w3 up [H, I] after transpose
            layer["w_gate"] = experts([n + "w1.weight" for n in names],
                                      q + "w_gate")
            layer["w_down"] = experts([n + "w2.weight" for n in names],
                                      q + "w_down")
            layer["w_up"] = experts([n + "w3.weight" for n in names],
                                    q + "w_up")
        else:
            layer["w_gate"] = take(p + "mlp.gate_proj.weight", q + "w_gate",
                                   True)
            layer["w_up"] = take(p + "mlp.up_proj.weight", q + "w_up", True)
            layer["w_down"] = take(p + "mlp.down_proj.weight", q + "w_down",
                                   True)
        layers.append(layer)

    params: Params = {
        "final_norm": take("model.norm.weight", "final_norm", keep=True),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        # tied checkpoints (some TinyLlama exports) omit lm_head
        if "lm_head.weight" in tensors:
            params["lm_head"] = take("lm_head.weight", "lm_head")
        else:
            params["lm_head"] = take("model.embed_tokens.weight", "lm_head",
                                     keep=True)
    params["embedding"] = take("model.embed_tokens.weight", "embedding")
    return params


def encoder_params_from_hf(cfg: EncoderConfig, tensors: Dict[str, Any],
                           device=None, block: Optional[_Block] = None
                           ) -> Params:
    """Map an HF BERT-family (e5) state dict onto ``models/encoder.py``'s
    tree on ``device``; with ``block`` each leaf is this rank's block."""
    device = resolve_device(device)
    # some exports nest everything under a "bert." module prefix
    if ("embeddings.word_embeddings.weight" not in tensors
            and "bert.embeddings.word_embeddings.weight" in tensors):
        tensors = {k[len("bert."):]: v for k, v in tensors.items()
                   if k.startswith("bert.")}
    dt = torch_dtype(cfg.dtype)

    def take(name: str, path: str, transpose: bool = False) -> torch.Tensor:
        t = _take(tensors, name)
        if block is not None:
            parts = block.parts(path)
            t = block.read(t, parts[::-1] if transpose else parts)
        return _cast(t, dt, device, transpose)

    layers: List[Params] = []
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}."
        q = f"layers/{i}/"
        names = (("wq", "attention.self.query.weight", True),
                 ("bq", "attention.self.query.bias", False),
                 ("wk", "attention.self.key.weight", True),
                 ("bk", "attention.self.key.bias", False),
                 ("wv", "attention.self.value.weight", True),
                 ("bv", "attention.self.value.bias", False),
                 ("wo", "attention.output.dense.weight", True),
                 ("bo", "attention.output.dense.bias", False),
                 ("attn_ln_w", "attention.output.LayerNorm.weight", False),
                 ("attn_ln_b", "attention.output.LayerNorm.bias", False),
                 ("w_in", "intermediate.dense.weight", True),
                 ("b_in", "intermediate.dense.bias", False),
                 ("w_out", "output.dense.weight", True),
                 ("b_out", "output.dense.bias", False),
                 ("mlp_ln_w", "output.LayerNorm.weight", False),
                 ("mlp_ln_b", "output.LayerNorm.bias", False))
        layers.append({key: take(p + hf, q + key, tr)
                       for key, hf, tr in names})
    return {
        "word_embedding": take("embeddings.word_embeddings.weight",
                               "word_embedding"),
        "position_embedding": take("embeddings.position_embeddings.weight",
                                   "position_embedding"),
        "type_embedding": take("embeddings.token_type_embeddings.weight",
                               "type_embedding"),
        "embed_ln_w": take("embeddings.LayerNorm.weight", "embed_ln_w"),
        "embed_ln_b": take("embeddings.LayerNorm.bias", "embed_ln_b"),
        "layers": layers,
    }


def llama_params_to_hf(cfg: ModelConfig, params: Params
                       ) -> Dict[str, torch.Tensor]:
    """Inverse of ``llama_params_from_hf`` (dense Llama): the port's tree
    -> an HF-named state dict of contiguous CPU tensors in ``cfg.dtype``
    (transposed on the tree's device), which ``write_safetensors`` and
    ``load_llama`` take."""
    if cfg.n_experts > 0:
        raise NotImplementedError("dense Llama export only")
    dt = torch_dtype(cfg.dtype)

    def host(x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        x = x.detach().to(dt)
        if transpose:
            x = x.transpose(-2, -1)
        return x.contiguous().cpu()

    out: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": host(params["embedding"]),
        "model.norm.weight": host(params["final_norm"]),
    }
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = host(params["lm_head"])
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = host(layer["attn_norm"])
        out[p + "post_attention_layernorm.weight"] = host(layer["mlp_norm"])
        out[p + "self_attn.q_proj.weight"] = host(layer["wq"], True)
        out[p + "self_attn.k_proj.weight"] = host(layer["wk"], True)
        out[p + "self_attn.v_proj.weight"] = host(layer["wv"], True)
        out[p + "self_attn.o_proj.weight"] = host(layer["wo"], True)
        out[p + "mlp.gate_proj.weight"] = host(layer["w_gate"], True)
        out[p + "mlp.up_proj.weight"] = host(layer["w_up"], True)
        out[p + "mlp.down_proj.weight"] = host(layer["w_down"], True)
    return out


def load_llama(cfg: ModelConfig, path: str, device=None,
               mesh: Optional[Any] = None,
               layout: Optional[Any] = None) -> Params:
    """Load a Llama/Mixtral-family checkpoint file or dir onto ``device``
    (``None`` = the card).  With ``mesh`` the result is THIS rank's shard
    under ``runtime.rules.llama_rules(cfg, layout)`` (the tree
    ``runtime.sharding.shard_params`` gives), and each rank reads only the
    rows of the files its blocks cover (the files are mapped, not read
    whole)."""
    device = resolve_device(device)
    if mesh is None:
        return llama_params_from_hf(cfg, load_checkpoint_tensors(path),
                                    device)
    from k8s_llm_rca_tpu_torch.runtime.rules import (
        llama_param_template, llama_rules, match_partition_rules,
    )

    specs = match_partition_rules(llama_rules(cfg, layout),
                                  llama_param_template(cfg), table="llama")
    return llama_params_from_hf(cfg, load_checkpoint_tensors(path, lazy=True),
                                device, _Block(specs, mesh))


def load_encoder(cfg: EncoderConfig, path: str, device=None,
                 mesh: Optional[Any] = None,
                 layout: Optional[Any] = None) -> Params:
    """Load a BERT/e5-family checkpoint file or dir onto ``device``; with
    ``mesh`` THIS rank's shard under ``runtime.rules.encoder_rules``."""
    device = resolve_device(device)
    if mesh is None:
        return encoder_params_from_hf(cfg, load_checkpoint_tensors(path),
                                      device)
    from k8s_llm_rca_tpu_torch.runtime.rules import (
        encoder_param_template, encoder_rules, match_partition_rules,
    )

    specs = match_partition_rules(encoder_rules(cfg, layout),
                                  encoder_param_template(cfg),
                                  table="encoder")
    return encoder_params_from_hf(cfg,
                                  load_checkpoint_tensors(path, lazy=True),
                                  device, _Block(specs, mesh))
