"""Checkpointing of model weights and train state: the port of
``k8s_llm_rca_tpu/utils/checkpoint.py`` in PyTorch's idiom.

- ``save_params`` / ``restore_params``: one-shot save of a param tree
  (nested dicts, lists and tuples of tensors, ``QuantTensor``/
  ``QuantTensor4`` leaves included), e.g. after converting an HF
  checkpoint through ``models/loader.py``, so later runs skip the
  transpose and cast pass;
- ``TrainCheckpointer``: step-numbered train-state checkpoints with
  retention (``max_to_keep``) and ``latest_step``.

The format is the port's own: ``torch.save`` of the tree, read back with
``torch.load(weights_only=True)``, a quantized leaf stored as its int8
bytes and its scales under a tag.  It cannot read the JAX package's orbax
directories, nor they it.  ``like=`` restores every tensor onto the
device and into the dtype of the matching tensor of ``like``; without it
tensors come back on the CPU.  int4 leaves hold nibble-packed bytes in the
split-half layout of ``models/quant.py``, which a restore does not check.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch

from k8s_llm_rca_tpu_torch.models.quant import QuantTensor, QuantTensor4

PyTree = Any

_FILE = "params.pt"
_QUANT_TAG = "__quant__"


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _encode(tree: PyTree) -> PyTree:
    """The tree with every quantized leaf as a tagged dict (``torch.load``
    under ``weights_only`` rebuilds only plain containers and tensors)."""
    if isinstance(tree, (QuantTensor, QuantTensor4)):
        return {_QUANT_TAG: 4 if isinstance(tree, QuantTensor4) else 8,
                "q": tree.q, "scale": tree.scale}
    if isinstance(tree, dict):
        return {k: _encode(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_encode(v) for v in tree)
    return tree


def _decode(tree: PyTree, like: PyTree = None) -> PyTree:
    """Inverse of ``_encode``; tensors follow ``like``'s devices and
    dtypes where it has a matching tensor."""
    if isinstance(tree, dict) and _QUANT_TAG in tree:
        cls = QuantTensor4 if tree[_QUANT_TAG] == 4 else QuantTensor
        return cls(q=_decode(tree["q"], getattr(like, "q", None)),
                   scale=_decode(tree["scale"], getattr(like, "scale", None)))
    if isinstance(tree, dict):
        return {k: _decode(v, like.get(k) if isinstance(like, dict) else None)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        likes = (list(like) if isinstance(like, (list, tuple))
                 and len(like) == len(tree) else [None] * len(tree))
        return type(tree)(_decode(v, lk) for v, lk in zip(tree, likes))
    if isinstance(tree, torch.Tensor) and isinstance(like, torch.Tensor):
        return tree.to(device=like.device, dtype=like.dtype)
    return tree


def _save(path: str, tree: PyTree) -> None:
    """Write ``tree`` to the file ``path`` atomically (a temporary file,
    then a rename)."""
    tmp = path + ".tmp"
    torch.save(_encode(tree), tmp)
    os.replace(tmp, path)


def _load(path: str, like: PyTree = None) -> PyTree:
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return _decode(tree, like)


def save_params(path: str, params: PyTree) -> None:
    """Save a param tree to the directory ``path`` (made if missing)."""
    path = _abs(path)
    os.makedirs(path, exist_ok=True)
    _save(os.path.join(path, _FILE), params)


def restore_params(path: str, like: Optional[PyTree] = None) -> PyTree:
    """Restore a param tree; ``like`` (a matching tree of tensors) places
    each tensor on its device in its dtype, else tensors stay on the
    CPU."""
    return _load(os.path.join(_abs(path), _FILE), like)


class TrainCheckpointer:
    """Step-numbered checkpoints of a train state with retention: step N
    lives in ``<directory>/<N>/``, and a save beyond ``max_to_keep``
    removes the oldest steps.

    Usage:
        ckpt = TrainCheckpointer(dir, max_to_keep=3)
        ckpt.save(step, {"params": params, "opt_state": opt_state})
        state = ckpt.restore(like={"params": params0, "opt_state": opt0})
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep={max_to_keep} must be >= 1")
        self.directory = _abs(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, _FILE)):
                steps.append(int(name))
        return sorted(steps)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: PyTree, wait: bool = True) -> None:
        """Save ``state`` as ``step`` (synchronously: ``wait`` is accepted
        for the JAX signature) and prune to the newest ``max_to_keep``."""
        del wait
        step_dir = os.path.join(self.directory, str(int(step)))
        os.makedirs(step_dir, exist_ok=True)
        _save(os.path.join(step_dir, _FILE), state)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, like: Optional[PyTree] = None,
                step: Optional[int] = None) -> PyTree:
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint steps saved yet")
        return _load(os.path.join(self.directory, str(int(step)), _FILE),
                     like)

    def close(self) -> None:
        """Nothing to release (saves are synchronous)."""
