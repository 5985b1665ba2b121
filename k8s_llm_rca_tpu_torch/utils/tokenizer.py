"""In-tree tokenizers: the port of ``k8s_llm_rca_tpu/utils/tokenizer.py``.

- ``ByteTokenizer``: hermetic UTF-8 byte tokenizer (256 byte ids +
  specials, vocab padded to 512), the JAX package's ids for the same text.
- ``BPETokenizer``: trainable byte-level BPE over ``tokenizers``
  (specials ``<pad>`` 0, ``<s>`` 1, ``</s>`` 2).
- ``HFTokenizer``: a HuggingFace tokenizer from a *local* path through
  ``transformers`` (``local_files_only``: never downloads).

The two library tokenizers import their package when built; where it is
missing they raise ``ImportError`` naming it, and nothing falls back to
the byte tokenizer.
"""

from __future__ import annotations

from typing import List, Optional, Protocol


class Tokenizer(Protocol):
    vocab_size: int
    pad_id: int
    bos_id: int
    eos_id: int

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]: ...
    def decode(self, ids: List[int]) -> str: ...
    def count(self, text: str) -> int: ...


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0..255 are raw bytes; specials follow."""

    def __init__(self, vocab_size: int = 512):
        if vocab_size < 259:
            raise ValueError("need 256 bytes + pad/bos/eos")
        self.vocab_size = vocab_size
        self.pad_id = 256
        self.bos_id = 257
        self.eos_id = 258

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: List[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def count(self, text: str) -> int:
        return len(self.encode(text))


def _require(module: str, what: str):
    """Import ``module`` or raise ``ImportError`` naming the package."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{what} needs the {module.split('.')[0]!r} package, which is "
            f"not installed here") from e


class BPETokenizer:
    """Trainable byte-level BPE (train on any local corpus, no network).
    The byte-level alphabet encodes every string (no unk); specials are
    ``<pad>`` 0, ``<s>`` 1, ``</s>`` 2."""

    def __init__(self, tok, vocab_size: int):
        self._tok = tok
        self.vocab_size = vocab_size
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = 2

    @classmethod
    def train(cls, corpus, vocab_size: int = 2048) -> "BPETokenizer":
        tk = _require("tokenizers", "BPETokenizer")
        tok = tk.Tokenizer(tk.models.BPE(unk_token=None))
        tok.pre_tokenizer = tk.pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = tk.decoders.ByteLevel()
        trainer = tk.trainers.BpeTrainer(
            vocab_size=vocab_size,
            special_tokens=["<pad>", "<s>", "</s>"],
            initial_alphabet=tk.pre_tokenizers.ByteLevel.alphabet())
        tok.train_from_iterator(list(corpus), trainer)
        # the trained size (a small corpus can run out of merges below the
        # requested size); load() reports the same
        return cls(tok, tok.get_vocab_size())

    def save(self, path: str) -> None:
        self._tok.save(path)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        tk = _require("tokenizers", "BPETokenizer")
        tok = tk.Tokenizer.from_file(path)
        return cls(tok, tok.get_vocab_size())

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = self._tok.encode(text).ids
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: List[int]) -> str:
        specials = {self.pad_id, self.bos_id, self.eos_id}
        return self._tok.decode([i for i in ids if i not in specials])

    def count(self, text: str) -> int:
        return len(self.encode(text))


class HFTokenizer:
    """A HuggingFace tokenizer loaded from a local directory."""

    def __init__(self, path: str):
        tf = _require("transformers", "HFTokenizer")
        self._tok = tf.AutoTokenizer.from_pretrained(path,
                                                     local_files_only=True)
        self.vocab_size = len(self._tok)
        # `is None`, not `or`: id 0 is a real token id (BERT-family pads)
        t = self._tok
        self.bos_id = 1 if t.bos_token_id is None else t.bos_token_id
        self.eos_id = 2 if t.eos_token_id is None else t.eos_token_id
        self.pad_id = self.eos_id if t.pad_token_id is None else t.pad_token_id

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: List[int]) -> str:
        specials = {self.pad_id, self.bos_id, self.eos_id}
        return self._tok.decode([i for i in ids if i not in specials])

    def count(self, text: str) -> int:
        return len(self.encode(text))


def get_tokenizer(spec: Optional[str] = None, vocab_size: int = 512) -> Tokenizer:
    """``spec`` None/"byte" selects the hermetic byte tokenizer; anything
    else is a local HuggingFace tokenizer directory."""
    if spec in (None, "byte"):
        return ByteTokenizer(vocab_size=max(vocab_size, 512))
    return HFTokenizer(spec)
