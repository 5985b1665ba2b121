"""In-tree tokenizers (the hermetic byte tokenizer; a copy of the JAX
package's ``ByteTokenizer``, so both packages map text to the same ids)."""

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


def get_tokenizer(spec: Optional[str] = None, vocab_size: int = 512) -> Tokenizer:
    """``spec`` None/"byte" selects the hermetic byte tokenizer.  Local
    HuggingFace tokenizers come with the loading slice (ROADMAP Queue 1
    item 7)."""
    if spec in (None, "byte"):
        return ByteTokenizer(vocab_size=max(vocab_size, 512))
    raise NotImplementedError(
        f"tokenizer {spec!r}: only the byte tokenizer is ported "
        f"(ROADMAP Queue 1 item 7, rerank and loading)")
