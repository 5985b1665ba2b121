"""The native (C++) runtime components: the port of
``k8s_llm_rca_tpu/native/__init__.py``.

``csrc/native.cpp`` (the port's own copy of the repo's ``csrc/native.cpp``)
holds the page allocator and the JSON grammar's automaton and token mask
behind a plain C interface.  ``g++ -O2 -std=c++17 -shared -fPIC`` builds it
at first use (never at import) into ``build/native/lib<name>-<hash>.so``
at the root of the checkout (git-ignored; the hash covers the source and
the flags), through a process-unique temp file and an atomic rename, and
``ctypes`` loads it.  ``NativePageAllocator`` and ``NativeJsonGrammar`` are
drop-in behind the interfaces of ``engine/paged.py::PageAllocator`` and
``engine/constrain.py::JsonGrammar``.

``load_library`` raises when the library cannot be built or loaded (no
``g++``); ``make_allocator`` and ``make_grammar`` catch that, log a
warning and build the Python object instead, so a host without a compiler
still serves.  ``chip_smoke.py`` calls ``load_library`` itself, so a card
machine without ``g++`` fails there instead of being served quietly by
the Python allocator.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from k8s_llm_rca_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
NAME = "k8s_rca_native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None      # why the library failed, once it has

# status codes (csrc/native.cpp)
OK = 0
ERR_OUT_OF_PAGES = 1
ERR_DOUBLE_FREE = 2
ERR_FOREIGN_PAGE = 3
ERR_TRASH_PAGE = 4
ERR_LEAK = 5
ERR_BAD_ARG = 6
ERR_GRAMMAR_VIOLATION = 7


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{NAME}-{digest[:16]}.so"


def build() -> Path:
    """Compile ``csrc/native.cpp`` unless its library is built; returns
    the library's path.  Raises ``RuntimeError`` when ``g++`` is missing
    or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"cannot run {cmd[0]}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed for {SOURCE.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library, building it first if necessary.  A failed build
    or load raises, and raises again on every later call without
    retrying."""
    global _lib, _error
    with _lock:
        if _lib is None:
            if _error is not None:
                raise RuntimeError(_error)
            try:
                lib = ctypes.CDLL(str(build()))
                _configure(lib)
            except (RuntimeError, OSError) as e:
                _error = f"native library unavailable: {e}"
                raise RuntimeError(_error) from e
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (logs why not)."""
    try:
        load_library()
        return True
    except RuntimeError as e:
        log.warning("%s", e)
        return False


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.pagealloc_create.restype = c.c_void_p
    lib.pagealloc_create.argtypes = [c.c_int32]
    lib.pagealloc_destroy.argtypes = [c.c_void_p]
    lib.pagealloc_n_free.restype = c.c_int32
    lib.pagealloc_n_free.argtypes = [c.c_void_p]
    lib.pagealloc_alloc.restype = c.c_int32
    lib.pagealloc_alloc.argtypes = [c.c_void_p, c.c_int32, c.c_int64,
                                    c.POINTER(c.c_int32)]
    lib.pagealloc_free.restype = c.c_int32
    lib.pagealloc_free.argtypes = [c.c_void_p, c.POINTER(c.c_int32),
                                   c.c_int32, c.c_int64]
    lib.pagealloc_transfer.restype = c.c_int32
    lib.pagealloc_transfer.argtypes = [c.c_void_p, c.POINTER(c.c_int32),
                                       c.c_int32, c.c_int64, c.c_int64]
    lib.pagealloc_pages_of.restype = c.c_int32
    lib.pagealloc_pages_of.argtypes = [c.c_void_p, c.c_int64,
                                       c.POINTER(c.c_int32), c.c_int32]
    lib.pagealloc_check.restype = c.c_int32
    lib.pagealloc_check.argtypes = [c.c_void_p]

    lib.jsongram_create.restype = c.c_void_p
    lib.jsongram_destroy.argtypes = [c.c_void_p]
    lib.jsongram_set_vocab.restype = c.c_int32
    lib.jsongram_set_vocab.argtypes = [c.c_void_p, c.c_char_p,
                                       c.POINTER(c.c_int32), c.c_int32]
    lib.jsongram_complete.restype = c.c_int32
    lib.jsongram_complete.argtypes = [c.c_void_p]
    lib.jsongram_can_terminate.restype = c.c_int32
    lib.jsongram_can_terminate.argtypes = [c.c_void_p]
    lib.jsongram_mask.restype = c.c_int32
    lib.jsongram_mask.argtypes = [c.c_void_p, c.POINTER(c.c_uint8)]
    lib.jsongram_advance_token.restype = c.c_int32
    lib.jsongram_advance_token.argtypes = [c.c_void_p, c.c_int32]
    lib.jsongram_accept_char.restype = c.c_int32
    lib.jsongram_accept_char.argtypes = [c.c_void_p, c.c_char]
    lib.jsongram_minimal_completion.restype = c.c_int32
    lib.jsongram_minimal_completion.argtypes = [c.c_void_p, c.c_char_p,
                                                c.c_int32]



class NativePageAllocator:
    """Drop-in for ``engine/paged.py::PageAllocator`` backed by
    ``csrc/native.cpp``: the same exception types on the same violations
    (its free-list order differs; the page ids it hands out do not change
    a token)."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self._lib = lib = load_library()
        self.n_pages = n_pages
        self._h = lib.pagealloc_create(np.int32(n_pages))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pagealloc_destroy(h)
            self._h = None

    def _raise(self, status: int) -> None:
        from k8s_llm_rca_tpu_torch.engine.paged import AllocatorError, OutOfPages

        if status == ERR_OUT_OF_PAGES:
            raise OutOfPages(f"pool exhausted ({self.n_free} free)")
        messages = {
            ERR_DOUBLE_FREE: "double free",
            ERR_FOREIGN_PAGE: "page owned by another sequence",
            ERR_TRASH_PAGE: "attempt to free the trash page",
            ERR_LEAK: "leaked or aliased pages",
            ERR_BAD_ARG: "bad argument",
        }
        raise AllocatorError(messages.get(status, f"status {status}"))

    @property
    def n_free(self) -> int:
        return int(self._lib.pagealloc_n_free(self._h))

    def pages_of(self, owner: int) -> List[int]:
        cap = self.n_pages
        out = (ctypes.c_int32 * cap)()
        n = self._lib.pagealloc_pages_of(self._h, np.int64(owner), out, cap)
        return sorted(out[i] for i in range(min(n, cap)))

    def alloc(self, n: int, owner: int) -> List[int]:
        out = (ctypes.c_int32 * max(n, 1))()
        status = self._lib.pagealloc_alloc(self._h, np.int32(n),
                                           np.int64(owner), out)
        if status != OK:
            self._raise(status)
        return [out[i] for i in range(n)]

    def free(self, pages: Sequence[int], owner: int) -> None:
        arr = (ctypes.c_int32 * max(len(pages), 1))(*pages)
        status = self._lib.pagealloc_free(self._h, arr,
                                          np.int32(len(pages)),
                                          np.int64(owner))
        if status != OK:
            self._raise(status)

    def transfer(self, pages: Sequence[int], from_owner: int,
                 to_owner: int) -> None:
        arr = (ctypes.c_int32 * max(len(pages), 1))(*pages)
        status = self._lib.pagealloc_transfer(
            self._h, arr, np.int32(len(pages)), np.int64(from_owner),
            np.int64(to_owner))
        if status != OK:
            self._raise(status)

    def check(self) -> None:
        status = self._lib.pagealloc_check(self._h)
        if status != OK:
            self._raise(status)


class NativeJsonGrammar:
    """Drop-in for ``engine/constrain.py::JsonGrammar`` with the automaton,
    the mask computation and the minimal completion in C++ (mask for mask
    equal to the Python grammar)."""

    def __init__(self, tokenizer):
        from k8s_llm_rca_tpu_torch.engine import constrain

        self._lib = lib = load_library()
        self.tokenizer = tokenizer
        self.eos_id = tokenizer.eos_id
        self._h = lib.jsongram_create()
        strings = constrain._token_strings(tokenizer)
        # flattened vocab buffer, cached on the tokenizer: grammars are
        # built once per serve request, so the O(V) encode must not repeat
        cached = getattr(tokenizer, "_native_vocab_cache", None)
        if cached is None:
            encoded = [s.encode("utf-8", errors="replace") for s in strings]
            buf = b"".join(encoded)
            offsets = np.zeros((len(strings) + 1,), np.int32)
            np.cumsum([len(e) for e in encoded], out=offsets[1:])
            cached = (buf, offsets)
            tokenizer._native_vocab_cache = cached
        buf, offsets = cached
        self._offsets = offsets            # keep alive for the C side setup
        status = lib.jsongram_set_vocab(
            self._h, buf, offsets.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)), np.int32(len(strings)))
        if status != OK:
            raise RuntimeError(f"set_vocab failed: {status}")
        self._strings = strings
        self._mask_buf = np.zeros((len(strings),), np.uint8)
        # force-close bookkeeping mirrors the Python grammar
        self._char_token: Dict[str, int] = {}
        max_chars = 1
        for t, s in enumerate(strings):
            if len(s) == 1 and s not in self._char_token:
                self._char_token[s] = t
            max_chars = max(max_chars, len(s))
        self._close_margin = 2 + 4 * (max_chars - 1)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.jsongram_destroy(h)
            self._h = None

    @property
    def done(self) -> bool:
        return bool(self._lib.jsongram_complete(self._h))

    def minimal_completion(self) -> str:
        out = ctypes.create_string_buffer(4096)
        n = self._lib.jsongram_minimal_completion(self._h, out, 4096)
        if n < 0:
            raise RuntimeError("minimal completion overflow")
        return out.raw[:n].decode()

    def constraint(self, remaining: Optional[int] = None):
        from k8s_llm_rca_tpu_torch.engine.constrain import Constraint

        if self.done:
            return Constraint(force=self.eos_id)
        if remaining is not None:
            completion = self.minimal_completion()
            if remaining <= len(completion) + self._close_margin:
                if not completion:
                    return Constraint(force=self.eos_id)
                forced = self._char_token.get(completion[0])
                if forced is None:
                    if bool(self._lib.jsongram_can_terminate(self._h)):
                        return Constraint(force=self.eos_id)
                    forced = self.tokenizer.encode(completion[0])[0]
                return Constraint(force=forced)
        n_allowed = self._lib.jsongram_mask(
            self._h, self._mask_buf.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)))
        allow = self._mask_buf.astype(bool)   # fresh array each call
        if bool(self._lib.jsongram_can_terminate(self._h)):
            allow[self.eos_id] = True
            n_allowed += 1
        if n_allowed == 0:
            return Constraint(force=self.eos_id)
        return Constraint(allow=allow)

    def advance(self, token: int) -> None:
        if token == self.eos_id:
            return
        status = self._lib.jsongram_advance_token(self._h, np.int32(token))
        if status != OK:
            raise ValueError(
                f"token {token} ({self._strings[token]!r}) violates the "
                f"JSON grammar")
