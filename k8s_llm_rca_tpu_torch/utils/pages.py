"""Host page records: the port of ``k8s_llm_rca_tpu/utils/pages.py``, the
one definition of the page gather, the in-place restore and the suffix
bucket that KV spill (``engine/paged.py``) and the prefix store
(``engine/prefix.py``) share.

A *page record* is the host image of pool pages: ``{"n_pages": n, "k":
[L, n, page, kv], "v": ..., ["k_scale": [L, n, page], "v_scale": ...]}``.
Its arrays are CPU tensors in the pool's dtype (bf16 included: numpy has
no bf16 without ``ml_dtypes``, and the card's machine has none).

- ``gather_pages`` selects the pages with one ``index_select`` per pool
  field and brings them to the host in ONE sync (``fetch``, the engine's
  ``_fetch_host``: on the card one pinned buffer, non-blocking copies on
  the current stream, one synchronise).
- ``restore_pages`` writes a record back IN PLACE (``index_copy_`` into
  the pool's own tensors): the engine's CUDA graphs were captured over
  that storage, so a restore that allocated new tensors would leave them
  reading the old pages.

Under TP a rank's pool holds its lanes of every page: spill and the
host tier keep that share, and ``whole_page_record`` /
``rank_page_record`` convert between it and the whole page that the disk
tier stores.

The disk codec frames one per-page record with ``utils/wal.py``: a JSON
field header, a NUL, then the raw bytes, in one CRC32 frame, byte for
byte the JAX package's files.  A bf16 field is written under JAX's tag
``'<V2'`` (what ``ml_dtypes.bfloat16`` reports as its ``dtype.str``), and
the port reads any 2-byte void field back as bf16.  ``decode_page_record``
returns None on any defect: a corrupt page on disk is a cold miss.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from k8s_llm_rca_tpu_torch.utils import wal

# record keys holding page arrays, in gather/restore/serialization order
_KV_FIELDS = ("k", "v")
_SCALE_FIELDS = ("k_scale", "v_scale")
# the tag JAX writes for a bfloat16 field (ml_dtypes reports it as void)
BF16_TAG = "<V2"


def suffix_bucket(bucket_of: Callable[[int], int], rest_len: int,
                  n_shared: int, page_size: int,
                  pages_per_seq: int) -> Tuple[int, int]:
    """Bucket a sequence SUFFIX that begins after ``n_shared`` held pages
    (a prefix hit, a spill restore): the padded bucket capped at the table
    room past the shared run.  Returns ``(bucket_tokens, n_pages)``.  One
    definition for every admission path, so allocator state evolves
    identically whichever path resumes a sequence."""
    bucket = min(bucket_of(rest_len), (pages_per_seq - n_shared) * page_size)
    return bucket, bucket // page_size


def pool_fields(pool) -> Tuple[str, ...]:
    return _KV_FIELDS + (_SCALE_FIELDS if pool.quantized else ())


def to_host(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Bring device tensors to the host in one sync.  On the card they
    land in ONE pinned buffer (each field a view of it, 16-byte aligned),
    copied non-blocking on the current stream, then one synchronise; CPU
    tensors pass through."""
    if not tensors or tensors[0].device.type != "cuda":
        return tensors
    offs, total = [], 0
    for t in tensors:
        offs.append(total)
        total += -(-t.numel() * t.element_size() // 16) * 16
    buf = torch.empty((total,), dtype=torch.uint8, pin_memory=True)
    out = []
    for t, off in zip(tensors, offs):
        n = t.numel() * t.element_size()
        host = buf[off:off + n].view(t.dtype).view(t.shape)
        host.copy_(t, non_blocking=True)
        out.append(host)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return tuple(out)


def gather_pages(pool, fetch: Callable, page_ids: Sequence[int]
                 ) -> Dict[str, object]:
    """The pages ``page_ids`` of every pool field (page axis 1) as a host
    page record, in ONE sync: ``fetch`` is the engine's ``_fetch_host``."""
    idx = torch.tensor(list(page_ids), dtype=torch.long, device=pool.k.device)
    fields = pool_fields(pool)
    host = fetch(*(getattr(pool, f).index_select(1, idx) for f in fields))
    rec: Dict[str, object] = {"n_pages": len(page_ids)}
    rec.update(zip(fields, host))
    return rec


def restore_pages(pool, rec: Dict[str, object], page_ids: Sequence[int]):
    """Write a page record into the pool pages ``page_ids``, in place (the
    inverse of ``gather_pages``); returns the same pool.  The copies run
    on the current stream, so the next decode step reads them."""
    dev = pool.k.device
    idx = torch.tensor(list(page_ids), dtype=torch.long, device=dev)
    for f in pool_fields(pool):
        src = as_tensor(rec[f]).to(dev, non_blocking=True)
        getattr(pool, f).index_copy_(1, idx, src)
    return pool


def as_tensor(a) -> torch.Tensor:
    """A record array as a CPU tensor (records written by numpy code, the
    JAX package's among them, hold numpy arrays)."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def record_fields(rec: Dict[str, object]) -> Tuple[str, ...]:
    """Array field names present in a page record, canonical order."""
    return _KV_FIELDS + (_SCALE_FIELDS if "k_scale" in rec else ())


def record_nbytes(rec: Dict[str, object]) -> int:
    """Total payload bytes a record holds."""
    return sum(as_tensor(rec[f]).numel() * as_tensor(rec[f]).element_size()
               for f in record_fields(rec))


def split_pages(rec: Dict[str, object]) -> List[Dict[str, object]]:
    """Split a multi-page record into per-page records (page axis kept,
    length 1), each a contiguous COPY: a store entry owns its bytes, so
    dropping it frees host memory instead of pinning the gathered block."""
    fields = record_fields(rec)
    out: List[Dict[str, object]] = []
    for i in range(int(rec["n_pages"])):
        page: Dict[str, object] = {"n_pages": 1}
        for f in fields:
            page[f] = as_tensor(rec[f])[:, i:i + 1].clone()
        out.append(page)
    return out


def stack_pages(recs: Sequence[Dict[str, object]],
                pin: bool = False) -> Dict[str, object]:
    """Concatenate per-page records along the page axis: the one record
    ``restore_pages`` writes in one copy per field.  ``pin``: into pinned
    memory (the card's restore then copies asynchronously)."""
    fields = record_fields(recs[0])
    rec: Dict[str, object] = {
        "n_pages": sum(int(r["n_pages"]) for r in recs)}
    for f in fields:
        parts = [as_tensor(r[f]) for r in recs]
        shape = list(parts[0].shape)
        shape[1] = sum(p.shape[1] for p in parts)
        out = torch.empty(shape, dtype=parts[0].dtype, pin_memory=pin)
        rec[f] = torch.cat(parts, dim=1, out=out)
    return rec


def whole_page_record(rec: Dict[str, object], group, packed: bool,
                      device=None) -> Dict[str, object]:
    """A TP rank's share of a page record (its lanes of the merged kv axis,
    ``rules.paged_pool_specs``) as the whole page in the JAX package's
    layout, the one ``.page`` files hold: k and v all-gathered along the
    lanes over the TP ``group``, in group-rank order.  An int4 share is
    split-half packed over the rank's own lanes: each share is unpacked,
    the lanes joined and packed split-half over all of them, a pure nibble
    permutation (the scale is already the full row's, the max over the
    group).  The scale fields are equal on every rank and pass through.
    ``device``: where the gather runs (the card under nccl; None keeps the
    host tensors, as gloo takes).  Every rank of ``group`` calls it, in the
    same order."""
    from k8s_llm_rca_tpu_torch.models.quant import (
        _pack_nibbles, _unpack_nibbles,
    )
    from k8s_llm_rca_tpu_torch.runtime.mesh import all_gather

    out: Dict[str, object] = {"n_pages": int(rec["n_pages"])}
    for f in record_fields(rec):
        t = as_tensor(rec[f])
        if f in _KV_FIELDS:
            src = t.to(device) if device is not None else t
            parts = all_gather(src, group, dim=0).cpu()
            parts = parts.view(-1, *t.shape)              # [n, L, p, pg, w]
            if packed:
                parts = _unpack_nibbles(parts)
            t = parts.movedim(0, -2).reshape(*t.shape[:-1], -1)
            if packed:
                t = _pack_nibbles(t)
        out[f] = t
    return out


def rank_page_record(rec: Dict[str, object], n_parts: int, part: int,
                     packed: bool) -> Dict[str, object]:
    """The inverse of ``whole_page_record`` on one rank: a whole page
    record's lanes of TP rank ``part`` of ``n_parts`` (int4: unpacked,
    sliced and packed split-half over the rank's lanes).  A record whose
    lanes do not split into ``n_parts`` comes back unchanged, for
    ``records_compatible`` to refuse."""
    from k8s_llm_rca_tpu_torch.models.quant import (
        _pack_nibbles, _unpack_nibbles,
    )

    width = as_tensor(rec["k"]).shape[-1] * (2 if packed else 1)
    lanes = width // n_parts
    if width % n_parts or (packed and lanes % 2):
        return rec
    out: Dict[str, object] = {"n_pages": int(rec["n_pages"])}
    for f in record_fields(rec):
        t = as_tensor(rec[f])
        if f in _KV_FIELDS:
            if packed:
                t = _pack_nibbles(
                    _unpack_nibbles(t)[..., part * lanes:(part + 1) * lanes])
            else:
                t = t[..., part * lanes:(part + 1) * lanes].contiguous()
        out[f] = t
    return out


def _compatible(pool, rec: Dict[str, object], n: int) -> bool:
    fields = pool_fields(pool)
    if record_fields(rec) != fields:
        return False
    for f in fields:
        arr = as_tensor(rec[f])
        ref = getattr(pool, f)
        want = (ref.shape[0], n) + tuple(ref.shape[2:])
        if tuple(arr.shape) != want or arr.dtype != ref.dtype:
            return False
    return True


def pool_compatible(pool, rec: Dict[str, object]) -> bool:
    """Whether a MULTI-page record's dtypes and shapes match THIS pool (the
    check before a handoff's pages are adopted)."""
    return _compatible(pool, rec, int(rec["n_pages"]))


def records_compatible(pool, rec: Dict[str, object]) -> bool:
    """Whether a per-page record's dtypes and shapes match THIS pool: a
    store shared across engine configs must answer a mismatched page as a
    cold miss, not scatter garbage."""
    return _compatible(pool, rec, 1)


def convert_page_record(rec: Dict[str, object], length: int,
                        dst_page_size: int) -> Dict[str, object]:
    """Re-chunk a multi-page record onto another page size: flatten the
    (page, token) axes, keep the ``length`` valid tokens, zero-pad to the
    next ``dst_page_size`` multiple and re-chunk (positions past
    ``length`` are never read).  Raises ValueError when ``length`` does
    not fit the record or the arrays disagree with ``n_pages``."""
    src = as_tensor(rec["k"])
    if src.ndim != 4:
        raise ValueError(
            f"convert_page_record: k has rank {src.ndim}, want "
            f"[L, n_pages, page, kv]")
    n_src, ps_src = int(rec["n_pages"]), int(src.shape[2])
    if src.shape[1] != n_src:
        raise ValueError(
            f"convert_page_record: record claims {n_src} pages but k "
            f"carries {src.shape[1]}")
    if not (0 < length <= n_src * ps_src):
        raise ValueError(
            f"convert_page_record: length={length} does not fit "
            f"{n_src} pages of {ps_src} tokens")
    if dst_page_size <= 0:
        raise ValueError(
            f"convert_page_record: dst_page_size={dst_page_size}")
    if dst_page_size == ps_src:
        return rec
    n_dst = -(-length // dst_page_size)
    out: Dict[str, object] = {"n_pages": n_dst}
    for f in record_fields(rec):
        arr = as_tensor(rec[f])
        n_layers, tail = arr.shape[0], tuple(arr.shape[3:])
        flat = arr.reshape((n_layers, n_src * ps_src) + tail)[:, :length]
        full = torch.zeros((n_layers, n_dst * dst_page_size) + tail,
                           dtype=arr.dtype)
        full[:, :length] = flat
        out[f] = full.reshape((n_layers, n_dst, dst_page_size) + tail)
    return out


# --------------------------------------------------------------- disk codec

def _dtype_tag(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return BF16_TAG
    return torch.empty((0,), dtype=dtype).numpy().dtype.str


def _raw_bytes(t: torch.Tensor) -> bytes:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def encode_page_record(rec: Dict[str, object]) -> bytes:
    """One CRC-framed disk entry for a per-page record: JSON header
    (field name, dtype tag, shape) + NUL + the fields' raw bytes, in
    ``wal.pack_record``; byte for byte the JAX package's encoding.  Raises
    ValueError past ``wal.MAX_RECORD_SIZE`` (the caller skips the write)."""
    fields = record_fields(rec)
    tensors = [as_tensor(rec[f]) for f in fields]
    header = {"n_pages": int(rec["n_pages"]),
              "fields": [[f, _dtype_tag(t.dtype), list(t.shape)]
                         for f, t in zip(fields, tensors)]}
    blob = b"".join(_raw_bytes(t) for t in tensors)
    return wal.pack_record(
        json.dumps(header, sort_keys=True).encode() + b"\0" + blob)


def _from_bytes(chunk: bytes, dt: np.dtype, shape) -> torch.Tensor:
    if dt.kind == "V" and dt.itemsize == 2:
        # JAX's bf16 tag: the port reads it back as bf16
        arr = np.frombuffer(chunk, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(chunk, dtype=dt).reshape(shape)
                            .copy())


def decode_page_record(data: bytes) -> Optional[Dict[str, object]]:
    """Inverse of ``encode_page_record``; None on ANY defect (torn or
    corrupt frame, bad header, truncated payload)."""
    try:
        payload = None
        for payload, _ in wal.iter_records(data):
            break
        if payload is None:
            return None
        head, sep, blob = payload.partition(b"\0")
        if not sep:
            return None
        header = json.loads(head.decode())
        rec: Dict[str, object] = {"n_pages": int(header["n_pages"])}
        off = 0
        for name, dtype_str, shape in header["fields"]:
            dt = np.dtype(dtype_str)
            n = dt.itemsize * int(np.prod(shape, dtype=np.int64))
            chunk = blob[off:off + n]
            if len(chunk) != n:
                return None
            rec[name] = _from_bytes(chunk, dt, shape)
            off += n
        if off != len(blob):
            return None
        return rec
    except Exception:
        return None
