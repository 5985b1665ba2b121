"""Write-ahead-log record codec: length-prefixed, checksummed, crash-tolerant
(a copy of ``k8s_llm_rca_tpu/utils/wal.py``; the port's page codec,
``utils/pages.py``, frames its ``.page`` files with it).

The serve-layer run journal (serve/journal.py) needs the same crash-artifact
discipline as ``sweeps/run_file.py:scan_output``: a process killed mid-write
leaves a torn tail, and the reader must recover every record written BEFORE
the torn one and (optionally) atomically truncate the garbage.  scan_output
gets that property for free from ``JSONDecoder.raw_decode``; a binary WAL
needs an explicit frame:

    [4-byte big-endian payload length][4-byte CRC32 of payload][payload]

A record is valid only if the full frame is present AND the checksum
matches.  The reader stops at the FIRST invalid frame: after a torn write
everything downstream is suspect (a later "valid-looking" frame could be a
coincidental bit pattern inside the torn region), which is standard WAL
semantics.

Truncation reuses scan_output's atomic recipe exactly (run_file.py:103-113):
write the clean prefix to a temp file, fsync, ``os.replace`` — a crash
during truncation leaves either the old or the new file, never a mix.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import BinaryIO, Iterator, List, Tuple

# THE frame header: (payload length, CRC32 of payload), big-endian.
# Single source of truth for every CRC-framed byte stream in the tree —
# the WAL journal, the prefix-store ``.page`` disk entries
# (utils/pages.py), and the out-of-process wire protocol (cluster/
# wire.py re-exports these same objects) — so a record written by one
# layer is byte-for-byte a legal frame to every other.
HEADER = struct.Struct(">II")
HEADER_SIZE = HEADER.size
_HEADER = HEADER                    # internal alias (pre-share spelling)

# frames above this are assumed to be torn-tail garbage, not real records
# (a length field read out of random bytes is uniform over 4 GiB; journal
# payloads are compact JSON far below this).  Shared with the wire codec
# as MAX_FRAME_SIZE: the disk and wire record-size guards cannot drift.
MAX_RECORD_SIZE = 16 * 1024 * 1024


def pack_record(payload: bytes) -> bytes:
    """Frame one payload: header (length + CRC32) followed by the bytes."""
    if len(payload) > MAX_RECORD_SIZE:
        raise ValueError(
            f"WAL record of {len(payload)} bytes exceeds MAX_RECORD_SIZE "
            f"({MAX_RECORD_SIZE}); records must stay small enough that a "
            f"corrupt length field is distinguishable from a real one")
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def append_record(f: BinaryIO, payload: bytes) -> int:
    """Append one framed record and force it to disk.  Returns the number
    of bytes written.  The fsync is the durability contract: after this
    returns, the record survives a process kill (the reader may still drop
    it on a KERNEL crash, which is the strongest single-fsync gives)."""
    frame = pack_record(payload)
    f.write(frame)
    f.flush()
    os.fsync(f.fileno())
    return len(frame)


def iter_records(data: bytes) -> Iterator[Tuple[bytes, int]]:
    """Yield ``(payload, end_offset)`` for each valid leading frame of
    ``data``; stop silently at the first torn/corrupt frame.  end_offset
    is the byte offset just past the yielded record — the last yielded
    offset is the clean truncation point."""
    off = 0
    n = len(data)
    while off + HEADER_SIZE <= n:
        length, crc = _HEADER.unpack_from(data, off)
        if length > MAX_RECORD_SIZE:
            return
        end = off + HEADER_SIZE + length
        if end > n:
            return                      # torn tail: frame not fully written
        payload = data[off + HEADER_SIZE:end]
        if zlib.crc32(payload) != crc:
            return                      # corrupt: stop, everything after is suspect
        yield payload, end
        off = end


def scan_wal(path: str, truncate_partial: bool = False
             ) -> Tuple[List[bytes], int]:
    """Read every valid record; return ``(payloads, clean_end)`` where
    clean_end is the offset of the first torn/corrupt byte (== file size
    when the file is clean).  With ``truncate_partial=True`` the torn tail
    is atomically dropped — same temp + fsync + ``os.replace`` recipe as
    scan_output, so a crash mid-truncation cannot corrupt the journal."""
    if not os.path.exists(path):
        return [], 0
    with open(path, "rb") as f:
        data = f.read()
    payloads: List[bytes] = []
    end = 0
    for payload, off in iter_records(data):
        payloads.append(payload)
        end = off
    if truncate_partial and end < len(data):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data[:end])
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    return payloads, end
