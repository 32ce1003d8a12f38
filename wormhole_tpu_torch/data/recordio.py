"""Magic-framed binary record format (RecordIO) + sparse-row record schema.

A copy of ``wormhole_tpu/data/recordio.py``: files written by either package
are byte-identical and read by the other. Rebuild of dmlc-core RecordIO
(``Reader/Writer/ChunkReader``, consumed at
``learn/linear/tool/text2rec.cc:118-127`` and
``learn/linear/base/criteo_rec_parser.h:44``) plus the record payloads of
``learn/linear/proto/data_format.proto``.

Framing (same scheme as dmlc recordio): every (sub-)record is

    [MAGIC u32][flag:3bits | len:29bits  u32][payload][pad to 4]

Headers are 4-byte aligned. The writer scans payloads for 4-aligned MAGIC
words and splits such payloads into continuation sub-records
(flag 0=whole, 1=first, 2=middle, 3=last), so an aligned MAGIC in the file
*always* marks a header. That invariant is what makes byte-range part-k/n
splitting sound: a reader dropped at an arbitrary offset scans to the next
aligned MAGIC with flag∈{0,1} and is guaranteed to be at a record start.

Ownership rule for part k of n over span [lo, hi): the part yields exactly
the records whose header starts in [lo, hi), reading past hi to complete the
final record. Records never straddle files.

Payload schema (replaces the reference's protobuf2 Criteo/Adfea messages with
one general sparse-row record):

  label   f32
  flags   u8     bit0: has explicit values
  nnz     u32
  index   u64 * nnz   (global feature ids, already offset/hashed by text2rec)
  value   f32 * nnz   (only if flags bit0)
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from wormhole_tpu_torch.data.input_split import part_ranges, resolve_files
from wormhole_tpu_torch.data.rowblock import RowBlock, RowBlockContainer
from wormhole_tpu_torch.data.stream import FileInfo, get_filesystem

MAGIC = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", MAGIC)
_U32 = struct.Struct("<I")
_REC_HDR = struct.Struct("<fBI")  # label, flags, nnz
_LEN_MASK = (1 << 29) - 1

_WHOLE, _FIRST, _MIDDLE, _LAST = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# row payload codec
# ---------------------------------------------------------------------------

def encode_row(label: float, index: np.ndarray,
               value: Optional[np.ndarray] = None) -> bytes:
    flags = 1 if value is not None else 0
    payload = _REC_HDR.pack(label, flags, len(index))
    payload += np.ascontiguousarray(index, dtype=np.uint64).tobytes()
    if value is not None:
        payload += np.ascontiguousarray(value, dtype=np.float32).tobytes()
    return payload


def decode_row(payload: bytes) -> Tuple[float, np.ndarray, Optional[np.ndarray]]:
    label, flags, nnz = _REC_HDR.unpack_from(payload, 0)
    off = _REC_HDR.size
    index = np.frombuffer(payload, np.uint64, nnz, off)
    off += nnz * 8
    value = np.frombuffer(payload, np.float32, nnz, off) if flags & 1 else None
    return label, index, value


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _aligned_magic_positions(payload: bytes) -> List[int]:
    """4-aligned offsets where MAGIC occurs inside payload."""
    out = []
    start = 0
    while True:
        i = payload.find(_MAGIC_BYTES, start)
        if i < 0:
            return out
        if i % 4 == 0:
            out.append(i)
            start = i + 4
        else:
            start = i + 1


class RecordWriter:
    """Write framed records to a binary stream (4-aligned from offset 0)."""

    def __init__(self, stream) -> None:
        self._s = stream

    def _emit(self, flag: int, part: bytes) -> None:
        self._s.write(_MAGIC_BYTES)
        self._s.write(_U32.pack((flag << 29) | len(part)))
        self._s.write(part)
        pad = (-len(part)) % 4
        if pad:
            self._s.write(b"\x00" * pad)

    def write_record(self, payload: bytes) -> None:
        cuts = _aligned_magic_positions(payload)
        if not cuts:
            self._emit(_WHOLE, payload)
            return
        # Split at each in-payload aligned MAGIC and *drop* those 4 magic
        # bytes from the written parts — each continuation part's own header
        # MAGIC stands in for them, so no aligned MAGIC ever appears inside
        # a written payload. The reader re-inserts MAGIC between parts.
        bounds = [0] + cuts + [len(payload)]
        nparts = len(bounds) - 1
        for i in range(nparts):
            lo, hi = bounds[i], bounds[i + 1]
            if i > 0:
                lo += 4  # strip the magic word; reader restores it
            flag = (_FIRST if i == 0 else
                    _LAST if i == nparts - 1 else _MIDDLE)
            self._emit(flag, payload[lo:hi])

    def write_row(self, label: float, index: np.ndarray,
                  value: Optional[np.ndarray] = None) -> None:
        self.write_record(encode_row(label, index, value))


# ---------------------------------------------------------------------------
# split-aware reader
# ---------------------------------------------------------------------------

class RecordStream:
    """Iterate whole record payloads for part ``k`` of ``n`` over uri(s).

    This is the recordio analogue of InputSplit: ranges are computed over the
    concatenated byte span, each file segment scans to its first owned header
    and reads headers while they start before the segment end."""

    def __init__(self, uri: str, part: int = 0, nparts: int = 1,
                 read_chunk: int = 1 << 20) -> None:
        assert 0 <= part < nparts
        self.part, self.nparts = part, nparts
        self._chunk = read_chunk
        self.files = resolve_files(uri)
        self._bytes_read = 0

    def bytes_read(self) -> int:
        return self._bytes_read

    def _ranges(self):
        return part_ranges(self.files, self.part, self.nparts)

    def __iter__(self) -> Iterator[bytes]:
        for f, lo, hi in self._ranges():
            yield from self._read_segment(f, lo, hi)

    def _read_segment(self, f: FileInfo, lo: int, hi: int) -> Iterator[bytes]:
        fs = get_filesystem(f.path)
        with fs.open(f.path, "rb") as fp:
            start = lo - (lo % 4)
            fp.seek(start)
            state = {"buf": b"", "base": start, "scan": 0}

            def fill(abs_end: int) -> bool:
                while state["base"] + len(state["buf"]) < abs_end:
                    data = fp.read(max(self._chunk,
                                       abs_end - state["base"] - len(state["buf"])))
                    if not data:
                        return False
                    self._bytes_read += len(data)
                    state["buf"] += data
                return True

            def header():
                """Peek (flag, len, total) at scan; False if not a header,
                None at EOF."""
                abs_pos = state["base"] + state["scan"]
                if not fill(abs_pos + 8):
                    return None
                s = state["scan"]
                if state["buf"][s:s + 4] != _MAGIC_BYTES:
                    return False
                word = _U32.unpack_from(state["buf"], s + 4)[0]
                flag, ln = word >> 29, word & _LEN_MASK
                return flag, ln, 8 + ln + ((-ln) % 4)

            def advance(total: int) -> bool:
                if not fill(state["base"] + state["scan"] + total):
                    return False
                state["scan"] += total
                if state["scan"] > self._chunk:
                    state["buf"] = state["buf"][state["scan"]:]
                    state["base"] += state["scan"]
                    state["scan"] = 0
                return True

            # --- resync: find the first WHOLE/FIRST header at abs >= lo ---
            while True:
                abs_pos = state["base"] + state["scan"]
                if abs_pos >= hi:
                    return
                h = header()
                if h is None:
                    return
                if h is False:
                    state["scan"] += 4
                    continue
                flag, ln, total = h
                if abs_pos < lo or flag in (_MIDDLE, _LAST):
                    # not ours / mid-record: step over the whole sub-record
                    if not advance(total):
                        return
                    continue
                break  # synced at an owned record start

            # --- main loop: read logical records headed before hi ---
            parts: List[bytes] = []
            while True:
                abs_pos = state["base"] + state["scan"]
                h = header()
                if h is None:
                    return
                if h is False:
                    raise IOError(f"recordio corrupt at {f.path}:{abs_pos}")
                flag, ln, total = h
                if not parts and abs_pos >= hi:
                    return  # next record belongs to the next part
                if not fill(abs_pos + total):
                    return  # truncated file tail
                s = state["scan"]
                payload = state["buf"][s + 8: s + 8 + ln]
                advance(total)
                if flag == _WHOLE:
                    yield payload
                elif flag == _FIRST:
                    parts = [payload]
                else:
                    parts.append(payload)
                    if flag == _LAST:
                        # the writer dropped the in-payload MAGIC words at
                        # the part boundaries; restore them on join
                        yield _MAGIC_BYTES.join(parts)
                        parts = []


def iter_record_blocks(source, rows_per_block: int = 65536) -> Iterator[RowBlock]:
    """Parse a RecordStream (or any payload iterable) into RowBlocks
    (criteo_rec/adfea_rec parser equivalent)."""
    c = RowBlockContainer()
    for payload in source:
        label, index, value = decode_row(payload)
        c.push(label, index, value)
        if c.size >= rows_per_block:
            yield c.finalize()
            c = RowBlockContainer()
    if c.size:
        yield c.finalize()
