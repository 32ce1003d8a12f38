"""Byte-range input splitting with part-k-of-n semantics.

A copy of ``wormhole_tpu/data/input_split.py`` over the port's local-only
``data/stream.py``. Rebuild of dmlc-core ``InputSplit::Create(uri, part,
nparts, type)`` as used by the reference minibatch reader
(``learn/linear/base/minibatch_iter.h:34-46``): a file (or file list) is
divided into ``nparts`` byte ranges; part ``k`` reads its range, snapping to
record boundaries so every record is read exactly once across parts (text:
newline; recordio: magic-framed records re-sync on their own).
"""

from __future__ import annotations

from typing import Iterator, List

from wormhole_tpu_torch.data.stream import FileInfo, get_filesystem, list_files

_CHUNK = 1 << 20  # 1 MiB read granularity


def resolve_files(uri: str) -> List[FileInfo]:
    """Expand a ';'-separated multi-uri (as dmlc-core supports) to files."""
    files: List[FileInfo] = []
    for piece in uri.split(";"):
        if piece:
            files.extend(list_files(piece))
    if not files:
        raise FileNotFoundError(f"no input files match {uri!r}")
    return files


def part_ranges(files: List[FileInfo], part: int,
                nparts: int) -> Iterator[tuple]:
    """Yield (file, lo, hi) byte ranges belonging to part ``k`` of ``n``.

    The concatenated byte span [0, total) is divided evenly into nparts; a
    file straddling a boundary contributes the overlap of its span."""
    total = sum(f.size for f in files)
    lo = total * part // nparts
    hi = total * (part + 1) // nparts
    offset = 0
    for f in files:
        flo, fhi = max(lo - offset, 0), min(hi - offset, f.size)
        if flo < fhi:
            yield f, flo, fhi
        offset += f.size
        if offset >= hi:
            break


class InputSplit:
    """Iterate byte chunks of part ``k`` of ``n`` over one or more files."""

    def __init__(self, uri: str, part: int = 0, nparts: int = 1,
                 split_type: str = "text", chunk_bytes: int = _CHUNK) -> None:
        assert 0 <= part < nparts, (part, nparts)
        self.part, self.nparts = part, nparts
        self.split_type = split_type
        self.chunk_bytes = chunk_bytes
        self.files = resolve_files(uri)
        self._bytes_read = 0

    def bytes_read(self) -> int:
        return self._bytes_read

    def _ranges(self) -> Iterator[tuple]:
        return part_ranges(self.files, self.part, self.nparts)

    def __iter__(self) -> Iterator[bytes]:
        if self.split_type == "text":
            return self._iter_text()
        elif self.split_type == "recordio":
            return self._iter_raw()
        raise ValueError(f"unknown split type {self.split_type!r}")

    def _iter_text(self) -> Iterator[bytes]:
        """Newline-aligned chunks: a part starting mid-line skips to the next
        newline; the part owning the line start reads through its end."""
        for f, lo, hi in self._ranges():
            fs = get_filesystem(f.path)
            with fs.open(f.path, "rb") as fp:
                start = lo
                if lo > 0:
                    fp.seek(lo - 1)
                    probe = fp.read(1)
                    if probe != b"\n":
                        # skip the partial line; its owner is the previous part
                        rest = fp.readline()
                        start = lo - 1 + 1 + len(rest)
                    # else: lo is exactly a line start
                fp.seek(start)
                pos = start
                carry = b""
                while pos < hi:
                    want = min(self.chunk_bytes, hi - pos)
                    buf = fp.read(want)
                    if not buf:
                        break
                    pos += len(buf)
                    if pos >= hi and not buf.endswith(b"\n"):
                        # finish the straddling line (owned by this part)
                        tail = fp.readline()
                        buf += tail
                        pos += len(tail)
                    chunk = carry + buf
                    nl = chunk.rfind(b"\n")
                    if nl < 0:
                        carry = chunk
                        continue
                    carry = chunk[nl + 1:]
                    out = chunk[: nl + 1]
                    self._bytes_read += len(out)
                    yield out
                if carry:
                    self._bytes_read += len(carry)
                    yield carry

    def _iter_raw(self) -> Iterator[bytes]:
        """Raw byte chunks for self-framing formats (recordio re-syncs on its
        magic marker, see recordio.py)."""
        for f, lo, hi in self._ranges():
            fs = get_filesystem(f.path)
            with fs.open(f.path, "rb") as fp:
                fp.seek(lo)
                pos = lo
                while pos < hi:
                    buf = fp.read(min(self.chunk_bytes, hi - pos))
                    if not buf:
                        break
                    pos += len(buf)
                    self._bytes_read += len(buf)
                    yield buf
