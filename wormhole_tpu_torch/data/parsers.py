"""Text-format chunk parsers: libsvm, criteo, adfea.

A copy of ``wormhole_tpu/data/parsers.py``. Rebuild of the reference's
format registry (``learn/linear/base/minibatch_iter.h:31-46``) and text
parsers (``base/criteo_parser.h:47-80``, ``base/adfea_parser.h:35-78``):
each parser consumes newline-aligned byte chunks from an InputSplit and
yields CSR RowBlocks with 64-bit global feature ids.

Format semantics (matching the reference):

- ``libsvm``: ``<label> <idx>:<val> ...``; binary rows without ``:`` allowed.
- ``criteo``: tab-separated ``<label> <13 int features> <26 categorical>``;
  integer feature i with raw value v becomes id ``v + i*itv`` where
  ``itv = 2**64 / 13 + 1`` (slot-offset one-hot, criteo_parser.h:47-48,60-66);
  categoricals are 8-char hex strings hashed to 32 bits (crc32).
- ``adfea``: whitespace tokens; ``feaid:groupid`` pairs keep the feaid; every
  third bare integer on a line is the label (lineid and count are skipped,
  adfea_parser.h:59-69).

All features are binary (value == None) for criteo/adfea, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator

import numpy as np

from wormhole_tpu_torch.data.hashing import crc32_hash
from wormhole_tpu_torch.data.rowblock import RowBlock

ChunkSource = Iterable[bytes]
ParserFn = Callable[[bytes], RowBlock]

_KMAX64 = 2 ** 64 - 1
_CRITEO_ITV = _KMAX64 // 13 + 1


def parse_libsvm_chunk(chunk: bytes) -> RowBlock:
    labels, offsets, idx, val = [], [0], [], []
    has_val = False
    nnz = 0
    for line in chunk.splitlines():
        parts = line.split()
        if not parts:
            continue
        first = parts[0]
        if b":" in first:  # unlabeled row (prediction input)
            labels.append(0.0)
            feats = parts
        else:
            labels.append(float(first))
            feats = parts[1:]
        for tok in feats:
            k, sep, v = tok.partition(b":")
            if not k:
                continue
            idx.append(int(k))
            if sep:
                has_val = True
                val.append(float(v))
            else:
                val.append(1.0)
            nnz += 1
        offsets.append(nnz)
    return RowBlock(
        offset=np.asarray(offsets, np.int64),
        label=np.asarray(labels, np.float32),
        index=np.asarray(idx, np.uint64),
        value=np.asarray(val, np.float32) if has_val else None,
    )


def parse_criteo_chunk(chunk: bytes) -> RowBlock:
    labels, offsets, idx = [], [0], []
    nnz = 0
    for line in chunk.splitlines():
        if not line:
            continue
        cols = line.split(b"\t")
        if len(cols) < 14:
            continue
        labels.append(float(cols[0]))
        for i in range(13):
            c = cols[1 + i]
            if c:
                idx.append((int(c) + i * _CRITEO_ITV) & _KMAX64)
                nnz += 1
        for c in cols[14:40]:
            if c:
                idx.append(crc32_hash(c))
                nnz += 1
        offsets.append(nnz)
    return RowBlock(
        offset=np.asarray(offsets, np.int64),
        label=np.asarray(labels, np.float32),
        index=np.asarray(idx, np.uint64),
        value=None,
    )


def parse_adfea_chunk(chunk: bytes) -> RowBlock:
    # Token state machine over the whole chunk, as in adfea_parser.h:50-78:
    # ':'-pairs append the feaid to the current row; every 3rd bare integer
    # (after a lineid and a count) is a label and closes the previous row.
    labels, offsets, idx = [], [0], []
    bare = 0
    for tok in chunk.split():
        k, sep, _gid = tok.partition(b":")
        if sep:
            idx.append(int(k))
        elif bare == 2:
            bare = 0
            if labels:
                offsets.append(len(idx))  # close previous row
            labels.append(1.0 if k[:1] == b"1" else 0.0)
        else:
            bare += 1
    if labels:
        offsets.append(len(idx))
    return RowBlock(
        offset=np.asarray(offsets, np.int64),
        label=np.asarray(labels, np.float32),
        index=np.asarray(idx, np.uint64),
        value=None,
    )


_TEXT_PARSERS: Dict[str, ParserFn] = {
    "libsvm": parse_libsvm_chunk,
    "criteo": parse_criteo_chunk,
    "adfea": parse_adfea_chunk,
}


def iter_blocks(source: ChunkSource, data_format: str) -> Iterator[RowBlock]:
    """Parse a chunk stream into RowBlocks. For text formats the chunks must
    be newline-aligned (InputSplit split_type='text')."""
    fmt = data_format.lower()
    if fmt in _TEXT_PARSERS:
        # Prefer the native C++ parser when available (hot path; SURVEY §7
        # hard part (d)); fall back to the Python implementations above.
        from wormhole_tpu_torch.data import native
        fn = native.get_parser(fmt) or _TEXT_PARSERS[fmt]
        for chunk in source:
            blk = fn(chunk)
            if blk.size:
                yield blk
    elif fmt in ("criteo_rec", "adfea_rec", "rec", "recordio"):
        from wormhole_tpu_torch.data.recordio import iter_record_blocks
        yield from iter_record_blocks(source)
    else:
        raise ValueError(f"unknown data format {data_format!r}")

