"""CSR row blocks — the in-memory unit of sparse data.

A copy of ``wormhole_tpu/data/rowblock.py`` (the port imports nothing of the
JAX package). Rebuild of dmlc-core's ``RowBlock``/``RowBlockContainer``
(consumed by the reference at ``learn/linear/base/minibatch_iter.h:87-101``
and ``learn/linear/base/localizer.h:157-180``): a block of rows stored CSR
with 64-bit global feature ids, optional values (None = all-ones/binary),
labels, and optional per-row weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class RowBlock:
    """Immutable CSR view over ``size`` rows."""

    offset: np.ndarray           # int64 (size+1,)
    label: np.ndarray            # float32 (size,)
    index: np.ndarray            # uint64 (nnz,)  global feature ids
    value: Optional[np.ndarray]  # float32 (nnz,) or None = binary
    weight: Optional[np.ndarray] = None  # float32 (size,) or None

    @property
    def size(self) -> int:
        return len(self.offset) - 1

    @property
    def nnz(self) -> int:
        return int(self.offset[-1] - self.offset[0])

    def slice(self, lo: int, hi: int) -> "RowBlock":
        """Zero-copy row slice [lo, hi)."""
        off = self.offset[lo:hi + 1]
        blo, bhi = int(off[0]), int(off[-1])
        return RowBlock(
            offset=off - off[0],
            label=self.label[lo:hi],
            index=self.index[blo:bhi],
            value=None if self.value is None else self.value[blo:bhi],
            weight=None if self.weight is None else self.weight[lo:hi],
        )

    def values_or_ones(self) -> np.ndarray:
        if self.value is not None:
            return self.value
        return np.ones(self.nnz, np.float32)

    def max_row_nnz(self) -> int:
        if self.size == 0:
            return 0
        return int(np.diff(self.offset).max())


class RowBlockContainer:
    """Appendable container that assembles RowBlocks."""

    def __init__(self) -> None:
        self._offsets: List[int] = [0]
        self._labels: List[float] = []
        self._weights: List[float] = []
        self._index_chunks: List[np.ndarray] = []
        self._value_chunks: List[Optional[np.ndarray]] = []
        self._has_value = False
        self._has_weight = False
        self._nnz = 0

    @property
    def size(self) -> int:
        return len(self._labels)

    def push(self, label: float, index: np.ndarray,
             value: Optional[np.ndarray] = None, weight: float = 1.0) -> None:
        self._labels.append(label)
        self._weights.append(weight)
        self._index_chunks.append(np.asarray(index, np.uint64))
        if value is not None:
            self._has_value = True
        if weight != 1.0:
            self._has_weight = True
        self._value_chunks.append(
            None if value is None else np.asarray(value, np.float32))
        self._nnz += len(index)
        self._offsets.append(self._nnz)

    def extend_block(self, blk: RowBlock) -> None:
        base = self._nnz
        self._index_chunks.append(blk.index)
        self._value_chunks.append(blk.value if blk.value is not None else None)
        if blk.value is not None:
            self._has_value = True
        if blk.weight is not None:
            self._has_weight = True
        self._labels.extend(blk.label.tolist())
        self._weights.extend([1.0] * blk.size if blk.weight is None
                             else blk.weight.tolist())
        self._nnz += blk.nnz
        per_row = np.diff(blk.offset)
        off = base + np.cumsum(per_row)
        self._offsets.extend(off.tolist())

    def finalize(self) -> RowBlock:
        if self._has_value:
            vals = [v if v is not None else np.ones(len(i), np.float32)
                    for v, i in zip(self._value_chunks, self._index_chunks)]
            value = np.concatenate(vals) if vals else np.zeros(0, np.float32)
        else:
            value = None
        return RowBlock(
            offset=np.asarray(self._offsets, np.int64),
            label=np.asarray(self._labels, np.float32),
            index=(np.concatenate(self._index_chunks)
                   if self._index_chunks else np.zeros(0, np.uint64)),
            value=value,
            weight=(np.asarray(self._weights, np.float32)
                    if self._has_weight else None),
        )


def concat_blocks(blocks: List[RowBlock]) -> RowBlock:
    if len(blocks) == 1:
        return blocks[0]
    c = RowBlockContainer()
    for b in blocks:
        c.extend_block(b)
    return c.finalize()
