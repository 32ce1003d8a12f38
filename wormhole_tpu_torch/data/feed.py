"""Device feed: pad ragged CSR minibatches into fixed-shape dense tensors.

The counterpart of ``SparseBatch``, ``pad_to_batch``, ``next_bucket``,
``nnz_bucket`` and ``batch_max_nnz`` in ``wormhole_tpu/data/feed.py``. Torch
needs no static shapes, but the port keeps the JAX package's padding and
positional truncation: ``(mb, max_nnz)`` index/value tensors plus masks,
and the per-batch unique-key vector padded to a bucketed length. Padding
entries point at local id 0 with value 0, so every op (gather, segmented
sum) treats them as no-ops; padded keys carry a zero mask so their
parameter updates vanish. The shapes, and so the order of every sum, are
the JAX package's.

``SparseBatch.to`` moves a host batch to the device from pinned memory with
``non_blocking`` copies, optionally on a side stream (the ``DeviceFeed``
transfer thread); ``wait`` then orders the consumer's stream after that
copy. ``num_real`` and ``num_keys`` (the real rows and keys; the rest are
padding) survive the move, and so does a reference to the host batch, whose
labels and row mask the eval pooling reads without a device round trip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from wormhole_tpu_torch.data.localizer import Localized
from wormhole_tpu_torch.data.rowblock import RowBlock

TENSOR_FIELDS = ("cols", "vals", "labels", "row_mask", "uniq_keys",
                 "key_mask")


@dataclass
class SparseBatch:
    """Fixed-shape padded sparse minibatch.

    cols[i, j] is the *local* feature id of the j-th entry of row i (0 when
    padded — harmless because vals is 0 there); uniq_keys maps local ids
    back to global bucket ids for parameter pull/push."""

    cols: torch.Tensor       # int32 (mb, max_nnz)
    vals: torch.Tensor       # f32   (mb, max_nnz); 0 on padding
    labels: torch.Tensor     # f32   (mb,)
    row_mask: torch.Tensor   # f32   (mb,); row weight, 0 on a padded row
    uniq_keys: torch.Tensor  # int32 (kpad,); global bucket id per local id
    key_mask: torch.Tensor   # f32   (kpad,); 1 real key, 0 padding
    num_real: Optional[int] = None        # real rows (pad_to_batch)
    num_keys: Optional[int] = None        # real keys, the first of uniq_keys
    host: Optional["SparseBatch"] = None  # the host batch of a device copy
    ready: Any = None        # CUDA event recorded after a side-stream copy

    @property
    def device(self) -> torch.device:
        return self.cols.device

    def on_host(self) -> "SparseBatch":
        """The host copy of this batch (itself when it is on the CPU)."""
        return self if self.host is None else self.host

    def to(self, device, non_blocking: bool = False,
           stream=None) -> "SparseBatch":
        """This batch on ``device``. For a CUDA device the host tensors go
        through pinned memory and ``non_blocking`` copies, issued on
        ``stream`` when given (an event recorded there after the copies
        becomes ``ready``; ``wait`` orders the consumer after it)."""
        device = torch.device(device)
        if device.type != "cuda":
            return self
        src = {f: getattr(self, f) for f in TENSOR_FIELDS}
        if non_blocking:
            src = {f: t.pin_memory() for f, t in src.items()}
        ready = None
        if stream is not None:
            with torch.cuda.stream(stream):
                out = {f: t.to(device, non_blocking=non_blocking)
                       for f, t in src.items()}
                ready = torch.cuda.Event()
                ready.record(stream)
        else:
            out = {f: t.to(device, non_blocking=non_blocking)
                   for f, t in src.items()}
        return SparseBatch(**out, num_real=self.num_real,
                           num_keys=self.num_keys, host=self.on_host(),
                           ready=ready)

    def wait(self) -> "SparseBatch":
        """Order the current stream after this batch's side-stream copy
        and hand its tensors to that stream (``record_stream``), so the
        caching allocator does not reuse them while the step still reads
        them. A no-op for a batch copied on the current stream."""
        if self.ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(self.ready)
            for f in TENSOR_FIELDS:
                getattr(self, f).record_stream(cur)
            self.ready = None
        return self


def _scatter_padded(blk: RowBlock, mb: int, max_nnz: int):
    """Shared CSR→padded-dense scatter: (cols, vals, labels, row_mask).

    Rows with more than ``max_nnz`` entries are truncated positionally (the
    first ``max_nnz`` entries in storage order are kept)."""
    n = blk.size
    assert n <= mb, (n, mb)
    cols = np.zeros((mb, max_nnz), np.int32)
    vals = np.zeros((mb, max_nnz), np.float32)
    if blk.nnz:
        per_row = np.diff(blk.offset).astype(np.int64)
        row_ids = np.repeat(np.arange(n, dtype=np.int64), per_row)
        pos = np.arange(blk.nnz, dtype=np.int64) - np.repeat(
            blk.offset[:-1].astype(np.int64), per_row)
        keep = pos < max_nnz
        cols[row_ids[keep], pos[keep]] = blk.index[keep].astype(np.int64)
        vals[row_ids[keep], pos[keep]] = blk.values_or_ones()[keep]
    labels = np.zeros(mb, np.float32)
    labels[:n] = blk.label
    row_mask = np.zeros(mb, np.float32)
    row_mask[:n] = 1.0
    if blk.weight is not None:
        row_mask[:n] = blk.weight
    return cols, vals, labels, row_mask


def next_bucket(n: int, minimum: int = 256) -> int:
    """Round up to a power of two (the JAX package's shape bucketing)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def pad_to_batch(loc: Localized, minibatch_size: int,
                 max_nnz: int, key_pad: Optional[int] = None,
                 key_dtype=np.int32) -> SparseBatch:
    """Pad a localized RowBlock into a host SparseBatch (CPU tensors over
    the numpy arrays).

    Rows with more than ``max_nnz`` entries are truncated positionally (the
    first ``max_nnz`` entries in storage order are kept). ``uniq_keys``
    must fit ``key_dtype``: a silent wraparound would corrupt parameter
    pull/push, so it raises instead."""
    blk = loc.block
    mb = minibatch_size
    cols, vals, labels, row_mask = _scatter_padded(blk, mb, max_nnz)

    k = len(loc.uniq_keys)
    kpad = key_pad or next_bucket(k)
    if k > kpad:
        raise ValueError(
            f"batch has {k} unique keys but key_pad={kpad}: raise "
            "key_pad (it must cover minibatch x max row nnz worth of "
            "distinct hashed keys) or lower minibatch")
    if k and int(loc.uniq_keys.max()) > np.iinfo(key_dtype).max:
        raise OverflowError(
            f"uniq key {int(loc.uniq_keys.max())} exceeds "
            f"{np.dtype(key_dtype)}; fold the key space with "
            "Localizer(num_buckets=...) or pass key_dtype=np.int64")
    uniq = np.zeros(kpad, key_dtype)
    uniq[:k] = loc.uniq_keys.astype(key_dtype)
    key_mask = np.zeros(kpad, np.float32)
    key_mask[:k] = 1.0
    arrays = dict(cols=cols, vals=vals, labels=labels, row_mask=row_mask,
                  uniq_keys=uniq, key_mask=key_mask)
    return SparseBatch(**{f: torch.from_numpy(a) for f, a in arrays.items()},
                       num_real=blk.size, num_keys=k)


def nnz_bucket(densest: int, cap: int = 4096) -> int:
    """The per-row padded-nnz bucketing policy: power-of-two, min 8,
    capped (denser rows are positionally truncated)."""
    return min(next_bucket(max(densest, 1), 8), cap)


def batch_max_nnz(blk: RowBlock, cap: int = 4096) -> int:
    return nnz_bucket(blk.max_row_nnz(), cap)

