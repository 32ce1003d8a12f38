"""Sparse matrix-vector products on padded batches, and the segmented sum.

The counterpart of ``wormhole_tpu/ops/spmv.py`` (reference
``learn/linear/base/spmv.h:10-121``). The CSR block arrives as fixed-shape
``(mb, max_nnz)`` local-id/value tensors (``data/feed.py``), so

- ``spmv_times`` (y = X w) is a gather of ``w`` at ``cols`` and a row sum;
- ``spmv_trans_times`` (y = Xᵀ d) sums ``d·vals`` into the key axis.

The JAX package writes the second as a scatter-add. On a CUDA device
``index_add_``/``scatter_add_`` (and autograd's backward of a gather) add
with float atomics in an order that changes from run to run, which would
break the port's rule that a step returns the same bits on every run. So
every sum into the key axis here goes through ``segment_sum``: a stable
sort of the flat local ids, then ``torch.segment_reduce``, which adds each
key's entries one after another in the order they had in the flat batch.
That is the order of the JAX package's scatter on the CPU, on any device.
"""

from __future__ import annotations

from typing import Tuple

import torch


def segment_index(ids: torch.Tensor, num: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, offsets) of the flat ids ``ids`` (values in [0, num)):
    ``order`` sorts them stably, and key ``i``'s entries are
    ``order[offsets[i]:offsets[i + 1]]``, in flat order. Built once per
    batch and shared by every ``segment_sum`` over it; no host sync."""
    ids = ids.reshape(-1).to(torch.int64)
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.arange(num + 1, dtype=torch.int64, device=ids.device)
    return order, torch.searchsorted(sorted_ids, bounds)


def segment_sum(index: Tuple[torch.Tensor, torch.Tensor],
                data: torch.Tensor) -> torch.Tensor:
    """out[i, c] = Σ data[j, c] over the entries j of key i, added in flat
    order from 0 (``index`` from ``segment_index``; ``data`` (N, C) or
    (N,), one row per flat id). Keys with no entry get 0."""
    order, offsets = index
    d2 = data.reshape(order.shape[0], -1)[order]
    out = torch.segment_reduce(d2, "sum", offsets=offsets, axis=0,
                               unsafe=True)
    return out if data.dim() > 1 else out[:, 0]


def spmv_times(cols: torch.Tensor, vals: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """y = X w.  cols/vals: (mb, max_nnz); w: (k,) → y: (mb,). Padding
    entries have vals == 0 so they contribute nothing."""
    return torch.sum(vals * w[cols.to(torch.int64)], 1)


def spmv_trans_times(cols: torch.Tensor, vals: torch.Tensor,
                     dual: torch.Tensor, num_keys: int,
                     index=None) -> torch.Tensor:
    """y = Xᵀ d.  dual: (mb,) → y: (num_keys,), each key's entries summed
    in flat order (``segment_sum``; ``index`` reuses a batch's
    ``segment_index``)."""
    if index is None:
        index = segment_index(cols, num_keys)
    return segment_sum(index, (vals * dual[:, None]).reshape(-1))


def row_nnz(vals: torch.Tensor) -> torch.Tensor:
    """Number of real entries per row (padding is exactly 0)."""
    return torch.sum(vals != 0, -1)
