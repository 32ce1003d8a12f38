"""Localizer: map a minibatch's global 64-bit feature ids to dense local ids.

A copy of ``Localizer`` and ``Localized`` from
``wormhole_tpu/data/localizer.py``. Rebuild of the reference ``Localizer``
(``learn/linear/base/localizer.h:18-181``): produces (a) the sorted unique
key vector that becomes the parameter pull/push key set, (b) a RowBlock
whose indices are remapped to [0, k), and (c) per-key frequencies for tail-
feature filtering (``config.proto tail_feature_freq``). The optional
``num_buckets`` fold is the reference's ``FLAGS_max_key`` hash kernel
(localizer.h:88-96) — collisions are accepted by design.

The parallel sort + dedup of the reference becomes ``np.unique`` (which also
yields the inverse remap in one pass).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from wormhole_tpu_torch.data.hashing import fold_keys
from wormhole_tpu_torch.data.rowblock import RowBlock


@dataclass
class Localized:
    """Result of localizing one minibatch."""
    uniq_keys: np.ndarray   # int64/uint64 (k,) sorted unique (possibly folded) keys
    block: RowBlock         # indices remapped to [0, k) (uint32)
    freq: np.ndarray        # int32 (k,) occurrence counts


class Localizer:
    def __init__(self, num_buckets: int = 0, hashed: bool = True,
                 tail_freq: int = 0) -> None:
        self.num_buckets = num_buckets
        self.hashed = hashed
        self.tail_freq = tail_freq

    def localize(self, blk: RowBlock) -> Localized:
        keys = blk.index
        if self.num_buckets:
            keys = fold_keys(keys, self.num_buckets, self.hashed)
        uniq, inverse, freq = np.unique(keys, return_inverse=True,
                                        return_counts=True)
        value = blk.value
        if self.tail_freq > 0:
            keep = freq > self.tail_freq
            if not keep.all():
                # drop tail features: entries mapping to dropped keys are
                # removed from the CSR block (reference filter_tail path)
                kept_ids = np.cumsum(keep) - 1  # new local id per old uid
                entry_keep = keep[inverse]
                per_row = np.diff(blk.offset)
                row_ids = np.repeat(np.arange(blk.size), per_row)
                new_per_row = np.bincount(row_ids[entry_keep],
                                          minlength=blk.size)
                inverse = kept_ids[inverse[entry_keep]]
                uniq, freq = uniq[keep], freq[keep]
                offset = np.zeros(blk.size + 1, np.int64)
                np.cumsum(new_per_row, out=offset[1:])
                if value is not None:
                    value = value[entry_keep]
                blk = RowBlock(offset=offset, label=blk.label,
                               index=blk.index[entry_keep], value=value,
                               weight=blk.weight)
        local = RowBlock(
            offset=blk.offset,
            label=blk.label,
            index=inverse.astype(np.uint32),
            value=value,
            weight=blk.weight,
        )
        return Localized(uniq_keys=uniq, block=local,
                         freq=freq.astype(np.int32))

