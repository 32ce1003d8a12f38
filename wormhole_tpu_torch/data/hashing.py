"""Feature-id hashing and key folding.

A copy of ``wormhole_tpu/data/hashing.py``. The text formats hash criteo's
categorical strings with ``crc32_hash`` and fold 64-bit ids into
``[0, num_buckets)`` with the splitmix64 mixer (``fold_keys``, the
Localizer's fold); the crec2 writer folds each u32 key with the murmur3
fmix32 mixer (``fold_keys32``). Both packages must bucket a key identically,
so a file written or a model saved by one is read by the other.
"""

from __future__ import annotations

import zlib

import numpy as np

_U64 = np.uint64
_U32 = np.uint32


def crc32_hash(data: bytes) -> int:
    """32-bit string hash for categorical features (crc32.h analogue)."""
    return zlib.crc32(data) & 0xFFFFFFFF


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 over a uint64 array."""
    x = x.astype(_U64, copy=True)
    with np.errstate(over="ignore"):
        x += _U64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


def mix32_np(x: np.ndarray) -> np.ndarray:
    """Finalizing 32-bit mixer (murmur3 fmix32 constants), vectorized numpy."""
    x = x.astype(_U32, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> _U32(16)
        x *= _U32(0x85EBCA6B)
        x ^= x >> _U32(13)
        x *= _U32(0xC2B2AE35)
        return x ^ (x >> _U32(16))


def fold_keys32(keys: np.ndarray, num_buckets: int) -> np.ndarray:
    """Fold a 32-bit key space into [0, num_buckets) via mix32 (localizer.h
    :88-96 semantics, collisions accepted)."""
    return (mix32_np(keys) % _U32(num_buckets)).astype(np.int64)


def key64_to_key32(keys: np.ndarray) -> np.ndarray:
    """Map the 64-bit text-parser id space onto crec's u32 keys (splitmix64
    then truncate). 0xFFFFFFFF is reserved as the missing-slot sentinel."""
    k = splitmix64_np(np.asarray(keys, _U64)).astype(_U32)
    return np.where(k == _U32(0xFFFFFFFF), _U32(0xFFFFFFFE), k)


def fold_keys(keys: np.ndarray, num_buckets: int,
              hashed: bool = True) -> np.ndarray:
    """Fold a 64-bit key space into [0, num_buckets) bucket ids
    (``key % FLAGS_max_key`` after an optional hash, localizer.h:88-96;
    collisions accepted). ``hashed=True`` mixes first so adjacent raw ids
    spread across buckets."""
    k = keys.astype(_U64, copy=False)
    if hashed:
        k = splitmix64_np(k)
    return (k % _U64(num_buckets)).astype(np.int64)
