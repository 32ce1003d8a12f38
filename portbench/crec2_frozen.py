"""A frozen copy of the crec2 file layout, its numpy encoder and the
``mix32`` key fold, as the port reads them.

The benchmark writes its own crec2 files with this copy, never with the
port's ``CRec2Writer``, so a later change to the program cannot move the
yardstick: a test holds these bytes equal to the port's writer on a small
spec, and any change to the port's format shows there as a difference.

Layout (little endian): a 48-byte header, magic ``WCREC\\x04\\0\\0``, nnz
u32, block_rows u32, total_rows u64, nb u32, subblocks u32, cap u32,
ovf_cap u32, reserved u64; then fixed-size blocks of

    pw     u32[T * S/GS * GS*C]   packed pair words, grouped by 16K-bucket tile
    labels u8[block_rows]         0/1, 255 = padded row
    ovf_b  u32[ovf_cap]           spill buckets, 0xFFFFFFFF = unused slot
    ovf_r  u32[ovf_cap]           spill rows (block-global)

A pair word packs (bucket % 16384, row % 8192) as lo | hi << 7 | rlo << 16
| rhi << 23; a pad word is 511 << 7. Pairs past ``cap`` in their (subblock,
tile) cell spill to the COO list in tile order.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

TILE = 128 * 128          # buckets a tile
RSUB = 64 * 128           # rows a subblock
PADWORD = np.uint32(511 << 7)
SENTINEL = np.uint32(0xFFFFFFFF)
PAD_LABEL = 255
MAGIC2 = b"WCREC\x04\x00\x00"
HDR2 = struct.Struct("<8sIIQIIIIQ")


def group_of(subblocks: int) -> int:
    """Subblocks batched per pairs-array slice: the largest of 4, 2, 1 that
    divides ``subblocks``."""
    return max(g for g in (4, 2, 1) if subblocks % g == 0)


def pairs_shape(nb: int, subblocks: int, cap: int) -> Tuple[int, int, int]:
    g = group_of(subblocks)
    return nb // TILE, subblocks // g, g * cap


def default_cap(nnz: int, nb: int) -> int:
    """Per-(subblock, tile) pair capacity: mean + 3 sigma of the binomial
    tile occupancy of hashed-uniform keys, rounded up to 128."""
    mean = RSUB * nnz / (nb // TILE)
    return max(128, int(-(-(mean + 3 * mean ** 0.5) // 128)) * 128)


def mix32(x: np.ndarray) -> np.ndarray:
    """The murmur3 fmix32 finalizer on u32 keys."""
    x = x.astype(np.uint32, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        return x ^ (x >> np.uint32(16))


def fold(keys: np.ndarray, nb: int) -> np.ndarray:
    """u32 keys -> int64 buckets in [0, nb)."""
    return (mix32(keys) % np.uint32(nb)).astype(np.int64)


def pairs_of(keys: np.ndarray, nb: int) -> Tuple[np.ndarray, np.ndarray]:
    """(bucket, row) int64 of every real key of a (rows, nnz) u32 grid, in
    row-major order."""
    rr, cc = np.nonzero(keys != SENTINEL)
    return fold(keys[rr, cc], nb), rr.astype(np.int64)


def _pack(b: np.ndarray, r: np.ndarray) -> np.ndarray:
    b = b.astype(np.uint32)
    r = r.astype(np.uint32)
    return ((b & 127) | ((b >> 7) << 7)
            | ((r & np.uint32(127)) << 16) | ((r >> 7) << 23))


def spill_mask(buckets: np.ndarray, rows: np.ndarray, nb: int,
               cap: int) -> np.ndarray:
    """True for each pair (given in row-major order, as ``pairs_of`` yields
    them) that the encoder spills: past ``cap`` in its (subblock, tile)
    cell, in that order."""
    cell = (rows // RSUB) * (nb // TILE) + (buckets >> 14)
    order = np.argsort(cell, kind="stable")
    cs = cell[order]
    first = np.ones(len(cs), bool)
    first[1:] = cs[1:] != cs[:-1]
    idx = np.arange(len(cs))
    run_start = np.maximum.accumulate(np.where(first, idx, 0))
    out = np.zeros(len(cs), bool)
    out[order] = (idx - run_start) >= cap
    return out


def spill_count(buckets: np.ndarray, rows: np.ndarray, nb: int,
                cap: int) -> int:
    """How many pairs the encoder spills: those past ``cap`` in their
    (subblock, tile) cell."""
    cells = np.bincount((rows // RSUB) * (nb // TILE) + (buckets >> 14))
    return int(np.maximum(cells - cap, 0).sum())


def encode_block(buckets: np.ndarray, rows: np.ndarray, nb: int,
                 subblocks: int, cap: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pw u32 pairs_shape, spill buckets u32, spill rows u32) of one
    block's (bucket, block-row) pairs, rows in [0, subblocks * RSUB)."""
    T = nb // TILE
    pw = np.empty((subblocks, T, cap), np.uint32)
    ovb: List[np.ndarray] = []
    ovr: List[np.ndarray] = []
    sub = rows // RSUB
    for s in range(subblocks):
        m = sub == s
        b, r = buckets[m], rows[m] % RSUB
        tile = b >> 14
        order = np.argsort(tile, kind="stable")
        tile_s = tile[order]
        counts = np.bincount(tile_s, minlength=T)
        starts = np.zeros(T + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        out = np.full((T, cap), PADWORD, np.uint32)
        words = _pack(b & 16383, r)[order]
        idx = np.arange(len(tile_s)) - starts[tile_s]
        keep = idx < cap
        out[tile_s[keep], idx[keep]] = words[keep]
        pw[s] = out
        spill = ~keep
        if spill.any():
            ovb.append(b[order][spill].astype(np.uint32))
            ovr.append((r[order][spill] + s * RSUB).astype(np.uint32))
    pw = np.swapaxes(pw, 0, 1).reshape(pairs_shape(nb, subblocks, cap))
    return (pw,
            np.concatenate(ovb) if ovb else np.zeros(0, np.uint32),
            np.concatenate(ovr) if ovr else np.zeros(0, np.uint32))


def block_bytes(keys: np.ndarray, labels: np.ndarray, nb: int,
                subblocks: int, cap: int, ovf_cap: int) -> bytes:
    """One block's bytes: ``keys`` (block_rows, nnz) u32 with SENTINEL
    empties, ``labels`` (block_rows,) u8 with PAD_LABEL on padded rows.
    Raises when the spill exceeds ``ovf_cap``."""
    b, r = pairs_of(keys, nb)
    pw, ob, orow = encode_block(b, r, nb, subblocks, cap)
    if len(ob) > ovf_cap:
        raise ValueError(f"block spill {len(ob)} > ovf_cap {ovf_cap}")
    fb = np.full(ovf_cap, SENTINEL, np.uint32)
    fr = np.zeros(ovf_cap, np.uint32)
    fb[:len(ob)] = ob
    fr[:len(orow)] = orow
    return (pw.tobytes() + np.ascontiguousarray(labels, np.uint8).tobytes()
            + fb.tobytes() + fr.tobytes())


def header(nnz: int, block_rows: int, total_rows: int, nb: int,
           subblocks: int, cap: int, ovf_cap: int) -> bytes:
    return HDR2.pack(MAGIC2, nnz, block_rows, total_rows, nb, subblocks, cap,
                     ovf_cap, 0)
