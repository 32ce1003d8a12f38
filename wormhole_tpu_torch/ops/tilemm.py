"""Tile-grouped crec2 pairs: layout, host encoder, and the train-step ops.

The counterpart of ``wormhole_tpu/ops/tilemm.py``. The bucket space
``[0, nb)`` is cut into tiles of 16384 = (hi 128) x (lo 128) buckets and a
block's rows into subblocks of 8192 = (rhi 64) x (rlo 128) rows. Offline, the
crec2 writer groups each block's (bucket, row) pairs by tile and packs the
four digits of a pair into one u32 word: lo = bits 0..6, hi = 7..15 (9 bits,
so the pad word 511 << 7 is representable), rlo = 16..22, rhi = 23..28. Pairs
past ``cap`` in their (subblock, tile) cell spill to an exact COO list.

The layout, constants and the numpy encoder are copies of the JAX package's
(``tilemm.py:66-256``), so both packages write and read the same bytes. The
device half differs: the TPU ran the gather and the scatter as one-hot MXU
matmuls because it has no fast gather; Hopper has one, so the ops launch
hand-written kernels from ``csrc/`` on a CUDA tensor:

- ``forward_margins`` → ``tile_fwd.cu`` (margins of one block);
- ``backward_grad`` → ``tile_bwd.cu`` (the per-bucket gradient, any spec);
- ``fused_step_grad`` / ``fused_step_update`` → ``tile_step.cu`` (a whole
  train step: forward, dual, backward, and the FTRL update in place);
- ``loss_dual`` / ``ftrl_push`` → ``tile_step.cu`` (the split path's
  elementwise math, the same device functions the fused steps run).

The multi-channel ops of the FM and wide&deep models (``models/``):

- ``forward_pulls`` / ``backward_pushes`` → ``tile_multi.cu`` (the (rows,
  ch) pooled pulls and the (nb, ch) channel pushes; ``pull_index`` and
  ``push_index`` run their row and bucket indexes alone);
- ``fused_fm_step`` → ``tile_fm_step.cu`` (pulls, the FM margin, dual and
  push channels, pushes), with ``fm_boundary`` its boundary math alone;
- ``fused_wd_step`` → ``tile_wd_step.cu`` (pulls, the MLP forward and vjp,
  pushes, parameter grads), with ``wd_boundary`` its boundary alone;
  ``mlp_forward`` is the MLP's plain version.

Each has a plain torch version beside it (``*_plain``): the wrapper runs it
for a CPU tensor, and only there; a CUDA tensor launches the kernel or
raises. ``wd_boundary_ordered_plain`` repeats the boundary kernel's order of
operations, so the card holds the kernel to it bitwise. Each wrapper counts
its launches in ``.launches``. The kernels sum in fixed orders without
float atomics, so they return the same bits on every run, and the fused
steps equal the split chain bitwise. The COO spill adds
(``spill_margin_rows``, ``spill_grad_scatter``, ``spill_pull_rows``,
``spill_push_scatter``) stay in torch and are deterministic too.
``resolve_step_kernel`` picks fused or split as the JAX package does, with
``auto`` resolving to fused on a CUDA device.

Device operands: ``pw`` is int32 (every field sits below bit 29, so the u32
words read the same), ``w`` and the row vectors float32; the spill lists are
int32, the ``0xFFFFFFFF`` unused-slot sentinel reading as -1. The FTRL slots
are the store's plane-major ``(3, nb)`` float32 table.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from wormhole_tpu_torch.ops import _ext
from wormhole_tpu_torch.ops.loss import (LOSS_IDS, create_loss, loss_key,
                                         nudge_zero_dual)

A_HI = 128          # bucket hi digit
B_LO = 128          # bucket lo digit
TILE = A_HI * B_LO  # buckets per tile
RH = 64             # row hi digit
RL = 128            # row lo digit
RSUB = RH * RL      # rows per subblock (8192)

# packed pair word (u32): lo | hi<<7 | rlo<<16 | rhi<<23
LO_SH, HI_SH, RLO_SH, RHI_SH = 0, 7, 16, 23
LO_M, HI_M, RLO_M, RHI_M = 127, 511, 127, 63
PADWORD = np.uint32(511 << HI_SH)
OVF_SENTINEL = -1   # 0xFFFFFFFF spill-bucket sentinel, read as int32

@dataclass(frozen=True)
class TileSpec:
    """Static layout of one encoded block (stored in the crec2 header).

    ``tiles_step`` and ``fuse`` are TPU grid parameters the port's kernels
    do not use; they are kept so a spec compares equal across packages."""

    nb: int              # model buckets; multiple of TILE
    subblocks: int       # S: rows per block = S * 8192
    cap: int             # C: max pairs per (subblock, tile); mult of 128
    group: int = 4       # GS: subblocks batched per pairs-array slice
    tiles_step: int = 4  # TB: tiles per TPU grid step
    fuse: int = 1        # K: adjacent tiles fused per TPU bwd value chain

    def __post_init__(self):
        if self.nb % TILE:
            raise ValueError(f"nb {self.nb} not a multiple of {TILE}")
        if self.subblocks % self.group:
            raise ValueError("subblocks must be a multiple of group")
        if self.cap % 128:
            raise ValueError("cap must be a multiple of 128")
        if self.tiles % self.tiles_step:
            raise ValueError(f"tiles {self.tiles} not a multiple of "
                             f"tiles_step {self.tiles_step}")
        if self.fuse > 1 and self.tiles_step % self.fuse:
            raise ValueError(f"tiles_step {self.tiles_step} not a "
                             f"multiple of fuse {self.fuse}")

    @property
    def tiles(self) -> int:
        return self.nb // TILE

    @property
    def block_rows(self) -> int:
        return self.subblocks * RSUB

    @property
    def n(self) -> int:  # pairs per grouped slice
        return self.group * self.cap

    @property
    def pairs_shape(self) -> Tuple[int, int, int]:
        return (self.tiles, self.subblocks // self.group, self.n)


def make_spec(nb: int, subblocks: int, cap: int) -> TileSpec:
    """TileSpec with the largest group (<=4) and tiles_step (<=16) that
    divide the given shape, and the JAX package's fuse rule — the same
    spec ``wormhole_tpu.ops.tilemm.make_spec`` returns."""
    group = max(g for g in (4, 2, 1) if subblocks % g == 0)
    tiles = nb // TILE
    tb = max(t for t in (16, 8, 4, 2, 1) if tiles % t == 0)
    fuse = 1
    if cap <= 256:
        while (group * cap * fuse * 2 <= 8192 and fuse * 2 <= min(tb, 8)):
            fuse *= 2
    return TileSpec(nb=nb, subblocks=subblocks, cap=cap, group=group,
                    tiles_step=tb, fuse=fuse)


# ---------------------------------------------------------------------------
# offline encoder (host, numpy) — used by the crec2 writer and tests
# ---------------------------------------------------------------------------

def pack_fields(bucket_in_tile: np.ndarray, row_in_sub: np.ndarray
                ) -> np.ndarray:
    """Digit-encode (bucket % TILE, row % RSUB) into packed u32 words."""
    b = bucket_in_tile.astype(np.uint32)
    r = row_in_sub.astype(np.uint32)
    return ((b & 127) | ((b >> 7) << HI_SH)
            | ((r & np.uint32(RL - 1)) << RLO_SH) | ((r >> 7) << RHI_SH))


def unpack_fields(pw: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """(bucket_in_tile, row_in_sub, is_pad) from packed words."""
    pw = pw.astype(np.uint32)
    hi = (pw >> HI_SH) & HI_M
    b = (hi << 7) | (pw & LO_M)
    r = (((pw >> RHI_SH) & RHI_M) << 7) | ((pw >> RLO_SH) & RLO_M)
    return b, r, hi >= 128


def encode_subblock(buckets: np.ndarray, rows: np.ndarray,
                    spec: TileSpec) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """Group one subblock's pairs by tile.

    buckets int64 (P,) in [0, nb); rows (P,) in [0, 8192).
    Returns (pw u32 (T, cap), ovf_buckets, ovf_rows);
    overflow = pairs beyond `cap` in their tile (exact COO spill).
    """
    T, C = spec.tiles, spec.cap
    tile = buckets >> 14
    order = np.argsort(tile, kind="stable")
    tile_s = tile[order]
    counts = np.bincount(tile_s, minlength=T)
    starts = np.zeros(T + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    out = np.full((T, C), PADWORD, np.uint32)
    pw_s = pack_fields(buckets & 16383, rows)[order]
    idx = np.arange(len(tile_s)) - starts[tile_s]
    keep = idx < C
    out[tile_s[keep], idx[keep]] = pw_s[keep]
    spill = ~keep
    return (out,
            buckets[order][spill].astype(np.uint32),
            rows[order][spill].astype(np.uint32))


def encode_block(buckets: np.ndarray, rows: np.ndarray,
                 spec: TileSpec) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """Encode a whole block of valid (bucket, global-row) pairs.

    rows in [0, block_rows). Returns (pw (T, S//GS, N) u32,
    ovf_buckets u32, ovf_rows u32 (block-global rows))."""
    S, T, C = spec.subblocks, spec.tiles, spec.cap
    pw = np.empty((S, T, C), np.uint32)
    ovb: List[np.ndarray] = []
    ovr: List[np.ndarray] = []
    sub = rows // RSUB
    for s in range(S):
        m = sub == s
        p, ob, orow = encode_subblock(buckets[m], rows[m] % RSUB, spec)
        pw[s] = p
        if len(ob):
            ovb.append(ob)
            ovr.append(orow + s * RSUB)
    # (S,T,C) -> (T,S,C) -> group-flattened kernel layout
    pw = np.swapaxes(pw, 0, 1).reshape(spec.pairs_shape)
    return (pw,
            np.concatenate(ovb) if ovb else np.zeros(0, np.uint32),
            np.concatenate(ovr) if ovr else np.zeros(0, np.uint32))


def encode_block_capped(buckets: np.ndarray, rows: np.ndarray,
                        spec: TileSpec, ovf_cap: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """``encode_block`` with fixed-width overflow arrays: ``(pw, ovf_b,
    ovf_r, n_ovf)`` where the overflow arrays are exactly ``ovf_cap`` long
    (unused slots carry 0xFFFFFFFF buckets and row 0) and ``n_ovf`` is the
    TRUE overflow count — callers check ``n_ovf > ovf_cap`` before
    trusting the arrays."""
    pw, ovb, ovr = encode_block(buckets, rows, spec)
    n_ovf = len(ovb)
    ob = np.full(max(ovf_cap, 0), 0xFFFFFFFF, np.uint32)
    orow = np.zeros(max(ovf_cap, 0), np.uint32)
    keep = min(n_ovf, ovf_cap)
    ob[:keep] = ovb[:keep]
    orow[:keep] = ovr[:keep]
    return pw, ob, orow, n_ovf


# ---------------------------------------------------------------------------
# operand checks, scratch and the kernel libraries
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, want {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(n: int, device, **rows) -> None:
    """Each of ``rows`` an (n,) f32 contiguous vector on ``device``."""
    for name, t in rows.items():
        _check(name, t, torch.float32, (n,), device)


def _check_slots(slots: torch.Tensor, nb: int, device) -> None:
    _check("slots", slots, torch.float32, (3, nb), device)
    if nb % TILE:
        raise ValueError(f"nb {nb} not a multiple of {TILE}")


def _lib(name: str, fn: str, argtypes) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with ``fn``'s C signature set."""
    lib = _ext.load(name)
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# bins of 512 buckets a tile of csrc/tile_bwd.cuh's backward: one warp each,
# 8,192 at full width. The split push (``ftrl_push``) and the fused update
# sum Σ(Δw)² over the same bins, so the count is part of both paths' bits;
# the kernels take no other.
BWD_SPANS = 32


def _span_scratch(spec: TileSpec, device) -> Tuple[torch.Tensor, int]:
    """(scratch, rows a span) of the tile passes of csrc/tile_fwd.cuh and
    csrc/tile_bwd.cuh: each subblock's 8192 rows cut into ceil(SMs /
    subblocks) spans, one CTA each, so the forward's (span, subblock) grid
    fills the card once (11 spans of 745 rows, 132 CTAs, at 12 subblocks on
    an H100); each tile's buckets into ``BWD_SPANS`` bins. The scratch holds
    a tile pass's packed value of every pair word (17.3 MB at full width)
    and the span or bin starts of every 1024-word chunk (0.4 MB), sized for
    whichever pass cuts more, so the fused steps run both passes in one
    buffer. Each row is summed in word order whatever the span, so the
    result does not depend on the rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = -(-RSUB // max(1, -(-sms // spec.subblocks)))
    T, SG, N = spec.pairs_shape
    spans = max(-(-RSUB // rows), BWD_SPANS)
    offs = spec.subblocks * T * -(-spec.cap // 1024) * (spans + 1)
    n = T * SG * N + -(-offs // 2)
    return torch.empty(n, dtype=torch.int32, device=device), rows


# ---------------------------------------------------------------------------
# forward margins: the plain torch version and the kernel wrapper
# ---------------------------------------------------------------------------

def _check_operands(pw: torch.Tensor, w: torch.Tensor,
                    spec: TileSpec) -> None:
    if pw.device != w.device:
        raise ValueError(f"pw on {pw.device} but w on {w.device}")
    if pw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"forward_margins: device {pw.device} unsupported")
    if pw.dtype != torch.int32:
        raise TypeError(f"pw must be int32 (u32 words viewed as int32), "
                        f"got {pw.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if tuple(pw.shape) != spec.pairs_shape:
        raise ValueError(f"pw shape {tuple(pw.shape)} != spec pairs_shape "
                         f"{spec.pairs_shape}")
    if tuple(w.shape) != (spec.nb,):
        raise ValueError(f"w shape {tuple(w.shape)} != ({spec.nb},)")
    if not (pw.is_contiguous() and w.is_contiguous()):
        raise ValueError("pw and w must be contiguous")


def decode_pairs(pw: torch.Tensor, spec: TileSpec
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(bucket, block row, valid) int64/int64/bool, each of pw's shape:
    the packed words decoded to global coordinates (pad words invalid)."""
    T, SG, _ = spec.pairs_shape
    GS, C = spec.group, spec.cap
    dev = pw.device
    p = pw.reshape(T, SG, GS, C).to(torch.int64)
    hi = (p >> HI_SH) & HI_M
    valid = hi < A_HI
    t = torch.arange(T, device=dev).view(T, 1, 1, 1)
    s = (torch.arange(SG, device=dev).view(1, SG, 1, 1) * GS
         + torch.arange(GS, device=dev).view(1, 1, GS, 1))
    bucket = t * TILE + ((hi & (A_HI - 1)) << 7 | (p & LO_M))
    row = s * RSUB + (((p >> RHI_SH) & RHI_M) << 7 | ((p >> RLO_SH) & RLO_M))
    return (bucket.reshape(pw.shape), row.reshape(pw.shape),
            valid.reshape(pw.shape))


def forward_margins_plain(pw: torch.Tensor, w: torch.Tensor,
                          spec: TileSpec) -> torch.Tensor:
    """margins (block_rows,) f32 = per row, the sum of bf16(w[bucket])
    over its pair words, from 0 in f32, left to right in word order, on any
    device: ``forward_pulls_plain``'s sums at one channel."""
    _check_operands(pw, w, spec)
    start, kr, kb = _word_csr(pw, spec, by_row=True)
    return _word_order_sums(start, kr, kb, w.view(spec.nb, 1),
                            spec.block_rows)[:, 0]


def _launch_tile_fwd(pw: torch.Tensor, w: torch.Tensor,
                     spec: TileSpec) -> torch.Tensor:
    lib = _lib("tile_fwd", "wh_tile_fwd", [_P] * 3 + [_L, _P] + [_I] * 5
               + [_P])
    T, SG, _ = spec.pairs_shape
    scratch, rows = _span_scratch(spec, pw.device)
    margins = torch.empty(spec.block_rows, dtype=torch.float32,
                          device=pw.device)
    with torch.cuda.device(pw.device):
        err = lib.wh_tile_fwd(pw.data_ptr(), w.data_ptr(), scratch.data_ptr(),
                              scratch.numel(), margins.data_ptr(), T, SG,
                              spec.group, spec.cap, rows, _stream(pw))
    _ext.check(lib, err, "tile_fwd")
    return margins


def _run_sums(keys: torch.Tensor, vals: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distinct keys, the sum of ``vals`` over each key), without float
    atomics: the pairs are sorted by key (stable), each run of equal keys
    is laid out along one row of an (n, n) zero-padded matrix — at most
    ``ovf_cap``² floats — and summed there by a fixed-order reduction. The
    same inputs give the same bits on every run, on the CPU and on CUDA.
    ``vals`` (n,) or (n, ch): a 2-D ``vals`` is summed column by column
    over the one sort."""
    n = keys.shape[0]
    dev = keys.device
    ks, order = torch.sort(keys, stable=True)
    vs = vals[order]
    idx = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = ks[1:] != ks[:-1]
    start = torch.cummax(torch.where(first, idx, 0), 0).values

    def col_sums(v):
        runs = torch.zeros((n, n), dtype=vals.dtype, device=dev)
        runs[start, idx - start] = v
        return runs.sum(1)[first]

    if vs.dim() == 1:
        return ks[first], col_sums(vs)
    return ks[first], torch.stack([col_sums(vs[:, c])
                                   for c in range(vs.shape[1])], 1)


def spill_margin_rows(w: torch.Tensor, ovf_b: torch.Tensor,
                      ovf_r: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """(block_rows,) f32 spill margins: each valid COO pair's f32 w lands
    on its row (sentinel slots add nothing), summed per row by
    ``_run_sums`` — deterministic without float atomics."""
    dev = w.device
    valid = ovf_b != OVF_SENTINEL
    b = torch.where(valid, ovf_b, 0).to(torch.int64)
    wv = torch.where(valid, w[b], torch.zeros((), dtype=w.dtype, device=dev))
    # sentinel slots sort into a dummy row past the block, dropped below
    r = torch.where(valid, ovf_r.to(torch.int64) % spec.block_rows,
                    spec.block_rows)
    rows, sums = _run_sums(r, wv)
    out = torch.zeros(spec.block_rows + 1, dtype=w.dtype, device=dev)
    out[rows] = sums
    return out[:spec.block_rows]


def forward_margins(pw: torch.Tensor, w: torch.Tensor, spec: TileSpec,
                    ovf_b: Optional[torch.Tensor] = None,
                    ovf_r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """margins (block_rows,) f32 = per row, the sum of bf16(w[bucket]) over
    its pair words, plus the f32 spill margins (``spill_margin_rows``).

    The wrapper of the ``csrc/tile_fwd.cu`` kernel, which replaces the TPU
    kernel ``wormhole_tpu/ops/tilemm.py:_fwd_kernel``: on a CUDA tensor it
    launches the kernel (and counts the launch in
    ``forward_margins.launches``) or raises; on a CPU tensor, and only
    there, it runs ``forward_margins_plain``. The kernel gives each CTA a
    span of one subblock's rows, owned outright: a tile pass gathers
    bf16(w) for every word from the tile's w slice in shared memory and
    sorts each 1024-word chunk by span, and the span's CTA reads only its
    words and sums each row from 0 in word order, with no float atomics
    and no partial slabs, so it equals the plain version bitwise and gives
    the same bits on every run (see the note in the source)."""
    _check_operands(pw, w, spec)
    if pw.device.type == "cuda":
        margins = _launch_tile_fwd(pw, w, spec)
        forward_margins.launches += 1
    else:
        margins = forward_margins_plain(pw, w, spec)
    if ovf_b is not None and ovf_b.shape[0]:
        margins = margins + spill_margin_rows(w, ovf_b, ovf_r, spec)
    return margins


forward_margins.launches = 0


# ---------------------------------------------------------------------------
# training: the step-kernel resolver
# ---------------------------------------------------------------------------

STEP_KERNELS = ("auto", "fused", "split")
ONEHOT_CACHES = ("auto", "on", "off")

_NO_ONEHOT_PLANES = ("the Hopper kernels gather and scatter the pair words "
                     "directly and build no one-hot planes to stage")


@dataclass(frozen=True)
class StepResolution:
    """Structured result of resolve_step_kernel: the resolved kernel, the
    split reason (empty when fused), and the one-hot cache decision with
    its off-reason. ``cache_record`` is the string the store's
    ``step_kernel`` records beside the split reason. ``dim`` and ``hidden``
    record the wide&deep geometry the step was resolved for (0 and () for
    the linear and FM steps)."""
    kernel: str
    why: str = ""
    cache: bool = False
    cache_why: str = ""
    dim: int = 0
    hidden: Tuple[int, ...] = ()

    @property
    def cache_record(self) -> str:
        return ("onehot_cache=on" if self.cache
                else f"onehot_cache=off:{self.cache_why}")


def _onehot_cache_decision(resolved: str, knob: str,
                           spec: Optional[TileSpec], channels: int,
                           deep: bool) -> Tuple[bool, str]:
    """The cache half of resolve_step_kernel. The structural exclusions keep
    the JAX package's wording; where the TPU would stage its planes, the
    port records that its kernels have none (the cache is never on)."""
    if knob == "off":
        return False, "forced off"
    if resolved != "fused":
        return False, "split path shares no phases"
    if channels > 1 or deep:
        return False, ("multi-channel kernels hoist one wide compare "
                       "across channels; no per-phase rebuild to stage")
    if spec is None:
        return False, "no tile spec at resolve time"
    if spec.fuse > 1:
        return False, ("fuse>1 re-views pairs into K-tile chains; the "
                       "staged planes do not align with the bwd view")
    return False, _NO_ONEHOT_PLANES


def resolve_step_kernel(kernel: str, *, ovf_cap: int = 0,
                        mesh: bool = False, deep: bool = False,
                        spec: Optional[TileSpec] = None,
                        onehot_cache: str = "auto", dim: int = 0,
                        hidden: Tuple[int, ...] = (),
                        channels: int = 1,
                        device="cuda") -> StepResolution:
    """Resolve the ``tile_step_kernel`` + ``tile_onehot_cache`` knobs to a
    :class:`StepResolution` (``wormhole_tpu/ops/tilemm.py:1086``): ``why``
    names the reason whenever the resolution is split, ``cache_why``
    whenever the one-hot cache is off (always, on Hopper). Structural
    inadmissibility (mesh, wide&deep spill, a wide&deep step with no spec)
    wins over a forced ``fused`` and never raises. ``auto`` resolves to
    fused on a CUDA ``device`` and to split, "auto on cpu device", on the
    CPU. ``dim``/``hidden`` (the wide&deep geometry) are accepted as the
    JAX resolver takes them and recorded in the resolution, but bound
    nothing: the TPU budgeted the in-kernel MLP phase against VMEM, and the
    port's fused steps are launch chains whose MLP boundary keeps a tile's
    activations in shared memory, or, for widths whose tile does not fit
    there, in a device-memory region of each CTA, so every width fuses here
    (ROADMAP C records the difference)."""
    if kernel not in STEP_KERNELS:
        raise ValueError(f"tile_step_kernel must be one of "
                         f"{STEP_KERNELS}, got {kernel!r}")
    if onehot_cache not in ONEHOT_CACHES:
        raise ValueError(f"tile_onehot_cache must be one of "
                         f"{ONEHOT_CACHES}, got {onehot_cache!r}")

    def res(k: str, why: str = "") -> StepResolution:
        cache, cwhy = _onehot_cache_decision(k, onehot_cache, spec,
                                             channels, deep)
        return StepResolution(k, why, cache, cwhy, dim, tuple(hidden))

    if mesh:
        return res("split", ("mesh psums (margins over model, grads "
                             "over data) sit between the phases the "
                             "fusion joins"))
    if deep:
        if ovf_cap > 0:
            return res("split", ("wide&deep spill needs the pull "
                                 "channels in HBM for the COO scatter "
                                 "between the phases"))
        if spec is None:
            return res("split", ("no tile spec at resolve time to "
                                 "budget the in-kernel MLP phase "
                                 "against VMEM"))
    if kernel == "split":
        return res("split", "forced")
    if kernel == "fused":
        return res("fused")
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        return res("fused")
    return res("split", f"auto on {dev_type} device")


# ---------------------------------------------------------------------------
# training: the loss dual and the FTRL push (split path's elementwise math)
# ---------------------------------------------------------------------------

def loss_dual_plain(margins, labels, mask, loss: str,
                    exact_dense: bool) -> torch.Tensor:
    """d objv / d margin per row [then the zero-dual nudge], plain torch."""
    dual = create_loss(loss)[1](margins, labels, mask)
    return dual if exact_dense else nudge_zero_dual(dual, labels, mask)


def loss_dual(margins: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor, loss: str,
              exact_dense: bool) -> torch.Tensor:
    """The split path's dual, (rows,) f32 from f32 margins/labels/mask. On
    a CUDA tensor it launches ``wh_loss_dual`` (csrc/tile_step.cu), the
    same ``__device__`` math the fused step runs at its phase boundary, so
    the two paths give the same bits; on a CPU tensor, and only there, it
    runs ``loss_dual_plain``."""
    key = loss_key(loss)
    n = margins.shape[0]
    for name, t in (("margins", margins), ("labels", labels),
                    ("mask", mask)):
        _check(name, t, torch.float32, (n,), margins.device)
    if margins.device.type != "cuda":
        return loss_dual_plain(margins, labels, mask, key, exact_dense)
    lib = _lib("tile_step", "wh_loss_dual",
               [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P])
    dual = torch.empty_like(margins)
    with torch.cuda.device(margins.device):
        err = lib.wh_loss_dual(margins.data_ptr(), labels.data_ptr(),
                               mask.data_ptr(), dual.data_ptr(), n,
                               LOSS_IDS[key], int(exact_dense),
                               _stream(margins))
    _ext.check(lib, err, "loss_dual")
    loss_dual.launches += 1
    return dual


loss_dual.launches = 0


def ftrl_push_plain(slots: torch.Tensor, grad: torch.Tensor,
                    handle) -> torch.Tensor:
    """``handle.update`` on the plane-major (3, nb) slots, in place;
    returns Σ(w' - w)² as a 0-d f32 tensor."""
    w_new, z_new, cg_new = handle.update(slots[0], slots[1], slots[2], grad)
    d0 = w_new - slots[0]
    wdelta2 = torch.sum(d0 * d0)
    slots[0], slots[1], slots[2] = w_new, z_new, cg_new
    return wdelta2


def ftrl_push(slots: torch.Tensor, grad: torch.Tensor,
              handle) -> torch.Tensor:
    """FTRL push of a (nb,) gradient into the plane-major (3, nb) f32
    slots, IN PLACE (the port keeps one table, not the JAX package's
    functional copy); returns Σ(w' - w)² (0-d f32), which the metric tail
    needs and the in-place update can no longer compute afterwards.

    On a CUDA tensor it launches ``wh_ftrl_push`` (csrc/tile_step.cu): one
    warp per bin of a tile (``BWD_SPANS`` a tile) runs the same
    ``__device__`` update and the same per-bin Σ(Δw)² reduction as the
    fused update step's epilogue, and the (tiles·bins,) partials are summed
    alike, so split and fused agree bitwise; on a CPU tensor, and only
    there, ``ftrl_push_plain``."""
    nb = grad.shape[0]
    _check_slots(slots, nb, grad.device)
    _check("grad", grad, torch.float32, (nb,), grad.device)
    if grad.device.type != "cuda":
        return ftrl_push_plain(slots, grad, handle)
    lib = _lib("tile_step", "wh_ftrl_push",
               [_P] * 5 + [_I] * 2 + [_F] * 4 + [_P])
    T = nb // TILE
    part = torch.empty(T * BWD_SPANS, dtype=torch.float32, device=grad.device)
    p, lr = handle.penalty, handle.lr
    with torch.cuda.device(grad.device):
        err = lib.wh_ftrl_push(grad.data_ptr(), slots[0].data_ptr(),
                               slots[1].data_ptr(), slots[2].data_ptr(),
                               part.data_ptr(), T, BWD_SPANS, lr.alpha,
                               lr.beta, p.lambda1, p.lambda2, _stream(grad))
    _ext.check(lib, err, "ftrl_push")
    ftrl_push.launches += 1
    return part.sum()


ftrl_push.launches = 0


# ---------------------------------------------------------------------------
# training: the backward gradient and the COO spill scatter
# ---------------------------------------------------------------------------

def spill_grad_scatter(g: torch.Tensor, dual_rows: torch.Tensor,
                       ovf_b: torch.Tensor, ovf_r: torch.Tensor,
                       spec: TileSpec) -> torch.Tensor:
    """Add each spill pair's f32 dual into the (nb,) gradient ``g`` — IN
    PLACE, and returns ``g``: the grad-side COO tail shared by
    ``backward_grad`` and the fused spill step. Deterministic without float
    atomics: the pairs' duals are summed per bucket by ``_run_sums`` and
    each touched bucket gets one add."""
    valid = ovf_b != OVF_SENTINEL
    rows = ovf_r.to(torch.int64) % spec.block_rows
    d = torch.where(valid, dual_rows[rows],
                    torch.zeros((), dtype=g.dtype, device=g.device))
    # sentinel slots sort into a dummy bucket past the table, dropped below
    b = torch.where(valid, ovf_b.to(torch.int64), spec.nb)
    buckets, sums = _run_sums(b, d)
    keep = buckets < spec.nb
    buckets, sums = buckets[keep], sums[keep]
    g[buckets] = g[buckets] + sums
    return g


def backward_grad_plain(pw: torch.Tensor, dual_rows: torch.Tensor,
                        spec: TileSpec) -> torch.Tensor:
    """grad (nb,) f32 = per bucket, the sum of bf16(dual[row]) over its
    pair words, from 0 in f32, left to right in word order, on any device:
    ``backward_pushes_plain``'s sums at one channel."""
    _check_bwd(pw, dual_rows, spec)
    start, kb, kr = _word_csr(pw, spec, by_row=False)
    return _word_order_sums(start, kb, kr, dual_rows.view(-1, 1),
                            spec.nb)[:, 0]


def _check_pw(pw: torch.Tensor, spec: TileSpec) -> None:
    if pw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {pw.device} unsupported")
    _check("pw", pw, torch.int32, spec.pairs_shape, pw.device)


def _check_bwd(pw, dual_rows, spec) -> None:
    _check_pw(pw, spec)
    _check_rows(spec.block_rows, pw.device, dual_rows=dual_rows)


def backward_grad(pw: torch.Tensor, dual_rows: torch.Tensor,
                  spec: TileSpec, ovf_b: Optional[torch.Tensor] = None,
                  ovf_r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """grad (nb,) f32 = per bucket, the sum of bf16(dual[row]) over its pair
    words, plus the spill pairs' f32 duals (``spill_grad_scatter``).

    The wrapper of ``csrc/tile_bwd.cu``, which replaces the TPU kernels
    ``_bwd_kernel`` (#2) and, on a ``fuse > 1`` spec, ``_bwd_kernel_fused``
    (#3): the Hopper kernel reads the pair bytes as they are, whatever the
    spec's K. On a CUDA tensor it launches the kernel (counted in
    ``backward_grad.launches``) or raises; on a CPU tensor, and only there,
    it runs ``backward_grad_plain``. The kernel gives each warp a bin of
    512 of one tile's buckets, owned outright: a tile pass gathers
    bf16(dual) for every word and sorts each 1024-word chunk by bin, and
    the bin's warp reads only its words and sums each bucket from 0 in
    word order, with no float atomics, so it equals the plain version
    bitwise, gives the same bits on every run and runs the same code as the
    fused steps."""
    _check_bwd(pw, dual_rows, spec)
    if pw.device.type == "cuda":
        lib = _lib("tile_bwd", "wh_tile_bwd", [_P] * 3 + [_L, _P] + [_I] * 5
                   + [_P])
        grad = torch.empty(spec.nb, dtype=torch.float32, device=pw.device)
        scratch, _ = _span_scratch(spec, pw.device)
        T, SG, _ = spec.pairs_shape
        with torch.cuda.device(pw.device):
            err = lib.wh_tile_bwd(pw.data_ptr(), dual_rows.data_ptr(),
                                  scratch.data_ptr(), scratch.numel(),
                                  grad.data_ptr(), T, SG, spec.group,
                                  spec.cap, BWD_SPANS, _stream(pw))
        _ext.check(lib, err, "tile_bwd")
        backward_grad.launches += 1
    else:
        grad = backward_grad_plain(pw, dual_rows, spec)
    if ovf_b is not None and ovf_b.shape[0]:
        grad = spill_grad_scatter(grad, dual_rows, ovf_b, ovf_r, spec)
    return grad


backward_grad.launches = 0


# ---------------------------------------------------------------------------
# training: the fused steps
# ---------------------------------------------------------------------------

def fused_step_grad_plain(pw, w, labels, mask, spec: TileSpec, loss: str,
                          exact_dense: bool, spill_margins=None):
    """forward → [+ spill grid] → dual [→ nudge] → backward, plain torch:
    (margins, grad)."""
    margins = forward_margins_plain(pw, w, spec)
    if spill_margins is not None:
        margins = margins + spill_margins
    dual = loss_dual_plain(margins, labels, mask, loss, exact_dense)
    return margins, backward_grad_plain(pw, dual, spec)


def fused_step_grad(pw: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor, spec: TileSpec, loss: str,
                    exact_dense: bool,
                    spill_margins: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step's (margins (block_rows,), grad (nb,)): the forward, the
    pre-aggregated spill grid (``spill_margin_rows``) added before the dual,
    the dual [and the zero-dual nudge when not ``exact_dense``], and the
    backward. The caller runs ``spill_grad_scatter`` on the grad with the
    dual it recomputes from the returned margins (``loss_dual``, the same
    device math, so the same bits).

    The wrapper of ``wh_step_grad`` (csrc/tile_step.cu), which replaces the
    TPU kernel ``_make_step_kernel`` built by ``_build_step_grad`` (#6). On
    a CUDA tensor it launches the step (counted in
    ``fused_step_grad.launches``) or raises; on a CPU tensor, and only
    there, it runs ``fused_step_grad_plain``. The forward (the tile pass,
    then the row spans with the boundary: spill add, dual, nudge, bf16 dual
    grid, as their epilogue) sums each row in word order as
    ``forward_margins`` does, so the margins equal
    ``fused_step_grad_plain``'s bitwise; then the backward,
    ``backward_grad``'s kernel on the bf16 dual grid. Its margins and grad
    equal the split chain forward_margins → loss_dual → backward_grad
    bitwise."""
    key = loss_key(loss)
    _check_operands(pw, w, spec)
    _check_rows(spec.block_rows, pw.device, labels=labels, mask=mask)
    if spill_margins is not None:
        _check_rows(spec.block_rows, pw.device, spill_margins=spill_margins)
    if pw.device.type != "cuda":
        return fused_step_grad_plain(pw, w, labels, mask, spec, key,
                                     exact_dense, spill_margins)
    lib = _lib("tile_step", "wh_step_grad",
               [_P] * 6 + [_L] + [_P] * 3 + [_I] * 8 + [_P])
    dev = pw.device
    scratch, rows = _span_scratch(spec, dev)
    margins = torch.empty(spec.block_rows, dtype=torch.float32, device=dev)
    dual = torch.empty(spec.block_rows, dtype=torch.bfloat16, device=dev)
    grad = torch.empty(spec.nb, dtype=torch.float32, device=dev)
    T, SG, _ = spec.pairs_shape
    with torch.cuda.device(dev):
        err = lib.wh_step_grad(
            pw.data_ptr(), w.data_ptr(), labels.data_ptr(), mask.data_ptr(),
            _ptr(spill_margins), scratch.data_ptr(), scratch.numel(),
            margins.data_ptr(), dual.data_ptr(), grad.data_ptr(), T, SG,
            spec.group, spec.cap, rows, BWD_SPANS, LOSS_IDS[key],
            int(exact_dense), _stream(pw))
    _ext.check(lib, err, "tile_step_grad")
    fused_step_grad.launches += 1
    return margins, grad


fused_step_grad.launches = 0


def fused_step_update_plain(pw, slots, labels, mask, spec: TileSpec,
                            loss: str, handle):
    """forward → dual → backward → FTRL push, plain torch, in place on the
    (3, nb) slots: (margins, Σ(w' - w)²)."""
    margins = forward_margins_plain(pw, slots[0], spec)
    dual = loss_dual_plain(margins, labels, mask, loss, True)
    grad = backward_grad_plain(pw, dual, spec)
    return margins, ftrl_push_plain(slots, grad, handle)


def fused_step_update(pw: torch.Tensor, slots: torch.Tensor,
                      labels: torch.Tensor, mask: torch.Tensor,
                      spec: TileSpec, loss: str, handle
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step with the FTRL update applied in place to the plane-major
    (3, nb) f32 slots [w, z, √Σg²]: returns (margins (block_rows,),
    Σ(w' - w)² as a 0-d f32 tensor). FTRL is exact-dense, so there is no
    nudge; spill blocks take ``fused_step_grad``.

    The wrapper of ``wh_step_update`` (csrc/tile_step.cu), which replaces
    the TPU kernel ``_make_step_kernel`` + ``_GradSink`` built by
    ``_build_step_update`` (#7): each bin's gradient stays in shared
    memory and goes straight into the update, so the (nb,) gradient
    never exists in device memory. On a CUDA tensor it launches the step
    (counted in ``fused_step_update.launches``) or raises; on a CPU tensor,
    and only there, ``fused_step_update_plain``. Its forward and backward
    sum each row and bucket in word order, so the margins and the
    gradient the update reads equal the plain versions' bitwise. Margins,
    slots and Σ(Δw)² equal the split chain's (… → backward_grad →
    ftrl_push) bitwise."""
    key = loss_key(loss)
    _check_slots(slots, spec.nb, pw.device)
    _check_operands(pw, slots[0], spec)
    _check_rows(spec.block_rows, pw.device, labels=labels, mask=mask)
    if pw.device.type != "cuda":
        return fused_step_update_plain(pw, slots, labels, mask, spec, key,
                                       handle)
    lib = _lib("tile_step", "wh_step_update",
               [_P] * 7 + [_L] + [_P] * 3 + [_I] * 7 + [_F] * 4 + [_P])
    dev = pw.device
    scratch, rows = _span_scratch(spec, dev)
    margins = torch.empty(spec.block_rows, dtype=torch.float32, device=dev)
    dual = torch.empty(spec.block_rows, dtype=torch.bfloat16, device=dev)
    T, SG, _ = spec.pairs_shape
    part = torch.empty(T * BWD_SPANS, dtype=torch.float32, device=dev)
    p, lr = handle.penalty, handle.lr
    with torch.cuda.device(dev):
        err = lib.wh_step_update(
            pw.data_ptr(), slots[0].data_ptr(), slots[1].data_ptr(),
            slots[2].data_ptr(), labels.data_ptr(), mask.data_ptr(),
            scratch.data_ptr(), scratch.numel(), margins.data_ptr(),
            dual.data_ptr(), part.data_ptr(), T, SG, spec.group, spec.cap,
            rows, BWD_SPANS, LOSS_IDS[key], lr.alpha, lr.beta, p.lambda1,
            p.lambda2, _stream(pw))
    _ext.check(lib, err, "tile_step_update")
    fused_step_update.launches += 1
    return margins, part.sum()


fused_step_update.launches = 0


# ---------------------------------------------------------------------------
# multi-channel pulls and pushes (the FM and wide&deep tile path)
# ---------------------------------------------------------------------------
#
# The JAX package's ``_multi_spec`` (tilemm.py:785) shrinks ``tiles_step``
# to fit a TPU compile budget; the Hopper kernels read the pair bytes as
# they are, so every spec the JAX package accepts runs here unchanged.

# words a CTA of csrc/tile_multi.cuh's index places in one window (its
# IDX_WIN): the pulls' row index gives each CTA a run of this many words'
# worth of tiles of one subblock (14 tiles, 228 CTAs at full width)
PULL_RUN_WORDS = 20480


def _perm_scratch(spec: TileSpec, device) -> torch.Tensor:
    """One int32 per pair word (17.3 MB at full width): the ``perm`` of
    csrc/tile_multi.cuh's row and bucket indexes. The fused steps pass one
    to both: the pulls' perm is dead once the pulls have run."""
    T, SG, N = spec.pairs_shape
    return torch.empty(T * SG * N, dtype=torch.int32, device=device)


def _pull_scratch(spec: TileSpec, device) -> Tuple[torch.Tensor, int]:
    """(index, tiles per run) of csrc/tile_multi.cuh's pulls: index holds
    the row starts (rows + 1), the (subblock, run, row) offsets and the
    1024-row chunk totals."""
    per_run = max(1, PULL_RUN_WORDS // spec.cap)
    nrun = -(-spec.tiles // per_run)
    rows = spec.block_rows
    return (torch.empty(rows + 1 + spec.subblocks * nrun * RSUB + rows // 1024,
                        dtype=torch.int32, device=device), per_run)


def _push_scratch(spec: TileSpec, device) -> torch.Tensor:
    """The index of csrc/tile_multi.cuh's pushes: the bucket starts (nb + 1)
    and the tile counts (tiles)."""
    return torch.empty(spec.nb + 1 + spec.tiles, dtype=torch.int32,
                       device=device)


def _check_table(name: str, t: torch.Tensor, n: int, device) -> int:
    """A (n, ch) f32 contiguous table on ``device``; returns ch."""
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D (n, ch), got {tuple(t.shape)}")
    _check(name, t, torch.float32, (n, t.shape[1]), device)
    if t.shape[1] < 1:
        raise ValueError(f"{name} has no channels")
    return t.shape[1]


def spill_pull_rows(w: torch.Tensor, ovf_b: torch.Tensor,
                    ovf_r: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """(block_rows, ch) f32 spill pulls: each valid COO pair's f32 table
    row lands on its block row, summed per row by ``_run_sums`` over each
    channel — the multi-channel ``spill_margin_rows``, deterministic."""
    dev = w.device
    valid = ovf_b != OVF_SENTINEL
    b = torch.where(valid, ovf_b, 0).to(torch.int64)
    wv = torch.where(valid[:, None], w[b],
                     torch.zeros((), dtype=w.dtype, device=dev))
    r = torch.where(valid, ovf_r.to(torch.int64) % spec.block_rows,
                    spec.block_rows)
    rows, sums = _run_sums(r, wv)
    out = torch.zeros((spec.block_rows + 1, w.shape[1]), dtype=w.dtype,
                      device=dev)
    out[rows] = sums
    return out[:spec.block_rows]


def spill_push_scatter(g: torch.Tensor, dual_rows: torch.Tensor,
                       ovf_b: torch.Tensor, ovf_r: torch.Tensor,
                       spec: TileSpec) -> torch.Tensor:
    """Add each spill pair's f32 (ch,) value row into the (nb, ch) pushes
    ``g`` — IN PLACE, and returns ``g``: the multi-channel
    ``spill_grad_scatter``, the tail of ``backward_pushes`` and of the
    fused FM spill step. Summed per bucket by ``_run_sums`` over each
    channel, one add per touched bucket: deterministic."""
    valid = ovf_b != OVF_SENTINEL
    rows = ovf_r.to(torch.int64) % spec.block_rows
    d = torch.where(valid[:, None], dual_rows[rows],
                    torch.zeros((), dtype=g.dtype, device=g.device))
    b = torch.where(valid, ovf_b.to(torch.int64), spec.nb)
    buckets, sums = _run_sums(b, d)
    keep = buckets < spec.nb
    buckets, sums = buckets[keep], sums[keep]
    g[buckets] = g[buckets] + sums
    return g


def _word_csr(pw: torch.Tensor, spec: TileSpec, by_row: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(start (n+1,), key, other) int64: the valid pair words sorted by
    key — the block row (``by_row``, n = rows) or the bucket (n = nb) —
    stably, so each key's words stay in word order ((tile, group, slot)
    order, the order ``decode_pairs`` flattens them in); ``other`` is each
    word's bucket (``by_row``) or block row."""
    bucket, row, valid = decode_pairs(pw, spec)
    kb, kr = bucket[valid], row[valid]
    key, other, n = (kr, kb, spec.block_rows) if by_row else (kb, kr, spec.nb)
    order = torch.argsort(key, stable=True)
    start = torch.zeros(n + 1, dtype=torch.int64, device=pw.device)
    start[1:] = torch.cumsum(torch.bincount(key, minlength=n), 0)
    return start, key[order], other[order]


def _word_order_sums(start: torch.Tensor, key: torch.Tensor,
                     other: torch.Tensor, vals: torch.Tensor,
                     n: int) -> torch.Tensor:
    """(n, ch) f32: per key, the sum of bf16(vals[other, :]) over its words,
    from 0 in f32, left to right in word order, on any device. Each word's
    rank among its key's words comes from the stable CSR, then one
    ``index_add_`` per rank: within one rank the keys are distinct, so no
    two adds meet and the order is exact."""
    rank = torch.arange(key.numel(), device=key.device) - start[key]
    by_rank = torch.argsort(rank, stable=True)
    sizes = torch.bincount(rank).tolist()
    vb = vals.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((n, vals.shape[1]), dtype=torch.float32,
                      device=key.device)
    for k, o in zip(key[by_rank].split(sizes), other[by_rank].split(sizes)):
        out.index_add_(0, k, vb[o])
    return out


def forward_pulls_plain(pw: torch.Tensor, w: torch.Tensor,
                        spec: TileSpec) -> torch.Tensor:
    """pulls (block_rows, ch) f32 = per row, the sum of bf16(w[bucket, :])
    over its pair words, from 0 in f32, left to right in word order, on any
    device (``_word_order_sums`` over the CSR by row)."""
    start, kr, kb = _word_csr(pw, spec, by_row=True)
    return _word_order_sums(start, kr, kb, w, spec.block_rows)


def forward_pulls(pw: torch.Tensor, w: torch.Tensor, spec: TileSpec,
                  ovf_b: Optional[torch.Tensor] = None,
                  ovf_r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(block_rows, ch) per-row sums of bf16(w[bucket, :]) over each row's
    pairs — the pooled-embedding pull — plus the f32 spill pulls
    (``spill_pull_rows``). ``w`` is the bucket-major (nb, ch) f32 table,
    so one pair's ch values are one contiguous read.

    The wrapper of ``wh_tile_pulls`` (csrc/tile_multi.cu), which replaces
    the TPU kernel ``_fwd_multi_kernel`` (#4). On a CUDA tensor it launches
    the kernel (counted in ``forward_pulls.launches``) or raises; on a CPU
    tensor, and only there, ``forward_pulls_plain``. The kernel builds a
    CSR of the words by row (``pull_index``) and sums every (row, channel)
    from 0 in word order, as the plain version does, so it equals that
    version bitwise; the fused steps run the same device code."""
    _check_pw(pw, spec)
    ch = _check_table("w", w, spec.nb, pw.device)
    if pw.device.type == "cuda":
        lib = _lib("tile_multi", "wh_tile_pulls", [_P] * 5 + [_I] * 6 + [_P])
        index, per_run = _pull_scratch(spec, pw.device)
        perm = _perm_scratch(spec, pw.device)
        pulls = torch.empty((spec.block_rows, ch), dtype=torch.float32,
                            device=pw.device)
        T, SG, _ = spec.pairs_shape
        with torch.cuda.device(pw.device):
            err = lib.wh_tile_pulls(pw.data_ptr(), w.data_ptr(),
                                    index.data_ptr(), perm.data_ptr(),
                                    pulls.data_ptr(), T, SG, spec.group,
                                    spec.cap, ch, per_run, _stream(pw))
        _ext.check(lib, err, "tile_pulls")
        forward_pulls.launches += 1
    else:
        pulls = forward_pulls_plain(pw, w, spec)
    if ovf_b is not None and ovf_b.shape[0]:
        pulls = pulls + spill_pull_rows(w, ovf_b, ovf_r, spec)
    return pulls


forward_pulls.launches = 0


def pull_index_plain(pw: torch.Tensor, spec: TileSpec
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start (rows+1,), perm (n,)) int32: the CSR by block row of the
    block's n valid pair words that csrc/tile_multi.cuh's pulls build. Row
    r's words are perm[start[r]:start[r+1]], each as its table row
    t*16384 + bucket, in word order."""
    _check_pw(pw, spec)
    start, _, buckets = _word_csr(pw, spec, by_row=True)
    return start.to(torch.int32), buckets.to(torch.int32)


def pull_index(pw: torch.Tensor, spec: TileSpec
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pull_index_plain``'s (start, perm), built by the index launches of
    the pulls alone (``wh_pull_index``, csrc/tile_multi.cu), so a test can
    hold the index against its plain version. On a CUDA tensor it launches
    the kernel (counted in ``pull_index.launches``) or raises; on a CPU
    tensor, and only there, ``pull_index_plain``."""
    _check_pw(pw, spec)
    if pw.device.type != "cuda":
        return pull_index_plain(pw, spec)
    lib = _lib("tile_multi", "wh_pull_index", [_P] * 3 + [_I] * 5 + [_P])
    index, per_run = _pull_scratch(spec, pw.device)
    perm = _perm_scratch(spec, pw.device)
    T, SG, _ = spec.pairs_shape
    with torch.cuda.device(pw.device):
        err = lib.wh_pull_index(pw.data_ptr(), index.data_ptr(),
                                perm.data_ptr(), T, SG, spec.group,
                                spec.cap, per_run, _stream(pw))
    _ext.check(lib, err, "pull_index")
    pull_index.launches += 1
    start = index[:spec.block_rows + 1]
    return start, perm[:int(start[-1])]


pull_index.launches = 0


def push_index_plain(pw: torch.Tensor, spec: TileSpec
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start (nb+1,), perm (n,)) int32: the CSR by bucket of the block's n
    valid pair words that csrc/tile_multi.cuh's pushes build. Bucket b's
    words are perm[start[b]:start[b+1]], each as its block row, in word
    order."""
    _check_pw(pw, spec)
    start, _, rows = _word_csr(pw, spec, by_row=False)
    return start.to(torch.int32), rows.to(torch.int32)


def push_index(pw: torch.Tensor, spec: TileSpec
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``push_index_plain``'s (start, perm), built by the index launches of
    the pushes alone (``wh_push_index``, csrc/tile_multi.cu), so a test can
    hold the index against its plain version. On a CUDA tensor it launches
    the kernel (counted in ``push_index.launches``) or raises; on a CPU
    tensor, and only there, ``push_index_plain``."""
    _check_pw(pw, spec)
    if pw.device.type != "cuda":
        return push_index_plain(pw, spec)
    lib = _lib("tile_multi", "wh_push_index", [_P] * 3 + [_I] * 4 + [_P])
    index = _push_scratch(spec, pw.device)
    perm = _perm_scratch(spec, pw.device)
    T, SG, _ = spec.pairs_shape
    with torch.cuda.device(pw.device):
        err = lib.wh_push_index(pw.data_ptr(), index.data_ptr(),
                                perm.data_ptr(), T, SG, spec.group,
                                spec.cap, _stream(pw))
    _ext.check(lib, err, "push_index")
    push_index.launches += 1
    start = index[:spec.nb + 1]
    return start, perm[:int(start[-1])]


push_index.launches = 0


def backward_pushes_plain(pw: torch.Tensor, dvals: torch.Tensor,
                          spec: TileSpec) -> torch.Tensor:
    """pushes (nb, ch) f32 = per bucket, the sum of bf16(dvals[row, :])
    over its pair words, from 0 in f32, left to right in word order, on any
    device (``_word_order_sums`` over the CSR by bucket)."""
    start, kb, kr = _word_csr(pw, spec, by_row=False)
    return _word_order_sums(start, kb, kr, dvals, spec.nb)


def backward_pushes(pw: torch.Tensor, dvals: torch.Tensor, spec: TileSpec,
                    ovf_b: Optional[torch.Tensor] = None,
                    ovf_r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(nb, ch) per-bucket sums of bf16(dvals[row, :]) over the bucket's
    pairs — the embedding-gradient push — plus the spill pairs' f32 rows
    (``spill_push_scatter``).

    The wrapper of ``wh_tile_pushes`` (csrc/tile_multi.cu), which replaces
    the TPU kernel ``_bwd_multi_kernel`` (#5). On a CUDA tensor it launches
    the kernel (counted in ``backward_pushes.launches``) or raises; on a
    CPU tensor, and only there, ``backward_pushes_plain``. The kernel
    builds a CSR of the words by bucket (``push_index``) and sums every
    (bucket, channel) from 0 in word order, as the plain version does, so it
    equals that version bitwise; the fused steps run the same device code."""
    _check_pw(pw, spec)
    ch = _check_table("dvals", dvals, spec.block_rows, pw.device)
    if pw.device.type == "cuda":
        lib = _lib("tile_multi", "wh_tile_pushes", [_P] * 6 + [_I] * 5 + [_P])
        dvb = torch.empty((spec.block_rows, ch), dtype=torch.bfloat16,
                          device=pw.device)
        index = _push_scratch(spec, pw.device)
        perm = _perm_scratch(spec, pw.device)
        pushes = torch.empty((spec.nb, ch), dtype=torch.float32,
                             device=pw.device)
        T, SG, _ = spec.pairs_shape
        with torch.cuda.device(pw.device):
            err = lib.wh_tile_pushes(pw.data_ptr(), dvals.data_ptr(),
                                     dvb.data_ptr(), index.data_ptr(),
                                     perm.data_ptr(), pushes.data_ptr(), T,
                                     SG, spec.group, spec.cap, ch,
                                     _stream(pw))
        _ext.check(lib, err, "tile_pushes")
        backward_pushes.launches += 1
    else:
        pushes = backward_pushes_plain(pw, dvals, spec)
    if ovf_b is not None and ovf_b.shape[0]:
        pushes = spill_push_scatter(pushes, dvals, ovf_b, ovf_r, spec)
    return pushes


backward_pushes.launches = 0


# ---------------------------------------------------------------------------
# the FM step: margin math, its boundary, and the fused step
# ---------------------------------------------------------------------------

def fm_margin_math(lin, s_parts, q):
    """FM margin lin + ½(Σ s_j² − q), the sum accumulated in the fixed
    sequential channel order of the JAX package's ``fm_margin_math``
    (tilemm.py:1427). The JAX version multiplies every product by an opaque
    one so that Mosaic and XLA contract alike; torch eager contracts
    nothing into an FMA, and the kernels are built with ``--fmad=false``,
    so that guard has nothing to do here and is left out."""
    ss = s_parts[0] * s_parts[0]
    for sj in s_parts[1:]:
        ss = ss + sj * sj
    return lin + 0.5 * (ss - q)


def fm_boundary_plain(pulls, labels, mask, k: int, loss: str,
                      want_dual: bool = True):
    """(margins, push rows [dual, dual·s_j…, mask] or None), plain torch."""
    s = [pulls[:, 1 + j] for j in range(k)]
    margin = fm_margin_math(pulls[:, 0], s, pulls[:, 1 + k])
    if not want_dual:
        return margin, None
    dual = create_loss(loss)[1](margin, labels, mask)
    dvals = torch.cat([dual[:, None], dual[:, None] * pulls[:, 1:1 + k],
                       mask[:, None]], 1)
    return margin, dvals


def fm_boundary(pulls: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, k: int, loss: str,
                want_dual: bool = True):
    """The FM step's boundary math from (rows, k+2) f32 pulls [w, s_1..s_k,
    q]: (margins (rows,), f32 push rows (rows, k+2) [dual, dual·s_1..k,
    mask], or None when not ``want_dual``). No nudge: the FM path applies
    none (touched buckets come from the mask channel).

    On a CUDA tensor it launches ``wh_fm_boundary`` (csrc/tile_fm_step.cu),
    the same device code the fused step runs at its phase boundary, so the
    split chain and the eval margins give the fused step's bits (counted
    in ``fm_boundary.launches``); on a CPU tensor, and only there,
    ``fm_boundary_plain``."""
    key = loss_key(loss)
    n = pulls.shape[0]
    _check("pulls", pulls, torch.float32, (n, k + 2), pulls.device)
    _check_rows(n, pulls.device, labels=labels, mask=mask)
    if pulls.device.type != "cuda":
        return fm_boundary_plain(pulls, labels, mask, k, key, want_dual)
    lib = _lib("tile_fm_step", "wh_fm_boundary",
               [_P] * 5 + [ctypes.c_longlong, _I, _I, _I, _P])
    margins = torch.empty(n, dtype=torch.float32, device=pulls.device)
    dvals = (torch.empty((n, k + 2), dtype=torch.float32,
                         device=pulls.device) if want_dual else None)
    with torch.cuda.device(pulls.device):
        err = lib.wh_fm_boundary(pulls.data_ptr(), labels.data_ptr(),
                                 mask.data_ptr(), margins.data_ptr(),
                                 _ptr(dvals), n, k, LOSS_IDS[key],
                                 int(want_dual), _stream(pulls))
    _ext.check(lib, err, "fm_boundary")
    fm_boundary.launches += 1
    return margins, dvals


fm_boundary.launches = 0


def fused_fm_step_plain(pw, wpull, labels, mask, spec: TileSpec, k: int,
                        loss: str, spill_pulls=None):
    """pulls [+ spill grid] → FM boundary → pushes, plain torch:
    (margins, pushes[, push rows])."""
    pulls = forward_pulls_plain(pw, wpull, spec)
    if spill_pulls is not None:
        pulls = pulls + spill_pulls
    margin, dvals = fm_boundary_plain(pulls, labels, mask, k, loss)
    pushes = backward_pushes_plain(pw, dvals, spec)
    if spill_pulls is not None:
        return margin, pushes, dvals
    return margin, pushes


def fused_fm_step(pw: torch.Tensor, wpull: torch.Tensor,
                  labels: torch.Tensor, mask: torch.Tensor, spec: TileSpec,
                  k: int, loss: str,
                  spill_pulls: Optional[torch.Tensor] = None):
    """One FM step: (margins (block_rows,), pushes (nb, k+2)) from the
    (nb, k+2) pull table [w, v_1..v_k, Σv²]. With ``spill_pulls`` (the
    (rows, k+2) grid from ``spill_pull_rows``) the boundary sums it into
    the pulls, and a third result, the f32 (rows, k+2) push rows, comes
    back for the caller's ``spill_push_scatter``.

    The wrapper of ``wh_fm_step`` (csrc/tile_fm_step.cu), which replaces
    the TPU kernel ``_make_fm_step_kernel`` (#8). On a CUDA tensor it
    launches the step (counted in ``fused_fm_step.launches``) or raises; on
    a CPU tensor, and only there, ``fused_fm_step_plain``. It equals the
    split chain forward_pulls → fm_boundary → backward_pushes bitwise."""
    key = loss_key(loss)
    _check_pw(pw, spec)
    _check("wpull", wpull, torch.float32, (spec.nb, k + 2), pw.device)
    _check_rows(spec.block_rows, pw.device, labels=labels, mask=mask)
    if spill_pulls is not None:
        _check("spill_pulls", spill_pulls, torch.float32,
               (spec.block_rows, k + 2), pw.device)
    if pw.device.type != "cuda":
        return fused_fm_step_plain(pw, wpull, labels, mask, spec, k, key,
                                   spill_pulls)
    lib = _lib("tile_fm_step", "wh_fm_step", [_P] * 13 + [_I] * 7 + [_P])
    dev, ch, rows = pw.device, k + 2, spec.block_rows
    pull_idx, per_run = _pull_scratch(spec, dev)
    push_idx, perm = _push_scratch(spec, dev), _perm_scratch(spec, dev)
    pulls = torch.empty((rows, ch), dtype=torch.float32, device=dev)
    margins = torch.empty(rows, dtype=torch.float32, device=dev)
    dvb = torch.empty((rows, ch), dtype=torch.bfloat16, device=dev)
    dvf = (torch.empty((rows, ch), dtype=torch.float32, device=dev)
           if spill_pulls is not None else None)
    pushes = torch.empty((spec.nb, ch), dtype=torch.float32, device=dev)
    T, SG, _ = spec.pairs_shape
    with torch.cuda.device(dev):
        err = lib.wh_fm_step(
            pw.data_ptr(), wpull.data_ptr(), labels.data_ptr(),
            mask.data_ptr(), _ptr(spill_pulls), pull_idx.data_ptr(),
            pulls.data_ptr(), margins.data_ptr(), dvb.data_ptr(), _ptr(dvf),
            push_idx.data_ptr(), perm.data_ptr(), pushes.data_ptr(), T, SG,
            spec.group, spec.cap, k, per_run, LOSS_IDS[key], _stream(pw))
    _ext.check(lib, err, "tile_fm_step")
    fused_fm_step.launches += 1
    if spill_pulls is not None:
        return margins, pushes, dvf
    return margins, pushes


fused_fm_step.launches = 0


# ---------------------------------------------------------------------------
# the wide&deep step: the MLP, its boundary, and the fused step
# ---------------------------------------------------------------------------

def mlp_forward(params: dict, x: torch.Tensor, n_layers: int
                ) -> torch.Tensor:
    """Dense MLP forward on the pooled embeddings (wide&deep's deep tower,
    ``wormhole_tpu/ops/tilemm.py:1575``): h @ W_i + b_i with ReLU between
    layers, the first output column. The plain version of the MLP the
    wide&deep boundary kernel (csrc/tile_wd.cuh) runs by hand."""
    h = x
    for i in range(n_layers):
        h = h @ params[f"W{i}"] + params[f"b{i}"]
        if i + 1 < n_layers:
            h = torch.relu(h)
    return h[:, 0]


def mlp_sizes(mlp: dict) -> List[int]:
    """[k, hidden..., 1]: the layer widths of an MLP dict."""
    n = len(mlp) // 2
    return [mlp["W0"].shape[0]] + [mlp[f"W{i}"].shape[1] for i in range(n)]


def _pack_mlp(mlp: dict, n_layers: int) -> torch.Tensor:
    """The flat f32 parameter vector [W0, b0, W1, b1, ...] the kernel
    reads (each W row-major (in, out))."""
    return torch.cat([t for i in range(n_layers)
                      for t in (mlp[f"W{i}"].reshape(-1), mlp[f"b{i}"])])


def _unpack_mlp(flat: torch.Tensor, sizes: List[int]) -> dict:
    out, off = {}, 0
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"W{i}"] = flat[off:off + a * b].view(a, b)
        out[f"b{i}"] = flat[off + a * b:off + a * b + b]
        off += a * b + b
    return out


def _check_mlp(mlp: dict, k: int, device) -> List[int]:
    sizes = mlp_sizes(mlp)
    if sizes[0] != k or sizes[-1] != 1:
        raise ValueError(f"MLP widths {sizes}: want [{k}, ..., 1]")
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        _check(f"W{i}", mlp[f"W{i}"], torch.float32, (a, b), device)
        _check(f"b{i}", mlp[f"b{i}"], torch.float32, (b,), device)
    return sizes


def wd_boundary_plain(pulls, labels, mask, mlp: dict, loss: str,
                      want_grad: bool = True):
    """(margins, push rows [dual, g_pooled…, mask], MLP grads) plain torch:
    the MLP forward and ``torch.func.vjp`` of it. On a CUDA tensor its
    matrix products are cuBLAS GEMMs, the boundary's library yardstick."""
    n_layers = len(mlp) // 2
    deep, vjp = torch.func.vjp(lambda m, x: mlp_forward(m, x, n_layers),
                               mlp, pulls[:, 1:])
    margin = pulls[:, 0] + deep
    if not want_grad:
        return margin, None, None
    dual = create_loss(loss)[1](margin, labels, mask)
    g_mlp, g_pooled = vjp(dual)
    dvals = torch.cat([dual[:, None], g_pooled, mask[:, None]], 1)
    return margin, dvals, dict(g_mlp)


# rows a CTA of csrc/tile_wd.cuh sums each parameter gradient over: the
# gradients add the rows of a span in order, then the spans in order, so the
# span is part of their bits (the tile of rows a CTA keeps on chip is not)
WD_SPAN_ROWS = 256


def kernel_order_dual(margins, labels, mask, loss: str) -> torch.Tensor:
    """The loss dual as ``csrc/tile_math.cuh`` ``loss_dual`` rounds it, one
    torch op per device operation (logit: 1/(1 + exp(-x)) with x = -y·m,
    where ``create_loss`` takes ``torch.sigmoid``)."""
    key = loss_key(loss)
    y = torch.where(labels > 0.5, 1.0, -1.0).to(margins.dtype)
    if key == "logit":
        x = -y * margins
        return -y * (1.0 / (1.0 + torch.exp(-x))) * mask
    if key == "hinge":
        active = torch.where(1.0 - y * margins > 0, 1.0, 0.0).to(
            margins.dtype)
        return -y * active * mask
    if key == "square_hinge":
        t = torch.clamp(1.0 - y * margins, min=0.0)
        return -2.0 * y * t * mask
    return (margins - labels) * mask


def _fold_rows(h: torch.Tensor, g: torch.Tensor, span: int):
    """(Σ h[r, a]·g[r, b], Σ g[r, b]) over the rows, as the kernel adds them:
    the rows of each span of ``span`` in order from 0, then the spans in
    order from 0. Rows padded to whole spans carry h = g = 0, which add
    nothing (a sum that starts at +0 never becomes -0)."""
    n, sa = h.shape
    sb = g.shape[1]
    nspan = max(1, -(-n // span))
    pad = nspan * span - n
    hs = torch.nn.functional.pad(h, (0, 0, 0, pad)).view(nspan, span, sa)
    gs = torch.nn.functional.pad(g, (0, 0, 0, pad)).view(nspan, span, sb)
    sw = torch.zeros((nspan, sa, sb), dtype=h.dtype, device=h.device)
    sbias = torch.zeros((nspan, sb), dtype=h.dtype, device=h.device)
    for r in range(span):
        sw = sw + hs[:, r, :, None] * gs[:, r, None, :]
        sbias = sbias + gs[:, r]
    gw = torch.zeros((sa, sb), dtype=h.dtype, device=h.device)
    gb = torch.zeros(sb, dtype=h.dtype, device=h.device)
    for s in range(nspan):
        gw = gw + sw[s]
        gb = gb + sbias[s]
    return gw, gb


def wd_boundary_ordered_plain(pulls, labels, mask, mlp: dict, loss: str,
                              want_grad: bool = True,
                              span: int = WD_SPAN_ROWS):
    """``wd_boundary``'s results in the kernel's order, plain torch, one op
    per device operation, so the kernel equals it bitwise on the card: each
    layer's z[b] = ((0 + h_0·W[0,b]) + h_1·W[1,b]) + … + bias[b], ReLU as
    z > 0 ? z : 0; the dual as ``kernel_order_dual``; gh[a] = Σ_b
    W[a,b]·g[b] from 0 in b order, masked by h > 0 below the top layer;
    the parameter gradients as ``_fold_rows`` over spans of ``span`` rows."""
    n_layers = len(mlp) // 2
    h = pulls[:, 1:]
    hs = []
    for i in range(n_layers):
        W, b = mlp[f"W{i}"], mlp[f"b{i}"]
        hs.append(h)
        acc = torch.zeros((h.shape[0], W.shape[1]), dtype=h.dtype,
                          device=h.device)
        for a in range(W.shape[0]):
            acc = acc + h[:, a:a + 1] * W[a]
        z = acc + b
        h = torch.where(z > 0, z, 0.0) if i + 1 < n_layers else z
    margin = pulls[:, 0] + h[:, 0]
    if not want_grad:
        return margin, None, None
    dual = kernel_order_dual(margin, labels, mask, loss)
    g, grads = dual[:, None], {}
    for i in range(n_layers - 1, -1, -1):
        W = mlp[f"W{i}"]
        grads[f"W{i}"], grads[f"b{i}"] = _fold_rows(hs[i], g, span)
        gh = torch.zeros((g.shape[0], W.shape[0]), dtype=g.dtype,
                         device=g.device)
        for b in range(W.shape[1]):
            gh = gh + g[:, b:b + 1] * W[:, b]
        g = torch.where(hs[i] > 0, gh, 0.0) if i > 0 else gh
    dvals = torch.cat([dual[:, None], g, mask[:, None]], 1)
    return margin, dvals, {n: grads[n] for n in mlp}


# (device, widths) -> the widths as a device int32 tensor, made once: the
# kernel takes up to eight layers' widths by value and reads this copy only
# for a deeper MLP
_WD_DSIZES: Dict[Tuple[str, Tuple[int, ...]], torch.Tensor] = {}


class _WdScratch:
    """The wide&deep boundary's operands for csrc/tile_wd_step.cu: the
    packed parameters, the layer widths as a host int array (the kernel
    takes them by value) and a device copy made once per widths, the
    device-memory tiles of widths whose tile fits no CTA's shared memory
    (``wh_wd_tiles`` sizes them; none otherwise), each span's
    parameter-gradient sums (spans, P) and the gradient."""

    def __init__(self, lib, mlp: dict, sizes: List[int], rows: int, k: int,
                 device, want_grad: bool = True):
        L = len(sizes) - 1
        self.L = L
        self.params = _pack_mlp(mlp, L).contiguous()
        self.P = self.params.numel()
        self.sizes = (ctypes.c_int * (L + 1))(*sizes)
        key = (str(device), tuple(sizes))
        if key not in _WD_DSIZES:
            _WD_DSIZES[key] = torch.tensor(sizes, dtype=torch.int32,
                                           device=device)
        self.dsizes = _WD_DSIZES[key]
        f = lib.wh_wd_tiles
        f.argtypes = [_P, _P, _I, _L, _I, _L, _I, _I]
        f.restype = _L
        with torch.cuda.device(device):
            n = f(self.sizes, self.dsizes.data_ptr(), L, self.P, k, rows,
                  WD_SPAN_ROWS, int(want_grad))
        if n < 0:
            raise ValueError(f"MLP widths {sizes}: the boundary kernel "
                             f"does not take them ({self.P} parameters)")
        self.tiles = (torch.empty(n, dtype=torch.float32, device=device)
                      if n > 0 else None)
        self.gpart = self.grad = None
        if want_grad:
            self.gpart = torch.empty((-(-rows // WD_SPAN_ROWS), self.P),
                                     dtype=torch.float32, device=device)
            self.grad = torch.empty(self.P, dtype=torch.float32,
                                    device=device)


def wd_boundary(pulls: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, mlp: dict, k: int, loss: str,
                want_grad: bool = True):
    """The wide&deep step's boundary from (rows, 1+k) f32 pulls [w,
    pooled_1..k]: (margins, f32 push rows (rows, k+2) [dual,
    g_pooled_1..k, mask], MLP parameter grads {W_i, b_i}); the last two
    None when not ``want_grad``. No nudge, as in the JAX step.

    On a CUDA tensor it launches ``wh_wd_boundary`` (csrc/tile_wd_step.cu:
    the row-tile kernel of csrc/tile_wd.cuh, then the combine of its span
    sums), the MLP forward and vjp the fused step runs at its boundary, so
    the split chain and the eval margins give the fused step's bits
    (counted in ``wd_boundary.launches``); it equals
    ``wd_boundary_ordered_plain`` bitwise. On a CPU tensor, and only there,
    ``wd_boundary_plain``."""
    key = loss_key(loss)
    n = pulls.shape[0]
    _check("pulls", pulls, torch.float32, (n, k + 1), pulls.device)
    _check_rows(n, pulls.device, labels=labels, mask=mask)
    sizes = _check_mlp(mlp, k, pulls.device)
    if pulls.device.type != "cuda":
        return wd_boundary_plain(pulls, labels, mask, mlp, key, want_grad)
    lib = _lib("tile_wd_step", "wh_wd_boundary",
               [_P] * 6 + [_I, _L, _I] + [_P] * 5 + [_L, _I, _I, _I, _P])
    dev = pulls.device
    sc = _WdScratch(lib, mlp, sizes, n, k, dev, want_grad)
    margins = torch.empty(n, dtype=torch.float32, device=dev)
    dvals = (torch.empty((n, k + 2), dtype=torch.float32, device=dev)
             if want_grad else None)
    with torch.cuda.device(dev):
        err = lib.wh_wd_boundary(
            pulls.data_ptr(), labels.data_ptr(), mask.data_ptr(),
            sc.params.data_ptr(), sc.sizes, sc.dsizes.data_ptr(), sc.L,
            sc.P, k, _ptr(sc.tiles), _ptr(sc.gpart), margins.data_ptr(),
            _ptr(dvals), _ptr(sc.grad), n, WD_SPAN_ROWS, LOSS_IDS[key],
            int(want_grad), _stream(pulls))
    _ext.check(lib, err, "wd_boundary")
    wd_boundary.launches += 1
    if not want_grad:
        return margins, None, None
    return margins, dvals, _unpack_mlp(sc.grad, sizes)


wd_boundary.launches = 0


def fused_wd_step_plain(pw, wpull, labels, mask, mlp: dict, spec: TileSpec,
                        loss: str):
    """pulls → MLP forward + vjp → dual → pushes, plain torch: (margins,
    pushes, g_mlp)."""
    pulls = forward_pulls_plain(pw, wpull, spec)
    margin, dvals, g_mlp = wd_boundary_plain(pulls, labels, mask, mlp, loss)
    return margin, backward_pushes_plain(pw, dvals, spec), g_mlp


def fused_wd_step(pw: torch.Tensor, wpull: torch.Tensor,
                  labels: torch.Tensor, mask: torch.Tensor, mlp: dict,
                  spec: TileSpec, k: int, loss: str):
    """One wide&deep step: (margins (rows,), pushes (nb, k+2), g_mlp
    {W_i, b_i}) from the (nb, 1+k) pull table [w, v_1..v_k] and the MLP
    dict, whose widths [k, hidden..., 1] the kernel takes from its
    weights. Spill-free blocks only (``resolve_step_kernel`` sends wide&deep
    spill to split); the table and MLP updates stay torch elementwise ops,
    as they were XLA ops in JAX.

    The wrapper of ``wh_wd_step`` (csrc/tile_wd_step.cu), which replaces
    the TPU kernel ``_make_wd_step_kernel`` (#9), the MLP forward and vjp
    included. On a CUDA tensor it launches the step (counted in
    ``fused_wd_step.launches``) or raises; on a CPU tensor, and only there,
    ``fused_wd_step_plain``. It equals the split chain forward_pulls →
    wd_boundary → backward_pushes bitwise, parameter grads included."""
    key = loss_key(loss)
    _check_pw(pw, spec)
    _check("wpull", wpull, torch.float32, (spec.nb, k + 1), pw.device)
    _check_rows(spec.block_rows, pw.device, labels=labels, mask=mask)
    sizes = _check_mlp(mlp, k, pw.device)
    if pw.device.type != "cuda":
        return fused_wd_step_plain(pw, wpull, labels, mask, mlp, spec, key)
    margins, pushes, grad, _ = _wd_step(pw, wpull, labels, mask, mlp, sizes,
                                        spec, k, key)
    return margins, pushes, _unpack_mlp(grad, sizes)


def _wd_step(pw, wpull, labels, mask, mlp, sizes, spec, k, key):
    """Launch ``wh_wd_step`` on checked CUDA operands: (margins, pushes,
    flat MLP grads, the bf16 push rows (rows, k+2) the pushes summed)."""
    lib = _lib("tile_wd_step", "wh_wd_step",
               [_P] * 7 + [_I, _L] + [_P] * 10 + [_I] * 8 + [_P])
    dev, rows = pw.device, spec.block_rows
    sc = _WdScratch(lib, mlp, sizes, rows, k, dev)
    pull_idx, per_run = _pull_scratch(spec, dev)
    push_idx, perm = _push_scratch(spec, dev), _perm_scratch(spec, dev)
    pulls = torch.empty((rows, k + 1), dtype=torch.float32, device=dev)
    margins = torch.empty(rows, dtype=torch.float32, device=dev)
    dvb = torch.empty((rows, k + 2), dtype=torch.bfloat16, device=dev)
    pushes = torch.empty((spec.nb, k + 2), dtype=torch.float32, device=dev)
    T, SG, _ = spec.pairs_shape
    with torch.cuda.device(dev):
        err = lib.wh_wd_step(
            pw.data_ptr(), wpull.data_ptr(), labels.data_ptr(),
            mask.data_ptr(), sc.params.data_ptr(), sc.sizes,
            sc.dsizes.data_ptr(), sc.L, sc.P, pull_idx.data_ptr(),
            pulls.data_ptr(), _ptr(sc.tiles), sc.gpart.data_ptr(),
            margins.data_ptr(), dvb.data_ptr(), sc.grad.data_ptr(),
            push_idx.data_ptr(), perm.data_ptr(), pushes.data_ptr(), T, SG,
            spec.group, spec.cap, k, per_run, WD_SPAN_ROWS, LOSS_IDS[key],
            _stream(pw))
    _ext.check(lib, err, "tile_wd_step")
    fused_wd_step.launches += 1
    return margins, pushes, sc.grad, dvb


fused_wd_step.launches = 0


# -- slow exact reference (tests / differential checking) -------------------

def forward_margins_ref(buckets: np.ndarray, rows: np.ndarray,
                        w: np.ndarray, block_rows: int) -> np.ndarray:
    out = np.zeros(block_rows, np.float64)
    np.add.at(out, rows, np.asarray(w, np.float64)[buckets])
    return out.astype(np.float32)


def backward_grad_ref(buckets: np.ndarray, rows: np.ndarray,
                      dual_rows: np.ndarray, nb: int) -> np.ndarray:
    out = np.zeros(nb, np.float64)
    np.add.at(out, buckets, np.asarray(dual_rows, np.float64)[rows])
    return out.astype(np.float32)
