"""The port's tile layout, encoder and forward margins against the JAX
package's (Pallas in interpret mode on the CPU). The CUDA kernel against its
plain torch version is in test_torch_kernels.py.

Tolerance for margins: the port and the reference both round w to bf16 and
accumulate in f32; they differ only in the order of the f32 sums. A sum of k
terms in any order is within k·2⁻²⁴·Σ|terms| of the exact sum, so two orders
differ by at most 2k·2⁻²⁴·Σ|terms|; the bound used is 4·nnz·2⁻²⁴·Σ_p|w_p|
per row, with nnz the row's pair count.
"""

import numpy as np
import pytest
import torch

from wormhole_tpu.ops import tilemm as jt
from wormhole_tpu_torch.ops import tilemm as tt

SPEC_ARGS = dict(nb=2 * tt.TILE, subblocks=2, cap=1280, group=2,
                 tiles_step=2)
SPEC = tt.TileSpec(**SPEC_ARGS)
JSPEC = jt.TileSpec(**SPEC_ARGS)
OVF_CAP = 1536


def make_pairs(rng, n_pairs, skew=False):
    buckets = rng.integers(0, SPEC.nb, size=n_pairs).astype(np.int64)
    rows = rng.integers(0, SPEC.block_rows, size=n_pairs).astype(np.int64)
    if skew:  # a hot bucket past cap in tile 1 spills to the COO list
        hot = 7 * tt.TILE // 4
        buckets = np.concatenate([buckets, np.full(1400, hot, np.int64)])
        rows = np.concatenate(
            [rows, rng.integers(0, tt.RSUB, size=1400).astype(np.int64)])
    return buckets, rows


def bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def encoded_pairs(pw):
    """(bucket, block row) of every non-pad word, via jt.unpack_fields."""
    T, SG, _ = SPEC.pairs_shape
    b, r, pad = jt.unpack_fields(pw.reshape(T, SG, SPEC.group, SPEC.cap))
    t, g, j, _ = np.nonzero(~pad)
    return (t * tt.TILE + b[~pad].astype(np.int64),
            (g * SPEC.group + j) * tt.RSUB + r[~pad].astype(np.int64))


def margin_tol(buckets, rows, w, spill_b=None, spill_r=None):
    """Per-row bound 4·nnz·2⁻²⁴·Σ|w_p| (+ a denormal floor)."""
    wb = np.abs(bf16(w)).astype(np.float64)
    mag = np.bincount(rows, weights=wb[buckets], minlength=SPEC.block_rows)
    cnt = np.bincount(rows, minlength=SPEC.block_rows)
    if spill_b is not None:  # spill pairs use f32 w
        mag += np.bincount(spill_r, weights=np.abs(w[spill_b]),
                           minlength=SPEC.block_rows)
    return 4 * np.maximum(cnt, 1) * 2.0 ** -24 * mag + 1e-30


def test_make_spec_matches_jax():
    for nb, sub, cap in [(1 << 22, 12, 1408), (1 << 22, 12, 128),
                         (2 * tt.TILE, 2, 1280), (1 << 26, 8, 256),
                         (6 * tt.TILE, 3, 384)]:
        a, b = tt.make_spec(nb, sub, cap), jt.make_spec(nb, sub, cap)
        assert (a.nb, a.subblocks, a.cap, a.group, a.tiles_step, a.fuse,
                a.pairs_shape, a.block_rows) == \
            (b.nb, b.subblocks, b.cap, b.group, b.tiles_step, b.fuse,
             b.pairs_shape, b.block_rows)
    with pytest.raises(ValueError):
        tt.TileSpec(nb=tt.TILE + 1, subblocks=2, cap=128)


@pytest.mark.parametrize("skew", [False, True])
def test_encoder_byte_identical_to_jax(skew):
    rng = np.random.default_rng(10 + skew)
    buckets, rows = make_pairs(rng, 4000, skew=skew)
    got = tt.encode_block_capped(buckets, rows, SPEC, OVF_CAP)
    want = jt.encode_block_capped(buckets, rows, JSPEC, OVF_CAP)
    assert got[3] == want[3] and (got[3] > 0) == skew
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    np.testing.assert_array_equal(
        np.stack(tt.unpack_fields(got[0])), np.stack(jt.unpack_fields(got[0])))


def _operands(rng, skew):
    buckets, rows = make_pairs(rng, 4000, skew=skew)
    pw, ob, orow, n_ovf = tt.encode_block_capped(buckets, rows, SPEC,
                                                 OVF_CAP)
    w = (rng.standard_normal(SPEC.nb) * 0.1).astype(np.float32)
    return buckets, rows, pw, ob, orow, n_ovf, w


def _port_margins(pw, w, ob=None, orow=None):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    return tt.forward_margins(
        t(pw), torch.from_numpy(w), SPEC,
        None if ob is None else t(ob),
        None if orow is None else t(orow)).numpy()


@pytest.mark.parametrize("skew", [False, True])
def test_forward_margins_match_jax_and_ref(skew):
    """Port (CPU, plain) vs JAX tilemm.forward_margins (Pallas interpret),
    with and without spill; both vs forward_margins_ref."""
    rng = np.random.default_rng(20 + skew)
    buckets, rows, pw, ob, orow, n_ovf, w = _operands(rng, skew)
    spill = (ob, orow) if skew else (None, None)
    got = _port_margins(pw, w, *spill)
    want = np.asarray(jt.forward_margins(pw, w, JSPEC, *spill))
    sb = ob[:n_ovf].astype(np.int64) if skew else None
    sr = orow[:n_ovf].astype(np.int64) if skew else None
    tol = margin_tol(buckets, rows, w, sb, sr)
    assert np.all(np.abs(got - want) <= tol)
    # the exact reference: the encoded pairs (decoded by the JAX package's
    # unpack_fields) see bf16(w), the spill pairs f32 w
    kb, kr = encoded_pairs(pw)
    ref = tt.forward_margins_ref(kb, kr, bf16(w),
                                 SPEC.block_rows).astype(np.float64)
    if skew:
        ref += np.bincount(sr, weights=w[sb].astype(np.float64),
                           minlength=SPEC.block_rows)
    assert np.all(np.abs(got - ref) <= tol)
    assert np.all(np.abs(want - ref) <= tol)


def word_order_fold(pw, w):
    """Per row, bf16(w[bucket]) added in f32 from 0, one word at a time, in
    word order: (tile, group, slot), read straight off the packed layout."""
    T, SG, _ = SPEC.pairs_shape
    p = pw.reshape(T, SG, SPEC.group, SPEC.cap).astype(np.int64)
    hi = (p >> 7) & 511
    t = np.broadcast_to(np.arange(T)[:, None, None, None], p.shape)
    s = np.broadcast_to(np.arange(SG)[None, :, None, None] * SPEC.group
                        + np.arange(SPEC.group)[None, None, :, None], p.shape)
    valid = hi < 128
    bucket = (t * tt.TILE + ((hi & 127) << 7 | (p & 127)))[valid]
    row = (s * tt.RSUB + (((p >> 23) & 63) << 7 | ((p >> 16) & 127)))[valid]
    out = np.zeros(SPEC.block_rows, np.float32)
    wb = bf16(w)
    for b, r in zip(bucket, row):
        out[r] = np.float32(out[r] + wb[b])
    return out


@pytest.mark.parametrize("spill", [False, True])
def test_forward_margins_plain_sums_in_word_order_bitwise(spill):
    """The order-exact plain forward equals a Python word-order fold, the
    single index_add_ over all words that the CPU ran before (it adds in
    index order too) and forward_pulls_plain at one channel, bit for bit;
    with spill, forward_margins adds the spill margins to exactly these
    bits."""
    rng = np.random.default_rng(40 + spill)
    _, _, pw, ob, orow, n_ovf, w = _operands(rng, spill)
    assert (n_ovf > 0) == spill
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    got = tt.forward_margins_plain(t(pw), torch.from_numpy(w), SPEC)
    assert got.numpy().tobytes() == word_order_fold(pw, w).tobytes()
    bucket, row, valid = tt.decode_pairs(t(pw), SPEC)
    one_call = torch.zeros(SPEC.block_rows).index_add_(
        0, row[valid], torch.from_numpy(w).to(torch.bfloat16).float()[
            bucket[valid]])
    assert torch.equal(got, one_call)
    pulls = tt.forward_pulls_plain(t(pw), torch.from_numpy(w).view(-1, 1),
                                   SPEC)
    assert torch.equal(got, pulls[:, 0])
    sp = (t(ob), t(orow)) if spill else (None, None)
    want = (got + tt.spill_margin_rows(torch.from_numpy(w), *sp, SPEC)
            if spill else got)
    assert torch.equal(tt.forward_margins(t(pw), torch.from_numpy(w), SPEC,
                                          *sp), want)


def test_spill_margin_rows_matches_jax_with_shared_rows():
    rng = np.random.default_rng(3)
    w = rng.standard_normal(SPEC.nb).astype(np.float32)
    n = 64
    ob = np.full(n, 0xFFFFFFFF, np.uint32)
    orow = np.zeros(n, np.uint32)
    ob[:40] = rng.integers(0, SPEC.nb, 40)
    orow[:40] = rng.choice([5, 9, 9000, 16383], 40)   # runs of equal rows
    want = np.asarray(jt.spill_margin_rows(w, ob, orow, JSPEC))
    got = tt.spill_margin_rows(torch.from_numpy(w),
                               torch.from_numpy(ob.view(np.int32)),
                               torch.from_numpy(orow.view(np.int32)),
                               SPEC).numpy()
    exact = np.bincount(orow[:40].astype(np.int64),
                        weights=w[ob[:40]].astype(np.float64),
                        minlength=SPEC.block_rows)
    mag = np.bincount(orow[:40].astype(np.int64),
                      weights=np.abs(w[ob[:40]]), minlength=SPEC.block_rows)
    tol = 4 * 40 * 2.0 ** -24 * mag + 1e-30
    assert np.all(np.abs(got - want) <= tol)
    assert np.all(np.abs(got - exact) <= tol)
    assert np.count_nonzero(got) == 4


def test_pad_words_are_noops_and_plain_is_reproducible():
    pw = np.full(SPEC.pairs_shape, tt.PADWORD, np.uint32)
    w = np.random.default_rng(4).standard_normal(SPEC.nb).astype(np.float32)
    assert np.all(_port_margins(pw, w) == 0)
    rng = np.random.default_rng(5)
    _, _, pw, _, _, _, w = _operands(rng, False)
    assert np.array_equal(_port_margins(pw, w), _port_margins(pw, w))


@pytest.mark.parametrize("bad", ["dtype", "shape", "w_dtype", "devices",
                                 "contiguous"])
def test_forward_margins_rejects_bad_operands(bad):
    pw = torch.full(SPEC.pairs_shape, int(tt.PADWORD), dtype=torch.int32)
    w = torch.zeros(SPEC.nb)
    if bad == "dtype":
        pw = pw.to(torch.int64)
    elif bad == "shape":
        pw = pw[:1]
    elif bad == "w_dtype":
        w = w.double()
    elif bad == "devices":
        w = w.to("meta")
    else:
        w = torch.zeros(SPEC.nb, 2)[:, 0]
    with pytest.raises((TypeError, ValueError)):
        tt.forward_margins(pw, w, SPEC)
