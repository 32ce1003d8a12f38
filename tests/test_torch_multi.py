"""The port's multi-channel tile ops against the JAX package's (Pallas in
interpret mode on the CPU): forward_pulls (#4), backward_pushes (#5), the
spill helpers, the fused FM step (#8), the fused wide&deep step (#9) and the
resolver's records for both models. The CUDA kernels against their plain
torch versions are in test_torch_kernels.py.

Tolerances, each from how the two sides compute:

- pulls: both round the table to bf16 and sum in f32 in another order, so a
  (row, channel) is within 4·n·2⁻²⁴·Σ|bf16 w_p| (n its pair count); spill
  pairs add the same bound over their f32 values.
- pushes, given the same value rows: the same bound over the bucket's bf16
  values. From each side's own values (the fused steps), the values may
  differ by the margin bound carried through the dual, and their bf16
  roundings by one bf16 step (2⁻⁸ relative); the bound adds Σ|bf16(x_port)
  − bf16(x_jax)| over the bucket's pairs, from the two sides' values.
- FM margins: lin + ½(Σ s_j² − q) moves by δ_lin + ½(Σ (2|s_j| + δ_j)δ_j +
  δ_q) under pull differences δ, plus (k+4) f32 roundings of its terms.
- wide&deep: the MLP carries the pulls' f32 differences (≈1e-7 relative)
  through He-initialised layers of gain ≈1, and a ReLU whose input lies
  within that of 0 may flip, which moves its output by as little: margins
  within 1e-5·(1 + |m|), the parameter gradients (sums over rows) within
  1e-4 of the largest entry of each leaf.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wormhole_tpu.ops import loss as jloss
from wormhole_tpu.ops import tilemm as jt
from wormhole_tpu_torch.ops import tilemm as tt

SPEC_ARGS = dict(nb=2 * tt.TILE, subblocks=2, cap=1280, group=2,
                 tiles_step=2)
SPEC, JSPEC = tt.TileSpec(**SPEC_ARGS), jt.TileSpec(**SPEC_ARGS)
OVF_CAP = 1536
LOSSES = ["logit", "hinge", "square_hinge", "square"]
K = 4


def i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def f32(a):
    return torch.from_numpy(np.array(a, np.float32))


def bf16(x):
    return f32(x).to(torch.bfloat16).float().numpy().astype(np.float64)


def block(seed, skew=False, n_pairs=4000):
    """(pw, ovf_b, ovf_r, n_ovf) of one encoded block; with ``skew`` a hot
    bucket past cap spills into the COO list."""
    rng = np.random.default_rng(seed)
    buckets = rng.integers(0, SPEC.nb, size=n_pairs).astype(np.int64)
    rows = rng.integers(0, SPEC.block_rows, size=n_pairs).astype(np.int64)
    if skew:
        buckets = np.concatenate([buckets,
                                  np.full(1400, 7 * tt.TILE // 4, np.int64)])
        rows = np.concatenate([rows, rng.integers(0, SPEC.block_rows, 1400)])
    pw, ob, orow, n_ovf = tt.encode_block_capped(buckets, rows, SPEC,
                                                 OVF_CAP)
    assert (n_ovf > 0) == skew
    return pw, ob, orow, n_ovf


def pairs(pw, ob=None, orow=None, n_ovf=0):
    """(tile buckets, tile rows, spill buckets, spill rows) as int64."""
    b, r, valid = tt.decode_pairs(i32(pw), SPEC)
    return (b[valid].numpy(), r[valid].numpy(),
            np.zeros(0, np.int64) if ob is None else ob[:n_ovf].astype(
                np.int64),
            np.zeros(0, np.int64) if orow is None else orow[:n_ovf].astype(
                np.int64))


def sum_tol(keys, idx, vals, n, skeys=None, sidx=None, svals=None):
    """Per (key, channel): 4·n·2⁻²⁴·Σ|bf16 value| over the key's tile
    pairs, and the same over its spill pairs' f32 values."""
    vb = np.abs(bf16(vals))
    cols = vals.shape[1]
    tol = np.stack([np.bincount(keys, weights=vb[idx, c], minlength=n)
                    for c in range(cols)], 1)
    cnt = np.bincount(keys, minlength=n)
    if skeys is not None and len(skeys):
        tol += np.stack([np.bincount(skeys, weights=np.abs(svals[sidx, c]),
                                     minlength=n) for c in range(cols)], 1)
        cnt = cnt + np.bincount(skeys, minlength=n)
    return 4 * np.maximum(cnt, 1)[:, None] * 2.0 ** -24 * tol + 1e-30


def flip_tol(keys, idx, a, b, n):
    """Σ|bf16(a) − bf16(b)| per (key, channel) over the key's pairs."""
    d = np.abs(bf16(a) - bf16(b))
    return np.stack([np.bincount(keys, weights=d[idx, c], minlength=n)
                     for c in range(a.shape[1])], 1)


# -- forward_pulls / backward_pushes ------------------------------------------

@pytest.mark.parametrize("ch", [3, 10, 18])
@pytest.mark.parametrize("spill", [False, True])
def test_forward_pulls_matches_jax(ch, spill):
    pw, ob, orow, n_ovf = block(70 + ch, skew=spill)
    w = (np.random.default_rng(71).standard_normal((SPEC.nb, ch))
         * 0.1).astype(np.float32)
    sp = (ob, orow) if spill else (None, None)
    got = tt.forward_pulls(i32(pw), f32(w), SPEC,
                           *(None if a is None else i32(a) for a in sp))
    want = np.asarray(jt.forward_pulls(pw, w, JSPEC, *sp))
    kb, kr, sb, sr = pairs(pw, ob, orow, n_ovf if spill else 0)
    tol = sum_tol(kr, kb, w, SPEC.block_rows, sr, sb, w)
    assert got.shape == (SPEC.block_rows, ch)
    assert np.all(np.abs(got.numpy() - want) <= tol)
    ref = tt.forward_margins_ref(kb, kr, bf16(w[:, 0]), SPEC.block_rows)
    if spill:
        ref = ref + np.bincount(sr, weights=w[sb, 0], minlength=len(ref))
    assert np.all(np.abs(got.numpy()[:, 0] - ref) <= tol[:, 0])


@pytest.mark.parametrize("ch", [3, 10, 18])
@pytest.mark.parametrize("spill", [False, True])
def test_backward_pushes_matches_jax(ch, spill):
    pw, ob, orow, n_ovf = block(80 + ch, skew=spill)
    dv = (np.random.default_rng(81).standard_normal((SPEC.block_rows, ch))
          * 0.5).astype(np.float32)
    sp = (ob, orow) if spill else (None, None)
    got = tt.backward_pushes(i32(pw), f32(dv), SPEC,
                             *(None if a is None else i32(a) for a in sp))
    want = np.asarray(jt.backward_pushes(pw, dv, JSPEC, *sp))
    kb, kr, sb, sr = pairs(pw, ob, orow, n_ovf if spill else 0)
    tol = sum_tol(kb, kr, dv, SPEC.nb, sb, sr, dv)
    assert got.shape == (SPEC.nb, ch)
    assert np.all(np.abs(got.numpy() - want) <= tol)
    assert np.count_nonzero(got.numpy()[:, 0]) > 0.9 * len(np.unique(kb))


# -- the row and bucket indexes and the order-exact plain pulls and pushes ---

def word_order_pairs(pw):
    """(bucket, row) int64 of the valid words in word order: (tile, group,
    slot) order, read straight off the packed layout."""
    T, SG, _ = SPEC.pairs_shape
    p = pw.reshape(T, SG, SPEC.group, SPEC.cap).astype(np.int64)
    hi = (p >> 7) & 511
    t = np.arange(T)[:, None, None, None]
    s = (np.arange(SG)[None, :, None, None] * SPEC.group
         + np.arange(SPEC.group)[None, None, :, None])
    bucket = np.broadcast_to(t * tt.TILE + ((hi & 127) << 7 | (p & 127)),
                             p.shape)
    row = np.broadcast_to(s * tt.RSUB + (((p >> 23) & 63) << 7
                                         | ((p >> 16) & 127)), p.shape)
    valid = hi < 128
    return bucket[valid], row[valid]


@pytest.mark.parametrize("spill", [False, True])
def test_push_index_plain_is_a_stable_bucket_sort(spill):
    """start is monotone from 0, its counts are the bincount of the valid
    words' buckets, and each bucket's rows are its words in word order;
    the wrapper takes the plain path on a CPU tensor and counts no
    launch."""
    pw, _, _, _ = block(90, skew=spill)
    before = tt.push_index.launches
    start, perm = tt.push_index(i32(pw), SPEC)
    assert tt.push_index.launches == before
    want = tt.push_index_plain(i32(pw), SPEC)
    assert torch.equal(start, want[0]) and torch.equal(perm, want[1])
    assert start.dtype == perm.dtype == torch.int32
    assert start.shape == (SPEC.nb + 1,)
    st = start.numpy().astype(np.int64)
    kb, kr = word_order_pairs(pw)
    assert st[0] == 0 and np.all(np.diff(st) >= 0)
    assert np.array_equal(np.diff(st), np.bincount(kb, minlength=SPEC.nb))
    assert st[-1] == len(kb) == perm.numel()
    for b in np.unique(kb):
        assert np.array_equal(perm.numpy()[st[b]:st[b + 1]], kr[kb == b])
    if spill:   # the hot bucket holds more words than any other
        assert np.diff(st).max() > 100


@pytest.mark.parametrize("spill", [False, True])
def test_pull_index_plain_is_a_stable_row_sort(spill):
    """start is monotone from 0, its counts are the bincount of the valid
    words' block rows, and each row's entries are its words' table rows
    t*16384 + bucket in word order; the wrapper takes the plain path on a
    CPU tensor and counts no launch."""
    pw, _, _, _ = block(89, skew=spill)
    before = tt.pull_index.launches
    start, perm = tt.pull_index(i32(pw), SPEC)
    assert tt.pull_index.launches == before
    want = tt.pull_index_plain(i32(pw), SPEC)
    assert torch.equal(start, want[0]) and torch.equal(perm, want[1])
    assert start.dtype == perm.dtype == torch.int32
    assert start.shape == (SPEC.block_rows + 1,)
    st = start.numpy().astype(np.int64)
    kb, kr = word_order_pairs(pw)
    assert st[0] == 0 and np.all(np.diff(st) >= 0)
    assert np.array_equal(np.diff(st),
                          np.bincount(kr, minlength=SPEC.block_rows))
    assert st[-1] == len(kr) == perm.numel()
    for r in np.unique(kr):
        assert np.array_equal(perm.numpy()[st[r]:st[r + 1]], kb[kr == r])
    if spill:   # the hot bucket's words spread over many rows
        assert np.count_nonzero(perm.numpy() == 7 * tt.TILE // 4) > 100


def word_order_fold(keys, others, vals, n):
    """Sums by a Python loop: each word's bf16 value row (vals[other])
    added into its key in f32, from 0, one word at a time in word order."""
    out = np.zeros((n, vals.shape[1]), np.float32)
    vb = bf16(vals).astype(np.float32)
    for k, o in zip(keys, others):
        out[k] = out[k] + vb[o]
    return out


@pytest.mark.parametrize("ch", [1, 10, 17])
@pytest.mark.parametrize("spill", [False, True])
def test_forward_pulls_plain_sums_in_word_order_bitwise(ch, spill):
    """The order-exact plain pulls equal a Python word-order fold, and the
    single index_add_ over all words that the CPU ran before (it adds in
    index order too), bit for bit; with spill, forward_pulls adds the spill
    pulls to exactly these bits."""
    pw, ob, orow, _ = block(88 + ch, skew=spill)
    w = (np.random.default_rng(87).standard_normal((SPEC.nb, ch))
         * 0.3).astype(np.float32)
    got = tt.forward_pulls_plain(i32(pw), f32(w), SPEC)
    kb, kr = word_order_pairs(pw)
    assert got.numpy().tobytes() == word_order_fold(
        kr, kb, w, SPEC.block_rows).tobytes()
    bucket, row, valid = tt.decode_pairs(i32(pw), SPEC)
    one_call = torch.zeros((SPEC.block_rows, ch)).index_add_(
        0, row[valid], f32(w).to(torch.bfloat16).float()[bucket[valid]])
    assert torch.equal(got, one_call)
    sp = (i32(ob), i32(orow)) if spill else (None, None)
    want = got + tt.spill_pull_rows(f32(w), *sp, SPEC) if spill else got
    assert torch.equal(tt.forward_pulls(i32(pw), f32(w), SPEC, *sp), want)


@pytest.mark.parametrize("ch", [1, 10, 18])
@pytest.mark.parametrize("spill", [False, True])
def test_backward_pushes_plain_sums_in_word_order_bitwise(ch, spill):
    """The order-exact plain pushes equal a Python word-order fold, and the
    single index_add_ over all words that the CPU ran before (it adds in
    index order too), bit for bit."""
    pw, _, _, _ = block(91 + ch, skew=spill)
    dv = (np.random.default_rng(92).standard_normal((SPEC.block_rows, ch))
          * 0.5).astype(np.float32)
    got = tt.backward_pushes_plain(i32(pw), f32(dv), SPEC)
    kb, kr = word_order_pairs(pw)
    assert got.numpy().tobytes() == word_order_fold(kb, kr, dv,
                                                    SPEC.nb).tobytes()
    bucket, row, valid = tt.decode_pairs(i32(pw), SPEC)
    one_call = torch.zeros((SPEC.nb, ch)).index_add_(
        0, bucket[valid], f32(dv).to(torch.bfloat16).float()[row[valid]])
    assert torch.equal(got, one_call)
    assert torch.equal(tt.backward_pushes(i32(pw), f32(dv), SPEC), got)


def test_spill_helpers_match_jax_and_are_reproducible():
    rng = np.random.default_rng(82)
    ch, n = 5, 64
    w = rng.standard_normal((SPEC.nb, ch)).astype(np.float32)
    g = rng.standard_normal((SPEC.nb, ch)).astype(np.float32)
    dv = rng.standard_normal((SPEC.block_rows, ch)).astype(np.float32)
    ob = np.full(n, 0xFFFFFFFF, np.uint32)
    orow = np.zeros(n, np.uint32)
    ob[:40] = rng.choice([3, 77, 20000, 32767], 40)   # runs of equal keys
    orow[:40] = rng.choice([0, 5, 9000, 16383], 40)
    sb, sr = ob[:40].astype(np.int64), orow[:40].astype(np.int64)
    pulls = [tt.spill_pull_rows(f32(w), i32(ob), i32(orow), SPEC).numpy()
             for _ in range(2)]
    pushes = [tt.spill_push_scatter(f32(g), f32(dv), i32(ob), i32(orow),
                                    SPEC).numpy() for _ in range(2)]
    assert pulls[0].tobytes() == pulls[1].tobytes()
    assert pushes[0].tobytes() == pushes[1].tobytes()
    want_p = np.asarray(jt.spill_pull_rows(jnp.asarray(w), ob, orow, JSPEC))
    want_g = np.asarray(jt.spill_push_scatter(jnp.asarray(g), dv, ob, orow,
                                              JSPEC))
    ptol = 4 * 41 * 2.0 ** -24 * np.stack(
        [np.bincount(sr, weights=np.abs(w[sb, c]), minlength=SPEC.block_rows)
         for c in range(ch)], 1) + 1e-30
    gtol = 4 * 41 * 2.0 ** -24 * (np.stack(
        [np.bincount(sb, weights=np.abs(dv[sr, c]), minlength=SPEC.nb)
         for c in range(ch)], 1) + np.abs(g)) + 1e-30
    assert np.all(np.abs(pulls[0] - want_p) <= ptol)
    assert np.all(np.abs(pushes[0] - want_g) <= gtol)
    assert set(np.nonzero(np.any(pushes[0] != g, 1))[0].tolist()) <= \
        {3, 77, 20000, 32767}


# -- the fused FM step ----------------------------------------------------------

def fm_table(seed, k=K):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(SPEC.nb) * 0.3
    v = rng.standard_normal((SPEC.nb, k)) * 0.3
    return np.concatenate([w[:, None], v, np.sum(v * v, 1, keepdims=True)],
                          1).astype(np.float32)


def row_data(seed):
    rng = np.random.default_rng(seed)
    labels = (rng.random(SPEC.block_rows) < 0.4).astype(np.float32)
    mask = np.ones(SPEC.block_rows, np.float32)
    mask[-64:] = 0.0
    return labels, mask


def fm_margin_tol(pulls, ptol, k):
    s, d = np.abs(pulls[:, 1:1 + k]), ptol[:, 1:1 + k]
    mag = (np.abs(pulls[:, 0])
           + 0.5 * (np.sum(s * s, 1) + np.abs(pulls[:, 1 + k])))
    return (ptol[:, 0] + 0.5 * (np.sum((2 * s + d) * d, 1) + ptol[:, 1 + k])
            + (k + 4) * 2.0 ** -24 * mag + 1e-30)


def jax_fm_split(pw, wpull, labels, mask, loss, spill=(None, None), k=K):
    """The JAX FM split path's pulls, margins and push rows (fm.py:223-307),
    which its fused step equals bitwise."""
    pulls = jt.forward_pulls(pw, wpull, JSPEC, *spill)
    margin = jt.fm_margin_math(pulls[:, 0], [pulls[:, 1 + j]
                                             for j in range(k)],
                               pulls[:, 1 + k], jloss.opaque_one(mask))
    dual = jloss.create_loss(loss)[1](margin, labels, mask)
    dv = jnp.concatenate([dual[:, None], dual[:, None] * pulls[:, 1:1 + k],
                          mask[:, None]], 1)
    return np.asarray(pulls), np.asarray(margin), np.asarray(dv)


@pytest.mark.parametrize("loss", LOSSES)
def test_fused_fm_step_matches_jax(loss):
    """Port fused_fm_step vs JAX's one-grid Pallas FM step (#8), and the
    port's own split chain forward_pulls → fm_boundary → backward_pushes,
    which it equals bitwise."""
    pw, _, _, _ = block(90)
    wpull = fm_table(91)
    labels, mask = row_data(92)
    mg_j, push_j = (np.asarray(x) for x in jt.fused_fm_step(
        pw, wpull, labels, mask, JSPEC, K, loss))
    P, W, L, M = i32(pw), f32(wpull), f32(labels), f32(mask)
    mg_t, push_t = tt.fused_fm_step(P, W, L, M, SPEC, K, loss)
    pulls = tt.forward_pulls(P, W, SPEC)
    mg_s, dv_s = tt.fm_boundary(pulls, L, M, K, loss)
    assert torch.equal(mg_t, mg_s)
    assert torch.equal(push_t, tt.backward_pushes(P, dv_s, SPEC))
    pulls_j, mg_js, dv_j = jax_fm_split(pw, wpull, labels, mask, loss)
    np.testing.assert_array_equal(mg_js, mg_j)
    kb, kr, _, _ = pairs(pw)
    ptol = sum_tol(kr, kb, wpull, SPEC.block_rows)
    assert np.all(np.abs(mg_t.numpy() - mg_j)
                  <= fm_margin_tol(pulls_j, ptol, K))
    tol = (sum_tol(kb, kr, dv_s.numpy(), SPEC.nb)
           + flip_tol(kb, kr, dv_s.numpy(), dv_j, SPEC.nb))
    assert np.all(np.abs(push_t.numpy() - push_j) <= tol)


def test_fused_fm_step_spill_matches_jax():
    """The spill variant: the spill pulls enter at the boundary, the step
    returns the push rows, and the scatter runs on them — port vs JAX, and
    port fused = port split bitwise."""
    pw, ob, orow, n_ovf = block(93, skew=True)
    wpull = fm_table(94)
    labels, mask = row_data(95)
    loss = "logit"
    sp_j = jt.spill_pull_rows(wpull, ob, orow, JSPEC)
    mg_j, push_j, dv_jk = jt.fused_fm_step(pw, wpull, labels, mask, JSPEC,
                                           K, loss, spill_pulls=sp_j)
    push_j = np.asarray(jt.spill_push_scatter(push_j, dv_jk, ob, orow,
                                              JSPEC))
    mg_j, dv_jk = np.asarray(mg_j), np.asarray(dv_jk)
    P, W, L, M = i32(pw), f32(wpull), f32(labels), f32(mask)
    B, R = i32(ob), i32(orow)
    sp = tt.spill_pull_rows(W, B, R, SPEC)
    mg_t, push_t, dv_t = tt.fused_fm_step(P, W, L, M, SPEC, K, loss,
                                          spill_pulls=sp)
    push_t = tt.spill_push_scatter(push_t, dv_t, B, R, SPEC)
    pulls = tt.forward_pulls(P, W, SPEC, B, R)
    mg_s, dv_s = tt.fm_boundary(pulls, L, M, K, loss)
    assert torch.equal(mg_t, mg_s) and torch.equal(dv_t, dv_s)
    assert torch.equal(push_t, tt.backward_pushes(P, dv_s, SPEC, B, R))
    pulls_j, _, dv_j = jax_fm_split(pw, wpull, labels, mask, loss,
                                    (ob, orow))
    kb, kr, sb, sr = pairs(pw, ob, orow, n_ovf)
    ptol = sum_tol(kr, kb, wpull, SPEC.block_rows, sr, sb, wpull)
    mtol = fm_margin_tol(pulls_j, ptol, K)
    assert np.all(np.abs(mg_t.numpy() - mg_j) <= mtol)
    # the push rows: dual·s_j moves by |s_j|·δdual + |dual|·δs_j
    dd = np.abs(dv_t.numpy() - dv_jk)
    assert np.all(dd[:, 0] <= mtol * 0.25 + 1e-7)
    tol = (sum_tol(kb, kr, dv_s.numpy(), SPEC.nb, sb, sr, dv_s.numpy())
           + flip_tol(kb, kr, dv_s.numpy(), dv_j, SPEC.nb)
           + np.stack([np.bincount(sb, weights=dd[sr, c], minlength=SPEC.nb)
                       for c in range(K + 2)], 1))
    assert np.all(np.abs(push_t.numpy() - push_j) <= tol)


# -- the fused wide&deep step ------------------------------------------------------

HIDDEN = (8,)


def wd_inputs(seed):
    rng = np.random.default_rng(seed)
    wpull = (rng.standard_normal((SPEC.nb, 1 + K)) * 0.3).astype(np.float32)
    sizes = [K] + list(HIDDEN) + [1]
    mlp = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        mlp[f"W{i}"] = (rng.standard_normal((a, b))
                        * np.sqrt(2.0 / a)).astype(np.float32)
        mlp[f"b{i}"] = (rng.standard_normal(b) * 0.1).astype(np.float32)
    return wpull, mlp


def jax_wd_split(pw, wpull, labels, mask, mlp, loss):
    """The JAX wide&deep split path's margins and push rows
    (wide_deep.py:241-312), jitted as the JAX store jits it, which its
    fused step equals bitwise."""
    n_layers = len(mlp) // 2

    @jax.jit
    def split(pw, wpull, labels, mask, mlp):
        pulls = jt.forward_pulls(pw, wpull, JSPEC)
        deep, vjp = jax.vjp(lambda m, x: jt.mlp_forward(m, x, n_layers),
                            mlp, pulls[:, 1:])
        margin = pulls[:, 0] + deep
        dual = jloss.create_loss(loss)[1](margin, labels, mask)
        _, g_pooled = vjp(dual)
        return margin, jnp.concatenate([dual[:, None], g_pooled,
                                        mask[:, None]], 1)

    margin, dv = split(pw, wpull, labels, mask,
                       {k: jnp.asarray(v) for k, v in mlp.items()})
    return np.asarray(margin), np.asarray(dv)


@pytest.mark.parametrize("loss", ["logit", "hinge"])
def test_fused_wd_step_matches_jax(loss):
    """Port fused_wd_step vs JAX's one-grid step with the in-kernel MLP
    (#9): margins, pushes and every parameter-gradient leaf; and the port's
    own split chain forward_pulls → wd_boundary → backward_pushes, which it
    equals bitwise."""
    pw, _, _, _ = block(96)
    wpull, mlp = wd_inputs(97)
    labels, mask = row_data(98)
    jmlp = {k: jnp.asarray(v) for k, v in mlp.items()}
    mg_j, push_j, g_j = jt.fused_wd_step(pw, wpull, labels, mask, jmlp,
                                         JSPEC, K, HIDDEN, loss)
    tm = {k: f32(v) for k, v in mlp.items()}
    P, W, L, M = i32(pw), f32(wpull), f32(labels), f32(mask)
    mg_t, push_t, g_t = tt.fused_wd_step(P, W, L, M, tm, SPEC, K, loss)
    mg_s, dv_s, g_s = tt.wd_boundary(tt.forward_pulls(P, W, SPEC), L, M, tm,
                                     K, loss)
    assert torch.equal(mg_t, mg_s)
    assert torch.equal(push_t, tt.backward_pushes(P, dv_s, SPEC))
    assert sorted(g_t) == sorted(g_s) == sorted(g_j)
    for key in g_t:
        assert torch.equal(g_t[key], g_s[key])
    mg_js, dv_j = jax_wd_split(pw, wpull, labels, mask, mlp, loss)
    np.testing.assert_array_equal(mg_js, np.asarray(mg_j))
    mg_j = np.asarray(mg_j)
    assert np.all(np.abs(mg_t.numpy() - mg_j) <= 1e-5 * (1 + np.abs(mg_j)))
    kb, kr, _, _ = pairs(pw)
    tol = (sum_tol(kb, kr, dv_s.numpy(), SPEC.nb)
           + flip_tol(kb, kr, dv_s.numpy(), dv_j, SPEC.nb))
    assert np.all(np.abs(push_t.numpy() - np.asarray(push_j)) <= tol)
    for key, want in g_j.items():
        want = np.asarray(want)
        assert g_t[key].shape == want.shape
        assert np.all(np.abs(g_t[key].numpy() - want)
                      <= 1e-4 * np.abs(want).max() + 1e-7), key


def test_mlp_forward_matches_jax():
    rng = np.random.default_rng(99)
    _, mlp = wd_inputs(99)
    x = rng.standard_normal((500, K)).astype(np.float32)
    want = np.asarray(jt.mlp_forward({k: jnp.asarray(v)
                                      for k, v in mlp.items()}, x, 2))
    got = tt.mlp_forward({k: f32(v) for k, v in mlp.items()}, f32(x), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert tt.mlp_sizes({k: f32(v) for k, v in mlp.items()}) == [K, 8, 1]


# -- the resolver ------------------------------------------------------------------

MODEL_CASES = [
    ("fused", dict(spec=True, channels=K + 2)),                  # FM
    ("split", dict(spec=True, channels=K + 2)),
    ("fused", dict(spec=True, channels=K + 2, ovf_cap=64)),      # FM spill
    ("fused", dict(spec=True, channels=K + 2, mesh=True)),
    ("fused", dict(spec=True, deep=True, dim=K, hidden=HIDDEN,
                   channels=K + 2)),                             # wide&deep
    ("split", dict(spec=True, deep=True, dim=K, hidden=HIDDEN,
                   channels=K + 2)),
    ("fused", dict(spec=True, deep=True, dim=K, hidden=HIDDEN,
                   channels=K + 2, ovf_cap=64)),                 # wd spill
    ("fused", dict(deep=True, dim=K, hidden=HIDDEN, channels=K + 2)),
    ("fused", dict(spec=True, deep=True, dim=K, hidden=HIDDEN,
                   channels=K + 2, mesh=True)),
]


@pytest.mark.parametrize("kernel,kw", MODEL_CASES)
def test_model_resolutions_match_jax(kernel, kw):
    """FM and wide&deep resolve and record as in the JAX package (fused,
    split, spill, mesh, no spec); the multi-channel cache record keeps the
    JAX wording."""
    tk, jk = dict(kw), dict(kw)
    if kw.get("spec"):
        tk["spec"], jk["spec"] = SPEC, JSPEC
    else:
        tk.pop("spec", None)
        jk.pop("spec", None)
    for dev in ("cpu", "cuda"):
        got = tt.resolve_step_kernel(kernel, device=dev, **tk)
        want = jt.resolve_step_kernel(kernel, **jk)
        assert (got.kernel, got.why, got.cache_record) == \
            (want.kernel, want.why, want.cache_record)
        assert (got.dim, got.hidden) == (kw.get("dim", 0),
                                         tuple(kw.get("hidden", ())))


def test_model_auto_and_over_vmem_width():
    """``auto`` resolves split ("auto on cpu device") on the CPU and fused
    on CUDA, for FM spill and spill-free wide&deep. A wide&deep width over
    the TPU's VMEM budget resolves split in JAX and fused in the port: its
    launch chain keeps the activations in device memory (the difference by
    design that ROADMAP C records)."""
    fm = dict(spec=SPEC, channels=K + 2, ovf_cap=64)
    wd = dict(spec=SPEC, deep=True, dim=K, hidden=HIDDEN, channels=K + 2)
    for kw in (fm, wd):
        cpu = tt.resolve_step_kernel("auto", device="cpu", **kw)
        assert (cpu.kernel, cpu.why) == ("split", "auto on cpu device")
        assert tt.resolve_step_kernel("auto", device="cuda",
                                      **kw).kernel == "fused"
    wide = dict(wd, hidden=(1 << 14, 1 << 14))
    jwide = dict(wide, spec=JSPEC)
    want = jt.resolve_step_kernel("fused", **jwide)
    assert want.kernel == "split" and "VMEM" in want.why
    got = tt.resolve_step_kernel("fused", device="cuda", **wide)
    assert (got.kernel, got.why) == ("fused", "")


def test_multi_wrappers_take_the_plain_path_only_on_cpu():
    """On CPU tensors every multi-channel wrapper runs its plain version
    and counts no launch; a bad operand raises before any launch."""
    counted = (tt.forward_pulls, tt.backward_pushes, tt.fm_boundary,
               tt.wd_boundary, tt.fused_fm_step, tt.fused_wd_step,
               tt.pull_index, tt.push_index)
    before = [f.launches for f in counted]
    pw, _, _, _ = block(100)
    P, W = i32(pw), f32(fm_table(101))
    labels, mask = (f32(a) for a in row_data(102))
    assert torch.equal(tt.forward_pulls(P, W, SPEC),
                       tt.forward_pulls_plain(P, W, SPEC))
    for got, want in zip(tt.pull_index(P, SPEC),
                         tt.pull_index_plain(P, SPEC)):
        assert torch.equal(got, want)
    m, push = tt.fused_fm_step(P, W, labels, mask, SPEC, K, "logit")
    mp, pp = tt.fused_fm_step_plain(P, W, labels, mask, SPEC, K, "logit")
    assert torch.equal(m, mp) and torch.equal(push, pp)
    assert [f.launches for f in counted] == before
    with pytest.raises((TypeError, ValueError)):
        tt.forward_pulls(P, W.double(), SPEC)
    with pytest.raises((TypeError, ValueError)):
        tt.backward_pushes(P, W, SPEC)            # not (rows, ch)
    with pytest.raises((TypeError, ValueError)):
        tt.fused_fm_step(P, W, labels, mask, SPEC, K + 1, "logit")
    wpull, mlp = wd_inputs(103)
    short = {k: f32(v) for k, v in mlp.items()}
    short["W1"] = short["W1"][:-1]           # rows no longer match b0
    with pytest.raises(ValueError):
        tt.fused_wd_step(P, f32(wpull), labels, mask, short, SPEC, K,
                         "logit")
