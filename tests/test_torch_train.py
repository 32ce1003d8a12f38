"""The port's training ops against the JAX package's (Pallas in interpret
mode on the CPU): the backward gradient (a fuse>1 spec included), the spill
gradient scatter, both fused steps, the FTRL update and the step-kernel
resolver. The CUDA kernels against their plain torch versions are in
test_torch_kernels.py.

Tolerances, each from how the two sides compute:

- margins: both round w to bf16 and sum in f32 in another order, so a row
  is within 4·k·2⁻²⁴·Σ|w_p| (k its pair count), as test_torch_tilemm.py.
- grad, given the same duals: both round the dual to bf16 and sum in f32
  in another order: 4·k·2⁻²⁴·Σ|bf16 dual| per bucket (k its pair count),
  plus the same bound over its spill pairs' f32 duals.
- grad from each side's own margins (the fused steps): the margins differ
  by the bound above, so the duals may differ, and their bf16 roundings by
  up to one bf16 step; the bound adds Σ|bf16(d_port) − bf16(d_jax)| over
  the bucket's pairs, computed from the two sides' duals.
- FTRL slots: a gradient difference δ moves cg' by ≤ δ, z' by
  ≤ δ·(1 + |w|/α) and w' by ≤ α·|Δz'|/β; each side adds at most a few f32
  roundings, 8·2⁻²⁴ relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wormhole_tpu.learners import handles as jh
from wormhole_tpu.learners.store import _nudge_zero_dual as j_nudge
from wormhole_tpu.ops import loss as jloss
from wormhole_tpu.ops import penalty as jp
from wormhole_tpu.ops import tilemm as jt
from wormhole_tpu_torch.learners import handles as th
from wormhole_tpu_torch.ops import penalty as tp
from wormhole_tpu_torch.ops import tilemm as tt

SPEC_ARGS = dict(nb=2 * tt.TILE, subblocks=2, cap=1280, group=2,
                 tiles_step=2)
SPEC, JSPEC = tt.TileSpec(**SPEC_ARGS), jt.TileSpec(**SPEC_ARGS)
# the K-tile geometry the JAX package runs through _bwd_kernel_fused (#3)
K2_ARGS = dict(nb=4 * tt.TILE, subblocks=2, cap=128, group=2, tiles_step=4,
               fuse=2)
SPECK2, JSPECK2 = tt.TileSpec(**K2_ARGS), jt.TileSpec(**K2_ARGS)
OVF_CAP = 1536
LOSSES = ["logit", "hinge", "square_hinge", "square"]
ALPHA, BETA, LAM = 0.1, 1.0, (0.05, 0.01)


def i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def f32(a):
    """A float32 tensor of its own (a copy: the port updates in place)."""
    return torch.from_numpy(np.array(a, np.float32))


def bf16(x):
    return f32(x).to(torch.bfloat16).float().numpy().astype(np.float64)


def block(seed, spec=SPEC, n_pairs=4000, skew=False):
    """(buckets, rows, pw, ovf_b, ovf_r, n_ovf) of one encoded block; with
    ``skew`` a hot bucket past cap spills into the COO list."""
    rng = np.random.default_rng(seed)
    buckets = rng.integers(0, spec.nb, size=n_pairs).astype(np.int64)
    rows = rng.integers(0, spec.block_rows, size=n_pairs).astype(np.int64)
    if skew:
        buckets = np.concatenate([buckets,
                                  np.full(1400, 7 * tt.TILE // 4, np.int64)])
        rows = np.concatenate([rows, rng.integers(0, spec.block_rows, 1400)])
    pw, ob, orow, n_ovf = tt.encode_block_capped(buckets, rows, spec,
                                                 OVF_CAP)
    assert (n_ovf > 0) == skew
    return buckets, rows, pw, ob, orow, n_ovf


def row_data(seed, spec=SPEC):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(spec.nb) * 0.1).astype(np.float32)
    labels = (rng.random(spec.block_rows) < 0.4).astype(np.float32)
    mask = np.ones(spec.block_rows, np.float32)
    mask[-64:] = 0.0
    return w, labels, mask


def grad_tol(buckets, rows, d_port, d_jax, nb, sb=None, sr=None):
    """Per-bucket bound: the reorder term over bf16 duals, the bf16
    rounding difference of the two sides' duals, and the spill pairs'
    reorder term over f32 duals (see the module docstring)."""
    dp, dj = bf16(d_port), bf16(d_jax)
    mag = np.bincount(buckets, weights=np.abs(dp)[rows], minlength=nb)
    cnt = np.bincount(buckets, minlength=nb).astype(np.float64)
    tol = 4 * np.maximum(cnt, 1) * 2.0 ** -24 * mag
    tol += np.bincount(buckets, weights=np.abs(dp - dj)[rows], minlength=nb)
    if sb is not None:
        smag = np.bincount(sb, weights=np.abs(d_port[sr]), minlength=nb)
        scnt = np.bincount(sb, minlength=nb)
        tol += 4 * np.maximum(scnt, 1) * 2.0 ** -24 * smag
        tol += np.bincount(sb, weights=np.abs(d_port - d_jax)[sr],
                           minlength=nb)
    return tol + 1e-30


def margin_tol(buckets, rows, w, nrows, sb=None, sr=None):
    wb = np.abs(bf16(w))
    mag = np.bincount(rows, weights=wb[buckets], minlength=nrows)
    cnt = np.bincount(rows, minlength=nrows)
    if sb is not None:
        mag += np.bincount(sr, weights=np.abs(w[sb]), minlength=nrows)
        cnt = cnt + np.bincount(sr, minlength=nrows)
    return 4 * np.maximum(cnt, 1) * 2.0 ** -24 * mag + 1e-30


def tile_pairs(pw, spec):
    """(bucket, row) of every non-pad word of pw."""
    b, r, valid = tt.decode_pairs(i32(pw), spec)
    return b[valid].numpy(), r[valid].numpy()


def spills(ob, orow, n_ovf):
    return ob[:n_ovf].astype(np.int64), orow[:n_ovf].astype(np.int64)


# -- backward_grad ------------------------------------------------------------

@pytest.mark.parametrize("case", ["uniform", "spill", "fuse2"])
def test_backward_grad_matches_jax(case):
    """Port (plain, CPU) vs JAX backward_grad: _bwd_kernel (#2) on SPEC,
    with and without spill pairs, and _bwd_kernel_fused (#3) on a fuse=2
    spec, which the port covers with the same function."""
    spec, jspec = (SPECK2, JSPECK2) if case == "fuse2" else (SPEC, JSPEC)
    assert (spec.fuse > 1) == (case == "fuse2")
    _, _, pw, ob, orow, n_ovf = block(
        40, spec, n_pairs=700 if case == "fuse2" else 4000,
        skew=case == "spill")
    dual = (np.random.default_rng(41).standard_normal(spec.block_rows)
            * 0.5).astype(np.float32)
    spill = (ob, orow) if case == "spill" else (None, None)
    got = tt.backward_grad(i32(pw), f32(dual), spec,
                           *(None if a is None else i32(a)
                             for a in spill)).numpy()
    want = np.asarray(jt.backward_grad(pw, dual, jspec, *spill))
    kb, kr = tile_pairs(pw, spec)
    sb, sr = spills(ob, orow, n_ovf) if case == "spill" else (None, None)
    tol = grad_tol(kb, kr, dual, dual, spec.nb, sb, sr)
    assert np.all(np.abs(got - want) <= tol)
    # the exact reference: tile pairs see bf16(dual), spill pairs f32 dual
    ref = tt.backward_grad_ref(kb, kr, bf16(dual), spec.nb).astype(
        np.float64)
    if sb is not None:
        ref += np.bincount(sb, weights=dual[sr].astype(np.float64),
                           minlength=spec.nb)
    assert np.all(np.abs(got - ref) <= tol)
    assert np.count_nonzero(got) > 0.9 * len(np.unique(kb))


def grad_word_order_fold(pw, spec, dual):
    """Per bucket, f32 adds of bf16(dual[row]) from 0, one word at a time in
    word order (the order decode_pairs flattens the words in)."""
    b, r, valid = tt.decode_pairs(i32(pw), spec)
    db = f32(dual).to(torch.bfloat16).float().numpy()
    out = np.zeros(spec.nb, np.float32)
    for bk, rw in zip(b[valid].tolist(), r[valid].tolist()):
        out[bk] = np.float32(out[bk] + db[rw])
    return out


@pytest.mark.parametrize("case", ["uniform", "skew", "spill"])
def test_backward_grad_plain_sums_in_word_order_bitwise(case):
    """The order-exact plain backward equals a Python word-order fold, the
    single index_add_ over all words that the CPU ran before (it adds in
    index order too) and backward_pushes_plain at one channel, bit for bit:
    on a uniform block, a skewed one (one bucket holding 200 words, within
    cap) and a spilling one; with spill, backward_grad adds the spill
    pairs' duals to exactly these bits."""
    if case == "skew":
        rng = np.random.default_rng(45)
        buckets = np.concatenate([rng.integers(0, SPEC.nb, 3000),
                                  np.full(200, 5 * tt.TILE // 4)])
        rows = rng.integers(0, SPEC.block_rows, len(buckets))
        pw, ob, orow, n_ovf = tt.encode_block_capped(buckets, rows, SPEC,
                                                     OVF_CAP)
        assert n_ovf == 0
    else:
        _, _, pw, ob, orow, n_ovf = block(43, skew=case == "spill")
    dual = (np.random.default_rng(44).standard_normal(SPEC.block_rows)
            * 0.5).astype(np.float32)
    dual[::7] = 0.0                      # exact zeros among the terms
    P, D = i32(pw), f32(dual)
    got = tt.backward_grad_plain(P, D, SPEC)
    assert got.numpy().tobytes() == grad_word_order_fold(pw, SPEC,
                                                         dual).tobytes()
    bucket, row, valid = tt.decode_pairs(P, SPEC)
    one_call = torch.zeros(SPEC.nb).index_add_(
        0, bucket[valid], D.to(torch.bfloat16).float()[row[valid]])
    assert torch.equal(got, one_call)
    assert torch.equal(got, tt.backward_pushes_plain(P, D.view(-1, 1),
                                                     SPEC)[:, 0])
    if case == "skew":
        assert torch.count_nonzero(bucket[valid] == 5 * tt.TILE // 4) == 200
    sp = (i32(ob), i32(orow)) if case == "spill" else (None, None)
    want = (tt.spill_grad_scatter(got.clone(), D, *sp, SPEC)
            if case == "spill" else got)
    assert torch.equal(tt.backward_grad(P, D, SPEC, *sp), want)


def test_spill_grad_scatter_matches_jax_and_is_reproducible():
    rng = np.random.default_rng(42)
    g = rng.standard_normal(SPEC.nb).astype(np.float32)
    dual = rng.standard_normal(SPEC.block_rows).astype(np.float32)
    n = 64
    ob = np.full(n, 0xFFFFFFFF, np.uint32)
    orow = np.zeros(n, np.uint32)
    ob[:40] = rng.choice([3, 77, 20000, 32767], 40)   # runs of equal buckets
    orow[:40] = rng.integers(0, SPEC.block_rows, 40)
    want = np.asarray(jt.spill_grad_scatter(jnp.asarray(g), dual, ob, orow,
                                         JSPEC))
    runs = [tt.spill_grad_scatter(f32(g), f32(dual), i32(ob), i32(orow),
                                  SPEC).numpy() for _ in range(2)]
    assert runs[0].tobytes() == runs[1].tobytes()
    sb = ob[:40].astype(np.int64)
    sr = orow[:40].astype(np.int64)
    mag = np.bincount(sb, weights=np.abs(dual[sr]), minlength=SPEC.nb)
    tol = 4 * 41 * 2.0 ** -24 * (mag + np.abs(g)) + 1e-30
    assert np.all(np.abs(runs[0] - want) <= tol)
    changed = np.nonzero(runs[0] != g)[0]
    assert set(changed.tolist()) <= {3, 77, 20000, 32767}


# -- the fused steps ----------------------------------------------------------

def _jax_split_dual(loss, exact_dense, margin, labels, mask):
    d = jloss.create_loss(loss)[1](jnp.asarray(margin), jnp.asarray(labels),
                                   jnp.asarray(mask))
    if not exact_dense:
        d = j_nudge(d, jnp.asarray(labels), jnp.asarray(mask))
    return np.asarray(d)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("exact_dense", [True, False])
def test_fused_step_grad_matches_jax(loss, exact_dense):
    """Port fused_step_grad vs JAX (the one-grid Pallas step, #6), and the
    port's own split chain forward_margins → loss_dual → backward_grad,
    which it equals bitwise."""
    buckets, rows, pw, _, _, _ = block(50)
    w, labels, mask = row_data(51)
    w *= 8    # margins past 1 on some rows: the hinge losses saturate there
    mg_j, g_j = (np.asarray(x) for x in jt.fused_step_grad(
        pw, w, labels, mask, JSPEC, loss, exact_dense))
    args = (i32(pw), f32(w), f32(labels), f32(mask))
    mg_t, g_t = tt.fused_step_grad(*args, SPEC, loss, exact_dense)
    mg_s = tt.forward_margins(args[0], args[1], SPEC)
    d_s = tt.loss_dual(mg_s, args[2], args[3], loss, exact_dense)
    assert torch.equal(mg_t, mg_s)
    assert torch.equal(g_t, tt.backward_grad(args[0], d_s, SPEC))
    kb, kr = tile_pairs(pw, SPEC)
    assert np.all(np.abs(mg_t.numpy() - mg_j)
                  <= margin_tol(kb, kr, w, SPEC.block_rows))
    d_j = _jax_split_dual(loss, exact_dense, mg_j, labels, mask)
    tol = grad_tol(kb, kr, d_s.numpy(), d_j, SPEC.nb)
    assert np.all(np.abs(g_t.numpy() - g_j) <= tol)
    if not exact_dense and loss != "logit":
        # the nudge reached some saturated rows on both sides
        assert np.any(np.abs(d_s.numpy()) == np.float32(1e-30))


def test_fused_step_grad_spill_matches_jax():
    """The spill variant: the pre-aggregated spill grid enters before the
    dual, and the grad-side scatter runs on the dual recomputed from the
    emitted margins — port vs JAX, and port fused = port split bitwise."""
    buckets, rows, pw, ob, orow, n_ovf = block(52, skew=True)
    w, labels, mask = row_data(53)
    loss = "hinge"
    sp_j = jt.spill_margin_rows(w, ob, orow, JSPEC)
    mg_j, g_j = jt.fused_step_grad(pw, w, labels, mask, JSPEC, loss, False,
                                   spill_margins=sp_j)
    d_j = _jax_split_dual(loss, False, np.asarray(mg_j), labels, mask)
    g_j = np.asarray(jt.spill_grad_scatter(g_j, d_j, ob, orow, JSPEC))
    P, W, L, M = i32(pw), f32(w), f32(labels), f32(mask)
    B, R = i32(ob), i32(orow)
    sp = tt.spill_margin_rows(W, B, R, SPEC)
    mg_t, g_t = tt.fused_step_grad(P, W, L, M, SPEC, loss, False,
                                   spill_margins=sp)
    d_t = tt.loss_dual(mg_t, L, M, loss, False)
    g_t = tt.spill_grad_scatter(g_t, d_t, B, R, SPEC)
    mg_s = tt.forward_margins(P, W, SPEC, B, R)
    g_s = tt.backward_grad(P, tt.loss_dual(mg_s, L, M, loss, False), SPEC,
                           B, R)
    assert torch.equal(mg_t, mg_s) and torch.equal(g_t, g_s)
    kb, kr = tile_pairs(pw, SPEC)
    sb, sr = spills(ob, orow, n_ovf)
    assert np.all(np.abs(mg_t.numpy() - np.asarray(mg_j))
                  <= margin_tol(kb, kr, w, SPEC.block_rows, sb, sr))
    tol = grad_tol(kb, kr, d_t.numpy(), d_j, SPEC.nb, sb, sr)
    assert np.all(np.abs(g_t.numpy() - g_j) <= tol)


def ftrl_handles():
    return (jh.FTRLHandle(penalty=jp.L1L2(*LAM),
                          lr=jh.LearnRate(ALPHA, BETA)),
            th.FTRLHandle(penalty=tp.L1L2(*LAM),
                          lr=th.LearnRate(ALPHA, BETA)))


def slot_tol(s_old, g, new, gtol=0.0):
    """Per-bucket (nb, 3) bound on FTRL slots (module docstring): the
    f32 roundings of z' = (z + g) − σ·w (σ from the cancelling
    cg' − cg), carried into w' through the shrink (where |z'| − λ1 may
    cancel) and the α/β curvature, plus what a per-bucket gradient bound
    ``gtol`` moves."""
    eps = 8 * 2.0 ** -24
    s_old = s_old.astype(np.float64)
    w, z, cg = np.abs(s_old[:, 0]), np.abs(s_old[:, 1]), s_old[:, 2]
    # σ = (cg' − cg)/α cancels: cg's rounding enters relative to cg
    dsigma = eps * (np.abs(new[:, 2]) + cg) / ALPHA
    dz = eps * (z + np.abs(g)) + dsigma * w + gtol * (1 + w / ALPHA)
    dw = ALPHA / BETA * (dz + eps * (np.abs(new[:, 1]) + LAM[0]))
    tol = np.stack([dw + eps * np.abs(new[:, 0]), dz,
                    eps * np.abs(new[:, 2]) + gtol], axis=1)
    return tol + 1e-30


def test_fused_step_update_matches_jax():
    """Port fused_step_update (in place on plane-major slots) vs JAX's
    in-kernel FTRL step (#7): margins and the (nb, 3) slots, compared
    through the JAX layout; and the port's own split chain, bitwise."""
    buckets, rows, pw, _, _, _ = block(54)
    _, labels, mask = row_data(55)
    rng = np.random.default_rng(56)
    s32 = (rng.standard_normal((SPEC.nb, 3)) * 0.1).astype(np.float32)
    s32[:, 2] = np.abs(s32[:, 2])
    hj, ht = ftrl_handles()
    mg_j, new_j = (np.asarray(x) for x in jt.fused_step_update(
        pw, s32, labels, mask, JSPEC, "logit", hj))
    slots = f32(s32.T.copy())
    mg_t, wd2 = tt.fused_step_update(i32(pw), slots, f32(labels), f32(mask),
                                     SPEC, "logit", ht)
    split = f32(s32.T.copy())
    mg_s = tt.forward_margins(i32(pw), split[0], SPEC)
    d_s = tt.loss_dual(mg_s, f32(labels), f32(mask), "logit", True)
    wd2_s = tt.ftrl_push(split, tt.backward_grad(i32(pw), d_s, SPEC), ht)
    assert torch.equal(mg_t, mg_s) and torch.equal(slots, split)
    assert torch.equal(wd2, wd2_s)
    kb, kr = tile_pairs(pw, SPEC)
    assert np.all(np.abs(mg_t.numpy() - mg_j)
                  <= margin_tol(kb, kr, s32[:, 0], SPEC.block_rows))
    d_j = _jax_split_dual("logit", True, mg_j, labels, mask)
    gtol = grad_tol(kb, kr, d_s.numpy(), d_j, SPEC.nb)
    got = slots.numpy().T
    g_t = tt.backward_grad(i32(pw), d_s, SPEC).numpy()
    assert np.all(np.abs(got - new_j) <= slot_tol(s32, g_t, new_j, gtol))
    d0 = new_j[:, 0].astype(np.float64) - s32[:, 0]
    assert abs(float(wd2) - np.sum(d0 * d0)) <= 1e-4 * np.sum(d0 * d0)


def test_ftrl_update_matches_jax_push():
    """The plain FTRL slot math (FTRLHandle.update / push) vs the JAX
    handle's push on the same slots and gradient: the same f32 formula, so
    within a few f32 roundings (``slot_tol`` with no gradient term)."""
    rng = np.random.default_rng(57)
    s32 = (rng.standard_normal((SPEC.nb, 3)) * 0.3).astype(np.float32)
    s32[:, 2] = np.abs(s32[:, 2])
    g = (rng.standard_normal(SPEC.nb) * 0.5).astype(np.float32)
    g[:100] = 0.0
    hj, ht = ftrl_handles()
    want = np.asarray(hj.push(jnp.asarray(s32), jnp.asarray(g),
                              jnp.float32(1), jnp.float32(0)))
    slots = f32(s32.T.copy())
    wd2 = ht.push(slots, f32(g))
    assert np.all(np.abs(slots.numpy().T - want) <= slot_tol(s32, g, want))
    d0 = want[:, 0].astype(np.float64) - s32[:, 0]
    assert abs(float(wd2) - np.sum(d0 * d0)) <= 1e-5 * np.sum(d0 * d0)


# -- the resolver --------------------------------------------------------------

STRUCTURAL = [
    ("fused", dict(spec="SPEC")),
    ("split", dict()),
    ("split", dict(spec="SPEC", onehot_cache="on")),
    ("fused", dict(ovf_cap=64, spec="SPEC")),
    ("fused", dict(mesh=True)),
    ("fused", dict(deep=True, ovf_cap=64, spec="SPEC")),
    ("fused", dict(deep=True)),
    ("fused", dict(spec="SPEC", onehot_cache="off")),
    ("fused", dict(spec="SPEC", channels=6, onehot_cache="on")),
    ("fused", dict(spec="K2", onehot_cache="on")),
    ("fused", dict()),
]


@pytest.mark.parametrize("kernel,kw", STRUCTURAL)
def test_resolve_step_kernel_matches_jax(kernel, kw):
    """Every structural case resolves the kernel and records the split
    reason as the JAX package does. The cache record matches JAX wherever
    JAX keeps the cache off; where the TPU would stage its planes, the port
    records off with its own reason (its kernels stage no one-hot planes)."""
    specs = {"SPEC": (SPEC, JSPEC), "K2": (SPECK2, JSPECK2)}
    tk, jk = dict(kw), dict(kw)
    if "spec" in kw:
        tk["spec"], jk["spec"] = specs[kw["spec"]]
    got = tt.resolve_step_kernel(kernel, device="cpu", **tk)
    want = jt.resolve_step_kernel(kernel, **jk)
    assert (got.kernel, got.why) == (want.kernel, want.why)
    assert not got.cache
    if want.cache:
        assert got.cache_record == ("onehot_cache=off:"
                                    + tt._NO_ONEHOT_PLANES)
    else:
        assert got.cache_record == want.cache_record


def test_resolve_auto_follows_the_device():
    on_cpu = tt.resolve_step_kernel("auto", spec=SPEC, device="cpu")
    assert (on_cpu.kernel, on_cpu.why) == ("split", "auto on cpu device")
    assert on_cpu.cache_record == \
        "onehot_cache=off:split path shares no phases"
    # a CUDA device resolves fused whether or not this host has one: the
    # resolver never looks at a build, so it cannot fall back to split
    on_cuda = tt.resolve_step_kernel("auto", spec=SPEC, device="cuda")
    assert (on_cuda.kernel, on_cuda.why) == ("fused", "")
    assert not on_cuda.cache and "no one-hot planes" in on_cuda.cache_why
    assert tt.resolve_step_kernel("auto", mesh=True,
                                  device="cuda").kernel == "split"
    with pytest.raises(ValueError, match="tile_step_kernel"):
        tt.resolve_step_kernel("bogus")
    with pytest.raises(ValueError, match="tile_onehot_cache"):
        tt.resolve_step_kernel("fused", onehot_cache="bogus")


@pytest.mark.parametrize("bad", ["dual_shape", "dual_dtype", "labels_dtype",
                                 "slots_shape", "grad_device"])
def test_training_ops_reject_bad_operands(bad):
    _, _, pw, _, _, _ = block(58)
    P = i32(pw)
    w, labels, mask = (f32(a) for a in row_data(59))
    _, ht = ftrl_handles()
    with pytest.raises((TypeError, ValueError)):
        if bad == "dual_shape":
            tt.backward_grad(P, labels[:-1], SPEC)
        elif bad == "dual_dtype":
            tt.backward_grad(P, labels.double(), SPEC)
        elif bad == "labels_dtype":
            tt.fused_step_grad(P, w, labels.to(torch.uint8), mask, SPEC,
                               "logit", True)
        elif bad == "slots_shape":
            tt.fused_step_update(P, torch.zeros(SPEC.nb, 3), labels, mask,
                                 SPEC, "logit", ht)
        else:
            tt.ftrl_push(torch.zeros(3, SPEC.nb), w.to("meta"), ht)
