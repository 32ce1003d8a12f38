"""The wide&deep boundary's order-exact plain version
(``tilemm.wd_boundary_ordered_plain``, the version the CUDA kernel of
``csrc/tile_wd.cuh`` is held to bitwise on the card) against the JAX
package: ``jax.vjp`` of ``mlp_forward`` (wormhole_tpu/ops/tilemm.py:1575),
the MLP phase of the fused step, and ``jt.fused_wd_step`` itself (Pallas in
interpret mode); against the port's autograd version; and against Python
folds of single f32 operations in the kernel's order. The kernel itself is
held to it in test_torch_kernels.py.

Tolerances, each from how the two sides compute:

- margins within 1e-5·(1 + |m|) and the parameter gradients within 1e-4 of
  the largest entry of each leaf (the JAX parity tests' bounds): both sides
  round every product and add in f32, in other orders, through He-
  initialised layers of gain ≈ 1, and a ReLU input within that of 0 may
  take the other side. A gradient entry also gets 1e-5 of the sum of its
  terms' magnitudes, Σ_rows |h|·|gz|: the activations and cotangents it
  sums agree to that, and a sum over thousands of rows whose terms cancel
  (W2 at hidden (300, 40): 1.1e-4 of the leaf maximum between JAX and
  either torch version, which agree with each other to 4e-6) carries their
  difference at the terms' scale;
- push rows [dual, g_pooled, mask] within 1e-5·(1 + |x|): the margins'
  bound carried through the dual (slope at most 1/4 for logit, 0 for hinge
  away from the kink) and the same layers backward;
- against a Python fold of np.float32 operations in the kernel's order:
  bitwise.
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
WIDTHS = [(4, (8,)), (16, (64, 32)), (16, (300, 40))]
# a tile that fits no CTA's shared memory, and an MLP deeper than the eight
# layers the kernel takes by value: the kernel runs both
ANY_WIDTHS = [(16, (1024, 512, 256)), (4, (8,) * 10)]


def f32(a):
    return torch.from_numpy(np.array(a, np.float32))


def mlp_draw(rng, k, hidden):
    sizes = [k] + list(hidden) + [1]
    mlp = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        mlp[f"W{i}"] = (rng.standard_normal((a, b))
                        * np.sqrt(2.0 / a)).astype(np.float32)
        mlp[f"b{i}"] = (rng.standard_normal(b) * 0.1).astype(np.float32)
    return mlp


def rows_draw(rng, n, k):
    """(pulls (n, 1+k), labels, mask with its last 5 rows 0) as float32."""
    pulls = (rng.standard_normal((n, 1 + k)) * 0.5).astype(np.float32)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[-5:] = 0
    return pulls, labels, mask


def close_rows(got, want, tol):
    want = np.asarray(want, np.float64)
    return np.all(np.abs(np.asarray(got, np.float64) - want)
                  <= tol * (1 + np.abs(want)))


def abs_terms(pulls, mlp, dual):
    """Per gradient entry, Σ_rows |h_l[a]|·|gz_{l+1}[b]| (and Σ |gz| for a
    bias), in float64 from the forward and backward of ``mlp``."""
    n_layers = len(mlp) // 2
    W = [torch.as_tensor(mlp[f"W{l}"]).double() for l in range(n_layers)]
    b = [torch.as_tensor(mlp[f"b{l}"]).double() for l in range(n_layers)]
    h, hs = torch.as_tensor(pulls)[:, 1:].double(), []
    for l in range(n_layers):
        hs.append(h)
        h = torch.relu(h @ W[l] + b[l])
    g, out = torch.as_tensor(dual).double()[:, None], {}
    for l in range(n_layers - 1, -1, -1):
        out[f"W{l}"] = (hs[l].abs().T @ g.abs()).numpy()
        out[f"b{l}"] = g.abs().sum(0).numpy()
        g = (g @ W[l].T) * (hs[l] > 0)
    return out


def close_leaves(got: dict, want: dict, terms=None):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w).reshape(np.asarray(got[key]).shape)
        tol = 1e-4 * np.abs(w).max() + 1e-7
        if terms is not None:
            tol = tol + 1e-5 * terms[key]
        assert np.all(np.abs(np.asarray(got[key]) - w) <= tol), key


@pytest.mark.parametrize("loss", ["logit", "hinge"])
@pytest.mark.parametrize("k,hidden", WIDTHS + ANY_WIDTHS)
def test_ordered_plain_matches_jax_vjp(k, hidden, loss):
    """Margins, push rows and every gradient leaf against ``jax.vjp`` of
    the JAX ``mlp_forward`` on the same pulls, and against the port's
    autograd version; 1,000 rows, not a multiple of the span or of a
    128-row tile."""
    rng = np.random.default_rng(11 + k + len(hidden))
    mlp = mlp_draw(rng, k, hidden)
    pulls, labels, mask = rows_draw(rng, 1000, k)
    n_layers = len(hidden) + 1

    @jax.jit
    def ref(pulls, labels, mask, mlp):
        deep, vjp = jax.vjp(lambda m, x: jt.mlp_forward(m, x, n_layers),
                            mlp, pulls[:, 1:])
        margin = pulls[:, 0] + deep
        dual = jloss.create_loss(loss)[1](margin, labels, mask)
        g_mlp, g_pooled = vjp(dual)
        return margin, jnp.concatenate([dual[:, None], g_pooled,
                                        mask[:, None]], 1), g_mlp

    mj, dvj, gj = ref(pulls, labels, mask,
                      {n: jnp.asarray(v) for n, v in mlp.items()})
    tm = {n: f32(v) for n, v in mlp.items()}
    mo, dvo, go = tt.wd_boundary_ordered_plain(f32(pulls), f32(labels),
                                               f32(mask), tm, loss)
    assert close_rows(mo.numpy(), mj, 1e-5)
    assert close_rows(dvo.numpy(), dvj, 1e-5)
    close_leaves({n: v.numpy() for n, v in go.items()}, gj,
                 abs_terms(pulls, mlp, dvo[:, 0]))
    mp, dvp, gp = tt.wd_boundary_plain(f32(pulls), f32(labels), f32(mask),
                                       tm, loss)
    assert close_rows(mo.numpy(), mp.numpy(), 1e-5)
    assert close_rows(dvo.numpy(), dvp.numpy(), 1e-5)
    close_leaves({n: v.numpy() for n, v in go.items()},
                 {n: v.numpy() for n, v in gp.items()})
    me = tt.wd_boundary_ordered_plain(f32(pulls), f32(labels), f32(mask),
                                      tm, loss, want_grad=False)
    assert torch.equal(me[0], mo) and me[1] is None and me[2] is None


@pytest.mark.parametrize("loss", ["logit", "hinge"])
@pytest.mark.parametrize("k,hidden", WIDTHS)
def test_ordered_plain_matches_jax_fused_step(k, hidden, loss):
    """The ordered plain boundary on the port's pulls against JAX's one-grid
    wide&deep step (#9): its margins, and its MLP gradients leaf by leaf."""
    rng = np.random.default_rng(21 + k + len(hidden))
    buckets = rng.integers(0, SPEC.nb, size=4000).astype(np.int64)
    rows = rng.integers(0, SPEC.block_rows, size=4000).astype(np.int64)
    pw, _, _, n_ovf = tt.encode_block_capped(buckets, rows, SPEC, 1536)
    assert n_ovf == 0
    wpull = (rng.standard_normal((SPEC.nb, 1 + k)) * 0.3).astype(np.float32)
    mlp = mlp_draw(rng, k, hidden)
    labels = (rng.random(SPEC.block_rows) < 0.3).astype(np.float32)
    mask = np.ones(SPEC.block_rows, np.float32)
    mask[-50:] = 0
    mj, _, gj = jt.fused_wd_step(pw, wpull, labels, mask,
                                 {n: jnp.asarray(v) for n, v in mlp.items()},
                                 JSPEC, k, hidden, loss)
    P = torch.from_numpy(np.ascontiguousarray(pw).view(np.int32))
    pulls = tt.forward_pulls(P, f32(wpull), SPEC)
    mo, dvo, go = tt.wd_boundary_ordered_plain(
        pulls, f32(labels), f32(mask), {n: f32(v) for n, v in mlp.items()},
        loss)
    assert close_rows(mo.numpy(), mj, 1e-5)
    close_leaves({n: v.numpy() for n, v in go.items()},
                 {n: np.asarray(v) for n, v in gj.items()},
                 abs_terms(pulls, mlp, dvo[:, 0]))


def fold_boundary(pulls, labels, mask, mlp, span):
    """The boundary of a few rows as a Python fold of np.float32 operations
    in the kernel's order (hinge loss, so the dual needs no exp): (margins,
    push rows, gradient leaves)."""
    f = np.float32
    n_layers = len(mlp) // 2
    Ws = [mlp[f"W{l}"] for l in range(n_layers)]
    bs = [mlp[f"b{l}"] for l in range(n_layers)]
    n = pulls.shape[0]
    margins, dv, hs_all, gz_all = [], [], [], []
    for r in range(n):
        h, hs = [f(x) for x in pulls[r, 1:]], []
        for l, (W, b) in enumerate(zip(Ws, bs)):
            hs.append(h)
            z = []
            for c in range(W.shape[1]):
                acc = f(0)
                for a in range(W.shape[0]):
                    acc = f(acc + f(h[a] * W[a, c]))
                z.append(f(acc + b[c]))
            h = [x if x > 0 else f(0) for x in z] if l + 1 < n_layers else z
        m = f(f(pulls[r, 0]) + h[0])
        y = f(1) if labels[r] > 0.5 else f(-1)
        active = f(1) if f(f(1) - f(y * m)) > 0 else f(0)
        d = f(f(f(-y) * active) * f(mask[r]))
        g, gzs = [d], {}
        for l in range(n_layers - 1, -1, -1):
            gzs[l] = g
            W = Ws[l]
            gh = []
            for a in range(W.shape[0]):
                acc = f(0)
                for c in range(W.shape[1]):
                    acc = f(acc + f(g[c] * W[a, c]))
                gh.append(acc)
            g = ([x if hs[l][a] > 0 else f(0) for a, x in enumerate(gh)]
                 if l > 0 else gh)
        margins.append(m)
        dv.append([d] + g + [f(mask[r])])
        hs_all.append(hs)
        gz_all.append(gzs)
    grads = {}
    for l, W in enumerate(Ws):
        gw = np.zeros(W.shape, np.float32)
        gb = np.zeros(W.shape[1], np.float32)
        for s0 in range(0, n, span):
            pw_ = np.zeros(W.shape, np.float32)
            pb = np.zeros(W.shape[1], np.float32)
            for r in range(s0, min(n, s0 + span)):
                for a in range(W.shape[0]):
                    for c in range(W.shape[1]):
                        pw_[a, c] = f(pw_[a, c]
                                      + f(hs_all[r][l][a] * gz_all[r][l][c]))
                for c in range(W.shape[1]):
                    pb[c] = f(pb[c] + gz_all[r][l][c])
            gw = (gw + pw_).astype(np.float32)
            gb = (gb + pb).astype(np.float32)
        grads[f"W{l}"], grads[f"b{l}"] = gw, gb
    return (np.array(margins, np.float32), np.array(dv, np.float32), grads)


@pytest.mark.parametrize("n,span", [(37, tt.WD_SPAN_ROWS), (150, 64)])
def test_ordered_plain_equals_a_python_fold_bitwise(n, span):
    """Every row's margin and push row, and every gradient summed row by
    row within a span and span by span, equal a fold of single np.float32
    operations in the kernel's order bit for bit, also for a row count that
    is not a multiple of the span (150 rows: two full spans and 22 rows)."""
    rng = np.random.default_rng(31 + n)
    k, hidden = 4, (8, 3)
    mlp = mlp_draw(rng, k, hidden)
    pulls, labels, mask = rows_draw(rng, n, k)
    mf, dvf, gf = fold_boundary(pulls, labels, mask, mlp, span)
    mo, dvo, go = tt.wd_boundary_ordered_plain(
        f32(pulls), f32(labels), f32(mask),
        {n_: f32(v) for n_, v in mlp.items()}, "hinge", span=span)
    np.testing.assert_array_equal(mo.numpy().view(np.int32),
                                  mf.view(np.int32))
    np.testing.assert_array_equal(dvo.numpy().view(np.int32),
                                  dvf.view(np.int32))
    assert list(go) == list(mlp)
    for key in mlp:
        np.testing.assert_array_equal(go[key].numpy().view(np.int32),
                                      gf[key].view(np.int32))


def test_ordered_plain_span_orders_only_the_gradients():
    """The span changes the order of the parameter sums and nothing else:
    margins and push rows are the same bits at any span, and the gradients
    of a ragged row count agree across spans within the f32 reorder
    bound."""
    rng = np.random.default_rng(41)
    k, hidden = 16, (64, 32)
    tm = {n: f32(v) for n, v in mlp_draw(rng, k, hidden).items()}
    pulls, labels, mask = (f32(a) for a in rows_draw(rng, 1000, k))
    a = tt.wd_boundary_ordered_plain(pulls, labels, mask, tm, "logit")
    b = tt.wd_boundary_ordered_plain(pulls, labels, mask, tm, "logit",
                                     span=96)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    close_leaves({n: v.numpy() for n, v in b[2].items()},
                 {n: v.numpy() for n, v in a[2].items()})
    assert torch.equal(a[1][:, -1], mask)


@pytest.mark.parametrize("loss", ["logit", "hinge", "square_hinge",
                                  "square"])
def test_kernel_order_dual_matches_the_loss_dual(loss):
    """``kernel_order_dual`` (the device function's operations one by one)
    equals the loss module's dual within a few f32 roundings, masked rows
    zero."""
    rng = np.random.default_rng(51)
    m = f32(rng.standard_normal(2000) * 3)
    labels = f32(rng.random(2000) < 0.4)
    mask = f32(rng.random(2000) < 0.9)
    got = tt.kernel_order_dual(m, labels, mask, loss)
    want = tt.create_loss(loss)[1](m, labels, mask)
    assert torch.all((got - want).abs() <= 4e-7 * (1 + want.abs()))
    assert torch.all(got[mask == 0] == 0)
