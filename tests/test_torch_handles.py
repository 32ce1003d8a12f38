"""The port's six server handles and the sparse gradient quantizer against
the JAX package's, on the CPU.

Each handle's update is the JAX handle's elementwise math in the same
order, every operation rounded to f32 once (a division by a scalar divides
by a 0-d tensor and a square root is correctly rounded, as XLA's are), so
on this host the slots come out bitwise equal. The freedom left is that
XLA may contract a product and an add into one FMA where torch rounds
twice: an ulp of an O(1) intermediate, which FTRL's prox can carry into w
at the scale of its inputs. So the new slots are held within 4 ulp of
1 + |x| (``assert_ulps``), and Σ(Δw)² within 1e-5 relative. The quantizer
runs the same four operations on the same input, so its output is held
bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wormhole_tpu.learners import handles as jh
from wormhole_tpu.learners import store as js
from wormhole_tpu.ops import penalty as jp
from wormhole_tpu.parallel.filters import quantize_dequantize as jquant
from wormhole_tpu_torch.learners import handles as th
from wormhole_tpu_torch.learners import store as ts
from wormhole_tpu_torch.ops import penalty as tp

ALGOS = ["ftrl", "sgd", "adagrad", "dt_sgd", "dt_adagrad", "dt2_adagrad"]
K = 4099
ULPS = 4


def assert_ulps(got, want, ulps=ULPS):
    """|got − want| ≤ ``ulps`` f32 ulps of 1 + |want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    spacing = np.spacing(np.float32(1) + np.abs(want))
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(err <= ulps * spacing), (err / spacing).max()


def pair(algo, lam=(0.05, 0.01), lr=(0.1, 1.0)):
    return (jh.create_handle(algo, jp.L1L2(*lam), jh.LearnRate(*lr)),
            th.create_handle(algo, tp.L1L2(*lam), th.LearnRate(*lr)))


def random_slots(rng, algo, val_len, k=K):
    """Slots a handle can hold: accumulators ≥ 0 (DT2's cg2max ≥ cg2)."""
    s = rng.standard_normal((k, val_len)).astype(np.float32)
    if algo in ("adagrad", "dt_adagrad", "ftrl"):
        s[:, -1] = np.abs(s[:, -1])
    if algo == "dt2_adagrad":
        s[:, 2] = np.abs(s[:, 2])
        s[:, 3] = s[:, 2] + np.abs(s[:, 3])
    s[rng.random(k) < 0.1] = 0.0        # untouched keys
    return s


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("t,tau", [(1.0, 0.0), (37.0, 2.0), (1e4, 3.5)])
def test_handle_apply_matches_jax_push(algo, t, tau):
    """``apply`` on plane-major rows equals the JAX ``push`` on the same
    (k, val_len) slots, gradient, clock and staleness within 4 ulp."""
    rng = np.random.default_rng(hash((algo, t)) % 2**32)
    hj, ht = pair(algo)
    assert ht.val_len == hj.val_len
    s = random_slots(rng, algo, hj.val_len)
    g = (rng.standard_normal(K) * 0.3).astype(np.float32)
    g[rng.random(K) < 0.2] = 0.0
    want = np.asarray(hj.push(jnp.asarray(s), jnp.asarray(g),
                              jnp.float32(t), jnp.float32(tau)))
    got = ht.apply(torch.from_numpy(s.T.copy()), torch.from_numpy(g), t,
                   tau).numpy().T
    assert_ulps(got, want)


def test_dt2_apply_with_snapshot_matches_jax():
    """DT2 with a pull-time gsum snapshot (the sparse path's dt2_push),
    also with lr_beta = 0, where the first push's correction is 0."""
    rng = np.random.default_rng(7)
    for beta in (1.0, 0.0):
        hj, ht = pair("dt2_adagrad", lr=(0.1, beta))
        s = random_slots(rng, "dt2_adagrad", 4)
        s[:5] = 0.0                          # first-ever pushes
        g = (rng.standard_normal(K) * 0.3).astype(np.float32)
        snap = s[:, 1] - (rng.standard_normal(K) * 0.1).astype(np.float32)
        want = np.asarray(hj.push(jnp.asarray(s), jnp.asarray(g),
                                  jnp.float32(0), jnp.float32(0),
                                  gsum_snap=jnp.asarray(snap)))
        got = ht.apply(torch.from_numpy(s.T.copy()), torch.from_numpy(g),
                       0.0, 0.0, gsum_snap=torch.from_numpy(snap))
        assert bool(torch.isfinite(got).all())
        assert_ulps(got.numpy().T, want)


@pytest.mark.parametrize("algo", ALGOS)
def test_push_in_place_returns_wdelta2(algo):
    """``push`` writes ``apply``'s rows into the table in place and
    returns Σ(w' − w)² (FTRL through its plain ``ftrl_push`` on the CPU,
    whose table is whole tiles); the JAX store's ``masked_push`` gives the
    same table, masked or not."""
    rng = np.random.default_rng(11)
    hj, ht = pair(algo)
    nb = 16384
    s = random_slots(rng, algo, hj.val_len, nb)
    g = (rng.standard_normal(nb) * 0.3).astype(np.float32)
    g[rng.random(nb) < 0.3] = 0.0
    for exact in (True, False):
        table = torch.from_numpy(s.T.copy())
        wd2 = ts.masked_push(ht, table, torch.from_numpy(g), 5.0, 1.0,
                             exact)
        want = np.asarray(js.masked_push(hj, jnp.asarray(s), jnp.asarray(g),
                                         jnp.float32(5.0), jnp.float32(1.0),
                                         exact))
        assert_ulps(table.numpy().T, want)
        d0 = want[:, 0].astype(np.float64) - s[:, 0]
        assert abs(float(wd2) - np.sum(d0 * d0)) <= 1e-5 * np.sum(d0 * d0)


@pytest.mark.parametrize("algo", ALGOS)
def test_create_handle_and_warm_start_match_jax(algo):
    """Every algo resolves in both packages to the same layout and the same
    mask decision, and a warm start gives the same slots."""
    hj, ht = pair(algo)
    assert type(ht).__name__ == type(hj).__name__
    assert ts.zero_grad_push_is_identity(ht) == \
        js.zero_grad_push_is_identity(hj)
    w = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    assert_ulps(ht.warm_start(torch.from_numpy(w)).numpy().T,
                np.asarray(hj.warm_start(jnp.asarray(w))))
    assert ht.init(10).shape == (hj.val_len, 10)


def test_create_handle_rejects_unknown():
    with pytest.raises(ValueError, match="unknown algo"):
        th.create_handle("lbfgs")


@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_dequantize_matches_jax_bitwise(bits):
    """The fixed_bytes round trip: round(g / scale · levels) · (scale /
    levels), half to even, bitwise as the JAX filter's (also on a vector
    whose scaled values land exactly on .5, and on an all-zero one)."""
    rng = np.random.default_rng(bits)
    cases = [(rng.standard_normal(5000) * 1e-3).astype(np.float32),
             np.array([-1.0, 0.5 / 127, 1.5 / 127, 2.5 / 127, 0.0],
                      np.float32),
             np.zeros(64, np.float32)]
    for g in cases:
        want = np.asarray(jquant(jnp.asarray(g), bits))
        got = ts.quantize_dequantize(torch.from_numpy(g), bits).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
