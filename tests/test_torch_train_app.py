"""The port's crec2 training slice against the JAX package: the store's train
steps (fused and split, on a spill-free file and on a spill file) and the app
end to end through ``main`` with ``device=cpu`` (train + val + predict +
model_out).

Tolerances. One step differs between the packages only in f32 summation
order (test_torch_train.py states the per-op bounds). Over several steps one
more effect enters: both sides round w (forward) and the dual (backward) to
bf16, and a value that lies within an f32 rounding of a bf16 rounding
boundary may round up on one side and down on the other. One such flip moves
a margin by at most 2⁻⁸·|w| (≤ 2⁻⁸ here, |w| < 1) or a gradient by one bf16
step of a dual (≤ 2⁻⁸, |dual| ≤ 1), and through the FTRL update
(w' ≤ α/β·|Δz'|, Δz' ≲ Δg·(1 + |w|/α)) a weight by ≤ 2⁻⁸·(α + 1) < 5e-3
per flip. So every slot is held within 1e-2 (a flip or two), and the bulk —
all but 1% of the buckets, which no flip reaches — within the f32 bound
1e-5·(1 + |x|). Metrics are sums over thousands of rows, within 1e-4
relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wormhole_tpu.data import crec as jc
from wormhole_tpu.learners import handles as jh
from wormhole_tpu.learners import store as js
from wormhole_tpu.ops import penalty as jp
from wormhole_tpu_torch.data import crec as tc
from wormhole_tpu_torch.learners import handles as th
from wormhole_tpu_torch.learners import store as ts
from wormhole_tpu_torch.learners.async_sgd import AsyncSGD, main
from wormhole_tpu_torch.ops import penalty as tp
from wormhole_tpu_torch.ops import tilemm as tt
from wormhole_tpu_torch.utils.config import Config

NB = 2 * tt.TILE
NNZ = 6
LAM = (0.05, 0.01)
ROWS = 2 * tt.RSUB + 700          # two full blocks and a padded tail
NO_PLANES = "onehot_cache=off:" + tt._NO_ONEHOT_PLANES


def make_file(path, seed, spill):
    """Three one-subblock blocks of criteo-like rows whose labels follow a
    hidden linear model; with ``spill`` the cap sits near the mean tile
    load, so several hundred pairs per block spill into the COO list."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 20, size=(ROWS, NNZ), dtype=np.uint32)
    keys[rng.random(keys.shape) < 0.1] = 0xFFFFFFFF
    truth = rng.standard_normal(1 << 20) * 0.8
    real = keys != 0xFFFFFFFF
    m = np.where(real, truth[np.where(real, keys, 0) % (1 << 20)], 0).sum(1)
    labels = (rng.random(ROWS) < 1 / (1 + np.exp(-m))).astype(np.uint8)
    cap = 22144 if spill else tc.default_cap(NNZ, NB)
    with tc.CRec2Writer(str(path), nnz=NNZ, nb=NB, subblocks=1, cap=cap,
                        ovf_cap=1024 if spill else 0) as w:
        w.append(keys, labels)
    return str(path)


def n_spill(path):
    return sum(int(np.count_nonzero(v["ovf_b"] != 0xFFFFFFFF))
               for v, _ in jc.iter_packed2(path))


def handles():
    return (jh.FTRLHandle(penalty=jp.L1L2(*LAM), lr=jh.LearnRate(0.1, 1.0)),
            th.FTRLHandle(penalty=tp.L1L2(*LAM), lr=th.LearnRate(0.1, 1.0)))


def assert_slots_close(got, want):
    """Every slot within 1e-2, and 99% within 1e-5·(1 + |x|) (module
    docstring: bf16 flips vs f32 reordering)."""
    err = np.abs(got.astype(np.float64) - want)
    assert err.max() <= 1e-2, err.max()
    tight = err <= 1e-5 * (1 + np.abs(want))
    assert tight.mean() >= 0.99, tight.mean()


def assert_macc_close(got, want):
    """[objv, num_ex, acc, wdelta2, pos[512], neg[512]] summed over steps:
    sums within 1e-4 relative, the example count exact, and the
    histograms equal up to rows whose margin moved across a bin edge."""
    assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0])
    assert got[1] == want[1]
    assert abs(got[2] - want[2]) <= 1e-3
    assert abs(got[3] - want[3]) <= 1e-3 * abs(want[3])
    assert got[4:].sum() == want[4:].sum()
    assert np.abs(got[4:] - want[4:]).sum() <= 0.002 * want[4:].sum()


def run_jax(path, kernel, s0):
    hj, _ = handles()
    st = js.ShardedStore(js.StoreConfig(num_buckets=NB,
                                        tile_step_kernel=kernel), hj)
    st.slots = jnp.asarray(s0)
    info = jc.read_header2(path)
    for views, _ in jc.iter_packed2(path):
        st.tile_train_step({k: jnp.asarray(v) for k, v in views.items()},
                           info)
    jax.block_until_ready(st.slots)
    return np.asarray(st.slots), np.asarray(st._macc), st.step_kernel


def run_port(path, kernel, s0):
    _, ht = handles()
    st = ts.ShardedStore(ts.StoreConfig(num_buckets=NB,
                                        tile_step_kernel=kernel), ht,
                         device="cpu")
    st.from_jax_slots(s0)
    info = tc.read_header2(path)
    for views, _ in tc.iter_packed2(path):
        assert st.tile_train_step(tc.block_tensors(views), info) is None
    kernel_rec = st._tile_kernel[(info, "train")]
    return st.to_jax_slots(), st.fetch_metrics(), kernel_rec, st


@pytest.mark.parametrize("spill", [False, True])
def test_store_train_steps_match_jax(tmp_path, spill):
    """Three train steps (one per block) of the port's store, fused and
    split, against the JAX store's: slots and the metric accumulator, and
    the recorded step kernels. Inside the port, fused = split bitwise."""
    path = make_file(tmp_path / "t.crec2", 60 + spill, spill)
    assert (n_spill(path) > 0) == spill
    rng = np.random.default_rng(61)
    s0 = (rng.standard_normal((NB, 3)) * 0.05).astype(np.float32)
    s0[:, 2] = np.abs(s0[:, 2])
    resolved = "fused" if spill else "fused_update"
    ports = {}
    for kernel in ("fused", "split"):
        js_, jm, jk = run_jax(path, kernel, s0)
        ps, pm, pk, st = run_port(path, kernel, s0)
        assert st.t == 4 and st.fetch_metrics().sum() == 0  # fetch resets
        assert_slots_close(ps, js_)
        assert_macc_close(pm, jm)
        assert pk[:2] == jk[:2]
        assert pk[0] == (resolved if kernel == "fused" else "split")
        assert pk[2] == (NO_PLANES if kernel == "fused" else jk[2])
        ports[kernel] = (ps, pm)
    np.testing.assert_array_equal(ports["fused"][0], ports["split"][0])
    np.testing.assert_array_equal(ports["fused"][1], ports["split"][1])


def test_store_helpers_match_jax():
    """zero_grad_push_is_identity, the nudge and masked_push (with the
    touched-bucket mask for a non-exact-dense apply) against the JAX
    store's helpers."""
    hj, ht = handles()
    assert ts.zero_grad_push_is_identity(ht) == \
        js.zero_grad_push_is_identity(hj) is True
    plain = th.Handle(penalty=tp.L1L2(0.0, 0.0))
    assert ts.zero_grad_push_is_identity(plain)
    assert not ts.zero_grad_push_is_identity(
        th.Handle(penalty=tp.L1L2(0.1, 0.0)))
    rng = np.random.default_rng(62)
    dual = np.where(rng.random(1000) < 0.3, 0.0,
                    rng.standard_normal(1000)).astype(np.float32)
    labels = (rng.random(1000) < 0.5).astype(np.float32)
    mask = (rng.random(1000) < 0.8).astype(np.float32)
    want = np.asarray(js._nudge_zero_dual(jnp.asarray(dual),
                                          jnp.asarray(labels),
                                          jnp.asarray(mask)))
    got = ts._nudge_zero_dual(torch.from_numpy(dual),
                              torch.from_numpy(labels),
                              torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    s0 = (rng.standard_normal((NB, 3)) * 0.1).astype(np.float32)
    s0[:, 2] = np.abs(s0[:, 2])
    g = np.where(rng.random(NB) < 0.5, 0.0,
                 rng.standard_normal(NB)).astype(np.float32)
    for exact in (True, False):
        want = np.asarray(js.masked_push(hj, jnp.asarray(s0), jnp.asarray(g),
                                         jnp.float32(1), jnp.float32(0),
                                         exact))
        slots = torch.from_numpy(s0.T.copy())
        wd2 = ts.masked_push(ht, slots, torch.from_numpy(g), 1.0, 0.0, exact)
        np.testing.assert_allclose(slots.numpy().T, want, rtol=1e-5,
                                   atol=1e-6)
        if not exact:   # untouched buckets keep every slot
            np.testing.assert_array_equal(slots.numpy().T[g == 0],
                                          s0[g == 0])
        d0 = want[:, 0].astype(np.float64) - s0[:, 0]
        assert abs(float(wd2) - np.sum(d0 * d0)) <= 1e-4 * np.sum(d0 * d0)


def _jax_app(**kw):
    from wormhole_tpu.learners.async_sgd import AsyncSGD as JApp
    from wormhole_tpu.parallel.mesh import MeshRuntime, make_mesh
    from wormhole_tpu.utils.config import Config as JConfig
    rt = MeshRuntime.create()
    rt.mesh = make_mesh("data:1", jax.devices()[:1])
    return JApp(JConfig(**kw), rt)


def test_main_trains_like_the_jax_app(tmp_path):
    """One training pass through the port's ``main`` (device=cpu) and the
    JAX app's ``run`` on the same spill file: Progress objv, AUC and
    accuracy, the validation pass, the predictions and the saved model."""
    path = make_file(tmp_path / "t.crec2", 63, True)
    kw = dict(data_format="crec2", num_buckets=NB, train_data=path,
              val_data=path, max_data_pass=1, lambda_=list(LAM),
              disp_itv=1e12)
    japp = _jax_app(**kw, test_data=path, pred_out=str(tmp_path / "pj"),
                    model_out=str(tmp_path / "mj"))
    jprog = japp.run()
    assert main(["data_format=crec2", f"num_buckets={NB}",
                 f"train_data={path}", f"val_data={path}",
                 "max_data_pass=1", f"lambda={LAM[0]} {LAM[1]}",
                 "disp_itv=1e12", f"test_data={path}",
                 f"pred_out={tmp_path / 'pt'}",
                 f"model_out={tmp_path / 'mt'}", "device=cpu"]) == 0
    tapp = AsyncSGD(Config(**kw), device="cpu")
    tprog = tapp.run()
    assert tprog.num_ex == jprog.num_ex == ROWS
    assert tprog.count == jprog.count == 3
    for a, b in ((tprog.objv, jprog.objv), (tprog.auc, jprog.auc),
                 (tprog.acc, jprog.acc)):
        assert abs(a - b) <= 1e-4 * abs(b)
    rec = tapp.pass_log[0]
    jv, jauc = japp._run_eval(path)
    assert rec["val_num_ex"] == jv.num_ex == ROWS
    assert abs(rec["val_objv"] - jv.objv / jv.num_ex) <= 1e-4 * rec[
        "val_objv"]
    assert abs(rec["val_auc"] - jauc) <= 1e-4
    assert abs(rec["val_acc"] - jv.acc / jv.count) <= 1e-3
    assert rec["val_objv"] < rec["train_objv"]   # the pass learned
    pj, pt = np.loadtxt(tmp_path / "pj"), np.loadtxt(tmp_path / "pt")
    assert pj.shape == pt.shape == (ROWS,)
    assert np.abs(pt - pj).max() <= 1e-3
    assert np.mean(np.abs(pt - pj) <= 1e-5) >= 0.99
    mj = np.loadtxt(tmp_path / "mj_0", comments="#")
    mt = np.loadtxt(tmp_path / "mt_0", comments="#")
    wj, wt = np.zeros(NB), np.zeros(NB)
    wj[mj[:, 0].astype(int)], wt[mt[:, 0].astype(int)] = mj[:, 1], mt[:, 1]
    assert_slots_close(wt[:, None], wj[:, None])


def test_train_loop_stops_on_divergence_and_converges(tmp_path):
    """max_objv kills a run whose objv per example exceeds it; epsilon
    stops training once a pass improves objv by less than it."""
    from wormhole_tpu_torch.learners.async_sgd import DivergedError
    path = make_file(tmp_path / "t.crec2", 64, False)
    base = dict(data_format="crec2", num_buckets=NB, train_data=path,
                disp_itv=1e12)
    with pytest.raises(DivergedError, match="max_objv"):
        AsyncSGD(Config(**base, max_data_pass=1, max_objv=0.1),
                 device="cpu").run()
    app = AsyncSGD(Config(**base, max_data_pass=5, epsilon=0.5),
                   device="cpu")
    app.run()
    assert len(app.pass_log) == 2      # pass 2 improves by less than 50%
