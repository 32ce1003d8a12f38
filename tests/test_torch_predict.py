"""The port's crec2 predict/eval slice against the JAX package: weights
carried across, the tile eval step's metrics, the margin histogram, and the
predictions written by the two apps' ``main``/``predict``.

Tolerances: margins differ only by f32 summation order (bound stated in
test_torch_tilemm.py), which moves objv, the predictions and the pooled
metrics by far less than the 1e-5 relative the tests allow.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wormhole_tpu.data import crec as jc
from wormhole_tpu.learners import handles as jh
from wormhole_tpu.learners import store as js
from wormhole_tpu.ops import loss as jloss
from wormhole_tpu.ops import metrics as jm
from wormhole_tpu.ops import penalty as jp
from wormhole_tpu_torch.data import crec as tc
from wormhole_tpu_torch.learners import handles as th
from wormhole_tpu_torch.learners import store as ts
from wormhole_tpu_torch.learners.async_sgd import AsyncSGD, main
from wormhole_tpu_torch.ops import loss as tloss
from wormhole_tpu_torch.ops import metrics as tm
from wormhole_tpu_torch.ops import penalty as tp
from wormhole_tpu_torch.ops.tilemm import TILE
from wormhole_tpu_torch.serve import tile_margins
from wormhole_tpu_torch.utils.config import Config

NB = 2 * TILE
NNZ = 8
LAM = (0.05, 0.01)


def make_file(path, seed=0, n=300, spill=True):
    """A few hundred criteo-like rows; cap=1024 makes both tiles spill a
    little into the COO list, cap=1280 keeps every pair in the tiles."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, size=(n, NNZ), dtype=np.uint32)
    keys[keys == 0xFFFFFFFF] = 0
    keys[rng.random((n, NNZ)) < 0.1] = 0xFFFFFFFF
    labels = (rng.random(n) < 0.4).astype(np.uint8)
    with tc.CRec2Writer(str(path), nnz=NNZ, nb=NB, subblocks=2,
                        cap=1024 if spill else 1280, ovf_cap=256) as w:
        w.append(keys, labels)
    return str(path)


def model_weights(seed=1):
    """Weights with at most 5 significant digits, so save_model's %.6g
    text round-trips them exactly; about a third are exactly zero."""
    rng = np.random.default_rng(seed)
    w = np.round(rng.standard_normal(NB) * 0.5, 4).astype(np.float32)
    w[rng.random(NB) < 0.3] = 0.0
    return w


def handles():
    pen_j, pen_t = jp.L1L2(*LAM), tp.L1L2(*LAM)
    lr_j, lr_t = jh.LearnRate(0.1, 1.0), th.LearnRate(0.1, 1.0)
    return jh.FTRLHandle(penalty=pen_j, lr=lr_j), \
        th.FTRLHandle(penalty=pen_t, lr=lr_t)


def jax_store(w, loss="logit"):
    hj, _ = handles()
    st = js.ShardedStore(js.StoreConfig(num_buckets=NB, loss=loss), hj)
    st.slots = hj.warm_start(jnp.asarray(w))
    return st


def torch_store(loss="logit"):
    _, ht = handles()
    return ts.ShardedStore(ts.StoreConfig(num_buckets=NB, loss=loss), ht,
                           device="cpu")


def test_load_model_and_from_jax_slots_agree(tmp_path):
    """A JAX save_model file loaded by the port and the JAX slots carried
    by from_jax_slots give the same weights (and FTRL z) as the JAX
    store."""
    w = model_weights()
    jst = jax_store(w)
    jst.save_model(str(tmp_path / "m"), rank=0, key_fold="mix32")
    a = torch_store()
    a.load_model(str(tmp_path / "m"), expect_key_fold="mix32")
    b = torch_store()
    b.from_jax_slots(np.asarray(jst.slots))
    jw = np.asarray(jst.handle.weights(jst.slots))
    np.testing.assert_array_equal(jw, w)
    np.testing.assert_array_equal(a.handle.weights(a.slots).numpy(), jw)
    np.testing.assert_array_equal(b.handle.weights(b.slots).numpy(), jw)
    np.testing.assert_array_equal(a.slots.numpy(), np.asarray(jst.slots).T)
    np.testing.assert_array_equal(b.slots.numpy(), a.slots.numpy())
    with pytest.raises(ValueError, match="key_fold"):
        a.load_model(str(tmp_path / "m"), expect_key_fold="splitmix64")
    with pytest.raises(ValueError, match="shape"):
        b.from_jax_slots(np.zeros((NB, 2), np.float32))


def test_save_model_round_trips_through_jax(tmp_path):
    w = model_weights(seed=2)
    st = torch_store()
    st.slots = st.handle.warm_start(torch.from_numpy(w))
    st.save_model(str(tmp_path / "m"), key_fold="mix32")
    jst = jax_store(np.zeros(NB, np.float32))
    jst.load_model(str(tmp_path / "m"), expect_key_fold="mix32")
    np.testing.assert_array_equal(np.asarray(jst.handle.weights(jst.slots)),
                                  w)
    assert open(tmp_path / "m_0").read() == _jax_dump(jst, tmp_path)


def _jax_dump(jst, tmp_path):
    jst.save_model(str(tmp_path / "j"), rank=0, key_fold="mix32")
    return open(tmp_path / "j_0").read()


def _blocks(path):
    info_j, info_t = jc.read_header2(path), tc.read_header2(path)
    views, _ = next(jc.iter_packed2(path))
    jblock = {k: jnp.asarray(v) for k, v in views.items()}
    tblock = tc.block_tensors(views)
    return info_j, info_t, jblock, tblock, views


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


@pytest.mark.parametrize("spill", [False, True])
def test_tile_eval_step_matches_jax(tmp_path, spill):
    path = make_file(tmp_path / "t.crec2", seed=3 + spill, spill=spill)
    info_j, info_t, jblock, tblock, views = _blocks(path)
    assert (np.count_nonzero(views["ovf_b"] != 0xFFFFFFFF) > 0) == spill
    w = model_weights(seed=4)
    jout = [np.asarray(x) for x in jax_store(w).tile_eval_step(jblock,
                                                               info_j)]
    st = torch_store()
    st.slots = st.handle.warm_start(torch.from_numpy(w))
    tout = [x.numpy() for x in st.tile_eval_step(tblock, info_t)]
    objv_j, num_j, acc_j, pos_j, neg_j, mg_j = jout
    objv_t, num_t, acc_t, pos_t, neg_t, mg_t = tout
    assert _rel(objv_t, objv_j) <= 1e-5
    assert float(num_t) == float(num_j) == 300
    assert _rel(acc_t, acc_j) <= 1e-5
    np.testing.assert_allclose(mg_t, mg_j, rtol=1e-5, atol=1e-6)
    assert pos_t.sum() == pos_j.sum() and neg_t.sum() == neg_j.sum()
    # the serve surface rides the same step
    m = tile_margins(st, st.serve_params(), tblock, info_t)
    assert torch.equal(m, torch.from_numpy(mg_t))


def test_margin_hist_is_exactly_equal():
    """Same margins (bin edges, the clip range and beyond included) give
    the same pos/neg counts in both packages."""
    rng = np.random.default_rng(5)
    edges = -14.0 + 28.0 * np.arange(512) / 511
    margin = np.concatenate([rng.standard_normal(4000) * 5,
                             edges, np.nextafter(edges, 0), [-30, 30, 14, -14]
                             ]).astype(np.float32)
    labels = (rng.random(margin.size) < 0.4).astype(np.float32)
    mask = (rng.random(margin.size) < 0.9).astype(np.float32)
    pj, nj = jm.margin_hist(jnp.asarray(labels), jnp.asarray(margin),
                            jnp.asarray(mask))
    pt, nt = tm.margin_hist(torch.from_numpy(labels),
                            torch.from_numpy(margin), torch.from_numpy(mask))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert tm.auc_from_hist(pt, nt) == jm.auc_from_hist(pj, nj)


@pytest.mark.parametrize("name", ["logit", "hinge", "square_hinge",
                                  "square"])
def test_losses_and_accuracy_match_jax(name):
    rng = np.random.default_rng(6)
    margin = (rng.standard_normal(1000) * 3).astype(np.float32)
    labels = (rng.random(1000) < 0.4).astype(np.float32)
    mask = (rng.random(1000) < 0.9).astype(np.float32)
    jo, jd = jloss.create_loss(name)
    to, td = tloss.create_loss(name)
    J = [jnp.asarray(x) for x in (margin, labels, mask)]
    T = [torch.from_numpy(x) for x in (margin, labels, mask)]
    assert _rel(to(*T), np.asarray(jo(*J))) <= 1e-5
    np.testing.assert_allclose(td(*T).numpy(), np.asarray(jd(*J)),
                               rtol=1e-5, atol=1e-7)
    assert float(tm.accuracy(T[1], T[0], T[2])) == \
        float(jm.accuracy(J[1], J[0], J[2]))
    assert tm.auc_np(labels, margin, mask) == jm.auc_np(labels, margin, mask)
    with pytest.raises(ValueError):
        tloss.create_loss("nope")


def _jax_app(cfg):
    from wormhole_tpu.learners.async_sgd import AsyncSGD as JApp
    from wormhole_tpu.parallel.mesh import MeshRuntime, make_mesh
    rt = MeshRuntime.create()
    rt.mesh = make_mesh("data:1", jax.devices()[:1])
    return JApp(cfg, rt)


def _cfg(**kw):
    from wormhole_tpu.utils.config import Config as JConfig
    base = dict(data_format="crec2", num_buckets=NB, max_data_pass=0,
                lambda_=list(LAM), disp_itv=1e12)
    base.update(kw)
    return JConfig(**base), Config(**base)


def test_main_predict_matches_jax_predict(tmp_path):
    """Port ``main`` (device=cpu) vs JAX ``AsyncSGD.predict`` on the same
    crec2 file (with spill) and the same save_model model."""
    path = make_file(tmp_path / "t.crec2", seed=7)
    jax_store(model_weights(seed=8)).save_model(str(tmp_path / "m"), 0,
                                                key_fold="mix32")
    jcfg, _ = _cfg(model_in=str(tmp_path / "m"))
    app = _jax_app(jcfg)
    app._store_io("load", str(tmp_path / "m"))
    app.predict(path, str(tmp_path / "pj.txt"))
    assert main(["data_format=crec2", f"num_buckets={NB}",
                 f"lambda={LAM[0]} {LAM[1]}",
                 f"model_in={tmp_path / 'm'}", f"test_data={path}",
                 f"pred_out={tmp_path / 'pt.txt'}", "max_data_pass=0",
                 "device=cpu"]) == 0
    pj = np.loadtxt(tmp_path / "pj.txt")
    pt = np.loadtxt(tmp_path / "pt.txt")
    assert pj.shape == pt.shape == (300,)
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-7)


def test_run_eval_matches_jax(tmp_path):
    path = make_file(tmp_path / "t.crec2", seed=9)
    w = model_weights(seed=10)
    jcfg, tcfg = _cfg()
    japp = _jax_app(jcfg)
    japp.store.slots = japp.store.handle.warm_start(jnp.asarray(w))
    jp_, jauc = japp._run_eval(path)
    tapp = AsyncSGD(tcfg, device="cpu")
    tapp.store.from_jax_slots(np.asarray(japp.store.slots))
    tp_, tauc = tapp._run_eval(path)
    assert tp_.num_ex == jp_.num_ex == 300 and tp_.count == jp_.count == 1
    assert _rel(tp_.objv, jp_.objv) <= 1e-5
    assert _rel(tp_.acc, jp_.acc) <= 1e-5
    assert _rel(tp_.auc, jp_.auc) <= 1e-5
    assert _rel(tauc, jauc) <= 1e-5


def test_training_and_other_formats_raise(tmp_path):
    """What the port does not run yet raises NotImplementedError naming
    ROADMAP.md, before any work: other data formats, the other handles,
    the multihost/staleness path, checkpoint resume and device-resident
    replay. A file written for another bucket count is a ValueError."""
    path = make_file(tmp_path / "t.crec2", seed=11, spill=False)
    for kw, what in ((dict(data_format="libsvm"), "crec2"),
                     (dict(staleness_tau=0), "staleness_tau"),
                     (dict(checkpoint_dir=str(tmp_path / "ck")),
                      "checkpoint_dir"),
                     (dict(cache_device=True), "cache_device")):
        _, tcfg = _cfg(train_data=path, max_data_pass=1, **kw)
        app = AsyncSGD(tcfg, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP") as e:
            app.run()
        assert what in str(e.value)
        with pytest.raises(NotImplementedError, match=what):
            app.process(path, 0, 1, "train")
    assert not (tmp_path / "ck").exists()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        th.create_handle("adagrad")
    _, bad = _cfg(num_buckets=4 * TILE)
    with pytest.raises(ValueError, match="num_buckets"):
        AsyncSGD(bad, device="cpu")._run_eval(path)
    _, bad = _cfg(num_buckets=4 * TILE, train_data=path, max_data_pass=1)
    with pytest.raises(ValueError, match="num_buckets"):
        AsyncSGD(bad, device="cpu").run()


def test_bf16_param_table_serves_the_same_kernel_margins(tmp_path):
    """param_dtype=bfloat16 stores the table in bf16; the tile margins
    round w to bf16 anyway, so a spill-free block scores the same."""
    path = make_file(tmp_path / "t.crec2", seed=12, spill=False)
    _, info, _, tblock, _ = _blocks(path)
    w = torch.from_numpy(model_weights(seed=13))
    _, ht = handles()
    f32 = ts.ShardedStore(ts.StoreConfig(num_buckets=NB), ht, device="cpu")
    b16 = ts.ShardedStore(ts.StoreConfig(num_buckets=NB,
                                         param_dtype="bfloat16"), ht,
                          device="cpu")
    f32.slots = ht.warm_start(w)
    b16.slots = ht.warm_start(w).to(torch.bfloat16)
    assert b16.slots.dtype == torch.bfloat16
    assert torch.equal(f32.tile_eval_step(tblock, info)[5],
                       b16.tile_eval_step(tblock, info)[5])
    with pytest.raises(ValueError, match="param_dtype"):
        ts.ShardedStore(ts.StoreConfig(num_buckets=NB, param_dtype="fp8"),
                        ht, device="cpu")


def test_l1l2_prox_matches_jax():
    z = np.random.default_rng(14).standard_normal(1000).astype(np.float32)
    for lam in ((0.0, 0.0), (0.3, 0.1)):
        got = tp.L1L2(*lam).solve(torch.from_numpy(z), 2.5).numpy()
        want = np.asarray(jp.L1L2(*lam).solve(jnp.asarray(z), 2.5))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_workload_pool_matches_files_by_regex_and_splits_parts(tmp_path):
    from wormhole_tpu_torch.sched.workload_pool import TEST, WorkloadPool
    for name in ("a.crec2", "b.crec2", "notes.txt"):
        (tmp_path / name).write_bytes(b"x")
    pool = WorkloadPool()
    assert pool.add(str(tmp_path / r".*\.crec2$"), 2, TEST) == 4
    got = []
    while (wl := pool.get("w")) is not None:
        got.append((os.path.basename(wl.file), wl.part, wl.nparts, wl.kind))
        assert not pool.is_finished()
        pool.finish(wl.id)
    assert got == [("a.crec2", 0, 2, TEST), ("a.crec2", 1, 2, TEST),
                   ("b.crec2", 0, 2, TEST), ("b.crec2", 1, 2, TEST)]
    assert pool.is_finished()
    with pytest.raises(FileNotFoundError):
        pool.add(str(tmp_path / "missing-*.crec2"))
