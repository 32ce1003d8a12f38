"""The port's sparse ``SparseBatch`` path against the JAX package's, on the
CPU: spmv, AUC, the store's sparse steps for every ``algo``, the FM and
wide&deep sparse steps, the pull-only forward, and ``main`` on libsvm,
recordio and criteo files (train + validation + predict + model_out); also
crec2 tile training with ``algo=sgd``/``adagrad``, fused and split.

Tolerances. Every elementwise operation is the JAX one in the same order,
rounded once to f32 (``test_torch_handles.py``), and the sums into the key
axis add each key's entries in the JAX scatter's order; so a gradient from
the same margins is bitwise the JAX one. What differs is the order of the
row sums (the margin: torch's reduction against XLA's dot), an ulp of a
margin, which the dual, the gradient and the update carry on. So:

- ``fixed_bytes=0``: slots within 1e-5·(1 + |x|) after a few steps, metrics
  within 1e-5 relative;
- ``fixed_bytes=1`` quantizes the gradient to 255 levels of max|g|/127. A
  value within an ulp of a rounding boundary can round to the neighbouring
  level on one side: a flip of one quantum q = max|g|/127, which moves that
  key's update by about η·q. The tests count entries off the f32 bound and
  allow a few (``MAX_FLIPS`` per run), each within one quantum's update
  (α·q/β, q ≤ 1/127 for |g| ≤ 1: 1e-3 at α = 0.1);
- metrics are sums over the batch (AUC a fraction of ranked pairs): within
  1e-5 relative at ``fixed_bytes=0``, 1e-3 at 1;
- ``main`` is held as the store steps are; its text outputs carry 6
  significant digits, so a saved weight or a prediction may differ by one
  printed step (1e-6 here) where an ulp crosses a printed rounding
  boundary: predictions within 1e-4 (one quantum's update through the
  sigmoid), 99% of them within 2.5e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wormhole_tpu.data import feed as jfeed
from wormhole_tpu.data import localizer as jloc
from wormhole_tpu.data import minibatch as jmb
from wormhole_tpu.learners import handles as jh
from wormhole_tpu.learners import store as js
from wormhole_tpu.ops import metrics as jmetrics
from wormhole_tpu.ops import penalty as jp
from wormhole_tpu.ops import spmv as jspmv
from wormhole_tpu_torch.data import feed as tfeed
from wormhole_tpu_torch.data import localizer as tloc
from wormhole_tpu_torch.data import recordio as trec
from wormhole_tpu_torch.learners import handles as th
from wormhole_tpu_torch.learners import store as ts
from wormhole_tpu_torch.learners.async_sgd import AsyncSGD, main
from wormhole_tpu_torch.ops import metrics as tmetrics
from wormhole_tpu_torch.ops import penalty as tp
from wormhole_tpu_torch.ops import spmv as tspmv
from wormhole_tpu_torch.serve import ForwardStep
from wormhole_tpu_torch.utils.config import load_config

ALGOS = ["ftrl", "sgd", "adagrad", "dt_sgd", "dt_adagrad", "dt2_adagrad"]
NB = 1 << 13
VOCAB = 3000
LAM = (0.01, 0.001)
MAX_FLIPS = 8
QUANTUM_STEP = 1e-3     # α·q/β with α = 0.1, q ≤ 1/127, β = 1


def write_libsvm(path, rng, truth, n, nfeat=12, vals=False):
    """``n`` rows of up to ``nfeat`` ids from a ``VOCAB``-id vocabulary
    (10% dropped), labels drawn from the linear model ``truth``."""
    lines = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, nfeat)[rng.random(nfeat) >= 0.1]
        v = (rng.random(len(ids)) + 0.5) if vals else np.ones(len(ids))
        y = int(rng.random() < 1 / (1 + np.exp(-(truth[ids] * v).sum())))
        lines.append(f"{y} " + " ".join(
            f"{j}:{x:.4g}" if vals else f"{j}" for j, x in zip(ids, v)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sparse")
    rng = np.random.default_rng(2024)
    truth = rng.standard_normal(VOCAB)
    return {"train": write_libsvm(d / "t.libsvm", rng, truth, 1500,
                                  vals=True),
            "val": write_libsvm(d / "v.libsvm", rng, truth, 400),
            "dir": str(d), "truth": truth}


def assert_close(got, want, fixed_bytes, what=""):
    """The module docstring's bound: all within 1e-5·(1 + |x|) at
    fixed_bytes=0; at 1 up to MAX_FLIPS entries off it, each within one
    quantum's update."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    off = err > 1e-5 * (1 + np.abs(want))
    if not fixed_bytes:
        assert not off.any(), (what, err.max())
    else:
        assert off.sum() <= MAX_FLIPS, (what, off.sum())
        assert err.max() <= QUANTUM_STEP, (what, err.max())


def assert_metrics_close(got, want, fixed_bytes):
    rtol = 1e-3 if fixed_bytes else 1e-5
    got = [float(x) for x in got]
    want = [float(np.asarray(x)) for x in want]
    assert got[1] == want[1]                              # num_ex
    for a, b in zip(got, want):
        assert abs(a - b) <= rtol * max(abs(b), 1.0), (got, want)


def batches(path, mb=250, nnz=16, kpad=0, n_buckets=NB):
    """(JAX, port) SparseBatch pairs of one file, padded alike."""
    out = []
    for blk in jmb.MinibatchIter(path, 0, 1, "libsvm", mb):
        lj = jloc.Localizer(num_buckets=n_buckets).localize(blk)
        lt = tloc.Localizer(num_buckets=n_buckets).localize(blk)
        kp = kpad or jfeed.next_bucket(len(lj.uniq_keys), 64)
        out.append((jfeed.pad_to_batch(lj, mb, nnz, kp),
                    tfeed.pad_to_batch(lt, mb, nnz, kp)))
    return out


def handles(algo):
    return (jh.create_handle(algo, jp.L1L2(*LAM), jh.LearnRate(0.1, 1.0)),
            th.create_handle(algo, tp.L1L2(*LAM), th.LearnRate(0.1, 1.0)))


# -- ops -------------------------------------------------------------------

def test_spmv_matches_jax():
    """``spmv_trans_times`` sums each key's entries in the JAX scatter's
    order (bitwise, and bitwise to a Python fold in flat order);
    ``spmv_times`` within 1e-6 (row-sum order)."""
    rng = np.random.default_rng(1)
    mb, nnz, k = 300, 24, 257
    cols = rng.integers(0, k, (mb, nnz)).astype(np.int32)
    cols[:, :3] = 5                                  # a hot key
    vals = rng.standard_normal((mb, nnz)).astype(np.float32)
    vals[rng.random((mb, nnz)) < 0.3] = 0.0          # padding
    cols[vals == 0] = 0
    dual = rng.standard_normal(mb).astype(np.float32)
    w = rng.standard_normal(k).astype(np.float32)
    ct, vt, dt = map(torch.from_numpy, (cols, vals, dual))
    got = tspmv.spmv_trans_times(ct, vt, dt, k).numpy()
    want = np.asarray(jspmv.spmv_trans_times(cols, vals, dual, k))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    fold = np.zeros(k, np.float32)
    for c, x in zip(cols.reshape(-1), (vals * dual[:, None]).reshape(-1)):
        fold[c] = np.float32(fold[c] + x)
    assert np.array_equal(got, fold)
    m = tspmv.spmv_times(ct, vt, torch.from_numpy(w)).numpy()
    assert np.allclose(m, np.asarray(jspmv.spmv_times(cols, vals, w)),
                       rtol=1e-6, atol=1e-6)
    assert np.array_equal(tspmv.row_nnz(vt).numpy(),
                          np.asarray(jspmv.row_nnz(vals)))


def test_auc_matches_jax():
    """The per-minibatch AUC: ties broken by row order (stable), masked
    rows at -inf, fractional weights, and 0.5 for an empty class."""
    rng = np.random.default_rng(3)
    n = 500
    labels = (rng.random(n) < 0.4).astype(np.float32)
    margin = np.round(rng.standard_normal(n), 1).astype(np.float32)  # ties
    mask = (rng.random(n) < 0.9).astype(np.float32)
    mask[:50] *= 0.5
    for lab, msk in ((labels, mask), (labels, np.ones(n, np.float32)),
                     (np.zeros(n, np.float32), mask)):
        got = float(tmetrics.auc(*map(torch.from_numpy, (lab, margin, msk))))
        want = float(jmetrics.auc(lab, margin, msk))
        assert abs(got - want) <= 1e-6, (got, want)


# -- the store's sparse steps ----------------------------------------------

@pytest.mark.parametrize("fixed_bytes", [0, 1])
@pytest.mark.parametrize("algo", ALGOS)
def test_store_steps_match_jax(files, algo, fixed_bytes):
    """Six train steps (tau cycling 0..2; for dt2_adagrad each batch's push
    two pulls after its pull) from the same random start slots, loaded
    through ``from_jax_slots`` (val_len 1 to 4), then an eval step: the
    metrics of every step, the slots and the eval margins."""
    hj, ht = handles(algo)
    rng = np.random.default_rng(ALGOS.index(algo))
    s0 = (rng.standard_normal((NB, hj.val_len)) * 0.1).astype(np.float32)
    s0[:, 1:] = np.abs(s0[:, 1:])
    if algo == "dt2_adagrad":
        s0[:, 3] = s0[:, 2] + s0[:, 3]
    jst = js.ShardedStore(js.StoreConfig(num_buckets=NB,
                                         fixed_bytes=fixed_bytes), hj)
    jst.slots = jnp.asarray(s0)
    tst = ts.ShardedStore(ts.StoreConfig(num_buckets=NB,
                                         fixed_bytes=fixed_bytes), ht,
                          device="cpu")
    tst.from_jax_slots(s0)
    pairs = batches(files["train"])
    assert len(pairs) == 6
    if algo == "dt2_adagrad":
        pending = []
        for jb, tb in pairs + [(None, None)] * 2:
            if jb is not None:
                gj, sj, mj = jst.dt2_pull(jb)
                gt, st_, mt = tst.dt2_pull(tb)
                assert_metrics_close(mt, mj, 0)
                pending.append(((jb, gj, sj), (tb, gt, st_)))
            if len(pending) > 2 or jb is None and pending:
                (jb_, gj, sj), (tb_, gt, st_) = pending.pop(0)
                jst.dt2_push(jb_, gj, sj)
                tst.dt2_push(tb_, gt, st_)
    else:
        for i, (jb, tb) in enumerate(pairs):
            mj = jst.train_step(jb, tau=float(i % 3))
            mt = tst.train_step(tb, tau=float(i % 3))
            assert_metrics_close(mt, mj, fixed_bytes)
    assert tst.t == jst.t == 7
    assert_close(tst.to_jax_slots(), np.asarray(jst.slots), fixed_bytes,
                 "slots")
    vj, vt = batches(files["val"])[0]
    ej, et = jst.eval_step(vj), tst.eval_step(vt)
    assert_metrics_close(et[:4], ej[:4], fixed_bytes)
    assert_close(et[4].numpy(), np.asarray(ej[4]), fixed_bytes, "margin")
    keys = np.arange(0, NB, 97)
    assert_close(tst.pull(keys), jst.pull(keys), fixed_bytes, "pull")


def test_padding_keys_are_never_written(files):
    """The push writes the real keys only: bucket 0, a pad slot of every
    batch, keeps its value unless a batch holds it as a real key."""
    _, ht = handles("adagrad")
    tst = ts.ShardedStore(ts.StoreConfig(num_buckets=NB), ht, device="cpu")
    tst.slots[:, 0] = 7.0
    for _, tb in batches(files["train"]):
        assert tb.num_keys < tb.uniq_keys.shape[0]
        real0 = bool((tb.uniq_keys[:tb.num_keys] == 0).any())
        before = tst.slots[:, 0].clone()
        tst.train_step(tb)
        if not real0:
            assert torch.equal(tst.slots[:, 0], before)


# -- FM and wide&deep sparse steps -------------------------------------------

def model_stores(model):
    from wormhole_tpu.models import fm as jfm, wide_deep as jwd
    from wormhole_tpu_torch.models import fm as tfm, wide_deep as twd
    if model == "fm":
        kw = dict(num_buckets=NB, dim=4, l1=0.01, l2=0.001)
        return (jfm.FMStore(jfm.FMConfig(**kw)),
                tfm.FMStore(tfm.FMConfig(**kw), device="cpu"))
    kw = dict(num_buckets=NB, dim=4, hidden=(8, 4))
    return (jwd.WideDeepStore(jwd.WideDeepConfig(**kw)),
            twd.WideDeepStore(twd.WideDeepConfig(**kw), device="cpu"))


@pytest.mark.parametrize("model", ["fm", "wide_deep"])
def test_model_sparse_steps_match_jax(files, model):
    """Six FM / wide&deep sparse train steps from the same fresh store (the
    same seeded draw, bitwise), then an eval step and the serving forward:
    metrics, the table, the MLP and its accumulators within the f32 bound
    (their hand-written backward sums each key's entries in flat order, as
    the JAX grad's scatter does), and the forward's margins bitwise equal
    to the eval step's."""
    jst, tst = model_stores(model)
    assert np.array_equal(tst.to_jax_slots(), np.asarray(jst.slots))
    for jb, tb in batches(files["train"]):
        assert_metrics_close(tst.train_step(tb), jst.train_step(jb), 0)
    assert tst.t == jst.t == 7
    assert_close(tst.to_jax_slots(), np.asarray(jst.slots), 0, "slots")
    if model == "wide_deep":
        mlp, accum = tst.to_jax_mlp()
        for n in mlp:
            assert_close(mlp[n], np.asarray(jst.mlp[n]), 0, n)
            assert_close(accum[n], np.asarray(jst.mlp_accum[n]), 0, n)
    vj, vt = batches(files["val"])[0]
    ej, et = jst.eval_step(vj), tst.eval_step(vt)
    assert_metrics_close(et[:4], ej[:4], 0)
    assert_close(et[4].numpy(), np.asarray(ej[4]), 0, "margin")
    fwd = ForwardStep.from_store(tst)
    margin, pred = fwd(vt)
    assert torch.equal(margin, et[4])
    assert torch.equal(pred, torch.sigmoid(et[4]))


def test_forward_step_swap_checks_the_model():
    """``swap`` takes a model of the served structure and shapes and
    refuses another; the forward then serves the new params."""
    _, ht = handles("adagrad")
    st = ts.ShardedStore(ts.StoreConfig(num_buckets=NB), ht, device="cpu")
    fwd = ForwardStep.from_store(st)
    assert fwd.loss == "logit"
    fwd.swap({"slots": torch.ones_like(st.slots)})
    with pytest.raises(ValueError, match="swap mismatch"):
        fwd.swap({"slots": torch.ones(3, NB)})
    with pytest.raises(ValueError, match="swap mismatch"):
        fwd.swap({"w": st.slots})


# -- main against the JAX app -------------------------------------------------

def _jax_app(tokens, store=None):
    from wormhole_tpu.learners.async_sgd import AsyncSGD as JApp
    from wormhole_tpu.parallel.mesh import MeshRuntime, make_mesh
    from wormhole_tpu.utils.config import load_config as jload
    rt = MeshRuntime.create()
    rt.mesh = make_mesh("data:1", jax.devices()[:1])
    return JApp(jload(None, tokens), rt, store=store)


def compare_runs(tokens, out, jstore=None, tstore_fn=None, model=False):
    """The JAX app's ``run`` and the port's ``main`` (device=cpu) on the
    same tokens: predictions and the saved model; the port's
    ``AsyncSGD.run`` on them too: Progress and the validation pass."""
    jtok = tokens + [f"pred_out={out}/pj", f"model_out={out}/mj"]
    japp = _jax_app(jtok, jstore)
    jprog = japp.run()
    ttok = tokens + [f"pred_out={out}/pt", f"model_out={out}/mt"]
    if model:
        tstore_fn(ttok + ["device=cpu"])
    else:
        assert main(ttok + ["device=cpu"]) == 0
        cfg = load_config(None, [t for t in tokens
                                 if not t.startswith("test_data=")])
        tapp = AsyncSGD(cfg, device="cpu")
        tprog = tapp.run()
        assert tprog.num_ex == jprog.num_ex and tprog.count == jprog.count
        for a, b in ((tprog.objv, jprog.objv), (tprog.auc, jprog.auc),
                     (tprog.acc, jprog.acc), (tprog.wdelta2,
                                              jprog.wdelta2)):
            assert abs(a - b) <= 1e-3 * abs(b), (a, b)
        rec = tapp.pass_log[-1]
        jv, jauc = japp._run_eval(cfg.val_data)
        assert rec["val_num_ex"] == jv.num_ex
        assert abs(rec["val_objv"] - jv.objv / jv.num_ex) <= 1e-3 * abs(
            rec["val_objv"])
        assert abs(rec["val_auc"] - jauc) <= 1e-3
    pj, pt = np.loadtxt(f"{out}/pj"), np.loadtxt(f"{out}/pt")
    assert pj.shape == pt.shape and len(pt) > 0
    err = np.abs(pt - pj)
    assert err.max() <= 1e-4 and np.mean(err <= 2.5e-6) >= 0.99, err.max()
    return out


def load_text_model(path):
    w = np.zeros(NB)
    with open(path) as f:
        head = f.readline()
    kv = np.loadtxt(path, comments="#", ndmin=2)
    w[kv[:, 0].astype(int)] = kv[:, 1]
    return head, w


@pytest.mark.parametrize("algo", ALGOS)
def test_main_matches_the_jax_app(files, tmp_path, algo):
    """Two passes of each ``algo`` on libsvm at the default fixed_bytes=1
    and pipeline_workers=2 (max_delay=4 for dt2_adagrad), with validation,
    predict (the serving forward) and model_out, against the JAX app."""
    tokens = [f"train_data={files['train']}", f"val_data={files['val']}",
              f"test_data={files['val']}", f"num_buckets={NB}",
              "max_data_pass=2", f"algo={algo}", "minibatch=250",
              f"lambda={LAM[0]} {LAM[1]}", "disp_itv=1e12"]
    if algo == "dt2_adagrad":
        tokens.append("max_delay=4")
    out = compare_runs(tokens, str(tmp_path))
    hj, wj = load_text_model(f"{out}/mj_0")
    ht, wt = load_text_model(f"{out}/mt_0")
    assert ht == hj == "# key_fold=splitmix64\n"
    assert_close(wt, wj, 1, "model")      # the default fixed_bytes=1


@pytest.mark.parametrize("model", ["fm", "wide_deep"])
def test_model_main_matches_the_jax_app(files, tmp_path, model):
    """FM (dim 4) and wide&deep (dim 4, hidden 8,4) through each model's
    ``main`` on libsvm: predictions and the saved npz model."""
    from wormhole_tpu_torch.models import fm as tfm, wide_deep as twd
    tokens = [f"train_data={files['train']}", f"val_data={files['val']}",
              f"test_data={files['val']}", f"num_buckets={NB}",
              "max_data_pass=2", "minibatch=250", "disp_itv=1e12"]
    jstore, _ = model_stores(model)
    extra = ["dim=4"] + (["l1=0.01", "l2=0.001"] if model == "fm"
                         else ["hidden=8,4"])
    tmain = tfm.main if model == "fm" else twd.main
    out = compare_runs(tokens, str(tmp_path), jstore=jstore,
                       tstore_fn=lambda t: tmain(t + extra), model=True)
    mj, mt = np.load(f"{out}/mj_0.npz"), np.load(f"{out}/mt_0.npz")
    assert sorted(mj.files) == sorted(mt.files)
    for n in mj.files:
        assert_close(mt[n], mj[n], 0, n)


def test_recordio_and_criteo_main_match_the_jax_app(files, tmp_path):
    """``data_format=recordio`` (the libsvm rows written as records) and
    ``criteo`` with ``text_dense=false`` train like the JAX app."""
    from test_torch_textdata import criteo_text
    rec = str(tmp_path / "t.rec")
    with open(rec, "wb") as f:
        w = trec.RecordWriter(f)
        for blk in jmb.MinibatchIter(files["train"], 0, 1, "libsvm", 500):
            for i in range(blk.size):
                lo, hi = blk.offset[i], blk.offset[i + 1]
                w.write_row(float(blk.label[i]), blk.index[lo:hi],
                            blk.value[lo:hi])
    crit = tmp_path / "t.criteo"
    crit.write_bytes(criteo_text(np.random.default_rng(6), 700))
    for fmt, path in (("recordio", rec), ("criteo", str(crit))):
        out = tmp_path / fmt
        out.mkdir()
        compare_runs([f"train_data={path}", f"val_data={path}",
                      f"test_data={path}", f"data_format={fmt}",
                      "text_dense=false", f"num_buckets={NB}",
                      "max_data_pass=1", "minibatch=250", "disp_itv=1e12",
                      "fixed_bytes=0"], str(out))


def test_pipeline_workers_do_not_change_the_result(files):
    """The DeviceFeed (2 workers, ring of 2) and the serial path train to
    the same bits."""
    slots = []
    for workers in (0, 2):
        app = AsyncSGD(load_config(None, [
            f"train_data={files['train']}", f"num_buckets={NB}",
            "max_data_pass=1", "algo=adagrad", "minibatch=100",
            f"pipeline_workers={workers}", "disp_itv=1e12"]), device="cpu")
        app.run()
        slots.append(app.store.slots)
        if workers:
            assert app.feed_stats["feed_batches"] == 15
    assert torch.equal(*slots)


def test_unported_paths_raise_naming_the_roadmap(files, tmp_path):
    """crec v1, criteo/adfea with text_dense=true, tile_online=on and the
    multihost/checkpoint/cache knobs raise NotImplementedError naming
    ROADMAP.md; a remote URI raises in the stream layer."""
    base = [f"train_data={files['train']}", f"num_buckets={NB}",
            "max_data_pass=1"]
    for extra in (["data_format=crec"], ["data_format=criteo"],
                  ["data_format=adfea", "text_dense=true"],
                  ["tile_online=on"], ["staleness_tau=1"],
                  ["checkpoint_dir=" + str(tmp_path)],
                  ["cache_device=true"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            AsyncSGD(load_config(None, base + extra), device="cpu").run()
    with pytest.raises(ValueError, match="not ported"):
        AsyncSGD(load_config(None, [
            "train_data=s3://bucket/t.libsvm", f"num_buckets={NB}",
            "max_data_pass=1"]), device="cpu").run()


# -- crec2 tiles with the other handles -------------------------------------

@pytest.mark.parametrize("algo", ["sgd", "adagrad"])
def test_crec2_tile_training_with_other_algos(tmp_path, algo):
    """``algo=sgd``/``adagrad`` on crec2 train through the tile steps:
    fused (``fused_step_grad`` + the masked push) and split (forward,
    dual, backward, push) give the same bits, both match the JAX split
    path's slots within 1e-5·(1 + |x|) on a spill file (test_torch_train_app
    states the bf16-flip bound, never reached here), and ``main`` trains
    and predicts."""
    from test_torch_train_app import ROWS, make_file, NB as TNB
    from wormhole_tpu.data import crec as jc
    from wormhole_tpu_torch.data import crec as tc
    path = make_file(tmp_path / "t.crec2", 65, True)
    hj = jh.create_handle(algo, jp.L1L2(*LAM), jh.LearnRate(0.1, 1.0))
    ht = th.create_handle(algo, tp.L1L2(*LAM), th.LearnRate(0.1, 1.0))
    jst = js.ShardedStore(js.StoreConfig(num_buckets=TNB,
                                         tile_step_kernel="split"), hj)
    info = jc.read_header2(path)
    for views, _ in jc.iter_packed2(path):
        jst.tile_train_step({k: jnp.asarray(v) for k, v in views.items()},
                            info, tau=1.0)
    want = np.asarray(jst.slots)
    got = {}
    for kernel in ("fused", "split"):
        tst = ts.ShardedStore(ts.StoreConfig(num_buckets=TNB,
                                             tile_step_kernel=kernel), ht,
                              device="cpu")
        info_t = tc.read_header2(path)
        for views, _ in tc.iter_packed2(path):
            tst.tile_train_step(tc.block_tensors(views), info_t, tau=1.0)
        assert tst.step_kernel[0] == kernel
        got[kernel] = tst.to_jax_slots()
        err = np.abs(got[kernel].astype(np.float64) - want)
        assert np.all(err <= 1e-5 * (1 + np.abs(want))), err.max()
    assert np.array_equal(got["fused"], got["split"])
    assert main(["data_format=crec2", f"num_buckets={TNB}",
                 f"train_data={path}", f"val_data={path}",
                 f"test_data={path}", f"pred_out={tmp_path / 'p'}",
                 f"algo={algo}", "max_data_pass=1", "disp_itv=1e12",
                 "device=cpu"]) == 0
    p = np.loadtxt(tmp_path / "p")
    assert p.shape == (ROWS,) and np.all((p > 0) & (p < 1))
