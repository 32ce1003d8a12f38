"""The port's CUDA kernels against their plain torch versions.

This file imports nothing of JAX, so it also runs on the GPU host, which has
no JAX; ``tests/conftest.py`` imports JAX, so run it there as

    python -m pytest --noconftest tests/test_torch_kernels.py

Tests marked ``cuda`` skip on a host without a CUDA device. The forward
and backward kernels and their plain versions all sum each row or bucket
from 0 in word order, so the margins and the gradient (alone and inside the
fused steps) are held to bitwise equality, and so are ``forward_pulls`` and
``backward_pushes`` at one channel, a second word-order forward and
backward. The FTRL slots after a fused step equal the push kernel's on the
plain gradient bitwise, and the plain version's within 1e-5·(1 + |x|): the
plain update's torch arithmetic and the kernel's may round apart (the CPU
tests derive the full per-slot bound). The multi-channel pulls and pushes
and their plain versions all sum each (row or bucket, channel) in word
order, so they are held to bitwise equality, and so are the row and bucket
indexes they build.
"""

import os

import numpy as np
import pytest
import torch

from wormhole_tpu_torch.data.crec import CRec2Writer
from wormhole_tpu_torch.learners.async_sgd import AsyncSGD, main
from wormhole_tpu_torch.learners.handles import FTRLHandle, LearnRate
from wormhole_tpu_torch.ops import _ext
from wormhole_tpu_torch.ops import tilemm as tt
from wormhole_tpu_torch.ops.penalty import L1L2
from wormhole_tpu_torch.utils.config import Config

SPEC = tt.TileSpec(nb=2 * tt.TILE, subblocks=2, cap=1280, group=2,
                   tiles_step=2)


def operands(seed, skew):
    rng = np.random.default_rng(seed)
    buckets = rng.integers(0, SPEC.nb, size=4000).astype(np.int64)
    rows = rng.integers(0, SPEC.block_rows, size=4000).astype(np.int64)
    if skew:   # a hot bucket past cap spills to the COO list
        buckets = np.concatenate([buckets,
                                  np.full(1400, 7 * tt.TILE // 4, np.int64)])
        rows = np.concatenate([rows, rng.integers(0, tt.RSUB, 1400)])
    pw, ob, orow, n_ovf = tt.encode_block_capped(buckets, rows, SPEC, 1536)
    w = (rng.standard_normal(SPEC.nb) * 0.1).astype(np.float32)
    return buckets, rows, pw, ob, orow, n_ovf, w


def as_i32(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def test_kernel_sources_and_build_paths():
    """One library per source, named after a hash of its source and
    flags; nothing is built when the module is imported."""
    assert _ext.sources() == ["tile_bwd", "tile_fm_step", "tile_fwd",
                              "tile_multi", "tile_step", "tile_wd_step"]
    for name in _ext.sources():
        p = _ext._lib_path(name)
        assert p.parent == _ext.BUILD_DIR and p.name.startswith(name + "-")
        assert p == _ext._lib_path(name)
    assert "-gencode=arch=compute_90a,code=sm_90a" in _ext.NVCC_FLAGS
    assert "--fmad=false" in _ext.NVCC_FLAGS


def test_missing_nvcc_raises(monkeypatch):
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("this host has the CUDA toolkit at /usr/local/cuda")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _ext.nvcc_path()


def test_plain_path_is_taken_only_for_cpu_tensors():
    """On CPU tensors the wrapper runs the plain version and counts no
    kernel launch."""
    _, _, pw, _, _, _, w = operands(1, False)
    before = tt.forward_margins.launches
    got = tt.forward_margins(as_i32(pw), torch.from_numpy(w), SPEC)
    want = tt.forward_margins_plain(as_i32(pw), torch.from_numpy(w), SPEC)
    assert torch.equal(got, want)
    assert tt.forward_margins.launches == before


LAUNCHED = (tt.forward_margins, tt.backward_grad, tt.fused_step_grad,
            tt.fused_step_update, tt.loss_dual, tt.ftrl_push)
HANDLE = FTRLHandle(penalty=L1L2(0.05, 0.01), lr=LearnRate(0.1, 1.0))


def launch_counts():
    return [f.launches for f in LAUNCHED]


def step_operands(seed, device="cpu", skew=False):
    buckets, rows, pw, ob, orow, _, w = operands(seed, skew)
    rng = np.random.default_rng(seed + 100)
    labels = (rng.random(SPEC.block_rows) < 0.4).astype(np.float32)
    mask = np.ones(SPEC.block_rows, np.float32)
    mask[-50:] = 0
    slots = (rng.standard_normal((3, SPEC.nb)) * 0.1).astype(np.float32)
    slots[2] = np.abs(slots[2])
    t = lambda a: torch.from_numpy(a).to(device)
    return dict(buckets=buckets, rows=rows, pw=as_i32(pw, device),
                ob=as_i32(ob, device), orow=as_i32(orow, device), w=t(w),
                labels=t(labels), mask=t(mask), slots=t(slots))


def test_training_wrappers_take_the_plain_path_only_on_cpu():
    """On CPU tensors every training wrapper runs its plain version and
    counts no launch; the fused steps equal their plain compositions."""
    o = step_operands(3)
    before = launch_counts()
    mg, g = tt.fused_step_grad(o["pw"], o["w"], o["labels"], o["mask"], SPEC,
                               "logit", True)
    pm, pg = tt.fused_step_grad_plain(o["pw"], o["w"], o["labels"],
                                      o["mask"], SPEC, "logit", True)
    assert torch.equal(mg, pm) and torch.equal(g, pg)
    assert torch.equal(tt.backward_grad(o["pw"], o["labels"], SPEC),
                       tt.backward_grad_plain(o["pw"], o["labels"], SPEC))
    a, b = o["slots"].clone(), o["slots"].clone()
    ma, wa = tt.fused_step_update(o["pw"], a, o["labels"], o["mask"], SPEC,
                                  "logit", HANDLE)
    mb, wb = tt.fused_step_update_plain(o["pw"], b, o["labels"], o["mask"],
                                        SPEC, "logit", HANDLE)
    assert torch.equal(ma, mb) and torch.equal(a, b) and torch.equal(wa, wb)
    assert launch_counts() == before


# -- on the GPU host --------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the GPU host)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [False, True])
def test_kernel_matches_plain_and_is_bitwise_reproducible(cuda, skew):
    buckets, rows, pw, ob, orow, n_ovf, w = operands(30 + skew, skew)
    assert (n_ovf > 0) == skew
    pwd, wd = as_i32(pw, cuda), torch.from_numpy(w).to(cuda)
    spill = (as_i32(ob, cuda), as_i32(orow, cuda)) if skew else (None, None)
    before = tt.forward_margins.launches
    a = tt.forward_margins(pwd, wd, SPEC, *spill)
    b = tt.forward_margins(pwd, wd, SPEC, *spill)
    torch.cuda.synchronize()
    assert tt.forward_margins.launches == before + 2
    assert torch.equal(a, b)
    plain = tt.forward_margins_plain(pwd, wd, SPEC)
    if skew:
        plain = plain + tt.spill_margin_rows(wd, *spill, SPEC)
    # both sum each row from 0 in word order: equal bit for bit
    assert torch.equal(a, plain)


def shuffled_block(device):
    """SPEC operands whose segments are shuffled within (pad words
    included), so no segment is in row order."""
    o = step_operands(77, device)
    T, SG, _ = SPEC.pairs_shape
    seg = o["pw"].cpu().numpy().reshape(T, SG, SPEC.group, SPEC.cap)
    rng = np.random.default_rng(78)
    for t, g, j in np.ndindex(seg.shape[:3]):
        seg[t, g, j] = rng.permutation(seg[t, g, j])
    pw = as_i32(seg.reshape(SPEC.pairs_shape), device)
    assert not torch.equal(pw, o["pw"])
    return pw, SPEC


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spec", "wide", "many_tiles", "shuffled"])
def test_tile_fwd_equals_forward_pulls_at_one_channel(cuda, case):
    """Two independent word-order forwards agree bit for bit: tile_fwd (row
    spans) and forward_pulls at ch 1 (row index + segmented sum), on SPEC,
    on WIDE (22,528-word segments), on MANY (256 tiles a subblock) and on
    a block whose segments are shuffled within; both equal the plain
    version."""
    if case == "shuffled":
        pw, spec = shuffled_block(cuda)
    else:
        pw, spec = index_block({"spec": "uniform", "wide": "wide",
                                "many_tiles": "many_tiles"}[case], cuda)
    w = torch.from_numpy((np.random.default_rng(79).standard_normal(spec.nb)
                          * 0.3).astype(np.float32)).to(cuda)
    before = tt.forward_margins.launches
    m = tt.forward_margins(pw, w, spec)
    torch.cuda.synchronize()
    assert tt.forward_margins.launches == before + 1
    assert torch.equal(m, tt.forward_pulls(pw, w.view(spec.nb, 1),
                                           spec)[:, 0])
    assert torch.equal(m, tt.forward_margins_plain(pw, w, spec))


@pytest.mark.cuda
def test_kernel_rejects_bad_cuda_operands(cuda):
    pw = torch.full(SPEC.pairs_shape, int(tt.PADWORD), dtype=torch.int32,
                    device=cuda)
    before = tt.forward_margins.launches
    with pytest.raises(ValueError):
        tt.forward_margins(pw, torch.zeros(SPEC.nb, 2, device=cuda)[:, 0],
                           SPEC)
    with pytest.raises(ValueError):
        tt.forward_margins(pw, torch.zeros(SPEC.nb), SPEC)   # w on the CPU
    assert tt.forward_margins.launches == before
    assert torch.all(tt.forward_margins(pw, torch.ones(SPEC.nb, device=cuda),
                                        SPEC) == 0)
    # the C entry refuses a missing or too small scratch and a 0-row span
    lib = tt._lib("tile_fwd", "wh_tile_fwd", [tt._P] * 3 + [tt._L, tt._P]
                  + [tt._I] * 5 + [tt._P])
    scratch, rows = tt._span_scratch(SPEC, cuda)
    out = torch.empty(SPEC.block_rows, device=cuda)
    T, SG, _ = SPEC.pairs_shape
    n = scratch.numel()
    for ptr, words, r in ((None, n, rows), (scratch.data_ptr(), n, 0),
                          (scratch.data_ptr(), T * SG * SPEC.n, rows)):
        err = lib.wh_tile_fwd(pw.data_ptr(), out.data_ptr(), ptr, words,
                              out.data_ptr(), T, SG, SPEC.group, SPEC.cap, r,
                              tt._stream(pw))
        with pytest.raises(RuntimeError):
            _ext.check(lib, err, "tile_fwd")


@pytest.mark.cuda
def test_predict_and_eval_on_cuda_match_cpu(cuda, tmp_path):
    """The app on the GPU (one kernel launch per block) gives the CPU
    run's predictions and metrics."""
    rng = np.random.default_rng(2)
    n = 3 * 8192 + 500
    keys = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint32)
    keys[rng.random(keys.shape) < 0.1] = 0xFFFFFFFF
    path = str(tmp_path / "t.crec2")
    with CRec2Writer(path, nnz=8, nb=SPEC.nb, subblocks=1, cap=33408,
                     ovf_cap=64) as wr:
        wr.append(keys, (rng.random(n) < 0.4).astype(np.uint8))
    app = AsyncSGD(Config(data_format="crec2", num_buckets=SPEC.nb),
                   device="cpu")
    app.store.slots = app.store.handle.warm_start(
        torch.from_numpy((rng.standard_normal(SPEC.nb) * 0.3)
                         .astype(np.float32)))
    app.store.save_model(str(tmp_path / "m"), key_fold="mix32")
    app.store.load_model(str(tmp_path / "m"))   # the %.6g weights main sees
    outs = {}
    for dev in ("cpu", "cuda"):
        before = tt.forward_margins.launches
        assert main(["data_format=crec2", f"num_buckets={SPEC.nb}",
                     f"model_in={tmp_path / 'm'}", f"test_data={path}",
                     f"pred_out={tmp_path / dev}.txt", "max_data_pass=0",
                     f"device={dev}"]) == 0
        outs[dev] = (np.loadtxt(f"{tmp_path / dev}.txt"),
                     tt.forward_margins.launches - before)
    assert outs["cpu"][1] == 0 and outs["cuda"][1] == 4
    np.testing.assert_allclose(outs["cuda"][0], outs["cpu"][0], rtol=1e-5,
                               atol=1e-6)
    gpu = AsyncSGD(Config(data_format="crec2", num_buckets=SPEC.nb,
                          model_in=str(tmp_path / "m"), max_data_pass=0),
                   device=cuda)
    gpu.run()
    (pc, ac), (pg, ag) = app._run_eval(path), gpu._run_eval(path)
    assert pg.num_ex == pc.num_ex == n
    assert abs(pg.objv - pc.objv) <= 1e-5 * abs(pc.objv)
    assert abs(ag - ac) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [False, True])
def test_tile_bwd_matches_plain_and_is_bitwise_reproducible(cuda, skew):
    o = step_operands(40 + skew, cuda, skew)
    dual = (np.random.default_rng(41).standard_normal(SPEC.block_rows)
            * 0.5).astype(np.float32)
    d = torch.from_numpy(dual).to(cuda)
    before = tt.backward_grad.launches
    a = tt.backward_grad(o["pw"], d, SPEC)
    b = tt.backward_grad(o["pw"], d, SPEC)
    torch.cuda.synchronize()
    assert tt.backward_grad.launches == before + 2
    assert torch.equal(a, b)
    # both sum each bucket from 0 in word order: equal bit for bit
    assert torch.equal(a, tt.backward_grad_plain(o["pw"], d, SPEC))


def bwd_block(case, device):
    """(pw, spec) of the backward's cases: SPEC, WIDE (22,528-word
    segments), MANY (256 tiles), a WIDE block whose first bin of tile 0
    holds 14,000 words, more than a dozen fills of a bin warp's 1,024-word
    buffer, 3,000 of them on one bucket (so one bucket's words span several
    fills), and SPEC with its segments shuffled within."""
    if case == "shuffled":
        return shuffled_block(device)
    if case != "two_windows":
        return index_block({"spec": "uniform", "wide": "wide",
                            "many_tiles": "many_tiles"}[case], device)
    rng = np.random.default_rng(80)
    buckets = rng.integers(0, WIDE.nb, size=20000)
    rows = rng.integers(0, WIDE.block_rows, size=20000)
    span = tt.TILE // tt.BWD_SPANS
    buckets[:11000] = rng.integers(0, span, 11000)
    buckets[11000:14000] = span // 2
    pw, _, _, n_ovf = tt.encode_block_capped(buckets, rows, WIDE, 64)
    assert n_ovf == 0
    return as_i32(pw, device), WIDE


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spec", "wide", "many_tiles",
                                  "two_windows", "shuffled"])
def test_tile_bwd_equals_backward_pushes_at_one_channel(cuda, case):
    """Two independent word-order backwards agree bit for bit: tile_bwd
    (bins of buckets, a warp each) and backward_pushes at ch 1 (bucket index
    + segmented sum), on SPEC, WIDE, MANY, a block whose bin takes many
    buffer fills and a block whose segments are shuffled within; both equal
    the plain version."""
    pw, spec = bwd_block(case, cuda)
    d = torch.from_numpy((np.random.default_rng(81).standard_normal(
        spec.block_rows) * 0.4).astype(np.float32)).to(cuda)
    before = tt.backward_grad.launches
    g = tt.backward_grad(pw, d, spec)
    torch.cuda.synchronize()
    assert tt.backward_grad.launches == before + 1
    assert torch.equal(g, tt.backward_pushes(pw, d.view(-1, 1), spec)[:, 0])
    assert torch.equal(g, tt.backward_grad_plain(pw, d, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["logit", "hinge", "square_hinge",
                                  "square"])
@pytest.mark.parametrize("skew", [False, True])
def test_fused_step_grad_equals_split_bitwise_on_cuda(cuda, loss, skew):
    """The fused step kernel equals the split chain (tile_fwd → loss_dual
    → tile_bwd) bit for bit, repeats bitwise, and its margins and its grad
    (on the kernel's own dual) equal the plain versions' bitwise (all sum
    each row and bucket in word order)."""
    o = step_operands(50 + skew, cuda, skew)
    exact = loss in ("logit", "square_hinge")
    sp = (tt.spill_margin_rows(o["w"], o["ob"], o["orow"], SPEC) if skew
          else None)
    args = (o["pw"], o["w"], o["labels"], o["mask"], SPEC, loss, exact)
    before = launch_counts()
    mf, gf = tt.fused_step_grad(*args, spill_margins=sp)
    mf2, gf2 = tt.fused_step_grad(*args, spill_margins=sp)
    spill = (o["ob"], o["orow"]) if skew else (None, None)
    ms = tt.forward_margins(o["pw"], o["w"], SPEC, *spill)
    gs = tt.backward_grad(o["pw"], tt.loss_dual(ms, o["labels"], o["mask"],
                                                loss, exact), SPEC)
    torch.cuda.synchronize()
    assert np.subtract(launch_counts(), before).tolist() == [1, 1, 2, 0, 1,
                                                             0]
    assert torch.equal(mf, ms) and torch.equal(gf, gs)
    assert torch.equal(mf, mf2) and torch.equal(gf, gf2)
    mp, _ = tt.fused_step_grad_plain(*args, spill_margins=sp)
    assert torch.equal(mf, mp)
    dk = tt.loss_dual(mf, o["labels"], o["mask"], loss, exact)
    assert torch.equal(gf, tt.backward_grad_plain(o["pw"], dk, SPEC))


@pytest.mark.cuda
def test_fused_step_update_equals_split_bitwise_on_cuda(cuda):
    """The in-place FTRL step equals tile_fwd → loss_dual → tile_bwd →
    ftrl_push bit for bit (margins, all three planes, Σ(Δw)²), repeats
    bitwise, and agrees with its plain version: margins bitwise, slots
    bitwise with the push kernel on the plain gradient, and within
    1e-5·(1 + |x|) of the plain update."""
    o = step_operands(54, cuda)
    runs = []
    for _ in range(2):
        s = o["slots"].clone()
        m, wd = tt.fused_step_update(o["pw"], s, o["labels"], o["mask"],
                                     SPEC, "logit", HANDLE)
        runs.append((m, s, wd))
    s = o["slots"].clone()
    ms = tt.forward_margins(o["pw"], s[0], SPEC)
    d = tt.loss_dual(ms, o["labels"], o["mask"], "logit", True)
    wd = tt.ftrl_push(s, tt.backward_grad(o["pw"], d, SPEC), HANDLE)
    torch.cuda.synchronize()
    for m_, s_, wd_ in runs:
        assert torch.equal(m_, ms) and torch.equal(s_, s)
        assert torch.equal(wd_, wd)
    p = o["slots"].clone()
    mp, _ = tt.fused_step_update_plain(o["pw"], p, o["labels"], o["mask"],
                                       SPEC, "logit", HANDLE)
    assert torch.equal(ms, mp)
    q = o["slots"].clone()
    wq = tt.ftrl_push(q, tt.backward_grad_plain(o["pw"], d, SPEC), HANDLE)
    assert torch.equal(q, s) and torch.equal(wq, wd)
    err = (s - p).abs().cpu().numpy()
    assert np.all(err <= 1e-5 * (1 + np.abs(p.cpu().numpy())))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dual_cpu", "dual_shape", "labels_dtype",
                                 "slots_layout", "spill_shape"])
def test_training_kernels_reject_bad_cuda_operands(cuda, bad):
    o = step_operands(58, cuda)
    before = launch_counts()
    with pytest.raises((TypeError, ValueError)):
        if bad == "dual_cpu":
            tt.backward_grad(o["pw"], o["labels"].cpu(), SPEC)
        elif bad == "dual_shape":
            tt.backward_grad(o["pw"], o["labels"][:-1], SPEC)
        elif bad == "labels_dtype":
            tt.fused_step_grad(o["pw"], o["w"], o["labels"].double(),
                               o["mask"], SPEC, "logit", True)
        elif bad == "slots_layout":
            tt.fused_step_update(o["pw"], o["slots"].T.contiguous().T,
                                 o["labels"], o["mask"], SPEC, "logit",
                                 HANDLE)
        else:
            tt.fused_step_grad(o["pw"], o["w"], o["labels"], o["mask"], SPEC,
                               "logit", True, spill_margins=o["w"])
    assert launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["tile_bwd", "step_grad", "step_update"])
@pytest.mark.parametrize("bad", ["scratch_missing", "scratch_small",
                                 "spans"])
def test_backward_c_entries_refuse_bad_scratch(cuda, entry, bad):
    """The backward's C entries refuse a missing scratch, one too small for
    the packed values and span starts (before any launch: the update step
    leaves the slots as they were), and a span count that is not a power of
    two."""
    o = step_operands(59, cuda)
    scratch, rows = tt._span_scratch(SPEC, cuda)
    T, SG, _ = SPEC.pairs_shape
    ptr, words, spans = scratch.data_ptr(), scratch.numel(), tt.BWD_SPANS
    if bad == "scratch_missing":
        ptr = None
    elif bad == "scratch_small":
        words = T * SG * SPEC.n          # the packed values, no span starts
    else:
        spans = 3
    geo = (T, SG, SPEC.group, SPEC.cap)
    out = torch.empty(SPEC.nb, device=cuda)
    dual = torch.empty(SPEC.block_rows, dtype=torch.bfloat16, device=cuda)
    margins = torch.empty(SPEC.block_rows, device=cuda)
    part = torch.empty(T * tt.BWD_SPANS, device=cuda)
    slots = o["slots"].clone()
    P, L, I, F = tt._P, tt._L, tt._I, tt._F
    st = tt._stream(o["pw"])
    if entry == "tile_bwd":
        lib = tt._lib("tile_bwd", "wh_tile_bwd",
                      [P] * 3 + [L, P] + [I] * 5 + [P])
        err = lib.wh_tile_bwd(o["pw"].data_ptr(), o["labels"].data_ptr(),
                              ptr, words, out.data_ptr(), *geo, spans, st)
    elif entry == "step_grad":
        lib = tt._lib("tile_step", "wh_step_grad",
                      [P] * 6 + [L] + [P] * 3 + [I] * 8 + [P])
        err = lib.wh_step_grad(
            o["pw"].data_ptr(), o["w"].data_ptr(), o["labels"].data_ptr(),
            o["mask"].data_ptr(), None, ptr, words, margins.data_ptr(),
            dual.data_ptr(), out.data_ptr(), *geo, rows, spans, 0, 1, st)
    else:
        lib = tt._lib("tile_step", "wh_step_update",
                      [P] * 7 + [L] + [P] * 3 + [I] * 7 + [F] * 4 + [P])
        err = lib.wh_step_update(
            o["pw"].data_ptr(), slots[0].data_ptr(), slots[1].data_ptr(),
            slots[2].data_ptr(), o["labels"].data_ptr(),
            o["mask"].data_ptr(), ptr, words, margins.data_ptr(),
            dual.data_ptr(), part.data_ptr(), *geo, rows, spans, 0, 0.1,
            1.0, 0.05, 0.01, st)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError):
        _ext.check(lib, err, entry)
    if entry == "step_update" and bad != "spans":
        assert torch.equal(slots, o["slots"])     # nothing ran


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "split"])
def test_training_on_cuda_matches_cpu(cuda, tmp_path, kernel):
    """Two training passes through the app on the GPU (one step launch per
    block and pass on the resolved kernel) against the CPU run; fused and
    split trained slots equal bitwise on the card."""
    rng = np.random.default_rng(5)
    n = 3 * 8192 + 500
    keys = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint32)
    keys[rng.random(keys.shape) < 0.1] = 0xFFFFFFFF
    path = str(tmp_path / "t.crec2")
    with CRec2Writer(path, nnz=8, nb=SPEC.nb, subblocks=1, cap=33408,
                     ovf_cap=0) as wr:
        wr.append(keys, (rng.random(n) < 0.4).astype(np.uint8))
    cfg = dict(data_format="crec2", num_buckets=SPEC.nb, train_data=path,
               max_data_pass=2, tile_step_kernel=kernel, disp_itv=1e12)
    cpu = AsyncSGD(Config(**cfg), device="cpu")
    cpu.run()
    gpu = {}
    for k in ("fused", "split"):
        before = launch_counts()
        app = AsyncSGD(Config(**dict(cfg, tile_step_kernel=k)), device=cuda)
        app.run()
        torch.cuda.synchronize()
        gpu[k] = (app, np.subtract(launch_counts(), before).tolist())
    assert gpu["fused"][1] == [0, 0, 0, 8, 0, 0]
    assert gpu["split"][1] == [8, 8, 0, 0, 8, 8]
    assert torch.equal(gpu["fused"][0].store.slots, gpu["split"][0].store.slots)
    app = gpu[kernel][0]
    assert app.progress.num_ex == cpu.progress.num_ex == 2 * n
    assert abs(app.progress.objv - cpu.progress.objv) <= \
        1e-4 * cpu.progress.objv
    err = (app.store.slots.cpu() - cpu.store.slots).abs()
    assert float(err.max()) <= 1e-2
    assert float((err <= 1e-5 * (1 + cpu.store.slots.abs())).float()
                 .mean()) >= 0.99


# -- the multi-channel kernels (FM and wide&deep) ---------------------------

MULTI = (tt.forward_pulls, tt.backward_pushes, tt.fm_boundary,
         tt.wd_boundary, tt.fused_fm_step, tt.fused_wd_step)


def multi_counts():
    return [f.launches for f in MULTI]


def multi_operands(seed, device, skew=False, k=4, hidden=(8,)):
    o = step_operands(seed, device, skew)
    rng = np.random.default_rng(seed + 7)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        device)
    v = rng.standard_normal((SPEC.nb, k)) * 0.3
    o["fm_w"] = t(np.concatenate([rng.standard_normal((SPEC.nb, 1)) * 0.3,
                                  v, np.sum(v * v, 1, keepdims=True)], 1))
    o["wd_w"] = t(rng.standard_normal((SPEC.nb, 1 + k)) * 0.3)
    sizes = [k] + list(hidden) + [1]
    o["mlp"] = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        o["mlp"][f"W{i}"] = t(rng.standard_normal((a, b)) * np.sqrt(2 / a))
        o["mlp"][f"b{i}"] = t(rng.standard_normal(b) * 0.1)
    o["k"], o["hidden"] = k, tuple(hidden)
    return o


@pytest.mark.cuda
@pytest.mark.parametrize("ch", [3, 10, 17, 18])
@pytest.mark.parametrize("skew", [False, True])
def test_pulls_and_pushes_match_plain_and_repeat(cuda, ch, skew):
    o = step_operands(60 + ch, cuda, skew)
    rng = np.random.default_rng(ch)
    w = rng.standard_normal((SPEC.nb, ch)).astype(np.float32) * 0.2
    dv = rng.standard_normal((SPEC.block_rows, ch)).astype(np.float32) * 0.5
    wd, dvd = torch.from_numpy(w).to(cuda), torch.from_numpy(dv).to(cuda)
    before = multi_counts()
    a = tt.forward_pulls(o["pw"], wd, SPEC)
    b = tt.forward_pulls(o["pw"], wd, SPEC)
    ga = tt.backward_pushes(o["pw"], dvd, SPEC)
    gb = tt.backward_pushes(o["pw"], dvd, SPEC)
    torch.cuda.synchronize()
    assert np.subtract(multi_counts(), before).tolist() == [2, 2, 0, 0, 0, 0]
    assert torch.equal(a, b) and torch.equal(ga, gb)
    # the kernels sum each (row or bucket, channel) in word order, as the
    # plain versions do: equal bit for bit
    assert torch.equal(a, tt.forward_pulls_plain(o["pw"], wd, SPEC))
    assert torch.equal(ga, tt.backward_pushes_plain(o["pw"], dvd, SPEC))


# 22,528 words a tile: past the index build's 20,480-word window, so a
# tile's words are placed in two windows
WIDE = tt.TileSpec(nb=2 * tt.TILE, subblocks=2, cap=11264, group=2,
                   tiles_step=2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "skew", "two_windows"])
def test_push_index_kernel_equals_plain(cuda, case):
    """The pushes' bucket index built on the card (bucket starts, and each
    bucket's block rows in word order) equals push_index_plain exactly, and
    the pushes over it equal the plain version bitwise."""
    if case == "two_windows":
        rng = np.random.default_rng(67)
        buckets = rng.integers(0, WIDE.nb, size=30000)
        rows = rng.integers(0, WIDE.block_rows, size=30000)
        # fill tile 0's subblock 1 past the window (2,048 words there), with
        # one bucket's words in both windows
        buckets[:11000] = rng.integers(0, tt.TILE, 11000)
        rows[:11000] = rng.integers(tt.RSUB, 2 * tt.RSUB, 11000)
        buckets[11000:14000] = 16000
        pw = as_i32(tt.encode_block_capped(buckets, rows, WIDE, 64)[0], cuda)
        spec = WIDE
    else:
        pw, spec = step_operands(66, cuda, case == "skew")["pw"], SPEC
    before = tt.push_index.launches
    start, perm = tt.push_index(pw, spec)
    torch.cuda.synchronize()
    assert tt.push_index.launches == before + 1
    ps, pp = tt.push_index_plain(pw, spec)
    assert torch.equal(start, ps) and torch.equal(perm, pp)
    dv = torch.from_numpy(np.random.default_rng(68).standard_normal(
        (spec.block_rows, 3)).astype(np.float32)).to(cuda)
    assert torch.equal(tt.backward_pushes(pw, dv, spec),
                       tt.backward_pushes_plain(pw, dv, spec))


# 256 tiles of 256 words: the pulls' row index splits each subblock's tiles
# into two runs (160 and 96 tiles), one CTA each
MANY = tt.TileSpec(nb=256 * tt.TILE, subblocks=2, cap=128, group=2,
                   tiles_step=2)
# 22,528 words a (tile, subblock) segment: a pulls index CTA places them in
# two windows
TWO = tt.TileSpec(nb=2 * tt.TILE, subblocks=2, cap=22528, group=2,
                  tiles_step=2)


def index_block(case, device):
    """(pw, spec) of the pull index cases."""
    rng = np.random.default_rng(69)
    if case in ("uniform", "skew"):
        return step_operands(69, device, case == "skew")["pw"], SPEC
    if case == "wide":          # one tile a run, one window
        spec = WIDE
        buckets = rng.integers(0, spec.nb, size=30000)
        rows = rng.integers(0, spec.block_rows, size=30000)
        buckets[:11000] = rng.integers(0, tt.TILE, 11000)
        rows[:11000] = rng.integers(tt.RSUB, 2 * tt.RSUB, 11000)
    elif case == "many_tiles":
        spec = MANY
        buckets = rng.integers(0, spec.nb, size=20000)
        rows = rng.integers(0, spec.block_rows, size=20000)
    else:                       # two windows, 64 rows in both
        spec = TWO
        buckets = rng.integers(0, spec.nb, size=30000)
        rows = rng.integers(0, spec.block_rows, size=30000)
        buckets[:21000] = rng.integers(0, tt.TILE, 21000)
        rows[:21000] = rng.integers(tt.RSUB, tt.RSUB + 64, 21000)
    pw = tt.encode_block_capped(buckets, rows, spec, 64)[0]
    return as_i32(pw, device), spec


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "skew", "wide", "many_tiles",
                                  "two_windows"])
def test_pull_index_kernel_equals_plain(cuda, case):
    """The pulls' row index built on the card (row starts, and each row's
    table rows in word order) equals pull_index_plain exactly, and the
    pulls over it equal the plain version bitwise (a channel a thread at
    ch 3, a pair at ch 6)."""
    pw, spec = index_block(case, cuda)
    before = tt.pull_index.launches
    start, perm = tt.pull_index(pw, spec)
    torch.cuda.synchronize()
    assert tt.pull_index.launches == before + 1
    ps, pp = tt.pull_index_plain(pw, spec)
    assert torch.equal(start, ps) and torch.equal(perm, pp)
    for ch in (3, 6):
        w = torch.from_numpy(np.random.default_rng(ch).standard_normal(
            (spec.nb, ch)).astype(np.float32)).to(cuda)
        assert torch.equal(tt.forward_pulls(pw, w, spec),
                           tt.forward_pulls_plain(pw, w, spec))


@pytest.mark.cuda
def test_pulls_do_not_assume_row_order_within_a_segment(cuda):
    """A block whose segments are shuffled within (pad words included): the
    row index, the pulls and the pushes equal their plain versions bitwise,
    and the fused FM step equals the split chain."""
    o = multi_operands(75, cuda)
    T, SG, _ = SPEC.pairs_shape
    seg = o["pw"].cpu().numpy().reshape(T, SG, SPEC.group, SPEC.cap)
    rng = np.random.default_rng(76)
    for t, g, j in np.ndindex(seg.shape[:3]):
        seg[t, g, j] = rng.permutation(seg[t, g, j])
    pw = as_i32(seg.reshape(SPEC.pairs_shape), cuda)
    assert not torch.equal(pw, o["pw"])
    start, perm = tt.pull_index(pw, SPEC)
    ps, pp = tt.pull_index_plain(pw, SPEC)
    assert torch.equal(start, ps) and torch.equal(perm, pp)
    W, k = o["fm_w"], o["k"]
    pulls = tt.forward_pulls(pw, W, SPEC)
    assert torch.equal(pulls, tt.forward_pulls_plain(pw, W, SPEC))
    ms, dvs = tt.fm_boundary(pulls, o["labels"], o["mask"], k, "logit")
    gs = tt.backward_pushes(pw, dvs, SPEC)
    assert torch.equal(gs, tt.backward_pushes_plain(pw, dvs, SPEC))
    mf, gf = tt.fused_fm_step(pw, W, o["labels"], o["mask"], SPEC, k,
                              "logit")
    assert torch.equal(mf, ms) and torch.equal(gf, gs)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["logit", "hinge", "square_hinge",
                                  "square"])
@pytest.mark.parametrize("skew", [False, True])
def test_fused_fm_step_equals_split_bitwise_on_cuda(cuda, loss, skew):
    """wh_fm_step equals forward_pulls → fm_boundary → backward_pushes bit
    for bit (the spill variant's push rows too), repeats bitwise, and
    agrees with its plain version within the bounds."""
    o = multi_operands(70 + skew, cuda, skew)
    k, W = o["k"], o["fm_w"]
    args = (o["pw"], W, o["labels"], o["mask"], SPEC, k, loss)
    sp = tt.spill_pull_rows(W, o["ob"], o["orow"], SPEC) if skew else None
    before = multi_counts()
    f1 = tt.fused_fm_step(*args, spill_pulls=sp)
    f2 = tt.fused_fm_step(*args, spill_pulls=sp)
    spill = (o["ob"], o["orow"]) if skew else (None, None)
    pulls = tt.forward_pulls(o["pw"], W, SPEC, *spill)
    ms, dvs = tt.fm_boundary(pulls, o["labels"], o["mask"], k, loss)
    gs = tt.backward_pushes(o["pw"], dvs, SPEC)
    torch.cuda.synchronize()
    assert np.subtract(multi_counts(), before).tolist() == [1, 1, 1, 0, 2, 0]
    for x, y in zip(f1, f2):
        assert torch.equal(x, y)
    assert torch.equal(f1[0], ms) and torch.equal(f1[1], gs)
    if skew:
        assert torch.equal(f1[2], dvs)
    mp = tt.fused_fm_step_plain(*args, spill_pulls=sp)[0].cpu().numpy()
    assert np.all(np.abs(f1[0].cpu().numpy() - mp)
                  <= 1e-5 * (1 + np.abs(mp)))


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [(8,), (64, 32), (300, 40)])
def test_fused_wd_step_equals_split_bitwise_on_cuda(cuda, hidden):
    """wh_wd_step equals forward_pulls → wd_boundary → backward_pushes bit
    for bit, MLP grads included, at widths whose weights sit in shared
    memory and at (300, 40), whose 17,181 weights (k 16) do not; it repeats
    bitwise and agrees with its plain (autograd) version."""
    o = multi_operands(80, cuda, k=16 if hidden != (8,) else 4,
                       hidden=hidden)
    k, W, mlp = o["k"], o["wd_w"], o["mlp"]
    args = (o["pw"], W, o["labels"], o["mask"], mlp, SPEC, k, "logit")
    before = multi_counts()
    m1, p1, g1 = tt.fused_wd_step(*args)
    m2, p2, g2 = tt.fused_wd_step(*args)
    pulls = tt.forward_pulls(o["pw"], W, SPEC)
    ms, dvs, gs = tt.wd_boundary(pulls, o["labels"], o["mask"], mlp, k,
                                 "logit")
    ps = tt.backward_pushes(o["pw"], dvs, SPEC)
    me = tt.wd_boundary(pulls, o["labels"], o["mask"], mlp, k, "logit",
                        want_grad=False)[0]
    torch.cuda.synchronize()
    assert np.subtract(multi_counts(), before).tolist() == [1, 1, 0, 2, 0, 2]
    assert torch.equal(m1, m2) and torch.equal(p1, p2)
    assert torch.equal(m1, ms) and torch.equal(p1, ps)
    assert torch.equal(me, ms)
    for key in g1:
        assert torch.equal(g1[key], g2[key]) and torch.equal(g1[key],
                                                             gs[key])
    mp, _, gp = tt.fused_wd_step_plain(*args[:5], SPEC, "logit")
    mp = mp.cpu().numpy()
    assert np.all(np.abs(m1.cpu().numpy() - mp) <= 1e-5 * (1 + np.abs(mp)))
    for key in gp:
        want = gp[key].cpu().numpy()
        assert np.all(np.abs(g1[key].cpu().numpy() - want)
                      <= 1e-4 * np.abs(want).max() + 1e-6), key


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["table_cpu", "table_1d", "dvals_shape",
                                 "fm_width", "mlp_width", "push_scratch",
                                 "pull_scratch"])
def test_multi_kernels_reject_bad_cuda_operands(cuda, bad):
    o = multi_operands(90, cuda)
    before = multi_counts()
    exc = (RuntimeError if bad.endswith("_scratch")
           else (TypeError, ValueError))
    with pytest.raises(exc):
        if bad == "pull_scratch":   # the pulls' index scratch left out
            lib = tt._lib("tile_multi", "wh_tile_pulls",
                          [tt._P] * 5 + [tt._I] * 6 + [tt._P])
            ch = o["fm_w"].shape[1]
            out = torch.empty((SPEC.block_rows, ch), device=cuda)
            T, SG, _ = SPEC.pairs_shape
            err = lib.wh_tile_pulls(o["pw"].data_ptr(), o["fm_w"].data_ptr(),
                                    None, None, out.data_ptr(), T, SG,
                                    SPEC.group, SPEC.cap, ch, 1,
                                    tt._stream(o["pw"]))
            _ext.check(lib, err, "tile_pulls")
        elif bad == "push_scratch":   # the pushes' index scratch left out
            lib = tt._lib("tile_multi", "wh_tile_pushes",
                          [tt._P] * 6 + [tt._I] * 5 + [tt._P])
            dv = torch.zeros((SPEC.block_rows, 3), device=cuda)
            dvb = dv.to(torch.bfloat16)
            out = torch.empty((SPEC.nb, 3), device=cuda)
            T, SG, _ = SPEC.pairs_shape
            err = lib.wh_tile_pushes(o["pw"].data_ptr(), dv.data_ptr(),
                                     dvb.data_ptr(), None, None,
                                     out.data_ptr(), T, SG, SPEC.group,
                                     SPEC.cap, 3, tt._stream(o["pw"]))
            _ext.check(lib, err, "tile_pushes")
        elif bad == "table_cpu":
            tt.forward_pulls(o["pw"], o["fm_w"].cpu(), SPEC)
        elif bad == "table_1d":
            tt.forward_pulls(o["pw"], o["w"], SPEC)
        elif bad == "dvals_shape":
            tt.backward_pushes(o["pw"], o["fm_w"], SPEC)
        elif bad == "fm_width":
            tt.fused_fm_step(o["pw"], o["fm_w"], o["labels"], o["mask"],
                             SPEC, o["k"] + 1, "logit")
        else:
            short = dict(o["mlp"], W1=o["mlp"]["W1"][:-1])  # 7 rows, not 8
            tt.fused_wd_step(o["pw"], o["wd_w"], o["labels"], o["mask"],
                             short, SPEC, o["k"], "logit")
    assert multi_counts() == before
