#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's crec2 predict and training paths at the full width of the
repo's flagship model (criteo-shaped FTRL: 2^22 buckets, 39 keys per row,
98,304-row blocks), and FM (dim 8) and wide&deep (dim 16, hidden 64,32)
training at the same geometry, on the card, and fails (non-zero exit) on any
error:

1. prints torch, CUDA, nvcc versions and the card's name and power limit;
2. builds every kernel from ``wormhole_tpu_torch/ops/csrc`` (one ``nvcc`` per
   source, all at once) and prints the build time and register/smem use;
3. holds the ``tile_fwd`` kernel at full width, on a uniform block and on a
   block whose hot key spills into the COO list, bitwise to its order-exact
   plain torch version (each row summed in word order; plus the spill grid)
   and to ``forward_pulls`` at one channel, and requires two kernel runs to
   be bitwise equal;
4. writes 4 crec2 blocks and a save_model text model from ``--seed`` with
   numpy, then runs the app's ``main`` (the CLI a user calls) to predict;
5. checks every prediction against a float64 numpy oracle, and that the
   kernel launched once per predicted block during that run;
6. runs a validation pass (``_run_eval``) and checks objv, AUC and accuracy
   against the oracle;
7. times the kernel (and the device time of its two launches apart), its
   plain version, ``forward_pulls`` at one channel and a one-call yardstick
   (``torch.sparse.mm`` on a CSR matrix of the same pairs) per block with
   CUDA events, beside the bound the card's memory rate sets;
8. holds the training kernels against their plain torch versions at full
   width: ``tile_bwd`` on a uniform block, a spill block and a fuse=8 spec
   (2^25 buckets), the fused steps ``tile_step_grad`` (with and without the
   spill grid) and ``tile_step_update``, and the split path's ``loss_dual``
   and ``ftrl_push``; requires two runs to be bitwise equal, ``tile_bwd``
   to equal its order-exact plain version (each bucket summed in word
   order) and ``backward_pushes`` at one channel bitwise, the fused steps
   to equal the split chain bitwise, their margins and grad to equal the
   plain versions' bitwise (the grad on the kernel's own dual), and the
   update step's slots to equal ``ftrl_push`` on the plain gradient;
9. writes a 4-block spill file (ovf_cap 1024, a hot key) and a 4-block
   ovf_cap=0 file from ``--seed`` and trains 2 passes with validation on each
   resolution: ``fused`` on the spill file through ``main`` (also predicting
   and saving the model), then in-process ``fused`` and ``split`` on both
   files. Requires one launch per block and pass on the resolved kernel,
   fused and split trained slots bitwise equal, and per-pass train objv and
   validation objv/AUC/accuracy within 1e-4 of a float64 numpy oracle of the
   same FTRL steps, and the final weights within the stated per-bucket
   bound; prints examples per second of each run;
10. times each training kernel per full-width block beside its bound, its
    plain version, the split chain, and (for ``tile_bwd``, also on the
    fuse=8 spec) the one-call yardstick ``torch.sparse.mm`` of the
    transposed CSR; the device time of each launch of ``tile_bwd`` and the
    two fused steps (``torch.profiler``) and ``backward_pushes`` at one
    channel, the alternative design;
11. holds the multi-channel kernels against their plain versions at full
    width on the uniform and the spill block: ``tile_pulls``/``tile_pushes``
    at ch 10, 17 and 18, ``tile_fm_step`` with and without the spill grid
    (logit and hinge), ``tile_wd_step`` and the ``fm_boundary``/
    ``wd_boundary`` launches; requires two runs bitwise equal, the fused
    steps equal to the split chain bitwise, ``tile_pulls`` and
    ``tile_pushes`` equal to their order-exact plain versions bitwise, and
    the pulls' row index (``pull_index``, also on the 2,048-tile fuse=8
    spec) and the pushes' bucket index (``push_index``) equal to their
    plain versions exactly;
12. writes another spill file and ovf_cap=0 file and trains FM and
    wide&deep 2 passes with validation: through each model's ``main`` on
    the fused resolution, then in process on ``fused`` and ``split`` on both
    files. Requires one launch per block and pass on the resolved kernel
    (#8/#9 fused; #4 + #5 split and on wide&deep spill blocks), #4 on every
    validation block, fused and split trained state bitwise equal (slots,
    MLP and its accumulator), per-pass train objv and validation
    objv/AUC/accuracy on a float64 numpy oracle, and every updated table
    entry and MLP parameter within its stated bound of that oracle replayed
    from the port's state; prints examples per second of each run;
13. times each multi-channel kernel per full-width block beside its bound
    (the pull table's bytes counted over the sectors the block reaches),
    its plain version, the split chain (fused steps) and the one-call
    yardstick ``torch.sparse.mm`` (#4, #5), the device time of each launch
    of ``tile_pulls`` (its row index and its segmented sum apart, with
    ``torch.profiler``), and the whole FM and wide&deep train step with the
    dense AdaGrad update;
14. prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
    as the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package, and exits non-zero with no
result when ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

NB = 1 << 22          # bench.py's flagship criteo geometry
NNZ = 39
SUBBLOCKS = 12
OVF_CAP = 1024
BLOCKS = 4
TAIL_ROWS = 40_000    # the 4th block is a padded tail
HOT_ROWS = 600        # rows of block 1 sharing one key: ~300 spill pairs
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PASSES = 2            # training passes per run
LAMBDA = (0.5, 0.1)   # FTRL L1/L2 of the training runs
ALPHA, BETA = 0.1, 1.0   # Config's lr_eta/lr_beta defaults
NB_FUSE8 = 1 << 25    # the spec make_spec gives fuse=8 (cap 256)
VOCAB = 1 << 20       # distinct keys of the training files


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase(name: str) -> float:
    print(f"== {name}", flush=True)
    return time.perf_counter()


def make_keys(rng, n: int) -> np.ndarray:
    keys = rng.integers(0, 1 << 32, size=(n, NNZ), dtype=np.uint32)
    keys[keys == 0xFFFFFFFF] = 0
    keys[rng.random((n, NNZ)) < 0.1] = 0xFFFFFFFF   # missing criteo fields
    return keys


def bf16(x: np.ndarray) -> np.ndarray:
    import torch
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def row_tolerance(torch, tt, pw, w, spec):
    """Per-row bound 4·nnz·2⁻²⁴·Σ_p|w_p|: kernel and plain version both sum
    bf16(w) in f32 and differ only in order (a k-term f32 sum is within
    k·2⁻²⁴·Σ|terms| of exact). Spill pairs add the same f32 grid to both."""
    bucket, row, valid = tt.decode_pairs(pw, spec)
    wb = w.to(torch.bfloat16).double().abs()
    mag = torch.zeros(spec.block_rows, dtype=torch.float64,
                      device=pw.device).index_add_(0, row[valid],
                                                   wb[bucket[valid]])
    cnt = torch.zeros(spec.block_rows, dtype=torch.float64,
                      device=pw.device).index_add_(
                          0, row[valid], torch.ones_like(wb[bucket[valid]]))
    return 4 * cnt.clamp(min=1) * 2.0 ** -24 * mag + 1e-30


def time_ms(torch, fn, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of the mean of ``inner`` back-to-back calls,
    timed with CUDA events after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1) / inner)
    return float(np.median(ts))


def launch_ms(torch, fn, reps: int = 10) -> dict:
    """Device ms per call of each kernel that ``fn`` launches, by kernel
    name, from ``torch.profiler`` over ``reps`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / reps / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def kernel_name(key: str) -> str:
    """A profiler kernel key without its parameter list, return type and
    anonymous namespace: ``wh::fwd_rows<16, 8, wh::FwdMargins>``."""
    key = key.replace("(anonymous namespace)::", "")
    return key.split("(")[0].removeprefix("void ").strip()


def table_bytes(torch, bucket, width: int) -> int:
    """Bytes that a gather of the rows ``bucket`` (repeats allowed) from a
    row-major (nb, width) f32 table must read: the 32 B sectors those rows
    span, each once. A block reaches only part of the table, and a row of a
    few channels shares its sectors with its neighbours."""
    b = torch.unique(bucket).to(torch.int64)
    lo = b * (4 * width) // 32
    hi = (b * (4 * width) + 4 * width - 1) // 32
    sec = lo[:, None] + torch.arange(-(-4 * width // 32) + 1, device=b.device)
    return int(torch.unique(sec[sec <= hi[:, None]]).numel()) * 32


def grad_tolerance(torch, tt, pw, spec, d_a, d_b):
    """Per-bucket bound between two gradients from duals d_a and d_b: the
    f32 reorder term 4·k·2⁻²⁴·Σ|bf16 d| over the bucket's k pairs, plus
    Σ|bf16(d_a) − bf16(d_b)| (two duals a rounding apart may round to
    neighbouring bf16 values)."""
    bucket, row, valid = tt.decode_pairs(pw, spec)
    b, r = bucket[valid], row[valid]
    da = d_a.to(torch.bfloat16).double()
    db = d_b.to(torch.bfloat16).double()
    z = lambda: torch.zeros(spec.nb, dtype=torch.float64, device=pw.device)
    mag = z().index_add_(0, b, da.abs()[r])
    cnt = z().index_add_(0, b, torch.ones_like(r, dtype=torch.float64))
    flip = z().index_add_(0, b, (da - db).abs()[r])
    return 4 * cnt.clamp(min=1) * 2.0 ** -24 * mag + flip + 1e-30


def slot_tolerance(torch, old, g, new, gtol):
    """Per-slot bound on an FTRL update (3, nb) from the same start: the f32
    roundings of z' = (z + g) − σ·w (σ from the cancelling cg' − cg),
    carried into w' through the shrink and the α/β curvature, plus what a
    per-bucket gradient bound ``gtol`` moves (z' by gtol·(1 + |w|/α))."""
    eps = 8 * 2.0 ** -24
    o, n = old.double(), new.double()
    w, z, cg = o[0].abs(), o[1].abs(), o[2]
    dz = (eps * (z + g.double().abs()) + eps * (n[2].abs() + cg) / ALPHA * w
          + gtol * (1 + w / ALPHA))
    dw = ALPHA / BETA * (dz + eps * (n[1].abs() + LAMBDA[0]))
    return torch.stack([dw + eps * n[0].abs(), dz,
                        eps * n[2].abs() + gtol]) + 1e-30


def oracle_blocks(torch, tt, path, spec, dev):
    """Per block of a crec2 file, as numpy: the tile pairs' (bucket, row),
    the spill pairs' (bucket, row) and the u8 labels."""
    from wormhole_tpu_torch.data.crec import block_tensors, iter_packed2
    out = []
    for views, _rows in iter_packed2(path):
        pw = block_tensors(views)["pw"].to(dev)
        b, r, v = tt.decode_pairs(pw, spec)
        sp = views["ovf_b"] != 0xFFFFFFFF
        out.append((b[v].cpu().numpy(), r[v].cpu().numpy(),
                    views["ovf_b"][sp].astype(np.int64),
                    views["ovf_r"][sp].astype(np.int64),
                    views["labels"].copy()))
    return out


def oracle_margins(w, blk, rows):
    """Tile pairs add bf16(f32 w), spill pairs f32 w, summed in float64."""
    pb, pr, sb, sr, _ = blk
    w32 = w.astype(np.float32)
    return (np.bincount(pr, weights=bf16(w32).astype(np.float64)[pb],
                        minlength=rows)
            + np.bincount(sr, weights=w32[sb].astype(np.float64),
                          minlength=rows))


def oracle_train(blocks, nb, rows, auc_np):
    """Float64 FTRL over the blocks, PASSES passes, logit loss, with the
    kernels' bf16 rounding of w (tile pairs) and of the dual (tile pairs;
    spill pairs carry f32 values). Returns the final w and, per pass, the
    train objv per example and the validation (same blocks) objv per
    example, pooled AUC and mean per-block accuracy."""
    w, z, cg = np.zeros(nb), np.zeros(nb), np.zeros(nb)
    log = []
    for _ in range(PASSES):
        objv, n = 0.0, 0
        for blk in blocks:
            pb, pr, sb, sr, lab = blk
            m = oracle_margins(w, blk, rows)
            real = lab != 255
            y = np.where(lab == 1, 1.0, -1.0)
            objv += float(np.logaddexp(0, -y * m)[real].sum())
            n += int(real.sum())
            dual = np.where(real, -y / (1 + np.exp(y * m)), 0.0)
            d32 = dual.astype(np.float32)
            g = (np.bincount(pb, weights=bf16(d32).astype(np.float64)[pr],
                             minlength=nb)
                 + np.bincount(sb, weights=d32.astype(np.float64)[sr],
                               minlength=nb))
            c = np.sqrt(cg * cg + g * g)
            z = z + g - (c - cg) / ALPHA * w
            cg = c
            v = -z
            w = (np.sign(v) * np.maximum(np.abs(v) - LAMBDA[0], 0)
                 / ((BETA + c) / ALPHA + LAMBDA[1]))
        ms, ys, accs, vobjv = [], [], [], 0.0
        for blk in blocks:
            lab = blk[4]
            real = lab != 255
            m = oracle_margins(w, blk, rows)[real]
            y = (lab[real] == 1).astype(np.float64)
            vobjv += float(np.logaddexp(0, -(2 * y - 1) * m).sum())
            accs.append(np.mean((m > 0) == (y > 0.5)))
            ms.append(m)
            ys.append(y)
        log.append({"train_objv": objv / n, "val_objv": vobjv / n,
                    "val_auc": auc_np(np.concatenate(ys),
                                      np.concatenate(ms)),
                    "val_acc": float(np.mean(accs))})
    return w, log


# -- the FM and wide&deep slice ------------------------------------------------

FM_DIM = 8                  # bench.py's FM geometry (dim 8, 10 channels)
WD_DIM, WD_HIDDEN = 16, (64, 32)   # and wide&deep's (17 in, 18 out)
MULTI_NAMES = ["tile_pulls", "tile_pushes", "fm_boundary", "wd_boundary",
               "tile_fm_step", "tile_wd_step"]


def multi_counted(tt):
    return [tt.forward_pulls, tt.backward_pushes, tt.fm_boundary,
            tt.wd_boundary, tt.fused_fm_step, tt.fused_wd_step]


def chan_tol(torch, keys, idx, vals, n):
    """Per (key, channel): 4·m·2⁻²⁴·Σ|bf16 value| over the key's m pairs
    (the f32 reorder bound of two sums of the same bf16 terms), plus
    2⁻²³·that magnitude for one f32 add of an identical spill grid."""
    vb = vals.to(torch.bfloat16).double().abs()
    mag = torch.zeros((n, vals.shape[1]), dtype=torch.float64,
                      device=vals.device).index_add_(0, keys, vb[idx])
    cnt = torch.zeros(n, dtype=torch.float64, device=vals.device).index_add_(
        0, keys, torch.ones_like(keys, dtype=torch.float64))
    return (4 * cnt.clamp(min=1)[:, None] + 2) * 2.0 ** -24 * mag + 1e-30


def flip_tol(torch, keys, idx, a, b, n):
    """Σ|bf16(a) − bf16(b)| per (key, channel) over the key's pairs: two
    values an f32 rounding apart may round to neighbouring bf16 values."""
    d = (a.to(torch.bfloat16).double() - b.to(torch.bfloat16).double()).abs()
    return torch.zeros((n, a.shape[1]), dtype=torch.float64,
                       device=a.device).index_add_(0, keys, d[idx])


def multi_kernel_checks(torch, tt, spec, blocks, many, rng, dev, errs):
    """#4 and #5 at ch 10, 17 and 18 (each, and its row or bucket index,
    bitwise equal to its plain version), fused_fm_step with and without
    spill and fused_wd_step at full width: against their plain versions,
    two runs bitwise equal, fused = split chain bitwise; and #4's row index
    and its pulls at ch 1 on ``many``, a (pw, spec) of 2,048 tiles.
    Records the largest error per kernel in ``errs``."""
    rows, nb = spec.block_rows, spec.nb
    labels = torch.from_numpy((rng.random(rows) < 0.25).astype(
        np.float32)).to(dev)
    mask = torch.ones(rows, device=dev)
    mask[-4096:] = 0.0

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def note(name, err):
        errs[name] = max(errs.get(name, 0.0), float(err))

    for kind, blk in blocks.items():
        pw = blk["pw"]
        spill = (blk["ovf_b"], blk["ovf_r"]) if kind == "spill" else \
            (None, None)
        bucket, row, valid = tt.decode_pairs(pw, spec)
        kb, kr = bucket[valid], row[valid]
        for name, build, plain_build in (
                ("push_index", tt.push_index, tt.push_index_plain),
                ("pull_index", tt.pull_index, tt.pull_index_plain)):
            start, perm = build(pw, spec)
            ps, pp = plain_build(pw, spec)
            require(torch.equal(start, ps) and torch.equal(perm, pp),
                    f"{name} {kind}: the index differs from its plain "
                    "version")
            print(f"{name} {kind}: {perm.numel()} words in "
                  f"{int((ps[1:] > ps[:-1]).sum())} keys, = plain exactly")
            del start, perm, ps, pp
        for ch in (10, 17, 18):
            w = f32(rng.standard_normal((nb, ch)) * 0.1)
            a = tt.forward_pulls(pw, w, spec, *spill)
            b = tt.forward_pulls(pw, w, spec, *spill)
            plain = tt.forward_pulls_plain(pw, w, spec)
            if kind == "spill":
                plain = plain + tt.spill_pull_rows(w, *spill, spec)
            err = (a.double() - plain.double()).abs()
            require(torch.equal(a, b), f"tile_pulls {kind} ch {ch}: runs "
                    "differ")
            # both sum each (row, channel) from 0 in word order
            require(torch.equal(a, plain), f"tile_pulls {kind} ch {ch}: "
                    f"not bitwise equal to the order-exact plain version "
                    f"({int((a != plain).sum())} entries differ, largest "
                    f"{err.max():.3e})")
            note("tile_pulls", err.max())
            dv = f32(rng.standard_normal((rows, ch)) * 0.4)
            a = tt.backward_pushes(pw, dv, spec, *spill)
            b = tt.backward_pushes(pw, dv, spec, *spill)
            plain = tt.backward_pushes_plain(pw, dv, spec)
            if kind == "spill":
                plain = tt.spill_push_scatter(plain, dv, *spill, spec)
            err2 = (a.double() - plain.double()).abs()
            require(torch.equal(a, b), f"tile_pushes {kind} ch {ch}: runs "
                    "differ")
            require(bool(torch.all(err2 <= chan_tol(torch, kb, kr, dv, nb)
                                   + 2.0 ** -23 * plain.double().abs())),
                    f"tile_pushes {kind} ch {ch}: vs plain {err2.max():.3e}")
            # both sum each (bucket, channel) from 0 in word order
            require(torch.equal(a, plain), f"tile_pushes {kind} ch {ch}: "
                    f"not bitwise equal to the order-exact plain version "
                    f"({int((a != plain).sum())} entries differ)")
            note("tile_pushes", err2.max())
            print(f"tile_pulls/tile_pushes {kind} ch {ch}: = order-exact "
                  f"plain bitwise (max |kernel - plain| {err.max():.3e} / "
                  f"{err2.max():.3e}), bitwise repeat ok")
            del a, b, plain, err, err2, w, dv
        # the FM step (k 8, 10 channels), with the spill grid on the spill
        # block
        k = FM_DIM
        v = rng.standard_normal((nb, k)) * 0.1
        wf = f32(np.concatenate([rng.standard_normal((nb, 1)) * 0.1, v,
                                 np.sum(v * v, 1, keepdims=True)], 1))
        sp = tt.spill_pull_rows(wf, *spill, spec) if kind == "spill" else None
        for loss in ("logit", "hinge"):
            f1 = tt.fused_fm_step(pw, wf, labels, mask, spec, k, loss,
                                  spill_pulls=sp)
            f2 = tt.fused_fm_step(pw, wf, labels, mask, spec, k, loss,
                                  spill_pulls=sp)
            pulls = tt.forward_pulls(pw, wf, spec, *spill)
            ms, dvs = tt.fm_boundary(pulls, labels, mask, k, loss)
            gs = tt.backward_pushes(pw, dvs, spec)
            require(all(torch.equal(x, y) for x, y in zip(f1, f2)),
                    f"tile_fm_step {kind} {loss}: runs differ")
            require(torch.equal(f1[0], ms) and torch.equal(f1[1], gs)
                    and (sp is None or torch.equal(f1[2], dvs)),
                    f"tile_fm_step {kind} {loss}: fused != split")
            mp, dvp = tt.fm_boundary_plain(pulls, labels, mask, k, loss)
            berr = max((ms.double() - mp.double()).abs().max().item(),
                       (dvs.double() - dvp.double()).abs().max().item())
            require(berr <= 1e-5, f"fm_boundary {loss}: vs plain on the "
                    f"same pulls {berr:.3e}")
            note("fm_boundary", berr)
            p = tt.fused_fm_step_plain(pw, wf, labels, mask, spec, k, loss,
                                       sp)
            pulls_p = tt.forward_pulls_plain(pw, wf, spec)
            if sp is not None:
                pulls_p = pulls_p + sp
            dvp = tt.fm_boundary_plain(pulls_p, labels, mask, k, loss)[1]
            # margins: the pull bound carried through lin + ½(Σs² − q),
            # plus f32 roundings of its terms
            ptol = chan_tol(torch, kr, kb, wf, rows)
            s = pulls[:, 1:1 + k].double().abs()
            d = ptol[:, 1:1 + k]
            mtol = (ptol[:, 0] + 0.5 * (((2 * s + d) * d).sum(1)
                                         + ptol[:, 1 + k])
                    + 1e-6 * (1 + ms.double().abs()))
            merr = (f1[0].double() - p[0].double()).abs()
            # pushes: the reorder bound plus the bf16 flips of the two
            # sides' push values
            gtol = (chan_tol(torch, kb, kr, dvs, nb)
                    + flip_tol(torch, kb, kr, dvs, dvp, nb))
            gerr = (f1[1].double() - p[1].double()).abs()
            require(bool(torch.all(merr <= mtol)), f"tile_fm_step {kind} "
                    f"{loss}: margins vs plain {merr.max():.3e}")
            require(bool(torch.all(gerr <= gtol)), f"tile_fm_step {kind} "
                    f"{loss}: pushes vs plain {gerr.max():.3e}")
            note("tile_fm_step", max(merr.max().item(), gerr.max().item()))
            print(f"tile_fm_step {kind} {loss}: fused = split bitwise, "
                  f"bitwise repeat ok; vs plain margins {merr.max():.3e} "
                  f"pushes {gerr.max():.3e}; fm_boundary vs plain on the "
                  f"same pulls {berr:.3e} (tolerance 1e-5)")
            del f1, f2, pulls, pulls_p, ms, dvs, dvp, gs, p, ptol, gtol
        del wf, v, sp
    # the row index over many tiles (80 tiles a run, 26 runs a subblock)
    pw, spec_m = many
    start, perm = tt.pull_index(pw, spec_m)
    ps, pp = tt.pull_index_plain(pw, spec_m)
    require(torch.equal(start, ps) and torch.equal(perm, pp),
            f"pull_index {spec_m.tiles} tiles: the index differs from its "
            "plain version")
    # a table that draws nothing from rng, so later phases see the inputs
    # they saw before this check
    w = f32(np.sin(np.arange(spec_m.nb, dtype=np.float64))[:, None] * 0.1)
    require(torch.equal(tt.forward_pulls(pw, w, spec_m),
                        tt.forward_pulls_plain(pw, w, spec_m)),
            f"tile_pulls {spec_m.tiles} tiles ch 1: not bitwise equal to "
            "the order-exact plain version")
    print(f"pull_index {spec_m.tiles} tiles (cap {spec_m.cap}): "
          f"{perm.numel()} words, = plain exactly; tile_pulls ch 1 = plain "
          "bitwise")
    del start, perm, ps, pp, w
    # the wide&deep step (k 16, hidden 64,32) on the spill-free block
    pw = blocks["uniform"]["pw"]
    bucket, row, valid = tt.decode_pairs(pw, spec)
    kb, kr = bucket[valid], row[valid]
    k = WD_DIM
    ww = f32(rng.standard_normal((nb, 1 + k)) * 0.1)
    sizes = [k] + list(WD_HIDDEN) + [1]
    mlp = {}
    for i, (a_, b_) in enumerate(zip(sizes[:-1], sizes[1:])):
        mlp[f"W{i}"] = f32(rng.standard_normal((a_, b_)) * np.sqrt(2 / a_))
        mlp[f"b{i}"] = f32(rng.standard_normal(b_) * 0.05)
    m1, p1, g1 = tt.fused_wd_step(pw, ww, labels, mask, mlp, spec, k,
                                  "logit")
    m2, p2, g2 = tt.fused_wd_step(pw, ww, labels, mask, mlp, spec, k,
                                  "logit")
    pulls = tt.forward_pulls(pw, ww, spec)
    ms, dvs, gs = tt.wd_boundary(pulls, labels, mask, mlp, k, "logit")
    ps = tt.backward_pushes(pw, dvs, spec)
    me = tt.wd_boundary(pulls, labels, mask, mlp, k, "logit",
                        want_grad=False)[0]
    require(torch.equal(m1, m2) and torch.equal(p1, p2) and all(
        torch.equal(g1[n], g2[n]) for n in g1), "tile_wd_step: runs differ")
    require(torch.equal(m1, ms) and torch.equal(p1, ps) and torch.equal(
        me, ms) and all(torch.equal(g1[n], gs[n]) for n in g1),
        "tile_wd_step: fused != split (or eval margins differ)")
    mb, dvb_, gb = tt.wd_boundary_plain(pulls, labels, mask, mlp, "logit")
    berr = (ms.double() - mb.double()).abs()
    require(bool(torch.all(berr <= 1e-5 * (1 + mb.double().abs()))),
            f"wd_boundary: margins vs plain {berr.max():.3e}")
    for n in gb:
        e = (gs[n].double() - gb[n].double()).abs().max().item()
        require(e <= 1e-4 * gb[n].abs().max().item() + 1e-6,
                f"wd_boundary: {n} vs plain {e:.3e}")
    note("wd_boundary", berr.max())
    mp, pp, gp = tt.fused_wd_step_plain(pw, ww, labels, mask, mlp, spec,
                                        "logit")
    merr = (m1.double() - mp.double()).abs()
    require(bool(torch.all(merr <= 1e-5 * (1 + mp.double().abs()))),
            f"tile_wd_step: margins vs plain {merr.max():.3e}")
    dvp = tt.wd_boundary_plain(tt.forward_pulls_plain(pw, ww, spec), labels,
                               mask, mlp, "logit")[1]
    gtol = (chan_tol(torch, kb, kr, dvs, nb)
            + flip_tol(torch, kb, kr, dvs, dvp, nb))
    gerr = (p1.double() - pp.double()).abs()
    require(bool(torch.all(gerr <= gtol)),
            f"tile_wd_step: pushes vs plain {gerr.max():.3e}")
    for n in gp:
        e = (g1[n].double() - gp[n].double()).abs().max().item()
        require(e <= 1e-4 * gp[n].abs().max().item() + 1e-6,
                f"tile_wd_step: {n} vs plain {e:.3e}")
    note("tile_wd_step", max(merr.max().item(), gerr.max().item()))
    print(f"tile_wd_step: fused = split bitwise (margins, pushes, every MLP "
          f"grad; eval margins too), bitwise repeat ok; vs plain margins "
          f"{merr.max():.3e} (tolerance 1e-5*(1+|m|)), pushes "
          f"{gerr.max():.3e} (reorder + bf16 flip bound), MLP grads within "
          f"1e-4 of each leaf's largest entry")


def oracle_taps(torch, store, oblocks, deep):
    """Wrap ``store``'s train and eval steps so that they record, as numpy,
    the table rows each train step reads, before and after the step, with
    the MLP and its accumulator, and the rows validation reads, at the first
    eval step of each pass. ``multi_oracle`` replays every step from these
    states. Returns the record."""
    ubs = [np.unique(np.concatenate([b[0], b[2]])) for b in oblocks]
    taps = {"train": [], "eval": [], "ubs": ubs,
            "uall": np.unique(np.concatenate(ubs))}
    train, evals = store.tile_train_step, store.tile_eval_step

    def grab(rows):
        idx = torch.from_numpy(rows).to(store.slots.device)
        dense = None
        if deep:
            dense = tuple({n: v.cpu().numpy().astype(np.float64)
                           for n, v in tree.items()}
                          for tree in (store.mlp, store.mlp_accum))
        return store.slots[idx].cpu().numpy(), dense

    def tile_train_step(block, info, tau=0.0):
        i = len(taps["train"]) % len(ubs)
        pre = grab(ubs[i])
        ticket = train(block, info, tau)
        taps["train"].append((i, pre, grab(ubs[i])))
        return ticket

    def tile_eval_step(block, info):
        if len(taps["eval"]) * len(ubs) < len(taps["train"]):
            taps["eval"].append(grab(taps["uall"]))
        return evals(block, info)

    store.tile_train_step = tile_train_step
    store.tile_eval_step = tile_eval_step
    return taps


def multi_oracle(taps, blocks, k, rows, auc_np, deep):
    """Float64 numpy oracle of the FM (FMConfig defaults, logit loss) or
    wide&deep (WideDeepConfig defaults) train steps and validation passes,
    replayed from the port's own state: each step starts from the table
    rows, MLP and accumulator the port held before it (``oracle_taps``),
    and each validation pass from the port's table after that pass. So the
    check holds one step's arithmetic, not a trajectory. A free-running
    oracle drifts: a push value within an f32 rounding of a bf16 boundary
    rounds differently on the two sides, and the MLP spreads that one
    step's difference to every row, which moved wide&deep's validation
    accuracy 1.5e-4 after one pass. The pull table and the push values round
    to bf16 where the kernels do (tile pairs; spill pairs carry f32), and a
    wide&deep row whose ReLU input lies within f32 error of 0 takes the
    side the port's updated table shows (``relu_sides``). Only touched
    buckets change, so only their rows are updated. Returns per-pass
    train objv per example and validation objv, pooled AUC and mean block
    accuracy, and the per-step deviations of the port's updated state."""
    lr, beta = 0.05, 1.0
    l2_v = 1e-5 if deep else 1e-4
    nblk = len(blocks)
    index = {}

    def pulls(th32, bi, ub, key):
        pb, pr, sb, sr, _ = blocks[bi]
        if (bi, key) not in index:
            index[(bi, key)] = (np.searchsorted(ub, pb),
                                np.searchsorted(ub, sb))
        ip, is_ = index[(bi, key)]
        th = th32[:, :1 + k].astype(np.float64)
        wp = th if deep else np.concatenate(
            [th, np.sum(th[:, 1:] ** 2, 1, keepdims=True)], 1)
        w32 = wp.astype(np.float32)
        wb = bf16(w32).astype(np.float64)
        P, Pabs = (np.stack([np.bincount(pr, weights=f(wb[ip, c]),
                                         minlength=rows)
                             + np.bincount(sr, weights=f(w32[is_, c].astype(
                                 np.float64)), minlength=rows)
                             for c in range(wp.shape[1])], 1)
                   for f in (lambda x: x, np.abs))
        return P, Pabs, ip, is_

    def forward(P, mlp):
        if not deep:
            s = P[:, 1:1 + k]
            return P[:, 0] + 0.5 * (np.sum(s * s, 1) - P[:, 1 + k]), None
        hs = [P[:, 1:]]
        L = len(mlp) // 2
        for i in range(L):
            z = hs[-1] @ mlp[f"W{i}"] + mlp[f"b{i}"]
            hs.append(np.maximum(z, 0) if i + 1 < L else z)
        return P[:, 0] + hs[-1][:, 0], hs

    def backward(d, hs, masks, mlp):
        """The MLP vjp from the duals d with the ReLU masks given per
        hidden layer: (g_pooled, MLP grads, the grads' Σ|terms|)."""
        gz, gm, gabs = d[:, None], {}, {}
        for i in range(len(mlp) // 2 - 1, -1, -1):
            gm[f"W{i}"] = hs[i].T @ gz
            gm[f"b{i}"] = gz.sum(0)
            gabs[f"W{i}"] = np.abs(hs[i]).T @ np.abs(gz)
            gabs[f"b{i}"] = np.abs(gz).sum(0)
            gh = gz @ mlp[f"W{i}"].T
            gz = gh * masks[i] if i > 0 else gh
        return gz, gm, gabs

    def pushes(dv, ip, is_, pr, sr, n):
        """Per-bucket push channels: tile pairs add the bf16-rounded values,
        spill pairs the f32 ones. Also returns the bf16 rows."""
        d32 = dv.astype(np.float32)
        db = bf16(d32).astype(np.float64)
        return np.stack([np.bincount(ip, weights=db[pr, c], minlength=n)
                         + np.bincount(is_, weights=d32[sr, c].astype(
                             np.float64), minlength=n)
                         for c in range(dv.shape[1])], 1), db

    def adagrad(T0, pu):
        """The table rows [θ, cg] after the AdaGrad step on push rows pu."""
        th, cg = T0[:, :1 + k], T0[:, 1 + k:]
        v = th[:, 1:]
        g_v = pu[:, 1:1 + k] + l2_v * v
        if not deep:
            g_v = g_v - v * pu[:, :1]
        g = np.concatenate([pu[:, :1], g_v], 1)
        c_new = np.sqrt(cg * cg + g * g)
        return np.concatenate([th - lr / (beta + c_new) * g, c_new], 1)

    def relu_sides(d, hs, Pabs, masks, mlp, real, dv, push, blk, pre, post):
        """Rows with a hidden pre-activation within the port's f32 error of
        0: the port's ReLU may take the other side there, which changes the
        row's pooled gradient and MLP terms outright. That error is at most
        1e-5 of Σ|terms| for the pooled sums (39 terms at 2^-24 each) and
        for each layer's dot, plus what the layer's input carried through
        |W|. For each such row,
        try every side of its ambiguous units (up to 4 of them; past that,
        none, each alone and all) and keep, in ``masks``, the side whose
        updated table rows for the row's buckets lie closest to the port's.
        Returns (ambiguous rows, rows that took another side)."""
        ip, is_, pr, sr, po, ps, so, ss = blk
        amb, e = [None], 1e-5 * Pabs[:, 1:]
        for i in range(1, len(masks)):
            W, b = np.abs(mlp[f"W{i - 1}"]), np.abs(mlp[f"b{i - 1}"])
            e = 1e-5 * (np.abs(hs[i - 1]) @ W + b) + e @ W
            amb.append(np.abs(hs[i - 1] @ mlp[f"W{i - 1}"]
                              + mlp[f"b{i - 1}"]) <= e)
        rows_a = np.nonzero(real & (d != 0) & np.any(
            [a.any(1) for a in amb[1:]], 0))[0]
        flipped = 0
        for r in rows_a:
            units = [(i, u) for i in range(1, len(masks))
                     for u in np.nonzero(amb[i][r])[0]]
            if len(units) <= 4:
                cands = [[x for j, x in enumerate(units) if s >> j & 1]
                         for s in range(1 << len(units))]
            else:
                cands = [[]] + [[x] for x in units] + [units]
            jt, js = po[ps[r]:ps[r + 1]], so[ss[r]:ss[r + 1]]
            bk = np.unique(np.concatenate([ip[jt], is_[js]]))
            at_t = np.searchsorted(bk, ip[jt])
            at_s = np.searchsorted(bk, is_[js])
            a32 = dv[r].astype(np.float32)
            best = None
            for flips in cands:
                ms_ = [None] + [m[r:r + 1].copy() for m in masks[1:]]
                for i, u in flips:
                    ms_[i][0, u] = not ms_[i][0, u]
                g_r = backward(d[r:r + 1], [h[r:r + 1] for h in hs], ms_,
                               mlp)[0][0]
                c32 = np.concatenate([[d[r]], g_r, [1.0]]).astype(np.float32)
                pu = push[bk].copy()
                np.add.at(pu, at_t, (bf16(c32).astype(np.float64)
                                     - bf16(a32).astype(np.float64)))
                np.add.at(pu, at_s, c32.astype(np.float64)
                          - a32.astype(np.float64))
                Tc = adagrad(pre[bk].astype(np.float64), pu)
                score = float(np.sum(np.abs(post[bk] - Tc) / (1 + np.abs(Tc))))
                if best is None or score < best[0]:
                    best = (score, flips)
            for i, u in best[1]:
                masks[i][r, u] = not masks[i][r, u]
            flipped += bool(best[1])
        return len(rows_a), flipped

    log = []
    dev = {"rows_max": 0.0, "rows_out": 0, "rows_n": 0, "rows_over": 0.0,
           "relu_rows": 0, "relu_flipped": 0, "mlp_rel": 0.0,
           "mlp_over": 0.0}
    for p in range(len(taps["train"]) // nblk):
        objv, n = 0.0, 0
        for bi, (pre, dense), (post, dense_post) in \
                taps["train"][p * nblk:(p + 1) * nblk]:
            ub, lab = taps["ubs"][bi], blocks[bi][4]
            pb, pr, sb, sr, _ = blocks[bi]
            mlp, acc = dense if deep else ({}, {})
            P, Pabs, ip, is_ = pulls(pre, bi, ub, "train")
            m, hs = forward(P, mlp)
            real = lab != 255
            y = np.where(lab == 1, 1.0, -1.0)
            objv += float(np.logaddexp(0, -y * m)[real].sum())
            n += int(real.sum())
            d = np.where(real, -y / (1 + np.exp(y * m)), 0.0)
            if deep:
                masks = [None] + [hs[i] > 0 for i in range(1, len(mlp) // 2)]
                gz = backward(d, hs, masks, mlp)[0]
                dv = np.concatenate([d[:, None], gz, real[:, None]], 1)
                push = pushes(dv, ip, is_, pr, sr, len(ub))[0]
                if (bi, "rows") not in index:
                    po = np.argsort(pr, kind="stable")
                    so = np.argsort(sr, kind="stable")
                    index[(bi, "rows")] = (
                        po, np.searchsorted(pr[po], np.arange(rows + 1)),
                        so, np.searchsorted(sr[so], np.arange(rows + 1)))
                n_amb, n_flip = relu_sides(
                    d, hs, Pabs, masks, mlp, real, dv, push,
                    (ip, is_, pr, sr) + index[(bi, "rows")], pre, post)
                dev["relu_rows"] += n_amb
                dev["relu_flipped"] += n_flip
                gz, gm, gabs = backward(d, hs, masks, mlp)
                dv = np.concatenate([d[:, None], gz, real[:, None]], 1)
            else:
                dv = np.concatenate([d[:, None], d[:, None] * P[:, 1:1 + k],
                                     real[:, None]], 1)
            push, db = pushes(dv, ip, is_, pr, sr, len(ub))
            T = pre.astype(np.float64)
            t = push[:, 1 + k] > 0
            T[t] = adagrad(T[t], push[t])
            # every entry within 1e-5·(1 + |x|) of the oracle, except where
            # a push term rounded to the neighbouring bf16 step on one side:
            # at most 2^-7·|term| each, so a bucket's channel moves by at
            # most F = 2^-7·Σ|terms| (FM's g_v also by |v|·F of the w
            # channel), and AdaGrad passes that on to cg and, times
            # 2·α/β < 1, to the weights. Wide&deep rows take the ReLU side
            # the port took (relu_sides), so no entry is exempt.
            err = np.abs(post - T)
            base = 1e-5 * (1 + np.abs(T))
            bad = np.any(err > base, 1)
            dev["rows_max"] = max(dev["rows_max"],
                                  float((err / (1 + np.abs(T))).max()))
            dev["rows_out"] += int(np.sum(err > base))
            dev["rows_n"] += err.size
            if bad.any():
                sel = bad[ip]
                F = 2.0 ** -7 * np.stack(
                    [np.bincount(ip[sel], weights=np.abs(db[pr[sel], c]),
                                 minlength=len(ub)) for c in range(1 + k)],
                    1)[bad]
                if not deep:
                    F[:, 1:] += np.abs(pre[bad, 1:1 + k]) * F[:, :1]
                dev["rows_over"] = max(dev["rows_over"], float(
                    (err[bad] / (base[bad] + np.concatenate([F, F], 1)))
                    .max()))
            # the MLP grads are f32 sums over the rows, 512-row chunks then
            # the chunks: within (512 + rows/512)·2^-24 of Σ|terms| each,
            # doubled for the terms' own roundings, plus 1e-6 of it for
            # the f32 inputs; AdaGrad passes that on to the accumulator and,
            # times 2·α_dense/β < 1, to the parameters
            rel_g = 2 * (512 + rows / 512) * 2.0 ** -24 + 1e-6
            for nm in mlp:
                a_new = np.sqrt(acc[nm] ** 2 + gm[nm] ** 2)
                want = (mlp[nm] - 0.01 / (beta + a_new) * gm[nm], a_new)
                for got, w in zip((dense_post[0][nm], dense_post[1][nm]),
                                  want):
                    e = np.abs(got - w)
                    dev["mlp_rel"] = max(dev["mlp_rel"], float(
                        e.max() / (np.abs(w).max() + 1e-30)))
                    dev["mlp_over"] = max(dev["mlp_over"], float(
                        (e / (rel_g * gabs[nm] + 1e-7 * np.abs(w)
                              + 1e-30)).max()))
        S = taps["eval"][p][0]
        ms, ys, accs, vobjv = [], [], [], 0.0
        for bi in range(nblk):
            lab = blocks[bi][4]
            real = lab != 255
            m = forward(pulls(S, bi, taps["uall"], "val")[0],
                        taps["eval"][p][1][0] if deep else {})[0][real]
            yv = (lab[real] == 1).astype(np.float64)
            vobjv += float(np.logaddexp(0, -(2 * yv - 1) * m).sum())
            accs.append(np.mean((m > 0) == (yv > 0.5)))
            ms.append(m)
            ys.append(yv)
        log.append({"train_objv": objv / n, "val_objv": vobjv / n,
                    "val_auc": auc_np(np.concatenate(ys),
                                      np.concatenate(ms)),
                    "val_acc": float(np.mean(accs))})
    return log, dev


def multi_training(torch, tt, spec, rng, n_rows, w_np, auc_np, dev):
    """FM (dim 8) and wide&deep (dim 16, hidden 64,32) trained for PASSES
    passes with validation on a spill file and an ovf_cap=0 file: through
    each model's ``main`` on the fused resolution, then in process on
    ``fused`` and ``split``. Requires one launch per block and pass on the
    resolved kernel, the eval kernels on every validation block, fused and
    split trained state bitwise equal, and the per-pass metrics of a fused
    run on the float64 oracle. Returns the launches of all these runs."""
    from wormhole_tpu_torch.learners.async_sgd import AsyncSGD
    from wormhole_tpu_torch.models import fm, wide_deep
    from wormhole_tpu_torch.utils.config import load_config
    counted = multi_counted(tt)

    def counts():
        return dict(zip(MULTI_NAMES, (f.launches for f in counted)))

    def reset():
        for f in counted:
            f.launches = 0

    nblk = BLOCKS * PASSES
    hidden = ",".join(str(h) for h in WD_HIDDEN)
    models = {
        "fm": (fm, lambda kern: fm.FMStore(fm.FMConfig(
            num_buckets=NB, dim=FM_DIM, tile_step_kernel=kern), dev),
            [f"dim={FM_DIM}"], "fm_boundary", "tile_fm_step", "spill"),
        "wd": (wide_deep, lambda kern: wide_deep.WideDeepStore(
            wide_deep.WideDeepConfig(num_buckets=NB, dim=WD_DIM,
                                     hidden=WD_HIDDEN,
                                     tile_step_kernel=kern), dev),
            [f"dim={WD_DIM}", f"hidden={hidden}"], "wd_boundary",
            "tile_wd_step", "ovf0"),
    }

    def expect(model, kind, kernel):
        _, _, _, bnd, step, _ = models[model]
        fused = kernel == "fused" and not (model == "wd" and kind == "spill")
        want = {"tile_pulls": nblk, bnd: nblk}        # validation
        if fused:
            want[step] = nblk
        else:
            want.update({"tile_pulls": 2 * nblk, bnd: 2 * nblk,
                         "tile_pushes": nblk})
        return {n: want.get(n, 0) for n in MULTI_NAMES}, \
            "fused" if fused else "split"

    total = {n: 0 for n in MULTI_NAMES}
    train_rows = PASSES * n_rows
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as work:
        t0 = phase("FM and wide&deep: write a spill file and an ovf_cap=0 "
                   "file")
        files = write_train_files(rng, work, spec, n_rows, w_np, "multi_")
        oblocks = {k: oracle_blocks(torch, tt, f, spec, dev)
                   for k, f in files.items()}
        print(f"spill pairs {sum(len(b[2]) for b in oblocks['spill'])}; "
              f"{time.perf_counter() - t0:.1f} s")
        base = ["data_format=crec2", f"num_buckets={NB}",
                f"max_data_pass={PASSES}", "disp_itv=1e12"]
        for model, (mod, make, extra, _, _, ofile) in models.items():
            t0 = phase(f"{model}: train through main and AsyncSGD.run")
            reset()
            t1 = time.perf_counter()
            rc = mod.main(base + extra + [f"train_data={files[ofile]}",
                                          f"val_data={files[ofile]}"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            got = counts()
            want, _ = expect(model, ofile, "fused")
            require(rc == 0 and got == want,
                    f"{model} main: rc {rc}, launches {got}, want {want}")
            for n in MULTI_NAMES:
                total[n] += got[n]
            print(f"{model} main (auto, {ofile} file): {got}  {dt:.1f} s, "
                  f"{train_rows / dt:.0f} train examples/s over the run "
                  f"(set-up and validation included)")
            deep = model == "wd"

            def train_run(kind, kernel, tapped=False):
                reset()
                store = make(kernel)
                taps = (oracle_taps(torch, store, oblocks[kind], deep)
                        if tapped else None)
                cfg = load_config(None, base + [f"train_data={files[kind]}",
                                                f"val_data={files[kind]}"])
                app = AsyncSGD(cfg, dev, store=store)
                t1 = time.perf_counter()
                app.run()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t1
                got = counts()
                want, resolved = expect(model, kind, kernel)
                rec = [r for key, r in store._tile_kernel.items()
                       if key[1] == "train"][0]
                tag = f"{model} {kind}/{kernel}" + (" (oracle taps)"
                                                    if tapped else "")
                require(got == want and rec[0] == resolved,
                        f"{tag}: launches {got} (want {want}), resolved "
                        f"{rec}")
                for n in MULTI_NAMES:
                    total[n] += got[n]
                state = [store.slots]
                if deep:
                    state += [store.mlp[n] for n in sorted(store.mlp)]
                    state += [store.mlp_accum[n] for n in sorted(store.mlp)]
                why = rec[1] or "no split reason"
                print(f"{tag}: resolved {rec[0]!r} ({why}); launches "
                      f"{ {n: c for n, c in got.items() if c} }; {dt:.1f} s"
                      + ("" if tapped else f", {train_rows / dt:.0f} train "
                         "examples/s over the run (validation included)"))
                return state, app.pass_log, taps

            trained = {(kind, kernel): train_run(kind, kernel)[0]
                       for kind in ("spill", "ovf0")
                       for kernel in ("fused", "split")}
            for kind in ("spill", "ovf0"):
                a, b = trained[(kind, "fused")], trained[(kind, "split")]
                require(all(torch.equal(x, y) for x, y in zip(a, b)),
                        f"{model} {kind}: fused and split trained state "
                        "differ")
            print(f"{model}: fused and split trained state bitwise equal on "
                  "both files" + (" (slots, MLP and its accumulator)"
                                  if deep else " (slots)"))
            # the oracle's run: fused on the model's file, its steps tapped
            state, log, taps = train_run(ofile, "fused", tapped=True)
            require(all(torch.equal(x, y) for x, y in zip(
                state, trained[(ofile, "fused")])),
                f"{model}: the tapped run's state differs from the fused run")
            del trained, state
            t1 = time.perf_counter()
            log_or, dev_or = multi_oracle(
                taps, oblocks[ofile], FM_DIM if model == "fm" else WD_DIM,
                spec.block_rows, auc_np, deep)
            del taps
            # The oracle replays each step from the port's own state, so
            # the two differ by one step's f32 vs float64 arithmetic: about
            # 1e-6 relative on a margin, which moves a sum over 3e5 rows by
            # far less than 1e-4 relative, and moves accuracy (AUC) only by
            # the few rows within ~1e-6 of 0 (of another row). The updated
            # state is held entry by entry (multi_oracle): 1e-5·(1 + |x|),
            # but for the rare bf16 flip of a push term, inside its bound;
            # and the MLP within its f32 sum bound. A wide&deep row whose
            # ReLU sits within f32 rounding of 0 may take either side in the
            # port, which changes its terms outright: the oracle takes the
            # side the port's table shows (multi_oracle's relu_sides), so
            # those rows too are held to these bounds.
            for p_, (a, b) in enumerate(zip(log, log_or)):
                for key in ("train_objv", "val_objv"):
                    require(abs(a[key] - b[key]) <= 1e-4 * abs(b[key]),
                            f"{model} pass {p_} {key} {a[key]} vs {b[key]}")
                for key in ("val_auc", "val_acc"):
                    require(abs(a[key] - b[key]) <= 1e-4,
                            f"{model} pass {p_} {key} {a[key]} vs {b[key]}")
                print(f"{model} {ofile} pass {p_}: " + "  ".join(
                    f"{key} {a[key]:.6f} (oracle {b[key]:.6f})"
                    for key in b))
            out = dev_or["rows_out"] / dev_or["rows_n"]
            require(len(log) == len(log_or) == PASSES
                    and dev_or["rows_over"] <= 1 and dev_or["mlp_over"] <= 1,
                    f"{model}: updated state vs oracle {dev_or}")
            print(f"{model} updated table rows vs oracle: largest "
                  f"|d|/(1+|x|) {dev_or['rows_max']:.3e}, "
                  f"{dev_or['rows_out']} of {dev_or['rows_n']} entries "
                  f"({out:.2e}) past 1e-5*(1+|x|), those at "
                  f"{dev_or['rows_over']:.3f} of their bf16-flip bound"
                  + (f"; {dev_or['relu_rows']} ReLU-ambiguous rows over the "
                     f"steps, {dev_or['relu_flipped']} of them on the other "
                     f"side in the port; MLP and accumulator "
                     f"{dev_or['mlp_rel']:.3e} of the leaf's largest entry, "
                     f"{dev_or['mlp_over']:.3f} of the f32 sum bound"
                     if deep else ""))
            print(f"{model} oracle {time.perf_counter() - t1:.1f} s; phase "
                  f"{time.perf_counter() - t0:.1f} s")
            del log, log_or
    return total


def multi_timing(torch, tt, spec, blocks, rng, dev, smi, launches, errs):
    """Per full-width block, with CUDA events: each new kernel beside its
    bound, its plain version and (for #4/#5) the one-call yardstick
    ``torch.sparse.mm``; the fused steps beside their split chains; and the
    whole FM and wide&deep train step (dense AdaGrad included). Returns
    the kernels' entries of the ``{"kernels": [...]}`` line."""
    rows, nb = spec.block_rows, spec.nb
    pw = blocks["uniform"]["pw"]
    bucket, row, valid = tt.decode_pairs(pw, spec)
    n_pairs = int(valid.sum().item())
    pw_b = pw.numel() * 4

    def reach(ch):
        """The pull table's bytes this block's pairs reach at ch channels;
        the steps read the pair words once and write the dense pushes."""
        return table_bytes(torch, bucket[valid], ch)

    def csr(keys, idx, n, m):
        order = torch.argsort(keys, stable=True)
        k_, i_ = keys[order], idx[order]
        crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(k_, minlength=n), 0)
        return torch.sparse_csr_tensor(crow, i_, torch.ones_like(
            i_, dtype=torch.float32), size=(n, m))

    csr_f = csr(row[valid], bucket[valid], rows, nb)
    csr_b = csr(bucket[valid], row[valid], nb, rows)
    labels = torch.from_numpy((rng.random(rows) < 0.25).astype(
        np.float32)).to(dev)
    mask = torch.ones(rows, device=dev)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    out = []

    def entry(name, src, replaces, ker, plain, lib, nbytes, nops, chain=None,
              note=""):
        k_ms = time_ms(torch, ker)
        p_ms = time_ms(torch, plain)
        l_ms = time_ms(torch, lib) if lib is not None else None
        k_ms2 = time_ms(torch, ker)
        b_by = "bytes" if nbytes / PEAK_BYTES_S >= nops / PEAK_F32_S \
            else "operations"
        b_ms = max(nbytes / PEAK_BYTES_S, nops / PEAK_F32_S) * 1e3
        line = (f"{name}{note} {k_ms:.4f} ms (again {k_ms2:.4f})  plain "
                f"{p_ms:.4f} ms  bound {b_ms:.4f} ms ({nbytes / 1e6:.2f} MB,"
                f" {nops / 1e9:.3f} GFLOP; by {b_by})")
        if l_ms is not None:
            line += f"  torch.sparse.mm {l_ms:.4f} ms"
        if chain is not None:
            line += f"  split chain {time_ms(torch, chain):.4f} ms"
        print(line + f"  card {smi}")
        return {"name": name, "route": "cuda",
                "source": f"wormhole_tpu_torch/ops/csrc/{src}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms}

    # #4 and #5 at the FM widths (printed) and the wide&deep widths (kept)
    for ch_in, ch_out in ((FM_DIM + 2, FM_DIM + 2),
                          (WD_DIM + 1, WD_DIM + 2)):
        w = f32(rng.standard_normal((nb, ch_in)) * 0.1)
        wb = w.to(torch.bfloat16).float()
        dv = f32(rng.standard_normal((rows, ch_out)) * 0.4)
        dvb = dv.to(torch.bfloat16).float()
        lib = torch.sparse.mm(csr_f, wb)
        require(bool(torch.all((lib - tt.forward_pulls(pw, w, spec)).abs()
                               <= 1e-5 * (1 + lib.abs()))),
                "sparse.mm yardstick disagrees with tile_pulls")
        e1 = entry("tile_pulls", "tile_multi.cu",
                   "wormhole_tpu/ops/tilemm.py:703",
                   lambda: tt.forward_pulls(pw, w, spec),
                   lambda: tt.forward_pulls_plain(pw, w, spec),
                   lambda: torch.sparse.mm(csr_f, wb),
                   pw_b + reach(ch_in) + rows * ch_in * 4,
                   n_pairs * ch_in, note=f" ch {ch_in}")
        per = launch_ms(torch, lambda: tt.forward_pulls(pw, w, spec))
        parts = {p_: sum(v for k_, v in per.items() if p_ in k_)
                 for p_ in ("pull_counts", "pull_row_prefix", "pull_index",
                            "pull_segsum")}
        if sum(parts.values()) > 0:
            print(f"tile_pulls ch {ch_in} launches (torch.profiler device "
                  f"ms per call): row index "
                  f"{sum(parts.values()) - parts['pull_segsum']:.4f} ("
                  + ", ".join(f"{k_} {v:.4f}" for k_, v in parts.items()
                              if k_ != "pull_segsum")
                  + f"), segmented sum {parts['pull_segsum']:.4f}  card "
                  f"{smi}")
        else:
            print(f"tile_pulls ch {ch_in} launches: not measured (the "
                  "profiler reported no device time)")
        e2 = entry("tile_pushes", "tile_multi.cu",
                   "wormhole_tpu/ops/tilemm.py:741",
                   lambda: tt.backward_pushes(pw, dv, spec),
                   lambda: tt.backward_pushes_plain(pw, dv, spec),
                   lambda: torch.sparse.mm(csr_b, dvb),
                   pw_b + rows * ch_out * 4 + nb * ch_out * 4,
                   n_pairs * ch_out, note=f" ch {ch_out}")
        del w, wb, dv, dvb, lib
    out += [e1, e2]
    # the FM step and its boundary at k 8
    k = FM_DIM
    v = rng.standard_normal((nb, k)) * 0.1
    wf = f32(np.concatenate([rng.standard_normal((nb, 1)) * 0.1, v,
                             np.sum(v * v, 1, keepdims=True)], 1))
    del v
    pulls = tt.forward_pulls(pw, wf, spec)
    ch = k + 2
    out.append(entry("fm_boundary", "tile_fm_step.cu",
                     "wormhole_tpu/ops/tilemm.py:1470",
                     lambda: tt.fm_boundary(pulls, labels, mask, k, "logit"),
                     lambda: tt.fm_boundary_plain(pulls, labels, mask, k,
                                                  "logit"),
                     None, rows * (2 * ch + 3) * 4, rows * (3 * k + 12)))
    out.append(entry(
        "tile_fm_step", "tile_fm_step.cu", "wormhole_tpu/ops/tilemm.py:1546",
        lambda: tt.fused_fm_step(pw, wf, labels, mask, spec, k, "logit"),
        lambda: tt.fused_fm_step_plain(pw, wf, labels, mask, spec, k,
                                       "logit"),
        None, pw_b + reach(ch) + nb * ch * 4 + 3 * rows * 4,
        2 * n_pairs * ch + rows * (3 * k + 12),
        chain=lambda: tt.backward_pushes(pw, tt.fm_boundary(
            tt.forward_pulls(pw, wf, spec), labels, mask, k, "logit")[1],
            spec)))
    del wf, pulls
    # the wide&deep step and its boundary at k 16, hidden 64,32
    k = WD_DIM
    ww = f32(rng.standard_normal((nb, 1 + k)) * 0.1)
    sizes = [k] + list(WD_HIDDEN) + [1]
    mlp = {}
    for i, (a_, b_) in enumerate(zip(sizes[:-1], sizes[1:])):
        mlp[f"W{i}"] = f32(rng.standard_normal((a_, b_)) * np.sqrt(2 / a_))
        mlp[f"b{i}"] = f32(np.zeros(b_))
    macs = sum(a_ * b_ for a_, b_ in zip(sizes[:-1], sizes[1:]))
    n_params = macs + sum(sizes[1:])
    mlp_flops = rows * 2 * macs * 3          # forward, input and weight vjp
    pulls = tt.forward_pulls(pw, ww, spec)
    out.append(entry("wd_boundary", "tile_wd_step.cu",
                     "wormhole_tpu/ops/tilemm.py:1622",
                     lambda: tt.wd_boundary(pulls, labels, mask, mlp, k,
                                            "logit"),
                     lambda: tt.wd_boundary_plain(pulls, labels, mask, mlp,
                                                  "logit"),
                     None, rows * ((1 + k) + (k + 2) + 3) * 4, mlp_flops))
    out.append(entry(
        "tile_wd_step", "tile_wd_step.cu", "wormhole_tpu/ops/tilemm.py:1705",
        lambda: tt.fused_wd_step(pw, ww, labels, mask, mlp, spec, k,
                                 "logit"),
        lambda: tt.fused_wd_step_plain(pw, ww, labels, mask, mlp, spec,
                                       "logit"),
        None, pw_b + reach(1 + k) + nb * (k + 2) * 4 + 3 * rows * 4
        + 2 * 4 * n_params,
        n_pairs * (2 * k + 3) + mlp_flops,
        chain=lambda: tt.backward_pushes(pw, tt.wd_boundary(
            tt.forward_pulls(pw, ww, spec), labels, mask, mlp, k,
            "logit")[1], spec)))
    del ww, pulls
    # the whole train step of each store, the dense AdaGrad sweep included
    from wormhole_tpu_torch.data.crec import CRec2Info
    from wormhole_tpu_torch.models import fm, wide_deep
    info = CRec2Info(nnz=NNZ, block_rows=rows, total_rows=rows, nb=nb,
                     subblocks=spec.subblocks, cap=spec.cap, ovf_cap=0)
    blk = {"pw": pw, "labels": torch.ones(rows, dtype=torch.uint8,
                                          device=dev)}
    for name, store in (
            ("FM", fm.FMStore(fm.FMConfig(num_buckets=nb, dim=FM_DIM,
                                          tile_step_kernel="fused"), dev)),
            ("wide&deep", wide_deep.WideDeepStore(wide_deep.WideDeepConfig(
                num_buckets=nb, dim=WD_DIM, hidden=WD_HIDDEN,
                tile_step_kernel="fused"), dev))):
        step_ms = time_ms(torch, lambda: store.tile_train_step(blk, info),
                          reps=5, inner=3)
        print(f"{name} train step (fused kernel + torch AdaGrad over the "
              f"{tuple(store.slots.shape)} f32 table, "
              f"{store.slots.numel() * 4 / 1e6:.0f} MB): {step_ms:.3f} ms "
              f"per block  card {smi}")
        del store
    return out


def write_train_files(rng, work, spec, n_rows, w_np, tag=""):
    """A 4-block spill file (ovf_cap 1024, a hot key in block 1) and a
    4-block ovf_cap=0 file: keys from a 2^20-key vocabulary, so a key
    recurs across rows (about 12 times a file) and training has something
    to learn, and labels drawn from the linear model ``w_np``."""
    from wormhole_tpu_torch.data.crec import CRec2Writer
    from wormhole_tpu_torch.data.hashing import fold_keys32
    files = {}
    vocab = rng.integers(0, 0xFFFFFFFF, size=VOCAB, dtype=np.uint32)
    for kind, oc in (("spill", OVF_CAP), ("ovf0", 0)):
        keys = vocab[rng.integers(0, VOCAB, size=(n_rows, NNZ))]
        keys[rng.random((n_rows, NNZ)) < 0.1] = 0xFFFFFFFF
        if oc:
            keys[spec.block_rows:spec.block_rows + HOT_ROWS, 0] = \
                np.uint32(0xC0FFEE)
        rr, cc = np.nonzero(keys != 0xFFFFFFFF)
        pair_b = fold_keys32(keys[rr, cc], NB)
        true_m = np.bincount(rr, weights=w_np[pair_b].astype(np.float64),
                             minlength=n_rows)
        lab = (rng.random(n_rows) < 1 / (1 + np.exp(-true_m))
               ).astype(np.uint8)
        files[kind] = os.path.join(work, f"{tag}{kind}.crec2")
        with CRec2Writer(files[kind], nnz=NNZ, nb=NB, subblocks=SUBBLOCKS,
                         ovf_cap=oc) as wr:
            wr.append(keys, lab)
    return files


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test runs on a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wormhole_tpu_torch.data.crec import (CRec2Writer, block_tensors,
                                              default_cap, encode_tile_block,
                                              iter_packed2, read_header2)
    from wormhole_tpu_torch.data.hashing import fold_keys32
    from wormhole_tpu_torch.learners import async_sgd
    from wormhole_tpu_torch.learners.handles import FTRLHandle
    from wormhole_tpu_torch.learners.store import ShardedStore, StoreConfig
    from wormhole_tpu_torch.ops import _ext
    from wormhole_tpu_torch.ops import tilemm as tt
    from wormhole_tpu_torch.ops.metrics import auc_np
    from wormhole_tpu_torch.utils.config import Config, load_config

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # -- 1. environment ------------------------------------------------------
    t0 = phase("environment")
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  count {torch.cuda.device_count()}")
    print("nvcc:", sh([_ext.nvcc_path(), "--version"]).splitlines()[-1])
    print("nvidia-smi:", smi)

    # -- 2. build ------------------------------------------------------------
    t0 = phase("build kernels from ops/csrc")
    logs = _ext.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")

    # -- 3. kernel vs plain at full width -------------------------------------
    t0 = phase("tile_fwd vs plain at full width")
    rng = np.random.default_rng(args.seed)
    cap = default_cap(NNZ, NB)
    spec = tt.make_spec(NB, SUBBLOCKS, cap)
    print(f"spec {spec}  pw {spec.pairs_shape} u32 "
          f"{np.prod(spec.pairs_shape) * 4 / 1e6:.1f} MB")
    w_np = (rng.standard_normal(NB) * 0.1).astype(np.float32)
    w_np[rng.random(NB) < 0.3] = 0.0           # an L1-sparse FTRL model
    wd = torch.from_numpy(w_np).to(dev)
    max_err = 0.0
    uniform_block = spill_block = None
    for kind in ("uniform", "spill"):
        keys = make_keys(rng, spec.block_rows)
        if kind == "spill":
            keys[:HOT_ROWS, 0] = np.uint32(0xC0FFEE)
        pw, ob, orow, n_ovf = encode_tile_block(keys, NB, spec, OVF_CAP)
        require((n_ovf == 0) if kind == "uniform" else 1 <= n_ovf <= OVF_CAP,
                f"{kind} block has {n_ovf} spill pairs")
        blk = {k: v.to(dev) for k, v in block_tensors(
            {"pw": pw, "ovf_b": ob, "ovf_r": orow}).items()}
        a = tt.forward_margins(blk["pw"], wd, spec, blk["ovf_b"],
                               blk["ovf_r"])
        b = tt.forward_margins(blk["pw"], wd, spec, blk["ovf_b"],
                               blk["ovf_r"])
        plain = (tt.forward_margins_plain(blk["pw"], wd, spec)
                 + tt.spill_margin_rows(wd, blk["ovf_b"], blk["ovf_r"], spec))
        # a second word-order forward: the pulls' row index and segmented
        # sum at one channel
        pulls1 = tt.forward_pulls(blk["pw"], wd.view(NB, 1), spec,
                                  blk["ovf_b"], blk["ovf_r"])[:, 0]
        torch.cuda.synchronize()
        err = (a.double() - plain.double()).abs()
        require(torch.equal(a, plain),
                f"{kind}: kernel != order-exact plain version (max err "
                f"{err.max().item():.3e})")
        require(torch.equal(a, pulls1),
                f"{kind}: kernel != forward_pulls at ch 1")
        require(torch.equal(a, b), f"{kind}: two kernel runs differ")
        max_err = max(max_err, err.max().item())
        print(f"{kind}: spill pairs {n_ovf}  kernel = order-exact plain "
              f"(+ spill grid) bitwise, = forward_pulls at ch 1 bitwise, "
              f"bitwise repeat ok")
        if kind == "uniform":
            uniform_block = blk
        else:
            spill_block = blk
    print(f"phase {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        # -- 4. data + model, then the app's main ---------------------------
        t0 = phase("write 4 crec2 blocks and a save_model model")
        n_rows = (BLOCKS - 1) * spec.block_rows + TAIL_ROWS
        keys = make_keys(rng, n_rows)
        keys[spec.block_rows:spec.block_rows + HOT_ROWS, 0] = \
            np.uint32(0xC0FFEE)
        rr, cc = np.nonzero(keys != 0xFFFFFFFF)
        pair_b = fold_keys32(keys[rr, cc], NB)
        true_m = np.bincount(rr, weights=w_np[pair_b].astype(np.float64),
                             minlength=n_rows)
        labels = (rng.random(n_rows) < 1 / (1 + np.exp(-true_m))
                  ).astype(np.uint8)
        data = os.path.join(work, "test.crec2")
        with CRec2Writer(data, nnz=NNZ, nb=NB, subblocks=SUBBLOCKS,
                         ovf_cap=OVF_CAP) as wr:
            wr.append(keys, labels)
        info = read_header2(data)
        require(info.num_blocks == BLOCKS and info.cap == cap,
                f"wrote {info}")
        model = os.path.join(work, "model")
        st = ShardedStore(StoreConfig(num_buckets=NB), FTRLHandle(), dev)
        st.slots = st.handle.warm_start(wd)
        st.save_model(model, key_fold="mix32")
        del st
        print(f"{n_rows} rows in {info.num_blocks} blocks, "
              f"{os.path.getsize(data) / 1e6:.1f} MB; model "
              f"{os.path.getsize(model + '_0') / 1e6:.1f} MB; "
              f"{time.perf_counter() - t0:.1f} s")

        t0 = phase("predict through async_sgd.main")
        pred = os.path.join(work, "pred.txt")
        tt.forward_margins.launches = 0
        rc = async_sgd.main([
            "data_format=crec2", f"num_buckets={NB}", f"model_in={model}",
            f"test_data={data}", f"pred_out={pred}", "max_data_pass=0"])
        torch.cuda.synchronize()
        launches = tt.forward_margins.launches
        print(f"main rc {rc}  tile_fwd launches {launches}  "
              f"{time.perf_counter() - t0:.1f} s")
        require(rc == 0, f"main returned {rc}")
        require(launches == info.num_blocks,
                f"tile_fwd launched {launches} times for "
                f"{info.num_blocks} blocks")

        # -- 5. predictions vs the numpy oracle ------------------------------
        t0 = phase("predictions vs float64 numpy oracle")
        mfile = np.loadtxt(model + "_0", comments="#")
        w_file = np.zeros(NB, np.float32)
        w_file[mfile[:, 0].astype(np.int64)] = mfile[:, 1]
        wb = bf16(w_file).astype(np.float64)
        oracle = np.bincount(rr, weights=wb[pair_b], minlength=n_rows)
        mag = np.bincount(rr, weights=np.abs(wb[pair_b]), minlength=n_rows)
        n_spill = 0
        for i, (views, rows) in enumerate(iter_packed2(data)):
            sp = views["ovf_b"] != 0xFFFFFFFF
            sb = views["ovf_b"][sp].astype(np.int64)
            sr = views["ovf_r"][sp].astype(np.int64) + i * spec.block_rows
            n_spill += int(sp.sum())
            # spill pairs carry f32 w, the kernel's pairs bf16(w)
            np.add.at(oracle, sr, w_file[sb].astype(np.float64) - wb[sb])
        require(n_spill > 0, "no spill pairs reached the main path")
        p_oracle = 1 / (1 + np.exp(-oracle))
        p = np.loadtxt(pred)
        require(p.shape == (n_rows,), f"{p.shape} predictions for "
                f"{n_rows} rows")
        require(bool(np.all(np.isfinite(p))), "non-finite predictions")
        cnt = np.bincount(rr, minlength=n_rows)
        ptol = 4 * np.maximum(cnt, 1) * 2.0 ** -24 * mag / 4 + 1e-6
        perr = np.abs(p - p_oracle)
        require(bool(np.all(perr <= ptol)),
                f"predictions off the oracle (max err {perr.max():.3e})")
        print(f"{n_rows} predictions, {n_spill} spill pairs; max |pred - "
              f"oracle| {perr.max():.3e} (tolerance: margin bound / 4 + "
              f"1e-6 for %.6g printing, largest {ptol.max():.3e})")

        # -- 6. validation pass ------------------------------------------------
        t0 = phase("validation pass (_run_eval)")
        app = async_sgd.AsyncSGD(Config(data_format="crec2", num_buckets=NB,
                                        model_in=model, max_data_pass=0))
        app.run()
        tot, auc = app._run_eval(data)
        objv, acc = tot.objv / tot.num_ex, tot.acc / tot.count
        y = labels.astype(np.float64)
        objv_or = np.mean(np.logaddexp(0, -(2 * y - 1) * oracle))
        # Progress.acc sums each block's accuracy; the display divides
        # by the block count
        acc_or = np.mean([np.mean((oracle[i:i + spec.block_rows] > 0)
                                  == (y[i:i + spec.block_rows] > 0.5))
                          for i in range(0, n_rows, spec.block_rows)])
        auc_or = auc_np(y, oracle)
        print(f"objv {objv:.6f} (oracle {objv_or:.6f})  auc {auc:.6f} "
              f"(oracle {auc_or:.6f})  acc {acc:.6f} (oracle {acc_or:.6f})"
              f"  examples {tot.num_ex}")
        require(tot.num_ex == n_rows, f"eval saw {tot.num_ex} rows")
        require(abs(objv - objv_or) <= 1e-4 * abs(objv_or), "objv")
        require(abs(auc - auc_or) <= 1e-4 and auc > 0.6, "auc")
        require(abs(acc - acc_or) <= 1e-4, "accuracy")
        del app

    # -- 7. timing -------------------------------------------------------------
    t0 = phase("timing per block (CUDA events, median of 7 x 10 calls)")
    pwd = uniform_block["pw"]
    bucket, row, valid = tt.decode_pairs(pwd, spec)
    order = torch.argsort(row[valid], stable=True)
    rows_v, cols_v = row[valid][order], bucket[valid][order]
    crow = torch.zeros(spec.block_rows + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(rows_v,
                                           minlength=spec.block_rows), 0)
    csr = torch.sparse_csr_tensor(crow, cols_v,
                                  torch.ones_like(cols_v, dtype=torch.float32),
                                  size=(spec.block_rows, NB))
    wcol = wd.to(torch.bfloat16).float().unsqueeze(1)
    lib = torch.sparse.mm(csr, wcol).squeeze(1)
    ker = tt.forward_margins(pwd, wd, spec)
    require(bool(torch.all((lib - ker).abs() <= row_tolerance(
        torch, tt, pwd, wd, spec))), "sparse.mm yardstick disagrees")
    w1 = wd.view(NB, 1)
    ms = time_ms(torch, lambda: tt.forward_margins(pwd, wd, spec))
    plain_ms = time_ms(torch, lambda: tt.forward_margins_plain(pwd, wd, spec))
    lib_ms = time_ms(torch, lambda: torch.sparse.mm(csr, wcol))
    pulls1_ms = time_ms(torch, lambda: tt.forward_pulls(pwd, w1, spec))
    ms2 = time_ms(torch, lambda: tt.forward_margins(pwd, wd, spec))
    fwd_parts = "  ".join(
        f"{kernel_name(k)} {v:.4f}" for k, v in
        launch_ms(torch, lambda: tt.forward_margins(pwd, wd, spec)).items())
    n_pairs = int(valid.sum().item())
    nbytes = (pwd.numel() * 4 + table_bytes(torch, bucket[valid], 1)
              + spec.block_rows * 4)
    bound_ms = max(nbytes / PEAK_BYTES_S, n_pairs / PEAK_F32_S) * 1e3
    print(f"tile_fwd {ms:.4f} ms (again {ms2:.4f}; device: {fwd_parts})  "
          f"plain {plain_ms:.4f} ms  sparse.mm {lib_ms:.4f} ms  "
          f"forward_pulls at ch 1 {pulls1_ms:.4f} ms  bound {bound_ms:.4f} "
          f"ms ({nbytes / 1e6:.2f} MB at {PEAK_BYTES_S / 1e12:.2f} TB/s; "
          f"{n_pairs} pair adds)  card {smi}")

    kernels = [{
        "name": "tile_fwd", "route": "cuda",
        "source": "wormhole_tpu_torch/ops/csrc/tile_fwd.cu",
        "replaces": "wormhole_tpu/ops/tilemm.py:309",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": lib_ms,
    }]

    # -- 8. training kernels vs plain at full width ----------------------------
    t0 = phase("training kernels vs plain at full width")
    from wormhole_tpu_torch.learners.handles import LearnRate
    from wormhole_tpu_torch.ops.penalty import L1L2
    handle = FTRLHandle(penalty=L1L2(*LAMBDA), lr=LearnRate(ALPHA, BETA))
    rows = spec.block_rows
    labels_d = torch.from_numpy((rng.random(rows) < 0.25).astype(
        np.float32)).to(dev)
    mask_d = torch.ones(rows, device=dev)
    mask_d[-4096:] = 0.0                                 # a padded tail
    slots0 = torch.stack([wd, -10.0 * wd, wd.abs() * 3]).contiguous()
    errs = {k: 0.0 for k in ("tile_bwd", "tile_step_grad",
                             "tile_step_update", "loss_dual", "ftrl_push")}
    spec8 = tt.make_spec(NB_FUSE8, SUBBLOCKS, default_cap(NNZ, NB_FUSE8))
    require(spec8.fuse == 8 and spec8.cap == 256, f"fuse spec {spec8}")
    cases = [("uniform", uniform_block, spec), ("spill", spill_block, spec)]
    pw8 = torch.from_numpy(encode_tile_block(
        make_keys(rng, spec8.block_rows), NB_FUSE8, spec8, OVF_CAP)[0]
        .view(np.int32)).to(dev)
    cases.append(("fuse8", {"pw": pw8}, spec8))
    for kind, blk, sp_ in cases:
        dual = torch.from_numpy((rng.standard_normal(sp_.block_rows) * 0.4)
                                .astype(np.float32)).to(dev)
        a = tt.backward_grad(blk["pw"], dual, sp_)
        b = tt.backward_grad(blk["pw"], dual, sp_)
        plain = tt.backward_grad_plain(blk["pw"], dual, sp_)
        pushes = tt.backward_pushes(blk["pw"], dual.view(-1, 1), sp_)[:, 0]
        torch.cuda.synchronize()
        err = (a.double() - plain.double()).abs()
        # both sum each bucket from 0 in word order
        require(torch.equal(a, plain), f"tile_bwd {kind}: not bitwise equal "
                f"to the order-exact plain version ({int((a != plain).sum())}"
                f" buckets differ, largest {err.max().item():.3e})")
        require(torch.equal(a, pushes), f"tile_bwd {kind}: != "
                "backward_pushes at ch 1")
        require(torch.equal(a, b), f"tile_bwd {kind}: two runs differ")
        errs["tile_bwd"] = max(errs["tile_bwd"], err.max().item())
        print(f"tile_bwd {kind} ({sp_.tiles} tiles, fuse {sp_.fuse}): = "
              f"order-exact plain bitwise = backward_pushes at ch 1, "
              f"bitwise repeat ok")
        del a, b, plain, pushes, err
    del cases
    for kind, blk in (("uniform", uniform_block), ("spill", spill_block)):
        pw = blk["pw"]
        spill = (blk["ovf_b"], blk["ovf_r"]) if kind == "spill" else \
            (None, None)
        sp = (tt.spill_margin_rows(wd, *spill, spec) if kind == "spill"
              else None)
        for loss, exact in (("logit", True), ("hinge", False)):
            mf, gf = tt.fused_step_grad(pw, wd, labels_d, mask_d, spec, loss,
                                        exact, spill_margins=sp)
            mf2, gf2 = tt.fused_step_grad(pw, wd, labels_d, mask_d, spec,
                                          loss, exact, spill_margins=sp)
            ms_ = tt.forward_margins(pw, wd, spec, *spill)
            dk = tt.loss_dual(ms_, labels_d, mask_d, loss, exact)
            gs = tt.backward_grad(pw, dk, spec)
            mp, gp = tt.fused_step_grad_plain(pw, wd, labels_d, mask_d, spec,
                                              loss, exact, sp)
            dp = tt.loss_dual_plain(mp, labels_d, mask_d, loss, exact)
            torch.cuda.synchronize()
            require(torch.equal(mf, ms_) and torch.equal(gf, gs),
                    f"tile_step_grad {kind} {loss}: fused != split")
            require(torch.equal(mf, mf2) and torch.equal(gf, gf2),
                    f"tile_step_grad {kind} {loss}: two runs differ")
            merr = (mf.double() - mp.double()).abs()
            gtol = grad_tolerance(torch, tt, pw, spec, dk, dp)
            gerr = (gf.double() - gp.double()).abs()
            require(torch.equal(mf, mp), f"tile_step_grad {kind} {loss}: "
                    f"margins != plain (max err {merr.max().item():.3e})")
            require(bool(torch.all(gerr <= gtol)),
                    f"tile_step_grad {kind} {loss}: grad vs plain (max err "
                    f"{gerr.max().item():.3e})")
            require(torch.equal(gf, tt.backward_grad_plain(pw, dk, spec)),
                    f"tile_step_grad {kind} {loss}: grad != the plain "
                    "backward on its dual")
            derr = (dk.double() - dp.double()).abs()
            dk_p = tt.loss_dual_plain(ms_, labels_d, mask_d, loss, exact)
            derr_same = (dk.double() - dk_p.double()).abs()
            require(bool(torch.all(derr_same <= 2.0 ** -20 * dk_p.double()
                                   .abs() + 1e-30)),
                    f"loss_dual {loss}: vs plain on the same margins")
            errs["tile_step_grad"] = max(errs["tile_step_grad"],
                                         merr.max().item(),
                                         gerr.max().item())
            errs["loss_dual"] = max(errs["loss_dual"],
                                    derr_same.max().item())
            print(f"tile_step_grad {kind} {loss} exact_dense={exact}: "
                  f"fused = split bitwise, bitwise repeat ok; vs plain "
                  f"margins bitwise, grad = plain backward on the kernel's "
                  f"dual bitwise, grad vs plain step "
                  f"{gerr.max().item():.3e} (dual {derr.max().item():.3e}; "
                  f"loss_dual vs plain on the same margins "
                  f"{derr_same.max().item():.3e}, tolerance 2^-20 relative)")
    pw = uniform_block["pw"]
    runs = []
    for _ in range(2):
        s_ = slots0.clone()
        m_, wd2 = tt.fused_step_update(pw, s_, labels_d, mask_d, spec,
                                       "logit", handle)
        runs.append((m_, s_, wd2))
    ss = slots0.clone()
    ms_ = tt.forward_margins(pw, ss[0], spec)
    dk = tt.loss_dual(ms_, labels_d, mask_d, "logit", True)
    gk = tt.backward_grad(pw, dk, spec)
    wds = tt.ftrl_push(ss, gk, handle)
    sp_ = slots0.clone()
    mp, _ = tt.fused_step_update_plain(pw, sp_, labels_d, mask_d, spec,
                                       "logit", handle)
    pp = slots0.clone()
    tt.ftrl_push_plain(pp, gk, handle)
    pg = slots0.clone()
    wdg = tt.ftrl_push(pg, tt.backward_grad_plain(pw, dk, spec), handle)
    torch.cuda.synchronize()
    require(torch.equal(pg, ss) and torch.equal(wdg, wds),
            "tile_step_update: slots != ftrl_push on the plain gradient")
    for m_, s_, wd2 in runs:
        require(torch.equal(m_, ms_) and torch.equal(s_, ss)
                and torch.equal(wd2, wds),
                "tile_step_update: fused != split (or runs differ)")
    require(torch.equal(ms_, mp), "tile_step_update: margins != plain")
    dp = tt.loss_dual_plain(mp, labels_d, mask_d, "logit", True)
    gtol = grad_tolerance(torch, tt, pw, spec, dk, dp)
    uerr = (ss.double() - sp_.double()).abs()
    utol = slot_tolerance(torch, slots0, gk, sp_, gtol)
    require(bool(torch.all(uerr <= utol)),
            f"tile_step_update vs plain (max err {uerr.max().item():.3e})")
    perr = (ss.double() - pp.double()).abs()
    require(bool(torch.all(perr <= slot_tolerance(torch, slots0, gk, pp,
                                                  0.0))),
            f"ftrl_push vs plain (max err {perr.max().item():.3e})")
    errs["tile_step_update"] = uerr.max().item()
    errs["ftrl_push"] = perr.max().item()
    print(f"tile_step_update: fused = split bitwise (margins, w/z/cg, "
          f"sum dw^2 {wds.item():.6g}), bitwise repeat ok; margins = plain "
          f"bitwise; slots = ftrl_push on the plain gradient bitwise; slots "
          f"vs plain "
          f"{uerr.max().item():.3e}; ftrl_push vs plain on the same "
          f"gradient {perr.max().item():.3e} (per-slot f32 bound)")
    del runs, ss, sp_, pp, pg, uerr, utol, perr, gtol
    print(f"phase {time.perf_counter() - t0:.1f} s")

    # -- 9. training through async_sgd.main ------------------------------------
    counted = [tt.forward_margins, tt.backward_grad, tt.fused_step_grad,
               tt.fused_step_update, tt.loss_dual, tt.ftrl_push]
    names = ["tile_fwd", "tile_bwd", "tile_step_grad", "tile_step_update",
             "loss_dual", "ftrl_push"]

    def counts():
        return dict(zip(names, (f.launches for f in counted)))

    train_launches = {n: 0 for n in names}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        t0 = phase("write a spill file and an ovf_cap=0 file")
        files = write_train_files(rng, work, spec, n_rows, w_np)
        oblocks = {k: oracle_blocks(torch, tt, f, spec, dev)
                   for k, f in files.items()}
        require(sum(len(b[2]) for b in oblocks["spill"]) > 0,
                "the spill file has no spill pairs")
        print(f"{n_rows} rows x 2 files of {BLOCKS} blocks; spill pairs "
              f"{sum(len(b[2]) for b in oblocks['spill'])}; "
              f"{time.perf_counter() - t0:.1f} s")

        t0 = phase("train through async_sgd.main and AsyncSGD.run")
        base = ["data_format=crec2", f"num_buckets={NB}",
                f"max_data_pass={PASSES}", f"lambda={LAMBDA[0]} {LAMBDA[1]}",
                "disp_itv=1e12"]
        expect = {  # launches per run: one per block and pass, per kernel
            ("spill", "fused"): {"tile_step_grad": 8, "loss_dual": 8,
                                 "ftrl_push": 8, "tile_fwd": 8},
            ("ovf0", "fused"): {"tile_step_update": 8, "tile_fwd": 8},
            ("spill", "split"): {"tile_fwd": 16, "tile_bwd": 8,
                                 "loss_dual": 8, "ftrl_push": 8},
            ("ovf0", "split"): {"tile_fwd": 16, "tile_bwd": 8,
                                "loss_dual": 8, "ftrl_push": 8},
        }
        resolved = {("spill", "fused"): "fused",
                    ("ovf0", "fused"): "fused_update"}
        train_rows = PASSES * n_rows
        for f in counted:
            f.launches = 0
        # the CLI a user calls: auto resolves the fused step on the card
        pred = os.path.join(work, "pred.txt")
        t1 = time.perf_counter()
        rc = async_sgd.main(base + [
            f"train_data={files['spill']}", f"val_data={files['spill']}",
            f"test_data={files['spill']}", f"pred_out={pred}",
            f"model_out={os.path.join(work, 'trained')}"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        got = counts()
        require(rc == 0, f"main returned {rc}")
        want = dict(expect[("spill", "fused")])
        want["tile_fwd"] += BLOCKS                     # the test predict
        require(got == {n: want.get(n, 0) for n in names},
                f"main launches {got}, want {want}")
        p = np.loadtxt(pred)
        require(p.shape == (n_rows,) and bool(np.all(np.isfinite(p))),
                "main's predictions")
        print(f"main (auto, spill file): {got}  {dt:.1f} s, "
              f"{train_rows / dt:.0f} train examples/s over the whole run "
              f"(validation, predict and model_out included)")
        train_launches = dict(got)
        trained = {}
        for (kind, kernel) in expect:
            for f in counted:
                f.launches = 0
            cfg = load_config(None, base + [
                f"train_data={files[kind]}", f"val_data={files[kind]}",
                f"tile_step_kernel={kernel}"])
            app = async_sgd.AsyncSGD(cfg)
            t1 = time.perf_counter()
            app.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            got = counts()
            for n in names:
                train_launches[n] += got[n]
            require(got == {n: expect[(kind, kernel)].get(n, 0)
                            for n in names},
                    f"{kind}/{kernel} launches {got}")
            info = read_header2(files[kind])
            rec = app.store._tile_kernel[(info, "train")]
            require(rec[0] == resolved.get((kind, kernel), "split"),
                    f"{kind}/{kernel} resolved {rec}")
            trained[(kind, kernel)] = (app.store.slots, app.pass_log)
            print(f"{kind}/{kernel}: resolved {rec[0]!r} ({rec[2]}); "
                  f"launches {got}; {dt:.1f} s, {train_rows / dt:.0f} "
                  f"train examples/s over the run (validation included)")
            del app
        for kind in ("spill", "ovf0"):
            require(torch.equal(trained[(kind, "fused")][0],
                                trained[(kind, "split")][0]),
                    f"{kind}: fused and split trained slots differ")
        print("fused and split trained slots bitwise equal on both files")

        t0 = phase("training vs float64 numpy oracle")
        for kind in ("spill", "ovf0"):
            w_or, log_or = oracle_train(oblocks[kind], NB, spec.block_rows,
                                        auc_np)
            slots, log = trained[(kind, "fused")]
            for p_, (a, b) in enumerate(zip(log, log_or)):
                for key in ("train_objv", "val_objv"):
                    require(abs(a[key] - b[key]) <= 1e-4 * abs(b[key]),
                            f"{kind} pass {p_} {key} {a[key]} vs {b[key]}")
                for key in ("val_auc", "val_acc"):
                    require(abs(a[key] - b[key]) <= 1e-4,
                            f"{kind} pass {p_} {key} {a[key]} vs {b[key]}")
                print(f"{kind} pass {p_}: " + "  ".join(
                    f"{k} {a[k]:.6f} (oracle {b[k]:.6f})" for k in b))
            # The per-bucket bound. The kernels run f32 and the oracle
            # float64, so most buckets agree to f32 rounding over 8 steps:
            # 1e-5·(1 + |w|). Where a row's f32 dual lies within an f32
            # rounding of a bf16 rounding boundary, the two round it to
            # neighbouring bf16 values, one bf16 step (≤ 2^-8, |dual| ≤ 1)
            # apart. That moves each of the row's ~35 buckets' gradient by
            # that step and its w by at most α/β·2^-8·(1 + |w|/α) ≈ 4e-4
            # (w' ≤ α/β·|Δz'|). So every bucket is held within 2e-3 (a few
            # such flips), and at least 99% of buckets to the f32 bound.
            w_k = slots[0].double().cpu().numpy()
            werr = np.abs(w_k - w_or)
            tight = werr <= 1e-5 * (1 + np.abs(w_or))
            print(f"{kind}: final w vs oracle: max {werr.max():.3e}, "
                  f"99.9th pct {np.quantile(werr, 0.999):.3e}, "
                  f"{tight.mean() * 100:.4f}% within 1e-5*(1+|w|), "
                  f"nnz {np.count_nonzero(w_k)} (oracle "
                  f"{np.count_nonzero(w_or)})")
            require(werr.max() <= 2e-3 and tight.mean() >= 0.99,
                    f"{kind}: final weights off the oracle")
        print(f"phase {time.perf_counter() - t0:.1f} s")
        del trained, oblocks

    # -- 10. timing of the training kernels ------------------------------------
    t0 = phase("training kernels per block (CUDA events, median of 7 x 10)")

    def transposed_csr(pw_, sp_):
        """The block's pairs as a (nb, rows) CSR matrix of ones: the
        one-call yardstick torch.sparse.mm(csr, bf16 dual) of tile_bwd."""
        bucket, row, valid = tt.decode_pairs(pw_, sp_)
        order = torch.argsort(bucket[valid], stable=True)
        b_v, r_v = bucket[valid][order], row[valid][order]
        crow = torch.zeros(sp_.nb + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(b_v, minlength=sp_.nb), 0)
        return torch.sparse_csr_tensor(crow, r_v, torch.ones_like(
            r_v, dtype=torch.float32), size=(sp_.nb, sp_.block_rows)), \
            int(valid.sum().item())

    pw = uniform_block["pw"]
    dual = torch.from_numpy((rng.standard_normal(rows) * 0.4).astype(
        np.float32)).to(dev)
    csr_t, n_pairs = transposed_csr(pw, spec)
    dcol = dual.to(torch.bfloat16).float().unsqueeze(1)
    lib_g = torch.sparse.mm(csr_t, dcol).squeeze(1)
    require(bool(torch.all((lib_g - tt.backward_grad(pw, dual, spec)).abs()
                           <= grad_tolerance(torch, tt, pw, spec, dual,
                                             dual))),
            "sparse.mm yardstick disagrees with tile_bwd")
    del lib_g
    # kernel #3's function: tile_bwd on the fuse=8 spec (no main-path file
    # has one, so it is timed here and not listed with launches)
    dual8 = torch.from_numpy((rng.standard_normal(spec8.block_rows) * 0.4)
                             .astype(np.float32)).to(dev)
    csr8, n8 = transposed_csr(pw8, spec8)
    d8col = dual8.to(torch.bfloat16).float().unsqueeze(1)
    b8 = pw8.numel() * 4 + spec8.block_rows * 4 + spec8.nb * 4
    ms8 = time_ms(torch, lambda: tt.backward_grad(pw8, dual8, spec8))
    p8 = time_ms(torch, lambda: tt.backward_grad_plain(pw8, dual8, spec8))
    l8 = time_ms(torch, lambda: torch.sparse.mm(csr8, d8col))
    print(f"tile_bwd on the fuse=8 spec (nb 2^25, cap 256): {ms8:.4f} ms  "
          f"plain {p8:.4f} ms  sparse.mm of the transposed CSR {l8:.4f} ms"
          f"  bound {max(b8 / PEAK_BYTES_S, n8 / PEAK_F32_S) * 1e3:.4f} ms "
          f"({b8 / 1e6:.2f} MB)  card {smi}")
    del csr8, d8col, dual8
    # the two launches of tile_bwd apart, the alternative design (the bucket
    # index + segmented sum of backward_pushes at ch 1) and each launch of
    # the fused steps
    d1 = dual.view(-1, 1)
    pushes1_ms = time_ms(torch, lambda: tt.backward_pushes(pw, d1, spec))
    su = slots0.clone()
    for what, fn in (
            ("tile_bwd", lambda: tt.backward_grad(pw, dual, spec)),
            ("tile_step_grad", lambda: tt.fused_step_grad(
                pw, wd, labels_d, mask_d, spec, "logit", True)),
            ("tile_step_update", lambda: tt.fused_step_update(
                pw, su, labels_d, mask_d, spec, "logit", handle))):
        parts = "  ".join(f"{kernel_name(k)} {v:.4f}"
                          for k, v in launch_ms(torch, fn).items())
        print(f"{what} device ms per launch: {parts}  card {smi}")
    del su
    print(f"backward_pushes at ch 1 (bucket index + segmented sum, the "
          f"alternative design): {pushes1_ms:.4f} ms  card {smi}")
    sl = slots0.clone()
    g_t = tt.backward_grad(pw, dual, spec)
    m_t = tt.forward_margins(pw, wd, spec)
    b_rows, b_nb = rows * 4, NB * 4
    pw_b = pw.numel() * 4
    bucket, _, valid = tt.decode_pairs(pw, spec)
    w_read = table_bytes(torch, bucket[valid], 1)    # the w sectors reached
    del bucket, valid
    t = {}
    t["tile_bwd"] = (lambda: tt.backward_grad(pw, dual, spec),
                     lambda: tt.backward_grad_plain(pw, dual, spec),
                     lambda: torch.sparse.mm(csr_t, dcol),
                     pw_b + b_rows + b_nb, n_pairs)
    t["tile_step_grad"] = (
        lambda: tt.fused_step_grad(pw, wd, labels_d, mask_d, spec, "logit",
                                   True),
        lambda: tt.fused_step_grad_plain(pw, wd, labels_d, mask_d, spec,
                                         "logit", True),
        None, pw_b + w_read + 3 * b_rows + b_nb, 2 * n_pairs)
    t["tile_step_update"] = (
        lambda: tt.fused_step_update(pw, sl, labels_d, mask_d, spec, "logit",
                                     handle),
        lambda: tt.fused_step_update_plain(pw, sl, labels_d, mask_d, spec,
                                           "logit", handle),
        None, pw_b + 6 * b_nb + 3 * b_rows, 2 * n_pairs + 20 * NB)
    t["loss_dual"] = (
        lambda: tt.loss_dual(m_t, labels_d, mask_d, "logit", True),
        lambda: tt.loss_dual_plain(m_t, labels_d, mask_d, "logit", True),
        None, 4 * b_rows, 8 * rows)
    t["ftrl_push"] = (lambda: tt.ftrl_push(sl, g_t, handle),
                      lambda: tt.ftrl_push_plain(sl, g_t, handle),
                      None, 7 * b_nb, 20 * NB)
    chains = {
        "tile_step_grad": lambda: tt.backward_grad(
            pw, tt.loss_dual(tt.forward_margins(pw, wd, spec), labels_d,
                             mask_d, "logit", True), spec),
        "tile_step_update": lambda: tt.ftrl_push(sl, tt.backward_grad(
            pw, tt.loss_dual(tt.forward_margins(pw, sl[0], spec), labels_d,
                             mask_d, "logit", True), spec), handle),
    }
    sources = {"tile_bwd": "tile_bwd.cu", "tile_step_grad": "tile_step.cu",
               "tile_step_update": "tile_step.cu", "loss_dual": "tile_step.cu",
               "ftrl_push": "tile_step.cu"}
    replaces = {
        "tile_bwd": "wormhole_tpu/ops/tilemm.py:527",
        "tile_step_grad": "wormhole_tpu/ops/tilemm.py:1348",
        "tile_step_update": "wormhole_tpu/ops/tilemm.py:1399",
        # the split path's elementwise math, which XLA fused in JAX
        "loss_dual": "wormhole_tpu/ops/loss.py:44",
        "ftrl_push": "wormhole_tpu/learners/handles.py:122",
    }
    for name, (ker, plain, lib, nbytes, nops) in t.items():
        k_ms = time_ms(torch, ker)
        p_ms = time_ms(torch, plain)
        l_ms = time_ms(torch, lib) if lib is not None else None
        k_ms2 = time_ms(torch, ker)
        b_ms = max(nbytes / PEAK_BYTES_S, nops / PEAK_F32_S) * 1e3
        line = (f"{name} {k_ms:.4f} ms (again {k_ms2:.4f})  plain "
                f"{p_ms:.4f} ms  bound {b_ms:.4f} ms ({nbytes / 1e6:.2f} MB "
                f"at {PEAK_BYTES_S / 1e12:.2f} TB/s)")
        if l_ms is not None:
            line += f"  sparse.mm of the transposed CSR {l_ms:.4f} ms"
        if name in chains:
            line += f"  split chain {time_ms(torch, chains[name]):.4f} ms"
        print(line + f"  card {smi}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"wormhole_tpu_torch/ops/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": train_launches[name],
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": "bytes", "library_ms": l_ms})
    kernels[0]["launches"] += train_launches["tile_fwd"]
    print(f"phase {time.perf_counter() - t0:.1f} s")

    # -- 11. the FM and wide&deep kernels vs plain at full width ---------------
    t0 = phase("multi-channel kernels vs plain at full width")
    blocks = {"uniform": uniform_block, "spill": spill_block}
    merrs: dict = {}
    multi_kernel_checks(torch, tt, spec, blocks, (pw8, spec8), rng, dev,
                        merrs)
    del pw8
    print(f"phase {time.perf_counter() - t0:.1f} s")

    # -- 12. FM and wide&deep training through main ------------------------------
    multi_launches = multi_training(torch, tt, spec, rng, n_rows, w_np,
                                    auc_np, dev)

    # -- 13. timing of the FM and wide&deep kernels ------------------------------
    t0 = phase("FM and wide&deep kernels per block (CUDA events)")
    kernels += multi_timing(torch, tt, spec, blocks, rng, dev, smi,
                            multi_launches, merrs)
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} never launched on the "
                "main path")
    print(f"phase {time.perf_counter() - t0:.1f} s")

    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
