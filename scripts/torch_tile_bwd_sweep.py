#!/usr/bin/env python3
"""Design sweep of the port's tile backward on one NVIDIA GPU.

    python3 scripts/torch_tile_bwd_sweep.py [--seed N]

Makes one full-width criteo block (2^22 buckets, 12 subblocks, 39 keys per
row, 98,304 rows) and a dual from ``--seed`` and times per block, with CUDA
events (median of 7 x 10 calls):

- the shipped ``tilemm.backward_grad`` (``csrc/tile_bwd.cu``), and the
  device time of its two launches apart (``torch.profiler``);
- the variants of ``scripts/torch_tile_bwd_sweep.cu``, each held to
  ``tilemm.backward_grad`` bitwise: the shipped design (``bin_vals``, then
  a warp per 512-bucket bin) at other bin sizes, warps a CTA, buffer sizes
  and loads a lane in flight; the span design as first laid out (a CTA per
  4096-bucket span, a two-level sort by owner thread, or a merge of each
  warp's bin) with the mean time its CTAs spend in each phase
  (``%globaltimer``, one atomic a phase and CTA); the design both
  replaced, a dual pre-pass and one queue-merge CTA per tile; and the
  update step's backward at bins of 512 and 256 buckets;
- ``tilemm.backward_pushes`` at one channel (a bucket index and a segmented
  sum: the alternative design; bitwise) and the one-call yardstick
  ``torch.sparse.mm`` of the block's transposed CSR (built outside the timed
  call);

then the device time of each launch of the shipped train steps
(``fused_step_grad``, ``fused_step_update``) with ``torch.profiler``. Prints
the card's name and power limit. Needs CUDA and nvcc; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

# (variant of scripts/torch_tile_bwd_sweep.cu, spans a tile, what it is)
VARIANTS = [
    (3, 32, "bins (shipped): 32 bins of 512 buckets, 8 warps a CTA in both "
            "launches, a 1,024-word buffer, 4 loads a lane in flight"),
    (1, 64, "bins of 256 buckets"),
    (2, 128, "bins of 128 buckets"),
    (4, 64, "bins of 256 buckets, 4 warps a CTA in both launches"),
    (5, 64, "bins of 256 buckets, a 2,048-word buffer, 4 bins a CTA"),
    (6, 64, "bins of 256 buckets, 2 loads a lane in flight"),
    (7, 64, "bins of 256 buckets, 8 loads a lane in flight"),
    (11, 32, "bins of 512 buckets, 4 warps a CTA in both launches"),
    (12, 16, "bins of 1,024 buckets, 4 warps a CTA in both launches"),
    (13, 32, "bins of 512 buckets, 4 warps a CTA, a 2,048-word buffer"),
    (14, 32, "bins of 512 buckets, 8 warps a bin_vals CTA, 4 a bin_sums"),
    (8, 4, "spans as first laid out: a CTA per 4,096-bucket span, 16 warps, "
           "level-1 sort by owner warp, level-2 by lane, own sums"),
    (9, 4, "spans, each warp's bin merged by __match_any_sync"),
    (10, 4, "spans, 8 warps, merged"),
    (0, 0, "queue (the design both replaced): dual pre-pass, one 16-warp "
           "CTA a tile, queue merge"),
]
PHASES = ("window counts", "copy of the span's runs",
          "level-1 counts and scans", "level-1 placement",
          "level 2 (warp 0)", "bucket sums")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from wormhole_tpu_torch.data.crec import default_cap, encode_tile_block
    from wormhole_tpu_torch.learners.handles import FTRLHandle, LearnRate
    from wormhole_tpu_torch.ops import _ext
    from wormhole_tpu_torch.ops import tilemm as tt
    from wormhole_tpu_torch.ops.penalty import L1L2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    spec = tt.make_spec(cs.NB, cs.SUBBLOCKS, default_cap(cs.NNZ, cs.NB))
    rng = np.random.default_rng(args.seed)
    pw_np = encode_tile_block(cs.make_keys(rng, spec.block_rows), cs.NB,
                              spec, cs.OVF_CAP)[0]
    pw = torch.from_numpy(pw_np.view(np.int32)).to(dev)
    dual = torch.from_numpy((rng.standard_normal(spec.block_rows) * 0.4)
                            .astype(np.float32)).to(dev)
    T, SG, N = spec.pairs_shape
    print(f"card {smi}; spec {spec}")
    _ext.build_all()

    ref = tt.backward_grad(pw, dual, spec)
    if not torch.equal(ref, tt.backward_grad_plain(pw, dual, spec)):
        raise RuntimeError("backward_grad != plain")
    ms = cs.time_ms(torch, lambda: tt.backward_grad(pw, dual, spec))
    parts = "  ".join(f"{cs.kernel_name(k)} {v:.4f}" for k, v in cs.launch_ms(
        torch, lambda: tt.backward_grad(pw, dual, spec)).items())
    print(f"backward_grad {ms:.4f} ms (= plain bitwise; device: {parts})  "
          f"card {smi}")

    stream = torch.cuda.current_stream().cuda_stream
    grad = torch.empty(spec.nb, device=dev)
    dv = torch.empty(pw.numel(), dtype=torch.bfloat16, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "tile_bwd_sweep.so")
        out = subprocess.run([_ext.nvcc_path(), *_ext.NVCC_FLAGS, "-o", so,
                              os.path.join(HERE, "torch_tile_bwd_sweep.cu")],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
        lib = ctypes.CDLL(so)
    lib.sweep_bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                              + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                              + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.sweep_bwd.restype = ctypes.c_int
    lib.sweep_phases.argtypes = [ctypes.c_void_p]
    lib.sweep_phases.restype = ctypes.c_int

    def run_fn(variant, spans):
        offs = spec.subblocks * T * -(-spec.cap // 1024) * (spans + 1)
        scratch = torch.empty(T * SG * N + -(-offs // 2), dtype=torch.int32,
                              device=dev)

        def run():
            err = lib.sweep_bwd(variant, pw.data_ptr(), dual.data_ptr(),
                                scratch.data_ptr(), scratch.numel(),
                                dv.data_ptr(), grad.data_ptr(), T, SG,
                                spec.group, spec.cap, stream)
            if err:
                raise RuntimeError(f"variant {variant}: CUDA error {err}")
        return run

    ph = (ctypes.c_ulonglong * 6)()
    for v, spans, what in VARIANTS:
        run = run_fn(v, spans)
        run()
        torch.cuda.synchronize()
        if not torch.equal(grad, ref):
            raise RuntimeError(f"{what}: != backward_grad")
        print(f"{what}: {cs.time_ms(torch, run):.4f} ms  (= backward_grad "
              f"bitwise)  card {smi}")
        if v in (8, 9):
            # where the span CTAs spend their time: each phase's
            # %globaltimer ns, summed by thread 0 of every CTA
            lib.sweep_phases(ph)
            calls = 20
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
            if lib.sweep_phases(ph):
                raise RuntimeError("sweep_phases failed")
            print("  mean us a span CTA per call: " + ", ".join(
                f"{n} {t / calls / (spans * T) / 1e3:.2f}"
                for n, t in zip(PHASES, ph)))

    # the update step's backward at bins of 512 or 256 buckets, in turns
    lib.sweep_ftrl.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                               + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
                               + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.sweep_ftrl.restype = ctypes.c_int
    offs = spec.subblocks * T * -(-spec.cap // 1024) * (64 + 1)
    scratch = torch.empty(T * SG * N + -(-offs // 2), dtype=torch.int32,
                          device=dev)
    w0 = torch.randn(spec.nb, device=dev) * 0.1
    planes = torch.stack([w0, -10 * w0, w0.abs()]).contiguous()
    part = torch.empty(T * 64, device=dev)

    def ftrl_fn(variant):
        def run():
            err = lib.sweep_ftrl(variant, pw.data_ptr(), dual.data_ptr(),
                                 scratch.data_ptr(), scratch.numel(),
                                 planes[0].data_ptr(), planes[1].data_ptr(),
                                 planes[2].data_ptr(), part.data_ptr(), T,
                                 SG, spec.group, spec.cap, stream)
            if err:
                raise RuntimeError(f"sweep_ftrl {variant}: CUDA error {err}")
        return run

    what = ("bins of 512 buckets (shipped)", "bins of 256 buckets")
    for v in (0, 1, 1, 0):
        print(f"update step's backward (bin_vals + bin_sums with the FTRL "
              f"epilogue), {what[v]}: {cs.time_ms(torch, ftrl_fn(v)):.4f} "
              f"ms  card {smi}")
    del planes, part, scratch

    d1 = dual.view(-1, 1)
    if not torch.equal(tt.backward_pushes(pw, d1, spec)[:, 0], ref):
        raise RuntimeError("backward_pushes at ch 1 != backward_grad")
    print(f"backward_pushes at ch 1 (bucket index + segmented sum): "
          f"{cs.time_ms(torch, lambda: tt.backward_pushes(pw, d1, spec)):.4f}"
          f" ms  (= backward_grad bitwise)  card {smi}")
    bucket, rows_, valid = tt.decode_pairs(pw, spec)
    order = torch.argsort(bucket[valid], stable=True)
    crow = torch.zeros(spec.nb + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(bucket[valid],
                                           minlength=spec.nb), 0)
    cols = rows_[valid][order]
    csr = torch.sparse_csr_tensor(crow, cols, torch.ones_like(
        cols, dtype=torch.float32), size=(spec.nb, spec.block_rows))
    dcol = dual.to(torch.bfloat16).float().unsqueeze(1)
    print(f"torch.sparse.mm of the block's transposed CSR: "
          f"{cs.time_ms(torch, lambda: torch.sparse.mm(csr, dcol)):.4f} ms"
          f"  card {smi}")
    del csr, crow, cols, order, bucket, rows_, valid

    w = torch.randn(spec.nb, device=dev) * 0.1
    labels = (torch.rand(spec.block_rows, device=dev) < 0.3).float()
    mask = torch.ones(spec.block_rows, device=dev)
    slots = torch.stack([w, -10 * w, w.abs()]).contiguous()
    handle = FTRLHandle(penalty=L1L2(0.5, 0.1), lr=LearnRate(0.1, 1.0))
    for name, step in (
            ("fused_step_grad", lambda: tt.fused_step_grad(
                pw, w, labels, mask, spec, "logit", True)),
            ("fused_step_update", lambda: tt.fused_step_update(
                pw, slots, labels, mask, spec, "logit", handle))):
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        reps = 20
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                step()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_time_total > 0]
        total = sum(e.device_time_total for e in evs) / reps / 1e3
        print(f"{name}: {total:.4f} ms of device time per call "
              f"(torch.profiler, {reps} calls):")
        for ev in sorted(evs, key=lambda e: -e.device_time_total):
            print(f"  {cs.kernel_name(ev.key):60s} {ev.count // reps} a "
                  f"call  {ev.device_time_total / ev.count / 1e3:.4f} ms")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
