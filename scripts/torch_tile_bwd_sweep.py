#!/usr/bin/env python3
"""Design sweep of the port's tile backward on one NVIDIA GPU.

    python3 scripts/torch_tile_bwd_sweep.py [--seed N]

Builds ``scripts/torch_tile_bwd_sweep.cu`` (the backward's queue-merge loop
at 8, 16 and 32 warps per CTA, with the dual read inside the per-tile loop
or from the word-ordered pre-pass, and a probe that reads no dual) and times
each variant per full-width criteo block (2^22 buckets, 98,304 rows) with
CUDA events; every real variant must equal ``tilemm.backward_grad`` bitwise
(they sum in the same order). Then it reads the device time of each launch
of the shipped train steps with ``torch.profiler``. Prints the card's name
and power limit. Needs CUDA and nvcc.
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

VARIANTS = [  # (id, warps, where the dual is read)
    (0, 8, "in the loop"), (1, 16, "in the loop"), (2, 32, "in the loop"),
    (3, 16, "not at all (probe)"), (4, 8, "pre-pass"),
    (5, 16, "pre-pass (shipped)"), (6, 32, "pre-pass")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from wormhole_tpu_torch.data.crec import default_cap, encode_tile_block
    from wormhole_tpu_torch.learners.handles import FTRLHandle, LearnRate
    from wormhole_tpu_torch.ops import _ext
    from wormhole_tpu_torch.ops import tilemm as tt
    from wormhole_tpu_torch.ops.penalty import L1L2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "sweep.so")
        subprocess.run([_ext.nvcc_path(), *_ext.NVCC_FLAGS, "-o", so,
                        os.path.join(HERE, "torch_tile_bwd_sweep.cu")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)
    fn = lib.wh_bwd_sweep
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    dev = torch.device("cuda")
    nb, nnz = 1 << 22, 39
    spec = tt.make_spec(nb, 12, default_cap(nnz, nb))
    rng = np.random.default_rng(args.seed)
    keys = rng.integers(0, 1 << 32, size=(spec.block_rows, nnz),
                        dtype=np.uint32)
    keys[rng.random(keys.shape) < 0.1] = 0xFFFFFFFF
    pw_np = encode_tile_block(keys, nb, spec, 1024)[0]
    pw = torch.from_numpy(pw_np.view(np.int32)).to(dev)
    dual = torch.from_numpy((rng.standard_normal(spec.block_rows) * 0.4)
                            .astype(np.float32)).to(dev)
    dv = torch.empty(pw.numel(), dtype=torch.bfloat16, device=dev)
    grad = torch.empty(nb, dtype=torch.float32, device=dev)
    T, SG, _ = spec.pairs_shape
    stream = torch.cuda.current_stream().cuda_stream
    ref = tt.backward_grad(pw, dual, spec)

    def run(v):
        err = fn(v, pw.data_ptr(), dual.data_ptr(), dv.data_ptr(),
                 grad.data_ptr(), T, SG, spec.group, spec.cap, stream)
        if err:
            raise RuntimeError(f"variant {v}: CUDA error {err}")

    def time_ms(f, reps=7, inner=10):
        for _ in range(3):
            f()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(inner):
                f()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1) / inner)
        return float(np.median(ts))

    print(f"card {smi}; spec {spec}")
    print("warps per CTA | dual read | ms per block (median of 7 x 10) | "
          "equals tile_bwd")
    for v, warps, where in VARIANTS:
        ms = time_ms(lambda: run(v))
        run(v)
        torch.cuda.synchronize()
        same = "-" if v == 3 else str(torch.equal(grad, ref))
        print(f"{warps} | {where} | {ms:.4f} | {same}")
    print(f"package tile_bwd: {time_ms(lambda: tt.backward_grad(pw, dual, spec)):.4f} ms")

    w = (torch.randn(nb, device=dev) * 0.1)
    labels = (torch.rand(spec.block_rows, device=dev) < 0.3).float()
    mask = torch.ones(spec.block_rows, device=dev)
    slots = torch.stack([w, -10 * w, w.abs()]).contiguous()
    handle = FTRLHandle(penalty=L1L2(0.5, 0.1), lr=LearnRate(0.1, 1.0))

    def steps():
        tt.fused_step_grad(pw, w, labels, mask, spec, "logit", True)
        tt.fused_step_update(pw, slots, labels, mask, spec, "logit", handle)

    for _ in range(3):
        steps()
    torch.cuda.synchronize()
    reps = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            steps()
        torch.cuda.synchronize()
    print(f"device time per call of each launch of the two train steps "
          f"(torch.profiler, {reps} calls each):")
    for ev in sorted(prof.key_averages(), key=lambda e: -e.device_time_total):
        if ev.device_time_total > 0:
            print(f"  {ev.key[:60]:60s} {ev.count // reps} per step call  "
                  f"{ev.device_time_total / ev.count / 1e3:.4f} ms")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
