#!/usr/bin/env python3
"""Design sweep of the port's multi-channel pulls on one NVIDIA GPU.

    python3 scripts/torch_pull_sweep.py [--seed N]

Makes one full-width criteo block (2^22 buckets, 39 keys per row, 98,304
rows) from ``--seed`` and times per block, with CUDA events:

- the row index (``wh_pull_index``) at several run lengths (tiles a CTA
  places; the shipped ``tilemm.PULL_RUN_WORDS`` gives 14), each held to
  ``tilemm.pull_index_plain`` exactly;
- the segmented sum's variants of ``scripts/torch_pull_sweep.cu`` at ch 10
  and ch 17 (the FM and wide&deep pull widths) over that index, each held
  to ``tilemm.forward_pulls`` bitwise (they sum in the same order).

Prints the card's name and power limit. Needs CUDA and nvcc.
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

SEG_VARIANTS = [
    (0, "a thread per output, 4 gathers in flight (shipped)"),
    (1, "a thread per output, 1 gather at a time"),
    (2, "a thread per output, 8 gathers in flight"),
    (3, "a thread per channel, 4 gathers in flight"),
    (4, "a warp per row, a lane per channel, 4 gathers in flight")]
RUN_TILES = (2, 4, 7, 14, 28)


def time_ms(torch, f, reps=7, inner=10):
    """Median over ``reps`` of the mean of ``inner`` calls (CUDA events)."""
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2

    from wormhole_tpu_torch.data.crec import default_cap, encode_tile_block
    from wormhole_tpu_torch.ops import _ext
    from wormhole_tpu_torch.ops import tilemm as tt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    nb, nnz = 1 << 22, 39
    spec = tt.make_spec(nb, 12, default_cap(nnz, nb))
    rng = np.random.default_rng(args.seed)
    keys = rng.integers(0, 1 << 32, size=(spec.block_rows, nnz),
                        dtype=np.uint32)
    keys[rng.random(keys.shape) < 0.1] = 0xFFFFFFFF
    pw = torch.from_numpy(encode_tile_block(keys, nb, spec, 1024)[0]
                          .view(np.int32)).to(dev)
    T, SG, _ = spec.pairs_shape
    stream = torch.cuda.current_stream().cuda_stream
    print(f"card {smi}; spec {spec}")

    # the row index at several run lengths
    lib = tt._lib("tile_multi", "wh_pull_index",
                  [tt._P] * 3 + [tt._I] * 5 + [tt._P])
    ps, pp = tt.pull_index_plain(pw, spec)
    for per_run in RUN_TILES:
        nrun = -(-T // per_run)
        rows = spec.block_rows
        index = torch.empty(rows + 1 + spec.subblocks * nrun * tt.RSUB
                            + rows // 1024, dtype=torch.int32, device=dev)
        perm = torch.empty(pw.numel(), dtype=torch.int32, device=dev)

        def build():
            err = lib.wh_pull_index(pw.data_ptr(), index.data_ptr(),
                                    perm.data_ptr(), T, SG, spec.group,
                                    spec.cap, per_run, stream)
            _ext.check(lib, err, "pull_index")

        build()
        if not (torch.equal(index[:rows + 1], ps)
                and torch.equal(perm[:pp.numel()], pp)):
            raise RuntimeError(f"index at {per_run} tiles a run differs "
                               "from pull_index_plain")
        ms = time_ms(torch, build)
        print(f"row index, {per_run} tiles a run ({nrun * spec.subblocks} "
              f"CTAs): {ms:.4f} ms  (= plain exactly)  card {smi}")

    # the segmented sum's variants over the shipped index
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "pull_sweep.so")
        subprocess.run([_ext.nvcc_path(), *_ext.NVCC_FLAGS, "-o", so,
                        os.path.join(HERE, "torch_pull_sweep.cu")],
                       check=True, capture_output=True)
        sweep = ctypes.CDLL(so)
        sweep.sweep_segsum.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                       + [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_void_p])
        sweep.sweep_segsum.restype = ctypes.c_int
        start, perm = tt.pull_index(pw, spec)
        for ch in (10, 17):
            w = torch.from_numpy((rng.standard_normal((nb, ch)) * 0.1)
                                 .astype(np.float32)).to(dev)
            want = tt.forward_pulls(pw, w, spec)
            full = time_ms(torch, lambda: tt.forward_pulls(pw, w, spec))
            print(f"ch {ch}: forward_pulls {full:.4f} ms  card {smi}")
            for v, what in SEG_VARIANTS:
                if v == 3 and ch % 2:
                    continue                 # the shipped kernel at odd ch
                out = torch.empty_like(want)

                def run():
                    err = sweep.sweep_segsum(v, start.data_ptr(),
                                             perm.data_ptr(), w.data_ptr(),
                                             out.data_ptr(), spec.block_rows,
                                             ch, stream)
                    if err:
                        raise RuntimeError(f"variant {v}: CUDA error {err}")

                run()
                if not torch.equal(out, want):
                    raise RuntimeError(f"ch {ch} variant {v} differs from "
                                       "forward_pulls")
                print(f"ch {ch} segmented sum, {what}: "
                      f"{time_ms(torch, run):.4f} ms  (= forward_pulls "
                      f"bitwise)  card {smi}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
