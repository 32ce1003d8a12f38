#!/usr/bin/env python3
"""Design sweep of the port's wide&deep MLP boundary on one NVIDIA GPU.

    python3 scripts/torch_wd_boundary_sweep.py [--seed N]

Makes a full-width block's pulls (98,304 rows, k 16), labels, a mask and an
MLP of hidden (64, 32) from ``--seed`` and times per block, with CUDA events
(median of 7 x 10 calls):

- the shipped ``tilemm.wd_boundary`` (``csrc/tile_wd.cuh``), and the device
  time of its launches apart (``torch.profiler``);
- the variants of ``scripts/torch_wd_boundary_sweep.cu``: the shipped design
  at other tile rows (32·TR), warps a CTA, tile placements (shared memory or
  a device-memory region a CTA), weight placements (shared memory or L1) and
  spans of the parameter sums (built with phase timers: the first row also
  prints the mean time a span takes in each phase, by ``%globaltimer``), and
  the row-thread design it replaced (one thread a row with column-major
  activation scratch in device memory, then one warp a parameter), the
  reference row.
  Every row is held bitwise to ``tilemm.wd_boundary_ordered_plain`` on the
  margins and the push rows, and on the parameter gradients where its span
  is the ordered version's (the row-thread row: within 1e-4 of each leaf's
  largest entry, its order being another);
- ``tilemm.wd_boundary_plain``, the autograd version (cuBLAS GEMMs), the
  boundary's library yardstick;

then the same for the shipped boundary and a few variants at hidden
(300, 40), whose weights do not fit beside a 128-row tile (the span's sums
then stay in device memory too), and at hidden (1024, 512, 256), whose
tile fits no CTA's shared memory (the package keeps it in device memory).
Prints the card's name and power limit. Needs CUDA and nvcc; imports nothing of JAX.
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

# (TR, warps, tile in device memory, weights in shared memory, span, what)
VARIANTS = [
    (4, 8, 0, 1, 256, "shipped: 128-row tiles, 8 warps, weights in shared "
                      "memory, 256-row spans"),
    (2, 8, 0, 1, 256, "64-row tiles"),
    (1, 8, 0, 1, 256, "32-row tiles"),
    (4, 4, 0, 1, 256, "4 warps a CTA"),
    (2, 4, 0, 1, 256, "64-row tiles, 4 warps a CTA"),
    (4, 8, 0, 0, 256, "weights read through L1"),
    (1, 8, 1, 1, 256, "32-row tiles in device memory (the layout of widths "
                      "whose tile fits no CTA)"),
    (4, 8, 0, 1, 128, "128-row spans (768 partials)"),
    (4, 8, 0, 1, 512, "512-row spans (192 partials)"),
    (4, 8, 0, 1, 1024, "1,024-row spans (96 partials)"),
]
PHASES = ("weights in and sums zeroed", "pulls in", "forward",
          "margin and dual", "parameter sums", "backward products",
          "push rows out", "span sums out")
WIDE_VARIANTS = [
    (4, 8, 0, 0, 256, "128-row tiles, weights read through L1 (the pick)"),
    (2, 8, 0, 0, 256, "64-row tiles, weights read through L1"),
    (1, 8, 0, 0, 256, "32-row tiles, weights read through L1"),
    (1, 8, 0, 1, 256, "32-row tiles, weights in shared memory"),
]
DEEP_VARIANTS = [
    (4, 8, 1, 0, 256, "128-row tiles in device memory, weights read "
                      "through L1 (the pick)"),
    (2, 8, 1, 0, 256, "64-row tiles in device memory"),
    (1, 8, 1, 0, 256, "32-row tiles in device memory"),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from wormhole_tpu_torch.ops import _ext
    from wormhole_tpu_torch.ops import tilemm as tt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    rows, k = 98_304, 16
    print(f"card {smi}; {rows} rows, k {k}")
    _ext.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "wd_boundary_sweep.so")
        out = subprocess.run([_ext.nvcc_path(), *_ext.NVCC_FLAGS, "-o", so,
                              os.path.join(HERE,
                                           "torch_wd_boundary_sweep.cu")],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
        lib = ctypes.CDLL(so)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    L_ = ctypes.c_longlong
    lib.sweep_tile.argtypes = ([I_] * 4 + [P_] * 5 + [I_, L_] + [P_] * 5
                               + [L_, I_, I_, P_])
    lib.sweep_tiles.argtypes = [I_, I_, P_, I_, L_, L_, I_]
    lib.sweep_tiles.restype = L_
    lib.sweep_tile.restype = I_
    lib.sweep_rowthread.argtypes = ([P_] * 5 + [I_] * 3 + [P_] * 6
                              + [ctypes.c_longlong, I_, P_])
    lib.sweep_rowthread.restype = I_
    lib.sweep_phases.argtypes = [P_]
    lib.sweep_phases.restype = I_
    ph = (ctypes.c_ulonglong * 8)()
    stream = torch.cuda.current_stream().cuda_stream

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    pulls = f32(rng.standard_normal((rows, 1 + k)) * 0.5)
    labels = f32(rng.random(rows) < 0.25)
    mask = torch.ones(rows, device=dev)
    mask[-4096:] = 0.0

    def sweep(hidden, variants, rowthread):
        sizes = [k] + list(hidden) + [1]
        mlp = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            mlp[f"W{i}"] = f32(rng.standard_normal((a, b)) * np.sqrt(2 / a))
            mlp[f"b{i}"] = f32(rng.standard_normal(b) * 0.05)
        L = len(sizes) - 1
        params = tt._pack_mlp(mlp, L).contiguous()
        P = params.numel()
        hs = (ctypes.c_int * (L + 1))(*sizes)
        margins = torch.empty(rows, device=dev)
        dvf = torch.empty((rows, k + 2), device=dev)
        grad = torch.empty(P, device=dev)
        ordered = {}

        def want(span):
            if span not in ordered:
                m, dv, g = tt.wd_boundary_ordered_plain(
                    pulls, labels, mask, mlp, "logit", span=span)
                ordered[span] = (m, dv, tt._pack_mlp(g, L))
            return ordered[span]

        def held(what, span):
            m, dv, g = want(span or tt.WD_SPAN_ROWS)
            if not (torch.equal(margins, m) and torch.equal(dvf, dv)):
                raise RuntimeError(f"{what}: margins or push rows differ "
                                   "from the ordered plain version")
            if span is not None and not torch.equal(grad, g):
                raise RuntimeError(f"{what}: parameter gradients differ "
                                   "from the ordered plain version")

        ms, dvs, gs = tt.wd_boundary(pulls, labels, mask, mlp, k, "logit")
        mo, dvo, go = want(tt.WD_SPAN_ROWS)
        if not (torch.equal(ms, mo) and torch.equal(dvs, dvo)
                and torch.equal(tt._pack_mlp(gs, L), go)):
            raise RuntimeError("wd_boundary != ordered plain version")
        fn = lambda: tt.wd_boundary(pulls, labels, mask, mlp, k, "logit")
        parts = "  ".join(f"{cs.kernel_name(n)} {v:.4f}" for n, v in
                          cs.launch_ms(torch, fn).items())
        print(f"hidden {hidden}: wd_boundary {cs.time_ms(torch, fn):.4f} ms "
              f"(= ordered plain bitwise; device: {parts})  card {smi}")
        fe = lambda: tt.wd_boundary(pulls, labels, mask, mlp, k, "logit",
                                    want_grad=False)
        print(f"hidden {hidden}: wd_boundary eval (forward only) "
              f"{cs.time_ms(torch, fe):.4f} ms  card {smi}")
        for tr, nw, gt, ws, span, what in variants:
            part = torch.empty((-(-rows // span), P), device=dev)
            nt = lib.sweep_tiles(tr, gt, hs, L, P, rows, span)
            tiles = torch.empty(max(nt, 1), device=dev)

            def run(tr=tr, nw=nw, gt=gt, ws=ws, span=span, part=part,
                    tiles=tiles):
                err = lib.sweep_tile(tr, nw, gt, ws, pulls.data_ptr(),
                                     labels.data_ptr(), mask.data_ptr(),
                                     params.data_ptr(), hs, L, P,
                                     tiles.data_ptr(), part.data_ptr(),
                                     margins.data_ptr(),
                                     dvf.data_ptr(), grad.data_ptr(), rows,
                                     span, 0, stream)
                if err:
                    raise RuntimeError(f"{what}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            held(what, span)
            print(f"hidden {hidden}: {what}: "
                  f"{cs.time_ms(torch, run):.4f} ms (= ordered plain "
                  f"bitwise, grads too)  card {smi}")
            if what == variants[0][-1]:
                # where a CTA spends its time: each phase's %globaltimer ns,
                # summed by thread 0 of every CTA
                lib.sweep_phases(ph)
                calls = 20
                for _ in range(calls):
                    run()
                torch.cuda.synchronize()
                if lib.sweep_phases(ph):
                    raise RuntimeError("sweep_phases failed")
                spans = -(-rows // span)
                print("  mean us a span per call: " + ", ".join(
                    f"{n_} {t / calls / spans / 1e3:.2f}"
                    for n_, t in zip(PHASES, ph)))
            del part, tiles
        if rowthread:
            dsz = torch.tensor(sizes, dtype=torch.int32, device=dev)
            acts = torch.empty((sum(sizes[:-1]), rows), device=dev)
            gz = torch.empty((sum(sizes[1:]), rows), device=dev)
            gpart = torch.empty((-(-rows // 512), P), device=dev)

            def run_rowthread():
                err = lib.sweep_rowthread(pulls.data_ptr(), labels.data_ptr(),
                                    mask.data_ptr(), params.data_ptr(),
                                    dsz.data_ptr(), L, P, k, acts.data_ptr(),
                                    gz.data_ptr(), gpart.data_ptr(),
                                    margins.data_ptr(), dvf.data_ptr(),
                                    grad.data_ptr(), rows, 0, stream)
                if err:
                    raise RuntimeError(f"row-thread design: CUDA error {err}")

            run_rowthread()
            torch.cuda.synchronize()
            held("row-thread design", None)
            e = (grad - go).abs()
            off = 0
            for a, b in zip(sizes[:-1], sizes[1:]):
                for n_ in (a * b, b):
                    sl = slice(off, off + n_)
                    if e[sl].max() > 1e-4 * go[sl].abs().max() + 1e-6:
                        raise RuntimeError("row-thread design: gradients off")
                    off += n_
            t3 = cs.time_ms(torch, run_rowthread)
            parts = "  ".join(f"{cs.kernel_name(n)} {v:.4f}" for n, v in
                              cs.launch_ms(torch, run_rowthread).items())
            print(f"hidden {hidden}: row-thread design (reference row): "
                  f"{t3:.4f} ms (margins and push rows = ordered plain "
                  f"bitwise; "
                  f"device: {parts})  card {smi}")
            del acts, gz, gpart, dsz
        fp = lambda: tt.wd_boundary_plain(pulls, labels, mask, mlp, "logit")
        print(f"hidden {hidden}: wd_boundary_plain (autograd, cuBLAS): "
              f"{cs.time_ms(torch, fp):.4f} ms  card {smi}")

    sweep((64, 32), VARIANTS, True)
    sweep((300, 40), WIDE_VARIANTS, False)
    sweep((1024, 512, 256), DEEP_VARIANTS, False)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
