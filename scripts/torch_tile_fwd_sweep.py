#!/usr/bin/env python3
"""Design sweep of the port's tile forward margins on one NVIDIA GPU.

    python3 scripts/torch_tile_fwd_sweep.py [--seed N]

Makes one full-width criteo block (2^22 buckets, 12 subblocks, 39 keys per
row, 98,304 rows) from ``--seed`` and times per block, with CUDA events
(median of 7 x 10 calls):

- the shipped ``tilemm.forward_margins`` (``csrc/tile_fwd.cu``), and the
  device time of its two launches apart (``torch.profiler``);
- the shipped design (``wh::launch_fwd``) at other row spans, warps a CTA,
  loads in flight when a span's runs are copied and window sizes, each held
  to ``tilemm.forward_margins_plain`` bitwise (this build adds each phase's
  ``%globaltimer`` time to a counter, one atomic a phase and CTA), and the
  mean time a CTA of the shipped settings spends in each phase;
- the variants of ``scripts/torch_tile_fwd_sweep.cu``: ``filter`` (row-span
  CTAs that each read their whole subblock; bitwise) and ``chunk``
  (variant (c): chunk CTAs, partial slabs and a combine launch; within
  4·nnz·2⁻²⁴·Σ|w| per row of the plain version, as it does not sum in word
  order);
- ``tilemm.forward_pulls`` at one channel (a row index and a segmented sum;
  bitwise) and the one-call yardstick ``torch.sparse.mm`` of the block's
  CSR (built outside the timed call);

each on the block as the encoder writes it (each segment in row order) and,
for the shipped forward, on the block with each segment shuffled. Prints the
card's name and power limit. Needs CUDA and nvcc; imports nothing of JAX.
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

SHIPPED = [(3, "16 warps, 8 16-byte loads a lane in flight (shipped)"),
           (2, "16 warps, 16 16-byte loads a lane in flight"),
           (4, "8 warps, 16 16-byte loads a lane in flight")]
SPANS = (6, 11, 22)          # row spans a subblock (rows a CTA 1366, 745, 373)
CAPS = (0, 8192)             # window words: as many as fit, or 8,192


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from wormhole_tpu_torch.data.crec import default_cap, encode_tile_block
    from wormhole_tpu_torch.ops import _ext
    from wormhole_tpu_torch.ops import tilemm as tt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    spec = tt.make_spec(cs.NB, cs.SUBBLOCKS, default_cap(cs.NNZ, cs.NB))
    rng = np.random.default_rng(args.seed)
    w = (rng.standard_normal(cs.NB) * 0.1).astype(np.float32)
    w[rng.random(cs.NB) < 0.3] = 0.0
    wd = torch.from_numpy(w).to(dev)
    pw = encode_tile_block(cs.make_keys(rng, spec.block_rows), cs.NB, spec,
                           cs.OVF_CAP)[0]
    T, SG, N = spec.pairs_shape
    seg = pw.reshape(T, SG, spec.group, spec.cap)
    shuf = np.take_along_axis(seg, np.argsort(rng.random(seg.shape), -1),
                              -1).reshape(spec.pairs_shape)
    blocks = {b: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
              .to(dev) for b, a in (("row-ordered", pw), ("shuffled", shuf))}
    print(f"card {smi}; spec {spec}")
    _ext.build_all()

    for name, pwd in blocks.items():
        plain = tt.forward_margins_plain(pwd, wd, spec)
        got = tt.forward_margins(pwd, wd, spec)
        if not torch.equal(got, plain):
            raise RuntimeError(f"{name}: forward_margins != plain")
        ms = cs.time_ms(torch, lambda: tt.forward_margins(pwd, wd, spec))
        dev_ms = cs.launch_ms(torch, lambda: tt.forward_margins(pwd, wd,
                                                                spec))
        parts = "  ".join(f"{cs.kernel_name(k)} {v:.4f}"
                          for k, v in dev_ms.items())
        print(f"{name} block: forward_margins {ms:.4f} ms (= plain "
              f"bitwise; device: {parts})  card {smi}")

    pwd = blocks["row-ordered"]
    plain = tt.forward_margins_plain(pwd, wd, spec)
    tol = cs.row_tolerance(torch, tt, pwd, wd, spec)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(spec.block_rows, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "tile_fwd_sweep.so")
        subprocess.run([_ext.nvcc_path(), *_ext.NVCC_FLAGS, "-o", so,
                        os.path.join(HERE, "torch_tile_fwd_sweep.cu")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        lib.sweep_fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                  + [ctypes.c_longlong]
                                  + [ctypes.c_void_p] * 2
                                  + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.sweep_fwd.restype = ctypes.c_int

        def scratch_for(rows):
            nr = -(-tt.RSUB // rows)
            offs = spec.subblocks * T * -(-spec.cap // 1024) * (nr + 1)
            return torch.empty(T * SG * N + -(-offs // 2), dtype=torch.int32,
                               device=dev)

        def run_fn(variant, rows, per_cta=4, cap=0):
            scratch = scratch_for(rows)
            nz = -(-T // per_cta)
            partial = torch.empty(spec.subblocks * nz * tt.RSUB, device=dev)

            def run():
                err = lib.sweep_fwd(variant, pwd.data_ptr(), wd.data_ptr(),
                                    scratch.data_ptr(), scratch.numel(),
                                    partial.data_ptr(), out.data_ptr(), T,
                                    SG, spec.group, spec.cap, rows, per_cta,
                                    cap, stream)
                if err:
                    raise RuntimeError(f"variant {variant}: CUDA error {err}")
            return run

        for variant, what in SHIPPED:
            for spans in SPANS:
                rows = -(-tt.RSUB // spans)
                for cap in CAPS:
                    run = run_fn(variant, rows, cap=cap)
                    run()
                    if not torch.equal(out, plain):
                        raise RuntimeError(f"{what}, {spans} spans: != plain")
                    print(f"shipped design, {what}, {spans} spans of {rows} "
                          f"rows ({spans * spec.subblocks} CTAs), window "
                          f"{cap or 'max'} words: "
                          f"{cs.time_ms(torch, run):.4f} ms  (= plain "
                          f"bitwise)  card {smi}")
        # where the shipped design's row spans spend their time: each
        # phase's %globaltimer ns, summed by thread 0 of every CTA
        lib.sweep_phases.argtypes = [ctypes.c_void_p]
        lib.sweep_phases.restype = ctypes.c_int
        ph = (ctypes.c_ulonglong * 6)()
        rows, calls = -(-tt.RSUB // 11), 20
        run = run_fn(3, rows)
        run()
        torch.cuda.synchronize()
        lib.sweep_phases(ph)
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        if lib.sweep_phases(ph):
            raise RuntimeError("sweep_phases failed")
        ctas = 11 * spec.subblocks
        names = ("window counts", "copy of the span's runs",
                 "level-1 counts and scans", "level-1 placement",
                 "level 2 (warp 0)", "row sums")
        print("shipped row spans, mean us a CTA per call: " + ", ".join(
            f"{n} {v / calls / ctas / 1e3:.2f}" for n, v in zip(names, ph))
            + f"  card {smi}")
        for spans in (8, 11):
            rows = -(-tt.RSUB // spans)
            run = run_fn(0, rows)
            run()
            if not torch.equal(out, plain):
                raise RuntimeError(f"filter, {spans} spans: != plain")
            print(f"filter: {spans} spans of {rows} rows, each CTA reading "
                  f"its whole subblock: {cs.time_ms(torch, run):.4f} ms  "
                  f"(= plain bitwise)  card {smi}")
        for per_cta in (2, 4, 8):
            run = run_fn(1, tt.RSUB, per_cta=per_cta)
            run()
            err = (out.double() - plain.double()).abs()
            if not bool(torch.all(err <= tol)):
                raise RuntimeError("chunk variant off the plain version")
            print(f"chunk (c): {per_cta} tiles a CTA, "
                  f"{-(-T // per_cta) * spec.subblocks} CTAs, partial slabs "
                  f"+ combine: {cs.time_ms(torch, run):.4f} ms  (max |err| "
                  f"{err.max().item():.3e}, within 4*nnz*2^-24*sum|w|)  "
                  f"card {smi}")

    w1 = wd.view(spec.nb, 1)
    if not torch.equal(tt.forward_pulls(pwd, w1, spec)[:, 0], plain):
        raise RuntimeError("forward_pulls at ch 1 != plain")
    print(f"forward_pulls at ch 1 (row index + segmented sum): "
          f"{cs.time_ms(torch, lambda: tt.forward_pulls(pwd, w1, spec)):.4f}"
          f" ms  (= plain bitwise)  card {smi}")
    bucket, row, valid = tt.decode_pairs(pwd, spec)
    order = torch.argsort(row[valid], stable=True)
    crow = torch.zeros(spec.block_rows + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(row[valid],
                                           minlength=spec.block_rows), 0)
    cols = bucket[valid][order]
    csr = torch.sparse_csr_tensor(crow, cols, torch.ones_like(
        cols, dtype=torch.float32), size=(spec.block_rows, spec.nb))
    wcol = wd.to(torch.bfloat16).float().unsqueeze(1)
    print(f"torch.sparse.mm of the block's CSR: "
          f"{cs.time_ms(torch, lambda: torch.sparse.mm(csr, wcol)):.4f} ms"
          f"  card {smi}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
