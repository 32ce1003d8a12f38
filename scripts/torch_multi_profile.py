#!/usr/bin/env python3
"""Device time of each launch of the port's FM and wide&deep train steps on
one NVIDIA GPU.

    python3 scripts/torch_multi_profile.py [--seed N]

Builds the kernels, makes one full-width criteo block (2^22 buckets, 39 keys
per row, 98,304 rows) from ``--seed``, and reads with ``torch.profiler``
the device time per call of every launch of ``forward_pulls`` alone at
ch 10 and ch 17 (the FM and wide&deep pull widths: the row index's three
launches and the segmented sum apart), of ``backward_pushes`` alone at
ch 10 and ch 18 (the push widths: the bf16 rounding, the bucket index's two
launches and the segmented sum apart), ``fused_fm_step`` (dim 8),
``fused_wd_step`` (dim 16, hidden 64,32), and the whole store train steps
``FMStore.tile_train_step`` and ``WideDeepStore.tile_train_step`` (the
fused step, then the dense torch AdaGrad update of the table and the MLP,
and the metric row). Prints the card's name and power limit. Needs CUDA and
nvcc.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from wormhole_tpu_torch.data.crec import (CRec2Info, default_cap,
                                              encode_tile_block)
    from wormhole_tpu_torch.models import fm, wide_deep
    from wormhole_tpu_torch.ops import tilemm as tt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    nb, nnz = 1 << 22, 39
    spec = tt.make_spec(nb, 12, default_cap(nnz, nb))
    rows = spec.block_rows
    rng = np.random.default_rng(args.seed)
    keys = rng.integers(0, 1 << 32, size=(rows, nnz), dtype=np.uint32)
    keys[rng.random(keys.shape) < 0.1] = 0xFFFFFFFF
    pw = torch.from_numpy(encode_tile_block(keys, nb, spec, 1024)[0]
                          .view(np.int32)).to(dev)
    lab_u8 = (rng.random(rows) < 0.25).astype(np.uint8)
    labels = torch.from_numpy(lab_u8.astype(np.float32)).to(dev)
    mask = torch.ones(rows, device=dev)
    info = CRec2Info(nnz=nnz, block_rows=rows, total_rows=rows, nb=nb,
                     subblocks=spec.subblocks, cap=spec.cap, ovf_cap=0)
    block = {"pw": pw, "labels": torch.from_numpy(lab_u8).to(dev)}

    fs = fm.FMStore(fm.FMConfig(num_buckets=nb, dim=8,
                                tile_step_kernel="fused"), dev)
    ws = wide_deep.WideDeepStore(wide_deep.WideDeepConfig(
        num_buckets=nb, dim=16, hidden=(64, 32), tile_step_kernel="fused"),
        dev)
    wf = torch.cat([fs.slots[:, :9], torch.sum(fs.slots[:, 1:9] ** 2, 1,
                                               keepdim=True)], 1)
    ww = ws.slots[:, :17].contiguous()
    wt = {10: wf, 17: ww}
    dvs = {ch: torch.from_numpy((rng.standard_normal((rows, ch)) * 0.4)
                                .astype(np.float32)).to(dev)
           for ch in (10, 18)}
    cases = [
        (f"forward_pulls (ch {ch})",
         lambda ch=ch: tt.forward_pulls(pw, wt[ch], spec))
        for ch in (10, 17)] + [
        (f"backward_pushes (ch {ch})",
         lambda ch=ch: tt.backward_pushes(pw, dvs[ch], spec))
        for ch in (10, 18)] + [
        ("fused_fm_step (dim 8)",
         lambda: tt.fused_fm_step(pw, wf, labels, mask, spec, 8, "logit")),
        ("fused_wd_step (dim 16, hidden 64,32)",
         lambda: tt.fused_wd_step(pw, ww, labels, mask, ws.mlp, spec, 16,
                                  "logit")),
        ("FMStore.tile_train_step (fused step + AdaGrad over the table)",
         lambda: fs.tile_train_step(block, info)),
        ("WideDeepStore.tile_train_step (fused step + AdaGrad over the "
         "table and the MLP)", lambda: ws.tile_train_step(block, info)),
    ]
    print(f"card {smi}; spec {spec}")
    reps = 10
    for name, fn in cases:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_time_total > 0]
        total = sum(e.device_time_total for e in evs) / reps / 1e3
        print(f"{name}: {total:.4f} ms of device time per call "
              f"(torch.profiler, {reps} calls)")
        for ev in sorted(evs, key=lambda e: -e.device_time_total):
            print(f"  {ev.key[:64]:64s} {ev.count / reps:5.1f} per call  "
                  f"{ev.device_time_total / reps / 1e3:.4f} ms per call")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
