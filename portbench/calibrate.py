"""Readings that the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own size (not run by the benchmark's runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \\
        [--first-seed N] [--controls 3] [--seconds 1]

For each seed, a run of the cell as ``run.py`` makes it (its set-up, a
window of ``--seconds``, the reference), whose compared numbers are the
program's readings (the lower ones). For the first ``--controls`` seeds
also the control, the configuration's lower precision (the program's own
bfloat16 table where it has one, the reference in bfloat16 where it has
none), and the faults planted in the reference put in the program's place
(``half_batch``, ``altered``; ``unchanged`` reads 1 on ``change_gap`` by
its measure), each over the same steps. One JSON line a reading, then a
summary line: per number the largest program reading and each control's
and fault's smallest.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from portbench import judge, run  # noqa: E402

# every limit is read; the window's row count is exact by construction
NO_LIMITS = {k: float("inf") for k in
             ("loss_gap", "grad_gap", "change_gap", "auc_gap", "order_rows",
              "window_loss_gap", "window_auc_gap", "examples_missing")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    bench = run.load_json(HERE.parent / "BENCHMARK.json")
    cell = run.cell_of(bench, args.workload)
    config = run.load_json(HERE / "configs" / f"{cell['config']}.json")
    summary = {"program": {}, "control": {}, "half_batch": {},
               "altered": {}}

    def keep(kind, nums, **extra):
        row = summary[kind]
        for k, v in nums.items():
            if kind == "program":
                row[k] = max(row.get(k, 0.0), v)
            else:
                row[k] = min(row.get(k, float("inf")), v)
        print(json.dumps(dict(kind=kind, numbers=nums, **extra)), flush=True)

    def cell_run(seed, overrides=None):
        sink: dict = {}
        t0 = time.time()
        run.run_cell(bench, args.workload, seed, args.seconds, False,
                     limits=NO_LIMITS, overrides=overrides, sink=sink)
        return sink, round(time.time() - t0, 2)

    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i + (1 << 31)
        sink, secs = cell_run(seed)
        keep("program", sink["numbers"], seed=seed, s=secs,
             plan=sink["plan"])
        if i >= args.controls:
            continue
        ref, plan = sink["ref"], sink["plan"]
        ctl = config.get("control", {})
        if "app" in ctl:
            csink, _ = cell_run(seed, ctl["app"])
            cn = csink["numbers"]
        else:
            alt = judge.reference_run(config, sink["blocks"], seed, dev,
                                      plan, lower=True)
            cn = judge.numbers(config, alt, ref,
                               {"reported": 0, "expected": 0})
        keep("control", cn, seed=seed)
        for fault in ("half_batch", "altered"):
            alt = judge.reference_run(config, sink["blocks"], seed, dev,
                                      plan, fault=fault)
            keep(fault, judge.numbers(config, alt, ref,
                                      {"reported": 0, "expected": 0}),
                 seed=seed)
        del sink
        torch.cuda.empty_cache()
    print(json.dumps({"summary": summary, "workload": args.workload,
                      "card": torch.cuda.get_device_name(dev),
                      "power_limit": run.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
