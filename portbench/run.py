"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json`` at the checkout's
root: its configuration (``configs/<config>.json``) and its traffic
(``traffic/<traffic>.json``). Set-up generates the seed's data (or reuses
it, ``gen.py``), builds the port's ``AsyncSGD`` with its store, and runs
warm passes; the first of them streams the file (and, for a resident cell,
fills the device cache), the others replay it as the window does, and the
first three steps of the last one are captured for the correctness check.
The window then calls ``AsyncSGD.process`` on the training file pass after
pass until ``--seconds`` have passed, finishes the pass in progress and
drains the device; its first metric window is kept for the check.
``--trace 1`` profiles the window and prints the cell's per-layer metrics
instead of its end-to-end ones. After the window the program is freed and
the plain reference replays every step from the seed on the device in
float64, through the window's first metric window (``judge.py``); each
compared number is printed beside its limit, as the last lines on standard
error and under ``checks``, the result line's last key. The result line is
the last line on standard output.

A host without a CUDA device, or with fewer than the cell asks for, gets
an error and exit code 2, and no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "wormhole_tpu")
WARM_STEPS = 128       # two of the learner's 64-step metric windows


@dataclass
class Context:
    """What a per-layer reader reads (``metrics/<name>.py``)."""
    config: dict
    meta: dict
    kernels: dict
    peaks: dict
    steps: int = 0
    window_s: float = 0.0
    timer: dict = field(default_factory=dict)
    trace: object = None


def load_json(p: Path) -> dict:
    return json.loads(p.read_text())


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def _timer_delta(app, before: dict) -> dict:
    t = app.timer
    return {k: (t.totals[k] - before.get(k, (0.0, 0))[0],
                t.counts[k] - before.get(k, (0.0, 0))[1])
            for k in t.totals}


def _timer_snap(app) -> dict:
    return {k: (app.timer.totals[k], app.timer.counts[k])
            for k in app.timer.totals}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault=None, config: dict = None,
             traffic: dict = None, limits: dict = None,
             warm_steps: int = WARM_STEPS, overrides: dict = None,
             sink: dict = None) -> dict:
    """One run of cell ``name``: the result line's dict. The tests hand in
    a small ``config``/``traffic``, ``device="cpu"`` and a ``fault`` (a
    function that breaks the store's step, called with the store before
    set-up); ``calibrate.py`` hands in the control's app ``overrides`` and
    a ``sink`` that receives the reference's blocks, step plan, readings
    and the compared numbers."""
    import gc

    import torch

    import wormhole_tpu_torch  # noqa: F401  the system under test, first
    from portbench import gen, judge, program

    cell = cell_of(bench, name)
    config = config or load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = traffic or load_json(HERE / "traffic"
                                   / f"{cell['traffic']}.json")
    limits = limits or load_json(HERE / "limits" / f"{name}.json")
    geom = gen.geometry(config, traffic)
    dev = torch.device(device)
    data_seed = seed % (1 << 63)

    phases = {"start_s": time.perf_counter() - T_START}
    t = time.perf_counter()
    path, meta = gen.generate(name, traffic, geom, data_seed)
    phases["data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    app = program.build_app(config, str(path), data_seed,
                            bool(traffic["cache_device"]), dev, overrides)
    if fault is not None:
        fault(app.store)
    n_blocks = len(meta["blocks"])
    real_rows = sum(b["rows"] for b in meta["blocks"])
    # whole passes, at least two, so that the last one replays the device
    # cache as the window does; its first three steps are the ones checked
    warm = max(2, -(-warm_steps // n_blocks))
    cap = program.Capture(app.store, config, start=(warm - 1) * n_blocks,
                          n=judge.STEPS)
    phases["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    try:
        for _ in range(warm):
            program.train_pass(app, str(path))
    finally:
        cap.remove()
    app.flush_metrics()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    phases["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T_START

    before = _timer_snap(app)
    tap = program.WindowTap(app)
    tracer = None
    if trace:
        from portbench import devtrace
        tracer = devtrace.Tracer()
        tracer.start()
    reported = 0
    passes = 0
    t0 = time.perf_counter()
    while True:
        reported += program.train_pass(app, str(path)).num_ex
        passes += 1
        if time.perf_counter() - t0 >= seconds:
            break
    reported += app.flush_metrics().num_ex
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    tr = tracer.stop() if tracer is not None else None
    tap.remove()
    timer = _timer_delta(app, before)
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)

    prog = judge.program_readings(config, cap, tap)
    plan = {"capture": cap.start, "warm": warm * n_blocks,
            "window": tap.steps}
    del app, cap, tap
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    blocks = judge.blocks_of(traffic, geom, meta, data_seed, dev)
    ref = judge.reference_run(config, blocks, data_seed, dev, plan)
    nums = judge.numbers(config, prog, ref,
                         {"reported": reported,
                          "expected": passes * real_rows})
    correct, checks = judge.verdict(nums, limits)
    phases["reference_s"] = time.perf_counter() - t
    if sink is not None:
        sink.update(blocks=blocks, plan=plan, ref=ref, numbers=nums)
    del blocks

    steps = passes * n_blocks
    block_rows = real_rows / n_blocks
    result = {"correct": bool(correct), "attempted": steps,
              "failed": int(-(-nums["examples_missing"] // block_rows)),
              "metrics": {}}
    ctx = Context(config=config, meta=meta,
                  kernels=load_json(HERE / "kernels.json"),
                  peaks=load_json(HERE / "peaks.json"),
                  steps=steps, window_s=window_s,
                  timer=timer, trace=tr)
    if trace:
        import importlib
        for m in bench["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            mod = importlib.import_module(f"portbench.metrics.{m['name']}")
            v = mod.read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"train_ex_per_s": passes * real_rows / window_s,
               "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if name in m.get("workloads", [name]):
                result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                                "unit": m["unit"]}
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                        "kind": kind, "count": 1,
                        "memory_peak_bytes": int(mem_peak),
                        "power_limit": power_limit() if dev.type == "cuda"
                        else "none"}
    if tr is not None:
        from portbench import devtrace
        result["device"]["busy_s"] = tr.busy_ns / 1e9
        result["device"]["window_s"] = tr.window_ns / 1e9
        result["breakdown"] = devtrace.breakdown(tr)
    result["phases"] = phases
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = HERE / "_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    import torch
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = int(cell_of(bench, args.workload)["chips"])
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is false; the benchmark "
              "runs on a CUDA device only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} devices, this host has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}: the benchmark may load "
              "neither JAX nor the JAX package", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
