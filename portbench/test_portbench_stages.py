"""The store step's stage metrics: the four readers on a synthetic
``Context`` (here), and on the card (marked ``cuda``, skipped without a
CUDA device) the program's device-timed stages against the profiler: every
window step's stages resolved, their sum within 3% of ``step_device_ms``
in each cell, and each kernel inside the device interval of the stage
whose host span launched it, to within 20 us.

Run: ``python -m pytest portbench/test_portbench_stages.py -q``; on the
card ``python3 -m pytest --noconftest portbench/test_portbench_stages.py``.
"""

from __future__ import annotations

import importlib
from bisect import bisect_right

import pytest
import torch

from portbench import _tiny, gen, program, run

READERS = {"kernel_device_ms": "device:step:kernel",
           "tail_device_ms": "device:step:tail",
           "pull_device_ms": "device:step:pull",
           "update_device_ms": "device:step:update"}
CELLS = [w["name"] for w in _tiny.bench()["workloads"]]
SEED = 2 ** 31 + 4343


def context(timer: dict, steps: int = 200) -> run.Context:
    return run.Context(config={}, meta={}, kernels={}, peaks={},
                       steps=steps, window_s=1.0, timer=timer)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_device_ms_a_step(name):
    mod = importlib.import_module(f"portbench.metrics.{name}")
    ctx = context({READERS[name]: (0.9, 200), "dispatch": (2.0, 200)})
    assert mod.read(ctx) == pytest.approx(4.5)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_none_without_its_key(name):
    mod = importlib.import_module(f"portbench.metrics.{name}")
    others = {k: (0.9, 200) for k in READERS.values() if k != READERS[name]}
    assert mod.read(context(others)) is None
    assert mod.read(context({READERS[name]: (0.9, 200)}, steps=0)) is None


def test_every_stage_metric_is_declared_for_its_cells():
    per_layer = {m["name"]: m for m in _tiny.bench()["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert (m["source"], m["layer"], m["moves"], m["unit"]) == (
            "program_span", "store step", "train_ex_per_s", "ms")
        want = (["fm.resident.uniform"] if name in ("pull_device_ms",
                                                     "update_device_ms")
                else ["ftrl.resident.uniform", "fm.resident.uniform"])
        assert m["workloads"] == want


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU host)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_stages_sum_to_the_step_on_the_card(cuda, name, monkeypatch):
    """A traced 2-s window of the full cell: each stage resolved once a
    window step, and the stages' device ms within 3% of the profiler's
    ``step_device_ms``."""
    seen = []
    make = run.Context
    monkeypatch.setattr(run, "Context",
                        lambda **kw: seen.append(make(**kw)) or seen[-1])
    res = run.run_cell(_tiny.bench(), name, SEED, 2.0, True)
    assert res["correct"], res["checks"]
    ctx = seen[0]
    stages = {k: v for k, v in ctx.timer.items()
              if k.startswith("device:step:")}
    assert stages and ctx.steps > 0
    assert all(n == ctx.steps for _, n in stages.values()), stages
    got = res["metrics"]
    total = sum(got[m]["value"] for m in READERS if m in got)
    step = got["step_device_ms"]["value"]
    print(f"{name}: stages {total:.4f} ms, step_device_ms {step:.4f} ms, "
          + ", ".join(f"{m} {got[m]['value']:.4f}" for m in READERS
                      if m in got))
    assert abs(total - step) <= 0.03 * step


def _device_ops(prof) -> list:
    """(correlation id, name, start ns, duration ns) of the kernels, copies
    and sets of a profile, in launch order."""
    ops = [(e.correlation_id(), e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if "CUDA" in str(e.device_type())]
    return sorted(ops)


def _hold_stages(opened: list, dev: list, ops: list, marker: str):
    """Check each op of ``ops`` (``_device_ops``) launched between two
    boundary markers (the ops named ``marker``, one launched right after
    each boundary of ``opened``) against its stage's interval on the
    device track ``dev``. Returns (ops checked, the worst step's spread in
    us, the boundary whose marker the profile lost or None).

    Each boundary's event fired after the op before its marker ended and
    before the marker started (later where the card was idle there), so
    within a step one offset between the profiler's device clock and the
    events', the least of marker start less boundary, fits every boundary
    to within the step's spread (the profiler's device clock may shift
    between steps). A profile may lose a device op: one missing marker is
    placed where the worst spread is least, and the ops between its
    neighbours go unchecked."""
    # boundary k opens the stage of index[k] (None: a step's end); its
    # device-track time is that stage's start, or the last one's end
    index, at, step, j, s = [], [], [], 0, 0
    for n in opened:
        index.append(None if n is None else j)
        at.append(dev[j]["ts"] if n is not None
                  else dev[j - 1]["ts"] + dev[j - 1]["dur"])
        step.append(s)
        j += n is not None
        s += n is None
    mk = [i for i, op in enumerate(ops) if marker in op[1]]
    assert len(mk) in (len(opened), len(opened) - 1), (
        len(mk), len(opened), sorted({o[1] for o in ops}))
    base = ops[mk[0]][2]

    def us(ns):                        # profiler device ns -> us
        return (ns - base) / 1e3

    fits = []
    for lost in ([None] if len(mk) == len(opened) else range(len(opened))):
        ks = [k for k in range(len(opened)) if k != lost]
        lead, lag = {}, {}             # by step
        for k, i in zip(ks, mk):
            lead[step[k]] = min(lead.get(step[k], 1e18), us(ops[i][2]) - at[k])
            if i:
                end = us(ops[i - 1][2] + ops[i - 1][3]) - at[k]
                lag[step[k]] = max(lag.get(step[k], -1e18), end)
        worst = max(lag[t] - lead[t] for t in lag)
        fits.append((worst, lost, ks, lead))
    spread, lost, ks, lead = min(fits, key=lambda f: f[0])
    assert spread <= 20, (spread, lost)
    cids = [ops[i][0] for i in mk]
    checked = 0
    for cid, name, start, dur in ops:
        r = bisect_right(cids, cid) - 1
        if r < 0 or cid == cids[r]:
            continue
        k = ks[r]
        if index[k] is None or (lost is not None and k + 1 == lost):
            continue
        a = us(start) - lead[step[k]]
        b = a + dur / 1e3
        d = dev[index[k]]
        assert d["ts"] - 20 <= a and b <= d["ts"] + d["dur"] + 20, (
            name, d["name"], a, b, d["ts"], d["dur"])
        checked += 1
    return checked, spread, lost


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_stage_holds_the_kernels_it_launched(cuda, name, monkeypatch):
    """A traced pass of the full cell (device-bound, as in the window; the
    seed's data as the test above made it) under the profiler: each op
    launched inside a stage's host span runs inside that stage's interval
    on the device track, within 20 us. Every stage boundary also launches
    a marker (a fill of one int16, which the program never launches)
    right after its timing event: the markers split the launches into
    stages by launch order (the profiler's correlation ids) and tie the
    profiler's device clock to the events' (``_hold_stages``)."""
    from torch.profiler import ProfilerActivity, profile

    from wormhole_tpu_torch.obs import trace
    cell = run.cell_of(_tiny.bench(), name)
    cfg = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    tr = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    path, _ = gen.generate(name, tr, gen.geometry(cfg, tr), SEED)
    app = program.build_app(cfg, str(path), SEED, bool(tr["cache_device"]),
                            cuda)
    for _ in range(2):                 # fill the device cache, then replay
        program.train_pass(app, str(path))
    app.flush_metrics()
    opened = []                        # each boundary's stage, in order
    stage = trace._stage
    flag = torch.zeros(1, dtype=torch.int16, device=cuda)

    def marked(name, on_cuda):
        stage(name, on_cuda)
        flag.fill_(1)
        opened.append(name)

    monkeypatch.setattr(trace, "_stage", marked)
    torch.cuda.synchronize()
    trace.enable(ring=1 << 20)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            program.train_pass(app, str(path))
            app.flush_metrics()
            torch.cuda.synchronize()
        drift = trace.clock_drift_s()
        evs = trace.events()
        assert trace.stages_dropped() == 0
    finally:
        trace.disable()
    host = sorted((e for e in evs if e.get("cat") == "step"),
                  key=lambda e: e["ts"])
    dev = sorted((e for e in evs if e["tid"] == trace.DEVICE_TID),
                 key=lambda e: e["ts"])
    assert host and [e["name"] for e in dev] == [
        "device:" + e["name"] for e in host]
    assert [n for n in opened if n is not None] == [e["name"] for e in host]
    checked, spread, lost = _hold_stages(opened, dev, _device_ops(prof),
                                         "FillFunctor<short>")
    print(f"{name}: {checked} device ops inside their stages; boundaries "
          f"spread {spread:.2f} us (marker lost: {lost}); clock drift "
          f"{drift * 1e6:.2f} us")
    assert checked >= len(host) - 2
