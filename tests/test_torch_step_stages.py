"""The store step's traced stages (``obs.trace.stage``): the host spans each
train-step variant of the linear and FM stores emits, in order, nested in
the step's tilemm span, on one thread; nothing with tracing off; the same
result bits either way; and the device side's recorder on fake timing
events (the anchor's one synchronize, completed boundaries only at a
drain, the bound on unresolved ones, one ``Timer.add`` a stage and step,
the device track on the host clock and out of the step loop's ledger).
"""

import threading

import numpy as np
import pytest
import torch

from wormhole_tpu_torch.data import crec as tc
from wormhole_tpu_torch.learners import handles as th
from wormhole_tpu_torch.learners import store as ts
from wormhole_tpu_torch.models import fm as tfm
from wormhole_tpu_torch.obs import ledger, trace
from wormhole_tpu_torch.ops import penalty as tp
from wormhole_tpu_torch.ops import tilemm as tt
from wormhole_tpu_torch.utils.timer import Timer

torch.set_num_threads(1)

NB = 2 * tt.TILE
NNZ = 6
ROWS = tt.RSUB + 700              # one full block and a padded tail
PULL, KERNEL, SPILL, UPDATE, TAIL = ("step:pull", "step:kernel",
                                     "step:spill", "step:update",
                                     "step:tail")

# (store, tile_step_kernel, spill) -> (resolved variant, stages a step)
VARIANTS = {
    ("linear", "fused", False): ("fused_update", [KERNEL, TAIL]),
    ("linear", "fused", True): ("fused", [SPILL, KERNEL, SPILL, KERNEL,
                                          TAIL]),
    ("linear", "split", False): ("split", [KERNEL, TAIL]),
    ("linear", "split", True): ("split", [KERNEL, TAIL]),
    ("fm", "fused", False): ("fused", [PULL, KERNEL, UPDATE, TAIL]),
    ("fm", "fused", True): ("fused", [PULL, SPILL, KERNEL, SPILL, UPDATE,
                                      TAIL]),
    ("fm", "split", False): ("split", [PULL, KERNEL, UPDATE, TAIL]),
    ("fm", "split", True): ("split", [PULL, KERNEL, UPDATE, TAIL]),
}
IDS = [f"{s}-{k}-{'spill' if sp else 'nospill'}"
       for s, k, sp in VARIANTS]


@pytest.fixture(autouse=True)
def _trace_off():
    trace.disable()
    yield
    trace.disable()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two one-subblock blocks of random keys, without and with spill
    pairs (the cap near the mean tile load)."""
    d = tmp_path_factory.mktemp("stages")
    out = {}
    for spill in (False, True):
        rng = np.random.default_rng(70 + spill)
        keys = rng.integers(0, 1 << 20, size=(ROWS, NNZ), dtype=np.uint32)
        keys[rng.random(keys.shape) < 0.1] = 0xFFFFFFFF
        labels = (rng.random(ROWS) < 0.3).astype(np.uint8)
        path = str(d / f"s{int(spill)}.crec2")
        cap = 22144 if spill else tc.default_cap(NNZ, NB)
        with tc.CRec2Writer(path, nnz=NNZ, nb=NB, subblocks=1, cap=cap,
                            ovf_cap=1024 if spill else 0) as w:
            w.append(keys, labels)
        out[spill] = path
    return out


def make_store(kind, kernel):
    if kind == "fm":
        return tfm.FMStore(tfm.FMConfig(num_buckets=NB, dim=4, l1=0.05,
                                        l2=0.01, seed=7,
                                        tile_step_kernel=kernel),
                           device="cpu")
    h = th.FTRLHandle(penalty=tp.L1L2(0.05, 0.01),
                      lr=th.LearnRate(0.1, 1.0))
    st = ts.ShardedStore(ts.StoreConfig(num_buckets=NB,
                                        tile_step_kernel=kernel), h,
                         device="cpu")
    rng = np.random.default_rng(3)
    s0 = (rng.standard_normal((NB, 3)) * 0.05).astype(np.float32)
    s0[:, 2] = np.abs(s0[:, 2])
    st.from_jax_slots(s0)
    return st


def run(variant, path):
    """The store after one train step a block of ``path``: (store, steps)."""
    kind, kernel, _ = variant
    st = make_store(kind, kernel)
    info = tc.read_header2(path)
    n = 0
    for views, _ in tc.iter_packed2(path):
        assert st.tile_train_step(tc.block_tensors(views), info) is None
        n += 1
    return st, n


@pytest.mark.parametrize("variant", list(VARIANTS), ids=IDS)
def test_each_variant_emits_its_stages_in_order_nested_on_one_thread(
        files, variant):
    trace.enable()
    st, n = run(variant, files[variant[2]])
    resolved, stages = VARIANTS[variant]
    assert st.step_kernel[0] == resolved
    evs = trace.events()
    spans = sorted((e for e in evs if e.get("cat") == "step"),
                   key=lambda e: e["ts"])
    assert [e["name"] for e in spans] == stages * n
    assert {e["tid"] for e in spans} == {threading.get_ident()}
    assert all(e["ph"] == "X" for e in spans)
    assert not any(e["tid"] == trace.DEVICE_TID for e in evs)
    for i in range(n):
        step = spans[i * len(stages):(i + 1) * len(stages)]
        # one stretch: each stage opens right after the last closed
        for a, b in zip(step, step[1:]):
            assert 0 < b["ts"] - (a["ts"] + a["dur"]) < 1e3
    outer = sorted((e for e in evs if e["name"].startswith("tilemm:")),
                   key=lambda e: e["ts"])
    if resolved.startswith("fused"):
        assert len(outer) == n
        for i, o in enumerate(outer):
            assert o["tid"] == threading.get_ident()
            for s in spans[i * len(stages):(i + 1) * len(stages)]:
                assert o["ts"] - 2e-3 <= s["ts"]
                assert s["ts"] + s["dur"] <= o["ts"] + o["dur"] + 2e-3
    else:
        assert outer == []


@pytest.mark.parametrize("variant", list(VARIANTS), ids=IDS)
def test_tracing_off_emits_nothing(files, variant, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("recorded with tracing off")

    monkeypatch.setattr(trace, "_stage", boom)
    monkeypatch.setattr(trace, "_record", boom)
    monkeypatch.setattr(trace, "_new_event", boom)
    st, n = run(variant, files[variant[2]])
    assert n == 2 and st.t == 3
    assert trace.events() == [] and not trace._MARKS


@pytest.mark.parametrize("variant", list(VARIANTS), ids=IDS)
def test_result_bits_equal_with_tracing_on_and_off(files, variant):
    off, _ = run(variant, files[variant[2]])
    trace.enable()
    on, _ = run(variant, files[variant[2]])
    trace.disable()
    np.testing.assert_array_equal(on.to_jax_slots(), off.to_jax_slots())
    np.testing.assert_array_equal(on.fetch_metrics(), off.fetch_metrics())
    assert on.t == off.t


def test_the_learner_on_the_cpu_gets_no_device_keys(files):
    """``AsyncSGD`` with tracing on, on the CPU: the stage spans, and no
    device track and no ``device:`` timer keys."""
    from wormhole_tpu_torch.learners.async_sgd import AsyncSGD
    from wormhole_tpu_torch.sched.workload_pool import TRAIN
    from wormhole_tpu_torch.utils.config import load_config
    path = files[False]
    cfg = load_config(None, ["data_format=crec2", f"train_data={path}",
                             f"num_buckets={NB}", "max_data_pass=1"])
    app = AsyncSGD(cfg, "cpu")
    trace.enable()
    app.process(path, 0, 1, kind=TRAIN)
    app.flush_metrics()
    evs = trace.events()
    assert [e["name"] for e in evs if e.get("cat") == "step"] \
        == [KERNEL, TAIL] * 2
    assert not any(e["tid"] == trace.DEVICE_TID for e in evs)
    assert not [k for k in app.timer.totals if k.startswith("device:")]


# -- the device side, on fake timing events ----------------------------------

CUDA = torch.device("cuda")          # a descriptor only: nothing runs on it
DUR = {KERNEL: 0.004, TAIL: 0.0003, SPILL: 0.0005}


class FakeClock:
    """The device's clock, which the test advances, and how far the device
    has got (``done``); counts the events made and the synchronizes."""

    def __init__(self):
        self.now, self.done = 5.0, 0.0
        self.made = self.syncs = 0


class FakeEvent:
    def __init__(self, clock):
        self.clock, self.t = clock, None

    def record(self):
        self.t = self.clock.now

    def query(self):
        return self.t is not None and self.t <= self.clock.done

    def elapsed_time(self, other):
        assert self.query() and other.query(), "an event not yet complete"
        return (other.t - self.t) * 1e3

    def synchronize(self):
        raise AssertionError("an event synchronize")


@pytest.fixture
def fake(monkeypatch):
    clock = FakeClock()

    def new_event():
        clock.made += 1
        return FakeEvent(clock)

    def synchronize():
        clock.syncs += 1
        clock.done = clock.now

    monkeypatch.setattr(trace, "_new_event", new_event)
    monkeypatch.setattr(trace, "_synchronize", synchronize)
    trace.enable()
    return clock


def fake_step(clock, stages=(KERNEL, TAIL)):
    """One step's boundaries, each stage taking DUR of device time."""
    for name in stages:
        trace.stage(name, CUDA)
        clock.now += DUR[name]
    trace.stage(None, CUDA)


def device_events():
    return [e for e in trace.events() if e["tid"] == trace.DEVICE_TID]


def test_a_drain_resolves_only_the_completed_boundaries(fake):
    timer = Timer()
    fake_step(fake)
    fake.done = fake.now                # the device has passed step 1
    fake_step(fake)
    fake_step(fake)
    assert trace.resolve_stages(timer.add) == 1
    assert timer.counts == {"device:step:kernel": 1, "device:step:tail": 1}
    assert timer.totals["device:step:kernel"] == pytest.approx(DUR[KERNEL])
    assert timer.totals["device:step:tail"] == pytest.approx(DUR[TAIL])
    # step 2's first boundary was recorded at the device's point too, so
    # it resolved, but pairs with nothing yet
    assert len(trace._MARKS) == 5
    assert trace.resolve_stages(timer.add) == 0     # nothing new: no wait
    fake.done = fake.now                # the flush's wait
    assert trace.resolve_stages(timer.add) == 2
    assert timer.counts == {"device:step:kernel": 3, "device:step:tail": 3}
    assert timer.totals["device:step:kernel"] == pytest.approx(
        3 * DUR[KERNEL])
    assert not trace._MARKS
    assert fake.syncs == 1              # the anchor's, and no other
    assert trace.stages_dropped() == 0


def test_the_device_track_is_on_the_host_clock(fake):
    fake_step(fake)
    fake_step(fake, (SPILL, KERNEL, SPILL, KERNEL, TAIL))
    fake.done = fake.now
    timer = Timer()
    assert trace.resolve_stages(timer.add) == 2
    evs = device_events()
    assert [e["name"] for e in evs] == [
        "device:step:kernel", "device:step:tail", "device:step:spill",
        "device:step:kernel", "device:step:spill", "device:step:kernel",
        "device:step:tail"]
    assert all(e["cat"] == "device" and e["ph"] == "X" for e in evs)
    ev0, t0 = trace._ANCHOR
    # the first boundary was recorded right after the anchor, at the same
    # device time; each interval starts where the last ended
    assert evs[0]["ts"] == pytest.approx((t0 - trace._T0) * 1e6, abs=2e-3)
    for a, b in zip(evs, evs[1:]):
        assert a["ts"] + a["dur"] == pytest.approx(b["ts"], abs=2e-3)
    assert [e["dur"] for e in evs[:2]] == pytest.approx(
        [DUR[KERNEL] * 1e6, DUR[TAIL] * 1e6], abs=2e-3)
    # a stage entered twice in a step reaches the timer once, summed
    assert timer.counts["device:step:spill"] == 1
    assert timer.counts["device:step:kernel"] == 2
    assert timer.totals["device:step:spill"] == pytest.approx(
        2 * DUR[SPILL])
    assert trace._TID_NAMES[trace.DEVICE_TID] == "device"


def test_unresolved_boundaries_are_bounded_and_counted(fake, monkeypatch):
    monkeypatch.setattr(trace, "STAGE_MARKS", 4)
    timer = Timer()
    for _ in range(3):
        fake_step(fake)                 # 9 boundaries, 4 held
    assert len(trace._MARKS) == 4 and trace.stages_dropped() == 5
    made = fake.made
    fake.done = fake.now
    # step 1 whole; step 2's first boundary pairs with nothing
    assert trace.resolve_stages(timer.add) == 1
    assert timer.counts == {"device:step:kernel": 1, "device:step:tail": 1}
    fake_step(fake)                     # the pool's events are reused
    assert fake.made == made
    fake.done = fake.now
    assert trace.resolve_stages(timer.add) == 1
    assert timer.counts == {"device:step:kernel": 2, "device:step:tail": 2}


def test_configure_drops_the_unresolved_and_anchors_anew(fake):
    fake_step(fake)
    trace.disable()
    assert not trace._MARKS and trace._ANCHOR is None
    assert trace.resolve_stages() == 0
    trace.enable()
    fake_step(fake)
    assert fake.syncs == 2
    fake.done = fake.now
    assert trace.resolve_stages() == 1


def test_the_device_track_stays_out_of_the_step_loops_ledger(fake):
    fake_step(fake)
    fake.done = fake.now
    trace.resolve_stages()
    evs = trace.events()
    host = [e for e in evs if e["tid"] == threading.get_ident()]
    assert len(host) == 2 and len(device_events()) == 2
    led = ledger.build(evs)
    assert led["spans_attributed"] == 2
    assert led["buckets_s"]["device_compute"] == pytest.approx(
        sum(e["dur"] for e in host) / 1e6, abs=1e-6)
    for name in (PULL, KERNEL, SPILL, UPDATE, TAIL, "device:step:kernel"):
        assert ledger.span_bucket(name) == "device_compute"
