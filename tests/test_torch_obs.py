"""The port's telemetry (``wormhole_tpu_torch/obs``, ``ft/``) against the JAX
package's on one event sequence.

Each test drives the same calls through both packages under one fake clock
(``time.monotonic``, ``time.time`` and ``time.perf_counter`` advance 1 ms a
read, restarted for each package) and one pid, and requires the same text
out: the trace JSON, the ledger built from its events, the Prometheus dump,
the heartbeat lines, the timeline spill and the cross-rank merge. These
are text and JSON, so the tolerance is none. One documented difference:
the JAX ledger's ``est_mxu_util`` (its device share times a TPU kernel
floor) has no GPU meaning and the port leaves it out, so it is dropped
from the JAX side before comparing.
"""

import json
import os
import time

import pytest

from wormhole_tpu import obs as jobs
from wormhole_tpu.data import pipeline as jpipe
from wormhole_tpu.ft import chaos as jchaos
from wormhole_tpu.obs import flight as jflight
from wormhole_tpu.obs import ledger as jledger
from wormhole_tpu.obs import merge as jmerge
from wormhole_tpu.obs import timeline as jtimeline
from wormhole_tpu.utils import progress as jprogress
from wormhole_tpu.utils import timer as jtimer
from wormhole_tpu.utils.config import Config as JConfig
from wormhole_tpu_torch import obs as tobs
from wormhole_tpu_torch.data import pipeline as tpipe
from wormhole_tpu_torch.ft import chaos as tchaos
from wormhole_tpu_torch.ft import watchdog as twatchdog
from wormhole_tpu_torch.obs import flight as tflight
from wormhole_tpu_torch.obs import ledger as tledger
from wormhole_tpu_torch.obs import merge as tmerge
from wormhole_tpu_torch.obs import timeline as ttimeline
from wormhole_tpu_torch.utils import progress as tprogress
from wormhole_tpu_torch.utils import timer as ttimer
from wormhole_tpu_torch.utils.config import Config as TConfig

JAX = dict(obs=jobs, pipe=jpipe, ledger=jledger, merge=jmerge,
           timeline=jtimeline, progress=jprogress, timer=jtimer,
           flight=jflight, Config=JConfig)
PORT = dict(obs=tobs, pipe=tpipe, ledger=tledger, merge=tmerge,
            timeline=ttimeline, progress=tprogress, timer=ttimer,
            flight=tflight, Config=TConfig)


@pytest.fixture
def clock(monkeypatch):
    """A fake clock: each read advances 1 ms; ``restart()`` rewinds it."""
    t = [0.0]

    def mono():
        t[0] += 0.001
        return 100.0 + t[0]

    monkeypatch.setattr(time, "monotonic", mono)
    monkeypatch.setattr(time, "perf_counter", mono)
    monkeypatch.setattr(time, "time", lambda: 1.7e9 + mono())
    t.append(lambda: t.__setitem__(0, 0.0))
    yield lambda: t[1]()


@pytest.fixture(autouse=True)
def _trace_off():
    for pkg in (JAX, PORT):
        pkg["obs"].trace.disable()
    yield
    for pkg in (JAX, PORT):
        pkg["obs"].trace.disable()


def drive(pkg, path):
    """One event sequence: spans, a counter, an instant, timer scopes, a
    serial DeviceFeed with its stage spans, and a flush."""
    tr = pkg["obs"].trace
    tr.enable(path, pid=0)
    with tr.span("checkpoint:save", cat="checkpoint",
                 args={"bytes": 12}):
        pass
    tr.complete("parse", time.monotonic(), 0.002, cat="timer")
    tr.counter("crec2-feed:ring", 2, cat="feed")
    tr.instant("marker", cat="test")
    timer = pkg["timer"].Timer()
    for _ in range(3):
        with timer.scope("dispatch"):
            with tr.span("tilemm:fused_step", cat="tile"):
                pass
        with timer.scope("wait"):
            pass
    feed = pkg["pipe"].DeviceFeed(range(4), lambda x, _c: x * 2, workers=0,
                                  transfer=lambda x: x, name="crec2-feed")
    assert list(feed) == [0, 2, 4, 6]
    with tr.span("collective:metrics_window", cat="collective",
                 args={"site": "async_sgd/metrics_window"}):
        pass
    evs = tr.events()
    tr.flush()
    return timer, feed, evs


def test_trace_json_equals_the_jax_trace(tmp_path, clock):
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        clock()
        path = str(tmp_path / f"{name}.json")
        _, _, evs = drive(pkg, path)
        out[name] = (open(path).read(), evs,
                     pkg["obs"].trace.summary(), pkg["obs"].trace.dropped())
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1:] == out["jax"][1:]
    names = {e["name"] for e in json.loads(out["port"][0])["traceEvents"]}
    assert {"crec2-feed:parse", "crec2-feed:prep", "crec2-feed:put",
            "dispatch", "wait", "tilemm:fused_step", "checkpoint:save",
            "collective:metrics_window", "crec2-feed:ring"} <= names


def test_ring_drops_and_disabled_trace_match(tmp_path, clock):
    for pkg in (JAX, PORT):
        clock()
        tr = pkg["obs"].trace
        tr.enable("", ring=16, pid=0)
        for i in range(40):
            tr.complete(f"s{i}", time.monotonic(), 0.001)
        pkg["drop"] = (tr.dropped(), tr.events())
        tr.disable()
        tr.complete("off", time.monotonic(), 0.001)
        assert tr.events() == [] and not tr.enabled()
    assert PORT["drop"] == JAX["drop"]
    assert PORT["drop"][0] == 24


def jax_ledger(led):
    led = dict(led)
    led.pop("est_mxu_util")
    return led


def test_ledger_from_the_same_events_equals_the_jax_ledger(tmp_path, clock):
    clock()
    _, _, evs = drive(JAX, str(tmp_path / "t.json"))
    for wall in (None, 0.5):
        want = jax_ledger(jledger.build(evs, wall_s=wall))
        assert tledger.build(evs, wall_s=wall) == want
    assert tledger.BUCKETS == jledger.BUCKETS
    # the port adds its store-step stages and their device track
    port_only = {k: v for k, v in tledger.SPAN_TABLE.items()
                 if k not in jledger.SPAN_TABLE}
    assert tledger.SPAN_TABLE == {**jledger.SPAN_TABLE, **port_only}
    assert set(port_only) == {"step:pull", "step:kernel", "step:spill",
                              "step:update", "step:tail", "device:*"}
    assert set(port_only.values()) == {"device_compute"}
    for name in list(jledger.SPAN_TABLE) + ["eval_wait", "x:put",
                                            "train:encode", "a_stall",
                                            "collective:allreduce_max",
                                            "unknown"]:
        assert tledger.span_bucket(name) == jledger.span_bucket(name)


def fill_registry(pkg, evs):
    """The same declarations and adapters through a package's registry."""
    reg = pkg["obs"].Registry()
    reg.counter("feed/batches", help="batches").inc(7)
    reg.gauge("mesh/x", help="a max gauge", agg="max").max(3.5)
    h = reg.histogram("serve/latency_ms", buckets=[1, 2, 5, 10],
                      help="latency")
    for v in (0.5, 1.5, 3.0, 7.0, 20.0):
        h.observe(v)
    timer = pkg["timer"].Timer()
    timer.add("dispatch", 1.25, 4)
    reg.from_timer(timer)
    prog = pkg["progress"].Progress()
    prog.objv, prog.num_ex, prog.count = 12.5, 1000, 3
    reg.from_progress(prog)
    reg.ingest_feed({"parse": 0.5, "prep": 0.25, "batches": 4,
                     "ring_max": 2})
    stall, fallback = pkg["obs"].metrics.encode_counters(reg)
    stall.inc(0.125)
    fallback.inc(2)
    pkg["ledger"].to_registry(pkg["ledger"].build(evs, wall_s=0.5), reg)
    return reg


def test_prometheus_text_and_records_equal_the_jax_registry(tmp_path, clock):
    clock()
    _, _, evs = drive(JAX, str(tmp_path / "t.json"))
    jreg, treg = fill_registry(JAX, evs), fill_registry(PORT, evs)
    jtext = jreg.prometheus_text(labels={"host": "0"}).splitlines()
    ttext = treg.prometheus_text(labels={"host": "0"}).splitlines()
    assert ttext == [ln for ln in jtext if "est_mxu_util" not in ln]
    jsnap = jreg.snapshot()
    jsnap.pop("ledger/est_mxu_util")
    assert treg.snapshot() == jsnap
    clock()
    jrec = jreg.record(rank=0, step=3)
    clock()
    trec = treg.record(rank=0, step=3)
    jrec.pop("ledger/est_mxu_util")
    assert trec == jrec
    merged = tobs.merge_snapshots([treg.snapshot(), treg.snapshot()])
    assert merged.snapshot() == tobs.merge_snapshots(
        [treg.snapshot(), treg.snapshot()]).snapshot()
    # the cross-host merge on one process keeps every value
    before = treg.snapshot()
    treg.allreduce(None)
    assert treg.snapshot() == before


def test_heartbeat_lines_equal_the_jax_writer(tmp_path, clock):
    texts = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        clock()
        d = str(tmp_path / name)
        reg = pkg["obs"].Registry()
        reg.counter("feed/batches").inc(3)
        hb = pkg["obs"].HeartbeatWriter(d, 1, interval=0.0, registry=reg)
        for step in range(3):
            hb.beat(step, 100 * step, 0.01 * step, lr=0.1)
        hb.close(9, 900, 0.5)
        texts[name] = open(os.path.join(d, "host1.hb.jsonl")).read()
        assert pkg["obs"].read_heartbeats(d)[1][-1]["final"] is True
    assert texts["port"] == texts["jax"]
    assert texts["port"].count("\n") == 4


def test_timeline_spill_equals_the_jax_sampler(tmp_path, clock, monkeypatch):
    texts = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        tl = pkg["timeline"]
        monkeypatch.setattr(tl, "read_rss_bytes", lambda: 4096.0)
        monkeypatch.setattr(tl, "read_device_mem_bytes", lambda: 2048.0)
        clock()
        reg = pkg["obs"].Registry()
        c = reg.counter("feed/batches")
        h = reg.histogram("serve/latency_ms", buckets=[1, 2, 5])
        path = tl.timeline_path(str(tmp_path / name), 0)
        smp = tl.TimelineSampler(registry=reg, interval_s=1.0, path=path,
                                 ring=3, rank=0)
        smp.set_phase("train:pass0")
        for i in range(5):
            c.inc(i)
            h.observe(0.5 * i)
            smp.feed_progress(i, 1000 * i)
            smp.sample_once()
        smp.spill()
        texts[name] = (open(path).read(), smp.dropped(),
                       tl.summarize(smp.samples()))
    assert texts["port"] == texts["jax"]
    assert texts["port"][1] == 2


def test_device_memory_probe_never_initializes_cuda(monkeypatch):
    import torch
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda *a: calls.append(a) or 1.0)
    ttimeline.watch_device(torch.device("cuda", 0))
    try:
        assert ttimeline.read_device_mem_bytes() == 0.0
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        assert ttimeline.read_device_mem_bytes() == 1.0
        assert calls == [(0,)]
        ttimeline.watch_device(torch.device("cpu"))
        assert ttimeline.read_device_mem_bytes() == 0.0
    finally:
        ttimeline.watch_device(None)


# -- the cross-rank merge, on tests/test_merge.py's inputs --------------------

def _coll_ev(site, seq, ts_us, dur_us, tid=1):
    return {"ph": "X", "name": "collective:allreduce_sum",
            "cat": "collective", "pid": 0, "tid": tid,
            "ts": float(ts_us), "dur": float(dur_us),
            "args": {"site": site, "seq": seq}}


def _rank_doc(rank, mono_t0, events, dropped=0):
    return {"traceEvents": list(events), "displayTimeUnit": "ms",
            "metadata": {"rank": rank, "mono_t0": mono_t0,
                         "wall_t0": 1000.0 + mono_t0,
                         "dropped_spans": dropped}}


def _hb(rank, mono_t0, wall_offset, n=3):
    return [{"ts": 1000.0 + wall_offset + mono_t0 + i,
             "mono": mono_t0 + float(i), "rank": rank, "seq": i,
             "ex_per_sec": 100.0}
            for i in range(n)]


MERGE_CASES = {
    "straggler": (
        {0: _rank_doc(0, 100.0, [_coll_ev("s/a", 0, 7_010_000, 6_000),
                                 _coll_ev("s/a", 1, 7_030_000, 6_000),
                                 _coll_ev("s/b", 0, 7_050_000, 2_000)]),
         1: _rank_doc(1, 107.0, [_coll_ev("s/a", 0, 15_000, 1_000),
                                 _coll_ev("s/a", 1, 35_000, 1_000),
                                 _coll_ev("s/b", 0, 55_000, 1_000)], 3)},
        {0: _hb(0, 100.0, 0.0), 1: _hb(1, 107.0, 0.0)}),
    "wall_disagreement": (
        {0: _rank_doc(0, 100.0, [_coll_ev("s/a", 0, 10_000, 1_000)]),
         1: _rank_doc(1, 100.0, [_coll_ev("s/a", 0, 10_000, 1_000)])},
        {0: _hb(0, 100.0, 0.0), 1: _hb(1, 100.0, 2.0)}),
    "no_heartbeats": (
        {0: _rank_doc(0, 100.0, [_coll_ev("s/a", 0, 10_000, 1_000)]),
         1: _rank_doc(1, 103.0, [_coll_ev("s/a", 0, 10_000, 1_000)])},
        {}),
    "one_sample": (
        {0: _rank_doc(0, 50.0, [_coll_ev("s/a", 0, 10_000, 1_000)]),
         1: _rank_doc(1, 80.0, [_coll_ev("s/a", 0, 12_000, 1_000)])},
        {0: _hb(0, 50.0, 0.0), 1: _hb(1, 80.0, 3.0, n=1)}),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_traces_equals_the_jax_merge(case):
    docs, hb = MERGE_CASES[case]
    want = jmerge.merge_traces(json.loads(json.dumps(docs)),
                               json.loads(json.dumps(hb)))
    got = tmerge.merge_traces(json.loads(json.dumps(docs)),
                              json.loads(json.dumps(hb)))
    assert got == want
    assert tmerge.clock_offsets(hb) == jmerge.clock_offsets(hb)


def _write_run(d, hb_dir):
    from wormhole_tpu_torch.obs.heartbeat import heartbeat_path
    os.makedirs(hb_dir, exist_ok=True)
    for rank, delay in ((0, 0), (1, 5_000)):
        doc = _rank_doc(rank, 100.0,
                        [_coll_ev("s/a", 0, 10_000 + delay, 1_000)])
        name = "trace.json" if rank == 0 else f"trace.r{rank}.json"
        with open(os.path.join(d, name), "w") as f:
            json.dump(doc, f)
        with open(heartbeat_path(hb_dir, rank), "w") as f:
            for rec in _hb(rank, 100.0, 0.0):
                f.write(json.dumps(rec) + "\n")
        with open(os.path.join(hb_dir, f"host{rank}.timeline.jsonl"),
                  "w") as f:
            for i in range(3):
                f.write(json.dumps({"ts": 1100.0 + i + rank,
                                    "mono": 100.0 + i, "rank": rank,
                                    "seq": i, "ex_per_sec": 10.0 * i})
                        + "\n")


def test_merge_run_files_equal_the_jax_merge(tmp_path):
    """``merge_run`` and ``merge_timelines`` of either package on the same
    per-rank files (written afresh into one directory, so the paths the
    reports name agree): the same merged trace, skew report and merged
    timeline."""
    import shutil
    out = {}
    d = tmp_path / "run"
    for name, mod in (("jax", jmerge), ("port", tmerge)):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        _write_run(str(d), str(d / "hb"))
        merged_path, report = mod.merge_run(str(d), str(d / "hb"))
        tl_path, tl_report = mod.merge_timelines(str(d / "hb"))
        out[name] = (open(merged_path).read(),
                     open(d / mod.SKEW_REPORT).read(), report,
                     open(tl_path).read(), tl_report)
        assert mod.merge_run(str(tmp_path / "missing")) is None
    assert out["port"] == out["jax"]
    assert out["port"][2]["worst"]["rank"] == 1
    assert out["port"][4]["samples"] == 6


# -- the hub, the flight recorder and the fault hooks ---------------------------

def test_obs_hub_files_equal_the_jax_hub(tmp_path, clock):
    files = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        clock()
        d = tmp_path / name
        cfg = pkg["Config"](trace_path=str(d / "trace.json"),
                            metrics_export=str(d / "m"), heartbeat_itv=0.0)
        hub = pkg["obs"].setup(cfg, 0, registry=pkg["obs"].Registry())
        assert hub.active and hub.tick_due()
        timer, feed, _ = drive(pkg, str(d / "trace.json"))
        hub.heartbeat_tick(step=2, num_ex=200, feed_stall=0.5)
        prog = pkg["progress"].Progress()
        prog.num_ex = 200
        hub.finalize(step=3, num_ex=300, feed_stall=0.5, timer=timer,
                     progress=prog, feed_stats=feed.stats(), wall_s=0.25)
        files[name] = {
            "trace": open(d / "trace.json").read(),
            "hb": [{k: v for k, v in json.loads(ln).items()
                    if k != "ledger/est_mxu_util"}
                   for ln in open(d / "m" / "host0.hb.jsonl")],
            "prom": [ln for ln in open(d / "m" / "host0.prom").read()
                     .splitlines() if "est_mxu_util" not in ln]}
    assert files["port"] == files["jax"]
    assert "trace_dropped_spans" in "\n".join(files["port"]["prom"])


def test_obs_env_fallbacks_and_finalize_never_raises(tmp_path, monkeypatch):
    monkeypatch.setenv(tobs.METRICS_EXPORT_ENV, str(tmp_path / "m"))
    monkeypatch.setenv(tobs.TRACE_EXPORT_ENV, str(tmp_path / "tr"))
    for pkg in (JAX, PORT):
        hub = pkg["obs"].setup(pkg["Config"](), 2,
                               registry=pkg["obs"].Registry())
        pkg["hub"] = (hub.export_dir, hub.trace_path)
        pkg["obs"].trace.disable()
    assert PORT["hub"] == JAX["hub"] == (
        str(tmp_path / "m"), str(tmp_path / "tr" / "trace.r2.json"))
    monkeypatch.delenv(tobs.METRICS_EXPORT_ENV)
    monkeypatch.delenv(tobs.TRACE_EXPORT_ENV)
    hub = tobs.setup(TConfig(), 0, registry=tobs.Registry())
    assert not hub.active
    hub.finalize(mesh=object())          # the world-of-one merge
    bad = tobs.Obs(trace_path=str(tmp_path / "t.json"),
                   registry=tobs.Registry())
    bad.registry = None                  # every ingest now fails
    bad.finalize(timer=ttimer.Timer())   # never raises into the caller


def test_flight_bundle_equals_the_jax_bundle(tmp_path, clock, monkeypatch):
    """``record`` called directly (the drain edge waits for the
    supervisor): the same bundle files as the JAX recorder's."""
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        tl = pkg["timeline"]
        monkeypatch.setattr(tl, "read_rss_bytes", lambda: 4096.0)
        monkeypatch.setattr(tl, "read_device_mem_bytes", lambda: 0.0)
        clock()
        reg = pkg["obs"].Registry()
        reg.counter("feed/batches").inc(5)
        smp = tl.TimelineSampler(registry=reg, interval_s=1.0, path="",
                                 rank=0)
        smp.sample_once()
        rec = pkg["obs"].FlightRecorder(str(tmp_path / name), sampler=smp,
                                        window_s=30.0, rank=0)
        pkg["flight"].install(rec)
        try:
            bdir = pkg["flight"].record("drain", step=7, note="test")
            assert pkg["flight"].record("drain", step=8) == ""   # once
        finally:
            pkg["flight"].uninstall()
        assert pkg["flight"].record("drain", step=9) == ""   # disarmed
        out[name] = {f: open(os.path.join(bdir, f)).read()
                     for f in sorted(os.listdir(bdir))}
        out[name + "_dir"] = os.path.basename(bdir)
    meta = json.loads(out["port"]["flight.json"])
    assert meta["reason"] == "drain" and meta["step"] == 7
    assert sorted(out["port"]) == ["flight.json", "registry.json",
                                   "timeline.jsonl"]
    assert out["port"] == out["jax"]
    assert out["port_dir"] == out["jax_dir"] == "flight_drain_7"


def test_chaos_plan_and_checkpoint_fault(monkeypatch):
    cfg = TConfig(chaos_ckpt_errors=1, chaos_heartbeat_delay_s=0.0)
    try:
        for mod in (jchaos, tchaos):
            assert mod.install_from_config(cfg, 0)
            with pytest.raises(OSError, match="injected"):
                mod.ckpt_fault("x")
            mod.ckpt_fault("x")            # the retry goes through
            mod.tick_block(5)              # no kill planned for rank 0
        assert not tchaos.install_from_config(TConfig(), 0)
        assert not tchaos.active()
        monkeypatch.setenv(tchaos.ATTEMPT_ENV, "1")   # a relaunch is clean
        assert not tchaos.install_from_config(cfg, 0)
    finally:
        jchaos.reset()
        tchaos.reset()


def test_watchdog_off_by_default_and_fires_on_timeout():
    assert twatchdog.configure(0.0) is None
    with twatchdog.guard("x"):
        pass
    fired = []
    try:
        wd = twatchdog.configure(0.05, exit_fn=fired.append)
        with twatchdog.guard("collective:test"):
            deadline = time.monotonic() + 5.0
            while not fired and time.monotonic() < deadline:
                time.sleep(0.01)
        assert fired == ["collective:test"] and wd.fired_site == fired[0]
    finally:
        twatchdog.shutdown()
    assert twatchdog.get() is None and twatchdog.PEER_LOST == 117
