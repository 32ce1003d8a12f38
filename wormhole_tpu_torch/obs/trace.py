"""Span tracing: a bounded, thread-aware trace recorder.

The counterpart of ``wormhole_tpu/obs/trace.py``, with the same span
names, categories and file layout, so a trace of either package reads the
same (``tests/test_torch_obs.py`` holds the two byte-equal on one event
sequence).

Dapper-style spans (Sigelman et al., 2010) over the hot paths this repo
already times — DeviceFeed stages, device step dispatch/wait, collective
boundaries, GBDT histogram kernels and chunk reads, checkpoint save/load
— emitted as Chrome trace-event JSON that loads directly in Perfetto
(ui.perfetto.dev) or chrome://tracing.

Design constraints, in order:

1. **Near-zero cost when off.** Tracing is off by default; every record
   call starts with one module-global bool check and returns. The
   instrumented paths (``Timer.scope``, DeviceFeed stages) are
   per-*batch*, not per-row, so even enabled tracing is noise next to a
   device step.
2. **Bounded memory.** Events land in a ``deque(maxlen=ring)`` — a long
   run keeps the freshest window instead of growing without bound
   (the dist_monitor.h rate-limit philosophy applied to traces).
3. **Thread attribution.** Events carry the recording thread's id and
   the first event per thread registers its name, so the pipeline's
   dispatcher / prep workers / transfer thread / consumer render as
   separate Perfetto tracks and stage overlap is visible.

Events are stored as tuples and formatted only at :func:`flush`; the
record path does no dict building, no JSON, no I/O.

**Store-step stages.** The tile train steps mark their stages with
:func:`stage` (``step:pull``, ``step:kernel``, ``step:spill``,
``step:update``, ``step:tail``, category ``step``): each call closes the
thread's open stage as a host span and opens the next. On a CUDA device
each boundary also records a timing event on the current stream, from a
reused pool; :func:`resolve_stages` turns the completed ones into the
device time of each stage, with no synchronize of its own: a complete
event ``device:<stage>`` (category ``device``) on the ``device`` track
(:data:`DEVICE_TID`), on the host ``time.monotonic()`` clock through one
anchor event recorded right after a synchronize at the first traced
boundary, and one ``sink(name, seconds)`` call per stage and step (the
learner's ``Timer.add``). At most :data:`STAGE_MARKS` boundaries wait
unresolved; past that they are dropped and counted
(:func:`stages_dropped`).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Iterator, Optional

__all__ = ["enable", "disable", "enabled", "configure", "complete",
           "span", "instant", "counter", "events", "summary", "reset",
           "dropped", "flush", "write_trace", "stage", "resolve_stages",
           "stages_dropped", "clock_drift_s"]

# module-global fast path: `if not _ENABLED: return` is the entire cost
# of every record call while tracing is off
_ENABLED = False
_RING: "deque" = deque(maxlen=1)
_PATH: Optional[str] = None
_PID = 0
_T0 = 0.0                      # monotonic base; ts are relative to it
_WALL_T0 = 0.0                 # wall clock at _T0 (merge.py alignment)
_DROPPED = 0                   # ring evictions since configure()
_TID_NAMES: dict = {}          # tid -> thread name (first event wins)

# store-step stages (see the module docstring); cleared by configure()
DEVICE_TID = 1                 # the device track: no OS thread's ident
STAGE_MARKS = 4096             # unresolved device boundaries held at most
_STAGE_OPEN: dict = {}         # tid -> (stage, host t0, its mark, totals)
_MARKS: "deque" = deque()      # unresolved device boundaries, oldest first
_EVENT_POOL: list = []         # timing events free for reuse
_ANCHOR = None                 # (timing event, monotonic s) after a sync
_STAGE_DROPPED = 0             # boundaries not recorded: _MARKS was full

# event tuples: (ph, name, cat, ts_us, dur_us, tid, arg)
_PH_COMPLETE = "X"
_PH_INSTANT = "i"
_PH_COUNTER = "C"


def _rank() -> int:
    """Process rank without forcing a ``torch.distributed`` import: an
    initialized process group's rank when one exists, else the launcher's
    PROCESS_ID env, then 0."""
    import sys
    d = sys.modules.get("torch.distributed")
    if d is not None:
        try:
            if d.is_available() and d.is_initialized() \
                    and d.get_world_size() > 1:
                return int(d.get_rank())
        except Exception:
            pass
    return int(os.environ.get("PROCESS_ID", "0"))


def configure(trace_path: str = "", ring: int = 1 << 16,
              enabled: Optional[bool] = None,
              pid: Optional[int] = None) -> None:
    """(Re)configure the global recorder. ``trace_path`` non-empty (or
    ``enabled=True`` for a ring-only, no-file session) turns tracing on;
    both empty/False turns it off and drops buffered events. ``pid``
    overrides the recorder's process rank (the Obs hub passes the rank
    it was constructed with — authoritative over the env sniffing)."""
    global _ENABLED, _RING, _PATH, _PID, _T0, _WALL_T0, _DROPPED
    global _ANCHOR, _STAGE_DROPPED
    on = bool(trace_path) if enabled is None else enabled
    _PATH = trace_path or None
    _STAGE_OPEN.clear()
    _EVENT_POOL.clear()
    _MARKS.clear()
    _ANCHOR = None
    _STAGE_DROPPED = 0
    if on:
        _RING = deque(maxlen=max(int(ring), 16))
        _TID_NAMES.clear()
        _PID = _rank() if pid is None else int(pid)
        _T0 = time.monotonic()
        _WALL_T0 = time.time()
        _DROPPED = 0
    _ENABLED = on
    if not on:
        _RING = deque(maxlen=1)
        _TID_NAMES.clear()


def enable(trace_path: str = "", ring: int = 1 << 16,
           pid: Optional[int] = None) -> None:
    configure(trace_path, ring, enabled=True, pid=pid)


def disable() -> None:
    configure("", enabled=False)


def enabled() -> bool:
    return _ENABLED


def _record(ph: str, name: str, cat: str, ts: float, dur: float,
            arg=None, tid: Optional[int] = None) -> None:
    global _DROPPED
    if tid is None:
        t = threading.current_thread()
        tid = t.ident or 0
        if tid not in _TID_NAMES:
            _TID_NAMES[tid] = t.name
    if len(_RING) == _RING.maxlen:
        # the append below silently evicts the oldest event; count it so
        # a truncated trace is detectable (summary counter + flush
        # metadata). Approximate under racing writers — it's a tally,
        # not an index.
        _DROPPED += 1
    # deque.append is atomic under the GIL — no lock on the record path
    _RING.append((ph, name, cat, (ts - _T0) * 1e6, dur * 1e6, tid, arg))


def complete(name: str, t0: float, dur: float, cat: str = "",
             args: Optional[dict] = None) -> None:
    """Record a completed span: ``t0`` is the ``time.monotonic()`` start,
    ``dur`` seconds. This is the hot-path entry point — callers that
    already measured a duration (Timer.scope, DeviceFeed stages) hand it
    over instead of paying a second context-manager frame. ``args``
    (optional dict) lands as the event's Perfetto args panel."""
    if not _ENABLED:
        return
    _record(_PH_COMPLETE, name, cat, t0, dur,
            dict(args) if args else None)


@contextmanager
def span(name: str, cat: str = "",
         args: Optional[dict] = None) -> Iterator[None]:
    """``with trace.span("checkpoint:save"): ...`` — a no-op (single
    bool check) while tracing is off. A mutable ``args`` dict may be
    filled *inside* the span (payload sizes known only after encoding);
    it is snapshotted when the span closes."""
    if not _ENABLED:
        yield
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        _record(_PH_COMPLETE, name, cat, t0, time.monotonic() - t0,
                dict(args) if args else None)


class _Mark:
    """One device boundary: its event (None once resolved), the stage it
    opens (None at the step's end), the boundary before it on its thread
    (None after a drop), its device time from the anchor in seconds once
    resolved, and its step's per-stage device totals."""
    __slots__ = ("ev", "opens", "prev", "t", "totals")

    def __init__(self, ev, opens, prev, totals):
        self.ev, self.opens, self.prev = ev, opens, prev
        self.t, self.totals = None, totals


def _new_event():
    import torch
    return torch.cuda.Event(enable_timing=True)


def _synchronize() -> None:
    import torch
    torch.cuda.synchronize()


def stage(name: Optional[str], device=None) -> None:
    """Store-step stage boundary: close this thread's open stage and open
    ``name`` (None only closes: the step's end). On a CUDA ``device`` the
    boundary is also a timing event on the current stream. A single bool
    check while tracing is off."""
    if not _ENABLED:
        return
    _stage(name, device is not None and device.type == "cuda")


def _stage(name: Optional[str], cuda: bool) -> None:
    global _ANCHOR, _STAGE_DROPPED
    if cuda and _ANCHOR is None:
        # host-sync: once per trace session, the anchor that puts the
        # device track on the host clock
        _synchronize()
        ev = _new_event()
        _ANCHOR = (ev, time.monotonic())
        ev.record()
    tid = threading.get_ident()
    open_ = _STAGE_OPEN.pop(tid, None)
    now = time.monotonic()
    prev, totals = None, {}
    if open_ is not None:
        _record(_PH_COMPLETE, open_[0], "step", open_[1], now - open_[1])
        prev, totals = open_[2], open_[3]
    mark = None
    if cuda:
        if len(_MARKS) >= STAGE_MARKS:
            _STAGE_DROPPED += 1
        else:
            ev = _EVENT_POOL.pop() if _EVENT_POOL else _new_event()
            ev.record()
            mark = _Mark(ev, name, prev, totals)
            _MARKS.append(mark)
    if name is not None:
        # a fresh clock read: the next span starts after this boundary's
        # bookkeeping, so sibling spans never overlap once rounded to the
        # trace's ns (the ledger would clamp the later one away)
        _STAGE_OPEN[tid] = (name, time.monotonic(), mark, totals)


def resolve_stages(sink=None) -> int:
    """Turn the completed device boundaries, oldest first, into stage
    intervals: each goes to the ring as ``device:<stage>`` on the device
    track, and at a step's end ``sink("device:<stage>", seconds)`` is
    called once for each stage of that step. Only boundaries whose event
    ``query()`` is true resolve; nothing waits. Returns the steps
    handed to ``sink``."""
    if not _MARKS:
        return 0
    anchor_ev, anchor_t = _ANCHOR
    steps = 0
    while _MARKS and _MARKS[0].ev.query():
        m = _MARKS.popleft()
        m.t = anchor_ev.elapsed_time(m.ev) / 1e3
        _EVENT_POOL.append(m.ev)
        m.ev = None
        p, m.prev = m.prev, None
        if p is not None and p.t is not None:
            if DEVICE_TID not in _TID_NAMES:
                _TID_NAMES[DEVICE_TID] = "device"
            dur = m.t - p.t
            _record(_PH_COMPLETE, "device:" + p.opens, "device",
                    anchor_t + p.t, dur, tid=DEVICE_TID)
            m.totals[p.opens] = m.totals.get(p.opens, 0.0) + dur
        if m.opens is None:
            if sink is not None:
                for k, v in m.totals.items():
                    sink("device:" + k, v)
            steps += 1
    return steps


def stages_dropped() -> int:
    """Device boundaries not recorded since :func:`configure` because
    :data:`STAGE_MARKS` were waiting unresolved."""
    return _STAGE_DROPPED


def clock_drift_s() -> Optional[float]:
    """The device clock's advance since the anchor less the host clock's,
    in seconds, read through a fresh event after a synchronize (None
    before any CUDA stage boundary). A diagnostic: it waits on the
    device, so never call it inside a step loop."""
    if _ANCHOR is None:
        return None
    _synchronize()  # host-sync: a diagnostic outside the step loop
    t = time.monotonic()
    ev = _new_event()
    ev.record()
    ev.synchronize()  # host-sync: the same diagnostic
    return _ANCHOR[0].elapsed_time(ev) / 1e3 - (t - _ANCHOR[1])


def instant(name: str, cat: str = "") -> None:
    if not _ENABLED:
        return
    _record(_PH_INSTANT, name, cat, time.monotonic(), 0.0)


def counter(name: str, value: float, cat: str = "") -> None:
    """Chrome counter-track sample (rendered as a line chart)."""
    if not _ENABLED:
        return
    _record(_PH_COUNTER, name, cat, time.monotonic(), 0.0, float(value))


def events() -> list:
    """Buffered events as trace-event dicts (the flush format)."""
    out = []
    for ph, name, cat, ts, dur, tid, arg in list(_RING):
        ev = {"ph": ph, "name": name, "pid": _PID, "tid": tid,
              "ts": round(ts, 3)}
        if cat:
            ev["cat"] = cat
        if ph == _PH_COMPLETE:
            ev["dur"] = round(dur, 3)
            if arg:
                ev["args"] = arg
        elif ph == _PH_INSTANT:
            ev["s"] = "t"
        elif ph == _PH_COUNTER:
            ev["args"] = {"value": arg}
        out.append(ev)
    return out


def summary() -> dict:
    """Aggregate buffered complete-spans: name -> {count, total_s}.
    The bench folds this per-phase view into its --out JSON."""
    agg: dict = {}
    for ph, name, _cat, _ts, dur, _tid, _arg in list(_RING):
        if ph != _PH_COMPLETE:
            continue
        row = agg.setdefault(name, {"count": 0, "total_s": 0.0})
        row["count"] += 1
        row["total_s"] += dur / 1e6
    for row in agg.values():
        row["total_s"] = round(row["total_s"], 6)
    return agg


def dropped() -> int:
    """Ring evictions since :func:`configure` — events silently lost to
    the bounded buffer. Cumulative across :func:`reset` (phase resets
    keep the run-level truncation visible)."""
    return _DROPPED


def reset() -> None:
    _RING.clear()


def write_trace(path: str, evs: list) -> str:
    """Write ``evs`` (trace-event dicts, e.g. accumulated :func:`events`
    batches) plus the recorder's thread/process metadata as a Chrome
    trace-event JSON file (atomic tmp+replace). The bench uses this to
    merge per-phase event batches into one viewable file.

    The doc carries a ``metadata`` block (Perfetto ignores unknown
    top-level keys): the recorder's rank, its monotonic/wall time bases
    (obs/merge.py aligns per-rank files on these), and the drop count —
    a nonzero ``dropped_spans`` marks the trace as truncated."""
    evs = list(evs)
    for tid, tname in sorted(_TID_NAMES.items()):
        evs.append({"ph": "M", "name": "thread_name", "pid": _PID,
                    "tid": tid, "args": {"name": tname}})
    evs.append({"ph": "M", "name": "process_name", "pid": _PID,
                "args": {"name": f"wormhole-host{_PID}"}})
    doc = {"traceEvents": evs, "displayTimeUnit": "ms",
           "metadata": {"rank": _PID, "mono_t0": round(_T0, 6),
                        "wall_t0": round(_WALL_T0, 6),
                        "dropped_spans": _DROPPED}}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def flush(path: Optional[str] = None) -> Optional[str]:
    """Write buffered events (plus per-thread name metadata) as Chrome
    trace-event JSON. Returns the path written, or None when tracing is
    off / no destination is configured."""
    dst = path or _PATH
    if not _ENABLED or not dst:
        return None
    return write_trace(dst, events())
