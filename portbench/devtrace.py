"""The traced window: ``torch.profiler`` on the device, the program's host
spans in memory, and their reduction to device ops, busy time, idle gaps
labelled by what the host was doing, and the breakdown the result line
carries.

Only CUDA activity is recorded (kernels, copies, sets), which keeps a
10-second window of some hundred thousand launches cheap to read. The
device clock is tied to the host's by a marker: right after a
synchronize, the host notes its clock and a one-microsecond spin kernel
starts; the kernel's start in the trace is that host instant. Where the
trace lost the marker, the window's first and last device ops bound it.
"""

from __future__ import annotations

import re
import sys
import time
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Dict, List

import torch

MARKER = "portbench:marker"


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    kind: str        # kernel, memcpy, memset


@dataclass
class Trace:
    ops: List[DeviceOp] = field(default_factory=list)
    window_ns: int = 0
    busy_ns: int = 0
    gaps: Dict[str, float] = field(default_factory=dict)


def short_name(name: str) -> str:
    """A kernel name without parameters, return type or namespaces of
    templates: ``wh::fwd_rows<...>(...)`` -> ``fwd_rows``."""
    n = name.replace("(anonymous namespace)::", "")
    n = n.split("(")[0].removeprefix("void ").strip()
    n = re.sub(r"<.*", "", n)
    return n.rsplit("::", 1)[-1] or name


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


class Tracer:
    """Start with ``start()`` right before the window, end with
    ``stop()`` right after its synchronize."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        from wormhole_tpu_torch.obs import trace as host_trace
        self._host = host_trace
        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self):
        self._host.enable(ring=1 << 21)
        self._prof.__enter__()
        torch.cuda.synchronize()
        self.t0_host = time.monotonic()
        self._host.complete(MARKER, self.t0_host, 0.0)
        torch.cuda._sleep(1000)

    def stop(self) -> Trace:
        torch.cuda.synchronize()
        t1_host = time.monotonic()
        self._prof.__exit__(None, None, None)
        spans = self._host.events()
        self._host.disable()
        ops = []
        marker_ns = None
        for e in self._prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            name = e.name()
            if marker_ns is None and "spin_kernel" in name:
                marker_ns = e.start_ns()
                continue
            ops.append(DeviceOp(name, e.start_ns(), e.duration_ns(),
                                _kind(name)))
        if marker_ns is not None:
            end_ns = marker_ns + int((t1_host - self.t0_host) * 1e9)
        elif ops:
            # no marker kernel in the trace: the window's first and last
            # device ops bound it instead
            print(f"portbench: the trace holds no marker kernel among "
                  f"{len(ops)} device ops; the window is taken from the "
                  "first to the last of them", file=sys.stderr)
            marker_ns = min(o.start_ns for o in ops)
            end_ns = max(o.start_ns + o.dur_ns for o in ops)
        else:
            raise RuntimeError("the profiler recorded no device op")
        ops = [o for o in ops if o.start_ns >= marker_ns]
        ops.sort(key=lambda o: o.start_ns)
        tr = Trace(ops=ops, window_ns=end_ns - marker_ns)
        tr.busy_ns, gaps = _busy_and_gaps(ops, marker_ns, end_ns)
        tr.gaps = _label_gaps(gaps, spans, marker_ns)
        return tr


def _busy_and_gaps(ops: List[DeviceOp], t0: int, t1: int):
    """(union of the ops' intervals in ns, idle gaps [(start, end)])."""
    busy = 0
    gaps = []
    cur_s, cur_e = None, t0
    for o in ops:
        s, e = o.start_ns, o.start_ns + o.dur_ns
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if t1 > cur_e:
        gaps.append((cur_e, t1))
    return busy, gaps


def _label_gaps(gaps, spans: list, marker_ns: int) -> Dict[str, float]:
    """Idle seconds by what the consumer thread (the one that set the
    marker) was doing: each gap's time goes to the innermost host span
    open over it, piece by piece, and to ``host:between spans`` where none
    is."""
    marker = next((s for s in spans if s["name"] == MARKER), None)
    if marker is None:
        return {}
    tid, base_us = marker["tid"], marker["ts"]
    # the spans of one thread nest: a sweep over their ends gives the
    # innermost open span of every stretch of the thread's time
    edges = []
    for s in spans:
        if s.get("ph") != "X" or s["tid"] != tid or s["name"] == MARKER:
            continue
        t0 = s["ts"]
        t1 = t0 + s.get("dur", 0.0)
        edges.append((t0, 1, -t1, s["name"]))
        edges.append((t1, 0, 0.0, s["name"]))
    edges.sort()
    segs = []             # (start_us, end_us, label)
    stack: List[str] = []
    last = None
    for t, opening, _, name in edges:
        if last is not None and t > last:
            segs.append((last, t, stack[-1] if stack else None))
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        last = t
    out: Dict[str, float] = {}
    starts = [sg[0] for sg in segs]
    for g0, g1 in gaps:
        a = base_us + (g0 - marker_ns) / 1e3
        b = base_us + (g1 - marker_ns) / 1e3
        covered = 0.0
        i = max(bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            s0, s1, label = segs[i]
            ov = min(s1, b) - max(s0, a)
            if ov > 0 and label is not None:
                out[label] = out.get(label, 0.0) + ov / 1e6
                covered += ov
            i += 1
        rest = (b - a) - covered
        if rest > 0:
            out["host:between spans"] = (out.get("host:between spans", 0.0)
                                         + rest / 1e6)
    return out


def kernel_seconds(tr: Trace, names=None, exclude=None) -> float:
    """Device seconds of the kernels whose short name is in ``names`` (all
    kernels if None) and not in ``exclude``."""
    tot = 0
    for o in tr.ops:
        if o.kind != "kernel":
            continue
        n = short_name(o.name)
        if names is not None and n not in names:
            continue
        if exclude is not None and n in exclude:
            continue
        tot += o.dur_ns
    return tot / 1e9


def breakdown(tr: Trace) -> dict:
    """The ten device ops that took most time, and the ten largest idle
    totals by host activity, each [name, seconds]."""
    by: Dict[str, int] = {}
    for o in tr.ops:
        key = o.name if o.kind != "kernel" else short_name(o.name)
        by[key] = by.get(key, 0) + o.dur_ns
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v / 1e9] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


