"""Step ledger: per-step wall-time attribution from trace spans.

The counterpart of ``wormhole_tpu/obs/ledger.py``: the same buckets, span
table and sweep, so one event list gives both packages the same record
(``tests/test_torch_obs.py``). The JAX record's ``est_mxu_util`` (its
device share times a TPU kernel-floor fraction) has no meaning on a GPU and
is left out; the card's kernel times against their bounds come from
``chip_smoke.py``. This module folds the spans the repo already records (Timer.scope keys, DeviceFeed
stage spans, collective/checkpoint spans) into a small set of named
buckets and an explicit ``unattributed`` remainder, so the buckets
provably sum to the measured wall time instead of silently double- or
under-counting.

Two properties make the accounting honest:

1. **Self-time, not span totals.** Spans nest (``collective:*`` inside
   ``collective:metrics_window``; feed stage spans inside the consume
   loop when ``workers=0``) and worker-thread spans overlap the consumer
   wall-clock. The ledger therefore (a) only attributes spans recorded
   on ONE thread (the step loop's — callers pass or default to the
   current thread), and (b) sweeps them into *self time*: each instant
   is charged to the innermost span covering it, so the bucket seconds
   partition the covered timeline exactly.
2. **Explicit remainder.** ``unattributed = wall - sum(buckets)`` is
   always reported (never clamped, never hidden) — a large remainder
   means uninstrumented work, a negative one means clock noise or a
   mis-nested span, and both are visible in the run's Prometheus dump.

:data:`SPAN_TABLE` is the single declaration site for every span name
the instrumentation emits — a renamed span that never lands in a bucket
is a hole in the ledger (the JAX package lints its own sites against its
copy of the table).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["SPAN_TABLE", "BUCKETS", "span_bucket", "build",
           "to_registry"]

# Ledger buckets. ``host_prep`` (parse/localize/pad) and ``other``
# (checkpoint I/O, GBDT chunk reads) extend the core six so the step
# loop's whole timeline lands somewhere nameable; ``paging`` isolates
# bigmodel hot/cold tier traffic (bigmodel/paged.py) from the batch
# H2D bucket — the whole point of the cold tier is that this bucket
# stays small while nb outgrows HBM; ``unattributed`` is computed,
# never declared.
BUCKETS = ("encode", "h2d_transfer", "device_compute", "collective_wait",
           "metrics_readback", "host_prep", "residual_stall", "paging",
           "other")

# Central span-name table: every instrumentation-site span name (or
# ``prefix*`` pattern for f-string sites) -> ledger bucket. Timer.scope
# keys carry no category; DeviceFeed stage spans are ``<feed>:<stage>``
# and resolve through the stage rules in :func:`span_bucket`; ``eval_``
# prefixed Timer keys fold onto their train-pass base name.
SPAN_TABLE: Dict[str, str] = {
    # host-side batch preparation (Timer.scope keys)
    "parse": "host_prep",
    "localize": "host_prep",
    "pad": "host_prep",
    "prep": "host_prep",
    # online tile encoding (DeviceFeed prep_label + timer key)
    "encode": "encode",
    # host->device transfer (DeviceFeed put stage / put_time)
    "put": "h2d_transfer",
    # device step dispatch + blocking wait on inflight results
    "dispatch": "device_compute",
    "wait": "device_compute",
    # multi-device mesh path: group dispatch and the spill scatter step
    # are device work; the sync-mode hot-loop group stack is host prep
    # (the ring mode moves it into the feed's ``stack`` stage below)
    "mesh:dispatch": "device_compute",
    # transport-wrapped mesh dispatch (MeshTransport.dispatch); same
    # bucket as mesh:dispatch so routing through the transport layer
    # does not shift ledger attribution
    "collective:mesh": "device_compute",
    "mesh:spill": "device_compute",
    "mesh:stack": "host_prep",
    "stack": "host_prep",
    # metrics ticket readback on the host
    "read": "metrics_readback",
    "collective:metrics_window": "metrics_readback",
    # residual stalls (ring empty/full, stage starvation); dynamic feed
    # stall spans (<feed>:<stage>_stall) resolve via the _stall rule
    "feed_stall": "residual_stall",
    "consume_stall": "residual_stall",
    # L-BFGS / GBDT device work
    "grad": "device_compute",
    "direction": "device_compute",
    "linesearch": "device_compute",
    "gbdt_hist": "device_compute",
    # host collectives (per-site seq-stamped; see obs/merge.py)
    "collective:allreduce_*": "collective_wait",
    "collective:allgather": "collective_wait",
    "collective:broadcast": "collective_wait",
    "collective:ckpt_barrier": "collective_wait",
    # attributable but outside the step loop proper
    "checkpoint:*": "other",
    "gbdt:chunk_read": "other",
    # the tile train step (ops/tilemm.py): the store's step dispatch,
    # kernel launches and the on-device update, so the span is device
    # work
    "tilemm:fused_step": "device_compute",
    "tilemm:fused_multi": "device_compute",
    # the JAX package's one-hot cache variant (never taken on a GPU) and
    # the wide&deep MLP forward/vjp at the step's phase boundary
    "tilemm:fused_cached": "device_compute",
    "tilemm:mlp_phase": "device_compute",
    # the port's store-step stages inside the tile train step
    # (obs/trace.py ``stage``): host spans of the step's launches, nested
    # in the tilemm span where there is one
    "step:pull": "device_compute",
    "step:kernel": "device_compute",
    "step:spill": "device_compute",
    "step:update": "device_compute",
    "step:tail": "device_compute",
    # the same stages' device intervals, on the trace's device track
    # (trace.DEVICE_TID): build() attributes one thread only, so they
    # never add to the step loop's wall time
    "device:*": "device_compute",
    # online serving (serve/): the pull-only forward is device work;
    # the snapshot hot-swap is a reference assignment outside any step
    "serve:forward": "device_compute",
    "serve:swap": "other",
    # bounded-staleness exchange engine (ps/): the drain thread's
    # exchange span never lands in the step-loop ledger (wrong thread)
    # but must still resolve; the gate is the trainer actually blocked
    # on the wire, and the delta apply is a device push
    "ps:exchange": "collective_wait",
    "ps:gate": "collective_wait",
    "ps:apply": "device_compute",
    # live rank rejoin (ft/rejoin.py): the handshake is membership
    # bookkeeping off the step loop; the replay applies reduced deltas
    # to the restored store (device pushes)
    "rejoin:handshake": "other",
    "rejoin:replay": "device_compute",
    # bigmodel hot/cold tier paging (bigmodel/paged.py): page-row H2D
    # staging (through DeviceFeed.prepare), the eviction gather +
    # async-D2H dispatch, and the writeback-resolving host read. All
    # three land in the dedicated paging bucket so tier traffic never
    # masquerades as batch transfer or device compute.
    "page:h2d": "paging",
    "page:d2h": "paging",
    "page:evict": "paging",
}

# DeviceFeed stage -> bucket, for dynamic ``<feed>:<stage>`` span names
# (the feed name varies; the stage vocabulary is fixed in pipeline.py).
_FEED_STAGES = {"parse": "host_prep", "prep": "host_prep",
                "pad": "host_prep", "encode": "encode",
                "stack": "host_prep", "put": "h2d_transfer"}


def span_bucket(name: str, cat: str = "") -> Optional[str]:
    """Resolve a span name to its ledger bucket, or None for a span the
    table doesn't know (the caller decides whether that is ``other`` or
    a lint failure)."""
    b = SPAN_TABLE.get(name)
    if b is not None:
        return b
    if name.startswith("eval_"):
        return span_bucket(name[5:], cat)
    if name.endswith("_stall"):
        return "residual_stall"
    for pat, bucket in SPAN_TABLE.items():
        if pat.endswith("*") and name.startswith(pat[:-1]):
            return bucket
    if ":" in name:
        stage = name.rsplit(":", 1)[1]
        return _FEED_STAGES.get(stage)
    return None


def _self_times(spans: List[Tuple[float, float, str]]):
    """Innermost-wins sweep over ``(start, end, name)`` intervals on one
    thread: returns (name -> self time, total covered time). Properly
    nested spans (context managers) partition exactly; a partial overlap
    (a ``complete()`` with a back-dated start) is clamped to its
    enclosing span so no instant is charged twice."""
    out: Dict[str, float] = {}
    if not spans:
        return out, 0.0
    evs = sorted(spans, key=lambda x: (x[0], -x[1]))
    stack: List[Tuple[float, str]] = []   # (end, name), innermost last
    cursor = evs[0][0]
    covered = 0.0

    def charge(upto: float, name: str) -> None:
        nonlocal cursor, covered
        if upto > cursor:
            out[name] = out.get(name, 0.0) + (upto - cursor)
            covered += upto - cursor
            cursor = upto

    for s, e, name in evs:
        while stack and stack[-1][0] <= s:
            end0, nm0 = stack.pop()
            charge(end0, nm0)
        if stack:
            charge(s, stack[-1][1])
        if s > cursor:
            cursor = s                     # gap with no open span
        if stack and e > stack[-1][0]:
            e = stack[-1][0]               # clamp partial overlap
        if e > cursor:
            stack.append((e, name))
    while stack:
        end0, nm0 = stack.pop()
        charge(end0, nm0)
    return out, covered


def build(events: List[dict], wall_s: Optional[float] = None,
          tid: Optional[int] = None) -> dict:
    """Fold trace-event dicts (:func:`obs.trace.events` format) into the
    ledger record. Only complete-spans on ``tid`` (default: the calling
    thread, i.e. the step loop that just ran) are attributed; ``wall_s``
    is the measured wall time the buckets must sum to (default: the
    span extent, for callers without an outer clock)."""
    if tid is None:
        tid = threading.get_ident()
    spans = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
             for e in events
             if e.get("ph") == "X" and e.get("tid") == tid]
    self_us, covered_us = _self_times(spans)
    buckets = {b: 0.0 for b in BUCKETS}
    for name, us in self_us.items():
        buckets[span_bucket(name) or "other"] += us / 1e6
    extent_s = ((max(e for _s, e, _n in spans)
                 - min(s for s, _e, _n in spans)) / 1e6) if spans else 0.0
    if wall_s is None:
        wall_s = extent_s
    attributed = sum(buckets.values())
    unattributed = wall_s - attributed
    denom = max(wall_s, 1e-9)
    frac = {b: round(v / denom, 4) for b, v in buckets.items()}
    frac["unattributed"] = round(unattributed / denom, 4)
    device_frac = buckets["device_compute"] / denom
    return {
        "wall_s": round(wall_s, 6),
        "buckets_s": {b: round(v, 6) for b, v in buckets.items()},
        "unattributed_s": round(unattributed, 6),
        "frac": frac,
        "attributed_frac": round(attributed / denom, 4),
        # device-bucket share of the wall
        "device_frac": round(device_frac, 4),
        "spans_attributed": len(spans),
    }


def to_registry(led: dict, reg=None) -> None:
    """Export a ledger record through the metrics registry: per-bucket
    seconds as sum-gauges (they add across hosts like timer seconds),
    the fractions as last-gauges. Names are ``ledger/<bucket>_seconds``
    etc. — derived from :data:`BUCKETS`, so this stays the single
    declaration site."""
    if reg is None:
        from .metrics import default_registry
        reg = default_registry()
    for b in BUCKETS:
        reg.gauge(f"ledger/{b}_seconds",
                  help=f"step ledger: seconds attributed to {b}",
                  agg="sum").value = led["buckets_s"][b]
    reg.gauge("ledger/unattributed_seconds",
              help="step ledger: wall time no span accounts for",
              agg="sum").value = led["unattributed_s"]
    reg.gauge("ledger/wall_seconds",
              help="step ledger: measured wall time the buckets sum to",
              agg="sum").value = led["wall_s"]
    reg.gauge("ledger/device_frac",
              help="step ledger: device_compute share of wall time"
              ).value = led["device_frac"]
