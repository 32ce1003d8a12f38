"""Staged host→device ingest pipeline (parse ∥ pad ∥ transfer).

The counterpart of ``DeviceFeed`` in ``wormhole_tpu/data/pipeline.py``. The
reference keeps a dedicated ``ThreadedParser`` behind every minibatch
iterator (``learn/linear/base/minibatch_iter.h:50``) so text parsing
overlaps the SGD step; ``DeviceFeed`` extends that to the whole feed path:

    source ──► dispatcher ──► work queue ──► prep workers (pool)
                   │                              │
               seq_ctx()                    results, by seq
             (sequential,                         │
              in order)                           ▼
                                     transfer thread (reorders to
                                     stream order, transfer)
                                         ──► ring ──► consumer

* the **dispatcher** iterates ``source`` and runs ``seq_ctx(item)``
  sequentially in stream order — shape-bucket state (monotone max_nnz
  growth) lives here, so every batch sees exactly the bucket value the
  serial path would have given it, no matter which worker pads it;
* ``workers`` **prep workers** run ``prep(item, ctx)`` concurrently
  (localize + pad: thread-safe and stateless);
* the **transfer thread** restores stream order by sequence number,
  runs ``transfer`` (the learner's pinned, ``non_blocking`` copy on a side
  stream) and keeps a ``ring_depth``-deep ring of device batches ahead of
  the consumer.

Contracts kept from the serial path: the same batches in the same order;
an error in any stage surfaces at the consumer after every batch that
precedes it; a consumer that abandons the iterator stops every thread
(all blocking operations are timed polls against a stop event);
``workers=0`` runs every stage inline on the consumer thread (the serial
fallback and the parity oracle of the tests). Per-stage busy/stall seconds
are kept under a lock and come out of ``drain_stats()``. The JAX package's
trace spans and ring counter come with the port's ``obs/`` (ROADMAP.md).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Optional

__all__ = ["DeviceFeed"]

_END = object()


class _StageError:
    """An exception captured in a pipeline stage, delivered to the
    consumer in sequence position (so batches that precede the failure
    still arrive, then the error raises — same as the serial path)."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


class DeviceFeed:
    """Chain source → prep workers → in-order transfer → device ring.

    Parameters
    ----------
    source:  iterable of raw items (blocks, chunks, indices…). Iterated
             on the dispatcher thread, in order.
    prep:    ``prep(item, ctx) -> result``; runs on the worker pool, so
             it must be thread-safe and must not mutate shared state.
             ``None`` passes items through.
    workers: worker-pool size; ``0`` runs the whole chain inline
             (serial fallback — no threads at all).
    ring_depth: device-resident batches kept ahead of the consumer.
    seq_ctx: ``seq_ctx(item) -> ctx``; runs on the dispatcher thread
             sequentially IN STREAM ORDER before the item is handed to
             a worker — the only safe place for order-dependent state
             like monotone shape buckets.
    transfer: ``transfer(payload) -> device item``; defaults to the
             identity (a host-side feed).
    """

    def __init__(self, source: Iterable[Any],
                 prep: Optional[Callable[[Any, Any], Any]] = None,
                 *, workers: int = 2, ring_depth: int = 2,
                 seq_ctx: Optional[Callable[[Any], Any]] = None,
                 transfer: Optional[Callable[[Any], Any]] = None,
                 name: str = "feed") -> None:
        if ring_depth < 1:
            raise ValueError("ring_depth must be >= 1")
        self.source = source
        self.prep = prep
        self.workers = max(int(workers), 0)
        self.ring_depth = ring_depth
        self.seq_ctx = seq_ctx
        self._transfer = transfer
        self.name = name
        self._lock = threading.Lock()
        # Stage accumulators are written from the dispatcher, prep-pool,
        # and consumer threads; every read-modify-write goes through
        # _acc() or an explicit `with self._lock` block.
        self._busy = {"parse": 0.0, "prep": 0.0, "put": 0.0}  # guarded-by: _lock
        self._stall = {"parse": 0.0, "prep": 0.0, "put": 0.0,  # guarded-by: _lock
                       "consume": 0.0}
        self._batches = 0  # guarded-by: _lock
        self._threads: list = []

    # -- stats ---------------------------------------------------------------

    def _acc(self, table: dict, key: str, dt: float) -> None:
        with self._lock:
            table[key] = table.get(key, 0.0) + dt

    def drain_stats(self) -> dict:
        """Per-stage busy/stall seconds (worker seconds sum over the pool,
        so busy can exceed wall time) and batches delivered; resets the
        accumulators."""
        with self._lock:
            snap = {k: v for k, v in self._busy.items()}
            snap.update({f"{k}_stall": v for k, v in self._stall.items()})
            snap["batches"] = self._batches
            for k in self._busy:
                self._busy[k] = 0.0
            for k in self._stall:
                self._stall[k] = 0.0
            self._batches = 0
        return snap

    # -- iteration -----------------------------------------------------------

    def __iter__(self):
        if self.workers == 0:
            return self._iter_serial()
        return self._iter_pipelined()

    def _default_transfer(self):
        if self._transfer is not None:
            return self._transfer
        return lambda payload: payload

    def _iter_serial(self):
        """Inline fallback: every stage on the consumer thread, same
        order/exception semantics, no threads (``pipeline_workers=0``)."""
        transfer = self._default_transfer()
        mono = time.monotonic
        it = iter(self.source)
        while True:
            t0 = mono()
            try:
                item = next(it)
            except StopIteration:
                self._acc(self._busy, "parse", mono() - t0)
                break
            ctx = self.seq_ctx(item) if self.seq_ctx else None
            self._acc(self._busy, "parse", mono() - t0)
            t0 = mono()
            res = self.prep(item, ctx) if self.prep else item
            self._acc(self._busy, "prep", mono() - t0)
            t0 = mono()
            out = transfer(res)
            self._acc(self._busy, "put", mono() - t0)
            with self._lock:
                self._batches += 1
            yield out

    def _iter_pipelined(self):
        transfer = self._default_transfer()
        mono = time.monotonic
        stop = threading.Event()
        work_q: "queue.Queue" = queue.Queue(maxsize=max(2 * self.workers, 2))
        ring: "queue.Queue" = queue.Queue(maxsize=self.ring_depth)
        done: dict = {}              # seq -> result | _StageError
        cond = threading.Condition()
        total = [None]               # [stream length] once known

        def put_or_stop(q: "queue.Queue", item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def dispatcher() -> None:
            seq = 0
            try:
                it = iter(self.source)
                while not stop.is_set():
                    t0 = mono()
                    try:
                        item = next(it)
                    except StopIteration:
                        self._acc(self._busy, "parse", mono() - t0)
                        break
                    ctx = self.seq_ctx(item) if self.seq_ctx else None
                    self._acc(self._busy, "parse", mono() - t0)
                    t0 = mono()
                    ok = put_or_stop(work_q, (seq, item, ctx))
                    self._acc(self._stall, "parse", mono() - t0)
                    if not ok:
                        return
                    seq += 1
            except BaseException as e:
                with cond:
                    done[seq] = _StageError(e)
                    total[0] = seq + 1
                    cond.notify_all()
            else:
                with cond:
                    total[0] = seq
                    cond.notify_all()
            finally:
                for _ in range(self.workers):
                    if not put_or_stop(work_q, _END):
                        break

        def worker() -> None:
            while not stop.is_set():
                t0 = mono()
                try:
                    task = work_q.get(timeout=0.2)
                except queue.Empty:
                    self._acc(self._stall, "prep", mono() - t0)
                    continue
                self._acc(self._stall, "prep", mono() - t0)
                if task is _END:
                    return
                seq, item, ctx = task
                t0 = mono()
                try:
                    res = self.prep(item, ctx) if self.prep else item
                except BaseException as e:
                    res = _StageError(e)
                self._acc(self._busy, "prep", mono() - t0)
                with cond:
                    done[seq] = res
                    cond.notify_all()

        def emit(payload) -> bool:
            """transfer + ring put; False when the consumer is gone."""
            t0 = mono()
            try:
                dev = transfer(payload)
            except BaseException as e:
                put_or_stop(ring, _StageError(e))
                return False
            self._acc(self._busy, "put", mono() - t0)
            return put_or_stop(ring, dev)

        def transferrer() -> None:
            nxt = 0
            while not stop.is_set():
                t0 = mono()
                with cond:
                    while nxt not in done and \
                            (total[0] is None or nxt < total[0]):
                        if stop.is_set():
                            return
                        cond.wait(timeout=0.2)
                    if total[0] is not None and nxt >= total[0]:
                        self._acc(self._stall, "put", mono() - t0)
                        break
                    res = done.pop(nxt)
                self._acc(self._stall, "put", mono() - t0)
                nxt += 1
                if isinstance(res, _StageError):
                    put_or_stop(ring, res)
                    return
                if not emit(res):
                    return
            if stop.is_set():
                return
            put_or_stop(ring, _END)

        threads = [threading.Thread(target=dispatcher, daemon=True,
                                    name=f"{self.name}-dispatch")]
        threads += [threading.Thread(target=worker, daemon=True,
                                     name=f"{self.name}-prep{i}")
                    for i in range(self.workers)]
        xfer = threading.Thread(target=transferrer, daemon=True,
                                name=f"{self.name}-xfer")
        threads.append(xfer)
        self._threads = threads
        for t in threads:
            t.start()
        try:
            while True:
                t0 = mono()
                try:
                    item = ring.get(timeout=0.5)
                except queue.Empty:
                    self._acc(self._stall, "consume", mono() - t0)
                    if not xfer.is_alive():
                        raise RuntimeError(
                            f"{self.name}: transfer thread died without "
                            "delivering end-of-stream")
                    continue
                self._acc(self._stall, "consume", mono() - t0)
                if item is _END:
                    break
                if isinstance(item, _StageError):
                    raise item.exc
                with self._lock:
                    self._batches += 1
                yield item
        finally:
            stop.set()
