"""Online sharded-SGD app — the flagship learner, on one device.

The counterpart of ``wormhole_tpu/learners/async_sgd.py``. It trains any
``algo`` (FTRL, SGD, AdaGrad and the delay-tolerant variants), validates,
predicts and saves the model, on one device:

    python -m wormhole_tpu_torch.learners.async_sgd train_data=<f.libsvm> \\
        val_data=<v.libsvm> num_buckets=4194304 max_data_pass=2 \\
        [algo=ftrl|sgd|adagrad|dt_sgd|dt_adagrad|dt2_adagrad] \\
        [data_format=libsvm|criteo|adfea|rec|recordio|crec2] \\
        [model_out=<model>] [test_data=<t> pred_out=<out>] [device=cpu]

``run`` warm-starts from ``model_in`` (a ``save_model`` text model of either
package), runs ``max_data_pass`` training passes over ``train_data`` with a
validation pass over ``val_data`` after each, then predicts ``test_data``
(one σ(margin) per real row to ``pred_out``) and saves ``model_out``.

Two data paths, as in the JAX app. The text and recordio formats stream
through the sparse path: ``MinibatchIter`` parses (the native C++ parser
where it builds) and re-slices into ``minibatch`` rows, the ``Localizer``
folds and deduplicates the keys and ``pad_to_batch`` pads them
(``pipeline_workers`` threads, ``DeviceFeed``), the batch crosses to the
device in pinned, ``non_blocking`` copies on a side stream, and
``store.train_step`` runs the sparse step with at most ``max_delay`` steps
in flight; ``dt2_adagrad`` trains through the split ``dt2_pull``/
``dt2_push`` pair, each push up to ``max_delay`` batches after its pull.
crec2 blocks go to the device as they are and run ``store.tile_train_step``
(the hand-written kernels in ``ops/csrc`` on a GPU; ``tile_step_kernel=auto``
resolves to the fused step there), whose metrics accumulate on the device
and come home once per window. Predict rides the pull-only ``ForwardStep``
when ``serve_predict`` is set.

The device is ``cuda`` unless ``device=cpu`` is given; the token is the
port's own and never enters ``Config``. Not ported yet, and raising
``NotImplementedError`` that names ROADMAP.md: crec v1, criteo/adfea with
``text_dense=true``, ``tile_online=on``, the multihost/staleness path
(``staleness_tau >= 0``), ``checkpoint_dir`` and ``cache_device``; remote
URI schemes raise in ``data/stream.py``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from wormhole_tpu_torch.data.crec import PackedFeed, read_header2
from wormhole_tpu_torch.data.feed import next_bucket, nnz_bucket, \
    pad_to_batch
from wormhole_tpu_torch.data.localizer import Localizer
from wormhole_tpu_torch.data.minibatch import MinibatchIter
from wormhole_tpu_torch.data.pipeline import DeviceFeed
from wormhole_tpu_torch.data.stream import open_stream
from wormhole_tpu_torch.device import DeviceLike, resolve_device, \
    split_device_arg
from wormhole_tpu_torch.learners.handles import DT2AdaGradHandle, \
    LearnRate, create_handle
from wormhole_tpu_torch.learners.store import ShardedStore, StoreConfig, \
    to_host_async
from wormhole_tpu_torch.ops.metrics import auc_from_hist, auc_np
from wormhole_tpu_torch.ops.penalty import L1L2
from wormhole_tpu_torch.sched.workload_pool import (TEST, TRAIN, VAL,
                                                    WorkloadPool)
from wormhole_tpu_torch.serve.forward import ForwardStep
from wormhole_tpu_torch.utils.config import Config, Penalty, load_config
from wormhole_tpu_torch.utils.logging import get_logger
from wormhole_tpu_torch.utils.progress import Progress, TimeReporter

log = get_logger("async_sgd")


class DivergedError(RuntimeError):
    pass


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (see ROADMAP.md "
        "for the slice that brings it)")


class AsyncSGD:
    """Scheduler + worker in one host process, on one device."""

    # eval blocks dispatched before their metrics and margins are fetched;
    # train steps dispatched ahead of a metric-accumulator fetch
    CREC_DRAIN_CHUNK = 64

    def __init__(self, cfg: Config, device: DeviceLike = None, store=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if store is None:
            lam = list(cfg.lambda_) + [0.0, 0.0]
            # config.proto:34-39 — L1: λ0·‖w‖₁ + ½λ1·‖w‖²; L2: ½λ0·‖w‖²
            if cfg.penalty == Penalty.L2:
                penalty = L1L2(lambda1=0.0, lambda2=lam[0])
            else:
                penalty = L1L2(lambda1=lam[0], lambda2=lam[1])
            handle = create_handle(cfg.algo.value, penalty,
                                   LearnRate(cfg.lr_eta, cfg.lr_beta))
            store = ShardedStore(
                StoreConfig(num_buckets=cfg.num_buckets,
                            loss=cfg.loss.value,
                            fixed_bytes=cfg.fixed_bytes,
                            lr_theta=cfg.lr_theta,
                            param_dtype=cfg.param_dtype,
                            tile_step_kernel=cfg.tile_step_kernel,
                            tile_onehot_cache=cfg.tile_onehot_cache),
                handle, self.device)
        elif store.cfg.num_buckets != cfg.num_buckets:
            raise ValueError(
                f"store has num_buckets={store.cfg.num_buckets} but config "
                f"says {cfg.num_buckets}")
        self.store = store
        if cfg.test_data and not cfg.pred_out:
            # fail at construction, not after the whole pass
            raise ValueError("test_data set but pred_out empty")
        self.localizer = Localizer(num_buckets=cfg.num_buckets,
                                   tail_freq=cfg.tail_feature_freq)
        self._max_nnz = cfg.max_nnz
        self._warned_trunc = False
        # DeviceFeed counters: consumer-side ring stalls, batches delivered
        self.feed_stats = {"feed_stall": 0.0, "feed_batches": 0}
        # the pull-only forward of a predict pass (serve_predict)
        self._predict_forward = None
        self.progress = Progress()
        self.start_time = time.time()
        self._prev_num_ex = 0
        self._nnz_w = 0          # nnz(w) at the last pass boundary
        self.reporter = TimeReporter(self._emit_row, interval=cfg.disp_itv)
        # deferred crec2 metric window: train steps accumulate their metric
        # rows on the device; the host counts dispatched steps and fetches
        # one buffer per window (an async ticket, resolved a window later)
        self._crec_count = 0
        self._crec_tickets: list = []
        self._crec_hist = [np.zeros(512), np.zeros(512)]
        # per-pass record: train objv per example, and the validation
        # pass's objv per example, pooled AUC and accuracy
        self.pass_log: List[dict] = []

    def _check_ported(self) -> None:
        cfg = self.cfg
        fmt = cfg.data_format
        if fmt == "crec":
            raise _not_ported("data_format='crec' (crec v1)")
        if fmt in ("criteo", "adfea") and cfg.text_dense:
            raise _not_ported(
                f"data_format={fmt!r} with text_dense=true (the dense-apply "
                "text path; text_dense=false trains on the sparse path)")
        if fmt != "crec2" and cfg.tile_online == "on":
            raise _not_ported("tile_online=on (the online tile encoder)")
        if cfg.staleness_tau >= 0:
            raise _not_ported("staleness_tau >= 0 (the multihost exchange)")
        if cfg.checkpoint_dir:
            raise _not_ported("checkpoint_dir (checkpoint resume)")
        if cfg.cache_device:
            raise _not_ported("cache_device (device-resident replay)")

    # -- worker data path ---------------------------------------------------

    def process(self, file: str, part: int, nparts: int,
                kind: str = TRAIN, pooled: Optional[list] = None) -> Progress:
        """One workload part (AsyncSGDWorker::Process, async_sgd.h:57-127).
        ``pooled``, if given, collects ``(margin, label, weight)`` of every
        real row, for pass-level metrics and predictions."""
        self._check_ported()
        if self.cfg.data_format == "crec2":
            return self._process_crec(file, part, nparts, kind, pooled)
        return self._process_sparse(file, part, nparts, kind, pooled)

    # -- the sparse SparseBatch path ----------------------------------------

    def _bucket_nnz(self, blk) -> int:
        """Resolve the (monotone) per-batch nnz bucket for ``blk``: the
        max over every block up to and including it, so it must run in
        stream order (the serial loop, or the DeviceFeed dispatcher ahead
        of the pad workers). Rows beyond the bucket's 4096 cap, or beyond
        a user-set ``max_nnz``, are truncated by position, loudly."""
        densest = blk.max_row_nnz()
        if not self.cfg.max_nnz:
            self._max_nnz = max(self._max_nnz, nnz_bucket(densest))
        if densest > self._max_nnz and not self._warned_trunc:
            self._warned_trunc = True
            log.warning(
                "row with %d features truncated to max_nnz=%d "
                "(set max_nnz to keep more)", densest, self._max_nnz)
        return self._max_nnz

    def _localize_pad(self, blk, max_nnz: int):
        """Localize + pad one block into a host SparseBatch (stateless:
        safe on a DeviceFeed worker thread)."""
        loc = self.localizer.localize(blk)
        kpad = self.cfg.key_pad or next_bucket(len(loc.uniq_keys), 64)
        return pad_to_batch(loc, self.cfg.minibatch, max_nnz, kpad)

    def _batches(self, file: str, part: int, nparts: int):
        """stream → localize → pad → device, batch by batch. With
        ``pipeline_workers > 0`` the stages run as a DeviceFeed (localize
        and pad on a worker pool, the copy to the device on its own thread
        and a side stream, a ``pipeline_ring``-deep ring ahead of the
        step); 0 runs them inline. The batches, their order and their
        shapes are the same either way."""
        cfg = self.cfg
        reader = MinibatchIter(file, part, nparts, cfg.data_format,
                               cfg.minibatch)
        if cfg.pipeline_workers <= 0:
            for blk in reader:
                max_nnz = self._bucket_nnz(blk)
                yield self._localize_pad(blk, max_nnz).to(
                    self.device, non_blocking=True)
            return
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)

        def transfer(batch):
            return batch.to(self.device, non_blocking=True, stream=stream)

        feed = DeviceFeed(reader, self._localize_pad,
                          workers=cfg.pipeline_workers,
                          ring_depth=cfg.pipeline_ring,
                          seq_ctx=self._bucket_nnz, transfer=transfer,
                          name="sparse")
        try:
            for batch in feed:
                yield batch.wait()
        finally:
            snap = feed.drain_stats()
            self.feed_stats["feed_stall"] += snap["consume_stall"]
            self.feed_stats["feed_batches"] += snap["batches"]

    @staticmethod
    def _real_rows(batch) -> np.ndarray:
        """Per-row (real, weight) for pooled eval: the first ``num_real``
        rows are real, the rest padding — row_mask alone can't tell a
        padded row from a real row with example weight 0."""
        host = batch.on_host()
        mask = host.row_mask.numpy()
        n = host.num_real
        real = (np.arange(len(mask)) < n) if n is not None else mask > 0
        return np.where(real, np.maximum(mask, 0.0), -1.0)

    def _process_sparse(self, file: str, part: int, nparts: int,
                        kind: str, pooled: Optional[list]) -> Progress:
        """The sparse path (the JAX ``process``, async_sgd.py:260-372). A
        train batch runs ``store.train_step`` with tau = the steps still in
        flight, after the WaitMinibatch gate has left at most
        ``max(max_delay - 1, 0)`` of them (``max_delay=0``: no two steps
        overlap); ``dt2_adagrad`` pulls each batch and pushes it once
        ``max_delay`` pulls are ahead of it. A step's metrics (and an eval
        batch's margins) come home as one async copy, resolved when the
        gate harvests it. Validation runs with an unbounded window."""
        cfg = self.cfg
        fs0 = dict(self.feed_stats)
        max_delay = cfg.max_delay if kind == TRAIN else 1 << 30
        inflight: deque = deque()
        local = Progress()

        def harvest(item) -> None:
            fetch, labels, keep = item
            m = fetch()
            local.num_ex += int(m[1])
            local.count += 1
            local.objv += float(m[0])
            local.auc += float(m[2])
            local.acc += float(m[3])
            if kind == TRAIN:
                if len(m) > 4:
                    local.wdelta2 += float(m[4])
                self._display(local)
            elif pooled is not None:
                margin = m[4:]
                real = keep >= 0   # real rows (weight-0 rows included)
                pooled.append((margin[real], labels[real], keep[real]))

        def gate() -> None:
            while len(inflight) > max(max_delay - 1, 0):
                harvest(inflight.popleft())

        store = self.store
        if kind == TRAIN and isinstance(getattr(store, "handle", None),
                                        DT2AdaGradHandle):
            for batch in self._batches(file, part, nparts):
                grad, snap, metrics = store.dt2_pull(batch)
                inflight.append((batch, grad, snap,
                                 to_host_async(torch.stack(metrics))))
                while len(inflight) > max(max_delay - 1, 0):
                    b, g, s, t = inflight.popleft()
                    store.dt2_push(b, g, s)
                    harvest((t.resolve, None, None))
            while inflight:
                b, g, s, t = inflight.popleft()
                store.dt2_push(b, g, s)
                harvest((t.resolve, None, None))
            self._merge_feed_progress(local, fs0)
            return local

        for batch in self._batches(file, part, nparts):
            gate()
            if kind == TRAIN:
                metrics = store.train_step(batch, tau=float(len(inflight)))
                ticket = to_host_async(torch.stack(metrics))
                inflight.append((ticket.resolve, None, None))
                continue
            keep = self._real_rows(batch)
            labels = batch.on_host().labels.numpy()
            if kind == TEST and self._predict_forward is not None:
                # offline predict rides the serving forward; eval metrics
                # mean nothing on unlabeled TEST data, only the margin
                ticket = to_host_async(self._predict_forward.margins(batch))
                head = np.array([0.0, float((keep >= 0).sum()), 0.5, 0.0])

                def fetch(t=ticket, h=head):
                    return np.concatenate([h, t.resolve()])
            else:
                objv, num_ex, a, acc, margin = store.eval_step(batch)
                fetch = to_host_async(torch.cat(
                    [torch.stack([objv, num_ex, a, acc]), margin])).resolve
            inflight.append((fetch, labels, keep))
        while inflight:                      # WaitMinibatch(0)
            harvest(inflight.popleft())
        self._merge_feed_progress(local, fs0)
        return local

    def _merge_feed_progress(self, local: Progress, before: dict) -> None:
        """Fold this part's DeviceFeed counter deltas into its Progress."""
        fs = self.feed_stats
        local.feed_stall += fs["feed_stall"] - before["feed_stall"]
        local.feed_batches += fs["feed_batches"] - before["feed_batches"]

    # -- deferred train metrics (the on-device accumulator) ------------------

    def _harvest_macc(self, local: Progress, hist: list, n_new: int,
                      final: bool) -> None:
        """Harvest the on-device metric accumulator into ``local``: ``n_new``
        pending steps start an async fetch now, and the previous window's
        ticket — which has had a window to fly home — is resolved; ``final``
        resolves everything (part ends, flush). AUC comes from the running
        margin histograms in ``hist``, stored as auc*count so Progress
        merges give the pass-level number. Row layout: [objv, num_ex, acc,
        wdelta2, pos, neg] (TableCheckpoint.MACC_LEN)."""
        if n_new:
            self._crec_tickets.append(
                (self.store.fetch_metrics_async(), n_new))
        resolved = False
        while self._crec_tickets and (final or len(self._crec_tickets) > 1):
            ticket, n = self._crec_tickets.pop(0)
            row = ticket.resolve()
            local.objv += float(row[0])
            local.num_ex += int(row[1])
            local.count += n
            local.acc += float(row[2])
            local.wdelta2 += float(row[3])
            bins = (len(row) - 4) // 2
            hist[0] += row[4:4 + bins]
            hist[1] += row[4 + bins:]
            resolved = True
        if resolved:
            local.auc = auc_from_hist(*hist) * local.count
            self._display(local)

    def _drain_crec2_train(self, local: Progress,
                           final: bool = True) -> None:
        self._harvest_macc(local, self._crec_hist, self._crec_count, final)
        self._crec_count = 0

    def flush_metrics(self) -> Progress:
        """Drain any deferred crec2 metrics; returns the tail Progress
        (callers merge it into their running totals)."""
        tail = Progress()
        self._drain_crec2_train(tail)
        return tail

    def _process_crec(self, file: str, part: int, nparts: int,
                      kind: str, pooled: Optional[list]) -> Progress:
        """The crec2 streaming path: block bytes go to the device as they
        are (PackedFeed). A train block runs ``store.tile_train_step``,
        gated so that at most ``max(max_delay, 1)`` steps are in flight
        (``max_delay=0``: no two device steps overlap) with tau = the steps
        still in flight; its metrics stay on the device until the window
        drains. An eval block runs the tile eval step, and its metrics and
        margins come back in one copy per block, ``CREC_DRAIN_CHUNK`` blocks
        at a time."""
        info = read_header2(file)
        if info.nb != self.cfg.num_buckets:
            raise ValueError(
                f"{file}: crec2 was written for num_buckets={info.nb} "
                f"but config says {self.cfg.num_buckets} (the tile grouping "
                "is bucket-count specific)")
        local = Progress()
        feed = PackedFeed(file, part, nparts, device=self.device)
        if kind == TRAIN:
            max_delay = self.cfg.max_delay
            tau_cap = float(max(max_delay - 1, 0))
            inflight: deque = deque()
            for dev, _host, _rows in feed:
                while len(inflight) > max(max_delay - 1, 0):
                    self._harvest(inflight.popleft(), local)
                ticket = self.store.tile_train_step(
                    dev, info, tau=min(float(len(inflight)), tau_cap))
                self._crec_count += 1
                inflight.append(ticket)
                if self._crec_count >= self.CREC_DRAIN_CHUNK:
                    self._drain_crec2_train(local, final=False)
            self._drain_crec2_train(local)
            return local
        pending: list = []
        for dev, host, _rows in feed:
            objv, num_ex, acc, pos, neg, margin = \
                self.store.tile_eval_step(dev, info)
            packed = torch.cat([torch.stack([objv, num_ex, acc]), pos, neg,
                                margin])
            pending.append((packed, host["labels"].copy()))
            if len(pending) >= self.CREC_DRAIN_CHUNK:
                self._drain(pending, local, pooled)
        self._drain(pending, local, pooled)
        return local

    def _harvest(self, ticket, local: Progress) -> None:
        """Wait for a train step to finish (its completion event), then
        drain the metric window if the display is due."""
        if ticket is not None:
            ticket.synchronize()
        if self.reporter.due():
            self._drain_crec2_train(local, final=False)

    @staticmethod
    def _drain(pending: list, local: Progress,
               pooled: Optional[list]) -> None:
        bins = 512
        for packed, labels_u8 in pending:
            row = packed.cpu().numpy()
            local.objv += float(row[0])
            local.num_ex += int(row[1])
            local.count += 1
            local.acc += float(row[2])
            local.auc += auc_from_hist(row[3:3 + bins],
                                       row[3 + bins:3 + 2 * bins])
            if pooled is not None:
                margin = row[3 + 2 * bins:]
                real = labels_u8 != 255
                pooled.append((margin[real],
                               np.minimum(labels_u8[real], 1)
                               .astype(np.float32),
                               np.ones(int(real.sum()), np.float32)))
        pending.clear()

    # -- scheduler loop -----------------------------------------------------

    def run(self) -> Progress:
        """Pass/workload loop (AsyncSGDScheduler::Run, async_sgd.h:294-348;
        the single-process loop of wormhole_tpu/learners/async_sgd.py:1052):
        warm start from ``model_in``, ``max_data_pass`` training passes with
        a validation pass after each and the epsilon early stop, then
        predict ``test_data`` and save ``model_out``."""
        cfg = self.cfg
        self._check_ported()
        if cfg.model_in:
            self._store_io("load", cfg.model_in)
            log.info("warm start from %s", cfg.model_in)
        if cfg.max_data_pass > 0:
            print(Progress.HEADER)
        prev_objv_ex = None
        for data_pass in range(cfg.max_data_pass):
            pool = WorkloadPool()
            pool.add(cfg.train_data, cfg.num_parts_per_file, TRAIN)
            pass_prog = Progress()
            while True:
                wl = pool.get("proc0")
                if wl is None:
                    break
                prog = self.process(wl.file, wl.part, wl.nparts, wl.kind)
                self.progress.merge(prog)
                pass_prog.merge(prog)
                pool.finish(wl.id)
                self._check_divergence(prog)
            tail = self.flush_metrics()
            self.progress.merge(tail)
            pass_prog.merge(tail)
            self._check_divergence(tail)
            self._crec_hist = [np.zeros(512), np.zeros(512)]  # pass-level
            self._nnz_w = self.store.nnz_weight()
            rec = {"pass": data_pass, "train_num_ex": pass_prog.num_ex,
                   "train_objv": pass_prog.objv / max(pass_prog.num_ex, 1)}
            if cfg.val_data:
                vp, pass_auc = self._run_eval(cfg.val_data)
                n = max(vp.num_ex, 1)
                rec.update(val_num_ex=vp.num_ex, val_objv=vp.objv / n,
                           val_auc=pass_auc,
                           val_acc=vp.acc / max(vp.count, 1))
                log.info("pass %d validation: objv=%.6f auc=%.6f acc=%.6f",
                         data_pass, rec["val_objv"], pass_auc,
                         rec["val_acc"])
            self.pass_log.append(rec)
            if self._converged(data_pass, pass_prog, prev_objv_ex):
                break
            prev_objv_ex = pass_prog.objv / max(pass_prog.num_ex, 1)
        if cfg.test_data:
            self.predict(cfg.test_data, cfg.pred_out)
        if cfg.model_out:
            self._store_io("save", cfg.model_out)
        return self.progress

    def _run_eval(self, pattern: str):
        """Full eval pass; returns (Progress, pooled AUC over the whole
        pass). The per-block mean AUC stays in Progress for display; the
        pooled number is the pass-level statistic."""
        pool = WorkloadPool()
        pool.add(pattern, self.cfg.num_parts_per_file, VAL)
        total = Progress()
        pooled: list = []
        while True:
            wl = pool.get("eval")
            if wl is None:
                break
            total.merge(self.process(wl.file, wl.part, wl.nparts, VAL,
                                     pooled=pooled))
            pool.finish(wl.id)
        if pooled:
            margins = np.concatenate([p[0] for p in pooled])
            labels = np.concatenate([p[1] for p in pooled])
            weights = np.concatenate([p[2] for p in pooled])
            pass_auc = auc_np(labels, margins, weights)
        else:
            pass_auc = 0.5
        return total, pass_auc

    def predict(self, pattern: str, out_path: str) -> None:
        """TEST workload (reference workload.proto:12-16): stream the test
        data and write one prediction per real row to ``out_path`` —
        σ(margin) for logit loss (linear.h MarginToPred), the raw margin
        otherwise. With ``serve_predict`` the sparse path's margins come
        from the pull-only ``ForwardStep``."""
        if not out_path:
            raise ValueError("test_data set but pred_out empty")
        if self.cfg.serve_predict and hasattr(self.store,
                                              "build_serve_margin"):
            self._predict_forward = ForwardStep.from_store(self.store)
        pool = WorkloadPool()
        pool.add(pattern, self.cfg.num_parts_per_file, TEST)
        pooled: list = []
        try:
            while True:
                wl = pool.get("predict")
                if wl is None:
                    break
                self.process(wl.file, wl.part, wl.nparts, TEST,
                             pooled=pooled)
                pool.finish(wl.id)
        finally:
            self._predict_forward = None
        self._write_preds(pooled, out_path)

    def _write_preds(self, pooled: list, out_path: str) -> None:
        margins = (np.concatenate([p[0] for p in pooled])
                   if pooled else np.zeros(0, np.float32))
        if self.cfg.loss.value == "logit":
            preds = 1.0 / (1.0 + np.exp(-margins))
        else:
            preds = margins
        with open_stream(out_path, "w") as f:
            f.write("".join(f"{p:.6g}\n" for p in preds.tolist()))
        log.info("wrote %d predictions to %s", len(preds), out_path)

    def _key_fold(self) -> str:
        """The key->bucket scheme of this run's data_format, recorded in
        and checked against saved models: crec2 folds u32 keys with mix32,
        the sparse path 64-bit ids with splitmix64 (data/hashing.py)."""
        return "mix32" if self.cfg.data_format == "crec2" else "splitmix64"

    def _store_io(self, op: str, path: str):
        """save/load the model with the key-fold tag."""
        if op == "save":
            self.store.save_model(path, 0, key_fold=self._key_fold())
        else:
            self.store.load_model(path, expect_key_fold=self._key_fold())

    # -- display and stop rules -----------------------------------------------

    def _display(self, local: Progress) -> None:
        self.reporter.report(local)

    def _emit_row(self, local: Progress) -> None:
        snap = Progress(self.progress.fvec + local.fvec,
                        self.progress.ivec + local.ivec)
        # nnz from the last pass boundary: a live count would sync the
        # device every display window
        snap.nnz_w = self._nnz_w
        print(snap.print_row(time.time() - self.start_time,
                             self._prev_num_ex))
        self._prev_num_ex = snap.num_ex

    def _converged(self, data_pass: int, pass_prog: Progress,
                   prev_objv_ex) -> bool:
        """Early stop (Config.epsilon): a pass that improves per-example
        objv by less than epsilon (relatively) ends training."""
        eps = self.cfg.epsilon
        if not eps or prev_objv_ex is None or pass_prog.num_ex == 0:
            return False
        cur = pass_prog.objv / max(pass_prog.num_ex, 1)
        rel = (prev_objv_ex - cur) / max(abs(prev_objv_ex), 1e-12)
        if rel < eps:
            log.info("converged at pass %d: relative objv improvement "
                     "%.2e < epsilon %.2e", data_pass, rel, eps)
            return True
        return False

    def _check_divergence(self, prog: Progress) -> None:
        """Kill switch on the freshest workload part; NaN always counts as
        diverged (async_sgd.h:316-319)."""
        per_ex = prog.objv / max(prog.num_ex, 1)
        if np.isnan(per_ex):
            raise DivergedError("objv is NaN")
        if self.cfg.max_objv and per_ex > self.cfg.max_objv:
            raise DivergedError(
                f"objv {per_ex:.4f} > max_objv {self.cfg.max_objv} "
                f"(async_sgd.h:316-319 kill switch)")


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``python -m wormhole_tpu_torch.learners.async_sgd [conf]
    key=val ... [device=cpu]``."""
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    device, args = split_device_arg(args)
    conf = args.pop(0) if args and "=" not in args[0] else None
    cfg = load_config(conf, args)
    AsyncSGD(cfg, device=device).run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
