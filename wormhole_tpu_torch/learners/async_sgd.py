"""Online sharded-SGD app — the flagship learner, on one device.

The counterpart of ``wormhole_tpu/learners/async_sgd.py``. It trains any
``algo`` (FTRL, SGD, AdaGrad and the delay-tolerant variants), validates,
predicts and saves the model, on one device:

    python -m wormhole_tpu_torch.learners.async_sgd train_data=<f.libsvm> \\
        val_data=<v.libsvm> num_buckets=4194304 max_data_pass=2 \\
        [algo=ftrl|sgd|adagrad|dt_sgd|dt_adagrad|dt2_adagrad] \\
        [data_format=libsvm|criteo|adfea|rec|recordio|crec|crec2] \\
        [text_dense=true|false] [tile_online=auto|on|off] \\
        [cache_device=true] \\
        [model_out=<model>] [test_data=<t> pred_out=<out>] [device=cpu]

``run`` warm-starts from ``model_in`` (a ``save_model`` text model of either
package), runs ``max_data_pass`` training passes over ``train_data`` with a
validation pass over ``val_data`` after each, then predicts ``test_data``
(one σ(margin) per real row to ``pred_out``) and saves ``model_out``.

Two data paths, as in the JAX app. libsvm, recordio and criteo/adfea with
``text_dense=false`` stream through the sparse path: ``MinibatchIter``
parses (the native C++ parser where it builds) and re-slices into
``minibatch`` rows, the ``Localizer``
folds and deduplicates the keys and ``pad_to_batch`` pads them
(``pipeline_workers`` threads, ``DeviceFeed``), the batch crosses to the
device in pinned, ``non_blocking`` copies on a side stream, and
``store.train_step`` runs the sparse step with at most ``max_delay`` steps
in flight; ``dt2_adagrad`` trains through the split ``dt2_pull``/
``dt2_push`` pair, each push up to ``max_delay`` batches after its pull.
Predict rides the pull-only ``ForwardStep`` when ``serve_predict`` is set.

The block formats run ``_process_crec``. crec2 blocks go to the device as
they are and run ``store.tile_train_step`` (the hand-written kernels in
``ops/csrc`` on a GPU; ``tile_step_kernel=auto`` resolves to the fused step
there), whose metrics accumulate on the device and come home once per
window. crec v1 files and criteo/adfea text with ``text_dense=true`` (the
default for those formats; the text assembled into crec v1 blocks by the
native parser, ``TextCRecFeed``) run either the dense-apply step (the keys
folded on the device, ``store.dense_train_step``) or, with ``tile_online``,
the tile steps on blocks that the feed's workers encode into crec2 on the
fly (``TileOnlineFeed``; a block whose spill overflows its cap runs the
sparse step, counted in the registry's ``feed/tile_fallback_blocks``).
``cache_device`` keeps each part's device blocks and replays them on later
passes.

``checkpoint_dir`` commits the store's state (``state_pytree``: the table,
the step clock and, for wide&deep, the MLP and its accumulators) after
every ``checkpoint_every`` passes and at the end, in the JAX package's
file format (``parallel/checkpoint.py``); a run launched again resumes at
the newest committed pass and ends with the bits of an uninterrupted run.
The telemetry knobs are the JAX app's (``obs/``): ``trace_path`` (Chrome
trace JSON of the stage, timer, step and checkpoint spans),
``metrics_export`` (heartbeat lines and ``host<rank>.prom``),
``metrics_sample_itv_s`` (the timeline) and ``flight_dir``; all off by
default, at one bool check per span site.

``staleness_tau >= 0``, and any run of several processes, hand over to
``run_multihost``. With ``staleness_tau >= 0`` its train pass
(``_multihost_pass_ps``) takes its parts round-robin (``take_static``)
and folds each window of ``ps_window_steps`` minibatch gradients
(``store.dt2_pull``, all at the same weights) into one dense
``(num_buckets,)`` delta on the device; the window goes through the
bounded-staleness engine's drain thread (``ps/``), summed over the ranks
(the identity on a world of one), and is applied by ``store.ps_push`` at
most ``staleness_tau`` windows later, with its measured delay as the DT
handles' ``tau``. Windows are consumed by count, so the run returns the
same bits every time. With ``staleness_tau < 0`` past one process the
train pass is the replicated-pool BSP pass (``_multihost_pass``): each
round every process runs the same sparse step on the hosts' batches
gathered into one global batch. Validation and predict run the
replicated-pool pass, checkpoints go through ``ShardCheckpointer`` (a
``rank<r>/`` directory with commit markers a rank), each rank writes
``model_out_<rank>`` and ``pred_out_<rank>``, and ``max_nnz``/``key_pad``
must be set. Only the linear store has the pull/push pair; FM and
wide&deep refuse the knob at construction on the sparse formats. A SIGTERM under
``WORMHOLE_FT_DRAIN=1`` (``ft/supervisor.py``) stops either loop at a
part or window boundary, commits and returns.

Several processes come from the launcher (``python -m
wormhole_tpu_torch.parallel.launcher -n 2 --cluster mp -- python -m
wormhole_tpu_torch.learners.async_sgd ...``): the constructor joins its
gloo group (``MeshRuntime.create``) and installs the ``comm_filters``
chain, the ``wire`` (``process``, ``socket``, ``sim``), the watchdog and
chaos, in the JAX order. On a host with one GPU every process steps on
the same card.

The device is ``cuda`` unless ``device=cpu`` is given; the token is the
port's own and never enters ``Config``.

crec and crec2 under ``staleness_tau >= 0`` or past one process take the
JAX app's route: ``_multihost_pass_crec``, one host a data index of the
``data:D,model:M`` mesh (``mesh_shape``, ``model_shards``; a position a
process, rank d·M + m), every round one block a host through the mesh
step (``store.tile_train_step_mesh`` / ``dense_train_step_mesh``: each
model shard holds its range of the table, margins sum over the model
axis and gradients over the data axis through the transport stack), the
ps engine (if any) ordering only the control exchanges; dense text and
``tile_online`` take the sparse passes there, as in the JAX app.
The FM and wide&deep stores take the same route through their own mesh
steps; on crec v1 they have no dense-apply mesh step, and raise the JAX
pass's ``AttributeError``. ``process`` of a block format past one process
raises: the JAX ``_process_crec_mesh`` serves one process that drives
several devices, which the port (one device a process) does not have.
With ``rejoin_replay_windows > 0`` the engine keeps the live-rejoin
replay log and each window carries its one-hot version-vector row
(``ft/rejoin.py``). Remote URI schemes raise in ``data/stream.py``.
"""

from __future__ import annotations

import time
from collections import deque
from itertools import islice
from typing import List, Optional

import numpy as np
import torch

from wormhole_tpu_torch import obs
from wormhole_tpu_torch.data.crec import (BlockPut, CRecInfo, PackedFeed,
                                          TextCRecFeed, TileOnlineFeed,
                                          mesh_lane, mesh_pads, online_info,
                                          read_header, read_header2, settle,
                                          stack_mesh_group)
from wormhole_tpu_torch.data.feed import SparseBatch, next_bucket, \
    nnz_bucket, pad_to_batch
from wormhole_tpu_torch.data.localizer import Localizer
from wormhole_tpu_torch.data.minibatch import MinibatchIter
from wormhole_tpu_torch.data.pipeline import DeviceFeed
from wormhole_tpu_torch.data.stream import list_files, open_stream
from wormhole_tpu_torch.device import DeviceLike, host_to_device, \
    resolve_device, split_device_arg
from wormhole_tpu_torch.ft import chaos as ft_chaos
from wormhole_tpu_torch.ft.rejoin import VersionVector
from wormhole_tpu_torch.ft import supervisor as ft_supervisor
from wormhole_tpu_torch.ft import watchdog as ft_watchdog
from wormhole_tpu_torch.learners.handles import DT2AdaGradHandle, \
    LearnRate, create_handle
from wormhole_tpu_torch.learners.store import MetricTicket, ShardedStore, \
    StoreConfig, to_host_async
from wormhole_tpu_torch.obs import flight as obs_flight
from wormhole_tpu_torch.ops.metrics import auc_from_hist, auc_np
from wormhole_tpu_torch.ops.penalty import L1L2
from wormhole_tpu_torch.ops.tilemm import RSUB, TILE
from wormhole_tpu_torch.parallel.checkpoint import Checkpointer, \
    ShardCheckpointer
from wormhole_tpu_torch.parallel import filters as comm_filters
from wormhole_tpu_torch.parallel import transport as comm_transport
from wormhole_tpu_torch.parallel.collectives import allgather_tree, \
    allreduce_tree, host_local_to_global
from wormhole_tpu_torch.parallel.mesh import MeshRuntime
from wormhole_tpu_torch.ps import build_engine
from wormhole_tpu_torch.sched.workload_pool import (TEST, TRAIN, VAL,
                                                    ReplicatedRounds,
                                                    WorkloadPool)
from wormhole_tpu_torch.serve.forward import ForwardStep
from wormhole_tpu_torch.utils.config import Config, Penalty, check_choice, \
    load_config
from wormhole_tpu_torch.utils.logging import get_logger
from wormhole_tpu_torch.utils.progress import Progress, TimeReporter
from wormhole_tpu_torch.utils.timer import Timer

log = get_logger("async_sgd")

# tile_online=auto on a CUDA device (PERF.md §6): criteo text of the
# flagship geometry trained 2.3-6.8x faster on the dense-apply step than
# through the online encoder (two H100 runs), whose host encode (100-128 ms
# a 16,384-row block) bounds it; so a store with a dense-apply step keeps
# it, and a store without one (FM, wide&deep) encodes online
ONLINE_AUTO_DENSE = ("off", "auto on CUDA: the dense-apply step trains "
                     "criteo text 2.3-6.8x faster than the online encoder "
                     "(PERF.md)")
ONLINE_AUTO_TILE_ONLY = ("on", "auto on CUDA: the store has no dense-apply "
                         "step; the online encoder is its block path")


class DivergedError(RuntimeError):
    pass


class AsyncSGD:
    """Scheduler + worker in one host process, on one device."""

    # eval blocks dispatched before their metrics and margins are fetched;
    # train steps dispatched ahead of a metric-accumulator fetch
    CREC_DRAIN_CHUNK = 64

    def __init__(self, cfg: Config, device: DeviceLike = None, store=None,
                 runtime: Optional[MeshRuntime] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # one device per process, one mesh position per process; past one
        # process the launcher's env joins the gloo group here, before
        # anything reads the rank (or the caller hands in a runtime over
        # its own wire)
        self.rt = runtime if runtime is not None else MeshRuntime.create(
            cfg.mesh_shape, cfg.model_shards, self.device,
            cfg.comm_timeout_s)
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
                handle, self.device, runtime=self.rt)
        elif store.cfg.num_buckets != cfg.num_buckets:
            raise ValueError(
                f"store has num_buckets={store.cfg.num_buckets} but config "
                f"says {cfg.num_buckets}")
        if cfg.staleness_tau >= 0 \
                and cfg.data_format not in ("crec", "crec2") \
                and not (hasattr(store, "dt2_pull")
                         and hasattr(store, "ps_push")):
            # the JAX app fails the same way, only later: its ps pass
            # calls store.dt2_pull on a store that has none
            raise ValueError(
                f"staleness_tau={cfg.staleness_tau}: the ps engine pass "
                "needs the store's dt2_pull/ps_push pair, which "
                f"{type(store).__name__} does not have (the linear store "
                "does; FM and wide&deep train with staleness_tau=-1)")
        self.store = store
        if cfg.test_data and not cfg.pred_out:
            # fail at construction, not after the whole pass
            raise ValueError("test_data set but pred_out empty")
        check_choice("tile_online", cfg.tile_online, ("auto", "on", "off"))
        self.localizer = Localizer(num_buckets=cfg.num_buckets,
                                   tail_freq=cfg.tail_feature_freq)
        self._max_nnz = cfg.max_nnz
        self._warned_trunc = False
        # DeviceFeed counters: consumer-side ring stalls, batches delivered,
        # deepest ring occupancy observed
        self.feed_stats = {"feed_stall": 0.0, "feed_batches": 0,
                           "ring_max": 0}
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
        self.timer = Timer()   # the block paths' stage seconds
        self._feeds: dict = {}  # cache_device: feed per (file, part, ...)
        self.tile_online_record = None   # (resolved, reason) of tile_online
        self.ckpt = Checkpointer(cfg.checkpoint_dir)
        self._warned_ckpt = False
        # telemetry hub (obs/): trace_path turns span tracing on,
        # metrics_export the heartbeat/Prometheus files; both off (the
        # default) leaves every instrumented path at one bool check
        self.obs = obs.setup(cfg, self.rt.rank)
        obs.timeline_mod.watch_device(self.device)
        self._fallback0 = self._fallback_counter().value
        # the communication filter chain (process-global, so every host
        # exchange below rides it), then the wire of the cross-host leg,
        # before anything caches the default stack
        comm_filters.install_from_config(cfg)
        comm_transport.install_wire_from_config(cfg)
        if self.rt.world > 1:
            # every position forms its axis groups here, at the same point
            # of its program (gloo subgroups are formed collectively)
            self.rt.axis_stacks()
        # fault-tolerance wiring (ft/): the collective watchdog and the
        # deterministic fault plan, both off by default
        ft_watchdog.configure(cfg.comm_timeout_s)
        ft_chaos.install_from_config(cfg, self.rt.rank)
        # SIGTERM -> drain at a part/window boundary, under a supervised
        # launcher only (WORMHOLE_FT_DRAIN); a no-op otherwise
        ft_supervisor.install_drain_handler()
        self._engine = None

    def _fallback_counter(self):
        return obs.metrics.encode_counters(self.obs.registry)[1]

    @property
    def fallback_blocks(self) -> int:
        """Online blocks of this app whose spill overflowed their cap and
        ran the sparse step: its share of the registry's
        ``feed/tile_fallback_blocks`` counter."""
        return int(self._fallback_counter().value - self._fallback0)

    def _block_path(self) -> bool:
        """Whether this run's format takes the block paths (crec2, crec
        v1, dense text, online tiles) in a single-process pass."""
        return (self.cfg.data_format in ("crec", "crec2")
                or self._text_dense() or self._tile_online())

    def _check_mesh_store(self) -> None:
        """The mesh route (crec and crec2 past one process or under
        ``staleness_tau >= 0``, as in the JAX app) steps the store's mesh
        step. Past one process the store must hold this app's runtime (its
        model shard's range and the axes its sums cross). crec v1 needs
        the dense-apply mesh step, which the FM and wide&deep stores do not
        have, in either package: the JAX pass raises this AttributeError
        at its first step; here it is raised before the pass."""
        cfg = self.cfg
        world = self.rt.world
        if not (cfg.data_format in ("crec", "crec2")
                and (cfg.staleness_tau >= 0 or world > 1)):
            return
        if world > 1 and getattr(self.store, "rt", None) is not self.rt:
            raise ValueError(
                f"{type(self.store).__name__} on the mesh at a world of "
                f"{world}: build the store with the app's runtime "
                "(store(cfg, device, runtime)) so it holds its model "
                "shard's range")
        if cfg.data_format == "crec" \
                and not hasattr(self.store, "dense_train_step_mesh"):
            raise AttributeError(
                f"{type(self.store).__name__!r} object has no attribute "
                "'dense_train_step_mesh' (crec v1 on the mesh route, "
                f"staleness_tau={cfg.staleness_tau}, a world of {world})")

    # -- worker data path ---------------------------------------------------

    def process(self, file: str, part: int, nparts: int,
                kind: str = TRAIN, pooled: Optional[list] = None) -> Progress:
        """One workload part (AsyncSGDWorker::Process, async_sgd.h:57-127).
        ``pooled``, if given, collects ``(margin, label, weight)`` of every
        real row, for pass-level metrics and predictions."""
        self._check_mesh_store()
        if self._block_path():
            if self.rt.world > 1:
                raise ValueError(
                    f"process() of {self.cfg.data_format} at a world of "
                    f"{self.rt.world}: past one process the block formats "
                    "run through run() (_multihost_pass_crec, one data "
                    "index a process)")
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

    def _batches(self, file: str, part: int, nparts: int,
                 prefix: str = "", host: bool = False):
        """stream → localize → pad → device, batch by batch. With
        ``pipeline_workers > 0`` the stages run as a DeviceFeed (localize
        and pad on a worker pool, the copy to the device on its own thread
        and a side stream, a ``pipeline_ring``-deep ring ahead of the
        step); 0 runs them inline, each stage timed under the reference's
        names (``parse``, ``localize``, ``pad``). The batches, their order
        and their shapes are the same either way. The feed's stage seconds
        go to ``timer`` under ``prefix``. ``host`` keeps the batches on the
        host (the multi-process global batch assembles host arrays)."""
        cfg = self.cfg
        reader = MinibatchIter(file, part, nparts, cfg.data_format,
                               cfg.minibatch)
        if cfg.pipeline_workers <= 0:
            it = iter(reader)
            while True:
                with self.timer.scope(prefix + "parse"):
                    blk = next(it, None)
                if blk is None:
                    return
                with self.timer.scope(prefix + "localize"):
                    loc = self.localizer.localize(blk)
                max_nnz = self._bucket_nnz(blk)
                kpad = cfg.key_pad or next_bucket(len(loc.uniq_keys), 64)
                with self.timer.scope(prefix + "pad"):
                    batch = pad_to_batch(loc, cfg.minibatch, max_nnz, kpad)
                yield batch if host else batch.to(self.device,
                                                  non_blocking=True)
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" and not host else None)

        def transfer(batch):
            if host:
                return batch
            return batch.to(self.device, non_blocking=True, stream=stream)

        feed = DeviceFeed(reader, self._localize_pad,
                          workers=cfg.pipeline_workers,
                          ring_depth=cfg.pipeline_ring,
                          seq_ctx=self._bucket_nnz, transfer=transfer,
                          bytes_read=reader.bytes_read,
                          name=(prefix or "train").rstrip("_"))
        try:
            for batch in feed:
                yield batch.wait()
        finally:
            snap = feed.drain_stats(self.timer, prefix)
            self.feed_stats["feed_stall"] += snap["consume_stall"]
            self.feed_stats["feed_batches"] += snap["batches"]
            self.feed_stats["ring_max"] = max(self.feed_stats["ring_max"],
                                              snap["ring_max"])

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
            # the metric buffer flying home: the sparse path's window
            # boundary, the same span name as the crec harvest
            with obs.trace.span("collective:metrics_window",
                                cat="collective",
                                args={"site": "async_sgd/metrics_window"}):
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

        for batch in self._batches(file, part, nparts,
                                   "" if kind == TRAIN else "eval_"):
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
            # the fetched accumulator: the window boundary on the device
            # step path
            with obs.trace.span("collective:metrics_window",
                                cat="collective",
                                args={"site": "async_sgd/metrics_window"}):
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
        # the store step's traced stages that the device has passed (all
        # of them after a final harvest's wait): device time into the timer
        obs.trace.resolve_stages(self.timer.add)

    def flush_metrics(self) -> Progress:
        """Drain any deferred crec2 metrics; returns the tail Progress
        (callers merge it into their running totals)."""
        tail = Progress()
        self._drain_crec2_train(tail)
        return tail

    # -- the crec paths: crec2, crec v1, dense text, online tiles -------------

    def _text_dense(self) -> bool:
        """True when this text format streams through the dense-apply path
        (native chunk -> crec block assembly): the binary-feature formats
        only; libsvm may carry values, so it keeps the sparse path."""
        return (self.cfg.text_dense
                and self.cfg.data_format in ("criteo", "adfea"))

    def _text_nnz(self) -> int:
        if self.cfg.data_format == "criteo":
            return 39
        if not self.cfg.max_nnz:
            raise ValueError("text_dense for adfea needs max_nnz= (the "
                             "fixed crec row width)")
        return self.cfg.max_nnz

    def _online_info(self, fmt: str, file: Optional[str]):
        """The crec2 geometry for online-encoding this stream
        (``data/crec.online_info``): crec v1 takes nnz and rows from the
        file's header, dense text from the config. ``file=None`` is the
        probe made before a file is at hand (admission depends on the bucket
        count, so nominal nnz and rows stand in)."""
        cfg = self.cfg
        if fmt == "crec":
            if file is None:
                return online_info(1, RSUB, cfg.num_buckets)
            src = read_header(file)
            return online_info(src.nnz, src.block_rows, cfg.num_buckets)
        return online_info(self._text_nnz(), cfg.text_block_rows,
                           cfg.num_buckets)

    def _tile_online(self, fmt: Optional[str] = None,
                     file: Optional[str] = None) -> bool:
        """Does this stream run the online tile-encode path
        (``tile_online``)? ``on`` requires an admissible stream and raises
        with the reason otherwise; ``off`` never routes; crec2 files are
        encoded already and ignore the knob. ``auto`` never routes on the
        CPU, as the JAX package off a TPU; on a CUDA device it is the
        port's choice from its card measurement (the JAX package routes
        only on a TPU): an admissible stream routes only for a store with
        no dense-apply step. The choice and its reason are kept in
        ``tile_online_record``."""
        cfg = self.cfg
        mode = cfg.tile_online
        fmt = fmt or cfg.data_format
        if mode == "off" or fmt == "crec2":
            self.tile_online_record = ("off", f"tile_online={mode}, "
                                       f"data_format={fmt}")
            return False
        why = None
        if fmt not in ("crec", "criteo", "adfea"):
            why = (f"format {fmt!r} is not a binary-feature streaming "
                   "format (crec/criteo/adfea)")
        elif not hasattr(self.store, "tile_train_step"):
            why = (f"store {type(self.store).__name__} has no tile "
                   "step surface")
        else:
            try:
                self._online_info(fmt, file).spec
            except ValueError as e:
                why = f"tilemm limits reject the geometry: {e}"
        if why is not None:
            if mode == "on":
                raise ValueError(f"tile_online=on but {why}")
            self.tile_online_record = ("off", why)
            return False
        if mode == "on":
            self.tile_online_record = ("on", "tile_online=on")
        elif self.device.type != "cuda":
            self.tile_online_record = ("off", "auto off a CUDA device")
        elif hasattr(self.store, "dense_train_step"):
            self.tile_online_record = ONLINE_AUTO_DENSE
        else:
            self.tile_online_record = ONLINE_AUTO_TILE_ONLY
        return self.tile_online_record[0] == "on"

    def _make_feed(self, file: str, part: int, nparts: int, fmt: str,
                   cache: bool = False, tile_info=None, host: bool = False):
        """The block feed of one part: crec/crec2 files through
        ``PackedFeed``, criteo/adfea text through ``TextCRecFeed``, and, with
        ``tile_info``, either of the v1 sources kept on the host (``host``,
        an identity put) under a ``TileOnlineFeed``."""
        cfg = self.cfg
        workers = cfg.pipeline_workers
        depth = max(cfg.pipeline_ring, 3 if workers == 0 else 1)
        if tile_info is not None and fmt != "crec2":
            inner = self._make_feed(file, part, nparts, fmt, host=True)
            return TileOnlineFeed(inner, tile_info, workers=workers,
                                  depth=depth, device=self.device,
                                  cache=cache)
        put = (lambda x: x) if host else None
        dev = None if host else self.device
        if fmt in ("crec", "crec2"):
            return PackedFeed(file, part, nparts, dev, depth, fmt=fmt,
                              cache=cache, device_put=put, workers=workers)
        return TextCRecFeed(file, part, nparts, dev, text_fmt=fmt,
                            nnz=self._text_nnz(),
                            block_rows=cfg.text_block_rows, depth=depth,
                            device_put=put, cache=cache, workers=workers)

    def _feed(self, file: str, part: int, nparts: int, fmt: str,
              tile_info=None):
        """The feed of a (file, part), kept across passes with
        ``cache_device`` so later passes replay device-resident blocks."""
        if not self.cfg.cache_device:
            return self._make_feed(file, part, nparts, fmt,
                                   tile_info=tile_info)
        key = (file, part, nparts, fmt, tile_info is not None)
        feed = self._feeds.get(key)
        if feed is None:
            feed = self._feeds[key] = self._make_feed(
                file, part, nparts, fmt, cache=True, tile_info=tile_info)
        return feed

    def _block_info(self, fmt: str, file: str):
        """(block geometry, online, tile) of a block-path file: a crec2
        header, the online encoder's geometry, or a crec v1 / dense-text
        block's."""
        cfg = self.cfg
        online = fmt != "crec2" and self._tile_online(fmt, file)
        if fmt == "crec2":
            if not hasattr(self.store, "tile_train_step"):
                raise ValueError(
                    f"store {type(self.store).__name__} has no tile step; "
                    "crec2 streaming needs the table-backed ShardedStore")
            info = read_header2(file)
            if info.nb != cfg.num_buckets:
                raise ValueError(
                    f"{file}: crec2 was written for num_buckets={info.nb} "
                    f"but config says {cfg.num_buckets} (the tile grouping "
                    "is bucket-count specific)")
        elif online:
            info = self._online_info(fmt, file)
        else:
            if not hasattr(self.store, "dense_train_step"):
                raise ValueError(
                    f"store {type(self.store).__name__} has no dense-apply "
                    "step; crec streaming needs the table-backed "
                    "ShardedStore")
            info = (read_header(file) if fmt == "crec" else
                    CRecInfo(nnz=self._text_nnz(),
                             block_rows=cfg.text_block_rows, total_rows=0))
        return info, online, fmt == "crec2" or online

    def _process_crec(self, file: str, part: int, nparts: int,
                      kind: str, pooled: Optional[list]) -> Progress:
        """The block paths (the JAX ``_process_crec``, async_sgd.py:583):
        crec2 blocks and online-encoded blocks run the tile steps, crec v1
        and dense-text blocks the dense-apply steps, and an online block
        whose spill overflowed its cap (a SparseBatch) the sparse step.

        A train step is gated so that at most ``max(max_delay, 1)`` steps
        are in flight (tau = the steps still in flight). Tile train metrics
        add into the store's on-device accumulator, fetched once per window
        of ``CREC_DRAIN_CHUNK`` steps and at the part's end; every other
        step's metrics (and an eval block's margins) come home as one async
        copy. A replay of cached blocks skips the gate, and leaves a tile
        window shorter than a chunk open for the pass's flush."""
        cfg = self.cfg
        fmt = cfg.data_format
        info, online, tile = self._block_info(fmt, file)
        max_delay = cfg.max_delay if kind == TRAIN else 1 << 30
        tau_cap = float(max(cfg.max_delay - 1, 0))
        acc_metrics = tile and kind == TRAIN
        inflight: deque = deque()
        pending: list = []     # (ticket, host labels) of per-step metrics
        spill: list = []       # the same, for overflow-fallback steps
        local = Progress()
        bins = 512

        def pool_margin(margin, labels_u8) -> None:
            if pooled is not None and labels_u8 is not None:
                real = labels_u8 != 255
                # host-sync: none, the block's labels are host numpy
                n_real = int(real.sum())
                pooled.append((margin[real],
                               np.minimum(labels_u8[real], 1)
                               .astype(np.float32),
                               np.ones(n_real, np.float32)))

        def drain_spill() -> None:
            """Overflow-fallback steps: the sparse path's metric layout
            [objv, num_ex, auc, acc, wdelta2 | margin]."""
            for ticket, labels_u8 in spill:
                m = ticket.resolve()
                local.objv += float(m[0])
                local.num_ex += int(m[1])
                local.count += 1
                local.auc += float(m[2])
                local.acc += float(m[3])
                if kind == TRAIN:
                    local.wdelta2 += float(m[4])
                else:
                    pool_margin(m[4:], labels_u8)
            spill.clear()

        def drain_pending(final: bool = True) -> None:
            drain_spill()
            if acc_metrics:
                self._drain_crec2_train(local, final)
                return
            for ticket, labels_u8 in pending:
                m = ticket.resolve()
                local.objv += float(m[0])
                local.num_ex += int(m[1])
                local.count += 1
                if tile:   # [objv, num_ex, acc, pos, neg, margin]
                    local.acc += float(m[2])
                    local.auc += auc_from_hist(m[3:3 + bins],
                                               m[3 + bins:3 + 2 * bins])
                    rest = m[3 + 2 * bins:]
                else:      # [objv, num_ex, auc, acc, wdelta2 | margin]
                    local.auc += float(m[2])
                    local.acc += float(m[3])
                    rest = m[4:]
                if kind == TRAIN:
                    local.wdelta2 += float(rest[0])
                else:
                    pool_margin(rest, labels_u8)
            pending.clear()
            if kind == TRAIN:
                self._display(local)

        def collect(item) -> None:
            obj, labels, is_spill = item
            if is_spill:
                spill.append((obj, labels))
            elif not acc_metrics:
                pending.append((obj, labels))

        def harvest(item) -> None:
            obj = item[0]
            if isinstance(obj, MetricTicket):
                obj.resolve()           # waits for the step's copy
            elif obj is not None:
                # host-sync: a tile step's completion event, harvested a
                # window behind the dispatch
                obj.synchronize()
            collect(item)
            if kind == TRAIN and self.reporter.due():
                drain_pending(final=not acc_metrics)

        pfx = "" if kind == TRAIN else "eval_"
        feed = self._feed(file, part, nparts, fmt,
                          tile_info=info if online else None)

        def labels_of(host) -> np.ndarray:
            return feed.labels(host).copy()

        put_before = feed.put_time
        # read before iterating: the feed marks its cache full as its
        # stream ends, in the middle of this part
        replay = feed._cache_full
        if replay:
            # cached blocks are resident already: the gate would only cost
            # a host round trip per step
            max_delay = 1 << 30
        store = self.store
        for dev, host, _rows in feed:
            with self.timer.scope(pfx + "wait"):
                while len(inflight) > max(max_delay - 1, 0):
                    harvest(inflight.popleft())
            tau = min(float(len(inflight)), tau_cap)
            with self.timer.scope(pfx + "dispatch"):
                if tile and isinstance(dev, dict):
                    if kind == TRAIN:
                        inflight.append((store.tile_train_step(
                            dev, info, tau=tau), None, False))
                        self._crec_count += 1
                        if self._crec_count >= self.CREC_DRAIN_CHUNK:
                            self._drain_crec2_train(local, final=False)
                    else:
                        objv, num_ex, acc, pos, neg, margin = \
                            store.tile_eval_step(dev, info)
                        inflight.append((to_host_async(torch.cat([
                            torch.stack([objv, num_ex, acc]), pos, neg,
                            margin])), labels_of(host), False))
                elif tile:
                    # the online overflow fallback: a SparseBatch, through
                    # the sparse step, counted
                    self._fallback_counter().inc(1)
                    if kind == TRAIN:
                        m = torch.stack(store.train_step(dev, tau=tau))
                    else:
                        objv, num_ex, a, acc, margin = store.eval_step(dev)
                        m = torch.cat([torch.stack([objv, num_ex, a, acc]),
                                       margin])
                    inflight.append((to_host_async(m), labels_of(host),
                                     True))
                elif kind == TRAIN:
                    inflight.append((to_host_async(torch.stack(
                        store.dense_train_step(dev, info.block_rows,
                                               info.nnz, tau=tau))),
                        None, False))
                else:
                    objv, num_ex, a, acc, margin = store.dense_eval_step(
                        dev, info.block_rows, info.nnz)
                    inflight.append((to_host_async(torch.cat([
                        torch.stack([objv, num_ex, a, acc]), margin])),
                        labels_of(host), False))
                if not acc_metrics and len(pending) >= self.CREC_DRAIN_CHUNK:
                    drain_pending()
        with self.timer.scope(pfx + "wait"):
            while inflight:
                collect(inflight.popleft())
            if acc_metrics and replay:
                drain_spill()
                if self._crec_count >= self.CREC_DRAIN_CHUNK:
                    self._drain_crec2_train(local, final=False)
            else:
                drain_pending()
        self.timer.add(pfx + "put", feed.put_time - put_before)
        self._merge_pipe_snap(feed.drain_pipe_stats(), pfx, local)
        return local

    def _mesh_tiles(self, info, is_tile: bool):
        """(first tile, tile count) of this position's shard of a crec2
        block's pair words; None without a model axis."""
        if not (is_tile and self.rt.have_model):
            return None
        nbl = info.spec.nb // self.rt.model_axis_size
        return (self.rt.model_index * nbl // TILE, nbl // TILE)

    def _mesh_eval_row(self, m) -> MetricTicket:
        """An eval mesh step's (objv, num_ex, acc, pos, neg, margin) as one
        async host copy."""
        objv, num_ex, acc, pos, neg, margin = m
        return to_host_async(torch.cat([torch.stack([objv, num_ex, acc]),
                                        pos, neg, margin]))

    def _fold_mesh_eval(self, local: Progress, row: np.ndarray,
                        labels_u8, pooled) -> None:
        """Fold one resolved eval row: the data-axis sums into ``local``,
        this block's real rows' margins into ``pooled``."""
        bins = 512
        local.objv += float(row[0])
        local.num_ex += int(row[1])
        local.count += 1
        local.acc += float(row[2])
        local.auc += auc_from_hist(row[3:3 + bins],
                                   row[3 + bins:3 + 2 * bins])
        if pooled is not None and labels_u8 is not None:
            margin = row[3 + 2 * bins:]
            real = labels_u8 != 255
            pooled.append((margin[real],
                           np.minimum(labels_u8[real], 1)
                           .astype(np.float32),
                           np.ones(int(real.sum()), np.float32)))

    def _merge_pipe_snap(self, snap: Optional[dict], pfx: str,
                         local: Progress) -> None:
        """Fold a block feed's stage counters (``drain_pipe_stats``) into
        the stage timer and the part's Progress; ``put`` is the feed's own
        ``put_time``."""
        if not snap:
            return
        n = max(snap["batches"], 1)
        self.timer.add(pfx + "read", snap["prep"], n)
        self.timer.add(pfx + "feed_stall", snap["consume_stall"], n)
        self.timer.add(pfx + "read_stall", snap["prep_stall"], n)
        self.timer.add(pfx + "put_stall", snap["put_stall"], n)
        if "encode" in snap:
            # encode_stall: the in-order transferrer waiting on the encode
            # pool, the "is encoding the bottleneck?" signal
            self.timer.add(pfx + "encode", snap["encode"], n)
            self.timer.add(pfx + "encode_stall", snap["encode_stall"], n)
            stall_c, _ = obs.metrics.encode_counters(self.obs.registry)
            stall_c.inc(snap["encode_stall"])
        self.feed_stats["feed_stall"] += snap["consume_stall"]
        self.feed_stats["feed_batches"] += snap["batches"]
        self.feed_stats["ring_max"] = max(self.feed_stats["ring_max"],
                                          snap.get("ring_max", 0))
        local.feed_stall += snap["consume_stall"]
        local.feed_batches += snap["batches"]

    # -- scheduler loop -----------------------------------------------------

    def run(self) -> Progress:
        """Pass/workload loop (AsyncSGDScheduler::Run, async_sgd.h:294-348;
        the single-process loop of wormhole_tpu/learners/async_sgd.py:1052):
        resume from ``checkpoint_dir`` or warm start from ``model_in``,
        ``max_data_pass`` training passes with a checkpoint every
        ``checkpoint_every`` passes and a validation pass after each and the
        epsilon early stop, the final checkpoint, then predict
        ``test_data``, save ``model_out`` and flush the telemetry. A drain
        request stops the pass at a part boundary, re-commits
        ``completed`` with the mid-pass state and skips predict and save.
        ``staleness_tau >= 0`` runs ``run_multihost``."""
        cfg = self.cfg
        self._check_mesh_store()
        if cfg.staleness_tau >= 0 or self.rt.world > 1:
            # the ps engine path shares the multihost pass structure even
            # on one process, as in the JAX app (async_sgd.py:1054)
            return self.run_multihost()
        run_t0 = time.monotonic()   # obs ledger: measured run wall time
        # checkpoint resume at pass granularity (rabit LoadCheckPoint
        # semantics: version = completed data passes), optimizer
        # accumulators included
        start_pass = 0
        if cfg.checkpoint_dir and self._ckpt_ok():
            start_pass, state = self.ckpt.load(self.store.state_pytree())
            if start_pass:
                self.store.restore_pytree(state)
                log.info("resumed at data pass %d", start_pass)
        if not start_pass and cfg.model_in:
            # a checkpoint resume supersedes the warm start
            self._store_io("load", cfg.model_in)
            log.info("warm start from %s", cfg.model_in)
        if cfg.max_data_pass > 0:
            print(Progress.HEADER)
        prev_objv_ex = None
        last_saved = completed = start_pass
        drained = False
        for data_pass in range(start_pass, cfg.max_data_pass):
            self.obs.set_phase(f"train:pass{data_pass}")
            pool = WorkloadPool()
            pool.add(cfg.train_data, cfg.num_parts_per_file, TRAIN)
            pass_prog = Progress()
            while True:
                if ft_supervisor.drain_requested():
                    # supervised SIGTERM: stop at this part boundary,
                    # commit below, return cleanly
                    drained = True
                    break
                wl = pool.get("proc0")
                if wl is None:
                    break
                prog = self.process(wl.file, wl.part, wl.nparts, wl.kind)
                self.progress.merge(prog)
                pass_prog.merge(prog)
                pool.finish(wl.id)
                self._check_divergence(prog)
            if drained:
                self.progress.merge(self.flush_metrics())
                log.info("drain requested: abandoning pass %d at a part "
                         "boundary (completed=%d)", data_pass, completed)
                obs_flight.record("drain", step=completed)
                break
            tail = self.flush_metrics()
            self.progress.merge(tail)
            pass_prog.merge(tail)
            self._check_divergence(tail)
            self._crec_hist = [np.zeros(512), np.zeros(512)]  # pass-level
            self._nnz_w = self.store.nnz_weight()
            completed = data_pass + 1
            if cfg.checkpoint_dir and self._ckpt_ok() \
                    and completed % max(cfg.checkpoint_every, 1) == 0:
                self.ckpt.save(completed, self.store.state_pytree())
                last_saved = completed
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
        if cfg.checkpoint_dir and self._ckpt_ok() and \
                (last_saved < completed or (drained and completed)):
            # the final pass must never be lost to checkpoint_every
            # misalignment or an epsilon early stop; a drain re-commits
            # `completed` with the freshest (mid-pass) state
            self.ckpt.save(completed, self.store.state_pytree())
        if cfg.test_data and not drained:
            self.predict(cfg.test_data, cfg.pred_out)
        if cfg.model_out and not drained:
            self._store_io("save", cfg.model_out)
        if self.timer.totals:
            log.info("pipeline profile:\n%s", self.timer.report())
        if self.obs.active:
            self.obs.finalize(step=self.progress.count,
                              num_ex=self.progress.num_ex,
                              feed_stall=self.feed_stats["feed_stall"],
                              timer=self.timer, progress=self.progress,
                              wall_s=time.monotonic() - run_t0)
        return self.progress

    # -- the multihost pass structure ------------------------------------------
    #
    # The JAX app runs staleness_tau >= 0 through its multihost passes even
    # on one process, and every run past one process (async_sgd.py:1155-
    # 1882). The port keeps their structure over the transport stack
    # (parallel/collectives.py): on a world of one the collectives return
    # the caller's values; past one the processes exchange over the wire.
    #
    # The BSP train step past one process is ONE global step on every
    # process: each host's batch (its own part, its own key set, its cols
    # offset to its key segment at slot · key_pad) is allgathered as host
    # numpy (``host_local_to_global``), concatenated in rank order, and
    # every process runs the same sparse step on the same global batch
    # against its replica of the table. This keeps the replicas bitwise
    # equal, and the global batch's fixed_bytes scale (one max|g|) and AUC
    # are global by construction, as in the JAX step; the price is
    # redundant compute, N steps of N hosts' rows. A key in several hosts'
    # segments takes each segment's delta, from the same pre-step rows,
    # added in rank order (``store.write_rows``).

    def _host_slot(self) -> int:
        """This host's block position along the mesh data axis: its rank.
        The port's mesh is one device per process with a data axis of the
        world (``MeshRuntime``), which is what the JAX ``_host_slot``
        checks the mesh for (each data index within one process, each
        process one contiguous run)."""
        rt = self.rt
        if self.cfg.data_format in ("crec", "crec2"):
            # the mesh step: a data index's positions read its blocks
            return rt.data_index
        if rt.data_axis_size != rt.world or rt.model_axis_size != 1:
            raise ValueError(
                f"data axis {rt.data_axis_size} x model axis "
                f"{rt.model_axis_size} over a world of {rt.world}: the "
                "global batch needs one data index per process (a model "
                "axis is for crec and crec2, whose mesh step shards the "
                "table)")
        return rt.rank

    def _global_batch(self, batch):
        """The hosts' batches as one global batch on the device: rows in
        rank order, each host's key segment at ``slot · key_pad`` (its
        cols offset there), and the segments' real-key counts in
        ``key_segments``. On a world of one the host's batch as it is."""
        world = self.rt.world
        if world == 1:
            return batch
        kpad = self.cfg.key_pad
        h = batch.on_host()
        local = {"cols": h.cols.numpy() + np.int32(self._slot * kpad),
                 "vals": h.vals.numpy(), "labels": h.labels.numpy(),
                 "row_mask": h.row_mask.numpy(),
                 "uniq_keys": h.uniq_keys.numpy(),
                 "key_mask": h.key_mask.numpy(),
                 "counts": np.array([[h.num_real or 0, h.num_keys or 0]],
                                    np.int64)}
        g = host_local_to_global(local, self.rt.mesh)
        counts = g.pop("counts")
        gb = SparseBatch(
            **{k: torch.from_numpy(v) for k, v in g.items()},
            key_segments=tuple((r * kpad, int(counts[r, 1]))
                               for r in range(world)))
        return gb.to(self.device, non_blocking=True)

    def _my_rows(self, x: torch.Tensor) -> np.ndarray:
        """This host's rows of a global batch's per-row output."""
        if self.rt.world == 1:
            return x.cpu().numpy()
        mb = self.cfg.minibatch
        return x[self._slot * mb:(self._slot + 1) * mb].cpu().numpy()

    def _empty_local_batch(self, host: bool = False) -> SparseBatch:
        """A batch with no real row and no real key, at the static shapes:
        what a host whose data ran out feeds into a window or a round (on
        the host for the global batch's assembly)."""
        cfg = self.cfg
        dev = torch.device("cpu") if host else self.device
        mb, nnz, kp = cfg.minibatch, cfg.max_nnz, cfg.key_pad
        return SparseBatch(
            cols=torch.zeros((mb, nnz), dtype=torch.int32, device=dev),
            vals=torch.zeros((mb, nnz), dtype=torch.float32, device=dev),
            labels=torch.zeros(mb, dtype=torch.float32, device=dev),
            row_mask=torch.zeros(mb, dtype=torch.float32, device=dev),
            uniq_keys=torch.zeros(kp, dtype=torch.int32, device=dev),
            key_mask=torch.zeros(kp, dtype=torch.float32, device=dev),
            num_real=0, num_keys=0)

    def _ctl(self, fn):
        """Run one control-plane host exchange: through the engine's drain
        thread when the ps engine is live (the single global exchange
        order), else inline."""
        eng = self._engine
        return eng.exchange(fn) if eng is not None else fn()

    def _ps_apply(self, ticket, local: Progress) -> bool:
        """Apply one completed delta window to the store and fold its summed
        metrics; True when the window proves the pass globally drained (no
        rank fed a real batch into it). A window that crossed the wire
        comes back as host numpy and goes to the device here, on the
        trainer thread."""
        res = ticket.result
        tau = self._engine.note_applied(ticket)
        grad, m = res["grad"], res["metrics"]
        if isinstance(grad, np.ndarray):
            with self.timer.scope("ps:put"):
                grad = host_to_device(grad, self.device)
            m = np.asarray(m, np.float64)
        else:
            m = m.resolve().astype(np.float64)
        with obs.trace.span("ps:apply", cat="ps", args={"tau": tau}):
            self.store.ps_push(grad, tau=float(tau))
        if "vv" in res:
            # the one-hot rows sum to the full per-rank window-counter
            # vector (ft/rejoin.VersionVector); max-merge, so a replayed
            # or stale row never regresses it
            self._rejoin_vv.merge_row(res["vv"])
        if m[1] > 0:
            local.objv += float(m[0])
            local.num_ex += int(m[1])
            local.count += 1
            # auc/acc travel example-weighted, so the sum renormalizes to
            # the window's pooled fraction
            local.auc += float(m[2]) / m[1]
            local.acc += float(m[3]) / m[1]
            self._display(local)
        return int(res["have"]) == 0

    def _ps_exchange(self, dense: torch.Tensor, mets: torch.Tensor,
                     have: bool, vv: Optional[np.ndarray] = None):
        """The drain-thread closure of one window's exchange.

        On a world of one the payload is the device window itself and the
        exchange returns it untouched (no CUDA work on the drain thread).
        Past one process the window crosses as host bytes: the trainer
        thread copies the window and its metrics into one pinned buffer
        with ``non_blocking`` copies and records an event; the drain
        thread only waits on that event (it launches nothing), then
        allreduces the JAX payload (``grad`` f32, ``metrics`` f32 of the
        f64 sums, ``have`` int64) as numpy views of the buffer. The copy's
        device ms and the exchange's ms go to ``ps_window_stats``. ``vv``,
        the version-vector row of a run with a replay log, rides along as
        an int64 leaf."""
        extra = {} if vv is None else {"vv": vv}
        if self.rt.world == 1:
            payload = {"grad": dense,
                       "metrics": to_host_async(mets.to(torch.float32)),
                       "have": np.int64(have), **extra}
            # transport: engine — the closure executes on the drain thread
            return lambda p=payload: allreduce_tree(
                p, self.rt.mesh, "sum", site="ps/delta")
        nb = dense.numel()
        e0 = e1 = None
        if dense.device.type == "cuda":
            buf = torch.empty(nb + 4, dtype=torch.float32, pin_memory=True)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            buf[:nb].copy_(dense, non_blocking=True)
            buf[nb:].copy_(mets.to(torch.float32), non_blocking=True)
            e1.record()
        else:
            buf = torch.cat([dense, mets.to(torch.float32)])
        stats = self.ps_window_stats

        def exchange():
            if e1 is not None:
                e1.synchronize()
                stats["d2h_ms"] += e0.elapsed_time(e1)
            arr = buf.numpy()
            t0 = time.perf_counter()
            # transport: engine — the closure executes on the drain thread
            out = allreduce_tree(
                {"grad": arr[:nb], "metrics": arr[nb:],
                 "have": np.int64(have), **extra},
                self.rt.mesh, "sum", site="ps/delta")
            stats["exchange_ms"] += (time.perf_counter() - t0) * 1e3
            stats["windows"] += 1
            return out

        return exchange

    def _multihost_pass_ps(self, pattern: str) -> Progress:
        """One TRAIN pass through the bounded-staleness engine (the JAX
        ``_multihost_pass_ps``, async_sgd.py:1306).

        Each window takes up to ``ps_window_steps`` of this rank's
        minibatches (parts round-robin, ``take_static``), pulls their
        gradients at the same weights (``dt2_pull``) and sums them into one
        dense bucket-space delta. The JAX app scatters into a host array
        (``np.add.at``); here the delta stays on the device and
        ``index_add_`` adds each batch's real keys, which are unique within
        a batch, so every bucket takes one add a batch in batch order: the
        same f32 sums, and the same bits, as the host scatter. The window's
        metrics are summed on the device in f64 (the JAX host arithmetic).
        The window goes through the engine (``_ps_exchange``: summed over
        the ranks in rank order) and is applied by ``ps_push`` at most
        ``staleness_tau`` windows later. A pass ends with the window that
        proves every rank drained, so it always ends with one empty window
        at tau 0 (tau + 1 counting the ones in flight)."""
        cfg = self.cfg
        engine = self._engine
        dev = self.device
        local = Progress()
        pool = WorkloadPool()
        pool.add(pattern, cfg.num_parts_per_file, TRAIN)
        mine = pool.take_static(self.rt.world, self.rt.rank)

        def batches():
            for wl in mine:
                yield from self._batches(wl.file, wl.part, wl.nparts)

        it = batches()
        window = max(1, cfg.ps_window_steps)
        # the version-vector row rides each window only with a replay log
        # (rejoin off leaves the payload as it was: tau 0 = BSP bitwise)
        vv_on = engine.replay is not None
        if vv_on and not hasattr(self, "_rejoin_vv"):
            self._rejoin_vv = VersionVector(self.rt.world)
        stop = False
        while not stop:
            if ft_supervisor.drain_requested():
                # flush the windows in flight into the store before the
                # survivor checkpoint commits (run_multihost's handler)
                with self.timer.scope("wait"):
                    for tk in engine.quiesce():
                        self._ps_apply(tk, local)
                raise ft_supervisor.DrainInterrupt()
            dense = torch.zeros(cfg.num_buckets, dtype=torch.float32,
                                device=dev)
            mets = torch.zeros(4, dtype=torch.float64, device=dev)
            have_local = False
            for _ in range(window):
                with self.timer.scope("parse"):
                    blk = next(it, None)
                real = blk is not None
                have_local = have_local or real
                batch = blk if real else self._empty_local_batch()
                with self.timer.scope("dispatch"):
                    grad, _snap, m = self.store.dt2_pull(batch)
                    k = batch.num_keys
                    dense.index_add_(0, batch.uniq_keys[:k].to(torch.int64),
                                     (grad * batch.key_mask)[:k])
                    nex = m[1].to(torch.float64)
                    mets += torch.stack([m[0].to(torch.float64), nex,
                                         m[2].to(torch.float64) * nex,
                                         m[3].to(torch.float64) * nex])
                if not real:
                    break   # local tail: no more empties in this window
            vv = None
            if vv_on:
                # own window count in own slot; the delta sum rebuilds the
                # whole vector at no extra exchange
                self._rejoin_vv.bump(self.rt.rank)
                vv = self._rejoin_vv.one_hot(self.rt.rank)
            engine.submit(self._ps_exchange(dense, mets, have_local, vv))
            with self.timer.scope("wait"):
                for tk in engine.gate():
                    stop = self._ps_apply(tk, local) or stop
        with self.timer.scope("wait"):
            for tk in engine.quiesce():
                self._ps_apply(tk, local)
        return local

    def _multihost_pass(self, pattern: str, kind: str,
                        pooled: Optional[list] = None) -> Progress:
        """One synchronized pass over ``pattern`` with the replicated
        dynamic pool (the JAX ``_multihost_pass``, async_sgd.py:1386): a
        status allgather a round (through ``_ctl``) drives identical finish
        and claim transitions in every replica (``ReplicatedRounds``:
        rounds-based straggler re-issue with an exact block skip), a
        ``have`` exchange ends the pass when no rank fed a batch, and each
        round runs the global step (``_global_batch``): TRAIN with at most
        ``max_delay`` steps' metrics in flight, VAL and TEST the eval step,
        this host's rows pooled. Every metric comes out of the global step,
        so every rank computes the same values."""
        cfg = self.cfg
        world = self.rt.world
        host = world > 1
        pool = WorkloadPool(straggler_factor=cfg.straggler_factor)
        pool.add(pattern, cfg.num_parts_per_file, kind)
        rr = ReplicatedRounds(pool, world, self.rt.rank)
        my_it = None
        my_wl = None
        my_skip = 0
        drained = False
        finished_id = -1
        local = Progress()
        inflight: deque = deque()
        pfx = "" if kind == TRAIN else "eval_"
        tau_cap = float(max(cfg.max_delay - 1, 0))

        def harvest(metrics) -> None:
            vals = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                                for v in metrics[:4]]).cpu().numpy()
            local.objv += float(vals[0])
            local.num_ex += int(vals[1])
            local.count += 1
            local.auc += float(vals[2])
            local.acc += float(vals[3])
            if kind == TRAIN:
                self._display(local)

        while True:
            if ft_supervisor.drain_requested():
                # leave the round loop before the next exchange, which
                # could wait on a dead rank; run_multihost commits
                raise ft_supervisor.DrainInterrupt()
            blk = None
            if my_it is not None:
                with self.timer.scope(pfx + "parse"):
                    blk = next(my_it, None)
                if blk is None:
                    finished_id = my_wl.id
                    my_it = None
                else:
                    rr.produced(1)
            # drained hosts stay needy: a straggler re-issue must find a
            # claimant (drained flips back off when the pool hands work)
            need = my_it is None
            status = self._ctl(
                # transport: engine — control exchange on the drain thread
                lambda: allgather_tree(
                    rr.status_row(finished_id, need, drained),
                    self.rt.mesh, site="async_sgd/status"))
            finished_id = -1
            rr.advance(status)
            # identical pool transitions on every replica, in rank order
            for r in range(world):
                if status[r, 0] >= 0:
                    rr.finished(int(status[r, 0]))
            any_claimed = False
            for r in range(world):
                if status[r, 1]:
                    wl = pool.get(f"proc{r}")
                    if wl is not None:
                        any_claimed = True
                        if rr.reclaimed_from(wl, r):
                            # straggler handoff: the new holder resumes at
                            # our skip point; stop without finishing
                            log.info("part %d re-issued to proc%d; "
                                     "abandoning at block %d", wl.id, r,
                                     rr._progress.get(wl.id, 0))
                            my_it = None
                            my_wl = None
                            rr.abandon()
                        skip = rr.claimed(r, wl)
                    else:
                        skip = 0
                    if r == self.rt.rank:
                        my_wl = wl
                        my_skip = skip
            if need:
                if my_wl is None:
                    drained = True
                else:
                    drained = False
                    my_it = self._batches(my_wl.file, my_wl.part,
                                          my_wl.nparts, pfx, host=host)
                    if my_skip:
                        my_it = islice(my_it, my_skip, None)
                    with self.timer.scope(pfx + "parse"):
                        blk = next(my_it, None)
                    if blk is None:       # empty part: finish next round
                        finished_id = my_wl.id
                        my_it = None
                    else:
                        rr.produced(1)
            have = int(self._ctl(
                # transport: engine — control exchange on the drain thread
                lambda b=blk: allreduce_tree(np.int64(b is not None),
                                             self.rt.mesh, "sum",
                                             site="async_sgd/have")))
            if have == 0:
                # a global decision: status and the pool (so any_claimed)
                # are identical on every replica
                if bool(np.all(status[:, 2])) and not any_claimed:
                    break
                continue
            batch = (blk if blk is not None
                     else self._empty_local_batch(host=host))
            gb = self._global_batch(batch)
            with self.timer.scope(pfx + "dispatch"):
                if kind == TRAIN:
                    inflight.append(self.store.train_step(
                        gb, tau=min(float(len(inflight)), tau_cap)))
                else:
                    m = self.store.eval_step(gb)
                    harvest(m)
                    if pooled is not None and blk is not None:
                        margins = self._my_rows(m[4])
                        keep = self._real_rows(batch)
                        real = keep >= 0
                        pooled.append((margins[real],
                                       batch.on_host().labels.numpy()[real],
                                       np.maximum(keep[real], 0.0)))
            with self.timer.scope(pfx + "wait"):
                while len(inflight) > cfg.max_delay:
                    harvest(inflight.popleft())
        with self.timer.scope(pfx + "wait"):
            while inflight:
                harvest(inflight.popleft())
        return local

    def _multihost_pass_crec(self, pattern: str, kind: str,
                             pooled: Optional[list] = None) -> Progress:
        """One synchronized crec/crec2 pass across the mesh (the JAX
        ``_multihost_pass_crec``, async_sgd.py:1526): the hosts are the
        data indices; each runs the replicated pool (its status and
        ``have`` exchanged over its data-axis line, through ``_ctl``, so
        under the ps engine they keep the drain thread's order), streams
        blocks of its claimed part, and steps one block a round through
        the mesh step (crec2: ``tile_train_step_mesh`` on its tile range;
        crec v1: ``dense_train_step_mesh``). A host with no block this
        round steps an all-PAD block (``mesh_pads``), which adds nothing
        to any sum; a straggler's part is re-issued with an exact block
        skip (``ReplicatedRounds``). The model shards of a data index read
        the same blocks and take the same decisions. Every metric comes
        out of the mesh step's data-axis sums, so every position computes
        the same values; eval pools this host's real rows."""
        cfg = self.cfg
        fmt = cfg.data_format
        rt = self.rt
        hosts = rt.data_axis_size
        me = rt.data_index
        data_stack, _ = rt.axis_stacks()
        pool = WorkloadPool(straggler_factor=cfg.straggler_factor)
        pool.add(pattern, cfg.num_parts_per_file, kind)
        rr = ReplicatedRounds(pool, hosts, me)
        my_skip = 0
        read_hdr = read_header2 if fmt == "crec2" else read_header
        info = read_hdr(list_files(pattern)[0].path)
        is_tile = fmt == "crec2"
        tiles = self._mesh_tiles(info, is_tile)
        pads = mesh_pads(info, is_tile)
        put = BlockPut(self.device)
        my_it = None
        my_wl = None
        drained = False
        finished_id = -1
        local = Progress()
        hist_tot = [np.zeros(512), np.zeros(512)]
        pfx = "" if kind == TRAIN else "eval_"
        store = self.store

        def feed_iter(wl, skip=0):
            hdr = read_hdr(wl.file)
            if is_tile:
                same = (hdr.nb == cfg.num_buckets and hdr.spec == info.spec
                        and hdr.block_rows == info.block_rows
                        and hdr.nnz == info.nnz
                        and hdr.ovf_cap == info.ovf_cap)
            else:
                same = (hdr.block_rows == info.block_rows
                        and hdr.nnz == info.nnz)
            if not same:
                raise ValueError(
                    f"{wl.file}: {fmt} geometry does not match the "
                    f"dataset's first file ({hdr} vs {info}); the hosts' "
                    "blocks must be shape-identical")
            it = iter(PackedFeed(wl.file, wl.part, wl.nparts, fmt=fmt,
                                 device_put=lambda x: x))
            if skip:
                # straggler handoff: resume after the blocks the original
                # holder already stepped (read and drop)
                it = islice(it, skip, None)
            return it

        nsteps = [0]

        def drain_pending(final: bool = True) -> None:
            self._harvest_macc(local, hist_tot, nsteps[0], final)
            nsteps[0] = 0

        def collect(group):
            nonlocal my_it, finished_id
            while my_it is not None and len(group) < 1:
                with self.timer.scope(pfx + "parse"):
                    item = next(my_it, None)
                if item is None:
                    finished_id = my_wl.id
                    my_it = None
                else:
                    group.append(item[0])
                    rr.produced(1)

        while True:
            if ft_supervisor.drain_requested():
                raise ft_supervisor.DrainInterrupt()
            group: list = []
            collect(group)
            # drained hosts stay needy: a straggler re-issue must find a
            # claimant
            need = my_it is None
            row = rr.status_row(finished_id, need, drained)
            status = self._ctl(lambda: np.asarray(data_stack.allgather(
                row, None, site="async_sgd/status")))
            finished_id = -1
            rr.advance(status)
            for r in range(hosts):
                if status[r, 0] >= 0:
                    rr.finished(int(status[r, 0]))
            any_claimed = False
            for r in range(hosts):
                if status[r, 1]:
                    wl = pool.get(f"proc{r}")
                    if wl is not None:
                        any_claimed = True
                        if rr.reclaimed_from(wl, r):
                            log.info("part %d re-issued to proc%d; "
                                     "abandoning at block %d", wl.id, r,
                                     rr._progress.get(wl.id, 0))
                            my_it = None
                            my_wl = None
                            rr.abandon()
                        skip = rr.claimed(r, wl)
                    else:
                        skip = 0
                    if r == me:
                        my_wl = wl
                        my_skip = skip
            if need:
                if my_wl is None:
                    drained = True
                else:
                    drained = False
                    my_it = feed_iter(my_wl, my_skip)
                    collect(group)   # contribute in the claim round too
            have = int(self._ctl(lambda g=group: data_stack.allreduce(
                np.int64(len(g)), None, "sum", site="async_sgd/have")))
            if have == 0:
                # a global decision: status and the pool are identical on
                # every replica
                if bool(np.all(status[:, 2])) and not any_claimed:
                    break
                continue
            host_blk = group[0] if group else pads
            blocks, _ = stack_mesh_group(group, 1, info, pads, is_tile)
            mine = mesh_lane(blocks, 0, tiles)
            with self.timer.scope(pfx + "put"):
                dev = settle(*put(mine))
            with self.timer.scope(pfx + "dispatch"):
                if kind == TRAIN:
                    if is_tile:
                        store.tile_train_step_mesh(dev, info)
                    else:
                        store.dense_train_step_mesh(dev, info.block_rows,
                                                    info.nnz)
                    nsteps[0] += 1
                    if (self.reporter.due()
                            or nsteps[0] >= self.CREC_DRAIN_CHUNK):
                        with self.timer.scope(pfx + "wait"):
                            drain_pending(final=False)
                else:
                    m = (store.tile_eval_step_mesh(dev, info) if is_tile
                         else store.dense_eval_step_mesh(
                             dev, info.block_rows, info.nnz))
                    labs = None
                    if group:
                        labs = (host_blk["labels"] if is_tile else
                                host_blk[info.block_rows * info.nnz * 4:]
                                [:info.block_rows])
                    self._fold_mesh_eval(local, self._mesh_eval_row(m)
                                         .resolve(), labs, pooled)
        with self.timer.scope(pfx + "wait"):
            drain_pending()
        return local

    def run_multihost(self) -> Progress:
        """The multihost scheduler loop (the JAX ``run_multihost``,
        async_sgd.py:1734): the ps engine when ``staleness_tau >= 0``, the
        resume version agreed across ranks (an allreduce-min) and loaded
        from ``ShardCheckpointer``, ``max_data_pass`` passes (engine or
        BSP) with a shard commit every ``checkpoint_every`` passes,
        validation through the
        replicated pool with the pooled AUC from summed histograms, the
        divergence kill switch and the epsilon stop, predict (to
        ``{pred_out}_{rank}``) and ``model_out``. A drain request raises
        ``DrainInterrupt`` out of a pass; the survivor commit re-writes
        version ``completed`` with that state, without the barrier, and the
        run returns. The engine stops in ``finally``."""
        run_t0 = time.monotonic()
        cfg = self.cfg
        crec = cfg.data_format in ("crec", "crec2")
        if not crec and not (cfg.max_nnz and cfg.key_pad):
            raise ValueError("multi-host sync training (and the ps "
                             "engine path) needs static max_nnz= and "
                             "key_pad= config")
        self._engine = None
        if cfg.staleness_tau >= 0:
            self._engine = build_engine(cfg, registry=self.obs.registry)
            log.info("ps engine on: staleness_tau=%d window_steps=%d",
                     cfg.staleness_tau, cfg.ps_window_steps)
        self.ps_window_stats = {"windows": 0, "d2h_ms": 0.0,
                                "exchange_ms": 0.0}
        self._slot = self._host_slot()
        self._max_nnz = cfg.max_nnz
        rt = self.rt
        ckpt = (ShardCheckpointer(
            cfg.checkpoint_dir, rank=rt.rank, world=rt.world,
            shard=(rt.model_index, rt.model_axis_size), stack=rt.stack)
            if cfg.checkpoint_dir else None)
        start_pass = 0
        try:
            if ckpt is not None:
                # ranks agree on the resume point even when the checkpoint
                # dir is not shared: the slowest view wins
                ver = int(self._ctl(
                    # transport: engine — control exchange, drain thread
                    lambda: allreduce_tree(np.int64(ckpt.latest_version()),
                                           self.rt.mesh, "min",
                                           site="async_sgd/ckpt_ver")))
                if ver:
                    _, state = ckpt.load(self.store.state_pytree(),
                                         version=ver)
                    self.store.restore_pytree(state)
                    start_pass = ver
                    log.info("resumed at data pass %d", start_pass)
            if not start_pass and cfg.model_in:
                self._store_io("load", cfg.model_in)
                log.info("warm start from %s", cfg.model_in)
            if self.rt.rank == 0:
                print(Progress.HEADER)
            self._multihost_passes(ckpt, start_pass)
        finally:
            # the drain thread must not outlive the pass structure it
            # serializes (a later run would race two engines)
            if self._engine is not None:
                self._engine.stop()
                self._engine = None
        if self.timer.totals:
            log.info("pipeline profile:\n%s", self.timer.report())
        if self.obs.active:
            self.obs.finalize(step=self.progress.count,
                              num_ex=self.progress.num_ex,
                              feed_stall=self.feed_stats["feed_stall"],
                              timer=self.timer, progress=self.progress,
                              wall_s=time.monotonic() - run_t0)
        return self.progress

    def _multihost_passes(self, ckpt, start_pass: int) -> None:
        """``run_multihost``'s pass loop, survivor commit, final commit,
        predict and save."""
        cfg = self.cfg
        prev_objv_ex = None
        last_saved = completed = start_pass
        drained = False
        try:
            crec = cfg.data_format in ("crec", "crec2")
            for data_pass in range(start_pass, cfg.max_data_pass):
                self.obs.set_phase(f"multihost:pass{data_pass}")
                # crec and crec2 train through the mesh step under any
                # staleness_tau (the engine then orders the control
                # exchanges only); the sparse formats through the engine
                # or the global batch
                prog = (self._multihost_pass_crec(cfg.train_data, TRAIN)
                        if crec
                        else self._multihost_pass_ps(cfg.train_data)
                        if self._engine is not None
                        else self._multihost_pass(cfg.train_data, TRAIN))
                self.progress.merge(prog)
                self._check_divergence(prog)
                completed = data_pass + 1
                if ckpt is not None \
                        and completed % max(cfg.checkpoint_every, 1) == 0:
                    self.ckpt_version = completed
                    ckpt.save(completed, self.store.state_pytree())
                    last_saved = completed
                rec = {"pass": data_pass, "train_num_ex": prog.num_ex,
                       "train_objv": prog.objv / max(prog.num_ex, 1)}
                if cfg.val_data:
                    pooled: list = []
                    vp = (self._multihost_pass_crec(cfg.val_data, VAL,
                                                    pooled) if crec
                          else self._multihost_pass(cfg.val_data, VAL,
                                                    pooled))
                    pass_auc = self._allreduce_pooled_auc(pooled)
                    n = max(vp.num_ex, 1)
                    rec.update(val_num_ex=vp.num_ex, val_objv=vp.objv / n,
                               val_auc=pass_auc,
                               val_acc=vp.acc / max(vp.count, 1))
                    log.info("pass %d validation: objv=%.6f auc=%.6f "
                             "acc=%.6f", data_pass, rec["val_objv"],
                             pass_auc, rec["val_acc"])
                self.pass_log.append(rec)
                # prog is global (identical on every rank), so every rank
                # takes the early-stop branch in the same pass
                if self._converged(data_pass, prog, prev_objv_ex):
                    break
                prev_objv_ex = prog.objv / max(prog.num_ex, 1)
        except ft_supervisor.DrainInterrupt:
            # supervised SIGTERM: commit a survivor checkpoint without the
            # cross-rank barrier (peers may be gone; the resume-version
            # allreduce-min is the agreement). Version `completed` is
            # re-committed with the freshest window-boundary state.
            drained = True
            log.info("drain requested: abandoning pass at a block "
                     "boundary; committing survivor checkpoint v%d",
                     completed)
            obs_flight.record("drain_interrupt", step=completed)
            if ckpt is not None and completed:
                self.ckpt_version = completed
                ckpt.save(completed, self.store.state_pytree(),
                          barrier=False)
                last_saved = completed
        if ckpt is not None and last_saved < completed:
            # the final pass must never be lost to checkpoint_every
            # misalignment or an epsilon early stop
            self.ckpt_version = completed
            ckpt.save(completed, self.store.state_pytree())
        if cfg.test_data and not drained:
            pooled = []
            if cfg.data_format in ("crec", "crec2"):
                self._multihost_pass_crec(cfg.test_data, TEST, pooled)
            else:
                self._multihost_pass(cfg.test_data, TEST, pooled)
            # one file per data index: its model shards hold the same rows
            if self.rt.model_index == 0:
                self._write_preds(pooled,
                                  f"{cfg.pred_out}_{self.rt.data_index}")
        if cfg.model_out and not drained:
            self._store_io("save", cfg.model_out)

    def _allreduce_pooled_auc(self, pooled: list) -> float:
        """Pass-level AUC across hosts without gathering margins: each host
        bins its rows' (margin, label, weight) into 512 pos/neg histograms
        over [-8, 8], the histograms are summed across hosts, and the AUC is
        read from the sums (exact up to binning)."""
        bins, lo, hi = 512, -8.0, 8.0
        pos = np.zeros(bins)
        neg = np.zeros(bins)
        for margins, labels, weights in pooled:
            b = (np.clip((margins - lo) / (hi - lo), 0, 1)
                 * (bins - 1)).astype(np.int64)
            np.add.at(pos, b, (labels > 0.5) * weights)
            np.add.at(neg, b, (labels <= 0.5) * weights)
        if self.rt.model_index:
            # a data index's model shards pooled the same rows: one counts
            pos[:] = 0
            neg[:] = 0
        z = self.cfg.msg_compression
        pos, neg = self._ctl(
            # transport: engine — control exchange on the drain thread
            lambda: allreduce_tree((pos, neg), self.rt.mesh, "sum",
                                   compress=z, site="async_sgd/auc_hist"))
        return auc_from_hist(np.asarray(pos), np.asarray(neg))

    def _ckpt_ok(self) -> bool:
        """Checkpointing needs a store with ``state_pytree``; one without
        is skipped loudly (once), as in the JAX app. (Every store of the
        port is addressable from this one process.)"""
        if hasattr(self.store, "state_pytree"):
            return True
        if not self._warned_ckpt:
            self._warned_ckpt = True
            log.warning("checkpointing skipped: store %s has no "
                        "state_pytree", type(self.store).__name__)
        return False

    def _run_eval(self, pattern: str):
        """Full eval pass; returns (Progress, pooled AUC over the whole
        pass). The per-block mean AUC stays in Progress for display; the
        pooled number is the pass-level statistic."""
        self.obs.set_phase("eval")
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
        self.obs.set_phase("predict")
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
        and checked against saved models: the block paths fold u32 keys
        with mix32 (crec, crec2, dense text and the online encoder), the
        sparse path 64-bit ids with splitmix64 (data/hashing.py)."""
        return ("mix32" if self.cfg.data_format in ("crec", "crec2")
                or self._text_dense() or self._tile_online()
                else "splitmix64")

    def _store_io(self, op: str, path: str):
        """save/load the model with the key-fold tag; a save writes this
        process's file, ``{path}_{rank}``; on a model-sharded mesh the
        positions of data index 0 write their ranges, ``{path}_{m}``
        (global bucket ids), and a load merges every file."""
        if op == "save":
            rt = self.rt
            if rt.have_model:
                if rt.data_index == 0:
                    self.store.save_model(path, rt.model_index,
                                          key_fold=self._key_fold())
                return
            self.store.save_model(path, rt.rank,
                                  key_fold=self._key_fold())
        else:
            self.store.load_model(path, expect_key_fold=self._key_fold())

    # -- display and stop rules -----------------------------------------------

    def _display(self, local: Progress) -> None:
        if self.obs.tick_due():
            snap = Progress(self.progress.fvec + local.fvec,
                            self.progress.ivec + local.ivec)
            self.obs.heartbeat_tick(
                step=snap.count, num_ex=snap.num_ex,
                feed_stall=self.feed_stats["feed_stall"])
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
