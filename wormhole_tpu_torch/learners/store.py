"""Parameter store: the model table, the sparse steps and the crec2 tile
steps, one device.

The counterpart of ``wormhole_tpu/learners/store.py`` on one device. The
model is one ``(val_len, num_buckets)`` tensor on the store's device —
plane-major, unlike the JAX store's ``(num_buckets, val_len)``, so each
plane is contiguous (``handles.py``). ``from_jax_slots``/``to_jax_slots``
carry slots across in the JAX layout.

The sparse ``SparseBatch`` steps (the text and recordio formats) are the
JAX store's jitted gather, spmv and scatter written as torch ops:
``train_step`` gathers the batch's unique bucket rows, computes margins and
the gradient (``ops/spmv.py``, whose sum into the key axis is in a fixed
order on every device), quantizes it when ``fixed_bytes`` is set
(``quantize_dequantize``, the FIXING_FLOAT filter), applies the handle to
the gathered rows and writes back ``rows + (new − rows)·key_mask`` for the
real keys only. ``eval_step`` and the serving forward share one margin
function (``build_serve_margin``). ``dt2_pull``/``dt2_push`` split the
step for the delay-compensated handle, the pull snapshotting each key's
cumulative gradient.

The dense-apply steps (``dense_train_step``/``dense_eval_step``) run a crec
v1 block, as its raw bytes on the device: the keys are read from the block's
first ``R·nnz·4`` bytes, folded to buckets on the device (``mix32``), the
margins are a gather and a row sum, and the gradient sums into the whole
bucket axis through ``ops/spmv.segment_sum`` (each bucket's entries in flat
order, the JAX CPU scatter's); the handle then updates the whole table
(``masked_push``, with the touched-bucket mask where a zero-gradient push is
not the identity). Sentinel keys and pad rows are masked out.

The tile eval step runs a crec2 block through ``tilemm.forward_margins`` (the
``csrc/tile_fwd.cu`` kernel on a CUDA device) and the metric tail, and
returns the JAX step's tuple ``(objv, num_ex, acc, pos, neg, margin)``.

The tile train step resolves ``tile_step_kernel`` as the JAX store does
(``tilemm.resolve_step_kernel``; ``auto`` is fused on CUDA) and runs one of
three variants, recorded in ``step_kernel``: ``fused_update`` (FTRL, no
spill: ``tilemm.fused_step_update``, the update inside the step),
``fused`` (``tilemm.fused_step_grad``, then the spill scatter and the push)
or ``split`` (forward, dual, backward, push as separate calls). All of them
update the table in place and add the JAX packed metric row ``[objv,
num_ex, acc, wdelta2, pos[512], neg[512]]`` into an on-device accumulator
that the learner fetches once per window (``fetch_metrics_async``).

``TableCheckpoint`` (the checkpoint state, the step clock's staleness
weight and that metric accumulator) is shared with the model stores of ``wormhole_tpu_torch.models``:
``FMStore`` and ``WideDeepStore`` run the multi-channel tile steps
(``tilemm.forward_pulls``/``backward_pushes`` and the fused
``fused_fm_step``/``fused_wd_step``) and plug into the same ``AsyncSGD``.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
import re
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from wormhole_tpu_torch.data.hashing import fold_keys32_t
from wormhole_tpu_torch.data.stream import (get_filesystem, is_remote,
                                            list_files, open_stream)
from wormhole_tpu_torch.device import DeviceLike, host_to_device, \
    resolve_device
from wormhole_tpu_torch.learners.handles import FTRLHandle, Handle
from wormhole_tpu_torch.obs import trace
from wormhole_tpu_torch.ops import tilemm
from wormhole_tpu_torch.ops.loss import create_loss, loss_key, \
    nudge_zero_dual
from wormhole_tpu_torch.ops.metrics import accuracy, auc, margin_hist
from wormhole_tpu_torch.ops.spmv import segment_index, segment_sum, \
    spmv_times, spmv_trans_times
from wormhole_tpu_torch.parallel.filters import quantize_dequantize

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def zero_grad_push_is_identity(handle: Handle) -> bool:
    """True when a zero-gradient push leaves a slot row unchanged, so the
    dense table sweep needs no touched-bucket mask: always for FTRL (w is a
    pure function of z, which g = 0 leaves unchanged), and for the other
    handles only without a penalty (wormhole_tpu/learners/store.py:92)."""
    if isinstance(handle, FTRLHandle):
        return True
    return handle.penalty.lambda1 == 0.0 and handle.penalty.lambda2 == 0.0


# the JAX store's name for the nudge (wormhole_tpu/learners/store.py:117)
_nudge_zero_dual = nudge_zero_dual


def masked_push(handle: Handle, s32: torch.Tensor, grad: torch.Tensor, t,
                tau, exact_dense: bool) -> torch.Tensor:
    """Full-table handle apply, in place on the f32 slots ``s32``, with the
    touched-bucket mask when a zero-grad push is not the identity; returns
    Σ(w' - w)². The nudge and the mask are only correct together: callers
    that pass ``exact_dense=False`` formed ``grad`` from nudged duals."""
    if exact_dense:
        return handle.push(s32, grad, t, tau)
    old = s32.clone()
    handle.push(s32, grad, t, tau)
    s32.copy_(torch.where(grad != 0.0, s32, old))
    d0 = s32[0] - old[0]
    return torch.sum(d0 * d0)


def gather_rows(slots: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """The f32 rows of the plane-major table at bucket ids ``keys``:
    (val_len, len(keys)). ``keys`` may hold int32 ids."""
    return slots[:, keys.to(torch.int64)].to(torch.float32)


def write_rows(slots: torch.Tensor, batch, rows: torch.Tensor,
               delta: torch.Tensor) -> None:
    """``slots.at[uniq_keys].add(delta)`` of the JAX store, for the real
    keys only. Within a host's key segment the real keys are unique and
    come first (``pad_to_batch``), so each is written once, as ``rows +
    delta`` in the storage dtype, and the padding's zero deltas on bucket
    0 are never written. A global batch of N hosts (``key_segments``)
    holds a key once per host that saw it: the segments are added one
    after another in rank order, which is the position order of the JAX
    scatter-add, so a key in two hosts' batches takes ``(w + δ0) + δ1``
    with no float atomics, the same bits on every run and every rank."""
    segs = batch.key_segments or ((0, batch.num_keys),)
    for i, (off, k) in enumerate(segs):
        keys = batch.uniq_keys[off:off + k].to(torch.int64)
        d = delta[:, off:off + k]
        if slots.dtype != torch.float32:
            slots[:, keys] = slots[:, keys] + d.to(slots.dtype)
        elif i == 0:
            # no segment before it: the gathered rows are the table's
            slots[:, keys] = rows[:, off:off + k] + d
        else:
            slots[:, keys] = slots[:, keys] + d


def batch_metrics(labels, margin, row_mask):
    """(num_ex, auc, acc) of a sparse batch, as 0-d tensors."""
    return (torch.sum(row_mask), auc(labels, margin, row_mask),
            accuracy(labels, margin, row_mask))


# -- the mesh steps' shared pieces (wormhole_tpu/learners/store.py:66-260)
#
# A data×model mesh runs one position per process. The MODEL axis shards
# the bucket table into equal ranges (each position holds its own slot
# table of ``nb_local`` buckets and runs the tile kernels over its own
# tile range, at ``spec_local``); the DATA axis shards whole blocks (one
# per data index). Partial margins sum over the model axis, gradients
# and the metric row over the data axis, each through the transport stack
# over that axis's positions (``MeshRuntime.axis_stacks``: host numpy in
# rank order, the same bits on every wire); the handle applies
# shard-locally, in place.

def shard_param_table(arr: torch.Tensor, runtime, axis: int = 0
                      ) -> torch.Tensor:
    """This position's range of a full parameter table along its bucket
    ``axis`` (the JAX ``shard_param_table``, store.py:66, placed the table
    over the model axis; here a position keeps its own rows), validating
    divisibility; the table itself when the mesh has no model axis."""
    if runtime is None or not runtime.have_model:
        return arr
    m, nm = runtime.model_index, runtime.model_axis_size
    n = arr.shape[axis]
    if n % nm:
        raise ValueError(f"num_buckets {n} not divisible by model axis "
                         f"{nm}")
    k = n // nm
    return arr.narrow(axis, m * k, k).clone()


def mesh_tile_geometry(rt, spec):
    """(nb_local, spec_local, have_model) for a model-axis-sharded tile
    step: each shard runs the tile kernels over its own tile range (the
    JAX ``mesh_tile_geometry``, store.py:146)."""
    m = rt.model_axis_size
    if spec.nb % (tilemm.TILE * m):
        raise ValueError(f"nb {spec.nb} not shardable over model axis {m}")
    nb_local = spec.nb // m
    spec_local = tilemm.make_spec(nb_local, spec.subblocks, spec.cap)
    return nb_local, spec_local, rt.have_model


def shard_range_mask(ovb: torch.Tensor, off: int, nb_local: int):
    """(valid, local_idx) of overflow COO buckets owned by this model
    shard (the JAX ``shard_range_mask``, store.py:158): the 0xFFFFFFFF
    sentinel (-1 as int32) and out-of-range buckets mask out; idx is
    clamped to 0 where invalid."""
    bi = ovb.to(torch.int64)
    valid = (ovb != tilemm.OVF_SENTINEL) & (bi >= off) \
        & (bi < off + nb_local)
    return valid, torch.where(valid, bi - off, 0)


def mesh_block_view(rt, info, off: int):
    """``(local, nb_local, spec_local)`` of a mesh position whose bucket
    range starts at ``off``: ``local(block)`` gives (pw, labels, row_mask,
    ovf_b, ovf_r) of a device block for the tile kernels at
    ``spec_local`` — the position's tiles of a whole block's words, and
    the spill pairs inside its range as local bucket ids (the others
    masked to the sentinel). A store without a runtime is a mesh of one
    position."""
    if rt is not None:
        nb_local, spec_local, _ = mesh_tile_geometry(rt, info.spec)
    else:
        nb_local, spec_local = info.spec.nb, info.spec
    oc = info.ovf_cap

    def local(block):
        pw = block["pw"]
        if pw.shape[0] != spec_local.tiles:
            # a whole block: this shard's tiles
            t0 = off // tilemm.TILE
            pw = pw[t0:t0 + spec_local.tiles]
        lab = block["labels"]
        row_mask = (lab != 255).to(torch.float32)
        labels = torch.clamp(lab, max=1).to(torch.float32)
        ovb = ovr = None
        if oc:
            valid, idx = shard_range_mask(block["ovf_b"], off, nb_local)
            ovb = torch.where(valid, idx, tilemm.OVF_SENTINEL).to(
                torch.int32)
            ovr = block["ovf_r"]
        return pw, labels, row_mask, ovb, ovr

    return local, nb_local, spec_local


def _axis_sum(stack, x: torch.Tensor, site: str, clock=None):
    """The sum of ``x`` over one mesh axis, in rank order (identity on a
    line of one position); ``clock[site]`` adds the exchange's host ms."""
    if stack is None or stack.wire.world_size() == 1:
        return x
    t0 = time.perf_counter()
    out = stack.allreduce(x, None, "sum", site=site)
    if clock is not None:
        clock[site] = clock.get(site, 0.0) + (time.perf_counter() - t0) * 1e3
    return out


def mesh_metric_sums(objv, num_ex, acc, pos, neg, data=None, clock=None):
    """DATA-axis metric reduction shared by every mesh step (the JAX
    ``mesh_metric_sums``, store.py:168): (objv_g, tot_ex, acc_frac,
    pos_g, neg_g). ``acc`` is a per-shard fraction, weighted by its row
    count before the sum (an all-PAD block adds 0 rows), so acc_frac is
    the exact fraction of the grouped step. The five leaves cross as one
    f32 vector over the ``data`` stack (None: one data position)."""
    nb = pos.shape[0]
    vec = torch.cat([torch.stack([objv, num_ex, acc * num_ex]), pos, neg])
    vec = _axis_sum(data, vec.to(torch.float32), "mesh/data_metrics",
                    clock)
    tot_ex = vec[1]
    acc_frac = vec[2] / torch.clamp(tot_ex, min=1.0)
    return vec[0], tot_ex, acc_frac, vec[3:3 + nb], vec[3 + nb:]


def mesh_macc_row(objv_g, tot_ex, acc_frac, wdelta2, pos_g, neg_g):
    """The packed metric row every mesh train step accumulates:
    [objv, num_ex, acc, wdelta2, pos[bins], neg[bins]]."""
    return torch.cat([torch.stack([objv_g, tot_ex, acc_frac,
                                   wdelta2.to(torch.float32)]),
                      pos_g, neg_g])


def mesh_step_ici_bytes(rt, *, margin_elems: int, grad_elems: int = 0,
                        extra_data_elems: int = 0, train: bool = True
                        ) -> int:
    """Modeled collective bytes ONE position moves for a mesh step (the
    JAX ``mesh_step_ici_bytes``, store.py:208; ``MeshTransport`` books it
    into ``comm/bytes_ici``): margins over MODEL, the packed metric row
    over DATA, and (train) the gradient over DATA plus the wdelta2 scalar
    over MODEL, each at the ring-allreduce 2(k-1)/k·n bound; a trivial
    axis costs zero."""
    from wormhole_tpu_torch.parallel.transport import ici_ring_bytes
    m = rt.model_axis_size if rt.have_model else 1
    d = rt.data_axis_size
    n = ici_ring_bytes(4 * int(margin_elems), m)
    n += ici_ring_bytes(4 * (TableCheckpoint.MACC_LEN - 1), d)
    if train:
        n += ici_ring_bytes(4 * (int(grad_elems) + int(extra_data_elems)),
                            d)
        n += ici_ring_bytes(4, m)
    return n


@dataclass
class StoreConfig:
    num_buckets: int = 1 << 20
    loss: str = "logit"
    fixed_bytes: int = 0      # 0 = exact; 1 = 8-bit quantized sparse grads
    lr_theta: float = 1.0     # staleness weight for the DT handles
    param_dtype: str = "float32"  # slots storage dtype ("float32" or
                                  # "bfloat16"; compute always runs in f32)
    tile_step_kernel: str = "auto"   # auto|fused|split (auto = fused on
                                     # CUDA; tilemm.resolve_step_kernel)
    tile_onehot_cache: str = "auto"  # auto|on|off: a TPU staging knob;
                                     # always records off on Hopper


class MetricTicket:
    """A metric row on its way to the host: a (pinned, for CUDA) host
    buffer and the CUDA event recorded after its copy. ``resolve`` waits
    for that event, not for the whole device."""

    def __init__(self, host: torch.Tensor, event=None):
        self.host = host
        self.event = event

    def resolve(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def to_host_async(t: torch.Tensor) -> MetricTicket:
    """A ticket for ``t``'s value on the host: on CUDA a ``non_blocking``
    copy into pinned host memory and the event recorded after it (the
    host waits only when it resolves the ticket); on the CPU ``t``
    itself."""
    if t.device.type != "cuda":
        return MetricTicket(t)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return MetricTicket(host, event)


def _file_slots(slots):
    """A checkpoint's slots leaf as numpy: a bfloat16 table's file holds a
    torch tensor (widened to f32, which is exact)."""
    if isinstance(slots, torch.Tensor):
        return slots.float().numpy()
    return slots


class TableCheckpoint:
    """The checkpoint state, the step clock and the on-device metric
    accumulator of the table-backed stores
    (wormhole_tpu/learners/store.py:281-356)."""

    # the axis of ``slots`` that indexes buckets: FM and wide&deep keep
    # (num_buckets, width) rows; the linear store overrides it
    bucket_axis = 0

    def state_pytree(self) -> dict:
        """``{slots, t}`` as the JAX store holds them (``to_jax_slots``:
        numpy f32 (num_buckets, width), row-major; ``t`` an int64 scalar),
        so a checkpoint of either package resumes in the other. A bfloat16
        table is stored widened to f32, which is exact."""
        return {"slots": self.to_jax_slots(), "t": np.int64(self.t)}

    def restore_pytree(self, state) -> None:
        """Load a ``state_pytree`` (e.g. from ``Checkpointer.load``): the
        table goes to the store's own device in the port's layout
        (``from_jax_slots``); the metric window restarts empty."""
        self.from_jax_slots(_file_slots(state["slots"]))
        self.t = int(state["t"])
        self._macc = None

    def serve_params_from_state(self, state) -> dict:
        """The served params (``serve_params()``'s structure) of a
        ``state_pytree``-shaped state, e.g. a checkpoint the snapshot
        poller loaded: new tensors on this store's device, in its layout
        and dtype, by the conversion ``restore_pytree`` runs. The store
        itself is left as it is."""
        return {"slots": self._slots_from_jax(_file_slots(state["slots"]))}

    def serve_params_to_state(self, params) -> dict:
        """The inverse of ``serve_params_from_state``: served params as the
        checkpoint state holds them (host numpy f32 in the JAX layout), the
        form the serve fleet ships (``serve/fleet.py``)."""
        return {"slots": params["slots"].to(torch.float32).cpu().numpy()}

    # packed metric layout: [objv, num_ex, acc, wdelta2, pos[512], neg[512]]
    MACC_LEN = 4 + 2 * 512

    def _macc_buf(self) -> torch.Tensor:
        if getattr(self, "_macc", None) is None:
            self._macc = torch.zeros(self.MACC_LEN, dtype=torch.float32,
                                     device=self.device)
        return self._macc

    def fetch_metrics_async(self) -> MetricTicket:
        """Hand the accumulator over and start a fresh one; its value comes
        home through ``to_host_async`` — the device never drains waiting
        on a metrics round trip."""
        buf = getattr(self, "_macc", None)
        self._macc = None
        if buf is None:
            return MetricTicket(torch.zeros(self.MACC_LEN))
        return to_host_async(buf)

    def fetch_metrics(self) -> np.ndarray:
        """Blocking fetch-and-reset of the metric accumulator."""
        return self.fetch_metrics_async().resolve()

    def _tau_const(self, tau: float) -> float:
        """The staleness the handle sees: tau weighted by ``lr_theta`` (1.0
        for a model config without one, as the FM and wide&deep configs)."""
        return tau * getattr(self.cfg, "lr_theta", 1.0)

    # -- the mesh plumbing every store's mesh steps share ---------------------

    def _init_mesh(self, runtime) -> None:
        """Record the store's mesh position: ``rt`` (None: a mesh of one
        position), ``nb_local`` buckets from ``row_offset`` on, and the
        per-step exchange clock ``mesh_stats``."""
        self.rt = runtime
        self.nb_local = self.slots.shape[self.bucket_axis]
        self.row_offset = (runtime.model_index * self.nb_local
                           if runtime is not None and runtime.have_model
                           else 0)
        self.mesh_stats = {"steps": 0, "ici_bytes": 0}

    def _mesh_transport(self):
        """The mesh leg around each step: the ``collective:mesh`` span,
        site/seq, watchdog, chaos and the modeled ``comm/bytes_ici``."""
        mt = getattr(self, "_mt", None)
        if mt is None:
            from wormhole_tpu_torch.parallel.transport import MeshTransport
            mt = self._mt = MeshTransport(site="mesh/step")
        return mt

    def _mesh_axes(self):
        """(data stack, model stack, have_model) of the store's runtime; a
        store without one is a mesh of one position."""
        rt = self.rt
        if rt is None:
            return None, None, False
        data, model = rt.axis_stacks()
        return data, model, rt.have_model

    def _mesh_dispatch(self, fn, *args, ici_bytes: int):
        self.mesh_stats["steps"] += 1
        self.mesh_stats["ici_bytes"] += int(ici_bytes)
        return self._mesh_transport().dispatch(fn, *args,
                                               ici_bytes=ici_bytes)

    def _mesh_tail(self, margin, labels, row_mask, data, clock):
        """The metric tail of a mesh step over the global margins: this
        position's sums, then their data-axis sums."""
        objv = self.objv_fn(margin, labels, row_mask)
        num_ex = torch.sum(row_mask)
        acc = accuracy(labels, margin, row_mask)
        pos, neg = margin_hist(labels, margin, row_mask)
        return mesh_metric_sums(objv, num_ex, acc, pos, neg, data, clock)



def _model_file_exists(path: str) -> bool:
    if not is_remote(path):
        return os.path.exists(path)
    try:
        get_filesystem(path).size(path)
    except OSError:
        return False
    return True


def _model_shards(path: str) -> list:
    """The ``{path}_{rank}`` files of a save_model dump: a glob for a local
    path, the directory listing filtered by name through the stream layer
    for a remote one."""
    if not is_remote(path):
        return sorted(_glob.glob(path + "_*"))
    head, _, base = path.rpartition("/")
    rx = re.compile(re.escape(base) + r"_\d+$")
    return sorted(fi.path for fi in list_files(head)
                  if rx.match(fi.path.rpartition("/")[2]))


class ShardedStore(TableCheckpoint):
    """Model state + the crec2 tile steps on one device."""

    bucket_axis = 1     # plane-major (val_len, num_buckets) slots

    def __init__(self, cfg: StoreConfig, handle: Handle,
                 device: DeviceLike = None, runtime=None):
        self.cfg = cfg
        self.handle = handle
        self.device = resolve_device(device)
        self.objv_fn, self.dual_fn = create_loss(cfg.loss)
        if cfg.param_dtype not in _DTYPES:
            raise ValueError(f"param_dtype {cfg.param_dtype!r}: want "
                             "float32 or bfloat16")
        self.dtype = _DTYPES[cfg.param_dtype]
        # on a mesh with a model axis this position holds one range of
        # the buckets (``shard_param_table``)
        self.slots = shard_param_table(
            handle.init(cfg.num_buckets, self.device), runtime,
            axis=1).to(self.dtype)
        self._init_mesh(runtime)
        self.t = 1  # global update counter (the SGD eta schedule's t)
        self._macc = None
        self._tile_cache: dict = {}
        self._tile_kernel: dict = {}
        self._dense_cache: dict = {}
        self.step_kernel = None

    def with_num_buckets(self, nb: int) -> "ShardedStore":
        """A fresh store of the same config, handle and device at ``nb``
        buckets: the bigmodel hot tier's twin (``bigmodel/paged.py``) and
        the full-size oracle of its parity checks."""
        return ShardedStore(dataclasses.replace(self.cfg, num_buckets=nb),
                            self.handle, self.device)

    def _weights(self, slots: torch.Tensor) -> torch.Tensor:
        return self.handle.weights(slots).to(torch.float32)

    # -- the sparse SparseBatch steps -------------------------------------

    def _sparse_grad(self, rows: torch.Tensor, batch):
        """(margin, objv, grad) of a batch against its gathered rows."""
        margin = spmv_times(batch.cols, batch.vals, self.handle.weights(rows))
        objv = self.objv_fn(margin, batch.labels, batch.row_mask)
        dual = self.dual_fn(margin, batch.labels, batch.row_mask)
        grad = spmv_trans_times(batch.cols, batch.vals, dual, rows.shape[1])
        return margin, objv, grad

    def train_step(self, batch, tau: float = 0.0):
        """One sparse step (the JAX ``_build_step``, store.py:400): pull,
        forward, backward, the optional 8-bit quantization, the handle's
        update at the step clock ``t`` and staleness ``tau``, and the push
        of the real keys' rows. Returns (objv, num_ex, auc, acc, wdelta2)
        as 0-d tensors."""
        rows = gather_rows(self.slots, batch.uniq_keys)
        margin, objv, grad = self._sparse_grad(rows, batch)
        if self.cfg.fixed_bytes:
            grad = quantize_dequantize(grad, 8 * self.cfg.fixed_bytes)
        new_rows = self.handle.apply(rows, grad, float(self.t),
                                     self._tau_const(tau))
        delta = (new_rows - rows) * batch.key_mask
        write_rows(self.slots, batch, rows, delta)
        self.t += 1
        num_ex, a, acc = batch_metrics(batch.labels, margin, batch.row_mask)
        return objv, num_ex, a, acc, torch.sum(delta[0] * delta[0])

    def eval_step(self, batch):
        """(objv, num_ex, auc, acc, margin) of a batch, through the serve
        margin function (the JAX ``_build_eval``, store.py:464)."""
        margin = self.build_serve_margin()(self.serve_params(), batch)
        objv = self.objv_fn(margin, batch.labels, batch.row_mask)
        return (objv,) + batch_metrics(batch.labels, margin,
                                       batch.row_mask) + (margin,)

    def dt2_pull(self, batch):
        """The pull half of the delay-compensated step (the JAX
        ``dt2_pull``, store.py:1059): the gradient against the current
        weights and each key's cumulative-gradient slot at pull time.
        Returns (grad, snapshot, (objv, num_ex, auc, acc))."""
        rows = gather_rows(self.slots, batch.uniq_keys)
        margin, objv, grad = self._sparse_grad(rows, batch)
        return grad, rows[1], (objv,) + batch_metrics(
            batch.labels, margin, batch.row_mask)

    def dt2_push(self, batch, grad: torch.Tensor,
                 snap: torch.Tensor) -> None:
        """The push half: apply the delayed gradient with its pull-time
        snapshot (DT2's rule reads neither the clock nor tau); advances
        the step clock as the JAX ``dt2_push`` does."""
        rows = gather_rows(self.slots, batch.uniq_keys)
        new_rows = self.handle.apply(rows, grad, 0.0, 0.0, gsum_snap=snap)
        write_rows(self.slots, batch, rows,
                   (new_rows - rows) * batch.key_mask)
        self.t += 1

    def ps_push(self, grad, tau: float = 0.0) -> None:
        """Apply one reduced dense delta window of the ps engine (the JAX
        ``ps_push``, store.py:1083): ``grad`` is a (num_buckets,) gradient,
        a tensor on the store's device or a host array, applied to the
        whole table by ``masked_push`` at the step clock ``t`` and the
        engine-measured window delay ``tau``; advances ``t``. The same
        masking contract as the dense-apply step: exact handles sweep
        unmasked, the others keep the old slots where the window's gradient
        is exactly zero."""
        grad = torch.as_tensor(grad, dtype=torch.float32,
                               device=self.device)
        s32 = (self.slots if self.slots.dtype == torch.float32
               else self.slots.to(torch.float32))
        masked_push(self.handle, s32, grad, float(self.t),
                    self._tau_const(tau),
                    zero_grad_push_is_identity(self.handle))
        if s32 is not self.slots:
            self.slots.copy_(s32)
        self.t += 1

    def pull(self, keys: np.ndarray) -> np.ndarray:
        """Debug/oracle surface: weights for explicit bucket ids."""
        keys = torch.as_tensor(np.asarray(keys, np.int64),
                               device=self.device)
        return self._weights(self.slots)[keys].cpu().numpy()

    # -- pull-only serving surface ------------------------------------------

    def serve_params(self):
        """Live model params for the pull-only forward (serve/forward.py)."""
        return {"slots": self.slots}

    def build_serve_margin(self):
        """margin_fn(params, batch) -> (mb,) margins: the pull of the
        batch's weights and the spmv, nothing else (the JAX store's,
        store.py:451; ``eval_step`` runs the same function)."""
        handle = self.handle

        def margin_fn(params, batch):
            w = handle.weights(params["slots"])[
                batch.uniq_keys.to(torch.int64)].to(torch.float32)
            return spmv_times(batch.cols, batch.vals, w)

        return margin_fn

    # -- dense-apply: the crec v1 and dense-text step ------------------------

    def _dense_step(self, block_rows: int, nnz: int, kind: str):
        """The dense-apply step for ``block_rows``-row blocks of ``nnz``
        keys (the JAX ``_dense_step``, store.py:490): "train" gives
        ``step(s32, packed, t, tau) -> (objv, num_ex, auc, acc, wdelta2)``,
        updating the f32 slots ``s32`` in place; "eval" gives
        ``step(slots, packed) -> (objv, num_ex, auc, acc, margin)``."""
        key = (block_rows, nnz, kind)
        fn = self._dense_cache.get(key)
        if fn is not None:
            return fn
        exact_dense = zero_grad_push_is_identity(self.handle)
        handle, objv_fn, dual_fn = self.handle, self.objv_fn, self.dual_fn
        nb = self.cfg.num_buckets
        R, N = block_rows, nnz
        nk = R * N * 4

        def fold_and_forward(slots, packed):
            # the keys' bytes as int32 (0xFFFFFFFF, the sentinel, reads -1)
            keys = packed[:nk].view(torch.int32)
            valid = keys != -1
            b = torch.where(valid, fold_keys32_t(keys, nb), 0)
            lab_u8 = packed[nk:nk + R]
            row_mask = (lab_u8 != 255).to(torch.float32)
            labels = torch.clamp(lab_u8, max=1).to(torch.float32)
            vf = valid.to(torch.float32).reshape(R, N)
            margin = torch.sum(self._weights(slots)[b.reshape(R, N)] * vf, 1)
            return b, valid, vf, labels, row_mask, margin

        if kind == "train":
            def step(s32, packed, t, tau):
                b, valid, vf, labels, row_mask, margin = fold_and_forward(
                    s32, packed)
                objv = objv_fn(margin, labels, row_mask)
                dual = dual_fn(margin, labels, row_mask)
                if not exact_dense:
                    dual = nudge_zero_dual(dual, labels, row_mask)
                # a sentinel slot sums into no bucket (id nb, past the last
                # segment); its ±0 would change no sum in the JAX scatter
                contrib = (dual[:, None] * vf).reshape(-1)
                grad = segment_sum(segment_index(
                    torch.where(valid, b, nb), nb), contrib)
                wd2 = masked_push(handle, s32, grad, t, tau, exact_dense)
                num_ex, a, acc = batch_metrics(labels, margin, row_mask)
                return objv, num_ex, a, acc, wd2
        else:
            def step(slots, packed):
                _, _, _, labels, row_mask, margin = fold_and_forward(slots,
                                                                     packed)
                objv = objv_fn(margin, labels, row_mask)
                return (objv,) + batch_metrics(labels, margin,
                                               row_mask) + (margin,)

        self._dense_cache[key] = step
        return step

    def dense_train_step(self, packed: torch.Tensor, block_rows: int,
                         nnz: int, tau: float = 0.0):
        """One dense-apply step over a device-resident packed block (uint8);
        returns (objv, num_ex, auc, acc, wdelta2) as 0-d tensors."""
        step = self._dense_step(block_rows, nnz, "train")
        s32 = (self.slots if self.slots.dtype == torch.float32
               else self.slots.to(torch.float32))
        metrics = step(s32, packed, float(self.t), self._tau_const(tau))
        if s32 is not self.slots:
            self.slots.copy_(s32)
        self.t += 1
        return metrics

    def dense_eval_step(self, packed: torch.Tensor, block_rows: int,
                        nnz: int):
        """(objv, num_ex, auc, acc, margin) of a packed block."""
        return self._dense_step(block_rows, nnz, "eval")(self.slots, packed)

    # -- the crec2 tile step ------------------------------------------------

    def _tile_step(self, info, kind: str):
        """The crec2 step for blocks of geometry ``info``. ``kind`` "eval"
        gives ``step(slots, block) -> (objv, num_ex, acc, pos, neg,
        margin)``; "train" gives ``step(s32, block, t, tau) -> packed
        metric row``, which updates the f32 slots ``s32`` in place. Sets
        ``step_kernel`` to ``(resolved, why, cache_record)`` as the JAX
        store does (wormhole_tpu/learners/store.py:699-858)."""
        key = (info, kind)
        fn = self._tile_cache.get(key)
        if fn is not None:
            self.step_kernel = self._tile_kernel[key]
            return fn
        exact_dense = zero_grad_push_is_identity(self.handle)
        handle, objv_fn = self.handle, self.objv_fn
        dev = self.device
        spec = info.spec
        oc = info.ovf_cap
        loss = loss_key(self.cfg.loss)
        res = tilemm.resolve_step_kernel(
            self.cfg.tile_step_kernel, ovf_cap=oc, spec=spec,
            onehot_cache=self.cfg.tile_onehot_cache, device=self.device)
        fused = res.kernel == "fused" and kind == "train"
        # the in-place update needs FTRL and no spill (the COO scatter
        # needs the gradient in device memory); the port runs one process
        fused_update = fused and oc == 0 and isinstance(handle, FTRLHandle)

        def decode(block):
            lab_u8 = block["labels"]
            row_mask = (lab_u8 != 255).to(torch.float32)
            labels = torch.clamp(lab_u8, max=1).to(torch.float32)
            ovf_b = block["ovf_b"] if oc else None
            ovf_r = block["ovf_r"] if oc else None
            return block["pw"], labels, row_mask, ovf_b, ovf_r

        def finish(margin, labels, row_mask, wdelta2):
            # the shared metric tail: the same ops downstream of the
            # margins in every variant; its stage ends after the
            # accumulator add (tile_train_step)
            trace.stage("step:tail", dev)
            objv = objv_fn(margin, labels, row_mask)
            num_ex = torch.sum(row_mask)
            acc = accuracy(labels, margin, row_mask)
            pos, neg = margin_hist(labels, margin, row_mask)
            return torch.cat([torch.stack([objv, num_ex, acc, wdelta2]),
                              pos, neg])

        if kind != "train":
            def step(slots, block):
                pw, labels, row_mask, ovf_b, ovf_r = decode(block)
                w = self._weights(slots)
                margin = tilemm.forward_margins(pw, w, spec, ovf_b, ovf_r)
                objv = objv_fn(margin, labels, row_mask)
                num_ex = torch.sum(row_mask)
                acc = accuracy(labels, margin, row_mask)
                pos, neg = margin_hist(labels, margin, row_mask)
                return objv, num_ex, acc, pos, neg, margin
        elif fused_update:
            def step(s32, block, t, tau):
                trace.stage("step:kernel", dev)
                pw, labels, row_mask, _, _ = decode(block)
                margin, wd2 = tilemm.fused_step_update(
                    pw, s32, labels, row_mask, spec, loss, handle)
                return finish(margin, labels, row_mask, wd2)
        elif fused:
            def step(s32, block, t, tau):
                w = handle.weights(s32)
                sp = None
                if oc:
                    trace.stage("step:spill", dev)
                    sp = tilemm.spill_margin_rows(w, block["ovf_b"],
                                                  block["ovf_r"], spec)
                trace.stage("step:kernel", dev)
                pw, labels, row_mask, ovf_b, ovf_r = decode(block)
                margin, grad = tilemm.fused_step_grad(
                    pw, w, labels, row_mask, spec, loss, exact_dense,
                    spill_margins=sp)
                if oc:
                    # the spill pairs' duals, recomputed from the emitted
                    # margins by the same device math: the kernel's bits
                    trace.stage("step:spill", dev)
                    dual = tilemm.loss_dual(margin, labels, row_mask, loss,
                                            exact_dense)
                    grad = tilemm.spill_grad_scatter(grad, dual, ovf_b,
                                                     ovf_r, spec)
                    trace.stage("step:kernel", dev)
                wd2 = masked_push(handle, s32, grad, t, tau, exact_dense)
                return finish(margin, labels, row_mask, wd2)
        else:
            def step(s32, block, t, tau):
                trace.stage("step:kernel", dev)
                pw, labels, row_mask, ovf_b, ovf_r = decode(block)
                w = handle.weights(s32)
                margin = tilemm.forward_margins(pw, w, spec, ovf_b, ovf_r)
                dual = tilemm.loss_dual(margin, labels, row_mask, loss,
                                        exact_dense)
                grad = tilemm.backward_grad(pw, dual, spec, ovf_b, ovf_r)
                wd2 = masked_push(handle, s32, grad, t, tau, exact_dense)
                return finish(margin, labels, row_mask, wd2)

        if kind != "train":
            record = ("split", "eval is forward-only",
                      "onehot_cache=off:eval is forward-only")
        else:
            resolved = ("fused_update" if fused_update
                        else "fused" if fused else "split")
            record = (resolved, res.why, res.cache_record)
        self._tile_kernel[key] = self.step_kernel = record
        self._tile_cache[key] = step
        return step

    def tile_train_step(self, block: dict, info, tau: float = 0.0):
        """One crec2 train step over a device block dict, in place on the
        table. The step's metric row adds into the on-device accumulator
        (``fetch_metrics``). Returns a completion ticket: a CUDA event
        recorded after the step (None on the CPU, where the step has
        finished on return), so the learner can bound the steps in flight
        without draining the device. Its stages are ``trace.stage``
        spans (``step:kernel``, ``step:spill``, ``step:tail``)."""
        step = self._tile_step(info, "train")
        s32 = (self.slots if self.slots.dtype == torch.float32
               else self.slots.to(torch.float32))
        with (trace.span("tilemm:fused_step", cat="tile")
              if self.step_kernel[0].startswith("fused") else nullcontext()):
            row = step(s32, block, float(self.t), self._tau_const(tau))
            self._macc_buf().add_(row)
            trace.stage(None, self.device)
        if s32 is not self.slots:
            self.slots.copy_(s32)
        self.t += 1
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def tile_eval_step(self, block: dict, info):
        return self._tile_step(info, "eval")(self.slots, block)

    # -- the steps over a data x model mesh ---------------------------------

    def _tile_step_mesh(self, info, kind: str):
        """The crec2 step of one mesh position (the JAX
        ``_tile_step_mesh``, store.py:869): its block's words of its tile
        range through ``forward_margins`` at ``spec_local``, plus the
        spill pairs inside its bucket range; the margins summed over the
        model axis; the metric row over the data axis; the dual, the
        gradient of its range (``backward_grad`` at ``spec_local``) summed
        over the data axis, and the handle's update of its slots, in
        place. "eval" gives ``step(slots, block) -> (objv, num_ex, acc,
        pos, neg, margin)`` (this position's rows), "train" gives
        ``step(s32, block, t, tau) -> metric row``."""
        key = (info, kind, "mesh")
        fn = self._tile_cache.get(key)
        if fn is not None:
            return fn
        exact_dense = zero_grad_push_is_identity(self.handle)
        handle = self.handle
        loss = loss_key(self.cfg.loss)
        local, _, spec_local = mesh_block_view(self.rt, info,
                                               self.row_offset)
        data, model, have_model = self._mesh_axes()
        clock = self.mesh_stats

        def forward(w, pw, ovb, ovr):
            mg = tilemm.forward_margins(pw, w, spec_local, ovb, ovr)
            return (_axis_sum(model, mg, "mesh/model_margins", clock)
                    if have_model else mg)

        if kind != "train":
            def step(slots, block):
                pw, labels, row_mask, ovb, ovr = local(block)
                margin = forward(self._weights(slots), pw, ovb, ovr)
                return self._mesh_tail(margin, labels, row_mask, data,
                                       clock) + (margin,)
        else:
            def step(s32, block, t, tau):
                pw, labels, row_mask, ovb, ovr = local(block)
                margin = forward(handle.weights(s32), pw, ovb, ovr)
                objv_g, tot_ex, acc_frac, pos_g, neg_g = self._mesh_tail(
                    margin, labels, row_mask, data, clock)
                dual = tilemm.loss_dual(margin, labels, row_mask, loss,
                                        exact_dense)
                g = tilemm.backward_grad(pw, dual, spec_local, ovb, ovr)
                g = _axis_sum(data, g, "mesh/data_grad", clock)
                wd2 = masked_push(handle, s32, g, t, tau, exact_dense)
                if have_model:
                    wd2 = _axis_sum(model, wd2.to(torch.float32).reshape(1),
                                    "mesh/model_wdelta2", clock)[0]
                return mesh_macc_row(objv_g, tot_ex, acc_frac, wd2, pos_g,
                                     neg_g)

        self._tile_cache[key] = step
        return step

    def _mesh_train(self, step, block, tau, ici):
        s32 = (self.slots if self.slots.dtype == torch.float32
               else self.slots.to(torch.float32))
        row = self._mesh_dispatch(step, s32, block, float(self.t),
                                  self._tau_const(tau), ici_bytes=ici)
        if s32 is not self.slots:
            self.slots.copy_(s32)
        self._macc_buf().add_(row)
        self.t += 1
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def tile_train_step_mesh(self, block: dict, info, tau: float = 0.0):
        """One mesh train step of this position (the JAX
        ``tile_train_step_mesh``, store.py:956): ``block`` is the block of
        its data index, a device dict {pw, labels, ovf_b, ovf_r} whose
        ``pw`` holds the whole block's tiles or only this shard's. The
        metric row (data-axis sums included) adds into the on-device
        accumulator. Returns a completion ticket as ``tile_train_step``."""
        step = self._tile_step_mesh(info, "train")
        ici = mesh_step_ici_bytes(self.rt, margin_elems=info.block_rows,
                                  grad_elems=self.nb_local) \
            if self.rt is not None else 0
        return self._mesh_train(step, block, tau, ici)

    def tile_eval_step_mesh(self, block: dict, info):
        """(objv, num_ex, acc, pos, neg, margin) of this position's block,
        the metrics summed over the data axis, the margins this block's."""
        ici = mesh_step_ici_bytes(self.rt, margin_elems=info.block_rows,
                                  train=False) if self.rt is not None else 0
        return self._mesh_dispatch(self._tile_step_mesh(info, "eval"),
                                   self.slots, block, ici_bytes=ici)

    def _dense_step_mesh(self, block_rows: int, nnz: int, kind: str):
        """The dense-apply step of one mesh position (the JAX
        ``_dense_step_mesh``, store.py:580): its crec v1 block's keys
        folded on the device and kept where the bucket falls in its range,
        the gathered margins summed over the model axis, the gradient of
        its range (``segment_sum`` in flat order) over the data axis, the
        handle's update of its slots in place."""
        key = (block_rows, nnz, kind, "mesh")
        fn = self._dense_cache.get(key)
        if fn is not None:
            return fn
        exact_dense = zero_grad_push_is_identity(self.handle)
        handle, dual_fn = self.handle, self.dual_fn
        nb = self.cfg.num_buckets
        nb_local, off = self.nb_local, self.row_offset
        data, model, have_model = self._mesh_axes()
        clock = self.mesh_stats
        R, N = block_rows, nnz
        nk = R * N * 4

        def fold(w, packed):
            keys = packed[:nk].view(torch.int32)
            valid = keys != -1
            b = torch.where(valid, fold_keys32_t(keys, nb), 0).to(
                torch.int64)
            inr = valid & (b >= off) & (b < off + nb_local)
            bl = torch.where(inr, b - off, 0)
            lab_u8 = packed[nk:nk + R]
            row_mask = (lab_u8 != 255).to(torch.float32)
            labels = torch.clamp(lab_u8, max=1).to(torch.float32)
            vf = inr.to(torch.float32).reshape(R, N)
            mg = torch.sum(w[bl.reshape(R, N)] * vf, 1)
            margin = (_axis_sum(model, mg, "mesh/model_margins", clock)
                      if have_model else mg)
            return inr, bl, vf, labels, row_mask, margin

        if kind != "train":
            def step(slots, packed):
                _, _, _, labels, row_mask, margin = fold(
                    self._weights(slots), packed)
                return self._mesh_tail(margin, labels, row_mask, data,
                                       clock) + (margin,)
        else:
            def step(s32, packed, t, tau):
                inr, bl, vf, labels, row_mask, margin = fold(
                    handle.weights(s32), packed)
                objv_g, tot_ex, acc_frac, pos_g, neg_g = self._mesh_tail(
                    margin, labels, row_mask, data, clock)
                dual = dual_fn(margin, labels, row_mask)
                if not exact_dense:
                    dual = nudge_zero_dual(dual, labels, row_mask)
                contrib = (dual[:, None] * vf).reshape(-1)
                grad = segment_sum(segment_index(
                    torch.where(inr, bl, nb_local), nb_local), contrib)
                grad = _axis_sum(data, grad, "mesh/data_grad", clock)
                wd2 = masked_push(handle, s32, grad, t, tau, exact_dense)
                if have_model:
                    wd2 = _axis_sum(model, wd2.to(torch.float32).reshape(1),
                                    "mesh/model_wdelta2", clock)[0]
                return mesh_macc_row(objv_g, tot_ex, acc_frac, wd2, pos_g,
                                     neg_g)

        self._dense_cache[key] = step
        return step

    def dense_train_step_mesh(self, packed: torch.Tensor, block_rows: int,
                              nnz: int, tau: float = 0.0):
        """One mesh dense-apply step of this position over its packed v1
        block; the metric row accumulates on the device."""
        step = self._dense_step_mesh(block_rows, nnz, "train")
        ici = mesh_step_ici_bytes(self.rt, margin_elems=block_rows,
                                  grad_elems=self.nb_local) \
            if self.rt is not None else 0
        return self._mesh_train(step, packed, tau, ici)

    def dense_eval_step_mesh(self, packed: torch.Tensor, block_rows: int,
                             nnz: int):
        ici = mesh_step_ici_bytes(self.rt, margin_elems=block_rows,
                                  train=False) if self.rt is not None else 0
        return self._mesh_dispatch(
            self._dense_step_mesh(block_rows, nnz, "eval"), self.slots,
            packed, ici_bytes=ici)

    def nnz_weight(self) -> int:
        return int(torch.count_nonzero(self._weights(self.slots)))

    # -- weights in and out -------------------------------------------------

    def from_jax_slots(self, slots: np.ndarray) -> None:
        """Load a JAX store's ``(num_buckets, val_len)`` slots (as numpy,
        e.g. ``np.asarray(jax_store.slots)``) into this store: transposed
        to the port's plane-major layout, cast to ``param_dtype``, placed
        on the store's device."""
        self.slots = self._slots_from_jax(slots)

    def _slots_from_jax(self, slots: np.ndarray) -> torch.Tensor:
        """``from_jax_slots``' table, returned: the row-major f32 rows go
        to the device as they are (``host_to_device``), and the transpose
        and the cast run there."""
        slots = np.asarray(slots)
        want = (self.nb_local, self.handle.val_len)
        if slots.shape != want:
            raise ValueError(f"JAX slots of shape {slots.shape}; this store "
                             f"holds {want} (num_buckets, val_len)")
        rows = host_to_device(np.asarray(slots, np.float32), self.device)
        return rows.t().contiguous().to(self.dtype)

    def to_jax_slots(self) -> np.ndarray:
        """This store's slots as a JAX store holds them: numpy f32
        ``(num_buckets, val_len)`` — the inverse of ``from_jax_slots``."""
        return self.serve_params_to_state({"slots": self.slots})["slots"]

    def serve_params_to_state(self, params) -> dict:
        return {"slots": np.ascontiguousarray(
            params["slots"].to(torch.float32).cpu().numpy().T)}

    def save_model(self, path: str, rank: Optional[int] = None,
                   key_fold: str = "") -> None:
        """Write nonzero (bucket, weight) pairs as text to
        ``{path}_{rank}`` — the JAX store's format, so either package
        loads what the other saved; ``rank`` defaults to this process's
        (one file per host, as the reference's per-server shards).
        ``key_fold`` names the key→bucket scheme ("mix32" for crec2) as a
        ``# key_fold=`` header line."""
        if rank is None:
            from wormhole_tpu_torch.parallel.mesh import process_world
            rank = process_world()[0]
        w = self._weights(self.slots).cpu().numpy()
        idx = np.nonzero(w)[0]
        # a model shard writes its range with global bucket ids
        idx_out = idx + self.row_offset
        with open_stream(f"{path}_{rank}", "w") as f:
            if key_fold:
                f.write(f"# key_fold={key_fold}\n")
            f.write("".join(f"{i}\t{v:.6g}\n"
                            for i, v in zip(idx_out.tolist(),
                                            w[idx].tolist())))

    def load_model(self, path: str, expect_key_fold: str = "") -> None:
        """Read back a save_model dump (either package's). ``path`` may be
        the bare ``model_out`` prefix: all ``{path}_{rank}`` shard files
        are merged. ``expect_key_fold`` must match a recorded
        ``# key_fold=`` header when both name one. The weights warm-start
        the handle (FTRL seeds z, not just w)."""
        paths = [path] if _model_file_exists(path) else \
            _model_shards(path)
        if not paths:
            raise FileNotFoundError(path)
        body = []
        for pth in paths:
            with open_stream(pth, "r") as f:
                for ln in f.read().splitlines():
                    ln = ln.strip()
                    if not ln:
                        continue
                    if ln.startswith("#"):
                        self._check_key_fold(path, ln, expect_key_fold)
                        continue
                    body.append(ln)
        kv = np.fromstring(" ".join(body), dtype=np.float64, sep=" ") \
            if body else np.zeros(0)
        if kv.size != 2 * len(body):
            raise ValueError(f"model {path}: every line must be "
                             "'<bucket>\\t<weight>'")
        keys = kv[0::2].astype(np.int64)
        if keys.size and (keys.min() < 0 or keys.max() >= self.cfg.num_buckets):
            raise ValueError(f"model {path}: bucket ids outside "
                             f"[0, {self.cfg.num_buckets})")
        w = np.zeros(self.cfg.num_buckets, np.float32)
        w[keys] = kv[1::2]
        w = w[self.row_offset:self.row_offset + self.nb_local]
        self.slots = self.handle.warm_start(
            torch.from_numpy(w).to(self.device)).to(self.dtype)

    @staticmethod
    def _check_key_fold(path: str, line: str, expect: str) -> None:
        if "key_fold=" not in line or not expect:
            return
        saved = line.split("key_fold=")[1].split()[0]
        if saved != expect:
            raise ValueError(
                f"model {path} was trained with key_fold={saved} but this "
                f"run folds keys with {expect} (crec formats hash "
                "differently from the text formats); retrain or convert "
                "the data, a warm start would remap every feature")
