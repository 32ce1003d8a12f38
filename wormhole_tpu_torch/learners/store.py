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

``TableCheckpoint`` (the step clock's staleness weight and that metric
accumulator) is shared with the model stores of ``wormhole_tpu_torch.models``:
``FMStore`` and ``WideDeepStore`` run the multi-channel tile steps
(``tilemm.forward_pulls``/``backward_pushes`` and the fused
``fused_fm_step``/``fused_wd_step``) and plug into the same ``AsyncSGD``.
"""

from __future__ import annotations

import glob as _glob
import os
from dataclasses import dataclass

import numpy as np
import torch

from wormhole_tpu_torch.data.stream import open_stream
from wormhole_tpu_torch.device import DeviceLike, resolve_device
from wormhole_tpu_torch.learners.handles import FTRLHandle, Handle
from wormhole_tpu_torch.ops import tilemm
from wormhole_tpu_torch.ops.loss import create_loss, loss_key, \
    nudge_zero_dual
from wormhole_tpu_torch.ops.metrics import accuracy, auc, margin_hist
from wormhole_tpu_torch.ops.spmv import spmv_times, spmv_trans_times

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


def quantize_dequantize(g: torch.Tensor, bits: int) -> torch.Tensor:
    """The fixed-point round trip of the sparse gradient (the FIXING_FLOAT
    value transform, wormhole_tpu/parallel/filters.py:105): symmetric
    b-bit levels around 0 with scale max|g| + 1e-30, in the JAX order
    ``round(g / scale * levels) * (scale / levels)``; ``torch.round``
    rounds half to even as ``jnp.round`` does."""
    scale = torch.max(torch.abs(g)) + 1e-30
    levels = float(2 ** (bits - 1) - 1)
    q = torch.round(g / scale * levels)
    return q * (scale / torch.full((), levels, dtype=torch.float32,
                                   device=g.device))


def gather_rows(slots: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """The f32 rows of the plane-major table at bucket ids ``keys``:
    (val_len, len(keys)). ``keys`` may hold int32 ids."""
    return slots[:, keys.to(torch.int64)].to(torch.float32)


def write_rows(slots: torch.Tensor, batch, rows: torch.Tensor,
               delta: torch.Tensor) -> None:
    """``slots.at[uniq_keys].add(delta)`` of the JAX store, for the real
    keys only: they are unique and come first (``pad_to_batch``), so each
    row is written once, as ``rows + delta`` in the storage dtype, and the
    padding's zero deltas on bucket 0 are never written."""
    k = batch.num_keys
    keys = batch.uniq_keys[:k].to(torch.int64)
    if slots.dtype == torch.float32:
        slots[:, keys] = rows[:, :k] + delta[:, :k]
    else:
        slots[:, keys] = slots[:, keys] + delta[:, :k].to(slots.dtype)


def batch_metrics(labels, margin, row_mask):
    """(num_ex, auc, acc) of a sparse batch, as 0-d tensors."""
    return (torch.sum(row_mask), auc(labels, margin, row_mask),
            accuracy(labels, margin, row_mask))


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


class TableCheckpoint:
    """The step clock and the on-device metric accumulator of the
    table-backed stores (wormhole_tpu/learners/store.py:281-356). The
    checkpoint half (``state_pytree``/``restore_pytree``) comes with
    checkpoint resume (ROADMAP.md)."""

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


class ShardedStore(TableCheckpoint):
    """Model state + the crec2 tile steps on one device."""

    def __init__(self, cfg: StoreConfig, handle: Handle,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.handle = handle
        self.device = resolve_device(device)
        self.objv_fn, self.dual_fn = create_loss(cfg.loss)
        if cfg.param_dtype not in _DTYPES:
            raise ValueError(f"param_dtype {cfg.param_dtype!r}: want "
                             "float32 or bfloat16")
        self.dtype = _DTYPES[cfg.param_dtype]
        self.slots = handle.init(cfg.num_buckets, self.device).to(self.dtype)
        self.t = 1  # global update counter (the SGD eta schedule's t)
        self._macc = None
        self._tile_cache: dict = {}
        self._tile_kernel: dict = {}
        self.step_kernel = None

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
            # margins in every variant
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
                pw, labels, row_mask, _, _ = decode(block)
                margin, wd2 = tilemm.fused_step_update(
                    pw, s32, labels, row_mask, spec, loss, handle)
                return finish(margin, labels, row_mask, wd2)
        elif fused:
            def step(s32, block, t, tau):
                pw, labels, row_mask, ovf_b, ovf_r = decode(block)
                w = handle.weights(s32)
                sp = (tilemm.spill_margin_rows(w, ovf_b, ovf_r, spec)
                      if oc else None)
                margin, grad = tilemm.fused_step_grad(
                    pw, w, labels, row_mask, spec, loss, exact_dense,
                    spill_margins=sp)
                if oc:
                    # the spill pairs' duals, recomputed from the emitted
                    # margins by the same device math: the kernel's bits
                    dual = tilemm.loss_dual(margin, labels, row_mask, loss,
                                            exact_dense)
                    grad = tilemm.spill_grad_scatter(grad, dual, ovf_b,
                                                     ovf_r, spec)
                wd2 = masked_push(handle, s32, grad, t, tau, exact_dense)
                return finish(margin, labels, row_mask, wd2)
        else:
            def step(s32, block, t, tau):
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
        without draining the device."""
        step = self._tile_step(info, "train")
        s32 = (self.slots if self.slots.dtype == torch.float32
               else self.slots.to(torch.float32))
        row = step(s32, block, float(self.t), self._tau_const(tau))
        if s32 is not self.slots:
            self.slots.copy_(s32)
        self._macc_buf().add_(row)
        self.t += 1
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def tile_eval_step(self, block: dict, info):
        return self._tile_step(info, "eval")(self.slots, block)

    def nnz_weight(self) -> int:
        return int(torch.count_nonzero(self._weights(self.slots)))

    # -- weights in and out -------------------------------------------------

    def from_jax_slots(self, slots: np.ndarray) -> None:
        """Load a JAX store's ``(num_buckets, val_len)`` slots (as numpy,
        e.g. ``np.asarray(jax_store.slots)``) into this store: transposed
        to the port's plane-major layout, cast to ``param_dtype``, placed
        on the store's device."""
        slots = np.asarray(slots)
        want = (self.cfg.num_buckets, self.handle.val_len)
        if slots.shape != want:
            raise ValueError(f"JAX slots of shape {slots.shape}; this store "
                             f"holds {want} (num_buckets, val_len)")
        self.slots = torch.from_numpy(
            np.ascontiguousarray(slots.T, np.float32)).to(
                device=self.device, dtype=self.dtype)

    def to_jax_slots(self) -> np.ndarray:
        """This store's slots as a JAX store holds them: numpy f32
        ``(num_buckets, val_len)`` — the inverse of ``from_jax_slots``."""
        return np.ascontiguousarray(
            self.slots.to(torch.float32).cpu().numpy().T)

    def save_model(self, path: str, rank: int = 0,
                   key_fold: str = "") -> None:
        """Write nonzero (bucket, weight) pairs as text to
        ``{path}_{rank}`` — the JAX store's format, so either package
        loads what the other saved. ``key_fold`` names the key→bucket
        scheme ("mix32" for crec2) as a ``# key_fold=`` header line."""
        w = self._weights(self.slots).cpu().numpy()
        idx = np.nonzero(w)[0]
        with open_stream(f"{path}_{rank}", "w") as f:
            if key_fold:
                f.write(f"# key_fold={key_fold}\n")
            f.write("".join(f"{i}\t{v:.6g}\n"
                            for i, v in zip(idx.tolist(), w[idx].tolist())))

    def load_model(self, path: str, expect_key_fold: str = "") -> None:
        """Read back a save_model dump (either package's). ``path`` may be
        the bare ``model_out`` prefix: all ``{path}_{rank}`` shard files
        are merged. ``expect_key_fold`` must match a recorded
        ``# key_fold=`` header when both name one. The weights warm-start
        the handle (FTRL seeds z, not just w)."""
        paths = [path]
        if not os.path.exists(path):
            paths = sorted(_glob.glob(path + "_*"))
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
