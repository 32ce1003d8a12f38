"""Factorization machine, one device.

The counterpart of ``wormhole_tpu/models/fm.py``, on the sparse path (the
text and recordio formats) and on crec2 tiles:

    python -m wormhole_tpu_torch.models.fm num_buckets=4194304 dim=8 \\
        train_data=<f> val_data=<v> max_data_pass=2 model_out=<m> \\
        [data_format=libsvm|criteo|adfea|rec|crec2] \\
        [test_data=<t> pred_out=<p>] [tile_step_kernel=auto|fused|split] \\
        [device=cpu]

Forward (Rendle 2010): margin = Σ wᵢxᵢ + ½ Σ_f [(Σᵢ v_{if}xᵢ)² − Σᵢ v²_{if}x²ᵢ].
The sparse step (``train_step``) gathers the batch's unique rows, computes
the margin over the padded ``(mb, nnz, k)`` factors, and writes its
backward out by hand where JAX takes ``jax.grad``: the per-entry gradients
w: dual·x and v: dual·(s − v·x)·x, summed into the keys in flat order
(``ops/spmv.segment_sum``, the same bits on every run), plus the weight
decay on v; then AdaGrad with the L1L2 prox on w and plain AdaGrad on v,
written back for the real keys. ``eval_step`` and the serving forward share
``build_serve_margin``.

Each bucket row holds ``[w, v_1..v_k, cg_w, cg_v1..cg_vk]`` (a weight, a
k-dim factor and their AdaGrad accumulators) in one bucket-major
``(num_buckets, 2(1+k))`` f32 table, the JAX layout. With binary features the
margin, lin + ½ Σ_f [(Σ v_f)² − Σ v_f²], needs three pooled sums per row, all
pulled in one multi-channel tile pull of the k+2 channels [w, v_1..v_k, Σv²]
(``tilemm.forward_pulls``, kernel #4). The backward pushes the k+2 channels
[dual, dual·s_1..k, mask] (``tilemm.backward_pushes``, #5); the bucket-side
correction −v·push(dual) and the update (AdaGrad with the L1L2 prox on w,
AdaGrad with weight decay on v, touched buckets only) are torch elementwise
ops, as they were XLA ops in JAX. On a CUDA device ``tile_step_kernel=auto``
resolves the fused step ``tilemm.fused_fm_step`` (#8), spill blocks included.

Past one process the sparse step runs on the global batch (each host's
keys a segment, ``_tile.write_bucket_rows``). On a data×model mesh
(``runtime``; one position a process) the store holds its model shard's
range of the table, and the crec2 mesh step (``tile_train_step_mesh``,
the JAX ``_tile_step_mesh``, fm.py:340) runs the split chain at the
shard's ``spec_local``: the pulls [w, v, Σv²] of its own rows (#4, the
spill pairs in its range added), summed over the model axis; the
boundary (``tilemm.fm_boundary``) and the metric row summed over the data
axis; the pushes of its range (#5) summed over the data axis; the update
in place; Σ(Δw)² summed over the model axis. Every axis sum goes through
the transport stack in rank order. The fused step #8 cannot run there:
the model-axis sum sits between its pulls and its boundary.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from wormhole_tpu_torch.device import DeviceLike, host_to_device, \
    resolve_device
from wormhole_tpu_torch.learners.handles import scalar_like, sqrt_rn
from wormhole_tpu_torch.learners.store import (TableCheckpoint, _axis_sum,
                                               batch_metrics,
                                               mesh_block_view,
                                               mesh_macc_row,
                                               mesh_step_ici_bytes,
                                               mesh_tile_geometry,
                                               shard_param_table)
from wormhole_tpu_torch.models._tile import (EVAL_RECORD, check_slots,
                                             decode_block, eval_metrics,
                                             gather_bucket_rows, init_slots,
                                             mesh_runtime, metric_row,
                                             model_config,
                                             route_cli, step_ticket,
                                             write_bucket_rows)
from wormhole_tpu_torch.obs import trace
from wormhole_tpu_torch.ops import tilemm
from wormhole_tpu_torch.ops.loss import create_loss, loss_key
from wormhole_tpu_torch.ops.penalty import L1L2
from wormhole_tpu_torch.ops.spmv import segment_index, segment_sum, \
    spmv_times
from wormhole_tpu_torch.utils.config import apply_kvs


@dataclass
class FMConfig:
    num_buckets: int = 1 << 20
    dim: int = 8                  # latent factor size k
    loss: str = "logit"
    lr_alpha: float = 0.05
    lr_beta: float = 1.0
    l1: float = 0.0               # L1 on w (prox)
    l2: float = 0.0               # L2 on w (prox)
    l2_v: float = 1e-4            # weight decay on v
    init_scale: float = 0.01      # v init stddev
    seed: int = 0
    tile_step_kernel: str = "auto"   # auto|fused|split (auto = fused on
                                     # CUDA; tilemm.resolve_step_kernel)
    tile_onehot_cache: str = "auto"  # auto|on|off: a TPU staging knob;
                                     # always records off


def fm_forward(theta: torch.Tensor, batch):
    """(margin, vx, s) of a batch: ``theta`` (kpad, 1+k) holds [w, v] of
    its local keys, ``vx`` (mb, nnz, k) the value-weighted factors and
    ``s`` their row sums (the JAX ``fm_margin``, fm.py:65)."""
    w, v = theta[:, 0], theta[:, 1:]
    lin = spmv_times(batch.cols, batch.vals, w)
    vx = v[batch.cols.to(torch.int64)] * batch.vals[..., None]
    s = torch.sum(vx, 1)
    s2 = torch.sum(vx * vx, 1)
    return lin + 0.5 * torch.sum(s * s - s2, -1), vx, s


def fm_margin(theta: torch.Tensor, batch) -> torch.Tensor:
    """(mb,) FM margins of a batch from its (kpad, 1+k) [w, v] rows."""
    return fm_forward(theta, batch)[0]


def fm_tile_update(s32: torch.Tensor, push: torch.Tensor, cfg: FMConfig,
                   penalty: L1L2):
    """The tile step's table update from its push buffer (the JAX
    ``_tile_step`` ``update``, wormhole_tpu/models/fm.py:239-256): ``s32``
    is the (nb, 2(1+k)) table [w, v, cg_w, cg_v], ``push`` the (nb, k+2)
    pushes [dual, dual·s_1..k, mask]. On the touched buckets (mask > 0):
    AdaGrad with the L1L2 prox on w, AdaGrad with weight decay on v. Each
    quotient and square root rounds once, as XLA's do (``scalar_like``,
    ``sqrt_rn``). Returns (new table, Σ(Δw)²)."""
    k = cfg.dim
    theta, cg = s32[:, :1 + k], s32[:, 1 + k:]
    w, v = theta[:, 0], theta[:, 1:]
    g_w = push[:, 0]
    tm = (push[:, 1 + k] > 0)[:, None]
    g_v = push[:, 1:1 + k] - v * g_w[:, None] + cfg.l2_v * v * tm
    grads = torch.cat([g_w[:, None], g_v], 1)
    cg_new = torch.where(tm, sqrt_rn(cg * cg + grads * grads), cg)
    eta = scalar_like(cfg.lr_alpha, cg_new) / (cfg.lr_beta + cg_new)
    w_new = penalty.solve(w / eta[:, 0] - g_w, 1.0 / eta[:, 0])
    v_new = v - eta[:, 1:] * g_v
    theta_new = torch.where(tm, torch.cat([w_new[:, None], v_new], 1),
                            theta)
    d0 = theta_new[:, 0] - w
    return torch.cat([theta_new, cg_new], 1), torch.sum(d0 * d0)


class FMStore(TableCheckpoint):
    """FM parameters and the sparse and crec2 tile train/eval steps on one
    device; with a ``runtime`` of a model axis, its shard's range of the
    table (the same draws as the full table's rows)."""

    def __init__(self, cfg: FMConfig, device: DeviceLike = None,
                 runtime=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.objv_fn, self.dual_fn = create_loss(cfg.loss)
        rng = np.random.default_rng(cfg.seed)
        self.slots = shard_param_table(torch.from_numpy(init_slots(
            cfg.num_buckets, cfg.dim, cfg.init_scale, rng)),
            runtime).to(self.device)
        self._init_mesh(runtime)
        self.t = 1
        self._macc = None
        self._tile_cache: dict = {}
        self._tile_kernel: dict = {}
        self.step_kernel = None

    def with_num_buckets(self, nb: int) -> "FMStore":
        """The same config and device at ``nb`` buckets (the JAX
        ``with_num_buckets``): the bigmodel hot tier's twin and the
        full-size oracle. The v init re-draws from ``cfg.seed``
        over the new bucket count; a paged run overwrites a hot row on
        its first touch, so only the cold table's init matters."""
        return FMStore(dataclasses.replace(self.cfg, num_buckets=nb),
                      self.device, self.rt)

    # -- the sparse SparseBatch step ------------------------------------------

    def train_step(self, batch, tau: float = 0.0):
        """One sparse FM step (the JAX ``_build_step``, fm.py:104); returns
        (objv, num_ex, auc, acc, wdelta2) as 0-d tensors."""
        cfg = self.cfg
        k = cfg.dim
        rows = gather_bucket_rows(self.slots, batch)
        theta, cg = rows[:, :1 + k], rows[:, 1 + k:]
        margin, vx, s = fm_forward(theta, batch)
        objv = self.objv_fn(margin, batch.labels, batch.row_mask)
        dual = self.dual_fn(margin, batch.labels, batch.row_mask)
        # d margin / d w[key] = x and d margin / d v[key] = (s − v·x)·x per
        # entry; each key's entries summed in flat order
        x = batch.vals[..., None]
        contrib = torch.cat([x * dual[:, None, None],
                             dual[:, None, None] * (s[:, None, :] - vx) * x],
                            -1)
        g = segment_sum(segment_index(batch.cols, rows.shape[0]),
                        contrib.reshape(-1, 1 + k))
        km = batch.key_mask[:, None]
        v = theta[:, 1:]
        grads = torch.cat([g[:, :1], g[:, 1:] + cfg.l2_v * (v * km) * km], 1)
        cg_new = sqrt_rn(cg * cg + grads * grads)
        eta = scalar_like(cfg.lr_alpha, cg_new) / (cfg.lr_beta + cg_new)
        # w: AdaGrad + L1L2 prox (the AdaGrad handle's rule); v: AdaGrad
        w_new = L1L2(cfg.l1, cfg.l2).solve(
            theta[:, 0] / eta[:, 0] - grads[:, 0],
            scalar_like(1.0, eta) / eta[:, 0])
        v_new = v - eta[:, 1:] * grads[:, 1:]
        new_rows = torch.cat([w_new[:, None], v_new, cg_new], 1)
        delta = (new_rows - rows) * km
        write_bucket_rows(self.slots, batch, rows, delta)
        self.t += 1
        num_ex, a, acc = batch_metrics(batch.labels, margin, batch.row_mask)
        return objv, num_ex, a, acc, torch.sum(delta[:, 0] * delta[:, 0])

    def eval_step(self, batch):
        """(objv, num_ex, auc, acc, margin) through the serve margin."""
        margin = self.build_serve_margin()(self.serve_params(), batch)
        objv = self.objv_fn(margin, batch.labels, batch.row_mask)
        return (objv,) + batch_metrics(batch.labels, margin,
                                       batch.row_mask) + (margin,)

    # -- pull-only serving surface (serve/forward.py) ------------------------

    def serve_params(self):
        return {"slots": self.slots}

    def build_serve_margin(self):
        k = self.cfg.dim

        def margin_fn(params, batch):
            return fm_margin(gather_bucket_rows(params["slots"], batch)
                             [:, :1 + k], batch)

        return margin_fn

    # -- the crec2 tile step ------------------------------------------------

    def _tile_step(self, info, kind: str):
        """The step for blocks of geometry ``info``: "eval" gives
        ``step(slots, block) -> (objv, num_ex, acc, pos, neg, margin)``,
        "train" gives ``step(slots, block, tau) -> (new slots, packed
        metric row)``. Sets ``step_kernel`` to ``(resolved, why,
        cache_record)`` as the JAX store does (fm.py:189-338)."""
        key = (info, kind)
        fn = self._tile_cache.get(key)
        if fn is not None:
            self.step_kernel = self._tile_kernel[key]
            return fn
        cfg = self.cfg
        k = cfg.dim
        objv_fn = self.objv_fn
        loss = loss_key(cfg.loss)
        penalty = L1L2(cfg.l1, cfg.l2)
        spec, oc = info.spec, info.ovf_cap
        dev = self.device
        res = tilemm.resolve_step_kernel(
            cfg.tile_step_kernel, ovf_cap=oc, spec=spec, channels=k + 2,
            onehot_cache=cfg.tile_onehot_cache, device=self.device)
        fused = res.kernel == "fused" and kind == "train"

        def make_wpull(s32):
            w, v = s32[:, 0], s32[:, 1:1 + k]
            return torch.cat([w[:, None], v,
                              torch.sum(v * v, 1, keepdim=True)], 1)

        def update(s32, push, margin, labels, row_mask):
            # everything downstream of the push buffer: the same torch ops
            # in the fused and split programs; the tail's stage ends after
            # the accumulator add (tile_train_step)
            trace.stage("step:update", dev)
            new, wdelta2 = fm_tile_update(s32, push, cfg, penalty)
            trace.stage("step:tail", dev)
            return new, metric_row(objv_fn, margin, labels, row_mask,
                                   wdelta2)

        if kind != "train":
            def step(slots, block):
                pw, labels, row_mask, ovf_b, ovf_r = decode_block(block, oc)
                pulls = tilemm.forward_pulls(pw, make_wpull(slots), spec,
                                             ovf_b, ovf_r)
                margin, _ = tilemm.fm_boundary(pulls, labels, row_mask, k,
                                               loss, want_dual=False)
                return eval_metrics(objv_fn, margin, labels, row_mask)
        elif fused:
            def step(slots, block, tau):
                trace.stage("step:pull", dev)
                wpull = make_wpull(slots)
                if oc:
                    # the spill pulls ride into the step as a grid operand;
                    # the step hands back the push rows for the scatter
                    trace.stage("step:spill", dev)
                    sp = tilemm.spill_pull_rows(wpull, block["ovf_b"],
                                                block["ovf_r"], spec)
                trace.stage("step:kernel", dev)
                pw, labels, row_mask, ovf_b, ovf_r = decode_block(block, oc)
                if oc:
                    margin, push, dv = tilemm.fused_fm_step(
                        pw, wpull, labels, row_mask, spec, k, loss,
                        spill_pulls=sp)
                    trace.stage("step:spill", dev)
                    push = tilemm.spill_push_scatter(push, dv, ovf_b, ovf_r,
                                                     spec)
                else:
                    margin, push = tilemm.fused_fm_step(
                        pw, wpull, labels, row_mask, spec, k, loss)
                return update(slots, push, margin, labels, row_mask)
        else:
            def step(slots, block, tau):
                trace.stage("step:pull", dev)
                wpull = make_wpull(slots)
                trace.stage("step:kernel", dev)
                pw, labels, row_mask, ovf_b, ovf_r = decode_block(block, oc)
                pulls = tilemm.forward_pulls(pw, wpull, spec, ovf_b, ovf_r)
                margin, dvals = tilemm.fm_boundary(pulls, labels, row_mask,
                                                   k, loss)
                push = tilemm.backward_pushes(pw, dvals, spec, ovf_b, ovf_r)
                return update(slots, push, margin, labels, row_mask)

        record = (EVAL_RECORD if kind != "train" else
                  ("fused" if fused else "split", res.why, res.cache_record))
        self._tile_kernel[key] = self.step_kernel = record
        self._tile_cache[key] = step
        return step

    def tile_train_step(self, block: dict, info, tau: float = 0.0):
        """One crec2 train step over a device block dict. The metric row
        adds into the on-device accumulator (``fetch_metrics``). Returns a
        completion ticket: a CUDA event recorded after the step, or None on
        the CPU. Its stages are ``trace.stage`` spans (``step:pull``,
        ``step:kernel``, ``step:spill``, ``step:update``, ``step:tail``)."""
        step = self._tile_step(info, "train")
        with (trace.span("tilemm:fused_multi", cat="tile")
              if self.step_kernel[0] == "fused" else nullcontext()):
            self.slots, row = step(self.slots, block, self._tau_const(tau))
            self._macc_buf().add_(row)
            trace.stage(None, self.device)
        self.t += 1
        return step_ticket(self.device)

    def tile_eval_step(self, block: dict, info):
        return self._tile_step(info, "eval")(self.slots, block)

    # -- the crec2 step of one mesh position ---------------------------------

    def _tile_step_mesh(self, info, kind: str):
        """The FM step of one mesh position (the JAX ``_tile_step_mesh``,
        fm.py:340-446): "eval" gives ``step(slots, block) -> (objv,
        num_ex, acc, pos, neg, margin)``, "train" gives ``step(slots,
        block) -> (new slots, metric row)``. The Σv² channel is each
        shard's own, summed with the others as a pull channel."""
        key = (info, kind, "mesh")
        fn = self._tile_cache.get(key)
        if fn is not None:
            return fn
        cfg = self.cfg
        k = cfg.dim
        loss = loss_key(cfg.loss)
        penalty = L1L2(cfg.l1, cfg.l2)
        local, _, spec_local = mesh_block_view(self.rt, info,
                                               self.row_offset)
        data, model, have_model = self._mesh_axes()
        clock = self.mesh_stats

        def pulls_of(s32, pw, ovb, ovr):
            w, v = s32[:, 0], s32[:, 1:1 + k]
            wpull = torch.cat([w[:, None], v,
                               torch.sum(v * v, 1, keepdim=True)], 1)
            pulls = tilemm.forward_pulls(pw, wpull, spec_local, ovb, ovr)
            return (_axis_sum(model, pulls, "mesh/model_pulls", clock)
                    if have_model else pulls)

        if kind != "train":
            def step(slots, block):
                pw, labels, row_mask, ovb, ovr = local(block)
                margin, _ = tilemm.fm_boundary(
                    pulls_of(slots, pw, ovb, ovr), labels, row_mask, k,
                    loss, want_dual=False)
                return self._mesh_tail(margin, labels, row_mask, data,
                                       clock) + (margin,)
        else:
            def step(slots, block):
                pw, labels, row_mask, ovb, ovr = local(block)
                margin, dvals = tilemm.fm_boundary(
                    pulls_of(slots, pw, ovb, ovr), labels, row_mask, k,
                    loss)
                tail = self._mesh_tail(margin, labels, row_mask, data,
                                       clock)
                push = tilemm.backward_pushes(pw, dvals, spec_local, ovb,
                                              ovr)
                push = _axis_sum(data, push, "mesh/data_pushes", clock)
                new, wd2 = fm_tile_update(slots, push, cfg, penalty)
                if have_model:
                    wd2 = _axis_sum(model, wd2.reshape(1),
                                    "mesh/model_wdelta2", clock)[0]
                return new, mesh_macc_row(tail[0], tail[1], tail[2], wd2,
                                          tail[3], tail[4])

        self._tile_cache[key] = step
        return step

    def _mesh_ici(self, info, train: bool = True) -> int:
        """The modeled exchange bytes of one mesh step (the JAX
        ``tile_train_step_mesh``'s: k+2 pull channels over the model
        axis, k+2 push channels over the data axis)."""
        if self.rt is None:
            return 0
        ch = self.cfg.dim + 2
        nb_local = mesh_tile_geometry(self.rt, info.spec)[0]
        return mesh_step_ici_bytes(self.rt,
                                   margin_elems=info.block_rows * ch,
                                   grad_elems=nb_local * ch, train=train)

    def tile_train_step_mesh(self, block: dict, info, tau: float = 0.0):
        """One mesh train step of this position (the JAX
        ``tile_train_step_mesh``, fm.py:448): ``block`` is the device
        block of its data index, whose ``pw`` holds the whole block's
        tiles or only this shard's. The metric row (data-axis sums
        included) adds into the on-device accumulator. Returns a
        completion ticket as ``tile_train_step``."""
        self.slots, row = self._mesh_dispatch(
            self._tile_step_mesh(info, "train"), self.slots, block,
            ici_bytes=self._mesh_ici(info))
        self._macc_buf().add_(row)
        self.t += 1
        return step_ticket(self.device)

    def tile_eval_step_mesh(self, block: dict, info):
        """(objv, num_ex, acc, pos, neg, margin) of this position's block,
        the metrics summed over the data axis."""
        return self._mesh_dispatch(self._tile_step_mesh(info, "eval"),
                                   self.slots, block,
                                   ici_bytes=self._mesh_ici(info, False))

    def nnz_weight(self) -> int:
        return int(torch.count_nonzero(self.slots[:, 0]))

    # -- weights in and out -------------------------------------------------

    def from_jax_slots(self, slots: np.ndarray) -> None:
        """Load a JAX ``FMStore``'s (num_buckets, 2(1+k)) slots (numpy;
        on a model shard, its range's rows)."""
        self.slots = self._slots_from_jax(slots)

    def _slots_from_jax(self, slots: np.ndarray) -> torch.Tensor:
        return host_to_device(check_slots(slots, self.nb_local,
                                          self.cfg.dim), self.device)

    def to_jax_slots(self) -> np.ndarray:
        """The slots as a JAX ``FMStore`` holds them, numpy f32."""
        return self.slots.cpu().numpy().copy()

    def save_model(self, path: str, rank: int = 0,
                   key_fold: str = "") -> None:
        """``{path}_{rank}.npz`` with ``w`` and ``v``: the JAX store's
        export (fm.py:525), so either package loads the other's model.
        ``key_fold`` is accepted for the store protocol; the npz carries
        none."""
        arr = self.slots[:, :1 + self.cfg.dim].cpu().numpy()
        np.savez_compressed(f"{path}_{rank}.npz", w=arr[:, 0], v=arr[:, 1:])

    def load_model(self, path: str, expect_key_fold: str = "") -> None:
        data = np.load(path)
        slots = self.slots.cpu().numpy().copy()
        w, v = data["w"], data["v"]
        if len(w) != self.nb_local:
            # a whole table's file on a model shard: this shard's range
            off = self.row_offset
            w, v = w[off:off + self.nb_local], v[off:off + self.nb_local]
        slots[:, 0] = w
        slots[:, 1:1 + self.cfg.dim] = v
        self.slots = torch.from_numpy(slots).to(self.device)


def main(argv: Optional[list] = None) -> int:
    """CLI: ``python -m wormhole_tpu_torch.models.fm [conf] train_data=<uri>
    dim=8 [key=val ...] [device=cpu]`` — the AsyncSGD app with an
    FMStore plugged in. FMConfig fields go to the model, everything else to
    the app Config; ``num_buckets``, ``loss``, ``seed``,
    ``tile_step_kernel`` and ``tile_onehot_cache`` are mirrored into the
    model config."""
    from wormhole_tpu_torch.learners.async_sgd import AsyncSGD
    device, cfg, model_kvs = route_cli(argv, FMConfig)
    mcfg = model_config(FMConfig, cfg)
    apply_kvs(mcfg, model_kvs)
    rt = mesh_runtime(cfg, device)
    AsyncSGD(cfg, device, store=FMStore(mcfg, device, rt), runtime=rt).run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
