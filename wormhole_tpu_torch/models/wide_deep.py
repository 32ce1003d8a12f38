"""Wide & Deep, one device.

The counterpart of ``wormhole_tpu/models/wide_deep.py``, on the sparse path
(the text and recordio formats) and on crec2 tiles:

    python -m wormhole_tpu_torch.models.wide_deep num_buckets=4194304 \\
        dim=16 hidden=64,32 train_data=<f> val_data=<v> max_data_pass=2 \\
        model_out=<m> [data_format=libsvm|criteo|adfea|rec|crec2] \\
        [test_data=<t> pred_out=<p>] [tile_step_kernel=auto|fused|split] \\
        [device=cpu]

margin(row) = Σ wᵢxᵢ + MLP(Σ xᵢ·vᵢ) over the row's hashed features. The
sparse step (``train_step``) gathers the batch's unique rows, pools the
value-weighted embeddings, runs the MLP and takes its vjp
(``torch.func.vjp`` of ``tilemm.mlp_forward``; f32 matmuls with TF32 off),
and writes the backward of the gathers by hand where JAX takes ``jax.grad``:
the per-entry gradients w: dual·x and v: g_pooled·x summed into the keys in
flat order (``ops/spmv.segment_sum``, the same bits on every run), plus the
weight decay on v; then AdaGrad on the table rows (written back for the
real keys) and on the MLP. ``eval_step`` and the serving forward share
``build_serve_margin``.

On crec2 tiles, margin(row) = Σ w[b] + MLP(Σ v[b]) over binary features. The
sparse part is one bucket-major ``(num_buckets, 2(1+k))`` f32 table ``[w, v,
cg_w, cg_v]`` (the JAX layout), the dense part an MLP dict ``{W_i, b_i}`` with
its AdaGrad accumulators. Both pooled sums come from one tile pull of the 1+k
channels [w, v_1..v_k] (``tilemm.forward_pulls``, kernel #4); the dual
backprops through the MLP to the pooled input, and the pushes carry the k+2
channels [dual, g_pooled_1..k, mask] (``tilemm.backward_pushes``, #5). On a
CUDA device ``tile_step_kernel=auto`` resolves the fused step
``tilemm.fused_wd_step`` (#9, the MLP forward and vjp inside) on spill-free
blocks; spill blocks run split. The AdaGrad updates of the table and of the
MLP are torch elementwise ops.

Not ported yet: the mesh step (slice 5), ``state_pytree``/
``restore_pytree`` (checkpoint resume) and ``with_num_buckets`` (slice 6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from wormhole_tpu_torch.device import DeviceLike, resolve_device
from wormhole_tpu_torch.learners.handles import scalar_like, sqrt_rn
from wormhole_tpu_torch.learners.store import TableCheckpoint, batch_metrics
from wormhole_tpu_torch.models._tile import (EVAL_RECORD, check_slots,
                                             decode_block, eval_metrics,
                                             gather_bucket_rows, init_slots,
                                             metric_row, model_config,
                                             route_cli, step_ticket,
                                             write_bucket_rows)
from wormhole_tpu_torch.ops import tilemm
from wormhole_tpu_torch.ops.loss import create_loss, loss_key
from wormhole_tpu_torch.ops.spmv import segment_index, segment_sum, \
    spmv_times
from wormhole_tpu_torch.utils.config import apply_kvs


@dataclass
class WideDeepConfig:
    num_buckets: int = 1 << 20
    dim: int = 16                      # embedding size k
    hidden: Tuple[int, ...] = (64, 32)
    loss: str = "logit"
    lr_alpha: float = 0.05             # AdaGrad, sparse table
    lr_alpha_dense: float = 0.01       # AdaGrad, MLP
    lr_beta: float = 1.0
    l2_v: float = 1e-5
    init_scale: float = 0.01
    seed: int = 0
    tile_step_kernel: str = "auto"   # auto|fused|split (auto = fused on
                                     # CUDA for spill-free blocks)
    tile_onehot_cache: str = "auto"  # auto|on|off: a TPU staging knob;
                                     # always records off


def init_mlp(sizes: List[int], rng: np.random.Generator
             ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """He-init MLP params and zero AdaGrad accumulators, as numpy dicts —
    the JAX ``init_mlp`` draw (wide_deep.py:65) from the same generator, so
    a fresh store of either package holds the same bits."""
    params, accum = {}, {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"W{i}"] = (rng.standard_normal((a, b))
                           * np.sqrt(2.0 / a)).astype(np.float32)
        params[f"b{i}"] = np.zeros(b, np.float32)
    for k, v in params.items():
        accum[k] = np.zeros_like(v)
    return params, accum


def _to_device(tree: dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in tree.items()}


def _to_numpy(tree: dict) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy().copy() for k, v in tree.items()}


class WideDeepStore(TableCheckpoint):
    """Embedding table + MLP and the sparse and crec2 tile train/eval
    steps on one device."""

    def __init__(self, cfg: WideDeepConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.objv_fn, self.dual_fn = create_loss(cfg.loss)
        k = cfg.dim
        rng = np.random.default_rng(cfg.seed)
        self.slots = torch.from_numpy(init_slots(
            cfg.num_buckets, k, cfg.init_scale, rng)).to(self.device)
        sizes = [k] + list(cfg.hidden) + [1]
        params, accum = init_mlp(sizes, rng)
        self.mlp = _to_device(params, self.device)
        self.mlp_accum = _to_device(accum, self.device)
        self.n_layers = len(sizes) - 1
        self.t = 1
        self._macc = None
        self._tile_cache: dict = {}
        self._tile_kernel: dict = {}
        self.step_kernel = None

    # -- the sparse SparseBatch step ------------------------------------------

    def _forward(self, theta: torch.Tensor, batch):
        """(wide, pooled) of a batch from its (kpad, 1+k) [w, v] rows (the
        JAX ``_forward``, wide_deep.py:113, before the MLP)."""
        wide = spmv_times(batch.cols, batch.vals, theta[:, 0])
        v = theta[:, 1:]
        pooled = torch.sum(v[batch.cols.to(torch.int64)]
                           * batch.vals[..., None], 1)
        return wide, pooled

    def train_step(self, batch, tau: float = 0.0):
        """One sparse wide&deep step (the JAX ``_build_step``,
        wide_deep.py:121); returns (objv, num_ex, auc, acc, wdelta2) as 0-d
        tensors."""
        cfg = self.cfg
        k = cfg.dim
        n_layers = self.n_layers
        rows = gather_bucket_rows(self.slots, batch)
        theta, cg = rows[:, :1 + k], rows[:, 1 + k:]
        wide, pooled = self._forward(theta, batch)
        deep, vjp = torch.func.vjp(
            lambda m, x: tilemm.mlp_forward(m, x, n_layers), self.mlp, pooled)
        margin = wide + deep
        objv = self.objv_fn(margin, batch.labels, batch.row_mask)
        dual = self.dual_fn(margin, batch.labels, batch.row_mask)
        g_mlp, g_pooled = vjp(dual)
        # d margin / d w[key] = x and d margin / d v[key] = g_pooled·x per
        # entry; each key's entries summed in flat order
        x = batch.vals[..., None]
        contrib = torch.cat([x * dual[:, None, None],
                             x * g_pooled[:, None, :]], -1)
        g = segment_sum(segment_index(batch.cols, rows.shape[0]),
                        contrib.reshape(-1, 1 + k))
        km = batch.key_mask[:, None]
        v = theta[:, 1:]
        g_theta = torch.cat([g[:, :1], g[:, 1:] + cfg.l2_v * (v * km) * km],
                            1)
        cg_new = sqrt_rn(cg * cg + g_theta * g_theta)
        eta = scalar_like(cfg.lr_alpha, cg_new) / (cfg.lr_beta + cg_new)
        new_rows = torch.cat([theta - eta * g_theta, cg_new], 1)
        delta = (new_rows - rows) * km
        write_bucket_rows(self.slots, batch, rows, delta)
        self.mlp_accum = {n: sqrt_rn(a * a + g_mlp[n] * g_mlp[n])
                          for n, a in self.mlp_accum.items()}
        self.mlp = {n: p - scalar_like(cfg.lr_alpha_dense, p)
                    / (cfg.lr_beta + self.mlp_accum[n]) * g_mlp[n]
                    for n, p in self.mlp.items()}
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
        return {"slots": self.slots, "mlp": self.mlp}

    def build_serve_margin(self):
        k = self.cfg.dim
        n_layers = self.n_layers

        def margin_fn(params, batch):
            theta = gather_bucket_rows(params["slots"], batch)[:, :1 + k]
            wide, pooled = self._forward(theta, batch)
            return wide + tilemm.mlp_forward(params["mlp"], pooled, n_layers)

        return margin_fn

    # -- the crec2 tile step ------------------------------------------------

    def _tile_step(self, info, kind: str):
        """The step for blocks of geometry ``info``: "eval" gives
        ``step(slots, mlp, block) -> (objv, num_ex, acc, pos, neg,
        margin)``, "train" gives ``step(slots, mlp, accum, block, tau) ->
        (slots, mlp, accum, packed metric row)``. Sets ``step_kernel`` as
        the JAX store does (wide_deep.py:208-342)."""
        key = (info, kind)
        fn = self._tile_cache.get(key)
        if fn is not None:
            self.step_kernel = self._tile_kernel[key]
            return fn
        cfg = self.cfg
        k = cfg.dim
        objv_fn = self.objv_fn
        loss = loss_key(cfg.loss)
        spec, oc = info.spec, info.ovf_cap
        res = tilemm.resolve_step_kernel(
            cfg.tile_step_kernel, ovf_cap=oc, deep=True, spec=spec, dim=k,
            hidden=tuple(cfg.hidden), channels=k + 2,
            onehot_cache=cfg.tile_onehot_cache, device=self.device)
        fused = res.kernel == "fused" and kind == "train"

        def wpull(s32):
            return s32[:, :1 + k].contiguous()

        def finish(s32, mlp, accum, push, g_mlp, margin, labels, row_mask):
            # the update and metric tail downstream of the pushes and the
            # MLP grads: the same torch ops in the fused and split programs
            theta, cg = s32[:, :1 + k], s32[:, 1 + k:]
            v = theta[:, 1:]
            tm = (push[:, 1 + k] > 0)[:, None]
            g_v = push[:, 1:1 + k] + cfg.l2_v * v * tm
            grads = torch.cat([push[:, :1], g_v], 1)
            cg_new = torch.where(tm, torch.sqrt(cg * cg + grads * grads), cg)
            eta = cfg.lr_alpha / (cfg.lr_beta + cg_new)
            theta_new = torch.where(tm, theta - eta * grads, theta)
            accum = {n: torch.sqrt(a * a + g_mlp[n] * g_mlp[n])
                     for n, a in accum.items()}
            mlp = {n: p - cfg.lr_alpha_dense / (cfg.lr_beta + accum[n])
                   * g_mlp[n] for n, p in mlp.items()}
            d0 = theta_new[:, 0] - theta[:, 0]
            return (torch.cat([theta_new, cg_new], 1), mlp, accum,
                    metric_row(objv_fn, margin, labels, row_mask,
                               torch.sum(d0 * d0)))

        if kind != "train":
            def step(slots, mlp, block):
                pw, labels, row_mask, ovf_b, ovf_r = decode_block(block, oc)
                pulls = tilemm.forward_pulls(pw, wpull(slots), spec, ovf_b,
                                             ovf_r)
                margin = tilemm.wd_boundary(pulls, labels, row_mask, mlp, k,
                                            loss, want_grad=False)[0]
                return eval_metrics(objv_fn, margin, labels, row_mask)
        elif fused:
            def step(slots, mlp, accum, block, tau):
                pw, labels, row_mask, _, _ = decode_block(block, oc)
                margin, push, g_mlp = tilemm.fused_wd_step(
                    pw, wpull(slots), labels, row_mask, mlp, spec, k, loss)
                return finish(slots, mlp, accum, push, g_mlp, margin,
                              labels, row_mask)
        else:
            def step(slots, mlp, accum, block, tau):
                pw, labels, row_mask, ovf_b, ovf_r = decode_block(block, oc)
                pulls = tilemm.forward_pulls(pw, wpull(slots), spec, ovf_b,
                                             ovf_r)
                margin, dvals, g_mlp = tilemm.wd_boundary(
                    pulls, labels, row_mask, mlp, k, loss)
                push = tilemm.backward_pushes(pw, dvals, spec, ovf_b, ovf_r)
                return finish(slots, mlp, accum, push, g_mlp, margin,
                              labels, row_mask)

        record = (EVAL_RECORD if kind != "train" else
                  ("fused" if fused else "split", res.why, res.cache_record))
        self._tile_kernel[key] = self.step_kernel = record
        self._tile_cache[key] = step
        return step

    def tile_train_step(self, block: dict, info, tau: float = 0.0):
        """One crec2 train step (table and MLP); the metric row adds into
        the on-device accumulator. Returns a completion ticket: a CUDA
        event recorded after the step, or None on the CPU."""
        step = self._tile_step(info, "train")
        self.slots, self.mlp, self.mlp_accum, row = step(
            self.slots, self.mlp, self.mlp_accum, block,
            self._tau_const(tau))
        self._macc_buf().add_(row)
        self.t += 1
        return step_ticket(self.device)

    def tile_eval_step(self, block: dict, info):
        return self._tile_step(info, "eval")(self.slots, self.mlp, block)

    def nnz_weight(self) -> int:
        return int(torch.count_nonzero(self.slots[:, 0]))

    # -- weights in and out -------------------------------------------------

    def from_jax_slots(self, slots: np.ndarray) -> None:
        """Load a JAX ``WideDeepStore``'s (num_buckets, 2(1+k)) slots."""
        self.slots = torch.from_numpy(check_slots(
            slots, self.cfg.num_buckets, self.cfg.dim).copy()).to(self.device)

    def to_jax_slots(self) -> np.ndarray:
        return self.slots.cpu().numpy().copy()

    def from_jax_mlp(self, mlp: dict, accum: Optional[dict] = None) -> None:
        """Load a JAX store's ``mlp`` (and ``mlp_accum``) trees, given as
        dicts of arrays, checked against this store's widths."""
        for name, v in mlp.items():
            if np.shape(v) != tuple(self.mlp[name].shape):
                raise ValueError(f"mlp {name} of shape {np.shape(v)}; this "
                                 f"store holds {tuple(self.mlp[name].shape)}")
        self.mlp = _to_device(mlp, self.device)
        if accum is not None:
            self.mlp_accum = _to_device(accum, self.device)

    def to_jax_mlp(self) -> Tuple[dict, dict]:
        """(mlp, mlp_accum) as numpy dicts, the JAX store's tree keys."""
        return _to_numpy(self.mlp), _to_numpy(self.mlp_accum)

    def save_model(self, path: str, rank: int = 0,
                   key_fold: str = "") -> None:
        """``{path}_{rank}.npz`` with ``w``, ``v`` and ``mlp_W{i}``/
        ``mlp_b{i}``: the JAX store's export (wide_deep.py:559)."""
        arr = self.slots[:, :1 + self.cfg.dim].cpu().numpy()
        dense = {f"mlp_{n}": v for n, v in _to_numpy(self.mlp).items()}
        np.savez_compressed(f"{path}_{rank}.npz", w=arr[:, 0], v=arr[:, 1:],
                            **dense)

    def load_model(self, path: str, expect_key_fold: str = "") -> None:
        data = np.load(path)
        slots = self.slots.cpu().numpy().copy()
        slots[:, 0] = data["w"]
        slots[:, 1:1 + self.cfg.dim] = data["v"]
        self.slots = torch.from_numpy(slots).to(self.device)
        self.mlp = _to_device({n[4:]: data[n] for n in data.files
                               if n.startswith("mlp_")}, self.device)


def main(argv: Optional[list] = None) -> int:
    """CLI: ``python -m wormhole_tpu_torch.models.wide_deep [conf]
    train_data=<uri> hidden=64,32 [key=val ...] [device=cpu]`` — the
    AsyncSGD app with a WideDeepStore plugged in, routed as the FM CLI;
    ``hidden`` (comma-separated ints) is parsed here."""
    import sys
    from wormhole_tpu_torch.learners.async_sgd import AsyncSGD
    args = list(sys.argv[1:] if argv is None else argv)
    hidden, rest = None, []
    for a in args:
        key, _, val = a.partition("=")
        if key.strip() == "hidden":
            hidden = tuple(int(p) for p in val.replace(",", " ").split()
                           if p)
        else:
            rest.append(a)
    device, cfg, model_kvs = route_cli(rest, WideDeepConfig)
    mcfg = model_config(WideDeepConfig, cfg)
    apply_kvs(mcfg, model_kvs)
    if hidden is not None:
        mcfg.hidden = hidden
    AsyncSGD(cfg, device, store=WideDeepStore(mcfg, device)).run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
