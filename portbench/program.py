"""The system under test, as the benchmark drives it: the port's
``AsyncSGD`` on a cell's configuration, with a ``ShardedStore`` (FTRL) or
an ``FMStore``, and what the correctness check reads of it: three
captured steps and the window's first metric window.

This is the only module of the harness that imports the program
(``wormhole_tpu_torch``); it does so inside its functions.
"""

from __future__ import annotations

from typing import Optional

import torch

from portbench.reference.common import grown_norm, norm


def build_app(config: dict, train_file: str, seed: int, cache_device: bool,
              device, overrides: Optional[dict] = None):
    """An ``AsyncSGD`` on ``config['app']`` (plus ``overrides``), its store
    built as ``config['store']`` says."""
    from wormhole_tpu_torch.learners.async_sgd import AsyncSGD
    from wormhole_tpu_torch.utils.config import load_config
    app_kv = dict(config["app"])
    app_kv.update(train_data=train_file, seed=str(seed),
                  cache_device="true" if cache_device else "false",
                  max_data_pass="1")
    app_kv.update(overrides or {})
    cfg = load_config(None, [f"{k}={v}" for k, v in app_kv.items()])
    store = None
    if config["store"] == "fm":
        from wormhole_tpu_torch.models.fm import FMConfig, FMStore
        m = config["model"]
        mcfg = FMConfig(num_buckets=cfg.num_buckets, loss=cfg.loss.value,
                        seed=seed, tile_step_kernel=cfg.tile_step_kernel,
                        **{k: m[k] for k in ("dim", "lr_alpha", "lr_beta",
                                             "l1", "l2", "l2_v",
                                             "init_scale")})
        store = FMStore(mcfg, device)
    elif config["store"] != "linear":
        raise ValueError(f"unknown store {config['store']!r}")
    return AsyncSGD(cfg, device, store=store)


def train_pass(app, train_file: str):
    """One training pass: the call the window drives."""
    from wormhole_tpu_torch.sched.workload_pool import TRAIN
    return app.process(train_file, 0, 1, kind=TRAIN)


def leaves(config: dict, slots: torch.Tensor) -> dict:
    """The program's table as the reference's named leaves: views of it."""
    s = slots.detach()
    if config["store"] == "linear":      # plane-major (3, nb): w, z, n
        return {"w": s[0], "z": s[1], "n": s[2]}
    k = int(config["model"]["dim"])      # (nb, 2(1+k)): w, v, cg_w, cg_v
    return {"w": s[:, 0], "v": s[:, 1:1 + k], "cg_w": s[:, 1 + k],
            "cg_v": s[:, 2 + k:]}


# each gradient leaf and the accumulator of root sums of squares that
# takes it in
ACCUMULATORS = {"linear": {"g": "n"}, "fm": {"g_w": "cg_w", "g_v": "cg_v"}}


class Capture:
    """Wraps the store's ``tile_train_step`` and reads steps ``start`` to
    ``start + n - 1`` of the store's steps, on the device: the gradient of
    the first of them as the optimizer got it, from the growth of its
    accumulators (``grown_norm``), and the norms of each leaf's change over
    the ``n`` steps; besides, each step's own metric row (the accumulator
    is handed a fresh buffer for the step and added back, so its sum is
    the same) and each step's block labels. The other steps pass straight
    through; ``remove`` restores the method."""

    def __init__(self, store, config: dict, start: int, n: int = 3):
        self.store, self.config, self.start, self.n = store, config, start, n
        self.count = 0
        self.rows, self.labels = [], []
        self.grad_norms, self.change_norms = {}, {}
        self._orig = store.tile_train_step
        store.tile_train_step = self._step

    def _step(self, block, info, tau=0.0):
        i = self.count - self.start
        self.count += 1
        if not 0 <= i < self.n:
            return self._orig(block, info, tau)
        store, cfg = self.store, self.config
        if i == 0:
            self._before = store.slots.detach().clone()
        saved = store._macc
        store._macc = None
        ev = self._orig(block, info, tau)
        row = store._macc
        self.rows.append(row.detach().to("cpu", copy=True))
        if saved is not None:
            saved.add_(row)
            store._macc = saved
        self.labels.append(block["labels"].detach().to("cpu", copy=True))
        now, then = leaves(cfg, store.slots), leaves(cfg, self._before)
        if i == 0:
            self.grad_norms = {
                g: grown_norm(now[a], then[a])
                for g, a in ACCUMULATORS[cfg["store"]].items()}
        if i == self.n - 1:
            self.change_norms = {k: norm(now[k], then[k]) for k in now}
            del self._before
        return ev

    def remove(self):
        self.store.tile_train_step = self._orig


class WindowTap:
    """Keeps the first metric window that the app hands over from its
    store's on-device accumulator (``fetch_metrics_async``) while
    installed: its ticket, resolved later, and the steps it counts (the
    app's ``_crec_count`` at the hand-over)."""

    def __init__(self, app):
        self.app, self.store = app, app.store
        self.ticket, self.steps = None, 0
        self._orig = self.store.fetch_metrics_async
        self.store.fetch_metrics_async = self._fetch

    def _fetch(self):
        t = self._orig()
        if self.ticket is None:
            self.ticket, self.steps = t, int(self.app._crec_count)
        return t

    def remove(self):
        self.store.fetch_metrics_async = self._orig

    def row(self):
        return (self.ticket.resolve().astype("float64")
                if self.ticket is not None else None)
