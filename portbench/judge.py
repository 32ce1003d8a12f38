"""The comparison that decides ``correct``: the program's steps against
the plain reference, which replays every step from the seed.

Set-up runs ``warm`` steps (whole passes over the file's blocks, the first
streamed, the rest replayed from the device cache as the window replays
them); steps ``capture`` to ``capture + 2``, the first three of the last
warm pass, are captured (``program.Capture``). The window's first metric
window, its first ``window`` steps, comes from the program's own
accumulator (``program.WindowTap``). The numbers (each held to a limit of
``limits/<cell>.json``):

- ``loss_gap``: the largest of the three captured steps' |objv_p - objv_r|
  / |objv_r|;
- ``grad_gap``: the first captured step's gradient as the optimizer got
  it (read from the growth of the program's accumulators), by the worst
  leaf: |‖g_p‖ - ‖g_r‖| / max(‖g_r‖, the median leaf's ‖g_r‖);
- ``change_gap``: the table's change over the three captured steps, by
  the worst leaf, measured alike. A leaf counts only where its gradient
  leaf's reference norm is at least a thousandth of the median gradient
  leaf's;
- ``auc_gap``: |AUC_p - AUC_r| over the three steps' rows, both from
  512-bin margin histograms over [-14, 14];
- ``order_rows``: rows of the three captured blocks whose label differs
  from the generator's blocks 0, 1, 2 (the replay's order);
- ``window_loss_gap``, ``window_auc_gap``: the same of the window's first
  metric window, its objv sum and the AUC of its histograms;
- ``examples_missing``: |rows the program's metrics counted over the
  window - passes x the file's real rows|.
"""

from __future__ import annotations

import dataclasses
import importlib
from statistics import median
from typing import Dict

import numpy as np
import torch

from portbench import gen
from portbench.reference.common import (Rounding, auc_from_hist,
                                        make_block, norm)

STEPS = 3


def reference_module(config: dict):
    return importlib.import_module(f"portbench.reference.{config['reference']}")


def blocks_of(traffic: dict, geom: dict, meta: dict, seed: int,
              device) -> list:
    """Every block of the cell's file, from the generator's raw rows."""
    cdfs: dict = {}
    out = []
    for i in range(int(geom["blocks"])):
        keys, labels = gen.block_rows_data(traffic, geom, seed, i,
                                           meta["intercept"], cdfs)
        out.append((make_block(keys, labels, geom["num_buckets"],
                               meta["cap"], meta["ovf_cap"], device),
                    labels))
    return out


def reference_run(config: dict, blocks: list, seed: int, device, plan: dict,
                  lower: bool = False, fault: str = "") -> dict:
    """The reference's readings of the steps ``plan`` names (``capture``,
    ``warm``, ``window``; see the module's docstring), in the form of
    ``program_readings``. ``blocks``: ``blocks_of``. ``lower``: the
    control's precision. ``fault``: a fault planted in every step of the
    reference put in the program's place: ``half_batch`` (the second half
    of each block left out and the rest weighted 2, the mean over the
    rest) or ``altered`` (every 100th row's label flipped where the block
    is produced)."""
    ref = reference_module(config).Reference(config, device, seed,
                                             Rounding(lower))
    cap, warm, window = plan["capture"], plan["warm"], plan["window"]
    steps = {"objv": [], "labels": [], "pos": 0, "neg": 0}
    win = {"objv": 0.0, "pos": 0, "neg": 0}
    before = None
    for i in range(warm + window):
        blk, labels = blocks[i % len(blocks)]
        if fault == "altered":
            labels = labels.copy()
            labels[::100] ^= 1
            blk = dataclasses.replace(blk, y=torch.from_numpy(
                labels.astype(np.float64)).to(device))
        elif fault == "half_batch":
            w = torch.zeros(blk.rows, dtype=torch.float64, device=device)
            w[:blk.rows // 2] = 2.0
            blk = dataclasses.replace(blk, weight=w)
        if i == cap:
            before = ref.leaves()
        r = ref.step(blk)
        if cap <= i < cap + STEPS:
            steps["objv"].append(r["objv"])
            steps["labels"].append(labels)
            steps["pos"] = steps["pos"] + r["pos"].cpu().numpy()
            steps["neg"] = steps["neg"] + r["neg"].cpu().numpy()
            if i == cap:
                steps["grad_norms"] = {k: norm(v)
                                       for k, v in r["grads"].items()}
            if i == cap + STEPS - 1:
                steps["change_norms"] = {k: norm(v, before[k])
                                         for k, v in ref.state.items()}
                before = None
        if i >= warm:
            win["objv"] += r["objv"]
            win["pos"] = win["pos"] + r["pos"].cpu().numpy()
            win["neg"] = win["neg"] + r["neg"].cpu().numpy()
        del r
    steps["auc"] = auc_from_hist(steps.pop("pos"), steps.pop("neg"))
    steps["window"] = {"objv": win["objv"],
                       "auc": auc_from_hist(win["pos"], win["neg"])}
    return steps


def _hist(row: np.ndarray):
    bins = (len(row) - 4) // 2
    return row[4:4 + bins], row[4 + bins:]


def program_readings(config: dict, cap, tap) -> dict:
    """The program's readings, from its captured steps
    (``program.Capture``) and the window's first metric window
    (``program.WindowTap``)."""
    rows = [r.numpy().astype(np.float64) for r in cap.rows]
    pos = sum(_hist(r)[0] for r in rows)
    neg = sum(_hist(r)[1] for r in rows)
    wr = tap.row()
    return {"objv": [float(r[0]) for r in rows],
            "grad_norms": cap.grad_norms, "change_norms": cap.change_norms,
            "labels": [lab.numpy() for lab in cap.labels],
            "auc": auc_from_hist(pos, neg) if rows else 0.0,
            "window": ({"objv": float(wr[0]), "auc": auc_from_hist(*_hist(wr))}
                       if wr is not None else None)}


def _worst_leaf(p: Dict[str, float], r: Dict[str, float],
                counted) -> float:
    med = median(r.values())
    gaps = [abs(p[k] - r[k]) / max(r[k], med, 1e-300) for k in counted]
    return max(gaps) if gaps else 0.0


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def numbers(config: dict, prog: dict, ref: dict, window: dict) -> dict:
    """Every compared number, by name."""
    mod = reference_module(config)
    objv = [_rel(a, b) for a, b in zip(prog["objv"], ref["objv"])]
    g_p, g_r = prog["grad_norms"], ref["grad_norms"]
    g_med = median(g_r.values())
    live = {k for k in mod.GRAD_LEAVES if g_r[k] >= 1e-3 * g_med}
    d_p, d_r = prog["change_norms"], ref["change_norms"]
    counted = [k for k, g in mod.CHANGE_LEAVES.items() if g in live]
    order = sum(int(np.count_nonzero(np.minimum(a, 1) != b))
                if a.shape == b.shape else len(b)
                for a, b in zip(prog["labels"], ref["labels"]))
    order += sum(len(b) for b in ref["labels"][len(prog["labels"]):])
    wp, wr = prog["window"], ref["window"]
    return {"loss_gap": max(objv) if len(objv) == STEPS else 1.0,
            "grad_gap": (_worst_leaf(g_p, g_r, sorted(live))
                         if set(g_p) >= live else 1.0),
            "change_gap": (_worst_leaf(d_p, d_r, counted)
                           if set(d_p) >= set(counted) else 1.0),
            "auc_gap": abs(prog["auc"] - ref["auc"]),
            "order_rows": float(order),
            "window_loss_gap": _rel(wp["objv"], wr["objv"]) if wp else 1.0,
            "window_auc_gap": abs(wp["auc"] - wr["auc"]) if wp else 1.0,
            "examples_missing": float(abs(window["reported"]
                                          - window["expected"]))}


def verdict(nums: dict, limits: dict):
    """(correct, checks): each number beside its limit, in a fixed
    order."""
    checks = {k: {"value": float(nums[k]), "limit": float(limits[k])}
              for k in nums}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
