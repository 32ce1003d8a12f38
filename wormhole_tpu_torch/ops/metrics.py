"""Evaluation metrics: sort-based AUC, thresholded accuracy, margin
histograms.

The counterpart of ``wormhole_tpu/ops/metrics.py`` (reference
``learn/linear/base/evaluation.h:38-88``): the device-side pieces take a row
mask for padded rows; ``auc_from_hist`` and ``auc_np`` run on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def auc(labels: torch.Tensor, margin: torch.Tensor,
        mask: torch.Tensor) -> torch.Tensor:
    """Per-minibatch AUC via the weighted Mann-Whitney statistic, as the
    JAX ``auc``: ``mask`` doubles as the row weight, masked rows sort first
    at -inf, ties keep their row order (a stable argsort), and an empty
    class gives 0.5."""
    pos_w = (labels > 0.5).to(torch.float32) * mask
    neg_w = mask - pos_w
    key = torch.where(mask > 0, margin, torch.full_like(margin, -torch.inf))
    order = torch.argsort(key, stable=True)
    spos, sneg = pos_w[order], neg_w[order]
    cumneg = torch.cumsum(sneg, 0) - sneg    # negative weight ranked below
    wpos, wneg = torch.sum(pos_w), torch.sum(neg_w)
    a = torch.sum(spos * cumneg) / torch.clamp(wpos * wneg, min=1e-30)
    return torch.where((wpos > 0) & (wneg > 0), a, torch.full_like(a, 0.5))


def accuracy(labels: torch.Tensor, margin: torch.Tensor, mask: torch.Tensor,
             threshold: float = 0.0) -> torch.Tensor:
    """Fraction of rows where sign(margin - threshold) matches the label."""
    pred = (margin > threshold).to(torch.float32)
    truth = (labels > 0.5).to(torch.float32)
    correct = torch.sum((pred == truth).to(torch.float32) * mask)
    return correct / torch.clamp(torch.sum(mask), min=1.0)


def margin_hist(labels: torch.Tensor, margin: torch.Tensor,
                mask: torch.Tensor, bins: int = 512, lo: float = -14.0,
                hi: float = 14.0) -> tuple:
    """Device-side (pos, neg) margin histograms for streaming AUC: margins
    clipped to [lo, hi] and cut into ``bins`` bins. Histograms merge across
    blocks by summing. With 0/1 row weights (the tile path's mask) the
    counts are exact integers below 2^24, so the scatter's summation order
    cannot change them."""
    b = (torch.clamp((margin - lo) / (hi - lo), 0.0, 1.0)
         * (bins - 1)).to(torch.int64)
    pos_w = (labels > 0.5).to(torch.float32) * mask
    neg_w = mask - pos_w
    zeros = torch.zeros(bins, dtype=torch.float32, device=margin.device)
    return zeros.index_add(0, b, pos_w), zeros.index_add(0, b, neg_w)


def auc_from_hist(pos, neg) -> float:
    """Host AUC from (pos, neg) margin histograms; ties within a bin
    count 1/2 (the trapezoid correction)."""
    pos = np.asarray(pos, np.float64)
    neg = np.asarray(neg, np.float64)
    cumneg = np.cumsum(neg) - neg
    wp, wn = pos.sum(), neg.sum()
    if wp <= 0 or wn <= 0:
        return 0.5
    return float(np.sum(pos * (cumneg + 0.5 * neg)) / (wp * wn))


def auc_np(labels, margin, weights=None) -> float:
    """Host pooled AUC over a full eval pass (the reference evaluates AUC
    on the complete eval output, evaluation.h:38-68)."""
    labels = np.asarray(labels, np.float64)
    margin = np.asarray(margin, np.float64)
    w = np.ones_like(labels) if weights is None else np.asarray(
        weights, np.float64)
    pos_w = (labels > 0.5) * w
    neg_w = w - pos_w
    order = np.argsort(margin, kind="stable")
    spos, sneg = pos_w[order], neg_w[order]
    cumneg = np.cumsum(sneg) - sneg
    wp, wn = pos_w.sum(), neg_w.sum()
    if wp <= 0 or wn <= 0:
        return 0.5
    return float(np.sum(spos * cumneg) / (wp * wn))
