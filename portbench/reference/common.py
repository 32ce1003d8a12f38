"""What the plain references share: the pair list of a block, the rounding
the configurations state, the logistic loss and the margin histogram."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench import crec2_frozen as cf


@dataclass
class Block:
    """One block's pairs as the program's crec2 file holds them: bucket and
    row of every real key (row-major order), whether the encoder spilled
    it, and the rows' 0/1 labels; besides, the block's distinct buckets
    and each pair's index among them."""
    b: torch.Tensor        # int64 (pairs,)
    r: torch.Tensor        # int64 (pairs,)
    spill: torch.Tensor    # bool (pairs,)
    y: torch.Tensor        # float64 (rows,) 0/1
    rows: int
    u: torch.Tensor        # int64 (touched,): the distinct buckets
    inv: torch.Tensor      # int64 (pairs,): b == u[inv]
    weight: torch.Tensor = None   # float64 (rows,): 1, or a fault's weights


def make_block(keys: np.ndarray, labels: np.ndarray, nb: int, cap: int,
               ovf_cap: int, device) -> Block:
    """The block of a (rows, nnz) key grid. With ``ovf_cap`` 0 the file
    has no spill list, so no pair spilled."""
    b, r = cf.pairs_of(keys, nb)
    sp = (cf.spill_mask(b, r, nb, cap) if ovf_cap
          else np.zeros(len(b), bool))
    bt = torch.from_numpy(b).to(device)
    u, inv = torch.unique(bt, return_inverse=True)
    return Block(bt, torch.from_numpy(r).to(device),
                 torch.from_numpy(sp).to(device),
                 torch.from_numpy(labels.astype(np.float64)).to(device),
                 int(keys.shape[0]), u, inv)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class Rounding:
    """The reference's precision: float64 throughout (``lower=False``), or
    the control's, every stage that the configuration states in float32
    rounded to bfloat16 (``lower=True``). The bfloat16 rounding that the
    configuration itself states (pulled and pushed values of tile pairs)
    is applied in both."""

    def __init__(self, lower: bool = False):
        self.lower = lower

    def stage(self, x: torch.Tensor) -> torch.Tensor:
        return bf16(x) if self.lower else x

    @staticmethod
    def tile_pairs(x: torch.Tensor, spill: torch.Tensor) -> torch.Tensor:
        """bf16 at tile pairs, as stated; spill pairs keep their value."""
        sp = spill if x.dim() == 1 else spill[:, None]
        return torch.where(sp, x, bf16(x))


CHUNK = 1 << 24


def norm(x: torch.Tensor, y: torch.Tensor = None) -> float:
    """The float64 2-norm of ``x`` (of ``x - y`` when ``y`` is given), on
    their device, a block of rows at a time, so a leaf of the table needs
    no float64 copy of its own."""
    tot = 0.0
    for i in range(0, x.shape[0], CHUNK):
        d = x[i:i + CHUNK].to(torch.float64)
        if y is not None:
            d = d - y[i:i + CHUNK].to(torch.float64)
        tot += float(torch.sum(d * d))
    return tot ** 0.5


def grown_norm(after: torch.Tensor, before: torch.Tensor) -> float:
    """The 2-norm of g where ``after`` = sqrt(``before``^2 + g^2): the
    gradient that an accumulator of root sums of squares took in, in
    float64, a block of rows at a time."""
    tot = 0.0
    for i in range(0, after.shape[0], CHUNK):
        a = after[i:i + CHUNK].to(torch.float64)
        b = before[i:i + CHUNK].to(torch.float64)
        tot += float(torch.sum(torch.clamp(a * a - b * b, min=0.0)))
    return tot ** 0.5


def logit(m: torch.Tensor, y: torch.Tensor, weight=None):
    """(objv sum, dual) of the logistic loss, labels 0/1, rows weighted by
    ``weight`` (1 where None)."""
    s = 2.0 * y - 1.0
    ym = s * m
    loss = torch.clamp(-ym, min=0.0) + torch.log1p(torch.exp(-ym.abs()))
    dual = -s * torch.sigmoid(-ym)
    if weight is not None:
        loss, dual = loss * weight, dual * weight
    return torch.sum(loss), dual


def margin_hist(m: torch.Tensor, y: torch.Tensor, bins: int = 512,
                lo: float = -14.0, hi: float = 14.0):
    """(pos, neg) counts of margins in ``bins`` bins over [lo, hi]."""
    i = (torch.clamp((m - lo) / (hi - lo), 0.0, 1.0) * (bins - 1)).to(
        torch.int64)
    pos = torch.zeros(bins, dtype=torch.float64, device=m.device)
    pos.index_add_(0, i, (y > 0.5).to(torch.float64))
    neg = torch.bincount(i, minlength=bins).to(torch.float64) - pos
    return pos, neg


def auc_from_hist(pos: np.ndarray, neg: np.ndarray) -> float:
    pos = np.asarray(pos, np.float64)
    neg = np.asarray(neg, np.float64)
    cumneg = np.cumsum(neg) - neg
    wp, wn = pos.sum(), neg.sum()
    if wp <= 0 or wn <= 0:
        return 0.5
    return float(np.sum(pos * (cumneg + 0.5 * neg)) / (wp * wn))
