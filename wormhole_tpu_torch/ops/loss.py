"""Scalar losses over margins — objective values and dual gradients.

The counterpart of ``wormhole_tpu/ops/loss.py`` (reference
``learn/linear/base/loss.h``). Labels arrive as 0/1 floats and map to
y ∈ {-1, +1}; every function takes a row mask (padded rows contribute 0) and
returns sums, so results merge across blocks by a plain add.

These are the plain torch versions. On the card the duals run in CUDA:
``csrc/tile_math.cuh`` holds their ``__device__`` twins, which the fused
train step calls at its phase boundary and ``tilemm.loss_dual`` launches on
the split path. The JAX package guards some products with ``opaque_one`` so a
Pallas kernel and XLA contract them into FMAs alike (its fused/split
bit-parity contract); the port's kernels are built with ``--fmad=false``
(``ops/_ext.py``), which pins contraction in every kernel at once, so the
torch expressions here carry no guard.
"""

from __future__ import annotations

import torch


def _to_pm1(labels: torch.Tensor) -> torch.Tensor:
    return 2.0 * (labels > 0.5).to(labels.dtype) - 1.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) in the stable form jax.nn.softplus uses."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def logit_objv(margin, labels, mask):
    """Σ log(1 + exp(-y·m)) over real rows."""
    ym = _to_pm1(labels) * margin
    return torch.sum(_softplus(-ym) * mask)


def logit_dual(margin, labels, mask):
    """d objv / d margin = -y·σ(-y·m), masked."""
    y = _to_pm1(labels)
    return -y * torch.sigmoid(-y * margin) * mask


def hinge_objv(margin, labels, mask):
    """Σ max(0, 1 - y·m) over real rows."""
    t = torch.clamp(1.0 - _to_pm1(labels) * margin, min=0.0)
    return torch.sum(t * mask)


def hinge_dual(margin, labels, mask):
    """Subgradient: -y where the margin is violated, else 0."""
    y = _to_pm1(labels)
    active = (1.0 - y * margin > 0).to(margin.dtype)
    return -y * active * mask


def square_hinge_objv(margin, labels, mask):
    """Σ max(0, 1 - y·m)² over real rows."""
    t = torch.clamp(1.0 - _to_pm1(labels) * margin, min=0.0)
    return torch.sum(t * t * mask)


def square_hinge_dual(margin, labels, mask):
    y = _to_pm1(labels)
    t = torch.clamp(1.0 - y * margin, min=0.0)
    return -2.0 * y * t * mask


def square_objv(margin, labels, mask):
    d = margin - labels
    return 0.5 * torch.sum(d * d * mask)


def square_dual(margin, labels, mask):
    return (margin - labels) * mask


_LOSSES = {
    "logit": (logit_objv, logit_dual),
    "hinge": (hinge_objv, hinge_dual),
    "square_hinge": (square_hinge_objv, square_hinge_dual),
    "square": (square_objv, square_dual),
}


# the loss ids the CUDA kernels take (csrc/tile_math.cuh enum Loss)
LOSS_IDS = {"logit": 0, "hinge": 1, "square_hinge": 2, "square": 3}


def loss_key(name) -> str:
    """The lower-case loss name of a name or a ``Loss`` enum member."""
    key = name.lower() if isinstance(name, str) else name.value
    if key not in _LOSSES:
        raise ValueError(f"unknown loss {name!r}; have {sorted(_LOSSES)}")
    return key


def nudge_zero_dual(dual, labels, row_mask):
    """Replace exactly-zero duals of real rows with a signed 1e-30 so a
    saturated row still touches its buckets (the JAX store's
    ``_nudge_zero_dual``, wormhole_tpu/learners/store.py:117)."""
    eps = torch.where(labels > 0.5, -1e-30, 1e-30).to(dual.dtype)
    return torch.where((dual == 0.0) & (row_mask > 0), eps, dual)


def create_loss(name: str):
    """Factory (reference CreateLoss, loss.h:130-141): (objv_fn, dual_fn)."""
    return _LOSSES[loss_key(name)]
