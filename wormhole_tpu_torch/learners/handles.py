"""Per-key online update rules — the "server handles".

The counterpart of ``wormhole_tpu/learners/handles.py`` (reference
``learn/linear/sgd/sgd_server_handle.h``). One difference of layout: the JAX
handles work on a ``(k, val_len)`` slot matrix; the port keeps the slots
plane-major, ``(val_len, k)``, so the weight plane ``slots[0]`` is one
contiguous vector that the forward kernel reads as it is.

FTRL is ported whole: ``init``, ``weights``, ``warm_start`` and the update
rule. ``update`` is the plain torch slot math; ``push`` applies it to the
table IN PLACE (one table, not the JAX package's functional copy) and
returns Σ(w' - w)². On a CUDA table ``push`` launches the ``__device__`` twin
of ``update`` (``csrc/tile_math.cuh``), the same code the fused train step
runs in its epilogue. The other algorithms come with a later slice
(ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from wormhole_tpu_torch.ops.penalty import L1L2


@dataclass(frozen=True)
class LearnRate:
    """eta_t = alpha / (beta + √t-ish) (config.proto lr_eta/lr_beta)."""
    alpha: float = 0.1
    beta: float = 1.0


@dataclass(frozen=True)
class Handle:
    """Base: slot plane 0 is always w (set_sync_val_len(1) semantics)."""

    penalty: L1L2 = L1L2()
    lr: LearnRate = LearnRate()

    val_len: int = 1

    def init(self, num_keys: int, device=None) -> torch.Tensor:
        return torch.zeros((self.val_len, num_keys), dtype=torch.float32,
                           device=device)

    def weights(self, slots: torch.Tensor) -> torch.Tensor:
        """Pull: the weight plane (a view, contiguous for a contiguous
        plane-major table)."""
        return slots[0]

    def push(self, slots: torch.Tensor, grad: torch.Tensor, t=None,
             tau=None) -> torch.Tensor:
        """Apply a (k,) gradient to the (val_len, k) f32 slots in place;
        returns Σ(w' - w)² as a 0-d f32 tensor."""
        raise NotImplementedError

    def warm_start(self, w: torch.Tensor) -> torch.Tensor:
        """Slots that make ``w`` a fixed point of a zero-gradient push
        (model_in warm start, linear.cc:115-123): w in plane 0,
        accumulators zeroed."""
        slots = torch.zeros((self.val_len,) + tuple(w.shape),
                            dtype=torch.float32, device=w.device)
        slots[0] = w
        return slots


@dataclass(frozen=True)
class FTRLHandle(Handle):
    """FTRL-proximal (sgd_server_handle.h:111-141), slots [w, z, √Σg²]:
    z accumulates g − σ·w and w = prox(−z) with curvature (β+cg)/α."""

    val_len: int = 3

    def update(self, w, z, cg, grad):
        """The elementwise slot math on unstacked planes
        (wormhole_tpu/learners/handles.py:108): cg' = √(cg² + g²),
        σ = (cg' − cg)/α, z' = (z + g) − σ·w, w' = prox(−z') with
        curvature (β + cg')/α. Returns (w', z', cg')."""
        cg_new = torch.sqrt(cg * cg + grad * grad)
        sigma = (cg_new - cg) / self.lr.alpha
        z_new = (z + grad) - sigma * w
        w_new = self.penalty.solve(
            -z_new, (self.lr.beta + cg_new) / self.lr.alpha)
        return w_new, z_new, cg_new

    def push(self, slots, grad, t=None, tau=None):
        """FTRL ignores the clock and the staleness (``t``, ``tau``)."""
        from wormhole_tpu_torch.ops.tilemm import ftrl_push
        return ftrl_push(slots, grad, self)

    def warm_start(self, w: torch.Tensor) -> torch.Tensor:
        """FTRL derives w from z (w = prox(−z)), so a warm start seeds z
        with the value whose prox is w. With cg=0: prox(−z) =
        shrink(−z, λ1)/(β/α + λ2), so z = −(w·(β/α + λ2) + λ1·sign(w))."""
        p = self.penalty
        z = -(w * (self.lr.beta / self.lr.alpha + p.lambda2)
              + p.lambda1 * torch.sign(w))
        return torch.stack([w, z, torch.zeros_like(w)])


_HANDLES = {"ftrl": FTRLHandle}
_NOT_PORTED = ("sgd", "adagrad", "dt_sgd", "dt_adagrad", "dt2_adagrad")


def create_handle(algo: str, penalty: L1L2 = L1L2(),
                  lr: LearnRate = LearnRate()) -> Handle:
    """Runtime handle dispatch (AsyncSGDServer::InitHandle,
    async_sgd.h:189-231)."""
    key = algo.lower() if isinstance(algo, str) else algo.value
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"algo {key!r} is not ported to the PyTorch package yet; only "
            "ftrl is (see ROADMAP.md for the slice that brings the others)")
    if key not in _HANDLES:
        raise ValueError(f"unknown algo {algo!r}; have "
                         f"{sorted(set(_HANDLES) | set(_NOT_PORTED))}")
    return _HANDLES[key](penalty=penalty, lr=lr)
