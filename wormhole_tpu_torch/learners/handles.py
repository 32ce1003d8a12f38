"""Per-key online update rules — the "server handles".

The counterpart of ``wormhole_tpu/learners/handles.py`` (reference
``learn/linear/sgd/sgd_server_handle.h`` and ``delay_tol_handle.h``). One
difference of layout: the JAX handles work on a ``(k, val_len)`` slot
matrix; the port keeps the slots plane-major, ``(val_len, k)``, so the
weight plane ``slots[0]`` is one contiguous vector that the forward kernel
reads as it is. Slot layouts match the JAX package's:

- SGD      [w]                      (sgd_server_handle.h:43-68)
- AdaGrad  [w, √Σg²]                (sgd_server_handle.h:80-99)
- FTRL     [w, z, √Σg²]             (sgd_server_handle.h:111-141)
- DT-SGD / DT-AdaGrad: the learning-rate denominator inflated by the
  staleness τ (delay_tol_handle.h:141-194)
- DT2-AdaGrad [w, gsum, cg2, cg2max]: the accumulator corrected by the
  cross-term of the gradient mass applied between a batch's pull and its
  push, from the pull-time ``gsum`` snapshot (delay_tol_handle.h:20-111)

``apply(rows, grad, t, tau)`` is the update rule as plain torch math on
plane-major rows, returning the new rows; the sparse path runs it on a
batch's gathered ``(val_len, kpad)`` rows. ``push`` applies it to a whole
table IN PLACE (one table, not the JAX package's functional copy) and
returns Σ(w' - w)²; FTRL's ``push`` launches on a CUDA table the
``__device__`` twin of its update (``csrc/tile_math.cuh``), the same code the
fused train step runs in its epilogue. The operations are the JAX handles'
in the same order, each rounded to f32 once, as IEEE has it: a division by
a scalar divides by a 0-d tensor on the slots' device (torch computes
``tensor / float`` on CUDA and ``float / tensor`` everywhere as a product
with a reciprocal, which rounds twice), and a square root is ``sqrt_rn``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from wormhole_tpu_torch.ops.penalty import L1L2


def scalar_like(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d f32 tensor on ``like``'s device (no host sync)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root. CUDA's ``sqrtf`` is; torch's
    vectorized CPU ``sqrt`` is not (an ulp off on some inputs), so on the
    CPU it is taken in f64 and rounded once to f32, which is exact for a
    square root of an f32 (53 ≥ 2·24 + 2 bits)."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


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

    def apply(self, rows: torch.Tensor, grad: torch.Tensor, t=None,
              tau=None, gsum_snap=None) -> torch.Tensor:
        """The new (val_len, k) f32 rows after a (k,) gradient, at step
        clock ``t`` and staleness ``tau`` (floats; each handle reads what
        its rule needs)."""
        raise NotImplementedError

    def push(self, slots: torch.Tensor, grad: torch.Tensor, t=None,
             tau=None) -> torch.Tensor:
        """Apply a (k,) gradient to the (val_len, k) f32 slots in place;
        returns Σ(w' - w)² as a 0-d f32 tensor."""
        new = self.apply(slots, grad, t, tau)
        d0 = new[0] - slots[0]
        wdelta2 = torch.sum(d0 * d0)
        slots.copy_(new)
        return wdelta2

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
        alpha = scalar_like(self.lr.alpha, grad)
        cg_new = sqrt_rn(cg * cg + grad * grad)
        sigma = (cg_new - cg) / alpha
        z_new = (z + grad) - sigma * w
        w_new = self.penalty.solve(-z_new, (self.lr.beta + cg_new) / alpha)
        return w_new, z_new, cg_new

    def apply(self, rows, grad, t=None, tau=None, gsum_snap=None):
        return torch.stack(self.update(rows[0], rows[1], rows[2], grad))

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


def _eta_div(alpha: float, denom: torch.Tensor):
    """(η, 1/η) for η = α / denom, each one f32 division."""
    eta = scalar_like(alpha, denom) / denom
    return eta, scalar_like(1.0, denom) / eta


@dataclass(frozen=True)
class SGDHandle(Handle):
    """w ← prox(w/η − g) with η = α/(β+√t) (sgd_server_handle.h:43-68)."""

    val_len: int = 1

    def apply(self, rows, grad, t=None, tau=None, gsum_snap=None):
        eta, inv = _eta_div(self.lr.alpha,
                            self.lr.beta + sqrt_rn(scalar_like(t, grad)))
        return self.penalty.solve(rows[0] / eta - grad, inv)[None]


@dataclass(frozen=True)
class AdaGradHandle(Handle):
    """Per-key curvature: cg ← √(cg²+g²); η = α/(β+cg)
    (sgd_server_handle.h:80-99)."""

    val_len: int = 2

    def apply(self, rows, grad, t=None, tau=None, gsum_snap=None):
        w, cg = rows[0], rows[1]
        cg_new = sqrt_rn(cg * cg + grad * grad)
        eta, inv = _eta_div(self.lr.alpha, self.lr.beta + cg_new)
        return torch.stack([self.penalty.solve(w / eta - grad, inv),
                            cg_new])


@dataclass(frozen=True)
class DTSGDHandle(Handle):
    """Staleness-inflated SGD: η = α/(β+√t+τ) (delay_tol_handle.h:141-166;
    the caller folds the lr_theta weight into τ)."""

    val_len: int = 1

    def apply(self, rows, grad, t=None, tau=None, gsum_snap=None):
        eta, inv = _eta_div(
            self.lr.alpha,
            self.lr.beta + sqrt_rn(scalar_like(t, grad)) + float(tau))
        return self.penalty.solve(rows[0] / eta - grad, inv)[None]


@dataclass(frozen=True)
class DTAdaGradHandle(Handle):
    """AdaGrad with τ added to the denominator (delay_tol_handle.h:168-194)."""

    val_len: int = 2

    def apply(self, rows, grad, t=None, tau=None, gsum_snap=None):
        w, cg = rows[0], rows[1]
        cg_new = sqrt_rn(cg * cg + grad * grad)
        eta, inv = _eta_div(self.lr.alpha,
                            self.lr.beta + cg_new + float(tau))
        return torch.stack([self.penalty.solve(w / eta - grad, inv),
                            cg_new])


@dataclass(frozen=True)
class DT2AdaGradHandle(Handle):
    """Delay-compensated AdaGrad (DTAdaGradHandle2,
    delay_tol_handle.h:20-111), slots [w, gsum, cg2, cg2max]. The sparse
    path's ``dt2_pull`` snapshots each key's cumulative gradient ``gsum``
    with the in-flight batch; at the push, ``gbak = gsum_now − snapshot``
    is the mass other batches applied in between, and the update corrects
    the accumulator by the cross-term 2·g·gbak plus a weight term for the
    learning-rate shift. Without a snapshot (the tile steps, which have no
    pull→push gap) gbak is 0 and the rule is plain AdaGrad."""

    val_len: int = 4

    def apply(self, rows, grad, t=None, tau=None, gsum_snap=None):
        w, gsum, cg2, cg2max = rows[0], rows[1], rows[2], rows[3]
        gbak = (gsum - gsum_snap if gsum_snap is not None
                else torch.zeros_like(grad))
        alpha = scalar_like(self.lr.alpha, grad)
        cg2_new = cg2 + grad * grad + 2.0 * grad * gbak
        # the reference's divisor form of eta: sqrt(cg2max + beta) / alpha
        d_old = sqrt_rn(cg2max + self.lr.beta) / alpha
        cg2max_new = torch.maximum(cg2max, cg2_new)
        d = sqrt_rn(cg2max_new + self.lr.beta) / alpha
        # the first push with lr_beta=0 has d_old=0; gbak is 0 there, so
        # the correction is defined as 0 (guards the 0*inf)
        corr = torch.where(d_old > 0.0, gbak * (d / d_old - 1.0),
                           torch.zeros_like(grad))
        w_new = self.penalty.solve(d * w - grad + corr, d)
        return torch.stack([w_new, gsum + grad, cg2_new, cg2max_new])


_HANDLES = {
    "sgd": SGDHandle,
    "adagrad": AdaGradHandle,
    "ftrl": FTRLHandle,
    "dt_sgd": DTSGDHandle,
    "dt_adagrad": DTAdaGradHandle,
    "dt2_adagrad": DT2AdaGradHandle,
}


def create_handle(algo: str, penalty: L1L2 = L1L2(),
                  lr: LearnRate = LearnRate()) -> Handle:
    """Runtime handle dispatch (AsyncSGDServer::InitHandle,
    async_sgd.h:189-231)."""
    key = algo.lower() if isinstance(algo, str) else algo.value
    if key not in _HANDLES:
        raise ValueError(f"unknown algo {algo!r}; have {sorted(_HANDLES)}")
    return _HANDLES[key](penalty=penalty, lr=lr)
