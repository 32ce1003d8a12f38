"""Pull-only forward: margins and predictions from caller-owned params.

The counterpart of ``wormhole_tpu/serve/forward.py``. The training stores
run pull → forward → backward → push in one step; serving needs the first
half, against a model the caller owns. :class:`ForwardStep` closes over a
store's ``build_serve_margin`` — the margin function the store's
``eval_step`` runs, so serve and eval share one computation and give the
same bits — and returns ``(margin, prediction)`` for a ``SparseBatch``.
``params`` (``{"slots": ...}``, plus ``"mlp"`` for wide&deep) sits behind a
lock: :meth:`swap` replaces it between batches and refuses a replacement of
another structure, shape or dtype.

For crec2 tile blocks, :func:`tile_margins` runs the store's own tile eval
step. The admission front end, snapshots and the fleet come with the
serving slice (ROADMAP.md).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Tuple

import torch

__all__ = ["ForwardStep", "tile_margins"]


def _leaves(tree: Any, prefix: str = "") -> List[Tuple[str, tuple, str]]:
    """(path, shape, dtype) of every tensor of a nested dict, sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tuple(tree.shape), str(tree.dtype))]


class ForwardStep:
    """One pull-only forward shared by every serve consumer.

    ``margin_fn(params, batch) -> (mb,) margins`` comes from the store's
    ``build_serve_margin``; ``loss == "logit"`` adds the sigmoid (the
    reference's MarginToPred, linear.h), other losses serve the raw
    margin — as ``AsyncSGD._write_preds`` does."""

    def __init__(self, margin_fn: Callable[[Any, Any], torch.Tensor],
                 params: Any, loss: str = "logit") -> None:
        self._lock = threading.Lock()
        self._params = params  # guarded-by: _lock
        self._margin_fn = margin_fn
        self.loss = loss

    @classmethod
    def from_store(cls, store, loss: Optional[str] = None) -> "ForwardStep":
        """Build from any store with the serve surface
        (``build_serve_margin`` + ``serve_params``). The initial params
        alias the store's live tensors, which is right while training is
        quiescent (the offline predict pass)."""
        if loss is None:
            loss = getattr(getattr(store, "cfg", None), "loss", "logit")
            loss = getattr(loss, "value", loss)
        return cls(store.build_serve_margin(), store.serve_params(),
                   loss=str(loss))

    @property
    def params(self) -> Any:
        with self._lock:
            return self._params

    def swap(self, params: Any) -> None:
        """Replace the served model atomically: a batch sees the old model
        or the new one, never a mix. The structure, shapes and dtypes must
        equal the served model's."""
        cur, new = _leaves(self.params), _leaves(params)
        if cur != new:
            raise ValueError(f"swap mismatch: {new} vs served {cur}")
        with self._lock:
            self._params = params

    def __call__(self, batch):
        """(margin, pred) device tensors for one padded batch."""
        margin = self._margin_fn(self.params, batch)
        pred = torch.sigmoid(margin) if self.loss == "logit" else margin
        return margin, pred

    def margins(self, batch) -> torch.Tensor:
        return self._margin_fn(self.params, batch)


def tile_margins(store, params: Any, block: dict, info) -> torch.Tensor:
    """Margins (block_rows,) for one crec2 tile block against ``params``
    (as ``store.serve_params()`` returns them), through the store's own
    tile eval step. Exact for every row, masked or not: labels only feed
    the unused metric outputs."""
    step = store._tile_step(info, "eval")
    if "mlp" in params:
        return step(params["slots"], params["mlp"], block)[5]
    return step(params["slots"], block)[5]
