"""Progress metrics.

A copy of the part of ``wormhole_tpu/utils/progress.py`` the port uses: the
fixed-layout mergeable ``Progress`` POD (reference ``monitor.h:11-82``), its
display row, and the rate-limited ``TimeReporter`` (``dist_monitor.h:8-38``)
that drives the training display. The slot layout is identical to the JAX
package's, so the two compare slot by slot.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

_NF = 10  # float slots
_NI = 10  # int slots

_F_SLOTS = ["objv", "acc", "auc", "objv_w", "wdelta2", "feed_stall",
            "gbdt_hist", "gbdt_chunk_stall"]
_I_SLOTS = ["count", "num_ex", "nnz_w", "nnz_delta", "new_ex",
            "feed_batches"]


@dataclass
class Progress:
    """Fixed-layout mergeable metric vector: ``fvec``/``ivec`` always have
    length 10 each and Merge is a vector add — the reference POD's
    contract."""

    fvec: np.ndarray = field(default_factory=lambda: np.zeros(_NF, np.float64))
    ivec: np.ndarray = field(default_factory=lambda: np.zeros(_NI, np.int64))

    def _fget(self, name: str) -> float:
        return float(self.fvec[_F_SLOTS.index(name)])

    def _fset(self, name: str, v: float) -> None:
        self.fvec[_F_SLOTS.index(name)] = v

    def _iget(self, name: str) -> int:
        return int(self.ivec[_I_SLOTS.index(name)])

    def _iset(self, name: str, v: int) -> None:
        self.ivec[_I_SLOTS.index(name)] = v

    objv = property(lambda s: s._fget("objv"), lambda s, v: s._fset("objv", v))
    acc = property(lambda s: s._fget("acc"), lambda s, v: s._fset("acc", v))
    auc = property(lambda s: s._fget("auc"), lambda s, v: s._fset("auc", v))
    count = property(lambda s: s._iget("count"), lambda s, v: s._iset("count", v))
    num_ex = property(lambda s: s._iget("num_ex"), lambda s, v: s._iset("num_ex", v))
    wdelta2 = property(lambda s: s._fget("wdelta2"),
                       lambda s, v: s._fset("wdelta2", v))
    nnz_w = property(lambda s: s._iget("nnz_w"), lambda s, v: s._iset("nnz_w", v))
    feed_stall = property(lambda s: s._fget("feed_stall"),
                          lambda s, v: s._fset("feed_stall", v))
    feed_batches = property(lambda s: s._iget("feed_batches"),
                            lambda s, v: s._iset("feed_batches", v))

    def merge(self, other: "Progress") -> "Progress":
        self.fvec += other.fvec
        self.ivec += other.ivec
        return self

    def empty(self) -> bool:
        return self.num_ex == 0 and self.count == 0

    # --- display (reference scheduler progress row, async_sgd.h:306-320) ---
    HEADER = "  sec  #example delta #ex    |w|_0       logloss     AUC    accuracy"

    def print_row(self, elapsed: float, prev_num_ex: int = 0) -> str:
        n = max(self.num_ex, 1)
        return (f"{elapsed:5.0f}  {self.num_ex:.2e}  {self.num_ex - prev_num_ex:.2e}"
                f"  {self.nnz_w:.2e}  {self.objv / n:10.6f}  {self.auc / max(self.count, 1):.6f}"
                f"  {self.acc / max(self.count, 1):.6f}")


class TimeReporter:
    """Rate-limits metric reports (``dist_monitor.h:8-38``): ``report``
    calls ``report_fn`` at most once per ``interval`` seconds (the first
    call fires at once) and skips an empty Progress."""

    def __init__(self, report_fn: Callable[[Progress], None],
                 interval: float = 1.0) -> None:
        self._fn = report_fn
        self._itv = interval
        self._last = 0.0

    def due(self) -> bool:
        """Whether the next ``report`` call would fire."""
        return time.monotonic() - self._last >= self._itv

    def report(self, prog: Progress) -> bool:
        now = time.monotonic()
        if now - self._last < self._itv:
            return False
        if not prog.empty():
            self._fn(prog)
        self._last = now
        return True
