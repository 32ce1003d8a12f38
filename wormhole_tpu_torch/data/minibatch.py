"""Minibatch iterator: background-thread parsing + fixed-size re-slicing.

A copy of ``wormhole_tpu/data/minibatch.py``. Rebuild of the reference
``MinibatchIter`` (``learn/linear/base/minibatch_iter.h:26-111``): wraps a
format-specific chunk parser running in a prefetch thread (the reference's
``ThreadedParser``, minibatch_iter.h:50) and re-slices the variable-size
parsed RowBlocks into exact ``minibatch_size`` batches. Tracks BytesRead for
throughput reporting.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

from wormhole_tpu_torch.data.input_split import InputSplit
from wormhole_tpu_torch.data.parsers import iter_blocks
from wormhole_tpu_torch.data.recordio import RecordStream, iter_record_blocks
from wormhole_tpu_torch.data.rowblock import RowBlock, RowBlockContainer

_SENTINEL = object()


class MinibatchIter:
    """Iterate fixed-size RowBlock minibatches over part k/n of a uri."""

    def __init__(self, uri: str, part: int = 0, nparts: int = 1,
                 data_format: str = "libsvm", minibatch_size: int = 1000,
                 prefetch: int = 4, drop_tail: bool = False) -> None:
        self.uri = uri
        self.part, self.nparts = part, nparts
        self.data_format = data_format.lower()
        self.minibatch_size = minibatch_size
        self.prefetch = prefetch
        self.drop_tail = drop_tail
        self._source = None  # set per-pass

    def _make_block_iter(self) -> Iterator[RowBlock]:
        if self.data_format in ("criteo_rec", "adfea_rec", "rec", "recordio"):
            self._source = RecordStream(self.uri, self.part, self.nparts)
            return iter_record_blocks(self._source)
        self._source = InputSplit(self.uri, self.part, self.nparts,
                                  split_type="text")
        return iter_blocks(self._source, self.data_format)

    def bytes_read(self) -> int:
        return self._source.bytes_read() if self._source is not None else 0

    def _producer(self, q: "queue.Queue", stop: threading.Event) -> None:
        def put(item) -> bool:
            # bounded-queue put that gives up when the consumer abandoned
            # the generator — otherwise the thread (and its open file)
            # would be pinned forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for blk in self._make_block_iter():
                if not put(blk):
                    return
        except BaseException as e:  # surfaced in consumer
            put(e)
            return
        put(_SENTINEL)

    def __iter__(self) -> Iterator[RowBlock]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._producer, args=(q, stop),
                             daemon=True)
        t.start()
        try:
            yield from self._consume(q, t)
        finally:
            stop.set()

    def _consume(self, q: "queue.Queue",
                 t: threading.Thread) -> Iterator[RowBlock]:
        mb = self.minibatch_size
        carry: Optional[RowBlock] = None

        def slices_of(blk: RowBlock):
            """Split blk into mb-row slices, returning (full_slices, tail)."""
            out = []
            pos = 0
            while blk.size - pos >= mb:
                out.append(blk.slice(pos, pos + mb))
                pos += mb
            return out, (blk.slice(pos, blk.size) if pos < blk.size else None)

        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            if item is _SENTINEL:
                break
            blk: RowBlock = item
            if carry is not None:
                # merge carry + new block, then slice
                c = RowBlockContainer()
                c.extend_block(carry)
                c.extend_block(blk)
                blk = c.finalize()
                carry = None
            full, carry = slices_of(blk)
            yield from full
        t.join()
        if carry is not None and not self.drop_tail:
            yield carry
