"""The fused FTRL train step (``wh_step_update``): forward, dual, backward
and the FTRL update of the touched buckets in one launch chain.

Bytes: each real pair word (4 B) and each spill pair (bucket and row, 8 B)
read once; each row's u8 label read once; each touched bucket's three f32
slots [w, z, n] read once and written once (24 B). Operations: an add per
pair into its row and one into its bucket, the dual (about 8 a row) and
the FTRL update (about 12 a touched bucket). The whole FTRL step
(``train_mfu``) counts the same: its metric row adds a few KiB."""

from __future__ import annotations

from portbench.roofline import mean_block


def count(config: dict, meta: dict) -> dict:
    m = mean_block(meta)
    pairs = m["pairs"]
    return {"bytes": 4 * (pairs - m["spill"]) + 8 * m["spill"] + m["rows"]
            + 24 * m["touched"],
            "flops": 2 * pairs + 8 * m["rows"] + 12 * m["touched"]}
