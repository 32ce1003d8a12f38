"""The fused FM step (``wh_fm_step``): the pulls of [w, v_1..v_k, sum v^2]
to each row, the boundary (margin and dual), and the pushes [dual,
dual*s_1..dual*s_k, mask] to each bucket.

Bytes: each real pair word (4 B) and spill pair (8 B) once, each row's u8
label once, each touched bucket's k+2 pull values read once and its k+2
push values written once (8(k+2) B). Operations: k+2 adds a pair for the
pull and again for the push, and about 3k+10 a row for the boundary."""

from __future__ import annotations

from portbench.roofline import mean_block


def count(config: dict, meta: dict) -> dict:
    k = int(config["model"]["dim"])
    m = mean_block(meta)
    pairs = m["pairs"]
    return {"bytes": 4 * (pairs - m["spill"]) + 8 * m["spill"] + m["rows"]
            + 8 * (k + 2) * m["touched"],
            "flops": 2 * (k + 2) * pairs + (3 * k + 10) * m["rows"]}
