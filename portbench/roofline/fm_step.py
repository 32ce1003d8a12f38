"""The whole FM train step: the fused step's pairs and rows, and each
touched bucket's row [w, v, cg_w, cg_v] (2(1+k) f32) read once and written
once by the AdaGrad update. Operations: the fused step's, and about 10 a
value of a touched row for the update."""

from __future__ import annotations

from portbench.roofline import mean_block


def count(config: dict, meta: dict) -> dict:
    k = int(config["model"]["dim"])
    m = mean_block(meta)
    pairs = m["pairs"]
    return {"bytes": 4 * (pairs - m["spill"]) + 8 * m["spill"] + m["rows"]
            + 2 * 4 * 2 * (1 + k) * m["touched"],
            "flops": 2 * (k + 2) * pairs + (3 * k + 10) * m["rows"]
            + 10 * (1 + k) * m["touched"]}
