"""Small versions of the benchmark's cells for its tests: the same
configuration and traffic files at 2^15 buckets (on the CPU) or 2^22 (on
the card, whose kernels take a tile's capacity up to the flagship's), one
8,192-row subblock a block and four blocks, and a traffic whose hot key
makes every block spill (~1,700 pairs at 2^15: a few MB of the program's
spill scratch)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
NB = 1 << 15
NB_CARD = 1 << 22

SPILL_TRAFFIC = {
    "why": "three uniform keys and one constant key a row: the constant "
           "key's bucket takes every row, so its tile spills",
    "fields": [{"kind": "uniform32", "count": 3},
               {"kind": "zipf", "cardinality": 1, "exponent": 1.0}],
    "missing": 0.1,
    "label": {"weight_sd": 0.3, "positive_rate": 0.032},
    "blocks": 4,
    "cache_device": True,
}


def bench() -> dict:
    return json.loads((HERE.parent / "BENCHMARK.json").read_text())


def cell(name: str, spill: bool = False, nb: int = NB):
    """(config, traffic) of cell ``name`` at the small size."""
    b = bench()
    w = next(x for x in b["workloads"] if x["name"] == name)
    cfg = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    tr = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["data"] = {"num_buckets": nb, "subblocks": 1}
    cfg["app"]["num_buckets"] = str(nb)
    if spill:
        tr = dict(SPILL_TRAFFIC, cache_device=tr["cache_device"])
    else:
        tr = dict(tr, blocks=4)
    return cfg, tr
