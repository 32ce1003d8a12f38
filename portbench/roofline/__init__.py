"""Operation and byte counts of one step, from the generator's own
statistics of the data (real pair words, spill pairs, rows, touched
buckets), never from the program. Each module's ``count(config, meta)``
returns the mean over the file's blocks of {"bytes": ..., "flops": ...}:
what the step needs, each input byte read once and each output byte
written once. Pad words and full-table sweeps are not counted."""

from __future__ import annotations


def mean_block(meta: dict) -> dict:
    blocks = meta["blocks"]
    n = len(blocks)
    return {k: sum(b[k] for b in blocks) / n
            for k in ("rows", "pairs", "spill", "touched")}


def least_seconds(c: dict, peaks: dict) -> float:
    """The least time the chip needs for a count at its published peaks."""
    return max(c["bytes"] / peaks["hbm_bytes_per_s"],
               c["flops"] / peaks["fp32_flops_per_s"])
