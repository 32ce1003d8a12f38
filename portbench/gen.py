"""The benchmark's one traffic generator: Criteo-shaped click rows from a
traffic file's parameters and ``--seed``, written as a crec2 file through
the frozen encoder (``crec2_frozen``).

A traffic file (``portbench/traffic/<name>.json``) lists the row's fields
in order, each a law of its own:

- ``{"kind": "uniform32", "count": n}``: n fields of uniform u32 keys (a
  hashed id of a high-cardinality field);
- ``{"kind": "zipf", "cardinality": n, "exponent": s}``: one categorical
  field whose value of rank i is drawn with weight 1/i^s;
- ``{"kind": "count", "p": p}``: one integer field whose value is a
  geometric count (values 0, 1, 2, ... with ratio 1 - p), keyed per
  (field, value) as the reference's criteo parser keys integers.

Every field but ``uniform32`` hashes (field salt, value) to its u32 key;
``missing`` is the share of slots left empty (the sentinel key). Labels are
Bernoulli of a logistic of a true weight per bucket (uniform, standard
deviation ``label.weight_sd``, a hash of the bucket and the seed) plus an
intercept that puts ``label.positive_rate`` of block 0's rows positive.
Each block draws from ``default_rng([seed, block])``, so any block can be
drawn again alone (the reference does) and every seed gives the same sizes.

``ovf_cap`` is the largest spill of the generated blocks rounded up to a
multiple of 1,024 (0 when no block spills), written into the header.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import shutil
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from portbench import crec2_frozen as cf

HERE = Path(__file__).resolve().parent
DATA = HERE / "_data"
# generation runs before the window, on all but two of the host's cores
WORKERS = max(1, min(6, (os.cpu_count() or 1) - 2))


def _salt(seed: int, field: int) -> np.uint32:
    return np.uint32(cf.mix32(np.array([(seed * 1000003 + field * 7919 + 17)
                                        & 0xFFFFFFFF], np.uint32))[0])


def _field_specs(traffic: dict):
    out = []
    for f in traffic["fields"]:
        out.extend([f] * int(f.get("count", 1)) if f["kind"] == "uniform32"
                   else [f])
    return out


def _zipf_cdf(n: int, s: float, cache: dict) -> np.ndarray:
    key = (n, s)
    if key not in cache:
        w = np.arange(1, n + 1, dtype=np.float64) ** -s
        c = np.cumsum(w)
        cache[key] = c / c[-1]
    return cache[key]


def block_keys(traffic: dict, seed: int, block: int, rows: int,
               cdfs: dict = None) -> np.ndarray:
    """The (rows, nnz) u32 key grid of one block (SENTINEL empties)."""
    cdfs = {} if cdfs is None else cdfs
    rng = np.random.default_rng([seed, block])
    specs = _field_specs(traffic)
    keys = np.empty((rows, len(specs)), np.uint32)
    for j, f in enumerate(specs):
        kind = f["kind"]
        if kind == "uniform32":
            keys[:, j] = rng.integers(0, 0xFFFFFFFF, size=rows,
                                      dtype=np.uint32)
            continue
        if kind == "zipf":
            cdf = _zipf_cdf(int(f["cardinality"]), float(f["exponent"]), cdfs)
            v = np.searchsorted(cdf, rng.random(rows), side="right")
        elif kind == "count":
            v = rng.geometric(float(f["p"]), rows) - 1
        else:
            raise ValueError(f"unknown field kind {kind!r}")
        keys[:, j] = cf.mix32(v.astype(np.uint32) ^ _salt(seed, j))
    keys[keys == cf.SENTINEL] = np.uint32(0xFFFFFFFE)
    keys[rng.random((rows, len(specs))) < float(traffic["missing"])] = \
        cf.SENTINEL
    return keys


def true_margins(keys: np.ndarray, nb: int, seed: int, sd: float
                 ) -> np.ndarray:
    """Each row's sum of the true bucket weights (float64)."""
    b, r = cf.pairs_of(keys, nb)
    u = cf.mix32(b.astype(np.uint32) ^ _salt(seed, 1 << 20)) / 2.0 ** 32
    w = (u - 0.5) * (sd * 12 ** 0.5)
    return np.bincount(r, weights=w, minlength=keys.shape[0])


def intercept(m: np.ndarray, rate: float) -> float:
    """The b with mean σ(b + m) = rate, by bisection."""
    lo, hi = -30.0, 30.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if np.mean(1 / (1 + np.exp(-(mid + m)))) < rate:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def block_labels(keys: np.ndarray, nb: int, seed: int, block: int,
                 label: dict, b0: float) -> np.ndarray:
    rng = np.random.default_rng([seed, block, 1])
    m = true_margins(keys, nb, seed, float(label["weight_sd"]))
    return (rng.random(keys.shape[0]) < 1 / (1 + np.exp(-(b0 + m)))
            ).astype(np.uint8)


def block_rows_data(traffic: dict, geom: dict, seed: int, block: int,
                    b0: float, cdfs: dict = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(keys, labels) of one block: the raw rows both sides are built
    from."""
    rows = geom["subblocks"] * cf.RSUB
    keys = block_keys(traffic, seed, block, rows, cdfs)
    return keys, block_labels(keys, geom["num_buckets"], seed, block,
                              traffic["label"], b0)


def first_intercept(traffic: dict, geom: dict, seed: int) -> float:
    rows = geom["subblocks"] * cf.RSUB
    keys = block_keys(traffic, seed, 0, rows)
    m = true_margins(keys, geom["num_buckets"], seed,
                     float(traffic["label"]["weight_sd"]))
    return intercept(m, float(traffic["label"]["positive_rate"]))


def _spill_of(args) -> int:
    """Pairs of one block past ``cap`` in their (subblock, tile) cell."""
    traffic, geom, seed, block, cap = args
    nb = geom["num_buckets"]
    keys = block_keys(traffic, seed, block, geom["subblocks"] * cf.RSUB)
    return cf.spill_count(*cf.pairs_of(keys, nb), nb, cap)


def _write_one(args) -> dict:
    """Encode one block and write it at its offset of ``path``; returns
    its statistics."""
    traffic, geom, seed, block, b0, cap, ovf_cap, path = args
    nb, sub = geom["num_buckets"], geom["subblocks"]
    keys, labels = block_rows_data(traffic, geom, seed, block, b0)
    b, r = cf.pairs_of(keys, nb)
    data = cf.block_bytes(keys, labels, nb, sub, cap, ovf_cap)
    fd = os.open(path, os.O_WRONLY)
    try:
        os.pwrite(fd, data, cf.HDR2.size + block * len(data))
    finally:
        os.close(fd)
    return {"rows": int(keys.shape[0]), "pairs": int(len(b)),
            "spill": cf.spill_count(b, r, nb, cap),
            "touched": int(np.unique(b).size),
            "positives": int(labels.sum())}


def source_hash(traffic: dict, geom: dict) -> str:
    h = hashlib.sha256()
    for p in (HERE / "gen.py", HERE / "crec2_frozen.py"):
        h.update(p.read_bytes())
    h.update(json.dumps([traffic, geom], sort_keys=True).encode())
    return h.hexdigest()[:12]


def generate(cell: str, traffic: dict, geom: dict, seed: int,
             workers: int = None) -> Tuple[Path, dict]:
    """(crec2 path, meta) of the cell's data for ``seed``: made once in
    ``_data/<cell>-<seed>-<hash>/`` and reused; other entries of the cell
    are removed first. ``geom``: num_buckets, subblocks, nnz, blocks."""
    DATA.mkdir(exist_ok=True)
    name = f"{cell}-{seed}-{source_hash(traffic, geom)}"
    out = DATA / name
    meta_p = out / "meta.json"
    if meta_p.exists():
        return out / "train.crec2", json.loads(meta_p.read_text())
    for old in DATA.glob(f"{cell}-*"):
        shutil.rmtree(old, ignore_errors=True)
    nb, sub, nnz = geom["num_buckets"], geom["subblocks"], geom["nnz"]
    n_blocks = int(geom["blocks"])
    cap = cf.default_cap(nnz, nb)
    b0 = first_intercept(traffic, geom, seed)
    rows = sub * cf.RSUB
    tmp = DATA / (name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    path = tmp / "train.crec2"
    workers = WORKERS if workers is None else workers
    pool = None
    if workers > 1 and n_blocks > 1:
        pool = multiprocessing.get_context("spawn").Pool(
            min(workers, n_blocks))
    run = pool.map if pool is not None else (lambda f, a: list(map(f, a)))
    try:
        # the spill of every block sets ovf_cap, and so the blocks' size,
        # before any block is written
        spill = max(run(_spill_of, [(traffic, geom, seed, i, cap)
                                    for i in range(n_blocks)]))
        ovf_cap = -(-spill // 1024) * 1024
        with open(path, "wb") as f:
            f.write(cf.header(nnz, rows, rows * n_blocks, nb, sub, cap,
                              ovf_cap))
        stats = run(_write_one, [(traffic, geom, seed, i, b0, cap, ovf_cap,
                                  str(path)) for i in range(n_blocks)])
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    meta = {"seed": seed, "cap": cap, "ovf_cap": ovf_cap, "intercept": b0,
            "blocks": stats, "bytes": os.path.getsize(path)}
    (tmp / "meta.json").write_text(json.dumps(meta))
    os.replace(tmp, out)
    return out / "train.crec2", meta


def geometry(config: dict, traffic: dict) -> Dict[str, int]:
    """The data geometry of a (config, traffic) pair."""
    return {"num_buckets": int(config["data"]["num_buckets"]),
            "subblocks": int(config["data"]["subblocks"]),
            "nnz": len(_field_specs(traffic)),
            "blocks": int(traffic["blocks"])}
