"""The roofline counts against brute-force counts over the raw keys, and
against what a float64 replay of the same step reads and writes.

Run: ``python -m pytest portbench/ -q`` from the repository root."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from portbench import _tiny, crec2_frozen as cf, gen


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(gen, "DATA", tmp_path / "_data")
    return tmp_path


@pytest.mark.parametrize("spill", [False, True])
def test_generator_counts_equal_brute_force(data_dir, spill):
    cfg, tr = _tiny.cell("ftrl.resident.uniform", spill=spill)
    geom = gen.geometry(cfg, tr)
    _, meta = gen.generate("t", tr, geom, 31, workers=1)
    nb, cap = geom["num_buckets"], meta["cap"]
    for i, st in enumerate(meta["blocks"]):
        keys, labels = gen.block_rows_data(tr, geom, 31, i,
                                           meta["intercept"])
        pairs, touched, cells = 0, set(), {}
        spilled = 0
        for r in range(keys.shape[0]):
            for k in keys[r]:
                if k == cf.SENTINEL:
                    continue
                b = int(cf.fold(np.array([k], np.uint32), nb)[0])
                pairs += 1
                touched.add(b)
                c = (r // cf.RSUB, b // cf.TILE)
                cells[c] = cells.get(c, 0) + 1
                if cells[c] > cap:
                    spilled += 1
        assert st["pairs"] == pairs
        assert st["touched"] == len(touched)
        assert st["spill"] == spilled
        assert st["rows"] == keys.shape[0]
        assert (spilled > 0) == spill


def _replay_bytes(config, geom, meta) -> float:
    """Bytes a float64 replay of one step (the reference's) reads and
    writes at the least: each pair's bucket and row ids (8 B each) and its
    gathered value and pushed value (8 B each a channel), each row's label
    and margin, and every bucket's state read and written."""
    k = int(config["model"]["dim"]) if config["store"] == "fm" else 0
    ch = k + 2 if k else 1
    width = 2 * (1 + k) if k else 3
    st = meta["blocks"][0]
    return (st["pairs"] * (16 + 16 * ch) + st["rows"] * 16
            + 2 * 8 * width * geom["num_buckets"])


@pytest.mark.parametrize("name,counts", [
    ("ftrl.resident.uniform", ("tile_step_update",)),
    ("fm.resident.uniform", ("tile_fm_step", "fm_step"))])
def test_counts_never_exceed_a_float64_replay(data_dir, name, counts):
    cfg, tr = _tiny.cell(name, spill=True)
    geom = gen.geometry(cfg, tr)
    _, meta = gen.generate("t", tr, geom, 8, workers=1)
    meta = dict(meta, blocks=meta["blocks"][:1])
    for c in counts:
        n = importlib.import_module(f"portbench.roofline.{c}").count(cfg,
                                                                     meta)
        assert 0 < n["bytes"] <= _replay_bytes(cfg, geom, meta)
        assert n["flops"] > 0
