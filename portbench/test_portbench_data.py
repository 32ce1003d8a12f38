"""The frozen crec2 encoder and the traffic laws, on the CPU.

Run: ``python -m pytest portbench/ -q`` from the repository root."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import _tiny, crec2_frozen as cf, gen


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(gen, "DATA", tmp_path / "_data")
    return tmp_path


def _geom(traffic, subblocks=1, blocks=3):
    return {"num_buckets": _tiny.NB, "subblocks": subblocks,
            "nnz": len(gen._field_specs(traffic)), "blocks": blocks}


@pytest.mark.parametrize("spill", [False, True])
def test_frozen_bytes_equal_the_port_writer(data_dir, spill):
    """The file the generator writes through the frozen encoder is the
    port's ``CRec2Writer`` file of the same rows, byte for byte."""
    from wormhole_tpu_torch.data.crec import CRec2Writer
    _, traffic = _tiny.cell("ftrl.resident.uniform", spill=spill)
    geom = _geom(traffic, subblocks=2)
    seed = 2 ** 31 + 17
    path, meta = gen.generate("t", traffic, geom, seed, workers=1)
    assert (meta["ovf_cap"] > 0) == spill
    theirs = data_dir / "port.crec2"
    with CRec2Writer(str(theirs), nnz=geom["nnz"], nb=geom["num_buckets"],
                     subblocks=2, ovf_cap=meta["ovf_cap"]) as w:
        for i in range(geom["blocks"]):
            keys, labels = gen.block_rows_data(traffic, geom, seed, i,
                                               meta["intercept"])
            w.append(keys, labels)
    assert path.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("name", ["uniform_resident", "criteo_kaggle_zipf"])
def test_each_law_is_deterministic_per_seed(name):
    traffic = gen.json.loads((gen.HERE / "traffic" / f"{name}.json")
                             .read_text())
    a = gen.block_keys(traffic, 5, 1, 2048)
    b = gen.block_keys(traffic, 5, 1, 2048)
    c = gen.block_keys(traffic, 6, 1, 2048)
    assert a.shape == (2048, 39)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    missing = np.mean(a == cf.SENTINEL)
    assert 0.08 < missing < 0.12


def test_labels_are_deterministic_and_near_the_positive_rate():
    _, traffic = _tiny.cell("ftrl.resident.uniform")
    geom = _geom(traffic)
    b0 = gen.first_intercept(traffic, geom, 3)
    y1 = gen.block_rows_data(traffic, geom, 3, 0, b0)[1]
    y2 = gen.block_rows_data(traffic, geom, 3, 0, b0)[1]
    assert np.array_equal(y1, y2)
    assert 0.02 < y1.mean() < 0.045


def test_zipf_field_is_skewed_over_its_cardinality():
    traffic = {"fields": [{"kind": "zipf", "cardinality": 1000,
                           "exponent": 1.05}], "missing": 0.0}
    keys = gen.block_keys(traffic, 1, 0, 50000)[:, 0]
    _, counts = np.unique(keys, return_counts=True)
    counts = np.sort(counts)[::-1]
    assert len(counts) <= 1000
    # rank 1 against rank 10: 10^1.05 = 11.2 in expectation
    assert 7 < counts[0] / counts[9] < 17


def test_ovf_cap_covers_every_block_spill(data_dir):
    from wormhole_tpu_torch.data.crec import iter_packed2, read_header2
    _, traffic = _tiny.cell("ftrl.resident.uniform", spill=True)
    geom = _geom(traffic, blocks=4)
    path, meta = gen.generate("t", traffic, geom, 9, workers=1)
    spills = [b["spill"] for b in meta["blocks"]]
    assert min(spills) > 0
    assert meta["ovf_cap"] % 1024 == 0
    assert max(spills) <= meta["ovf_cap"] < max(spills) + 1024
    assert read_header2(str(path)).ovf_cap == meta["ovf_cap"]
    for (views, _), n in zip(iter_packed2(str(path)), spills):
        assert np.count_nonzero(views["ovf_b"] != cf.SENTINEL) == n


def test_data_is_reused_and_one_entry_kept_per_cell(data_dir):
    _, traffic = _tiny.cell("ftrl.resident.uniform")
    geom = _geom(traffic, blocks=1)
    p1, _ = gen.generate("c", traffic, geom, 1, workers=1)
    t1 = p1.stat().st_mtime_ns
    p1b, _ = gen.generate("c", traffic, geom, 1, workers=1)
    assert p1b == p1 and p1.stat().st_mtime_ns == t1
    p2, _ = gen.generate("c", traffic, geom, 2, workers=1)
    assert not p1.exists() and p2.exists()
    assert len(list((data_dir / "_data").glob("c-*"))) == 1
