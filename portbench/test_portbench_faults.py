"""Each fault a training cell can have, planted under the timed path, must
turn ``correct`` false: the harness's run of a small cell on the CPU (the
look for a card skipped), with the store's step broken underneath.

Run: ``python -m pytest portbench/ -q`` from the repository root."""

from __future__ import annotations

import pytest

from portbench import _tiny, gen, run

CELLS = [w["name"] for w in _tiny.bench()["workloads"]]


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(gen, "DATA", tmp_path / "_data")
    monkeypatch.setattr(gen, "WORKERS", 1)
    return tmp_path


def _breaking(edit):
    """A fault: ``edit(store, orig)`` becomes the store's step, for the
    whole run."""
    def install(store):
        orig = store.tile_train_step
        store.tile_train_step = lambda block, info, tau=0.0: edit(
            store, orig, block, info, tau)
    return install


def _unchanged(store, orig, block, info, tau):
    """A step that returns its state unchanged."""
    old = store.slots.clone()
    ev = orig(block, info, tau)
    store.slots.copy_(old)
    return ev


def _relabel(edit):
    def step(store, orig, block, info, tau):
        blk = dict(block)
        lab = block["labels"].clone()
        edit(lab)
        blk["labels"] = lab
        return orig(blk, info, tau)
    return step


def _leave_out_half(lab):
    lab[lab.shape[0] // 2:] = 255


def _flip(lab):
    lab[::100] ^= 1


FAULTS = {"unchanged": _breaking(_unchanged),
          "half_batch": _breaking(_relabel(_leave_out_half)),
          "altered": _breaking(_relabel(_flip))}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_turns_correct_false(data_dir, name, fault):
    cfg, tr = _tiny.cell(name)
    res = run.run_cell(_tiny.bench(), name, 2 ** 31 + 77, 0.05, False,
                       device="cpu", config=cfg, traffic=tr, warm_steps=8,
                       fault=FAULTS[fault])
    assert not res["correct"], res["checks"]


def test_the_same_run_without_a_fault_is_correct(data_dir):
    cfg, tr = _tiny.cell(CELLS[0])
    res = run.run_cell(_tiny.bench(), CELLS[0], 2 ** 31 + 77, 0.05, False,
                       device="cpu", config=cfg, traffic=tr, warm_steps=8)
    assert res["correct"], res["checks"]
