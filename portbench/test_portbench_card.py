"""The benchmark on the card: each cell's run at a short window, and the
small-size control and faults on the card's kernels. Marked ``cuda``: they
skip on a host without a CUDA device (the fixture decides).

Run on the card: ``python3 -m pytest --noconftest portbench/ -q``."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import _tiny, gen, judge, run
from portbench.test_portbench_faults import FAULTS
from portbench.test_portbench_reference import _control_numbers, limits

HERE = Path(__file__).resolve().parent
CELLS = [w["name"] for w in _tiny.bench()["workloads"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU host)")
    return torch.device("cuda")


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(gen, "DATA", tmp_path / "_data")
    return tmp_path


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_and_is_correct(cuda, name):
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        name, "--seed", str(2 ** 31 + 4242), "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card(cuda, data_dir, name):
    nums = _control_numbers(name, device=cuda, nb=_tiny.NB_CARD)
    ok, checks = judge.verdict(nums, limits(name))
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_fails_on_the_card(cuda, data_dir, name, fault):
    cfg, tr = _tiny.cell(name, nb=_tiny.NB_CARD)
    res = run.run_cell(_tiny.bench(), name, 2 ** 31 + 99, 0.2, False,
                       device="cuda", config=cfg, traffic=tr, warm_steps=8,
                       fault=FAULTS[fault])
    assert not res["correct"], res["checks"]
