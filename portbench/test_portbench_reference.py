"""The plain references against the port at a small size on the CPU, the
lower-precision controls that must fail, and the imports of the harness.

Run: ``python -m pytest portbench/ -q`` from the repository root."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import _tiny, gen, judge, run

HERE = Path(__file__).resolve().parent
CELLS = [w["name"] for w in _tiny.bench()["workloads"]]


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(gen, "DATA", tmp_path / "_data")
    monkeypatch.setattr(gen, "WORKERS", 1)
    return tmp_path


def limits(name):
    return json.loads((HERE / "limits" / f"{name}.json").read_text())


def tiny_run(name, spill=False, seed=2 ** 31 + 5, **kw):
    cfg, tr = _tiny.cell(name, spill=spill)
    return run.run_cell(_tiny.bench(), name, seed, 0.05, False,
                        device="cpu", config=cfg, traffic=tr, warm_steps=8,
                        **kw)


# With spill pairs the hot key's bucket sums some 7,400 values a step in
# float32, and FM's g_v = push_s - v*g_w cancels most of them, so the
# float32 program reads up to ~2e-3 against the float64 reference there; a
# plain float32 replay of the same steps reads ~7e-4 (1e-7 on the uniform
# rows of the cells): held to 1e-2 in this case.
SPILL_LIMITS = {"loss_gap": 1e-2, "grad_gap": 1e-2, "change_gap": 1e-2,
                "auc_gap": 1e-2, "order_rows": 0, "window_loss_gap": 1e-2,
                "window_auc_gap": 1e-2, "examples_missing": 0}


@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference(data_dir, name, spill):
    res = tiny_run(name, spill=spill,
                   limits=SPILL_LIMITS if spill else None)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 4
    assert set(res["checks"]) == set(limits(name)) - {"readings"}


def _control_numbers(name, seed=2 ** 31 + 5, device="cpu", nb=_tiny.NB):
    """The control's numbers at the small size: the program on its own
    bfloat16 path where the configuration names one, else the reference in
    bfloat16, each against the float64 reference over the same steps."""
    cfg, tr = _tiny.cell(name, nb=nb)
    ctl = cfg["control"]
    sink = {}
    kw = dict(device=device, config=cfg, traffic=tr, warm_steps=8,
              limits=dict.fromkeys(SPILL_LIMITS, float("inf")))
    run.run_cell(_tiny.bench(), name, seed, 0.05, False, sink=sink, **kw)
    if "app" in ctl:
        low = {}
        run.run_cell(_tiny.bench(), name, seed, 0.05, False,
                     overrides=ctl["app"], sink=low, **kw)
        return low["numbers"]
    alt = judge.reference_run(cfg, sink["blocks"], seed, device,
                              sink["plan"], lower=True)
    return judge.numbers(cfg, alt, sink["ref"],
                         {"reported": 0, "expected": 0})


@pytest.mark.parametrize("name", CELLS)
def test_the_lower_precision_control_fails(data_dir, name):
    nums = _control_numbers(name)
    ok, checks = judge.verdict(nums, limits(name))
    assert not ok, checks


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_no_jax_anywhere_and_no_program_in_the_reference():
    bad = {"jax", "jaxlib", "flax", "wormhole_tpu"}
    for p in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & bad, (p, tops & bad)
        if p.parent.name == "reference":
            assert "wormhole_tpu_torch" not in tops, p
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.run, portbench.judge, portbench.calibrate, "
            "portbench.devtrace, portbench.program; "
            "import wormhole_tpu_torch.learners.async_sgd, "
            "wormhole_tpu_torch.models.fm; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert not set(json.loads(out.replace("'", '"'))) & bad
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.ftrl, portbench.reference.fm; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert "wormhole_tpu_torch" not in json.loads(out.replace("'", '"'))


def test_a_host_without_a_card_gets_no_result():
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
