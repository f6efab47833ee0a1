"""The comparison that decides ``correct`` fails what it must.

On the CPU, at a tiny size in float32 with each cell's own limits: a sound
run passes; a run with the timed path broken underneath (every fault of
:mod:`benchmark.faults`) comes out not correct; and the control, the
reference in float8 put in the program's place, fails a limit.  On the
card (marked ``cuda``), the control at the cell's own size fails too.
"""

import pytest
import torch

from benchmark import calibrate, checks, faults, harness, spec
from benchmark.conftest import tiny_cell


def _run(cell, step_fn=None, seed=11):
    res, rows, _ = harness.run_cell(cell["workload"]["name"], seed, 0.2,
                                    False, device="cpu", cell=cell,
                                    step_fn=step_fn)
    return res, rows


def test_sound_tiny_run_is_correct(workload):
    res, rows = _run(tiny_cell(workload))
    assert res["correct"], rows
    assert res["metrics"] and list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_fault_is_not_correct(workload, fault):
    cell = tiny_cell(workload)
    fam = harness.module("models", cell["config"]["family"])
    res, rows = _run(cell, faults.FAULTS[fault](fam))
    assert not res["correct"], rows


def test_control_fails_a_limit(workload):
    cell = tiny_cell(workload)
    fam = harness.module("models", cell["config"]["family"])
    drv = harness.module("loops", cell["traffic"]["loop"])
    conf, traffic = cell["config"], cell["traffic"]
    ref = drv.reference(fam, conf, traffic, 13, "cpu")
    low = drv.reference(fam, conf, traffic, 13, "cpu", precision="fp8")
    values = checks.readings(calibrate.as_program(low, traffic["ranks"]), ref)
    correct, rows = checks.judge(values, cell["limits"])
    assert not correct, rows


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's size")
    cell = spec.cell(workload)
    fam = harness.module("models", cell["config"]["family"])
    drv = harness.module("loops", cell["traffic"]["loop"])
    conf, traffic = cell["config"], cell["traffic"]
    seed = 4000000001
    ref = drv.reference(fam, conf, traffic, seed, "cuda")
    low = drv.reference(fam, conf, traffic, seed, "cuda", precision="fp8")
    values = checks.readings(calibrate.as_program(low, traffic["ranks"]), ref)
    correct, rows = checks.judge(values, cell["limits"])
    assert not correct, rows


def test_unmoved_leaves_counts_moved_leaves_only():
    """A leaf that the reference moves and the program leaves as it was
    counts; a rounding tie (one element in a thousand) does not."""
    ref = {"losses": [1.0], "grad1": [1.0, 1.0, 1.0],
           "gradient": [1.0, 1.0, 1.0], "change": [1.0, 1.0, 0.004],
           "moved": [1.0, 0.5, 1e-3]}
    prog = {"losses": [[1.0]], "grad1": [[1.0, 1.0, 1.0]],
            "change": [[1.0, 0.0, 0.0]], "moved": [[1.0, 0.0, 0.0]],
            "ranks_differ": 0}
    values = checks.readings(prog, ref)
    assert values["unmoved_leaves"] == 1
    prog["moved"][0][1], prog["change"][0][1] = 0.5, 1.0
    assert checks.readings(prog, ref)["unmoved_leaves"] == 0
