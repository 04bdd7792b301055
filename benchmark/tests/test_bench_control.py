"""The check that decides ``correct`` has to fail: the control (the
reference in TF32 in the timed entry's place) and each fault a cell can
have, planted under the timed path of a run at the CPU's size."""

import time

import pytest

from benchmark import calibrate, harness
from benchmark.tests import faults
from benchmark.tests.conftest import CELLS

# The faults each cell can have: a call left out, a batch to halve, an
# answer altered, an inverse replaced by the forward or reversed.
FAULTS = ["unchanged", "half_batch", "altered", "forward_as_inverse", "reversed_inverse"]


def _run(tree, cell, patch):
    return harness.launch(cell, 2 ** 31 + 11, 0.3, False, tree, time.perf_counter(), "cpu",
                          CELLS[cell], tree / "benchmark", patch)["line"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_the_limit(tree, cell):
    line = _run(tree, cell, calibrate.tf32_control)
    check = line["checks"]["rel_l2_worst"]
    assert line["correct"] is False and line["failed"] > 0
    assert check["value"] > 3 * check["limit"]  # TF32 reads ~1e-4 and more


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELLS) for f in FAULTS])
def test_each_fault_is_caught(tree, cell, fault):
    line = _run(tree, cell, getattr(faults, fault))
    assert line["correct"] is False and line["failed"] > 0
