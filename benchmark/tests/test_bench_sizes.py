"""The cell ``c64-1d-sizes.bench15-b65536`` on the CPU: its 15 sizes a round
cut in this file's own tree to a batch of 2 each. The run is correct traced
and untraced; the check fails under the TF32 control, each fault a cell can
have, and a fault at one size alone; a round's work is the sum over its
sizes; ``product_flops_per_call`` reads the program's counts."""

import json
import sys
import time

import pytest

from benchmark import calibrate, harness
from benchmark.harness import Cell, Run
from benchmark.tests import faults
from benchmark.tests.conftest import REPO, make_tree
from benchmark.tests.test_bench_control import FAULTS
from fourier_tpu_torch import trace

CELL = "c64-1d-sizes.bench15-b65536"
SIZES = [256, 512, 1024, 243, 729, 2187, 125, 625, 3125, 222, 722, 1418, 191, 439, 1013]
BATCH = 2


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = make_tree(tmp_path_factory.mktemp("bench_sizes"))
    path = root / "benchmark" / "traffic" / "bench15-b65536.json"
    mix = json.loads(path.read_text())
    path.write_text(json.dumps({**mix, "batches": [BATCH] * len(mix["sizes"])}))
    return root


def _run(tree, trace=False, patch=None, seed=2 ** 31 + 41):
    return harness.launch(CELL, seed, 0.3, trace, tree, time.perf_counter(), "cpu", 1,
                          tree / "benchmark", patch)


def _mix():
    return json.loads((REPO / "benchmark" / "traffic" / "bench15-b65536.json").read_text())


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_runs_and_is_correct(tree, traced):
    before = trace.counters().snapshot()
    out = _run(tree, traced)
    counts = trace.counters().delta(before)
    line = out["line"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    check = line["checks"]["rel_l2_worst"]
    # Every transform of every size of every kept round: 15 sizes of 2.
    assert check["answers"] == check["calls"] * len(SIZES) * BATCH and check["value"] < 1e-5
    assert check["calls"] > 0 and check["calls"] % 3 == 0
    # One plan call a size a round; warm-up, window, traced window.
    assert counts["calls"] % len(SIZES) == 0 and counts["calls"] >= len(SIZES) * line["attempted"]
    if traced:
        assert set(line["metrics"]) <= {"load_s", "launches_per_call", "product_flops_per_call"}
    else:
        assert set(line["metrics"]) == {"gflops", "setup_s"}
    assert out["forbidden"] == []


def test_every_size_of_a_kept_round_is_checked(tree):
    c = harness.Cell(CELL, tree, tree / "benchmark")
    d = c.kind().Driver(harness.Ctx("cpu", 5, c.config, c.traffic))
    d.warm()
    for _ in range(2 * d.kept.k):
        d.step()
    assert d.calls == 2 * d.kept.k * d.chain and d.checked_calls() == d.kept.k * d.chain
    for _, rounds in d.kept.items:
        assert [[x[0].shape for x in r] for r in rounds] == [
            [(n, BATCH) for n in SIZES]] * d.chain
    d.release()
    vals = d.check()["rel_l2_worst"]
    assert len(vals) == d.checked_calls() * len(SIZES) * BATCH and max(vals) < 1e-5


def test_control_fails_the_limit(tree):
    line = _run(tree, patch=calibrate.tf32_control)["line"]
    check = line["checks"]["rel_l2_worst"]
    assert line["correct"] is False and check["value"] > 3 * check["limit"]


@pytest.mark.parametrize("fault", FAULTS)
def test_each_fault_is_caught(tree, fault):
    line = _run(tree, patch=getattr(faults, fault))["line"]
    assert line["correct"] is False and line["failed"] > 0


def _at_one_size(n):
    """A fault at size `n` alone: its calls' answers altered, every other
    size's left right."""
    def patch(driver):
        inner = driver.entry

        def call(x, forward):
            y = inner(x, forward)
            if x[0].shape[0] == n:
                y[0][0, 0] += 1.0
            return y
        driver.entry = call
    return patch


@pytest.mark.parametrize("n", [1013, 125])
def test_a_fault_at_one_size_is_caught(tree, n):
    line = _run(tree, patch=_at_one_size(n))["line"]
    check = line["checks"]["rel_l2_worst"]
    # Only the faulty size's transforms fail: one column a call of it.
    assert line["correct"] is False and 0 < line["failed"] <= check["calls"] * BATCH


def test_work_of_a_round_is_the_sum_over_its_sizes():
    config = json.loads((REPO / "benchmark" / "configs" / "c64-1d-sizes.json").read_text())
    mix = _mix()
    kind = harness._load_file(REPO / "benchmark" / "kinds" / "chained_sizes.py", "test_kind_")
    w = kind.work_of(config, mix)
    parts = [kind.work.batched(n, b) for n, b in zip(mix["sizes"], mix["batches"])]
    assert w.flops == sum(p.flops for p in parts) and w.bytes == sum(p.bytes for p in parts)
    assert mix["sizes"] == SIZES
    assert sum(n * b for n, b in zip(mix["sizes"], mix["batches"])) == 533331968
    assert w.flops == pytest.approx(2.588e10, rel=1e-3)
    assert w.bytes == pytest.approx(8.533e9, rel=1e-3)
    assert max(n * b for n, b in zip(mix["sizes"], mix["batches"])) <= 2 ** 26


def test_a_size_given_twice_or_a_batch_missing_is_refused():
    kind = harness._load_file(REPO / "benchmark" / "kinds" / "chained_sizes.py", "test_kind_")
    for bad in ({"sizes": [64, 64], "batches": [2, 2]}, {"sizes": [64, 32], "batches": [2]}):
        with pytest.raises(ValueError):
            kind.rows(bad)


def _reading_run():
    cell = Cell(CELL, REPO)
    return Run(cell=cell.name, traffic=cell.traffic, calls=10, trace=None, counters={})


def test_product_flops_per_call_reads_the_counts(monkeypatch):
    from benchmark.metrics import product_flops_per_call

    c = trace.Counters()
    monkeypatch.setattr(trace, "_COUNTERS", c)
    assert product_flops_per_call.read(_reading_run()) is None  # no call counted
    c.count("calls", 15)
    assert product_flops_per_call.read(_reading_run()) is None  # no product counted
    c.count("dft.products", 5)
    c.count("dft.product_flops", 427_500_000_000)
    assert product_flops_per_call.read(_reading_run()) == pytest.approx(28.5)


def test_product_flops_per_call_without_the_registry_reads_nothing(monkeypatch):
    """A port without fourier_tpu_torch.trace: None, and no exception."""
    from benchmark.metrics import product_flops_per_call

    monkeypatch.setitem(sys.modules, "fourier_tpu_torch.trace", None)
    monkeypatch.delattr(sys.modules["fourier_tpu_torch"], "trace")
    assert product_flops_per_call.read(_reading_run()) is None
