"""The four-card cell ``fft2d-4096-sharded.x4-b128`` on the CPU: four gloo
ranks, its configuration and mix cut in this file's own tree to 8 images of
16x32 (2 a rank, 4 rows a rank, one row a pipeline chunk). The run is
correct traced and untraced, counts its exchanges, and the check fails
under the TF32 control, each fault a cell can have, and an exchange that
delivers its blocks in the wrong rank order."""

import json
import time

import pytest

from benchmark import harness
from benchmark.tests import faults
from benchmark.tests.conftest import REPO, make_tree
from benchmark.tests.test_bench_control import FAULTS

CELL = "fft2d-4096-sharded.x4-b128"
WORLD = 4
TINY_CONFIG = {"shape": [16, 32], "images_per_chip": 2}
TINY_TRAFFIC = {"group": 2}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = make_tree(tmp_path_factory.mktemp("bench_sharded"))
    for path, upd in ((root / "benchmark" / "configs" / "fft2d-4096-sharded.json", TINY_CONFIG),
                      (root / "benchmark" / "traffic" / "x4-b128.json", TINY_TRAFFIC)):
        path.write_text(json.dumps({**json.loads(path.read_text()), **upd}))
    return root


def _run(tree, trace=False, patch=None, seed=2 ** 31 + 23):
    return harness.launch(CELL, seed, 0.3, trace, tree, time.perf_counter(), "cpu", WORLD,
                          tree / "benchmark", patch)


def blocks_out_of_order(driver) -> None:
    """An exchange whose blocks reach the wrong ranks: each rank sends its
    leading-dim blocks in reverse rank order, so rank j receives what was
    meant for rank S-1-j."""
    import torch.distributed as dist

    inner = dist.all_to_all_single

    def reversed_blocks(output, input, *args, group=None, **kwargs):
        s = dist.get_world_size(group)
        sent = input.reshape(s, -1).flip(0).reshape(input.shape)
        return inner(output, sent, *args, group=group, **kwargs)
    dist.all_to_all_single = reversed_blocks


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_and_is_correct(tree, trace):
    from fourier_tpu_torch import trace as program

    before = program.counters().snapshot()  # rank 0 runs in this process
    out = _run(tree, trace)
    counts = program.counters().delta(before)
    line = out["line"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["count"] == WORLD and line["attempted"] % WORLD == 0
    check = line["checks"]["rel_l2_worst"]
    # Every image of every kept call, on every rank: 8 images a call.
    assert check["answers"] == WORLD * check["calls"] * 8 and check["value"] < 1e-5
    metrics = line["metrics"]
    # One sharded call is one call: its row leg in 4 chunks, each with its
    # exchange, and the exchange back to rows.
    assert counts["calls"] > 0 and counts["exchange.legs"] == 5 * counts["calls"]
    if trace:
        assert metrics["exchanges_per_call"]["value"] > 0
        assert "exchange_share" not in metrics  # no device trace on the CPU
    else:
        assert set(metrics) == {"gflops", "setup_s"}
    assert out["forbidden"] == []


def test_control_fails_the_limit(tree):
    from benchmark import calibrate

    line = _run(tree, patch=calibrate.tf32_control)["line"]
    check = line["checks"]["rel_l2_worst"]
    assert line["correct"] is False and check["value"] > 3 * check["limit"]


@pytest.mark.parametrize("fault", FAULTS)
def test_each_fault_is_caught(tree, fault):
    line = _run(tree, patch=getattr(faults, fault))["line"]
    assert line["correct"] is False and line["failed"] > 0


def test_blocks_in_the_wrong_rank_order_are_caught(tree):
    import torch.distributed as dist

    kept = dist.all_to_all_single  # rank 0 runs in this process
    try:
        line = _run(tree, patch=blocks_out_of_order)["line"]
    finally:
        dist.all_to_all_single = kept
    assert line["correct"] is False and line["failed"] > 0


def test_work_and_least_link_time():
    """A rank's share of a call is its 32 images' transforms, so the four
    shares add up to the call's 128; the exchange's least link time is two
    all-to-alls of 3/4 of the rank's 4.29 GB at 450 GB/s."""
    config = json.loads((REPO / "benchmark" / "configs" / "fft2d-4096-sharded.json").read_text())
    mix = json.loads((REPO / "benchmark" / "traffic" / "x4-b128.json").read_text())
    kind = harness._load_file(REPO / "benchmark" / "kinds" / "sharded_fft2.py", "test_kind_")
    w = kind.work_of(config, mix, WORLD)
    assert (w.flops, w.bytes) == (5.0 * 4096 ** 2 * 24 * 32, 16.0 * 4096 ** 2 * 32)
    roof = harness._load_file(REPO / "benchmark" / "metrics" / "exchange_roofline.py",
                              "test_metric_")
    assert roof.least_seconds(config, WORLD) == pytest.approx(2 * 0.75 * 2 ** 32 / 450e9)
    assert roof.least_seconds(config, WORLD) == pytest.approx(14.3e-3, rel=2e-3)
