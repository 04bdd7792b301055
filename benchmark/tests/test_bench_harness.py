"""The harness on the CPU: cells found by name, the result line, the seeds,
the import check, and no run without a card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, run
from benchmark.tests.conftest import CELLS, REPO

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(tree, cell, trace=False, seed=2 ** 31 + 5, patch=None):
    return harness.launch(cell, seed, 0.3, trace, tree, time.perf_counter(), "cpu",
                          CELLS[cell], tree / "benchmark", patch)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_runs_and_is_correct(tree, cell, trace):
    out = _run(tree, cell, trace)
    line = out["line"]
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["count"] == CELLS[cell]
    spec = json.loads((tree / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", (cell,))}
    assert set(line["metrics"]) <= want  # device-trace readers find nothing on the CPU
    if not trace:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    for c in line["checks"].values():
        assert set(c) == {"value", "limit", "answers", "calls"} and c["value"] <= c["limit"]
        assert c["calls"] > 0 and c["calls"] % 3 == 0
    assert out["forbidden"] == []
    assert json.loads(json.dumps(line)) == line


@pytest.mark.parametrize("trace", [False, True])
def test_several_ranks(tree, trace):
    """The harness's path for a cell on several cards: one process a rank
    (here two gloo ranks on the CPU, each its own batch), the same steps on
    every rank, every rank's answers checked and its calls counted."""
    one = _run(tree, "c64-1d.n4096-b16384")["line"]
    out = harness.launch("c64-1d.n4096-b16384", 2 ** 31 + 5, 0.3, trace, tree,
                         time.perf_counter(), "cpu", 2, tree / "benchmark")
    line = out["line"]
    assert line["correct"] is True and line["device"]["count"] == 2 and line["attempted"] > 0
    assert line["attempted"] % 2 == 0  # both ranks made the same steps
    check = line["checks"]["rel_l2_worst"]
    assert check["answers"] == 2 * one["checks"]["rel_l2_worst"]["answers"]
    assert out["forbidden"] == []


def test_check_lines_end_with_each_limit(tree):
    out = _run(tree, "c64-1d.n4096-b16384")
    lines = harness.check_lines(out)
    assert lines[0].startswith("setup_s parts: start ")
    assert lines[-1].startswith("check rel_l2_worst: ") and " limit 4e-05 " in lines[-1]
    assert lines[-1].endswith(" answers of 9 calls")  # 3 chains kept of 3 calls


def test_the_sample_of_chains_is_fixed_by_the_seed():
    """Which chains the check keeps is drawn from the seed alone, uniformly
    over the window; every seed does the same work."""
    from benchmark.sample import Reservoir, stream

    def kept(seed, n=200, k=4):
        r = Reservoir(k, stream(seed, "keep"))
        for i in range(n):
            j = r.slot()
            if j is not None:
                r.items[j] = i
        return sorted(r.items)

    a, b, c = kept(2 ** 33 + 1), kept(2 ** 33 + 1), kept(2 ** 33 + 2)
    assert a == b and a != c and len(a) == 4
    counts = [0] * 200
    for seed in range(500):
        for i in kept(seed):
            counts[i] += 1
    assert sum(counts[:100]) / sum(counts) == pytest.approx(0.5, abs=0.05)


def test_a_slot_drops_what_it_held():
    from benchmark.sample import Reservoir, stream

    r = Reservoir(2, stream(7, "keep"))
    assert r.slot() == 0 and r.slot() == 1
    r.items[:] = ["a", "b"]
    while (j := r.slot()) is None:
        pass
    assert r.items[j] is None and r.items[1 - j] in ("a", "b")


@pytest.mark.parametrize("cell", ["c64-1d.n4096-b16384", "fft2d-4096.x1-b32"])
def test_every_call_of_a_kept_chain_is_checked(tree, cell):
    """Each kept chain holds one output a call, from the input its index
    names, and the check reads one answer a transform of each."""
    c = harness.Cell(cell, tree, tree / "benchmark")
    d = c.kind().Driver(harness.Ctx("cpu", 5, c.config, c.traffic))
    d.warm()
    for _ in range(3 * d.kept.k):
        d.step()
    assert d.calls == 3 * d.kept.k * d.chain and d.chains == 3 * d.kept.k
    assert len(d.kept.items) == d.kept.k
    assert all(len(outs) == d.chain for _, outs in d.kept.items)
    assert d.checked_calls() == d.kept.k * d.chain
    d.release()
    vals = d.check()["rel_l2_worst"]
    per_call = c.traffic.get("batch") or c.config["images_per_chip"]
    assert len(vals) == d.checked_calls() * per_call and max(vals) < 1e-5


def test_new_files_are_found_by_name(tmp_path):
    """A cell, a configuration, a mix and a per-layer metric added as files
    and entries only: found and run with no other edit."""
    from benchmark.tests.conftest import make_tree

    root = make_tree(tmp_path)
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / "c64-1d.json").read_text())
    (bench / "configs" / "c64-1d-new.json").write_text(json.dumps({**config, "name": "c64-1d-new"}))
    (bench / "traffic" / "n32-b4.json").write_text(json.dumps(
        {"kind": "chained_bm", "n": 32, "batch": 4, "chain": 3, "inputs": 1,
         "modes": ["FFT", "IFFT"], "keep": 1, "limits": {"rel_l2_worst": 4e-05}}))
    (bench / "metrics" / "calls_seen.new.py").write_text(
        "def read(run):\n    return float(run.trace['calls']) if run.trace else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "c64-1d-new", "source": "test", "reduced": [],
                            "file": "benchmark/configs/c64-1d-new.json", "why": "test"})
    spec["workloads"].append({"name": "c64-1d-new.n32-b4", "config": "c64-1d-new",
                              "traffic": "n32-b4", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "calls_seen.new", "unit": "count", "better": "higher",
                              "source": "program_counter", "layer": "test", "moves": "gflops",
                              "workloads": ["c64-1d-new.n32-b4"]})
    spec["end_to_end"][0]["workloads"].append("c64-1d-new.n32-b4")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = harness.launch("c64-1d-new.n32-b4", 9, 0.2, True, root, time.perf_counter(), "cpu",
                         1, bench)
    assert out["line"]["correct"] and out["line"]["metrics"]["calls_seen.new"]["value"] > 0
    out = harness.launch("c64-1d-new.n32-b4", 9, 0.2, False, root, time.perf_counter(), "cpu",
                         1, bench)
    assert set(out["line"]["metrics"]) == {"gflops", "setup_s"}


def test_an_unknown_cell_is_refused(tree):
    with pytest.raises(harness.SpecError, match="no workload"):
        harness.Cell("no-such.cell", tree, tree / "benchmark")


@pytest.mark.parametrize("names,found", [
    (["fourier_tpu_torch", "fourier_tpu_torch.plan.base", "torch", "numpy"], []),
    (["fourier_tpu"], ["fourier_tpu"]),
    (["fourier_tpu.ops.pallas", "fourier_tpu_torch"], ["fourier_tpu"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib.xla_client", "flax.linen", "jax_cosmology"], ["flax", "jaxlib"]),
])
def test_import_check_compares_whole_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


def test_the_harness_imports_no_jax():
    code = ("import sys, time; from pathlib import Path; from benchmark import harness, run, "
            "calibrate, chains, measure, spread, trace; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_no_card_no_result():
    """A measuring run with no card fails and prints nothing on stdout."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "c64-1d.n4096-b16384", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_too_few_cards_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", "c64-1d.n4096-b16384", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_without_the_port_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, a run
    fails (here before the card is looked for, or at the port's import)."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "c64-1d.n4096-b16384", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card(cuda):
    """On the card: the first cell, one short run, correct."""
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "c64-1d.n4096-b16384", "--seed", str(2 ** 31 + 77), "--seconds", "1",
                          "--trace", "1"], cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert 0 < line["metrics"]["call_roofline"]["value"] <= 100


def test_benchmark_file_keeps_its_contract():
    """BENCHMARK.json's shape: keys, names, units, files, and what each
    cell reports."""
    import re

    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert list(spec) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert all(p == "benchmark" for p in spec["paths"]) and 1 <= spec["run_seconds"] <= 51
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and all(name.match(k) for k in c["reduced"])
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    cells = {w["name"]: w for w in spec["workloads"]}
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and name.match(w["name"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "workloads" in m
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells)
    for c in cells:
        mine = [m["name"] for m in spec["end_to_end"] if c in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(c in m["workloads"] for m in spec["per_layer"])
