"""CPU tests of the benchmark, on a copy of ``benchmark/`` whose mixes and
2-D configuration are cut to a size the CPU runs in a fraction of a second
(limits, kinds and readers unchanged). Run: ``python -m pytest benchmark/tests -q``."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

TINY_TRAFFIC = {
    "n4096-b16384": {"n": 64, "batch": 8, "keep": 3},
    "x1-b32": {"group": 1},
}
TINY_CONFIG = {"fft2d-4096": {"shape": [16, 32], "images_per_chip": 2}}
# The cells of BENCHMARK.json, each with its world on the CPU.
CELLS = {"c64-1d.n4096-b16384": 1, "fft2d-4096.x1-b32": 1}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


def make_tree(root: Path) -> Path:
    """A checkout-like tree under `root`: BENCHMARK.json, and benchmark/
    with the tiny mixes and configurations."""
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    for folder, tiny in (("traffic", TINY_TRAFFIC), ("configs", TINY_CONFIG)):
        for name, upd in tiny.items():
            p = root / "benchmark" / folder / f"{name}.json"
            p.write_text(json.dumps({**json.loads(p.read_text()), **upd}))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


@pytest.fixture(scope="session")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def cuda():
    """Skips where there is no card; decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
