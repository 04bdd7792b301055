"""Run one cell of ``BENCHMARK.json`` once on the card and print its line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each compared
number beside its limit, which also end standard error). Without a card, or
with fewer cards than the cell asks for, it exits 2 and prints no result.
A cell on several cards runs one process a card and waits for each.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
BENCH_DIR = Path(__file__).resolve().parent


def cache_env() -> None:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run there compiles: the port builds its nvcc libraries into
    ``build/fourier_tpu_torch/`` itself; Triton, if anything loads it, into
    ``benchmark/.cache/triton``."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH_DIR / ".cache" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def power_limit() -> str:
    """The cards' power limits as ``nvidia-smi`` reads them: a roofline share
    is stated against the data sheet's 700 W peaks."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return ", ".join(x.strip() for x in out.stdout.splitlines() if x.strip()) or "unknown"


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    from benchmark import harness

    try:
        cell = harness.Cell(args.workload, ROOT)
    except (harness.SpecError, KeyError, OSError) as e:
        return fail(f"cannot load the cell: {e}")
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: this benchmark measures the card and has no CPU fallback")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"the cell needs {cell.chips} cards, {torch.cuda.device_count()} present")
    out = harness.launch(args.workload, args.seed, args.seconds, bool(args.trace), ROOT,
                         T_START, "cuda", cell.chips)
    forbidden = sorted(set(out["forbidden"]) | set(harness.forbidden_modules()))
    if forbidden:
        return fail(f"modules loaded that no run may import: {forbidden}")
    line = out["line"]
    line["device"]["power_limit"] = power_limit()
    print(json.dumps(line), flush=True)
    for s in harness.check_lines(out):
        print(s, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
