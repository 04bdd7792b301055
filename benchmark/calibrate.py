"""The readings that the check's limits are set from, on the card.

    python -m benchmark.calibrate --workload <cell> --seconds <s> [--control] --seeds <n> ...

runs the cell once a seed (a short window at the cell's own size and load)
and prints one JSON line a seed with each compared number. With
``--control`` the timed entry is replaced by the reference computed in TF32
(``reference/dft.py``: the nearest precision below the configurations'
float32), which a limit has to fail. The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def tf32_control(driver) -> None:
    """The control: the reference in TF32 in the timed entry's place."""
    driver.entry = driver.reference_entry("tf32")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    from benchmark import harness
    from benchmark.run import cache_env

    cache_env()
    import torch

    cell = harness.Cell(args.workload, Path.cwd())
    if torch.cuda.device_count() < cell.chips:
        print("calibrate: not enough CUDA devices", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.launch(args.workload, seed, args.seconds, False, Path.cwd(), t0, "cuda",
                             cell.chips, patch=tf32_control if args.control else None)
        line = out["line"]
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": line["correct"], "attempted": line["attempted"],
                          "checks": line["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
