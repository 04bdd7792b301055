"""The runs that a cell's limits and bounds are set from, in one process
tree on the card, each result kept under `--out`:

    python -m benchmark.measure --workload <cell> --out <dir> --seed0 <n>
        [--runs 6] [--traced 3] [--calibrate 6] [--control 3]
        [--seconds 10] [--cal-seconds 3] [--timeout 600]

in this order: `--calibrate` seeds of the program and `--control` seeds of
the control (``benchmark.calibrate``, short windows at the cell's own size
and load; the first of them compiles), two sets of `--runs` runs
(``benchmark.run``, the same seeds in both sets), then `--traced` runs with
``--trace 1``. Seeds: seed0 + i for the sets, + 100 + i traced, + 200 + i
calibrated, + 300 + i for the control. Each run's standard output and
error go to ``<dir>/<name>.out`` and ``.err``; the spread of the two sets is
``python -m benchmark.spread --set <dir>/A*.out --set <dir>/B*.out``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path


def _run(args, out: Path, name: str, timeout: float) -> None:
    t0 = time.perf_counter()
    with open(out / f"{name}.out", "w") as fo, open(out / f"{name}.err", "w") as fe:
        try:
            rc = subprocess.run([sys.executable, "-m", *args], stdout=fo, stderr=fe,
                                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
    print(f"{name}: rc={rc} {time.perf_counter() - t0:.1f} s", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.measure")
    p.add_argument("--workload", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--seed0", type=int, required=True)
    p.add_argument("--runs", type=int, default=6)
    p.add_argument("--traced", type=int, default=3)
    p.add_argument("--calibrate", type=int, default=6)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=int, default=10)
    p.add_argument("--cal-seconds", type=float, default=3.0)
    p.add_argument("--timeout", type=float, default=600.0, help="seconds a run may take")
    a = p.parse_args(argv)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    cal = ["benchmark.calibrate", "--workload", a.workload, "--seconds", str(a.cal_seconds)]
    if a.calibrate:
        _run(cal + ["--seeds", *(str(a.seed0 + 200 + i) for i in range(a.calibrate))],
             out, "calibrate", a.timeout * a.calibrate)
    if a.control:
        _run(cal + ["--control", "--seeds",
                    *(str(a.seed0 + 300 + i) for i in range(a.control))], out, "control",
             a.timeout * a.control)
    run = ["benchmark.run", "--workload", a.workload, "--seconds", str(a.seconds)]
    for s in "AB":
        for i in range(a.runs):
            _run(run + ["--seed", str(a.seed0 + i), "--trace", "0"], out, f"{s}{i + 1}", a.timeout)
    for i in range(a.traced):
        _run(run + ["--seed", str(a.seed0 + 100 + i), "--trace", "1"], out, f"T{i + 1}", a.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
