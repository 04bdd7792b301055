"""The spread of a cell's runs, as the bounds are set from it.

    python -m benchmark.spread --set A1.out A2.out ... --set B1.out B2.out ...

reads the last line of each file (a run's result line) and prints, for each
metric and each set of runs, the median and the spread: the distance
between the first and third quartiles (``statistics.quantiles(values,
n=4)``) as a share of the median; then the spread with each set's run
farthest from its median left out, the mean over the sets (what a bound has
to be twice), and the spread of all runs together (what a bound may be
eight times at most).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict, List


def spread(values: List[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: List[float]) -> List[float]:
    """`values` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def last_line(path: str) -> dict:
    with open(path) as f:
        lines = [x for x in f.read().splitlines() if x.strip()]
    return json.loads(lines[-1])


def report(sets: List[List[dict]]) -> Dict[str, dict]:
    names = sorted({m for s in sets for line in s for m in line["metrics"]})
    out = {}
    for name in names:
        vals = [[line["metrics"][name]["value"] for line in s if name in line["metrics"]]
                for s in sets]
        vals = [v for v in vals if len(v) >= 3]
        if not vals:
            continue
        out[name] = {
            "medians": [statistics.median(v) for v in vals],
            "spreads": [spread(v) for v in vals],
            "trimmed_mean": statistics.fmean(spread(trimmed(v)) for v in vals),
            "all": spread([x for v in vals for x in v]),
        }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.spread")
    p.add_argument("--set", action="append", nargs="+", required=True, dest="sets")
    args = p.parse_args(argv)
    sets = [[last_line(f) for f in s] for s in args.sets]
    print(json.dumps(report(sets), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
