"""A/B of the main path's call time between two trees of the repository.

Times ``create_fft_f32(4096).transform_planar_bm`` on the card at B = 16384
(the headline shape, device-bound) and at B = 16 (where the host's cost a
call shows), in one process per tree, in the order parent, change,
change, parent (``--rounds`` times), so that the two trees share one card
and one call of the tool. Each process reports, for each batch, the median
of 5 rounds of `chain` dependent ``SQRT_SCALED_FFT`` calls: the card's time
a call (CUDA events on the stream, which at B = 16 is the host's pace) and
the host's (the wall clock to the last call's return, before the
synchronise). A tree whose B1 launch is a registered operator also
times, in the same process, the B = 16 plan call with the operator's own
function in the operator's place (``no_dispatch_ms``,
``host_no_dispatch_us``): the difference is the dispatcher's cost a call.

Run:  python -m fourier_tpu_torch.tools.ab_main_path --parent DIR
          [--change DIR] [--rounds 1] [--json out.json]
(DIR: a checkout of the parent commit, e.g. from ``git archive``; the
change defaults to this checkout.)
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SIZE = 4096
BATCHES = {16384: 64, 16: 2000}  # batch -> dependent calls a round
ROUNDS = 5

# Runs inside each tree's process (the tree first on sys.path).
_PROBE = r'''
import json, sys, time
import numpy as np, torch
import fourier_tpu_torch as ftt
from fourier_tpu_torch import Transform
from fourier_tpu_torch.ops.cuda import stockham_vpu as sv

SIZE, BATCHES, ROUNDS = {size}, {batches}, {rounds}
dev = torch.device("cuda", 0)
plan = ftt.create_fft_f32(SIZE, device="cuda")
mode = Transform.SQRT_SCALED_FFT
out = {{"plan": type(plan).__name__}}

def timed(call, b, chain):
    rng = np.random.default_rng(0)
    re, im = (torch.as_tensor(rng.standard_normal((SIZE, b)).astype(np.float32), device=dev)
              for _ in range(2))
    for _ in range(3):
        re, im = call(re, im)
    torch.cuda.synchronize()
    dev_ms, host_us = [], []
    for _ in range(ROUNDS):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        for _ in range(chain):
            re, im = call(re, im)
        host = time.perf_counter() - t0
        stop.record()
        torch.cuda.synchronize()
        dev_ms.append(start.elapsed_time(stop) / chain)
        host_us.append(host / chain * 1e6)
    return float(np.median(dev_ms)), float(np.median(host_us))

for b, chain in BATCHES.items():
    ms, us = timed(lambda a, c: plan.transform_planar_bm(a, c, mode), b, chain)
    out[str(b)] = {{"ms": ms, "host_us": us}}
op = getattr(sv, "_vpu_fft_op", None)
raw = getattr(op, "_init_fn", None)
if raw is not None:
    # The same plan call with the operator's own function in its place: the
    # difference is the dispatcher's cost a call.
    sv._vpu_fft_op = raw
    try:
        ms, us = timed(lambda a, c: plan.transform_planar_bm(a, c, mode), 16, BATCHES[16])
    finally:
        sv._vpu_fft_op = op
    out["16"]["no_dispatch_ms"] = ms
    out["16"]["host_no_dispatch_us"] = us
print("AB_RESULT " + json.dumps(out), flush=True)
'''


def run_tree(tree: Path) -> dict:
    code = (f"import sys; sys.path.insert(0, {str(tree)!r})\n"
            + _PROBE.format(size=SIZE, batches=BATCHES, rounds=ROUNDS))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                          text=True, check=False)
    for line in proc.stdout.splitlines():
        if line.startswith("AB_RESULT "):
            return json.loads(line[len("AB_RESULT "):])
    raise RuntimeError(f"the probe in {tree} failed ({proc.returncode}):\n"
                       f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent", required=True, help="checkout of the parent commit")
    ap.add_argument("--change", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout of the change (default: this one)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times to run the order parent, change, change, parent")
    ap.add_argument("--json", help="write the runs to this JSON file")
    args = ap.parse_args(argv)
    trees = {"parent": Path(args.parent).resolve(), "change": Path(args.change).resolve()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    runs = []
    for _ in range(args.rounds):
        for label in ("parent", "change", "change", "parent"):
            res = run_tree(trees[label])
            runs.append({"tree": label, **res})
            print(f"{label}: " + ", ".join(
                f"B={b}: {res[str(b)]['ms']:.4f} ms (host {res[str(b)]['host_us']:.1f} us)"
                for b in BATCHES)
                + (f"; B=16 without the dispatcher: {res['16']['no_dispatch_ms']:.4f} ms "
                   f"(host {res['16']['host_no_dispatch_us']:.1f} us)"
                   if "no_dispatch_ms" in res["16"] else ""), flush=True)
    summary = {}
    for b in BATCHES:
        med = {label: statistics.median(r[str(b)]["ms"] for r in runs if r["tree"] == label)
               for label in trees}
        summary[str(b)] = {**{f"{k}_ms": v for k, v in med.items()},
                           "change_over_parent": med["change"] / med["parent"]}
        print(f"B={b}: change/parent {med['change'] / med['parent']:.4f} "
              f"(medians {med['change']:.4f} / {med['parent']:.4f} ms) on {smi}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "runs": runs, "summary": summary}, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
