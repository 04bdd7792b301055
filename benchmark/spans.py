"""The program's spans in a traced window: device time by the span that
launched it, span counts, and the host's own time a call.

The port labels its layer boundaries in ``torch.profiler``'s host timeline
(``fourier_tpu_torch.trace``: ``call[entry=...]``, ``call.nested[...]``,
``axis[axis=...]``, ``layout.*``, ``launch[op=...]``, ``exchange.*``). A
kernel is put down to the innermost program span open, on the launching
thread, when the CUDA runtime call that launched it began: the kernel and
that call share a correlation id, so a kernel that runs long after the host
left the span still counts for it (time overlap would give it to whatever
the host did then).

* ``span_device_s``: device seconds by the innermost span's name (its
  attributes dropped), ``"(none)"`` for kernels launched outside any span;
  ``span_path_device_s`` the same by the path of span labels from the
  outermost, which splits a 2-D call by axis;
* ``span_count``: program spans by name;
* ``host_self_s``: the ``call`` spans' host time less the CUDA runtime calls
  (``cuda*``) inside them, which is where the host waits on a full launch
  queue or a synchronisation;
* ``layout_share``: % of the device time in kernels launched inside a
  ``layout.*`` span (the surface's copies, scales and joins, whatever
  kernel does them); ``host_us``: ``host_self_s`` a call, in µs.

Run on the card, beside a cell's own runs:

    python -m benchmark.spans --workload <cell> --seed <n> [--seconds 4]

which sets the cell up as ``benchmark.run`` does, warms it, measures one
window untraced and one traced (``gflops`` of each: the profiler's cost)
and prints one JSON line: the above, and the benchmark's own
``copy_share`` and ``idle_share`` of the traced window. ``BENCHMARK.json``
reads none of it yet: the readers need ``benchmark/trace.py`` to keep these
keys in ``Trace.summary()``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from benchmark.trace import WINDOW_SPAN, _union

NAMES = ("call", "call.nested", "axis", "launch", "launch.first", "plan.build", "lib.load",
         "lib.build")
NONE = "(none)"


def base(label: str) -> str:
    """A span's name without its attributes."""
    return label.split("[")[0]


def is_program_span(label: str) -> bool:
    return base(label) in NAMES or label.startswith(("layout.", "exchange."))


def _kind(e) -> str:
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    return "annotation" if getattr(e, "is_user_annotation", lambda: False)() else ""


def events_of(prof) -> List[dict]:
    """The raw events of a finished ``torch.profiler.profile``, as
    ``benchmark.trace.events_of`` gives them, with the correlation id
    (``corr``) and the thread (``tid``)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append({"name": e.name(), "start": start, "end": start + e.duration_ns(),
                    "kind": _kind(e), "device": e.device_type().name != "CPU",
                    "corr": e.correlation_id(), "tid": e.start_thread_id()})
    return out


def _runtime(e) -> bool:
    return not e["device"] and e["name"].startswith("cuda")


def paths_at(spans: List[dict], at: List[dict]) -> Dict[int, Tuple[str, ...]]:
    """For each event of `at` (by its index there), the labels of the spans
    open on its thread when it began, outermost first. Spans of one thread
    nest, so one sweep by time keeps the open ones on a stack."""
    marks = sorted([(s["tid"], s["start"], 0, -s["end"], i) for i, s in enumerate(spans)]
                   + [(e["tid"], e["start"], 1, 0, i) for i, e in enumerate(at)])
    out, stack, tid = {}, [], None
    for t_id, t, is_query, _, i in marks:
        if t_id != tid:
            stack, tid = [], t_id
        while stack and stack[-1]["end"] < t:
            stack.pop()
        if is_query:
            out[i] = tuple(s["name"] for s in stack)
        else:
            stack.append(spans[i])
    return out


def summarize(events: List[dict], calls: int) -> dict:
    """The keys above, from one traced window's events (device activity
    clipped to the ``bench.window`` span where the events hold one)."""
    win = [e for e in events if e["name"] == WINDOW_SPAN and not e["device"]]
    w0 = min((e["start"] for e in win), default=None)
    w1 = max((e["end"] for e in win), default=None)
    spans = [e for e in events if not e["device"] and is_program_span(e["name"])]
    runtime = [e for e in events if _runtime(e)]
    paths = paths_at(spans, runtime)
    launched = {e["corr"]: paths[i] for i, e in enumerate(runtime)}
    by_name: Dict[str, float] = defaultdict(float)
    by_path: Dict[str, float] = defaultdict(float)
    total = layout = 0.0
    for e in events:
        if not e["device"] or "annotation" in e["kind"] or e["name"] == WINDOW_SPAN:
            continue
        s, t = e["start"], e["end"]
        if w0 is not None:
            s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        sec = (t - s) * 1e-9
        path = launched.get(e["corr"], ())
        by_name[base(path[-1]) if path else NONE] += sec
        by_path["/".join(path) if path else NONE] += sec
        total += sec
        if any(base(p).startswith("layout.") for p in path):
            layout += sec
    count: Dict[str, int] = defaultdict(int)
    for s in spans:
        count[base(s["name"])] += 1
    host_self = 0.0
    for c in spans:
        if base(c["name"]) != "call":
            continue
        inside = [(max(r["start"], c["start"]), min(r["end"], c["end"])) for r in runtime
                  if r["tid"] == c["tid"] and r["start"] < c["end"] and r["end"] > c["start"]]
        host_self += (c["end"] - c["start"] - _union(inside)[0]) * 1e-9
    return {"span_device_s": dict(by_name), "span_path_device_s": dict(by_path),
            "span_count": dict(count), "host_self_s": host_self,
            "layout_share": 100.0 * layout / total if total > 0 else None,
            "host_us": 1e6 * host_self / calls if calls and count.get("call") else None}


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    import time
    from pathlib import Path

    import torch

    from benchmark import harness
    from benchmark import trace as tr

    p = argparse.ArgumentParser(prog="python -m benchmark.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=harness.TRACE_SECONDS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.spans: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload, Path.cwd())
    if cell.chips != 1:
        print("benchmark.spans: one card a run", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    ctx = harness.Ctx(torch.device("cuda", 0), args.seed, cell.config, cell.traffic)
    driver = cell.kind().Driver(ctx)
    driver.warm()
    driver.reset()
    plain_s, plain_calls = harness._window(driver, ctx, args.seconds, None, False)
    with torch.profiler.profile(activities=tr.profile_activities("cuda")) as prof:
        traced_s, calls = harness._window(driver, ctx, args.seconds, None, True)
    events = events_of(prof)
    summary = tr.Trace(events, calls).summary()
    merged = tr.merged([summary])
    out = {"workload": args.workload, "calls": calls,
           "device": torch.cuda.get_device_name(0),
           "gflops_untraced": driver.work.flops * plain_calls / plain_s / 1e9,
           "gflops_traced": driver.work.flops * calls / traced_s / 1e9,
           "copy_share": tr.class_share(merged, "torch"), "idle_share": tr.idle_share(merged),
           "busy_s": summary["busy_s"], "window_s": summary["window_s"],
           **summarize(events, calls)}
    print(json.dumps(out), flush=True)
    for path, sec in sorted(out["span_path_device_s"].items(), key=lambda kv: -kv[1]):
        print(f"spans: {1e3 * sec / calls:.4f} ms a call  {path}", file=sys.stderr)
    print(f"spans: host {out['host_us']} us a call over {calls} calls; "
          f"{time.strftime('%H:%M:%S')}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
