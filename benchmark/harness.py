"""One run of one cell: load it by name, set it up, warm it, measure it,
check it against the reference, and build the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``
through the entry's ``file``) and a traffic mix (``traffic/<name>.json``),
whose ``kind`` names the generator (``kinds/<kind>.py``, a ``Driver``
class). Each metric is read by ``metrics/<name>.py`` (a ``read(run)``
function). Nothing here names a cell, a mix or a metric, so adding one
adds files only.

A cell on several chips runs one process a card (:func:`launch`: ranks 1..
spawned, rank 0 in the caller's process, which prints). A driver
(``kinds/<kind>.py``'s ``Driver``) gives:

* ``work``: a :class:`benchmark.work.Work`, this rank's share of one call;
* ``entry(x, forward)``: the timed call; ``reference_entry(precision)``:
  the reference in its place (the control); ``batch_dim``;
* ``warm()``: every shape the window uses, then ``reset()``;
* ``reset()``: zero the counts and the sample of calls the check keeps;
* ``step()``: the next calls (a chain); ``calls`` counts them;
  ``counters()``, the program's own counts;
* ``release()``: drop the program's state; ``check()``: per-answer
  readings of each compared number, against the reference;
  ``checked_calls()``, the calls those answers come from.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from contextlib import nullcontext
from datetime import timedelta
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fourier_tpu")
TRACE_SECONDS = 4.0  # the traced window's longest length
DIST_TIMEOUT_S = 240
JOIN_TIMEOUT_S = 120


class SpecError(ValueError):
    pass


def forbidden_modules(names=None) -> List[str]:
    """Top-level names (before the first dot, compared whole) of loaded
    modules that no run may import: JAX and the JAX package."""
    tops = {m.split(".")[0] for m in (sys.modules if names is None else names)}
    return sorted(tops.intersection(FORBIDDEN))


def _load_file(path: Path, prefix: str):
    if not path.is_file():
        raise SpecError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(f"{prefix}{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of the benchmark file, with its configuration, its mix and its
    metrics, resolved by name under `bench_dir`."""

    def __init__(self, name: str, root: Path, bench_dir: Path = BENCH_DIR):
        self.bench_dir = Path(bench_dir)
        spec_path = Path(root) / "BENCHMARK.json"
        if not spec_path.is_file():
            raise SpecError(f"no {spec_path}")
        spec = json.loads(spec_path.read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SpecError(f"no workload {name!r}; there are {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = json.loads((Path(root) / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads(
            (self.bench_dir / "traffic" / f"{self.entry['traffic']}.json").read_text())

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", (name,))]

        self.end_to_end = mine(spec["end_to_end"])
        self.per_layer = mine(spec["per_layer"])

    def kind(self):
        """The mix's generator module: ``Driver`` and ``work_of``."""
        return _load_file(self.bench_dir / "kinds" / f"{self.traffic['kind']}.py",
                          "benchmark_kind_")

    def reader(self, metric: str):
        return _load_file(self.bench_dir / "metrics" / f"{metric}.py", "benchmark_metric_").read


class Ctx:
    """What a driver is given: the device, the seed, the configuration and
    the mix, the rank and the world, and a wait for the device."""

    def __init__(self, device, seed: int, config: dict, traffic: dict, rank: int = 0,
                 world: int = 1):
        import torch
        import torch.distributed as dist

        self.device = torch.device(device)
        self.seed, self.config, self.traffic = int(seed), config, traffic
        self.rank, self.world = rank, world
        # The harness's own waits and messages go over the host (gloo), so
        # that no kernel of its own lands in a traced window.
        self.host_group = dist.new_group(backend="gloo") if world > 1 else None

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self) -> None:
        """Every rank's device done, then every rank's host met."""
        import torch.distributed as dist

        self.sync()
        if self.world > 1:
            dist.barrier(group=self.host_group)


class Run:
    """What the metric readers read (rank 0's view, the work of all ranks)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _window(driver, ctx: Ctx, seconds: float, steps: Optional[int], traced: bool):
    """Measure: steps until `seconds` have passed (one rank), or `steps`
    steps (several ranks, so that every rank issues the same collectives);
    the window ends when every rank's device is done. Returns its seconds
    and its calls."""
    import torch

    ctx.barrier()
    calls0 = driver.calls
    t0 = time.perf_counter()
    with torch.profiler.record_function("bench.window") if traced else nullcontext():
        if steps is None:
            while time.perf_counter() - t0 < seconds:
                driver.step()
        else:
            for _ in range(steps):
                driver.step()
        ctx.barrier()
    return time.perf_counter() - t0, driver.calls - calls0


def _steps_for(driver, ctx: Ctx, seconds: float) -> Optional[int]:
    """Several ranks: the steps that fill `seconds`, from two timed steps on
    rank 0, the same on every rank. One rank: None (the clock decides)."""
    if ctx.world == 1:
        return None
    import torch.distributed as dist

    ctx.barrier()
    t0 = time.perf_counter()
    for _ in range(2):
        driver.step()
    ctx.barrier()
    per = (time.perf_counter() - t0) / 2
    box = [max(1, math.ceil(seconds / per))]
    dist.broadcast_object_list(box, src=0, group=ctx.host_group)
    return box[0]


def run_rank(cell_name: str, seed: int, seconds: float, trace: bool, root: Path,
             t_start: float, device_type: str = "cuda", rank: int = 0, world: int = 1,
             init_method: Optional[str] = None, bench_dir: Path = BENCH_DIR,
             patch=None) -> Optional[dict]:
    """One rank of one run. Rank 0 returns the result (see
    :func:`result_line`); the others return None. `patch(driver)` swaps
    part of the timed path (the control and the faults' tests)."""
    import torch
    import torch.distributed as dist

    t_enter = time.perf_counter()
    cell = Cell(cell_name, root, bench_dir)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    if world > 1:
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method=init_method, rank=rank, world_size=world,
                                timeout=timedelta(seconds=DIST_TIMEOUT_S),
                                **({"device_id": device} if device_type == "cuda" else {}))
    try:
        ctx = Ctx(device, seed, cell.config, cell.traffic, rank, world)
        driver = cell.kind().Driver(ctx)
        if patch is not None:
            patch(driver)
        t_driver = time.perf_counter()
        driver.warm()
        steps = _steps_for(driver, ctx, seconds)
        driver.reset()
        ctx.barrier()
        t_warm = time.perf_counter()
        setup_s = t_warm - t_start
        parts = {"start": t_enter - t_start, "init": t_driver - t_enter,
                 "warm": t_warm - t_driver}
        window_s, calls = _window(driver, ctx, seconds, steps, False)
        summary = None
        if trace:
            from benchmark import trace as tr

            t_sec = min(seconds, TRACE_SECONDS)
            t_steps = None if steps is None else max(1, round(steps * t_sec / seconds))
            with torch.profiler.profile(activities=tr.profile_activities(device.type)) as prof:
                _, t_calls = _window(driver, ctx, t_sec, t_steps, True)
            summary = tr.Trace(tr.events_of(prof), t_calls).summary()
            del prof
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        counters = driver.counters()
        driver.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        readings = {k: [float(v) for v in vals] for k, vals in driver.check().items()}
        mine = {"calls": calls, "peak": peak, "readings": readings,
                "checked": driver.checked_calls(), "trace": summary,
                "forbidden": forbidden_modules()}
        if world > 1:
            box = [None] * world
            dist.all_gather_object(box, mine, group=ctx.host_group)
        else:
            box = [mine]
    finally:
        if world > 1 and dist.is_initialized():
            dist.destroy_process_group()
    if rank:
        return None
    out = result_line(cell, ctx, driver, box, setup_s, window_s, counters, trace)
    out["setup_parts"] = parts
    return out


def result_line(cell: Cell, ctx: Ctx, driver, ranks: List[dict], setup_s: float,
                window_s: float, counters: dict, traced: bool) -> dict:
    """The run's one line: correct, attempted, failed, metrics, device,
    breakdown (traced), and last the numbers compared beside their limits."""
    import torch

    from benchmark import trace as tr

    limits = cell.traffic["limits"]
    checks: Dict[str, dict] = {}
    failed = 0
    for name, limit in limits.items():
        vals = [v for r in ranks for v in r["readings"].get(name, [])]
        if not vals:
            raise RuntimeError(f"the check read no {name!r}")
        value = max(vals)
        if not all(math.isfinite(v) for v in vals):
            value = math.inf
        failed += sum(1 for v in vals if not v <= limit)
        checks[name] = {"value": value, "limit": limit, "answers": len(vals),
                        "calls": ranks[0]["checked"]}
    summary = tr.merged([r["trace"] for r in ranks]) if traced else None
    run = Run(cell=cell.name, config=cell.config, traffic=cell.traffic, chips=ctx.world,
              setup_s=setup_s, window_s=window_s, calls=ranks[0]["calls"],
              calls_all=sum(r["calls"] for r in ranks), work=driver.work,
              counters=counters, trace=summary)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if ctx.device.type == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
                  "count": ctx.world, "memory_peak_bytes": max(r["peak"] for r in ranks)}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": ctx.world,
                  "memory_peak_bytes": 0}
    line = {"correct": failed == 0, "attempted": run.calls_all, "failed": failed,
            "metrics": metrics, "device": device}
    if summary is not None:
        device["busy_s"] = summary["busy_s_mean"]
        device["window_s"] = summary["window_s_mean"]
        line["breakdown"] = {"device_ops": [list(x) for x in summary["top_ops"]],
                             "idle_gaps": [list(x) for x in summary["top_gaps"]]}
    line["checks"] = checks
    forbidden = sorted({m for r in ranks for m in r["forbidden"]})
    notes = []
    if summary is not None:
        notes = [f"trace rank {i}: calls {r['calls']}, device ops by class "
                 f"{r['count_by_class']}, seconds by class {r['seconds_by_class']}"
                 for i, r in enumerate(summary["ranks"])]
    return {"line": line, "forbidden": forbidden, "notes": notes}


def check_lines(out: dict) -> List[str]:
    """The traced window's counts, where set-up went, then each compared
    number beside its limit, for the end of standard error."""
    line = out["line"]
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in out["setup_parts"].items())
    return out["notes"] + [f"setup_s parts: {parts}"] + [
        f"check {name}: {c['value']!r} limit {c['limit']!r} over {c['answers']} answers "
        f"of {c['calls']} calls" for name, c in line["checks"].items()]


def launch(cell_name: str, seed: int, seconds: float, trace: bool, root: Path,
           t_start: float, device_type: str, world: int, bench_dir: Path = BENCH_DIR,
           patch=None) -> dict:
    """A whole run: ranks 1.. in processes of their own (spawned, over a
    free localhost port), rank 0 here; every rank is waited for. Returns
    rank 0's result; raises if any rank failed."""
    import multiprocessing as mp
    import socket

    procs, init = [], None
    common = (cell_name, seed, seconds, trace, root, t_start, device_type)
    if world > 1:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("127.0.0.1", 0))
            init = f"tcp://127.0.0.1:{s.getsockname()[1]}"
        spawn = mp.get_context("spawn")
        procs = [spawn.Process(target=rank_entry,
                               args=(*common, r, world, init, bench_dir, patch))
                 for r in range(1, world)]
        for p in procs:
            p.start()
    try:
        out = run_rank(*common, 0, world, init, bench_dir, patch)
    finally:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
            if p.is_alive():
                p.terminate()
                p.join(10)
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"a rank failed: exit codes {[p.exitcode for p in procs]}")
    return out


def rank_entry(cell_name, seed, seconds, trace, root, t_start, device_type, rank, world,
               init_method, bench_dir=BENCH_DIR, patch=None):
    """A spawned rank (1..world-1), on its own card."""
    os.environ.setdefault("USE_FLAX", "0")
    run_rank(cell_name, seed, seconds, trace, Path(root), t_start, device_type, rank, world,
             init_method, Path(bench_dir), patch)
