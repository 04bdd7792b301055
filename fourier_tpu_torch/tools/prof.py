"""Profiling entry point: run a plan in a loop for a profiler to watch.

Port of ``fourier_tpu/tools/prof.py`` (the fourier-prof analog): builds the
planner's complex64 plan, runs ``SQRT_SCALED_FFT`` through
``transform_planar`` on (batch, size) planes in a loop, and prints every 50
iterations (and at the last) µs per iteration, GFLOP/s (5 n log2 n) and
effective GB/s (planar f32 in and out), synchronised with the card first.
``--trace DIR`` wraps the loop in ``torch.profiler`` (CPU and, on the card,
CUDA activities), writes a Chrome trace to ``DIR/trace.json`` and prints
the operators' and kernels' device time (``key_averages()``); it says so
when the trace holds no device time. The trace holds the port's own spans
(``call[entry=...]``, ``launch[op=...]``: ``fourier_tpu_torch.trace``)
beside the kernels they launched.

Run:  python -m fourier_tpu_torch.tools.prof --size 4096 [--batch 2048]
          [--iters 100 | --forever] [--trace DIR]
          [--backend auto|vpu|mxu|stockham] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch


def _device_us(event) -> float:
    """An averaged profiler event's device time in µs (the attribute's
    name changed across torch versions)."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--forever", action="store_true")
    ap.add_argument("--trace", help="torch.profiler trace output directory")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import fourier_tpu_torch as ftt
    from fourier_tpu_torch.transform import Transform

    plan = ftt.create_fft(args.size, torch.complex64, backend=args.backend,
                          device=args.device)
    device = plan.device
    print(f"plan: {plan!r}")

    def step(re, im):
        return plan.transform_planar(re, im, Transform.SQRT_SCALED_FFT)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(0)
    re, im = (torch.as_tensor(rng.standard_normal((args.batch, args.size))
                              .astype(np.float32), device=device) for _ in range(2))
    t0 = time.perf_counter()
    re, im = step(re, im)
    sync()
    print(f"first run (kernel build included) in {time.perf_counter() - t0:.1f} s",
          flush=True)

    flops = 5.0 * args.size * np.log2(max(args.size, 2)) * args.batch
    bytes_moved = 2 * args.batch * args.size * 8  # planar f32 in + out

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    ctx = (torch.profiler.profile(activities=activities) if args.trace
           else contextlib.nullcontext())
    with ctx as prof:
        i = 0
        t_report = time.perf_counter()
        last = 0
        while args.forever or i < args.iters:
            re, im = step(re, im)
            i += 1
            if i % 50 == 0 or (not args.forever and i == args.iters):
                sync()
                now = time.perf_counter()
                dt = (now - t_report) / (i - last)
                t_report, last = now, i
                print(f"iter {i}: {dt * 1e6:.1f} us/iter, "
                      f"{flops / dt / 1e9:.1f} GFLOP/s, "
                      f"{bytes_moved / dt / 1e9:.1f} GB/s effective", flush=True)
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "trace.json")
        prof.export_chrome_trace(path)
        events = sorted(prof.key_averages(), key=_device_us, reverse=True)
        for e in events[:12]:
            print(f"profile: {e.key}: {e.count} calls, device {_device_us(e):.1f} us, "
                  f"host {e.cpu_time_total:.1f} us", flush=True)
        kernel_us = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        if device.type == "cuda" and kernel_us == 0:
            print("profile: the trace holds no device time (no kernel records); "
                  "time the card with CUDA events instead", flush=True)
        print(f"trace written to {path}; kernel time in the window {kernel_us:.1f} us "
              f"over {i} iterations", flush=True)
    return plan


if __name__ == "__main__":
    main()
