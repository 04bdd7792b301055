#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fourier_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds kernel B1 from fourier_tpu_torch/csrc with nvcc, holds it against its
plain PyTorch version and against np.fft, drives the main path (the default
complex64 1-D transform through create_fft_f32 on device="cuda") and checks
that it launched the kernel, then times the kernel, its plain version and
torch.fft at n=4096, B=16384. Every phase prints one line; any failed check
raises, so the exit code is non-zero. The next-to-last line is a JSON record
of the kernels; the last line is {"ok": true, "device": {...}}.

It needs a CUDA device and the repository beside it; it imports no JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

SIZES = (64, 96, 128, 243, 320, 512, 576, 625, 729, 1000, 1024, 1728, 2187,
         3125, 4096, 6144, 6561, 8192, 14400, 16384)
BATCHES = (1, 7, 1000)
REL_L2_GATE = 1e-6  # two f32 results, each within ~3e-7 of exact
HOST_COLUMNS = 3  # columns per case checked against np.fft in f64
MAIN_N, MAIN_B = 4096, 16384
PRIME = 1013
CHAIN = 128
REPS = 3
SEED = 20261016


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")

    import fourier_tpu_torch as ftt
    from fourier_tpu_torch import Transform
    from fourier_tpu_torch.ops.cuda import stockham_vpu as sv

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def planes(n, b):
        return (torch.randn(n, b, generator=gen, device=dev),
                torch.randn(n, b, generator=gen, device=dev))

    # 1. Device.
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(f"device: {name} | nvidia-smi: {smi}", flush=True)

    # 2. Build.
    t0 = time.perf_counter()
    sv.library()
    print(f"build: B1 from fourier_tpu_torch/csrc/stockham_vpu.cu in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 3. Kernel against its plain version, and against np.fft on the host.
    worst_plain = worst_host = max_abs = 0.0
    cases = [(n, b) for n in SIZES for b in BATCHES] + [(MAIN_N, MAIN_B)]
    for n, b in cases:
        plan = ftt.VpuFftPlan.create(n, device=dev)
        re, im = planes(n, b)
        x = (re[:, :HOST_COLUMNS].double().cpu().numpy()
             + 1j * im[:, :HOST_COLUMNS].double().cpu().numpy())
        for mode in Transform:
            kre, kim = plan.transform_planar_bm(re, im, mode)
            pre, pim = sv.vpu_fft_batch_minor_reference(
                re, im, n, plan.tables(mode.is_forward), mode.is_forward,
                mode.scale(n))
            torch.cuda.synchronize()
            k = torch.stack([kre, kim]).double()
            p = torch.stack([pre, pim]).double()
            err = (torch.linalg.norm(k - p) / torch.linalg.norm(p)).item()
            max_abs = max(max_abs, (k - p).abs().max().item())
            check(err <= REL_L2_GATE,
                  f"B1 vs plain n={n} B={b} {mode.name}: rel-L2 {err:.3e}")
            worst_plain = max(worst_plain, err)
            want = (np.fft.fft(x, axis=0) if mode.is_forward
                    else np.fft.ifft(x, axis=0) * n)
            want = want * (mode.scale(n) or 1.0)
            got = (kre[:, :HOST_COLUMNS].double().cpu().numpy()
                   + 1j * kim[:, :HOST_COLUMNS].double().cpu().numpy())
            err = rel_l2(got, want)
            check(err <= REL_L2_GATE,
                  f"B1 vs np.fft n={n} B={b} {mode.name}: rel-L2 {err:.3e}")
            worst_host = max(worst_host, err)
    print(f"kernel vs plain: {len(cases)} (n, B) cases x 5 modes pass; worst "
          f"rel-L2 {worst_plain:.3e} vs plain, {worst_host:.3e} vs np.fft "
          f"(gate {REL_L2_GATE:g}); max abs err {max_abs:.3e}", flush=True)

    # 4. Main path through the entry points, with the launch count.
    sv.vpu_fft_batch_minor.launches = 0
    plan = ftt.create_fft_f32(MAIN_N, device="cuda")
    check(isinstance(plan, ftt.VpuFftPlan), f"create_fft_f32 gave {plan!r}")
    seen = 0

    def rose(what):
        nonlocal seen
        now = sv.vpu_fft_batch_minor.launches
        check(now > seen, f"{what} did not launch B1")
        seen = now

    re, im = planes(MAIN_N, MAIN_B)
    bre, bim = plan.transform_planar_bm(re, im)
    rose("transform_planar_bm")
    mre, mim = plan.transform_planar(re.T.contiguous(), im.T.contiguous())
    rose("transform_planar")
    check(tuple(mre.shape) == (MAIN_B, MAIN_N), f"batch-major shape {tuple(mre.shape)}")
    check(torch.equal(mre.T, bre) and torch.equal(mim.T, bim),
          "batch-major and batch-minor results differ")
    xc = torch.complex(re.T.contiguous(), im.T.contiguous())
    y = plan.fft(xc)
    rose("fft")
    back = plan.ifft(y)
    rose("ifft")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(torch.view_as_real(y)).all()), "fft output not finite")
    check(y.dtype == torch.complex64 and tuple(y.shape) == (MAIN_B, MAIN_N),
          f"fft output {y.dtype} {tuple(y.shape)}")
    rt = (torch.linalg.norm(back - xc) / torch.linalg.norm(xc)).item()
    check(rt <= REL_L2_GATE, f"ifft(fft(x)) rel-L2 {rt:.3e}")
    host = xc[:HOST_COLUMNS].cpu().numpy().astype(np.complex128)
    fe = rel_l2(y[:HOST_COLUMNS].cpu().numpy(), np.fft.fft(host, axis=-1))
    check(fe <= REL_L2_GATE, f"fft vs np.fft rel-L2 {fe:.3e}")
    prime = ftt.create_fft_f32(PRIME, device="cuda")
    check(isinstance(prime, ftt.BluesteinPlan)
          and isinstance(prime.inner, ftt.VpuFftPlan)
          and prime.inner.size == 2048, f"n={PRIME} planned as {prime!r}")
    xp = torch.complex(*planes(64, PRIME))
    yp = prime.fft(xp)
    rose(f"Bluestein n={PRIME}")
    pe = rel_l2(yp.cpu().numpy(),
                np.fft.fft(xp.cpu().numpy().astype(np.complex128), axis=-1))
    check(pe <= REL_L2_GATE, f"n={PRIME} vs np.fft rel-L2 {pe:.3e}")
    launches = sv.vpu_fft_batch_minor.launches
    check(launches > 0, "the main path launched B1 no time")
    print(f"main path: {plan!r}; bm, batch-major, fft, ifft and Bluestein "
          f"n={PRIME} each launched B1 ({launches} launches); roundtrip rel-L2 "
          f"{rt:.3e}, fft vs np.fft {fe:.3e}, n={PRIME} vs np.fft {pe:.3e}",
          flush=True)

    # 5. Timing: CHAIN dependent SQRT_SCALED_FFT calls, median of REPS.
    mode = Transform.SQRT_SCALED_FFT
    tables = plan.tables(True)
    scale = mode.scale(MAIN_N)

    def kernel(a, b):
        return sv.vpu_fft_batch_minor(a, b, MAIN_N, True, scale, tables=tables,
                                      kernel_tables=plan.kernel_fwd)

    def plain(a, b):
        return sv.vpu_fft_batch_minor_reference(a, b, MAIN_N, tables, True, scale)

    def entry(a, b):
        return plan.transform_planar_bm(a, b, mode)

    def chained(step, a, b):
        for _ in range(CHAIN):
            a, b = step(a, b)
        return a, b

    def median_ms(step, a, b):
        step(a, b)
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            chained(step, a, b)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop) / CHAIN)
        return float(np.median(times))

    flops = 5.0 * MAIN_N * math.log2(MAIN_N) * MAIN_B
    xc = torch.complex(re.T.contiguous(), im.T.contiguous())
    timed = {
        "B1 kernel": median_ms(kernel, re, im),
        "plan.transform_planar_bm": median_ms(entry, re, im),
        "plain PyTorch B1": median_ms(plain, re, im),
        "torch.fft.fft": median_ms(
            lambda a, _b: (torch.fft.fft(a, norm="ortho"), None), xc, None),
    }
    for what, ms in timed.items():
        print(f"time: {what}: {ms:.4f} ms per call, "
              f"{flops / ms / 1e6:.2f} GFLOP/s (n={MAIN_N}, B={MAIN_B}, "
              f"chain {CHAIN}, median of {REPS}) on {card}", flush=True)
    ratio = timed["torch.fft.fft"] / timed["plan.transform_planar_bm"]
    print(f"time: port / torch.fft throughput ratio {ratio:.4f} on {card}",
          flush=True)

    print(json.dumps({"kernels": [{
        "name": "B1 fused Stockham c64 (stockham_vpu)",
        "route": "cuda",
        "source": "fourier_tpu_torch/csrc/stockham_vpu.cu",
        "replaces": "fourier_tpu/ops/pallas/stockham_vpu.py:422",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": timed["B1 kernel"],
        "plain_ms": timed["plain PyTorch B1"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
