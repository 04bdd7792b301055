"""Comparative benchmark: the port against torch.fft, numpy.fft and scipy.fft.

Port of ``fourier_tpu/tools/bench_suite.py``, the same 67 rows in the same
order: the five size families (pow2 {256, 512, 1024}, pow3 {243, 729,
2187}, pow5 {125, 625, 3125}, composite {222, 722, 1418}, prime {191, 439,
1013}) across {c64, c128} x {fft, ifft}, the c64-only ``large`` family
{65536, 262144} and the rfft+irfft round trips at {1024, 1013, 4096}. Each
row times the port on the card (``fourier_tpu_torch_*``), ``torch.fft`` on
the same data as a (B, n) tensor on the card, chained the same way
(``torch_fft_*``; ``rfft``/``irfft`` for the round trips), and numpy.fft and
scipy.fft on the host (capped at ``_HOST_ROW_CAP`` rows, scaled to the
row's batch), in µs per batched transform and GFLOP/s (5 n log2 n).
``native`` (the repository's C++ core through its FFI) is not ported yet
and ``fftw`` needs pyfftw: each reports a note.

Method (the JAX suite's): each timed step runs CHAIN dependent transforms
(the output feeds the next input; the unitary SQRT_SCALED modes keep the
magnitudes bounded), one warm step, then the median of 3 rounds of ITERS
steps, timed with CUDA events on the planes' stream. The c64 rows run the
planner's ``vpu`` route, the c128 rows its ``dd`` route in native f64,
both through ``transform_planar_bm`` on (n, B) planes where the plan has a
batch-minor path of its own, else ``transform_planar`` on (B, n) planes;
the round trips ``RfftPlan.rfft_planar_bm``/``irfft_planar_bm``. Batch
follows BASELINE.json's config 4 (:func:`default_batch`).

Every row records its plan (``repr`` and ``plan_tree``) and ``rel_l2``: one
application against scipy in f64 on 64 rows (the round trip's against its
input). The JSON file is ``{"device": ..., "rows": [...]}``, the device
record first (the card's name and power limit, as ``nvidia-smi`` gives
them), flushed after every row.

Run:  python -m fourier_tpu_torch.tools.bench_suite [--json out.json]
      [--family pow2 ...] [--max-sizes K] [--dtype c64|c128] [--batch B]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

SIZE_FAMILIES = {
    "pow2": [256, 512, 1024],
    "pow3": [243, 729, 2187],
    "pow5": [125, 625, 3125],
    "composite": [222, 722, 1418],
    "prime": [191, 439, 1013],
    # Past one fused kernel: four-step plans (B1 columns, B3 rows). c64 only,
    # as in the JAX suite.
    "large": [65536, 262144],
}

#: families measured at c64 only.
C64_ONLY_FAMILIES = {"large"}

#: real-input rows: rfft+irfft round trips (shape-preserving, so the
#: iterations chain), f32 real / c64 spectra: 1024 and 4096 even (B4),
#: 1013 odd (B5).
RFFT_SIZES = [1024, 1013, 4096]

CHAIN = 128
CHAIN_DD = 16
ITERS = 3
HOST_ITERS = 5
_HOST_ROW_CAP = 8192  # single-threaded host rate is batch-independent past ~1k

NATIVE_NOTE = "FFI not ported: ROADMAP item 13"
FFTW_NOTE = "pyfftw not installed"


def default_batch(n: int, base: int = 65536) -> int:
    """BASELINE config-4 batch at n<=1024; constant footprint above."""
    if n <= 1024:
        return base
    b = base * 1024 // n
    floor = 256 if n > 16384 else 1024
    return max(floor, 1 << int(np.log2(max(b, 1))))


def _gflops(n: int, batch: int, seconds: float) -> float:
    return 5.0 * n * np.log2(max(n, 2)) * batch / seconds / 1e9


def _first_tensor(out) -> torch.Tensor:
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def _sync(out) -> None:
    """Wait for the work that produced `out` (a tensor or nested tuple of
    them): synchronise its card; nothing on the CPU."""
    t = _first_tensor(out)
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _time_steps(step, args, chain: int, iters: int) -> float:
    """Median steady-state seconds per transform over 3 dependent rounds of
    `iters` steps (each `chain` transforms), after one warm step. On the
    card each round is timed with CUDA events on the planes' stream; on the
    CPU with the host clock."""
    out = step(*args)
    _sync(out)
    device = _first_tensor(out).device
    times = []
    for _ in range(3):
        cur = out
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(iters):
                cur = step(*cur)
            stop.record(stream)
            stop.synchronize()
            seconds = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                cur = step(*cur)
            seconds = time.perf_counter() - t0
        times.append(seconds / (iters * chain))
        out = cur
    return sorted(times)[1]


def batch_minor(plan) -> bool:
    """True for a plan with a batch-minor path of its own (the others'
    ``transform_planar_bm`` transposes around their batch-major one)."""
    from fourier_tpu_torch.plan.base import FftPlan

    return type(plan)._execute_bm is not FftPlan._execute_bm


def _chained(apply, chain: int):
    def step(*carry):
        for _ in range(chain):
            carry = apply(*carry)
            if not isinstance(carry, tuple):
                carry = (carry,)
        return carry
    return step


def _planes(shape, real, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(shape).astype(real), device=device)
                 for _ in range(2))


def bench_fourier_tpu_torch(n: int, batch: int, forward: bool, dtype,
                            device="cuda") -> float:
    """Seconds per batched transform of the planner's plan (c64: the vpu
    route, c128: the dd route on a card)."""
    import fourier_tpu_torch as ftt
    from fourier_tpu_torch.transform import Transform

    plan = ftt.create_fft(n, dtype, device=device)
    mode = Transform.SQRT_SCALED_FFT if forward else Transform.SQRT_SCALED_IFFT
    bm = batch_minor(plan)
    call = plan.transform_planar_bm if bm else plan.transform_planar
    chain = CHAIN if plan.dtype == torch.complex64 else CHAIN_DD
    real = np.float32 if plan.dtype == torch.complex64 else np.float64
    args = _planes((n, batch) if bm else (batch, n), real, plan.device)
    return _time_steps(_chained(lambda re, im: call(re, im, mode), chain), args,
                       chain, ITERS)


def bench_torch_fft(n: int, batch: int, forward: bool, dtype, device="cuda") -> float:
    """Seconds per batched ``torch.fft.fft``/``ifft`` (norm="ortho") of a
    (B, n) complex tensor on `device`, chained as the port's rows."""
    cdtype = torch.complex64 if np.dtype(dtype) == np.complex64 else torch.complex128
    chain = CHAIN if cdtype == torch.complex64 else CHAIN_DD
    re, im = _planes((batch, n), np.float64, device)
    x = torch.complex(re, im).to(cdtype)
    fn = torch.fft.fft if forward else torch.fft.ifft
    return _time_steps(_chained(lambda a: (fn(a, norm="ortho"),), chain), (x,),
                       chain, ITERS)


def bench_fourier_tpu_torch_rfft(n: int, batch: int, device="cuda") -> float:
    """Seconds per batched rfft+irfft round trip on batch-minor (n, B)
    planes (``RfftPlan.rfft_planar_bm`` / ``irfft_planar_bm``)."""
    from fourier_tpu_torch.rfft import RfftPlan

    plan = RfftPlan(n, torch.complex64, device=device)
    x = _planes((n, batch), np.float32, plan.device)[0]
    rt = lambda a: (plan.irfft_planar_bm(*plan.rfft_planar_bm(a)),)
    return _time_steps(_chained(rt, CHAIN), (x,), CHAIN, ITERS)


def bench_torch_fft_rfft(n: int, batch: int, device="cuda") -> float:
    """Seconds per batched ``torch.fft.rfft`` + ``irfft`` round trip of a
    (B, n) f32 tensor."""
    x = _planes((batch, n), np.float32, device)[0]
    rt = lambda a: (torch.fft.irfft(torch.fft.rfft(a), n=n),)
    return _time_steps(_chained(rt, CHAIN), (x,), CHAIN, ITERS)


def _host_bench(fn, x, iters: Optional[int] = None) -> float:
    iters = HOST_ITERS if iters is None else iters
    fn(x)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    return (time.perf_counter() - t0) / iters


def _host_input(n: int, batch: int, dtype):
    nb = min(batch, _HOST_ROW_CAP)
    rng = np.random.default_rng(0)
    return (rng.standard_normal((nb, n)) + 1j * rng.standard_normal((nb, n))).astype(dtype)


def bench_numpy(n: int, batch: int, forward: bool, dtype) -> float:
    x = _host_input(n, batch, dtype)
    fn = np.fft.fft if forward else np.fft.ifft
    return _host_bench(lambda a: fn(a, axis=-1), x) * (batch / x.shape[0])


def bench_scipy(n: int, batch: int, forward: bool, dtype) -> float:
    import scipy.fft as sfft

    x = _host_input(n, batch, dtype)
    fn = sfft.fft if forward else sfft.ifft
    return _host_bench(lambda a: fn(a, axis=-1), x) * (batch / x.shape[0])


def bench_host_rfft(module, n: int, batch: int) -> float:
    """Host rfft+irfft round trip (numpy.fft or scipy.fft namespace)."""
    nb = min(batch, _HOST_ROW_CAP)
    x = np.random.default_rng(0).standard_normal((nb, n)).astype(np.float32)
    fn = lambda a: module.irfft(module.rfft(a, axis=-1), n=n, axis=-1)
    return _host_bench(fn, x) * (batch / nb)


def bench_fftw(n: int, batch: int, forward: bool, dtype) -> Optional[float]:
    """FFTW via pyfftw when importable; None when it is absent."""
    try:
        import pyfftw.interfaces.numpy_fft as fftw
    except ImportError:
        return None
    x = _host_input(n, batch, dtype)
    fn = fftw.fft if forward else fftw.ifft
    return _host_bench(lambda a: fn(a, axis=-1), x) * (batch / x.shape[0])


def accuracy_rel_l2(n: int, forward: bool, dtype, device="cuda") -> float:
    """Rel-L2 of one application of the planner's plan against scipy in
    f64, on 64 rows (the gate)."""
    import scipy.fft as sfft

    import fourier_tpu_torch as ftt
    from fourier_tpu_torch.transform import Transform

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, n)) + 1j * rng.standard_normal((64, n))).astype(dtype)
    plan = ftt.create_fft(n, dtype, device=device)
    got = plan.transform(x, Transform.FFT if forward else Transform.IFFT)
    want = (sfft.fft if forward else sfft.ifft)(x.astype(np.complex128), axis=-1)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def accuracy_rel_l2_rfft(n: int, device="cuda") -> float:
    """Round-trip rel-L2 of rfft -> irfft against the input."""
    from fourier_tpu_torch.rfft import RfftPlan

    x = np.random.default_rng(1).standard_normal((64, n)).astype(np.float32)
    plan = RfftPlan(n, torch.complex64, device=device)
    got = plan.irfft(plan.rfft(x))
    return float(np.linalg.norm(got - x) / np.linalg.norm(x))


def device_record(device="cuda") -> dict:
    """What the times were taken on: the card's name, its power limit and
    name as ``nvidia-smi --query-gpu=name,power.limit`` gives them, torch
    and CUDA versions; for the CPU, the platform alone."""
    device = torch.device(device)
    rec = {"platform": device.type, "torch": torch.__version__}
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        rec["name"] = torch.cuda.get_device_name(index)
        rec["cuda"] = torch.version.cuda
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, check=True)
        rec["nvidia_smi"] = smi.stdout.strip()
    return rec


def _plan_fields(plan) -> dict:
    from fourier_tpu_torch.plan import plan_tree

    return {"plan": repr(plan), "plan_tree": plan_tree(plan)}


def _write(json_path, record, rows) -> None:
    with open(json_path, "w") as f:
        json.dump({"device": record, "rows": rows}, f, indent=1)


def _timed(row: dict, name: str, fn, flops_of) -> None:
    """Time `fn` into row[name_us] and row[name_gflops]; None (pyfftw
    missing) is a note. A failure raises: no row hides one."""
    dt = fn()
    if dt is None:
        row[f"{name}_note"] = FFTW_NOTE
        return
    row[f"{name}_us"] = round(dt * 1e6, 1)
    row[f"{name}_gflops"] = round(flops_of(dt), 1)


def run(batch: Optional[int] = None, families=None, max_sizes: int = 0,
        dtypes=("c64", "c128"), json_path: Optional[str] = None,
        device="cuda") -> List[Dict]:
    """Run the suite on `device` (the card unless the caller asks for the
    CPU); with `json_path`, the results are written after every row."""
    import fourier_tpu_torch as ftt
    from fourier_tpu_torch.plan.base import resolve_device
    from fourier_tpu_torch.rfft import RfftPlan

    device = resolve_device(device)
    record = device_record(device)
    rows: List[Dict] = []
    for family, sizes in SIZE_FAMILIES.items():
        if families and family not in families:
            continue
        for n in sizes[:max_sizes] if max_sizes else sizes:
            for dkey in dtypes:
                if family in C64_ONLY_FAMILIES and dkey != "c64":
                    continue
                dtype = np.complex64 if dkey == "c64" else np.complex128
                b = batch or default_batch(n)
                plan = ftt.create_fft(n, dtype, device=device)
                for forward in (True, False):
                    row = {"family": family, "n": n, "dtype": dkey,
                           "direction": "fft" if forward else "ifft", "batch": b,
                           "chain": CHAIN if dkey == "c64" else CHAIN_DD,
                           **_plan_fields(plan)}
                    flops = lambda dt: _gflops(n, b, dt)
                    for name, fn in (
                        ("fourier_tpu_torch",
                         lambda: bench_fourier_tpu_torch(n, b, forward, dtype, device)),
                        ("torch_fft", lambda: bench_torch_fft(n, b, forward, dtype, device)),
                        ("numpy", lambda: bench_numpy(n, b, forward, dtype)),
                        ("scipy", lambda: bench_scipy(n, b, forward, dtype)),
                        ("fftw", lambda: bench_fftw(n, b, forward, dtype)),
                    ):
                        _timed(row, name, fn, flops)
                    row["native_note"] = NATIVE_NOTE
                    row["rel_l2"] = accuracy_rel_l2(n, forward, dtype, device)
                    rows.append(row)
                    if json_path:
                        _write(json_path, record, rows)
                    print(f"{family:10s} n={n:6d} {dkey} {row['direction']:4s} "
                          f"port={row.get('fourier_tpu_torch_gflops', '?'):>8} GF  "
                          f"torch.fft={row.get('torch_fft_gflops', '?'):>8} GF  "
                          f"numpy={row.get('numpy_gflops', '?'):>7} GF  "
                          f"scipy={row.get('scipy_gflops', '?'):>7} GF  "
                          f"rel_l2={row['rel_l2']:.2e}", flush=True)
    if not families or "rfft" in families:
        import scipy.fft as sfft

        for n in RFFT_SIZES:
            b = batch or default_batch(n)
            plan = RfftPlan(n, torch.complex64, device=device)
            row = {"family": "rfft", "n": n, "dtype": "f32/c64", "direction": "roundtrip",
                   "batch": b, "chain": CHAIN, **_plan_fields(plan)}
            # Round-trip nominal flops: two directions of half the c2c count.
            flops = lambda dt: 2 * 2.5 * n * np.log2(n) * b / dt / 1e9
            for name, fn in (
                ("fourier_tpu_torch", lambda: bench_fourier_tpu_torch_rfft(n, b, device)),
                ("torch_fft", lambda: bench_torch_fft_rfft(n, b, device)),
                ("numpy", lambda: bench_host_rfft(np.fft, n, b)),
                ("scipy", lambda: bench_host_rfft(sfft, n, b)),
            ):
                _timed(row, name, fn, flops)
            row["rel_l2"] = accuracy_rel_l2_rfft(n, device)
            rows.append(row)
            if json_path:
                _write(json_path, record, rows)
            print(f"{'rfft':10s} n={n:6d} f32  rtrip "
                  f"port={row.get('fourier_tpu_torch_gflops', '?'):>8} GF  "
                  f"torch.fft={row.get('torch_fft_gflops', '?'):>8} GF  "
                  f"numpy={row.get('numpy_gflops', '?'):>7} GF  "
                  f"scipy={row.get('scipy_gflops', '?'):>7} GF  "
                  f"rel_l2={row['rel_l2']:.2e}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", help="write results to this JSON file")
    ap.add_argument("--batch", type=int, default=0,
                    help="override batch (0 = BASELINE config-4 scaling)")
    ap.add_argument("--family", action="append", help="limit to these families")
    ap.add_argument("--max-sizes", type=int, default=0,
                    help="limit sizes per family (0 = all)")
    ap.add_argument("--dtype", action="append", choices=["c64", "c128"],
                    help="limit dtypes (default both)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = run(args.batch or None, families=args.family, max_sizes=args.max_sizes,
               dtypes=tuple(args.dtype) if args.dtype else ("c64", "c128"),
               json_path=args.json, device=args.device)
    if args.json:
        print(f"wrote {args.json} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()
