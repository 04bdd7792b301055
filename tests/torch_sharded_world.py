"""The sharded plans' cases, run on a local gloo world of CPU processes.

``run_world`` spawns ``WORLD`` processes (or ``world``) that join one gloo
process group (a file store, so concurrent test workers never share a
port), build the meshes (``"fft"`` and ``"batch"`` of the world's size,
``("p", "q")`` of 1 by it and, on 4 ranks, ``("x", "y")`` of 2x2), run
every case named, each on every rank, and return rank 0's results: a dict
per case of numpy arrays and plain values, or ``{"error": traceback}``.
The tests hold them against numpy and the port's single-device surface.

This module imports the port and torch only, never JAX: the children
import it (and not the test files, whose conftest loads JAX).
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode

import fourier_tpu_torch as tft
from fourier_tpu_torch import parallel
from fourier_tpu_torch.parallel import exchange as ex
from fourier_tpu_torch.parallel import sharded
from fourier_tpu_torch.transform import Transform

WORLD = 4
SEED = 0xFEED
CASES = {}


class Ctx:
    """What a case gets: the meshes, this rank, and the caller's `extra`."""

    def __init__(self, rank, extra, world=WORLD):
        self.rank = rank
        self.extra = extra
        self.fft = init_device_mesh("cpu", (world,), mesh_dim_names=("fft",))
        self.batch = init_device_mesh("cpu", (world,), mesh_dim_names=("batch",))
        self.xy = (init_device_mesh("cpu", (2, 2), mesh_dim_names=("x", "y"))
                   if world == 4 else None)
        self.pq = init_device_mesh("cpu", (1, world), mesh_dim_names=("p", "q"))


def case(*params):
    """Register a case, once per parameter tuple (named fn[p1-p2...])."""
    def deco(fn):
        for p in params or [()]:
            p = p if isinstance(p, tuple) else (p,)
            name = fn.__name__ + (f"[{'-'.join(str(v) for v in p)}]" if p else "")
            CASES[name] = (fn, p)
        return fn
    return deco


def rng():
    return np.random.default_rng(SEED)


def cx(shape, dtype=np.complex64):
    r = rng()
    return (r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(dtype)


def real(shape, dtype=np.float32):
    return rng().standard_normal(shape).astype(dtype)


def planes(x):
    t = torch.as_tensor(x)
    return t.real.contiguous(), t.imag.contiguous()


def full(*ds):
    """numpy of whole DTensors; two planes join into one complex array."""
    arrs = [d.full_tensor().numpy() for d in ds]
    return arrs[0] + 1j * arrs[1] if len(arrs) == 2 else arrs[0]


def placements(*ds):
    return [[repr(p) for p in d.placements] for d in ds]


# -- batch sharding -----------------------------------------------------------


@case("c64", "c128")
def batched_transform(ctx, kind):
    dt = np.complex64 if kind == "c64" else np.complex128
    x = cx((16, 64 if kind == "c64" else 32), dt)
    plan = tft.create_fft(x.shape[-1], dt, device="cpu")
    out = parallel.batched_transform(plan, *planes(x), ctx.batch, axis="batch")
    inv = parallel.batched_transform(plan, *planes(x), ctx.batch, axis="batch",
                                     transform=Transform.IFFT)
    return {"x": x, "y": full(*out), "inv": full(*inv), "placements": placements(*out)}


@case((96, "c64"), (27, "c64"), (64, "c128"), (128, "vpu"), (769, "vpu"))
def batched_rfft(ctx, n, kind):
    dt = np.float64 if kind == "c128" else np.float32
    x = real((4 * WORLD, n), dt)
    cdt = np.complex128 if kind == "c128" else np.complex64
    plan = tft.RfftPlan(n, cdt, backend="vpu" if kind == "vpu" else "auto", device="cpu")
    re, im = parallel.batched_rfft(plan, x, ctx.batch, axis="batch")
    back = parallel.batched_irfft(plan, re, im, ctx.batch, axis="batch")
    return {"x": x, "y": full(re, im), "back": full(back), "fused": plan.fused,
            "placements": placements(re, im, back)}


# -- FourStepPlan -------------------------------------------------------------


@case((16, 16), (32, 8), (24, 8))
def four_step_natural(ctx, n1, n2):
    x = cx(n1 * n2)
    plan = parallel.FourStepPlan(n1, n2, ctx.fft, natural_order=True)
    out = plan.fft_planar(*planes(x.reshape(n1, n2)))
    return {"x": x, "y": full(*out), "placements": placements(*out)}


@case()
def four_step_digit_order_and_inverse(ctx):
    n1 = n2 = 16
    x = cx(n1 * n2)
    plan = parallel.FourStepPlan(n1, n2, ctx.fft)
    out = plan.fft_planar(*planes(x.reshape(n1, n2)))
    inv = plan.transform_planar(*planes(x.reshape(n1, n2)), Transform.IFFT)
    return {"x": x, "y": full(*out), "inv": full(*inv), "placements": placements(*out)}


@case()
def four_step_roundtrip_natural(ctx):
    n1 = n2 = 16
    x = cx(n1 * n2)
    plan = parallel.FourStepPlan(n1, n2, ctx.fft, natural_order=True)
    spec = full(*plan.fft_planar(*planes(x.reshape(n1, n2))))
    back = full(*plan.transform_planar(*planes(spec.reshape(n1, n2)), Transform.IFFT))
    return {"x": x, "back": back}


@case()
def four_step_batch_dims_and_complex_api(ctx):
    x = cx((3, 256))
    plan = parallel.FourStepPlan(16, 16, ctx.fft, natural_order=True)
    y = plan.fft(x)
    return {"x": x, "y": y, "back": plan.ifft(y)}


@case(2, 4)
def four_step_pipelined(ctx, chunks):
    x = cx((16, 32))
    base = parallel.FourStepPlan(16, 32, ctx.fft, natural_order=True)
    piped = parallel.FourStepPlan(16, 32, ctx.fft, natural_order=True,
                                  pipeline_chunks=chunks)
    digit = parallel.FourStepPlan(16, 32, ctx.fft, pipeline_chunks=chunks)
    return {"x": x, "base": full(*base.fft_planar(*planes(x))),
            "piped": full(*piped.fft_planar(*planes(x))),
            "digit": full(*digit.fft_planar(*planes(x))),
            "digit_base": full(*parallel.FourStepPlan(16, 32, ctx.fft).fft_planar(
                *planes(x)))}


@case("dd", "stockham")
def four_step_c128_natural(ctx, backend):
    x = cx(16 * 16, np.complex128)
    plan = parallel.FourStepPlan(16, 16, ctx.fft, dtype=torch.complex128,
                                 natural_order=True, backend=backend)
    y = plan.fft(x)
    return {"x": x, "y": y, "back": plan.ifft(y)}


# -- Fft2dPlan ----------------------------------------------------------------

MODES = {"FFT": Transform.FFT, "IFFT": Transform.IFFT,
         "SQRT": Transform.SQRT_SCALED_FFT, "UNSCALED": Transform.UNSCALED_IFFT}


@case(*[(n1, n2, m) for n1, n2 in ((32, 16), (16, 48)) for m in ("FFT", "IFFT")],
      (16, 16, "SQRT"), (16, 16, "UNSCALED"))
def fft2d(ctx, n1, n2, mode):
    x = cx((n1, n2))
    plan = parallel.Fft2dPlan(n1, n2, ctx.fft)
    out = plan.transform_planar(*planes(x), MODES[mode])
    return {"x": x, "y": full(*out), "placements": placements(*out)}


@case()
def fft2d_transposed_output(ctx):
    x = cx((16, 32))
    plan = parallel.Fft2dPlan(16, 32, ctx.fft, transposed_output=True)
    out = plan.fft_planar(*planes(x))
    return {"x": x, "y": full(*out), "placements": placements(*out)}


@case()
def fft2d_roundtrip(ctx):
    x = cx((16, 16))
    plan = parallel.Fft2dPlan(16, 16, ctx.fft)
    f = plan.fft_planar(*planes(x))
    return {"x": x, "back": full(*plan.ifft_planar(*f))}


@case()
def fft2d_batch_dims_and_complex_api(ctx):
    x = cx((2, 16, 32))
    plan = parallel.Fft2dPlan(16, 32, ctx.fft)
    y = plan.fft(x)
    return {"x": x, "y": y, "back": plan.ifft(torch.as_tensor(y)).numpy()}


@case(2, 4)
def fft2d_pipelined(ctx, chunks):
    x = cx((32, 16))
    base = parallel.Fft2dPlan(32, 16, ctx.fft)
    piped = parallel.Fft2dPlan(32, 16, ctx.fft, pipeline_chunks=chunks)
    tb = parallel.Fft2dPlan(32, 16, ctx.fft, transposed_output=True)
    tp = parallel.Fft2dPlan(32, 16, ctx.fft, transposed_output=True,
                            pipeline_chunks=chunks)
    return {"base": full(*base.fft_planar(*planes(x))),
            "piped": full(*piped.fft_planar(*planes(x))),
            "tbase": full(*tb.ifft_planar(*planes(x))),
            "tpiped": full(*tp.ifft_planar(*planes(x)))}


@case()
def fft2d_dtensor_in_and_out(ctx):
    """DTensors in, DTensors out with the JAX out_specs; a transposed result
    fed straight to a plan of the swapped shape, a natural one back to the
    same plan: no whole array on the way."""
    x = cx((2, 16, 32))
    plan = parallel.Fft2dPlan(16, 32, ctx.fft)
    tplan = parallel.Fft2dPlan(16, 32, ctx.fft, transposed_output=True)
    back_t = parallel.Fft2dPlan(32, 16, ctx.fft, transposed_output=True)
    re, im = planes(x)
    k = 16 // WORLD
    loc = [t[:, ctx.rank * k:(ctx.rank + 1) * k] for t in (re, im)]
    dre, dim = (DTensor.from_local(t, ctx.fft, [sharded.Shard(1)], run_check=False)
                for t in loc)
    f = plan.fft_planar(dre, dim)
    back = plan.ifft_planar(*f)
    t = tplan.fft_planar(dre, dim)        # (2, 32, 16): the 2-D FFT transposed
    tt = back_t.ifft_planar(*t)           # its inverse, transposed back
    return {"x": x, "y": full(*f), "back": full(*back), "tt": full(*tt),
            "types": [type(d).__name__ for d in (*f, *back, *t, *tt)],
            "placements": placements(*f, *t)}


@case("native", "dd")
def fft2d_c128(ctx, backend):
    x = cx((16, 16), np.complex128)
    plan = parallel.Fft2dPlan(16, 16, ctx.fft, dtype=torch.complex128,
                              pipeline_chunks=2,
                              backend="stockham" if backend == "native" else backend)
    y = plan.fft(x)
    return {"x": x, "y": y, "back": plan.ifft(y)}


# -- Fft3dPlan ----------------------------------------------------------------


@case(*[(d, m) for d in ("8x8x8", "4x8x16") for m in ("FFT", "IFFT")])
def fft3d_pencil(ctx, dims, mode):
    shape = tuple(int(v) for v in dims.split("x"))
    x = cx(shape)
    plan = parallel.Fft3dPlan(*shape, ctx.xy)
    return {"x": x, "y": plan.transform(x, MODES[mode])}


@case()
def fft3d_spectral_roundtrip(ctx):
    x = cx((8, 8, 8))
    natural = parallel.Fft3dPlan(8, 8, 8, ctx.xy)
    spectral = parallel.Fft3dPlan(8, 8, 8, ctx.xy, spectral_output=True)
    sre, sim = spectral.fft_planar(*planes(x))
    back = spectral.transform_planar(sre, sim, Transform.IFFT, from_spectral=True)
    return {"x": x, "ys": full(sre, sim), "yn": natural.fft(x), "back": full(*back),
            "placements": placements(sre, sim, *back)}


@case("fft", "pq")
def fft3d_slab_one_mesh_axis(ctx, mesh):
    """The slab over the 1-D mesh, and over the ("p", "q") mesh with q the
    only dim of size > 1 (p, of size 1, shards n0)."""
    x = cx((16, 16, 4))
    if mesh == "fft":
        plan = parallel.Fft3dPlan(16, 16, 4, ctx.fft, axes=("fft",))
    else:
        plan = parallel.Fft3dPlan(16, 16, 4, ctx.pq, axes=("p", "q"))
    y = plan.fft(x)
    return {"x": x, "y": y, "back": plan.ifft(y)}


@case()
def fft3d_batch_dims_and_planar_api(ctx):
    x = cx((2, 8, 8, 8))
    plan = parallel.Fft3dPlan(8, 8, 8, ctx.xy)
    out = plan.fft_planar(*planes(x))
    y = full(*out)
    return {"x": x, "y": y, "back": plan.ifft(y), "placements": placements(*out)}


@case("native", "dd")
def fft3d_c128(ctx, backend):
    x = cx((16, 8, 8), np.complex128)
    plan = parallel.Fft3dPlan(16, 8, 8, ctx.xy, dtype=torch.complex128,
                              backend="stockham" if backend == "native" else backend)
    y = plan.fft(x)
    return {"x": x, "y": y, "back": plan.ifft(y)}


@case(2, 4)
def fft3d_pipelined(ctx, chunks):
    x = cx((8, 8, 16))
    out = {}
    for spectral in (False, True):
        base = parallel.Fft3dPlan(8, 8, 16, ctx.xy, spectral_output=spectral)
        piped = parallel.Fft3dPlan(8, 8, 16, ctx.xy, spectral_output=spectral,
                                   pipeline_chunks=chunks)
        b, p = base.fft_planar(*planes(x)), piped.fft_planar(*planes(x))
        out[f"base{int(spectral)}"], out[f"piped{int(spectral)}"] = full(*b), full(*p)
        if spectral:
            out["back_base"] = full(*base.transform_planar(*b, Transform.IFFT,
                                                           from_spectral=True))
            out["back_piped"] = full(*piped.transform_planar(*p, Transform.IFFT,
                                                             from_spectral=True))
    out["x"] = x
    return out


# -- Rfft3dPlan ---------------------------------------------------------------


@case("8x8x16", "4x8x9")
def rfft3d_pencil(ctx, dims):
    shape = tuple(int(v) for v in dims.split("x"))
    x = real(shape)
    plan = parallel.Rfft3dPlan(*shape, ctx.xy)
    y = plan.rfft(x)
    return {"x": x, "y": y, "back": plan.irfft(y)}


@case()
def rfft3d_planar_pad_contract(ctx):
    x = real((8, 8, 16))
    plan = parallel.Rfft3dPlan(8, 8, 16, ctx.xy)    # out_len 9, n2p 10 over |y| = 2
    re, im = plan.rfft_planar(x)
    back = plan.irfft_planar(re, im)
    return {"x": x, "n": (plan.out_len, plan.n2p), "re": full(re), "im": full(im),
            "back": full(back), "placements": placements(re, im, back)}


@case()
def rfft3d_spectral_roundtrip(ctx):
    x = real((8, 8, 16))
    plan = parallel.Rfft3dPlan(8, 8, 16, ctx.xy, spectral_output=True)
    re, im = plan.rfft_planar(x)
    back = plan.irfft_planar(re, im, from_spectral=True)
    return {"x": x, "y": full(re, im), "back": full(back),
            "placements": placements(re, im, back), "out_len": plan.out_len}


@case("fft", "pq")
def rfft3d_slab_and_batch_dims(ctx, mesh):
    x = real((2, 8, 8, 10))
    if mesh == "fft":
        plan = parallel.Rfft3dPlan(8, 8, 10, ctx.fft, axes=("fft",))
    else:  # q of 4 pads the 6 bins to 8
        plan = parallel.Rfft3dPlan(8, 8, 10, ctx.pq, axes=("p", "q"))
    y = plan.rfft(x)
    return {"x": x, "y": y, "back": plan.irfft(y), "n": (plan.out_len, plan.n2p)}


@case("native", "dd")
def rfft3d_c128(ctx, backend):
    x = real((4, 8, 16), np.float64)
    plan = parallel.Rfft3dPlan(4, 8, 16, ctx.xy, dtype=torch.complex128,
                               backend="stockham" if backend == "native" else backend)
    y = plan.rfft(x)
    return {"x": x, "y": y, "back": plan.irfft(y)}


@case(2, 4)
def rfft3d_pipelined(ctx, chunks):
    x = real((8, 8, 16))
    out = {"x": x}
    for spectral in (False, True):
        base = parallel.Rfft3dPlan(8, 8, 16, ctx.xy, spectral_output=spectral)
        piped = parallel.Rfft3dPlan(8, 8, 16, ctx.xy, spectral_output=spectral,
                                    pipeline_chunks=chunks)
        b, p = base.rfft_planar(x), piped.rfft_planar(x)
        out[f"base{int(spectral)}"], out[f"piped{int(spectral)}"] = full(*b), full(*p)
        out[f"back_base{int(spectral)}"] = full(base.irfft_planar(
            *b, from_spectral=spectral))
        out[f"back_piped{int(spectral)}"] = full(piped.irfft_planar(
            *p, from_spectral=spectral))
    return out


@case()
def spectral_layout_halves_exchanges(ctx):
    """A filter round trip in the spectral layout makes half the exchanges
    of the natural one (the counterpart of the JAX package's HLO count)."""
    x = real((8, 8, 16))
    counts = {}
    for name, spectral in (("natural", False), ("spectral", True)):
        plan = parallel.Rfft3dPlan(8, 8, 16, ctx.xy, spectral_output=spectral)
        before = ex.exchange.launches
        re, im = plan.rfft_planar(x)
        plan.irfft_planar(re, im, from_spectral=spectral)
        counts[name] = ex.exchange.launches - before
    return counts


# -- Rfft2dPlan ---------------------------------------------------------------


@case(32, 21)
def rfft2d(ctx, n2):
    x = real((16, n2))
    plan = parallel.Rfft2dPlan(16, n2, ctx.fft)
    y = plan.rfft(x)
    spec = plan.rfft_planar(x)
    return {"x": x, "y": y, "back": plan.irfft(y), "n": (plan.out_len, plan.n2p),
            "placements": placements(*spec, plan.irfft_planar(*spec))}


@case()
def rfft2d_transposed_roundtrip_and_batch(ctx):
    x = real((3, 16, 32))
    plan = parallel.Rfft2dPlan(16, 32, ctx.fft, transposed_output=True)
    re, im = plan.rfft_planar(x)
    back = plan.irfft_planar(re, im, from_transposed=True)
    return {"x": x, "y": full(re, im), "back": full(back), "n2p": plan.n2p,
            "placements": placements(re, im, back), "rfft": plan.rfft(x)}


@case("native", "dd")
def rfft2d_c128(ctx, backend):
    x = real((8, 24), np.float64)
    plan = parallel.Rfft2dPlan(8, 24, ctx.fft, dtype=torch.complex128,
                               backend="stockham" if backend == "native" else backend)
    y = plan.rfft(x)
    return {"x": x, "y": y, "back": plan.irfft(y)}


# -- the card's routes, on their kernels' plain versions -------------------------


@case()
def card_routes(ctx):
    """Each plan over the sub-plans a card gives it (backend "vpu"/"dd"): B1
    at 64 and 128, B4a/B4b at n2 = 128 (m = 64), B5a/B5b at 769 (B2's
    inner), B6 at 64 and 96 in c128, run here on the plain versions."""
    out = {}
    x = cx((64, 128))
    out["fft2d_x"], out["fft2d"] = x, parallel.Fft2dPlan(64, 128, ctx.fft,
                                                         backend="vpu").fft(x)
    out["four_x"] = cx(64 * 128)
    out["four"] = parallel.FourStepPlan(64, 128, ctx.fft, natural_order=True,
                                        backend="vpu").fft(out["four_x"])
    for n2 in (128, 769):
        xr = real((8, n2))
        plan = parallel.Rfft2dPlan(8, n2, ctx.fft, backend="vpu")
        y = plan.rfft(xr)
        out[f"rfft2d{n2}_x"], out[f"rfft2d{n2}"] = xr, y
        out[f"rfft2d{n2}_back"], out[f"fused{n2}"] = plan.irfft(y), plan.rplan.fused
    xd = cx((64, 96), np.complex128)
    out["dd_x"], out["dd"] = xd, parallel.Fft2dPlan(64, 96, ctx.fft, dtype=torch.complex128,
                                                    backend="dd").fft(xd)
    x3 = real((8, 8, 128))
    plan3 = parallel.Rfft3dPlan(8, 8, 128, ctx.xy, backend="vpu")
    out["rfft3d_x"], out["rfft3d"] = x3, plan3.rfft(x3)
    out["rfft3d_back"] = plan3.irfft(out["rfft3d"])
    return out


# -- validation, modules, files, summaries --------------------------------------


def _raises(fn):
    try:
        fn()
    except Exception as e:  # the test reads the type and the message
        return [type(e).__name__, str(e)]
    return None


@case()
def validation(ctx):
    P = parallel
    checks = {
        "four_step_n1": lambda: P.FourStepPlan(9, 16, ctx.fft),
        "fft2d_n2": lambda: P.Fft2dPlan(16, 9, ctx.fft),
        "fft2d_chunks": lambda: P.Fft2dPlan(16, 16, ctx.fft, pipeline_chunks=3),
        "four_step_chunks0": lambda: P.FourStepPlan(16, 16, ctx.fft, pipeline_chunks=0),
        "fft3d_n0": lambda: P.Fft3dPlan(7, 8, 8, ctx.xy),
        "fft3d_n2": lambda: P.Fft3dPlan(8, 8, 6, ctx.pq, axes=("p", "q")),
        "fft3d_axes": lambda: P.Fft3dPlan(8, 8, 8, ctx.xy, axes=("x", "y", "z")),
        "fft3d_names": lambda: P.Fft3dPlan(8, 8, 8, ctx.fft),
        "fft3d_chunks0": lambda: P.Fft3dPlan(8, 8, 8, ctx.xy, pipeline_chunks=0),
        "rfft3d_n0": lambda: P.Rfft3dPlan(7, 8, 8, ctx.xy),
        "rfft3d_n1": lambda: P.Rfft3dPlan(8, 6, 8, ctx.pq, axes=("p", "q")),
        "rfft3d_axes": lambda: P.Rfft3dPlan(8, 8, 8, ctx.xy, axes=("x", "y", "z")),
        "rfft2d_n1": lambda: P.Rfft2dPlan(6, 8, ctx.fft),
    }
    out = {k: _raises(f) for k, f in checks.items()}
    plan = P.Rfft3dPlan(8, 8, 16, ctx.xy)
    out["rfft3d_shape"] = _raises(lambda: plan.rfft_planar(torch.zeros(8, 8, 12)))
    out["rfft3d_pad_tail"] = _raises(lambda: plan.irfft_planar(
        torch.zeros(8, 8, 9), torch.zeros(8, 8, 9)))
    f2 = P.Fft2dPlan(16, 16, ctx.fft)
    out["fft2d_shape"] = _raises(lambda: f2.fft_planar(torch.zeros(16, 8),
                                                       torch.zeros(16, 8)))
    d = DTensor.from_local(torch.zeros(16, 4), ctx.fft, [sharded.Shard(1)],
                           run_check=False)
    out["fft2d_placements"] = _raises(lambda: f2.fft_planar(d, d))
    r2 = P.Rfft2dPlan(16, 32, ctx.fft)
    out["rfft2d_pad_tail"] = _raises(lambda: r2.irfft_planar(torch.zeros(16, 17),
                                                             torch.zeros(16, 17)))
    out.update(_uneven_batches(ctx, 6))
    return out


def _batched_calls(n, x, mesh):
    """batched_transform, batched_rfft and batched_irfft of the rows of the
    real (B, n) `x` (its one-sided spectrum for the inverse) on `mesh`."""
    P = parallel
    plan = tft.create_fft(n, np.complex64, device="cpu")
    rplan = tft.RfftPlan(n, np.complex64, device="cpu")
    spec = np.fft.rfft(x.astype(np.float64)).astype(np.complex64)
    xt, sre, sim = torch.as_tensor(x), *planes(spec)
    return {
        "transform": lambda f: P.batched_transform(plan, f(xt), f(xt.flip(-1)), mesh),
        "rfft": lambda f: P.batched_rfft(rplan, f(xt), mesh),
        "irfft": lambda f: P.batched_irfft(rplan, f(sre), f(sim), mesh),
    }


def _uneven_batches(ctx, rows):
    """The errors of the batch-sharded calls on `rows` rows, which the batch
    mesh does not divide: as tensors and as (uneven) Shard(0) DTensors."""
    out = {}
    for call, fn in _batched_calls(16, real((rows, 16)), ctx.batch).items():
        out[f"batched_{call}_uneven"] = _raises(lambda: fn(lambda t: t))
        out[f"batched_{call}_uneven_dtensor"] = _raises(lambda: fn(
            lambda t: distribute_tensor(t, ctx.batch, [Shard(0)])))
    return out


@case()
def three_ranks(ctx):
    """On a 3-rank world: 10 rows refused, 9 rows against the single-device
    call."""
    out = _uneven_batches(ctx, 10)
    x = real((9, 48))
    for call, fn in _batched_calls(48, x, ctx.batch).items():
        got = fn(lambda t: t)
        out[call] = full(*got) if isinstance(got, tuple) else full(got)
    out["x"] = x
    return out


@case()
def plans_are_modules(ctx):
    """The place of the pytree registration: nn.Modules owning their
    sub-plans and tables, the mesh an attribute."""
    out = {}
    plans = {"four": parallel.FourStepPlan(16, 32, ctx.fft),
             "fft2d": parallel.Fft2dPlan(16, 16, ctx.fft),
             "fft3d": parallel.Fft3dPlan(8, 8, 16, ctx.xy),
             "rfft2d": parallel.Rfft2dPlan(16, 32, ctx.fft),
             "rfft3d": parallel.Rfft3dPlan(8, 8, 16, ctx.xy)}
    for k, p in plans.items():
        out[k] = {"module": isinstance(p, torch.nn.Module), "mesh": p.mesh is
                  (ctx.xy if k.endswith("3d") else ctx.fft),
                  "subplans": sorted(n for n, _ in p.named_children()),
                  "buffers": sorted(n for n, _ in p.named_buffers()),
                  "len": len(p), "repr": repr(p).splitlines()[0]}
    four = plans["four"]
    out["tw_shape"] = tuple(four.tw_fwd.shape)
    out["tw_local"] = four.tw_fwd.numpy()
    out["rank"] = ctx.rank
    return out


@case()
def serialize_roundtrip(ctx):
    d = ctx.extra["tmp"]
    out = {}
    plans = {"fft2d": (parallel.Fft2dPlan(16, 32, ctx.fft, pipeline_chunks=2), ctx.fft),
             "four": (parallel.FourStepPlan(16, 16, ctx.fft, natural_order=True), ctx.fft),
             "fft3d": (parallel.Fft3dPlan(8, 8, 8, ctx.xy), ctx.xy),
             "rfft2d": (parallel.Rfft2dPlan(8, 24, ctx.fft), ctx.fft),
             "rfft3d": (parallel.Rfft3dPlan(8, 8, 16, ctx.xy), ctx.xy)}
    for k, (plan, mesh) in plans.items():
        path = os.path.join(d, f"{k}-{ctx.rank}.npz")
        tft.save_plan(plan, path)
        if k == "fft2d":
            out["missing_mesh"] = _raises(lambda: tft.load_plan(path, device="cpu"))
            out["wrong_mesh"] = _raises(lambda: tft.load_plan(path, device="cpu",
                                                              mesh=ctx.batch))
            out["wrong_shape"] = _raises(lambda: tft.load_plan(path, device="cpu",
                                                               mesh=ctx.pq))
        again = tft.load_plan(path, device="cpu", mesh=mesh)
        again_b = tft.load_plan(tft.plan_to_bytes(plan), device="cpu", mesh=mesh)
        same_buffers = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            plan.named_buffers(), again.named_buffers()))
        if k.startswith("rfft"):
            x = real((8,) + ((24,) if k == "rfft2d" else (8, 16)))
            outs = [full(p.rfft_planar(x)[0]) for p in (plan, again, again_b)]
        else:
            shape = {"fft2d": (16, 32), "four": (16, 16), "fft3d": (8, 8, 8)}[k]
            outs = [full(*p.fft_planar(*planes(cx(shape)))) for p in (plan, again, again_b)]
        out[k] = {"type": type(again).__name__, "mesh": again.mesh is mesh,
                  "buffers": same_buffers, "repr": repr(again) == repr(plan),
                  "bitwise": all(np.array_equal(outs[0], o) for o in outs[1:])}
    return out


@case()
def summaries(ctx):
    plans = {"FourStepPlan": parallel.FourStepPlan(16, 16, ctx.fft),
             "Fft2dPlan": parallel.Fft2dPlan(32, 16, ctx.fft, pipeline_chunks=2),
             "Rfft2dPlan": parallel.Rfft2dPlan(16, 21, ctx.fft),
             "Fft3dPlan": parallel.Fft3dPlan(8, 8, 8, ctx.xy),
             "Rfft3dPlan": parallel.Rfft3dPlan(8, 8, 16, ctx.xy, spectral_output=True)}
    out = {}
    for k, p in plans.items():
        s = tft.summarize(p)
        out[k] = {"kind": s.kind, "size": s.size, "flops": s.flops_per_transform,
                  "bytes": s.min_hbm_bytes_per_transform, "stages": s.stages,
                  "children": [c.kind for c in s.children],
                  "describe": tft.describe(p)}
    return out


# -- parity with the JAX package: its inputs and plan files come in `extra` -------


def _summary(plan):
    s = tft.summarize(plan)
    return {"kind": s.kind, "size": s.size, "flops": s.flops_per_transform,
            "bytes": s.min_hbm_bytes_per_transform, "stages": len(s.stages),
            "children": [c.kind for c in s.children]}


@case()
def parity(ctx):
    """The three parity shapes through the port's own plans, and each plan
    file the JAX package saved, loaded with load_jax_plan and run on the
    same input (c64 and native-f64 c128; a double-word one refused)."""
    e = ctx.extra
    meshes = {"fft": ctx.fft, "xy": ctx.xy}
    four = parallel.FourStepPlan(16, 16, ctx.fft, pipeline_chunks=2)
    fft2 = parallel.Fft2dPlan(32, 16, ctx.fft, transposed_output=True)
    rf3 = parallel.Rfft3dPlan(8, 8, 8, ctx.xy, spectral_output=True)
    out = {"four": full(*four.fft_planar(*planes(e["x_four"]))),
           "fft2d": full(*fft2.fft_planar(*planes(e["x_fft2d"]))),
           "rfft3d": full(*rf3.rfft_planar(e["x_rfft3d"])),
           "summaries": {k: _summary(p) for k, p in
                         (("four", four), ("fft2d", fft2), ("rfft3d", rf3))}}
    for name, (path, mesh, kind) in e["files"].items():
        plan = tft.load_jax_plan(path, device="cpu", mesh=meshes[mesh])
        x = e["inputs"][name]
        if kind == "real":
            got = full(*plan.rfft_planar(x))
        else:
            got = full(*plan.fft_planar(*planes(x)))
        out["loaded", name] = {"type": type(plan).__name__, "y": got,
                               "subplans": sorted(type(c).__name__
                                                  for c in plan.children())}
    path = e["files"]["fft2d"][0]
    out["no_mesh"] = _raises(lambda: tft.load_jax_plan(path, device="cpu"))
    out["wrong_mesh"] = _raises(lambda: tft.load_jax_plan(path, device="cpu",
                                                          mesh=ctx.xy))
    out["dd"] = _raises(lambda: tft.load_jax_plan(e["dd_file"], device="cpu",
                                                  mesh=ctx.fft))
    return out


# -- layout: copies per leg ---------------------------------------------------------

_COPIES = {"aten::copy_", "aten::clone", "aten::_to_copy", "aten::cat", "aten::stack",
           "aten::constant_pad_nd", "aten::index", "aten::gather"}


class _Trace(TorchDispatchMode):
    """Events of a sharded call: "K" a 1-D plan's batch-minor call (its own
    ops not traced), "X" an exchange of one plane, "C" a copy."""

    def __init__(self):
        super().__init__()
        self.events, self.quiet, self.data = [], 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        out = func(*args, **(kwargs or {}))
        if not self.quiet:
            if name in _COPIES:
                written = out if isinstance(out, torch.Tensor) else args[0]
                self.events.append(("C", written.numel()))
            elif "alltoall" in name:
                self.events.append("X")
        return out


def _spy(trace, plan, method, size, sizes_seen):
    run = getattr(plan, method)

    def spy(*planes, **kw):
        planes_in = [p for p in planes if isinstance(p, torch.Tensor)]
        sizes_seen.append((method, size, [(tuple(p.shape), p.is_contiguous())
                                          for p in planes_in]))
        trace.events.append("K")
        trace.data.append(sum(p.numel() for p in planes_in))
        trace.quiet += 1
        try:
            return run(*planes, **kw)
        finally:
            trace.quiet -= 1
    setattr(plan, method, spy)


def _copies(call, subplans):
    """The elements copied between two kernel or exchange events (one
    entry a segment), the most elements a kernel or the result holds (every
    plane), the events, and every kernel call's (method, size, [(shape,
    contiguous)])."""
    trace, seen = _Trace(), []
    for plan, method in subplans:
        _spy(trace, plan, method, getattr(plan, "size", getattr(plan, "n", None)), seen)
    try:
        with trace:
            out = call()
    finally:
        for plan, method in subplans:
            delattr(plan, method)
    out = out if isinstance(out, tuple) else (out,)
    segments, cur = [], 0
    for e in trace.events + ["end"]:
        if isinstance(e, tuple):
            cur += e[1]
        else:
            segments.append(cur)
            cur = 0
    data = max(trace.data + [sum(o.to_local().numel() for o in out)])
    return {"events": "".join(e if isinstance(e, str) else "C" for e in trace.events),
            "segments": segments, "data": data, "kernels": seen}


@case()
def copies_per_leg(ctx):
    """Each plan on the card's routes (the batch-minor kernels' layout):
    copies between two kernel or exchange events, per plane."""
    out = {}
    bm = "transform_planar_bm"
    f2 = parallel.Fft2dPlan(64, 128, ctx.fft, backend="vpu")
    x2 = planes(cx((2, 64, 128)))
    out["fft2d"] = _copies(lambda: f2.fft_planar(*x2), [(f2.col_plan, bm),
                                                        (f2.row_plan, bm)])
    f2c = parallel.Fft2dPlan(64, 128, ctx.fft, backend="vpu", pipeline_chunks=2)
    out["fft2d_chunked"] = _copies(lambda: f2c.fft_planar(*x2), [(f2c.col_plan, bm),
                                                                 (f2c.row_plan, bm)])
    ft = parallel.Fft2dPlan(64, 128, ctx.fft, backend="vpu", transposed_output=True)
    out["fft2d_transposed"] = _copies(lambda: ft.fft_planar(*x2), [(ft.col_plan, bm),
                                                                   (ft.row_plan, bm)])
    fs = parallel.FourStepPlan(64, 128, ctx.fft, backend="vpu", natural_order=True)
    x4 = planes(cx((64, 128)))
    out["four_step"] = _copies(lambda: fs.fft_planar(*x4), [(fs.col_plan, bm),
                                                           (fs.row_plan, bm)])
    f3 = parallel.Fft3dPlan(64, 64, 128, ctx.xy, backend="vpu")
    x3 = planes(cx((64, 64, 128)))
    out["fft3d"] = _copies(lambda: f3.fft_planar(*x3), [(f3.plan0, bm), (f3.plan2, bm)])
    s3 = parallel.Fft3dPlan(64, 64, 128, ctx.xy, backend="vpu", spectral_output=True,
                            pipeline_chunks=2)
    spec = s3.fft_planar(*x3)
    out["fft3d_from_spectral"] = _copies(
        lambda: s3.transform_planar(*spec, Transform.IFFT, from_spectral=True),
        [(s3.plan0, bm), (s3.plan2, bm)])
    r2 = parallel.Rfft2dPlan(64, 128, ctx.fft, backend="vpu")
    xr = real((64, 128))
    sub = [(r2.rplan, "rfft_planar_bm"), (r2.rplan, "irfft_planar_bm"), (r2.col_plan, bm)]
    out["rfft2d"] = _copies(lambda: r2.rfft_planar(xr), sub)
    y = r2.rfft_planar(xr)
    out["irfft2d"] = _copies(lambda: r2.irfft_planar(*y), sub)
    r3 = parallel.Rfft3dPlan(64, 64, 128, ctx.xy, backend="vpu")
    xr3 = real((64, 64, 128))
    sub3 = [(r3.rplan, "rfft_planar_bm"), (r3.rplan, "irfft_planar_bm"),
            (r3.plan0, bm)]
    out["rfft3d"] = _copies(lambda: r3.rfft_planar(xr3), sub3)
    y3 = r3.rfft_planar(xr3)
    out["irfft3d"] = _copies(lambda: r3.irfft_planar(*y3), sub3)
    plan = tft.create_fft(128, device="cpu", backend="vpu", cache=False)
    xb = planes(cx((16, 128)))
    out["batched"] = _copies(lambda: parallel.batched_transform(
        plan, *xb, ctx.batch, axis="batch"), [(plan, bm)])
    return out


# -- the world ------------------------------------------------------------------------


def _rank_main(rank, store, names, out_path, extra, world):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=120))
    try:
        ctx = Ctx(rank, extra, world)
        results = {}
        for name in names:
            fn, params = CASES[name]
            try:
                results[name] = fn(ctx, *params)
            except Exception:  # recorded for the case's test, the world goes on
                results[name] = {"error": traceback.format_exc()}
            dist.barrier()
        if rank == 0:
            with open(out_path + ".tmp", "wb") as f:
                pickle.dump(results, f)
            os.replace(out_path + ".tmp", out_path)
    finally:
        dist.destroy_process_group()


def run_world(tmp_dir, names=None, extra=None, timeout=300.0, world=WORLD) -> dict:
    """Run the cases `names` (default all but ``three_ranks``) on a fresh
    world of `world` processes; rank 0's results."""
    names = [c for c in CASES if c != "three_ranks"] if names is None else list(names)
    extra = dict(extra or {}, tmp=str(tmp_dir))
    out_path = os.path.join(str(tmp_dir), "results.pkl")
    store = os.path.join(str(tmp_dir), "store")
    context = mp.start_processes(_rank_main, args=(store, names, out_path, extra, world),
                                 nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not context.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the gloo world did not finish in {timeout} s")
    finally:
        for p in context.processes:
            if p.is_alive():
                p.terminate()
            p.join(5)
    with open(out_path, "rb") as f:
        return pickle.load(f)
