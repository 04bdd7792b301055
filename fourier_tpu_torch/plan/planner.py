"""Runtime planner: ``create_fft_f32`` / ``create_fft_f64``.

Port of the ``auto``, ``vpu``, ``mxu`` and ``stockham`` backends of
``fourier_tpu/plan/planner.py``, with the same plan family for every size:

* ``vpu``      -- :class:`VpuFftPlan` (kernel B1) in its domain, else the
                  ``mxu`` route with the fused kernels first
                  (``_create_mxu(vpu_first=True)``): four-step composites
                  whose legs are VpuFftPlans (kernel B3 on the rows),
                  :class:`MxuFftPlan` products, :class:`VpuBluesteinPlan`
                  (kernel B2) for split-less sizes past the direct-product
                  crossover, else a composed :class:`BluesteinPlan`.
                  complex64 only.
* ``mxu``      -- the same route without the fused kernels first: DFT
                  products, four-step and Bluestein over them. complex64
                  only.
* ``stockham`` -- plain PyTorch Stockham autosort (2^a*3^b) + Bluestein, in
                  complex64 or complex128 on any device.
* ``auto``     -- ``vpu`` for complex64 on a CUDA device, else ``stockham``
                  (as the JAX package picks ``stockham`` off the TPU;
                  complex128 runs the f64 Stockham on every device).

``dd`` and ``measure`` are not ported yet and raise ``NotImplementedError``
naming the ROADMAP item that ports them.

Plans are cached per (size, dtype, resolved backend, device), LRU-bounded.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import torch

from fourier_tpu_torch.plan.autosort import AutosortPlan
from fourier_tpu_torch.plan.base import FftPlan, complex_dtype
from fourier_tpu_torch.plan.bluestein import BluesteinPlan
from fourier_tpu_torch.plan.bluestein_fused import VpuBluesteinPlan
from fourier_tpu_torch.plan.four_step_local import (FourStepLocalPlan,
                                                    choose_large_split)
from fourier_tpu_torch.plan.mxu import MxuFftPlan
from fourier_tpu_torch.plan.vpu import VpuFftPlan

_PLAN_CACHE: "OrderedDict[Tuple[int, str, str, str], FftPlan]" = OrderedDict()
_PLAN_CACHE_MAX = 256

BACKENDS = ("auto", "mxu", "stockham", "dd", "vpu", "measure")

_NOT_PORTED = {
    "dd": "ROADMAP.md queue 1 item 7 (c128 as native f64)",
    "measure": "ROADMAP.md queue 1 item 10 (plan/measure.py)",
}


def _resolve_backend(backend: str, dtype: torch.dtype, device: torch.device) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of {BACKENDS}")
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet: {_NOT_PORTED[backend]}"
        )
    if backend != "auto":
        return backend
    if dtype == torch.complex64 and device.type == "cuda":
        return "vpu"
    return "stockham"


def _create_stockham(size: int, dtype, device) -> FftPlan:
    plan = AutosortPlan.create(size, dtype, device)
    if plan is None:
        plan = BluesteinPlan.create(size, dtype, device=device)
    return plan


def _create_mxu_composite(size: int, dtype, device, *,
                          vpu_first: bool = False) -> Optional[FftPlan]:
    """Best product- or kernel-family plan for a composite size, or None
    (primes and other sizes with no usable divisor structure): VpuFftPlan
    first with `vpu_first`, then MxuFftPlan, then a four-step composition
    whose legs are planned the same way (falling back to ``stockham``)."""
    if vpu_first:
        plan = VpuFftPlan.create(size, dtype, device)
        if plan is not None:
            return plan
    plan = MxuFftPlan.create(size, dtype, device)
    if plan is not None:
        return plan
    split = choose_large_split(size)
    if split is None:
        return None

    def factory(m, dt, dev):
        sub = _create_mxu_composite(m, dt, dev, vpu_first=vpu_first)
        return sub if sub is not None else _create_stockham(m, dt, dev)

    return FourStepLocalPlan.create(size, dtype, split[0], split[1], factory,
                                    device)


def _create_mxu(size: int, dtype, device, *, vpu_first: bool = False) -> FftPlan:
    plan = _create_mxu_composite(size, dtype, device, vpu_first=vpu_first)
    if plan is not None:
        return plan
    # Split-less sizes up to the direct-product crossover: one full-size DFT
    # product; past it, the one-kernel Bluestein (B2) where its inner fits.
    if size <= MxuFftPlan.DIRECT_SINGLE_MAX:
        return MxuFftPlan.create_direct(size, dtype, device)
    if vpu_first:
        plan = VpuBluesteinPlan.create(size, dtype, device)
        if plan is not None:
            return plan

    def inner_factory(m, dt, dev):
        inner = _create_mxu_composite(m, dt, dev, vpu_first=vpu_first)
        return inner if inner is not None else AutosortPlan.create(m, dt, dev)

    return BluesteinPlan.create(size, dtype, inner_factory=inner_factory,
                                device=device)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device, a bare "cuda" as the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def create_fft(size: int, dtype=torch.complex64, *, backend: str = "auto",
               device="cpu", cache: bool = True) -> FftPlan:
    """Create (or fetch a cached) FFT plan for complex transforms of `size`
    on `device`."""
    dtype = complex_dtype(dtype)
    device = resolve_device(device)
    resolved = _resolve_backend(backend, dtype, device)
    if resolved in ("mxu", "vpu") and dtype != torch.complex64:
        raise ValueError(
            f"backend={resolved!r} supports complex64 only (c128: stockham)")
    key = (int(size), str(dtype), resolved, str(device))
    if cache and key in _PLAN_CACHE:
        _PLAN_CACHE.move_to_end(key)
        return _PLAN_CACHE[key]
    if resolved == "mxu":
        plan = _create_mxu(size, dtype, device)
    elif resolved == "vpu":
        plan = VpuFftPlan.create(size, dtype, device)
        if plan is None:
            plan = _create_mxu(size, dtype, device, vpu_first=True)
    else:
        plan = _create_stockham(size, dtype, device)
    if cache:
        _PLAN_CACHE[key] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
    return plan


def create_fft_f32(size: int, backend: str = "auto", device="cpu") -> FftPlan:
    """Complex64 (f32) FFT plan."""
    return create_fft(size, torch.complex64, backend=backend, device=device)


def create_fft_f64(size: int, backend: str = "auto", device="cpu") -> FftPlan:
    """Complex128 (f64) FFT plan: the f64 Stockham family on any device."""
    return create_fft(size, torch.complex128, backend=backend, device=device)


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()


def plan_tree(plan) -> tuple:
    """A plan's family tree: (class name, size, split or inner size,
    sub-plan trees). Read only by class name and attributes that both
    packages share, so it also gives the tree of a JAX package plan."""
    name = type(plan).__name__
    if name == "RfftPlan":
        return (name, plan.n, plan_tree(plan.inner))
    if name == "MxuFftPlan":
        return (name, plan.size, (plan.n1, plan.n2))
    if name == "VpuBluesteinPlan":
        return (name, plan.size, plan.m_inner)
    if name == "BluesteinPlan":
        return (name, plan.size, plan_tree(plan.inner))
    if name == "FourStepLocalPlan":
        return (name, plan.size, (plan.p, plan.q), plan_tree(plan.col_plan),
                plan_tree(plan.row_plan))
    return (name, plan.size)
