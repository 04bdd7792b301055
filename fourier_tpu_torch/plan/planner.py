"""Runtime planner: ``create_fft_f32`` / ``create_fft_f64``.

Port of the ``auto``, ``vpu``, ``mxu``, ``stockham`` and ``dd`` backends of
``fourier_tpu/plan/planner.py``, with the same plan family for every size as
the JAX package plans on a TPU:

* ``vpu``      -- :class:`VpuFftPlan` (kernel B1) in its domain, else the
                  ``mxu`` route with the fused kernels first
                  (``_create_mxu(vpu_first=True)``): four-step composites
                  whose legs are VpuFftPlans (kernel B3 on the rows),
                  :class:`MxuFftPlan` products, :class:`VpuBluesteinPlan`
                  (kernel B2) for split-less sizes past the direct-product
                  crossover, else a composed :class:`BluesteinPlan`.
                  complex64 only. One rule is the card's own: a size that
                  the route would run as one full-size DFT product
                  (``MxuFftPlan.single_product``) runs B2 instead where B2
                  takes it (``_card_bluestein``). It applies to the size
                  the caller plans; four-step legs and composed-Bluestein
                  inners keep the JAX package's route.
* ``mxu``      -- the same route without the fused kernels first: DFT
                  products, four-step and Bluestein over them. complex64
                  only.
* ``stockham`` -- plain PyTorch Stockham autosort (2^a*3^b) + Bluestein, in
                  complex64 or complex128 on any device.
* ``dd``       -- the complex128 route (``_create_dd``, the TPU branch of the
                  JAX package's): :class:`VpuDdFftPlan` (kernel B6) in its
                  domain, else a :class:`DdSplitPow2Plan` or
                  :class:`DdSplitRadixPlan` (B8 over B6), else
                  :class:`VpuDdBluesteinPlan` (kernel B7), else the f64
                  Stockham (2^a*3^b) or a composed Bluestein over those.
                  complex128 only. The name is the JAX package's, where it
                  means double-word f32; here the route is native f64.
* ``auto``     -- on a CUDA device ``vpu`` for complex64 and ``dd`` for
                  complex128; on the CPU ``stockham`` (as the JAX package
                  picks off the TPU with x64 on).

* ``measure``  -- the winner of :func:`plan.measure.measure_fft` on the
                  plan's device: wisdom if there is an entry for (size,
                  dtype) on its platform, else the eligible families timed
                  now (``plan/measure.py``; on the CPU ``stockham`` alone).

Every entry point plans on the card (``device="cuda"``) unless the caller
asks for the CPU; with no card it raises (``plan.base.resolve_device``).

Plans are cached per (size, dtype, resolved backend, device), LRU-bounded
(``measure`` plans per (size, dtype, "measure", device)). A lookup counts
``plan.cache_hit`` or ``plan.cache_miss``, and a build is the lifecycle span
``plan.build`` (``fourier_tpu_torch.trace``), whose record names the
class of the plan built (``plan``); a build that the card's rule sent from
the product to B2 counts ``plan.crossover_b2``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import torch

from fourier_tpu_torch import trace
from fourier_tpu_torch.plan.autosort import AutosortPlan
from fourier_tpu_torch.plan.base import FftPlan, complex_dtype, resolve_device
from fourier_tpu_torch.plan.bluestein import BluesteinPlan
from fourier_tpu_torch.plan.bluestein_fused import VpuBluesteinPlan
from fourier_tpu_torch.plan.four_step_local import (FourStepLocalPlan,
                                                    choose_large_split)
from fourier_tpu_torch.plan.mxu import MxuFftPlan
from fourier_tpu_torch.plan.vpu import VpuFftPlan
from fourier_tpu_torch.precision import (DdSplitPow2Plan, DdSplitRadixPlan,
                                         VpuDdBluesteinPlan, VpuDdFftPlan)

_PLAN_CACHE: "OrderedDict[Tuple[int, str, str, str], FftPlan]" = OrderedDict()
_PLAN_CACHE_MAX = 256

BACKENDS = ("auto", "mxu", "stockham", "dd", "vpu", "measure")


def _resolve_backend(backend: str, dtype: torch.dtype, device: torch.device) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of {BACKENDS}")
    if backend != "auto":
        return backend
    if device.type == "cuda":
        return "vpu" if dtype == torch.complex64 else "dd"
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
    if MxuFftPlan.single_product(size):
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


def _card_bluestein(size: int, dtype, device) -> Optional[VpuBluesteinPlan]:
    """B2 for a size that the vpu route would run as one full-size DFT
    product, where B2 takes it; None elsewhere. On an H100 at B = 65536,
    B2 beat that product at every such size batch-minor, and lost
    batch-major at 243 sizes <= 383, by up to 1.45x, where it transposes
    both planes in; no size threshold did better over both layouts
    (PERF.md §6)."""
    if not MxuFftPlan.single_product(size):
        return None
    plan = VpuBluesteinPlan.create(size, dtype, device)
    if plan is not None:
        trace.count("plan.crossover_b2")
    return plan


def _first(factories, size: int, dtype, device) -> Optional[FftPlan]:
    """The first plan one of `factories` gives, or None."""
    for factory in factories:
        plan = factory(size, dtype, device)
        if plan is not None:
            return plan
    return None


def _create_dd(size: int, dtype, device) -> FftPlan:
    """The complex128 route: port of ``_create_dd``'s TPU branch
    (``fourier_tpu/plan/planner.py:141-188``), with the JAX ``DdFftPlan``'s
    two kinds as the f64 :class:`AutosortPlan` (2^a*3^b) and
    :class:`BluesteinPlan` (inner next_power_of_two(2n-1) over B6, a radix-2
    split or the f64 Stockham)."""
    plan = _first((VpuDdFftPlan.create, DdSplitPow2Plan.create,
                   DdSplitRadixPlan.create, VpuDdBluesteinPlan.create,
                   AutosortPlan.create), size, dtype, device)
    if plan is not None:
        return plan
    inner = (VpuDdFftPlan.create, DdSplitPow2Plan.create, AutosortPlan.create)
    return BluesteinPlan.create(
        size, dtype, inner_factory=lambda m, dt, dev: _first(inner, m, dt, dev),
        device=device)


def create_fft(size: int, dtype=torch.complex64, *, backend: str = "auto",
               device="cuda", cache: bool = True) -> FftPlan:
    """Create (or fetch a cached) FFT plan for complex transforms of `size`
    on `device` (the card unless the caller asks for the CPU)."""
    dtype = complex_dtype(dtype)
    device = resolve_device(device)
    resolved = _resolve_backend(backend, dtype, device)
    if resolved in ("mxu", "vpu") and dtype != torch.complex64:
        raise ValueError(
            f"backend={resolved!r} supports complex64 only (c128: dd/stockham)")
    if resolved == "dd" and dtype != torch.complex128:
        raise ValueError("backend='dd' is the complex128 route")
    key = (int(size), str(dtype), resolved, str(device))
    if cache and key in _PLAN_CACHE:
        trace.count("plan.cache_hit")
        _PLAN_CACHE.move_to_end(key)
        return _PLAN_CACHE[key]
    with trace.span("plan.build", size=int(size), dtype=str(dtype),
                    backend=resolved) as build:
        if resolved == "measure":
            from fourier_tpu_torch.plan import measure as _measure

            plan = _measure.plan_from_wisdom(size, dtype, device)
            if plan is None:
                plan = _measure.measure_fft(size, dtype, device=device).plan
        elif resolved == "mxu":
            plan = _create_mxu(size, dtype, device)
        elif resolved == "vpu":
            plan = _first((VpuFftPlan.create, _card_bluestein), size, dtype,
                          device)
            if plan is None:
                plan = _create_mxu(size, dtype, device, vpu_first=True)
        elif resolved == "dd":
            plan = _create_dd(size, dtype, device)
        else:
            plan = _create_stockham(size, dtype, device)
        build.attrs["plan"] = type(plan).__name__
    if cache:
        trace.count("plan.cache_miss")
        _PLAN_CACHE[key] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
    return plan


def create_fft_f32(size: int, backend: str = "auto", device="cuda") -> FftPlan:
    """Complex64 (f32) FFT plan."""
    return create_fft(size, torch.complex64, backend=backend, device=device)


def create_fft_f64(size: int, backend: str = "auto", device="cuda") -> FftPlan:
    """Complex128 (f64) FFT plan: the ``dd`` route (kernels B6-B8) on a CUDA
    device, the f64 Stockham family on the CPU."""
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
    if name == "DdFftPlan":  # the JAX package's two-kind c128 plan
        if plan.kind == "stockham":
            return ("AutosortPlan", plan.size)
        return ("BluesteinPlan", plan.size, plan_tree(plan.inner))
    if name == "DdSplitPow2Plan":
        return (name, plan.size, plan_tree(plan.half))
    if name == "DdSplitRadixPlan":
        return (name, plan.size, plan.radix, plan_tree(plan.sub))
    if name == "MxuFftPlan":
        return (name, plan.size, (plan.n1, plan.n2))
    if name in ("VpuBluesteinPlan", "VpuDdBluesteinPlan"):
        return (name, plan.size, plan.m_inner)
    if name == "BluesteinPlan":
        return (name, plan.size, plan_tree(plan.inner))
    if name == "FourStepLocalPlan":
        return (name, plan.size, (plan.p, plan.q), plan_tree(plan.col_plan),
                plan_tree(plan.row_plan))
    return (name, plan.size)
