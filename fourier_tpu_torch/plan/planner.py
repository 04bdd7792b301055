"""Runtime planner: ``create_fft_f32`` / ``create_fft_f64``.

Port of the ``auto``, ``vpu`` and ``stockham`` backends of
``fourier_tpu/plan/planner.py``:

* ``vpu``      -- kernel B1 (:class:`VpuFftPlan`) for every size in its
                  domain. Other sizes take an interim route until B2, B3 and
                  the ``mxu`` family are ported: :class:`AutosortPlan` for
                  2^a*3^b, else :class:`BluesteinPlan` whose power-of-two
                  inner is a VpuFftPlan where B1's domain allows, else an
                  AutosortPlan. complex64 only.
* ``stockham`` -- plain PyTorch Stockham autosort (2^a*3^b) + Bluestein, in
                  complex64 or complex128 on any device.
* ``auto``     -- ``vpu`` for complex64 on a CUDA device, else ``stockham``
                  (complex128 runs the f64 Stockham on every device).

``mxu``, ``dd`` and ``measure`` are not ported yet and raise
``NotImplementedError`` naming the ROADMAP item that ports them.

Plans are cached per (size, dtype, resolved backend, device), LRU-bounded.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import torch

from fourier_tpu_torch.plan.autosort import AutosortPlan
from fourier_tpu_torch.plan.base import FftPlan, complex_dtype
from fourier_tpu_torch.plan.bluestein import BluesteinPlan
from fourier_tpu_torch.plan.vpu import VpuFftPlan

_PLAN_CACHE: "OrderedDict[Tuple[int, str, str, str], FftPlan]" = OrderedDict()
_PLAN_CACHE_MAX = 256

BACKENDS = ("auto", "mxu", "stockham", "dd", "vpu", "measure")

_NOT_PORTED = {
    "mxu": "ROADMAP.md queue 1 item 4 (plan/mxu.py and kernel B9)",
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


def _vpu_or_autosort(size: int, dtype, device) -> FftPlan:
    plan = VpuFftPlan.create(size, dtype, device)
    if plan is None:
        plan = AutosortPlan.create(size, dtype, device)
    return plan


def _create_vpu(size: int, dtype, device) -> FftPlan:
    plan = VpuFftPlan.create(size, dtype, device)
    if plan is None:
        plan = AutosortPlan.create(size, dtype, device)
    if plan is None:
        plan = BluesteinPlan.create(size, dtype, inner_factory=_vpu_or_autosort,
                                    device=device)
    return plan


def create_fft(size: int, dtype=torch.complex64, *, backend: str = "auto",
               device="cpu", cache: bool = True) -> FftPlan:
    """Create (or fetch a cached) FFT plan for complex transforms of `size`
    on `device`."""
    dtype = complex_dtype(dtype)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    resolved = _resolve_backend(backend, dtype, device)
    if resolved == "vpu" and dtype != torch.complex64:
        raise ValueError("backend='vpu' supports complex64 only (c128: stockham)")
    key = (int(size), str(dtype), resolved, str(device))
    if cache and key in _PLAN_CACHE:
        _PLAN_CACHE.move_to_end(key)
        return _PLAN_CACHE[key]
    if resolved == "vpu":
        plan = _create_vpu(size, dtype, device)
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
