"""The arbitrary-size complex128 plan: ``DdFftPlan`` in native f64.

Port of ``fourier_tpu/precision/dd_plan.py``. The JAX class computes c128
in double-word f32 on its f32-only chip: a Stockham plan for 2^a*3^b sizes,
a Bluestein over an inner power-of-two plan otherwise. The port keeps the
class, its two kinds and its surface (``transform``, ``fft``, ``ifft``,
``__call__``, ``transform_planar_dd``, ``kind``) and computes in f64: its
body is the f64 :class:`AutosortPlan` (kind ``stockham``) or a
:class:`BluesteinPlan` (kind ``bluestein``) whose inner plan is
``inner_factory(m)`` (default: a ``DdFftPlan`` of m, i.e. the f64
Stockham). No planner route builds it, as in the JAX package on its chip;
the ``dd_xla`` wisdom label does (``plan/measure.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from fourier_tpu_torch.plan.autosort import AutosortPlan
from fourier_tpu_torch.plan.base import FftPlan, resolve_device
from fourier_tpu_torch.plan.bluestein import BluesteinPlan
from fourier_tpu_torch.transform import Transform


class DdFftPlan(FftPlan):
    """Arbitrary-size c128 plan: the f64 Stockham for 2^a*3^b sizes, a
    Bluestein otherwise."""

    family = "stockham"
    dtype = torch.complex128

    def __init__(self, size: int, inner_factory: Optional[Callable] = None,
                 device="cuda"):
        """`inner_factory(m)` builds the Bluestein's power-of-two inner plan
        (a port plan on the same device)."""
        if size < 1:
            raise ValueError(f"FFT size must be >= 1, got {size}")
        device = resolve_device(device)
        body = AutosortPlan.create(size, torch.complex128, device)
        if body is None:
            factory = inner_factory or (lambda m: DdFftPlan(m, device=device))
            body = BluesteinPlan.create(size, torch.complex128,
                                        inner_factory=lambda m, _dt, _dev: factory(m),
                                        device=device)
        super().__init__()
        self._setup(body)

    @classmethod
    def from_body(cls, body) -> "DdFftPlan":
        """The plan over its f64 body (an AutosortPlan or a BluesteinPlan),
        as a saved plan holds it."""
        plan = cls.__new__(cls)
        torch.nn.Module.__init__(plan)
        plan._setup(body)
        return plan

    def _setup(self, body) -> None:
        if body.dtype != torch.complex128:
            raise ValueError(f"DdFftPlan's body must be complex128, got {body.dtype}")
        self.size = body.size
        self.body = body
        self.kind = "stockham" if isinstance(body, AutosortPlan) else "bluestein"

    @property
    def radices(self) -> Tuple[int, ...]:
        return self.body.radices

    @property
    def inner(self):
        """The Bluestein's inner plan (None for kind ``stockham``)."""
        return getattr(self.body, "inner", None)

    def _execute(self, re, im, transform: Transform):
        return self.body._execute(re, im, transform)

    def _execute_bm(self, re_t, im_t, transform: Transform):
        return self.body._execute_bm(re_t, im_t, transform)

    def extra_repr(self) -> str:
        return f"size={self.size}, kind={self.kind}"
