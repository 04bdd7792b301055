"""Stockham autosort plan: mixed-radix 2^a*3^b sizes.

Port of ``fourier_tpu/plan/autosort.py``: factorize the size over the
RADICES schedule and precompute per-stage forward and inverse (m, radix)
twiddle tables in f64, narrowed to the plan's real dtype. The tables live in
two (2, L) buffers; execution is :func:`ops.stockham_torch.apply_stages`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from fourier_tpu_torch.ops import stockham_torch
from fourier_tpu_torch.plan.base import (FftPlan, complex_dtype, numpy_real,
                                         planar_buffer, resolve_device,
                                         stage_views)
from fourier_tpu_torch.plan.factor import factorize_autosort
from fourier_tpu_torch.transform import Transform
from fourier_tpu_torch.twiddle import stage_twiddles


class AutosortPlan(FftPlan):
    """Mixed-radix Stockham plan for sizes 2^a * 3^b."""

    family = "stockham"

    def __init__(self, size: int, radices: Sequence[int], dtype,
                 fwd_twiddles, inv_twiddles, device):
        """`fwd_twiddles`/`inv_twiddles`: per-stage planar (re, im) numpy
        tables of shape (size_s // radix, radix)."""
        super().__init__()
        self.size = int(size)
        self.radices: Tuple[int, ...] = tuple(int(r) for r in radices)
        self.dtype = complex_dtype(dtype)
        rt = numpy_real(self.dtype)
        self.register_buffer("fwd", planar_buffer(fwd_twiddles, rt, device),
                             persistent=False)
        self.register_buffer("inv", planar_buffer(inv_twiddles, rt, device),
                             persistent=False)
        shapes, s = [], self.size
        for r in self.radices:
            shapes.append((s // r, r))
            s //= r
        self._shapes = tuple(shapes)

    @classmethod
    def create(cls, size: int, dtype=torch.complex64,
               device="cuda") -> Optional["AutosortPlan"]:
        """Plan `size`, or None when the size needs Bluestein."""
        radices = factorize_autosort(size)
        if radices is None:
            return None
        fwd, inv = [], []
        s = size
        for radix in radices:
            tf = stage_twiddles(s, radix, True)
            ti = stage_twiddles(s, radix, False)
            fwd.append((tf.real, tf.imag))
            inv.append((ti.real, ti.imag))
            s //= radix
        return cls(size, radices, dtype, fwd, inv, resolve_device(device))

    def _execute(self, re, im, transform: Transform):
        forward = transform.is_forward
        twiddles = stage_views(self.fwd if forward else self.inv, self._shapes)
        return stockham_torch.apply_stages(
            re, im, self.radices, twiddles, forward, self._scale_for(transform)
        )

    def extra_repr(self) -> str:
        return (f"size={self.size}, radices={self.radices}, "
                f"dtype={str(self.dtype).replace('torch.', '')}, family={self.family}")
