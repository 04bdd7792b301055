"""Bluestein chirp-z plan: arbitrary (prime/composite) sizes.

Port of ``fourier_tpu/plan/bluestein.py``. The inner size is
next_power_of_two(2n-1); the "w" table is the forward FFT of the zero-padded
wrap-mirrored chirp and the "x" table is the conjugate chirp. The plan-time
FFT that builds "w" runs in f64 numpy and is narrowed to the plan dtype.

Execution: x ⊙ input, zero-padded to M, inner forward FFT, ⊙ w, inner
inverse FFT (which absorbs 1/M), then ⊙ x with the mode's normalization.
"""

from __future__ import annotations

import numpy as np
import torch

from fourier_tpu_torch.ops import cplx
from fourier_tpu_torch.plan.autosort import AutosortPlan
from fourier_tpu_torch.plan.base import (FftPlan, complex_dtype, numpy_real,
                                         resolve_device)
from fourier_tpu_torch.plan.factor import next_power_of_two
from fourier_tpu_torch.transform import Transform
from fourier_tpu_torch.twiddle import half_twiddle


def _chirp_tables(size: int, inner_size: int):
    """f64 (w_fwd, w_inv, x_fwd, x_inv) complex tables."""
    n, m = size, inner_size
    i = np.arange(m, dtype=np.float64)
    # Quadratic chirp index: i^2 for i < n, (i - m)^2 for i > m - n, else unused.
    d = np.where(i < n, i**2, (i - m) ** 2)
    mask = (i < n) | (i > m - n)
    chirp = np.where(mask, half_twiddle(d, n), 0.0 + 0.0j)
    w_fwd = np.fft.fft(np.conj(chirp))
    w_inv = np.fft.fft(chirp)
    j = np.arange(n, dtype=np.float64)
    x_inv = half_twiddle(-(j**2), n)  # exp(+i*pi*j^2/n)
    x_fwd = np.conj(x_inv)
    return w_fwd, w_inv, x_fwd, x_inv


class BluesteinPlan(FftPlan):
    """Bluestein chirp-z plan for arbitrary sizes."""

    family = "stockham"

    def __init__(self, size, dtype, inner: FftPlan, w_fwd, w_inv, x_fwd,
                 x_inv, device):
        """Tables are planar (re, im) numpy pairs: w of shape (M,), x of (n,)."""
        super().__init__()
        self.size = int(size)
        self.dtype = complex_dtype(dtype)
        self.inner = inner
        rt = numpy_real(self.dtype)
        for name, (tr, ti) in (("w_fwd", w_fwd), ("w_inv", w_inv),
                               ("x_fwd", x_fwd), ("x_inv", x_inv)):
            buf = torch.as_tensor(np.stack([tr, ti]).astype(rt), device=device)
            self.register_buffer(name, buf, persistent=False)

    @classmethod
    def create(cls, size: int, dtype=torch.complex64, inner_factory=None,
               device="cuda") -> "BluesteinPlan":
        """Plan an arbitrary size. `inner_factory(size, dtype, device)`
        builds the power-of-two inner plan (default: AutosortPlan)."""
        if size < 1:
            raise ValueError(f"FFT size must be >= 1, got {size}")
        device = resolve_device(device)
        inner_size = next_power_of_two(2 * size - 1)
        factory = AutosortPlan.create if inner_factory is None else inner_factory
        inner = factory(inner_size, dtype, device)
        if inner is None:
            raise ValueError(f"inner factory gave no plan for size {inner_size}")
        tables = [(t.real, t.imag) for t in _chirp_tables(size, inner_size)]
        return cls(size, dtype, inner, *tables, device=device)

    @property
    def inner_size(self) -> int:
        return self.inner.size

    def _execute(self, re, im, transform: Transform):
        forward = transform.is_forward
        xt = self.x_fwd if forward else self.x_inv
        wt = self.w_fwd if forward else self.w_inv
        pad = self.inner.size - self.size
        wre, wim = cplx.mul((re, im), (xt[0], xt[1]))
        wre = torch.nn.functional.pad(wre, (0, pad))
        wim = torch.nn.functional.pad(wim, (0, pad))
        wre, wim = self.inner._execute(wre, wim, Transform.FFT)
        wre, wim = cplx.mul((wre, wim), (wt[0], wt[1]))
        wre, wim = self.inner._execute(wre, wim, Transform.IFFT)  # absorbs 1/M
        ore, oim = cplx.mul((wre[..., : self.size], wim[..., : self.size]),
                            (xt[0], xt[1]))
        scale = self._scale_for(transform)
        if scale is not None:
            ore, oim = ore * scale, oim * scale
        return ore, oim

    def _execute_bm(self, re_t, im_t, transform: Transform):
        """Batch-minor (n, B): the chirp and w passes broadcast the tables as
        column vectors; the inner FFTs run through the inner plan's own
        batch-minor path (the B1 kernel for a VpuFftPlan inner)."""
        forward = transform.is_forward
        xt = (self.x_fwd if forward else self.x_inv)[:, :, None]
        wt = (self.w_fwd if forward else self.w_inv)[:, :, None]
        wre, wim = cplx.mul((re_t, im_t), (xt[0], xt[1]))
        pad = (0, 0, 0, self.inner.size - self.size)
        wre = torch.nn.functional.pad(wre, pad)
        wim = torch.nn.functional.pad(wim, pad)
        wre, wim = self.inner._execute_bm(wre, wim, Transform.FFT)
        wre, wim = cplx.mul((wre, wim), (wt[0], wt[1]))
        wre, wim = self.inner._execute_bm(wre, wim, Transform.IFFT)
        ore, oim = cplx.mul((wre[: self.size], wim[: self.size]), (xt[0], xt[1]))
        scale = self._scale_for(transform)
        if scale is not None:
            ore, oim = ore * scale, oim * scale
        return ore, oim

    def extra_repr(self) -> str:
        return (f"size={self.size}, inner_size={self.inner.size}, "
                f"dtype={str(self.dtype).replace('torch.', '')}, family={self.family}")
