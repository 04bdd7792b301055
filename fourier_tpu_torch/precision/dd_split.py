"""Radix-r DIT split plans in f64: the c128 sizes just past B6's domain.

Port of ``fourier_tpu/precision/dd_split.py``. FFT_n, n = r*m, runs as one
batched m-point transform of the r residue classes and one O(n) combine,
kernel B8 (``ops/cuda/dd_combine.py``):

    F_t = FFT_m(x[t::r]),  X[j*m + k] = sum_t (w^(t*k) F_t[k]) W_r^(j*t)

:class:`DdSplitPow2Plan` is r = 2 over a B6 half or one more split level
(6144, 8192, 12288, 16384); :class:`DdSplitRadixPlan` is r in {3, 5} over a
B6 sub-plan (2187 = 3*729, 3125 = 5*625, 10000 = 5*2000). The limits are the
JAX package's (``MAX_SPLIT_SIZE``, ``MAX_DEPTH``, ``RADICES``), so both
packages plan the same family per size. On the card the split has the TPU's
reason as well: one c128 column of n = 16384 is 256 KiB, past the 227 KB of
shared memory a block may use.

Batch-minor (n, B) is the native layout and the split costs no copy: the
(n, B) input viewed as (m, r*B) is the batched sub-plan's input (class t in
columns t*B..t*B+B-1), the sub-plan runs FFT (UNSCALED_IFFT in the inverse
direction), and B8 twiddles classes 1..r-1, applies the mode scale and
writes the (r, m, B) output whose (n, B) view is the spectrum. The twiddle
tables are f64, computed at plan time as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fourier_tpu_torch.ops.cuda import dd_combine
from fourier_tpu_torch.plan.base import (BatchMinorPlan, complex_dtype,
                                         resolve_device)
from fourier_tpu_torch.precision.vpu_dd_plan import VpuDdFftPlan
from fourier_tpu_torch.transform import Transform

#: Largest size the split plans cover (the JAX package's limit).
MAX_SPLIT_SIZE = 16384


def twiddle_tables(n: int, r: int):
    """(forward, inverse) planar f64 (2, r-1, m) tables, row t-1 =
    w^(t*k) = exp(-+2*pi*i*t*k/n), k < m = n/r, with the JAX package's
    expressions (``_twiddle_tables`` for r = 2, ``_radix_twiddle_tables``
    otherwise)."""
    m = n // r
    k = np.arange(m, dtype=np.float64)
    if r == 2:
        thetas = [np.pi * k / float(m)]
    else:
        thetas = [2.0 * np.pi * (t * k) / float(n) for t in range(1, r)]
    w = np.stack([np.cos(th) - 1j * np.sin(th) for th in thetas])
    planar = lambda a: np.stack([a.real, a.imag])
    return planar(w), planar(np.conj(w))


class _DdSplitPlan(BatchMinorPlan):
    """Radix-r DIT over an m-point sub-plan, combined by kernel B8."""

    family = "vpu"
    dtype = torch.complex128

    def __init__(self, size: int, radix: int, sub, tw_fwd, tw_inv, device):
        """`tw_fwd`/`tw_inv`: planar numpy (2, r-1, m) tables of
        :func:`twiddle_tables`."""
        super().__init__()
        self.size = int(size)
        self.radix = int(radix)
        self.sub = sub
        for name, tw in (("tw_fwd", tw_fwd), ("tw_inv", tw_inv)):
            buf = np.asarray(tw, np.float64).reshape(2, self.radix - 1, -1)
            self.register_buffer(name, torch.as_tensor(buf, device=device),
                                 persistent=False)

    def _execute_bm(self, re_t, im_t, transform: Transform):
        n, r = self.size, self.radix
        m, b = n // r, re_t.shape[1]
        forward = transform.is_forward
        mode = Transform.FFT if forward else Transform.UNSCALED_IFFT
        sre, sim = self.sub._execute_bm(re_t.reshape(m, r * b),
                                        im_t.reshape(m, r * b), mode)
        return dd_combine.dd_split_combine_batch_minor(
            sre, sim, n, r, forward, self._scale_for(transform),
            tables=self.tw_fwd if forward else self.tw_inv)

    def extra_repr(self) -> str:
        return f"size={self.size}, radix={self.radix}, family={self.family}"


class DdSplitPow2Plan(_DdSplitPlan):
    """Radix-2 DIT over a B6 half, or over one more split level."""

    #: Split levels a chain may have: two cover 16384 = 2*(2*4096).
    MAX_DEPTH = 2

    def __init__(self, size: int, half, tw_fwd, tw_inv, device):
        super().__init__(size, 2, half, tw_fwd, tw_inv, device)

    @property
    def half(self):
        return self.sub

    @classmethod
    def create(cls, size: int, dtype=None, device="cuda", *,
               _depth: int = MAX_DEPTH) -> Optional["DdSplitPow2Plan"]:
        """The plan, or None for c64, odd sizes, sizes past MAX_SPLIT_SIZE
        and halves that reach no B6 plan within MAX_DEPTH levels."""
        if dtype is not None and complex_dtype(dtype) != cls.dtype:
            return None
        if size % 2 or size > MAX_SPLIT_SIZE or _depth < 1:
            return None
        device = resolve_device(device)
        m = size // 2
        half = VpuDdFftPlan.create(m, device=device)
        if half is None:
            half = cls.create(m, device=device, _depth=_depth - 1)
        if half is None:
            return None
        return cls(size, half, *twiddle_tables(size, 2), device)


class DdSplitRadixPlan(_DdSplitPlan):
    """Radix-r (r in {3, 5}) DIT over a B6 sub-plan."""

    RADICES = (3, 5)

    @classmethod
    def create(cls, size: int, dtype=None,
               device="cuda") -> Optional["DdSplitRadixPlan"]:
        """The plan of the first r in RADICES whose quotient has a B6 plan,
        or None (c64, sizes past MAX_SPLIT_SIZE, no such r)."""
        if dtype is not None and complex_dtype(dtype) != cls.dtype:
            return None
        if size > MAX_SPLIT_SIZE:
            return None
        device = resolve_device(device)
        for r in cls.RADICES:
            if size % r:
                continue
            sub = VpuDdFftPlan.create(size // r, device=device)
            if sub is not None:
                return cls(size, r, sub, *twiddle_tables(size, r), device)
        return None
