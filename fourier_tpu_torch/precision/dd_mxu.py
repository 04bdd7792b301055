"""The direct c128 DFT: ``DdMxuDirectPlan`` as one f64 matrix product.

Port of ``fourier_tpu/precision/dd_mxu.py``. On its chip, with no f64, the
JAX class computes a c128 DFT of size n <= 1024 as one dense (B, n) x (n, n)
product on the matrix unit, reaching double-word accuracy by cutting every
operand into exact 7-bit chunks (an Ozaki-style decomposition). The port
has f64: the product is ``torch.matmul`` in f64 against the f64 (n, n)
cos / -sin DFT matrix, built from numpy f64 at plan time (or, for a plan
saved by the JAX package, the exact f64 sum of its chunk tables). The JAX
package computes its product as XLA dots outside any Pallas kernel, so a
library product stands here as well. f64 products have no reduced-precision
mode; the dtype is asserted all the same.

No planner route builds it, as in the JAX package, where it measured slower
than the FFT-based c128 plans; ``create`` returns None exactly where the
JAX one does (n < 2 or n > ``MAX_SIZE``). It has the c128 plan surface
(the 2-plane and 4-plane calls, ``transform``, ``fft``, ``ifft``) and the
JAX ``kind``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fourier_tpu_torch.plan.base import FftPlan, resolve_device
from fourier_tpu_torch.transform import Transform


def dft_tables(size: int):
    """The f64 (n, n) forward DFT matrix as planar (cos, -sin) numpy. The
    exponent j*k is reduced mod n in integers first (the JAX package takes
    the angle of j*k itself, whose f64 rounding grows with j*k, up to
    n^2)."""
    j = np.arange(size, dtype=np.int64)
    ang = 2.0 * np.pi * (np.outer(j, j) % size) / float(size)
    return np.cos(ang), -np.sin(ang)


class DdMxuDirectPlan(FftPlan):
    """Direct c128 DFT of size 2..MAX_SIZE as f64 matrix products."""

    family = "mxu"
    dtype = torch.complex128
    kind = "mxu-dd-direct"

    #: The JAX class's size bound (its exactness bound for 7-bit chunks).
    MAX_SIZE = 1024

    def __init__(self, size: int, u, v, device):
        """`u`, `v`: the f64 (n, n) cos and -sin tables (numpy or tensors)."""
        super().__init__()
        self.size = int(size)
        dft = np.stack([np.asarray(u, np.float64), np.asarray(v, np.float64)])
        if dft.shape != (2, self.size, self.size):
            raise ValueError(f"DFT tables of shape {dft.shape[1:]} for size {self.size}")
        self.register_buffer("dft", torch.as_tensor(dft, device=device),
                             persistent=False)

    @classmethod
    def create(cls, size: int, device="cuda") -> Optional["DdMxuDirectPlan"]:
        """The plan, or None for n < 2 and n > MAX_SIZE."""
        if size < 2 or size > cls.MAX_SIZE:
            return None
        return cls(size, *dft_tables(size), resolve_device(device))

    def _products(self, re, im, transform: Transform, batch_minor: bool):
        u, v = self.dft[0], self.dft[1]
        assert u.dtype == torch.float64 and re.dtype == torch.float64
        if not transform.is_forward:
            v = -v  # the inverse runs conj(W)
        # W is symmetric: rows (..., n) @ W and columns W @ (n, B) alike.
        mm = (lambda w, x: w @ x) if batch_minor else (lambda w, x: x @ w)
        ore = mm(u, re) - mm(v, im)
        oim = mm(v, re) + mm(u, im)
        scale = self._scale_for(transform)
        if scale is not None:
            ore, oim = ore * scale, oim * scale
        return ore, oim

    def _execute(self, re, im, transform: Transform):
        return self._products(re, im, transform, False)

    def _execute_bm(self, re_t, im_t, transform: Transform):
        return self._products(re_t, im_t, transform, True)

    def extra_repr(self) -> str:
        return f"size={self.size}, kind={self.kind}"
