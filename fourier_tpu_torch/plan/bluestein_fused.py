"""Fused Bluestein plan: the whole chirp-z transform in one kernel (B2).

Port of ``fourier_tpu/plan/bluestein_fused.py``. The composed
:class:`BluesteinPlan` runs the chirp multiply, zero pad, inner forward
transform, w multiply, inner inverse transform and output chirp as separate
passes over memory; this plan runs them all inside kernel B2
(``csrc/stockham_vpu.cu``) on a CUDA device, and through B2's plain
PyTorch version on the CPU. Eligible: complex64, any n >= 2 whose inner size
M (:meth:`VpuBluesteinPlan.choose_inner`) is in B1's domain and at most
``MAX_INNER``.

The chirp and w tables are the composed plan's (``plan/bluestein._chirp_tables``,
f64 at plan time), narrowed to f32; the inner inverse transform's 1/M is
folded into the output chirp. Batch-minor (n, B) is the native layout; B is
not padded.

:class:`FusedBluesteinPlan` holds what this plan and its f64 twin
(``precision/dd_bluestein.VpuDdBluesteinPlan``, kernel B7) share; each names
its stage plan, inner-size rule and kernel wrapper.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fourier_tpu_torch.ops.cuda import stockham_vpu
from fourier_tpu_torch.plan.base import (BatchMinorPlan, complex_dtype,
                                         numpy_real, resolve_device)
from fourier_tpu_torch.plan.bluestein import _chirp_tables
from fourier_tpu_torch.plan.factor import next_power_of_two
from fourier_tpu_torch.plan.vpu import VpuFftPlan
from fourier_tpu_torch.transform import Transform


class FusedBluesteinPlan(BatchMinorPlan):
    """A one-kernel Bluestein chirp-z plan. Subclasses set ``dtype``,
    ``MAX_INNER``, ``stages_plan`` (the fused stage plan class of the inner
    size), ``choose_inner(size, max_inner)`` and the kernel wrapper
    ``run``."""

    family = "vpu"

    def __init__(self, size: int, stages, chirps_fwd, chirps_inv, device):
        """`stages`: the M-point stage plan whose stage, kernel and pair
        tables the inner transforms use (it is never run on its own);
        `chirps_fwd`/`chirps_inv`: planar numpy (re, im) pairs (xt, wt, xo)
        of lengths n, M and n, 1/M folded into xo."""
        super().__init__()
        self.size = int(size)
        self.stages = stages
        real = numpy_real(self.dtype)
        for direction, chirps in (("fwd", chirps_fwd), ("inv", chirps_inv)):
            for name, (tr, ti) in zip(("xt", "wt", "xo"), chirps):
                buf = np.stack([np.ravel(tr), np.ravel(ti)]).astype(real)
                self.register_buffer(f"{name}_{direction}",
                                     torch.as_tensor(buf, device=device),
                                     persistent=False)

    @property
    def m_inner(self) -> int:
        return self.stages.size

    @classmethod
    def create(cls, size: int, dtype=None, device="cuda"):
        """The plan, or None for the other complex dtype, n < 2 and sizes
        with no eligible M (`dtype` None: the plan's own)."""
        if dtype is not None and complex_dtype(dtype) != cls.dtype:
            return None
        if size < 2:
            return None
        m = cls.choose_inner(size, cls.MAX_INNER)
        if m is None:
            return None
        device = resolve_device(device)
        w_fwd, w_inv, x_fwd, x_inv = _chirp_tables(size, m)
        planar = lambda a: (a.real, a.imag)
        chirps = lambda x, w: (planar(x), planar(w), planar(x / m))
        return cls(size, cls.stages_plan.create(m, device=device),
                   chirps(x_fwd, w_fwd), chirps(x_inv, w_inv), device)

    def chirps(self, forward: bool):
        """The direction's (xt, wt, xo) planar (2, L) tensors."""
        d = "fwd" if forward else "inv"
        return tuple(getattr(self, f"{name}_{d}") for name in ("xt", "wt", "xo"))

    def body_tables(self) -> dict:
        """The inner size's tables that the kernel's bodies read, by the
        wrapper's keyword: the stage body's and the paired body's."""
        st = self.stages
        return dict(kernel_tables=(st.kernel_fwd, st.kernel_inv),
                    pair_tables=(st.pair_fwd, st.pair_inv))

    def _execute_bm(self, re_t, im_t, transform: Transform):
        st = self.stages
        return self.run(
            re_t, im_t, self.size, st.size, self._scale_for(transform),
            tables=(st.tables(True), st.tables(False)),
            chirps=self.chirps(transform.is_forward), **self.body_tables(),
        )

    def extra_repr(self) -> str:
        return f"size={self.size}, inner={self.m_inner}, family={self.family}"


class VpuBluesteinPlan(FusedBluesteinPlan):
    """One-kernel Bluestein chirp-z plan (complex64, batch-minor native)."""

    dtype = torch.complex64
    stages_plan = VpuFftPlan
    run = staticmethod(stockham_vpu.vpu_bluestein_batch_minor)

    # The JAX package's inner-size ceiling, kept so that both packages plan
    # the same family per size (ROADMAP.md: to re-measure on the H100). On
    # the card one M = 8192 column takes 64 KiB of shared memory.
    MAX_INNER = 8192

    @staticmethod
    def choose_inner(size: int, max_inner: int) -> Optional[int]:
        """Smallest M >= 2n-1 with 8 | M in B1's domain, up to the next power
        of two and `max_inner`; None when there is none. The pure 3^b and 5^c
        tabled sizes are never picked (8 does not divide them)."""
        lo = 2 * size - 1
        pow2 = next_power_of_two(lo)
        if pow2 <= 64:
            return pow2 if stockham_vpu.radix_schedule(pow2) else None
        start = -(-lo // 8) * 8
        for m in range(start, min(pow2, max_inner) + 1, 8):
            if stockham_vpu.radix_schedule(m) is not None:
                return m
        return pow2 if (
            pow2 <= max_inner and stockham_vpu.radix_schedule(pow2)
        ) else None
