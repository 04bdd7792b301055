"""Fused Stockham plan over batch-minor planes: kernel B1 as a plan.

Port of ``fourier_tpu/plan/vpu.py``. The native entry point is
:meth:`transform_planar_bm` on batch-minor (n, B) planes, the layout in
which a chained pipeline (fft -> pointwise filter -> ifft) needs no
transposes; batch-major ``transform_planar`` transposes once each way. On a
CUDA device every call launches the hand-written kernel; on the CPU it runs
the kernel's plain PyTorch version. B is not padded.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fourier_tpu_torch.ops.cuda import stockham_vpu
from fourier_tpu_torch.plan.base import (BatchMinorPlan, complex_dtype,
                                         planar_buffer, stage_views)
from fourier_tpu_torch.transform import Transform


class VpuFftPlan(BatchMinorPlan):
    """Fused all-stages c64 plan for sizes in B1's domain (n = 2^a*3^b*5^c,
    8 | n, 64..16384, and the tabled pure powers of 3 and 5), batch-minor."""

    family = "vpu"

    def __init__(self, size: int, fwd_tables, inv_tables, device="cpu"):
        """`fwd_tables`/`inv_tables`: the compact planar numpy (m, r) tables
        of ``stockham_vpu.make_stage_tables``. The kernel's own tables are
        derived from the size."""
        super().__init__()
        self.size = int(size)
        self.dtype = torch.complex64
        self.schedule = tuple(stockham_vpu.radix_schedule(self.size))
        self._shapes = tuple((tr.shape[0], tr.shape[1]) for tr, _ in fwd_tables)
        for name, tables in (("fwd", fwd_tables), ("inv", inv_tables)):
            self.register_buffer(name, planar_buffer(tables, np.float32, device),
                                 persistent=False)
            fwd = name == "fwd"
            ktw = torch.as_tensor(stockham_vpu.make_kernel_tables(self.size, fwd),
                                  device=device)
            self.register_buffer(f"kernel_{name}", ktw, persistent=False)

    @classmethod
    def create(cls, size: int, dtype=torch.complex64,
               device="cpu") -> Optional["VpuFftPlan"]:
        """The plan, or None for c128 and for sizes outside B1's domain."""
        if complex_dtype(dtype) != torch.complex64:
            return None
        if stockham_vpu.radix_schedule(size) is None:
            return None
        return cls(size, stockham_vpu.make_stage_tables(size, True),
                   stockham_vpu.make_stage_tables(size, False), device)

    def tables(self, forward: bool):
        """The compact (m, r) stage tables of the plain version, as views."""
        return stage_views(self.fwd if forward else self.inv, self._shapes)

    def _execute_bm(self, re_t, im_t, transform: Transform):
        forward = transform.is_forward
        return stockham_vpu.vpu_fft_batch_minor(
            re_t, im_t, self.size, forward, self._scale_for(transform),
            tables=self.tables(forward),
            kernel_tables=self.kernel_fwd if forward else self.kernel_inv,
        )

    def extra_repr(self) -> str:
        return f"size={self.size}, schedule={self.schedule}, family={self.family}"
