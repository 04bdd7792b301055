"""Fused f64 Stockham plan over batch-minor planes: kernel B6 as a plan.

Port of ``fourier_tpu/precision/vpu_dd_plan.py``. The JAX plan carries a
complex128 value as four f32 planes (double-word hi/lo pairs) and pads B to
128 lanes; this plan carries it as two float64 planes, through the same
planar API as the c64 plans (``transform_planar_bm``, ``transform_planar``,
``fft``, ``ifft``), and never pads B: the kernel masks the ragged column
group. On a CUDA device every call launches B6
(``csrc/stockham_vpu_dd.cu``); on the CPU it runs B6's plain version.
Domain: ``radix_schedule_dd`` (n = 2^a*3^b*5^c, 8 | n, 64..4096, and 243,
729, 625).
"""

from __future__ import annotations

import torch

from fourier_tpu_torch.ops.cuda import stockham_vpu_dd
from fourier_tpu_torch.plan.vpu import FusedStagesPlan


class VpuDdFftPlan(FusedStagesPlan):
    """Fused all-stages c128 plan in native f64, batch-minor."""

    dtype = torch.complex128
    radix_schedule = staticmethod(stockham_vpu_dd.radix_schedule_dd)
    make_stage_tables = staticmethod(stockham_vpu_dd.make_stage_tables_dd)
    make_kernel_tables = staticmethod(stockham_vpu_dd.make_kernel_tables_dd)
    pair_geometry = staticmethod(stockham_vpu_dd.fft_pair_geometry_dd)
    run = staticmethod(stockham_vpu_dd.vpu_dd_fft_batch_minor)
