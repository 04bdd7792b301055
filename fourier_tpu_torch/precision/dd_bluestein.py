"""One-kernel f64 Bluestein plan: kernel B7 as a plan.

Port of ``fourier_tpu/precision/dd_bluestein.py``: the whole c128 chirp-z
(chirp multiply, zero rows, inner forward transform, w multiply, inner
inverse transform, output chirp) in one kernel, B7
(``csrc/stockham_vpu_dd.cu``), on a CUDA device, and through B7's plain
version on the CPU. Eligible: sizes whose inner M = next_power_of_two(2n-1)
is in B6's domain and at most ``MAX_INNER`` = 2048 (17 <= n <= 1024), as in
the JAX package. The chirp and w tables are the composed plan's
(``plan/bluestein._chirp_tables``), kept in f64; the inner inverse
transform's 1/M is folded into the output chirp. Batch-minor (n, B) is the
native layout; B is not padded.
"""

from __future__ import annotations

from typing import Optional

import torch

from fourier_tpu_torch.ops.cuda import stockham_vpu_dd
from fourier_tpu_torch.plan.bluestein_fused import FusedBluesteinPlan
from fourier_tpu_torch.plan.factor import next_power_of_two
from fourier_tpu_torch.precision.vpu_dd_plan import VpuDdFftPlan


class VpuDdBluesteinPlan(FusedBluesteinPlan):
    """One-kernel Bluestein chirp-z plan (complex128 in f64, batch-minor)."""

    dtype = torch.complex128
    stages_plan = VpuDdFftPlan
    run = staticmethod(stockham_vpu_dd.vpu_dd_bluestein_batch_minor)

    # The JAX package's ceiling (its kernel's two stage pipelines at
    # M = 4096 did not fit the TPU's VMEM), kept so that both packages plan
    # the same family per size. On the card one M = 2048 column takes
    # 32 KiB of shared memory.
    MAX_INNER = 2048

    def body_tables(self) -> dict:
        """The paired body's tables: B7 has no other body."""
        return dict(pair_tables=(self.stages.pair_fwd, self.stages.pair_inv))

    @staticmethod
    def choose_inner(size: int, max_inner: int) -> Optional[int]:
        """next_power_of_two(2n-1) when it is in B6's domain and at most
        `max_inner`, else None."""
        m = next_power_of_two(2 * size - 1)
        if m > max_inner or stockham_vpu_dd.radix_schedule_dd(m) is None:
            return None
        return m
