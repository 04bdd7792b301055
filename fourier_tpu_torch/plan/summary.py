"""Plan introspection: what a plan will execute, and its cost model.

Port of ``fourier_tpu/plan/summary.py``: :func:`summarize` gives a
:class:`PlanSummary` (kind, stages, flops and minimum device-memory bytes per
transform, table bytes, sub-plan summaries) of any plan of the port,
:func:`describe` its rendering.

The complex64 plans (``RfftPlan``, ``AutosortPlan``, ``MxuFftPlan``,
``BluesteinPlan``, ``FourStepLocalPlan``, ``VpuFftPlan``,
``VpuBluesteinPlan``) get the JAX package's kind, stage list, flops and
minimum bytes, so the two summaries of one plan compare field by field.
``table_bytes`` is the port's own: the bytes of the plan's buffers, its
sub-plans' included (the port keeps compact (m, r) stage tables and the
kernels' tables beside them).

The complex128 plans are native f64 here, not the JAX package's double-word
f32: they get the port's own kinds (``VpuFusedF64``,
``VpuFusedBluesteinF64``, ``SplitRadix<r>F64``, ``DdFft[<kind>]F64``,
``MxuDdDirectF64``; the f64 ``AutosortPlan`` and ``BluesteinPlan`` keep the
c64 kinds) with f64 flop counts and two f64 planes
in and out, not the double-word multipliers and four f32 planes of the JAX
package's summaries. The sharded plans (``fourier_tpu_torch.parallel``)
get the JAX package's kinds, flops and stages, with each exchange named for
its transport (the mesh's process-group backend: NCCL between cards), not
ICI; their ``table_bytes`` are this rank's buffers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from fourier_tpu_torch.plan.convert import SHARDED_CLASSES


@dataclass
class PlanSummary:
    kind: str
    size: int
    dtype: str
    flops_per_transform: float  # algorithm flops (not the 5NlogN convention)
    table_bytes: int
    min_hbm_bytes_per_transform: int  # in + out planes, perfectly fused
    stages: List[str] = field(default_factory=list)
    children: List["PlanSummary"] = field(default_factory=list)

    def render(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [
            f"{pad}{self.kind}(n={self.size}, dtype={self.dtype}): "
            f"{self.flops_per_transform / 1e3:.1f} kflop/transform, "
            f"tables {self.table_bytes / 1024:.0f} KiB, "
            f"min-HBM {self.min_hbm_bytes_per_transform / 1024:.0f} KiB"
        ]
        lines += [f"{pad}  - {s}" for s in self.stages]
        lines += [c.render(indent + 1) for c in self.children]
        return "\n".join(lines)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _buffer_bytes(plan) -> int:
    """Bytes of the plan's buffers, its sub-plans' included."""
    return sum(b.numel() * b.element_size() for b in plan.buffers())


def _stage_flops(n: int, schedule) -> float:
    return float(sum(6.0 * n * np.log2(r) for r in schedule))


def summarize(plan) -> PlanSummary:
    """Build a PlanSummary for any plan of the port."""
    from fourier_tpu_torch.plan.autosort import AutosortPlan
    from fourier_tpu_torch.plan.bluestein import BluesteinPlan
    from fourier_tpu_torch.plan.bluestein_fused import VpuBluesteinPlan
    from fourier_tpu_torch.plan.four_step_local import FourStepLocalPlan
    from fourier_tpu_torch.plan.mxu import MxuFftPlan
    from fourier_tpu_torch.plan.vpu import VpuFftPlan
    from fourier_tpu_torch.precision import (DdFftPlan, DdMxuDirectPlan,
                                             DdSplitPow2Plan, DdSplitRadixPlan,
                                             VpuDdBluesteinPlan, VpuDdFftPlan)
    from fourier_tpu_torch.rfft import RfftPlan

    tables = _buffer_bytes(plan)
    dtype = _dtype_name(plan.dtype)
    c64 = plan.dtype == torch.complex64
    if type(plan).__name__ in SHARDED_CLASSES:
        return _summarize_sharded(plan, tables, dtype, 8 if c64 else 16)

    if isinstance(plan, RfftPlan):
        inner = summarize(plan.inner)
        stages = (
            ["even/odd de-interleave (reshape)", "half-size c2c FFT",
             "Hermitian unpack + W twiddle"]
            if plan.even
            else ["zero imaginary plane", "full c2c FFT", "one-sided slice"]
        )
        real_bytes = 4 if c64 else 8
        return PlanSummary(
            "RealFft", plan.n, dtype, inner.flops_per_transform + 8.0 * plan.n,
            tables, plan.n * real_bytes + plan.out_len * 2 * real_bytes, stages,
            [inner])

    n = plan.size
    io = 2 * n * (8 if c64 else 16)  # planar pairs in and out

    if isinstance(plan, AutosortPlan):
        stages, s = [], n
        for r in plan.radices:
            stages.append(f"radix-{r} stage (size {s} -> {s // r})")
            s //= r
        return PlanSummary("Stockham", n, dtype, _stage_flops(n, plan.radices),
                           tables, io, stages)

    if isinstance(plan, MxuFftPlan):
        if plan.single_phase:
            flops = 8.0 * n * n
            stages = [f"dense {n}x{n} DFT matmul (MXU)"]
        else:
            flops = 8.0 * n * (plan.n1 + plan.n2) + 14.0 * n
            stages = [
                f"phase A: {plan.n2}-point DFT matmul, batch {plan.n1}",
                f"glue twiddle ({plan.n2}x{plan.n1})"
                + (" folded into phase B" if plan.impl == "xla" else ""),
                f"phase B: {plan.n1}-point DFT contraction, batch {plan.n2}",
            ]
        return PlanSummary(f"MxuBailey[{plan.impl}]", n, dtype, flops, tables,
                           io, stages)

    if isinstance(plan, BluesteinPlan):
        inner = summarize(plan.inner)
        flops = 2 * inner.flops_per_transform + 6.0 * (3 * n + plan.inner.size)
        stages = [
            f"chirp multiply + zero-pad to {plan.inner.size}",
            "inner forward FFT",
            "spectral multiply by w",
            "inner inverse FFT",
            "chirp multiply + normalize",
        ]
        return PlanSummary("Bluestein", n, dtype, flops, tables, io, stages, [inner])

    if isinstance(plan, FourStepLocalPlan):
        col = summarize(plan.col_plan)
        row = summarize(plan.row_plan)
        flops = (plan.p * col.flops_per_transform
                 + plan.q * row.flops_per_transform + 6.0 * n)
        stages = [
            f"column FFTs ({plan.q}-point x {plan.p})",
            f"dense split twiddle ({plan.p}x{plan.q})",
            f"row FFTs ({plan.p}-point x {plan.q})",
            "natural-order transpose",
        ]
        return PlanSummary("FourStepLocal", n, dtype, flops, tables, io, stages,
                           [col, row])

    if isinstance(plan, (VpuFftPlan, VpuDdFftPlan)):
        sched = plan.schedule
        if c64:
            kind, stages = "VpuFused", [f"fused VMEM radix-{r} stage" for r in sched]
        else:
            kind, stages = "VpuFusedF64", [f"fused radix-{r} stage (f64)"
                                           for r in sched]
        return PlanSummary(kind, n, dtype, _stage_flops(n, sched), tables, io,
                           stages)

    if isinstance(plan, (VpuBluesteinPlan, VpuDdBluesteinPlan)):
        m = plan.m_inner
        sched = plan.stages.schedule
        flops = 2 * _stage_flops(m, sched) + 18.0 * n
        if c64:
            kind, tag = "VpuFusedBluestein", "fused VMEM"
        else:
            kind, tag = "VpuFusedBluesteinF64", "fused f64"
        stages = (
            [f"{tag} chirp multiply + zero-pad"]
            + [f"{tag} radix-{r} stage (fwd)" for r in sched]
            + [f"{tag} w multiply"]
            + [f"{tag} radix-{r} stage (inv)" for r in sched]
            + [f"{tag} chirp multiply (1/M folded)"]
        )
        return PlanSummary(kind, n, dtype, flops, tables, io, stages)

    if isinstance(plan, (DdSplitPow2Plan, DdSplitRadixPlan)):
        r, m = plan.radix, n // plan.radix
        sub = summarize(plan.sub)
        # r sub-transforms, a complex twiddle on (r-1)/r of the points and a
        # radix-r butterfly over all of them.
        flops = (r * sub.flops_per_transform + 6.0 * n * (r - 1) / r
                 + 6.0 * n * np.log2(r))
        stages = [
            f"de-interleave {r} residue classes (view)",
            f"batched fused f64 FFT x{r} ({m}-point, one kernel call)",
            f"f64 twiddle + radix-{r} combine (one kernel call)",
        ]
        return PlanSummary(f"SplitRadix{r}F64", n, dtype, flops, tables, io,
                           stages, [sub])

    if isinstance(plan, DdFftPlan):
        body = summarize(plan.body)
        return PlanSummary(f"DdFft[{plan.kind}]F64", n, dtype, body.flops_per_transform,
                           tables, io, [f"f64 {plan.kind} body"], [body])

    if isinstance(plan, DdMxuDirectPlan):
        return PlanSummary("MxuDdDirectF64", n, dtype, 8.0 * n * n, tables, io,
                           [f"dense {n}x{n} DFT matmul (f64, four real products)"])

    return PlanSummary(type(plan).__name__, n, dtype, 0.0, tables, io)


def _summarize_sharded(plan, tables: int, dtype: str, eb: int) -> PlanSummary:
    """The sharded families: port of ``fourier_tpu/plan/summary.py:257-350``
    (the exchange named for its transport)."""
    from fourier_tpu_torch.parallel.sharded import exchange_backend

    n, io = plan.size, 2 * plan.size * eb
    via = exchange_backend(plan)
    overlap = (f", {plan.pipeline_chunks} overlapped chunks"
               if getattr(plan, "pipeline_chunks", 1) > 1 else "")
    kind = type(plan).__name__
    if kind == "FourStepPlan":
        col, row = summarize(plan.col_plan), summarize(plan.row_plan)
        flops = (plan.n2 * col.flops_per_transform + plan.n1 * row.flops_per_transform
                 + 6.0 * n)
        stages = [f"column FFTs ({plan.n1}-point, sharded over {plan.axis!r})",
                  "split twiddle",
                  f"all_to_all transpose over {plan.axis!r} ({via})",
                  f"row FFTs ({plan.n2}-point)"]
        return PlanSummary("FourStepSharded", n, dtype, flops, tables, io, stages,
                           [col, row])
    restore = [] if getattr(plan, "transposed_output", False) else [
        f"all_to_all layout restore ({via})"]
    if kind == "Fft2dPlan":
        col, row = summarize(plan.col_plan), summarize(plan.row_plan)
        flops = plan.n1 * row.flops_per_transform + plan.n2 * col.flops_per_transform
        stages = [f"row FFTs ({plan.n2}-point, rows sharded over {plan.axis!r})",
                  f"all_to_all transpose over {plan.axis!r} ({via}){overlap}",
                  f"column FFTs ({plan.n1}-point)"] + restore
        return PlanSummary("Fft2dSharded", n, dtype, flops, tables, io, stages,
                           [row, col])
    if kind == "Rfft2dPlan":
        rp, col = summarize(plan.rplan), summarize(plan.col_plan)
        flops = plan.n1 * rp.flops_per_transform + plan.n2p * col.flops_per_transform
        stages = [f"row r2c FFTs ({plan.n2}->{plan.out_len} bins, pad to {plan.n2p})",
                  f"all_to_all transpose over {plan.axis!r} (half-spectrum bytes, {via})",
                  f"column FFTs ({plan.n1}-point)"] + restore
        return PlanSummary("Rfft2dSharded", n, dtype, flops, tables, n * eb // 2,
                           stages, [rp, col])
    ax = "/".join(repr(a) for a in plan.axes)
    mirror = [] if plan.spectral_output else ["mirror all_to_alls: natural layout restore"]
    if kind == "Fft3dPlan":
        subs = [summarize(p) for p in (plan.plan0, plan.plan1, plan.plan2)]
        per_line = (plan.n0 * plan.n1, plan.n0 * plan.n2, plan.n1 * plan.n2)
        flops = sum(c * s.flops_per_transform for c, s in zip(per_line, subs))
        first = f"n2 FFTs ({plan.n2}-point, pencils whole)"
        io_bytes, name = io, "Fft3dPencil"
        a2a = f"all_to_all over {ax} ({via}){overlap}"
    else:
        subs = [summarize(p) for p in (plan.rplan, plan.plan1, plan.plan0)]
        flops = (plan.n0 * plan.n1 * subs[0].flops_per_transform
                 + plan.n0 * plan.n2p * subs[1].flops_per_transform
                 + plan.n1 * plan.n2p * subs[2].flops_per_transform)
        first = f"n2 r2c FFTs ({plan.n2}->{plan.out_len} bins, pad to {plan.n2p})"
        io_bytes, name = n * eb // 2, "Rfft3dPencil"
        a2a = f"all_to_all over {ax} (half-spectrum bytes, {via}){overlap}"
    stages = [first, a2a, f"n1 FFTs ({plan.n1}-point)",
              f"all_to_all over first mesh axis ({via})",
              f"n0 FFTs ({plan.n0}-point)"] + mirror
    return PlanSummary(name, n, dtype, flops, tables, io_bytes, stages, subs)


def describe(plan) -> str:
    """Human-readable multi-line plan description."""
    return summarize(plan).render()
