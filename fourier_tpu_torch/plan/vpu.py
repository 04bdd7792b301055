"""Fused Stockham plan over batch-minor planes: kernel B1 as a plan.

Port of ``fourier_tpu/plan/vpu.py``. The native entry point is
:meth:`transform_planar_bm` on batch-minor (n, B) planes, the layout in
which a chained pipeline (fft -> pointwise filter -> ifft) needs no
transposes; batch-major ``transform_planar`` transposes once each way. On a
CUDA device every call launches the hand-written kernel; on the CPU it runs
the kernel's plain PyTorch version. B is not padded.

:class:`FusedStagesPlan` holds what the c64 plan and its f64 twin
(``precision/vpu_dd_plan.VpuDdFftPlan``, kernel B6) share; each names its
schedule, tables and kernel wrapper.
"""

from __future__ import annotations

import torch

from fourier_tpu_torch.ops.cuda import stockham_vpu
from fourier_tpu_torch.plan.base import (BatchMinorPlan, complex_dtype,
                                         numpy_real, planar_buffer,
                                         resolve_device, stage_views)
from fourier_tpu_torch.transform import Transform


class FusedStagesPlan(BatchMinorPlan):
    """A plan whose every call is one fused all-stages kernel. Subclasses
    set ``dtype`` and the static functions of their kernel module:
    ``radix_schedule(n)``, ``make_stage_tables(n, forward)``,
    ``make_kernel_tables(n, forward)``, ``pair_geometry(n)`` (the
    clustered body's launch, or None) and the wrapper ``run``."""

    family = "vpu"

    #: The buffers of the kernel's own tables: the stage body's and the
    #: clustered body's (None where the size has no clustered body), by
    #: direction.
    KERNEL_BUFFERS = ("kernel_fwd", "kernel_inv", "pair_fwd", "pair_inv")

    def __init__(self, size: int, fwd_tables, inv_tables, device,
                 kernel_tables=None):
        """`fwd_tables`/`inv_tables`: the compact planar numpy (m, r) tables
        of the schedule. `kernel_tables`: the kernel's own tables, a mapping
        of each name of KERNEL_BUFFERS to a planar (2, L) array or None, as
        a saved plan holds them; None: built here from the size, in f64
        narrowed to the plan's precision."""
        super().__init__()
        self.size = int(size)
        self.schedule = tuple(self.radix_schedule(self.size))
        self._shapes = tuple((tr.shape[0], tr.shape[1]) for tr, _ in fwd_tables)
        real = numpy_real(self.dtype)
        for name, tables in (("fwd", fwd_tables), ("inv", inv_tables)):
            self.register_buffer(name, planar_buffer(tables, real, device),
                                 persistent=False)
        if kernel_tables is None:
            kernel_tables = self.build_kernel_tables(self.size)
        for name in self.KERNEL_BUFFERS:
            table = kernel_tables[name]
            self.register_buffer(
                name, None if table is None else torch.as_tensor(table, device=device),
                persistent=False)

    @classmethod
    def build_kernel_tables(cls, size: int) -> dict:
        """The kernel's own tables at `size` (KERNEL_BUFFERS): the stage
        body's (``make_kernel_tables``) and, where ``pair_geometry`` gives a
        clustered body, its :func:`~fourier_tpu_torch.ops.cuda.stockham_vpu.pair_tables`
        on the body's clusters."""
        geo = cls.pair_geometry(size)
        real = numpy_real(cls.dtype)
        out = {}
        for forward, d in ((True, "fwd"), (False, "inv")):
            out[f"kernel_{d}"] = cls.make_kernel_tables(size, forward)
            out[f"pair_{d}"] = (None if geo is None else
                                stockham_vpu.pair_tables(size, forward, real, geo.ranks))
        return out

    @classmethod
    def create(cls, size: int, dtype=None, device="cuda"):
        """The plan, or None for the other complex dtype and for sizes
        outside the kernel's domain (`dtype` None: the plan's own)."""
        if dtype is not None and complex_dtype(dtype) != cls.dtype:
            return None
        if cls.radix_schedule(size) is None:
            return None
        return cls(size, cls.make_stage_tables(size, True),
                   cls.make_stage_tables(size, False), resolve_device(device))

    def tables(self, forward: bool):
        """The compact (m, r) stage tables of the plain version, as views."""
        return stage_views(self.fwd if forward else self.inv, self._shapes)

    def _execute_bm(self, re_t, im_t, transform: Transform):
        forward = transform.is_forward
        return self.run(
            re_t, im_t, self.size, forward, self._scale_for(transform),
            tables=self.tables(forward),
            kernel_tables=self.kernel_fwd if forward else self.kernel_inv,
            pair_tables=self.pair_fwd,
        )

    def extra_repr(self) -> str:
        return f"size={self.size}, schedule={self.schedule}, family={self.family}"


class VpuFftPlan(FusedStagesPlan):
    """Fused all-stages c64 plan for sizes in B1's domain (n = 2^a*3^b*5^c,
    8 | n, 64..16384, and the tabled pure powers of 3 and 5), batch-minor."""

    dtype = torch.complex64
    radix_schedule = staticmethod(stockham_vpu.radix_schedule)
    make_stage_tables = staticmethod(stockham_vpu.make_stage_tables)
    make_kernel_tables = staticmethod(stockham_vpu.make_kernel_tables)
    pair_geometry = staticmethod(stockham_vpu.fft_pair_geometry)
    run = staticmethod(stockham_vpu.vpu_fft_batch_minor)
    run_strided = staticmethod(stockham_vpu.vpu_fft_strided)

    @property
    def strided(self) -> bool:
        """Whether B1 runs its clustered body on a complex64 tensor where it
        lies at this size (:meth:`transform_strided`)."""
        return stockham_vpu.fft_pair_strided_geometry(self.size) is not None

    def fills_strided(self, inner: int) -> bool:
        """Whether :meth:`transform_strided` fills its tiles well enough
        along an axis with `inner` elements after it: the body has a form
        here (:attr:`strided`), and the axis is the last (a tile takes cols
        runs of n) or has at least half a tile's cols after it (a tile
        takes cols columns of one block, so at least half of them live).
        Fewer, as the 3 channels of an (H, W, 3) image against 8 to 256
        cols, leave most of every tile idle: on large tensors the planes
        cost less there (``PERF.md``, its probes of thin axes)."""
        geo = stockham_vpu.fft_pair_strided_geometry(self.size)
        return geo is not None and (inner == 1 or 2 * inner >= geo.cols)

    def transform_strided(self, x, axis: int, forward: bool, scale, out=None):
        """The transform along `axis` of the contiguous complex64 tensor `x`,
        read and written where it lies, times `scale` (None: 1): into a new
        tensor, or into `out`, which may be `x` (in place). Sizes where
        :attr:`strided` is True only; the N-D surface's passes
        (``ndim.py``)."""
        return self.run_strided(x, axis, self.size, forward, scale,
                                tables=self.tables(forward), pair_tables=self.pair_fwd,
                                out=out)
