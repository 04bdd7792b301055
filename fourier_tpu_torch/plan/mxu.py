"""MXU-family plan: the DFT as dense matrix products.

Port of ``fourier_tpu/plan/mxu.py``: planar tables computed in f64 at plan
time and narrowed to f32. A size with a split n = n1*n2 (n1, n2 <= 128) runs
two phases; small sizes, and any size the planner sends to
:meth:`MxuFftPlan.create_direct`, run one full-size DFT product. The mode
scale is folded into the last table at call time. Three forms, as in the JAX
package (``impl``):

* ``"xla"`` (the planner's): the ``torch.einsum`` forms of
  :mod:`fourier_tpu_torch.ops.bailey` in full float32, the split twiddle
  folded into the phase-B table. Below ``DIRECT_SINGLE_MAX`` a split whose
  factors are both < 64 becomes one full-size product.
* ``"xla_packed"``: phase B block-diagonal packed (``packed_phase_b``), in
  ``torch.einsum``; a single-phase plan (n <= 128) runs kernel B9a.
* ``"pallas"``: the fused kernels of :mod:`fourier_tpu_torch.ops.cuda.bailey`,
  B9a for n <= 128 and B9b for a split, on a CUDA device; their plain
  versions on the CPU. ``tb``, the TPU kernels' batch tile, caps the
  transforms a block takes; no result depends on it.

Every form's products of a call lie in the span ``dft.product[n, phases]``
and count ``dft.products`` and ``dft.product_flops``
(:meth:`MxuFftPlan.product_flops`; ``fourier_tpu_torch.trace``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from fourier_tpu_torch import trace
from fourier_tpu_torch.ops import bailey
from fourier_tpu_torch.ops.cuda import bailey as bailey_kernels
from fourier_tpu_torch.ops.dft_matrix import (choose_pack, choose_split,
                                              dft_matrix, folded_phase_b,
                                              packed_phase_b, split_twiddle)
from fourier_tpu_torch.plan.base import FftPlan, complex_dtype, resolve_device
from fourier_tpu_torch.transform import Transform

IMPLS = ("xla", "xla_packed", "pallas")


def _planar(a: np.ndarray):
    return a.real.astype(np.float32), a.imag.astype(np.float32)


class MxuFftPlan(FftPlan):
    """DFT-product plan for n = n1*n2 (n1, n2 <= 128), complex64."""

    family = "mxu"

    # The JAX package's measured crossover, kept so that both packages plan
    # the same family per size: below it one full-size DFT product replaces
    # an "xla" two-phase split whose factors are both < 64, and the planner
    # prefers it to Bluestein for split-less sizes. The card's vpu route
    # runs B2 in place of such a product where B2 takes the size
    # (``plan/planner.py``, ``_card_bluestein``).
    DIRECT_SINGLE_MAX = 768

    def __init__(self, size: int, n1: int, n2: int, fwd_tables, inv_tables,
                 device, *, impl: str = "xla", tb: Optional[int] = None):
        """`fwd_tables`/`inv_tables`: f32 numpy arrays, (dre, dim) of the
        (n, n) DFT matrix when n1 == 1, else D_n2 (n2, n2) and then, by
        `impl`: the (n2, n1, n1) folded phase-B table ("xla"), the
        (n2/pack, pack*n1, pack*n1) packed one ("xla_packed"), or the
        (n2, n1) split twiddle and D_n1 (n1, n1) ("pallas")."""
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"unknown MxuFftPlan impl {impl!r}; use one of {IMPLS}")
        self.size = int(size)
        self.n1 = int(n1)
        self.n2 = int(n2)
        self.dtype = torch.complex64
        self.impl = impl
        self.tb = None if tb is None else int(tb)
        for name, tables in (("fwd", fwd_tables), ("inv", inv_tables)):
            pairs = [tables[i:i + 2] for i in range(0, len(tables), 2)]
            for j, (tr, ti) in enumerate(pairs):
                buf = torch.as_tensor(np.stack([tr, ti]).astype(np.float32),
                                      device=device)
                self.register_buffer(f"{name}{j}", buf, persistent=False)
        self._ntables = len(fwd_tables) // 2

    @property
    def single_phase(self) -> bool:
        return self.n1 == 1

    @classmethod
    def create(cls, size: int, dtype=torch.complex64, device="cuda", *,
               impl: str = "xla", tb: Optional[int] = None) -> Optional["MxuFftPlan"]:
        """Plan `size`, or None for c128 and when no n1*n2 (<= 128 each)
        split exists."""
        if size < 1:
            raise ValueError(f"FFT size must be >= 1, got {size}")
        if complex_dtype(dtype) != torch.complex64:
            return None
        split = cls.planned_split(size, impl)
        if split is None:
            return None
        n1, n2 = split
        tables = {}
        for fwd in (True, False):
            if n1 == 1:
                tables[fwd] = _planar(dft_matrix(size, fwd))
                continue
            d2 = _planar(dft_matrix(n2, fwd))
            if impl == "xla":
                tables[fwd] = d2 + _planar(folded_phase_b(n1, n2, fwd))
            elif impl == "xla_packed":
                tables[fwd] = d2 + _planar(
                    packed_phase_b(n1, n2, fwd, choose_pack(n1, n2)))
            else:
                tables[fwd] = (d2 + _planar(split_twiddle(n1, n2, fwd))
                               + _planar(dft_matrix(n1, fwd)))
        return cls(size, n1, n2, tables[True], tables[False],
                   resolve_device(device), impl=impl, tb=tb)

    @classmethod
    def planned_split(cls, size: int, impl: str = "xla") -> Optional[Tuple[int, int]]:
        """The (n1, n2) :meth:`create` builds for `size`: (1, size) for one
        full-size product, None when no n1*n2 (<= 128 each) split exists."""
        split = choose_split(size)
        if split is None:
            return None
        n1, n2 = split
        if (n1 != 1 and size <= cls.DIRECT_SINGLE_MAX and max(n1, n2) < 64
                and impl == "xla"):
            return 1, size
        return n1, n2

    @classmethod
    def single_product(cls, size: int) -> bool:
        """Whether the route plans `size` as one full-size DFT product: a
        split :meth:`create` demotes to one, or a split-less size up to
        ``DIRECT_SINGLE_MAX`` (which the planner builds with
        :meth:`create_direct`)."""
        split = cls.planned_split(size)
        return split[0] == 1 if split else size <= cls.DIRECT_SINGLE_MAX

    @classmethod
    def create_direct(cls, size: int, dtype=torch.complex64,
                      device="cuda") -> Optional["MxuFftPlan"]:
        """One full-size DFT product for any size (no split needed), or
        None for c128."""
        if size < 1:
            raise ValueError(f"FFT size must be >= 1, got {size}")
        if complex_dtype(dtype) != torch.complex64:
            return None
        tables = {fwd: _planar(dft_matrix(size, fwd)) for fwd in (True, False)}
        return cls(size, 1, size, tables[True], tables[False],
                   resolve_device(device))

    def tables(self, forward: bool):
        """The planar (re, im) tables of one direction, in order."""
        name = "fwd" if forward else "inv"
        return [(b[0], b[1]) for b in
                (getattr(self, f"{name}{j}") for j in range(self._ntables))]

    def _execute(self, re, im, transform: Transform):
        batch_shape = re.shape[:-1]
        b = math.prod(batch_shape)  # symbolic under torch.export
        re2 = re.reshape(b, self.size)
        im2 = im.reshape(b, self.size)
        *head, (lre, lim) = self.tables(transform.is_forward)
        scale = self._scale_for(transform)
        if scale is not None:
            lre, lim = lre * scale, lim * scale
        if self.impl != "xla" and (self.single_phase or self.impl == "pallas"):
            # The kernels read contiguous (B, n) rows; a batch-minor call
            # comes here as transposed views.
            re2, im2 = re2.contiguous(), im2.contiguous()
        with trace.span("dft.product", n=self.size, phases=1 if self.single_phase else 2):
            if self.single_phase:
                if self.impl == "xla":
                    ore, oim = bailey.xla_fft_single(re2, im2, lre, lim)
                else:
                    ore, oim = bailey_kernels.mxu_fft_single(re2, im2, lre, lim,
                                                             tb=self.tb)
            elif self.impl == "pallas":
                (d2re, d2im), (tre, tim) = head
                ore, oim = bailey_kernels.mxu_fft_two_phase(
                    re2, im2, d2re, d2im, tre, tim, lre, lim, tb=self.tb)
            else:
                (d2re, d2im), = head
                form = (bailey.xla_fft_two_phase_folded if self.impl == "xla"
                        else bailey.xla_fft_two_phase_packed)
                ore, oim = form(re2, im2, d2re, d2im, lre, lim)
        trace.count("dft.products")
        if isinstance(b, int):  # symbolic under torch.export: nothing to add
            trace.count("dft.product_flops", self.product_flops(b))
        return (ore.reshape(*batch_shape, self.size),
                oim.reshape(*batch_shape, self.size))

    def product_flops(self, batch: int) -> int:
        """Real operations the DFT products of one call on `batch`
        transforms issue: four real products a complex one, two operations
        a multiply-add. One direct product: 8·B·n². Two phases: D_n2 on
        each of the n1 columns, 8·B·n·n2, then phase B on each of the n2
        rows, 8·B·n·n1, times the packing where phase B is packed (the
        split twiddle is no product)."""
        if self.single_phase:
            return 8 * batch * self.size * self.size
        pack = self.fwd1.shape[-1] // self.n1 if self.impl == "xla_packed" else 1
        return 8 * batch * self.size * (self.n2 + pack * self.n1)

    def extra_repr(self) -> str:
        return (f"size={self.size}, split=({self.n1},{self.n2}), impl={self.impl}, "
                f"tb={self.tb}, family={self.family}")
