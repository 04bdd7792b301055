"""Kernel B8: the radix-r DIT split combine in native f64.

Port of ``fourier_tpu/ops/pallas/dd_combine.py``. A split plan
(``precision/dd_split.py``) computes FFT_n, n = r*m with r in {2, 3, 5}, as
one batched m-point transform of the r residue classes and this O(n)
combine. Layout, every step a view with no copy:

  input   (n, B) planes, row i*r + t = class t, index i
        = (m, r*B) with column t*B + b holding class t, batch b
          -- the batched sub-plan's batch-minor input and output
  output  (r, m, B), section j = X[j*m : (j+1)*m], so its (n, B) view is the
          spectrum in natural order

Section j, row k is sum_t (class t[k] * w^(t*k) * scale) * W_r^(j*t): the
classes 1..r-1 are twiddled by the plan's tables (w^(t*k), direction-matched)
and the mode scale rides those tables and class 0.

:func:`dd_split_combine_batch_minor_reference` is the plain PyTorch version,
:func:`dd_split_combine_batch_minor` the kernel's wrapper (library
``csrc/stockham_vpu_dd.cu``): it runs the plain version for tensors on the
CPU, launches the kernel (or raises) for tensors on a CUDA device, through
the registered operator ``fourier_tpu_torch::dd_split_combine``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from fourier_tpu_torch.ops import cplx
from fourier_tpu_torch.ops.butterflies import BUTTERFLIES
from fourier_tpu_torch.ops.cuda.stockham_vpu import (check_planes, check_tables,
                                                     scale_arg, stream_of)
from fourier_tpu_torch.ops.cuda.stockham_vpu_dd import F64, launch

RADICES = (2, 3, 5)


def dd_split_combine_batch_minor_reference(re_t, im_t, n: int, r: int, tables,
                                           forward: bool,
                                           scale: Optional[float]):
    """Plain PyTorch B8: (m, r*B) class sub-spectra -> (n, B) spectrum.
    `tables`: the (2, r-1, m) planar twiddles, row t-1 = w^(t*k). Port of
    ``dd_combine._combine_kernel``'s math."""
    m = n // r
    b = re_t.shape[1] // r
    s = scale_arg(scale)
    parts = [(re_t[:, t * b:(t + 1) * b], im_t[:, t * b:(t + 1) * b])
             for t in range(r)]
    parts[0] = cplx.scale(parts[0], s)
    for t in range(1, r):
        w = (tables[0, t - 1][:, None] * s, tables[1, t - 1][:, None] * s)
        parts[t] = cplx.mul(parts[t], w)
    outs = BUTTERFLIES[r](parts, forward)
    return (torch.stack([o[0] for o in outs]).reshape(n, b),
            torch.stack([o[1] for o in outs]).reshape(n, b))


def dd_split_combine_batch_minor(re_t, im_t, n: int, r: int, forward: bool,
                                 scale: Optional[float], *, tables):
    """B8 over contiguous planar f64 (m, r*B) class sub-spectra; returns new
    (n, B) spectrum planes (views of (r, m, B) ones).

    `tables`: the (2, r-1, m) f64 planar twiddles of the plan, on the planes'
    device, direction-matched.
    """
    if r not in RADICES or n % r:
        raise ValueError(f"B8 combines r in {RADICES} classes of n/r, got "
                         f"n={n}, r={r}")
    m = n // r
    check_planes(re_t, im_t, (m,), "B8", F64)
    if re_t.shape[1] % r:
        raise ValueError(f"B8 takes (m, r*B) planes, got {tuple(re_t.shape)}")
    if tuple(tables.shape) != (2, r - 1, m):
        raise ValueError(f"B8 takes (2, {r - 1}, {m}) tables, got "
                         f"{tuple(tables.shape)}")
    if re_t.device.type == "cpu":
        return dd_split_combine_batch_minor_reference(re_t, im_t, n, r, tables,
                                                      forward, scale)
    check_tables(re_t.device, tables, dtype=F64)
    return _dd_split_combine_op(re_t, im_t, n, r, forward, scale, tables)


@torch.library.custom_op("fourier_tpu_torch::dd_split_combine", mutates_args=(),
                         device_types="cuda")
def _dd_split_combine_op(re_t: Tensor, im_t: Tensor, n: int, r: int, forward: bool,
                         scale: Optional[float], tables: Tensor
                         ) -> Tuple[Tensor, Tensor]:
    """B8's launch (see :func:`dd_split_combine_batch_minor`)."""
    m = n // r
    batch = re_t.shape[1] // r
    out_re = torch.empty(n, batch, dtype=F64, device=re_t.device)
    out_im = torch.empty_like(out_re)
    if batch == 0:
        return out_re, out_im
    launch(
        "fourier_tpu_torch::dd_split_combine",
        "fourier_split_combine_c128", f"B8 at n={n}, r={r}, B={batch}",
        re_t.data_ptr(), im_t.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        r, m, batch, tables[0].data_ptr(), tables[1].data_ptr(),
        int(forward), scale_arg(scale), re_t.device.index, stream_of(re_t),
    )
    return out_re, out_im


@_dd_split_combine_op.register_fake
def _(re_t, im_t, n, r, *_):
    out = re_t.new_empty((n, re_t.shape[1] // r))
    return out, torch.empty_like(out)
