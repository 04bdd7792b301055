"""Single-device four-step plan: a large transform from two sub-plans.

Port of ``fourier_tpu/plan/four_step_local.py``. For n = p*q, built from any
plan for q (the column transforms) and any plan for p (the row transforms):

    X[k1*q + k2] = sum_a W_p^(a*k1) * W_n^(a*k2) * sum_b x[a + p*b] * W_q^(b*k2)

Batch-major (:meth:`_execute`): reshape to (q, p), column transforms, the
dense split twiddle, row transforms, transpose to natural order.
Batch-minor (:meth:`_execute_bm`): the (n, B) planes reshape contiguously to
(q, p*B) for the column plan; then, when the row plan is a VpuFftPlan,
kernel B3 applies the split twiddle and the mode scale, runs the p-point
transforms and stores in natural order (its clustered-block body,
``csrc/four_step_pair.cu``, reads the forward twiddle in both directions;
its stage body, ``csrc/stockham_vpu.cu``, the direction-matched one);
otherwise the twiddle (scale folded in), one (q, p, B) -> (p, q, B)
transpose and the row plan do it in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fourier_tpu_torch.ops import cplx
from fourier_tpu_torch.ops.cuda import stockham_vpu
from fourier_tpu_torch.plan.base import (FftPlan, complex_dtype, numpy_real,
                                         resolve_device)
from fourier_tpu_torch.plan.vpu import VpuFftPlan
from fourier_tpu_torch.transform import Transform


def _split_twiddle_t(p: int, q: int, forward: bool):
    """Planar f64 W_n^(±a*k2) of shape (p, q), indexed [a, k2]."""
    a = np.arange(p, dtype=np.float64)[:, None]
    k2 = np.arange(q, dtype=np.float64)[None, :]
    theta = 2.0 * np.pi * (a * k2) / float(p * q)
    return np.cos(theta), (-np.sin(theta) if forward else np.sin(theta))


def choose_large_split(n: int, limit: int = 16384) -> Optional[Tuple[int, int]]:
    """The most balanced divisor pair (p, q), p <= q, both <= limit; None
    for n <= limit or when there is none."""
    if n <= limit:
        return None
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            other = n // cand
            return (cand, other) if other <= limit else None
    return None


class FourStepLocalPlan(FftPlan):
    """n = p*q transform composed from sub-plans for p and q."""

    family = "mxu"  # built by the mxu route (_create_mxu_composite)

    def __init__(self, size: int, p: int, q: int, dtype, col_plan: FftPlan,
                 row_plan: FftPlan, tw_fwd, tw_inv, device):
        """`col_plan` transforms size q, `row_plan` size p; `tw_fwd`/`tw_inv`:
        planar numpy (p, q) split twiddles [a, k2], held transposed, (q, p)."""
        super().__init__()
        self.size = int(size)
        self.p = int(p)
        self.q = int(q)
        self.dtype = complex_dtype(dtype)
        self.col_plan = col_plan
        self.row_plan = row_plan
        rt = numpy_real(self.dtype)
        for name, (tr, ti) in (("tw_fwd", tw_fwd), ("tw_inv", tw_inv)):
            buf = np.stack([np.asarray(tr).T, np.asarray(ti).T])
            buf = np.ascontiguousarray(buf, dtype=rt)
            self.register_buffer(name, torch.as_tensor(buf, device=device),
                                 persistent=False)

    @classmethod
    def create(cls, size: int, dtype, p: int, q: int, plan_factory,
               device="cuda") -> "FourStepLocalPlan":
        """Build from `plan_factory(sub_size, dtype, device) -> FftPlan`."""
        if p * q != size:
            raise ValueError(f"split ({p}, {q}) does not multiply to {size}")
        device = resolve_device(device)
        rt = numpy_real(complex_dtype(dtype))
        narrow = lambda t: tuple(a.astype(rt) for a in t)
        return cls(size, p, q, dtype, plan_factory(q, dtype, device),
                   plan_factory(p, dtype, device),
                   narrow(_split_twiddle_t(p, q, True)),
                   narrow(_split_twiddle_t(p, q, False)), device)

    def _execute(self, re, im, transform: Transform):
        forward = transform.is_forward
        batch_shape = re.shape[:-1]
        p, q = self.p, self.q
        mode = Transform.FFT if forward else Transform.UNSCALED_IFFT
        # M[b, a] = x[a + p*b]: columns run over b, the last axis of (.., a, b).
        re = re.reshape(*batch_shape, q, p).transpose(-1, -2)
        im = im.reshape(*batch_shape, q, p).transpose(-1, -2)
        re, im = self.col_plan._execute(re, im, mode)  # (.., a, k2)
        tw = self.tw_fwd if forward else self.tw_inv
        re, im = cplx.mul((re, im), (tw[0].T, tw[1].T))
        re, im = self.row_plan._execute(re.transpose(-1, -2),
                                        im.transpose(-1, -2), mode)  # (.., k2, k1)
        re = re.transpose(-1, -2).reshape(*batch_shape, self.size)
        im = im.transpose(-1, -2).reshape(*batch_shape, self.size)
        scale = self._scale_for(transform)
        if scale is not None:
            re, im = re * scale, im * scale
        return re, im

    def _execute_bm(self, re_t, im_t, transform: Transform):
        forward = transform.is_forward
        b = re_t.shape[-1]
        p, q = self.p, self.q
        mode = Transform.FFT if forward else Transform.UNSCALED_IFFT
        tw = self.tw_fwd if forward else self.tw_inv  # (q, p) [k2, a]
        scale = self._scale_for(transform)
        re, im = self.col_plan._execute_bm(re_t.reshape(q, p * b),
                                           im_t.reshape(q, p * b), mode)
        rp = self.row_plan
        if isinstance(rp, VpuFftPlan):
            # A column plan without a native batch-minor path returns
            # transposed views; B3 reads contiguous planes.
            return stockham_vpu.vpu_fft_four_step_row(
                re.reshape(q, p, b).contiguous(), im.reshape(q, p, b).contiguous(),
                p, q, forward, scale,
                tables=rp.tables(forward),
                kernel_tables=rp.kernel_fwd if forward else rp.kernel_inv,
                pair_tables=rp.pair_fwd,
                pre_tw=(tw[0], tw[1]), tw_fwd=(self.tw_fwd[0], self.tw_fwd[1]),
            )
        twr, twi = tw[0], tw[1]
        if scale is not None:
            twr, twi = twr * scale, twi * scale
        re, im = cplx.mul((re.reshape(q, p, b), im.reshape(q, p, b)),
                          (twr[:, :, None], twi[:, :, None]))
        re = re.transpose(0, 1).reshape(p, q * b)  # the one transpose
        im = im.transpose(0, 1).reshape(p, q * b)
        re, im = rp._execute_bm(re, im, mode)  # [k1, (k2, B)]
        return re.reshape(self.size, b), im.reshape(self.size, b)

    def extra_repr(self) -> str:
        return f"size={self.size}, split=({self.p},{self.q})"
