"""The plan interface: plan-then-execute on torch tensors.

Port of ``fourier_tpu/plan/base.py``. A plan is a ``torch.nn.Module`` built on
an explicit device, whose twiddle tables are non-persistent buffers; execution
is plain tensor code (or a kernel launch) on planar (re, im) planes.

The FFT is linear, so its reverse-mode rule needs no kernel internals: the
transpose of the planar map of the DFT matrix W is the map of conj(W), the
UNSCALED inverse. The gradient of any plan is therefore one more call of the
same plan in the transposed mode (``_TRANSPOSE_MODE``), wrapped in the
``torch.autograd.Function`` :class:`_LinearFft`:

  FFT <-> UNSCALED_IFFT,  SQRT pair <-> each other,  IFFT -> FFT / N.

Each public call (``transform_planar``, ``transform_planar_bm``, their
4-plane twins and the complex ``transform``) is a ``call`` span of
``fourier_tpu_torch.trace``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from fourier_tpu_torch import trace
from fourier_tpu_torch.transform import Transform

_TRANSPOSE_MODE = {
    Transform.FFT: (Transform.UNSCALED_IFFT, False),
    Transform.UNSCALED_IFFT: (Transform.FFT, False),
    Transform.IFFT: (Transform.FFT, True),
    Transform.SQRT_SCALED_FFT: (Transform.SQRT_SCALED_IFFT, False),
    Transform.SQRT_SCALED_IFFT: (Transform.SQRT_SCALED_FFT, False),
}

_COMPLEX_DTYPES = {
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}


def complex_dtype(dtype) -> torch.dtype:
    """torch.complex64/complex128 from a torch, numpy or string dtype."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = np.dtype(dtype).name
    if name not in _COMPLEX_DTYPES:
        raise ValueError(f"unsupported dtype {dtype}; use complex64 or complex128")
    return _COMPLEX_DTYPES[name]


def resolve_device(device) -> torch.device:
    """`device` as a torch.device, a bare "cuda" as the current card. Raises
    RuntimeError for a CUDA device when no card is present: the port plans
    on the CPU only when the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} needs a CUDA card and none is "
                "available; pass device='cpu' to plan on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def numpy_real(dtype: torch.dtype):
    """The numpy real type of a complex torch dtype's planes."""
    return np.float32 if dtype == torch.complex64 else np.float64


class _LinearFft(torch.autograd.Function):
    """A plan call whose backward is the same plan in the transposed mode."""

    @staticmethod
    def forward(ctx, plan, re, im, transform, batch_minor):
        ctx.plan = plan
        ctx.transform = transform
        ctx.batch_minor = batch_minor
        run = plan._execute_bm if batch_minor else plan._execute
        return run(re, im, transform)

    @staticmethod
    def backward(ctx, gre, gim):
        plan = ctx.plan
        tmode, scale_1n = _TRANSPOSE_MODE[ctx.transform]
        run = plan._execute_bm if ctx.batch_minor else plan._execute
        gre, gim = run(gre.contiguous(), gim.contiguous(), tmode)
        if scale_1n:
            gre, gim = gre / plan.size, gim / plan.size
        return None, gre, gim, None, None


class FftPlan(torch.nn.Module):
    """Base class for FFT plans (``trait Fft`` analog)."""

    size: int
    dtype: torch.dtype  # complex64 / complex128
    family: str  # the planner family that builds this plan

    def _execute(self, re, im, transform: Transform):
        """Transform the last axis of planar (..., size) planes."""
        raise NotImplementedError

    def _execute_bm(self, re_t, im_t, transform: Transform):
        """Transform the leading axis of batch-minor (size, B) planes.
        Families without a native batch-minor path transpose."""
        ore, oim = self._execute(re_t.T, im_t.T, transform)
        return ore.T, oim.T

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    @property
    def real_dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype == torch.complex64 else torch.float64

    def _scale_for(self, transform: Transform) -> Optional[float]:
        return transform.scale(self.size)

    def _planes(self, re, im, axis: int):
        """Validate planar input and cast it to the plan's real dtype."""
        re = torch.as_tensor(re)
        im = torch.as_tensor(im)
        if re.shape != im.shape:
            raise ValueError(f"re/im shapes differ: {tuple(re.shape)} vs {tuple(im.shape)}")
        if re.ndim == 0 or re.shape[axis] != self.size:
            raise ValueError(
                f"transform axis of input has length "
                f"{re.shape[axis] if re.ndim else 0}, but plan size is {self.size}"
            )
        for t in (re, im):
            if t.device != self.device:
                raise ValueError(
                    f"input on {t.device} but plan on {self.device}; build the "
                    f"plan with device={str(t.device)!r}"
                )
        rt = self.real_dtype
        return re.to(rt).contiguous(), im.to(rt).contiguous()

    # -- planar execution ---------------------------------------------------

    def transform_planar(
        self, re, im, transform: Transform = Transform.FFT
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Apply a transform over the last axis of planar (re, im) planes of
        shape (..., size); leading axes are batch dimensions."""
        with trace.call("transform_planar"):
            re, im = self._planes(re, im, -1)
            return _LinearFft.apply(self, re, im, Transform(transform), False)

    def transform_planar_bm(
        self, re_t, im_t, transform: Transform = Transform.FFT
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Apply a transform over the leading axis of batch-minor (size, B)
        planar planes."""
        with trace.call("transform_planar_bm"):
            if torch.as_tensor(re_t).ndim != 2:
                raise ValueError("batch-minor planes must be 2-D (size, B)")
            re_t, im_t = self._planes(re_t, im_t, 0)
            return _LinearFft.apply(self, re_t, im_t, Transform(transform), True)

    # -- the JAX package's 4-plane double-word API (complex128 plans) --------

    def _dd(self, call, planes, transform: Transform, name: str):
        from fourier_tpu_torch.precision import planes as dd_planes

        with trace.call(f"{name}_dd"):
            limbs = dd_planes.limbs(planes, self.dtype, name)
            if limbs[0].numel() == 0:
                return tuple(torch.empty_like(p) for p in limbs)
            return dd_planes.split(call(*dd_planes.join(limbs), transform))

    def transform_planar_dd(self, re_hi, re_lo, im_hi, im_lo,
                            transform: Transform = Transform.FFT):
        """The JAX package's c128 call on double-word f32 planes (re_hi,
        re_lo, im_hi, im_lo) of shape (..., size): the planes joined to
        f64, :meth:`transform_planar`, the result split into four f32
        planes (``precision/planes.py``). complex128 plans only."""
        return self._dd(self.transform_planar, (re_hi, re_lo, im_hi, im_lo),
                        transform, "transform_planar")

    def transform_planar_dd_bm(self, re_hi, re_lo, im_hi, im_lo,
                               transform: Transform = Transform.FFT):
        """:meth:`transform_planar_dd` on batch-minor (size, B) planes,
        through :meth:`transform_planar_bm`."""
        return self._dd(self.transform_planar_bm, (re_hi, re_lo, im_hi, im_lo),
                        transform, "transform_planar_bm")

    # -- complex convenience ------------------------------------------------

    def transform(self, x, transform: Transform = Transform.FFT):
        """Out-of-place transform of a complex array of shape (..., size).

        Accepts a numpy array (run on the plan's device, returned as numpy)
        or a torch tensor on the plan's device (returned as a tensor).
        """
        with trace.call("transform"):
            as_numpy = not isinstance(x, torch.Tensor)
            if as_numpy:
                x = torch.as_tensor(np.asarray(x), device=self.device)
            if not x.is_complex() or x.dtype != self.dtype:
                x = x.to(self.dtype)
            ore, oim = self.transform_planar(x.real, x.imag, transform)
            out = torch.complex(ore, oim)
            return out.detach().cpu().numpy() if as_numpy else out

    def forward(self, x, transform: Transform = Transform.FFT):
        return self.transform(x, transform)

    def fft(self, x):
        """Forward FFT."""
        return self.transform(x, Transform.FFT)

    def ifft(self, x):
        """Scaled (1/N) inverse FFT."""
        return self.transform(x, Transform.IFFT)

    def fft_planar(self, re, im):
        return self.transform_planar(re, im, Transform.FFT)

    def ifft_planar(self, re, im):
        return self.transform_planar(re, im, Transform.IFFT)

    def __len__(self) -> int:
        return self.size


class BatchMinorPlan(FftPlan):
    """A plan whose native layout is batch-minor (size, B): a batch-major
    call transposes once each way around :meth:`_execute_bm`."""

    def _execute(self, re, im, transform: Transform):
        batch_shape = re.shape[:-1]
        b = math.prod(batch_shape)  # symbolic under torch.export
        re_t = re.reshape(b, self.size).T.contiguous()
        im_t = im.reshape(b, self.size).T.contiguous()
        ore, oim = self._execute_bm(re_t, im_t, transform)
        return (ore.T.reshape(*batch_shape, self.size),
                oim.T.reshape(*batch_shape, self.size))


def planar_buffer(tables, real_dtype, device) -> torch.Tensor:
    """Pack per-stage planar (re, im) numpy tables into one (2, L) tensor."""
    flat = [np.stack([np.ravel(tr), np.ravel(ti)]) for tr, ti in tables]
    data = np.concatenate(flat, axis=1) if flat else np.zeros((2, 0))
    return torch.as_tensor(data.astype(real_dtype), device=device)


def stage_views(buf: torch.Tensor, shapes):
    """Split a (2, L) planar buffer back into per-stage (re, im) views."""
    views, off = [], 0
    for m, r in shapes:
        views.append((buf[0, off:off + m * r].view(m, r),
                      buf[1, off:off + m * r].view(m, r)))
        off += m * r
    return views
