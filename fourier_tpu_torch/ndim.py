"""Multi-dimensional FFTs: NdFftPlan, fftn / ifftn / fft2 / ifft2.

Port of ``fourier_tpu/ndim.py``. An N-D transform is separable: a 1-D plan
runs along each transformed axis, and the mode's normalization is applied
once over the whole transformed size (IFFT scales by 1/prod(shape), the
sqrt-scaled pair stays unitary).

Layout: every pass runs its 1-D plan's batch-minor entry
(``transform_planar_bm``) on a contiguous (n_axis, rest) plane, the native
layout of kernels B1 and B6. Each pass therefore permutes the planes at
most once, to bring its axis to the front; an axis that already leads in
memory is taken first and costs no copy, and the result is handed back as
a permuted view of the last pass's layout (no copy back). ``dims`` below
names the original axis at each position of the planes as they lie.

complex128 runs the ``dd`` route's plans in native f64 on a CUDA device.
The JAX package's 4-plane double-word call (``transform_planar_dd``) joins
its planes to f64, runs the 2-plane call and splits the result
(``precision/planes.py``); ``is_dd`` is False, since the plans' own
representation is two f64 planes. The ``nn.Module`` takes the place of its
pytree registration.

Every entry point runs on the card unless the caller asks for the CPU: a
plan is built on ``device`` ("cuda" by default), a numpy input is copied to
``device`` once and back once, and a tensor input runs on its own device.
An axis never runs on another device than its plan's: a mismatch raises.
The module functions run the planner's cached 1-D plans (``_axis_plans``);
only an ``NdFftPlan`` owns plans of its own.

In place: a pass of a complex64 transform on a CUDA device whose axis
plan is a ``VpuFftPlan`` with B1's clustered body on a tensor where it
lies (``VpuFftPlan.strided``: B1's clustered sizes up to 4096, not
B1_STAGE_FASTER) runs no plane at all, where that body fills its tiles
along the axis (``VpuFftPlan.fills_strided``: the last axis, or one with at
least half a tile's columns after it). It runs B1 on the contiguous complex
tensor as it lies, the axis read and written at the tensor's strides
(``VpuFftPlan.transform_strided``): the first pass into a new tensor, the
others in place on it, the last one with the whole transform's scale. Where
every pass runs so, no copy, join or scale pass is left and the result is
contiguous; the other passes of a call (the 3 channels' axis of an
(H, W, 3) image, say) then run over planes, unscaled, as below. This
leaves the JAX package's route (planes an axis, as above), which every
other call keeps: complex128, other sizes and plans, CPU tensors, a tensor
that records a gradient, the planar calls and the real family.

Spans (``fourier_tpu_torch.trace``): each public call is a ``call``, each
pass an ``axis`` (attribute ``axis``, the original axis), and the layout
work alone, never a plan's call, ``layout.to_front`` (the copy that brings
an axis to the front, or makes an input contiguous for the in-place
passes), ``layout.scale`` (the normalization's multiply) and
``layout.join`` (planes joined into a complex tensor). Counts: one
``axis.in_place`` a pass of the in-place route, one ``axis.copied`` a pass
over planes.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from fourier_tpu_torch import trace
from fourier_tpu_torch.plan.base import complex_dtype, resolve_device
from fourier_tpu_torch.plan.planner import create_fft
from fourier_tpu_torch.plan.vpu import VpuFftPlan
from fourier_tpu_torch.precision import planes as dd_planes
from fourier_tpu_torch.transform import Transform


def _memory_order(planes):
    """The planes permuted (a view) so that their dims run outermost first
    in memory, and the original axis at each position."""
    t = planes[0]
    dims = sorted(range(t.ndim), key=lambda d: -t.stride(d))
    return tuple(p.permute(dims) for p in planes), dims


def _to_front(planes, dims, axis: int):
    """The planes with original axis `axis` leading and contiguous (a copy
    unless it leads in memory already), and their new dims."""
    i = dims.index(axis)
    dims = [axis] + dims[:i] + dims[i + 1:]
    return tuple(p.movedim(i, 0).contiguous() for p in planes), dims


def _restore(planes, dims):
    """The planes as views in the original axis order."""
    back = [int(d) for d in np.argsort(dims)]
    return tuple(p.permute(back) for p in planes)


def _c2c(planes, dims, axis_plans, mode: Transform):
    """(re, im) after each (axis, 1-D plan) pass of `axis_plans` in `mode`,
    each on the plan's batch-minor entry; the axis leading in memory goes
    first."""
    for axis, plan in sorted(axis_plans, key=lambda ap: ap[0] != dims[0]):
        with trace.span("axis", axis=axis):
            with trace.span("layout.to_front"):
                (re, im), dims = _to_front(planes, dims, axis)
            shape = re.shape
            ore, oim = plan.transform_planar_bm(re.reshape(shape[0], -1),
                                                im.reshape(shape[0], -1), mode)
            planes = (ore.reshape(shape), oim.reshape(shape))
        trace.count("axis.copied")
    return planes, dims


def _run(planes, dims, axes, plans, transform: Transform):
    """(planes, dims) after `transform` over the original `axes`, one 1-D
    plan of `plans` each: unscaled passes, then the scale over the whole
    transformed size."""
    transform = Transform(transform)
    mode = Transform.FFT if transform.is_forward else Transform.UNSCALED_IFFT
    planes, dims = _c2c(planes, dims, list(zip(axes, plans)), mode)
    scale = transform.scale(int(np.prod([p.size for p in plans], dtype=np.int64)))
    if scale is not None:
        with trace.span("layout.scale"):
            planes = tuple(p * scale for p in planes)
    return planes, dims


def _card(x: torch.Tensor) -> bool:
    """Whether `x` lies on a CUDA device, where B1 runs on a tensor as it
    lies."""
    return x.device.type == "cuda"


def _strided_passes(shape, device, axes, plans) -> List[bool]:
    """For each (axis, plan) pass over a contiguous complex64 tensor of
    `shape` on `device`, whether B1 runs it on the tensor where it lies:
    the plan a ``VpuFftPlan`` on `device` whose body fills its tiles along
    the axis (``VpuFftPlan.fills_strided``)."""
    return [isinstance(p, VpuFftPlan) and p.device == device
            and p.fills_strided(math.prod(shape[axis % len(shape) + 1:]))
            for axis, p in zip(axes, plans)]


def _in_place_passes(x: torch.Tensor, axes, plans) -> List[bool]:
    """For each (axis, plan) pass over `x`, whether it runs in place: `x`
    complex64 on a card (:func:`_card`) and not recording a gradient (the
    planes' calls carry the VJP), and :func:`_strided_passes`."""
    if (x.dtype != torch.complex64 or not _card(x)
            or (x.requires_grad and torch.is_grad_enabled())):
        return [False] * len(plans)
    return _strided_passes(tuple(x.shape), x.device, axes, plans)


def _transform_in_place(x: torch.Tensor, axes, plans, forward: bool,
                        scale: Optional[float]):
    """Complex64 `x` transformed over `axes` in the `forward` direction,
    one pass of B1 an axis on the tensor where it lies, the last pass times
    `scale` (None: 1): a new contiguous tensor."""
    if not x.is_contiguous():
        with trace.span("layout.to_front"):
            x = x.contiguous()
    out = None
    for i, (axis, plan) in enumerate(zip(axes, plans)):
        with trace.span("axis", axis=axis):
            out = plan.transform_strided(x if out is None else out, axis, forward,
                                         scale if i == len(plans) - 1 else None, out=out)
        trace.count("axis.in_place")
    return out


def _transform_axes(x: torch.Tensor, axes, plans, transform: Transform,
                    divide: bool = False):
    """Complex `x` (a tensor on the plans' device) transformed over `axes`,
    a complex tensor of the plans' dtype in `x`'s axis order; `divide`: also
    divided by the transformed size (numpy's ``norm="forward"``). The passes
    that :func:`_in_place_passes` allows run first, in place, the last of
    them with the whole scale; the others over planes."""
    dtype = plans[0].dtype
    if not x.is_complex() or x.dtype != dtype:
        x = x.to(dtype)
    transform = Transform(transform)
    size = int(np.prod([p.size for p in plans], dtype=np.int64))
    in_place = _in_place_passes(x, axes, plans)
    if not any(in_place):
        planes, dims = _run(*_memory_order((x.real, x.imag)), axes, plans, transform)
    else:
        x = _transform_in_place(x, [a for a, i in zip(axes, in_place) if i],
                                [p for p, i in zip(plans, in_place) if i],
                                transform.is_forward,
                                1.0 / size if divide else transform.scale(size))
        if all(in_place):
            return x
        mode = Transform.FFT if transform.is_forward else Transform.UNSCALED_IFFT
        planes, dims = _c2c(*_memory_order((x.real, x.imag)),
                            [(a, p) for a, p, i in zip(axes, plans, in_place) if not i], mode)
    with trace.span("layout.join"):
        out = torch.complex(*_restore(planes, dims))
    if divide and not any(in_place):
        with trace.span("layout.scale"):
            out = out / size
    return out


def _axis_plans(sizes, dtype, device):
    """The planner's cached default 1-D plan of each size on `device`."""
    return [create_fft(int(n), dtype, device=device) for n in sizes]


class NdFftPlan(torch.nn.Module):
    """Separable N-D plan: one 1-D plan per transformed axis, owned by this
    plan (built with ``cache=False``; equal sizes share one), so ``.to()``
    moves them all and no plan another caller uses."""

    def __init__(self, shape: Sequence[int], dtype=torch.complex64, *,
                 backend: str = "auto", device="cuda"):
        super().__init__()
        shape = tuple(int(s) for s in shape)
        if not shape:
            raise ValueError("NdFftPlan needs at least one axis")
        dtype = complex_dtype(dtype)
        device = resolve_device(device)
        owned = {}
        for s in shape:
            if s not in owned:
                owned[s] = create_fft(s, dtype, backend=backend, device=device,
                                      cache=False)
        self._setup(shape, dtype, [owned[s] for s in shape])

    @classmethod
    def from_plans(cls, plans) -> "NdFftPlan":
        """A plan over the given 1-D plans, one per axis in order (e.g.
        each axis of a JAX ``NdFftPlan`` loaded with ``load_jax_plan``)."""
        plans = list(plans)
        if not plans:
            raise ValueError("NdFftPlan needs at least one axis")
        dtype, device = plans[0].dtype, plans[0].device
        for p in plans:
            if p.dtype != dtype or p.device != device:
                raise ValueError(
                    f"axis plans disagree: {p.dtype} on {p.device} vs "
                    f"{dtype} on {device}")
        plan = cls.__new__(cls)
        torch.nn.Module.__init__(plan)
        plan._setup(tuple(p.size for p in plans), dtype, plans)
        return plan

    def _setup(self, shape, dtype: torch.dtype, plans) -> None:
        self.shape = shape
        self.dtype = dtype
        self.plans = torch.nn.ModuleList(plans)
        self.size = int(np.prod(shape, dtype=np.int64))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def is_dd(self) -> bool:
        """False: the port's complex128 is two f64 planes, not the JAX
        package's four double-word f32 planes (whose 4-plane call
        :meth:`transform_planar_dd` a complex128 plan takes as well)."""
        return False

    @property
    def device(self) -> torch.device:
        return self.plans[0].device

    @property
    def real_dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype == torch.complex64 else torch.float64

    def extra_repr(self) -> str:
        return f"shape={self.shape}, dtype={self.dtype}"

    def transform_planar(self, re, im, transform: Transform = Transform.FFT):
        """Transform the trailing ``ndim`` axes of planar (re, im) planes."""
        with trace.call("NdFftPlan.transform_planar"):
            re = torch.as_tensor(re).to(self.real_dtype)
            im = torch.as_tensor(im).to(self.real_dtype)
            if re.shape != im.shape:
                raise ValueError(f"re/im shapes differ: {tuple(re.shape)} vs "
                                 f"{tuple(im.shape)}")
            if tuple(re.shape[max(re.ndim - self.ndim, 0):]) != self.shape:
                raise ValueError(
                    f"trailing axes {tuple(re.shape[-self.ndim:])} do not match "
                    f"plan shape {self.shape}")
            planes, dims = _memory_order((re, im))
            axes = range(re.ndim - self.ndim, re.ndim)
            return _restore(*_run(planes, dims, axes, self.plans, transform))

    def transform_planar_dd(self, re_hi, re_lo, im_hi, im_lo,
                            transform: Transform = Transform.FFT):
        """The JAX package's N-D c128 call on double-word f32 planes of
        shape (..., *shape): joined to f64, :meth:`transform_planar`, split
        into four f32 planes. complex128 plans only."""
        with trace.call("NdFftPlan.transform_planar_dd"):
            return dd_planes.run(self.transform_planar, (re_hi, re_lo, im_hi, im_lo),
                                 self.dtype, "transform_planar", transform)

    def transform(self, x, transform: Transform = Transform.FFT):
        """Complex convenience over the trailing ``ndim`` axes: a numpy
        array (run on the plan's device, numpy out) or a tensor on the
        plan's device (tensor out)."""
        with trace.call("NdFftPlan.transform"):
            as_numpy = not isinstance(x, torch.Tensor)
            xt = torch.as_tensor(np.asarray(x), device=self.device) if as_numpy else x
            if tuple(xt.shape[max(xt.ndim - self.ndim, 0):]) != self.shape:
                raise ValueError(
                    f"trailing axes {tuple(xt.shape[-self.ndim:])} do not match "
                    f"plan shape {self.shape}")
            out = _transform_axes(xt, range(xt.ndim - self.ndim, xt.ndim),
                                  self.plans, transform)
            return out.detach().cpu().numpy() if as_numpy else out

    def forward(self, x, transform: Transform = Transform.FFT):
        return self.transform(x, transform)

    def fft(self, x):
        return self.transform(x, Transform.FFT)

    def ifft(self, x):
        return self.transform(x, Transform.IFFT)

    def fft_planar(self, re, im):
        return self.transform_planar(re, im, Transform.FFT)

    def ifft_planar(self, re, im):
        return self.transform_planar(re, im, Transform.IFFT)


def _norm_mode(norm: Optional[str], forward: bool):
    """numpy.fft ``norm`` -> (Transform mode, extra 1/N scale needed?).

    backward (default): fft unscaled, ifft 1/N. ortho: 1/sqrt(N) both ways.
    forward: fft 1/N, ifft unscaled; the 1/N forward scale has no Transform
    mode, so the caller applies it when the flag comes back True.
    """
    if norm in (None, "backward"):
        return (Transform.FFT if forward else Transform.IFFT), False
    if norm == "ortho":
        return (
            Transform.SQRT_SCALED_FFT if forward else Transform.SQRT_SCALED_IFFT
        ), False
    if norm == "forward":
        return (Transform.FFT if forward else Transform.UNSCALED_IFFT), forward
    raise ValueError(f"norm must be backward/ortho/forward, got {norm!r}")


def _crop_pad_axis(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """numpy.fft semantics: truncate or zero-pad `axis` to length n."""
    cur = x.shape[axis]
    if cur >= n:
        return x.narrow(axis, 0, n)
    shape = list(x.shape)
    shape[axis] = n - cur
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _as_tensor(x, device):
    """(`x` as a tensor, whether it came as numpy): a numpy `x` goes to
    `device` once, a tensor stays on its own."""
    if isinstance(x, torch.Tensor):
        return x, False
    return torch.as_tensor(np.asarray(x), device=resolve_device(device)), True


def _resolve_axes(x_ndim: int, s, axes, ndim: Optional[int]):
    if axes is not None:
        axes = [int(a) % x_ndim for a in np.atleast_1d(axes)]
        if len(set(axes)) != len(axes):
            raise ValueError(f"repeated axis in axes={axes}")
    elif s is not None:
        axes = list(range(x_ndim - len(s), x_ndim))
    else:
        k = x_ndim if ndim is None else ndim
        axes = list(range(x_ndim - k, x_ndim))
    if s is not None and len(s) != len(axes):
        raise ValueError("s and axes must have the same length")
    return axes


def _fftn_impl(x, s, axes, norm, ndim, dtype, forward: bool, device):
    xt, as_numpy = _as_tensor(x, device)
    if dtype is None:
        # numpy-parity promotion: double-precision input (f64/c128) ->
        # complex128, everything else -> the native complex64 path.
        dtype = (torch.complex128
                 if xt.dtype in (torch.float64, torch.complex128)
                 else torch.complex64)
    axes = _resolve_axes(xt.ndim, s, axes, ndim)
    if s is not None:
        for n, ax in zip(s, axes):
            xt = _crop_pad_axis(xt, int(n), ax)
    mode, fwd_scale = _norm_mode(norm, forward)
    plans = _axis_plans([xt.shape[a] for a in axes], dtype, xt.device)
    out = _transform_axes(xt, axes, plans, mode, divide=fwd_scale)
    return out.detach().cpu().numpy() if as_numpy else out


def fftn(x, ndim: Optional[int] = None, dtype=None, *, s=None, axes=None,
         norm: Optional[str] = None, device="cuda"):
    """Forward FFT over `axes` (default: trailing `ndim` axes, default all).

    numpy.fft.fftn compatibility: ``s`` crops/zero-pads each transformed
    axis, ``axes`` selects arbitrary axes, ``norm`` is backward/ortho/forward.
    A numpy `x` runs on ``device`` (numpy out), a tensor on its own device.
    """
    with trace.call("fftn"):
        return _fftn_impl(x, s, axes, norm, ndim, dtype, True, device)


def ifftn(x, ndim: Optional[int] = None, dtype=None, *, s=None, axes=None,
          norm: Optional[str] = None, device="cuda"):
    """Inverse FFT over `axes` (numpy.fft.ifftn compatibility)."""
    with trace.call("ifftn"):
        return _fftn_impl(x, s, axes, norm, ndim, dtype, False, device)


def fft2(x, dtype=None, *, s=None, axes=(-2, -1), norm: Optional[str] = None,
         device="cuda"):
    """2-D forward FFT (numpy.fft.fft2 compatibility)."""
    with trace.call("fft2"):
        return _fftn_impl(x, s, list(axes), norm, None, dtype, True, device)


def ifft2(x, dtype=None, *, s=None, axes=(-2, -1), norm: Optional[str] = None,
          device="cuda"):
    """2-D inverse FFT (numpy.fft.ifft2 compatibility)."""
    with trace.call("ifft2"):
        return _fftn_impl(x, s, list(axes), norm, None, dtype, False, device)
