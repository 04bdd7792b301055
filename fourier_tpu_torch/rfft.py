"""Real-input FFTs: rfft / irfft with numpy.fft conventions.

Port of ``fourier_tpu/rfft.py``. For even n the length-n
real signal is the length-m = n/2 complex signal z[j] = x[2j] + i*x[2j+1]
(a reshape of the planar input), one c2c FFT of size m runs on the plan the
planner picks, and a Hermitian pack with a plan-time twiddle table gives the
n//2+1 one-sided bins:

  Z = FFT_m(z)
  E[k] = (Z[k] + conj(Z[m-k]))/2,   O[k] = -i*(Z[k] - conj(Z[m-k]))/2
  X[k] = E[k] + W_n^k * O[k]  (k = 0..m-1),   X[m] = E[0] - O[0]

The inverse runs the unpack backwards (conj(W)) and one scaled c2c IFFT of
size m. Odd sizes pack two real signals into one complex transform
(z = x1 + i*x2; X1 = (Z + conj(Z_rev))/2, X2 = -i*(Z - conj(Z_rev))/2); the
zero-imaginary-plane fallback remains for a batch of one and an odd
remainder row.

Batch-minor (n, B) is the kernels' native layout. There, on a CUDA device,
an even n whose half m plans as a :class:`VpuFftPlan` runs kernels B4a/B4b
(B1's stages with the pack or unpack fused in, for every m of B1's domain),
and an odd n that plans as a :class:`VpuBluesteinPlan` runs kernels B5a/B5b
(B2's chirp-z with the two-for-one separation or recombination fused in,
column j paired with column j + ceil(B/2)). Every other inner plan runs the
unfused formulation around its ``transform_planar_bm``. On the CPU the
kernels' plain PyTorch versions run. B is never padded. The batch-minor
calls are linear, so their gradients are each other's transform with a bin
weight (:class:`_RfftBm`, :class:`_IrfftBm`); the batch-major calls
differentiate through plain torch ops and the inner plan's own rule.

The half-spectrum twiddles are computed in f64 at plan time and narrowed.
complex128 runs the unfused formulation in f64, with f64 tables, around the
inner plan of the ``dd`` route on a CUDA device (kernels B6, B7 or B8 over
B6, as the JAX package's ``RfftPlan(n, np.complex128, backend="dd")`` on a
TPU) and around the f64 Stockham family on the CPU. The JAX package's
double-word twins (``rfft_planar_dd``, ``irfft_planar_dd``) join their f32
(hi, lo) planes to f64, run the batch-major calls and split the result
(``precision/planes.py``); ``dd`` is False, since the port's c128 is native
f64 and runs the same calls as c64.

The N-D real family (``rfftn``, ``irfftn``, ``hfftn``, ``ihfftn`` and their
2-D forms) runs its last-axis real transform on the batch-minor calls, where
B4/B5 run, and the c2c passes over the other axes through
:mod:`fourier_tpu_torch.ndim` on the same (n_axis, rest) layout: one copy an
axis at most, no host round trip between the passes.

Every entry point runs on the card unless the caller asks for the CPU:
``RfftPlan(..., device="cuda")`` by default, and the module functions plan
a numpy input on ``device`` (default "cuda"); a tensor input runs on its own
device.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from fourier_tpu_torch.ndim import (_as_tensor, _axis_plans, _crop_pad_axis,
                                    _memory_order, _restore, _run, _to_front)
from fourier_tpu_torch.ops import hermitian
from fourier_tpu_torch.ops.cuda import stockham_vpu
from fourier_tpu_torch.plan.base import complex_dtype, resolve_device
from fourier_tpu_torch.plan.bluestein_fused import VpuBluesteinPlan
from fourier_tpu_torch.plan.planner import create_fft
from fourier_tpu_torch.plan.vpu import VpuFftPlan
from fourier_tpu_torch.precision import planes as dd_planes
from fourier_tpu_torch.transform import Transform


class RfftPlan(torch.nn.Module):
    """Plan for real-input forward / inverse FFTs of length ``n``.

    ``rfft_planar(x)`` maps a real plane (..., n) to planar one-sided spectra
    (..., n//2+1) and ``irfft_planar(re, im)`` inverts it; ``rfft_planar_bm``
    and ``irfft_planar_bm`` do the same on batch-minor (n, B) and
    (n//2+1, B) planes. ``rfft`` / ``irfft`` take and give complex arrays.

    The inner c2c plan is built for this plan alone (not taken from the
    planner's cache), so ``.to()`` moves no plan that another one uses.
    """

    def __init__(self, n: int, dtype=torch.complex64, *, backend: str = "auto",
                 device="cuda"):
        super().__init__()
        n = int(n)
        if n < 1:
            raise ValueError(f"rfft size must be >= 1, got {n}")
        dtype = complex_dtype(dtype)
        even = n % 2 == 0
        inner = create_fft(n // 2 if even else n, dtype, backend=backend,
                           device=device, cache=False)
        w = None
        if even:
            theta = 2.0 * np.pi * np.arange(n // 2, dtype=np.float64) / n
            w = np.stack([np.cos(theta), -np.sin(theta)])
        self._setup(n, dtype, inner, w)

    @classmethod
    def from_parts(cls, n: int, dtype, inner, w) -> "RfftPlan":
        """A plan from its inner c2c plan and its planar (2, n/2) twiddle
        table (None for odd n), as a saved plan holds them."""
        plan = cls.__new__(cls)
        torch.nn.Module.__init__(plan)
        plan._setup(int(n), complex_dtype(dtype), inner, w)
        return plan

    def _setup(self, n: int, dtype: torch.dtype, inner, w) -> None:
        self.n = n
        self.dtype = dtype
        self.even = n % 2 == 0
        self.m = n // 2 if self.even else None
        self.inner = inner
        if w is not None:
            w = torch.as_tensor(np.asarray(w), device=inner.device)
            w = w.to(self.real_dtype)
        self.register_buffer("w", w, persistent=False)

    @property
    def real_dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype == torch.complex64 else torch.float64

    @property
    def out_len(self) -> int:
        return self.n // 2 + 1

    @property
    def device(self) -> torch.device:
        return self.inner.device

    @property
    def dd(self) -> bool:
        """False: the port's complex128 is two f64 planes, not the JAX
        package's double-word f32 pairs (whose calls ``rfft_planar_dd`` and
        ``irfft_planar_dd`` a complex128 plan takes as well)."""
        return False

    @property
    def fused(self) -> bool:
        """True when the batch-minor path runs the fused kernels (B4 for
        even n over a VpuFftPlan, B5 for odd n over a VpuBluesteinPlan; both
        complex64 only)."""
        return isinstance(self.inner, VpuFftPlan if self.even else VpuBluesteinPlan)

    def extra_repr(self) -> str:
        kind = "even-split" if self.even else "odd-two-for-one"
        return f"n={self.n}, {kind}, dtype={self.dtype}"

    # -- the formulation around the inner plan -----------------------------------
    #
    # `dim` is the transform axis: -1 on batch-major (..., n) planes, 0 on
    # batch-minor (n, B) ones; `inner` is the inner plan's transform_planar
    # or transform_planar_bm to match.

    def _twiddles(self, dim: int):
        """The (re, im) twiddles broadcast along `dim`."""
        if dim == 0:
            return self.w[0][:, None], self.w[1][:, None]
        return self.w[0], self.w[1]

    def _rfft_even(self, x, dim: int, inner):
        sub = 1 if dim == 0 else -1  # the axis of the (m, 2) sample pairs
        pair = x.unflatten(dim, (self.m, 2))
        zr, zi = inner(pair.select(sub, 0), pair.select(sub, 1), Transform.FFT)
        return hermitian.pack(zr, zi, self._twiddles(dim), dim)

    def _irfft_even(self, re, im, dim: int, inner):
        z = hermitian.unpack(re, im, self._twiddles(dim), dim)
        zr, zi = inner(*z, Transform.IFFT)  # 1/m
        if dim == 0:
            return torch.stack([zr, zi], dim=1).flatten(0, 1)
        return torch.stack([zr, zi], dim=-1).flatten(-2)

    def _rfft_odd(self, x, dim: int, inner):
        """Odd n on 2-D planes: signals j and j + B/2 (contiguous half-slabs)
        share one c2c transform; an odd remainder runs alone, with a zero
        imaginary plane."""
        bd = 1 if dim == 0 else 0  # the batch axis
        b, L = x.shape[bd], self.out_len
        h = b // 2
        parts_r, parts_i = [], []
        if h:
            zr, zi = inner(x.narrow(bd, 0, h), x.narrow(bd, h, h), Transform.FFT)
            (x1r, x1i), (x2r, x2i) = hermitian.separate(zr, zi, L, dim)
            parts_r += [x1r, x2r]
            parts_i += [x1i, x2i]
        if 2 * h < b or not h:
            last = x.narrow(bd, 2 * h, b - 2 * h)
            fr, fi = inner(last, torch.zeros_like(last), Transform.FFT)
            parts_r.append(fr.narrow(dim, 0, L))
            parts_i.append(fi.narrow(dim, 0, L))
        return torch.cat(parts_r, dim=bd), torch.cat(parts_i, dim=bd)

    def _irfft_odd(self, re, im, dim: int, inner):
        """The inverse of :meth:`_rfft_odd`: the two spectra of a pair
        recombine into one c2c inverse."""
        bd = 1 if dim == 0 else 0
        im = hermitian.zero_bins(im, dim, last=False)
        b = re.shape[bd]
        h = b // 2
        cols = lambda t, start, count: t.narrow(bd, start, count)
        parts = []
        if h:
            zr, zi = hermitian.recombine((cols(re, 0, h), cols(im, 0, h)),
                                         (cols(re, h, h), cols(im, h, h)), dim)
            parts += inner(zr, zi, Transform.IFFT)  # 1/n
        if 2 * h < b or not h:
            last = (cols(re, 2 * h, b - 2 * h), cols(im, 2 * h, b - 2 * h))
            zero = torch.zeros_like(last[0])
            zr, zi = hermitian.recombine(last, (zero, zero), dim)
            parts.append(inner(zr, zi, Transform.IFFT)[0])
        return torch.cat(parts, dim=bd)

    # -- batch-minor ----------------------------------------------------------

    def _rfft_bm(self, x_t):
        """Batch-minor forward on a contiguous (n, B) plane: the fused
        kernel where the inner plan has one, else the unfused path."""
        inner = self.inner
        if not self.fused:
            return self._rfft_bm_unfused(x_t)
        if self.even:
            return stockham_vpu.vpu_rfft_pack_batch_minor(
                x_t, self.m, tables=inner.tables(True),
                kernel_tables=inner.kernel_fwd, pair_tables=inner.pair_fwd, w=self.w)
        st = inner.stages
        return stockham_vpu.vpu_rfft_odd_pack_batch_minor(
            x_t, self.n, st.size, tables=(st.tables(True), st.tables(False)),
            kernel_tables=(st.kernel_fwd, st.kernel_inv),
            pair_tables=(st.pair_fwd, st.pair_inv), chirps=inner.chirps(True))

    def _irfft_bm(self, re_t, im_t):
        """Batch-minor inverse on contiguous (n//2+1, B) planes."""
        inner = self.inner
        if not self.fused:
            return self._irfft_bm_unfused(re_t, im_t)
        if self.even:
            return stockham_vpu.vpu_irfft_unpack_batch_minor(
                re_t, im_t, self.m, tables=inner.tables(False),
                kernel_tables=inner.kernel_inv, pair_tables=inner.pair_inv, w=self.w)
        st = inner.stages
        return stockham_vpu.vpu_irfft_odd_unpack_batch_minor(
            re_t, im_t, self.n, st.size,
            tables=(st.tables(True), st.tables(False)),
            kernel_tables=(st.kernel_fwd, st.kernel_inv),
            pair_tables=(st.pair_fwd, st.pair_inv), chirps=inner.chirps(False))

    def _rfft_bm_unfused(self, x_t):
        """The unfused batch-minor forward: plain torch packing around the
        inner plan's ``transform_planar_bm``."""
        run = self._rfft_even if self.even else self._rfft_odd
        return run(x_t, 0, self.inner.transform_planar_bm)

    def _irfft_bm_unfused(self, re_t, im_t):
        """The unfused batch-minor inverse."""
        run = self._irfft_even if self.even else self._irfft_odd
        return run(re_t, im_t, 0, self.inner.transform_planar_bm)

    # -- planar API -------------------------------------------------------------

    def _plane(self, t, axis: int, length: int, what: str):
        t = torch.as_tensor(t)
        if t.ndim == 0 or t.shape[axis] != length:
            got = t.shape[axis] if t.ndim else 0
            raise ValueError(f"{what} axis has length {got}, need {length} "
                             f"(plan n={self.n})")
        if t.device != self.device:
            raise ValueError(f"input on {t.device} but plan on {self.device}; "
                             f"build the plan with device={str(t.device)!r}")
        return t.to(self.real_dtype).contiguous()

    def _spectrum(self, re, im, axis: int):
        re = self._plane(re, axis, self.out_len, "one-sided spectrum")
        im = self._plane(im, axis, self.out_len, "one-sided spectrum")
        if re.shape != im.shape:
            raise ValueError(f"re/im shapes differ: {tuple(re.shape)} vs "
                             f"{tuple(im.shape)}")
        return re, im

    def rfft_planar(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """One-sided spectrum planes (..., n//2+1) of a real plane (..., n)."""
        x = self._plane(x, -1, self.n, "last")
        inner = self.inner.transform_planar
        if self.even:
            return self._rfft_even(x, -1, inner)
        lead = (*x.shape[:-1], self.out_len)
        re, im = self._rfft_odd(x.reshape(-1, self.n), -1, inner)
        return re.reshape(lead), im.reshape(lead)

    def irfft_planar(self, re, im) -> torch.Tensor:
        """Real signal (..., n) from one-sided spectrum planes (..., n//2+1)."""
        re, im = self._spectrum(re, im, -1)
        inner = self.inner.transform_planar
        if self.even:
            return self._irfft_even(re, im, -1, inner)
        flat = lambda t: t.reshape(-1, self.out_len)
        out = self._irfft_odd(flat(re), flat(im), -1, inner)
        return out.reshape(*re.shape[:-1], self.n)

    def rfft_planar_dd(self, xh, xl):
        """dd twin of :meth:`rfft_planar`: (hi, lo) f32 planes (..., n) ->
        4 one-sided f32 planes (re_hi, re_lo, im_hi, im_lo). complex128
        plans only."""
        xh, xl = dd_planes.limbs((xh, xl), self.dtype, "rfft_planar")
        if xh.ndim == 0 or xh.shape[-1] != self.n:
            raise ValueError(f"last axis {xh.shape[-1] if xh.ndim else 0} != plan "
                             f"size {self.n}")
        return dd_planes.split(self.rfft_planar(*dd_planes.join((xh, xl))))

    def irfft_planar_dd(self, reh, rel, imh, iml):
        """dd twin of :meth:`irfft_planar`: 4 one-sided f32 planes
        (..., n//2+1) -> the (hi, lo) f32 real planes (..., n). complex128
        plans only."""
        dd = dd_planes.limbs((reh, rel, imh, iml), self.dtype, "irfft_planar")
        if dd[0].ndim == 0 or dd[0].shape[-1] != self.out_len:
            raise ValueError(f"last axis {dd[0].shape[-1] if dd[0].ndim else 0} != "
                             f"one-sided length {self.out_len}")
        return dd_planes.split((self.irfft_planar(*dd_planes.join(dd)),))

    def rfft_planar_bm(self, x_t) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batch-minor forward: real (n, B) plane -> (n//2+1, B) planes."""
        if torch.as_tensor(x_t).ndim != 2:
            raise ValueError(f"batch-minor input must be (n={self.n}, B)")
        return _RfftBm.apply(self, self._plane(x_t, 0, self.n, "leading"))

    def irfft_planar_bm(self, re_t, im_t) -> torch.Tensor:
        """Batch-minor inverse: (n//2+1, B) spectrum planes -> real (n, B)."""
        if torch.as_tensor(re_t).ndim != 2:
            raise ValueError(f"batch-minor spectrum must be (L={self.out_len}, B)")
        return _IrfftBm.apply(self, *self._spectrum(re_t, im_t, 0))

    # -- complex conveniences ---------------------------------------------------

    def rfft(self, x):
        """One-sided spectrum (..., n//2+1) of real `x` (..., n): a numpy
        array (numpy out) or a tensor on the plan's device (tensor out)."""
        as_numpy = not isinstance(x, torch.Tensor)
        xt = torch.as_tensor(np.asarray(x), device=self.device) if as_numpy else x
        if xt.is_complex():
            xt = xt.real
        out = torch.complex(*self.rfft_planar(xt))
        return out.detach().cpu().numpy() if as_numpy else out

    def irfft(self, x):
        """Real signal (..., n) from the one-sided spectrum `x`."""
        as_numpy = not isinstance(x, torch.Tensor)
        xt = torch.as_tensor(np.asarray(x), device=self.device) if as_numpy else x
        if not xt.is_complex() or xt.dtype != self.dtype:
            xt = xt.to(self.dtype)
        out = self.irfft_planar(xt.real, xt.imag)
        return out.detach().cpu().numpy() if as_numpy else out

    def forward(self, x):
        return self.rfft(x)


# The batch-minor calls run kernels with no backward of their own, but rfft
# and irfft are linear over the planar reals, so each one's VJP is the other
# with a bin weight d_k = 2 - delta_k (delta at DC, and at Nyquist for even
# n: the bins the one-sided form does not double):
#
#   J_rfft^T  ct = n * irfft(ct / d)       (spectrum planes -> real g)
#   J_irfft^T g  = (d / n) * rfft(g)       (real g -> spectrum planes)


def _bin_weights(plan: RfftPlan, like: torch.Tensor) -> torch.Tensor:
    """(L, 1) column of d_k = 2 - delta_k for the plan's one-sided bins."""
    d = torch.full((plan.out_len, 1), 2.0, dtype=like.dtype, device=like.device)
    d[0] = 1.0
    if plan.even:
        d[-1] = 1.0
    return d


class _RfftBm(torch.autograd.Function):
    """Batch-minor rfft whose backward is the batch-minor irfft."""

    @staticmethod
    def forward(ctx, plan, x_t):
        ctx.plan = plan
        return plan._rfft_bm(x_t)

    @staticmethod
    def backward(ctx, ctr, cti):
        plan = ctx.plan
        s = plan.n / _bin_weights(plan, ctr)
        g = _IrfftBm.apply(plan, (ctr * s).contiguous(), (cti * s).contiguous())
        return None, g


class _IrfftBm(torch.autograd.Function):
    """Batch-minor irfft whose backward is the batch-minor rfft."""

    @staticmethod
    def forward(ctx, plan, re_t, im_t):
        ctx.plan = plan
        return plan._irfft_bm(re_t, im_t)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        ctr, cti = _RfftBm.apply(plan, g.contiguous())
        s = _bin_weights(plan, ctr) / plan.n
        return None, ctr * s, cti * s


_RFFT_CACHE: "OrderedDict[Tuple[int, str, str], RfftPlan]" = OrderedDict()
_RFFT_CACHE_MAX = 64


def _rfft_plan(n: int, dtype, device) -> RfftPlan:
    """The LRU-cached default plan of (n, dtype, device)."""
    dtype = complex_dtype(dtype)
    device = resolve_device(device)
    key = (int(n), str(dtype), str(device))
    if key in _RFFT_CACHE:
        _RFFT_CACHE.move_to_end(key)
        return _RFFT_CACHE[key]
    plan = RfftPlan(n, dtype, device=device)
    _RFFT_CACHE[key] = plan
    while len(_RFFT_CACHE) > _RFFT_CACHE_MAX:
        _RFFT_CACHE.popitem(last=False)
    return plan


def _norm_scale(norm: Optional[str], n: int, forward: bool) -> float:
    """numpy.fft real-transform norm factor."""
    if norm in (None, "backward"):
        return 1.0
    if norm == "ortho":
        return 1.0 / np.sqrt(n) if forward else np.sqrt(n)
    if norm == "forward":
        return 1.0 / n if forward else float(n)
    raise ValueError(f"norm must be backward/ortho/forward, got {norm!r}")


def _infer_cdtype(x: torch.Tensor) -> torch.dtype:
    """The JAX package's promotion: double-precision input (f64 or c128) ->
    complex128, everything else -> complex64."""
    return (torch.complex128 if x.dtype in (torch.float64, torch.complex128)
            else torch.complex64)


def _as_last(x, axis: int, device):
    """(tensor with `axis` moved last, whether `x` came as numpy): a numpy
    `x` goes to `device`, a tensor stays on its own."""
    xt, as_numpy = _as_tensor(x, device)
    return torch.movedim(xt, axis, -1), as_numpy


def _scaled(out, scale: float, as_numpy: bool):
    if scale != 1.0:
        out = out * scale
    return out.detach().cpu().numpy() if as_numpy else out


def _finish(out, axis: int, scale: float, as_numpy: bool):
    return _scaled(torch.movedim(out, -1, axis), scale, as_numpy)


def _conj(t: torch.Tensor) -> torch.Tensor:
    return t.conj().resolve_conj() if t.is_complex() else t


def _plan_for(n: int, dtype, xt) -> RfftPlan:
    return _rfft_plan(n, _infer_cdtype(xt) if dtype is None else dtype,
                      xt.device)


def _hermitian_plan(xt, n, dtype, what: str) -> RfftPlan:
    """The plan of a transform from the one-sided `xt`; n defaults to the
    even 2*(bins-1)."""
    plan = _plan_for(2 * (xt.shape[-1] - 1) if n is None else int(n), dtype, xt)
    if xt.shape[-1] != plan.out_len:
        raise ValueError(f"{what} length {xt.shape[-1]} inconsistent with "
                         f"n={plan.n} (need {plan.out_len})")
    return plan


def rfft(x, n: Optional[int] = None, norm: Optional[str] = None, dtype=None,
         axis: int = -1, device="cuda"):
    """One-sided FFT of a real array over ``axis`` (numpy.fft.rfft: ``n``
    crops or zero-pads the input, ``norm`` is backward/ortho/forward).
    ``dtype`` defaults to complex128 for double-precision input, else
    complex64. Takes a numpy array (run on ``device``, numpy out) or a
    tensor (run on its device)."""
    xt, as_numpy = _as_last(x, axis, device)
    if n is not None:
        xt = _crop_pad_axis(xt, int(n), xt.ndim - 1)
    size = xt.shape[-1]
    out = _plan_for(size, dtype, xt).rfft(xt)
    return _finish(out, axis, _norm_scale(norm, size, True), as_numpy)


def irfft(x, n: Optional[int] = None, norm: Optional[str] = None, dtype=None,
          axis: int = -1, device="cuda"):
    """Inverse of :func:`rfft` (numpy.fft.irfft); ``n`` defaults to the even
    2*(bins-1)."""
    xt, as_numpy = _as_last(x, axis, device)
    plan = _hermitian_plan(xt, n, dtype, "spectrum")
    return _finish(plan.irfft(xt), axis, _norm_scale(norm, plan.n, False),
                   as_numpy)


def hfft(x, n: Optional[int] = None, norm: Optional[str] = None, dtype=None,
         axis: int = -1, device="cuda"):
    """FFT of Hermitian-symmetric input -> real spectrum (numpy.fft.hfft):
    ``hfft(a, n) == irfft(conj(a), n) * n``, the norm in the forward
    direction."""
    xt, as_numpy = _as_last(x, axis, device)
    plan = _hermitian_plan(xt, n, dtype, "input")
    out = plan.irfft(_conj(xt)) * plan.n
    return _finish(out, axis, _norm_scale(norm, plan.n, True), as_numpy)


def ihfft(x, norm: Optional[str] = None, dtype=None, axis: int = -1,
          device="cuda"):
    """Inverse of :func:`hfft` (numpy.fft.ihfft): real input -> one-sided
    Hermitian spectrum, ``conj(rfft(x)) / n``."""
    xt, as_numpy = _as_last(x, axis, device)
    size = xt.shape[-1]
    out = _conj(_plan_for(size, dtype, xt).rfft(xt)) / size
    return _finish(out, axis, _norm_scale(norm, size, False), as_numpy)


def rfftfreq(n: int, d: float = 1.0) -> np.ndarray:
    """Sample frequencies for :func:`rfft` (numpy.fft.rfftfreq)."""
    return np.arange(n // 2 + 1, dtype=np.float64) / (float(n) * float(d))


# -- N-D real transforms (numpy.fft.rfftn family) ----------------------------


def _c2c_over_leading(planes, dims, shape, ndim: int, dtype, forward: bool):
    """(planes, dims) after the c2c transform over the `ndim` axes before the
    last one of an array of `shape` (original axis order): FFT forward, IFFT
    (1/their size) inverse."""
    if ndim == 0:
        return planes, dims
    axes = range(len(shape) - 1 - ndim, len(shape) - 1)
    plans = _axis_plans([shape[a] for a in axes], dtype, planes[0].device)
    return _run(planes, dims, axes, plans,
                Transform.FFT if forward else Transform.IFFT)


def _rfftn_planes(x, ndim: Optional[int], dtype, device):
    """((re, im) of the unnormalized rfftn in `x`'s axis order, the
    transformed size, whether `x` came as numpy)."""
    xt, as_numpy = _as_tensor(x, device)
    k = xt.ndim if ndim is None else ndim
    if not 1 <= k <= xt.ndim:
        raise ValueError(f"ndim={k} out of range for rank-{xt.ndim} input")
    plan = _plan_for(xt.shape[-1], dtype, xt)
    xr = (xt.real if xt.is_complex() else xt).to(plan.real_dtype)
    (xr,), dims = _to_front(*_memory_order((xr,)), xt.ndim - 1)
    rest = xr.shape[1:]
    re, im = plan.rfft_planar_bm(xr.reshape(plan.n, -1))
    planes = (re.reshape(plan.out_len, *rest), im.reshape(plan.out_len, *rest))
    planes, dims = _c2c_over_leading(planes, dims, xt.shape, k - 1, plan.dtype,
                                     True)
    total = int(np.prod(xt.shape[xt.ndim - k:], dtype=np.int64))
    return _restore(planes, dims), total, as_numpy


def _irfftn(x, shape, ndim, dtype, device, conj: bool):
    """(the unnormalized irfftn of `x`, or of conj(x), in `x`'s axis order;
    the transformed size; whether `x` came as numpy)."""
    xt, as_numpy = _as_tensor(x, device)
    if shape is not None:
        k, n_last = len(shape), int(shape[-1])
    else:
        k, n_last = (xt.ndim if ndim is None else ndim), 2 * (xt.shape[-1] - 1)
    if not 1 <= k <= xt.ndim:
        raise ValueError(f"ndim={k} out of range for rank-{xt.ndim} input")
    if shape is not None and (tuple(int(s) for s in shape[:-1])
                              != tuple(xt.shape[xt.ndim - k:-1])):
        raise ValueError(
            f"shape {tuple(shape)} inconsistent with input axes "
            f"{tuple(xt.shape[xt.ndim - k:])} (only the last axis may differ)")
    plan = _plan_for(n_last, dtype, xt)
    if xt.shape[-1] != plan.out_len:
        raise ValueError(
            f"spectrum length {xt.shape[-1]} inconsistent with last-axis size "
            f"{n_last} (need {plan.out_len})")
    xc = xt.to(plan.dtype)
    planes, dims = _memory_order((xc.real, -xc.imag if conj else xc.imag))
    planes, dims = _c2c_over_leading(planes, dims, xt.shape, k - 1, plan.dtype,
                                     False)
    (re, im), dims = _to_front(planes, dims, xt.ndim - 1)
    rest = re.shape[1:]
    out = plan.irfft_planar_bm(re.reshape(plan.out_len, -1),
                               im.reshape(plan.out_len, -1))
    (out,) = _restore((out.reshape(n_last, *rest),), dims)
    total = int(np.prod(xt.shape[xt.ndim - k:-1], dtype=np.int64)) * n_last
    return out, total, as_numpy


def rfftn(x, ndim: Optional[int] = None, dtype=None,
          norm: Optional[str] = None, device="cuda"):
    """Real-input N-D FFT over the trailing `ndim` axes (numpy.fft.rfftn):
    one-sided along the last axis, full along the others. A numpy `x` runs
    on ``device`` (numpy out), a tensor on its own device."""
    (re, im), total, as_numpy = _rfftn_planes(x, ndim, dtype, device)
    return _scaled(torch.complex(re, im), _norm_scale(norm, total, True),
                   as_numpy)


def irfftn(x, shape: Optional[Sequence[int]] = None, ndim: Optional[int] = None,
           dtype=None, norm: Optional[str] = None, device="cuda"):
    """Inverse of :func:`rfftn` (numpy.fft.irfftn). ``shape`` gives the output
    sizes of the transformed axes (its length sets ``ndim``); the default last
    axis is the even size 2*(bins-1)."""
    out, total, as_numpy = _irfftn(x, shape, ndim, dtype, device, conj=False)
    return _scaled(out, _norm_scale(norm, total, False), as_numpy)


def rfft2(x, dtype=None, device="cuda"):
    """2-D real-input FFT over the last two axes (numpy.fft.rfft2)."""
    return rfftn(x, 2, dtype, device=device)


def irfft2(x, shape: Optional[Sequence[int]] = None, dtype=None,
           device="cuda"):
    """Inverse of :func:`rfft2` (numpy.fft.irfft2)."""
    if shape is not None and len(shape) != 2:
        raise ValueError("irfft2 shape must have length 2")
    return irfftn(x, shape=shape, ndim=2, dtype=dtype, device=device)


def hfftn(x, shape: Optional[Sequence[int]] = None, ndim: Optional[int] = None,
          norm: Optional[str] = None, dtype=None, device="cuda"):
    """N-D FFT of Hermitian-symmetric input -> real output (scipy.fft.hfftn).

    Direction-swapped irfftn: ``hfftn(a, s) == irfftn(conj(a), s) * prod(s)``
    with the norm applied in the forward direction. ``shape`` gives the real
    output sizes of the transformed axes (its length sets ``ndim``)."""
    out, total, as_numpy = _irfftn(x, shape, ndim, dtype, device, conj=True)
    return _scaled(out, total * _norm_scale(norm, total, True), as_numpy)


def ihfftn(x, ndim: Optional[int] = None, norm: Optional[str] = None,
           dtype=None, device="cuda"):
    """Inverse of :func:`hfftn` (scipy.fft.ihfftn): real input -> one-sided
    Hermitian N-D spectrum, ``conj(rfftn(x)) / prod(transformed sizes)``."""
    (re, im), total, as_numpy = _rfftn_planes(x, ndim, dtype, device)
    return _scaled(torch.complex(re, -im),
                   _norm_scale(norm, total, False) / total, as_numpy)


def hfft2(x, shape: Optional[Sequence[int]] = None, dtype=None, device="cuda"):
    """2-D Hermitian-input FFT over the last two axes (scipy.fft.hfft2)."""
    if shape is not None and len(shape) != 2:
        raise ValueError("hfft2 shape must have length 2")
    return hfftn(x, shape=shape, ndim=2, dtype=dtype, device=device)


def ihfft2(x, dtype=None, device="cuda"):
    """Inverse of :func:`hfft2` (scipy.fft.ihfft2)."""
    return ihfftn(x, ndim=2, dtype=dtype, device=device)
