"""FFT convolution, correlation, the analytic signal, resampling, chirp-z.

Port of ``fourier_tpu/signal.py`` (scipy.signal semantics and defaults):
``fftconvolve``, ``oaconvolve``, ``correlate``, ``correlation_lags``,
``next_fast_len``, ``prev_fast_len``, ``hilbert``, ``hilbert2``,
``resample``, ``czt``, ``zoom_fft``, :class:`CztPlan` and
:class:`ConvolvePlan`.

Every transform runs on the port's plans. The convolutions build their
zero-padded operands, or overlap-add blocks, directly as contiguous planes
with the block axes leading, then the batch axes, then the axes that count
the blocks: the batch-minor (n, B) layout of the kernels, so each axis pass
runs the planner's cached 1-D plan (``ndim._axis_plans``) through
``ndim._run`` with one copy an axis at most. The spectral product, the
overlap-add fold and the crop run on the plans' device; nothing goes back
to the host between transforms. The fold (:func:`_fold`) sums
``ceil(block/advance)`` shifted copies: deterministic, no scatter, no
atomics. ``hilbert``, ``resample`` and ``czt`` transform the caller's array
along one axis through the same 1-D entry as ``fft`` (``plan.transform``).

complex128 runs in native f64 on the card (the ``dd`` route), the spectral
product included. The JAX package's double-word twin of
:class:`ConvolvePlan`'s planar call (``convolve_planar_dd``) joins its f32
(hi, lo) planes to f64, runs ``convolve_planar`` and splits the result.

Tables are computed in f64 numpy at plan time and moved to the device once,
cast: the chirp-z chirps and chirp spectrum, ConvolvePlan's kernel spectrum,
the resampling window.

Every entry point runs on the card unless the caller asks for the CPU: a
numpy input is copied to ``device`` ("cuda" by default) once and back once,
a tensor input runs on its own device and gives tensors.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fourier_tpu_torch.ndim import (_as_tensor, _axis_plans, _crop_pad_axis,
                                    _restore, _run, _transform_axes)
from fourier_tpu_torch.plan.base import complex_dtype, resolve_device
from fourier_tpu_torch.plan.planner import create_fft
from fourier_tpu_torch.precision import planes as dd_planes
from fourier_tpu_torch.rfft import _infer_cdtype
from fourier_tpu_torch.transform import Transform


def next_fast_len(n: int) -> int:
    """Smallest m >= n with m = 2^a * 3^b (the fast Stockham family)."""
    n = int(n)
    if n <= 1:
        return 1
    best = 1 << (n - 1).bit_length()  # pure power of two upper bound
    p3 = 1
    while p3 < best:
        # smallest 2^a with p3 * 2^a >= n
        need = -(-n // p3)
        m = p3 * (1 << max(0, (need - 1).bit_length()))
        if n <= m < best:
            best = m
        p3 *= 3
    return best


def prev_fast_len(n: int) -> int:
    """Largest m <= n with m = 2^a * 3^b (scipy.fft.prev_fast_len analog)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    best, p3 = 1, 1
    while p3 <= n:
        best = max(best, p3 << ((n // p3).bit_length() - 1))
        p3 *= 3
    return best


def _norm_axes(ndim: int, axes) -> Tuple[int, ...]:
    if axes is None:
        return tuple(range(ndim))
    if np.isscalar(axes):
        axes = (axes,)
    out = tuple(sorted(int(a) % ndim for a in axes))
    if len(set(out)) != len(out):
        raise ValueError(f"repeated axis in axes={axes}")
    return out


def _out_slice(mode: str, s1: int, s2: int, full: int) -> slice:
    if mode == "full":
        return slice(0, full)
    if mode == "same":
        start = (s2 - 1) // 2
        return slice(start, start + s1)
    if mode == "valid":
        if s1 < s2:
            raise ValueError(
                "valid mode requires in1 to be at least as large as in2 "
                "along every convolved axis"
            )
        return slice(s2 - 1, s1)
    raise ValueError(f"mode must be full/same/valid, got {mode!r}")


def _pair(in1, in2, device):
    """(in1, in2 as tensors on one device, whether both came as numpy): the
    device of the first tensor among them, else ``device``."""
    tensors = [t for t in (in1, in2) if isinstance(t, torch.Tensor)]
    if len({t.device for t in tensors}) > 1:
        raise ValueError(f"in1 on {in1.device} but in2 on {in2.device}")
    dev = tensors[0].device if tensors else resolve_device(device)
    a = in1 if isinstance(in1, torch.Tensor) else torch.as_tensor(np.asarray(in1))
    b = in2 if isinstance(in2, torch.Tensor) else torch.as_tensor(np.asarray(in2))
    return a.to(dev), b.to(dev), not tensors


def _out(t: torch.Tensor, as_numpy: bool):
    return t.detach().cpu().numpy() if as_numpy else t


def _fold(y: torch.Tensor, advance: int) -> torch.Tensor:
    """Overlap-add of the blocks of `y` (block, *mid, n): block i of the
    last axis lands ``i * advance`` samples along the first. Returns
    (*mid, (n + q - 1) * advance), q = ceil(block / advance).

    Chunk view: sample ``j * advance + r`` of block i lands in output chunk
    i + j at r, so the sum is q shifted copies of the blocks' chunks, each
    one strided add; the order of the adds is fixed."""
    blk, n = y.shape[0], y.shape[-1]
    if n == 1:
        return y[..., 0].movedim(0, -1)
    q = -(-blk // advance)
    out = y.new_zeros((advance, *y.shape[1:-1], n + q - 1))
    for j in range(q):
        chunk = y.narrow(0, j * advance, min(advance, blk - j * advance))
        out.narrow(0, 0, chunk.shape[0]).narrow(-1, j, n).add_(chunk)
    return out.movedim(0, -1).flatten(-2)


def _blocked(x: torch.Tensor, conv_axes, steps, fast, rt) -> torch.Tensor:
    """`x` cut into zero-padded blocks, contiguous (*fast, *batch, *nsteps):
    conv axis i in ceil(s_i / steps[i]) steps of steps[i] samples, each
    padded to fast[i]; batch axes in their order."""
    nd = x.ndim
    pad = []
    for ax in reversed(range(nd)):
        extra = 0
        if ax in conv_axes:
            st = steps[conv_axes.index(ax)]
            extra = -(-x.shape[ax] // st) * st - x.shape[ax]
        pad += [0, extra]
    if any(pad):
        x = F.pad(x, pad)
    # each conv axis split into (nstep, step), then the dims ordered
    # (steps..., batch..., nsteps...)
    shape, pos = [], {}
    for ax in range(nd):
        pos[ax] = len(shape)
        if ax in conv_axes:
            st = steps[conv_axes.index(ax)]
            shape += [x.shape[ax] // st, st]
        else:
            shape.append(x.shape[ax])
    x = x.reshape(shape).permute(
        [pos[ax] + 1 for ax in conv_axes]
        + [pos[ax] for ax in range(nd) if ax not in conv_axes]
        + [pos[ax] for ax in conv_axes])
    k = len(conv_axes)
    out = x.new_zeros((*fast, *x.shape[k:]), dtype=rt)
    out[tuple(slice(0, s) for s in x.shape[:k])] = x
    return out


def _convolve(a: torch.Tensor, b: torch.Tensor, conv_axes, steps, mode: str,
              dtype) -> torch.Tensor:
    """Linear convolution of `a` and `b` over `conv_axes` by overlap-add of
    blocks of steps[i] = (step of a, step of b) samples (whole sizes: one
    block, plain FFT convolution), every transform on the planner's cached
    axis plans, the output in `a`'s axis order, cropped to `mode`."""
    dtype = complex_dtype(dtype)
    rt = _real_of(dtype)
    k = len(conv_axes)
    block_full = [s1 + s2 - 1 for s1, s2 in steps]
    fast = [next_fast_len(s) for s in block_full]
    plans = _axis_plans(fast, dtype, a.device)
    axes = range(k)
    nd = a.ndim + k  # the blocked planes' rank

    def spectrum(x, which):
        st = [s[which] for s in steps]
        re = _blocked(x.real if x.is_complex() else x, conv_axes, st, fast, rt)
        im = (_blocked(x.imag, conv_axes, st, fast, rt) if x.is_complex()
              else torch.zeros_like(re))
        return _run((re, im), list(range(nd)), axes, plans, Transform.FFT)

    (ar, ai), dims = spectrum(a, 0)
    (br, bi), _ = spectrum(b, 1)
    # the inverse's 1/prod(fast) rides on b's spectrum
    s = 1.0 / float(np.prod(fast, dtype=np.float64))
    br, bi = br * s, bi * s
    planes, dims = _run((ar * br - ai * bi, ar * bi + ai * br), dims, axes, plans,
                        Transform.UNSCALED_IFFT)
    real_out = not (a.is_complex() or b.is_complex())
    planes = _restore(planes[:1] if real_out else planes, dims)
    out = []
    for y in planes:
        # (*block_full, *batch, *nsteps) -> (*batch, *full), axis by axis
        y = y[tuple(slice(0, s) for s in block_full)]
        for i, ax in enumerate(conv_axes):
            st1, st2 = steps[i]
            advance = st1 if -(-a.shape[ax] // st1) > 1 else st2
            # after i folds: (*blocks i.., *batch, *nsteps i.., *full ..i)
            y = _fold(y.movedim(a.ndim - i, -1), advance)
        out.append(y)
    y = out[0] if real_out else torch.complex(*out)
    batch = [ax for ax in range(a.ndim) if ax not in conv_axes]
    y = y.permute([int(i) for i in np.argsort(batch + list(conv_axes))])
    for ax in conv_axes:
        full = a.shape[ax] + b.shape[ax] - 1
        sl = _out_slice(mode, a.shape[ax], b.shape[ax], full)
        y = y.narrow(ax, sl.start, sl.stop - sl.start)
    return y


def _check_mode(mode: str) -> None:
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"mode must be full/same/valid, got {mode!r}")


def _conv(in1, in2, mode, axes, dtype, device, steps_of):
    """fftconvolve / oaconvolve: the blocks of each convolved axis are
    steps_of(s1, s2) samples of in1 and of in2."""
    a, b, as_numpy = _pair(in1, in2, device)
    if a.ndim != b.ndim:
        raise ValueError("in1 and in2 must have the same rank")
    if a.ndim == 0:
        return _out(a * b, as_numpy)
    conv_axes = list(_norm_axes(a.ndim, axes))
    for ax in range(a.ndim):
        if ax not in conv_axes and a.shape[ax] != b.shape[ax]:
            raise ValueError(
                f"non-convolved axis {ax} differs: {a.shape[ax]} vs "
                f"{b.shape[ax]}"
            )
    _check_mode(mode)
    steps = [steps_of(a.shape[ax], b.shape[ax]) for ax in conv_axes]
    return _out(_convolve(a, b, conv_axes, steps, mode, dtype), as_numpy)


def fftconvolve(in1, in2, mode: str = "full",
                axes: Optional[Sequence[int]] = None,
                dtype=np.complex64, device="cuda"):
    """Convolve two arrays via FFT (scipy.signal.fftconvolve semantics).

    Inputs must have equal rank; convolution runs over ``axes`` (default
    all), other axes must have matching sizes (batch dims). Each convolved
    axis is zero-padded to ``next_fast_len(s1 + s2 - 1)``. Real inputs give
    a real output of the working precision; ``dtype=complex128`` runs the
    f64 path. Numpy inputs run on ``device`` (numpy out); a tensor input
    runs on its own device (tensor out).
    """
    return _conv(in1, in2, mode, axes, dtype, device, lambda s1, s2: (s1, s2))


# -- overlap-add convolution (scipy.signal.oaconvolve) ------------------------


def _oa_lens(s1: int, s2: int) -> Tuple[int, int]:
    """Per-axis overlap-add step sizes (in1_step, in2_step).

    scipy.signal's block-size model (_calc_oa_lens): the optimal FFT block
    for overlap-add with overlap v = min(s1,s2)-1 minimizes
    (block/(block-v))*log2(block), whose stationary point is the Lambert-W
    expression below. Only the larger input is split; the smaller rides whole
    in every block. Returns whole sizes (no split) when splitting cannot win.
    """
    if s1 == s2 or s1 == 1 or s2 == 1:
        return s1, s2
    swapped = s2 > s1
    big, small = (s2, s1) if swapped else (s1, s2)
    overlap = small - 1
    from scipy.special import lambertw

    opt = -overlap * float(np.real(lambertw(-1 / (2 * np.e * overlap), k=-1)))
    block = next_fast_len(int(np.ceil(opt)))
    if block >= big:
        return s1, s2
    big_step = block - small + 1
    return (small, big_step) if swapped else (big_step, small)


def oaconvolve(in1, in2, mode: str = "full",
               axes: Optional[Sequence[int]] = None,
               dtype=np.complex64, device="cuda"):
    """Convolve via overlap-add (scipy.signal.oaconvolve semantics).

    Same contract and output as :func:`fftconvolve`; wins when the convolved
    sizes are very unequal (long signal, short kernel): the long axis is cut
    into blocks that become batch columns of the block-size plans.
    """
    return _conv(in1, in2, mode, axes, dtype, device, _oa_lens)


# -- analytic signal / FFT resampling / correlation ---------------------------


def _default_cdtype(t: torch.Tensor, dtype) -> torch.dtype:
    """`dtype`, or the reference's promotion: float64 or complex128 input
    runs complex128, any other complex64."""
    return _infer_cdtype(t) if dtype is None else complex_dtype(dtype)


def _real_of(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.complex64 else torch.float64


def hilbert(x, n: Optional[int] = None, dtype=None, device="cuda"):
    """Analytic signal via the FFT (scipy.signal.hilbert, axis=-1).

    Zeroes negative frequencies and doubles positive ones: the imaginary
    part of the result is the Hilbert transform of ``x`` (which must be
    real). Runs one forward and one inverse batched c2c transform.
    """
    xt, as_numpy = _as_tensor(x, device)
    if xt.is_complex():
        raise ValueError("x must be real")
    n = xt.shape[-1] if n is None else int(n)
    if n <= 0:
        raise ValueError("n must be positive")
    xt = _crop_pad_axis(xt, n, xt.ndim - 1)
    dtype = _default_cdtype(xt, dtype)
    h = np.zeros(n, np.float64)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
    plan = create_fft(n, dtype, device=xt.device)
    spec = plan.transform(xt, Transform.FFT) * torch.as_tensor(
        h, device=xt.device).to(_real_of(dtype))
    return _out(plan.transform(spec, Transform.IFFT), as_numpy)


def hilbert2(x, n: Optional[Sequence[int]] = None,
             axes: Tuple[int, int] = (-2, -1), dtype=None, device="cuda"):
    """2-D analytic signal: scipy.signal.hilbert2's "single-orthant"
    transform. Per axis, bins [1, (N+1)//2) are doubled and bins from
    (N+1)//2 on (including an even-N Nyquist) are zeroed."""
    xt, as_numpy = _as_tensor(x, device)
    while xt.ndim < 2:
        xt = xt.unsqueeze(0)
    if xt.is_complex():
        raise ValueError("x must be real")
    if len(axes) != 2 or (axes[0] % xt.ndim) == (axes[1] % xt.ndim):
        raise ValueError("axes must be two distinct axes")
    xt = torch.movedim(xt, tuple(axes), (-2, -1))
    if n is not None:
        if np.isscalar(n):
            n = (int(n), int(n))
        if len(n) != 2 or min(int(n[0]), int(n[1])) <= 0:
            raise ValueError("n must be two positive ints")
        xt = _crop_pad_axis(xt, int(n[0]), xt.ndim - 2)
        xt = _crop_pad_axis(xt, int(n[1]), xt.ndim - 1)
    shape = tuple(xt.shape[-2:])
    dtype = _default_cdtype(xt, dtype)

    def _h1(m: int) -> np.ndarray:
        h = np.zeros(m, np.float64)
        h[0] = 1.0
        h[1:(m + 1) // 2] = 2.0
        return h

    h0, h1 = (torch.as_tensor(_h1(m), device=xt.device).to(_real_of(dtype))
              for m in shape)
    axes2 = (xt.ndim - 2, xt.ndim - 1)
    plans = _axis_plans(shape, dtype, xt.device)
    spec = _transform_axes(xt, axes2, plans, Transform.FFT) * torch.outer(h0, h1)
    out = _transform_axes(spec, axes2, plans, Transform.IFFT)
    return _out(torch.movedim(out, (-2, -1), tuple(axes)), as_numpy)


def resample(x, num: int, t=None, axis: int = -1, window=None,
             domain: str = "time", dtype=None, device="cuda"):
    """Fourier-domain resampling to ``num`` samples (scipy.signal.resample;
    NOTE the repo-wide default ``axis=-1``, scipy defaults to 0): transform,
    crop/zero-pad the spectrum with scipy's exact unpaired-Nyquist-bin
    bookkeeping, inverse-transform at the new length."""
    xt, as_numpy = _as_tensor(x, device)
    num = int(num)
    if num <= 0:
        raise ValueError("num must be positive")
    if domain not in ("time", "freq"):
        raise ValueError(f"domain must be 'time' or 'freq', got {domain!r}")
    xt = torch.movedim(xt, axis, -1)
    n = xt.shape[-1]
    complex_in = xt.is_complex()
    dtype = _default_cdtype(xt, dtype)
    dev = xt.device

    if domain == "time":
        spec = create_fft(n, dtype, device=dev).transform(xt, Transform.FFT)
    else:
        spec = xt.to(dtype)
    if window is not None:
        if callable(window):
            w = np.asarray(window(np.fft.fftfreq(n)), np.float64)
        elif hasattr(window, "shape"):
            w = (window.detach().cpu().numpy() if isinstance(window, torch.Tensor)
                 else np.asarray(window)).astype(np.float64)
            if w.shape != (n,):
                raise ValueError(
                    f"window length {w.shape} != number of bins ({n},)"
                )
        else:
            from scipy.signal import get_window

            w = np.fft.fftshift(np.asarray(get_window(window, n), np.float64))
        spec = spec * torch.as_tensor(w, device=dev).to(_real_of(dtype))

    # scipy's spectrum crop/pad: m relevant bins, m2 = one-sided count
    # (includes the unpaired Nyquist bin of the SMALLER grid).
    m = min(n, num)
    m2 = m // 2 + 1
    newspec = spec.new_zeros(spec.shape[:-1] + (num,))
    newspec[..., :m2] = spec[..., :m2]
    if m2 < m:
        newspec[..., m2 - m:] = spec[..., m2 - m:]
    if m % 2 == 0:
        if num < n:
            # down: fold the old negative twin into the unpaired bin
            newspec[..., -m // 2] += spec[..., n - m // 2]
        elif n < num:
            # up: split the unpaired bin into a +/- pair
            newspec[..., m // 2] *= 0.5
            newspec[..., num - m // 2] = newspec[..., m // 2]

    y = create_fft(num, dtype, device=dev).transform(newspec, Transform.IFFT)
    y = y * (float(num) / float(n))
    if not complex_in and domain == "time":
        y = y.real
    y = _out(torch.movedim(y, -1, axis), as_numpy)
    if t is None:
        return y
    t0, t1 = float(t[0]), float(t[1])
    return y, np.arange(num) * (t1 - t0) * n / float(num) + t0


def correlate(in1, in2, mode: str = "full",
              axes: Optional[Sequence[int]] = None,
              dtype=np.complex64, device="cuda"):
    """Cross-correlation via FFT (scipy.signal.correlate(method='fft')):
    ``corr(a, b) = conv(a, conj(reversed(b)))`` over ``axes``."""
    a, b, as_numpy = _pair(in1, in2, device)
    b = torch.flip(b, _norm_axes(b.ndim, axes)) if b.ndim else b
    if b.is_complex():
        b = b.conj().resolve_conj()
    return _out(fftconvolve(a, b, mode, axes, dtype), as_numpy)


def correlation_lags(in1_len: int, in2_len: int,
                     mode: str = "full") -> np.ndarray:
    """Lag indices for :func:`correlate` (scipy.signal.correlation_lags)."""
    in1_len, in2_len = int(in1_len), int(in2_len)
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        start = mid - in1_len // 2
        return lags[start:start + in1_len]
    if mode == "valid":
        lag_max = max(in1_len, in2_len) - min(in1_len, in2_len)
        return np.arange(lag_max + 1) - (in2_len - min(in1_len, in2_len))
    raise ValueError(f"mode must be full/same/valid, got {mode!r}")


# -- chirp z-transform (scipy.signal.czt / zoom_fft) -------------------------
#
# X_k = sum_n x_n (a w^-k)^-n = w^{k^2/2} * conv(x_n a^-n w^{n^2/2},
# w^{-j^2/2})_k: the Bluestein factorization generalized to arbitrary
# (m, w, a). The convolution runs at next_fast_len(n+m-1) through a plan of
# the planner; all chirp tables are f64 numpy at plan time. For the default
# w (the zoom DFT w = exp(-2i*pi/m)) the quadratic phase is reduced mod 2m
# in exact integer arithmetic before the f64 trig, so table accuracy does
# not degrade as j^2 grows.


def _czt_halfpow(w, q, m: int):
    """w^{q/2} for an integer index array q (values j^2), f64 complex.

    w=None means the default zoom chirp exp(-2i*pi/m): exact integer
    reduction q mod 2m keeps the phase argument small. Arbitrary w goes
    through f64 phase/magnitude (scipy-equivalent accuracy).
    """
    if w is None:
        red = np.array([int(t) % (2 * m) for t in q], dtype=np.float64)
        return np.exp(-1j * np.pi * red / m)
    w = complex(w)
    qf = np.asarray(q, dtype=np.float64)
    out = np.exp(1j * (np.angle(w) * qf / 2.0)).astype(np.complex128)
    mag = abs(w)
    if mag != 1.0:
        out = out * np.power(mag, qf / 2.0)
    return out


class CztPlan(torch.nn.Module):
    """Chirp z-transform plan: X_k = sum_n x_n (a * w^-k)^-n, k = 0..m-1.

    scipy.signal.CZT analog: the Bluestein plan's three pointwise passes
    around a fast-size convolution, for any output count ``m``, ratio ``w``
    (default exp(-2i*pi/m), the DFT/zoom chirp) and starting point ``a``.
    The chirps and the chirp spectrum are buffers (f64 at plan time, cast
    to ``dtype``), the inner plan is the plan's own, so ``.to()`` moves it
    all.
    """

    def __init__(self, n: int, m: Optional[int] = None, w=None, a=1 + 0j,
                 dtype=torch.complex64, device="cuda"):
        super().__init__()
        self.n = int(n)
        self.m = self.n if m is None else int(m)
        if self.n < 1 or self.m < 1:
            raise ValueError(f"czt needs n >= 1 and m >= 1, got {n}, {m}")
        self.w = None if w is None else complex(w)
        self.a = complex(a)
        self.dtype = complex_dtype(dtype)
        device = resolve_device(device)
        n_, m_ = self.n, self.m
        L = next_fast_len(n_ + m_ - 1)
        self.inner_size = L
        self.inner = create_fft(L, self.dtype, device=device, cache=False)
        j = np.arange(max(n_, m_), dtype=np.int64)
        q = (j * j).astype(object)  # exact integer squares
        half = _czt_halfpow(self.w, q, m_)  # w^{j^2/2}
        # w^{-j^2/2}: conj only on the unit circle; for |w| != 1 the
        # reciprocal magnitude matters (conj would flip phase only).
        if self.w is None or abs(abs(self.w) - 1.0) < 1e-15:
            half_neg = np.conj(half)
        else:
            half_neg = 1.0 / half
        apow = np.power(self.a, -j[:n_].astype(np.float64))
        v = np.zeros(L, dtype=np.complex128)
        v[:m_] = half_neg[:m_]                                    # w^{-j^2/2}
        if n_ > 1:
            v[L - (n_ - 1):] = half_neg[1:n_][::-1]               # mirror tail
        tables = {"u_chirp": half[:n_] * apow,   # a^-n w^{n^2/2}
                  "y_chirp": half[:m_],          # w^{k^2/2}
                  "V": np.fft.fft(v)}            # the chirp spectrum, f64
        for name, t in tables.items():
            self.register_buffer(
                name, torch.as_tensor(t.astype(np.complex128), device=device).to(
                    self.dtype))

    @property
    def device(self) -> torch.device:
        return self.V.device

    def forward(self, x, *, axis: int = -1):
        """The chirp z-transform of `x` along `axis`: a numpy array (run on
        the plan's device, numpy out) or a tensor on the plan's device."""
        as_numpy = not isinstance(x, torch.Tensor)
        xt = torch.as_tensor(np.asarray(x), device=self.device) if as_numpy else x
        xt = torch.movedim(xt, axis, -1).to(self.dtype)
        if xt.shape[-1] != self.n:
            raise ValueError(f"axis length {xt.shape[-1]} != plan n {self.n}")
        u = F.pad(xt * self.u_chirp, (0, self.inner_size - self.n))
        conv = self.inner.transform(self.inner.transform(u, Transform.FFT) * self.V,
                                    Transform.IFFT)
        out = conv[..., :self.m] * self.y_chirp
        return _out(torch.movedim(out, -1, axis), as_numpy)

    def extra_repr(self) -> str:
        return (f"n={self.n}, m={self.m}, w={self.w}, a={self.a}, "
                f"inner={self.inner_size}, dtype={self.dtype}")


_CZT_CACHE: "OrderedDict[tuple, CztPlan]" = OrderedDict()
_CZT_CACHE_MAX = 64


def czt(x, m: Optional[int] = None, w=None, a=1 + 0j, *, axis: int = -1,
        device="cuda"):
    """Chirp z-transform (scipy.signal.czt semantics).

    X_k = sum_n x_n z_k^-n over z_k = a * w^-k; default w = exp(-2i*pi/m)
    makes czt(x) == fft(x). float64/complex128 input runs complex128, any
    other complex64. Plans are cached per (n, m, w, a, dtype, device).
    """
    xt, as_numpy = _as_tensor(x, device)
    n = xt.shape[axis]
    m_ = n if m is None else int(m)
    dtype = _default_cdtype(xt, None)
    key = (n, m_, None if w is None else complex(w), complex(a), str(dtype),
           str(xt.device))
    if key in _CZT_CACHE:
        _CZT_CACHE.move_to_end(key)
        plan = _CZT_CACHE[key]
    else:
        plan = CztPlan(n, m_, w, a, dtype, device=xt.device)
        _CZT_CACHE[key] = plan
        while len(_CZT_CACHE) > _CZT_CACHE_MAX:
            _CZT_CACHE.popitem(last=False)
    return _out(plan(xt, axis=axis), as_numpy)


def zoom_fft(x, fn, m: Optional[int] = None, *, fs=2, endpoint: bool = False,
             axis: int = -1, device="cuda"):
    """Zoomed DFT over the band ``fn = [f1, f2]`` (scipy.signal.zoom_fft).

    Evaluates the z-transform on ``m`` points of the unit-circle arc from
    f1 to f2 (sample rate ``fs``); a pure-frequency czt with
    a = exp(2i*pi*f1/fs), w = exp(-2i*pi*(f2-f1)/((m - endpoint)*fs)).
    """
    n = x.shape[axis] if isinstance(x, torch.Tensor) else np.shape(x)[axis]
    m_ = n if m is None else int(m)
    if np.isscalar(fn):
        f1, f2 = 0.0, float(fn)
    else:
        f1, f2 = (float(v) for v in fn)
    fs = float(fs)
    k = (m_ - 1) if endpoint else m_
    if k < 1:
        raise ValueError("zoom_fft needs m >= 2 with endpoint=True")
    w = np.exp(-2j * np.pi * (f2 - f1) / (k * fs))
    a = np.exp(2j * np.pi * f1 / fs)
    return czt(x, m_, w, a, axis=axis, device=device)


# -- device-resident overlap-add convolution plan ------------------------------


class ConvolvePlan(torch.nn.Module):
    """1-D FFT convolution with a fixed kernel (the plan form of
    :func:`oaconvolve`), resident on its device.

    The kernel's block spectrum is a buffer (exact f64 at plan time, cast),
    the inner plan of the block size is the plan's own: ``.to()`` moves
    both. ``convolve_planar`` frames the signal into step-sized blocks laid
    out batch-minor (block, *batch, n_blocks), runs the block plan's
    ``transform_planar_bm`` forward, the spectral product and the inverse on
    them, and folds the blocks back (:func:`_fold`); it is differentiable
    through the plan's linear rule. complex128 runs the same calls on f64
    planes on the ``dd`` route; the JAX package's 4-plane double-word twin,
    ``convolve_planar_dd``, joins its f32 (hi, lo) planes to f64, runs
    ``convolve_planar`` and splits the result (``precision/planes.py``), and
    ``dd`` is False (the port's c128 is native f64).
    """

    def __init__(self, kernel, mode: str = "full", dtype=torch.complex64,
                 block: Optional[int] = None, device="cuda"):
        super().__init__()
        kernel = (kernel.detach().cpu().numpy() if isinstance(kernel, torch.Tensor)
                  else np.asarray(kernel))
        if kernel.ndim != 1:
            raise ValueError("ConvolvePlan takes a 1-D kernel")
        _check_mode(mode)
        self.mode = mode
        self.dtype = complex_dtype(dtype)
        self.kernel_len = int(kernel.shape[0])
        self.kernel_is_real = not np.iscomplexobj(kernel)
        if block is None:
            # _oa_lens' Lambert-W optimum depends only on the overlap
            # (kernel_len - 1); probe with a huge signal to get the
            # unconditional block choice.
            L = self.kernel_len
            if L <= 1:
                block = max(L, 1)
            else:
                s1_step, _ = _oa_lens(1 << 60, L)
                block = (
                    next_fast_len(s1_step + L - 1)
                    if s1_step < (1 << 60) else next_fast_len(2 * L)
                )
        self.block = int(block)
        if self.block < self.kernel_len:
            raise ValueError(
                f"block {self.block} < kernel length {self.kernel_len}"
            )
        self.step = self.block - self.kernel_len + 1
        device = resolve_device(device)
        c128 = self.dtype == torch.complex128
        self.inner = create_fft(self.block, self.dtype,
                                backend="dd" if c128 else "auto", device=device,
                                cache=False)
        # Kernel block spectrum, computed exactly in f64 numpy at plan time.
        kf = np.fft.fft(
            np.pad(kernel.astype(np.complex128), (0, self.block - len(kernel)))
        )
        rt = _real_of(self.dtype)
        for name, part in (("k_re", kf.real), ("k_im", kf.imag)):
            self.register_buffer(name, torch.as_tensor(part, device=device).to(rt))

    @property
    def device(self) -> torch.device:
        return self.k_re.device

    @property
    def real_dtype(self) -> torch.dtype:
        return _real_of(self.dtype)

    @property
    def dd(self) -> bool:
        """False: the port's complex128 is two f64 planes, not the JAX
        package's double-word f32 pairs."""
        return False

    # -- geometry ---------------------------------------------------------------

    def n_blocks(self, s1: int) -> int:
        return -(-int(s1) // self.step)

    def out_len(self, s1: int) -> int:
        sl = self._mode_slice(int(s1))
        return sl.stop - sl.start

    def _mode_slice(self, s1: int) -> slice:
        full = s1 + self.kernel_len - 1
        return _out_slice(self.mode, s1, self.kernel_len, full)

    # -- execution ---------------------------------------------------------------

    def _plane(self, p) -> torch.Tensor:
        if not isinstance(p, torch.Tensor):
            p = torch.as_tensor(np.asarray(p), device=self.device)
        return p.to(self.real_dtype)

    def _frames(self, p: torch.Tensor) -> torch.Tensor:
        """(..., s1) -> batch-minor (block, prod(...) * n_blocks) blocks:
        step-sized cuts, zero-padded to the block."""
        s1 = p.shape[-1]
        k = self.n_blocks(s1)
        cuts = F.pad(p, (0, k * self.step - s1)).unflatten(-1, (k, self.step))
        out = p.new_zeros((self.block, *p.shape[:-1], k))
        out[:self.step] = cuts.movedim(-1, 0)
        return out.reshape(self.block, -1)

    def _fold(self, y: torch.Tensor, lead, s1: int) -> torch.Tensor:
        """Overlap-add (block, prod(lead) * n_blocks) -> (*lead, out_len)."""
        y = _fold(y.reshape(self.block, *lead, self.n_blocks(s1)), self.step)
        sl = self._mode_slice(s1)
        return y.narrow(-1, sl.start, sl.stop - sl.start)

    def convolve_planar(self, re, im=None):
        """Planar convolution: (..., s1) plane(s) -> (..., out_len) planes
        of the plan's real dtype. With ``im=None`` the imaginary plane is
        zero (real input) and, for a real kernel, only the real output plane
        is returned."""
        re = self._plane(re)
        real_in = im is None
        s1, lead = re.shape[-1], re.shape[:-1]
        fre = self._frames(re)
        fim = torch.zeros_like(fre) if real_in else self._frames(self._plane(im))
        zr, zi = self.inner.transform_planar_bm(fre, fim, Transform.FFT)
        kr, ki = self.k_re[:, None], self.k_im[:, None]
        yr, yi = self.inner.transform_planar_bm(zr * kr - zi * ki, zr * ki + zi * kr,
                                                Transform.IFFT)
        if real_in and self.kernel_is_real:
            return self._fold(yr, lead, s1)
        return self._fold(yr, lead, s1), self._fold(yi, lead, s1)

    def convolve_planar_dd(self, rh, rl, ih=None, il=None):
        """dd twin of :meth:`convolve_planar` on f32 (hi, lo) planes
        (..., s1): the real input's pair (``rl`` None: zero), and with
        ``ih`` the imaginary input's (``il`` None: zero). Returns the
        (hi, lo) pair of the real output for real input and a real kernel,
        else four planes. complex128 plans only."""
        if self.dtype != torch.complex128:
            raise TypeError("c64 plan: use convolve_planar")
        zeros = lambda p: (torch.zeros_like(p) if isinstance(p, torch.Tensor)
                           else np.zeros_like(p))
        dd = [rh, zeros(rh) if rl is None else rl]
        if ih is not None:
            dd += [ih, zeros(ih) if il is None else il]
        return dd_planes.run(self.convolve_planar, dd, self.dtype, "convolve_planar",
                          device=self.device)

    def convolve(self, x):
        """The convolution of `x` (..., s1): a numpy array (numpy out) or a
        tensor on the plan's device (tensor out); real for real `x` and a
        real kernel."""
        as_numpy = not isinstance(x, torch.Tensor)
        xt = torch.as_tensor(np.asarray(x), device=self.device) if as_numpy else x
        if xt.is_complex():
            out = torch.complex(*self.convolve_planar(xt.real, xt.imag))
        else:
            out = self.convolve_planar(xt)
            if isinstance(out, tuple):
                out = torch.complex(*out)
        return _out(out, as_numpy)

    def forward(self, x):
        return self.convolve(x)

    def extra_repr(self) -> str:
        return (f"kernel_len={self.kernel_len}, block={self.block}, "
                f"step={self.step}, mode={self.mode!r}, dtype={self.dtype}")
