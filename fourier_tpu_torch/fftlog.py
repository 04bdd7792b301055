"""Fast Hankel transform (FFTLog): ``fht`` / ``ifht`` / ``fhtoffset``.

Port of ``fourier_tpu/fftlog.py``: the discrete Hankel transform

    A(k) = int_0^inf a(r) J_mu(kr) k dr

of a log-uniformly sampled periodic sequence, via Hamilton's FFTLog
algorithm (A. J. S. Hamilton 2000, MNRAS 312, 257): in log space the Hankel
transform is a convolution, so it reduces to one real FFT, a pointwise
multiply by the analytically known coefficients

    u_m = (k_c r_c)^{-2iy} 2^{q+2iy} Gamma(x+ + iy) / Gamma(x- - iy),
    x+- = (mu+1+-q)/2,  y = pi m/(n dln),

and one inverse real FFT. Conventions (argument names, bias/offset
semantics, output flip) follow scipy.fft.fht.

The coefficient table is f64 numpy on the host (loggamma from
scipy.special), computed per call as the reference does; the two real FFTs
run on ``device`` through the complex128 ``RfftPlan``'s batch-minor calls
(on a CUDA device the unfused f64 pack around the ``dd`` route's inner
plan, kernel B6 at n/2 for the even n of its domain). A numpy input runs on
``device`` ("cuda" by default) and comes back as numpy; a tensor runs on
its own device. Input is float64, as scipy's.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from fourier_tpu_torch.ndim import (_as_tensor, _memory_order, _restore,
                                    _to_front)
from fourier_tpu_torch.rfft import _rfft_plan

_LN2 = float(np.log(2.0))


def fhtcoeff(n: int, dln: float, mu: float, offset: float = 0.0,
             bias: float = 0.0, inverse: bool = False) -> np.ndarray:
    """FFTLog coefficient table u_m, m = 0..n//2 (f64 numpy)."""
    from scipy.special import loggamma, poch

    q, lnkr = float(bias), float(offset)
    xp = (mu + 1.0 + q) / 2.0
    xm = (mu + 1.0 - q) / 2.0
    y = np.pi * np.arange(n // 2 + 1, dtype=np.float64) / (n * dln)
    # log u_m = q ln2 + lnGamma(x+ + iy) - conj(lnGamma(x- + iy)) + 2iy(ln2 - lnkr)
    lg = (q * _LN2 + loggamma(xp + 1j * y) - np.conj(loggamma(xm + 1j * y))
          + 2j * y * (_LN2 - lnkr))
    with np.errstate(over="ignore", invalid="ignore"):
        u = np.exp(lg)
    if n % 2 == 0:
        u.imag[-1] = 0.0  # Nyquist coefficient must be real
    if not np.isfinite(u[0]):
        # u_0 = 2^q Gamma(x+)/Gamma(x-) = 2^q poch(x-, x+ - x-); poch resolves
        # the negative-integer-pole cases to the correct limit (0 or inf)
        u[0] = 2.0 ** q * poch(xm, xp - xm)
    if np.isinf(u[0]) and not inverse:
        warnings.warn("singular transform; consider changing the bias",
                      stacklevel=3)
        u = u.copy()
        u[0] = 0.0
    elif u[0] == 0 and inverse:
        warnings.warn("singular inverse transform; consider changing the "
                      "bias", stacklevel=3)
        u = u.copy()
        u[0] = np.inf
    return u


def fhtoffset(dln: float, mu: float, initial: float = 0.0,
              bias: float = 0.0) -> float:
    """Offset nearest ``initial`` satisfying Hamilton's low-ringing
    condition (u_{n/2} real at the Nyquist frequency)."""
    from scipy.special import loggamma

    q, lnkr = float(bias), float(initial)
    xp = (mu + 1.0 + q) / 2.0
    xm = (mu + 1.0 - q) / 2.0
    y = np.pi / (2.0 * dln)
    arg = ((_LN2 - lnkr) / dln
           + (loggamma(xp + 1j * y).imag + loggamma(xm + 1j * y).imag)
           / np.pi)
    return lnkr + (arg - np.round(arg)) * dln


def _bias_exp(n: int, dln: float, bias: float, offset: float = 0.0):
    j = np.arange(n, dtype=np.float64)
    j_c = (n - 1) / 2.0
    return np.exp(-bias * ((j - j_c) * dln + offset))


def _on(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, device=like.device)


def _core(a: torch.Tensor, u: np.ndarray, inverse: bool) -> torch.Tensor:
    """irfft(rfft(a) * u) (or / conj(u) inverse) along the last axis of f64
    `a`, reversed; on the batch-minor layout."""
    n = a.shape[-1]
    plan = _rfft_plan(n, torch.complex128, a.device)
    (x,), dims = _to_front(*_memory_order((a,)), a.ndim - 1)
    rest = x.shape[1:]
    re, im = plan.rfft_planar_bm(x.reshape(n, -1))
    with np.errstate(divide="ignore", invalid="ignore"):
        w = 1.0 / np.conj(u) if inverse else u
    wr, wi = _on(w.real[:, None], a), _on(w.imag[:, None], a)
    out = plan.irfft_planar_bm((re * wr - im * wi).contiguous(),
                               (re * wi + im * wr).contiguous())
    (out,) = _restore((out.flip(0).reshape(n, *rest),), dims)
    return out


def _f64(a, device):
    at, as_numpy = _as_tensor(a, device)
    return at.to(torch.float64), as_numpy


def fht(a, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0,
        device="cuda"):
    """Fast Hankel transform of a log-uniform sequence (scipy.fft.fht)."""
    at, as_numpy = _f64(a, device)
    n = at.shape[-1]
    if bias != 0.0:
        at = at * _on(_bias_exp(n, dln, bias), at)
    out = _core(at, fhtcoeff(n, dln, mu, offset, bias), inverse=False)
    if bias != 0.0:
        out = out * _on(_bias_exp(n, dln, bias, offset), at)
    return out.detach().cpu().numpy() if as_numpy else out


def ifht(A, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0,
         device="cuda"):
    """Inverse fast Hankel transform (scipy.fft.ifht)."""
    At, as_numpy = _f64(A, device)
    n = At.shape[-1]
    if bias != 0.0:
        At = At / _on(_bias_exp(n, dln, bias, offset), At)
    out = _core(At, fhtcoeff(n, dln, mu, offset, bias, inverse=True),
                inverse=True)
    if bias != 0.0:
        out = out / _on(_bias_exp(n, dln, bias), At)
    return out.detach().cpu().numpy() if as_numpy else out
