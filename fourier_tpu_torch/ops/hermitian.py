"""The Hermitian steps of the real transforms, on planar (re, im) tensors.

Even n (``pack`` / ``unpack``): the length-n real signal is the length-m
complex z[j] = x[2j] + i*x[2j+1], and with Z = FFT_m(z) and W = exp(-2*pi*i/n)

  E[k] = (Z[k] + conj(Z[m-k]))/2,   O[k] = -i*(Z[k] - conj(Z[m-k]))/2
  X[k] = E[k] + W^k * O[k]  (k = 0..m-1),   X[m] = E[0] - O[0]

Odd n (``separate`` / ``recombine``): two real signals x1, x2 share one
transform Z = FFT_n(x1 + i*x2), with X1 = (Z + conj(Z_rev))/2 and
X2 = -i*(Z - conj(Z_rev))/2 over the L = (n+1)/2 one-sided bins.

Every function works along the axis `dim` of any-rank planes; a twiddle
pair `w` broadcasts along it. :class:`fourier_tpu_torch.rfft.RfftPlan` runs
them around its inner plan, and the plain versions of kernels B4 and B5 run
them around B1's and B2's plain stages.
"""

from __future__ import annotations

import torch

from fourier_tpu_torch.ops import cplx


def mirror(t, dim: int):
    """Index (len - k) mod len along `dim`, k = 0..len-1: index 0, then the
    rest reversed (the Hermitian partner of each bin)."""
    rest = t.narrow(dim, 1, t.shape[dim] - 1).flip(dim)
    return torch.cat([t.narrow(dim, 0, 1), rest], dim=dim)


def zero_bins(im, dim: int, last: bool):
    """A copy of `im` with index 0 (and the last index) along `dim` zeroed:
    numpy's irfft ignores the imaginary DC and Nyquist parts."""
    im = im.clone()
    im.narrow(dim, 0, 1).zero_()
    if last:
        im.narrow(dim, im.shape[dim] - 1, 1).zero_()
    return im


def pack(zr, zi, w, dim: int):
    """The m+1 one-sided bins X from the m-point spectrum Z (even n)."""
    cr, ci = mirror(zr, dim), -mirror(zi, dim)
    er, ei = 0.5 * (zr + cr), 0.5 * (zi + ci)
    o_r, o_i = 0.5 * (zi - ci), -0.5 * (zr - cr)
    xr, xi = cplx.mul((o_r, o_i), w)
    first = lambda t: t.narrow(dim, 0, 1)
    return (torch.cat([er + xr, first(er) - first(o_r)], dim=dim),
            torch.cat([ei + xi, first(ei) - first(o_i)], dim=dim))


def unpack(re, im, w, dim: int, half: float = 0.5):
    """Z[k], k = 0..m-1, from the m+1 one-sided bins (even n), scaled by
    2*half: 0.5 leaves the inverse transform's 1/m to the caller, 0.5/m
    folds it in. The imaginary DC and Nyquist parts are read as 0."""
    m = re.shape[dim] - 1
    im = zero_bins(im, dim, last=True)
    xr, xi = re.narrow(dim, 0, m), im.narrow(dim, 0, m)
    cr = re.narrow(dim, 1, m).flip(dim)  # X[m-k]
    ci = -im.narrow(dim, 1, m).flip(dim)
    er, ei = half * (xr + cr), half * (xi + ci)
    wor, woi = half * (xr - cr), half * (xi - ci)
    o_r, o_i = cplx.mul((wor, woi), (w[0], -w[1]))
    return er - o_i, ei + o_r


def separate(zr, zi, length: int, dim: int):
    """The one-sided spectra X1, X2 (`length` bins each) of
    Z = FFT(x1 + i*x2) along `dim` (odd n)."""
    zsr = mirror(zr, dim).narrow(dim, 0, length)
    zsi = mirror(zi, dim).narrow(dim, 0, length)
    hr, hi = zr.narrow(dim, 0, length), zi.narrow(dim, 0, length)
    return ((0.5 * (hr + zsr), 0.5 * (hi - zsi)),
            (0.5 * (hi + zsi), -0.5 * (hr - zsr)))


def recombine(x1, x2, dim: int):
    """Z = X1 + i*X2 over bins 0..L-1, Hermitian above (odd n). The caller
    zeroes the imaginary DC parts (:func:`zero_bins`)."""
    (x1r, x1i), (x2r, x2i) = x1, x2
    rev = lambda t: t.narrow(dim, 1, t.shape[dim] - 1).flip(dim)
    return (torch.cat([x1r - x2i, rev(x1r) + rev(x2i)], dim=dim),
            torch.cat([x1i + x2r, rev(x2r) - rev(x1i)], dim=dim))
