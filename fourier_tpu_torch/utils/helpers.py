"""Spectral helper functions: fftshift / ifftshift / fftfreq.

Port of ``fourier_tpu/utils/helpers.py``: the numpy.fft conveniences. The
shifts are ``torch.roll``: a tensor stays a tensor on its own device, a
numpy array (or anything ``np.asarray`` takes) gives numpy. ``fftfreq`` is
f64 numpy, like :func:`fourier_tpu_torch.rfft.rfftfreq`.
"""

from __future__ import annotations

import numpy as np
import torch


def _roll(x, axes, sign: int):
    as_numpy = not isinstance(x, torch.Tensor)
    xt = torch.as_tensor(np.asarray(x)) if as_numpy else x
    if axes is None:
        axes = tuple(range(xt.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    out = torch.roll(xt, [sign * (xt.shape[a] // 2) for a in axes], list(axes))
    return out.numpy() if as_numpy else out


def fftshift(x, axes=None):
    """Shift the zero-frequency component to the center of the spectrum."""
    return _roll(x, axes, 1)


def ifftshift(x, axes=None):
    """Inverse of :func:`fftshift`."""
    return _roll(x, axes, -1)


def fftfreq(n: int, d: float = 1.0) -> np.ndarray:
    """Sample frequencies for an n-point transform with sample spacing d."""
    results = np.empty(n, dtype=np.float64)
    half = (n - 1) // 2 + 1
    results[:half] = np.arange(0, half)
    results[half:] = np.arange(-(n // 2), 0)
    return results / (n * d)
