"""Naive O(N^2) DFT oracle in float64 numpy (port of
``fourier_tpu/utils/reference_dft.py``).

It builds the full (n, n) matrix, so it is unusable above n of about 4096:
gate larger sizes against ``np.fft``.
"""

from __future__ import annotations

import numpy as np

from fourier_tpu_torch.transform import Transform


def naive_dft(x: np.ndarray, forward: bool) -> np.ndarray:
    """Unscaled naive DFT over the last axis, computed in complex128."""
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    j = np.arange(n)
    sign = -2j if forward else 2j
    w = np.exp(sign * np.pi * np.outer(j, j) / n)  # (n, n)
    return x @ w


def oracle_transform(x: np.ndarray, mode: Transform) -> np.ndarray:
    """Naive-DFT equivalent of any of the five transform modes."""
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    y = naive_dft(x, mode.is_forward)
    scale = mode.scale(n)
    return y if scale is None else y * scale
