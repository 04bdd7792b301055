"""Twiddle-factor generation, in float64 numpy at plan time.

Port of ``fourier_tpu/twiddle.py`` (bitwise-equal results). Every twiddle the
port uses, on the CPU or on the card, comes from these f64 values narrowed to
the plan's precision; nothing trigonometric runs on the device.
"""

from __future__ import annotations

import numpy as np


def stage_twiddles(size: int, radix: int, forward: bool) -> np.ndarray:
    """Twiddle table for one Stockham stage, shape (m, radix) with
    m = size//radix. Entry (i, k) = W_size^(i*k); column 0 is all ones."""
    m = size // radix
    i = np.arange(m, dtype=np.float64)[:, None]
    k = np.arange(radix, dtype=np.float64)[None, :]
    theta = 2.0 * np.pi * (i * k) / float(size)
    tw = np.cos(theta) - 1j * np.sin(theta)
    return tw if forward else np.conj(tw)


def half_twiddle(index: np.ndarray, size: int) -> np.ndarray:
    """exp(-i*pi*index/size) elementwise: the Bluestein chirp helper.
    `index` may be a float64 array (i**2 overflows int32 for large sizes)."""
    theta = np.asarray(index, dtype=np.float64) * np.pi / float(size)
    return np.cos(theta) - 1j * np.sin(theta)
