"""Transform modes for forward/inverse FFTs and their normalization semantics.

Port of ``fourier_tpu/transform.py``: five modes with the C ABI codes 0-4,
``is_forward`` selecting the twiddle conjugation direction, ``inverse()``
(``None`` for ``UNSCALED_IFFT``) and ``scale(n)``.
"""

from __future__ import annotations

import enum
from typing import Optional


class Transform(enum.IntEnum):
    """A transform direction + normalization mode.

    =================  =========  ==============
    mode               direction  output scaling
    =================  =========  ==============
    FFT                forward    1
    IFFT               inverse    1/N
    UNSCALED_IFFT      inverse    1
    SQRT_SCALED_FFT    forward    1/sqrt(N)
    SQRT_SCALED_IFFT   inverse    1/sqrt(N)
    =================  =========  ==============
    """

    FFT = 0
    IFFT = 1
    UNSCALED_IFFT = 2
    SQRT_SCALED_FFT = 3
    SQRT_SCALED_IFFT = 4

    @property
    def is_forward(self) -> bool:
        """True for forward transforms (negative-exponent twiddles)."""
        return self in (Transform.FFT, Transform.SQRT_SCALED_FFT)

    def inverse(self) -> Optional["Transform"]:
        """The transform that undoes this one, or None for UNSCALED_IFFT."""
        return _INVERSES[self]

    def scale(self, n: int) -> Optional[float]:
        """The final normalization factor for an n-point transform, or None
        when no scaling is applied (FFT / UNSCALED_IFFT)."""
        if self in (Transform.FFT, Transform.UNSCALED_IFFT):
            return None
        if self is Transform.IFFT:
            return 1.0 / n
        return 1.0 / (n ** 0.5)


_INVERSES = {
    Transform.FFT: Transform.IFFT,
    Transform.IFFT: Transform.FFT,
    Transform.UNSCALED_IFFT: None,
    Transform.SQRT_SCALED_FFT: Transform.SQRT_SCALED_IFFT,
    Transform.SQRT_SCALED_IFFT: Transform.SQRT_SCALED_FFT,
}
