"""numpy.fft keyword helpers shared by the module-level wrappers.

Private ports of ``fourier_tpu/ndim.py:_norm_mode`` and ``_crop_pad_axis``;
the N-D transforms themselves are not ported yet (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

from typing import Optional

import torch

from fourier_tpu_torch.transform import Transform


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
