"""Plain PyTorch mixed-radix Stockham autosort on planar (..., n) tensors.

Port of ``fourier_tpu/ops/stockham_jax.py``: the port's ``stockham`` family
and its oracle-faithful execution path. With current sub-transform size `s`,
stride `st`, radix `r` and m = s/r, the input viewed as (r, m, st) at
(k, i, j) is butterflied along k, output k is multiplied by W_s^(i*k)
(skipped on the final stage where s == r), and written to the output viewed
as (m, r, st) at (i, k, j). Then s /= r, st *= r.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from fourier_tpu_torch.ops import cplx
from fourier_tpu_torch.ops.butterflies import BUTTERFLIES

# A planar twiddle table for one stage: (re, im) tensors of shape (m, radix).
StageTwiddles = Tuple[torch.Tensor, torch.Tensor]


def apply_stages(
    re: torch.Tensor,
    im: torch.Tensor,
    radices: Sequence[int],
    twiddles: Sequence[StageTwiddles],
    forward: bool,
    scale: Optional[float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all Stockham stages over the last axis of the planar input.

    `twiddles` holds one direction-matched (m, radix) table per stage;
    `scale` is the mode's final normalization factor or None.
    """
    n = re.shape[-1]
    batch_shape = re.shape[:-1]
    size = n
    stride = 1
    for radix, (tw_re, tw_im) in zip(radices, twiddles):
        m = size // radix
        vre = re.reshape(*batch_shape, radix, m, stride)
        vim = im.reshape(*batch_shape, radix, m, stride)
        parts = [(vre[..., k, :, :], vim[..., k, :, :]) for k in range(radix)]
        outs = BUTTERFLIES[radix](parts, forward)
        if size != radix:
            for k in range(1, radix):
                t = (tw_re[:, k].reshape(m, 1), tw_im[:, k].reshape(m, 1))
                outs[k] = cplx.mul(outs[k], t)
        re = torch.stack([o[0] for o in outs], dim=-2).reshape(*batch_shape, n)
        im = torch.stack([o[1] for o in outs], dim=-2).reshape(*batch_shape, n)
        size = m
        stride *= radix
    if scale is not None:
        re = re * scale
        im = im * scale
    return re, im
