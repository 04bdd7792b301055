"""The JAX package's 4-plane double-word API on the port's native-f64 plans.

On its f32-only chip the JAX package carries a complex128 plane as a
double-word pair of f32 planes (hi, lo), so its c128 calls take and give
four planes (re_hi, re_lo, im_hi, im_lo): ``transform_planar_dd``,
``rfft_planar_dd``, ``convolve_planar_dd`` and the sharded twins. The port
computes complex128 in f64, and each such call here does three steps:

1. join: each f64 plane is f64(hi) + f64(lo) (:func:`ddreal.to_f64`),
   exact for a normalised pair;
2. the plan's own f64 call (kernels B6, B7 or B8 on the card, exactly as
   the 2-plane call);
3. split: each f64 result becomes hi = f32(x), lo = f32(x - hi)
   (:func:`ddreal.from_f64`, the JAX package's split).

So each 4-plane output is the f64 result rounded to the double-word format.
The calls take f32 tensors (DTensors in the sharded twins) and refuse any
other dtype, and planes of different shapes, with ``ValueError``; a
complex64 plan refuses them with ``TypeError``, in the JAX package's words.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from fourier_tpu_torch.precision.ddreal import from_f64, to_f64


def limbs(planes: Sequence, dtype: torch.dtype, call: str,
          device=None) -> list:
    """The double-word planes as f32 tensors of one shape (a numpy plane
    onto `device`), checked for a complex128 plan of `dtype`; `call` names
    the 2-plane call a complex64 plan takes instead."""
    if dtype != torch.complex128:
        raise TypeError(f"this plan uses 2-plane planar data; call {call}")
    out = []
    for p in planes:
        if not isinstance(p, torch.Tensor):
            p = torch.as_tensor(np.asarray(p), device=device)
        if p.dtype != torch.float32:
            raise ValueError(f"double-word planes must be float32, got {p.dtype}")
        out.append(p)
    if any(p.shape != out[0].shape for p in out):
        raise ValueError(
            f"plane shapes differ: {[tuple(p.shape) for p in out]}")
    return out


def join(planes: Sequence) -> Tuple[torch.Tensor, ...]:
    """f64 planes from (hi, lo) pairs: 2k f32 planes in, k out."""
    return tuple(to_f64(planes[i:i + 2]) for i in range(0, len(planes), 2))


def split(planes: Sequence) -> Tuple[torch.Tensor, ...]:
    """(hi, lo) pairs of f64 planes: k in, 2k f32 planes out."""
    return tuple(limb for p in planes for limb in from_f64(p))


def run(call: Callable, planes: Sequence, dtype: torch.dtype, name: str,
        *args, device=None, **kwargs) -> Tuple[torch.Tensor, ...]:
    """`call` (a 2-plane f64 call of a complex128 plan, called `name`) on
    the joined double-word `planes`, its outputs split."""
    f64 = join(limbs(planes, dtype, name, device))
    out = call(*f64, *args, **kwargs)
    return split(out if isinstance(out, tuple) else (out,))
