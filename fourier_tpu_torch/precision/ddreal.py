"""Double-word f32 arithmetic on torch tensors: ~49-bit reals as (hi, lo).

Port of ``fourier_tpu/precision/ddreal.py``. The JAX package carries a
complex128 value on its f32-only chip as pairs of f32 (x = hi + lo with
|lo| <= ulp(hi)/2) and computes on them with the classical error-free
transformations (Knuth two-sum, Veltkamp split and Dekker two-product). The
port computes complex128 in native f64 and needs none of this for its
transforms; these functions are for a caller's own double-word pipeline
between two transforms (as ``ConvolvePlan.convolve_planar_dd`` is in the
JAX package), and give bitwise the JAX module's numpy results.

Every function is elementwise over same-shaped f32 tensors (CPU or CUDA). A
double-word value is a tuple ``(hi, lo)``. Each rounding step is a torch op
of its own, materialised in f32: nothing here may be fused or contracted
(no ``addcmul``/``addcdiv``, no ``torch.compile``, no ``torch.jit``), since
a fused multiply-add or an algebraic simplification of ``(a + b) - a``
destroys the error-free transformations (measured in the JAX package under
XLA: rel-L2 1e-15 -> 5e-8). Eager torch runs one kernel an operator, as
numpy does, so the JAX package's optimisation barriers have no counterpart.

:func:`from_f64` and :func:`to_f64` are the split and the join of an f64
tensor, which the port's 4-plane calls (``transform_planar_dd`` and the
like) use around their native f64 transforms.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_SPLIT = 4097.0  # 2^12 + 1: Veltkamp split constant for f32 (24-bit mantissa)

DD = Tuple  # (hi, lo)


def two_sum(a, b):
    """Error-free sum: s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (Dekker fast2sum)."""
    s = a + b
    e = b - (s - a)
    return s, e


def veltkamp_split(a):
    """a == hi + lo with hi, lo each fitting in 12 mantissa bits."""
    t = _SPLIT * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free product: p + e == a * b exactly (Dekker)."""
    p = a * b
    ah, al = veltkamp_split(a)
    bh, bl = veltkamp_split(b)
    e = (((ah * bh) - p) + (ah * bl) + (al * bh)) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# dd operations
# ---------------------------------------------------------------------------


def add(x: DD, y: DD) -> DD:
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return quick_two_sum(s, e)


def sub(x: DD, y: DD) -> DD:
    return add(x, neg(y))


def neg(x: DD) -> DD:
    return -x[0], -x[1]


def mul(x: DD, y: DD) -> DD:
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def _split_scalar_f32(c: float):
    """Veltkamp split of a scalar in f32 arithmetic (a Python-float split
    would compute in f64, where SPLIT*c never rounds, and keep all 24 bits
    in 'hi')."""
    c32 = np.float32(c)
    t = np.float32(_SPLIT) * c32
    hi = t - (t - c32)
    lo = c32 - hi
    return float(hi), float(lo)


def mul_f32(x: DD, c: float) -> DD:
    """Multiply a dd value by an f32-representable scalar constant."""
    ch, cl = _split_scalar_f32(c)
    p = x[0] * c
    ah, al = veltkamp_split(x[0])
    e = (((ah * ch) - p) + (ah * cl) + (al * ch)) + al * cl
    e = e + x[1] * c
    return quick_two_sum(p, e)


def is_pow2_scalar(c: float) -> bool:
    """True when f32(c) is a (signed) power of two: dd-exact to scale by."""
    c = float(np.float32(c))
    if c == 0.0 or not math.isfinite(c):
        return False
    return math.frexp(c)[0] in (0.5, -0.5)


def scale_pow2(x: DD, c: float) -> DD:
    """Multiply by a power-of-two scalar: exact, two multiplies, no EFT."""
    return x[0] * c, x[1] * c


def mul_dd_const(x: DD, c) -> DD:
    """Multiply a dd value by an f64 scalar given as its dd split
    ``c = (ch, cl)`` (:func:`const`): one Dekker product against ``ch``,
    the ``x0*cl`` and ``x1*ch`` cross terms folded into the error limb."""
    ch, cl = c
    chh, chl = _split_scalar_f32(ch)
    x0, x1 = x
    p = x0 * ch
    ah, al = veltkamp_split(x0)
    e = (((ah * chh) - p) + (ah * chl) + (al * chh)) + al * chl
    e = e + (x0 * cl + x1 * ch)
    return quick_two_sum(p, e)


def from_f64(a) -> DD:
    """Split f64 data (a tensor, or array-like onto the CPU) into the
    (hi, lo) f32 pair: hi = f32(a), lo = f32(a - hi), exactly the JAX
    package's split. A DTensor stays a DTensor."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a, dtype=np.float64))
    a = a.double()
    hi = a.float()
    lo = (a - hi).float()  # hi widened exactly inside the f64 subtraction
    return hi, lo


def to_f64(x: DD) -> torch.Tensor:
    """Join a (hi, lo) pair into f64: f64(hi) + f64(lo) (lo widened exactly
    inside the f64 addition)."""
    return x[0].double() + x[1]


def const(v: float):
    """Split a Python float into dd scalar parts (hi, lo) as Python floats."""
    hi = float(np.float32(v))
    lo = float(np.float32(v - hi))
    return hi, lo
