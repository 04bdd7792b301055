"""Planar complex arithmetic on (re, im) pairs of real tensors.

Port of ``fourier_tpu/ops/cplx.py``. The port keeps the planar representation
of the reference: every plan and kernel works on separate f32/f64 planes, and
complex dtypes appear only at the API boundary. A value is a tuple
``(re, im)`` of same-shaped real tensors; all functions are shape-polymorphic
and dtype-preserving.
"""

from __future__ import annotations

from typing import Tuple

Pair = Tuple  # (re, im)


def add(a: Pair, b: Pair) -> Pair:
    return a[0] + b[0], a[1] + b[1]


def sub(a: Pair, b: Pair) -> Pair:
    return a[0] - b[0], a[1] - b[1]


def mul(a: Pair, b: Pair) -> Pair:
    """Full complex multiply (4 mul + 2 add)."""
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def mul_const(a: Pair, cr: float, ci: float) -> Pair:
    """Multiply by a plan-time complex constant (cr + i*ci)."""
    return a[0] * cr - a[1] * ci, a[0] * ci + a[1] * cr


def scale(a: Pair, s) -> Pair:
    return a[0] * s, a[1] * s


def rotate(a: Pair, forward: bool) -> Pair:
    """Multiply by +i (forward) or -i."""
    if forward:
        return -a[1], a[0]
    return a[1], -a[0]
