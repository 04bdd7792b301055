"""Planar complex arithmetic over double-word f32 reals.

Port of ``fourier_tpu/precision/ddcplx.py``, the dd twin of
:mod:`fourier_tpu_torch.ops.cplx` (add, sub, mul, mul_const, scale, rotate,
conj). A complex value is ``(re, im)`` where re and im are dd pairs
``(hi, lo)`` of f32 tensors: four planes. Results are bitwise the JAX
module's numpy path (:mod:`fourier_tpu_torch.precision.ddreal` says why no
op here may be fused).
"""

from __future__ import annotations

from typing import Tuple

from fourier_tpu_torch.precision import ddreal as dd

Pair = Tuple  # ((re_hi, re_lo), (im_hi, im_lo))


def add(a: Pair, b: Pair) -> Pair:
    return dd.add(a[0], b[0]), dd.add(a[1], b[1])


def sub(a: Pair, b: Pair) -> Pair:
    return dd.sub(a[0], b[0]), dd.sub(a[1], b[1])


def neg(a: Pair) -> Pair:
    return dd.neg(a[0]), dd.neg(a[1])


def conj(a: Pair) -> Pair:
    return a[0], dd.neg(a[1])


def mul(a: Pair, b: Pair) -> Pair:
    """Full complex multiply: 4 dd products + 2 dd additions."""
    re = dd.sub(dd.mul(a[0], b[0]), dd.mul(a[1], b[1]))
    im = dd.add(dd.mul(a[0], b[1]), dd.mul(a[1], b[0]))
    return re, im


def _mul_const_dd(x, c):
    """x times the dd-split scalar c as two f32 products, the JAX module's
    composition (not ddreal.mul_dd_const, so that results match it)."""
    return dd.add(dd.mul_f32(x, c[0]), dd.mul_f32(x, c[1]))


def mul_const(a: Pair, cr: float, ci: float) -> Pair:
    """Multiply by a constant complex scalar, dd-split for accuracy; an
    axis-aligned constant reduces to a scale (after an exact rotate)."""
    cr, ci = float(cr), float(ci)
    if ci == 0.0:
        return scale(a, cr)
    if cr == 0.0:
        return scale(rotate(a, True), ci)
    crd = dd.const(cr)
    cid = dd.const(ci)
    re = dd.sub(_mul_const_dd(a[0], crd), _mul_const_dd(a[1], cid))
    im = dd.add(_mul_const_dd(a[0], cid), _mul_const_dd(a[1], crd))
    return re, im


def scale(a: Pair, s: float) -> Pair:
    s = float(s)
    if dd.is_pow2_scalar(s):
        # exact: a power of two scales each limb directly
        return dd.scale_pow2(a[0], s), dd.scale_pow2(a[1], s)
    sd = dd.const(s)
    return _mul_const_dd(a[0], sd), _mul_const_dd(a[1], sd)


def rotate(a: Pair, forward: bool) -> Pair:
    """Multiply by +i (forward) / -i: exact (sign and swap only)."""
    if forward:
        return dd.neg(a[1]), a[0]
    return a[1], dd.neg(a[0])
