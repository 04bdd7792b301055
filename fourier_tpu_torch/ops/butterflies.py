"""Radix-2/3/4/5/8 DIT butterflies and their two-level composites, on planar
(re, im) tensors.

Port of ``fourier_tpu/ops/butterflies.py``: radix-4 as two radix-2 layers
plus a ±i rotation, radix-8 as two radix-4 plus a radix-2 layer with W_8
twiddles, radix-3/5 in the real-constant sum/difference form, and 9/25/27 as
two-level Cooley-Tukey blocks. The radix-64/81/125 blocks of the fused B1
schedule (``ops/pallas/stockham_vpu.py:_butterfly64/81/125``) are the same
two-level composition one size up, so the plain B1 version in
``ops/cuda/stockham_vpu.py`` shares this vocabulary.

Each butterfly takes a list of `r` planar values (already gathered along the
radix axis) and returns `r` planar outputs. Every constant is an f64 Python
float, narrowed to the tensor's dtype by the multiply.
"""

from __future__ import annotations

import math
from typing import List, Sequence

from fourier_tpu_torch.ops import cplx

_SQRT_2_2 = math.sqrt(2.0) / 2.0
_SIN_PI_3 = math.sqrt(3.0) / 2.0


def butterfly2(x: Sequence, forward: bool) -> List:
    """[a+b, a-b]."""
    del forward
    return [cplx.add(x[0], x[1]), cplx.sub(x[0], x[1])]


def butterfly3(x: Sequence, forward: bool) -> List:
    """Radix-3 in the reduced form x0 - s/2 ± i*ti*(x1-x2)."""
    ti = -_SIN_PI_3 if forward else _SIN_PI_3  # imag part of W_3^1
    s = cplx.add(x[1], x[2])
    d = cplx.sub(x[1], x[2])
    base = cplx.add(x[0], cplx.scale(s, -0.5))
    rot = cplx.scale(cplx.rotate(d, True), ti)
    return [
        cplx.add(x[0], s),
        cplx.add(base, rot),
        cplx.sub(base, rot),
    ]


def butterfly4(x: Sequence, forward: bool) -> List:
    """Two radix-2 layers + ±i rotation + output permutation."""
    a0 = cplx.add(x[0], x[2])
    a1 = cplx.sub(x[0], x[2])
    a2 = cplx.add(x[1], x[3])
    a3 = cplx.rotate(cplx.sub(x[1], x[3]), forward)
    return [
        cplx.add(a0, a2),
        cplx.sub(a1, a3),
        cplx.sub(a0, a2),
        cplx.add(a1, a3),
    ]


def butterfly8(x: Sequence, forward: bool) -> List:
    """Two radix-4 + radix-2 combine with W_8 twiddles."""
    c = _SQRT_2_2
    tw_i = -c if forward else c  # W_8^1 = c + i*tw_i
    a = butterfly4([x[0], x[2], x[4], x[6]], forward)
    b = butterfly4([x[1], x[3], x[5], x[7]], forward)
    b1 = cplx.mul_const(b[1], c, tw_i)
    b2 = cplx.rotate(b[2], not forward)
    b3 = cplx.mul_const(b[3], -c, tw_i)  # W_8^3 = -conj(W_8^1)
    return [
        cplx.add(a[0], b[0]),
        cplx.add(a[1], b1),
        cplx.add(a[2], b2),
        cplx.add(a[3], b3),
        cplx.sub(a[0], b[0]),
        cplx.sub(a[1], b1),
        cplx.sub(a[2], b2),
        cplx.sub(a[3], b3),
    ]


def _two_level(x: Sequence, R: int, S: int, forward: bool) -> List:
    """N = R*S-point DFT as an SxR Cooley-Tukey.

    With j = R*q + r: G_r[k1] = DFT_S over q, then X[k1 + S*k2] = DFT_R over
    r of (W_N^(r*k1) * G_r[k1]) at k2. The W_N twiddles are f64 constants.
    """
    n = R * S
    sign = -1.0 if forward else 1.0
    w = [
        (math.cos(sign * 2.0 * math.pi * t / n),
         math.sin(sign * 2.0 * math.pi * t / n))
        for t in range(n)
    ]
    bfS = BUTTERFLIES[S]
    bfR = BUTTERFLIES[R]
    g = [bfS([x[R * q + r] for q in range(S)], forward)
         for r in range(R)]
    out = [None] * n
    for k1 in range(S):
        col = []
        for r in range(R):
            t = (r * k1) % n
            if t == 0:
                col.append(g[r][k1])
            else:
                col.append(cplx.mul_const(g[r][k1], w[t][0], w[t][1]))
        res = bfR(col, forward)
        for k2 in range(R):
            out[k1 + S * k2] = res[k2]
    return out


_C5_1 = math.cos(2.0 * math.pi / 5.0)
_C5_2 = math.cos(4.0 * math.pi / 5.0)
_S5_1 = math.sin(2.0 * math.pi / 5.0)
_S5_2 = math.sin(4.0 * math.pi / 5.0)


def butterfly5(x: Sequence, forward: bool) -> List:
    """Radix-5 via the sum/difference symmetry of W_5^k (real constants).

    With t1 = x1+x4, t2 = x2+x3, t3 = x1-x4, t4 = x2-x3:
      y0    = x0 + t1 + t2
      y1/y4 = (x0 + c1*t1 + c2*t2) ± i*sign*(s1*t3 + s2*t4)
      y2/y3 = (x0 + c2*t1 + c1*t2) ± i*sign*(s2*t3 - s1*t4)
    (sign = -1 forward).
    """
    t1 = cplx.add(x[1], x[4])
    t2 = cplx.add(x[2], x[3])
    t3 = cplx.sub(x[1], x[4])
    t4 = cplx.sub(x[2], x[3])
    a = cplx.add(x[0], cplx.add(cplx.scale(t1, _C5_1), cplx.scale(t2, _C5_2)))
    b = cplx.add(x[0], cplx.add(cplx.scale(t1, _C5_2), cplx.scale(t2, _C5_1)))
    u = cplx.add(cplx.scale(t3, _S5_1), cplx.scale(t4, _S5_2))
    v = cplx.sub(cplx.scale(t3, _S5_2), cplx.scale(t4, _S5_1))
    iu = cplx.rotate(u, not forward)  # i*sign*u
    iv = cplx.rotate(v, not forward)
    return [
        cplx.add(x[0], cplx.add(t1, t2)),
        cplx.add(a, iu),
        cplx.add(b, iv),
        cplx.sub(b, iv),
        cplx.sub(a, iu),
    ]


def _composite(R: int, S: int):
    def butterfly(x: Sequence, forward: bool) -> List:
        return _two_level(x, R, S, forward)

    return butterfly


BUTTERFLIES = {
    2: butterfly2, 3: butterfly3, 4: butterfly4, 5: butterfly5,
    8: butterfly8,
}
# Composites, each built from entries already in the table.
for _r, _s in ((3, 3), (5, 5), (3, 9), (8, 8), (9, 9), (5, 25)):
    BUTTERFLIES[_r * _s] = _composite(_r, _s)
