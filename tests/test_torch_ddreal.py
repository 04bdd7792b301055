"""The port's double-word arithmetic (``fourier_tpu_torch/precision/ddreal.py``
and ``ddcplx.py``) bitwise against the JAX package's numpy path.

Every function runs on the same seeded f32 inputs, spread over the whole
f32 range, with signed zeros, subnormals, infinities and the Veltkamp
split's edges among them (values whose 4097-fold overflows, all-ones
mantissas, powers of two, the smallest normal): every output element must
have the JAX module's bits (NaNs where it has NaNs). The JAX module runs
its numpy path, which numpy computes op by op in strict IEEE f32, as eager
torch does.
"""

import numpy as np
import pytest
import torch

from fourier_tpu.precision import ddcplx as jdc
from fourier_tpu.precision import ddreal as jdd

from fourier_tpu_torch.precision import ddcplx as tdc
from fourier_tpu_torch.precision import ddreal as tdd

SEED = 0xDDEA1
N = 4096

# The Veltkamp split's edges: 4097*a overflows past ~8.3e34; all-ones
# mantissas round hi up; powers of two; the smallest normal and subnormals.
EDGES = np.array([
    0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, 1.1754944e-38, -1.1754944e-38,
    8.3e34, 8.4e34, -8.4e34, 3.4028235e38, -3.4028235e38, np.inf, -np.inf,
    1.0 - 2.0 ** -24, 2.0 ** 24 - 1, 4097.0, 1.0 / 4097.0, 2.0 ** 12 + 1, 2.0 ** -126,
    0.5, -2.0, 3.0, 1.0 + 2.0 ** -23, 2.0 ** 127,
], np.float32)


def _values(seed, scale_exp=(-140, 120)):
    rng = np.random.default_rng(seed)
    e = rng.integers(*scale_exp, N)
    a = (rng.standard_normal(N) * np.exp2(e.astype(np.float64))).astype(np.float32)
    a[:len(EDGES)] = EDGES
    a[len(EDGES):2 * len(EDGES)] = -EDGES[::-1]
    return a


def _pair(seed):
    """A dd pair (hi, lo) with |lo| near ulp(hi)/2 and both at the edges."""
    hi = _values(seed)
    lo = (hi.astype(np.float64) * np.random.default_rng(seed + 7).uniform(
        -2.0 ** -25, 2.0 ** -25, N)).astype(np.float32)
    return hi, lo


def _same(want, got):
    """Bitwise equal, NaN where NaN."""
    want = [np.asarray(w, np.float32) for w in want]
    got = [g.numpy() for g in got]
    for w, g in zip(want, got):
        assert w.shape == g.shape
        nan = np.isnan(w)
        assert np.array_equal(nan, np.isnan(g))
        assert np.array_equal(w[~nan].view(np.uint32), g[~nan].view(np.uint32))


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


A, B = _values(SEED), _values(SEED + 1)
X, Y = _pair(SEED + 2), _pair(SEED + 3)
XT, YT = _t(*X), _t(*Y)

REAL = {
    "two_sum": (lambda m, x, y: m.two_sum(x[0], y[0])),
    "quick_two_sum": (lambda m, x, y: m.quick_two_sum(x[0], x[1])),
    "veltkamp_split": (lambda m, x, y: m.veltkamp_split(x[0])),
    "two_prod": (lambda m, x, y: m.two_prod(x[0], y[0])),
    "add": (lambda m, x, y: m.add(x, y)),
    "sub": (lambda m, x, y: m.sub(x, y)),
    "neg": (lambda m, x, y: m.neg(x)),
    "mul": (lambda m, x, y: m.mul(x, y)),
    "mul_f32": (lambda m, x, y: m.mul_f32(x, 0.1)),
    "mul_f32_pow2": (lambda m, x, y: m.mul_f32(x, -0.25)),
    "scale_pow2": (lambda m, x, y: m.scale_pow2(x, 0.125)),
    "mul_dd_const": (lambda m, x, y: m.mul_dd_const(x, m.const(np.pi))),
    "mul_dd_const_third": (lambda m, x, y: m.mul_dd_const(x, m.const(1.0 / 3.0))),
}


@pytest.mark.parametrize("name", list(REAL))
def test_ddreal_bitwise(name):
    fn = REAL[name]
    with np.errstate(all="ignore"):
        want = fn(jdd, X, Y)
    _same(want, fn(tdd, XT, YT))


def test_two_sum_and_two_prod_on_wide_values():
    """The error-free transformations alone on the two wide random arrays."""
    with np.errstate(all="ignore"):
        _same(jdd.two_sum(A, B), tdd.two_sum(*_t(A, B)))
        _same(jdd.two_prod(A, B), tdd.two_prod(*_t(A, B)))
        _same(jdd.veltkamp_split(B), tdd.veltkamp_split(torch.as_tensor(B)))


@pytest.mark.parametrize("v", [0.0, -0.0, 1.0, np.pi, 1.0 / 3.0, 1e-40, -7e30, 0.1])
def test_scalar_helpers(v):
    assert tdd.const(v) == jdd.const(v)
    assert tdd._split_scalar_f32(v) == jdd._split_scalar_f32(v)
    assert tdd.is_pow2_scalar(v) == jdd.is_pow2_scalar(v)


def test_from_f64_to_f64_bitwise():
    rng = np.random.default_rng(SEED + 4)
    x = np.concatenate([rng.standard_normal(N) * np.exp2(rng.integers(-200, 200, N)),
                        [0.0, -0.0, 5e-324, -5e-324, 1e-310, 1e300, -1e300]])
    with np.errstate(all="ignore"):
        want = jdd.from_f64(x)
    got = tdd.from_f64(torch.as_tensor(x))
    _same(want, got)
    finite = np.isfinite(want[0]) & np.isfinite(want[1])
    with np.errstate(all="ignore"):
        _same(jdd.from_f64(x[:8]), tdd.from_f64(x[:8]))  # array-like onto the CPU
        joined = jdd.to_f64(want)
    assert np.array_equal(joined[finite], tdd.to_f64(got).numpy()[finite])


Z = ((X[0], X[1]), (Y[0], Y[1]))
ZT = ((XT[0], XT[1]), (YT[0], YT[1]))
W = (_pair(SEED + 5), _pair(SEED + 6))
WT = tuple(_t(*p) for p in W)

CPLX = {
    "add": lambda m, z, w: m.add(z, w),
    "sub": lambda m, z, w: m.sub(z, w),
    "neg": lambda m, z, w: m.neg(z),
    "conj": lambda m, z, w: m.conj(z),
    "mul": lambda m, z, w: m.mul(z, w),
    "mul_const": lambda m, z, w: m.mul_const(z, 0.3, -0.7),
    "mul_const_real": lambda m, z, w: m.mul_const(z, 0.3, 0.0),
    "mul_const_imag": lambda m, z, w: m.mul_const(z, 0.0, -0.5),
    "scale": lambda m, z, w: m.scale(z, 1.0 / 3.0),
    "scale_pow2": lambda m, z, w: m.scale(z, 0.0625),
    "rotate_fwd": lambda m, z, w: m.rotate(z, True),
    "rotate_inv": lambda m, z, w: m.rotate(z, False),
}


@pytest.mark.parametrize("name", list(CPLX))
def test_ddcplx_bitwise(name):
    fn = CPLX[name]
    with np.errstate(all="ignore"):
        (wr, wi) = fn(jdc, Z, W)
    (gr, gi) = fn(tdc, ZT, WT)
    _same([*wr, *wi], [*gr, *gi])
