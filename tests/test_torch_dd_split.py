"""Kernel B8 of the port (the f64 split combine) and the split plans.

* B8's plain PyTorch version against the JAX
  ``dd_split_combine_batch_minor(..., interpret=True)`` called directly at
  m=64, r in {2, 3, 5}, B=128, on the same seeded sub-spectra (hi + lo
  recombined in f64), rel-L2 <= 1e-12 (the reference's c128 gate); and
  against the combine computed from np.fft.
* The whole split plans (B6 sub-plans, B8 combine, plain versions on the
  CPU) against np.fft at 2187, 3125 and 8192 and beyond: the JAX plans take
  minutes there on the CPU. Which sizes split, and how, equals the JAX
  package.
* ``test_kernel_matches_plain_on_card`` runs the kernel where a card is
  present (marker ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_tpu.ops.pallas.dd_combine import dd_split_combine_batch_minor as jcombine
from fourier_tpu.precision.dd_split import (DdSplitPow2Plan as JDdSplitPow2Plan,
                                            DdSplitRadixPlan as JDdSplitRadixPlan,
                                            _radix_twiddle_tables,
                                            _twiddle_tables)

from fourier_tpu_torch import Transform, trace
from fourier_tpu_torch.ops.cuda import dd_combine as dc
from fourier_tpu_torch.plan import plan_tree
from fourier_tpu_torch.precision import DdSplitPow2Plan, DdSplitRadixPlan
from fourier_tpu_torch.precision.dd_split import twiddle_tables

from test_torch_vpu_dd import (GATE, _dd_planes, _from_dd, _np, _planes, _rand,
                               _rel, np_transform)

RNG_SEED = 0xB8


def launches(op: str) -> int:
    """Launches of the operator ``fourier_tpu_torch::<op>`` counted so far."""
    return trace.counters()[f"launches.fourier_tpu_torch::{op}"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


def _jax_tables(n, r):
    """The JAX plan's (forward, inverse) double-word class tables."""
    if r == 2:
        return tuple((t,) for t in _twiddle_tables(n // 2))
    return _radix_twiddle_tables(n, r)


@pytest.mark.parametrize("r", [2, 3, 5])
def test_twiddle_tables_match_jax(r):
    n = 64 * r
    for mine, ref in zip(twiddle_tables(n, r), _jax_tables(n, r)):
        assert mine.shape == (2, r - 1, n // r) and mine.dtype == np.float64
        want = np.stack([_from_dd(*t4) for t4 in ref])
        np.testing.assert_allclose(mine[0] + 1j * mine[1], want, rtol=0, atol=1e-15)


def _combine_want(x, n, r, mode):
    """The combine from its definition: sub-spectra of each class through
    an np.fft over the classes, twiddled."""
    m, b = n // r, x.shape[1] // r
    k = np.arange(m)[:, None]
    sign = -1 if mode.is_forward else 1
    out = np.zeros((r, m, b), np.complex128)
    for j in range(r):
        for t in range(r):
            w = np.exp(sign * 2j * np.pi * t * (j * m + k) / n)
            out[j] += x[:, t * b:(t + 1) * b] * w
    return out.reshape(n, b) * (mode.scale(n) or 1.0)


@pytest.mark.parametrize("r,mode", [(r, m) for r in (2, 3, 5)
                                    for m in (Transform.FFT, Transform.SQRT_SCALED_IFFT)])
def test_plain_b8_matches_pallas_interpret(r, mode):
    m, b = 64, 128
    n = r * m
    rng = np.random.default_rng(RNG_SEED + r)
    x = _rand((m, r * b), rng)
    fwd, inv = _jax_tables(n, r)
    jt = fwd if mode.is_forward else inv
    jt = tuple(tuple(jnp.asarray(p).reshape(m, 1) for p in t4) for t4 in jt)
    want = _from_dd(*jcombine(*(jnp.asarray(p) for p in _dd_planes(x)), n, r, jt,
                              mode.is_forward, mode.scale(n), interpret=True))
    tables = torch.as_tensor(twiddle_tables(n, r)[0 if mode.is_forward else 1])
    got = _np(*dc.dd_split_combine_batch_minor(
        *_planes(x), n, r, mode.is_forward, mode.scale(n), tables=tables))
    assert got.shape == (n, b)
    assert _rel(got, want) <= GATE, (r, mode)
    assert _rel(got, _combine_want(x, n, r, mode)) <= GATE, (r, mode)


@pytest.mark.parametrize("n", [2187, 3125, 8192, 6144, 10000, 16384])
def test_split_plan_vs_numpy(n):
    rng = np.random.default_rng(RNG_SEED + n)
    x_t = _rand((n, 3), rng)
    plan = (DdSplitPow2Plan.create(n, device="cpu")
            or DdSplitRadixPlan.create(n, device="cpu"))
    modes = list(Transform) if n in (2187, 3125, 8192) else [Transform.FFT,
                                                              Transform.IFFT]
    for mode in modes:
        got = _np(*plan.transform_planar_bm(*_planes(x_t), mode))
        assert _rel(got, np_transform(x_t, mode)) <= GATE, (n, mode)
    x = np.ascontiguousarray(x_t.T)
    assert _rel(plan.transform(x), np.fft.fft(x)) <= GATE


def test_create_sizes_match_jax():
    for n in (6144, 8192, 12288, 16384, 32768, 8191, 10000, 2187, 3125, 2189,
              1013, 6561, 4096, 24):
        mine = DdSplitPow2Plan.create(n, device="cpu")
        ref = JDdSplitPow2Plan.create(n)
        assert (mine is None) == (ref is None), n
        if mine is not None:
            assert plan_tree(mine) == plan_tree(ref)
        mine = DdSplitRadixPlan.create(n, device="cpu")
        ref = JDdSplitRadixPlan.create(n)
        assert (mine is None) == (ref is None), n
        if mine is not None:
            assert plan_tree(mine) == plan_tree(ref)
    assert plan_tree(DdSplitRadixPlan.create(10000, device="cpu")) == (
        "DdSplitRadixPlan", 10000, 5, ("VpuDdFftPlan", 2000))
    assert DdSplitPow2Plan.create(8192, torch.complex64, device="cpu") is None


def _emulate_b8(x, n, r, tables, forward, scale):
    """numpy transliteration of split_combine_c128: thread (k, b) loads
    class t at row k*r*B + t*B + b, twiddles (table times scale), the
    r-point butterfly (an exact DFT), and stores section j at
    (j*m + k)*B + b."""
    m, b = n // r, x.shape[1] // r
    flat = x.ravel()
    tw = tables[0] + 1j * tables[1]
    out = np.empty(n * b, np.complex128)
    k, col = np.meshgrid(np.arange(m), np.arange(b), indexing="ij")
    vals = []
    for t in range(r):
        v = flat[k * r * b + t * b + col]
        vals.append(v * scale if t == 0 else v * (tw[t - 1][k] * scale))
    v = np.stack(vals)
    y = np.fft.fft(v, axis=0) if forward else np.fft.ifft(v, axis=0) * r
    for j in range(r):
        out[(j * m + k) * b + col] = y[j]
    return out.reshape(n, b)


@pytest.mark.parametrize("r", [2, 3, 5])
def test_kernel_algorithm_emulated(r):
    m, b = 40, 7
    n = r * m
    rng = np.random.default_rng(RNG_SEED + r)
    x = _rand((m, r * b), rng)
    for mode in (Transform.FFT, Transform.SQRT_SCALED_IFFT):
        tables = twiddle_tables(n, r)[0 if mode.is_forward else 1]
        got = _emulate_b8(x, n, r, tables, mode.is_forward, mode.scale(n) or 1.0)
        assert _rel(got, _combine_want(x, n, r, mode)) <= GATE, (r, mode)


def test_wrapper_contract():
    n, r = 192, 3
    tables = torch.as_tensor(twiddle_tables(n, r)[0])
    for bad in (torch.zeros(64, 9), torch.zeros(64, 18).double()[:, ::2],
                torch.zeros(65, 9).double(), torch.zeros(64, 8).double(),
                torch.zeros(64, 9, dtype=torch.float64, device="meta")):
        with pytest.raises((TypeError, ValueError)):
            dc.dd_split_combine_batch_minor(bad, bad, n, r, True, None, tables=tables)
    ok = torch.zeros(64, 9, dtype=torch.float64)
    with pytest.raises(ValueError):
        dc.dd_split_combine_batch_minor(ok, ok, n, 4, True, None, tables=tables)
    with pytest.raises(ValueError):
        dc.dd_split_combine_batch_minor(ok, ok, n, r, True, None, tables=tables[:, :1])
    before = launches("dd_split_combine")
    dc.dd_split_combine_batch_minor(ok, ok, n, r, True, None, tables=tables)
    assert launches("dd_split_combine") == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8192, 2187, 3125])
def test_kernel_matches_plain_on_card(cuda_device, n):
    plan = (DdSplitPow2Plan.create(n, device=cuda_device)
            or DdSplitRadixPlan.create(n, device=cuda_device))
    r, m, b = plan.radix, n // plan.radix, 1000
    rng = np.random.default_rng(RNG_SEED + n)
    x = _rand((m, r * b), rng)
    re = torch.as_tensor(x.real.copy(), device=cuda_device)
    im = torch.as_tensor(x.imag.copy(), device=cuda_device)
    for mode in Transform:
        tables = plan.tw_fwd if mode.is_forward else plan.tw_inv
        before = launches("dd_split_combine")
        k = dc.dd_split_combine_batch_minor(re, im, n, r, mode.is_forward,
                                            mode.scale(n), tables=tables)
        assert launches("dd_split_combine") == before + 1
        p = dc.dd_split_combine_batch_minor_reference(re, im, n, r, tables,
                                                      mode.is_forward, mode.scale(n))
        got = _np(k[0].cpu(), k[1].cpu())
        assert _rel(got, _np(p[0].cpu(), p[1].cpu())) <= GATE, (n, mode)
        assert _rel(got, _combine_want(x, n, r, mode)) <= GATE, (n, mode)
