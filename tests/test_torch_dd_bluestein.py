"""Kernel B7 of the port (the fused f64 Bluestein transform) and its plan.

* The port's VpuDdBluesteinPlan on the CPU runs B7's plain PyTorch version
  in float64; the JAX VpuDdBluesteinPlan runs its double-word Pallas kernel
  in interpret mode (as ``tests/test_dd_bluestein.py`` does), hi + lo
  recombined in f64. Same seeded inputs, rel-L2 <= 1e-12 (the reference's
  c128 gate) against the JAX output and against np.fft.
* The inner size and eligibility equal the JAX package's.
* The CUDA kernel cannot run here: a numpy transliteration of its algorithm
  (chirp load with zero rows, the f64 stages, the w multiply, the scaled
  output chirp, column blocking and the ragged-edge mask) is held against
  np.fft.
* ``test_kernel_matches_plain_on_card`` runs the kernel where a card is
  present (marker ``cuda``).
"""

import numpy as np
import pytest
import torch

from fourier_tpu import Transform as JTransform
from fourier_tpu.precision.dd_bluestein import VpuDdBluesteinPlan as JVpuDdBluesteinPlan

from fourier_tpu_torch import Transform, trace
from fourier_tpu_torch.ops.cuda import stockham_vpu_dd as dv
from fourier_tpu_torch.precision import VpuDdBluesteinPlan

from test_torch_vpu import emulate_stages
from test_torch_vpu_dd import (GATE, _dd_planes, _from_dd, _np, _planes, _rand,
                               _rel, np_transform)

RNG_SEED = 0xB7


def launches(op: str) -> int:
    """Launches of the operator ``fourier_tpu_torch::<op>`` counted so far."""
    return trace.counters()[f"launches.fourier_tpu_torch::{op}"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,inner", [(17, 64), (100, 256), (125, 256)])
def test_plan_and_plain_b7_match_pallas_interpret(n, inner):
    rng = np.random.default_rng(RNG_SEED + n)
    x_t = _rand((n, 5), rng)
    mine = VpuDdBluesteinPlan.create(n, device="cpu")
    ref = JVpuDdBluesteinPlan.create(n)
    assert ref.interpret and mine.m_inner == ref.m_inner == inner
    mode = Transform.FFT
    want = _from_dd(*ref.transform_planar_dd_bm(*_dd_planes(x_t), JTransform(int(mode))))
    got = _np(*mine.transform_planar_bm(*_planes(x_t), mode))
    assert got.shape == (n, 5)
    assert _rel(got, want) <= GATE and _rel(got, np_transform(x_t, mode)) <= GATE
    st = mine.stages
    plain = dv.vpu_dd_bluestein_batch_minor_reference(
        *_planes(x_t), n, inner, (st.tables(True), st.tables(False)),
        mine.chirps(True), None)
    assert _rel(_np(*plain), want) <= GATE
    for mode in Transform:  # every mode against np.fft, both layouts
        got = _np(*mine.transform_planar_bm(*_planes(x_t), mode))
        assert _rel(got, np_transform(x_t, mode)) <= GATE, (n, mode)
        x = np.ascontiguousarray(x_t.T)
        assert _rel(mine.transform(x, mode), np_transform(x, mode, -1)) <= GATE


def test_inner_size_matches_jax():
    for n in list(range(1, 1100, 13)) + [16, 17, 32, 1024, 1025]:
        mine = VpuDdBluesteinPlan.create(n, device="cpu")
        ref = JVpuDdBluesteinPlan.create(n)
        assert (mine is None) == (ref is None), n
        if mine is not None:
            assert mine.m_inner == ref.m_inner, n
    assert VpuDdBluesteinPlan.create(100, torch.complex64, device="cpu") is None
    plan = VpuDdBluesteinPlan.create(100, device="cpu")
    assert plan.dtype == torch.complex128 and plan.xt_fwd.dtype == torch.float64
    assert "inner=256" in repr(plan)


def _emulate_b7(x_t, n, m, chirps, scale):
    """numpy transliteration of B7 (bluestein_planar<double>)."""
    cols, _ = dv.launch_geometry_dd(m)
    xt, wt, xo = (c[0] + 1j * c[1] for c in chirps)
    b = x_t.shape[1]
    out = np.empty((n, b), np.complex128)
    for b0 in range(0, b, cols):
        valid = min(cols, b - b0)
        s = np.zeros((m, cols), np.complex128)
        s[:n, :valid] = x_t[:, b0:b0 + valid] * xt[:, None]
        s = s.ravel()
        emulate_stages(s, m, cols, True, dd=True)
        s *= np.repeat(wt, cols)
        emulate_stages(s, m, cols, False, dd=True)
        out[:, b0:b0 + valid] = (s.reshape(m, cols)[:n, :valid]
                                 * (xo * scale)[:, None])
    return out


@pytest.mark.parametrize("n", [17, 125, 439, 1013])
def test_kernel_algorithm_emulated(n):
    plan = VpuDdBluesteinPlan.create(n, device="cpu")
    m = plan.m_inner
    cols, _ = dv.launch_geometry_dd(m)
    rng = np.random.default_rng(RNG_SEED + n)
    x_t = _rand((n, cols + 3), rng)  # a ragged last block
    for mode in (Transform.FFT, Transform.SQRT_SCALED_IFFT):
        chirps = [c.numpy() for c in plan.chirps(mode.is_forward)]
        got = _emulate_b7(x_t, n, m, chirps, mode.scale(n) or 1.0)
        assert _rel(got, np_transform(x_t, mode)) <= GATE, (n, mode)


def test_wrapper_contract():
    n = 17
    plan = VpuDdBluesteinPlan.create(n, device="cpu")
    st = plan.stages
    kw = dict(tables=(st.tables(True), st.tables(False)),
              kernel_tables=(st.kernel_fwd, st.kernel_inv),
              chirps=plan.chirps(True))
    for bad in (torch.zeros(n, 3), torch.zeros(n, 6).double()[:, ::2],
                torch.zeros(n + 1, 3).double(),
                torch.zeros(n, 3, dtype=torch.float64, device="meta")):
        with pytest.raises((TypeError, ValueError)):
            dv.vpu_dd_bluestein_batch_minor(bad, bad, n, st.size, None, **kw)
    before = launches("vpu_dd_bluestein")
    ok = torch.zeros(n, 3, dtype=torch.float64)
    dv.vpu_dd_bluestein_batch_minor(ok, ok, n, st.size, None, **kw)
    assert launches("vpu_dd_bluestein") == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 125, 439, 1013])
def test_kernel_matches_plain_on_card(cuda_device, n):
    rng = np.random.default_rng(RNG_SEED + n)
    plan = VpuDdBluesteinPlan.create(n, device=cuda_device)
    st = plan.stages
    x = _rand((n, 1000), rng)
    re = torch.as_tensor(x.real.copy(), device=cuda_device)
    im = torch.as_tensor(x.imag.copy(), device=cuda_device)
    for mode in Transform:
        before = launches("vpu_dd_bluestein")
        kre, kim = plan.transform_planar_bm(re, im, mode)
        assert launches("vpu_dd_bluestein") == before + 1
        pre, pim = dv.vpu_dd_bluestein_batch_minor_reference(
            re, im, n, st.size, (st.tables(True), st.tables(False)),
            plan.chirps(mode.is_forward), mode.scale(n))
        got = _np(kre.cpu(), kim.cpu())
        assert _rel(got, _np(pre.cpu(), pim.cpu())) <= GATE, (n, mode)
        assert _rel(got, np_transform(x, mode)) <= GATE, (n, mode)
