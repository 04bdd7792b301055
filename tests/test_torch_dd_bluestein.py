"""Kernel B7 of the port (the fused f64 Bluestein transform) and its plan.

* The port's VpuDdBluesteinPlan on the CPU runs B7's plain PyTorch version
  in float64; the JAX VpuDdBluesteinPlan runs its double-word Pallas kernel
  in interpret mode (as ``tests/test_dd_bluestein.py`` does), hi + lo
  recombined in f64. Same seeded inputs, rel-L2 <= 1e-12 (the reference's
  c128 gate) against the JAX output and against np.fft.
* The inner size and eligibility equal the JAX package's.
* The CUDA kernel cannot run here: its paired body's numpy emulation is
  ``test_torch_pair_kernels.py``'s ``test_b7_pair_body_emulated``.
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


def test_wrapper_contract():
    n = 17
    plan = VpuDdBluesteinPlan.create(n, device="cpu")
    st = plan.stages
    kw = dict(tables=(st.tables(True), st.tables(False)),
              pair_tables=(st.pair_fwd, st.pair_inv), chirps=plan.chirps(True))
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
