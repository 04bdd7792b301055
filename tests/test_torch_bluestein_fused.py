"""Kernel B2 of the port (the fused Bluestein transform) and its plan.

* The port's VpuBluesteinPlan on the CPU runs B2's plain PyTorch version;
  the JAX VpuBluesteinPlan runs its Pallas kernel in interpret mode (as
  ``tests/test_vpu.py`` does). Same seeded inputs, all 5 modes, both
  layouts; max abs error <= 3e-6 * max(1, max|X|), the JAX test's gate.
* The inner-size choice equals the JAX package's over a range of sizes.
* The CUDA kernel cannot run here: a numpy transliteration of its algorithm
  (chirp load with zero rows, the forward and inverse stages of the shared
  stage code, the w multiply, the scaled output chirp, column blocking and
  the ragged-edge mask) is held against np.fft.
* ``test_kernel_matches_plain_on_card`` runs the kernel where a card is
  present (marker ``cuda``).
"""

import numpy as np
import pytest
import torch

from fourier_tpu import Transform as JTransform
from fourier_tpu.plan.bluestein_fused import VpuBluesteinPlan as JVpuBluesteinPlan

from fourier_tpu_torch import Transform, trace
from fourier_tpu_torch.ops.cuda import stockham_vpu as sv
from fourier_tpu_torch.plan import VpuBluesteinPlan

from test_torch_vpu import emulate_stages

RNG_SEED = 0xB2


def launches(op: str) -> int:
    """Launches of the operator ``fourier_tpu_torch::<op>`` counted so far."""
    return trace.counters()[f"launches.fourier_tpu_torch::{op}"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


def _rand(shape, rng):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, want):
    tol = 3e-6 * max(1.0, float(np.max(np.abs(want))))
    return float(np.max(np.abs(got - want))) < tol


def _planes(x):
    return (torch.as_tensor(np.ascontiguousarray(x.real)),
            torch.as_tensor(np.ascontiguousarray(x.imag)))


@pytest.mark.parametrize("n,inner", [(73, 160), (100, 200)])
def test_plan_and_plain_b2_match_pallas_interpret(n, inner):
    rng = np.random.default_rng(RNG_SEED + n)
    x_t = _rand((n, 5), rng)
    mine = VpuBluesteinPlan.create(n, device="cpu")
    ref = JVpuBluesteinPlan.create(n)
    assert mine.m_inner == ref.m_inner == inner
    st = mine.stages
    for mode in Transform:
        jre, jim = ref.transform_planar_bm(x_t.real, x_t.imag, JTransform(int(mode)))
        want = np.asarray(jre) + 1j * np.asarray(jim)
        ore, oim = mine.transform_planar_bm(*_planes(x_t), mode)
        assert ore.shape == (n, 5)
        assert _close(ore.numpy() + 1j * oim.numpy(), want), (n, mode)
        pre, pim = sv.vpu_bluestein_batch_minor_reference(
            *_planes(x_t), n, inner, (st.tables(True), st.tables(False)),
            mine.chirps(mode.is_forward), mode.scale(n))
        assert _close(pre.numpy() + 1j * pim.numpy(), want), (n, mode, "plain")
    # batch-major adapter
    x = np.ascontiguousarray(x_t.T)
    jre, jim = ref.transform_planar(x.real, x.imag)
    ore, oim = mine.transform_planar(*_planes(x))
    assert _close(ore.numpy() + 1j * oim.numpy(), np.asarray(jre) + 1j * np.asarray(jim))


def test_choose_inner_matches_jax():
    sizes = list(range(2, 600, 7)) + [769, 818, 1013, 1418, 2048, 4093, 4096,
                                      4097, 8191]
    for n in sizes:
        mine = VpuBluesteinPlan.choose_inner(n, VpuBluesteinPlan.MAX_INNER)
        assert mine == JVpuBluesteinPlan.choose_inner(n, JVpuBluesteinPlan.MAX_INNER), n
        assert (VpuBluesteinPlan.create(n, device="cpu") is None) == (mine is None)
    assert VpuBluesteinPlan.create(1, device="cpu") is None
    assert VpuBluesteinPlan.create(73, torch.complex128, device="cpu") is None


def _emulate_b2(x_t, n, m, chirps, scale):
    """numpy transliteration of B2 in csrc/stockham_vpu.cu."""
    cols, _ = sv.launch_geometry(m)
    xt, wt, xo = (c[0].astype(np.float64) + 1j * c[1].astype(np.float64)
                  for c in chirps)
    b = x_t.shape[1]
    out = np.empty((n, b), np.complex128)
    for b0 in range(0, b, cols):
        valid = min(cols, b - b0)
        s = np.zeros((m, cols), np.complex128)
        s[:n, :valid] = x_t[:, b0:b0 + valid] * xt[:, None]
        s = s.ravel()
        emulate_stages(s, m, cols, True)
        s *= np.repeat(wt, cols)
        emulate_stages(s, m, cols, False)
        out[:, b0:b0 + valid] = (s.reshape(m, cols)[:n, :valid]
                                 * (xo * scale)[:, None])
    return out


@pytest.mark.parametrize("n", [73, 769, 1013, 1418])
def test_kernel_algorithm_emulated(n):
    plan = VpuBluesteinPlan.create(n, device="cpu")
    m = plan.m_inner
    cols, _ = sv.launch_geometry(m)
    rng = np.random.default_rng(RNG_SEED + n)
    x_t = _rand((n, cols + 3), rng).astype(np.complex128)  # ragged last block
    for mode in (Transform.FFT, Transform.SQRT_SCALED_IFFT):
        chirps = [c.numpy() for c in plan.chirps(mode.is_forward)]
        got = _emulate_b2(x_t, n, m, chirps, mode.scale(n) or 1.0)
        want = (np.fft.fft(x_t, axis=0) if mode.is_forward
                else np.fft.ifft(x_t, axis=0) * n) * (mode.scale(n) or 1.0)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-6, (n, mode)


def test_wrapper_contract():
    """The plain version runs only for CPU tensors (no launch counted); the
    wrapper raises on what the kernel does not take."""
    n = 73
    plan = VpuBluesteinPlan.create(n, device="cpu")
    st = plan.stages
    kw = dict(tables=(st.tables(True), st.tables(False)),
              kernel_tables=(st.kernel_fwd, st.kernel_inv),
              chirps=plan.chirps(True))
    for bad in (torch.zeros(n, 3).double(), torch.zeros(n, 6)[:, ::2],
                torch.zeros(n + 1, 3), torch.zeros(n, 3, device="meta")):
        with pytest.raises((TypeError, ValueError)):
            sv.vpu_bluestein_batch_minor(bad, bad, n, st.size, None, **kw)
    before = launches("vpu_bluestein")
    ok = torch.zeros(n, 3)
    sv.vpu_bluestein_batch_minor(ok, ok, n, st.size, None, **kw)
    assert launches("vpu_bluestein") == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [73, 769, 1013, 1418, 4093])
def test_kernel_matches_plain_on_card(cuda_device, n):
    rng = np.random.default_rng(RNG_SEED + n)
    plan = VpuBluesteinPlan.create(n, device=cuda_device)
    st = plan.stages
    x = _rand((n, 1000), rng)
    re = torch.as_tensor(x.real.copy(), device=cuda_device)
    im = torch.as_tensor(x.imag.copy(), device=cuda_device)
    for mode in Transform:
        before = launches("vpu_bluestein")
        kre, kim = plan.transform_planar_bm(re, im, mode)
        assert launches("vpu_bluestein") == before + 1
        pre, pim = sv.vpu_bluestein_batch_minor_reference(
            re, im, n, st.size, (st.tables(True), st.tables(False)),
            plan.chirps(mode.is_forward), mode.scale(n))
        got = kre.cpu().numpy() + 1j * kim.cpu().numpy()
        want = pre.cpu().numpy() + 1j * pim.cpu().numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-6, (n, mode)
