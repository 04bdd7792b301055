"""Kernel B6 of the port (the fused f64 Stockham transform) and its plan.

* The port's VpuDdFftPlan on the CPU runs B6's plain PyTorch version in
  float64; the JAX VpuDdFftPlan runs its double-word Pallas kernel in
  interpret mode (as ``tests/test_vpu_dd.py`` does), its four f32 planes
  recombined as hi + lo in f64. Same seeded inputs, rel-L2 <= 1e-12 (the
  reference's c128 gate) against the JAX output and against np.fft. At 243
  and 625 the JAX interpret run compiles radix-27 and radix-25 double-word
  butterflies for one to two minutes on this CPU, so there the port is held
  against np.fft and the JAX plan's own tables instead.
* The CUDA kernel cannot run here: a numpy transliteration of its algorithm
  (the f64 schedule, tables, launch geometry and ragged-edge mask) is held
  against np.fft.
* ``test_kernel_matches_plain_on_card`` runs the kernel where a card is
  present (marker ``cuda``).
"""

import numpy as np
import pytest
import torch

from fourier_tpu import Transform as JTransform
from fourier_tpu.ops.pallas import stockham_vpu_dd as jdv
from fourier_tpu.precision import ddreal
from fourier_tpu.precision.vpu_dd_plan import VpuDdFftPlan as JVpuDdFftPlan

from fourier_tpu_torch import Transform, trace
from fourier_tpu_torch.ops.cuda import stockham_vpu_dd as dv
from fourier_tpu_torch.precision import VpuDdFftPlan

from test_torch_vpu import emulate_stages

RNG_SEED = 0xB6
GATE = 1e-12  # the reference's c128 rel-L2 gate


def launches(op: str) -> int:
    """Launches of the operator ``fourier_tpu_torch::<op>`` counted so far."""
    return trace.counters()[f"launches.fourier_tpu_torch::{op}"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


def _rand(shape, rng):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _planes(x):
    return (torch.as_tensor(np.ascontiguousarray(x.real)),
            torch.as_tensor(np.ascontiguousarray(x.imag)))


def _np(re, im):
    return re.numpy() + 1j * im.numpy()


def _dd_planes(x):
    rh, rl = ddreal.from_f64(x.real)
    ih, il = ddreal.from_f64(x.imag)
    return rh, rl, ih, il


def _from_dd(rh, rl, ih, il):
    f = lambda p: np.asarray(p, np.float64)
    return (f(rh) + f(rl)) + 1j * (f(ih) + f(il))


def np_transform(x, mode, axis=0):
    """np.fft in f64 in one of the five modes, along `axis`."""
    n = x.shape[axis]
    y = np.fft.fft(x, axis=axis) if mode.is_forward else np.fft.ifft(x, axis=axis) * n
    return y * (mode.scale(n) or 1.0)


def test_schedule_matches_jax():
    for n in range(1, 4200):
        mine, ref = dv.radix_schedule_dd(n), jdv.radix_schedule_dd(n)
        assert mine == (None if ref is None else list(ref)), n
        if mine is None:
            continue
        ks = dv.kernel_schedule_dd(n)
        assert set(ks) <= {2, 3, 4, 5, 8} and int(np.prod(ks)) == n
        cols, threads = dv.launch_geometry_dd(n)
        assert threads <= dv.MAX_THREADS and threads % 32 == 0
        assert threads * dv.POINTS_PER_THREAD >= n * cols
    assert dv.radix_schedule_dd(125) is None and dv.radix_schedule_dd(2187) is None


@pytest.mark.parametrize("n", [64, 96, 243, 320, 625, 1000, 3000])
def test_stage_tables_match_jax(n):
    """The compact f64 tables are every stride-th row of the JAX package's
    (n/r, r) double-word tables, recombined within the hi + lo split."""
    for forward in (True, False):
        mine = dv.make_stage_tables_dd(n, forward)
        ref = jdv.make_stage_tables_dd(n, forward)
        assert len(mine) == len(ref)
        stride = 1
        for (tr, ti), t4, r in zip(mine, ref, dv.radix_schedule_dd(n)):
            re, im = _from_dd(*t4).real, _from_dd(*t4).imag
            assert tr.dtype == np.float64
            np.testing.assert_allclose(tr, re[::stride], rtol=0, atol=1e-15)
            np.testing.assert_allclose(ti, im[::stride], rtol=0, atol=1e-15)
            stride *= r


@pytest.mark.parametrize("n,mode", [(64, Transform.FFT), (96, Transform.IFFT),
                                    (320, Transform.FFT)]
                         + [(192, m) for m in Transform])
def test_plan_and_plain_b6_match_pallas_interpret(n, mode):
    rng = np.random.default_rng(RNG_SEED + n)
    x_t = _rand((n, 5), rng)
    mine = VpuDdFftPlan.create(n, device="cpu")
    ref = JVpuDdFftPlan.create(n)
    assert ref.interpret and mine.schedule == tuple(jdv.radix_schedule_dd(n))
    want = _from_dd(*ref.transform_planar_dd_bm(*_dd_planes(x_t), JTransform(int(mode))))
    got = _np(*mine.transform_planar_bm(*_planes(x_t), mode))
    assert got.shape == (n, 5)
    assert _rel(got, want) <= GATE, (n, mode)
    assert _rel(got, np_transform(x_t, mode)) <= GATE, (n, mode)
    plain = dv.vpu_dd_fft_batch_minor_reference(
        *_planes(x_t), n, mine.tables(mode.is_forward), mode.is_forward,
        mode.scale(n))
    assert _rel(_np(*plain), want) <= GATE, (n, mode, "plain")


@pytest.mark.parametrize("n", [243, 625, 729, 1000, 3000, 4096])
def test_plan_vs_numpy(n):
    rng = np.random.default_rng(RNG_SEED + n)
    x_t = _rand((n, 3), rng)
    plan = VpuDdFftPlan.create(n, device="cpu")
    for mode in Transform:
        got = _np(*plan.transform_planar_bm(*_planes(x_t), mode))
        assert _rel(got, np_transform(x_t, mode)) <= GATE, (n, mode)
    # batch-major adapter, leading batch dims
    x = _rand((2, 3, n), rng)
    got = plan.transform(x)
    assert got.dtype == np.complex128 and got.shape == x.shape
    assert _rel(got, np.fft.fft(x)) <= GATE


def test_create_and_dtype():
    assert VpuDdFftPlan.create(125, device="cpu") is None
    assert VpuDdFftPlan.create(8192, device="cpu") is None
    assert VpuDdFftPlan.create(64, torch.complex64, device="cpu") is None
    plan = VpuDdFftPlan.create(64, torch.complex128, device="cpu")
    assert plan.dtype == torch.complex128 and plan.real_dtype == torch.float64
    assert plan.fwd.dtype == plan.kernel_fwd.dtype == torch.float64
    assert "family=vpu" in repr(plan)


def _emulate_b6(x_t, n, forward, scale):
    """numpy transliteration of B6 (stockham_planar<double>): per block of
    `cols` columns, load (the ragged last block masked), the f64 stages, the
    scaled store."""
    cols, _ = dv.launch_geometry_dd(n)
    b = x_t.shape[1]
    out = np.empty((n, b), np.complex128)
    for b0 in range(0, b, cols):
        valid = min(cols, b - b0)
        s = np.zeros((n, cols), np.complex128)
        s[:, :valid] = x_t[:, b0:b0 + valid]
        s = s.ravel()
        emulate_stages(s, n, cols, forward, dd=True)
        out[:, b0:b0 + valid] = s.reshape(n, cols)[:, :valid] * scale
    return out


@pytest.mark.parametrize("n", [64, 243, 625, 1000, 3000, 4096])
def test_kernel_algorithm_emulated(n):
    cols, _ = dv.launch_geometry_dd(n)
    rng = np.random.default_rng(RNG_SEED + n)
    x_t = _rand((n, cols + 1), rng)  # a ragged last block
    for mode in (Transform.FFT, Transform.SQRT_SCALED_IFFT):
        got = _emulate_b6(x_t, n, mode.is_forward, mode.scale(n) or 1.0)
        assert _rel(got, np_transform(x_t, mode)) <= GATE, (n, mode)


def test_wrapper_contract():
    """The plain version runs only for CPU tensors (no launch counted); the
    wrapper raises on what the kernel does not take."""
    n = 64
    plan = VpuDdFftPlan.create(n, device="cpu")
    kw = dict(tables=plan.tables(True), kernel_tables=plan.kernel_fwd)
    for bad in (torch.zeros(n, 3), torch.zeros(n, 6).double()[:, ::2],
                torch.zeros(n + 1, 3).double(),
                torch.zeros(n, 3, dtype=torch.float64, device="meta")):
        with pytest.raises((TypeError, ValueError)):
            dv.vpu_dd_fft_batch_minor(bad, bad, n, True, None, **kw)
    before = launches("vpu_dd_fft")
    ok = torch.zeros(n, 3, dtype=torch.float64)
    dv.vpu_dd_fft_batch_minor(ok, ok, n, True, None, **kw)
    assert launches("vpu_dd_fft") == before


def test_gradcheck_both_layouts():
    plan = VpuDdFftPlan.create(64, device="cpu")
    rng = np.random.default_rng(RNG_SEED)
    re = torch.tensor(rng.standard_normal((2, 64)), requires_grad=True)
    im = torch.tensor(rng.standard_normal((2, 64)), requires_grad=True)
    for mode in (Transform.FFT, Transform.IFFT):
        assert torch.autograd.gradcheck(
            lambda r, i: plan.transform_planar(r, i, mode), (re, im))
        assert torch.autograd.gradcheck(
            lambda r, i: plan.transform_planar_bm(r.T, i.T, mode), (re, im))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 243, 625, 729, 1000, 1024, 3000, 4096])
def test_kernel_matches_plain_on_card(cuda_device, n):
    rng = np.random.default_rng(RNG_SEED + n)
    plan = VpuDdFftPlan.create(n, device=cuda_device)
    x = _rand((n, 1000), rng)
    re = torch.as_tensor(x.real.copy(), device=cuda_device)
    im = torch.as_tensor(x.imag.copy(), device=cuda_device)
    for mode in Transform:
        before = launches("vpu_dd_fft")
        kre, kim = plan.transform_planar_bm(re, im, mode)
        assert launches("vpu_dd_fft") == before + 1
        pre, pim = dv.vpu_dd_fft_batch_minor_reference(
            re, im, n, plan.tables(mode.is_forward), mode.is_forward, mode.scale(n))
        got = _np(kre.cpu(), kim.cpu())
        assert _rel(got, _np(pre.cpu(), pim.cpu())) <= GATE, (n, mode)
        assert _rel(got, np_transform(x, mode)) <= GATE, (n, mode)
