"""The port's stockham family (AutosortPlan, BluesteinPlan) against the JAX
package on the CPU.

The exhaustive 1..255 sweep of ``tests/test_integrity.py`` runs both packages
on the same seeded inputs: each must meet the oracle gate (per-component
absolute error 1e-4 for c64, 1e-11 for c128, scaled by n for the 1/n-scaled
inverse on n-scaled input), and the port must agree with the reference at
rel-L2 <= 1e-6 (c64) and <= 1e-12 (c128).
"""

import numpy as np
import pytest
import torch

import fourier_tpu as jft
from fourier_tpu import Transform as JTransform

import fourier_tpu_torch as tft
from fourier_tpu_torch import Transform
from fourier_tpu_torch.plan import AutosortPlan, BluesteinPlan
from fourier_tpu_torch.plan.base import stage_views
from fourier_tpu_torch.utils import oracle_transform

RNG_SEED = 0xDEADBEEF
GATES = {
    np.complex64: (1e-4, 1e-6, torch.complex64),
    np.complex128: (1e-11, 1e-12, torch.complex128),
}


def _rand(shape, rng, scale=1.0):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale


def _run_jax(plan, x, mode):
    rt = plan.real_dtype
    ore, oim = plan._apply(np.asarray(x.real, rt), np.asarray(x.imag, rt),
                           JTransform(int(mode)))
    return np.asarray(ore) + 1j * np.asarray(oim)


def _run_port(plan, x, mode):
    re = torch.as_tensor(np.ascontiguousarray(x.real))
    im = torch.as_tensor(np.ascontiguousarray(x.imag))
    ore, oim = plan.transform_planar(re, im, mode)
    return ore.numpy() + 1j * oim.numpy()


@pytest.mark.parametrize("mode", [Transform.FFT, Transform.IFFT])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_sweep_against_reference(dtype, mode):
    oracle_eps, parity, tdtype = GATES[dtype]
    rng = np.random.default_rng(RNG_SEED)
    for n in range(1, 256):
        scale = 1.0 if mode.is_forward else float(n)
        tol = oracle_eps * scale
        x = _rand((2, n), rng, scale).astype(dtype)
        mine_plan = tft.create_fft(n, tdtype, backend="stockham", device="cpu")
        ref_plan = jft.create_fft(n, dtype)
        assert type(mine_plan).__name__ == type(ref_plan).__name__, n
        mine = _run_port(mine_plan, x, mode)
        ref = _run_jax(ref_plan, x, mode)
        want = oracle_transform(x, mode)
        assert np.max(np.abs(mine - want)) < tol, (n, "port vs oracle")
        assert np.max(np.abs(ref - want)) < tol, (n, "reference vs oracle")
        rel = np.linalg.norm(mine - ref) / np.linalg.norm(ref)
        assert rel <= parity, (n, rel)


@pytest.mark.parametrize("n", [16, 24, 73, 100])
@pytest.mark.parametrize("mode", list(Transform))
def test_all_modes_c128(n, mode):
    rng = np.random.default_rng(RNG_SEED + n)
    x = _rand((3, n), rng)
    plan = tft.create_fft_f64(n, device="cpu")
    got = plan.transform(x, mode)
    np.testing.assert_allclose(got, oracle_transform(x, mode), atol=1e-10 * n)


def test_plan_tables_equal_reference():
    """Same f64 values narrowed the same way: the tables are bitwise equal."""
    for n in (96, 243, 4096):
        for dt, jdt in ((torch.complex64, np.complex64), (torch.complex128, np.complex128)):
            mine = AutosortPlan.create(n, dt, device="cpu")
            ref = jft.AutosortPlan.create(n, jdt)
            assert mine.radices == ref.radices
            mine_tables = stage_views(mine.fwd, mine._shapes)
            for (tr, ti), (jr, ji) in zip(mine_tables, ref.fwd_twiddles):
                np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
                np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n", [73, 100])
def test_bluestein_batch_minor_matches_batch_major(n):
    rng = np.random.default_rng(RNG_SEED)
    plan = BluesteinPlan.create(n, torch.complex64, device="cpu")
    x = _rand((n, 5), rng).astype(np.complex64)
    for mode in (Transform.FFT, Transform.IFFT, Transform.SQRT_SCALED_FFT):
        ore, oim = plan.transform_planar_bm(
            torch.as_tensor(x.real.copy()), torch.as_tensor(x.imag.copy()), mode)
        got = ore.numpy() + 1j * oim.numpy()
        want = oracle_transform(x.T, mode).T
        tol = 3e-6 * max(1.0, float(np.max(np.abs(want))))
        assert np.max(np.abs(got - want)) < tol, (n, mode)


def test_roundtrips_and_batches():
    rng = np.random.default_rng(RNG_SEED)
    for n in (16, 27, 73):
        x = _rand((2, 3, n), rng)
        plan = tft.create_fft_f64(n, device="cpu")
        np.testing.assert_allclose(plan.ifft(plan.fft(x)), x, atol=1e-10)
        y = plan.transform(x, Transform.SQRT_SCALED_FFT)
        np.testing.assert_allclose(plan.transform(y, Transform.SQRT_SCALED_IFFT),
                                   x, atol=1e-10)
        np.testing.assert_allclose(plan.transform(x, Transform.UNSCALED_IFFT),
                                   plan.ifft(x) * n, atol=1e-9)


def test_input_validation():
    plan = tft.create_fft_f32(8, device="cpu")
    with pytest.raises(ValueError):
        plan.fft(np.zeros(9, np.complex64))
    with pytest.raises(ValueError):
        plan.fft_planar(torch.zeros(8), torch.zeros(7))
    with pytest.raises(ValueError):
        tft.create_fft(0, device="cpu")
    with pytest.raises(ValueError):
        tft.create_fft(8, np.float32, device="cpu")
