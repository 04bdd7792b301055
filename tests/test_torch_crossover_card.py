"""The card's crossover route on a CUDA card: the sizes of fft_bench.rs
that the JAX package's rules run as one full-size DFT product plan as B2
there (``plan/planner.py``, ``_card_bluestein``), through the entry the
benchmark calls, against the float64 DFT; and the real transforms whose
inner the crossover moves to B2 (odd n then run B5a/B5b).

This module imports neither JAX nor the JAX package, so it also runs where
JAX is not installed. There, skip the tests directory's ``conftest.py``
(it sets JAX up for the CPU run):

    python -m pytest --noconftest -m cuda tests/test_torch_crossover_card.py

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from fourier_tpu_torch import Transform, VpuBluesteinPlan, create_fft_f32
from fourier_tpu_torch.rfft import RfftPlan

C64_GATE = 1e-6
BATCH = 4096


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [125, 191, 222, 439, 722])
def test_bench15_products_run_b2_on_card(cuda_device, n):
    plan = create_fft_f32(n, device=cuda_device)
    assert isinstance(plan, VpuBluesteinPlan), plan
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    re = torch.randn(n, BATCH, device=cuda_device, generator=gen)
    im = torch.randn(n, BATCH, device=cuda_device, generator=gen)
    x = re.double().cpu().numpy() + 1j * im.double().cpu().numpy()
    for mode in (Transform.FFT, Transform.IFFT):
        ore, oim = plan.transform_planar_bm(re, im, mode)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(ore).all() and torch.isfinite(oim).all()), (n, mode)
        got = ore.double().cpu().numpy() + 1j * oim.double().cpu().numpy()
        want = np.fft.fft(x, axis=0) if mode.is_forward else np.fft.ifft(x, axis=0)
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert rel <= C64_GATE, (n, mode, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 250, 37, 101])
def test_rfft_over_the_crossover_on_card(cuda_device, n):
    plan = RfftPlan(n, device=cuda_device)
    assert isinstance(plan.inner, VpuBluesteinPlan) and plan.fused is (n % 2 == 1)
    x = torch.randn(n, BATCH, device=cuda_device)
    re, im = plan.rfft_planar_bm(x)
    back = plan.irfft_planar_bm(re, im)
    torch.cuda.synchronize()
    want = np.fft.rfft(x.double().cpu().numpy(), axis=0)
    got = re.double().cpu().numpy() + 1j * im.double().cpu().numpy()
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel <= C64_GATE, (n, rel)
    err = float(torch.linalg.norm(back.double() - x.double()) / torch.linalg.norm(x.double()))
    assert err <= C64_GATE, (n, err)
