"""Kernels B9a and B9b of the port on a CUDA card: ``mxu_fft_single`` (its
tensor-core body) against ``np.fft``, and ``mxu_fft_two_phase`` at splits
of each of its bodies against its plain version and ``np.fft``.

This module imports neither JAX nor the JAX package, so it also runs where
JAX is not installed. There, skip the tests directory's ``conftest.py``
(it sets JAX up for the CPU run):

    python -m pytest --noconftest -m cuda tests/test_torch_bailey_card.py

Without a card every test here skips.
"""

import contextlib

import numpy as np
import pytest
import torch

from fourier_tpu_torch import Transform
from fourier_tpu_torch.ops import bailey
from fourier_tpu_torch.ops.cuda import bailey as kb
from fourier_tpu_torch.plan import MxuFftPlan

RNG_SEED = 0xB9
CARD_GATE = 1e-6  # rel-L2, the card's gate (chip_smoke.py REL_L2_GATE)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


def _planes(shape, rng):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np_want(xr, xi, mode):
    x = xr.astype(np.float64) + 1j * xi
    n = x.shape[-1]
    want = np.fft.fft(x, axis=-1) if mode.is_forward else np.fft.ifft(x, axis=-1) * n
    return want * (mode.scale(n) or 1.0)


def _tables(plan, mode, device):
    """The plan's flat planar tables of `mode` on `device`, the scale folded
    into the last, as the plan hands them to the kernels."""
    tabs = list(plan.tables(mode.is_forward))
    scale = mode.scale(plan.size)
    if scale is not None:
        tabs[-1] = (tabs[-1][0] * scale, tabs[-1][1] * scale)
    return [t.to(device) for pair in tabs for t in pair]


def _complex(planes):
    return planes[0].cpu().numpy() + 1j * planes[1].cpu().numpy()


@contextlib.contextmanager
def _forced(body):
    """B9b's `body` ("mma" or "fma") at every split: B9B_FMA_WORK swapped
    in-process, as an A/B does."""
    kept = kb.B9B_FMA_WORK
    kb.B9B_FMA_WORK = 0 if body == "mma" else float("inf")
    try:
        yield
    finally:
        kb.B9B_FMA_WORK = kept


@pytest.mark.cuda
@pytest.mark.parametrize("n", [129, 250, 1000, 4096, 16384])
def test_b9b_on_card(cuda_device, n):
    """B9b at the body two_phase_body picks (the CUDA-core body at 129 and
    250, the tensor-core body above), and at the other one by
    B9B_FMA_WORK swapped in-process, against the plain version and np.fft,
    every mode, with the caller's TF32 on; a transform's result does not
    depend on its block; at the padded splits a NaN row and an infinite row
    stay in their rows with several transforms a block."""
    plan = MxuFftPlan.create(n, impl="pallas", device="cpu")
    rng = np.random.default_rng(RNG_SEED + n)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for b in (1, 7, 1000):
            xr, xi = _planes((b, n), rng)
            re_, im_ = (torch.as_tensor(t, device=cuda_device) for t in (xr, xi))
            for mode in Transform:
                d = _tables(plan, mode, cuda_device)
                p = _complex(bailey.reference_two_phase(re_, im_, *d))
                for body in ("mma", "fma"):
                    with _forced(body):
                        k = kb.mxu_fft_two_phase(re_, im_, *d)
                        got = _complex(k)
                        assert _rel(got, p) <= CARD_GATE, (n, b, mode, body)
                        assert _rel(got, _np_want(xr, xi, mode)) <= CARD_GATE, (
                            n, b, mode, body)
                        if b > 1:
                            tail = kb.mxu_fft_two_phase(re_[1:], im_[1:], *d)
                            assert torch.equal(tail[0], k[0][1:]) and torch.equal(
                                tail[1], k[1][1:]), (n, b, mode, body)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if n not in (129, 250):
        return
    b = 4 * torch.cuda.get_device_properties(cuda_device).multi_processor_count * 8
    xr, xi = _planes((b, n), rng)
    xr[5, n // 2], xi[b // 2, 0] = np.nan, np.inf
    re_, im_ = (torch.as_tensor(t, device=cuda_device) for t in (xr, xi))
    d = _tables(plan, Transform.FFT, cuda_device)
    want = _np_want(np.nan_to_num(xr), np.nan_to_num(xi), Transform.FFT)
    rest = np.setdiff1d(np.arange(b), [5, b // 2])
    for body in ("mma", "fma"):
        with _forced(body):
            got = _complex(kb.mxu_fft_two_phase(re_, im_, *d))
        assert _rel(got[rest], want[rest]) <= CARD_GATE, (n, body)
        assert not np.isfinite(got[5]).all() and not np.isfinite(got[b // 2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 16, 100, 125, 127, 128])
def test_b9a_on_card(cuda_device, n):
    """B9a's tensor-core body against np.fft at batches of one tile, a
    ragged tile and many, with and without a batch tile; a NaN row and an
    infinite one stay in their rows with three tiles a block at least."""
    plan = MxuFftPlan.create(n, impl="pallas", device="cpu")
    rng = np.random.default_rng(RNG_SEED + n)
    for b in (1, 7, 1000, 20001):
        xr, xi = _planes((b, n), rng)
        re_, im_ = (torch.as_tensor(t, device=cuda_device) for t in (xr, xi))
        for mode in Transform:
            d = _tables(plan, mode, cuda_device)
            k = kb.mxu_fft_single(re_, im_, *d)
            assert _rel(_complex(k), _np_want(xr, xi, mode)) <= CARD_GATE, (n, b, mode)
            again = kb.mxu_fft_single(re_, im_, *d, tb=4)
            assert torch.equal(again[0], k[0]) and torch.equal(again[1], k[1])
    # At n not a multiple of 8 the tile's zero-padded columns must not carry
    # them into the other rows of later tiles in the same buffer (at most
    # 2048 threads an SM).
    b = (3 * kb.single_mma_geometry(n).valid * 2048 // (32 * kb.MMA_WARPS)
         * torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    xr, xi = _planes((b, n), rng)
    xr[5, n // 2], xi[b // 2, 0] = np.nan, np.inf
    re_, im_ = (torch.as_tensor(t, device=cuda_device) for t in (xr, xi))
    want = _np_want(np.nan_to_num(xr), np.nan_to_num(xi), Transform.FFT)
    rest = np.setdiff1d(np.arange(b), [5, b // 2])
    got = _complex(kb.mxu_fft_single(re_, im_, *_tables(plan, Transform.FFT, cuda_device)))
    assert _rel(got[rest], want[rest]) <= CARD_GATE, n
    assert not np.isfinite(got[5]).all() and not np.isfinite(got[b // 2]).all()
