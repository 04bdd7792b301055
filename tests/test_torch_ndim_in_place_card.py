"""B1's clustered body on a complex64 tensor where it lies
(``csrc/fft_pair_strided.cu``, the operator
``fourier_tpu_torch::vpu_fft_strided``) on a CUDA card, against its plain
version (``vpu_fft_strided_reference``) and ``np.fft`` in f64, and the N-D
surface's in-place route that runs it.

This module imports neither JAX nor the JAX package, so it also runs where
JAX is not installed. There, skip the tests directory's ``conftest.py``
(it sets JAX up for the CPU run):

    python -m pytest --noconftest -m cuda tests/test_torch_ndim_in_place_card.py

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

import fourier_tpu_torch as ftt
from fourier_tpu_torch import Transform, trace
from fourier_tpu_torch.ops.cuda import stockham_vpu as sv

CARD_GATE = 1e-6  # rel-L2, the card's gate (chip_smoke.py REL_L2_GATE)
OP = "launches.fourier_tpu_torch::vpu_fft_strided"
# (shape, axis): the strided-column layout (inner > 1) with whole and
# ragged column groups (inner 13: odd, so 8-byte copies), the
# contiguous-row layout (inner = 1) with a ragged group of transforms;
# n = 512 (two-block clusters, 16 columns a tile), 2048 (two blocks of
# 1024 rows) and 4096 (four blocks).
CASES = [((3, 512, 64), 1), ((2, 512, 13), 1), ((37, 512), 1), ((5, 2048, 40), 1),
         ((4, 2048, 13), 1), ((19, 2048), 1), ((2, 4096, 24), 1), ((3, 4096, 13), 1),
         ((33, 4096), 1), ((4096, 9), 0)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _host(t):
    return t.detach().cpu().numpy().astype(np.complex128)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis", CASES)
def test_strided_body_against_plain(cuda_device, shape, axis):
    """Both layouts, both directions with a scale, into a new tensor and in
    place (output = input): the kernel against the plain version and
    np.fft, each launch counted once."""
    n = shape[axis]
    plan = ftt.create_fft(n, torch.complex64, backend="vpu", device=cuda_device,
                          cache=False)
    g = torch.Generator(device=cuda_device).manual_seed(n + len(shape))
    x = torch.randn(shape, dtype=torch.complex64, device=cuda_device, generator=g)
    xh = _host(x)
    for mode in (Transform.FFT, Transform.IFFT, Transform.SQRT_SCALED_FFT,
                 Transform.SQRT_SCALED_IFFT):
        fwd, scale = mode.is_forward, mode.scale(n)
        want = (np.fft.fft(xh, axis=axis) if fwd else np.fft.ifft(xh, axis=axis) * n) * (
            scale or 1.0)
        plain = sv.vpu_fft_strided_reference(x, axis, n, plan.tables(fwd), fwd, scale)
        before = trace.counters()[OP]
        got = plan.transform_strided(x, axis, fwd, scale)
        y = x.clone()
        assert plan.transform_strided(y, axis, fwd, scale, out=y) is y
        torch.cuda.synchronize()
        assert trace.counters()[OP] == before + 2
        for out in (got, y):
            assert _rel(_host(out), want) <= CARD_GATE, (shape, mode)
            assert _rel(_host(out), _host(plain)) <= CARD_GATE, (shape, mode)
        assert torch.equal(got, y), (shape, mode)


@pytest.mark.cuda
def test_strided_body_unaligned_and_nan(cuda_device):
    """A tensor 8 bytes off 16-byte alignment (8-byte copies in both
    layouts); a NaN in one column leaves every other column finite."""
    plan = ftt.create_fft(4096, torch.complex64, device=cuda_device)
    flat = torch.randn(6 * 4096 * 8 + 1, dtype=torch.complex64, device=cuda_device)
    x = flat[1:].view(6, 4096, 8)
    for xv, axis in ((x, 1), (x.reshape(48, 4096), 1)):
        got = plan.transform_strided(xv, axis, True, None)
        assert _rel(_host(got), np.fft.fft(_host(xv), axis=axis)) <= CARD_GATE
    x = x.clone()
    x[2, 100, 3] = float("nan")
    bad = ~torch.isfinite(plan.transform_strided(x, 1, True, None))
    assert bad[2, :, 3].all() and int(bad.sum()) == 4096
    rows = x.transpose(1, 2).contiguous()
    bad = ~torch.isfinite(plan.transform_strided(rows, 2, True, None))
    assert bad[2, 3, :].all() and int(bad.sum()) == 4096


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["fft2", "ifft2", "fftn", "ifftn"])
def test_surface_in_place_on_card(cuda_device, fn):
    """fft2/ifft2/fftn/ifftn on complex64 images run one launch of the
    operator an axis and nothing else: axis.in_place 2, axis.copied 0, no
    launch of B1 on planes; the input is left as it was."""
    x = torch.randn(3, 1024, 2048, dtype=torch.complex64, device=cuda_device)
    keep = x.clone()
    before = trace.counters().snapshot()
    got = getattr(ftt, fn)(x, axes=(-2, -1))
    torch.cuda.synchronize()
    delta = trace.counters().delta(before)
    assert delta.get("axis.in_place") == 2 and "axis.copied" not in delta
    assert delta.get(OP) == 2 and "launches.fourier_tpu_torch::vpu_fft" not in delta
    assert torch.equal(x, keep)
    np_fn = getattr(np.fft, fn)
    assert _rel(_host(got), np_fn(_host(keep), axes=(-2, -1))) <= CARD_GATE * np.sqrt(2)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["fft2", "ifft2"])
def test_surface_thin_axis_keeps_the_planes(cuda_device, fn):
    """fft2/ifft2 over axes (0, 1) of a channels-last (H, W, 3) image: the
    axis of H runs in place, the axis of W (3 values after it, under half of
    a tile's 16 columns at 1024) over planes, and the whole scale lands
    once."""
    x = torch.randn(512, 1024, 3, dtype=torch.complex64, device=cuda_device)
    before = trace.counters().snapshot()
    got = getattr(ftt, fn)(x, axes=(0, 1))
    torch.cuda.synchronize()
    delta = trace.counters().delta(before)
    assert delta.get("axis.in_place") == 1 and delta.get("axis.copied") == 1
    assert delta.get(OP) == 1
    want = getattr(np.fft, fn)(_host(x), axes=(0, 1))
    assert _rel(_host(got), want) <= CARD_GATE * np.sqrt(2)
