"""The port's scipy.fft backend: scipy code dispatches to the port unchanged.

Counterparts of every test of ``tests/test_scipy_backend.py``: each call
runs ``scipy.fft.<fn>`` under ``set_backend`` of the port's backend (built
on the CPU here, ``FourierTpuScipyBackend(device="cpu")``) and of the JAX
package's, and on scipy's default backend, on the same seeded inputs. The
port meets the reference test's gate against scipy and the same gate
against the JAX package's backend (both compute in complex128 for these
float64 inputs). Added: the exported instance runs on the card, scipy.signal
code under the backend, and the port's results alias no argument.
"""

import numpy as np
import pytest
import scipy.fft as sfft
import scipy.signal as ss

import fourier_tpu as jft

import fourier_tpu_torch as tft
from fourier_tpu_torch.scipy_backend import FourierTpuScipyBackend

BE = FourierTpuScipyBackend(device="cpu")
JBE = jft.scipy_fft_backend
RNG_SEED = 0xBACE


def _close(got, want, tol):
    got = np.asarray(got)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * max(1.0, np.linalg.norm(want))


def _three(call, tol, *data):
    """call(scipy.fft, *data) on scipy's backend, the JAX package's and the
    port's (pinned: a call that fell through would raise): the port within
    `tol` of scipy and of the JAX package."""
    want = call(sfft, *[np.copy(d) for d in data])
    with sfft.set_backend(JBE):
        jax_out = call(sfft, *[np.copy(d) for d in data])
    with sfft.set_backend(BE, only=True):
        got = call(sfft, *[np.copy(d) for d in data])
    _close(got, want, tol)
    _close(got, np.asarray(jax_out), tol)
    return got


@pytest.mark.parametrize(
    "call,tol",
    [
        (lambda m, x: m.fft(x), 1e-12),
        (lambda m, x: m.fft(x, 100), 1e-12),
        (lambda m, x: m.fft(x, 64, 0, "ortho"), 1e-12),  # positional args
        (lambda m, x: m.ifft(x, norm="forward"), 1e-12),
        (lambda m, x: m.fft(x, workers=4, overwrite_x=True), 1e-12),
    ],
)
def test_fft_1d_dispatch(call, tol):
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((8, 96)) + 1j * rng.standard_normal((8, 96))
    # copies: overwrite_x=True licenses scipy to destroy its input
    _three(call, tol, x)


def test_fftn_dispatch():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((4, 6, 8)) + 1j * rng.standard_normal((4, 6, 8))
    for call in (
        lambda m, v: m.fft2(v),
        lambda m, v: m.fftn(v),
        lambda m, v: m.ifftn(v, norm="ortho"),
        lambda m, v: m.fftn(v, axes=(1, 2)),
        lambda m, v: m.fftn(v, s=(8, 8), axes=(-2, -1)),
    ):
        _three(call, 1e-12, x)


def test_real_hermitian_dispatch():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((6, 80))
    spec = np.fft.rfft(x)
    for call, data in (
        (lambda m, v: m.rfft(v), x),
        (lambda m, v: m.rfft(v, n=72, axis=-1, norm="ortho"), x),
        (lambda m, v: m.irfft(v), spec),
        (lambda m, v: m.irfft(v, n=80), spec),
        (lambda m, v: m.hfft(v, n=80), spec),
        (lambda m, v: m.ihfft(v, n=64), x),
        (lambda m, v: m.rfftn(v), x),
        (lambda m, v: m.rfftn(v, axes=(-2, -1)), x),
        (lambda m, v: m.irfftn(v, axes=(-2, -1)), np.fft.rfftn(x)),
    ):
        _three(call, 1e-11, data)


def test_dct_dst_dispatch():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((4, 64))
    for call in (
        lambda m, v: m.dct(v),
        lambda m, v: m.dct(v, type=3, norm="ortho"),
        lambda m, v: m.dct(v, n=48),  # scipy's n crops before the transform
        lambda m, v: m.idct(v, type=2),
        lambda m, v: m.dst(v, type=4, norm="ortho"),
        lambda m, v: m.idst(v),
        lambda m, v: m.dctn(v, norm="ortho"),
        lambda m, v: m.idstn(v, axes=(-1,)),
    ):
        _three(call, 1e-11, x)


def test_fht_and_fast_len_dispatch():
    a = np.random.default_rng(RNG_SEED).standard_normal(64)
    got = _three(lambda m, v: m.fht(v, 0.1, 0.5), 1e-10, a)
    _three(lambda m, v: m.ifht(v, 0.1, 0.5), 1e-10, got)
    with sfft.set_backend(BE):
        back = sfft.ifht(got, 0.1, 0.5)
    _close(back, a, 1e-10)


def test_unsupported_options_fall_through():
    """Options the port's surface does not cover run on scipy's default
    backend (not ours, not an error) unless only=True pins us: the same
    calls as the JAX package's backend."""
    x = np.random.default_rng(RNG_SEED).standard_normal((4, 6, 8))
    want = sfft.rfftn(x, axes=(0, 2))  # non-trailing axes
    for be in (BE, JBE):
        with sfft.set_backend(be):
            got = sfft.rfftn(x, axes=(0, 2))
        _close(got, want, 1e-12)
        with pytest.raises(Exception):
            with sfft.set_backend(be, only=True):
                sfft.rfftn(x, axes=(0, 2))
    with pytest.raises(Exception):
        with sfft.set_backend(BE, only=True):
            sfft.dct(x, norm="ortho", orthogonalize=False)  # not covered


def test_register_backend_persistent():
    from scipy._lib import uarray as ua

    x = np.random.default_rng(RNG_SEED).standard_normal(128)
    sfft.register_backend(BE)
    try:
        _close(sfft.fft(x), np.fft.fft(x), 1e-12)
    finally:
        # Drop the registration: registered backends are process-global and
        # would shadow scipy's pocketfft for the rest of the test session.
        ua.clear_backends("numpy.scipy.fft", registered=True, globals=False)
    _close(sfft.fft(x), np.fft.fft(x), 1e-12)  # default backend restored


def test_exported_backend_runs_on_the_card():
    """fourier_tpu_torch.scipy_fft_backend is the card's instance: without a
    card its calls raise instead of falling back to the CPU."""
    import torch

    be = tft.scipy_fft_backend
    assert isinstance(be, FourierTpuScipyBackend) and be.device == "cuda"
    assert be.__ua_domain__ == "numpy.scipy.fft"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            with sfft.set_backend(be, only=True):
                sfft.fft(np.ones(8))


def test_results_are_writable_and_alias_no_argument():
    """scipy.signal.istft scales its irfft result in place: the backend's
    results are writable and never a view of the caller's array."""
    x = np.random.default_rng(RNG_SEED).standard_normal((3, 64))
    with sfft.set_backend(BE):
        out = sfft.dct(x, n=64)
        shifted = sfft.rfft(x)
    assert out.flags.writeable and not np.may_share_memory(out, x)
    assert shifted.flags.writeable
    out *= 2.0
    np.testing.assert_array_equal(x, np.random.default_rng(RNG_SEED).standard_normal(
        (3, 64)))


def test_scipy_signal_under_the_backend():
    """scipy.signal code runs on the port: fftconvolve of complex inputs
    (its fftn/ifftn), welch and stft/istft (rfft/irfft) against scipy's own
    backend and the JAX package's."""
    rng = np.random.default_rng(RNG_SEED)
    a = rng.standard_normal((40, 50)) + 1j * rng.standard_normal((40, 50))
    b = rng.standard_normal((7, 9)) + 1j * rng.standard_normal((7, 9))
    _three(lambda m, u, v: ss.fftconvolve(u, v, "same"), 1e-12, a, b)
    x = rng.standard_normal((2, 3000))
    _three(lambda m, v: ss.welch(v, nperseg=256)[1], 1e-12, x)
    z = _three(lambda m, v: ss.stft(v, nperseg=128)[2], 1e-12, x)
    _three(lambda m, v: ss.istft(v, nperseg=128)[1], 1e-12, z)
