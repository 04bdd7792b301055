"""The port's spectral.py against the JAX package and scipy.signal.

Counterparts of every test of ``tests/test_spectral.py``. Inputs are made
from a seed with numpy and run through the JAX functions (on the CPU, x64
on) and the port's (``device="cpu"``). Gates, rel-L2 over the whole array:
each reference test's own gate against scipy (1e-5 for a complex64 STFT,
1e-4 for the PSD estimates, 2e-3 for spectrogram phases, 1e-12 for
complex128), and against the JAX package twice that gate for complex64 and
the same gate for complex128. The JAX package's jit and pytree tests become
``nn.Module`` tests. Added: the median over an even number of segments,
detrending under a large DC offset, gradients through ``StftPlan`` in
complex128, the one-sided complex128 ``StftPlan`` and the routes a card
takes (``card_routes``: B4 at nfft 256, B5 at an odd nfft of 769).
"""

import numpy as np
import pytest
import scipy.signal as ss
import torch

from fourier_tpu import spectral as jsp

import fourier_tpu_torch as tft
from fourier_tpu_torch import spectral as tsp
from fourier_tpu_torch.rfft import RfftPlan

RNG_SEED = 0x57F7
C64, PSD, C128 = 1e-5, 1e-4, 1e-12


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _gate(port, jax_out, want, tol=C64, double=False):
    port = np.asarray(port)
    assert port.shape == np.shape(want)
    assert _rel(port, want) < tol
    assert _rel(port, jax_out) < (tol if double else 2 * tol)


def _cpu(name):
    fn = getattr(tsp, name)
    return lambda *a, **kw: fn(*a, device="cpu", **kw)


# -- stft / istft ------------------------------------------------------------------


@pytest.mark.parametrize("nperseg,noverlap,nfft,window", [
    (256, None, None, "hann"),
    (128, 96, None, "hamming"),
    (100, 50, 128, "hann"),
    (64, 48, None, ("tukey", 0.25)),
])
def test_stft_vs_scipy(nperseg, noverlap, nfft, window):
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(2000).astype(np.float32)
    kw = dict(fs=10.0, window=window, nperseg=nperseg, noverlap=noverlap, nfft=nfft)
    f, t, z = _cpu("stft")(x, **kw)
    fw, tw, zw = ss.stft(x.astype(np.float64), **kw)
    np.testing.assert_allclose(f, fw)
    np.testing.assert_allclose(t, tw)
    _gate(z, jsp.stft(x, **kw)[2], zw)


def test_stft_boundary_and_padding_modes():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(777).astype(np.float32)
    for boundary in (None, "zeros", "even", "odd", "constant"):
        for padded in (True, False) if boundary is not None else (True,):
            kw = dict(nperseg=64, boundary=boundary, padded=padded)
            f, t, z = _cpu("stft")(x, **kw)
            fw, tw, zw = ss.stft(x.astype(np.float64), **kw)
            np.testing.assert_allclose(t, tw)
            _gate(z, jsp.stft(x, **kw)[2], zw)


def test_stft_complex_input_twosided():
    rng = np.random.default_rng(RNG_SEED)
    x = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(np.complex64)
    with pytest.warns(UserWarning, match="onesided"):
        f, t, z = _cpu("stft")(x, nperseg=64)
    with pytest.warns(UserWarning):
        fw, tw, zw = ss.stft(x.astype(np.complex128), nperseg=64)
    with pytest.warns(UserWarning):
        jz = jsp.stft(x, nperseg=64)[2]
    np.testing.assert_allclose(f, fw)
    _gate(z, jz, zw)


def test_stft_psd_scaling_and_detrend():
    rng = np.random.default_rng(RNG_SEED)
    x = (rng.standard_normal(1024) + 3.0).astype(np.float32)
    x64 = x.astype(np.float64)
    kw = dict(fs=4.0, nperseg=128, scaling="psd", detrend="constant")
    _gate(_cpu("stft")(x, **kw)[2], jsp.stft(x, **kw)[2], ss.stft(x64, **kw)[2])
    kw = dict(nperseg=128, detrend="linear")
    _gate(_cpu("stft")(x, **kw)[2], jsp.stft(x, **kw)[2], ss.stft(x64, **kw)[2], PSD)


@pytest.mark.parametrize("offset", [1e3, 1e5])
def test_stft_detrend_large_offset(offset):
    """Detrending runs in f64 before the complex64 transform, as the
    reference does: unit noise on a large DC offset, given in f64, keeps
    its digits (rounded to f32 before the detrend it would be about 1e-5
    off at 1e3 and 1e-3 at 1e5)."""
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((2, 1500)) + offset
    for detrend in ("constant", "linear"):
        kw = dict(nperseg=128, detrend=detrend, dtype=np.complex64)
        want = ss.stft(x, nperseg=128, detrend=detrend)[2]
        _gate(_cpu("stft")(x, **kw)[2], jsp.stft(x, **kw)[2], want)
        want = ss.welch(x, nperseg=128, detrend=detrend)[1]
        _gate(_cpu("welch")(x, **kw)[1], jsp.welch(x, **kw)[1], want, C64)


def test_stft_callable_detrend():
    """A callable detrend receives the frames as an f64 tensor
    (..., nframes, nperseg)."""
    rng = np.random.default_rng(RNG_SEED)
    x = (rng.standard_normal(900) + 5.0).astype(np.float32)
    seen = []

    def demean(frames):
        seen.append((type(frames), frames.dtype, tuple(frames.shape)))
        return frames - frames.mean(-1, keepdims=True)

    z = _cpu("stft")(x, nperseg=128, detrend=demean)[2]
    assert seen[0][:2] == (torch.Tensor, torch.float64) and seen[0][2][-1] == 128
    want = ss.stft(x.astype(np.float64), nperseg=128, detrend="constant")[2]
    _gate(z, jsp.stft(x, nperseg=128, detrend="constant")[2], want)


def test_stft_batched():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((3, 2, 900)).astype(np.float32)
    _gate(_cpu("stft")(x, nperseg=128)[2], jsp.stft(x, nperseg=128)[2],
          ss.stft(x.astype(np.float64), nperseg=128)[2])


@pytest.mark.parametrize("window,nperseg,noverlap", [
    ("hann", 128, None),
    ("hann", 128, 96),
    ("hamming", 100, 60),
])
def test_istft_roundtrip(window, nperseg, noverlap):
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(1500).astype(np.float32)
    kw = dict(window=window, nperseg=nperseg, noverlap=noverlap)
    f, t, z = _cpu("stft")(x, **kw)
    tr, xr = _cpu("istft")(z, **kw)
    assert xr.dtype == np.float64  # the reference's output dtype
    assert xr.shape[-1] >= x.shape[-1]
    assert _rel(xr[..., :x.shape[-1]], x.astype(np.float64)) < C64
    # matches scipy's istft and the JAX package's of the same spectrogram
    twr, xwr = ss.istft(np.asarray(z, np.complex128), **kw)
    _gate(xr[..., :xwr.shape[-1]], jsp.istft(z, **kw)[1][..., :xwr.shape[-1]], xwr, PSD)


def test_istft_twosided_and_errors():
    rng = np.random.default_rng(RNG_SEED)
    x = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(np.complex64)
    with pytest.warns(UserWarning):
        f, t, z = _cpu("stft")(x, nperseg=64)
    tr, xr = _cpu("istft")(z, nperseg=64, input_onesided=False)
    assert _rel(xr[..., :512], x.astype(np.complex128)) < C64
    jx = jsp.istft(z, nperseg=64, input_onesided=False)[1]
    assert _rel(xr, jx) < 2 * C64
    with pytest.raises(ValueError):
        _cpu("istft")(z[..., :3, :], nperseg=64)           # wrong bin count
    with pytest.raises(ValueError):
        _cpu("istft")(np.zeros(5, np.complex64))           # rank < 2
    with pytest.raises(ValueError, match="NOLA"):
        w = np.zeros(64)
        w[:16] = 1.0
        _cpu("istft")(z, window=w, nperseg=64, noverlap=0, nfft=64,
                      input_onesided=False)


def test_check_cola_nola():
    assert tsp.check_cola("hann", 128, 64) == ss.check_COLA("hann", 128, 64)
    assert tsp.check_cola("hann", 128, 100) == ss.check_COLA("hann", 128, 100)
    assert tsp.check_nola("hann", 128, 64) == ss.check_NOLA("hann", 128, 64)
    assert tsp.check_nola("boxcar", 64, 0) == ss.check_NOLA("boxcar", 64, 0)
    w = np.zeros(64)
    w[:16] = 1.0
    assert tsp.check_nola(w, 64, 16) == ss.check_NOLA(w, 64, 16) == jsp.check_nola(w, 64, 16)
    assert tsp.check_nola(torch.as_tensor(w), 64, 16) == ss.check_NOLA(w, 64, 16)


def test_stft_exports():
    assert tft.stft is tsp.stft and tft.istft is tsp.istft
    assert tft.check_cola is tsp.check_cola and tft.check_nola is tsp.check_nola
    assert tft.StftPlan is tsp.StftPlan and tft.welch is tsp.welch


# -- PSD family ----------------------------------------------------------------------


@pytest.mark.parametrize("scaling", ["density", "spectrum"])
@pytest.mark.parametrize("average", ["mean", "median"])
def test_welch_vs_scipy(scaling, average):
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(4000).astype(np.float32)
    kw = dict(fs=8.0, nperseg=256, scaling=scaling, average=average)
    f, p = _cpu("welch")(x, **kw)
    fw, pw = ss.welch(x.astype(np.float64), **kw)
    np.testing.assert_allclose(f, fw)
    _gate(p, jsp.welch(x, **kw)[1], pw, PSD)


def test_welch_median_even_segments():
    """np.median over an even segment count averages the two middle values
    (torch.median would take the lower one): 30 segments here."""
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((2, 31 * 64)).astype(np.float32)
    kw = dict(nperseg=128, average="median")
    assert ss.welch(x[0], **kw)[1].shape == (65,)
    assert len(ss.spectrogram(x[0], nperseg=128, noverlap=64)[1]) == 30
    _gate(_cpu("welch")(x, **kw)[1], jsp.welch(x, **kw)[1],
          ss.welch(x.astype(np.float64), **kw)[1], PSD)
    y = rng.standard_normal(31 * 64).astype(np.float32)
    _gate(_cpu("csd")(x[0], y, **kw)[1], jsp.csd(x[0], y, **kw)[1],
          ss.csd(x[0].astype(np.float64), y.astype(np.float64), **kw)[1], PSD)


def test_welch_options_vs_scipy():
    rng = np.random.default_rng(RNG_SEED)
    x = (rng.standard_normal(3000) + 2.5).astype(np.float32)
    for kw in (
        dict(nperseg=200, noverlap=150),
        dict(nperseg=128, nfft=256),
        dict(nperseg=128, detrend="linear"),
        dict(nperseg=128, detrend=False),
        dict(nperseg=127, window="hamming"),  # odd nperseg (Nyquist handling)
    ):
        f, p = _cpu("welch")(x, **kw)
        fw, pw = ss.welch(x.astype(np.float64), **kw)
        np.testing.assert_allclose(f, fw)
        _gate(p, jsp.welch(x, **kw)[1], pw, PSD)


def test_welch_complex_twosided():
    rng = np.random.default_rng(RNG_SEED)
    x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)).astype(np.complex64)
    f, p = _cpu("welch")(x, nperseg=256)
    fw, pw = ss.welch(x.astype(np.complex128), nperseg=256)
    np.testing.assert_allclose(f, fw)
    _gate(p, jsp.welch(x, nperseg=256)[1], pw, PSD)


def test_welch_c128():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((2, 3000)) + 7.0
    f, p = _cpu("welch")(x, nperseg=256)
    assert p.dtype == np.float64
    _gate(p, jsp.welch(x, nperseg=256)[1], ss.welch(x, nperseg=256)[1], C128, double=True)


def test_csd_and_coherence_vs_scipy():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(4000).astype(np.float32)
    y = (np.roll(x, 3) + 0.4 * rng.standard_normal(4000).astype(np.float32)).astype(
        np.float32)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    f, pxy = _cpu("csd")(x, y, fs=2.0, nperseg=256)
    assert pxy.dtype.kind == "c"
    _gate(pxy, jsp.csd(x, y, fs=2.0, nperseg=256)[1],
          ss.csd(x64, y64, fs=2.0, nperseg=256)[1], PSD)
    _gate(_cpu("coherence")(x, y, nperseg=256)[1], jsp.coherence(x, y, nperseg=256)[1],
          ss.coherence(x64, y64, nperseg=256)[1], PSD)
    # unequal lengths: shorter zero-padded
    _gate(_cpu("csd")(x, y[:3000], nperseg=256)[1], jsp.csd(x, y[:3000], nperseg=256)[1],
          ss.csd(x64, y64[:3000], nperseg=256)[1], PSD)


def test_periodogram_vs_scipy():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(1024).astype(np.float32)
    x64 = x.astype(np.float64)
    f, p = _cpu("periodogram")(x, fs=5.0)
    fw, pw = ss.periodogram(x64, fs=5.0)
    np.testing.assert_allclose(f, fw)
    _gate(p, jsp.periodogram(x, fs=5.0)[1], pw, PSD)
    kw = dict(window="hann", nfft=2048)
    _gate(_cpu("periodogram")(x, **kw)[1], jsp.periodogram(x, **kw)[1],
          ss.periodogram(x64, **kw)[1], PSD)


@pytest.mark.parametrize("mode", ["psd", "complex", "magnitude", "angle", "phase"])
def test_spectrogram_vs_scipy(mode):
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(3000).astype(np.float32)
    f, t, s = _cpu("spectrogram")(x, fs=100.0, nperseg=256, mode=mode)
    fw, tw, sw = ss.spectrogram(x.astype(np.float64), fs=100.0, nperseg=256, mode=mode)
    np.testing.assert_allclose(f, fw)
    np.testing.assert_allclose(t, tw)
    tol = 2e-3 if mode in ("angle", "phase") else PSD
    _gate(s, jsp.spectrogram(x, fs=100.0, nperseg=256, mode=mode)[2], sw, tol)


def test_welch_batched():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((4, 2000)).astype(np.float32)
    _gate(_cpu("welch")(x, nperseg=256)[1], jsp.welch(x, nperseg=256)[1],
          ss.welch(x.astype(np.float64), nperseg=256)[1], PSD)


def test_tensor_io():
    rng = np.random.default_rng(RNG_SEED)
    x = torch.as_tensor(rng.standard_normal((2, 700)).astype(np.float32))
    f, t, z = tsp.stft(x, nperseg=64)
    assert isinstance(z, torch.Tensor) and isinstance(f, np.ndarray)
    f, p = tsp.welch(x, nperseg=64)
    assert isinstance(p, torch.Tensor) and p.dtype == torch.float32
    assert _rel(p.numpy(), ss.welch(x.double().numpy(), nperseg=64)[1]) < PSD


# -- StftPlan ---------------------------------------------------------------------------


def test_stft_plan_matches_host_stft():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((3, 1000)).astype(np.float32)
    plan = tsp.StftPlan(128, hop=64, device="cpu")
    re, im = plan.stft_planar(torch.as_tensor(x))
    got = re.numpy() + 1j * im.numpy()
    fw, tw, zw = ss.stft(x.astype(np.float64), nperseg=128, noverlap=64,
                         boundary=None, padded=False)
    jre, jim = jsp.StftPlan(128, hop=64).stft_planar(x)
    _gate(got, np.asarray(jre) + 1j * np.asarray(jim), np.moveaxis(zw, -1, -2))
    np.testing.assert_allclose(plan.f(), fw)
    np.testing.assert_allclose(plan.t(1000), tw)


def test_stft_plan_roundtrip():
    rng = np.random.default_rng(RNG_SEED)
    plan = tsp.StftPlan(256, hop=64, window="hann", device="cpu")
    n = plan.n_samples(20)
    x = rng.standard_normal((2, n)).astype(np.float32)
    back = plan.istft_planar(*plan.stft_planar(torch.as_tensor(x))).numpy()
    assert back.shape == x.shape
    core = slice(256, n - 256)
    assert _rel(back[:, core], x[:, core]) < C64
    jplan = jsp.StftPlan(256, hop=64, window="hann")
    jback = np.asarray(jplan.istft_planar(*jplan.stft_planar(x)))
    assert _rel(back[:, core], jback[:, core]) < 2 * C64


def test_stft_plan_twosided_complex():
    rng = np.random.default_rng(RNG_SEED)
    plan = tsp.StftPlan(64, hop=16, onesided=False, device="cpu")
    x = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(np.complex64)
    xr, xi = x.real.astype(np.float32), x.imag.astype(np.float32)
    re, im = plan.stft_planar(torch.as_tensor(xr), torch.as_tensor(xi))
    got = re.numpy() + 1j * im.numpy()
    fw, tw, zw = ss.stft(x.astype(np.complex128), nperseg=64, noverlap=48,
                         boundary=None, padded=False, return_onesided=False)
    jplan = jsp.StftPlan(64, hop=16, onesided=False)
    jre, jim = jplan.stft_planar(xr, xi)
    _gate(got, np.asarray(jre) + 1j * np.asarray(jim), np.moveaxis(zw, -1, -2))
    rre, rim = plan.istft_planar(re, im)
    back = rre.numpy() + 1j * rim.numpy()
    core = slice(64, 512 - 64)
    assert _rel(back[core], x[core].astype(np.complex128)) < C64
    jr, ji = jplan.istft_planar(jre, jim)
    assert _rel(back, np.asarray(jr) + 1j * np.asarray(ji)) < 2 * C64


def test_stft_plan_module_and_validation():
    """In place of the JAX package's pytree test: the windows are buffers
    that state_dict holds and .to() moves; the geometry and the checks."""
    plan = tsp.StftPlan(64, hop=32, nfft=128, device="cpu")
    jplan = jsp.StftPlan(64, hop=32, nfft=128)
    assert set(plan.state_dict()) == {"win", "win_inv"}
    assert plan.to("cpu") is plan and plan.device.type == "cpu"
    other = tsp.StftPlan(64, hop=32, nfft=128, window="boxcar", device="cpu")
    other.load_state_dict(plan.state_dict())
    assert torch.equal(other.win, plan.win)
    assert "StftPlan" in repr(plan) and "nperseg=64" in repr(plan)
    assert plan.n_bins == jplan.n_bins == 65
    assert plan.n_frames(128) == jplan.n_frames(128) == 3
    assert plan.n_samples(3) == 128
    with pytest.raises(ValueError):
        tsp.StftPlan(64, hop=0, device="cpu")
    with pytest.raises(ValueError):
        tsp.StftPlan(64, nfft=32, device="cpu")
    with pytest.raises(ValueError):
        plan.n_frames(32)
    bad = tsp.StftPlan(64, hop=64, window=np.r_[np.ones(16), np.zeros(48)], device="cpu")
    assert not bad.invertible
    with pytest.raises(ValueError, match="NOLA"):
        bad.istft_planar(torch.zeros(2, 65), torch.zeros(2, 65))


def test_stft_plan_onesided_c128():
    """The one-sided complex128 plan (refused by the JAX package off x64,
    run there on the CPU with x64 on) runs here: against scipy and the JAX
    package at 1e-12."""
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((2, 700))
    plan = tsp.StftPlan(96, hop=24, nfft=128, dtype=np.complex128, device="cpu")
    re, im = plan.stft_planar(torch.as_tensor(x))
    assert re.dtype == torch.float64
    zw = ss.stft(x, nperseg=96, noverlap=72, nfft=128, boundary=None, padded=False)[2]
    jre, jim = jsp.StftPlan(96, hop=24, nfft=128, dtype=np.complex128).stft_planar(x)
    _gate(re.numpy() + 1j * im.numpy(), np.asarray(jre) + 1j * np.asarray(jim),
          np.moveaxis(zw, -1, -2), C128, double=True)
    back = plan.istft_planar(re, im).numpy()
    n = plan.n_samples(re.shape[-2])
    assert back.shape == (2, n)
    assert _rel(back[:, 96:n - 96], x[:, 96:n - 96]) < C128


@pytest.mark.parametrize("onesided", [True, False])
def test_stft_plan_gradcheck_c128(onesided):
    """torch.autograd.gradcheck through stft_planar and istft_planar on f64
    planes (framing, window, the plans' linear rules, the fold)."""
    rng = np.random.default_rng(RNG_SEED)
    plan = tsp.StftPlan(8, hop=2, nfft=10, dtype=np.complex128, onesided=onesided,
                        device="cpu")
    x = torch.tensor(rng.standard_normal((2, 21)), requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: plan.stft_planar(t), (x,))
    bins = plan.n_bins
    re = torch.tensor(rng.standard_normal((2, 7, bins)), requires_grad=True)
    im = torch.tensor(rng.standard_normal((2, 7, bins)), requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: plan.istft_planar(a, b), (re, im))


# -- the routes a card takes ------------------------------------------------------------


@pytest.fixture
def card_routes(monkeypatch):
    """spectral.py on the routes a card takes (complex64: backend "vpu";
    complex128: "dd"), here on the kernels' plain versions."""
    def route(dtype):
        return "vpu" if dtype == torch.complex64 else "dd"

    monkeypatch.setattr(tsp, "_rfft_plan", lambda n, dtype, device: RfftPlan(
        n, dtype, backend=route(dtype), device=device))
    monkeypatch.setattr(tsp, "create_fft", lambda n, dtype, *, device, cache=True:
                        tft.create_fft(n, dtype, backend=route(dtype), device=device,
                                       cache=False))
    monkeypatch.setattr(tsp, "RfftPlan", lambda n, dtype, device: RfftPlan(
        n, dtype, backend=route(dtype), device=device))


@pytest.mark.parametrize("nperseg", [256, 769])
def test_spectral_on_card_routes(card_routes, nperseg):
    """stft/istft, StftPlan and welch through B4a/B4b (nfft 256: m = 128
    over B1) and B5a/B5b (nfft 769 over B2, inner 2048), and the two-sided
    c2c plan; f64 welch on the dd route (B6 at 128)."""
    plan = RfftPlan(nperseg, torch.complex64, backend="vpu", device="cpu")
    assert plan.fused
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((2, 4 * nperseg)).astype(np.float32)
    x64 = x.astype(np.float64)
    kw = dict(nperseg=nperseg)
    f, t, z = _cpu("stft")(x, **kw)
    _gate(z, jsp.stft(x, **kw)[2], ss.stft(x64, **kw)[2])
    back = _cpu("istft")(z, **kw)[1]
    assert _rel(back[..., :x.shape[-1]], x64) < C64
    _gate(_cpu("welch")(x, **kw)[1], jsp.welch(x, **kw)[1], ss.welch(x64, **kw)[1], PSD)
    sp = tsp.StftPlan(nperseg, device="cpu")
    re, im = sp.stft_planar(torch.as_tensor(x))
    zw = ss.stft(x64, nperseg=nperseg, noverlap=nperseg - sp.hop, boundary=None,
                 padded=False)[2]
    assert _rel(re.numpy() + 1j * im.numpy(), np.moveaxis(zw, -1, -2)) < C64
    xc = (x + 1j * x[::-1]).astype(np.complex64)
    _gate(_cpu("welch")(xc, **kw)[1], jsp.welch(xc, **kw)[1],
          ss.welch(xc.astype(np.complex128), **kw)[1], PSD)
    if nperseg == 256:
        _gate(_cpu("welch")(x64, **kw)[1], jsp.welch(x64, **kw)[1],
              ss.welch(x64, **kw)[1], C128, double=True)


def test_stft_plan_refuses_another_device():
    """A plane on another device than the plan's raises; numpy is copied to
    the plan's device."""
    plan = tsp.StftPlan(16, hop=8, device="cpu")
    with pytest.raises(ValueError, match="plan on cpu"):
        plan.stft_planar(torch.zeros(64, device="meta"))
    with pytest.raises(ValueError, match="plan on cpu"):
        plan.istft_planar(torch.zeros(3, 9, device="meta"), torch.zeros(3, 9))
    re, _ = plan.stft_planar(np.ones(64, np.float32))
    assert isinstance(re, torch.Tensor) and re.device.type == "cpu"
