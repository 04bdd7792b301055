"""The port's signal.py against the JAX package and scipy.signal.

Counterparts of every test of ``tests/test_signal.py`` and of the chirp-z
tests of ``tests/test_czt.py``. Inputs are made from a seed with numpy and
run through the JAX functions (on the CPU, x64 on, as those tests run them)
and the port's (``device="cpu"``). Gates, rel-L2 over the whole array: each
reference test's own gate against scipy (1e-5 for complex64, 1e-12 or
1e-13 for complex128), and against the JAX package twice that gate for
complex64 and the same gate for complex128. The JAX package's jit and pytree
tests become ``nn.Module`` tests, its double-word tests native-f64 tests at
the same gate. ``card_routes`` runs the functions on the routes a card
takes (backend "vpu" / "dd"), here on the kernels' plain versions.
"""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import fourier_tpu as jft
from fourier_tpu import signal as jsig

import fourier_tpu_torch as tft
from fourier_tpu_torch import signal as tsig
from fourier_tpu_torch.plan.base import complex_dtype

RNG_SEED = 0xC0
C64, C128 = 1e-5, 1e-12


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _gate(port, jax_out, want, tol=C64, double=False):
    """The port within `tol` of scipy and within 2*tol (complex64) or `tol`
    (complex128) of the JAX package."""
    port = np.asarray(port)
    assert port.shape == np.shape(want)
    assert _rel(port, want) < tol
    assert _rel(port, jax_out) < (tol if double else 2 * tol)


def _cpu(name):
    fn = getattr(tsig, name)
    return lambda *a, **kw: fn(*a, device="cpu", **kw)


def _allclose(port, jax_out, want, frac):
    """The ConvolvePlan tests' gate: max abs error within frac*max|want|
    against scipy, 2*frac against the JAX package."""
    scale = np.abs(want).max()
    np.testing.assert_allclose(port, want, rtol=0, atol=frac * scale)
    np.testing.assert_allclose(port, jax_out, rtol=0, atol=2 * frac * scale)


# -- next_fast_len / prev_fast_len ---------------------------------------------


def test_next_fast_len_values():
    cases = {1: 1, 2: 2, 5: 6, 7: 8, 9: 9, 13: 16, 17: 18, 97: 108,
             1000: 1024, 1025: 1152, 2917: 3072}
    for n, want in cases.items():
        assert tsig.next_fast_len(n) == want == jsig.next_fast_len(n), n


def test_next_fast_len_is_fast_family():
    for n in range(1, 700):
        m = tsig.next_fast_len(n)
        assert m >= n and m == jsig.next_fast_len(n)
        r = m
        while r % 2 == 0:
            r //= 2
        while r % 3 == 0:
            r //= 3
        assert r == 1, (n, m)


def test_prev_fast_len():
    cases = {1: 1, 2: 2, 5: 4, 7: 6, 9: 9, 13: 12, 17: 16, 100: 96,
             1000: 972, 1025: 1024}
    for n, want in cases.items():
        assert tsig.prev_fast_len(n) == want, n
    for n in range(1, 500):
        m = tsig.prev_fast_len(n)
        assert 1 <= m <= n and m == jsig.prev_fast_len(n)
        r = m
        while r % 2 == 0:
            r //= 2
        while r % 3 == 0:
            r //= 3
        assert r == 1
    with pytest.raises(ValueError):
        tsig.prev_fast_len(0)


# -- fftconvolve -----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fftconvolve_1d_real(mode):
    rng = np.random.default_rng(RNG_SEED)
    a = rng.standard_normal(100).astype(np.float32)
    b = rng.standard_normal(17).astype(np.float32)
    got = _cpu("fftconvolve")(a, b, mode)
    assert got.dtype == np.float32
    _gate(got, jsig.fftconvolve(a, b, mode), ss.fftconvolve(a, b, mode))


def test_fftconvolve_1d_complex():
    rng = np.random.default_rng(RNG_SEED)
    a = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(np.complex64)
    b = (rng.standard_normal(31) + 1j * rng.standard_normal(31)).astype(np.complex64)
    got = _cpu("fftconvolve")(a, b)
    assert np.iscomplexobj(got)
    _gate(got, jsig.fftconvolve(a, b), ss.fftconvolve(a, b))


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fftconvolve_2d(mode):
    rng = np.random.default_rng(RNG_SEED)
    a = rng.standard_normal((20, 30)).astype(np.float32)
    b = rng.standard_normal((5, 7)).astype(np.float32)
    _gate(_cpu("fftconvolve")(a, b, mode), jsig.fftconvolve(a, b, mode),
          ss.fftconvolve(a, b, mode))


def test_fftconvolve_batched_axes():
    rng = np.random.default_rng(RNG_SEED)
    a = rng.standard_normal((4, 50)).astype(np.float32)
    b = rng.standard_normal((4, 9)).astype(np.float32)
    _gate(_cpu("fftconvolve")(a, b, "same", axes=1),
          jsig.fftconvolve(a, b, "same", axes=1),
          ss.fftconvolve(a, b, "same", axes=1))


def test_fftconvolve_c128():
    rng = np.random.default_rng(RNG_SEED)
    a = rng.standard_normal(100)
    b = rng.standard_normal(17)
    got = _cpu("fftconvolve")(a, b, dtype=np.complex128)
    assert got.dtype == np.float64
    _gate(got, jsig.fftconvolve(a, b, dtype=np.complex128), ss.fftconvolve(a, b),
          C128, double=True)


@pytest.fixture
def card_routes(monkeypatch):
    """signal.py on the routes a card takes (complex64: backend "vpu";
    complex128: "dd"), here on the kernels' plain versions."""
    def route(dtype):
        return "vpu" if complex_dtype(dtype) == torch.complex64 else "dd"

    def create(n, dtype=torch.complex64, *, backend="auto", device, cache=True):
        return tft.create_fft(n, dtype, device=device, cache=False,
                              backend=route(dtype) if backend == "auto" else backend)

    monkeypatch.setattr(tsig, "create_fft", create)
    monkeypatch.setattr(tsig, "_axis_plans", lambda sizes, dtype, device: [
        create(n, dtype, device=device) for n in sizes])
    monkeypatch.setattr(tsig, "_CZT_CACHE", type(tsig._CZT_CACHE)())


def test_fftconvolve_c128_dd_path(card_routes, monkeypatch):
    """The c128 route a card takes (backend "dd": B6 at 72, the plain f64
    version here), as the JAX package's test forces its dd branch."""
    from fourier_tpu import ndim

    rng = np.random.default_rng(RNG_SEED)
    monkeypatch.setattr(jsig, "_nd_plan", lambda shape, dtype: ndim.NdFftPlan(
        shape, dtype, backend="dd"))
    a = rng.standard_normal(60)
    b = rng.standard_normal(13)
    _gate(_cpu("fftconvolve")(a, b, dtype=np.complex128),
          jsig.fftconvolve(a, b, dtype=np.complex128), ss.fftconvolve(a, b),
          C128, double=True)


def test_fftconvolve_validation():
    conv = _cpu("fftconvolve")
    with pytest.raises(ValueError):
        conv(np.zeros((2, 3)), np.zeros(3))  # rank mismatch
    with pytest.raises(ValueError):
        conv(np.zeros((2, 8)), np.zeros((3, 8)), axes=1)  # batch axis
    with pytest.raises(ValueError):
        conv(np.zeros(4), np.zeros(9), mode="valid")  # in2 > in1
    with pytest.raises(ValueError):
        conv(np.zeros(4), np.zeros(4), mode="bogus")


def test_exports():
    assert tft.fftconvolve is tsig.fftconvolve
    assert tft.next_fast_len is tsig.next_fast_len
    assert tft.ConvolvePlan is tsig.ConvolvePlan and tft.CztPlan is tsig.CztPlan


def test_tensor_io():
    """A tensor input runs on its own device and gives a tensor; numpy in,
    numpy out."""
    rng = np.random.default_rng(RNG_SEED)
    a = rng.standard_normal((3, 40)).astype(np.float32)
    b = rng.standard_normal((3, 7)).astype(np.float32)
    got = tft.fftconvolve(torch.as_tensor(a), b, axes=-1)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert _rel(got.numpy(), ss.fftconvolve(a, b, axes=-1)) < C64
    h = tft.hilbert(torch.as_tensor(a))
    assert isinstance(h, torch.Tensor) and h.dtype == torch.complex64
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tft.fftconvolve(a, b, axes=-1)


# -- oaconvolve ------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_oaconvolve_1d_real(mode):
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(4000).astype(np.float32)
    h = rng.standard_normal(31).astype(np.float32)
    got = _cpu("oaconvolve")(x, h, mode)
    assert got.dtype.kind == "f"
    _gate(got, jsig.oaconvolve(x, h, mode),
          ss.oaconvolve(x.astype(np.float64), h.astype(np.float64), mode))


def test_oaconvolve_swapped_and_complex():
    rng = np.random.default_rng(RNG_SEED)
    # in2 is the long side (the split must land on in2)
    h = (rng.standard_normal(17) + 1j * rng.standard_normal(17)).astype(np.complex64)
    x = (rng.standard_normal(3000) + 1j * rng.standard_normal(3000)).astype(np.complex64)
    got = _cpu("oaconvolve")(h, x)
    assert got.dtype.kind == "c"
    _gate(got, jsig.oaconvolve(h, x),
          ss.oaconvolve(h.astype(np.complex128), x.astype(np.complex128)))


@pytest.mark.parametrize("mode", ["full", "same"])
def test_oaconvolve_2d(mode):
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((300, 257)).astype(np.float32)
    h = rng.standard_normal((7, 5)).astype(np.float32)
    _gate(_cpu("oaconvolve")(x, h, mode), jsig.oaconvolve(x, h, mode),
          ss.oaconvolve(x.astype(np.float64), h.astype(np.float64), mode))


def test_oaconvolve_batched_axes():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((3, 2000)).astype(np.float32)
    h = rng.standard_normal((3, 9)).astype(np.float32)
    _gate(_cpu("oaconvolve")(x, h, "full", axes=-1),
          jsig.oaconvolve(x, h, "full", axes=-1),
          ss.oaconvolve(x.astype(np.float64), h.astype(np.float64), "full", axes=-1))


def test_oaconvolve_equal_sizes_falls_back():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(128).astype(np.float32)
    h = rng.standard_normal(128).astype(np.float32)
    got = _cpu("oaconvolve")(x, h)
    np.testing.assert_allclose(got, _cpu("fftconvolve")(x, h), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jsig.oaconvolve(x, h), rtol=0, atol=2e-5)


def test_oaconvolve_c128():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(2500)
    h = rng.standard_normal(21)
    _gate(_cpu("oaconvolve")(x, h, dtype=np.complex128),
          jsig.oaconvolve(x, h, dtype=np.complex128), ss.oaconvolve(x, h),
          C128, double=True)


def test_oaconvolve_validation():
    with pytest.raises(ValueError):
        _cpu("oaconvolve")(np.zeros((2, 3), np.float32), np.zeros(3, np.float32))
    with pytest.raises(ValueError):
        _cpu("oaconvolve")(np.zeros((2, 100), np.float32),
                           np.zeros((3, 5), np.float32), axes=-1)


# -- analytic signal / resample / correlation ------------------------------------


@pytest.mark.parametrize("n", [64, 100, 101])
def test_hilbert_vs_scipy(n):
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((2, n)).astype(np.float32)
    _gate(_cpu("hilbert")(x), jsig.hilbert(x), ss.hilbert(x.astype(np.float64)))
    # envelope of a tone is ~constant
    tt = np.arange(512) / 512.0
    tone = np.cos(2 * np.pi * 50 * tt).astype(np.float32)
    env = np.abs(_cpu("hilbert")(tone))
    assert np.all(np.abs(env[32:-32] - 1.0) < 0.02)


def test_hilbert_n_and_validation():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(100)
    x32 = x.astype(np.float32)
    _gate(_cpu("hilbert")(x32, 150), jsig.hilbert(x32, 150), ss.hilbert(x, 150))
    with pytest.raises(ValueError):
        _cpu("hilbert")(x.astype(np.complex64))
    with pytest.raises(ValueError):
        _cpu("hilbert")(x, 0)


def test_hilbert2_vs_scipy():
    rng = np.random.default_rng(RNG_SEED)
    img = rng.standard_normal((24, 37))
    i32 = img.astype(np.float32)
    _gate(_cpu("hilbert2")(i32), jsig.hilbert2(i32), ss.hilbert2(img))
    _gate(_cpu("hilbert2")(i32, (32, 32)), jsig.hilbert2(i32, (32, 32)),
          ss.hilbert2(img, (32, 32)))
    b = rng.standard_normal((3, 16, 18))
    b32 = b.astype(np.float32)
    _gate(_cpu("hilbert2")(b32, axes=(1, 2)), jsig.hilbert2(b32, axes=(1, 2)),
          ss.hilbert2(b, axes=(1, 2)))
    with pytest.raises(ValueError):
        _cpu("hilbert2")(img.astype(np.complex64))
    with pytest.raises(ValueError):
        _cpu("hilbert2")(img, axes=(0, 0))


@pytest.mark.parametrize("n,num", [
    (100, 50), (100, 51), (101, 50), (100, 200), (100, 201), (101, 202),
    (128, 128),
])
def test_resample_vs_scipy(n, num):
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(n)
    x32 = x.astype(np.float32)
    got = _cpu("resample")(x32, num)
    assert got.dtype.kind == "f"
    _gate(got, jsig.resample(x32, num), ss.resample(x, num))
    xc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    xc64 = xc.astype(np.complex64)
    _gate(_cpu("resample")(xc64, num), jsig.resample(xc64, num), ss.resample(xc, num))


def test_resample_window_t_and_domain():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(120)
    x32 = x.astype(np.float32)
    t = np.arange(120) * 0.25
    got, gt = _cpu("resample")(x32, 80, t=t, window="hamming")
    jgot, _ = jsig.resample(x32, 80, t=t, window="hamming")
    want, wt = ss.resample(x, 80, t=t, window="hamming")
    _gate(got, jgot, want)
    np.testing.assert_allclose(gt, wt)
    wf = lambda f: np.exp(-8.0 * f * f)
    _gate(_cpu("resample")(x32, 80, window=wf), jsig.resample(x32, 80, window=wf),
          ss.resample(x, 80, window=wf))
    spec = np.fft.fft(x)
    s64 = spec.astype(np.complex64)
    _gate(_cpu("resample")(s64, 80, domain="freq"),
          jsig.resample(s64, 80, domain="freq"), ss.resample(spec, 80, domain="freq"))
    # batched along axis 0 (scipy's default axis)
    xb = rng.standard_normal((100, 3))
    xb32 = xb.astype(np.float32)
    _gate(_cpu("resample")(xb32, 64, axis=0), jsig.resample(xb32, 64, axis=0),
          ss.resample(xb, 64, axis=0))
    with pytest.raises(ValueError):
        _cpu("resample")(x, 0)
    with pytest.raises(ValueError):
        _cpu("resample")(x, 50, domain="nope")


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_correlate_vs_scipy(mode):
    rng = np.random.default_rng(RNG_SEED)
    a = rng.standard_normal(300).astype(np.float32)
    b = rng.standard_normal(41).astype(np.float32)
    _gate(_cpu("correlate")(a, b, mode), jsig.correlate(a, b, mode),
          ss.correlate(a.astype(np.float64), b.astype(np.float64), mode, method="fft"))
    np.testing.assert_array_equal(tsig.correlation_lags(300, 41, mode),
                                  ss.correlation_lags(300, 41, mode))
    np.testing.assert_array_equal(tsig.correlation_lags(300, 41, mode),
                                  jsig.correlation_lags(300, 41, mode))


def test_correlate_complex_conjugation():
    rng = np.random.default_rng(RNG_SEED)
    a = (rng.standard_normal(128) + 1j * rng.standard_normal(128)).astype(np.complex64)
    b = (rng.standard_normal(32) + 1j * rng.standard_normal(32)).astype(np.complex64)
    _gate(_cpu("correlate")(a, b), jsig.correlate(a, b),
          ss.correlate(a.astype(np.complex128), b.astype(np.complex128), method="fft"))
    # peak finds the embedded template
    sig = np.zeros(256, np.float32)
    sig[100:132] = b.real
    lag = np.argmax(np.abs(_cpu("correlate")(sig, b.real)))
    assert tsig.correlation_lags(256, 32)[lag] == 100


# -- chirp z-transform (the czt part of tests/test_czt.py) -----------------------


RNG_CZT = 0xC27


def _randc(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _czt_gate(port, jax_out, want, tol):
    """test_czt.py's gate, ||port - want|| <= tol * max(||want||, 1), and the
    same against the JAX package (complex128)."""
    scale = max(np.linalg.norm(want), 1.0)
    assert np.linalg.norm(port - want) <= tol * scale
    assert np.linalg.norm(port - jax_out) <= tol * scale


@pytest.mark.parametrize("n,m", [(16, 16), (17, 31), (64, 7), (100, 100),
                                 (1, 5), (5, 1)])
def test_czt_default_w(n, m):
    x = _randc(np.random.default_rng(RNG_CZT + n * 131 + m), (3, n))
    _czt_gate(_cpu("czt")(x, m), jft.czt(x, m), ss.czt(x, m), 1e-12)


def test_czt_equals_fft():
    x = _randc(np.random.default_rng(RNG_CZT), (64,))
    got = _cpu("czt")(x)
    assert np.allclose(got, np.fft.fft(x), rtol=0, atol=1e-12)
    assert np.allclose(got, jft.czt(x), rtol=0, atol=1e-12)


@pytest.mark.parametrize("w,a", [
    (np.exp(-2j * np.pi * 0.007), 1 + 0j),          # unit-|w| off-grid
    (np.exp(-2j * np.pi / 40), np.exp(0.3j)),       # rotated start point
])
def test_czt_unit_w(w, a):
    n, m = 50, 23
    x = _randc(np.random.default_rng(RNG_CZT + 1), (n,))
    want = ss.czt(x, m, w, a)
    got = _cpu("czt")(x, m, w, a)
    assert np.linalg.norm(got - want) <= 1e-11 * np.linalg.norm(want)
    assert np.linalg.norm(got - jft.czt(x, m, w, a)) <= 1e-11 * np.linalg.norm(want)


def test_czt_nonunit_w_vs_direct():
    # |w| != 1 is inherently ill-conditioned (mag^{j^2/2} dynamic range);
    # gate against the direct O(nm) evaluation, and require parity with
    # scipy's own error and the JAX package's.
    n, m = 50, 23
    w, a = 0.98 * np.exp(-2j * np.pi / 40), 1.1 + 0.2j
    x = _randc(np.random.default_rng(RNG_CZT + 2), (n,))
    k, nn = np.arange(m), np.arange(n)
    z = a * w ** (-k)
    direct = (x[None, :] * z[:, None] ** (-nn[None, :])).sum(1)
    ours = np.linalg.norm(_cpu("czt")(x, m, w, a) - direct)
    scipys = np.linalg.norm(ss.czt(x, m, w, a) - direct)
    jaxs = np.linalg.norm(jft.czt(x, m, w, a) - direct)
    assert ours <= 2.0 * scipys + 1e-12 * np.linalg.norm(direct)
    assert ours <= 2.0 * jaxs + 1e-12 * np.linalg.norm(direct)


def test_czt_c64_dtype_and_axis():
    x = _randc(np.random.default_rng(RNG_CZT + 3), (4, 32, 2), np.complex64)
    got = _cpu("czt")(x, 20, axis=1)
    assert got.dtype == np.complex64
    want = ss.czt(x.astype(np.complex128), 20, axis=1)
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    assert np.linalg.norm(got - jft.czt(x, 20, axis=1)) <= 2e-5 * np.linalg.norm(want)


def test_zoom_fft_band():
    x = _randc(np.random.default_rng(RNG_CZT + 4), (3, 100))
    want = ss.zoom_fft(x, [0.1, 0.4], 47, fs=2)
    got = _cpu("zoom_fft")(x, [0.1, 0.4], 47, fs=2)
    assert np.linalg.norm(got - want) <= 1e-11 * np.linalg.norm(want)
    assert (np.linalg.norm(got - jft.zoom_fft(x, [0.1, 0.4], 47, fs=2))
            <= 1e-11 * np.linalg.norm(want))


def test_zoom_fft_scalar_fn_endpoint():
    x = np.random.default_rng(RNG_CZT + 5).standard_normal(64)
    want = ss.zoom_fft(x, 0.5, 33, fs=2, endpoint=True)
    got = _cpu("zoom_fft")(x, 0.5, 33, fs=2, endpoint=True)
    assert np.linalg.norm(got - want) <= 1e-11 * np.linalg.norm(want)
    jax_out = jft.zoom_fft(x, 0.5, 33, fs=2, endpoint=True)
    assert np.linalg.norm(got - jax_out) <= 1e-11 * np.linalg.norm(want)


def test_czt_plan_reuse_and_repr():
    """The plan is a module: its chirps are buffers that .to() moves and
    state_dict holds; repeated calls agree bitwise."""
    p = tsig.CztPlan(24, 10, device="cpu")
    x = _randc(np.random.default_rng(RNG_CZT + 6), (24,), np.complex64)
    a = p(x)
    assert np.array_equal(a, p(x))
    assert _rel(a, jft.CztPlan(24, 10)(x)) <= 2e-5
    assert "CztPlan" in repr(p) and "inner=" in repr(p)
    assert {"u_chirp", "y_chirp", "V"} <= set(dict(p.named_buffers()))
    assert set(p.state_dict()) >= {"u_chirp", "y_chirp", "V"}
    assert p.to("cpu") is p and p.V.device.type == "cpu" and p.V.dtype == torch.complex64
    q = tsig.CztPlan(24, 10, device="cpu")
    q.load_state_dict(p.state_dict())
    assert np.array_equal(q(x), a)


def test_czt_validation():
    with pytest.raises(ValueError):
        tsig.CztPlan(0, 4, device="cpu")
    with pytest.raises(ValueError):
        tsig.CztPlan(8, 8, device="cpu")(np.ones(7, np.complex64))


def test_czt_cache_keyed_on_device(monkeypatch):
    monkeypatch.setattr(tsig, "_CZT_CACHE", type(tsig._CZT_CACHE)())
    x = _randc(np.random.default_rng(RNG_CZT + 7), (2, 30))
    _cpu("czt")(x, 12)
    _cpu("czt")(torch.as_tensor(x), 12)
    (key,) = tsig._CZT_CACHE
    assert key[-1] == "cpu" and key[:2] == (30, 12)


# -- ConvolvePlan ------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_convolve_plan_real(mode):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(4000).astype(np.float32)
    h = rng.standard_normal(63).astype(np.float32)
    got = tsig.ConvolvePlan(h, mode=mode, device="cpu")(x)
    assert got.dtype == np.float32
    want = ss.fftconvolve(x.astype(np.float64), h.astype(np.float64), mode)
    assert got.shape == want.shape
    _allclose(got, jsig.ConvolvePlan(h, mode=mode)(x), want, 2e-4)


def test_convolve_plan_complex_batched():
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 2000)) + 1j * rng.standard_normal((3, 2000))
         ).astype(np.complex64)
    h = (rng.standard_normal(100) + 1j * rng.standard_normal(100)).astype(np.complex64)
    got = tsig.ConvolvePlan(h, mode="full", device="cpu")(x)
    want = np.stack([ss.fftconvolve(x[i].astype(np.complex128), h.astype(np.complex128))
                     for i in range(3)])
    assert got.shape == want.shape
    _allclose(got, jsig.ConvolvePlan(h, mode="full")(x), want, 5e-4)


def test_convolve_plan_module():
    """In place of the JAX package's jit/pytree test: convolve_planar runs
    on tensors end to end; the kernel spectrum is a buffer that .to() moves
    and state_dict holds."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal(1777).astype(np.float32)
    h = rng.standard_normal(31).astype(np.float32)
    plan = tsig.ConvolvePlan(h, mode="same", device="cpu")
    got = plan.convolve_planar(torch.as_tensor(x))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    want = ss.fftconvolve(x.astype(np.float64), h.astype(np.float64), "same")
    _allclose(got.numpy(), jsig.ConvolvePlan(h, mode="same")(x), want, 2e-4)
    assert set(plan.state_dict()) == {"k_re", "k_im"}
    assert plan.to("cpu") is plan and plan.device.type == "cpu"
    other = tsig.ConvolvePlan(np.zeros(31, np.float32), mode="same", device="cpu")
    other.load_state_dict(plan.state_dict())
    assert torch.equal(other.convolve_planar(torch.as_tensor(x)), got)


def test_convolve_plan_short_signal_and_edge_blocks():
    rng = np.random.default_rng(10)
    h = rng.standard_normal(17).astype(np.float32)
    plan = tsig.ConvolvePlan(h, mode="full", device="cpu")
    jplan = jsig.ConvolvePlan(h, mode="full")
    for s1 in (17, plan.step, plan.step + 1, 3 * plan.step - 1):
        x = rng.standard_normal(s1).astype(np.float32)
        want = ss.fftconvolve(x.astype(np.float64), h.astype(np.float64))
        _allclose(plan(x), jplan(x), want, 3e-4)


def test_convolve_plan_c128():
    """Native f64 on the dd route (the JAX package's double-word plan):
    the same ~1e-14 accuracy."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(900)
    h = rng.standard_normal(41)
    got = tsig.ConvolvePlan(h, mode="full", dtype=np.complex128, device="cpu")(x)
    want = ss.fftconvolve(x, h)
    assert got.dtype == np.float64
    assert _rel(got, want) < 1e-13
    assert _rel(got, jsig.ConvolvePlan(h, mode="full", dtype=np.complex128)(x)) < 1e-13


def test_convolve_plan_c128_complex_planar():
    """convolve_planar on f64 planes (the JAX package's convolve_planar_dd on
    four double-word planes)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal(500) + 1j * rng.standard_normal(500)
    h = rng.standard_normal(29) + 1j * rng.standard_normal(29)
    plan = tsig.ConvolvePlan(h, mode="same", dtype=np.complex128, device="cpu")
    ore, oim = plan.convolve_planar(torch.as_tensor(x.real), torch.as_tensor(x.imag))
    assert ore.dtype == torch.float64
    got = ore.numpy() + 1j * oim.numpy()
    want = ss.fftconvolve(x, h, "same")
    assert _rel(got, want) < 1e-13
    jax_out = jsig.ConvolvePlan(h, mode="same", dtype=np.complex128)(x)
    assert _rel(got, jax_out) < 1e-13
    # f32 planes are taken in and computed in f64
    r32 = plan.convolve_planar(torch.as_tensor(x.real.astype(np.float32)))[0]
    assert r32.dtype == torch.float64


def test_convolve_plan_grad():
    """Linear in the input: the gradient through the plan is the adjoint
    (correlation with h), as the JAX package's jax.grad gives it."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    h = rng.standard_normal(9).astype(np.float32)
    x = rng.standard_normal(200).astype(np.float32)
    w = rng.standard_normal(208).astype(np.float32)
    plan = tsig.ConvolvePlan(h, mode="full", device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    torch.dot(torch.as_tensor(w), plan.convolve_planar(xt)).backward()
    want = ss.correlate(w.astype(np.float64), h.astype(np.float64), "valid")
    jplan = jsig.ConvolvePlan(h, mode="full")
    jgrad = jax.grad(lambda xv: jnp.vdot(jnp.asarray(w), jplan.convolve_planar(xv)))(
        jnp.asarray(x))
    _allclose(xt.grad.numpy(), np.asarray(jgrad), want, 2e-4)


def test_convolve_plan_gradcheck_c128():
    """torch.autograd.gradcheck through convolve_planar on f64 planes, real
    and complex input (the frames, the plan's linear rule, the fold)."""
    rng = np.random.default_rng(14)
    plan = tsig.ConvolvePlan(rng.standard_normal(5) + 1j * rng.standard_normal(5),
                             mode="same", dtype=np.complex128, block=12, device="cpu")
    re = torch.tensor(rng.standard_normal((2, 23)), requires_grad=True)
    im = torch.tensor(rng.standard_normal((2, 23)), requires_grad=True)
    assert torch.autograd.gradcheck(lambda r, i: plan.convolve_planar(r, i), (re, im))
    assert torch.autograd.gradcheck(lambda r: plan.convolve_planar(r), (re,))


def test_convolve_plan_validation():
    with pytest.raises(ValueError):
        tsig.ConvolvePlan(np.ones((2, 2)), device="cpu")
    with pytest.raises(ValueError):
        tsig.ConvolvePlan(np.ones(8), mode="banana", device="cpu")
    with pytest.raises(ValueError):
        tsig.ConvolvePlan(np.ones(64), block=16, device="cpu")
    with pytest.raises(ValueError):
        tsig.ConvolvePlan(np.ones(8), dtype=np.float32, device="cpu")


# -- the overlap-add fold -------------------------------------------------------------


@pytest.mark.parametrize("block,advance,n", [(10, 4, 7), (12, 12, 3), (9, 2, 1), (5, 7, 4)])
def test_fold_matches_loop_and_is_deterministic(block, advance, n):
    """_fold equals the per-block loop (the reference's overlap-add) and
    gives bitwise equal results on every call."""
    rng = np.random.default_rng(15)
    y = rng.standard_normal((block, 3, n))
    want = np.zeros((3, (n - 1) * advance + block))
    for i in range(n):
        want[:, i * advance:i * advance + block] += y[:, :, i].T
    yt = torch.as_tensor(y)
    got = tsig._fold(yt, advance)
    assert got.shape[-1] >= want.shape[-1]
    np.testing.assert_allclose(got[:, :want.shape[-1]].numpy(), want, rtol=0, atol=1e-12)
    assert not got[:, want.shape[-1]:].any()
    assert all(torch.equal(tsig._fold(yt, advance), got) for _ in range(3))


# -- the routes a card takes ------------------------------------------------------------


def test_signal_on_card_routes(card_routes):
    """One case of each part of signal.py on the card's routes: fftconvolve
    and ConvolvePlan through B1 (n = 72), hilbert at n = 1013 through
    B2 (inner 2048), czt at inner 48 (a DFT product), resample through a
    DFT product; c128 fftconvolve through B6 (72)."""
    rng = np.random.default_rng(RNG_SEED)
    a = rng.standard_normal((3, 60)).astype(np.float32)
    b = rng.standard_normal((3, 13)).astype(np.float32)
    _gate(_cpu("fftconvolve")(a, b, axes=-1), jsig.fftconvolve(a, b, axes=-1),
          ss.fftconvolve(a, b, axes=-1))
    ad, bd = a.astype(np.float64), b.astype(np.float64)
    _gate(_cpu("fftconvolve")(ad, bd, axes=-1, dtype=np.complex128),
          jsig.fftconvolve(ad, bd, axes=-1, dtype=np.complex128),
          ss.fftconvolve(ad, bd, axes=-1), C128, double=True)
    x = rng.standard_normal(500).astype(np.float32)
    h = rng.standard_normal(9).astype(np.float32)
    plan = tsig.ConvolvePlan(h, block=72, device="cpu")
    assert type(plan.inner).__name__ == "VpuFftPlan"
    want = ss.fftconvolve(x.astype(np.float64), h.astype(np.float64))
    _allclose(plan(x), jsig.ConvolvePlan(h, block=72)(x), want, 2e-4)
    xh = rng.standard_normal((2, 1013)).astype(np.float32)
    assert type(tsig.create_fft(1013, torch.complex64, device="cpu")).__name__ == \
        "VpuBluesteinPlan"
    _gate(_cpu("hilbert")(xh), jsig.hilbert(xh), ss.hilbert(xh.astype(np.float64)))
    xc = _randc(rng, (2, 30), np.complex64)
    _gate(_cpu("czt")(xc, 19), jft.czt(xc, 19), ss.czt(xc.astype(np.complex128), 19))
    xr = rng.standard_normal((2, 90)).astype(np.float32)
    _gate(_cpu("resample")(xr, 60), jsig.resample(xr, 60),
          ss.resample(xr.astype(np.float64), 60, axis=-1))



def test_inputs_on_two_devices_raise():
    """Tensors on two devices raise: nothing is moved to another device
    behind the caller's back (a numpy input goes to the tensor's device)."""
    with pytest.raises(ValueError, match="in2 on meta"):
        tft.fftconvolve(torch.zeros(8), torch.zeros(3, device="meta"))
    with pytest.raises(ValueError, match="in2 on meta"):
        tft.correlate(torch.zeros(8), torch.zeros(3, device="meta"))
    got = tft.fftconvolve(torch.ones(8), np.ones(3))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
