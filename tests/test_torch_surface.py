"""The port's numpy-compatible surface beyond the c2c N-D transforms: the
N-D real and Hermitian family (rfftn ... ihfft2), the fast Hankel transform
(fht/ifht/fhtoffset), the exports, and the rule that the port never imports
JAX or the JAX package.

Inputs are made from a seed with numpy and run through the JAX functions (on
the CPU, x64 on, as ``tests/test_rfft.py`` and ``tests/test_czt.py`` run
them) and the port's (``device="cpu"``). Gates, rel-L2 over the whole array,
k the number of transformed axes: complex64 <= 1e-6*sqrt(k) against
numpy/scipy in f64 and <= 2e-6*sqrt(k) against the JAX package; complex128
and f64 <= 1e-12 (the FFTLog tests keep ``tests/test_czt.py``'s 1e-11 and
1e-10, the coefficient table's own error).
"""

import ast
import pathlib
import subprocess
import sys
from collections import OrderedDict

import numpy as np
import pytest
import scipy.fft as sfft
import torch

import fourier_tpu as jft

import fourier_tpu_torch as tft
from fourier_tpu_torch.rfft import RfftPlan

REPO = pathlib.Path(__file__).resolve().parents[1]
RNG_SEED = 0xB4B5
C64_NP, C64_JAX, C128 = 1e-6, 2e-6, 1e-12


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _gate(port, jax_out, want, k, double=False):
    if double:
        assert _rel(port, want) <= C128 and _rel(port, jax_out) <= C128
    else:
        assert _rel(port, want) <= C64_NP * np.sqrt(k)
        assert _rel(port, jax_out) <= C64_JAX * np.sqrt(k)


def _cpu(name):
    fn = getattr(tft, name)
    return lambda *a, **kw: fn(*a, device="cpu", **kw)


def test_rfftn_vs_numpy():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((5, 12, 16)).astype(np.float32)
    x64 = x.astype(np.float64)
    _gate(_cpu("rfft2")(x), jft.rfft2(x), np.fft.rfft2(x64), 2)
    _gate(_cpu("rfftn")(x), jft.rfftn(x), np.fft.rfftn(x64), 3)
    _gate(_cpu("rfftn")(x, 2), jft.rfftn(x, 2), np.fft.rfftn(x64, axes=(-2, -1)), 2)
    y = np.fft.rfftn(x64).astype(np.complex64)
    y128 = y.astype(np.complex128)
    _gate(_cpu("irfftn")(y), jft.irfftn(y), np.fft.irfftn(y128), 3)
    assert _cpu("irfftn")(y, shape=(5, 12, 16)).shape == (5, 12, 16)
    # odd last axis needs the explicit shape
    xo = rng.standard_normal((4, 9))
    yo = np.fft.rfft2(xo)
    yo32 = yo.astype(np.complex64)
    _gate(_cpu("irfft2")(yo32, shape=(4, 9)), jft.irfft2(yo32, shape=(4, 9)),
          np.fft.irfft2(yo32.astype(np.complex128), s=(4, 9)), 2)


def test_rfftn_c128():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((6, 8))
    got = _cpu("rfftn")(x, dtype=np.complex128)
    _gate(got, jft.rfftn(x, dtype=np.complex128), np.fft.rfftn(x), 2, double=True)
    back = _cpu("irfftn")(got, shape=(6, 8), dtype=np.complex128)
    np.testing.assert_allclose(back, x, atol=1e-12)


def test_rfftn_hfft_norms():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((4, 6, 8)).astype(np.float32)
    a = (rng.standard_normal((2, 17)) + 1j * rng.standard_normal((2, 17))).astype(
        np.complex64)
    xr = rng.standard_normal((2, 32)).astype(np.float32)
    y = np.fft.rfftn(x.astype(np.float64)).astype(np.complex64)
    for norm in (None, "ortho", "forward"):
        _gate(_cpu("rfftn")(x, norm=norm), jft.rfftn(x, norm=norm),
              np.fft.rfftn(x.astype(np.float64), norm=norm), 3)
        _gate(_cpu("irfftn")(y, shape=(4, 6, 8), norm=norm),
              jft.irfftn(y, shape=(4, 6, 8), norm=norm),
              np.fft.irfftn(y.astype(np.complex128), s=(4, 6, 8), axes=(0, 1, 2),
                            norm=norm), 3)
        _gate(_cpu("hfft")(a, norm=norm), jft.hfft(a, norm=norm),
              np.fft.hfft(a.astype(np.complex128), norm=norm), 1)
        _gate(_cpu("ihfft")(xr, norm=norm), jft.ihfft(xr, norm=norm),
              np.fft.ihfft(xr.astype(np.float64), norm=norm), 1)


def test_rfftn_validation():
    with pytest.raises(ValueError, match="out of range"):
        _cpu("rfftn")(np.zeros((2, 3), np.float32), ndim=3)
    with pytest.raises(ValueError, match="inconsistent with input axes"):
        _cpu("irfftn")(np.zeros((2, 5), np.complex64), shape=(3, 8))
    with pytest.raises(ValueError, match="spectrum length"):
        _cpu("irfftn")(np.zeros((2, 5), np.complex64), shape=(2, 12))
    with pytest.raises(ValueError, match="length 2"):
        _cpu("irfft2")(np.zeros((2, 5), np.complex64), shape=(2, 2, 8))
    with pytest.raises(ValueError, match="length 2"):
        _cpu("hfft2")(np.zeros((2, 5), np.complex64), shape=(4, 6, 8))


def test_hfftn_ihfftn_vs_scipy():
    rng = np.random.default_rng(RNG_SEED)
    a = (rng.standard_normal((4, 6, 9)) + 1j * rng.standard_normal((4, 6, 9))).astype(
        np.complex64)
    x = rng.standard_normal((4, 6, 16)).astype(np.float32)
    a128, x64 = a.astype(np.complex128), x.astype(np.float64)
    for norm in (None, "ortho", "forward"):
        _gate(_cpu("hfftn")(a, norm=norm), jft.hfftn(a, norm=norm),
              sfft.hfftn(a128, norm=norm), 3)
        _gate(_cpu("ihfftn")(x, norm=norm), jft.ihfftn(x, norm=norm),
              sfft.ihfftn(x64, norm=norm), 3)
    # explicit odd output shape + trailing-axes (ndim) selection
    _gate(_cpu("hfftn")(a, shape=(4, 6, 17)), jft.hfftn(a, shape=(4, 6, 17)),
          sfft.hfftn(a128, s=(4, 6, 17)), 3)
    _gate(_cpu("hfftn")(a, ndim=2), jft.hfftn(a, ndim=2),
          sfft.hfftn(a128, axes=(-2, -1)), 2)
    _gate(_cpu("ihfftn")(x, ndim=2), jft.ihfftn(x, ndim=2),
          sfft.ihfftn(x64, axes=(-2, -1)), 2)
    # 2-D wrappers
    _gate(_cpu("hfft2")(a[0]), jft.hfft2(a[0]), sfft.hfft2(a128[0]), 2)
    _gate(_cpu("ihfft2")(x[0]), jft.ihfft2(x[0]), sfft.ihfft2(x64[0]), 2)


def test_hfftn_roundtrip_and_dtype_inference():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((3, 5, 8))  # f64 -> complex128
    spec = _cpu("ihfftn")(x)
    assert spec.dtype == np.complex128
    _gate(spec, jft.ihfftn(x), sfft.ihfftn(x), 3, double=True)
    back = _cpu("hfftn")(spec, shape=x.shape)
    assert _rel(back, x) < C128
    assert _cpu("rfftn")(x).dtype == np.complex128
    assert _cpu("rfft2")(x.astype(np.float32)).dtype == np.complex64
    t = torch.as_tensor(x)
    out = tft.rfft2(t)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.complex128


@pytest.fixture
def card_routes(monkeypatch):
    """The surface on the routes it takes on a card (complex64: backend
    "vpu"; complex128: "dd"), run here on the kernels' plain versions."""
    def backend(dtype):
        return "vpu" if dtype == torch.complex64 else "dd"

    rfft_module = sys.modules["fourier_tpu_torch.rfft"]
    monkeypatch.setattr(rfft_module, "_axis_plans", lambda sizes, dtype, device: [
        tft.create_fft(n, dtype, backend=backend(dtype), device=device, cache=False)
        for n in sizes])
    monkeypatch.setattr(rfft_module, "_RFFT_CACHE", OrderedDict())
    monkeypatch.setattr(rfft_module, "RfftPlan", lambda n, dtype, device: RfftPlan(
        n, dtype, backend=backend(dtype), device=device))


@pytest.mark.parametrize("shape", [(64, 128), (128, 769), (12, 35)])
def test_real_family_on_card_routes(card_routes, shape):
    """rfft2/irfft2 through B4a/B4b (n = 128), B5a/B5b (n = 769) and the
    unfused pack (n = 35), each with B1's or a DFT product's plain version on
    the leading axis; complex128 on B6 (the last axis 128 plans 64)."""
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(shape).astype(np.float32)
    got = _cpu("rfft2")(x)
    _gate(got, jft.rfft2(x), np.fft.rfft2(x.astype(np.float64)), 2)
    back = _cpu("irfft2")(got, shape=shape)
    assert _rel(back, x) <= C64_NP * 2
    _gate(_cpu("ihfft2")(x), jft.ihfft2(x), sfft.ihfft2(x.astype(np.float64)), 2)
    if shape[1] == 128:
        xd = x.astype(np.float64)
        gd = _cpu("rfftn")(xd)
        _gate(gd, jft.rfftn(xd), np.fft.rfftn(xd), 2, double=True)
        assert _rel(_cpu("irfftn")(gd, shape=shape), xd) < C128


def test_real_family_gradient():
    """rfftn runs the batch-minor rfft (with its linear VJP) and the c2c
    passes (_LinearFft): gradcheck in f64 through both."""
    rng = np.random.default_rng(RNG_SEED)
    x = torch.tensor(rng.standard_normal((4, 6)), requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: torch.view_as_real(tft.rfftn(t)), (x,))
    s = torch.tensor(rng.standard_normal((4, 4, 2)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda t: tft.irfftn(torch.view_as_complex(t), shape=(4, 6)), (s,))


# -- fast Hankel transform (FFTLog) ------------------------------------------


@pytest.mark.parametrize("n,mu,bias,offset", [
    (64, 0.5, 0.0, 0.0),
    (100, 2.0, 0.0, 0.3),
    (128, -0.5, 0.1, 0.0),
    (47, 1.0, -0.2, 0.5),
])
def test_fht_vs_scipy(n, mu, bias, offset):
    dln = 0.1
    a = np.random.default_rng(0xC27 + n).standard_normal((2, n)) * np.exp(
        -0.05 * np.arange(n))
    got = _cpu("fht")(a, dln, mu, offset, bias)
    want = sfft.fht(a, dln, mu, offset=offset, bias=bias)
    assert _rel(got, want) <= 1e-11
    assert _rel(got, jft.fht(a, dln, mu, offset, bias)) <= C128
    gi = _cpu("ifht")(got, dln, mu, offset, bias)
    wi = sfft.ifht(want, dln, mu, offset=offset, bias=bias)
    assert _rel(gi, wi) <= 1e-11
    assert _rel(gi, jft.ifht(got, dln, mu, offset, bias)) <= C128


def test_fht_roundtrip_low_ringing_and_card_route(monkeypatch):
    """The low-ringing offset equals scipy's and the JAX package's; the round
    trip holds on the f64 route the card takes (backend "dd": B6 at 64)."""
    n, dln, mu = 128, 0.08, 1.5
    offset = tft.fhtoffset(dln, mu, 0.0)
    assert offset == sfft.fhtoffset(dln, mu, initial=0.0, bias=0.0)
    assert offset == jft.fhtoffset(dln, mu, 0.0)
    a = np.random.default_rng(0xC27).standard_normal(n) * np.exp(-0.03 * np.arange(n))
    fftlog = sys.modules["fourier_tpu_torch.fftlog"]
    monkeypatch.setattr(fftlog, "_rfft_plan", lambda n, dtype, device: RfftPlan(
        n, dtype, backend="dd", device=device))
    got = _cpu("fht")(a, dln, mu, offset)
    assert _rel(got, sfft.fht(a, dln, mu, offset=offset)) <= 1e-11
    rt = _cpu("ifht")(got, dln, mu, offset)
    assert _rel(rt, a) <= 1e-10


def test_fht_singular_warns():
    # bias -3 at mu=0 puts only the numerator gamma at a pole: u_0 = inf
    # (scipy warns identically for this configuration)
    a = np.random.default_rng(0xC27).standard_normal(16)
    with pytest.warns(UserWarning, match="singular"):
        got = _cpu("fht")(a, 0.1, 0.0, 0.0, -3.0)
    assert np.all(np.isfinite(got))


def test_fht_tensor_io():
    a = torch.randn(3, 32, generator=torch.Generator().manual_seed(1))
    out = tft.fht(a, 0.1, 0.5)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
    assert _rel(out.numpy(), sfft.fht(a.double().numpy(), 0.1, 0.5)) <= 1e-11


# -- the exports and the no-JAX rule -----------------------------------------


_EXPORTS = ("NdFftPlan", "fftn", "ifftn", "fft2", "ifft2", "rfftn", "irfftn",
            "rfft2", "irfft2", "hfftn", "ihfftn", "hfft2", "ihfft2", "dct",
            "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn", "fht",
            "ifht", "fhtoffset", "fftfreq", "fftshift", "ifftshift",
            "transform_planar", "fft_planar", "ifft_planar", "set_workers",
            "get_workers", "fftconvolve", "oaconvolve", "correlate",
            "correlation_lags", "next_fast_len", "prev_fast_len", "hilbert",
            "hilbert2", "resample", "czt", "zoom_fft", "CztPlan", "ConvolvePlan",
            "stft", "istft", "StftPlan", "welch", "csd", "periodogram",
            "coherence", "spectrogram", "check_cola", "check_nola",
            "scipy_fft_backend", "save_plan", "load_plan", "plan_to_bytes",
            "measure_fft", "export_wisdom", "import_wisdom", "forget_wisdom",
            "export_compiled", "load_compiled", "CompiledFft")


def test_exports():
    """Every name is exported: a function or class, and the scipy.fft
    backend object (a uarray backend, not a callable)."""
    for name in _EXPORTS:
        assert name in tft.__all__, name
        obj = getattr(tft, name)
        assert callable(obj) or hasattr(obj, "__ua_function__"), name
    assert all(hasattr(tft, name) for name in tft.__all__)


def _port_sources():
    return sorted((REPO / "fourier_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_no_jax_import_in_sources():
    """No source file of the port (its tools included), and not
    chip_smoke.py, imports jax or the JAX package (any import or
    from-import, at any depth)."""
    banned = {"jax", "jaxlib", "fourier_tpu"}
    found = []
    sources = _port_sources()
    tools = {p.name for p in sources if p.parent.name == "tools"}
    assert {"bench_suite.py", "prof.py"} <= tools, tools
    sharded = {p.name for p in sources if p.parent.name == "parallel"}
    assert {"__init__.py", "sharded.py", "exchange.py"} <= sharded, sharded
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            found += [f"{path.relative_to(REPO)}: {n}" for n in names
                      if n.split(".")[0] in banned]
    assert not found, found


def test_no_jax_in_a_fresh_process():
    """Importing the port and every module under it, its tools included,
    loads neither jax nor the JAX package."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "fourier_tpu_torch").rglob("*.py"))
    assert {"fourier_tpu_torch.tools.bench_suite", "fourier_tpu_torch.tools.prof",
            "fourier_tpu_torch.parallel.sharded"} <= set(modules)
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'fourier_tpu'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
