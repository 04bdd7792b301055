"""DCT/DST of the port (fourier_tpu_torch.dctdst) against the JAX package
and scipy.fft, across types, norms, sizes, dtypes and axes.

Inputs are made from a seed with numpy; the JAX functions run on the CPU
with x64 on, as ``tests/test_dct.py`` runs them, and the port's with
``device="cpu"``. Gates, rel-L2 over the whole array: float64 <= 1e-12
against scipy and the JAX package (``tests/test_dct.py``'s gate); float32
<= 1e-6*sqrt(k) against scipy in f64 and <= 2e-6*sqrt(k) against the JAX
package, k the number of transformed axes.
"""

import numpy as np
import pytest
import torch
from scipy import fft as sfft

import fourier_tpu as jft

import fourier_tpu_torch as tft
from fourier_tpu_torch import dctdst
from fourier_tpu_torch.plan import create_fft
from fourier_tpu_torch.rfft import RfftPlan

RNG_SEED = 0xDC7
TYPES = [1, 2, 3, 4]
NORMS = [None, "ortho", "forward"]
F64, F32_NP, F32_JAX = 1e-12, 1e-6, 2e-6
_FNS = ("dct", "idct", "dst", "idst")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _all_fns(x, type, norm, **kw):
    """{name: (port, JAX, scipy)} of the four 1-D transforms of `x`."""
    return {f: (getattr(tft, f)(x, type=type, norm=norm, device="cpu", **kw),
                getattr(jft, f)(x, type=type, norm=norm, **kw),
                getattr(sfft, f)(x.astype(np.float64), type=type, norm=norm, **kw))
            for f in _FNS}


@pytest.mark.parametrize("n", [2, 5, 8, 16, 27])
@pytest.mark.parametrize("type", TYPES)
def test_dct_vs_scipy(n, type):
    x = np.random.default_rng(RNG_SEED + n).standard_normal((3, n))
    for norm in NORMS:
        for f in ("dct", "idct"):
            port, jax_out, want = _all_fns(x, type, norm)[f]
            assert _rel(port, want) < F64, (f, type, norm)
            assert _rel(port, jax_out) < F64, (f, type, norm)


@pytest.mark.parametrize("n", [2, 5, 8, 16, 27])
@pytest.mark.parametrize("type", TYPES)
def test_dst_vs_scipy(n, type):
    x = np.random.default_rng(RNG_SEED + n).standard_normal((3, n))
    for norm in NORMS:
        for f in ("dst", "idst"):
            port, jax_out, want = _all_fns(x, type, norm)[f]
            assert _rel(port, want) < F64, (f, type, norm)
            assert _rel(port, jax_out) < F64, (f, type, norm)


@pytest.mark.parametrize("type", TYPES)
def test_dct_roundtrip(type):
    x = np.random.default_rng(RNG_SEED).standard_normal(24)
    for norm in NORMS:
        kw = dict(type=type, norm=norm, device="cpu")
        assert _rel(tft.idct(tft.dct(x, **kw), **kw), x) < F64
        assert _rel(tft.idst(tft.dst(x, **kw), **kw), x) < F64


@pytest.mark.parametrize("type", TYPES)
def test_dct_f32_dtype_and_axis(type):
    x = np.random.default_rng(RNG_SEED).standard_normal((6, 40)).astype(np.float32)
    for norm in NORMS:
        for f, (port, jax_out, want) in _all_fns(x, type, norm, axis=0).items():
            assert port.dtype == np.float32
            assert _rel(port, want) <= F32_NP, (f, norm)
            assert _rel(port, jax_out) <= F32_JAX, (f, norm)


def test_dct_validation():
    with pytest.raises(ValueError):
        tft.dct(np.zeros(4), type=5, device="cpu")
    with pytest.raises(ValueError):
        tft.dct(np.zeros(4), norm="bogus", device="cpu")
    with pytest.raises(ValueError):
        tft.dct(np.zeros(1), type=1, device="cpu")  # DCT-I needs n >= 2
    with pytest.raises(TypeError):
        tft.dct(np.zeros(4, np.complex64), device="cpu")
    with pytest.raises(ValueError):
        tft.dst(np.zeros((2, 4)), axis=2, device="cpu")
    with pytest.raises(ValueError):
        tft.dctn(np.zeros((2, 4)), axes=(1, 1), device="cpu")
    with pytest.raises(ValueError):
        tft.dctn(np.zeros((2, 4)), s=(3,), axes=(0, 1), device="cpu")


@pytest.fixture
def card_routes(monkeypatch):
    """The port's DCT/DST on the routes they take on a card (complex64:
    backend "vpu", kernels B1/B2/B4/B5; complex128: "dd", B6/B7), run here
    on the kernels' plain versions."""
    def backend(dtype):
        return "vpu" if dtype == torch.complex64 else "dd"

    monkeypatch.setattr(dctdst, "_rfft_plan", lambda n, dtype, device: RfftPlan(
        n, dtype, backend=backend(dtype), device=device))
    monkeypatch.setattr(dctdst, "create_fft", lambda n, dtype, device: create_fft(
        n, dtype, backend=backend(dtype), device=device, cache=False))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dct_card_route(card_routes, dtype):
    """At n = 64 the real FFTs of length 2n = 128 and 8n = 512 run B4a's
    plain version (their halves are in B1's domain) and DCT-III's c2c runs
    B1's, in complex64; B6's at 64 in complex128. DCT-I's 126 and DST-I's
    130 run the unfused pack around their inner plans."""
    x = np.random.default_rng(RNG_SEED).standard_normal((5, 64)).astype(dtype)
    gate_np, gate_jax = (F64, F64) if dtype == np.float64 else (F32_NP, F32_JAX)
    for type in TYPES:
        for norm in NORMS:
            for f, (port, jax_out, want) in _all_fns(x, type, norm).items():
                assert _rel(port, want) <= gate_np, (f, type, norm)
                assert _rel(port, jax_out) <= gate_jax, (f, type, norm)


def test_dct_n1_edge():
    x = np.array([3.0])
    for type in (2, 3, 4):
        assert _rel(tft.dct(x, type, device="cpu"), sfft.dct(x, type)) < 1e-14
        assert _rel(tft.idct(x, type, device="cpu"), sfft.idct(x, type)) < 1e-14
        assert _rel(tft.dst(x, type, device="cpu"), jft.dst(x, type)) < 1e-14


@pytest.mark.parametrize("kind", ["dct", "dst"])
@pytest.mark.parametrize("type_", TYPES)
def test_dctn_dstn_vs_scipy(kind, type_):
    x = np.random.default_rng(0xC27).standard_normal((6, 5, 8))
    for kw in ({}, {"axes": (0, 2)}, {"norm": "ortho"},
               {"s": (4, 9), "axes": (1, 2)}, {"s": (3, 5)}):
        for inv in ("", "i"):
            name = f"{inv}{kind}n"
            got = getattr(tft, name)(x, type_, device="cpu", **kw)
            assert _rel(got, getattr(sfft, name)(x, type_, **kw)) < F64, (name, kw)
            assert _rel(got, getattr(jft, name)(x, type_, **kw)) < F64, (name, kw)


def test_dctn_f32_and_roundtrip():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((12, 10)).astype(np.float32)
    for name in ("dctn", "idctn", "dstn", "idstn"):
        got = getattr(tft, name)(x, 2, device="cpu")
        assert got.dtype == np.float32
        want = getattr(sfft, name)(x.astype(np.float64), 2)
        assert _rel(got, want) <= F32_NP * np.sqrt(2)
        assert _rel(got, getattr(jft, name)(x, 2)) <= F32_JAX * np.sqrt(2)
    xd = rng.standard_normal((5, 12))
    rt = tft.idctn(tft.dctn(xd, 2, norm="ortho", device="cpu"), 2, norm="ortho",
                   device="cpu")
    assert _rel(rt, xd) < F64


def test_tensor_in_tensor_out_and_grad():
    """A tensor runs on its own device and stays a tensor; the transform is
    linear, so autograd through it passes gradcheck."""
    rng = np.random.default_rng(RNG_SEED)
    x = torch.tensor(rng.standard_normal((4, 6)), requires_grad=True)
    out = tft.dctn(x, 2, norm="ortho")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
    assert _rel(out.detach().numpy(), sfft.dctn(x.detach().numpy(), 2, norm="ortho")) < F64
    for type in TYPES:
        assert torch.autograd.gradcheck(lambda t: tft.dst(t, type, axis=0), (x,))
        assert torch.autograd.gradcheck(lambda t: tft.idct(t, type, norm="ortho"), (x,))


def test_twiddles_cached_per_size_dtype_device():
    like = torch.zeros(1, dtype=torch.float32)
    c, s = dctdst._quarter_wave(16, like, 0)
    assert c.dtype == torch.float32 and c.shape == (16, 1)
    assert dctdst._quarter_wave(16, like, 0)[0] is c
    c64 = dctdst._quarter_wave(16, like.double(), 0)[0]
    assert c64.dtype == torch.float64 and c64 is not c
    np.testing.assert_array_equal(
        c.numpy()[:, 0], np.cos(np.pi * np.arange(16) / 32.0).astype(np.float32))
