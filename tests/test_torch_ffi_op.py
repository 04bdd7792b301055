"""The native core as a registered operator (``fourier_tpu_torch.ffi.op``).

Counterparts of every case of ``tests/test_xla_ffi.py``: forward against
``np.fft`` in both dtypes, the all-modes round trips, composition with
``torch.compile(fullgraph=True)`` (the place of ``jax.jit``; the
``aot_eager`` backend) and ``torch.func.vmap``, the port's CPU plan at 360,
and bad inputs; plus a ``torch.export`` round trip, ``torch.library.opcheck``
and the JAX package's ``native_fft`` (its XLA custom call) on the same numpy
data, skipped only where its handler library does not build. Gates as the
reference's: rel-L2 1e-4 c64, 1e-12 c128.
"""

import io
import subprocess

import numpy as np
import pytest
import torch

import fourier_tpu_torch as tft
from fourier_tpu_torch import Transform
from fourier_tpu_torch.ffi import build
from fourier_tpu_torch.ffi.op import _native_fft_op, native_fft

try:
    build.compiler()
except RuntimeError as e:  # pragma: no cover - environment-dependent
    pytest.skip(str(e), allow_module_level=True)

RNG = np.random.default_rng(0x5EED)
TOL = {np.complex64: 1e-4, np.complex128: 1e-12}


def _rand(shape, dtype):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(dtype)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("n", [1, 4, 24, 64, 73, 100, 243, 1013])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_forward_vs_numpy(n, dtype):
    x = _rand((5, n), dtype)
    y = native_fft(x, Transform.FFT)
    assert isinstance(y, torch.Tensor) and y.numpy().dtype == dtype
    assert _rel(y, np.fft.fft(x, axis=-1)) <= TOL[dtype]
    assert np.array_equal(native_fft(torch.as_tensor(x), 0).numpy(), y.numpy())


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_all_modes_roundtrip(dtype):
    n = 96
    x = _rand((n,), dtype)
    tol, nrm = TOL[dtype], np.linalg.norm(x)

    def fft(t):
        return lambda a: native_fft(a, t)

    rt = fft(Transform.IFFT)(fft(Transform.FFT)(x))
    assert np.linalg.norm(rt.numpy() - x) <= tol * nrm
    rt = fft(Transform.SQRT_SCALED_IFFT)(fft(Transform.SQRT_SCALED_FFT)(x))
    assert np.linalg.norm(rt.numpy() - x) <= tol * nrm
    a = fft(Transform.UNSCALED_IFFT)(x).numpy()
    b = fft(Transform.IFFT)(x).numpy() * n
    assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b)


def test_inside_compile_composes():
    x = torch.as_tensor(_rand((4, 128), np.complex64))

    @torch.compile(fullgraph=True, backend="aot_eager")
    def f(a):
        return native_fft(a * 2.0, Transform.FFT).abs().sum()

    ref = np.abs(np.fft.fft(2.0 * x.numpy(), axis=-1)).sum()
    assert float(f(x)) == pytest.approx(float(ref), rel=1e-5)


def test_export_roundtrip():
    """torch.export keeps the operator in the graph; saved and loaded, the
    program gives the eager call's values."""

    class Inverse(torch.nn.Module):
        def forward(self, a):
            return native_fft(a, Transform.IFFT)

    x = torch.as_tensor(_rand((3, 100), np.complex128))
    ep = torch.export.export(Inverse(), (x,))
    assert "fourier_tpu_torch.native_fft" in ep.graph_module.code
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    y = torch.export.load(buf).module()(x)
    assert torch.equal(y, native_fft(x, Transform.IFFT))
    assert _rel(y, np.fft.ifft(x.numpy(), axis=-1)) <= TOL[np.complex128]


@pytest.mark.parametrize("in_dims", [0, 1])
def test_vmap_batches(in_dims):
    x = torch.as_tensor(_rand((6, 3, 64), np.complex64))
    y = torch.func.vmap(lambda a: native_fft(a, Transform.FFT), in_dims=in_dims)(x)
    ref = np.moveaxis(np.fft.fft(x.numpy(), axis=-1), in_dims, 0)
    assert y.shape == ref.shape and _rel(y, ref) <= 1e-4


@pytest.mark.parametrize("case", ["c64", "c128-strided", "empty-batch"])
def test_opcheck(case):
    """Schema, fake, autograd registration and AOT dispatch of the operator."""
    x = {"c64": lambda: torch.as_tensor(_rand((4, 24), np.complex64)),
         "c128-strided": lambda: torch.as_tensor(_rand((7, 5, 3), np.complex128))
         .transpose(0, 2),
         "empty-batch": lambda: torch.zeros(0, 16, dtype=torch.complex64)}[case]()
    torch.library.opcheck(_native_fft_op, (x, 3))


def test_agrees_with_port_plan():
    n = 360
    x = _rand((n,), np.complex64)
    a = tft.create_fft_f32(n, device="cpu").fft(torch.as_tensor(x))
    b = native_fft(x, Transform.FFT)
    assert _rel(a, b) <= 1e-4


@pytest.fixture(scope="module")
def jax_native_fft():
    """The JAX package's native_fft, its handlers registered with XLA."""
    import fcntl
    import shutil

    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        pytest.skip("the JAX package's handler library builds with cmake and ninja")
    xla_ffi = pytest.importorskip("fourier_tpu.ffi.xla")
    # Its build_library tests exists() before it takes its lock: wait for a
    # build another test process may be running before asking.
    xla_ffi._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(xla_ffi._BUILD_DIR / ".build.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
    try:
        xla_ffi.register()
    except (subprocess.CalledProcessError, OSError, FileNotFoundError) as e:
        pytest.skip(f"the JAX package's handler library does not build: {e}")
    return xla_ffi.native_fft


@pytest.mark.parametrize("mode", list(Transform))
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_agrees_with_jax_native_fft(jax_native_fft, dtype, mode):
    """The same core through XLA's custom call and through the operator."""
    x = _rand((3, 73), dtype)
    want = np.asarray(jax_native_fft(x, mode))
    got = native_fft(x, mode).numpy()
    assert np.array_equal(got, want)


def test_rejects_bad_inputs():
    with pytest.raises(TypeError):
        native_fft(np.ones((4,), np.float32), Transform.FFT)
    with pytest.raises(ValueError):
        native_fft(np.ones((4,), np.complex64), 7)
    with pytest.raises(ValueError):
        native_fft(np.ones((4,), np.complex64), -1)
    with pytest.raises(ValueError):
        native_fft(np.ones((3, 0), np.complex64), Transform.FFT)
    with pytest.raises(ValueError):  # the operator itself, as the handler does
        _native_fft_op(torch.ones(4, dtype=torch.complex64), 5)
    with pytest.raises(TypeError, match="host"):
        native_fft(torch.ones(4, dtype=torch.complex64, device="meta"), 0)
