"""The port's native host core (``fourier_tpu_torch.ffi``) over its C ABI.

Counterparts of every case of ``tests/test_ffi.py`` (the native core against
the oracle in both dtypes and all five modes, in place, batched, errors,
plan parity, the ctest suite), on numpy arrays and torch CPU tensors, plus
the port's additions: a code outside 0-4 and a tensor off the CPU are
refused. On the same seeded numpy data the port's ``NativeFftPlan`` is held
bitwise against the JAX package's (``fourier_tpu.ffi``: the same C++ core,
compiled by CMake there and by the host compiler here with the flags of
that Release build), and the native core against the JAX package's
Stockham plan and the port's CPU plan. Gates as the reference's: 1e-4 c64,
1e-10 c128 (max abs, scaled).

The module skips only where no host C++ compiler is found; the ctest case
also needs cmake and ninja.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import fourier_tpu as jft

import fourier_tpu_torch as tft
from fourier_tpu_torch import Transform
from fourier_tpu_torch.ffi import NativeFftPlan, build, plan_parity
from fourier_tpu_torch.utils import oracle_transform

try:
    build.compiler()
except RuntimeError as e:  # pragma: no cover - environment-dependent
    pytest.skip(str(e), allow_module_level=True)

RNG_SEED = 0xC0FFEE
DTYPES = [(np.complex64, 1e-4), (np.complex128, 1e-10)]


def _rand(n, rng, dtype=np.complex128):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(dtype)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.max(np.abs(got - want)) < tol * max(1.0, np.max(np.abs(want)))


@pytest.fixture(scope="module")
def jffi():
    """The JAX package's bindings over its CMake build."""
    import fcntl

    from fourier_tpu import ffi

    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        pytest.skip("the JAX package's native library builds with cmake and ninja")
    # Its build_library tests exists() before it takes its lock: wait for a
    # build another test process may be running before asking.
    ffi._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(ffi._BUILD_DIR / ".build.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
    ffi.load_library()
    return ffi


@pytest.mark.parametrize("n", [1, 2, 4, 24, 64, 73, 100, 243, 1013])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_native_vs_oracle(n, dtype, tol):
    rng = np.random.default_rng(RNG_SEED + n)
    plan = NativeFftPlan(n, dtype)
    x = _rand(n, rng, dtype)
    _close(plan.fft(x), oracle_transform(x, Transform.FFT), tol)
    _close(plan.ifft(x), oracle_transform(x, Transform.IFFT), tol)
    # A tensor in gives a tensor out, the same values.
    got = plan.fft(torch.as_tensor(x))
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), plan.fft(x))


@pytest.mark.parametrize("mode", list(Transform))
def test_native_modes(mode):
    rng = np.random.default_rng(RNG_SEED)
    n = 96
    plan = NativeFftPlan(n, np.complex128)
    x = _rand(n, rng)
    want = oracle_transform(x, mode)
    _close(plan.transform(x, int(mode)), want, 1e-10)
    _close(plan.transform(torch.as_tensor(x), mode), want, 1e-10)


@pytest.mark.parametrize("n", [64, 73, 100])
def test_native_matches_jax_path_and_port_plan(n):
    rng = np.random.default_rng(RNG_SEED + n)
    native = NativeFftPlan(n, torch.complex64)
    x = _rand(n, rng, np.complex64)
    got = native.fft(x)
    jplan = jft.create_fft(n, np.complex64, backend="stockham")
    np.testing.assert_allclose(got, np.asarray(jplan.fft(x)), atol=1e-4)
    tplan = tft.create_fft_f32(n, device="cpu")
    np.testing.assert_allclose(got, np.asarray(tplan.fft(torch.as_tensor(x))), atol=1e-4)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_native_in_place(kind):
    rng = np.random.default_rng(RNG_SEED)
    n = 48
    plan = NativeFftPlan(n, np.complex128)
    x = _rand(n, rng)
    buf = x.copy() if kind == "numpy" else torch.as_tensor(x.copy())
    plan.transform_in_place(buf, int(Transform.FFT))
    np.testing.assert_allclose(np.asarray(buf), np.fft.fft(x), atol=1e-10)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_native_batch_in_place(dtype, tol, kind):
    """One crossing transforms every row of (batch, n); a bad shape raises."""
    rng = np.random.default_rng(RNG_SEED)
    n = 96
    plan = NativeFftPlan(n, dtype)
    x = np.ascontiguousarray(_rand(7 * n, rng, dtype).reshape(7, n))
    buf = x.copy() if kind == "numpy" else torch.as_tensor(x.copy())
    plan.transform_batch_in_place(buf, int(Transform.FFT))
    np.testing.assert_allclose(np.asarray(buf), np.fft.fft(x, axis=-1), atol=tol)
    plan.transform_batch_in_place(buf, Transform.IFFT)
    np.testing.assert_allclose(np.asarray(buf), x, atol=tol)
    with pytest.raises(ValueError):
        plan.transform_batch_in_place(buf[:, :50], int(Transform.FFT))


def test_native_errors():
    with pytest.raises(ValueError):
        NativeFftPlan(0)
    with pytest.raises(ValueError):
        NativeFftPlan(8, np.float32)
    plan = NativeFftPlan(8)
    with pytest.raises(ValueError):
        plan.fft(np.zeros(9, np.complex64))
    with pytest.raises(ValueError):
        plan.fft(torch.zeros(9, dtype=torch.complex64))


def test_in_place_type_and_layout_errors():
    plan = NativeFftPlan(8, torch.complex64)
    with pytest.raises(TypeError):
        plan.transform_in_place(np.zeros(8, np.complex128))
    with pytest.raises(TypeError):
        plan.transform_in_place(torch.zeros(8, dtype=torch.complex128))
    with pytest.raises(TypeError):
        plan.transform_in_place([0j] * 8)
    with pytest.raises(ValueError):
        plan.transform_in_place(np.zeros(16, np.complex64)[::2])
    with pytest.raises(ValueError):
        plan.transform_in_place(torch.zeros(16, dtype=torch.complex64)[::2])
    with pytest.raises(ValueError):  # a conjugate view's memory is not its values
        plan.transform_in_place(torch.zeros(8, dtype=torch.complex64).conj())
    with pytest.raises(ValueError):
        plan.transform_batch_in_place(torch.zeros(8, 3, dtype=torch.complex64).t())


@pytest.mark.parametrize("code", [-1, 5, 7])
def test_code_outside_range_raises(code):
    """The C ABI returns without writing for such a code (the reference's
    ``transform`` then returns an uninitialised buffer); the port raises."""
    plan = NativeFftPlan(8, np.complex128)
    x = np.ones(8, np.complex128)
    with pytest.raises(ValueError, match="outside"):
        plan.transform(x, code)
    with pytest.raises(ValueError, match="outside"):
        plan.transform_in_place(x, code)
    with pytest.raises(ValueError, match="outside"):
        plan.transform_batch_in_place(x.reshape(1, 8), code)
    assert np.array_equal(x, np.ones(8))


def test_non_cpu_tensor_refused():
    """Host only: a tensor on another device is refused, not copied."""
    plan = NativeFftPlan(8, torch.complex64)
    meta = torch.zeros(8, dtype=torch.complex64, device="meta")
    for call in (plan.transform, plan.transform_in_place):
        with pytest.raises(TypeError, match="host"):
            call(meta)
    with pytest.raises(TypeError, match="host"):
        plan.transform_batch_in_place(meta.reshape(1, 8))


@pytest.mark.parametrize("mode", list(Transform))
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("n", [64, 73, 100, 1013])
def test_bitwise_equal_to_jax_package(jffi, n, dtype, mode):
    """The same C++ core built two ways: equal to the bit on the same data."""
    rng = np.random.default_rng(RNG_SEED + n)
    x = _rand(n, rng, dtype)
    want = jffi.NativeFftPlan(n, dtype).transform(x, int(mode))
    plan = NativeFftPlan(n, dtype)
    assert np.array_equal(plan.transform(x, mode), want)
    rows = np.stack([x, x[::-1]])
    plan.transform_batch_in_place(rows, mode)
    assert np.array_equal(rows[0], want)


def test_plan_parity_native_vs_port():
    """The C++ planner and the port's plan-time math agree on schedule and
    tables over {64, 73, 100, 243, 1013} x {f32, f64} (every plan family)."""
    dump_bin = build.build_dump_plan()
    assert plan_parity.run(dump_bin) == []
    assert plan_parity.main([str(dump_bin)]) == 0


def test_plan_parity_detects_a_mismatch(monkeypatch):
    """A planner that disagrees fails the check (exit 1)."""
    from fourier_tpu_torch.plan import factor

    monkeypatch.setattr(factor, "factorize_autosort",
                        lambda n: [2] * (n.bit_length() - 1) if n & (n - 1) == 0 else None)
    assert plan_parity.main([str(build.build_dump_plan())]) == 1


def test_ctest_suite_passes(tmp_path):
    """The C and C++ roundtrips (static and shared) and the plan-parity gate
    of the port's CMake build."""
    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        pytest.skip("cmake/ninja unavailable")
    bdir = tmp_path / "build"
    for cmd in (["cmake", "-S", str(build.FFI_DIR), "-B", str(bdir), "-G", "Ninja"],
                ["ninja", "-C", str(bdir)], ["ctest", "--output-on-failure"]):
        result = subprocess.run(cmd, cwd=bdir if cmd[0] == "ctest" else None,
                                capture_output=True, text=True)
        assert result.returncode == 0, result.stdout + result.stderr
    assert "plan_parity" in result.stdout and "100% tests passed" in result.stdout


def test_builds_into_the_port_build_dir():
    """From the port's own sources into build/fourier_tpu_torch/ffi/ at the
    repository root, never into the JAX package's build directory."""
    so = build.build_library()
    assert so.exists() and so.parent == build.BUILD_DIR
    assert so.parent.parts[-3:] == ("build", "fourier_tpu_torch", "ffi")
    assert build.FFI_DIR.parts[-2:] == ("fourier_tpu_torch", "ffi")
    assert build.build_library() == so  # built once


@pytest.fixture
def ffi_copy(tmp_path, monkeypatch):
    src = tmp_path / "ffi"
    shutil.copytree(build.FFI_DIR, src, ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    monkeypatch.setattr(build, "FFI_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    return src


def test_build_key_follows_sources_and_flags(ffi_copy, monkeypatch):
    before = build.library_path()
    (ffi_copy / "notes.txt").write_text("not a source\n")
    assert build.library_path() == before
    header = ffi_copy / "src" / "fft_core.hpp"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = build.library_path()
    assert edited != before and build.dump_plan_path().name.endswith(edited.name[14:-3])
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS + ("-g",))
    assert build.library_path() != edited


def test_failed_compile_raises_with_its_output(ffi_copy):
    capi = ffi_copy / "src" / "capi.cpp"
    capi.write_text(capi.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="capi.cpp"):
        build.build_library()
    assert not any(build.BUILD_DIR.glob("*.tmp*")) and not build.library_path().exists()


def test_missing_compiler_raises(ffi_copy, monkeypatch):
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    with pytest.raises(RuntimeError, match="host C\\+\\+ compiler"):
        build.build_library()
