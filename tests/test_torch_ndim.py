"""N-D transforms of the port (NdFftPlan, fftn/ifftn/fft2/ifft2) and the
helper wrappers, against the JAX package and numpy.

Every input is made from a seed with numpy and runs through the JAX function
(on the CPU, with x64 on, as ``tests/test_ndim.py`` runs it) and the port's
(``device="cpu"``). Gates, rel-L2 over the whole array, k the number of
transformed axes: complex64 <= 1e-6*sqrt(k) against ``np.fft`` in f64 and
<= 2e-6*sqrt(k) against the JAX package; complex128 <= 1e-12 against both.
The card's routes run here on their kernels' plain versions (``backend="vpu"``
or ``"dd"`` with ``device="cpu"``).
"""

import inspect

import numpy as np
import pytest
import torch

import fourier_tpu as jft
from fourier_tpu.ndim import NdFftPlan as JNdFftPlan
from fourier_tpu.plan.serialize import save_plan

import fourier_tpu_torch as tft
from fourier_tpu_torch import Transform
from fourier_tpu_torch import ndim as tnd
from fourier_tpu_torch.ndim import NdFftPlan
from fourier_tpu_torch.plan import load_jax_plan, plan_tree

RNG_SEED = 0x2D2D
C64_NP, C64_JAX, C128 = 1e-6, 2e-6, 1e-12


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _rand(shape, rng, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _gate_c64(port, jax_out, want, k):
    assert _rel(port, want) <= C64_NP * np.sqrt(k)
    assert _rel(port, jax_out) <= C64_JAX * np.sqrt(k)


@pytest.mark.parametrize("shape", [(16, 16), (8, 32), (12, 35)])
def test_fft2_vs_numpy(shape):
    x = _rand(shape, np.random.default_rng(RNG_SEED))
    x128 = x.astype(np.complex128)
    _gate_c64(tft.fft2(x, device="cpu"), jft.fft2(x), np.fft.fft2(x128), 2)
    _gate_c64(tft.ifft2(x, device="cpu"), jft.ifft2(x), np.fft.ifft2(x128), 2)


def test_fftn_3d():
    x = _rand((4, 8, 16), np.random.default_rng(RNG_SEED))
    x128 = x.astype(np.complex128)
    _gate_c64(tft.fftn(x, device="cpu"), jft.fftn(x), np.fft.fftn(x128), 3)
    _gate_c64(tft.ifftn(x, device="cpu"), jft.ifftn(x), np.fft.ifftn(x128), 3)


def test_batched_fft2():
    x = _rand((3, 8, 16), np.random.default_rng(RNG_SEED))
    _gate_c64(tft.fftn(x, ndim=2, device="cpu"), jft.fftn(x, ndim=2),
              np.fft.fft2(x.astype(np.complex128), axes=(-2, -1)), 2)


@pytest.mark.parametrize("mode", list(Transform))
def test_nd_modes(mode):
    shape = (8, 12)
    x = _rand(shape, np.random.default_rng(RNG_SEED))
    got = NdFftPlan(shape, device="cpu").transform(x, mode)
    n = np.prod(shape)
    x128 = x.astype(np.complex128)
    base = np.fft.fft2(x128) if mode.is_forward else np.fft.ifft2(x128) * n
    scale = mode.scale(n)
    want = base * (scale if scale is not None else 1.0)
    _gate_c64(got, JNdFftPlan(shape).transform(x, jft.Transform(int(mode))), want, 2)


def test_nd_unitary_roundtrip():
    shape = (16, 9)
    x = _rand(shape, np.random.default_rng(RNG_SEED))
    plan = NdFftPlan(shape, device="cpu")
    y = plan.transform(x, Transform.SQRT_SCALED_FFT)
    assert abs(np.linalg.norm(y) - np.linalg.norm(x)) < 1e-4 * np.linalg.norm(x)
    back = plan.transform(y, Transform.SQRT_SCALED_IFFT)
    np.testing.assert_allclose(back, x, atol=1e-4)


def test_nd_shape_validation():
    plan = NdFftPlan((8, 8), device="cpu")
    with pytest.raises(ValueError):
        plan.fft(np.zeros((8, 9), np.complex64))
    with pytest.raises(ValueError):
        plan.fft_planar(torch.zeros(8, 9), torch.zeros(8, 9))
    with pytest.raises(ValueError):
        NdFftPlan((), device="cpu")


@pytest.mark.parametrize("shape", [(16, 16), (8, 12)])
def test_fft2_c128(shape):
    """Native c128 on the card's route (B6 where the axis is in its domain,
    else the f64 Stockham) against the JAX c128 plan and np.fft."""
    x = _rand(shape, np.random.default_rng(RNG_SEED), np.complex128)
    plan = NdFftPlan(shape, torch.complex128, backend="dd", device="cpu")
    want = np.fft.fft2(x)
    got = plan.fft(x)
    assert _rel(got, want) < C128
    assert _rel(got, JNdFftPlan(shape, np.complex128).fft(x)) < C128
    assert _rel(plan.ifft(got), x) < C128
    assert _rel(tft.fft2(x, device="cpu"), want) < C128


def test_fft2_c128_planar_path():
    """The planar API in c128 matches the complex convenience bitwise and the
    JAX package within the gate; the 1e-12 gate holds at B6's n = 64."""
    rng = np.random.default_rng(RNG_SEED)
    shape = (64, 16)
    x = _rand(shape, rng, np.complex128)
    plan = NdFftPlan(shape, torch.complex128, backend="dd", device="cpu")
    assert plan_tree(plan.plans[0]) == ("VpuDdFftPlan", 64)
    ore, oim = plan.fft_planar(torch.as_tensor(x.real), torch.as_tensor(x.imag))
    got = ore.numpy() + 1j * oim.numpy()
    np.testing.assert_array_equal(got, plan.fft(x))
    assert _rel(got, np.fft.fft2(x)) < C128
    jre, jim = JNdFftPlan(shape, np.complex128).fft_planar(x.real, x.imag)
    assert _rel(got, np.asarray(jre) + 1j * np.asarray(jim)) < C128


@pytest.mark.parametrize("prime,kind", [(7, "BluesteinPlan"),
                                        (17, "VpuDdBluesteinPlan")])
def test_fftn_3d_c128_bluestein_axis(prime, kind):
    """c128 N-D with a Bluestein (prime) axis keeps the 1e-12 gate: the
    composed Bluestein at 7, B7's plain version at 17."""
    shape = (4, prime, 8)
    x = _rand(shape, np.random.default_rng(RNG_SEED), np.complex128)
    plan = NdFftPlan(shape, torch.complex128, backend="dd", device="cpu")
    assert plan_tree(plan.plans[1])[0] == kind
    want = np.fft.fftn(x)
    got = plan.fft(x)
    assert _rel(got, want) < C128
    assert _rel(got, JNdFftPlan(shape, np.complex128).fft(x)) < C128


def test_nd_planar_dtype_and_device():
    """Planes of another real dtype are cast to the plan's; a plan never runs
    an axis on another device than its own."""
    plan = NdFftPlan((8, 8), torch.complex128, device="cpu")
    ore, _ = plan.fft_planar(torch.zeros(8, 8), torch.zeros(8, 8))
    assert ore.dtype == torch.float64
    meta = torch.zeros(8, 8, device="meta")
    with pytest.raises(ValueError, match="plan on cpu"):
        plan.fft_planar(meta, meta)


def test_fftshift_helpers():
    for n in (8, 9, 16):
        x = np.arange(n)
        want = np.fft.fftshift(x)
        np.testing.assert_array_equal(tft.fftshift(x), want)
        np.testing.assert_array_equal(np.asarray(jft.fftshift(x)), want)
        np.testing.assert_array_equal(tft.ifftshift(tft.fftshift(x)), x)
        np.testing.assert_allclose(tft.fftfreq(n, d=0.5), np.fft.fftfreq(n, d=0.5))
        np.testing.assert_array_equal(tft.fftfreq(n, 0.5), jft.fftfreq(n, 0.5))
    x2 = np.arange(24).reshape(4, 6)
    np.testing.assert_array_equal(tft.fftshift(x2), np.fft.fftshift(x2))
    np.testing.assert_array_equal(tft.fftshift(x2, axes=1),
                                  np.fft.fftshift(x2, axes=1))
    np.testing.assert_array_equal(tft.ifftshift(x2, axes=(0,)),
                                  np.fft.ifftshift(x2, axes=(0,)))
    t = torch.arange(24).reshape(4, 6)
    out = tft.fftshift(t)
    assert isinstance(out, torch.Tensor) and out.device == t.device
    np.testing.assert_array_equal(out.numpy(), np.fft.fftshift(x2))


def test_numpy_compat_kwargs():
    """n/s/axes/norm parity with numpy.fft and the JAX package."""
    rng = np.random.default_rng(0xA1)
    x = _rand((3, 100), rng)
    for norm in (None, "ortho", "forward"):
        for n in (None, 64, 128):
            for f in ("fft", "ifft"):
                want = getattr(np.fft, f)(x.astype(np.complex128), n=n, norm=norm)
                _gate_c64(getattr(tft, f)(x, n=n, norm=norm, device="cpu"),
                          getattr(jft, f)(x, n=n, norm=norm), want, 1)
    a = _rand((4, 6, 8), rng)
    a128 = a.astype(np.complex128)
    cases = [("fftn", {"axes": (0, 2), "norm": "ortho"}),
             ("fft2", {"s": (8, 12)}),
             ("ifftn", {"s": (4, 4), "axes": (1, 2), "norm": "forward"}),
             ("fftn", {"s": (5, 3, 9), "axes": (0, 1, 2), "norm": "forward"}),
             ("ifft2", {"axes": (0, 2), "norm": "ortho"})]
    for name, kw in cases:
        k = len(kw.get("axes", kw.get("s", (0, 0))))
        _gate_c64(getattr(tft, name)(a, device="cpu", **kw),
                  getattr(jft, name)(a, **kw), getattr(np.fft, name)(a128, **kw), k)
    _gate_c64(tft.fftn(a, 2, device="cpu"), jft.fftn(a, 2),
              np.fft.fftn(a128, axes=(-2, -1)), 2)
    with pytest.raises(ValueError):
        tft.fftn(a, axes=(0, 0), device="cpu")
    with pytest.raises(ValueError):
        tft.fftn(a, s=(4, 4), axes=(0,), device="cpu")
    with pytest.raises(ValueError):
        tft.fft(x, norm="bogus", device="cpu")


def test_dtype_promotion_and_tensor_io():
    """numpy parity: f64/c128 input -> complex128, else complex64; a numpy
    input gives numpy, a tensor a tensor on its own device."""
    rng = np.random.default_rng(RNG_SEED)
    xr = rng.standard_normal((6, 10))
    assert tft.fft2(xr, device="cpu").dtype == np.complex128
    assert tft.fft2(xr.astype(np.float32), device="cpu").dtype == np.complex64
    assert tft.fft2(xr.astype(np.int32), device="cpu").dtype == np.complex64
    assert tft.fft2(xr, dtype=np.complex64, device="cpu").dtype == np.complex64
    t = torch.as_tensor(_rand((6, 10), rng))
    out = tft.ifftn(t)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.complex64
    _gate_c64(out.numpy(), jft.ifftn(t.numpy()),
              np.fft.ifftn(t.numpy().astype(np.complex128)), 2)


def test_layout_one_copy_per_axis(monkeypatch):
    """Every pass runs its plan's batch-minor entry on a contiguous (n, B)
    plane; the axis that leads in memory goes first and is not copied."""
    rng = np.random.default_rng(RNG_SEED)
    shape = (64, 12, 256)  # B1's plain version, a DFT product, B1
    plan = NdFftPlan(shape, backend="vpu", device="cpu")
    seen = []
    for p in plan.plans:
        run = p.transform_planar_bm

        def spy(re, im, mode, run=run, size=p.size):
            assert re.is_contiguous() and re.shape[0] == size and re.ndim == 2
            seen.append((size, re.data_ptr()))
            return run(re, im, mode)
        monkeypatch.setattr(p, "transform_planar_bm", spy)
    re = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    im = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    ore, oim = plan.fft_planar(re, im)
    assert [s for s, _ in seen] == [64, 12, 256]
    assert seen[0][1] == re.data_ptr()
    x128 = re.double().numpy() + 1j * im.double().numpy()
    assert _rel(ore.numpy() + 1j * oim.numpy(), np.fft.fftn(x128)) <= C64_NP * np.sqrt(3)
    # The result is a view in the caller's axis order of the last pass's
    # layout; a second call starts from the axis that leads in memory.
    seen.clear()
    back = plan.ifft_planar(ore, oim)
    outer = max(range(3), key=ore.stride)
    assert seen[0] == (shape[outer], ore.data_ptr()) and outer == 2
    assert _rel(back[0].numpy() + 1j * back[1].numpy(), x128) <= C64_NP * np.sqrt(3)


@pytest.mark.parametrize("backend", ["auto", "vpu"])
def test_from_plans_of_jax_axes(backend, tmp_path):
    """An NdFftPlan built from the axes of a JAX NdFftPlan (each saved with
    save_plan, read with load_jax_plan) matches the JAX plan on one input."""
    shape = (64, 12) if backend == "vpu" else (10, 12)
    ref = JNdFftPlan(shape, backend=backend)
    axes = []
    for i, p in enumerate(ref.plans):
        path = str(tmp_path / f"axis{i}.npz")
        save_plan(p, path)
        axes.append(load_jax_plan(path, device="cpu"))
    plan = NdFftPlan.from_plans(axes)
    assert plan.shape == shape and plan.size == int(np.prod(shape))
    assert [plan_tree(p) for p in plan.plans] == [plan_tree(p) for p in ref.plans]
    x = _rand((2, *shape), np.random.default_rng(RNG_SEED))
    for mode in (Transform.FFT, Transform.IFFT):
        want = (np.fft.fft2 if mode.is_forward else np.fft.ifft2)(x.astype(np.complex128))
        _gate_c64(plan.transform(x, mode), ref.transform(x, jft.Transform(int(mode))),
                  want, 2)
    with pytest.raises(ValueError):
        NdFftPlan.from_plans([axes[0], tft.create_fft(12, torch.complex128,
                                                      device="cpu")])


@pytest.mark.parametrize("mode", [Transform.FFT, Transform.IFFT,
                                  Transform.SQRT_SCALED_IFFT])
def test_nd_gradcheck_c128(mode):
    plan = NdFftPlan((4, 6), torch.complex128, device="cpu")
    rng = np.random.default_rng(RNG_SEED)
    re = torch.tensor(rng.standard_normal((2, 4, 6)), requires_grad=True)
    im = torch.tensor(rng.standard_normal((2, 4, 6)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: plan.transform_planar(a, b, mode), (re, im))


def test_to_moves_every_axis_plan():
    plan = NdFftPlan((8, 8, 6), device="cpu")
    assert plan.plans[0] is plan.plans[1]
    plan.to("meta")
    assert plan.device.type == "meta"
    assert all(b.device.type == "meta" for p in plan.plans for b in p.buffers())
    assert plan.plans[0] is not tft.create_fft(8, device="cpu")


def test_nd_plan_cache_is_per_device():
    """The module functions run the planner's cached 1-D plans, one per
    (size, dtype, device): no second cache of N-D plans."""
    a = tnd._axis_plans((8, 12, 8), torch.complex64, "cpu")
    assert a[0] is a[2] is tft.create_fft(8, device="cpu")
    assert tnd._axis_plans([8, 12], np.complex64, torch.device("cpu"))[1] is a[1]
    assert tnd._axis_plans((8, 12), torch.complex128, "cpu")[0] is not a[0]
    assert not hasattr(tnd, "_nd_plan")


def test_default_device_is_the_card(monkeypatch):
    """Every entry point of the surface plans on the card unless the caller
    asks for the CPU: the defaults name "cuda", and with no card each call
    raises naming it before any transform runs."""
    entry = (tft.NdFftPlan, tft.fftn, tft.ifftn, tft.fft2, tft.ifft2,
             tft.rfftn, tft.irfftn, tft.rfft2, tft.irfft2, tft.hfftn,
             tft.ihfftn, tft.hfft2, tft.ihfft2, tft.dct, tft.idct, tft.dst,
             tft.idst, tft.dctn, tft.idctn, tft.dstn, tft.idstn, tft.fht,
             tft.ifht, tft.transform_planar, tft.fft_planar, tft.ifft_planar)
    for fn in entry:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((8, 8), np.float32)
    calls = (lambda: tft.NdFftPlan((8, 8)), lambda: tft.fft2(x),
             lambda: tft.rfftn(x), lambda: tft.irfft2(x.astype(np.complex64)),
             lambda: tft.hfft2(x.astype(np.complex64)), lambda: tft.ihfft2(x),
             lambda: tft.dctn(x), lambda: tft.dst(x, 3), lambda: tft.fht(x, 0.1, 0.5),
             lambda: tft.transform_planar(x, x, Transform.FFT),
             lambda: tft.fft_planar(x, x), lambda: tft.ifft_planar(x, x))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()


def test_module_planar_wrappers():
    """transform_planar / fft_planar / ifft_planar plan on the planes' own
    device through the cached create_fft, as the JAX package's wrappers."""
    rng = np.random.default_rng(RNG_SEED)
    re = rng.standard_normal((3, 48)).astype(np.float32)
    im = rng.standard_normal((3, 48)).astype(np.float32)
    x128 = re.astype(np.float64) + 1j * im
    for fn, jfn, want in ((tft.fft_planar, jft.fft_planar, np.fft.fft(x128)),
                          (tft.ifft_planar, jft.ifft_planar, np.fft.ifft(x128))):
        ore, oim = fn(torch.as_tensor(re), torch.as_tensor(im))
        jre, jim = jfn(re, im)
        _gate_c64(ore.numpy() + 1j * oim.numpy(),
                  np.asarray(jre) + 1j * np.asarray(jim), want, 1)
    ore, _ = tft.transform_planar(torch.as_tensor(re).double(),
                                  torch.as_tensor(im).double(), Transform.FFT,
                                  torch.complex128)
    assert ore.dtype == torch.float64
    # numpy planes run on `device` and come back as numpy
    ore, oim = tft.fft_planar(re, im, device="cpu")
    assert isinstance(ore, np.ndarray) and isinstance(oim, np.ndarray)
    jre, jim = jft.fft_planar(re, im)
    _gate_c64(ore + 1j * oim, np.asarray(jre) + 1j * np.asarray(jim),
              np.fft.fft(x128), 1)
    assert tft.create_fft(48, device="cpu") is tft.create_fft(48, device="cpu")


def test_set_workers():
    assert tft.get_workers() == 1
    with tft.set_workers(4):
        assert tft.get_workers() == 4
        with tft.set_workers(2):
            assert tft.get_workers() == 2
        assert tft.get_workers() == 4
    assert tft.get_workers() == 1
