"""Planner routing, plan interchange, autograd and import hygiene of the port.

The slice as a whole: ``create_fft_f32`` through each backend against the JAX
package's ``create_fft_f32`` on the same inputs; the plan tree of the ``vpu``
and ``mxu`` routes against the JAX package's, size by size; plans saved by the
JAX package's ``save_plan`` and loaded with ``load_jax_plan``; the gradient of
the autograd ``Function`` against ``jax.grad`` through the JAX VpuFftPlan and
against the analytic linear VJP for the other families.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fourier_tpu as jft
from fourier_tpu import Transform as JTransform
from fourier_tpu.plan.serialize import save_plan
from fourier_tpu.plan.vpu import VpuFftPlan as JVpuFftPlan

import fourier_tpu_torch as tft
from fourier_tpu_torch import Transform
from fourier_tpu_torch.plan import (AutosortPlan, BluesteinPlan,
                                    FourStepLocalPlan, MxuFftPlan,
                                    VpuBluesteinPlan, VpuDdFftPlan, VpuFftPlan,
                                    load_jax_plan, plan_tree)

RNG_SEED = 0x5EED
REL_L2 = 1e-6
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


def _rand(shape, rng, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_cpu_routing():
    tft.clear_plan_cache()
    for n in (1, 4, 96, 128, 243, 4096):
        assert isinstance(tft.create_fft_f32(n, device="cpu"), AutosortPlan), n
    for n in (5, 73, 100, 1013):
        assert isinstance(tft.create_fft_f32(n, device="cpu"), BluesteinPlan), n
    assert isinstance(tft.create_fft_f64(64, device="cpu"), AutosortPlan)
    for n in (64, 320, 625, 4096, 16384):
        plan = tft.create_fft(n, backend="vpu", device="cpu")
        assert isinstance(plan, VpuFftPlan) and "family=vpu" in repr(plan)
    assert "family=stockham" in repr(tft.create_fft_f32(96, device="cpu"))


def test_vpu_backend_interim_routing():
    """Outside B1's domain the vpu route is the JAX package's but for the
    card's crossover: DFT products for sizes B2 does not take (n <= 16), B2
    in place of a full-size product where B2 takes the size (48; the mxu
    route keeps the product) and for primes past the direct-product
    crossover, B3 four-step for large composites, Bluestein over a four-step
    inner for large primes; complex128 raises."""
    moved = tft.create_fft(48, backend="vpu", device="cpu")
    assert isinstance(moved, VpuBluesteinPlan) and moved.m_inner == 96
    assert isinstance(tft.create_fft(48, backend="mxu", device="cpu"), MxuFftPlan)
    prime = tft.create_fft(1013, backend="vpu", device="cpu")
    assert isinstance(prime, VpuBluesteinPlan) and prime.m_inner == 2048
    assert "family=vpu" in repr(prime)
    small = tft.create_fft(7, backend="vpu", device="cpu")
    assert isinstance(small, MxuFftPlan) and small.single_phase
    large = tft.create_fft(10007, backend="vpu", device="cpu")
    assert isinstance(large, BluesteinPlan)
    assert isinstance(large.inner, FourStepLocalPlan)
    assert isinstance(large.inner.row_plan, VpuFftPlan)
    for backend in ("vpu", "mxu"):
        with pytest.raises(ValueError):
            tft.create_fft(64, torch.complex128, backend=backend, device="cpu")


@pytest.mark.parametrize("backend", ["mxu", "dd", "measure"])
def test_unported_backends_raise(backend):
    if backend == "mxu":
        # The backend is ported, and so are its Pallas kernels (B9).
        assert isinstance(tft.create_fft(64, backend="mxu", device="cpu"), MxuFftPlan)
        plan = MxuFftPlan.create(64, impl="pallas", device="cpu")
        assert plan.impl == "pallas" and plan.single_phase
    elif backend == "dd":
        # Ported: the complex128 route; complex64 raises as in the JAX package.
        plan = tft.create_fft(64, torch.complex128, backend="dd", device="cpu")
        assert isinstance(plan, VpuDdFftPlan)
        with pytest.raises(ValueError, match="complex128"):
            tft.create_fft(64, backend="dd", device="cpu")
    else:
        # Ported: measured planning; on the CPU one family is eligible, so
        # it plans the Stockham family without timing.
        plan = tft.create_fft(64, backend=backend, device="cpu", cache=False)
        assert isinstance(plan, AutosortPlan)
    with pytest.raises(ValueError):
        tft.create_fft(64, backend="nonsense", device="cpu")


# fft_bench.rs's 15 c64 sizes (the benchmark's ``c64-1d-sizes`` cell) are
# among them: ``auto`` on the card is ``vpu``, so its routes are the vpu
# column's.
BENCH15_SIZES = (256, 512, 1024, 243, 729, 2187, 125, 625, 3125, 222, 722, 1418,
                 191, 439, 1013)
ROUTE_SIZES = tuple(sorted({1, 7, 32, 48, 64, 100, 125, 200, 222, 439, 722, 769, 818,
                            1013, 1418, 4093, 4099, 10007, 20000, 32768, 65536,
                            262144, 458752, *BENCH15_SIZES}))


# The card's own vpu route where it leaves the JAX package's: the sizes of
# ROUTE_SIZES that the JAX rules run as one full-size DFT product and B2
# takes run B2 (the JAX package's VpuBluesteinPlan tree; plan/planner.py,
# _card_bluestein).
CARD_ROUTE = {n: ("VpuBluesteinPlan", n, m) for n, m in (
    (32, 64), (48, 96), (100, 200), (125, 256), (191, 384), (222, 480),
    (439, 960), (722, 1536))}


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
@pytest.mark.parametrize("n", ROUTE_SIZES)
def test_route_matches_jax(n, backend):
    """Every size plans the same tree in both packages, but the card's
    crossover (CARD_ROUTE): there the JAX route plans one full-size product
    and the port B2, the tree of the JAX package's own VpuBluesteinPlan."""
    from fourier_tpu.plan.bluestein_fused import VpuBluesteinPlan as JVpuBluesteinPlan

    mine = tft.create_fft(n, backend=backend, cache=False, device="cpu")
    ref = jft.create_fft(n, backend=backend, cache=False)
    if backend == "vpu" and n in CARD_ROUTE:
        assert plan_tree(ref) == ("MxuFftPlan", n, (1, n))
        assert plan_tree(mine) == CARD_ROUTE[n] == plan_tree(JVpuBluesteinPlan.create(n))
    else:
        assert plan_tree(mine) == plan_tree(ref)


# The complex128 route of the JAX package on a TPU (``_create_dd`` with
# jax.default_backend patched to "tpu"), as plan_tree gives it; a JAX
# DdFftPlan reads as ("AutosortPlan", n) or ("BluesteinPlan", n, inner).
DD_ROUTE = {
    12: ("AutosortPlan", 12),
    6561: ("AutosortPlan", 6561),
    65536: ("AutosortPlan", 65536),
    17: ("VpuDdBluesteinPlan", 17, 64),
    32: ("VpuDdBluesteinPlan", 32, 64),
    100: ("VpuDdBluesteinPlan", 100, 256),
    125: ("VpuDdBluesteinPlan", 125, 256),
    191: ("VpuDdBluesteinPlan", 191, 512),
    222: ("VpuDdBluesteinPlan", 222, 512),
    439: ("VpuDdBluesteinPlan", 439, 1024),
    722: ("VpuDdBluesteinPlan", 722, 2048),
    1013: ("VpuDdBluesteinPlan", 1013, 2048),
    **{n: ("VpuDdFftPlan", n) for n in (64, 243, 256, 512, 625, 729, 1000, 1024,
                                         3000, 4096)},
    1418: ("BluesteinPlan", 1418, ("VpuDdFftPlan", 4096)),
    4099: ("BluesteinPlan", 4099, ("DdSplitPow2Plan", 16384, (
        "DdSplitPow2Plan", 8192, ("VpuDdFftPlan", 4096)))),
    20000: ("BluesteinPlan", 20000, ("AutosortPlan", 65536)),
    2187: ("DdSplitRadixPlan", 2187, 3, ("VpuDdFftPlan", 729)),
    3125: ("DdSplitRadixPlan", 3125, 5, ("VpuDdFftPlan", 625)),
    10000: ("DdSplitRadixPlan", 10000, 5, ("VpuDdFftPlan", 2000)),
    6144: ("DdSplitPow2Plan", 6144, ("VpuDdFftPlan", 3072)),
    8192: ("DdSplitPow2Plan", 8192, ("VpuDdFftPlan", 4096)),
    12288: ("DdSplitPow2Plan", 12288, ("DdSplitPow2Plan", 6144,
                                       ("VpuDdFftPlan", 3072))),
    16384: ("DdSplitPow2Plan", 16384, ("DdSplitPow2Plan", 8192,
                                       ("VpuDdFftPlan", 4096))),
}


@pytest.fixture
def tpu_backend(monkeypatch):
    """The JAX package's planner as it plans on a TPU (tests/test_vpu_dd.py)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


@pytest.mark.parametrize("n", sorted(DD_ROUTE))
def test_dd_route_matches_jax(n, tpu_backend):
    """The c128 route plans the JAX package's TPU tree at every size of the
    table (the port's names; the same class names but DdFftPlan's)."""
    from fourier_tpu.plan import planner as jplanner

    mine = tft.create_fft(n, torch.complex128, backend="dd", cache=False, device="cpu")
    assert plan_tree(mine) == plan_tree(jplanner._create_dd(n)) == DD_ROUTE[n]


def test_c128_routing_by_device():
    """c128 ``auto`` is the f64 Stockham family on the CPU (as the JAX
    package off the TPU with x64) and ``dd`` on a card; ``dd`` on the CPU
    builds the card's tree over the plain versions."""
    assert isinstance(tft.create_fft_f64(1024, device="cpu"), AutosortPlan)
    assert isinstance(tft.create_fft_f64(1013, device="cpu"), BluesteinPlan)
    plan = tft.create_fft_f64(1024, backend="dd", device="cpu")
    assert isinstance(plan, VpuDdFftPlan) and plan.device.type == "cpu"
    assert "family=vpu" in repr(plan)


def test_default_device_is_the_card():
    """Every entry point plans on the card unless asked for the CPU: with no
    card it raises, naming the card; with one, the plan lands there."""
    x = np.zeros(64, np.complex64)
    calls = (lambda: tft.create_fft_f32(64), lambda: tft.create_fft_f64(1024),
             lambda: tft.create_fft(64), lambda: tft.RfftPlan(64),
             lambda: VpuFftPlan.create(64), lambda: tft.fft(x),
             lambda: tft.ifft(x), lambda: tft.rfft(x.real), lambda: tft.transform(x, 0))
    if torch.cuda.is_available():
        assert tft.create_fft_f64(1024).device.type == "cuda"
        assert isinstance(tft.create_fft_f64(1024), VpuDdFftPlan)
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()
    assert isinstance(tft.create_fft_f64(1024, device="cpu"), AutosortPlan)


@pytest.mark.parametrize("n", [100, 1024, 1418, 2187])
def test_create_fft_f64_dd_matches_reference(n):
    """The c128 slice end to end on the CPU: the port's dd route (plain
    versions of B6, B7, B8) against the JAX package's create_fft_f64 (its
    f64 stockham family off the TPU) on the same input, and np.fft."""
    rng = np.random.default_rng(RNG_SEED + n)
    x = _rand((3, n), rng, np.complex128)
    mine = tft.create_fft_f64(n, backend="dd", device="cpu")
    ref = jft.create_fft_f64(n)
    for mode in (Transform.FFT, Transform.IFFT):
        got = mine.transform(x, mode)
        want = np.asarray(ref.transform(x, JTransform(int(mode))))
        assert got.dtype == np.complex128 and got.shape == x.shape
        assert _rel(got, want) <= 1e-12, (n, mode)
        npw = np.fft.fft(x) if mode.is_forward else np.fft.ifft(x)
        assert _rel(got, npw) <= 1e-12, (n, mode)


_DD_KINDS = {"vpu_dd": 384, "dd_bluestein": 100, "split_pow2": 8192,
             "split_radix": 2187, "dd_stockham": 12, "dd_bluestein_composed": 1418}


@pytest.mark.parametrize("kind", sorted(_DD_KINDS))
def test_load_jax_plan_c128(kind, tmp_path, tpu_backend):
    """Each double-word plan class of the JAX package loads as the port's
    f64 plan of the same tree, its tables rebuilt as hi + lo, and agrees
    with a freshly planned port plan within rel-L2 1e-13."""
    from fourier_tpu.plan import planner as jplanner

    n = _DD_KINDS[kind]
    ref = jplanner._create_dd(n)
    path = tmp_path / "dd.npz"
    save_plan(ref, str(path))
    loaded = load_jax_plan(str(path), device="cpu")
    own = tft.create_fft(n, torch.complex128, backend="dd", cache=False, device="cpu")
    assert type(loaded) is type(own) and plan_tree(loaded) == plan_tree(own)
    rng = np.random.default_rng(RNG_SEED + n)
    x = _rand((2, n), rng, np.complex128)
    for mode in Transform:
        assert _rel(loaded.transform(x, mode), own.transform(x, mode)) <= 1e-13


# 16 and 17: the last size the vpu route keeps on the product, the first it
# runs as B2.
@pytest.mark.parametrize("n", sorted({16, 17, 64, 96, 100, 320, 1013, 1024, *BENCH15_SIZES}))
@pytest.mark.parametrize("backend", ["auto", "vpu"])
def test_create_fft_f32_matches_reference(n, backend):
    """The slice end to end on the CPU, against the JAX package's default
    c64 plan (its stockham family off-TPU) on the same input."""
    rng = np.random.default_rng(RNG_SEED + n)
    x = _rand((3, n), rng)
    mine = tft.create_fft_f32(n, backend=backend, device="cpu")
    ref = jft.create_fft_f32(n)
    for mode in (Transform.FFT, Transform.IFFT):
        got = mine.transform(x, mode)
        want = np.asarray(ref.transform(x, JTransform(int(mode))))
        assert got.dtype == np.complex64 and got.shape == x.shape
        assert _rel(got, want) <= REL_L2, (n, mode)


def test_device_mismatch_raises():
    plan = tft.create_fft_f32(64, backend="vpu", device="cpu")
    meta = torch.zeros(2, 64, device="meta")
    with pytest.raises(ValueError, match="plan on cpu"):
        plan.transform_planar(meta, meta)
    with pytest.raises(ValueError):
        plan.transform(torch.zeros(2, 64, dtype=torch.complex64, device="meta"))


@pytest.mark.cuda
def test_cpu_plan_given_cuda_tensor_raises(cuda_device):
    plan = tft.create_fft_f32(64, backend="vpu", device="cpu")
    x = torch.zeros(2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="plan on cpu"):
        plan.transform_planar(x, x)
    gpu = tft.create_fft_f32(64, device=cuda_device)
    assert isinstance(gpu, VpuFftPlan)
    with pytest.raises(ValueError):
        gpu.transform_planar(torch.zeros(2, 64), torch.zeros(2, 64))


def _jax_vpu_inner(m, dt):
    return JVpuFftPlan.create(m, dt) or jft.AutosortPlan.create(m, dt)


_ROUTED = {"mxu_direct": (439, "mxu"), "mxu_two_phase": (2048, "mxu"),
           "bluestein_fused": (1418, "vpu"), "four_step": (32768, "vpu"),
           "four_step_mxu_row": (20000, "vpu"), "bluestein_four_step": (10007, "vpu")}


@pytest.mark.parametrize("kind", ["autosort", "bluestein", "vpu", "bluestein_vpu",
                                  *_ROUTED])
def test_load_jax_plan_round_trip(kind, tmp_path):
    n = {"autosort": 96, "bluestein": 73, "vpu": 320, "bluestein_vpu": 37,
         **{k: v[0] for k, v in _ROUTED.items()}}[kind]
    if kind in _ROUTED:
        ref = jft.create_fft(n, backend=_ROUTED[kind][1], cache=False)
        own = tft.create_fft(n, backend=_ROUTED[kind][1], cache=False, device="cpu")
    elif kind == "autosort":
        ref = jft.AutosortPlan.create(n, np.complex64)
        own = AutosortPlan.create(n, device="cpu")
    elif kind == "bluestein":
        ref = jft.BluesteinPlan.create(n, np.complex64)
        own = BluesteinPlan.create(n, device="cpu")
    elif kind == "vpu":
        ref = JVpuFftPlan.create(n)
        own = VpuFftPlan.create(n, device="cpu")
    else:
        ref = jft.BluesteinPlan.create(n, np.complex64, inner_factory=_jax_vpu_inner)
        own = BluesteinPlan.create(
            n, inner_factory=lambda m, dt, dev: VpuFftPlan.create(m, dt, dev),
            device="cpu")
    path = tmp_path / "plan.npz"
    save_plan(ref, str(path))
    loaded = load_jax_plan(str(path), device="cpu")
    assert type(loaded) is type(own) and repr(loaded) == repr(own)
    with np.load(path) as data:
        assert type(load_jax_plan(data, device="cpu")) is type(own)
    rng = np.random.default_rng(RNG_SEED)
    x = _rand((2, n), rng)
    for mode in Transform:
        a, b = loaded.transform(x, mode), own.transform(x, mode)
        np.testing.assert_array_equal(a, b)


def test_load_jax_plan_unported_class_raises(tmp_path):
    """No plan class of the JAX package is left unported: the last one,
    DdMxuDirectPlan, loads as the port's; an xla_packed MxuFftPlan as the
    port's plan of that impl."""
    from fourier_tpu.precision.dd_mxu import DdMxuDirectPlan

    from fourier_tpu_torch.precision import DdMxuDirectPlan as PortDdMxuDirectPlan

    path = tmp_path / "dd.npz"
    save_plan(DdMxuDirectPlan.create(64), str(path))
    assert isinstance(load_jax_plan(str(path), device="cpu"), PortDdMxuDirectPlan)
    # Ported: an xla_packed plan loads as the port's plan of that impl.
    packed = jft.plan.mxu.MxuFftPlan.create(2048, impl="xla_packed")
    save_plan(packed, str(path))
    loaded = load_jax_plan(str(path), device="cpu")
    assert isinstance(loaded, MxuFftPlan) and loaded.impl == "xla_packed"


def _jax_pallas_inner(m, dt):
    return jft.plan.mxu.MxuFftPlan.create(m, dt, impl="pallas", tb=4)


_MXU_IMPLS = {"pallas_single": (100, "pallas"), "pallas_two_phase": (1000, "pallas"),
              "packed_single": (64, "xla_packed"), "packed_two_phase": (2048, "xla_packed"),
              "bluestein_pallas_inner": (73, None)}


@pytest.mark.parametrize("kind", sorted(_MXU_IMPLS))
def test_load_jax_plan_mxu_impls(kind, tmp_path):
    """Every MxuFftPlan impl of a JAX save_plan file (tables, tb and impl
    of its aux) loads as the port's plan of that impl, bitwise equal to a
    freshly built one on the CPU; also as a Bluestein inner."""
    n, impl = _MXU_IMPLS[kind]
    if impl is None:
        ref = jft.BluesteinPlan.create(n, np.complex64, inner_factory=_jax_pallas_inner)
        own = BluesteinPlan.create(n, inner_factory=lambda m, dt, dev: MxuFftPlan.create(
            m, dt, dev, impl="pallas", tb=4), device="cpu")
    else:
        ref = jft.plan.mxu.MxuFftPlan.create(n, impl=impl, tb=4)
        own = MxuFftPlan.create(n, impl=impl, tb=4, device="cpu")
    path = tmp_path / "mxu.npz"
    save_plan(ref, str(path))
    loaded = load_jax_plan(str(path), device="cpu")
    assert type(loaded) is type(own) and repr(loaded) == repr(own)
    assert "tb=4" in repr(loaded)
    rng = np.random.default_rng(RNG_SEED + n)
    x = _rand((3, n), rng)
    for mode in Transform:
        np.testing.assert_array_equal(loaded.transform(x, mode), own.transform(x, mode))
        assert _rel(loaded.transform(x, mode),
                    np.asarray(ref.transform(x, JTransform(int(mode))))) <= 2e-6


@pytest.mark.parametrize("mode", [Transform.FFT, Transform.IFFT])
def test_grad_matches_jax_vpu(mode):
    """d/dx of sum(Re(y)*a + Im(y)*b), y = plan(x): the autograd Function's
    backward (the plan in the transposed mode) against jax.grad through the
    JAX VpuFftPlan's linear custom VJP (Pallas kernel, interpret mode)."""
    n = 64
    rng = np.random.default_rng(RNG_SEED)
    re, im, a, b = (rng.standard_normal((3, n)).astype(np.float32) for _ in range(4))
    jplan = JVpuFftPlan.create(n)

    def loss(r, i):
        yr, yi = jplan.transform_planar(r, i, JTransform(int(mode)))
        return jnp.sum(yr * a + yi * b)

    jgr, jgi = jax.grad(loss, argnums=(0, 1))(re, im)
    plan = VpuFftPlan.create(n, device="cpu")
    tre = torch.tensor(re, requires_grad=True)
    tim = torch.tensor(im, requires_grad=True)
    yr, yi = plan.transform_planar(tre, tim, mode)
    (yr * torch.as_tensor(a) + yi * torch.as_tensor(b)).sum().backward()
    got = tre.grad.numpy() + 1j * tim.grad.numpy()
    want = np.asarray(jgr) + 1j * np.asarray(jgi)
    assert _rel(got, want) <= REL_L2


@pytest.mark.parametrize("kind", ["mxu", "bluestein_fused", "four_step"])
@pytest.mark.parametrize("batch_minor", [False, True])
def test_grad_new_families_linear_vjp(kind, batch_minor):
    """d/dx of Re(sum(conj(c) * y)), y = plan(x) in each mode, is F^H c: the
    autograd Function's backward against the analytic VJP in numpy."""
    n, plan = {
        "mxu": (125, MxuFftPlan.create(125, device="cpu")),
        "bluestein_fused": (73, VpuBluesteinPlan.create(73, device="cpu")),
        "four_step": (4096, FourStepLocalPlan.create(
            4096, torch.complex64, 64, 64,
            lambda m, dt, dev: VpuFftPlan.create(m, dt, dev), device="cpu")),
    }[kind]
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((2, 2, n))
    c = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n)))
    for mode in Transform:
        re = torch.tensor(x[0].astype(np.float32), requires_grad=True)
        im = torch.tensor(x[1].astype(np.float32), requires_grad=True)
        if batch_minor:
            yr, yi = plan.transform_planar_bm(re.T, im.T, mode)
            yr, yi = yr.T, yi.T
        else:
            yr, yi = plan.transform_planar(re, im, mode)
        loss = (yr * torch.tensor(c.real, dtype=torch.float32)
                + yi * torch.tensor(c.imag, dtype=torch.float32)).sum()
        loss.backward()
        got = re.grad.numpy() + 1j * im.grad.numpy()
        # y = s * DFT(x) (forward) or s * n * IDFT(x): F^H c swaps the two.
        s = mode.scale(n) or 1.0
        want = (np.fft.ifft(c, axis=-1) * n if mode.is_forward
                else np.fft.fft(c, axis=-1)) * s
        assert _rel(got, want) <= 5e-6, (kind, mode)


def test_gradcheck_c128_both_layouts():
    plan = tft.create_fft_f64(12, device="cpu")
    rng = np.random.default_rng(RNG_SEED)
    re = torch.tensor(rng.standard_normal((2, 12)), requires_grad=True)
    im = torch.tensor(rng.standard_normal((2, 12)), requires_grad=True)
    for mode in Transform:
        assert torch.autograd.gradcheck(
            lambda r, i: plan.transform_planar(r, i, mode), (re, im))
        assert torch.autograd.gradcheck(
            lambda r, i: plan.transform_planar_bm(r.T, i.T, mode), (re, im))


def test_module_level_fft_ifft():
    rng = np.random.default_rng(RNG_SEED)
    x = _rand((4, 24), rng, np.complex128)
    for norm in (None, "backward", "ortho", "forward"):
        np.testing.assert_allclose(tft.fft(x, norm=norm, device="cpu"), np.fft.fft(x, norm=norm),
                                   atol=1e-10)
        np.testing.assert_allclose(tft.ifft(x, n=30, axis=0, norm=norm, device="cpu"),
                                   np.fft.ifft(x, n=30, axis=0, norm=norm), atol=1e-10)
    got = tft.fft(torch.as_tensor(x.astype(np.complex64)), n=16, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.fft.fft(x, n=16), atol=1e-4)
    with pytest.raises(ValueError):
        tft.fft(x, norm="bogus", device="cpu")


def test_import_leaves_jax_out():
    """Importing every module of the port loads no jax (nor fourier_tpu)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fourier_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'fourier_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fourier_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
