"""The port's plan files (``fourier_tpu_torch.plan.serialize``) against the
JAX package's (``fourier_tpu.plan.serialize``).

Counterparts of ``tests/test_serialize.py``'s plan-file tests on the same
numpy inputs (its three export tests have theirs in
``tests/test_torch_aot.py``): plans of 64 (Stockham autosort) and 73
(Bluestein over an inner plan) in {c64, c128} x {forward, inverse}, the
MXU and fused-Stockham plans, bytes, the pickle-free allowlist. Beyond
them: a loaded port plan against the JAX package's loaded plan (rel-L2
<= 1e-6 c64, <= 1e-12 c128: two roundings of the same transform, each near
exact) and against np.fft; every route's plan (the card's trees, built on
the CPU) bitwise equal after a round trip, buffers and outputs; no
trigonometry and no plan-time FFT during a load; the errors across the two
formats.
"""

import json

import numpy as np
import pytest
import torch

import fourier_tpu as jft
from fourier_tpu import Transform as JTransform
from fourier_tpu.plan import MxuFftPlan as JMxuFftPlan
from fourier_tpu.plan.serialize import load_plan as jload_plan
from fourier_tpu.plan.serialize import save_plan as jsave_plan
from fourier_tpu.plan.vpu import VpuFftPlan as JVpuFftPlan

import fourier_tpu_torch as tft
from fourier_tpu_torch import Transform
from fourier_tpu_torch.plan import (MxuFftPlan, VpuFftPlan, load_jax_plan,
                                    load_plan, plan_to_bytes, plan_tree, save_plan)
from fourier_tpu_torch.plan import serialize
from fourier_tpu_torch.precision import DdFftPlan, DdMxuDirectPlan

RNG_SEED = 0x57A71C
GATES = {np.complex64: 1e-6, np.complex128: 1e-12}


def _rand(shape, rng, dtype):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _oracle(x, mode):
    return np.fft.fft(x, axis=-1) if mode.is_forward else np.fft.ifft(x, axis=-1)


@pytest.mark.parametrize("n", [64, 73])
@pytest.mark.parametrize("dtype,tol", [(np.complex64, 1e-4), (np.complex128, 1e-10)])
def test_saved_plan_matches_oracle(tmp_path, n, dtype, tol):
    """The JAX test's oracle check and bitwise check, and the loaded plan
    against the JAX package's loaded plan on the same input."""
    rng = np.random.default_rng(RNG_SEED + n)
    plan = tft.create_fft(n, dtype, device="cpu", cache=False)
    save_plan(plan, str(tmp_path / "plan.npz"))
    loaded = load_plan(str(tmp_path / "plan.npz"), device="cpu")
    assert type(loaded) is type(plan) and loaded.size == n
    jplan = jft.create_fft(n, dtype, cache=False)
    jsave_plan(jplan, str(tmp_path / "jplan.npz"))
    jloaded = jload_plan(str(tmp_path / "jplan.npz"))
    x = _rand(n, rng, dtype)
    for mode, jmode in ((Transform.FFT, JTransform.FFT), (Transform.IFFT, JTransform.IFFT)):
        got = loaded.transform(x, mode)
        want = _oracle(x.astype(np.complex128), mode)
        assert np.max(np.abs(got - want)) < tol * max(1.0, np.max(np.abs(want)))
        np.testing.assert_array_equal(got, plan.transform(x, mode))
        jgot = np.asarray(jloaded.transform(x, jmode))
        assert _rel(got, jgot) <= GATES[dtype], (n, mode)
        assert _rel(got, want) <= GATES[dtype], (n, mode)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mxu_plan_roundtrip(tmp_path, impl):
    """MxuFftPlan(384), the JAX test's size, in the planner's impl and the
    kernel's (B9b on the card); against the JAX package's round trip."""
    rng = np.random.default_rng(RNG_SEED)
    plan = MxuFftPlan.create(384, impl=impl, device="cpu")
    save_plan(plan, str(tmp_path / "mxu.npz"))
    loaded = load_plan(str(tmp_path / "mxu.npz"), device="cpu")
    assert (loaded.n1, loaded.n2, loaded.impl) == (plan.n1, plan.n2, plan.impl)
    x = _rand(384, rng, np.complex64)
    np.testing.assert_array_equal(loaded.fft(x), plan.fft(x))
    jplan = JMxuFftPlan.create(384)
    jsave_plan(jplan, str(tmp_path / "jmxu.npz"))
    jgot = np.asarray(jload_plan(str(tmp_path / "jmxu.npz")).fft(x))
    assert _rel(loaded.fft(x), jgot) <= 1e-6
    assert _rel(loaded.fft(x), np.fft.fft(x.astype(np.complex128))) <= 1e-6


def test_plan_to_bytes():
    plan = tft.create_fft(48, device="cpu", cache=False)
    blob = plan_to_bytes(plan)
    assert isinstance(blob, bytes) and len(blob) > 0
    loaded = load_plan(blob, device="cpu")
    x = _rand((3, 48), np.random.default_rng(RNG_SEED), np.complex64)
    np.testing.assert_array_equal(loaded.fft(x), plan.fft(x))


def test_vpu_plan_roundtrip(tmp_path):
    """VpuFftPlan(192) (schedule [8, 8, 3]), its kernels' tables included;
    against the JAX package's VpuFftPlan round trip."""
    rng = np.random.default_rng(RNG_SEED)
    plan = VpuFftPlan.create(192, device="cpu")
    save_plan(plan, str(tmp_path / "vpu.npz"))
    loaded = load_plan(str(tmp_path / "vpu.npz"), device="cpu")
    assert type(loaded) is VpuFftPlan and loaded.size == 192
    assert loaded.pair_fwd is not None  # 192 has a clustered body on the card
    x = _rand(192, rng, np.complex64)
    np.testing.assert_array_equal(loaded.fft(x), plan.fft(x))
    jplan = JVpuFftPlan.create(192)
    jsave_plan(jplan, str(tmp_path / "jvpu.npz"))
    assert _rel(loaded.fft(x), np.asarray(jload_plan(str(tmp_path / "jvpu.npz")).fft(x))) <= 1e-6


def test_load_plan_is_pickle_free(tmp_path):
    """Plan files carry no pickle: a class name off the allowlist is
    refused by name, and the npz loads with allow_pickle=False."""
    plan = tft.create_fft(48, device="cpu", cache=False)
    path = str(tmp_path / "plan.npz")
    save_plan(plan, path)
    with np.load(path, allow_pickle=False) as data:  # must not raise
        structure = json.loads(bytes(data["structure"].tobytes()))
        tampered = {k: data[k] for k in data.files if k != "structure"}
    structure["__plan__"] = "os.system"  # hostile class name
    tampered["structure"] = np.frombuffer(json.dumps(structure).encode(), dtype=np.uint8)
    bad = str(tmp_path / "bad.npz")
    with open(bad, "wb") as f:
        np.savez_compressed(f, **tampered)
    with pytest.raises(ValueError, match="unknown plan class"):
        load_plan(bad, device="cpu")


def test_allowlist_is_the_port_plan_classes(tmp_path):
    assert serialize.PLAN_CLASSES == tuple(sorted((
        "AutosortPlan", "BluesteinPlan", "FourStepLocalPlan", "MxuFftPlan", "VpuFftPlan",
        "VpuBluesteinPlan", "VpuDdFftPlan", "VpuDdBluesteinPlan", "DdSplitPow2Plan",
        "DdSplitRadixPlan", "DdFftPlan", "DdMxuDirectPlan", "RfftPlan", "FourStepPlan",
        "Fft2dPlan", "Fft3dPlan", "Rfft2dPlan", "Rfft3dPlan")))
    with pytest.raises(TypeError, match="not a plan class of the port"):
        save_plan(torch.nn.Linear(2, 2), str(tmp_path / "refused.npz"))
    assert not (tmp_path / "refused.npz").exists()


def _plan(route):
    kind, n, backend = route
    if kind == "rfft":
        dtype = torch.complex128 if backend == "dd" else torch.complex64
        return tft.RfftPlan(n, dtype, backend=backend, device="cpu")
    if kind == "mxu":
        return MxuFftPlan.create(n, impl=backend, device="cpu")
    if kind == "ddfft":
        return DdFftPlan(n, device="cpu")
    if kind == "ddmxu":
        return DdMxuDirectPlan.create(n, device="cpu")
    dtype = torch.complex128 if backend in ("dd", "stockham128") else torch.complex64
    backend = "stockham" if backend == "stockham128" else backend
    return tft.create_fft(n, dtype, backend=backend, device="cpu", cache=False)


# The card's trees (built on the CPU): B1 (64, 4096), B2 (1013, and 125 and
# 722 past the card's crossover), B1 + B3 (65536), composed Bluestein
# (4099); the mxu route's one full-size DFT product (722); B9b (384);
# B6 (1024), B8 (2187, 6144), B7 (1013), composed (1418); the f64 Stockham
# (12, 73); the real plans (B4 4096, B5 1013, the c128 one); DdFftPlan of
# both kinds (12, 73) and DdMxuDirectPlan (64), on no route.
ROUTES = [("c2c", n, "vpu") for n in (64, 4096, 1013, 65536, 125, 722, 4099)] + [
    ("c2c", 722, "mxu"), ("mxu", 384, "pallas"), ("mxu", 100, "xla_packed")] + [
    ("c2c", n, "dd") for n in (1024, 2187, 6144, 1013, 1418)] + [
    ("c2c", n, "stockham128") for n in (12, 73)] + [
    ("rfft", 4096, "vpu"), ("rfft", 1013, "vpu"), ("rfft", 1013, "dd"),
    ("ddfft", 12, "-"), ("ddfft", 73, "-"), ("ddmxu", 64, "-")]


def _buffers(module):
    """Every buffer slot of the plan and its sub-plans, None ones included."""
    return [(f"{prefix}.{name}", buf) for prefix, mod in module.named_modules()
            for name, buf in mod._buffers.items()]


def _run(plan, rng):
    if isinstance(plan, tft.RfftPlan):
        x = torch.as_tensor(rng.standard_normal((plan.n, 3)), dtype=plan.real_dtype)
        re, im = plan.rfft_planar_bm(x)
        return re, im, plan.irfft_planar_bm(re, im)
    real = np.float32 if plan.dtype == torch.complex64 else np.float64
    re, im = (torch.as_tensor(rng.standard_normal((plan.size, 3)).astype(real))
              for _ in range(2))
    return (*plan.transform_planar_bm(re, im, Transform.FFT),
            *plan.transform_planar_bm(re, im, Transform.SQRT_SCALED_IFFT))


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: f"{r[0]}-{r[1]}-{r[2]}")
def test_round_trip_is_bitwise(tmp_path, route):
    """Every buffer of the loaded plan (the non-persistent ones, the
    kernels' own tables and the clustered bodies' pair tables) is bitwise
    the saved plan's, through a file and through bytes, and so are the
    outputs."""
    plan = _plan(route)
    save_plan(plan, str(tmp_path / "p.npz"))
    for loaded in (load_plan(str(tmp_path / "p.npz"), device="cpu"),
                   load_plan(plan_to_bytes(plan), device="cpu")):
        assert plan_tree(loaded) == plan_tree(plan)
        want, got = _buffers(plan), _buffers(loaded)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (name, a), (_, b) in zip(want, got):
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), name
        for a, b in zip(_run(plan, np.random.default_rng(1)),
                        _run(loaded, np.random.default_rng(1))):
            assert torch.equal(a, b)


def _poison(monkeypatch):
    """Make every plan-time generator raise: numpy's trigonometry and FFT,
    and the twiddle generators wherever the port imported them."""
    import sys

    def boom(*_a, **_k):
        raise AssertionError("plan-time work during a load")

    for name in ("cos", "sin", "exp"):
        monkeypatch.setattr(np, name, boom)
    monkeypatch.setattr(np.fft, "fft", boom)
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("fourier_tpu_torch"):
            for name in ("stage_twiddles", "half_twiddle", "_chirp_tables",
                         "pair_tables", "make_kernel_tables", "make_stage_tables",
                         "dft_matrix", "twiddle_tables", "_split_twiddle_t"):
                if hasattr(mod, name):
                    monkeypatch.setattr(mod, name, boom)


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: f"{r[0]}-{r[1]}-{r[2]}")
def test_load_runs_no_trigonometry(monkeypatch, route):
    plan = _plan(route)
    blob = plan_to_bytes(plan)
    with monkeypatch.context() as m:
        _poison(m)
        with pytest.raises(AssertionError):  # the poison works
            np.cos(0.0)
        loaded = load_plan(blob, device="cpu")
    for a, b in zip(_run(plan, np.random.default_rng(2)),
                    _run(loaded, np.random.default_rng(2))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", [(64, np.complex64), (73, np.complex64),
                                   (1013, np.complex64), (64, np.complex128),
                                   (73, np.complex128)])
def test_loaded_plan_against_jax_loaded_plan(tmp_path, route):
    """The port's loaded plan (its card route, built on the CPU) against the
    JAX package's loaded plan and np.fft, every mode."""
    n, dtype = route
    backend = "vpu" if dtype == np.complex64 else "dd"
    plan = tft.create_fft(n, dtype, backend=backend, device="cpu", cache=False)
    loaded = load_plan(plan_to_bytes(plan), device="cpu")
    jsave_plan(jft.create_fft(n, dtype, cache=False), str(tmp_path / "j.npz"))
    jloaded = jload_plan(str(tmp_path / "j.npz"))
    x = _rand((4, n), np.random.default_rng(RNG_SEED + n), dtype)
    for mode in Transform:
        got = loaded.transform(x, mode)
        jgot = np.asarray(jloaded.transform(x, JTransform[mode.name]))
        x128 = x.astype(np.complex128)
        want = (np.fft.fft(x128, axis=-1) if mode.is_forward
                else np.fft.ifft(x128, axis=-1) * n) * (mode.scale(n) or 1.0)
        assert _rel(got, jgot) <= GATES[dtype], (n, mode)
        assert _rel(got, want) <= GATES[dtype], (n, mode)


def test_cross_format_errors(tmp_path):
    """A JAX file read by load_plan names load_jax_plan; a port file read by
    load_jax_plan names load_plan."""
    jsave_plan(jft.create_fft(64, cache=False), str(tmp_path / "j.npz"))
    with pytest.raises(ValueError, match="load_jax_plan"):
        load_plan(str(tmp_path / "j.npz"), device="cpu")
    assert load_jax_plan(str(tmp_path / "j.npz"), device="cpu").size == 64
    save_plan(tft.create_fft(64, device="cpu", cache=False), str(tmp_path / "t.npz"))
    with pytest.raises(ValueError, match="load_plan"):
        load_jax_plan(str(tmp_path / "t.npz"), device="cpu")
