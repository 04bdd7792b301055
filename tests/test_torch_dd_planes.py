"""The 4-plane double-word calls of the port against the JAX package's.

The JAX package runs complex128 on its f32-only chip as four f32 planes
(re_hi, re_lo, im_hi, im_lo); the port computes in f64, and its 4-plane
calls join the planes, run the f64 call and split the result
(``fourier_tpu_torch/precision/planes.py``). On the same seeded limbs, for
each c128 plan class (B6's ``VpuDdFftPlan``, B8's split plans, B7's
``VpuDdBluesteinPlan``, the f64 ``AutosortPlan`` and ``BluesteinPlan``,
``DdFftPlan``, ``DdMxuDirectPlan``), in all five modes, batch-minor and
batch-major:

* the port's four planes, joined, against the JAX plan's four, joined:
  rel-L2 <= 1e-12. The JAX Pallas plans run in interpret mode (as
  ``tests/test_torch_vpu_dd.py`` runs them) in the forward mode, and B6's
  also in the inverse; an interpret run compiles for 5-12 s a mode here,
  so the other modes hold the port against the JAX plan's exact-IEEE host
  path (its ``_apply_dd`` on numpy planes, the XLA ``DdFftPlan``'s
  double-word arithmetic in numpy);
* the same against ``np.fft``: rel-L2 <= 1e-12;
* the split: hi == f32(f64(hi) + f64(lo)) and |lo| <= ulp(hi)/2 on every
  output element.

Beside them: ``NdFftPlan``, ``RfftPlan`` (even and odd n) and
``ConvolvePlan`` (real and complex input) against their JAX ``*_dd``
twins; a complex64 plan refuses each 4-plane call with ``TypeError``; bad
limbs are refused with ``ValueError``; B = 0 gives empty planes; a JAX
``DdMxuDirectPlan`` file loads with ``load_jax_plan``; ``DdFftPlan`` and
``DdMxuDirectPlan`` keep the JAX classes' kinds and size limits.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fourier_tpu as jft
from fourier_tpu import Transform as JTransform
from fourier_tpu.plan.serialize import save_plan as jsave_plan
from fourier_tpu.precision import DdFftPlan as JDdFftPlan
from fourier_tpu.precision import ddreal as jdd
from fourier_tpu.precision.dd_bluestein import VpuDdBluesteinPlan as JVpuDdBluesteinPlan
from fourier_tpu.precision.dd_mxu import DdMxuDirectPlan as JDdMxuDirectPlan
from fourier_tpu.precision.dd_split import DdSplitPow2Plan as JDdSplitPow2Plan
from fourier_tpu.precision.dd_split import DdSplitRadixPlan as JDdSplitRadixPlan
from fourier_tpu.precision.vpu_dd_plan import VpuDdFftPlan as JVpuDdFftPlan
from fourier_tpu.signal import ConvolvePlan as JConvolvePlan

import fourier_tpu_torch as tft
from fourier_tpu_torch import Transform
from fourier_tpu_torch.plan import AutosortPlan, BluesteinPlan, load_jax_plan
from fourier_tpu_torch.precision import (DdFftPlan, DdMxuDirectPlan, DdSplitPow2Plan,
                                         DdSplitRadixPlan, VpuDdBluesteinPlan,
                                         VpuDdFftPlan, ddreal)

SEED = 0xDD4
GATE = 1e-12  # the reference's c128 gate
B = 3

# (id, the port's plan, the JAX plan of the same transform, whether the JAX
# plan is a Pallas one). The f64 AutosortPlan and BluesteinPlan are the
# port's counterparts of the JAX DdFftPlan's two kinds.
CLASSES = {
    "VpuDdFftPlan-64": (lambda: VpuDdFftPlan.create(64, device="cpu"),
                        lambda: JVpuDdFftPlan.create(64), True),
    "DdSplitPow2Plan-128": (lambda: DdSplitPow2Plan.create(128, device="cpu"),
                            lambda: JDdSplitPow2Plan.create(128), True),
    "DdSplitRadixPlan-192": (lambda: DdSplitRadixPlan.create(192, device="cpu"),
                             lambda: JDdSplitRadixPlan.create(192), True),
    "VpuDdBluesteinPlan-17": (lambda: VpuDdBluesteinPlan.create(17, device="cpu"),
                              lambda: JVpuDdBluesteinPlan.create(17), True),
    "AutosortPlan-12": (lambda: AutosortPlan.create(12, torch.complex128, device="cpu"),
                        lambda: JDdFftPlan(12), False),
    "BluesteinPlan-13": (lambda: BluesteinPlan.create(13, torch.complex128, device="cpu"),
                         lambda: JDdFftPlan(13), False),
    "DdFftPlan-12": (lambda: DdFftPlan(12, device="cpu"), lambda: JDdFftPlan(12), False),
    "DdFftPlan-13": (lambda: DdFftPlan(13, device="cpu"), lambda: JDdFftPlan(13), False),
    "DdMxuDirectPlan-16": (lambda: DdMxuDirectPlan.create(16, device="cpu"),
                           lambda: JDdMxuDirectPlan.create(16), False),
}
# The (class, mode) pairs that run the JAX Pallas plan in interpret mode.
INTERPRET = {(k, "FFT") for k, v in CLASSES.items() if v[2]} | {("VpuDdFftPlan-64", "IFFT")}


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _limbs(x):
    """The JAX package's split of complex128 numpy `x`: 4 f32 numpy planes."""
    return (*jdd.from_f64(np.real(x)), *jdd.from_f64(np.imag(x)))


def _join(planes):
    """complex128 numpy of 4 double-word planes (numpy, jax or torch)."""
    f = [np.asarray(p, np.float64) for p in planes]
    return (f[0] + f[1]) + 1j * (f[2] + f[3])


def _tensors(planes):
    return [torch.as_tensor(np.ascontiguousarray(p)) for p in planes]


def _np_transform(x, mode, axis=-1):
    n = x.shape[axis]
    y = np.fft.fft(x, axis=axis) if mode.is_forward else np.fft.ifft(x, axis=axis) * n
    return y * (mode.scale(n) or 1.0)


def _check_split(planes):
    """hi == f32(f64(hi) + f64(lo)) and |lo| <= ulp(hi)/2, each pair."""
    for hi, lo in ((planes[0], planes[1]), (planes[2], planes[3])):
        assert hi.dtype == lo.dtype == torch.float32
        assert torch.equal(hi, (hi.double() + lo.double()).float())
        h, low = hi.numpy(), lo.numpy()
        assert np.all(np.abs(low) <= np.spacing(np.abs(h)) / 2)


def _input(n):
    rng = np.random.default_rng(SEED + n)
    return rng.standard_normal((n, B)) + 1j * rng.standard_normal((n, B))


@functools.lru_cache(maxsize=None)
def _plans(cid):
    make, make_jax, _ = CLASSES[cid]
    return make(), make_jax()


@functools.lru_cache(maxsize=None)
def _jax_out(cid, mode_name):
    """The JAX plan's joined output on the (n, B) input's limbs, (n, B)."""
    plan, jplan = _plans(cid)
    x = _input(plan.size)
    mode = JTransform[mode_name]
    if (cid, mode_name) in INTERPRET or cid.startswith("DdMxuDirectPlan"):
        if hasattr(jplan, "transform_planar_dd_bm"):
            return _join(jplan.transform_planar_dd_bm(
                *(jnp.asarray(p) for p in _limbs(x)), mode))
        return _join(jplan.transform_planar_dd(
            *(jnp.asarray(p) for p in _limbs(x.T.copy())), mode)).T
    # the JAX plan's exact-IEEE host path on numpy planes, batch-major
    rh, rl, ih, il = _limbs(x.T.copy())
    (orh, orl), (oih, oil) = jplan._apply_dd(((rh, rl), (ih, il)), mode)
    return _join((orh, orl, oih, oil)).T


@pytest.mark.parametrize("layout", ["batch_minor", "batch_major"])
@pytest.mark.parametrize("mode", [m.name for m in Transform])
@pytest.mark.parametrize("cid", list(CLASSES))
def test_planes_match_jax_and_numpy(cid, mode, layout):
    plan, _ = _plans(cid)
    x = _input(plan.size)
    m = Transform[mode]
    if layout == "batch_minor":
        out = plan.transform_planar_dd_bm(*_tensors(_limbs(x)), m)
        got = _join(out)
    else:
        out = plan.transform_planar_dd(*_tensors(_limbs(x.T.copy())), m)
        got = _join(out).T
    _check_split(out)
    assert _rel(got, _np_transform(x, m, axis=0)) <= GATE
    assert _rel(got, _jax_out(cid, mode)) <= GATE


def test_nd_plan_matches_jax():
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((2, 8, 12)) + 1j * rng.standard_normal((2, 8, 12))
    plan = tft.NdFftPlan((8, 12), torch.complex128, backend="dd", device="cpu")
    jplan = jft.NdFftPlan((8, 12), np.complex128, backend="dd")
    assert plan.is_dd is False and jplan.is_dd is True
    for mode in (Transform.FFT, Transform.SQRT_SCALED_IFFT):
        out = plan.transform_planar_dd(*_tensors(_limbs(x)), mode)
        _check_split(out)
        want = _join(jplan.transform_planar_dd(*_limbs(x), JTransform[mode.name]))
        ref = np.fft.fft2(x) if mode.is_forward else np.fft.ifft2(x, norm="ortho")
        assert _rel(_join(out), want) <= GATE and _rel(_join(out), ref) <= GATE


@pytest.mark.parametrize("n", [8, 9])
def test_rfft_plan_matches_jax(n):
    """Even and odd n: 4 one-sided planes from 2 limbs, and back."""
    rng = np.random.default_rng(SEED + n)
    x = rng.standard_normal((3, n))
    plan = tft.RfftPlan(n, torch.complex128, backend="dd", device="cpu")
    jplan = jft.RfftPlan(n, np.complex128, backend="dd")
    assert plan.dd is False and jplan.dd is True
    xh, xl = jdd.from_f64(x)
    spec = plan.rfft_planar_dd(*_tensors((xh, xl)))
    _check_split(spec)
    jspec = jplan.rfft_planar_dd(xh, xl)
    assert _rel(_join(spec), _join(jspec)) <= GATE
    assert _rel(_join(spec), np.fft.rfft(x)) <= GATE
    back = plan.irfft_planar_dd(*spec)
    assert len(back) == 2 and back[0].dtype == torch.float32
    jback = jplan.irfft_planar_dd(*(np.asarray(p) for p in jspec))
    joined = back[0].double().numpy() + back[1].double().numpy()
    assert _rel(joined, jdd.to_f64(jback)) <= GATE and _rel(joined, x) <= GATE


def test_rfft_dd_shape_errors():
    plan = tft.RfftPlan(8, torch.complex128, device="cpu")
    z = torch.zeros(2, 7)
    with pytest.raises(ValueError, match="last axis 7 != plan size 8"):
        plan.rfft_planar_dd(z, z)
    with pytest.raises(ValueError, match="last axis 7 != one-sided length 5"):
        plan.irfft_planar_dd(z, z, z, z)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_convolve_plan_matches_jax(kind):
    rng = np.random.default_rng(SEED)
    kernel = rng.standard_normal(5)
    x = rng.standard_normal((2, 40)) + (1j * rng.standard_normal((2, 40))
                                        if kind == "complex" else 0.0)
    plan = tft.ConvolvePlan(kernel, dtype=torch.complex128, device="cpu")
    jplan = JConvolvePlan(kernel, dtype=np.complex128)
    assert plan.dd is False and jplan.dd is True
    limbs = _limbs(x)
    args = limbs[:2] if kind == "real" else limbs
    out = plan.convolve_planar_dd(*_tensors(args))
    jout = jplan.convolve_planar_dd(*(jnp.asarray(p) for p in args))
    assert len(out) == len(jout) == (2 if kind == "real" else 4)
    pad = lambda o: list(o) + [torch.zeros_like(o[0])] * (4 - len(o))
    got = _join(pad(out))
    want = np.stack([np.convolve(row, kernel) for row in x])
    assert _rel(got, _join(pad([torch.as_tensor(np.array(p)) for p in jout]))) <= GATE
    assert _rel(got, want) <= GATE
    # rl None: a zero lo limb
    hi_only = plan.convolve_planar_dd(torch.as_tensor(limbs[0]), None)
    assert _rel(_join(pad(hi_only)), np.stack([np.convolve(r, kernel) for r in
                                               limbs[0].astype(np.float64)])) <= GATE


def test_c64_plans_refuse_dd_calls():
    """Each 4-plane call on a complex64 plan: TypeError, in the JAX
    package's words."""
    z = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="2-plane planar data; call transform_planar"):
        tft.create_fft(8, device="cpu").transform_planar_dd(z, z, z, z)
    with pytest.raises(TypeError, match="call transform_planar_bm"):
        tft.create_fft(8, device="cpu").transform_planar_dd_bm(z.T, z.T, z.T, z.T)
    with pytest.raises(TypeError, match="call transform_planar"):
        tft.NdFftPlan((4, 8), device="cpu").transform_planar_dd(z, z, z, z)
    with pytest.raises(TypeError, match="call rfft_planar"):
        tft.RfftPlan(8, device="cpu").rfft_planar_dd(z, z)
    with pytest.raises(TypeError, match="call irfft_planar"):
        tft.RfftPlan(8, device="cpu").irfft_planar_dd(z, z, z, z)
    with pytest.raises(TypeError, match="c64 plan: use convolve_planar"):
        tft.ConvolvePlan(np.ones(3), device="cpu").convolve_planar_dd(z, z)


def test_bad_limbs_and_empty_batch():
    plan = tft.create_fft(16, torch.complex128, device="cpu")
    z = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="must be float32"):
        plan.transform_planar_dd(z, z, z, z.double())
    with pytest.raises(ValueError, match="plane shapes differ"):
        plan.transform_planar_dd(z, z, z, torch.zeros(3, 16))
    with pytest.raises(ValueError):
        plan.transform_planar_dd(*(torch.zeros(2, 15),) * 4)
    for call, shape in ((plan.transform_planar_dd, (0, 16)),
                        (plan.transform_planar_dd_bm, (16, 0))):
        out = call(*(torch.zeros(shape),) * 4)
        assert [tuple(o.shape) for o in out] == [shape] * 4
        assert all(o.dtype == torch.float32 for o in out)


def test_dd_plan_kinds_and_limits():
    """DdFftPlan's kinds, tree and inner factory; DdMxuDirectPlan's None
    exactly where the JAX create gives None."""
    assert DdFftPlan(4096, device="cpu").kind == JDdFftPlan(4096).kind == "stockham"
    plan = DdFftPlan(100, inner_factory=lambda m: VpuDdFftPlan.create(m, device="cpu"),
                     device="cpu")
    assert plan.kind == JDdFftPlan(100).kind == "bluestein"
    assert isinstance(plan.inner, VpuDdFftPlan) and plan.inner.size == 256
    x = _input(100).T
    assert np.linalg.norm(plan.fft(x) - np.fft.fft(x)) / np.linalg.norm(x) <= GATE
    assert tft.plan.plan_tree(DdFftPlan(13, device="cpu")) == tft.plan.plan_tree(
        JDdFftPlan(13))
    with pytest.raises(ValueError):
        DdFftPlan(0, device="cpu")
    for n in (0, 1, 2, 1024, 1025, 2048):
        assert (DdMxuDirectPlan.create(n, device="cpu") is None) == (
            JDdMxuDirectPlan.create(n) is None), n
    assert DdMxuDirectPlan.kind == JDdMxuDirectPlan.kind == "mxu-dd-direct"
    assert tft.precision.__all__.count("DdFftPlan") == 1


def test_load_jax_dd_mxu_plan(tmp_path):
    """A saved JAX DdMxuDirectPlan loads as the port's, its f64 DFT matrix
    the exact sum of the saved chunk tables, and runs as the JAX plan."""
    jplan = JDdMxuDirectPlan.create(24)
    jsave_plan(jplan, str(tmp_path / "mxu.npz"))
    plan = load_jax_plan(str(tmp_path / "mxu.npz"), device="cpu")
    assert isinstance(plan, DdMxuDirectPlan) and plan.size == 24
    # the JAX tables (its angle of j*k), to the chunks' 49 bits
    j = np.arange(24, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(j, j) / 24.0
    want = np.stack([np.cos(ang), -np.sin(ang)])
    assert float(np.abs(plan.dft.numpy() - want).max()) <= 2.0 ** -49
    x = _input(24).T.copy()
    limbs = _limbs(x)
    got = _join(plan.transform_planar_dd(*_tensors(limbs)))
    want = _join(jplan.transform_planar_dd(*(jnp.asarray(p) for p in limbs)))
    assert _rel(got, want) <= GATE and _rel(got, np.fft.fft(x)) <= GATE


def test_ddreal_join_split_are_the_jax_split():
    """from_f64 and to_f64 on tensors: bitwise the JAX package's numpy."""
    x = np.random.default_rng(SEED).standard_normal(1000) * 1e3
    hi, lo = ddreal.from_f64(torch.as_tensor(x))
    jhi, jlo = jdd.from_f64(x)
    assert np.array_equal(hi.numpy(), jhi) and np.array_equal(lo.numpy(), jlo)
    assert np.array_equal(ddreal.to_f64((hi, lo)).numpy(), jdd.to_f64((jhi, jlo)))
