"""Real transforms of the port: RfftPlan, kernels B4 (even n) and B5 (odd n).

* The port's ``RfftPlan`` on the CPU runs the kernels' plain PyTorch
  versions through their wrappers; the JAX ``RfftPlan`` runs its Pallas
  kernels in interpret mode (as ``tests/test_rfft.py`` does). Same seeded
  inputs, both layouts, rfft and irfft; rel-L2 < 1e-5 and round trip atol
  1e-4, the gates of ``tests/test_rfft.py``.
* At n = 192 and 486 (m = 96, 243) the JAX fused kernel asserts that m is
  a power of two (its row reverse); the port's fused path covers them and
  is held against the JAX ``backend="stockham"`` plan and ``np.fft``.
* The plain B4/B5 versions against the JAX kernels' wrappers in interpret
  mode; the CUDA kernels' index math (mirror rows, pairing of column j with
  j + ceil(B/2), masks, the 0.5/m and 1/n folds) as numpy transliterations
  against ``np.fft``; the kernels themselves where a card is present
  (marker ``cuda``).
* Plan trees, gradients, c128, the module functions and plan files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_tpu.ops.pallas import stockham_vpu as jsv
from fourier_tpu.plan.bluestein_fused import VpuBluesteinPlan as JVpuBluesteinPlan
from fourier_tpu.plan.serialize import save_plan
from fourier_tpu.plan.vpu import VpuFftPlan as JVpuFftPlan
from fourier_tpu.rfft import RfftPlan as JRfftPlan

import fourier_tpu_torch as tft
from fourier_tpu_torch import trace
from fourier_tpu_torch.ops.cuda import stockham_vpu as sv
from fourier_tpu_torch.plan import (VpuBluesteinPlan, VpuFftPlan, create_fft,
                                    load_jax_plan, plan_tree)
from fourier_tpu_torch.rfft import RfftPlan

from test_torch_vpu import emulate_stages

RNG_SEED = 0xB4B5
REL = 1e-5  # tests/test_rfft.py's rel-L2 gate (f32)
ATOL_RT = 1e-4  # its round-trip gate


def launches(op: str) -> int:
    """Launches of the operator ``fourier_tpu_torch::<op>`` counted so far."""
    return trace.counters()[f"launches.fourier_tpu_torch::{op}"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _c(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _port_both(plan, x):
    """(batch-major spectrum, batch-minor spectrum, both inverses) of the
    port's plan on real (B, n) rows `x`."""
    spec = _c(*(t.numpy() for t in plan.rfft_planar(_t(x))))
    re_t, im_t = plan.rfft_planar_bm(_t(x.T))
    spec_bm = _c(re_t.numpy(), im_t.numpy()).T
    back = plan.irfft_planar(_t(spec.real.astype(np.float32)),
                             _t(spec.imag.astype(np.float32))).numpy()
    back_bm = plan.irfft_planar_bm(re_t, im_t).numpy().T
    return spec, spec_bm, back, back_bm


def _jax_bm(plan, x):
    """(spectrum, inverse) of the JAX plan on the batch-minor layout, where
    its fused kernels run."""
    re_t, im_t = plan.rfft_planar_bm(np.ascontiguousarray(x.T))
    return _c(re_t, im_t).T, np.asarray(plan.irfft_planar_bm(re_t, im_t)).T


@pytest.mark.parametrize("n,fused", [(128, True), (1024, True), (37, True),
                                     (243, False), (250, False)])
def test_vpu_plan_matches_jax(n, fused):
    """Fused at 128 and 1024 (B4: the JAX kernel runs in interpret mode) and
    at 37 (B5 over B2, past the card's crossover), unfused at 250 (B2 inner
    of 125) and 243 (B1 inner, odd n). Both of the port's layouts are held
    against the JAX plan's batch-minor result (its batch-major path runs the
    same inner plan without the fused kernels; at 37 and 250 its inner is
    the JAX route's DFT product) and np.fft."""
    rng = np.random.default_rng(RNG_SEED + n)
    x = rng.standard_normal((4, n)).astype(np.float32)
    mine = RfftPlan(n, backend="vpu", device="cpu")
    ref = JRfftPlan(n, np.complex64, backend="vpu")
    assert plan_tree(mine) == CARD_ROUTE.get(n, plan_tree(ref))
    assert mine.fused is fused
    spec, back = _jax_bm(ref, x)
    got = _port_both(mine, x)
    for g in got[:2]:
        assert g.shape == (4, n // 2 + 1)
        assert _rel(g, spec) < REL
        assert _rel(g, np.fft.rfft(x.astype(np.float64))) < REL
    for g in got[2:]:
        np.testing.assert_allclose(g, back, atol=ATOL_RT)
        np.testing.assert_allclose(g, x, atol=ATOL_RT)


@pytest.mark.parametrize("n", [192, 486])
def test_fused_path_where_the_jax_kernel_asserts(n):
    """m = 96 and 243 are in B1's domain but not powers of two: the JAX
    fused kernel's row reverse asserts there, the port's mirror is an index.
    Held against the JAX unfused (stockham) plan and np.fft."""
    rng = np.random.default_rng(RNG_SEED + n)
    x = rng.standard_normal((5, n)).astype(np.float32)
    mine = RfftPlan(n, backend="vpu", device="cpu")
    assert isinstance(mine.inner, VpuFftPlan) and mine.fused
    with pytest.raises(AssertionError):
        JRfftPlan(n, np.complex64, backend="vpu").rfft_planar_bm(
            np.ascontiguousarray(x.T))
    got = _port_both(mine, x)
    ref = JRfftPlan(n, np.complex64, backend="stockham")
    want = _c(*ref.rfft_planar(x))
    for g in got[:2]:
        assert _rel(g, want) < REL
        assert _rel(g, np.fft.rfft(x.astype(np.float64))) < REL
    for g in got[2:]:
        np.testing.assert_allclose(g, x, atol=ATOL_RT)


@pytest.mark.parametrize("m", [64, 256])
def test_plain_b4_matches_pallas_interpret(m):
    rng = np.random.default_rng(RNG_SEED + m)
    b = 128  # the JAX wrappers need a multiple of cb = 128
    x = rng.standard_normal((2 * m, b)).astype(np.float32)
    jplan = JVpuFftPlan.create(m, interpret=True)
    w = RfftPlan(2 * m, backend="vpu", device="cpu").w
    jw = (w[0].numpy().reshape(-1, 1), w[1].numpy().reshape(-1, 1))
    inner = VpuFftPlan.create(m, device="cpu")
    want = _c(*jsv.vpu_rfft_pack_batch_minor(x, m, jplan.fwd_tables, jw,
                                             interpret=True))
    re, im = sv.vpu_rfft_pack_batch_minor_reference(_t(x), m,
                                                    inner.tables(True), w)
    assert re.shape == (m + 1, b)
    assert _rel(_c(re.numpy(), im.numpy()), want) < REL
    spec = np.fft.rfft(x.astype(np.float64), axis=0)
    spec[0].imag, spec[-1].imag = 1.0, -2.0  # ignored, as by np.fft.irfft
    sr, si = spec.real.astype(np.float32), spec.imag.astype(np.float32)
    want = np.asarray(jsv.vpu_irfft_unpack_batch_minor(
        sr, si, m, jplan.inv_tables, jw, interpret=True))
    got = sv.vpu_irfft_unpack_batch_minor_reference(_t(sr), _t(si), m,
                                                    inner.tables(False), w)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_RT)
    np.testing.assert_allclose(got.numpy(), x, atol=ATOL_RT)


def test_plain_b5_matches_pallas_interpret():
    """At B = 256 the JAX lane pairing (block t with t + B/(2*128)) and the
    port's (column j with j + ceil(B/2)) coincide, column for column."""
    n, b = 37, 256
    rng = np.random.default_rng(RNG_SEED + n)
    x = rng.standard_normal((n, b)).astype(np.float32)
    jplan = JVpuBluesteinPlan.create(n, interpret=True)
    mine = VpuBluesteinPlan.create(n, device="cpu")
    assert mine.m_inner == jplan.m_inner == 80
    st = mine.stages
    tables = (st.tables(True), st.tables(False))
    parts = jsv.vpu_rfft_odd_pack_batch_minor(
        x, n, jplan.m_inner, jplan.stage_tables, jplan.chirps_fwd,
        interpret=True)
    want = np.concatenate([_c(parts[0], parts[1]), _c(parts[2], parts[3])], 1)
    re, im = sv.vpu_rfft_odd_pack_batch_minor_reference(
        _t(x), n, mine.m_inner, tables, mine.chirps(True))
    assert re.shape == (19, b)
    assert _rel(_c(re.numpy(), im.numpy()), want) < REL
    assert _rel(_c(re.numpy(), im.numpy()),
                np.fft.rfft(x.astype(np.float64), axis=0)) < REL
    oa, ob = jsv.vpu_irfft_odd_unpack_batch_minor(
        re.numpy(), im.numpy(), n, jplan.m_inner, jplan.stage_tables,
        jplan.chirps_inv, interpret=True)
    got = sv.vpu_irfft_odd_unpack_batch_minor_reference(
        re, im, n, mine.m_inner, tables, mine.chirps(False))
    np.testing.assert_allclose(got.numpy(), np.concatenate([oa, ob], 1),
                               atol=ATOL_RT)
    np.testing.assert_allclose(got.numpy(), x, atol=ATOL_RT)


def _fused_odd(n):
    """The port's RfftPlan(n) over a VpuBluesteinPlan inner (B5)."""
    plan = RfftPlan(n, backend="vpu", device="cpu")
    plan.inner = VpuBluesteinPlan.create(n, device="cpu")
    assert plan.fused
    return plan


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n", [37, 101, 1013])
@pytest.mark.parametrize("b", [1, 2, 5, 8])
def test_odd_batches_vs_numpy(n, b, fused):
    """The unfused two-for-one (half slabs, single-row fallback) and B5's
    plain version (pairing with ceil(B/2), an unpaired last column against
    zeros) at every batch parity."""
    rng = np.random.default_rng(RNG_SEED + n + b)
    x = rng.standard_normal((b, n)).astype(np.float32)
    plan = _fused_odd(n) if fused else RfftPlan(n, backend="vpu", device="cpu")
    spec, spec_bm, back, back_bm = _port_both(plan, x)
    want = np.fft.rfft(x.astype(np.float64))
    assert _rel(spec, want) < REL and _rel(spec_bm, want) < REL
    np.testing.assert_allclose(back, x, atol=ATOL_RT)
    np.testing.assert_allclose(back_bm, x, atol=ATOL_RT)


@pytest.mark.parametrize("n", [2, 15, 64, 96, 1000, 1001])
def test_c128_vs_numpy(n):
    rng = np.random.default_rng(RNG_SEED + n)
    x = rng.standard_normal((3, n))
    plan = RfftPlan(n, torch.complex128, device="cpu")
    assert plan.w is None or plan.w.dtype == torch.float64
    want = np.fft.rfft(x)
    spec = plan.rfft(x)
    assert spec.dtype == np.complex128 and _rel(spec, want) <= 1e-12
    re_t, im_t = plan.rfft_planar_bm(_t(x.T))
    assert _rel(_c(re_t.numpy(), im_t.numpy()).T, want) <= 1e-12
    assert _rel(plan.irfft(spec), x) <= 1e-12
    assert _rel(plan.irfft_planar_bm(re_t, im_t).numpy().T, x) <= 1e-12


# The c128 inner of the JAX package's RfftPlan(n, np.complex128,
# backend="dd") on a TPU: B6 (2048), B8 over B6 (16384), B7 (1013).
DD_RFFT = {2048: ("VpuDdFftPlan", 1024),
           16384: ("DdSplitPow2Plan", 8192, ("VpuDdFftPlan", 4096)),
           1013: ("VpuDdBluesteinPlan", 1013, 2048)}


@pytest.mark.parametrize("n", sorted(DD_RFFT))
def test_c128_dd_route_matches_jax(n, monkeypatch, tmp_path):
    """RfftPlan(n, complex128) gets the dd route's inner, as the JAX package
    on a TPU (jax.default_backend patched), and its unfused f64 pack around
    the inner's plain versions meets the c128 gate against np.fft in both
    layouts, with the round trip. The JAX plan saved and loaded with
    load_jax_plan agrees with it within rel-L2 1e-13."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    ref = JRfftPlan(n, np.complex128, backend="dd")
    plan = RfftPlan(n, torch.complex128, backend="dd", device="cpu")
    assert plan_tree(plan) == plan_tree(ref) == ("RfftPlan", n, DD_RFFT[n])
    assert not plan.fused and (plan.w is None or plan.w.dtype == torch.float64)
    rng = np.random.default_rng(RNG_SEED + n)
    x = rng.standard_normal((3, n))
    want = np.fft.rfft(x)
    spec = plan.rfft(x)
    assert spec.dtype == np.complex128 and _rel(spec, want) <= 1e-12
    re_t, im_t = plan.rfft_planar_bm(_t(x.T))
    assert re_t.dtype == torch.float64
    assert _rel(_c(re_t.numpy(), im_t.numpy()).T, want) <= 1e-12
    assert _rel(plan.irfft(spec), x) <= 1e-12
    assert _rel(plan.irfft_planar_bm(re_t, im_t).numpy().T, x) <= 1e-12
    save_plan(ref, str(tmp_path / "rfft.npz"))
    loaded = load_jax_plan(str(tmp_path / "rfft.npz"), device="cpu")
    assert plan_tree(loaded) == plan_tree(plan)
    assert _rel(loaded.rfft(x), spec) <= 1e-13


# The route table of the JAX package's RfftPlan(n, backend="vpu"): even n
# plan n/2, odd n plan n.
ROUTE_SIZES = (16, 64, 128, 1024, 4096, 8192, 32768, 192, 486, 250, 2026,
               40000, 65536, 37, 101, 243, 769, 1013, 4093, 4097, 10007)
FUSED = {128, 1024, 4096, 8192, 32768, 192, 486, 37, 101, 769, 1013, 4093}
# Where the card's route leaves the JAX package's: inners the JAX rules run
# as one full-size DFT product run B2 where B2 takes them (odd n then run
# B5 on the batch-minor calls).
CARD_ROUTE = {n: ("RfftPlan", n, ("VpuBluesteinPlan", m, inner)) for n, m, inner in (
    (64, 32, 64), (250, 125, 256), (37, 37, 80), (101, 101, 216))}


@pytest.mark.parametrize("n", ROUTE_SIZES)
def test_route_matches_jax(n):
    mine = RfftPlan(n, backend="vpu", device="cpu")
    ref = JRfftPlan(n, np.complex64, backend="vpu")
    if n in CARD_ROUTE:
        assert plan_tree(ref)[2][0] == "MxuFftPlan"
    assert plan_tree(mine) == CARD_ROUTE.get(n, plan_tree(ref))
    assert mine.fused is (n in FUSED)


def test_inner_plan_is_owned():
    """The inner plan is built for the rfft plan alone: moving one plan with
    .to() cannot move a plan that the planner's cache hands out."""
    plan = RfftPlan(128, backend="vpu", device="cpu")
    assert plan.inner is not create_fft(64, backend="vpu", device="cpu")
    assert "inner" in dict(plan.named_children())
    assert plan.w.shape == (2, 64) and plan.w.dtype == torch.float32


def _loss_grads(plan, x, ctr, cti, gt, unfused=False):
    """d/dx sum(rfft_bm(x) * ct) and d/d(re, im) sum(irfft_bm(re, im) * gt)."""
    xt = _t(x).requires_grad_(True)
    fwd = plan._rfft_bm_unfused if unfused else plan.rfft_planar_bm
    sr, si = fwd(xt)
    (sr * _t(ctr) + si * _t(cti)).sum().backward()
    re = _t(ctr).requires_grad_(True)
    im = _t(cti).requires_grad_(True)
    inv = plan._irfft_bm_unfused if unfused else plan.irfft_planar_bm
    (inv(re, im) * _t(gt)).sum().backward()
    return xt.grad.numpy(), re.grad.numpy(), im.grad.numpy()


@pytest.mark.parametrize("n", [128, 73])
def test_grad_fused_bm(n):
    """The linear VJP of the fused batch-minor path against the port's
    stockham plan and the same plan's unfused branch (plain autograd through
    the inner plan), and against jax.grad of the JAX plan; within 2e-3, the
    gate of tests/test_autodiff.py."""
    rng = np.random.default_rng(RNG_SEED + n)
    b, L = 8, n // 2 + 1
    x = rng.standard_normal((n, b)).astype(np.float32)
    ctr, cti = (rng.standard_normal((L, b)).astype(np.float32) for _ in range(2))
    gt = rng.standard_normal((n, b)).astype(np.float32)
    fused = RfftPlan(n, backend="vpu", device="cpu") if n % 2 == 0 else _fused_odd(n)
    assert fused.fused
    got = _loss_grads(fused, x, ctr, cti, gt)
    stock = RfftPlan(n, backend="stockham", device="cpu")
    for want in (_loss_grads(stock, x, ctr, cti, gt),
                 _loss_grads(fused, x, ctr, cti, gt, unfused=True)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=2e-3, rtol=2e-3)
    jplan = JRfftPlan(n, np.complex64, backend="vpu")
    if n % 2 == 0:
        assert jplan._fused_even_cfg() is not None  # B4 in interpret mode

    def fwd_loss(v):
        sr, si = jplan.rfft_planar_bm(v)
        return jnp.sum(sr * ctr + si * cti)

    jg = jax.grad(fwd_loss)(jnp.asarray(x))
    ji = jax.grad(lambda r, i: jnp.sum(jplan.irfft_planar_bm(r, i) * gt),
                  argnums=(0, 1))(jnp.asarray(ctr), jnp.asarray(cti))
    for g, w in zip(got, (jg, *ji)):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-3, rtol=2e-3)


def test_grad_batch_major():
    """The batch-major calls differentiate through plain torch ops and the
    inner plan's rule: against the batch-minor linear VJP."""
    n = 128
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((3, n)).astype(np.float32)
    ct = rng.standard_normal((3, n // 2 + 1, 2)).astype(np.float32)
    plan = RfftPlan(n, backend="vpu", device="cpu")
    xt = _t(x).requires_grad_(True)
    sr, si = plan.rfft_planar(xt)
    (sr * _t(ct[..., 0]) + si * _t(ct[..., 1])).sum().backward()
    xb = _t(x.T).requires_grad_(True)
    sr, si = plan.rfft_planar_bm(xb)
    (sr * _t(ct[..., 0].T) + si * _t(ct[..., 1].T)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), xb.grad.numpy().T, atol=1e-4)


def test_module_functions_vs_numpy():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((4, 6, 9))
    spec = rng.standard_normal((4, 5)) + 1j * rng.standard_normal((4, 5))
    for norm in (None, "backward", "ortho", "forward"):
        for axis in (-1, 0, 1):
            np.testing.assert_allclose(tft.rfft(x, norm=norm, axis=axis, device="cpu"),
                                       np.fft.rfft(x, norm=norm, axis=axis),
                                       atol=1e-10)
            np.testing.assert_allclose(tft.ihfft(x, norm=norm, axis=axis, device="cpu"),
                                       np.fft.ihfft(x, norm=norm, axis=axis),
                                       atol=1e-10)
        np.testing.assert_allclose(tft.rfft(x, n=12, norm=norm, device="cpu"),
                                   np.fft.rfft(x, n=12, norm=norm), atol=1e-10)
        np.testing.assert_allclose(tft.rfft(x, n=7, norm=norm, axis=1, device="cpu"),
                                   np.fft.rfft(x, n=7, norm=norm, axis=1),
                                   atol=1e-10)
        for n in (None, 9):
            np.testing.assert_allclose(tft.irfft(spec, n=n, norm=norm, device="cpu"),
                                       np.fft.irfft(spec, n=n, norm=norm),
                                       atol=1e-10)
            np.testing.assert_allclose(tft.hfft(spec, n=n, norm=norm, device="cpu"),
                                       np.fft.hfft(spec, n=n, norm=norm),
                                       atol=1e-10)
        np.testing.assert_allclose(tft.irfft(spec.T, norm=norm, axis=0, device="cpu"),
                                   np.fft.irfft(spec.T, norm=norm, axis=0),
                                   atol=1e-10)
    f32 = x.astype(np.float32)
    got = tft.rfft(f32, device="cpu")
    assert got.dtype == np.complex64
    assert _rel(got, np.fft.rfft(x)) < REL
    out = tft.rfft(torch.as_tensor(f32), device="cpu")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.complex64
    back = tft.irfft(out, n=9, device="cpu")
    assert isinstance(back, torch.Tensor) and back.dtype == torch.float32
    np.testing.assert_allclose(back.numpy(), f32, atol=ATOL_RT)


def test_rfftfreq():
    for n in (8, 9, 16):
        np.testing.assert_allclose(tft.rfftfreq(n, d=0.25),
                                   np.fft.rfftfreq(n, d=0.25))


def test_validation():
    plan = RfftPlan(16, device="cpu")
    with pytest.raises(ValueError):
        plan.rfft_planar(np.zeros((2, 17), np.float32))
    with pytest.raises(ValueError):
        plan.irfft_planar(np.zeros(8, np.float32), np.zeros(8, np.float32))
    with pytest.raises(ValueError):
        RfftPlan(0, device="cpu")
    with pytest.raises(ValueError):
        RfftPlan(16, torch.float32, device="cpu")
    with pytest.raises(ValueError):
        tft.irfft(np.zeros(9, np.complex64), n=14, device="cpu")
    with pytest.raises(ValueError):
        tft.rfft(np.zeros(8), norm="bogus", device="cpu")
    with pytest.raises(ValueError):
        plan.rfft_planar_bm(np.zeros((8, 4), np.float32))  # wrong n
    with pytest.raises(ValueError):
        plan.rfft_planar_bm(np.zeros(16, np.float32))  # not 2-D
    with pytest.raises(ValueError):
        plan.irfft_planar_bm(np.zeros((16, 4), np.float32),
                             np.zeros((16, 4), np.float32))
    with pytest.raises(ValueError, match="plan on cpu"):
        plan.rfft_planar(torch.zeros(2, 16, device="meta"))
    with pytest.raises(ValueError, match="complex128"):
        RfftPlan(16, torch.complex64, backend="dd", device="cpu")


def test_irfft_leaves_the_callers_spectrum_alone():
    rng = np.random.default_rng(RNG_SEED)
    for n in (16, 15):
        plan = RfftPlan(n, backend="vpu", device="cpu")
        re = _t(rng.standard_normal((n // 2 + 1, 3)).astype(np.float32))
        im = _t(rng.standard_normal((n // 2 + 1, 3)).astype(np.float32))
        keep = im.clone()
        plan.irfft_planar_bm(re, im)
        plan.irfft_planar(re.T, im.T)
        plan._irfft_bm_unfused(re, im)
        assert torch.equal(im, keep)


@pytest.mark.parametrize("kind", ["even", "fused_odd"])
def test_load_jax_plan(kind, tmp_path):
    n, backend = {"even": (64, "auto"), "fused_odd": (1013, "vpu")}[kind]
    ref = JRfftPlan(n, np.complex64, backend=backend)
    path = tmp_path / "rfft.npz"
    save_plan(ref, str(path))
    loaded = load_jax_plan(str(path), device="cpu")
    own = RfftPlan(n, backend=backend, device="cpu")
    assert isinstance(loaded, RfftPlan) and plan_tree(loaded) == plan_tree(own)
    assert repr(loaded) == repr(own) and loaded.fused == own.fused
    rng = np.random.default_rng(RNG_SEED + n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    np.testing.assert_array_equal(loaded.rfft(x), own.rfft(x))
    a, b = (p.rfft_planar_bm(_t(x.T)) for p in (loaded, own))
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_load_jax_plan_dd_raises(tmp_path):
    """A double-word rfft plan loads as an f64 one (its (hi, lo) twiddles
    recombined); the dd class on no route of the reference, which raised
    before the port had it, loads too and runs as np.fft."""
    from fourier_tpu.precision.dd_mxu import DdMxuDirectPlan

    from fourier_tpu_torch.precision import DdMxuDirectPlan as PortDdMxuDirectPlan

    path = tmp_path / "dd.npz"
    save_plan(JRfftPlan(64, np.complex128, backend="dd"), str(path))
    loaded = load_jax_plan(str(path), device="cpu")
    own = RfftPlan(64, torch.complex128, backend="stockham", device="cpu")
    assert plan_tree(loaded) == plan_tree(own) == ("RfftPlan", 64, ("AutosortPlan", 32))
    assert (loaded.w - own.w).abs().max() <= 1e-14  # hi + lo keeps ~48 bits
    save_plan(DdMxuDirectPlan.create(64), str(path))
    mxu = load_jax_plan(str(path), device="cpu")
    assert isinstance(mxu, PortDdMxuDirectPlan) and mxu.size == 64
    x = np.random.default_rng(RNG_SEED).standard_normal((2, 64)) + 0.5j
    assert np.linalg.norm(mxu.fft(x) - np.fft.fft(x)) <= 1e-12 * np.linalg.norm(
        np.fft.fft(x))


# -- numpy transliterations of the CUDA kernels ---------------------------------


def _blocks(b, cols):
    for b0 in range(0, b, cols):
        yield b0, min(cols, b - b0)


def _emulate_b4a(x, m, w):
    """csrc/stockham_vpu.cu rfft_even_c64<true>: per block of `cols`
    columns, rows 2j/2j+1 into the re/im planes, the forward stages, then
    the pack read at rows k and (m-k) mod m (row m from row 0)."""
    cols, _ = sv.launch_geometry(m)
    wc = w[0].astype(np.float64) + 1j * w[1].astype(np.float64)
    out = np.empty((m + 1, x.shape[1]), np.complex128)
    k = np.arange(m + 1)
    kk = np.where(k == m, 0, k)
    kr = np.where(kk == 0, 0, m - kk)
    for b0, valid in _blocks(x.shape[1], cols):
        s = np.zeros((m, cols), np.complex128)
        s[:, :valid] = x[0::2, b0:b0 + valid] + 1j * x[1::2, b0:b0 + valid]
        s = s.ravel()
        emulate_stages(s, m, cols, True)
        s = s.reshape(m, cols)
        z, c = s[kk], np.conj(s[kr])
        e, o = 0.5 * (z + c), -0.5j * (z - c)
        wk = np.append(wc, 0.0)[:, None]
        got = np.where((k < m)[:, None], e + wk * o, e - o)
        out[:, b0:b0 + valid] = got[:, :valid]
    return out


def _emulate_b4b(spec, m, w):
    """rfft_even_c64<false>: Z[k] from rows k and m-k (imaginary DC and
    Nyquist read as 0), conj(W^k) and h = 0.5/m, the inverse stages
    unscaled, rows j to 2j and 2j+1."""
    cols, _ = sv.launch_geometry(m)
    wc = w[0].astype(np.float64) + 1j * w[1].astype(np.float64)
    h = float(np.float32(0.5 / m))
    b = spec.shape[1]
    out = np.empty((2 * m, b))
    k = np.arange(m)
    for b0, valid in _blocks(b, cols):
        s = np.zeros((m, cols), np.complex128)
        xs = spec[:, b0:b0 + valid]
        xk = xs.real[k] + 1j * np.where(k[:, None] == 0, 0.0, xs.imag[k])
        ck = xs.real[m - k] - 1j * np.where(k[:, None] == 0, 0.0, xs.imag[m - k])
        e, wo = h * (xk + ck), h * (xk - ck)
        s[:, :valid] = e + 1j * np.conj(wc)[:, None] * wo
        s = s.ravel()
        emulate_stages(s, m, cols, False)
        s = s.reshape(m, cols)[:, :valid]
        out[0::2, b0:b0 + valid] = s.real
        out[1::2, b0:b0 + valid] = s.imag
    return out


def _chirp_z(load, n, m, cols, chirps):
    """B2's chirp_z on one block: rows < n load * xt, the forward stages,
    * wt, the inverse stages; then * xo on rows < n."""
    xt, wt, xo = (c[0].numpy().astype(np.float64)
                  + 1j * c[1].numpy().astype(np.float64) for c in chirps)
    s = np.zeros((m, cols), np.complex128)
    s[:n] = load * xt[:, None]
    s = s.ravel()
    emulate_stages(s, m, cols, True)
    s *= np.repeat(wt, cols)
    emulate_stages(s, m, cols, False)
    return s.reshape(m, cols)[:n] * xo[:, None]


def _emulate_b5a(x, plan):
    """rfft_odd_pack_c64: column j (j < h = ceil(B/2)) pairs with j + h
    (zeros past B); separation from rows k and (n-k) mod n."""
    n, m = plan.size, plan.m_inner
    cols, _ = sv.launch_geometry(m)
    b = x.shape[1]
    h, L = (b + 1) // 2, (n + 1) // 2
    xp = np.concatenate([x, np.zeros((n, 2 * h - b))], 1)
    out = np.empty((L, b), np.complex128)
    k = np.arange(L)
    kr = np.where(k == 0, 0, n - k)
    for j0, valid in _blocks(h, cols):
        load = np.zeros((n, cols), np.complex128)
        load[:, :valid] = xp[:, j0:j0 + valid] + 1j * xp[:, h + j0:h + j0 + valid]
        z = _chirp_z(load, n, m, cols, plan.chirps(True))
        zk, zs = z[k], np.conj(z[kr])
        x1, x2 = 0.5 * (zk + zs), -0.5j * (zk - zs)
        out[:, j0:j0 + valid] = x1[:, :valid]
        keep = min(valid, b - h - j0)
        if keep > 0:
            out[:, h + j0:h + j0 + keep] = x2[:, :keep]
    return out


def _emulate_b5b(spec, plan):
    """irfft_odd_unpack_c64: Z = X1 + i*X2 on bins < L, conj X1 + i*conj X2
    above (imaginary DC read as 0), chirp-z inverse, * 1/n; re to column j,
    im to j + h."""
    n, m = plan.size, plan.m_inner
    cols, _ = sv.launch_geometry(m)
    b = spec.shape[1]
    h, L = (b + 1) // 2, (n + 1) // 2
    sp = np.concatenate([spec, np.zeros((L, 2 * h - b))], 1)
    sp[0] = sp[0].real
    row = np.arange(n)
    kidx = np.where(row < L, row, n - row)
    out = np.empty((n, b))
    for j0, valid in _blocks(h, cols):
        x1 = np.zeros((L, cols), np.complex128)
        x2 = np.zeros((L, cols), np.complex128)
        x1[:, :valid] = sp[:, j0:j0 + valid]
        x2[:, :valid] = sp[:, h + j0:h + j0 + valid]
        head = (row < L)[:, None]
        a, c = x1[kidx], x2[kidx]
        load = np.where(head, a + 1j * c, np.conj(a) + 1j * np.conj(c))
        y = _chirp_z(load, n, m, cols, plan.chirps(False)) / n
        out[:, j0:j0 + valid] = y.real[:, :valid]
        keep = min(valid, b - h - j0)
        if keep > 0:
            out[:, h + j0:h + j0 + keep] = y.imag[:, :keep]
    return out


@pytest.mark.parametrize("n", [128, 192, 486, 1024])
def test_b4_algorithm_emulated(n):
    m = n // 2
    plan = RfftPlan(n, backend="vpu", device="cpu")
    cols, _ = sv.launch_geometry(m)
    rng = np.random.default_rng(RNG_SEED + n)
    x = rng.standard_normal((n, cols + 3))  # ragged last block
    w = plan.w.numpy()
    spec = _emulate_b4a(x, m, w)
    want = np.fft.rfft(x, axis=0)
    assert _rel(spec, want) <= 1e-6
    spec[0].imag, spec[-1].imag = 3.0, -1.0  # read as 0
    assert _rel(_emulate_b4b(spec, m, w), x) <= 1e-6


@pytest.mark.parametrize("n", [73, 769, 1013])
@pytest.mark.parametrize("extra", [0, 3])
def test_b5_algorithm_emulated(n, extra):
    plan = VpuBluesteinPlan.create(n, device="cpu")
    cols, _ = sv.launch_geometry(plan.m_inner)
    b = 2 * cols + 1 + extra  # odd B: one column has no partner
    rng = np.random.default_rng(RNG_SEED + n + extra)
    x = rng.standard_normal((n, b))
    spec = _emulate_b5a(x, plan)
    want = np.fft.rfft(x, axis=0)
    assert _rel(spec, want) <= 1e-6
    spec[0].imag = 2.0  # read as 0
    assert _rel(_emulate_b5b(spec, plan), x) <= 1e-6
    one = _emulate_b5a(x[:, :1], plan)  # B = 1: the partner is all zeros
    assert _rel(one, want[:, :1]) <= 1e-6


def test_wrapper_contract():
    """The plain versions run only for CPU tensors (no launch counted); the
    wrappers raise on what the kernels do not take."""
    plan = RfftPlan(128, backend="vpu", device="cpu")
    inner = plan.inner
    kw = dict(tables=inner.tables(True), kernel_tables=inner.kernel_fwd, w=plan.w)
    for bad in (torch.zeros(128, 3).double(), torch.zeros(128, 6)[:, ::2],
                torch.zeros(127, 3), torch.zeros(128, 3, device="meta")):
        with pytest.raises((TypeError, ValueError)):
            sv.vpu_rfft_pack_batch_minor(bad, 64, **kw)
    with pytest.raises(ValueError):
        sv.vpu_rfft_pack_batch_minor(torch.zeros(128, 3), 64,
                                     **{**kw, "w": plan.w[:, :32]})
    odd = VpuBluesteinPlan.create(73, device="cpu")
    st = odd.stages
    okw = dict(tables=(st.tables(True), st.tables(False)),
               kernel_tables=(st.kernel_fwd, st.kernel_inv), chirps=odd.chirps(False))
    with pytest.raises((TypeError, ValueError)):
        sv.vpu_irfft_odd_unpack_batch_minor(torch.zeros(36, 3), torch.zeros(36, 3),
                                            73, st.size, **okw)
    ops = ("rfft_pack", "irfft_unpack", "rfft_odd_pack", "irfft_odd_unpack")
    before = [launches(op) for op in ops]
    x = torch.zeros(128, 3)
    re, im = sv.vpu_rfft_pack_batch_minor(x, 64, **kw)
    sv.vpu_irfft_unpack_batch_minor(re, im, 64, tables=inner.tables(False),
                                    kernel_tables=inner.kernel_inv, w=plan.w)
    re, im = sv.vpu_rfft_odd_pack_batch_minor(torch.zeros(73, 3), 73, st.size,
                                              **{**okw, "chirps": odd.chirps(True)})
    sv.vpu_irfft_odd_unpack_batch_minor(re, im, 73, st.size, **okw)
    assert [launches(op) for op in ops] == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 192, 486, 1024, 4096, 32768, 769, 1013, 4093])
@pytest.mark.parametrize("b", [1, 7, 1000])
def test_kernels_match_plain_on_card(cuda_device, n, b):
    rng = np.random.default_rng(RNG_SEED + n + b)
    plan = RfftPlan(n, device=cuda_device)
    assert plan.fused
    x = torch.as_tensor(rng.standard_normal((n, b)).astype(np.float32),
                        device=cuda_device)
    fwd, inv = (("rfft_pack", "irfft_unpack") if plan.even
                else ("rfft_odd_pack", "irfft_odd_unpack"))
    before = launches(fwd), launches(inv)
    re, im = plan.rfft_planar_bm(x)
    back = plan.irfft_planar_bm(re, im)
    torch.cuda.synchronize()
    assert (launches(fwd), launches(inv)) == (before[0] + 1, before[1] + 1)
    inner = plan.inner
    if plan.even:
        pre, pim = sv.vpu_rfft_pack_batch_minor_reference(
            x, plan.m, inner.tables(True), plan.w)
        pback = sv.vpu_irfft_unpack_batch_minor_reference(
            re, im, plan.m, inner.tables(False), plan.w)
    else:
        st = inner.stages
        tables = (st.tables(True), st.tables(False))
        pre, pim = sv.vpu_rfft_odd_pack_batch_minor_reference(
            x, n, st.size, tables, inner.chirps(True))
        pback = sv.vpu_irfft_odd_unpack_batch_minor_reference(
            re, im, n, st.size, tables, inner.chirps(False))
    got = _c(re.cpu().numpy(), im.cpu().numpy())
    assert _rel(got, _c(pre.cpu().numpy(), pim.cpu().numpy())) <= 1e-6
    assert _rel(got, np.fft.rfft(x.cpu().double().numpy(), axis=0)) <= 1e-6
    assert _rel(back.cpu().numpy(), pback.cpu().numpy()) <= 1e-6
    assert _rel(back.cpu().numpy(), x.cpu().numpy()) <= 1e-6
