"""Kernel B3 of the port (the four-step row leg) and FourStepLocalPlan.

* ``FourStepLocalPlan.create(4096, c64, 64, 64, vpu factory)`` in both
  packages: the port's row leg runs B3's plain PyTorch version, the JAX row
  leg runs B3 in interpret mode (as ``tests/test_mxu.py`` does). All 5 modes,
  both layouts, rel-L2 <= 5e-6. B3's plain function alone is held against
  ``vpu_fft_four_step_row(..., interpret=True)``.
* Larger sizes (32768, and 20000 whose row plan is an MxuFftPlan, so the
  plain twiddle-transpose route runs) are held against np.fft, rel-L2 <= 2e-6.
* The CUDA kernel cannot run here: a numpy transliteration of its indexing
  (grid over column groups and k2, twiddle-and-scale load, the shared
  stages, the transposed store) is held against np.fft.
* ``test_kernel_matches_plain_on_card`` runs the kernel where a card is
  present (marker ``cuda``); its clustered body reads the forward twiddle
  (``tw_fwd``) in both directions. The clustered body's own emulation is
  in ``tests/test_torch_pair_kernels.py``.
"""

import numpy as np
import pytest
import torch

from fourier_tpu import Transform as JTransform
from fourier_tpu.ops.pallas import stockham_vpu as jsv
from fourier_tpu.plan.four_step_local import FourStepLocalPlan as JFourStepLocalPlan
from fourier_tpu.plan.four_step_local import choose_large_split as jchoose
from fourier_tpu.plan.vpu import VpuFftPlan as JVpuFftPlan

import fourier_tpu_torch as tft
from fourier_tpu_torch import Transform, trace
from fourier_tpu_torch.ops.cuda import stockham_vpu as sv
from fourier_tpu_torch.plan import FourStepLocalPlan, MxuFftPlan, VpuFftPlan
from fourier_tpu_torch.plan.four_step_local import choose_large_split

from test_torch_vpu import emulate_stages

RNG_SEED = 0xB3


def launches(op: str) -> int:
    """Launches of the operator ``fourier_tpu_torch::<op>`` counted so far."""
    return trace.counters()[f"launches.fourier_tpu_torch::{op}"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


def _rand(shape, rng):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _planes(x):
    return (torch.as_tensor(np.ascontiguousarray(x.real)),
            torch.as_tensor(np.ascontiguousarray(x.imag)))


def _np(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _want(x, mode, axis):
    n = x.shape[axis]
    y = (np.fft.fft(x, axis=axis) if mode.is_forward
         else np.fft.ifft(x, axis=axis) * n)
    return y * (mode.scale(n) or 1.0)


def test_four_step_4096_matches_jax_b3_interpret():
    n, p, q = 4096, 64, 64
    mine = FourStepLocalPlan.create(
        n, torch.complex64, p, q, lambda m, dt, dev: VpuFftPlan.create(m, dt, dev),
        device="cpu")
    ref = JFourStepLocalPlan.create(n, np.complex64, p, q,
                                    lambda m, dt: JVpuFftPlan.create(m, dt))
    assert ref._row_fused_cfg() is not None  # the JAX row leg is B3
    rng = np.random.default_rng(RNG_SEED)
    x_t = _rand((n, 3), rng)
    for mode in Transform:
        want = _np(*ref.transform_planar_bm(x_t.real, x_t.imag, JTransform(int(mode))))
        got = _np(*mine.transform_planar_bm(*_planes(x_t), mode))
        assert got.shape == (n, 3)
        assert _rel(got, want) <= 5e-6, mode
    x = np.ascontiguousarray(x_t.T)
    want = _np(*ref.transform_planar(x.real, x.imag, JTransform.IFFT))
    got = _np(*mine.transform_planar(*_planes(x), Transform.IFFT))
    assert _rel(got, want) <= 5e-6


@pytest.mark.parametrize("mode", [Transform.FFT, Transform.SQRT_SCALED_IFFT])
def test_plain_row_kernel_matches_pallas_interpret(mode):
    p, q, b = 64, 16, 5
    rng = np.random.default_rng(RNG_SEED + int(mode))
    x3 = _rand((q, p, b), rng)
    forward = mode.is_forward
    tw = FourStepLocalPlan.create(p * q, torch.complex64, p, q,
                                  lambda m, dt, dev: VpuFftPlan.create(m, dt, dev),
                                  device="cpu")
    pre = tw.tw_fwd if forward else tw.tw_inv  # (2, q, p)
    scale = mode.scale(p * q)
    s = 1.0 if scale is None else np.float32(scale)
    jtables = jsv.make_stage_tables(p, forward)
    jpre = (pre[0].numpy().T * s, pre[1].numpy().T * s)  # (p, q), scale folded
    want = _np(*jsv.vpu_fft_four_step_row(
        x3.real, x3.imag, p, q, jtables, jpre, forward, cb=b, interpret=True))
    got = _np(*sv.vpu_fft_four_step_row_reference(
        *_planes(x3), p, q, VpuFftPlan.create(p, device="cpu").tables(forward),
        (pre[0], pre[1]), forward, scale))
    assert got.shape == (p * q, b)
    assert _rel(got, want) <= 1e-6


def test_choose_large_split_matches_jax():
    for n in [16384, 16385, 20000, 32768, 65536, 262144, 10007 * 2, 16384 * 16384,
              16384 * 16385, 3 * 5 * 7 * 11 * 13 * 17]:
        assert choose_large_split(n) == jchoose(n), n


@pytest.mark.parametrize("n", [20000, 32768])
def test_large_four_step_vs_numpy(n):
    plan = tft.create_fft(n, backend="vpu", cache=False, device="cpu")
    assert isinstance(plan, FourStepLocalPlan)
    fused = isinstance(plan.row_plan, VpuFftPlan)
    assert fused == (n == 32768) and isinstance(plan.row_plan, (VpuFftPlan, MxuFftPlan))
    rng = np.random.default_rng(RNG_SEED + n)
    x = _rand((2, n), rng)
    for mode in (Transform.FFT, Transform.IFFT, Transform.SQRT_SCALED_FFT):
        want = _want(x.astype(np.complex128), mode, -1)
        assert _rel(plan.transform(x, mode), want) <= 2e-6, (n, mode)
        got = _np(*plan.transform_planar_bm(*_planes(np.ascontiguousarray(x.T)), mode))
        assert _rel(got.T, want) <= 2e-6, (n, mode, "bm")


def _mxu_cols_vpu_rows(m, dt, dev):
    return VpuFftPlan.create(m, dt, dev) or MxuFftPlan.create(m, dt, dev)


@pytest.mark.parametrize("n,p,q", [(3072, 64, 48), (458752, 512, 896)])
def test_mxu_column_leg_feeds_b3(n, p, q):
    """A column plan with no native batch-minor path (an MxuFftPlan returns
    transposed views) ahead of B3's rows; 458752 is the vpu route's own
    tree."""
    if n == 458752:
        plan = tft.create_fft(n, backend="vpu", cache=False, device="cpu")
        assert (plan.p, plan.q) == (p, q)
    else:
        plan = FourStepLocalPlan.create(n, torch.complex64, p, q, _mxu_cols_vpu_rows,
                                        device="cpu")
    assert isinstance(plan.col_plan, MxuFftPlan) and isinstance(plan.row_plan, VpuFftPlan)
    rng = np.random.default_rng(RNG_SEED + n)
    x_t = _rand((n, 2), rng)
    for mode in Transform:
        want = _want(x_t.astype(np.complex128), mode, 0)
        got = _np(*plan.transform_planar_bm(*_planes(x_t), mode))
        assert _rel(got, want) <= 2e-6, (n, mode, "bm")
        got = _np(*plan.transform_planar(*_planes(np.ascontiguousarray(x_t.T)), mode))
        assert _rel(got.T, want) <= 2e-6, (n, mode)


def _emulate_b3(x3, p, q, pre, forward, scale):
    """numpy transliteration of B3 in csrc/stockham_vpu.cu over flat planes."""
    cols, _ = sv.launch_geometry(p)
    b = x3.shape[-1]
    flat = x3.ravel()
    pre = (pre[0].astype(np.float64) + 1j * pre[1].astype(np.float64)).ravel()
    out = np.full(p * q * b, np.nan, np.complex128)
    for k2 in range(q):  # blockIdx.y
        for b0 in range(0, b, cols):  # blockIdx.x
            e = np.arange(p * cols)
            a, col = e // cols, e % cols
            bb = b0 + col
            ok = bb < b
            s = np.zeros(p * cols, np.complex128)
            g = (k2 * p + a[ok]) * b + bb[ok]
            s[ok] = flat[g] * (pre[k2 * p + a[ok]] * scale)
            emulate_stages(s, p, cols, forward)
            out[a[ok] * (q * b) + k2 * b + bb[ok]] = s[ok]
    return out.reshape(p * q, b)


@pytest.mark.parametrize("p,q", [(64, 16), (96, 8)])
def test_kernel_algorithm_emulated(p, q):
    n = p * q
    plan = FourStepLocalPlan.create(n, torch.complex64, p, q,
                                    lambda m, dt, dev: VpuFftPlan.create(m, dt, dev),
                                    device="cpu")
    cols, _ = sv.launch_geometry(p)
    b = cols + 3  # ragged last column group
    rng = np.random.default_rng(RNG_SEED + n)
    x_t = _rand((n, b), rng).astype(np.complex128)
    for mode in (Transform.FFT, Transform.SQRT_SCALED_IFFT):
        forward = mode.is_forward
        # the column leg, exact: q-point transforms over the (q, p*B) view
        c = x_t.reshape(q, p * b)
        c = np.fft.fft(c, axis=0) if forward else np.fft.ifft(c, axis=0) * q
        pre = (plan.tw_fwd if forward else plan.tw_inv).numpy()
        got = _emulate_b3(c.reshape(q, p, b), p, q, pre, forward,
                          mode.scale(n) or 1.0)
        assert _rel(got, _want(x_t, mode, 0)) <= 1e-6, (p, q, mode)


def test_wrapper_contract():
    p, q = 64, 4
    rp = VpuFftPlan.create(p, device="cpu")
    pre = torch.ones(2, q, p)
    kw = dict(tables=rp.tables(True), kernel_tables=rp.kernel_fwd,
              pre_tw=(pre[0], pre[1]))
    for bad in (torch.zeros(q, p, 3).double(), torch.zeros(q, p, 6)[:, :, ::2],
                torch.zeros(p, q, 3), torch.zeros(q, p, 3, device="meta")):
        with pytest.raises((TypeError, ValueError)):
            sv.vpu_fft_four_step_row(bad, bad, p, q, True, None, **kw)
    before = launches("four_step_row")
    ok = torch.zeros(q, p, 3)
    out = sv.vpu_fft_four_step_row(ok, ok, p, q, True, None, **kw)
    assert out[0].shape == (p * q, 3)
    assert launches("four_step_row") == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32768, 65536, 262144])
def test_kernel_matches_plain_on_card(cuda_device, n):
    plan = tft.create_fft(n, device=cuda_device, cache=False)
    assert isinstance(plan, FourStepLocalPlan) and isinstance(plan.row_plan, VpuFftPlan)
    p, q = plan.p, plan.q
    rng = np.random.default_rng(RNG_SEED + n)
    x3 = _rand((q, p, 7), rng)
    re = torch.as_tensor(x3.real.copy(), device=cuda_device)
    im = torch.as_tensor(x3.imag.copy(), device=cuda_device)
    rp = plan.row_plan
    for mode in Transform:
        fwd = mode.is_forward
        tw = plan.tw_fwd if fwd else plan.tw_inv
        kw = dict(tables=rp.tables(fwd),
                  kernel_tables=rp.kernel_fwd if fwd else rp.kernel_inv,
                  pair_tables=rp.pair_fwd, pre_tw=(tw[0], tw[1]))
        before = launches("four_step_row")
        kre, kim = sv.vpu_fft_four_step_row(re, im, p, q, fwd, mode.scale(n),
                                            tw_fwd=(plan.tw_fwd[0], plan.tw_fwd[1]), **kw)
        assert launches("four_step_row") == before + 1
        pre, pim = sv.vpu_fft_four_step_row_reference(
            re, im, p, q, kw["tables"], kw["pre_tw"], fwd, mode.scale(n))
        got = kre.cpu().numpy() + 1j * kim.cpu().numpy()
        want = pre.cpu().numpy() + 1j * pim.cpu().numpy()
        assert _rel(got, want) <= 1e-6, (n, mode)
