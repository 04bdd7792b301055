"""Kernels B1-B7 of the port on a CUDA card, each at the body
``kernel_body`` picks for its size, against ``np.fft`` in f64 or its plain
version, at sizes of each body it runs: its clustered or paired body, and
its stage body both where the size is in the kernel's stage-faster set and
where it has no clustered geometry (B1 at n = 1000 and 3125, B3 at p =
1000 and 3125). B7 has one body, the paired one.

This module imports neither JAX nor the JAX package, so it also runs where
JAX is not installed. There, skip the tests directory's ``conftest.py``
(it sets JAX up for the CPU run):

    python -m pytest --noconftest -m cuda tests/test_torch_pair_kernels_card.py

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from fourier_tpu_torch import FourStepLocalPlan, Transform, VpuBluesteinPlan, VpuFftPlan
from fourier_tpu_torch.ops.cuda import stockham_vpu as sv
from fourier_tpu_torch.ops.cuda import stockham_vpu_dd as dv
from fourier_tpu_torch.precision import VpuDdBluesteinPlan, VpuDdFftPlan
from fourier_tpu_torch.rfft import RfftPlan

C64_GATE = 1e-6
C128_GATE = 1e-12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _want(x, mode, n):
    return (np.fft.fft(x, axis=0) if mode.is_forward
            else np.fft.ifft(x, axis=0) * n) * (mode.scale(n) or 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 96, 1000, 1024, 2048, 243, 2160])
def test_b4a_on_card(cuda_device, m):
    plan = RfftPlan(2 * m, device=cuda_device)
    inner = plan.inner
    kw = dict(tables=inner.tables(True), kernel_tables=inner.kernel_fwd,
              pair_tables=inner.pair_fwd, w=plan.w)
    for b in (1, 7, 1000, 1588, 1589):
        x = torch.randn(2 * m, b, device=cuda_device)
        got = sv.vpu_rfft_pack_batch_minor(x, m, **kw)
        want = np.fft.rfft(x.double().cpu().numpy(), axis=0)
        c = got[0].double().cpu().numpy() + 1j * got[1].double().cpu().numpy()
        assert _rel(c, want) <= C64_GATE, (m, b, sv.kernel_body("B4a", m))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 33, 191, 439, 1013])
def test_b7_on_card(cuda_device, n):
    plan = VpuDdBluesteinPlan.create(n, device=cuda_device)
    st = plan.stages
    kw = dict(tables=(st.tables(True), st.tables(False)),
              pair_tables=(st.pair_fwd, st.pair_inv))
    for b in (1, 7, 794, 795):
        re = torch.randn(n, b, dtype=torch.float64, device=cuda_device)
        im = torch.randn(n, b, dtype=torch.float64, device=cuda_device)
        x = re.cpu().numpy() + 1j * im.cpu().numpy()
        for mode in Transform:
            want = (np.fft.fft(x, axis=0) if mode.is_forward
                    else np.fft.ifft(x, axis=0) * n) * (mode.scale(n) or 1.0)
            got = dv.vpu_dd_bluestein_batch_minor(
                re, im, n, st.size, mode.scale(n), chirps=plan.chirps(mode.is_forward), **kw)
            c = got[0].cpu().numpy() + 1j * got[1].cpu().numpy()
            assert _rel(c, want) <= C128_GATE, (n, b, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 2048, 4096, 1000, 3125, 8192])
def test_b1_on_card(cuda_device, n):
    plan = VpuFftPlan.create(n, device=cuda_device)
    for b in (1, 7, 1588, 1589):
        re_ = torch.randn(n, b, device=cuda_device)
        im_ = torch.randn(n, b, device=cuda_device)
        x = re_.double().cpu().numpy() + 1j * im_.double().cpu().numpy()
        for mode in Transform:
            fwd = mode.is_forward
            got = sv.vpu_fft_batch_minor(
                re_, im_, n, fwd, mode.scale(n), tables=plan.tables(fwd),
                kernel_tables=plan.kernel_fwd if fwd else plan.kernel_inv,
                pair_tables=plan.pair_fwd)
            c = got[0].double().cpu().numpy() + 1j * got[1].double().cpu().numpy()
            assert _rel(c, _want(x, mode, n)) <= C64_GATE, (
                n, b, mode, sv.kernel_body("B1", n))


def _bluestein_on_card(cuda_device, n):
    plan = VpuBluesteinPlan.create(n, device=cuda_device)
    st = plan.stages
    kw = dict(tables=(st.tables(True), st.tables(False)),
              kernel_tables=(st.kernel_fwd, st.kernel_inv),
              pair_tables=(st.pair_fwd, st.pair_inv))
    return plan, st, kw


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 73, 509, 1013, 1500])
def test_b2_on_card(cuda_device, n):
    plan, st, kw = _bluestein_on_card(cuda_device, n)
    for b in (1, 7, 794, 795):
        re_ = torch.randn(n, b, device=cuda_device)
        im_ = torch.randn(n, b, device=cuda_device)
        x = re_.double().cpu().numpy() + 1j * im_.double().cpu().numpy()
        for mode in Transform:
            got = sv.vpu_bluestein_batch_minor(
                re_, im_, n, st.size, mode.scale(n), chirps=plan.chirps(mode.is_forward),
                **kw)
            c = got[0].double().cpu().numpy() + 1j * got[1].double().cpu().numpy()
            assert _rel(c, _want(x, mode, n)) <= C64_GATE, (
                n, b, mode, sv.kernel_body("B2", st.size))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 73, 509, 863, 1013])
def test_b5a_on_card(cuda_device, n):
    plan, st, kw = _bluestein_on_card(cuda_device, n)
    for b in (1, 2, 7, 1589, 1592):
        x = torch.randn(n, b, device=cuda_device)
        want = np.fft.rfft(x.double().cpu().numpy(), axis=0)
        got = sv.vpu_rfft_odd_pack_batch_minor(x, n, st.size, chirps=plan.chirps(True), **kw)
        c = got[0].double().cpu().numpy() + 1j * got[1].double().cpu().numpy()
        assert _rel(c, want) <= C64_GATE, (n, b, sv.kernel_body("B5a", st.size))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1024, 2048, 3000, 4096])
def test_b6_on_card(cuda_device, n):
    plan = VpuDdFftPlan.create(n, device=cuda_device)
    for b in (1, 7, 1588, 1589):
        re_ = torch.randn(n, b, dtype=torch.float64, device=cuda_device)
        im_ = torch.randn(n, b, dtype=torch.float64, device=cuda_device)
        x = re_.cpu().numpy() + 1j * im_.cpu().numpy()
        for mode in Transform:
            fwd = mode.is_forward
            got = dv.vpu_dd_fft_batch_minor(
                re_, im_, n, fwd, mode.scale(n), tables=plan.tables(fwd),
                kernel_tables=plan.kernel_fwd if fwd else plan.kernel_inv,
                pair_tables=plan.pair_fwd)
            c = got[0].cpu().numpy() + 1j * got[1].cpu().numpy()
            assert _rel(c, _want(x, mode, n)) <= C128_GATE, (
                n, b, mode, sv.kernel_body("B6", n))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 96, 1000, 2048, 1728, 2160])
def test_b4b_on_card(cuda_device, m):
    plan = RfftPlan(2 * m, device=cuda_device)
    kw = dict(tables=plan.inner.tables(False), kernel_tables=plan.inner.kernel_inv,
              pair_tables=plan.inner.pair_inv, w=plan.w)
    for b in (1, 7, 1000, 1588, 1589):
        re_ = torch.randn(m + 1, b, device=cuda_device)
        im_ = torch.randn(m + 1, b, device=cuda_device)
        want = np.fft.irfft(re_.double().cpu().numpy() + 1j * im_.double().cpu().numpy(),
                            2 * m, axis=0)
        got = sv.vpu_irfft_unpack_batch_minor(re_, im_, m, **kw)
        assert _rel(got.double().cpu().numpy(), want) <= C64_GATE, (
            m, b, sv.kernel_body("B4b", m))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 73, 509, 863, 1013])
def test_b5b_on_card(cuda_device, n):
    plan, st, kw = _bluestein_on_card(cuda_device, n)
    L = (n + 1) // 2
    for b in (1, 2, 7, 1589, 1592):
        re_ = torch.randn(L, b, device=cuda_device)
        im_ = torch.randn(L, b, device=cuda_device)
        want = np.fft.irfft(re_.double().cpu().numpy() + 1j * im_.double().cpu().numpy(),
                            n, axis=0)
        got = sv.vpu_irfft_odd_unpack_batch_minor(re_, im_, n, st.size,
                                                  chirps=plan.chirps(False), **kw)
        assert _rel(got.double().cpu().numpy(), want) <= C64_GATE, (
            n, b, sv.kernel_body("B5b", st.size))


def _b3_splits():
    """(p, q) of the routes' large sizes, whose p run the clustered body, and
    p = 1000 (B3_STAGE_FASTER) and 3125 (no clustered geometry), which run
    the stage body."""
    from fourier_tpu_torch.plan.four_step_local import choose_large_split

    return [choose_large_split(n) for n in (32768, 65536, 262144)] + [(1000, 64), (3125, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("p,q", _b3_splits())
def test_b3_on_card(cuda_device, p, q):
    n = p * q
    plan = FourStepLocalPlan.create(n, torch.complex64, p, q,
                                    lambda m, dt, dev: VpuFftPlan.create(m, dt, dev),
                                    device=cuda_device)
    rp = plan.row_plan
    for b in (1, 7, 64, 65):
        re3 = torch.randn(q, p, b, device=cuda_device)
        im3 = torch.randn(q, p, b, device=cuda_device)
        for mode in Transform:
            fwd = mode.is_forward
            tw = plan.tw_fwd if fwd else plan.tw_inv
            kw = dict(tables=rp.tables(fwd), pre_tw=(tw[0], tw[1]),
                      kernel_tables=rp.kernel_fwd if fwd else rp.kernel_inv,
                      pair_tables=rp.pair_fwd, tw_fwd=(plan.tw_fwd[0], plan.tw_fwd[1]))
            want = sv.vpu_fft_four_step_row_reference(re3, im3, p, q, kw["tables"],
                                                      kw["pre_tw"], fwd, mode.scale(n))
            want = want[0].double().cpu().numpy() + 1j * want[1].double().cpu().numpy()
            got = sv.vpu_fft_four_step_row(re3, im3, p, q, fwd, mode.scale(n), **kw)
            c = got[0].double().cpu().numpy() + 1j * got[1].double().cpu().numpy()
            assert _rel(c, want) <= C64_GATE, (p, q, b, mode, sv.kernel_body("B3", p))


def _misaligned(t):
    """A contiguous copy of `t` whose data starts one element past a 16-byte
    boundary: the kernels then take their element copies and stores."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


# The push split of fft_pair (B1, B3 and B6, csrc/stockham_pair.cuh) at a
# size on two-block clusters, one on four and 2160 (h/C = 135 rows a rank's
# share), and B3 at p = 4000 (the twiddle in a pass of its own); at a batch
# whose copies and stores are 16-byte, a ragged one, and the first again on
# a view one element off a 16-byte boundary (element copies).
PUSH_CASES = [("B1", 2048), ("B1", 4096), ("B1", 2160), ("B3", 256), ("B3", 4096),
              ("B3", 2160), ("B3", 4000), ("B6", 2048), ("B6", 4096), ("B6", 2160)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,n", PUSH_CASES)
def test_push_split_on_card(cuda_device, kernel, n):
    assert sv.kernel_body(kernel, n) == "pair", (kernel, n)
    f64 = kernel == "B6"
    gate = C128_GATE if f64 else C64_GATE
    dt = torch.float64 if f64 else torch.float32
    if kernel == "B3":
        q = 16
        plan = FourStepLocalPlan.create(n * q, torch.complex64, n, q,
                                        lambda m, dt_, dev: VpuFftPlan.create(m, dt_, dev),
                                        device=cuda_device)
        shape, batches = (q, n), (64, 65)
    else:
        plan = (VpuDdFftPlan if f64 else VpuFftPlan).create(n, device=cuda_device)
        shape, batches = (n,), (1588, 1589)
    for b, off in ((batches[0], False), (batches[1], False), (batches[0], True)):
        re_ = torch.randn(*shape, b, dtype=dt, device=cuda_device)
        im_ = torch.randn(*shape, b, dtype=dt, device=cuda_device)
        if off:
            re_, im_ = _misaligned(re_), _misaligned(im_)
            assert re_.data_ptr() % 16 and im_.data_ptr() % 16
        x = re_.double().cpu().numpy() + 1j * im_.double().cpu().numpy()
        for mode in Transform:
            fwd, scale = mode.is_forward, mode.scale(n if kernel != "B3" else n * q)
            if kernel == "B3":
                rp = plan.row_plan
                tw = plan.tw_fwd if fwd else plan.tw_inv
                got = sv.vpu_fft_four_step_row(
                    re_, im_, n, q, fwd, scale, tables=rp.tables(fwd),
                    kernel_tables=rp.kernel_fwd if fwd else rp.kernel_inv,
                    pair_tables=rp.pair_fwd, pre_tw=(tw[0], tw[1]),
                    tw_fwd=(plan.tw_fwd[0], plan.tw_fwd[1]))
                w = tw[0].double().cpu().numpy() + 1j * tw[1].double().cpu().numpy()
                y = x * w[:, :, None]
                y = np.fft.fft(y, axis=1) if fwd else np.fft.ifft(y, axis=1) * n
                want = y.transpose(1, 0, 2).reshape(n * q, b) * (scale or 1.0)
            else:
                wrapper = dv.vpu_dd_fft_batch_minor if f64 else sv.vpu_fft_batch_minor
                got = wrapper(re_, im_, n, fwd, scale, tables=plan.tables(fwd),
                              kernel_tables=plan.kernel_fwd if fwd else plan.kernel_inv,
                              pair_tables=plan.pair_fwd)
                want = _want(x, mode, n)
            c = got[0].double().cpu().numpy() + 1j * got[1].double().cpu().numpy()
            assert _rel(c, want) <= gate, (kernel, n, b, off, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 4096])
def test_split_cluster_bytes_on_card(cuda_device, n):
    """One B1 call counts (C-1)/C * 8 * n * B bytes pushed across its
    clusters: both f32 planes of every point but those that stay on their
    rank."""
    from fourier_tpu_torch import trace

    plan = VpuFftPlan.create(n, device=cuda_device)
    b = 1024
    re_ = torch.randn(n, b, device=cuda_device)
    im_ = torch.randn(n, b, device=cuda_device)
    c = sv.fft_pair_geometry(n).ranks
    before = trace.counters().snapshot()
    sv.vpu_fft_batch_minor(re_, im_, n, True, None, tables=plan.tables(True),
                           kernel_tables=plan.kernel_fwd, pair_tables=plan.pair_fwd)
    torch.cuda.synchronize()
    moved = trace.counters().delta(before)
    assert moved["split.cluster_bytes"] == (c - 1) * 8 * n * b // c
    assert moved["launches.fourier_tpu_torch::vpu_fft"] == 1
