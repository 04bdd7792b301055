"""Kernel B1 of the port: its plain version against the JAX Pallas kernel,
and the CUDA kernel's host-side inputs.

* The port's VpuFftPlan on the CPU runs B1's plain PyTorch version; the JAX
  VpuFftPlan runs its Pallas kernel in interpret mode on the CPU (as
  ``tests/test_vpu.py`` does). Same seeded inputs, rel-L2 <= 1e-6: each f32
  result sits within ~3e-7 of exact. Sizes whose interpret run takes tens of
  seconds here (625, 729, 2187, 3125) and the large 4096/16384 are held
  against the oracle / np.fft instead.
* The CUDA kernel cannot run here. A numpy transliteration of its algorithm
  (its own stage schedule, its concatenated twiddle tables with the offsets
  the host function computes, its in-place stage indexing, its column
  blocking and ragged-edge mask) is held against np.fft over the domain, so
  what the Python side hands the kernel is checked on every run. The stage
  part, :func:`emulate_stages`, also serves the emulations of B2 and B3.
* ``test_kernel_matches_plain_on_card`` runs the kernel itself where a card
  is present (marker ``cuda``).
"""

import numpy as np
import pytest
import torch

from fourier_tpu import Transform as JTransform
from fourier_tpu.plan.vpu import VpuFftPlan as JVpuFftPlan

from fourier_tpu_torch import Transform, trace
from fourier_tpu_torch.ops.cuda import stockham_vpu as sv
from fourier_tpu_torch.ops.cuda import stockham_vpu_dd as dv
from fourier_tpu_torch.plan.vpu import VpuFftPlan
from fourier_tpu_torch.utils import oracle_transform

RNG_SEED = 0x8888
REL_L2 = 1e-6


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


def _port_bm(plan, x_t, mode):
    ore, oim = plan.transform_planar_bm(torch.as_tensor(x_t.real.copy()),
                                        torch.as_tensor(x_t.imag.copy()), mode)
    return ore.numpy() + 1j * oim.numpy()


def _jax_bm(plan, x_t, mode):
    ore, oim = plan.transform_planar_bm(x_t.real.copy(), x_t.imag.copy(),
                                        JTransform(int(mode)))
    return np.asarray(ore) + 1j * np.asarray(oim)


@pytest.mark.parametrize("n", [64, 96, 128, 243, 256, 320, 1024])
def test_plain_b1_matches_pallas_interpret(n):
    rng = np.random.default_rng(RNG_SEED + n)
    x_t = _rand((n, 7), rng)  # ragged B: no padding in the port
    mode = Transform.FFT if n != 96 else Transform.IFFT
    mine = _port_bm(VpuFftPlan.create(n, device="cpu"), x_t, mode)
    ref = _jax_bm(JVpuFftPlan.create(n), x_t, mode)
    assert mine.shape == (n, 7)
    assert _rel(mine, ref) <= REL_L2


@pytest.mark.parametrize("mode", list(Transform))
def test_plain_b1_modes_match_pallas_interpret(mode):
    n = 64
    rng = np.random.default_rng(RNG_SEED)
    x_t = _rand((n, 5), rng)
    mine = _port_bm(VpuFftPlan.create(n, device="cpu"), x_t, mode)
    ref = _jax_bm(JVpuFftPlan.create(n), x_t, mode)
    assert _rel(mine, ref) <= REL_L2


def test_plain_b1_batch_major_matches_pallas_interpret():
    n = 64
    rng = np.random.default_rng(RNG_SEED)
    x = _rand((3, 4, n), rng)
    ore, oim = VpuFftPlan.create(n, device="cpu").transform_planar(
        torch.as_tensor(x.real.copy()), torch.as_tensor(x.imag.copy()))
    mine = ore.numpy() + 1j * oim.numpy()
    jre, jim = JVpuFftPlan.create(n).transform_planar(x.real, x.imag)
    ref = np.asarray(jre) + 1j * np.asarray(jim)
    assert mine.shape == (3, 4, n)
    assert _rel(mine, ref) <= REL_L2


@pytest.mark.parametrize("n", [625, 729, 2187, 3125, 4096, 16384])
def test_plain_b1_large_and_pure_powers(n):
    rng = np.random.default_rng(RNG_SEED + n)
    x = _rand((3, n), rng)
    plan = VpuFftPlan.create(n, device="cpu")
    for mode in (Transform.FFT, Transform.SQRT_SCALED_IFFT):
        got = _port_bm(plan, np.ascontiguousarray(x.T), mode).T
        if n <= 4096:
            want = oracle_transform(x, mode)
        else:
            want = np.fft.fft(x.astype(np.complex128), axis=-1)
            if not mode.is_forward:
                want = np.fft.ifft(x.astype(np.complex128), axis=-1) * np.sqrt(n)
        assert _rel(got, want) <= REL_L2, (n, mode)


def emulate_stages(s, n, cols, forward, dd=False):
    """numpy transliteration of run_stages in csrc/stockham_stages.cuh
    (butterflies as exact DFTs), in place on one block's flat (n * cols)
    shared-memory planes `s`: each stage reads every butterfly's inputs,
    then writes its twiddled outputs, in the kernel's index order. Shared
    by the emulations of B1, B2 and B3, and with `dd` (the f64 schedule,
    tables and launch geometry) of B6 and B7."""
    if dd:
        geometry, tables, schedule = (dv.launch_geometry_dd,
                                      dv.make_kernel_tables_dd,
                                      dv.kernel_schedule_dd)
    else:
        geometry, tables, schedule = (sv.launch_geometry, sv.make_kernel_tables,
                                      sv.kernel_schedule)
    _, threads = geometry(n)
    tw = tables(n, forward)
    tw = tw[0].astype(np.float64) + 1j * tw[1].astype(np.float64)
    size, stride, off = n, 1, 0
    for r in schedule(n):
        m = size // r
        blk = m * stride
        ids = np.arange(blk * cols)
        assert ids.size <= threads * -(-sv.POINTS_PER_THREAD // r)
        p, col = ids // cols, ids % cols
        i, j = p // stride, p % stride
        k = np.arange(r)[:, None]
        xin = s[(k * blk + p) * cols + col]
        y = np.fft.fft(xin, axis=0) if forward else np.fft.ifft(xin, axis=0) * r
        if m > 1:
            y = y * tw[off + i * r + k]
            off += size
        s[((i * r + k) * stride + j) * cols + col] = y
        size, stride = m, stride * r
    assert off == tw.size


def _emulate_kernel(x_t, n, forward, scale):
    """numpy transliteration of csrc/stockham_vpu.cu: per block of `cols`
    columns, load (the ragged last block masked), the stages, scaled store."""
    cols, _ = sv.launch_geometry(n)
    b = x_t.shape[1]
    out = np.empty((n, b), np.complex128)
    for b0 in range(0, b, cols):
        valid = min(cols, b - b0)
        s = np.zeros((n, cols), np.complex128)
        s[:, :valid] = x_t[:, b0:b0 + valid]
        s = s.ravel()
        emulate_stages(s, n, cols, forward)
        out[:, b0:b0 + valid] = s.reshape(n, cols)[:, :valid] * scale
    return out


@pytest.mark.parametrize("n", [64, 96, 243, 320, 625, 1000, 2187, 4096, 6561,
                               14400, 16384])
def test_kernel_algorithm_emulated(n):
    rng = np.random.default_rng(RNG_SEED + n)
    cols, _ = sv.launch_geometry(n)
    x_t = _rand((n, cols + 3), rng).astype(np.complex128)  # ragged last block
    for mode in (Transform.FFT, Transform.IFFT):
        got = _emulate_kernel(x_t, n, mode.is_forward, mode.scale(n) or 1.0)
        want = (np.fft.fft(x_t, axis=0) if mode.is_forward
                else np.fft.ifft(x_t, axis=0))
        assert _rel(got, want) <= REL_L2, (n, mode)


def test_wrapper_contract():
    """The wrapper runs the plain version only for CPU tensors and raises on
    anything the kernel does not take; there is no fallback."""
    n = 64
    plan = VpuFftPlan.create(n, device="cpu")
    tables = plan.tables(True)
    ok = torch.zeros(n, 3)
    for bad in (ok.double(), torch.zeros(n, 6)[:, ::2], torch.zeros(n + 1, 3)):
        with pytest.raises((TypeError, ValueError)):
            sv.vpu_fft_batch_minor(bad, bad, n, True, None, tables=tables,
                                   kernel_tables=plan.kernel_fwd)
    meta = torch.zeros(n, 3, device="meta")
    with pytest.raises(ValueError):
        sv.vpu_fft_batch_minor(meta, meta, n, True, None, tables=tables,
                               kernel_tables=plan.kernel_fwd)
    before = launches("vpu_fft")
    sv.vpu_fft_batch_minor(ok, ok, n, True, None, tables=tables,
                           kernel_tables=plan.kernel_fwd)
    assert launches("vpu_fft") == before  # plain version: no launch


def test_create_domain():
    assert VpuFftPlan.create(100, device="cpu") is None
    assert VpuFftPlan.create(32, device="cpu") is None
    assert VpuFftPlan.create(32768, device="cpu") is None
    assert VpuFftPlan.create(64, torch.complex128, device="cpu") is None
    assert VpuFftPlan.create(125, device="cpu") is None
    assert VpuFftPlan.create(6561, device="cpu").schedule == (81, 81)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 96, 243, 320, 625, 729, 1000, 2187, 3125,
                               4096, 6561, 14400, 16384])
def test_kernel_matches_plain_on_card(cuda_device, n):
    rng = np.random.default_rng(RNG_SEED + n)
    plan = VpuFftPlan.create(n, device=cuda_device)
    x = _rand((n, 1000), rng)
    re = torch.as_tensor(x.real.copy(), device=cuda_device)
    im = torch.as_tensor(x.imag.copy(), device=cuda_device)
    for mode in Transform:
        before = launches("vpu_fft")
        kre, kim = plan.transform_planar_bm(re, im, mode)
        assert launches("vpu_fft") == before + 1
        pre, pim = sv.vpu_fft_batch_minor_reference(
            re, im, n, plan.tables(mode.is_forward), mode.is_forward, mode.scale(n))
        torch.cuda.synchronize()
        got = kre.cpu().numpy() + 1j * kim.cpu().numpy()
        want = pre.cpu().numpy() + 1j * pim.cpu().numpy()
        assert _rel(got, want) <= REL_L2, (n, mode)
