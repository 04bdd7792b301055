"""Plan-time math of the PyTorch port against the JAX package.

Transform modes, twiddles, factorization, the B1 domain (radix_schedule) and
its compact tables must equal the reference's exactly: they are pure numpy
and Python, so any difference is a porting fault.
"""

import numpy as np
import pytest

from fourier_tpu.transform import Transform as JTransform
from fourier_tpu import twiddle as jtw
from fourier_tpu.ops.pallas import stockham_vpu as jsv
from fourier_tpu.plan import factor as jfactor
from fourier_tpu.utils import naive_dft as j_naive_dft

from fourier_tpu_torch.transform import Transform
from fourier_tpu_torch import twiddle as ttw
from fourier_tpu_torch.ops.cuda import stockham_vpu as tsv
from fourier_tpu_torch.plan import factor as tfactor
from fourier_tpu_torch.utils import naive_dft, oracle_transform

RNG_SEED = 0x70C4


@pytest.mark.parametrize("code", range(5))
def test_transform_codes_and_scale(code):
    mine, ref = Transform(code), JTransform(code)
    assert mine.name == ref.name and int(mine) == int(ref)
    assert mine.is_forward == ref.is_forward
    inv = mine.inverse()
    assert (inv is None) == (ref.inverse() is None)
    if inv is not None:
        assert int(inv) == int(ref.inverse())
    for n in (1, 2, 7, 64, 4096, 1013):
        assert mine.scale(n) == ref.scale(n)


@pytest.mark.parametrize("size,radix", [(8, 2), (64, 8), (96, 3), (625, 5),
                                        (4096, 64), (6561, 81), (3125, 125)])
def test_stage_twiddles_bitwise(size, radix):
    for forward in (True, False):
        a = ttw.stage_twiddles(size, radix, forward)
        b = jtw.stage_twiddles(size, radix, forward)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("size", [1, 7, 73, 1013, 4099])
def test_half_twiddle_bitwise(size):
    idx = np.arange(2 * size, dtype=np.float64) ** 2
    assert ttw.half_twiddle(idx, size).tobytes() == jtw.half_twiddle(idx, size).tobytes()


def test_factorize_autosort_equal():
    for n in range(1, 4097):
        assert tfactor.factorize_autosort(n) == jfactor.factorize_autosort(n), n
        assert tfactor.next_power_of_two(n) == jfactor.next_power_of_two(n)
    with pytest.raises(ValueError):
        tfactor.factorize_autosort(0)


def test_radix_schedule_equal():
    for n in range(1, 20001):
        assert tsv.radix_schedule(n) == jsv.radix_schedule(n), n


@pytest.mark.parametrize("n", [64, 96, 128, 243, 320, 576, 625, 1000, 1728,
                               2187, 4096, 6561, 14400, 16384])
def test_compact_tables_equal_dereplicated_jax(n):
    """The port's (m, r) tables are the JAX (n/r, r) tables without their
    replication over the stride: every stride-th row."""
    sched = jsv.radix_schedule(n)
    for forward in (True, False):
        mine = tsv.make_stage_tables(n, forward)
        ref = jsv.make_stage_tables(n, forward)
        assert len(mine) == len(ref) == len(sched) - 1
        stride = 1
        for (tr, ti), (jr, ji), r in zip(mine, ref, sched):
            assert tr.dtype == np.float32 and tr.shape[1] == r
            np.testing.assert_array_equal(tr, jr[::stride])
            np.testing.assert_array_equal(ti, ji[::stride])
            assert jr.shape[0] == tr.shape[0] * stride
            stride *= r


def test_kernel_schedule_and_geometry():
    """Over the whole B1 domain: the kernel's schedule multiplies to n with
    its own radices, and its launch geometry meets the .cu file's limits
    (<= 1024 threads, 16 points a thread, <= 227 KB of shared memory)."""
    domain = [n for n in range(1, 16385) if tsv.radix_schedule(n) is not None]
    assert len(domain) > 100
    for n in domain:
        ks = tsv.kernel_schedule(n)
        assert int(np.prod(ks)) == n and set(ks) <= set(tsv.KERNEL_RADICES), n
        assert len(ks) <= 16
        cols, threads = tsv.launch_geometry(n)
        assert threads % 32 == 0 and threads <= 1024
        assert threads * tsv.POINTS_PER_THREAD >= n * cols
        assert 8 * n * cols <= 227 * 1024
        assert tsv.make_kernel_tables(n, True).shape == (
            2, sum(s for s, _ in tsv._stage_sizes(n, ks)))


def test_oracle_matches_numpy_and_reference():
    rng = np.random.default_rng(RNG_SEED)
    for n in (1, 2, 7, 10, 16, 73, 100):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        np.testing.assert_allclose(naive_dft(x, True), np.fft.fft(x), atol=1e-9)
        np.testing.assert_array_equal(naive_dft(x, False), j_naive_dft(x, False))
        np.testing.assert_allclose(
            oracle_transform(x, Transform.IFFT), np.fft.ifft(x), atol=1e-9
        )
