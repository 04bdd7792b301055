"""The yardstick: each cell's work from its shapes, the peaks, and the
reference against numpy."""

import json
import math

import numpy as np
import pytest
import torch

from benchmark import harness, peaks, work
from benchmark.reference import dft as ref
from benchmark.tests.conftest import REPO

# One call of each cell: (flops, bytes) of one rank's share.
EXPECTED = {
    "c64-1d.n4096-b16384": (5.0 * 4096 * 12 * 16384, 16.0 * 4096 * 16384),
    "fft2d-4096.x1-b32": (5.0 * 4096 ** 2 * 24 * 32, 16.0 * 4096 ** 2 * 32),
}


def _work(config, traffic, world):
    cfg = json.loads((REPO / "benchmark" / "configs" / f"{config}.json").read_text())
    mix = json.loads((REPO / "benchmark" / "traffic" / f"{traffic}.json").read_text())
    kind = harness._load_file(REPO / "benchmark" / "kinds" / f"{mix['kind']}.py", "test_kind_")
    return kind.work_of(cfg, mix, world), mix


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_work_of_each_cell(name):
    config, traffic = name.split(".", 1)
    got, _ = _work(config, traffic, 1)
    assert (got.flops, got.bytes) == EXPECTED[name]


def test_work_is_independent_of_route():
    assert work.transform_flops(4096) == 5 * 4096 * 12
    assert work.transform_bytes(1013) == 2 * 1013 * 8
    assert work.transform_bytes(4096, "complex128") == 2 * 4096 * 16
    assert work.transform_flops(1) == 0.0


def test_least_seconds_takes_the_longer_bound():
    w = work.batched(4096, 16384)
    assert peaks.least_seconds(w.flops, w.bytes) == w.bytes / peaks.HBM_BYTES_PER_S
    assert peaks.least_seconds(1e12, 1.0) == 1e12 / peaks.F32_FLOPS_PER_S


@pytest.mark.parametrize("n", [1, 7, 12, 64, 100])
@pytest.mark.parametrize("forward", [True, False])
def test_reference_matches_numpy(n, forward):
    g = torch.Generator().manual_seed(n)
    re, im = torch.randn((2, n, 3), generator=g, dtype=torch.float64)
    yr, yi = ref.dft(re, im, 0, forward)
    x = (re + 1j * im).numpy()
    want = np.fft.fft(x, axis=0) if forward else np.fft.ifft(x, axis=0) * n
    np.testing.assert_allclose(yr.numpy() + 1j * yi.numpy(), want, rtol=0, atol=1e-12 * n)


def test_reference_rows_of_2d():
    g = torch.Generator().manual_seed(0)
    re, im = torch.randn((2, 2, 8, 12), generator=g, dtype=torch.float64)
    yr, yi = ref.dft2(re, im, True, 0.5, rows=slice(4, 8))
    want = np.fft.fft2((re + 1j * im).numpy())[:, 4:8] * 0.5
    np.testing.assert_allclose(yr.numpy() + 1j * yi.numpy(), want, rtol=0, atol=1e-12)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -1.0 - 2.0 ** -12, 3.0])
    assert ref.to_tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -9, -1.0, 3.0]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    rel = ((ref.to_tf32(y) - y).abs() / y.abs()).max().item()
    assert 2.0 ** -12 < rel <= 2.0 ** -11


def test_spread_is_the_quartile_distance_over_the_median():
    from benchmark import spread

    line = lambda v: {"metrics": {"gflops": {"value": v, "unit": "GFLOP/s"}}}  # noqa: E731
    a = [100.0, 101.0, 99.0, 100.5, 99.5, 130.0]
    b = [100.0, 100.2, 99.8, 100.1, 99.9, 100.0]
    got = spread.report([[line(v) for v in a], [line(v) for v in b]])["gflops"]
    q1, _, q3 = __import__("statistics").quantiles(a, n=4)
    assert got["spreads"][0] == (q3 - q1) / 100.25
    assert got["medians"] == [100.25, 100.0]
    assert spread.trimmed(a) == a[:5]  # the far run left out
    assert got["trimmed_mean"] < got["spreads"][0]
