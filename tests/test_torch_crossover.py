"""The card's rule between one full-size DFT product and kernel B2 in the
vpu route (``plan/planner.py``, ``_card_bluestein``).

A size the JAX package's rules run as one full-size product (split-less up
to ``MxuFftPlan.DIRECT_SINGLE_MAX``, or a split demoted to one product)
plans as :class:`VpuBluesteinPlan` where B2 takes it (n >= 17); every other
size plans the JAX package's tree. The ``mxu`` backend keeps
the product. On the CPU B2 runs its plain version.
"""

import numpy as np
import pytest
import torch

import fourier_tpu as jft

from fourier_tpu.plan.bluestein_fused import VpuBluesteinPlan as JVpuBluesteinPlan
from fourier_tpu_torch import Transform, trace
from fourier_tpu_torch.plan import (MxuFftPlan, VpuBluesteinPlan, plan_tree,
                                    planner)

BENCH15_PRODUCTS = (125, 191, 222, 439, 722)  # the JAX rules' products among fft_bench.rs's sizes
REL_L2 = 1e-6


def _b2_inner(n):
    return VpuBluesteinPlan.choose_inner(n, VpuBluesteinPlan.MAX_INNER)


B2_FIRST = next(n for n in range(2, 64) if _b2_inner(n) is not None)  # 17
EDGE = sorted({B2_FIRST - 1, B2_FIRST, *BENCH15_PRODUCTS})


@pytest.mark.parametrize("n", range(2, MxuFftPlan.DIRECT_SINGLE_MAX + 1))
def test_vpu_route_runs_b2_past_the_crossover(n):
    """B2 exactly where the JAX tree is one full-size product and B2 takes
    n, as the JAX package's own VpuBluesteinPlan plans it; the JAX tree
    everywhere else."""
    mine = plan_tree(planner.create_fft(n, backend="vpu", device="cpu", cache=False))
    ref = plan_tree(jft.create_fft(n, backend="vpu", cache=False))
    single = ref[0] == "MxuFftPlan" and ref[2][0] == 1
    if ref[0] == "MxuFftPlan":
        assert single == MxuFftPlan.single_product(n)
    if single and _b2_inner(n) is not None:
        assert mine == ("VpuBluesteinPlan", n, _b2_inner(n))
        assert mine == plan_tree(JVpuBluesteinPlan.create(n))
    else:
        assert mine == ref


@pytest.mark.parametrize("n", EDGE)
def test_crossover_counts_each_build_it_moved(n):
    """``plan.crossover_b2`` counts one a build the rule sent to B2, none on
    a cache hit, and none under ``backend="mxu"``, which keeps the product."""
    moved = _b2_inner(n) is not None
    planner.clear_plan_cache()
    before = trace.counters().snapshot()
    plans = [planner.create_fft(n, backend="vpu", device="cpu") for _ in range(2)]
    assert plans[0] is plans[1]
    assert isinstance(plans[0], VpuBluesteinPlan if moved else MxuFftPlan)
    assert trace.counters().delta(before) == {
        "plan.cache_miss": 1, "plan.cache_hit": 1,
        **({"plan.crossover_b2": 1} if moved else {})}
    before = trace.counters().snapshot()
    product = planner.create_fft(n, backend="mxu", device="cpu", cache=False)
    assert isinstance(product, MxuFftPlan) and product.single_phase
    assert trace.counters().delta(before) == {}


@pytest.mark.parametrize("n", EDGE)
def test_outputs_match_numpy_on_both_sides_of_the_crossover(n):
    """The vpu route's plan against np.fft in f64, batch-major and
    batch-minor, forward and inverse."""
    plan = planner.create_fft(n, backend="vpu", device="cpu", cache=False)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))
    x = x.astype(np.complex64)
    re = torch.from_numpy(np.ascontiguousarray(x.real))
    im = torch.from_numpy(np.ascontiguousarray(x.imag))
    x64 = x.astype(np.complex128)
    for mode in (Transform.FFT, Transform.IFFT):
        want = np.fft.fft(x64, axis=-1) if mode.is_forward else np.fft.ifft(x64, axis=-1)
        ore, oim = plan.transform_planar(re, im, mode)
        bre, bim = plan.transform_planar_bm(re.T.contiguous(), im.T.contiguous(), mode)
        for got in ((ore + 1j * oim).numpy(), (bre + 1j * bim).numpy().T):
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= REL_L2, (n, mode, type(plan).__name__, rel)
