"""Plan summaries of the port (``plan/summary.py``) against the JAX package's.

* Every complex64 plan class at a few sizes, built by both packages through
  the same route: ``summarize`` matches the JAX package's field by field
  (kind, size, dtype, stages, flops, min-HBM bytes), children included.
* ``table_bytes`` is the port's own: the bytes of the plan's buffers.
* The complex128 plans (native f64 in the port) are checked for structure:
  their kinds, their children's kinds and their stage counts.
"""

import numpy as np
import pytest
import torch

import fourier_tpu as jft
from fourier_tpu.plan.bluestein_fused import VpuBluesteinPlan as JVpuBluesteinPlan
from fourier_tpu.plan.mxu import MxuFftPlan as JMxuFftPlan
from fourier_tpu.plan.summary import summarize as jsummarize
from fourier_tpu.rfft import RfftPlan as JRfftPlan

import fourier_tpu_torch as tft
from fourier_tpu_torch import PlanSummary, describe, summarize
from fourier_tpu_torch.plan import MxuFftPlan, plan_tree


def _same(mine: PlanSummary, ref) -> None:
    assert (mine.kind, mine.size, mine.dtype) == (ref.kind, ref.size, ref.dtype)
    assert mine.stages == ref.stages
    assert mine.flops_per_transform == pytest.approx(ref.flops_per_transform, rel=1e-12)
    assert mine.min_hbm_bytes_per_transform == ref.min_hbm_bytes_per_transform
    assert len(mine.children) == len(ref.children)
    for c, r in zip(mine.children, ref.children):
        _same(c, r)


def _buffer_bytes(plan) -> int:
    return sum(t.nbytes for _, t in plan.named_buffers())


_ROUTES = [(n, backend) for n in (64, 125, 250, 1013, 4096, 65536)
           for backend in ("vpu", "mxu", "stockham")]
# Sizes the JAX rules run as one full-size DFT product and the card's vpu
# route as B2 (plan/planner.py, _card_bluestein): held against the JAX
# package's VpuBluesteinPlan.
CARD_B2 = (125, 250)


@pytest.mark.parametrize("n,backend", _ROUTES)
def test_summary_matches_jax(n, backend):
    mine = tft.create_fft(n, backend=backend, cache=False, device="cpu")
    ref = jft.create_fft(n, backend=backend, cache=False)
    if backend == "vpu" and n in CARD_B2:
        ref = JVpuBluesteinPlan.create(n)
    assert plan_tree(mine) == plan_tree(ref)
    s = summarize(mine)
    _same(s, jsummarize(ref))
    assert s.table_bytes == _buffer_bytes(mine) > 0
    assert describe(mine).splitlines()[0].startswith(f"{s.kind}(n={n}")


@pytest.mark.parametrize("impl", ["xla", "xla_packed", "pallas"])
@pytest.mark.parametrize("n", [64, 125, 250, 4096])
def test_mxu_impl_summary_matches_jax(n, impl):
    mine = MxuFftPlan.create(n, impl=impl, device="cpu")
    s = summarize(mine)
    _same(s, jsummarize(JMxuFftPlan.create(n, impl=impl)))
    assert s.kind == f"MxuBailey[{impl}]"
    assert s.table_bytes == _buffer_bytes(mine)
    assert f"MxuBailey[{impl}]" in describe(mine)


@pytest.mark.parametrize("n,backend", [(1024, "vpu"), (1024, "mxu"), (1013, "vpu"),
                                       (250, "vpu")])
def test_rfft_summary_matches_jax(n, backend):
    mine = tft.RfftPlan(n, backend=backend, device="cpu")
    ref = JRfftPlan(n, backend=backend)
    inner = n // 2 if n % 2 == 0 else n
    if backend == "vpu" and inner in CARD_B2:
        ref.inner = JVpuBluesteinPlan.create(inner)
    assert plan_tree(mine) == plan_tree(ref)
    s = summarize(mine)
    _same(s, jsummarize(ref))
    assert s.table_bytes == _buffer_bytes(mine)
    assert "RealFft" in describe(mine)


# c128 (native f64): kind, children's kinds, stage count.
_C128 = {
    1024: ("VpuFusedF64", [], 4),
    1013: ("VpuFusedBluesteinF64", [], 2 * 4 + 3),
    2187: ("SplitRadix3F64", ["VpuFusedF64"], 3),
    8192: ("SplitRadix2F64", ["VpuFusedF64"], 3),
    1418: ("Bluestein", ["VpuFusedF64"], 5),
    12: ("Stockham", [], 2),
}


@pytest.mark.parametrize("n", sorted(_C128))
def test_c128_summary_structure(n):
    plan = tft.create_fft(n, torch.complex128, backend="dd", cache=False, device="cpu")
    s = summarize(plan)
    kind, children, nstages = _C128[n]
    assert (s.kind, s.size, s.dtype) == (kind, n, "complex128")
    assert [c.kind for c in s.children] == children
    assert len(s.stages) == nstages
    assert s.flops_per_transform > 0 and s.min_hbm_bytes_per_transform == 32 * n
    assert s.table_bytes == _buffer_bytes(plan)
    r = summarize(tft.RfftPlan(2048, torch.complex128, device="cpu"))
    assert r.kind == "RealFft" and r.dtype == "complex128"
    assert r.min_hbm_bytes_per_transform == 2048 * 8 + 1025 * 16


def test_unknown_plan_falls_back():
    class Odd(torch.nn.Module):
        size, dtype = 8, torch.complex64

    s = summarize(Odd())
    assert (s.kind, s.flops_per_transform, s.table_bytes) == ("Odd", 0.0, 0)
    assert np.isclose(s.min_hbm_bytes_per_transform, 2 * 8 * 8)
