"""The N-D surface's in-place route (``ndim._transform_in_place``): each
axis of a complex64 transform one pass of B1 on the tensor where it lies
(``VpuFftPlan.transform_strided``), the whole scale on the last pass.

On a card a pass runs so for a CUDA tensor whose axis plan is a
``VpuFftPlan`` with B1's clustered body on a tensor where it lies and fills
its tiles along the axis; the call's other passes run over planes. Here
the ``in_place_route`` fixture gives the module functions the card's 1-D
plans (``backend="vpu"``) and takes CPU tensors for the card's
(``ndim._card``), so the passes run B1's plain version
(``vpu_fft_strided_reference``). Every result is held
against the JAX package (CPU), against ``np.fft`` in f64 and against the
route over planes on the same plans, with ``tests/test_torch_ndim.py``'s
gates (rel-L2 over the whole array, k transformed axes): <= 1e-6*sqrt(k)
against ``np.fft`` and the planes, <= 2e-6*sqrt(k) against the JAX package.
The JAX package runs every axis over planes; the in-place route is the
port's own (a route that leaves the JAX package's, named here and in
``chip_smoke.py``'s route table).
"""

import numpy as np
import pytest
import torch

import fourier_tpu as jft

import fourier_tpu_torch as tft
from fourier_tpu_torch import Transform, trace
from fourier_tpu_torch import ndim as tnd
from fourier_tpu_torch.ops.cuda import stockham_vpu as sv
from fourier_tpu_torch.plan.vpu import VpuFftPlan

RNG_SEED = 0x1F2E
C64_NP, C64_JAX = 1e-6, 2e-6
FNS = {"fft2": (tft.fft2, jft.fft2, np.fft.fft2), "ifft2": (tft.ifft2, jft.ifft2, np.fft.ifft2),
       "fftn": (tft.fftn, jft.fftn, np.fft.fftn), "ifftn": (tft.ifftn, jft.ifftn, np.fft.ifftn)}
# (axes, shape, passes in place): the two trailing axes in both orders and
# two pairs of a 3-D tensor that leave the middle or the last axis out;
# transformed sizes 64 with 256 or 128 (B1's two-block clustered bodies; a
# tile has 256 columns at 64, 128 at 128 and 64 at 256). The axis of 128 of
# "first2" (a channels-last image) has 3 values after it and keeps the
# planes.
AXES = {"last2": ((-2, -1), (3, 64, 256), 2), "last2_swapped": ((-1, -2), (3, 64, 256), 2),
        "first2": ((0, 1), (64, 128, 3), 1), "outer": ((0, 2), (64, 3, 128), 2)}
NORMS = ("backward", "ortho", "forward")


def _rand(shape, rng):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _card_plans(sizes, dtype, device):
    return [tft.create_fft(int(n), dtype, backend="vpu", device=device, cache=False)
            for n in sizes]


@pytest.fixture
def in_place_route(monkeypatch):
    """The card's 1-D plans for the module functions, and CPU tensors taken
    for the card's (every other condition of the route kept)."""
    monkeypatch.setattr(tnd, "_axis_plans", _card_plans)
    monkeypatch.setattr(tnd, "_card", lambda x: True)


def _axis_counts(fn):
    """fn()'s result and the axis.* counts it made."""
    before = trace.counters().snapshot()
    out = fn()
    delta = trace.counters().delta(before)
    return out, {k: delta.get(k, 0) for k in ("axis.in_place", "axis.copied")}


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("axes_case", list(AXES))
@pytest.mark.parametrize("fn", list(FNS))
def test_in_place_matches_jax_numpy_and_planes(in_place_route, monkeypatch, fn, axes_case,
                                                norm):
    axes, shape, in_place = AXES[axes_case]
    port, jax_fn, np_fn = FNS[fn]
    x = _rand(shape, np.random.default_rng(RNG_SEED + len(fn) + shape[0]))
    got, counts = _axis_counts(lambda: port(x, axes=axes, norm=norm, device="cpu"))
    assert counts == {"axis.in_place": in_place, "axis.copied": 2 - in_place}
    want = np_fn(x.astype(np.complex128), axes=axes, norm=norm)
    assert got.dtype == np.complex64 and got.shape == x.shape
    assert _rel(got, want) <= C64_NP * np.sqrt(2)
    assert _rel(got, jax_fn(x, axes=axes, norm=norm)) <= C64_JAX * np.sqrt(2)
    monkeypatch.setattr(tnd, "_card", lambda x: False)
    planes, counts = _axis_counts(lambda: port(x, axes=axes, norm=norm, device="cpu"))
    assert counts == {"axis.in_place": 0, "axis.copied": 2}
    assert _rel(got, planes) <= C64_NP * np.sqrt(2)


@pytest.mark.parametrize("n,route", [(256, "in_place"), (1000, "copied"), (1728, "copied"),
                                     (1013, "copied")])
def test_route_by_size(in_place_route, n, route):
    """Sizes with B1's clustered body where it lies run in place; a size of
    B1_STAGE_FASTER (1000), a spilled height (1728) and a Bluestein size
    (1013) keep the planes for their axis, while the other axis (64, the
    last) runs in place."""
    x = _rand((n, 64), np.random.default_rng(RNG_SEED + n))
    got, counts = _axis_counts(lambda: tft.fft2(x, device="cpu"))
    assert counts == {"axis.in_place": 1 + (route == "in_place"),
                      "axis.copied": int(route == "copied")}
    assert _rel(got, np.fft.fft2(x.astype(np.complex128))) <= C64_NP * np.sqrt(2)
    assert _rel(got, jft.fft2(x)) <= C64_JAX * np.sqrt(2)


def test_in_place_route_table():
    """Which passes take the in-place route (the port's own; the JAX package
    runs planes on every axis): complex64 on a CUDA device, not recording a
    gradient, the axis plan a VpuFftPlan on the tensor's device with B1's
    body where it lies, filling its tiles. Off the card, and for
    complex128, other plans or sizes, the planes."""
    vpu = {n: VpuFftPlan.create(n, device="cpu") for n in (64, 4096, 1000, 1728)}
    assert [p.strided for p in vpu.values()] == [True, True, False, False]
    for n in (64, 128, 2048, 2160, 4096):
        assert sv.fft_pair_strided_geometry(n) is not None, n
    x = torch.zeros(64, 4096, dtype=torch.complex64)
    plans = [vpu[64], vpu[4096]]
    assert not tnd._card(x)
    assert tnd._in_place_passes(x, (0, 1), plans) == [False, False]  # a CPU tensor
    assert tnd._strided_passes((64, 4096), x.device, (0, 1), plans) == [True, True]
    assert tnd._in_place_passes(x, (), []) == []
    meta = torch.empty(64, 4096, dtype=torch.complex64, device="meta")
    assert not tnd._card(meta)
    assert tnd._in_place_passes(meta, (0, 1), plans) == [False, False]  # not a CUDA device
    assert tnd._strided_passes((64, 4096), meta.device, (0, 1), plans) == [False, False]
    stock = tft.create_fft(64, torch.complex64, backend="stockham", device="cpu", cache=False)
    dd = tft.create_fft(64, torch.complex128, backend="dd", device="cpu", cache=False)
    assert not isinstance(stock, VpuFftPlan) and not isinstance(dd, VpuFftPlan)
    assert tnd._strided_passes((64, 64), x.device, (0, 1), [stock, vpu[64]]) == [False, True]


@pytest.mark.parametrize("n", [64, 512, 4096])
def test_in_place_pass_fills_its_tiles(n):
    """A pass runs in place along the last axis, or along one with at least
    half a tile's columns after it; fewer (the channels of an (H, W, 3)
    image) would leave most of every tile idle, so that pass keeps the
    planes."""
    plan = VpuFftPlan.create(n, device="cpu")
    cols = sv.fft_pair_strided_geometry(n).cols
    half = cols // 2
    assert [plan.fills_strided(k) for k in (1, 2, half - 1, half, cols - 1, cols, cols + 1,
                                            3 * cols)] == [
        True, False, False, True, True, True, True, True]
    assert not VpuFftPlan.create(1000, device="cpu").fills_strided(1)
    cpu = torch.device("cpu")
    assert tnd._strided_passes((5, n, half - 1), cpu, (1, -1), [plan, plan]) == [False, True]
    assert tnd._strided_passes((5, n, half), cpu, (-2,), [plan]) == [True]


def test_nd_plan_and_non_contiguous_input(in_place_route):
    """An NdFftPlan of the card's plans runs in place too; a non-contiguous
    input is made contiguous once (a layout.to_front span), the caller's
    tensor is never written, and the result is a new contiguous tensor."""
    rng = np.random.default_rng(RNG_SEED)
    base = torch.as_tensor(_rand((256, 5, 64), rng))
    x = base.permute(1, 2, 0)  # (5, 64, 256), not contiguous
    keep = x.clone()
    plan = tnd.NdFftPlan((64, 256), backend="vpu", device="cpu")
    for mode in Transform:
        got, counts = _axis_counts(lambda: plan.transform(x, mode))
        assert counts == {"axis.in_place": 2, "axis.copied": 0}, mode
        assert got.is_contiguous() and got.data_ptr() != base.data_ptr()
        xx = keep.numpy().astype(np.complex128)
        n = 64 * 256
        want = (np.fft.fft2(xx) if mode.is_forward else np.fft.ifft2(xx) * n) * (
            mode.scale(n) or 1.0)
        assert _rel(got, want) <= C64_NP * np.sqrt(2), mode
        assert torch.equal(x, keep)
    got = tft.ifft2(x, norm="forward")
    assert _rel(got, np.fft.ifft2(keep.numpy().astype(np.complex128), norm="forward")) <= (
        C64_NP * np.sqrt(2))
    assert torch.equal(x, keep)


@pytest.mark.parametrize("fn", list(FNS))
def test_in_place_leaves_input_and_other_images(in_place_route, fn):
    """The input tensor is left as it was; a NaN in one image of a batch
    leaves every other image finite (each image's passes read only its own
    values)."""
    port = FNS[fn][0]
    rng = np.random.default_rng(RNG_SEED + 7)
    x = torch.as_tensor(_rand((4, 64, 256), rng))
    x[2, 5, 7] = complex(float("nan"), 0.0)
    keep = x.clone()
    got = port(x, axes=(-2, -1))
    assert torch.equal(torch.isnan(x), torch.isnan(keep))
    assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(keep))
    finite = torch.isfinite(got).reshape(4, -1).all(dim=1)
    assert finite.tolist() == [True, True, False, True]
    clean = np.delete(keep.numpy(), 2, axis=0).astype(np.complex128)
    want = FNS[fn][2](clean, axes=(-2, -1))
    assert _rel(np.delete(got.numpy(), 2, axis=0), want) <= C64_NP * np.sqrt(2)


def test_strided_operator_and_fake():
    """The pass is the registered operator fourier_tpu_torch::vpu_fft_strided,
    which runs only on the card (no CPU kernel: the plain version stays
    outside it), mutates its output alone, and whose fake returns nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    assert "vpu_fft_strided" in dir(torch.ops.fourier_tpu_torch)
    plan = VpuFftPlan.create(64, device="cpu")
    x = torch.randn(3, 64, 5, dtype=torch.complex64)
    y = torch.empty_like(x)
    for args in ((y, x), (x, None)):
        with pytest.raises(NotImplementedError):
            sv._vpu_fft_strided_op(*args, 1, 64, True, None, plan.pair_fwd)
        with FakeTensorMode(allow_non_fake_inputs=True):
            assert sv._vpu_fft_strided_op(*args, 1, 64, True, None, plan.pair_fwd) is None
    schema = torch.ops.fourier_tpu_torch.vpu_fft_strided.default._schema
    assert [a.name for a in schema.arguments if a.alias_info and a.alias_info.is_write] == ["y"]


def test_gradient_keeps_the_planes(in_place_route):
    """A tensor that records a gradient takes the planes (whose calls carry
    the VJP), and its gradient is the adjoint's; without grad mode the same
    tensor runs in place."""
    rng = np.random.default_rng(RNG_SEED + 3)
    x = torch.as_tensor(_rand((2, 64, 256), rng)).requires_grad_(True)
    y, counts = _axis_counts(lambda: tft.fft2(x))
    assert counts == {"axis.in_place": 0, "axis.copied": 2}
    g = torch.as_tensor(_rand((2, 64, 256), rng))
    (grad,) = torch.autograd.grad(y, x, g)
    want = np.fft.ifft2(g.numpy().astype(np.complex128)) * (64 * 256)
    assert _rel(grad.numpy(), want) <= C64_NP * np.sqrt(2)
    with torch.no_grad():
        _, counts = _axis_counts(lambda: tft.fft2(x))
    assert counts == {"axis.in_place": 2, "axis.copied": 0}
