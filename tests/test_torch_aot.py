"""Ahead-of-time export (``fourier_tpu_torch.plan.aot``) against the JAX
package's (``fourier_tpu.plan.aot``) and the registered kernel operators.

Counterparts of ``tests/test_serialize.py``'s three export tests on the
same numpy inputs: ``export_compiled`` parity at 64 (Stockham autosort) and
73 (Bluestein) against the JAX package's artifact (rel-L2 <= 1e-6, two
roundings of one transform) and np.fft, bitwise against the port's own
plan; a symbolic batch, now also at the three plans whose batch product
went through numpy (``VpuFftPlan(64)``, ``MxuFftPlan(100)``,
``FourStepLocalPlan(65536)``) and at ``BluesteinPlan(73)``; the raw
``torch.export`` round trip. Beyond them: complex128 against the JAX
package's plan (1e-12); no planning and no trigonometry during a load and
a call; no custom operator in a CPU plan's graph; the twelve registered
operators and their fake implementations' shapes against the plain
versions' results; and, on a card, a card plan's graph calls the kernel
operator and the loaded artifact launches the kernel.
"""

import io

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import fourier_tpu as jft
from fourier_tpu import Transform as JTransform

import fourier_tpu_torch as tft
from fourier_tpu_torch import Transform, trace
from fourier_tpu_torch.ops.cuda import bailey as bk
from fourier_tpu_torch.ops.cuda import dd_combine as dc
from fourier_tpu_torch.ops.cuda import stockham_vpu as sv
from fourier_tpu_torch.ops.cuda import stockham_vpu_dd as dv
from fourier_tpu_torch.plan import (FourStepLocalPlan, MxuFftPlan, VpuFftPlan,
                                    export_compiled, load_compiled)
from fourier_tpu_torch.plan import aot

RNG_SEED = 0x57A71C


def launches(op: str) -> int:
    """Launches of the operator ``fourier_tpu_torch::<op>`` counted so far."""
    return trace.counters()[f"launches.fourier_tpu_torch::{op}"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


def _rand(shape, rng, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("n", [64, 73])
def test_export_compiled_parity(tmp_path, n):
    """The loaded artifact against np.fft, the JAX package's artifact and,
    bitwise, the port's plan."""
    rng = np.random.default_rng(RNG_SEED + n)
    plan = tft.create_fft(n, np.complex64, device="cpu", cache=False)
    path = str(tmp_path / "compiled.npz")
    export_compiled(plan, path, batch_shape=(4,))
    comp = load_compiled(path)
    assert comp.size == n and len(comp) == n
    assert comp.real_dtype == torch.float32
    assert comp.meta["device"] == "cpu" and comp.meta["plan_class"] == type(plan).__name__
    jpath = str(tmp_path / "jcompiled.npz")
    jft.export_compiled(jft.create_fft(n, np.complex64, cache=False), jpath, batch_shape=(4,))
    jcomp = jft.load_compiled(jpath)
    x = _rand((4, n), rng)
    for mode, ref in ((Transform.FFT, np.fft.fft), (Transform.IFFT, np.fft.ifft)):
        ore, oim = comp.transform_planar(np.real(x), np.imag(x), mode)
        got = ore + 1j * oim
        np.testing.assert_allclose(got, ref(x, axis=-1), atol=1e-4)
        pre, pim = plan.transform_planar(torch.as_tensor(np.real(x)),
                                         torch.as_tensor(np.imag(x)), mode)
        np.testing.assert_array_equal(ore, pre.numpy())
        np.testing.assert_array_equal(oim, pim.numpy())
        jre, jim = jcomp.transform_planar(np.real(x), np.imag(x), JTransform[mode.name])
        assert _rel(got, np.asarray(jre) + 1j * np.asarray(jim)) <= 1e-6
        assert _rel(got, ref(x.astype(np.complex128), axis=-1)) <= 1e-6
    with pytest.raises(ValueError, match="not exported"):
        comp.transform_planar(np.real(x), np.imag(x), Transform.UNSCALED_IFFT)


@pytest.mark.parametrize("n", [64, 73])
def test_export_compiled_c128(tmp_path, n):
    """complex128 (the card's dd route, built on the CPU) against the JAX
    package's plan and np.fft."""
    rng = np.random.default_rng(RNG_SEED + n)
    plan = tft.create_fft(n, np.complex128, backend="dd", device="cpu", cache=False)
    export_compiled(plan, str(tmp_path / "c.npz"), batch_shape=(3,), modes=(Transform.FFT,))
    comp = load_compiled(str(tmp_path / "c.npz"))
    assert comp.real_dtype == torch.float64
    x = _rand((3, n), rng, np.complex128)
    ore, oim = comp.fft_planar(np.real(x), np.imag(x))
    got = ore + 1j * oim
    jre, jim = jft.create_fft(n, np.complex128, cache=False).fft_planar(np.real(x), np.imag(x))
    assert _rel(got, np.asarray(jre) + 1j * np.asarray(jim)) <= 1e-12
    assert _rel(got, np.fft.fft(x, axis=-1)) <= 1e-12


def _symbolic_plan(kind):
    if kind == "vpu64":
        return VpuFftPlan.create(64, device="cpu")
    if kind == "mxu100":
        return MxuFftPlan.create(100, device="cpu")
    if kind == "fourstep65536":
        plan = tft.create_fft(65536, backend="vpu", device="cpu", cache=False)
        assert isinstance(plan, FourStepLocalPlan)
        return plan
    return tft.create_fft(73, backend="stockham", device="cpu", cache=False)


@pytest.mark.parametrize("kind", ["vpu64", "mxu100", "fourstep65536", "bluestein73"])
def test_export_compiled_symbolic_batch(tmp_path, kind):
    """One artifact serves any batch: the three plans whose batch product
    went through numpy (a guard that fixed the symbolic batch), and the
    Bluestein one."""
    plan = _symbolic_plan(kind)
    n = plan.size
    path = str(tmp_path / "poly.npz")
    export_compiled(plan, path, batch_shape=("b",), modes=(Transform.FFT,))
    comp = load_compiled(path)
    assert comp.meta["batch_shape"] == ["b"]
    rng = np.random.default_rng(RNG_SEED)
    for batch in (1, 3, 7):
        x = _rand((batch, n), rng)
        re, im = torch.as_tensor(np.real(x).copy()), torch.as_tensor(np.imag(x).copy())
        ore, oim = comp.fft_planar(re, im)
        got = ore.numpy() + 1j * oim.numpy()
        assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=-1)) <= 1e-6
        pre, pim = plan.fft_planar(re, im)
        assert torch.equal(ore, pre) and torch.equal(oim, pim)


def test_aot_export_roundtrip():
    """torch.export of the execute call, saved to bytes, loaded, run."""
    plan = tft.create_fft(64, np.complex64, device="cpu", cache=False)

    class Run(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.plan = plan

        def forward(self, re, im):
            return self.plan.transform_planar(re, im, Transform.FFT)

    re, im = torch.zeros(4, 64), torch.zeros(4, 64)
    program = torch.export.export(Run(), (re, im), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    assert len(buf.getvalue()) > 0
    reloaded = torch.export.load(io.BytesIO(buf.getvalue())).module()
    x = _rand((4, 64), np.random.default_rng(RNG_SEED))
    ore, oim = reloaded(torch.as_tensor(np.real(x).copy()), torch.as_tensor(np.imag(x).copy()))
    np.testing.assert_allclose(ore.numpy() + 1j * oim.numpy(), np.fft.fft(x, axis=-1),
                               atol=1e-4)


def test_load_and_call_plan_nothing(tmp_path, monkeypatch):
    """load_compiled and the call build no plan, run no trigonometry and no
    plan-time FFT: every plan constructor and generator raises meanwhile."""
    import sys

    from fourier_tpu_torch.plan import serialize

    plan = tft.create_fft(73, backend="stockham", device="cpu", cache=False)
    path = str(tmp_path / "c.npz")
    export_compiled(plan, path, batch_shape=(2,))
    x = _rand((2, 73), np.random.default_rng(RNG_SEED))
    want = plan.fft_planar(torch.as_tensor(np.real(x).copy()), torch.as_tensor(np.imag(x).copy()))

    def boom(*_a, **_k):
        raise AssertionError("planning during a load or call")

    with monkeypatch.context() as m:
        for codec in serialize._CODECS.values():
            m.setattr(codec.cls, "__init__", boom)
        for name in ("cos", "sin", "exp"):
            m.setattr(np, name, boom)
        m.setattr(np.fft, "fft", boom)
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("fourier_tpu_torch"):
                for name in ("stage_twiddles", "half_twiddle", "create_fft"):
                    if hasattr(mod, name):
                        m.setattr(mod, name, boom)
        with pytest.raises(AssertionError):  # the poison works
            tft.plan.bluestein.half_twiddle(np.zeros(1), 3)
        comp = load_compiled(path)
        got = comp.fft_planar(torch.as_tensor(np.real(x).copy()), torch.as_tensor(np.imag(x).copy()))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cpu_graph_has_no_custom_op(tmp_path):
    """A CPU plan exports its plain PyTorch version: no kernel operator in
    its graph, before or after the load."""
    plan = tft.create_fft(192, backend="vpu", device="cpu", cache=False)
    assert isinstance(plan, VpuFftPlan)
    export_compiled(plan, str(tmp_path / "c.npz"), batch_shape=(2,), modes=(Transform.FFT,))
    comp = load_compiled(str(tmp_path / "c.npz"))
    assert comp.meta["kernels"] == {"fft": []}
    assert aot.graph_ops(comp._programs["fft"]) == []


def test_jax_artifact_is_refused(tmp_path):
    jft.export_compiled(jft.create_fft(64, np.complex64, cache=False),
                        str(tmp_path / "j.npz"), batch_shape=(1,), modes=(JTransform.FFT,))
    with pytest.raises(ValueError, match="JAX package"):
        load_compiled(str(tmp_path / "j.npz"))


OPS = ("vpu_fft", "vpu_bluestein", "four_step_row", "rfft_pack", "irfft_unpack",
       "rfft_odd_pack", "irfft_odd_unpack", "vpu_dd_fft", "vpu_dd_bluestein",
       "dd_split_combine", "mxu_fft_single", "mxu_fft_two_phase")


def _op_cases():
    """(operator, its arguments but the planes, planes, plain result) of
    each kernel at a small shape, the tables from the plans."""
    rng = np.random.default_rng(RNG_SEED)
    planes = lambda shape, dt=torch.float32: tuple(
        torch.as_tensor(rng.standard_normal(shape)).to(dt) for _ in range(2))
    cases = []
    p64 = VpuFftPlan.create(64, device="cpu")
    re, im = planes((64, 5))
    cases.append((sv._vpu_fft_op, (re, im, 64, True, None, p64.kernel_fwd, p64.pair_fwd),
                  p64.transform_planar_bm(re, im)))
    b2 = tft.VpuBluesteinPlan.create(73, device="cpu")
    st = b2.stages
    re, im = planes((73, 5))
    cases.append((sv._vpu_bluestein_op, (re, im, 73, st.size, None, st.kernel_fwd, st.kernel_inv,
                                         st.pair_fwd, st.pair_inv, *b2.chirps(True)),
                  b2.transform_planar_bm(re, im)))
    re3, im3 = planes((4, 64, 5))
    tw = torch.ones(2, 4, 64)
    cases.append((sv._four_step_row_op, (re3, im3, 64, 4, True, None, p64.kernel_fwd,
                                         p64.pair_fwd, tw[0], tw[1], tw[0], tw[1], True),
                  sv.vpu_fft_four_step_row_reference(re3, im3, 64, 4, p64.tables(True),
                                                     (tw[0], tw[1]), True, None)))
    r128 = tft.RfftPlan(128, backend="vpu", device="cpu")
    x = planes((128, 5))[0]
    spec = r128.rfft_planar_bm(x)
    cases.append((sv._rfft_pack_op, (x, 64, r128.inner.kernel_fwd, r128.inner.pair_fwd,
                                     r128.w), spec))
    cases.append((sv._irfft_unpack_op, (*spec, 64, r128.inner.kernel_inv, r128.inner.pair_inv,
                                        r128.w), r128.irfft_planar_bm(*spec)))
    x = planes((73, 5))[0]
    ospec = sv.vpu_rfft_odd_pack_batch_minor_reference(
        x, 73, st.size, (st.tables(True), st.tables(False)), b2.chirps(True))
    cases.append((sv._rfft_odd_pack_op, (x, 73, st.size, st.kernel_fwd, st.kernel_inv,
                                         st.pair_fwd, st.pair_inv, *b2.chirps(True)), ospec))
    cases.append((sv._irfft_odd_unpack_op, (*ospec, 73, st.size, st.kernel_fwd, st.kernel_inv,
                                            st.pair_fwd, st.pair_inv, *b2.chirps(False)),
                  sv.vpu_irfft_odd_unpack_batch_minor_reference(
                      *ospec, 73, st.size, (st.tables(True), st.tables(False)),
                      b2.chirps(False))))
    d64 = tft.VpuDdFftPlan.create(64, device="cpu")
    re, im = planes((64, 5), torch.float64)
    cases.append((dv._vpu_dd_fft_op, (re, im, 64, True, None, d64.kernel_fwd, d64.pair_fwd),
                  d64.transform_planar_bm(re, im)))
    b7 = tft.VpuDdBluesteinPlan.create(17, device="cpu")
    s7 = b7.stages
    re, im = planes((17, 5), torch.float64)
    cases.append((dv._vpu_dd_bluestein_op, (re, im, 17, s7.size, None, s7.pair_fwd,
                                            s7.pair_inv, *b7.chirps(True)),
                  b7.transform_planar_bm(re, im)))
    split = tft.create_fft(2187, torch.complex128, backend="dd", device="cpu", cache=False)
    re, im = planes((729, 3 * 5), torch.float64)
    cases.append((dc._dd_split_combine_op, (re, im, 2187, 3, True, None, split.tw_fwd),
                  dc.dd_split_combine_batch_minor(re, im, 2187, 3, True, None,
                                                  tables=split.tw_fwd)))
    m100 = MxuFftPlan.create(100, impl="pallas", device="cpu")
    re, im = planes((5, 100))
    (dre, dim), = m100.tables(True)
    cases.append((bk._mxu_fft_single_op, (re, im, dre, dim, None),
                  bk.mxu_fft_single(re, im, dre, dim)))
    m384 = MxuFftPlan.create(384, impl="pallas", device="cpu")
    re, im = planes((5, 384))
    tabs = [t for pair in m384.tables(True) for t in pair]
    cases.append((bk._mxu_fft_two_phase_op, (re, im, *tabs, None),
                  bk.mxu_fft_two_phase(re, im, *tabs)))
    return cases


def test_kernel_operators_and_fakes():
    """Every kernel launch is a registered operator of the namespace, which
    runs only on the card (no CPU kernel: the plain versions stay outside
    it), and whose fake implementation gives the plain result's shapes and
    dtypes."""
    registered = {name for name in dir(torch.ops.fourier_tpu_torch) if not name.startswith("_")}
    assert set(OPS) <= registered
    cases = _op_cases()
    assert [f"{op._namespace}::{op._name}" for op, _, _ in cases] == \
        [f"fourier_tpu_torch::{o}" for o in OPS]
    for op, args, want in cases:
        with pytest.raises(NotImplementedError):
            op(*args)  # CPU tensors: the operator has no CPU kernel
        with FakeTensorMode(allow_non_fake_inputs=True):
            got = op(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert [(tuple(g.shape), g.dtype) for g in got] == \
               [(tuple(w.shape), w.dtype) for w in want], op._name


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", [(4096, torch.complex64), (1013, torch.complex64),
                                     (1024, torch.complex128)])
def test_card_artifact_runs_the_kernel(tmp_path, cuda_device, n, dtype):
    """On the card the exported graph calls the kernel operator, and the
    loaded artifact launches the kernel, bitwise as the plan does."""
    plan = tft.create_fft(n, dtype, device=cuda_device, cache=False)
    export_compiled(plan, str(tmp_path / "c.npz"), batch_shape=("b",))
    comp = load_compiled(str(tmp_path / "c.npz"))
    op = {VpuFftPlan: "vpu_fft", tft.VpuBluesteinPlan: "vpu_bluestein",
          tft.VpuDdFftPlan: "vpu_dd_fft"}[type(plan)]
    assert comp.meta["kernels"]["fft"], comp.meta
    real = plan.real_dtype
    for b in (3, 64):
        re = torch.randn(b, n, dtype=real, device=cuda_device)
        im = torch.randn(b, n, dtype=real, device=cuda_device)
        before = launches(op)
        got = comp.fft_planar(re, im)
        assert launches(op) > before
        want = plan.fft_planar(re, im)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
