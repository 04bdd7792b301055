"""fourier_tpu_torch.trace: spans at the layer boundaries and the one
registry of counts, on the CPU. The exchange's counts on two gloo ranks are
in ``test_torch_sharded.py`` (``test_exchange_legs_and_bytes_are_counted``)."""

import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fourier_tpu_torch as ftt
from fourier_tpu_torch import trace
from fourier_tpu_torch.ops.cuda import build
from fourier_tpu_torch.plan import MxuFftPlan, planner


def _names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()]


def test_counters_snapshot_and_delta():
    c = trace.Counters()
    assert c["a"] == 0 and c.snapshot() == {}
    c.count("a")
    c.count("b", 5)
    assert c.snapshot() == {"a": 1, "b": 5}
    s = c.snapshot()
    c.count("a", 2)
    c.count("c")
    assert c.delta(s) == {"a": 2, "c": 1}
    assert c.delta(s, s) == {} and c["a"] == 3
    s["a"] = 0  # a snapshot is a copy
    assert c["a"] == 3


def test_counters_lose_no_count_across_threads():
    c = trace.Counters()

    def work():
        for _ in range(2000):
            c.count("n")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert c["n"] == 16000


def test_lifecycle_spans_nest_with_parent_and_call_id():
    first = len(trace.spans())
    calls = trace.counters()["calls"]
    with trace.call("outer"):
        with trace.call("inner"):  # a nested entry is no new call
            with trace.span("lib.load", lib="x"):
                with trace.span("lib.build", target="libx.so"):
                    pass
    with trace.span("plan.build", size=3):
        pass
    with trace.call("again"):
        with trace.span("plan.build", size=4):
            pass
    build_, load, plan, again = trace.spans()[first:first + 4]
    assert trace.counters()["calls"] == calls + 2
    assert (load.name, build_.name, plan.name) == ("lib.load", "lib.build", "plan.build")
    assert build_.parent == load.id and load.parent is None and plan.parent is None
    assert build_.call == load.call is not None and plan.call is None
    assert again.call not in (None, load.call)
    assert load.start_ns <= build_.start_ns <= build_.end_ns <= load.end_ns
    assert load.attrs == {"lib": "x"} and build_.attrs == {"target": "libx.so"}


def test_a_full_store_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "STORE_MAX", len(trace.spans()) + 1)
    dropped = trace.counters()["spans.dropped"]
    for _ in range(3):
        with trace.span("plan.build"):
            pass
    assert len(trace.spans()) == trace.STORE_MAX
    assert trace.counters()["spans.dropped"] == dropped + 2


class _Counting:
    """torch.profiler.record_function's stand-in: counts its entries."""

    entered = 0

    def __init__(self, name, args=None):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_profiler_off_enters_no_record_function(monkeypatch):
    """The hot path (a plan's call, fft2 with its passes and layout work, a
    launch after the first) costs flag tests only while no profiler runs."""
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _Counting.entered = 0
    plan = ftt.create_fft_f32(16, device="cpu")
    x = torch.randn(3, 8, 16, dtype=torch.complex64)
    calls = trace.counters()["calls"]
    plan.transform_planar_bm(torch.randn(16, 4), torch.randn(16, 4))
    plan.fft(x[0])
    ftt.ifft2(ftt.fft2(x))
    assert _Counting.entered == 0
    assert trace.counters()["calls"] == calls + 4
    assert trace.span("axis", axis=1) is trace.span("layout.join")
    assert trace.call("fft2") is trace.call("transform")


def test_profiler_on_records_the_spans():
    x = torch.randn(2, 8, 16, dtype=torch.complex64)
    ftt.ifft2(x)  # plans built outside the window
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ftt.ifft2(x)
    names = [n for n in _names(prof) if n.startswith(("call", "axis", "layout"))]
    assert names == ["call[entry=ifft2]",
                     "axis[axis=1]", "layout.to_front", "call.nested[entry=transform_planar_bm]",
                     "axis[axis=2]", "layout.to_front", "call.nested[entry=transform_planar_bm]",
                     "layout.scale", "layout.join"]
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    outer, join = ev["call[entry=ifft2]"], ev["layout.join"]
    assert outer.start_ns() <= join.start_ns()
    assert join.start_ns() + join.duration_ns() <= outer.start_ns() + outer.duration_ns()


def test_plan_cache_miss_builds_and_hit_counts():
    planner.clear_plan_cache()
    first = len(trace.spans())
    before = trace.counters().snapshot()
    planner.create_fft(24, device="cpu")
    planner.create_fft(24, device="cpu")
    assert trace.counters().delta(before) == {"plan.cache_miss": 1, "plan.cache_hit": 1}
    builds = [s for s in trace.spans()[first:] if s.name == "plan.build"]
    assert [(s.attrs["size"], s.attrs["backend"]) for s in builds] == [(24, "stockham")]
    assert builds[0].end_ns > builds[0].start_ns


def test_plan_build_names_the_plan_it_built():
    planner.clear_plan_cache()
    first = len(trace.spans())
    planner.create_fft(722, backend="vpu", device="cpu")
    planner.create_fft(1013, backend="vpu", device="cpu")
    planner.create_fft(24, device="cpu")
    builds = [s.attrs for s in trace.spans()[first:] if s.name == "plan.build"]
    assert [(a["size"], a["backend"], a["plan"]) for a in builds] == [
        (722, "vpu", "VpuBluesteinPlan"), (1013, "vpu", "VpuBluesteinPlan"),
        (24, "stockham", "AutosortPlan")]


def test_a_dense_product_counts_its_call_and_operations(monkeypatch):
    """One direct product of 3 transforms of 722 points: one product,
    8·3·722² operations (four real products of (3×722)·(722×722)), and no
    profiler span while none runs."""
    plan = planner.create_fft(722, backend="mxu", device="cpu", cache=False)
    assert isinstance(plan, MxuFftPlan) and plan.single_phase
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _Counting.entered = 0
    before = trace.counters().snapshot()
    plan.transform_planar_bm(torch.randn(722, 3), torch.randn(722, 3))
    assert trace.counters().delta(before) == {
        "calls": 1, "dft.products": 1, "dft.product_flops": 8 * 3 * 722 ** 2}
    assert _Counting.entered == 0


# Two-phase products at n = 1000 = 25·40 (n1, n2), B = 3: D_40 on each of
# the 25 columns, then phase B on each of the 40 rows, packed 5 at a time
# in "xla_packed" ((8, 125, 125) blocks).
@pytest.mark.parametrize("impl,flops", [
    ("xla", 8 * 3 * (40 * 40 * 25 + 40 * 25 * 25)),
    ("xla_packed", 8 * 3 * (40 * 40 * 25 + 8 * 125 * 125)),
    ("pallas", 8 * 3 * (40 * 40 * 25 + 40 * 25 * 25)),
])
def test_two_phase_products_count_both_phases(impl, flops):
    plan = MxuFftPlan.create(1000, impl=impl, device="cpu")
    assert (plan.n1, plan.n2) == (25, 40)
    before = trace.counters().snapshot()
    plan.transform_planar(torch.randn(3, 1000), torch.randn(3, 1000))
    counts = trace.counters().delta(before)
    assert counts["dft.products"] == 1 and counts["dft.product_flops"] == flops


def test_the_dense_product_span_is_recorded():
    plan = planner.create_fft(439, backend="mxu", device="cpu", cache=False)
    re, im = torch.randn(439, 2), torch.randn(439, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan.transform_planar_bm(re, im)
    names = _names(prof)
    assert "dft.product[n=439,phases=1]" in names
    assert "call[entry=transform_planar_bm]" in names


def _fake_library(name, rc=0):
    fns = {"fourier_fake_launch": lambda *args: rc,
           "fourier_cuda_error_string": lambda rc: b"fake failure"}
    return types.SimpleNamespace(_name=name, **fns)


def test_launch_counts_by_operator_and_spans_the_first():
    lib = _fake_library("libfake-for-trace.so")
    op = "fourier_tpu_torch::fake_for_trace"
    first = len(trace.spans())
    before = trace.counters().snapshot()
    for _ in range(3):
        build.launch(op, lib, "fourier_fake_launch", "the fake kernel", 1, 2)
    assert trace.counters().delta(before) == {f"launches.{op}": 3}
    firsts = [s for s in trace.spans()[first:] if s.name == "launch.first"]
    assert [s.attrs for s in firsts] == [{"op": op, "entry": "fourier_fake_launch"}]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build.launch(op, lib, "fourier_fake_launch", "the fake kernel")
    assert f"launch[op={op}]" in _names(prof)


def test_a_failed_launch_is_not_counted():
    lib = _fake_library("libfake-failing.so", rc=2)
    op = "fourier_tpu_torch::fake_failing"
    with pytest.raises(RuntimeError, match="fake failure"):
        build.launch(op, lib, "fourier_fake_launch", "the failing kernel")
    assert trace.counters()[f"launches.{op}"] == 0


def test_an_exception_closes_the_call():
    calls = trace.counters()["calls"]
    plan = ftt.create_fft_f32(16, device="cpu")
    with pytest.raises(ValueError):
        plan.transform_planar_bm(torch.randn(15, 2), torch.randn(15, 2))
    plan.transform_planar_bm(torch.randn(16, 2), torch.randn(16, 2))
    assert trace.counters()["calls"] == calls + 2  # the second is outermost again
