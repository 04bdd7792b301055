"""The program's spans and counts in the benchmark, on synthetic records:
``benchmark.spans`` (device time by launching span, the host's own time a
call), and the readers ``launches_per_call`` and ``load_s``."""

import sys

import pytest

from benchmark import spans
from benchmark import trace as tr
from benchmark.harness import Cell, Run
from benchmark.tests.conftest import REPO
from fourier_tpu_torch import trace

WINDOW = {"name": "bench.window", "start": 0, "end": 1000, "kind": "user_annotation",
          "device": False, "corr": 0, "tid": 1}


def host(name, start, end, corr=0, tid=1):
    return {"name": name, "start": start, "end": end, "kind": "", "device": False,
            "corr": corr, "tid": tid}


def kernel(name, start, end, corr):
    return {"name": name, "start": start, "end": end, "kind": "kernel", "device": True,
            "corr": corr, "tid": 0}


def _events():
    """One call: a layout copy whose kernel runs while the host is already
    in the plan's launch, then the launch's own kernel."""
    return [WINDOW,
            host("call[entry=fft2]", 100, 300),
            host("axis[axis=1]", 110, 290),
            host("layout.to_front", 120, 140),
            host("cudaLaunchKernel", 125, 135, corr=7),
            host("call.nested[entry=transform_planar_bm]", 150, 280),
            host("launch[op=fourier_tpu_torch::vpu_fft]", 160, 270),
            host("cudaLaunchKernelExC", 170, 260, corr=8),  # waits on a full queue
            host("cudaLaunchKernel", 400, 410, corr=9),  # outside any span
            kernel("void at::native::elementwise_kernel<copy>", 150, 190, corr=7),
            kernel("fft_pair_c64<4, 1024>", 190, 290, corr=8),
            kernel("void at::native::vectorized_elementwise_kernel<mul>", 420, 430, corr=9)]


def test_device_time_goes_to_the_launching_span_not_the_overlapping_one():
    out = spans.summarize(_events(), calls=1)
    # the copy ran 150-190, inside the launch span's interval, but was
    # launched in layout.to_front: correlation, not overlap, decides.
    assert out["span_device_s"] == pytest.approx({"layout.to_front": 40e-9,
                                                  "launch": 100e-9, "(none)": 10e-9})
    assert out["span_path_device_s"][
        "call[entry=fft2]/axis[axis=1]/layout.to_front"] == pytest.approx(40e-9)
    assert out["layout_share"] == pytest.approx(100 * 40 / 150)
    assert out["span_count"] == {"call": 1, "axis": 1, "layout.to_front": 1,
                                 "call.nested": 1, "launch": 1}


def test_host_time_a_call_leaves_out_the_runtime_calls():
    events = _events() + [host("cudaStreamSynchronize", 200, 250, tid=2)]  # another thread
    out = spans.summarize(events, calls=1)
    # 200 ns of call less 10 + 90 ns in cudaLaunchKernel(ExC)
    assert out["host_self_s"] == pytest.approx(100e-9)
    assert out["host_us"] == pytest.approx(0.1)
    overlapping = _events() + [host("cudaGetDevice", 180, 200)]  # inside the ExC one
    assert spans.summarize(overlapping, calls=2)["host_us"] == pytest.approx(0.05)


def test_no_call_span_no_host_time():
    events = [e for e in _events() if not e["name"].startswith("call")]
    out = spans.summarize(events, calls=1)
    assert out["host_us"] is None and out["host_self_s"] == 0


def test_the_accepted_device_readings_ignore_the_added_fields():
    """copy_share, idle_share and call_roofline's busy time read the same
    from the events with and without the correlation ids and threads."""
    events = _events()
    bare = [{k: v for k, v in e.items() if k not in ("corr", "tid")} for e in events]
    a, b = tr.Trace(events, 1).summary(), tr.Trace(bare, 1).summary()
    assert a == b
    m = tr.merged([a])
    assert tr.class_share(m, "torch") == pytest.approx(100 * 50 / 150)
    assert tr.idle_share(m) == pytest.approx(100 * (1 - 150 / 1000))
    assert a["busy_s"] == pytest.approx(150e-9)


def _run():
    cell = Cell("c64-1d.n4096-b16384", REPO)
    return Run(cell=cell.name, traffic=cell.traffic, calls=10, trace=None, counters={})


def test_launches_per_call_divides_by_the_counted_calls(monkeypatch):
    from benchmark.metrics import launches_per_call

    c = trace.Counters()
    monkeypatch.setattr(trace, "_COUNTERS", c)
    assert launches_per_call.read(_run()) is None  # no call counted
    c.count("calls", 4)
    c.count("launches.fourier_tpu_torch::vpu_fft", 8)
    c.count("launches.fourier_tpu_torch::vpu_bluestein", 2)
    c.count("launches.mxu_fft_two_phase.mma", 5)  # a body's share of its operator's
    c.count("plan.cache_hit", 7)
    assert launches_per_call.read(_run()) == 2.5


def test_load_s_is_the_union_of_the_load_spans(monkeypatch):
    from benchmark.metrics import load_s

    rec = [trace.Span(1, "lib.build", 10, 40, 2, None, {}),
           trace.Span(2, "lib.load", 0, 50, None, None, {}),
           trace.Span(3, "launch.first", 45, 70, None, 1, {}),
           trace.Span(4, "plan.build", 100, 900, None, None, {}),
           trace.Span(5, "launch.first", 1000, 1030, None, 2, {})]
    monkeypatch.setattr(trace, "spans", lambda: rec)
    assert load_s.read(_run()) == pytest.approx(100e-9)
    monkeypatch.setattr(trace, "spans", lambda: rec[3:4])
    assert load_s.read(_run()) is None


@pytest.mark.parametrize("metric", ["load_s", "launches_per_call"])
def test_a_port_without_the_registry_reads_nothing(monkeypatch, metric):
    """The parent's port has no fourier_tpu_torch.trace: the reader returns
    None and does not raise."""
    import importlib

    reader = importlib.import_module(f"benchmark.metrics.{metric}")
    monkeypatch.setitem(sys.modules, "fourier_tpu_torch.trace", None)
    monkeypatch.delattr(sys.modules["fourier_tpu_torch"], "trace")
    assert reader.read(_run()) is None
