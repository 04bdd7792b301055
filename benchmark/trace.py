"""The profiler's record of one traced window, reduced to what the per-layer
readers need: device busy time, time by class of kernel, idle gaps named by
what the host was doing, and the largest device operations.

Times come from ``torch.profiler`` (CUPTI on the card). The window is the
benchmark's own ``bench.window`` span; device activity is clipped to it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"
TOP = 10


def kernel_class(name: str) -> str:
    """"nccl" (the exchange's transport), "torch" (PyTorch's own kernels:
    copies, transposes, elementwise passes, memcpy and memset), or "port"
    (everything else: the port's kernels and the libraries it calls)."""
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if "at::native" in name or "at_cuda_detail" in name or low.startswith(("memcpy", "memset")):
        return "torch"
    return "port"


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """Total length of the union of [start, end) intervals, and the gaps
    between its pieces."""
    total, gaps = 0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


class Trace:
    """One rank's traced window. Times in seconds."""

    def __init__(self, events, calls: int):
        self.calls = calls
        win = [e for e in events if e["name"] == WINDOW_SPAN and not e["device"]]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
        w0 = min(e["start"] for e in win)
        w1 = max(e["end"] for e in win)
        self.window_s = (w1 - w0) * 1e-9
        dev, host = [], []
        for e in events:
            if e["device"] and ("annotation" in e["kind"] or e["name"] == WINDOW_SPAN):
                continue  # a host span's mirror on the device's timeline
            if e["device"]:
                s, t = max(e["start"], w0), min(e["end"], w1)
                if t > s:
                    dev.append((s, t, e["name"]))
            elif e["name"] != WINDOW_SPAN:
                host.append((e["start"], e["end"], e["name"]))
        self.device_ops = len(dev)
        busy, gaps = _union([(s, t) for s, t, _ in dev])
        if dev:
            first = min(s for s, _, _ in dev)
            last = max(t for _, t, _ in dev)
            gaps = [(w0, first)] + gaps + [(last, w1)]
        else:
            gaps = [(w0, w1)]
        self.busy_s = busy * 1e-9
        by_name: Dict[str, float] = defaultdict(float)
        by_class: Dict[str, float] = defaultdict(float)
        count_class: Dict[str, int] = defaultdict(int)
        for s, t, name in dev:
            by_name[name] += (t - s) * 1e-9
            by_class[kernel_class(name)] += (t - s) * 1e-9
            count_class[kernel_class(name)] += 1
        self.seconds_by_class = dict(by_class)
        self.count_by_class = dict(count_class)
        self.top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        self.top_gaps = self._name_gaps(host, gaps)

    @staticmethod
    def _name_gaps(host, gaps) -> List[Tuple[str, float]]:
        """Idle seconds summed by the innermost host event running at each
        gap's midpoint (the one that started last among those covering it)."""
        host.sort()
        starts = [h[0] for h in host]
        out: Dict[str, float] = defaultdict(float)
        for s, t in gaps:
            if t <= s:
                continue
            mid = (s + t) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = "host: no traced op"
            for j in range(i, max(i - 64, -1), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            out[name] += (t - s) * 1e-9
        return sorted(out.items(), key=lambda kv: -kv[1])[:TOP]

    def summary(self) -> dict:
        """What a rank sends to rank 0."""
        return {"calls": self.calls, "window_s": self.window_s, "busy_s": self.busy_s,
                "device_ops": self.device_ops, "seconds_by_class": self.seconds_by_class,
                "count_by_class": self.count_by_class, "top_ops": self.top_ops,
                "top_gaps": self.top_gaps}


def _kind(e) -> str:
    """The activity's kind ("gpu_user_annotation", "kernel", ...), where the
    installed torch tells it; "annotation" for a user span where it only
    tells that; else ""."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    if getattr(e, "is_user_annotation", lambda: False)():
        return "annotation"
    return ""


def events_of(prof) -> List[dict]:
    """The raw events of a finished ``torch.profiler.profile``: name, start
    and end in ns, the activity's kind, and whether it was on the device."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append({"name": e.name(), "start": start, "end": start + e.duration_ns(),
                    "kind": _kind(e), "device": e.device_type().name != "CPU"})
    return out


def profile_activities(device_type: str):
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def merged(summaries: List[dict]) -> Optional[dict]:
    """Rank 0's summary, with busy and window averaged over the ranks."""
    if not summaries:
        return None
    first = dict(summaries[0])
    first["busy_s_mean"] = sum(s["busy_s"] for s in summaries) / len(summaries)
    first["window_s_mean"] = sum(s["window_s"] for s in summaries) / len(summaries)
    first["ranks"] = summaries
    return first


def idle_share(summary: Optional[dict]) -> Optional[float]:
    """Percent of the traced window with nothing on the device, averaged
    over the ranks; None without device activity."""
    if summary is None or summary["busy_s_mean"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s_mean"] / summary["window_s_mean"])


def class_share(summary: Optional[dict], cls: str) -> Optional[float]:
    """Percent of rank 0's device time in kernels of class `cls`."""
    if summary is None:
        return None
    total = sum(summary["seconds_by_class"].values())
    if total <= 0:
        return None
    return 100.0 * summary["seconds_by_class"].get(cls, 0.0) / total
