"""Spans and counters of the port: the one place where it records what a
call did, at each layer boundary.

* :func:`span` ``(name, **attrs)`` is a context manager around a layer's
  work. While no ``torch.profiler`` runs it costs one flag test and returns
  a shared object that does nothing. While a profiler runs it enters
  ``torch.profiler.record_function`` under the label ``name`` (with
  ``[key=value,...]`` where it has attributes), so the span lies in the
  profiler's host timeline beside the CUDA runtime calls and kernels it
  issued, on their clock.
* :func:`call` ``(entry)`` is the span of a public entry point. The
  outermost one of a thread counts ``calls``, takes the next call id (the
  lifecycle spans inside it carry it) and is labelled ``call[entry=...]``;
  entries it reaches (a plan's call inside an ``fft2``) are labelled
  ``call.nested[entry=...]``.
* Lifecycle spans (``LIFECYCLE``: a plan built, a library loaded or built,
  the first launch of a C entry point) are set-up events that happen a few
  times a process. They are always recorded, on ``time.perf_counter_ns``,
  into a bounded store that :func:`spans` returns: name, start, end, the
  enclosing lifecycle span, the call they happened in, and attributes.
  ``with span(...) as s`` gives a lifecycle span itself, and an attribute
  set in ``s.attrs`` inside goes into its record (the profiler's label is
  fixed on entry): ``plan.build`` so records ``plan``, the class of the
  plan it built.
* :func:`counters` is one registry of named integer counts
  (:class:`Counters`), always on: ``calls``, ``launches.<operator>``, the
  planner's cache hits and misses, libraries loaded and built, exchange
  legs and bytes, the exchange layer's copies (``exchange.copies``: pieces
  copied; ``exchange.copies.tiled``: those whose two sides' innermost dims
  differ; ``exchange.copy_bytes``: bytes read), the bytes the push split
  of a clustered ``fft_pair`` body (B1, B3, B6) sends across its cluster
  (``split.cluster_bytes``), the dense DFT products of ``MxuFftPlan``
  (``dft.products``: one a call; ``dft.product_flops``: the real
  operations its products issue, 8·B·n² for one direct product of B
  transforms). Take a ``snapshot()`` and read ``delta(snapshot)``.

Span names by layer: ``call`` / ``call.nested`` (entry and plan),
``plan.build[size,dtype,backend]`` (planner; ``plan`` in its record),
``dft.product[n,phases]`` (``plan/mxu.py``: a call's DFT products, which
launch no registered operator in the planner's form), ``axis``,
``layout.to_front``, ``layout.scale``,
``layout.join`` (the surface's per-axis passes and layout work, ``ndim.py``),
``launch`` / ``launch.first`` (a registered operator's C entry point,
``ops/cuda/build.py``), ``lib.load`` / ``lib.build`` (kernel build and
load), ``exchange.issue`` / ``exchange.wait`` / ``exchange.copy[what=gather|
assemble]`` (``parallel/exchange.py``).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

# Whether a torch profiler records (one C call, ~0.1 µs).
profiling = torch._C._autograd._profiler_enabled

LIFECYCLE = frozenset({"plan.build", "lib.load", "lib.build", "launch.first"})
# Lifecycle spans kept; later ones are counted in ``spans.dropped``.
STORE_MAX = 10_000


class Counters:
    """Named integer counts. Each thread counts into a dict of its own,
    which no other thread writes, so a count takes no lock; a read sums
    every thread's (a dict is copied whole under the interpreter lock)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._threads: List[Dict[str, int]] = []
        registry = self

        class _Local(threading.local):
            def __init__(self):
                self.counts: Dict[str, int] = {}
                with registry._lock:
                    registry._threads.append(self.counts)

        self._local = _Local()

    def count(self, name: str, k: int = 1) -> None:
        """Add `k` to `name`."""
        counts = self._local.counts
        counts[name] = counts.get(name, 0) + k

    def __getitem__(self, name: str) -> int:
        return self.snapshot().get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            threads = list(self._threads)
        out: Dict[str, int] = {}
        for counts in threads:
            for k, v in counts.copy().items():
                out[k] = out.get(k, 0) + v
        return out

    def delta(self, since: Dict[str, int], until: Optional[Dict[str, int]] = None
              ) -> Dict[str, int]:
        """The counts that moved from snapshot `since` to `until` (default:
        now), by how much."""
        until = self.snapshot() if until is None else until
        return {k: v - since.get(k, 0) for k, v in until.items() if v != since.get(k, 0)}


_COUNTERS = Counters()


def counters() -> Counters:
    """The process's registry."""
    return _COUNTERS


# Add k to a count of the process's registry: count(name, k=1).
count = _COUNTERS.count


class Span(NamedTuple):
    """A recorded lifecycle span; times in ns of ``time.perf_counter_ns``."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]  # the enclosing lifecycle span's id
    call: Optional[int]  # the id of the public call it happened in
    attrs: dict


class _State:
    """A thread's place in the spans (a plain object: a ``threading.local``
    attribute costs more to read and write than a slot)."""

    __slots__ = ("depth", "call", "open")

    def __init__(self):
        self.depth = 0  # public entries open
        self.call: Optional[int] = None  # the outermost one's id
        self.open: List[int] = []  # lifecycle spans open, innermost last


class _Thread(threading.local):
    def __init__(self):
        self.s = _State()


_thread = _Thread()
_store: List[Span] = []
_store_lock = threading.Lock()
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)


def spans() -> List[Span]:
    """The lifecycle spans recorded so far, in the order they ended."""
    with _store_lock:
        return list(_store)


def _label(name: str, attrs: dict) -> str:
    if not attrs:
        return name
    return f"{name}[{','.join(f'{k}={v}' for k, v in attrs.items())}]"


class _Off:
    """What a span is while nothing records it."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Profiled:
    """A span that only the profiler records."""

    __slots__ = ("_rf",)

    def __init__(self, label: str):
        self._rf = torch.profiler.record_function(label)

    def __enter__(self):
        self._rf.__enter__()

    def __exit__(self, *exc):
        return self._rf.__exit__(*exc)


class _Lifecycle:
    """A span kept in the store (and given to the profiler, if one runs)."""

    __slots__ = ("name", "attrs", "_rf", "_id", "_start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self._rf = torch.profiler.record_function(_label(name, attrs)) if profiling() else None

    def __enter__(self):
        self._id = next(_span_ids)
        _thread.s.open.append(self._id)
        if self._rf is not None:
            self._rf.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        t = _thread.s
        t.open.pop()
        rec = Span(self._id, self.name, self._start, end, t.open[-1] if t.open else None,
                   t.call, self.attrs)
        with _store_lock:
            if len(_store) < STORE_MAX:
                _store.append(rec)
                return False
        count("spans.dropped")
        return False


def span(name: str, **attrs):
    """The span of one layer's work (see the module's notes)."""
    if name in LIFECYCLE:
        return _Lifecycle(name, attrs)
    if not profiling():
        return _OFF
    return _Profiled(_label(name, attrs))


class _Call:
    """A public entry's span: the outermost one of a thread counts a call
    and gives it its id."""

    __slots__ = ()

    def __enter__(self):
        t = _thread.s
        if not t.depth:
            t.call = next(_call_ids)
            count("calls")
        t.depth += 1

    def __exit__(self, *exc):
        t = _thread.s
        t.depth -= 1
        if not t.depth:
            t.call = None
        return False


class _ProfiledCall(_Call):
    __slots__ = ("_rf",)

    def __init__(self, label: str):
        self._rf = torch.profiler.record_function(label)

    def __enter__(self):
        super().__enter__()
        self._rf.__enter__()

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return super().__exit__(*exc)


_CALL_OFF = _Call()


def call(entry: str):
    """The span of the public entry point `entry` (see the module's notes)."""
    if not profiling():
        return _CALL_OFF
    return _ProfiledCall(f"{'call.nested' if _thread.s.depth else 'call'}[entry={entry}]")
