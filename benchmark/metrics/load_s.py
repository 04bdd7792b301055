"""load_s (program spans): the seconds rank 0's process spent loading the
port's kernel libraries (its lifecycle spans ``lib.load``, a build inside
one included) and in each C entry point's first launch (``launch.first``,
where the CUDA driver loads the kernel's module), as the union of their
intervals: the part of ``setup_s`` that the kernel build and load layer
owns. The spans are the program's own (``fourier_tpu_torch.trace.spans``),
kept whatever the run traces; None where it has none."""

from benchmark.trace import _union

SPANS = ("lib.load", "launch.first")


def read(run):
    try:
        from fourier_tpu_torch import trace
    except ImportError:  # a port that records no spans
        return None
    spans = [(s.start_ns, s.end_ns) for s in trace.spans() if s.name in SPANS]
    if not spans:
        return None
    return _union(spans)[0] * 1e-9
