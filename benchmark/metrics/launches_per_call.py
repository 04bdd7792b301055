"""launches_per_call (program counters): the launches of the port's
registered operators (``launches.fourier_tpu_torch::<operator>``, every
operator) over its public calls (``calls``, the outermost entries), both as
``fourier_tpu_torch.trace.counters`` counts them in rank 0's process. Every
call there is the cell's entry (warm-up and both windows; the check runs the
reference), so the ratio is a call's. None where the program counts no
calls."""

PREFIX = "launches.fourier_tpu_torch::"


def read(run):
    try:
        from fourier_tpu_torch import trace
    except ImportError:  # a port that counts no calls
        return None
    counts = trace.counters().snapshot()
    if not counts.get("calls"):
        return None
    return sum(v for k, v in counts.items() if k.startswith(PREFIX)) / counts["calls"]
