"""exchanges_per_call (program counters): the exchange legs issued
(``exchange.legs``, one ``all_to_all_single`` a plane set) over the public
calls (``calls``, the outermost entries), both as
``fourier_tpu_torch.trace.counters`` counts them in rank 0's process. Every
call there is the cell's entry (warm-up and both windows; the check runs the
reference). None where the program counts no calls or no legs."""


def read(run):
    try:
        from fourier_tpu_torch import trace
    except ImportError:  # a port that counts nothing
        return None
    counts = trace.counters().snapshot()
    if not counts.get("calls") or not counts.get("exchange.legs"):
        return None
    return counts["exchange.legs"] / counts["calls"]
