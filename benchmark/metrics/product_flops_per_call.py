"""product_flops_per_call (program counters): the real operations that the
plans' dense DFT products issued (``dft.product_flops``, ``plan/mxu.py``:
8·B·n² a direct product of B transforms of n points) over the public calls
(``calls``, the outermost entries), both as
``fourier_tpu_torch.trace.counters`` counts them in rank 0's process, in
GFLOP. Every call there is the cell's entry (warm-up and both windows; the
check runs the reference), and every round calls each size once, so the
ratio is a plan call's. A route moved off the dense product lowers it. None
where the program counts no calls or no such operations (a port without the
counter)."""


def read(run):
    try:
        from fourier_tpu_torch import trace
    except ImportError:  # a port that counts nothing
        return None
    counts = trace.counters().snapshot()
    if not counts.get("calls") or not counts.get("dft.product_flops"):
        return None
    return counts["dft.product_flops"] / counts["calls"] / 1e9
