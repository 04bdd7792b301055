"""gflops (end to end, host clock): the work of every call completed in the
window, on every rank (5·N·log2 N a transform, ``benchmark/work.py``), over
the window's wall time, which ends when every card is done."""


def read(run):
    return run.work.flops * run.calls_all / run.window_s / 1e9
