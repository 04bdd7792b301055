"""setup_s (end to end, host clock): process start through warm-up (rank
0's clock; several ranks wait for each other at its end)."""


def read(run):
    return run.setup_s
