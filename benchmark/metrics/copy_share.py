"""copy_share (device trace): the share of rank 0's device time spent in
PyTorch's own kernels (``at::native`` copies, transposes and elementwise
passes, memcpy and memset), not in the port's kernels or the exchange's.
Percent."""

from benchmark.trace import class_share


def read(run):
    return class_share(run.trace, "torch")
