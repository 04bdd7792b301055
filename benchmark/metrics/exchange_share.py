"""exchange_share (device trace): the share of rank 0's device time spent in
the exchange's transport (kernels of class ``nccl``: NCCL's all-to-all
kernels), beside the port's kernels and PyTorch's copies. Percent."""

from benchmark.trace import class_share


def read(run):
    return class_share(run.trace, "nccl")
