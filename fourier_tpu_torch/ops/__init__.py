"""Execution ops: planar complex helpers, butterflies, the plain Stockham
path, and (under ``ops.cuda``) the hand-written CUDA kernels."""
