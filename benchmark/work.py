"""The work of a cell, from its shapes alone.

benchFFT's convention, which BASELINE.json and the upstream crate's
benchmark use: an N-point complex transform counts 5·N·log2(N) operations,
whatever route computes it (a 2-D image of n1×n2 points is one N = n1·n2
transform). Bytes are the least a transform moves: every point read once and
written once, 8 B a complex64 point each way. Neither depends on the route
or kernel the program picks, so a change of route cannot move the yardstick.
"""

from __future__ import annotations

import math

POINT_BYTES = {"complex64": 8, "complex128": 16}


def transform_flops(points: int) -> float:
    """Operations of one complex transform of `points` points."""
    return 5.0 * points * math.log2(points) if points > 1 else 0.0


def transform_bytes(points: int, dtype: str = "complex64") -> float:
    """Least bytes of one out-of-place transform: read once, write once."""
    return 2.0 * points * POINT_BYTES[dtype]


class Work:
    """Operations and bytes of one call."""

    def __init__(self, flops: float, nbytes: float):
        self.flops = float(flops)
        self.bytes = float(nbytes)

    def __repr__(self) -> str:
        return f"Work(flops={self.flops!r}, bytes={self.bytes!r})"


def batched(points: int, count: int, dtype: str = "complex64") -> Work:
    """`count` transforms of `points` points each."""
    return Work(count * transform_flops(points), count * transform_bytes(points, dtype))
