"""Size factorization for the mixed-radix Stockham planner.

Port of ``fourier_tpu/plan/factor.py``: RADICES = (4, 8, 4, 3, 2); at most one
leading radix-4 stage, then greedily 8s, 4s, 3s and 2s. A residual other than
1 means the size is not 2^a*3^b and the planner uses Bluestein.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

RADICES: Tuple[int, ...] = (4, 8, 4, 3, 2)


def factorize_autosort(size: int) -> Optional[List[int]]:
    """Per-stage radix list for `size` in application order (4096 ->
    [4, 8, 8, 8, 2]; 243 -> [3]*5), or None if not 2^a*3^b."""
    if size < 1:
        raise ValueError(f"FFT size must be >= 1, got {size}")
    remaining = size
    counts = [0] * len(RADICES)
    if remaining % RADICES[0] == 0:
        remaining //= RADICES[0]
        counts[0] = 1
    for idx in range(1, len(RADICES)):
        radix = RADICES[idx]
        while remaining % radix == 0:
            remaining //= radix
            counts[idx] += 1
    if remaining != 1:
        return None
    stages: List[int] = []
    for radix, count in zip(RADICES, counts):
        stages.extend([radix] * count)
    return stages


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n (the Bluestein inner size helper)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()
