"""Dense DFT matrices and split twiddles for the MXU-family plans.

Port of ``fourier_tpu/ops/dft_matrix.py`` (bitwise-equal results): plan-time
f64 numpy, narrowed to planar f32 by the plan. A size n = n1*n2 transforms as

    X[k1*n2 + k2] = sum_a W_n1^(a*k1) * W_n^(a*k2) * sum_b x[a + n1*b] * W_n2^(b*k2)

i.e. a D_n2 contraction, the split twiddle T[k2, a] = W_n^(a*k2), and a D_n1
contraction; :func:`folded_phase_b` folds the twiddle into the second one,
and :func:`packed_phase_b` lays that folded table out block-diagonally.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def dft_matrix(n: int, forward: bool) -> np.ndarray:
    """Dense (n, n) DFT matrix D[k, j] = W_n^(±k*j), complex128."""
    k = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]
    theta = 2.0 * np.pi * (k * j) / float(n)
    d = np.cos(theta) - 1j * np.sin(theta)
    return d if forward else np.conj(d)


def folded_phase_b(n1: int, n2: int, forward: bool, scale: float = 1.0) -> np.ndarray:
    """Phase-B DFT with the split twiddle folded in: (n2, n1, n1) complex128,
    Df[k2, k1, a] = D_n1[k1, a] * T[k2, a] * scale."""
    d1 = dft_matrix(n1, forward) * scale
    t = split_twiddle(n1, n2, forward)
    return d1[None, :, :] * t[:, None, :]


def packed_phase_b(n1: int, n2: int, forward: bool, pack: int,
                   scale: float = 1.0) -> np.ndarray:
    """Block-diagonal packed phase B: (n2/pack, pack*n1, pack*n1) complex128,
    BD[g, kk*n1 + p, kk'*n1 + a] = delta(kk, kk') * Df[g*pack + kk, p, a]:
    `pack` adjacent k2's share one (pack*n1)-long contraction. Requires
    pack | n2."""
    assert n2 % pack == 0, (n2, pack)
    df = folded_phase_b(n1, n2, forward, scale)
    g = n2 // pack
    dfg = df.reshape(g, pack, n1, n1)  # k2 = g*pack + kk
    bd = np.zeros((g, pack * n1, pack * n1), dtype=np.complex128)
    for kk in range(pack):
        bd[:, kk * n1:(kk + 1) * n1, kk * n1:(kk + 1) * n1] = dfg[:, kk]
    return bd


def choose_pack(n1: int, n2: int, limit: int = 128) -> int:
    """Largest pack with pack | n2 and pack*n1 <= limit (1 = no packing)."""
    best = 1
    for p in range(2, n2 + 1):
        if n2 % p == 0 and p * n1 <= limit:
            best = p
    return best


def split_twiddle(n1: int, n2: int, forward: bool) -> np.ndarray:
    """Dense (n2, n1) split twiddle T[k2, a] = W_(n1*n2)^(±a*k2), complex128."""
    n = n1 * n2
    k2 = np.arange(n2, dtype=np.float64)[:, None]
    a = np.arange(n1, dtype=np.float64)[None, :]
    theta = 2.0 * np.pi * (a * k2) / float(n)
    t = np.cos(theta) - 1j * np.sin(theta)
    return t if forward else np.conj(t)


def choose_split(n: int, limit: int = 128) -> Optional[Tuple[int, int]]:
    """(n1, n2) with n = n1*n2, both <= limit, minimizing n1 + n2 (ties to
    the larger n2); (1, n) for n <= limit; None when no such pair exists
    (n > limit^2, or no divisor pair within the limit, e.g. large primes)."""
    if n <= limit:
        return (1, n)
    best = None
    best_sum = None
    for n2 in range(limit, 0, -1):
        if n % n2 == 0:
            n1 = n // n2
            if n1 <= limit and (best_sum is None or n1 + n2 < best_sum):
                best = (n1, n2)
                best_sum = n1 + n2
    return best
