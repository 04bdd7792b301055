"""The DFT as dense matrix products: the two forms the MXU-family plan runs.

Port of ``xla_fft_single`` and ``xla_fft_two_phase_folded`` of
``fourier_tpu/ops/pallas/bailey.py``. The JAX package computes these
products with ``jnp.einsum`` outside any Pallas kernel; here they are
``torch.einsum`` on planar f32 tensors (four real products per complex one).

The reference pins ``Precision.HIGHEST`` on every product. On a CUDA device
PyTorch may run float32 products in TF32 (about three decimal digits) when
the caller allows it, so every product here runs inside
:func:`full_f32_matmul`, which forces full float32 and restores the caller's
setting on exit.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """Full-f32 (no TF32) float32 products inside; the caller's matmul
    precision, set through either of PyTorch's APIs, is restored on exit."""
    matmul = torch.backends.cuda.matmul
    saved_matmul = getattr(matmul, "fp32_precision", None)
    saved_generic = getattr(torch.backends, "fp32_precision", None)
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller used the newer per-backend API
        legacy = None
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        if saved_generic is not None:
            torch.backends.fp32_precision = saved_generic
        if saved_matmul is not None:
            matmul.fp32_precision = saved_matmul


def xla_fft_single(re, im, dre, dim):
    """One batched DFT product: (B, n) planes times the (n, n) matrix D
    (direction and mode scale folded in), O[t, k] = sum_j D[k, j] x[t, j]."""
    with full_f32_matmul():
        dg = lambda x, d: torch.einsum("tj,kj->tk", x, d)
        ore = dg(re, dre) - dg(im, dim)
        oim = dg(re, dim) + dg(im, dre)
    return ore, oim


def xla_fft_two_phase_folded(re, im, d2re, d2im, dfre, dfim):
    """Two-phase DFT of (B, n) planes, n = n1*n2: G = D_n2 @ x.reshape(n2, n1),
    then the k2-batched contraction with the folded phase-B table
    Df (n2, n1, n1) (ops/dft_matrix.folded_phase_b), natural order out."""
    b, n = re.shape
    n2 = d2re.shape[0]
    n1 = dfre.shape[1]
    mre = re.reshape(b, n2, n1)
    mim = im.reshape(b, n2, n1)
    with full_f32_matmul():
        mm = lambda d, m: torch.einsum("kb,tba->tka", d, m)
        gre = mm(d2re, mre) - mm(d2im, mim)
        gim = mm(d2re, mim) + mm(d2im, mre)
        dg = lambda d, g: torch.einsum("kpa,tka->tpk", d, g)
        ore = dg(dfre, gre) - dg(dfim, gim)
        oim = dg(dfre, gim) + dg(dfim, gre)
    return ore.reshape(b, n), oim.reshape(b, n)
