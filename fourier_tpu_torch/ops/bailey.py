"""The DFT as dense matrix products: the einsum forms of the MXU-family plan.

Port of ``xla_fft_single``, ``xla_fft_two_phase_folded``,
``xla_fft_two_phase_packed`` and ``reference_two_phase`` of
``fourier_tpu/ops/pallas/bailey.py``. The JAX package computes these
products with ``jnp.einsum`` outside any Pallas kernel; here they are
``torch.einsum`` on planar f32 tensors (four real products per complex one).
:func:`xla_fft_single` and :func:`reference_two_phase` are also the plain
versions of kernels B9a and B9b (``ops/cuda/bailey.py``).

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


def xla_fft_two_phase_packed(re, im, d2re, d2im, bdre, bdim):
    """Two-phase DFT with phase B block-diagonal packed: BD (n2/pack,
    pack*n1, pack*n1) (ops/dft_matrix.packed_phase_b), so `pack` adjacent
    k2's share one contraction; natural order out."""
    b, n = re.shape
    n2 = d2re.shape[0]
    g, pn1, _ = bdre.shape
    n1 = pn1 // (n2 // g)
    mre = re.reshape(b, n2, n1)
    mim = im.reshape(b, n2, n1)
    with full_f32_matmul():
        mm = lambda d, m: torch.einsum("kb,tba->tka", d, m)
        gre = mm(d2re, mre) - mm(d2im, mim)
        gim = mm(d2re, mim) + mm(d2im, mre)
        # (t, k2, a) -> (t, G, pack*n1): k2 = g*pack + kk, a free reshape.
        gre = gre.reshape(b, g, pn1)
        gim = gim.reshape(b, g, pn1)
        dg = lambda d, x: torch.einsum("gPA,tgA->tgP", d, x)
        yre = dg(bdre, gre) - dg(bdim, gim)
        yim = dg(bdre, gim) + dg(bdim, gre)
    # (t, G, pack*n1) is (t, k2, k1); the output index is k1*n2 + k2.
    tr = lambda y: y.reshape(b, n2, n1).transpose(1, 2).reshape(b, n)
    return tr(yre), tr(yim)


def reference_two_phase(re, im, d2re, d2im, tre, tim, d1re, d1im):
    """Two-phase DFT with the split twiddle as its own pass: G = D_n2 @ M,
    G' = G * T (T (n2, n1)), O[k1, k2] = sum_a D_n1[k1, a] G'[k2, a]. The
    plain version of kernel B9b (ops/cuda/bailey.py)."""
    b, n = re.shape
    n2, n1 = tre.shape
    mre = re.reshape(b, n2, n1)
    mim = im.reshape(b, n2, n1)
    with full_f32_matmul():
        mm = lambda d, m: torch.einsum("kb,tba->tka", d, m)
        gre = mm(d2re, mre) - mm(d2im, mim)
        gim = mm(d2re, mim) + mm(d2im, mre)
        g2re = gre * tre - gim * tim
        g2im = gre * tim + gim * tre
        dg = lambda d, g: torch.einsum("pa,tka->tpk", d, g)
        ore = dg(d1re, g2re) - dg(d1im, g2im)
        oim = dg(d1re, g2im) + dg(d1im, g2re)
    return ore.reshape(b, n), oim.reshape(b, n)
