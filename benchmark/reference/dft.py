"""The DFT by matrix products, in float64 (the reference) or in TF32 (the
control: the reference in the nearest precision below the float32 that the
configurations state).

TF32 is emulated exactly as the tensor cores compute it: both operands
rounded to 10 mantissa bits (nearest, ties to even), products summed in
float32. The emulation gives the same numbers on the CPU and on the card, so
the control's test here and its run on the card agree.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

Planes = Tuple[torch.Tensor, torch.Tensor]

# Columns a product takes at once: bounds the temporaries (4 planes of this
# many columns of n rows in float64).
BLOCK_ELEMENTS = 1 << 26


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32's 10 mantissa bits, nearest even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def matrix(n: int, forward: bool, device, rows: Optional[slice] = None) -> Planes:
    """(cos, sin) planes of the n-point DFT matrix in float64, exp(∓2πi·jk/n),
    the rows `rows` only when given. j·k is reduced mod n in integers first,
    so every angle is exact before its cosine."""
    k = torch.arange(n, device=device, dtype=torch.int64)
    j = k if rows is None else k[rows]
    jk = torch.remainder(j[:, None] * k[None, :], n).to(torch.float64)
    ang = (-2.0 if forward else 2.0) * math.pi / n * jk
    return torch.cos(ang), torch.sin(ang)


def _products(wr, wi, xr, xi, precision: str) -> Planes:
    if precision == "f64":
        return wr @ xr - wi @ xi, wr @ xi + wi @ xr
    if precision != "tf32":
        raise ValueError(f"precision is 'f64' or 'tf32', not {precision!r}")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the rounding is explicit
    try:
        return wr @ xr - wi @ xi, wr @ xi + wi @ xr
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dft(re: torch.Tensor, im: torch.Tensor, dim: int, forward: bool, scale: float = 1.0,
        precision: str = "f64", rows: Optional[slice] = None) -> Planes:
    """The DFT of planar (re, im) along `dim`, times `scale`; only output
    indices `rows` along `dim` when given. float64 planes out for "f64",
    float32 for "tf32"."""
    n = re.shape[dim]
    dtype = torch.float64 if precision == "f64" else torch.float32
    wr, wi = matrix(n, forward, re.device, rows)
    wr, wi = wr.to(dtype), wi.to(dtype)
    if precision == "tf32":
        wr, wi = to_tf32(wr), to_tf32(wi)
    xr = re.movedim(dim, 0)
    xi = im.movedim(dim, 0)
    rest = xr.shape[1:]
    xr = xr.reshape(n, -1)
    xi = xi.reshape(n, -1)
    cols = xr.shape[1]
    step = max(1, BLOCK_ELEMENTS // max(n, 1))
    out_r = torch.empty((wr.shape[0], cols), dtype=dtype, device=re.device)
    out_i = torch.empty_like(out_r)
    for c in range(0, cols, step):
        br = xr[:, c:c + step].to(dtype)
        bi = xi[:, c:c + step].to(dtype)
        if precision == "tf32":
            br, bi = to_tf32(br), to_tf32(bi)
        yr, yi = _products(wr, wi, br, bi, precision)
        out_r[:, c:c + step] = yr * scale
        out_i[:, c:c + step] = yi * scale
    shape = (wr.shape[0], *rest)
    return out_r.reshape(shape).movedim(0, dim), out_i.reshape(shape).movedim(0, dim)


def dft2(re: torch.Tensor, im: torch.Tensor, forward: bool, scale: float = 1.0,
         precision: str = "f64", rows: Optional[slice] = None) -> Planes:
    """The 2-D DFT over the last two dims, only rows `rows` of the second
    last when given: those rows first, then the last dim of them."""
    yr, yi = dft(re, im, -2, forward, 1.0, precision, rows)
    return dft(yr, yi, -1, forward, scale, precision)


def rel_l2(got: Planes, ref: Planes, dims) -> torch.Tensor:
    """‖got − ref‖₂ / ‖ref‖₂ over `dims`, one reading for each answer (each
    index of the other dims), in float64."""
    gr, gi = (g.to(torch.float64) for g in got)
    rr, ri = (r.to(torch.float64) for r in ref)
    err = ((gr - rr).square() + (gi - ri).square()).sum(dim=dims)
    norm = (rr.square() + ri.square()).sum(dim=dims)
    return torch.sqrt(err / norm)
