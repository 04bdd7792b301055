"""Kernels B9a and B9b: the DFT as dense complex products in one kernel each.

Port of ``mxu_fft_single`` and ``mxu_fft_two_phase`` of
``fourier_tpu/ops/pallas/bailey.py`` (the Pallas kernels of
``MxuFftPlan(impl="pallas")``). Both take and return batch-major (B, n)
planar f32 planes; the plan folds direction and mode scale into the tables.

* B9a, :func:`mxu_fft_single`: O[t, k] = sum_j D[k, j] x[t, j], n <= 128.
  Its plain version is :func:`fourier_tpu_torch.ops.bailey.xla_fft_single`.
* B9b, :func:`mxu_fft_two_phase`: n = n1*n2 (n1, n2 <= 128), G = D_n2 @ M
  with M = x.reshape(n2, n1), G' = G * T, O[k1, k2] = sum_a D_n1[k1, a]
  G'[k2, a] in natural order. Its plain version is
  :func:`fourier_tpu_torch.ops.bailey.reference_two_phase`.

Both run on the tensor cores: their bodies of ``csrc/dft_mma.cu`` (a
library of its own) compute every complex product in 3xTF32 on
``mma.sync`` (each operand split into two TF32 parts, three TF32 products
per f32 one, never one TF32 product), through one warp-level product
(``csrc/dft_mma.cuh``); :func:`single_mma_geometry` and
:func:`two_phase_mma_geometry` give their layouts. B9b's tensor-core body
runs phase A as G^T = M^T D_n2^T (M comes in transposed), the twiddle as a
float multiply on the fragments into G', and phase B as O = D_n1 G'^T, on
one transform at a time. B9b's CUDA-core body (fp32 FMA, no TF32), a
library built from ``csrc/bailey.cu``, runs the small transforms below
``B9B_FMA_WORK``, where the card's sweep found it faster
(:func:`two_phase_body`, the one rule of B9b's body). No product
takes the caller's TF32 setting. Each wrapper runs its plain version for
tensors on the CPU and launches its kernel (or raises) for tensors on a
CUDA device, through a registered operator (``fourier_tpu_torch::
mxu_fft_single``, ``::mxu_fft_two_phase``), whose launches ``build.launch``
counts (B9b's tensor-core ones also in ``launches.mxu_fft_two_phase.mma``
of ``fourier_tpu_torch.trace``'s registry). ``tb`` is the TPU kernel's
batch tile; here it caps the rows or transforms a block takes at once,
and no result depends on it. :func:`two_phase_geometry` gives the
CUDA-core launch's shape.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from fourier_tpu_torch import trace
from fourier_tpu_torch.ops import bailey
from fourier_tpu_torch.ops.cuda import build
from fourier_tpu_torch.ops.cuda.stockham_vpu import (check_planes, check_tables,
                                                     stream_of)

MAX_N = 128  # either factor of a split, and n of the single product
MAX_OUT = 16  # complex outputs one thread accumulates (csrc kMaxOut)
MAX_THREADS = 1024
SMALL_THREADS = 512  # B9b's instantiation with 128 registers a thread
MAX_SMEM = 232448  # bytes of shared memory a block may use (227 KB)

# B9a's tensor-core body (csrc/dft_mma.cu): eight warps a block, a warp
# holding at most MMA_MAX_TILES 8-column n-tiles of 16 output rows.
MMA_WARPS = 8
MMA_MAX_TILES = 4

LIBRARY = "bailey"  # csrc/bailey.cu
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY_POINTS = {
    "fourier_dft_two_phase_c64": [_P] * 10 + [_I] * 6 + [_P],
}
MMA_LIBRARY = "dft_mma"  # csrc/dft_mma.cu: B9a's tensor-core body
MMA_ENTRY_POINTS = {
    "fourier_dft_single_mma_c64": [_P] * 6 + [_I] * 4 + [_P],
    "fourier_dft_two_phase_mma_c64": [_P] * 10 + [_I] * 4 + [_P],
}
# B9b's body follows a transform's work n * (n1 + n2), the CUDA-core body's
# flops over 8: below B9B_FMA_WORK the card's sweep (chip_smoke.py phase 5g:
# every split of 128 < n <= 640 and every 16th above, both bodies) found the
# CUDA-core body faster, above it the tensor-core body. The CUDA-core body's
# time follows its flops; the tensor-core body takes one transform a block
# at a time, with three barriers and at least one warp job a phase, so a
# small transform leaves most of its warps idle.
B9B_FMA_WORK = 21000


def library():
    """Build (at first use) and load B9b's CUDA-core library."""
    return build.bind(LIBRARY, ENTRY_POINTS)


def mma_library():
    """Build (at first use) and load B9a's tensor-core library."""
    return build.bind(MMA_LIBRARY, MMA_ENTRY_POINTS)


class MmaGeometry(NamedTuple):
    """B9a's tensor-core tile at size n (mma_geometry in csrc/dft_mma.cu):
    N and K padded to `np8`, rows at a stride of `ld` floats in shared
    memory, `wn` warps along the output's n-tiles and MMA_WARPS / `wn` along
    its 16-row m-tiles, so `rows` rows a tile, of which `valid` are taken
    (`tb` caps them); `smem` bytes: D and two buffers of a tile's two
    planes."""
    np8: int
    ld: int
    wn: int
    rows: int
    valid: int
    smem: int


class TwoPhaseMmaGeometry(NamedTuple):
    """B9b's tensor-core layout at split (n1, n2) (two_phase_geometry in
    csrc/dft_mma.cu): `n1p` = ceil(n1 / 8) * 8, `arows` = ceil(n1 / 16) * 16
    (rows a of phase A and k1 of phase B, in 16-row m-tiles), `k2p` =
    ceil(n2 / 8) * 8; M^T (rows a) at a stride of `ldm` floats, `buffers`
    of them; S, `chunk` rows k2 of G', at `ldg`; D_n1 and D_n2 at `ld1`
    and `ld2`, in shared memory where `staged`, else read from global
    memory as they are (strides n1 and n2, the reads past them guarded);
    `smem` bytes."""
    n1p: int
    arows: int
    k2p: int
    ldm: int
    ldg: int
    ld1: int
    ld2: int
    staged: bool
    buffers: int
    chunk: int
    smem: int


def groups_of(rows: int) -> int:
    """Thread groups over `rows` outputs, each owning at most MAX_OUT."""
    return -(-rows // MAX_OUT)


def single_mma_geometry(n: int, tb: Optional[int] = None) -> MmaGeometry:
    """B9a's tensor-core tile: np8 = ceil(n / 8) * 8, the row stride np8 + 4
    (4 mod 8 words: a fragment load's eight rows fall on distinct banks),
    one, two or four warps along the np8 / 8 n-tiles so that a warp holds at
    most MMA_MAX_TILES of them, and 16 rows for each warp along the m-tiles
    (128, 64 or 32 rows); `tb` caps the rows a tile takes."""
    np8 = -(-n // 8) * 8
    ntiles = np8 // 8
    wn = 1 if ntiles <= MMA_MAX_TILES else 2 if ntiles <= 2 * MMA_MAX_TILES else 4
    rows = 16 * (MMA_WARPS // wn)
    ld = np8 + 4
    valid = max(1, min(rows, tb)) if tb else rows
    return MmaGeometry(np8, ld, wn, rows, valid, 4 * ld * (2 * np8 + 4 * rows))


def two_phase_mma_geometry(n1: int, n2: int) -> TwoPhaseMmaGeometry:
    """B9b's tensor-core layout: strides of 4 mod 8 words in shared memory
    (a fragment load's eight rows on distinct banks); the first of (staged
    tables, two buffers, all of S), (staged, two, S of 64 rows), (global
    tables, two, all), (global, two, 64), (global, one, all), (global, one,
    64) within MAX_SMEM bytes."""
    n1p, arows, k2p = -(-n1 // 8) * 8, -(-n1 // 16) * 16, -(-n2 // 8) * 8
    ldm, ldg = k2p + 4, n1p + 4
    for option in range(6):
        staged, buffers = option < 2, 2 if option < 4 else 1
        chunk = 64 if option % 2 and k2p > 64 else k2p
        ld2, ld1 = (k2p + 4, n1p + 4) if staged else (n2, n1)
        floats = ((2 * (k2p * ld2 + arows * ld1) if staged else 0)
                  + 2 * buffers * arows * ldm + 2 * chunk * ldg)
        if 4 * floats <= MAX_SMEM:
            break
    return TwoPhaseMmaGeometry(n1p, arows, k2p, ldm, ldg, ld1, ld2, staged, buffers,
                               chunk, 4 * floats)


def two_phase_geometry(n1: int, n2: int, batch: int, sms: int,
                       tb: Optional[int] = None) -> Tuple[int, int]:
    """B9b's (transforms a block, threads a block) on a card of `sms`
    multiprocessors: enough transforms to give about two blocks an SM,
    within the thread cap (one thread per column and output group of each
    phase; SMALL_THREADS, where the kernel may use 128 registers a thread,
    unless one transform needs more) and MAX_SMEM bytes (the padded planes,
    8 * n2 * (n1 | 1) bytes a transform)."""
    per = max(n1 * groups_of(n2), n2 * groups_of(n1))
    cap = SMALL_THREADS if per <= SMALL_THREADS else MAX_THREADS
    tpb = min(cap // per, MAX_SMEM // (8 * n2 * (n1 | 1)),
              -(-batch // (2 * sms)))
    if tb:
        tpb = min(tpb, tb)
    tpb = max(1, tpb)
    return tpb, -(-tpb * per // 32) * 32


def _check(re, im, n: int, what: str):
    """Contiguous f32 (B, n) planes on the CPU or a CUDA device."""
    two_d = isinstance(re, torch.Tensor) and re.ndim == 2
    check_planes(re, im, (re.shape[0] if two_d else -1,), what)
    if re.shape[1] != n:
        raise ValueError(f"{what} takes (B, {n}) planes, got {tuple(re.shape)}")


def _check_table(t, shape, what: str):
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} takes a {shape} table, got {tuple(t.shape)}")


def mxu_fft_single(re, im, dre, dim, *, tb: Optional[int] = None):
    """B9a over contiguous planar f32 (B, n) planes, n <= 128; returns new
    planes. `dre`/`dim`: the (n, n) table, direction and scale folded in.
    The kernel is the tensor-core body of ``csrc/dft_mma.cu``."""
    n = dre.shape[0] if dre.ndim == 2 else -1
    if not 1 <= n <= MAX_N:
        raise ValueError(f"B9a takes n <= {MAX_N}, got a table of {tuple(dre.shape)}")
    _check(re, im, n, "B9a")
    for t in (dre, dim):
        _check_table(t, (n, n), "B9a")
    if re.device.type == "cpu":
        return bailey.xla_fft_single(re, im, dre, dim)
    check_tables(re.device, dre, dim)
    return _mxu_fft_single_op(re, im, dre, dim, tb)


_SINGLE_OP = "fourier_tpu_torch::mxu_fft_single"


@torch.library.custom_op(_SINGLE_OP, mutates_args=(), device_types="cuda")
def _mxu_fft_single_op(re: Tensor, im: Tensor, dre: Tensor, dim: Tensor,
                       tb: Optional[int]) -> Tuple[Tensor, Tensor]:
    """B9a's launch (see :func:`mxu_fft_single`)."""
    n = dre.shape[0]
    out_re = torch.empty_like(re)
    out_im = torch.empty_like(im)
    batch = re.shape[0]
    if batch == 0:
        return out_re, out_im
    data = (re.data_ptr(), im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
            dre.data_ptr(), dim.data_ptr())
    build.launch(_SINGLE_OP, mma_library(), "fourier_dft_single_mma_c64",
                 f"B9a (tensor cores) at n={n}, B={batch}", *data, n, batch,
                 single_mma_geometry(n, tb).valid, re.device.index, stream_of(re))
    return out_re, out_im


@_mxu_fft_single_op.register_fake
def _(re, im, *_):
    return torch.empty_like(re), torch.empty_like(im)


def two_phase_body(n1: int, n2: int) -> str:
    """The body mxu_fft_two_phase runs at split (n1, n2): "fma" (the
    CUDA-core body) where n * (n1 + n2) < B9B_FMA_WORK, else "mma" (the
    tensor-core body). An A/B that forces a body swaps B9B_FMA_WORK
    in-process."""
    return "fma" if n1 * n2 * (n1 + n2) < B9B_FMA_WORK else "mma"


def mxu_fft_two_phase(re, im, d2re, d2im, tre, tim, d1re, d1im, *,
                      tb: Optional[int] = None):
    """B9b over contiguous planar f32 (B, n) planes, n = n1*n2; returns new
    planes in natural order. Tables: D_n2 (n2, n2), the split twiddle T
    (n2, n1) and D_n1 (n1, n1), direction and scale folded in. The kernel
    is the tensor-core body of ``csrc/dft_mma.cu``, but the CUDA-core body
    of ``csrc/bailey.cu`` where :func:`two_phase_body` says so. The
    tensor-core body takes one transform at a time, so `tb` caps only the
    CUDA-core body's transforms a block."""
    if tre.ndim != 2:
        raise ValueError(f"B9b takes an (n2, n1) twiddle, got {tuple(tre.shape)}")
    n2, n1 = tre.shape
    if not (1 <= n1 <= MAX_N and 1 <= n2 <= MAX_N):
        raise ValueError(f"B9b takes n1, n2 <= {MAX_N}, got ({n1}, {n2})")
    n = n1 * n2
    _check(re, im, n, "B9b")
    for t, shape in ((d2re, (n2, n2)), (d2im, (n2, n2)), (tim, (n2, n1)),
                     (d1re, (n1, n1)), (d1im, (n1, n1))):
        _check_table(t, shape, "B9b")
    if re.device.type == "cpu":
        return bailey.reference_two_phase(re, im, d2re, d2im, tre, tim, d1re, d1im)
    check_tables(re.device, d2re, d2im, tre, tim, d1re, d1im)
    return _mxu_fft_two_phase_op(re, im, d2re, d2im, tre, tim, d1re, d1im, tb)


_TWO_PHASE_OP = "fourier_tpu_torch::mxu_fft_two_phase"


@torch.library.custom_op(_TWO_PHASE_OP, mutates_args=(), device_types="cuda")
def _mxu_fft_two_phase_op(re: Tensor, im: Tensor, d2re: Tensor, d2im: Tensor,
                          tre: Tensor, tim: Tensor, d1re: Tensor, d1im: Tensor,
                          tb: Optional[int]) -> Tuple[Tensor, Tensor]:
    """B9b's launch (see :func:`mxu_fft_two_phase`)."""
    n2, n1 = tre.shape
    n = n1 * n2
    out_re = torch.empty_like(re)
    out_im = torch.empty_like(im)
    batch = re.shape[0]
    if batch == 0:
        return out_re, out_im
    what = f"B9b at n={n} ({n1}, {n2}), B={batch}"
    if two_phase_body(n1, n2) == "mma":
        build.launch(_TWO_PHASE_OP, mma_library(), "fourier_dft_two_phase_mma_c64",
                     f"{what} (tensor cores)", re.data_ptr(), im.data_ptr(),
                     out_re.data_ptr(), out_im.data_ptr(), d2re.data_ptr(),
                     d2im.data_ptr(), tre.data_ptr(), tim.data_ptr(), d1re.data_ptr(),
                     d1im.data_ptr(), n1, n2, batch, re.device.index, stream_of(re))
        trace.count("launches.mxu_fft_two_phase.mma")
    else:
        sms = torch.cuda.get_device_properties(re.device).multi_processor_count
        tpb, threads = two_phase_geometry(n1, n2, batch, sms, tb)
        build.launch(_TWO_PHASE_OP, library(), "fourier_dft_two_phase_c64", what,
                     re.data_ptr(), im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
                     d2re.data_ptr(), d2im.data_ptr(), tre.data_ptr(), tim.data_ptr(),
                     d1re.data_ptr(), d1im.data_ptr(), n1, n2, batch, tpb, threads,
                     re.device.index, stream_of(re))
    return out_re, out_im


@_mxu_fft_two_phase_op.register_fake
def _(re, im, *_):
    return torch.empty_like(re), torch.empty_like(im)
