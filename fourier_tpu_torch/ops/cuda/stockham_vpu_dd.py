"""Kernels B6 and B7: the fused Stockham and Bluestein FFTs in native f64.

Port of ``fourier_tpu/ops/pallas/stockham_vpu_dd.py``. The TPU has no f64,
so its kernels carry a complex128 value as four f32 planes (double-word hi/lo
pairs); the card has native f64, so here a complex128 value is two float64
planes (re, im) and the kernels are B1's and B2's stage code at double:

* :func:`radix_schedule_dd` is the TPU kernel's schedule, kept as the plan's
  domain predicate (n = 2^a*3^b*5^c with 8 | n and 64 <= n <= 4096, plus
  243, 729 and 625);
* :func:`make_stage_tables_dd` gives its compact (m, r) twiddle tables in f64
  (the TPU kernel's (n/r, r) dd tables repeat each row `stride` times);
* B6, the fused all-stages transform: :func:`vpu_dd_fft_batch_minor_reference`
  is the plain PyTorch version, :func:`vpu_dd_fft_batch_minor` the kernel's
  wrapper, which launches the clustered-block body of ``csrc/fft_pair_dd.cu``
  (B1's body at double, its own library) at the 60 n of
  :func:`fft_pair_geometry_dd` but those of B6_STAGE_FASTER, and the stage
  body at the rest of its domain;
* B7, the fused Bluestein transform: :func:`vpu_dd_bluestein_batch_minor_reference`
  and the wrapper :func:`vpu_dd_bluestein_batch_minor`, which launches the
  paired-block body of ``csrc/stockham_pair.cuh`` (:func:`bluestein_pair_geometry`,
  the pass schedule of :mod:`.stockham_vpu`).

B6's stage body, B7's paired body and B8 of :mod:`.dd_combine` are one
library built from ``csrc/stockham_vpu_dd.cu``. Each wrapper runs its plain version for tensors
on the CPU, and launches its kernel (or raises) for tensors on a CUDA
device, through a registered operator as in :mod:`.stockham_vpu`, whose
launches ``build.launch`` counts; B6's body is
``clustered_geometry("B6", n)``'s (:mod:`.stockham_vpu`). The clustered and paired bodies
read the plan's ``pair_tables`` (f64). B6's stage body runs
:func:`kernel_schedule_dd`, each radix of the TPU schedule split into 8, 4,
2, 3 and 5, with twiddles from :func:`make_kernel_tables_dd`; no table is
narrowed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from fourier_tpu_torch.ops.cuda import build
from fourier_tpu_torch.ops.cuda.stockham_vpu import (BODIES, FFT_PAIR_ROWS,
                                                     POINTS_PER_THREAD,
                                                     PairGeometry,
                                                     chirp_z_reference,
                                                     check_planes, check_tables,
                                                     check_pair_tables,
                                                     clustered_geometry,
                                                     count_split_bytes,
                                                     kernel_tables,
                                                     pair_geometry,
                                                     pass_schedule,
                                                     radices_arg, scale_arg,
                                                     split_schedule,
                                                     stage_tables,
                                                     stages_reference,
                                                     stream_of)

# Pure 3^b and 5^c schedules of the TPU kernel (two-stage blocks); part of the
# domain definition. 125 and 2187 are outside it.
_POW3_DD_SCHEDULES = {243: (27, 9), 729: (27, 27)}
_POW5_DD_SCHEDULES = {625: (25, 25)}

F64 = torch.float64
# Launch geometry of the f64 kernels: at most MAX_THREADS threads a block (an
# f64 radix-8 stage holds 64 32-bit registers of data a thread, and a
# 512-thread block leaves a thread 128), so at most BLOCK_POINTS complex
# points (128 KiB of shared memory) over up to MAX_COLS columns.
MAX_THREADS = 512
BLOCK_POINTS = MAX_THREADS * POINTS_PER_THREAD
MAX_COLS = 32
# Threads a block of B7's paired-block body (kPairThreadsDd in the .cu) and
# of B6's clustered ones (kThreads in csrc/fft_pair_dd.cu): 16 complex f64
# points a thread in a pass, 64 32-bit registers of data, with up to 255
# registers a thread at one block an SM.
PAIR_THREADS_DD = 256
# Sizes at which B6's stage body won a same-run A/B against its clustered
# body (chip_smoke.py phase 5g, about 2^26 points a call, on an H100 80GB
# HBM3 at 700 W): there the wrapper would launch the stage body. None: the
# clustered body won at all 60 n, by 1.003x (n = 640) to 2.05x.
B6_STAGE_FASTER = frozenset()


def radix_schedule_dd(n: int) -> Optional[List[int]]:
    """Stage radices of the TPU kernel for n in B6's domain, else None.

    Radix-8 stages first, one {4, 2} remainder, then radix-3 stages and the
    radix-25/5 ones; the pure powers 3^b and 5^c come from the tabled
    two-stage schedules (243, 729, 625).
    """
    if n < 64 or n > 4096:
        return None
    pow2, threes, fives = n, 0, 0
    while pow2 % 3 == 0:
        pow2 //= 3
        threes += 1
    while pow2 % 5 == 0:
        pow2 //= 5
        fives += 1
    if pow2 & (pow2 - 1):
        return None  # not 2^a * 3^b * 5^c
    if pow2 < 8:
        if pow2 == 1 and threes == 0 and n in _POW5_DD_SCHEDULES:
            return list(_POW5_DD_SCHEDULES[n])
        if pow2 == 1 and fives == 0 and n in _POW3_DD_SCHEDULES:
            return list(_POW3_DD_SCHEDULES[n])
        return None
    sched, m = [], pow2
    while m % 8 == 0:
        sched.append(8)
        m //= 8
    if m > 1:
        sched.append(int(m))  # 4 or 2
    sched.extend([3] * threes)
    sched.extend([25] * (fives // 2))
    sched.extend([5] * (fives % 2))
    return sched


def make_stage_tables_dd(n: int, forward: bool) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Compact planar f64 (m, r) twiddle tables of :func:`radix_schedule_dd`,
    one per stage but the last."""
    return stage_tables(n, radix_schedule_dd(n), forward, np.float64)


@functools.lru_cache(maxsize=None)
def kernel_schedule_dd(n: int) -> Tuple[int, ...]:
    """B6's stages: :func:`radix_schedule_dd` split into 8, 4, 2, 3 and 5."""
    return split_schedule(radix_schedule_dd(n))


def make_kernel_tables_dd(n: int, forward: bool) -> np.ndarray:
    """B6's twiddles for :func:`kernel_schedule_dd`, a planar f64 (2, L)
    array."""
    return kernel_tables(n, kernel_schedule_dd(n), forward, np.float64)


def launch_geometry_dd(n: int) -> Tuple[int, int]:
    """(columns per block, threads per block) of the f64 kernels at size n."""
    cols = max(1, min(MAX_COLS, BLOCK_POINTS // n))
    threads = -(-n * cols // POINTS_PER_THREAD)
    return cols, -(-threads // 32) * 32


def fft_pair_geometry_dd(n: int) -> Optional[PairGeometry]:
    """B6's clustered-block launch at n (PAIR_THREADS_DD threads), or None
    where the stage body stays the kernel: B1's 60 clustered sizes
    (``fft_pair_geometry`` of :mod:`.stockham_vpu`), two blocks of n/2 rows
    for 8 | n up to 2048 and four of n/4 for the 14 n in (2048, 4096] whose
    n/4 is a two-block height; not 243, 625, 729, 3000 or 3240. 4 f64
    columns a tile at n/C = 1024, 8 at 512, more where n/C is small."""
    if radix_schedule_dd(n) is None:
        return None
    for ranks in (2, 4):
        if n % ranks == 0 and n // ranks in FFT_PAIR_ROWS[ranks]:
            return pair_geometry(n, 8, PAIR_THREADS_DD, ranks)
    return None


BODIES["B6"] = (fft_pair_geometry_dd, B6_STAGE_FASTER)


def bluestein_pair_geometry(m: int) -> PairGeometry:
    """B7's paired-block launch at inner size m (a power of two, 64..2048):
    m/2 rows, 4 f64 columns a group, groups up to 16 points a thread."""
    return pair_geometry(m, 8, PAIR_THREADS_DD)


def vpu_dd_fft_batch_minor_reference(re_t, im_t, n: int, tables, forward: bool,
                                     scale: Optional[float]):
    """Plain PyTorch B6: the stages of :func:`radix_schedule_dd` over f64
    (n, B) planes with the compact `tables` of :func:`make_stage_tables_dd`,
    then the mode scale. Port of ``stockham_vpu_dd._kernel``'s math."""
    return stages_reference(re_t, im_t, radix_schedule_dd(n), tables, forward,
                            scale)


def vpu_dd_bluestein_batch_minor_reference(re_t, im_t, n: int, m: int, tables,
                                           chirps, scale: Optional[float]):
    """Plain PyTorch B7: the chirp-z over f64 (n, B) planes through the
    m-point stages of :func:`radix_schedule_dd`. `tables`: the (forward,
    inverse) compact stage tables of m; `chirps`: the f64 (2, n), (2, m) and
    (2, n) planar tensors xt, wt and xo (1/m folded into xo). Port of
    ``stockham_vpu_dd._bluestein_kernel_dd``'s math."""
    return chirp_z_reference(re_t, im_t, n, m, radix_schedule_dd(m), tables,
                             chirps, scale)


LIBRARY = "stockham_vpu_dd"  # csrc/stockham_vpu_dd.cu
# The library's C entry points and their argument types.
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
ENTRY_POINTS = {
    "fourier_stockham_c128": [_P] * 4 + [_I] * 5 + [_P] * 3 + [_I, _D, _I, _P],
    "fourier_bluestein_pair_c128": [_P] * 4 + [_I] * 6 + [_P] * 11 + [_D, _I, _P],
    "fourier_split_combine_c128": [_P] * 4 + [_I] * 3 + [_P] * 2 + [_I, _D, _I, _P],
}
FFT_PAIR_DD_LIBRARY = "fft_pair_dd"  # csrc/fft_pair_dd.cu: B6's clustered bodies
FFT_PAIR_DD_ENTRY_POINTS = {
    "fourier_stockham_pair_c128": [_P] * 4 + [_I] * 6 + [_P] * 3 + [_I, _D, _I, _P],
    "fourier_stockham_pair_clusters_c128": [_I] * 4 + [ctypes.POINTER(_I)],
}


def library():
    """Build (at first use) and load the f64 kernel library."""
    return build.bind(LIBRARY, ENTRY_POINTS)


def fft_pair_dd_library():
    """Build (at first use) and load B6's clustered-block library."""
    return build.bind(FFT_PAIR_DD_LIBRARY, FFT_PAIR_DD_ENTRY_POINTS)


def fft_pair_clusters_dd(n: int, device) -> int:
    """The clusters of B6's clustered body at n that the card keeps at once
    (cudaOccupancyMaxActiveClusters), the grid of its persistent walk."""
    geo = fft_pair_geometry_dd(n)
    if geo is None:
        raise ValueError(f"B6 has no clustered-block body at n={n}")
    out = ctypes.c_int(0)
    build.call(fft_pair_dd_library(), "fourier_stockham_pair_clusters_c128",
               f"B6's cluster count at n={n}", n, geo.ranks, geo.cols,
               torch.device(device).index or 0, ctypes.byref(out))
    return out.value


def launch(op: str, fn_name: str, what: str, *args) -> None:
    """Launch the operator `op` through this library's C entry point
    `fn_name`; raise if it fails."""
    build.launch(op, library(), fn_name, what, *args)


def vpu_dd_fft_batch_minor(re_t, im_t, n: int, forward: bool,
                           scale: Optional[float], *, tables, kernel_tables,
                           pair_tables=None):
    """B6 over contiguous planar f64 (n, B) planes; returns new planes.

    `tables`: the compact stage tables of :func:`make_stage_tables_dd` as
    tensors (plain version); `kernel_tables`: the (2, L) f64 tensor of
    :func:`make_kernel_tables_dd` (the stage body), both direction-matched;
    `pair_tables`: the forward f64 ``pair_tables`` of n on the body's
    clusters, which the clustered body reads in both directions (None where
    n has no clustered body); all on the planes' device. The kernel is the
    clustered-block body of ``csrc/fft_pair_dd.cu`` where
    ``clustered_geometry`` gives its launch, else the stage body. On a card the launch is the operator
    ``fourier_tpu_torch::vpu_dd_fft``.
    """
    check_planes(re_t, im_t, (n,), "B6", F64)
    if re_t.device.type == "cpu":
        return vpu_dd_fft_batch_minor_reference(re_t, im_t, n, tables, forward,
                                                scale)
    check_tables(re_t.device, kernel_tables, dtype=F64)
    return _vpu_dd_fft_op(re_t, im_t, n, forward, scale, kernel_tables, pair_tables)


@torch.library.custom_op("fourier_tpu_torch::vpu_dd_fft", mutates_args=(),
                         device_types="cuda")
def _vpu_dd_fft_op(re_t: Tensor, im_t: Tensor, n: int, forward: bool,
                   scale: Optional[float], kernel_tables: Tensor,
                   pair_tables: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """B6's launch (see :func:`vpu_dd_fft_batch_minor`)."""
    out_re = torch.empty_like(re_t)
    out_im = torch.empty_like(im_t)
    batch = re_t.shape[1]
    if batch == 0:
        return out_re, out_im
    data = (re_t.data_ptr(), im_t.data_ptr(), out_re.data_ptr(), out_im.data_ptr())
    geo = clustered_geometry("B6", n)
    if geo is not None:
        check_pair_tables(re_t.device, n, geo.ranks, pair_tables, dtype=F64)
        count_split_bytes(geo.ranks, n, batch, 8)
        build.launch(
            "fourier_tpu_torch::vpu_dd_fft",
            fft_pair_dd_library(), "fourier_stockham_pair_c128",
            f"B6 ({geo.ranks}-block clusters) at n={n}, B={batch}", *data,
            n, batch, geo.ranks, geo.cols, geo.threads,
            *radices_arg(pass_schedule(geo.rows)),
            pair_tables[0].data_ptr(), pair_tables[1].data_ptr(), int(forward),
            scale_arg(scale), re_t.device.index, stream_of(re_t),
        )
    else:
        cols, threads = launch_geometry_dd(n)
        launch(
            "fourier_tpu_torch::vpu_dd_fft",
            "fourier_stockham_c128", f"B6 at n={n}, B={batch}", *data,
            n, batch, cols, threads, *radices_arg(kernel_schedule_dd(n)),
            kernel_tables[0].data_ptr(), kernel_tables[1].data_ptr(),
            int(forward), scale_arg(scale), re_t.device.index, stream_of(re_t),
        )
    return out_re, out_im


@_vpu_dd_fft_op.register_fake
def _(re_t, im_t, *_):
    return torch.empty_like(re_t), torch.empty_like(im_t)


def vpu_dd_bluestein_batch_minor(re_t, im_t, n: int, m: int,
                                 scale: Optional[float], *, tables, chirps,
                                 pair_tables):
    """B7 over contiguous planar f64 (n, B) planes; returns new planes.

    `tables`: (forward, inverse) compact stage tables for m as tensors
    (plain version); `pair_tables`: the (forward, inverse) f64
    ``pair_tables`` of m (the paired body); `chirps`: the direction-matched
    (xt, wt, xo); all f64 on the planes' device. The kernel is the
    paired-block body, at every M. On a card the launch is the operator
    ``fourier_tpu_torch::vpu_dd_bluestein``.
    """
    check_planes(re_t, im_t, (n,), "B7", F64)
    if re_t.device.type == "cpu":
        return vpu_dd_bluestein_batch_minor_reference(re_t, im_t, n, m, tables,
                                                      chirps, scale)
    check_tables(re_t.device, *chirps, dtype=F64)
    return _vpu_dd_bluestein_op(re_t, im_t, n, m, scale, *pair_tables, *chirps)


@torch.library.custom_op("fourier_tpu_torch::vpu_dd_bluestein", mutates_args=(),
                         device_types="cuda")
def _vpu_dd_bluestein_op(re_t: Tensor, im_t: Tensor, n: int, m: int,
                         scale: Optional[float], pf: Tensor, pi: Tensor, xt: Tensor,
                         wt: Tensor, xo: Tensor) -> Tuple[Tensor, Tensor]:
    """B7's launch (see :func:`vpu_dd_bluestein_batch_minor`)."""
    out_re = torch.empty_like(re_t)
    out_im = torch.empty_like(im_t)
    batch = re_t.shape[1]
    if batch == 0:
        return out_re, out_im
    geo = bluestein_pair_geometry(m)
    check_pair_tables(re_t.device, m, 2, pf, pi, dtype=F64)
    launch(
        "fourier_tpu_torch::vpu_dd_bluestein",
        "fourier_bluestein_pair_c128", f"B7 (paired blocks) at n={n}, M={m}, B={batch}",
        re_t.data_ptr(), im_t.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        n, m, batch, geo.cols, geo.threads, *radices_arg(pass_schedule(m // 2)),
        pf[0].data_ptr(), pf[1].data_ptr(), pi[0].data_ptr(), pi[1].data_ptr(),
        xt[0].data_ptr(), xt[1].data_ptr(), wt[0].data_ptr(), wt[1].data_ptr(),
        xo[0].data_ptr(), xo[1].data_ptr(),
        scale_arg(scale), re_t.device.index, stream_of(re_t),
    )
    return out_re, out_im


@_vpu_dd_bluestein_op.register_fake
def _(re_t, im_t, *_):
    return torch.empty_like(re_t), torch.empty_like(im_t)
