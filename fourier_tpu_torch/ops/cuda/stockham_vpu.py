"""Kernel B1: the fused all-stages Stockham FFT over batch-minor (n, B) planes.

Port of the B1 part of ``fourier_tpu/ops/pallas/stockham_vpu.py``:

* :func:`radix_schedule` is the TPU kernel's schedule, kept as the plan's
  domain predicate (n = 2^a*3^b*5^c with 8 | n and 64 <= n <= 16384, plus
  243, 729, 2187, 6561, 625 and 3125);
* :func:`make_stage_tables` gives its compact (m, r) twiddle tables;
* :func:`vpu_fft_batch_minor_reference` is the plain PyTorch version, a port
  of ``_stages_value`` plus the mode scale;
* :func:`vpu_fft_batch_minor` is the wrapper of the CUDA kernel in
  ``csrc/stockham_vpu.cu``. It runs the plain version for a tensor on the
  CPU, and launches the kernel (or raises) for a tensor on a CUDA device. It
  counts its launches in ``vpu_fft_batch_minor.launches``.

The kernel runs its own schedule, :func:`kernel_schedule`, which splits each
radix of :func:`radix_schedule` into radices 8, 4, 2, 3 and 5, with twiddles
from :func:`make_kernel_tables`. The source note in the .cu file gives the
design.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fourier_tpu_torch.ops import cplx
from fourier_tpu_torch.ops.butterflies import BUTTERFLIES
from fourier_tpu_torch.twiddle import stage_twiddles

# Pure 3^b and 5^c schedules of the TPU kernel (its measured two-stage
# in-register blocks); part of the domain definition.
_POW3_SCHEDULES = {243: (27, 9), 729: (81, 9), 2187: (81, 27), 6561: (81, 81)}
_POW5_SCHEDULES = {625: (125, 5), 3125: (125, 25)}

# Radices of the CUDA kernel, in the order each TPU radix is split into them.
KERNEL_RADICES = (8, 4, 2, 3, 5)
# Points a kernel thread handles per stage (kPointsPerThread in the .cu).
POINTS_PER_THREAD = 16
# Columns per block (launch_geometry): up to MAX_COLS while the block holds at
# most BLOCK_POINTS complex points (64 KiB of shared memory), and at least
# RUN_COLS (one 32-byte run per row) where MAX_BLOCK_POINTS (128 KiB, 1024
# threads) allow. Chosen on an H100: at n=4096, 4 columns took 2.13 ms against
# 2.71 ms for 2; at n=1024, 8 columns 1.36 ms against 1.47 ms for 16.
BLOCK_POINTS = 8192
MAX_BLOCK_POINTS = 16384
MAX_COLS = 32
RUN_COLS = 8


def radix_schedule(n: int) -> Optional[List[int]]:
    """Stage radices of the TPU kernel for n in B1's domain, else None.

    Greedy radix-64 stages, then radix-8s, one {4, 2} remainder stage, then
    radix-9/3 stages and greedy radix-125/25/5 blocks; the pure powers 3^b
    and 5^c come from the tabled two-stage schedules.
    """
    if n < 64 or n > 16384:
        return None
    pow2 = n
    threes = 0
    while pow2 % 3 == 0:
        pow2 //= 3
        threes += 1
    fives = 0
    while pow2 % 5 == 0:
        pow2 //= 5
        fives += 1
    if pow2 & (pow2 - 1):
        return None  # not 2^a * 3^b * 5^c
    if pow2 < 8:
        if pow2 == 1 and threes == 0 and n in _POW5_SCHEDULES:
            return list(_POW5_SCHEDULES[n])
        if pow2 == 1 and fives == 0 and n in _POW3_SCHEDULES:
            return list(_POW3_SCHEDULES[n])
        return None  # first stage must be a pow2 radix >= 8
    sched = []
    first = 64 if (pow2 >= 64 and n >= 512) else 8
    sched.append(first)
    m = pow2 // first
    while m % 64 == 0:
        sched.append(64)
        m //= 64
    while m % 8 == 0:
        sched.append(8)
        m //= 8
    if m > 1:
        sched.append(int(m))  # 4 or 2
    sched.extend([9] * (threes // 2))
    sched.extend([3] * (threes % 2))
    rem5 = fives
    while rem5 >= 3:
        sched.append(125)
        rem5 -= 3
    if rem5 == 2:
        sched.append(25)
    elif rem5 == 1:
        sched.append(5)
    return sched


def _stage_sizes(n: int, schedule: Sequence[int]):
    """(size, radix) of every stage but the last (which has no twiddles)."""
    out, size = [], n
    for r in schedule[:-1]:
        out.append((size, r))
        size //= r
    return out


def make_stage_tables(n: int, forward: bool) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Compact planar f32 (m, r) twiddle tables of :func:`radix_schedule`,
    one per stage but the last: entry (i, k) = W_size^(i*k)."""
    tables = []
    for size, r in _stage_sizes(n, radix_schedule(n)):
        tw = stage_twiddles(size, r, forward)
        tables.append((tw.real.astype(np.float32), tw.imag.astype(np.float32)))
    return tables


@functools.lru_cache(maxsize=None)
def kernel_schedule(n: int) -> Tuple[int, ...]:
    """The CUDA kernel's stages: each radix of :func:`radix_schedule` split
    greedily into 8, 4, 2, 3 and 5 (64 -> 8, 8; 81 -> 3, 3, 3, 3;
    125 -> 5, 5, 5)."""
    out = []
    for r in radix_schedule(n):
        for k in KERNEL_RADICES:
            while r % k == 0:
                out.append(k)
                r //= k
    return tuple(out)


def make_kernel_tables(n: int, forward: bool) -> np.ndarray:
    """The kernel's twiddles: the (size // r, r) tables of every stage of
    :func:`kernel_schedule` but the last, flattened row-major and
    concatenated, as a planar f32 (2, L) array."""
    parts = [stage_twiddles(size, r, forward).ravel()
             for size, r in _stage_sizes(n, kernel_schedule(n))]
    tw = np.concatenate(parts)
    return np.stack([tw.real, tw.imag]).astype(np.float32)


def launch_geometry(n: int) -> Tuple[int, int]:
    """(columns per block, threads per block) of the kernel at size n."""
    cols = max(1, min(MAX_COLS, BLOCK_POINTS // n),
               min(RUN_COLS, MAX_BLOCK_POINTS // n))
    points = n * cols
    threads = -(-points // POINTS_PER_THREAD)
    threads = -(-threads // 32) * 32
    return cols, threads


def vpu_fft_batch_minor_reference(re_t, im_t, n: int, tables, forward: bool,
                                  scale: Optional[float]):
    """Plain PyTorch B1: the stages of :func:`radix_schedule` over (n, B)
    planes with the compact `tables` of :func:`make_stage_tables`, then the
    mode scale. Port of ``stockham_vpu._stages_value``."""
    schedule = radix_schedule(n)
    b = re_t.shape[-1]
    re, im = re_t, im_t
    size, stride = n, 1
    for s, r in enumerate(schedule):
        m = size // r
        blk = m * stride
        parts = [(re[k * blk:(k + 1) * blk], im[k * blk:(k + 1) * blk])
                 for k in range(r)]
        outs = BUTTERFLIES[r](parts, forward)
        outs = [(o[0].reshape(m, stride, b), o[1].reshape(m, stride, b))
                for o in outs]
        if s < len(schedule) - 1:
            twre, twim = tables[s]
            for k in range(1, r):
                t = (twre[:, k].reshape(m, 1, 1), twim[:, k].reshape(m, 1, 1))
                outs[k] = cplx.mul(outs[k], t)
        re = torch.stack([o[0] for o in outs], dim=1).reshape(n, b)
        im = torch.stack([o[1] for o in outs], dim=1).reshape(n, b)
        size = m
        stride *= r
    if scale is not None:
        re, im = re * scale, im * scale
    return re, im


def _check_planes(re_t, im_t, n: int):
    for t in (re_t, im_t):
        if not isinstance(t, torch.Tensor):
            raise TypeError("B1 takes torch tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"B1 takes float32 planes, got {t.dtype}")
        if t.ndim != 2 or t.shape[0] != n:
            raise ValueError(f"B1 takes ({n}, B) planes, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("B1 takes contiguous planes")
    if re_t.shape != im_t.shape or re_t.device != im_t.device:
        raise ValueError("re/im planes differ in shape or device")


def library():
    """Build (at first use) and load the kernel's shared library."""
    from fourier_tpu_torch.ops.cuda import build

    lib = build.load("stockham_vpu")
    fn = lib.fourier_stockham_c64
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        lib.fourier_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fourier_cuda_error_string.restype = ctypes.c_char_p
    return lib


def vpu_fft_batch_minor(re_t, im_t, n: int, forward: bool,
                        scale: Optional[float], *, tables, kernel_tables):
    """B1 over contiguous planar f32 (n, B) planes; returns new planes.

    `tables`: the compact stage tables of :func:`make_stage_tables` as
    tensors (plain version); `kernel_tables`: the (2, L) f32 tensor of
    :func:`make_kernel_tables` (kernel), both direction-matched and on the
    planes' device.
    """
    _check_planes(re_t, im_t, n)
    if re_t.device.type == "cpu":
        return vpu_fft_batch_minor_reference(re_t, im_t, n, tables, forward,
                                             scale)
    if re_t.device.type != "cuda":
        raise ValueError(f"B1 runs on CPU or CUDA tensors, not {re_t.device}")
    if (kernel_tables.device != re_t.device
            or kernel_tables.dtype != torch.float32
            or not kernel_tables.is_contiguous()):
        raise ValueError("kernel_tables must be contiguous float32 on the "
                         "planes' device")
    out_re = torch.empty_like(re_t)
    out_im = torch.empty_like(im_t)
    batch = re_t.shape[1]
    if batch == 0:
        return out_re, out_im
    lib = library()
    schedule = kernel_schedule(n)
    radices = (ctypes.c_int * len(schedule))(*schedule)
    cols, threads = launch_geometry(n)
    stream = torch.cuda.current_stream(re_t.device).cuda_stream
    rc = lib.fourier_stockham_c64(
        re_t.data_ptr(), im_t.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        n, batch, cols, threads, len(schedule), radices,
        kernel_tables[0].data_ptr(), kernel_tables[1].data_ptr(),
        int(forward), 1.0 if scale is None else float(scale),
        re_t.device.index, stream,
    )
    if rc != 0:
        msg = lib.fourier_cuda_error_string(rc).decode()
        raise RuntimeError(f"B1 launch failed at n={n}, B={batch}: {msg} ({rc})")
    vpu_fft_batch_minor.launches += 1
    return out_re, out_im


vpu_fft_batch_minor.launches = 0
