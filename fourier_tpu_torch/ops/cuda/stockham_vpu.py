"""Kernels B1-B5: the fused Stockham FFTs over batch-minor planes and the
real transforms built on them.

Port of ``fourier_tpu/ops/pallas/stockham_vpu.py`` (all of its kernels):

* :func:`radix_schedule` is the TPU kernel's schedule, kept as the plan's
  domain predicate (n = 2^a*3^b*5^c with 8 | n and 64 <= n <= 16384, plus
  243, 729, 2187, 6561, 625 and 3125);
* :func:`make_stage_tables` gives its compact (m, r) twiddle tables;
* B1, the fused all-stages transform: :func:`vpu_fft_batch_minor_reference`
  is the plain PyTorch version (a port of ``_stages_value`` plus the mode
  scale), :func:`vpu_fft_batch_minor` the kernel's wrapper. B1 runs the
  clustered-block body of ``csrc/fft_pair.cu`` (its own library) at the 60
  n of :func:`fft_pair_geometry` (clusters of two blocks for 8 | n up to
  2048, of four for 14 n in (2048, 4096]) but those of B1_STAGE_FASTER, and
  the stage body of ``csrc/stockham_vpu.cu`` at the rest of its domain
  (those, 3000, 3240, 4320, the pure powers of 3 and 5, n above 4096);
* B1 on a complex64 tensor where it lies, for the N-D surface's passes
  (``ndim.py``): :func:`vpu_fft_strided_reference` (the axis moved to the
  front of B1's plain version) and the wrapper :func:`vpu_fft_strided`,
  which runs B1's clustered body with an I/O policy of its own
  (``csrc/fft_pair_strided.cu``, its own library) along one axis of the
  interleaved tensor, read and written at its strides, in place or not, at
  the n of :func:`fft_pair_strided_geometry` (B1's clustered sizes but
  B1_STAGE_FASTER and B1_STRIDED_SPILLED). The JAX package has no such
  kernel: it runs planes;
* B2, the fused Bluestein transform: :func:`vpu_bluestein_batch_minor_reference`
  (a port of ``_bluestein_value``) and the wrapper
  :func:`vpu_bluestein_batch_minor`. B2 runs the paired-block body of
  ``csrc/bluestein_pair.cu`` (its own library) at the inner sizes M up to
  2048 of :func:`bluestein_pair_geometry_c64` but those of B2_STAGE_FASTER,
  and the stage body at the others (those, M = 1024 and M above 2048);
* B3, the row leg of the four-step transform:
  :func:`vpu_fft_four_step_row_reference` and the wrapper
  :func:`vpu_fft_four_step_row`. B3 runs the clustered-block body of
  ``csrc/four_step_pair.cu`` (its own library; B1's body with the four-step
  twiddle on the split's read, each tile a column group of one k2, the
  transposed store) at the 56 p of :func:`four_step_pair_geometry` but
  those of B3_STAGE_FASTER, and the stage body at the rest of its domain;
* B4a/B4b, the even-n real transforms (an m-point transform with the
  Hermitian pack or unpack fused in): :func:`vpu_rfft_pack_batch_minor_reference`,
  :func:`vpu_irfft_unpack_batch_minor_reference` and the wrappers
  :func:`vpu_rfft_pack_batch_minor`, :func:`vpu_irfft_unpack_batch_minor`.
  B4a runs the paired-block body of ``csrc/rfft_pack_pair.cu`` (its own
  library) for even m up to 2048 (:func:`rfft_pack_geometry`, with
  :func:`pass_schedule` and :func:`pair_tables`) and B1's stages for the
  other m; B4b runs B4a's body backwards, the paired-block body of
  ``csrc/irfft_unpack_pair.cu`` (its own library; the Hermitian unpack on
  the first inverse pass's read), at the same m but 1728
  (:func:`irfft_unpack_geometry`) and those of B4B_STAGE_FASTER, and B1's
  stages for the other m;
* B5a/B5b, the odd-n real transforms (B2's chirp-z with the two-for-one
  separation or recombination fused in):
  :func:`vpu_rfft_odd_pack_batch_minor_reference`,
  :func:`vpu_irfft_odd_unpack_batch_minor_reference` and the wrappers
  :func:`vpu_rfft_odd_pack_batch_minor`,
  :func:`vpu_irfft_odd_unpack_batch_minor`. Column j pairs with column
  j + ceil(B/2); an unpaired last column runs against zeros. B5a runs the
  paired-block body of ``csrc/rfft_odd_pair.cu`` (its own library; B2's
  body with the pairing on its copies and the separation on its store) at
  B2's inner sizes (:func:`rfft_odd_pack_geometry`) but those of
  B5A_STAGE_FASTER, and the stage body at the others; B5b runs the
  paired-block body of ``csrc/irfft_odd_pair.cu`` (its own library; B2's
  body with the pairing and the Hermitian tail on its first read) at B2's
  inner sizes (:func:`irfft_odd_unpack_geometry`) but those of
  B5B_STAGE_FASTER, and the stage body at the others.

The stage bodies are one library, built from ``csrc/stockham_vpu.cu``; the
clustered-block bodies of B1 (on planes and on complex64 where it lies),
B2, B3, B4a, B4b, B5a and B5b (``csrc/stockham_pair.cuh``) are a library
each, built from ``csrc/fft_pair.cu``, ``csrc/fft_pair_strided.cu``,
``csrc/bluestein_pair.cu``, ``csrc/four_step_pair.cu``,
``csrc/rfft_pack_pair.cu``, ``csrc/irfft_unpack_pair.cu``,
``csrc/rfft_odd_pair.cu`` and ``csrc/irfft_odd_pair.cu``.

Each wrapper runs its plain version for tensors on the CPU, and launches its
kernel (or raises) for tensors on a CUDA device, through
:func:`~fourier_tpu_torch.ops.cuda.build.launch`, which counts
``launches.fourier_tpu_torch::<name>`` in ``fourier_tpu_torch.trace``'s
registry. Each launch is a registered operator
(``torch.library.custom_op``, ``fourier_tpu_torch::<name>``, with a fake
implementation that gives the outputs' shapes), so that ``torch.export``
keeps it in the graph of a plan on the card. The operator chooses the body
and its launch from the kernel and the size alone, by
:func:`clustered_geometry` over the table :data:`BODIES`. The clustered
bodies read the tables
of :func:`pair_tables`, which the plans build at plan time and pass in
(``pair_tables=``); no wrapper computes a twiddle.

The stage bodies run their own schedule, :func:`kernel_schedule`, which
splits each radix of :func:`radix_schedule` into radices 8, 4, 2, 3 and 5,
with twiddles from :func:`make_kernel_tables`; the clustered bodies run the
passes of :func:`pass_schedule` with the tables of :func:`pair_tables`. The
source notes in the .cu files give the designs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from fourier_tpu_torch import trace
from fourier_tpu_torch.ops import cplx, hermitian
from fourier_tpu_torch.ops.butterflies import BUTTERFLIES
from fourier_tpu_torch.ops.cuda import build
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
# The clustered-block bodies (B1, B2, B4a here, B7 in stockham_vpu_dd.py;
# csrc/stockham_pair.cuh): a tile's row runs are at least PAIR_RUN_BYTES,
# because on an H100 a copy-only persistent kernel moved a (2048, 32768) f32
# plane in 0.663 ms through 16-byte runs and in 0.272 ms through 32-byte
# ones; a thread holds PAIR_POINTS points a pass.
PAIR_RUN_BYTES = 32
PAIR_POINTS = 16
# The float clustered-block bodies (B1, B2, B4a): 512 threads a block, one
# compiled body per block height h in PAIR_ROWS, the h = m/2 of each even m
# of B1's domain up to 2048 (FOURIER_PAIR_ROWS in csrc/stockham_pair.cuh).
PAIR_THREADS = 512
PAIR_MAX_M = 2048


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


PAIR_ROWS = tuple(m // 2 for m in range(2, PAIR_MAX_M + 1, 2) if radix_schedule(m))
# The block heights of B1's bodies (and B6's at double), by the blocks of a
# cluster: PAIR_ROWS on two, its h above 512 on four (FOURIER_B1_QUAD_ROWS
# in csrc/stockham_pair.cuh); and of B2's and B5a's (FOURIER_B2_ROWS there):
# PAIR_ROWS but 512 (M = 1024), where ptxas spilled in every arrangement of
# B2's body tried, so the stage body stays the kernel there.
FFT_PAIR_ROWS = {2: PAIR_ROWS, 4: tuple(h for h in PAIR_ROWS if h > 512)}
BLUESTEIN_PAIR_ROWS = tuple(h for h in PAIR_ROWS if h != 512)
# B5a's (FOURIER_B5A_ROWS in csrc/rfft_odd_pair.cu): B2's but 240 (M = 480),
# where its body spilled in every arrangement of its store tried.
RFFT_ODD_PAIR_ROWS = tuple(h for h in BLUESTEIN_PAIR_ROWS if h != 240)
# B5b's (FOURIER_B5B_ROWS in csrc/irfft_odd_pair.cu): B2's. B4b's
# (FOURIER_B4B_ROWS in csrc/irfft_unpack_pair.cu): B4a's but 864 (m = 1728),
# where its body spilled in every arrangement tried.
IRFFT_ODD_PAIR_ROWS = BLUESTEIN_PAIR_ROWS
IRFFT_UNPACK_PAIR_ROWS = tuple(h for h in PAIR_ROWS if h != 864)
# Sizes with a clustered body that lost to the stage body in a same-run A/B
# over every such size (chip_smoke.py phase 5g, about 2^26 points a call, on
# an H100 80GB HBM3 at 700 W; a size whose winner changed between runs went
# to the body that won two of three): there the wrapper launches the stage
# body.
# B1 at n, B2 and B5a at the inner size M; mostly small non-power-of-two
# heights, whose tile is one 32-byte column group and leaves most threads
# idle, and for B5a mixed-radix heights, whose store takes two steps (1600
# among the rfft routes' M).
B1_STAGE_FASTER = frozenset({576, 648, 800, 960, 1000})
# The heights h = n/C at which ptxas spilled B1's body on a complex64
# tensor where it lies (csrc/fft_pair_strided.cu) on both cluster sizes, at
# 512 threads: n = 1440, 1600, 1728, 2880, 3200 and 3456 keep the planes.
B1_STRIDED_SPILLED = frozenset({720, 800, 864})
B2_STAGE_FASTER = frozenset({64, 72, 120, 320, 576, 600, 640, 648, 800, 960, 1000})
B5A_STAGE_FASTER = frozenset({64, 72, 120, 200, 320, 576, 600, 640, 648, 800, 864,
                              960, 1000, 1080, 1600})
# B4b at m and B5b at M (two runs that agreed at every size): none of the
# rfft routes' B5b sizes (M 1600..2048) and, of their B4b sizes, m = 1000.
B4B_STAGE_FASTER = frozenset({72, 320, 576, 600, 640, 648, 768, 800, 960, 1000})
B5B_STAGE_FASTER = frozenset({64, 72, 120, 200, 320, 576, 600, 648, 800, 864, 960, 1000})
# B3 at the row size p (phase 5g's sweep at q = 256, at B = 2^26 / (256 p)
# rounded down to a multiple of 4 and at that B - 1; two runs that agreed):
# the p where the stage body won at the odd batch, which at B a multiple
# of 4 lose or tie too (320 and 640 within 3%); no other p loses by more
# than 0.3% at either (64, 72, 768, 864 and 2592 tie). The mixed-radix
# heights of B1_STAGE_FASTER, and none of the routes' p (128, 256, 512).
B3_STAGE_FASTER = frozenset({320, 576, 600, 640, 648, 800, 1000})
# B3's clustered bodies (csrc/four_step_pair.cu), by blocks a cluster: the
# heights h = p/C of B1's bodies at which each design of the four-step
# twiddle is built, one design a height. Design (a), the twiddle in the
# split read (FOURIER_B3_SPLIT_ROWS), at every height where it compiled
# with no spill at 512 threads; design (b), a pass of its own over each
# rank's rows (FOURIER_B3_PASS_ROWS), at 7 of the 11 where (a) spilled.
# Both spilled at 2 x 480, 2 x 640, 4 x 640 and 4 x 960, which keep the
# stage body.
B3_SPLIT_ROWS = {2: tuple(h for h in FFT_PAIR_ROWS[2] if h not in (32, 60, 120, 480, 640, 720)),
                 4: tuple(h for h in FFT_PAIR_ROWS[4] if h not in (640, 900, 960, 972, 1000))}
B3_PASS_ROWS = {2: (32, 60, 120, 720), 4: (900, 972, 1000)}

def _stage_sizes(n: int, schedule: Sequence[int]):
    """(size, radix) of every stage but the last (which has no twiddles)."""
    out, size = [], n
    for r in schedule[:-1]:
        out.append((size, r))
        size //= r
    return out


def stage_tables(n: int, schedule: Sequence[int], forward: bool,
                 real=np.float64) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Compact planar (m, r) twiddle tables of a stage schedule, one per
    stage but the last: entry (i, k) = W_size^(i*k), computed in f64 and
    cast to `real`."""
    tables = []
    for size, r in _stage_sizes(n, schedule):
        tw = stage_twiddles(size, r, forward)
        tables.append((tw.real.astype(real), tw.imag.astype(real)))
    return tables


def make_stage_tables(n: int, forward: bool) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Compact planar f32 (m, r) twiddle tables of :func:`radix_schedule`."""
    return stage_tables(n, radix_schedule(n), forward, np.float32)


def split_schedule(schedule: Sequence[int]) -> Tuple[int, ...]:
    """A CUDA kernel's stages: each radix of a TPU schedule split greedily
    into 8, 4, 2, 3 and 5 (64 -> 8, 8; 81 -> 3, 3, 3, 3; 125 -> 5, 5, 5)."""
    out = []
    for r in schedule:
        for k in KERNEL_RADICES:
            while r % k == 0:
                out.append(k)
                r //= k
    return tuple(out)


@functools.lru_cache(maxsize=None)
def kernel_schedule(n: int) -> Tuple[int, ...]:
    """B1's stages: :func:`radix_schedule` split by :func:`split_schedule`."""
    return split_schedule(radix_schedule(n))


def kernel_tables(n: int, schedule: Sequence[int], forward: bool,
                  real=np.float64) -> np.ndarray:
    """A kernel's twiddles: the (size // r, r) tables of every stage of its
    `schedule` but the last, flattened row-major and concatenated, as a
    planar (2, L) array of `real`, computed in f64."""
    parts = [stage_twiddles(size, r, forward).ravel()
             for size, r in _stage_sizes(n, schedule)]
    tw = np.concatenate(parts)
    return np.stack([tw.real, tw.imag]).astype(real)


def make_kernel_tables(n: int, forward: bool) -> np.ndarray:
    """B1's twiddles, :func:`kernel_tables` of :func:`kernel_schedule` in
    f32."""
    return kernel_tables(n, kernel_schedule(n), forward, np.float32)


def launch_geometry(n: int) -> Tuple[int, int]:
    """(columns per block, threads per block) of the kernel at size n."""
    cols = max(1, min(MAX_COLS, BLOCK_POINTS // n),
               min(RUN_COLS, MAX_BLOCK_POINTS // n))
    points = n * cols
    threads = -(-points // POINTS_PER_THREAD)
    threads = -(-threads // 32) * 32
    return cols, threads


class PairGeometry(NamedTuple):
    """A clustered-block body's launch: each block of a cluster of `ranks`
    blocks holds `rows` = M/ranks rows of `cols` columns (whole
    `PAIR_RUN_BYTES` groups) in each of two buffers, `smem` bytes in all,
    with `threads` threads."""
    rows: int
    cols: int
    threads: int
    smem: int
    ranks: int = 2


def pass_schedule(h: int) -> Tuple[int, ...]:
    """The radices of a paired-block body's h-point passes (pair_radix in
    csrc/stockham_pair.cuh), h = 2^(4q + r) * 3^b * 5^c. A power of two
    takes q passes of 16 and one of 2^r: 1024 -> (16, 16, 4), 512 ->
    (16, 16, 2). Otherwise the 3s and 5s come first, then 2^r and q 16s, or
    8, 8 and q - 1 16s where r = 2: 96 -> (3, 2, 16), 960 -> (3, 5, 8, 8)
    (the orders that ptxas compiles without spills at 512 threads)."""
    rest = h
    a = 0
    while rest % 2 == 0:
        rest //= 2
        a += 1
    threes = fives = 0
    while rest % 3 == 0:
        rest //= 3
        threes += 1
    while rest % 5 == 0:
        rest //= 5
        fives += 1
    if rest != 1:
        raise ValueError(f"{h} is not 2^a * 3^b * 5^c")
    q, r = divmod(a, 4)
    if threes + fives == 0:
        return tuple([16] * q + ([2 ** r] if r else []))
    pows = [8, 8] + [16] * (q - 1) if r == 2 and q else ([2 ** r] if r else []) + [16] * q
    return tuple([3] * threes + [5] * fives + pows)


def pair_tables(m: int, forward: bool, real=np.float64, ranks: int = 2) -> np.ndarray:
    """A clustered-block body's twiddles for an m-point transform on
    clusters of `ranks` blocks, h = m/ranks, a planar (2, (ranks-1)*h + L)
    array of `real` computed in f64: the cross-block split's W_m^(r*p) for
    r = 1..ranks-1 (rank-major) and p < h, then the (size // r, r) tables of
    every pass of :func:`pass_schedule` (h) but the last."""
    h = m // ranks
    split = stage_twiddles(m, ranks, forward)[:, 1:].T.ravel()
    rest = kernel_tables(h, pass_schedule(h), forward, np.float64)
    return np.concatenate([np.stack([split.real, split.imag]), rest],
                          axis=1).astype(real)


def pair_table_length(m: int, ranks: int = 2) -> int:
    """Entries of each plane of :func:`pair_tables` (m, ranks): the split's
    (ranks-1)*h and every pass's size but the last's (h = m/ranks)."""
    h = m // ranks
    return (ranks - 1) * h + sum(size for size, _ in _stage_sizes(h, pass_schedule(h)))


def check_pair_tables(device, m: int, ranks: int, *tables, dtype=torch.float32):
    """The plan's clustered-body tables: each the (2, L) :func:`pair_tables`
    of (m, ranks), of `dtype` on `device`; a body whose plan holds none is
    refused."""
    for t in tables:
        if t is None:
            raise ValueError(f"the clustered-block body at m={m} needs the plan's "
                             "pair tables (pair_tables=)")
        if tuple(t.shape) != (2, pair_table_length(m, ranks)):
            raise ValueError(f"pair tables of shape {tuple(t.shape)} are not those of "
                             f"m={m} on clusters of {ranks} blocks")
    check_tables(device, *tables, dtype=dtype)


def pair_geometry(m: int, itemsize: int, threads: int, ranks: int = 2) -> PairGeometry:
    """The tile of a clustered-block body at size m on clusters of `ranks`
    blocks (pair_cols in csrc/stockham_pair.cuh): m/ranks rows and the
    widest power-of-two number of PAIR_RUN_BYTES column groups whose points
    `threads` threads cover at PAIR_POINTS each, one group rather than two
    where m/ranks is not a power of two."""
    h = m // ranks
    cols = PAIR_RUN_BYTES // itemsize
    while h * cols * 2 <= PAIR_POINTS * threads:
        cols *= 2
    if cols * itemsize == 2 * PAIR_RUN_BYTES and h & (h - 1):
        cols //= 2
    return PairGeometry(h, cols, threads, 4 * h * cols * itemsize, ranks)


def rfft_pack_geometry(m: int) -> Optional[PairGeometry]:
    """B4a's paired-block launch at m (PAIR_THREADS threads), or None where
    the stage body stays the kernel: odd m, and m above PAIR_MAX_M, whose
    tile of 32-byte runs needs more than PAIR_THREADS threads at PAIR_POINTS
    each (and 1024 threads leave a thread 64 registers)."""
    if m % 2 or m > PAIR_MAX_M or radix_schedule(m) is None:
        return None
    return pair_geometry(m, 4, PAIR_THREADS)


def fft_pair_geometry(n: int) -> Optional[PairGeometry]:
    """B1's clustered-block launch at n (PAIR_THREADS threads), or None where
    the stage body stays the kernel: two blocks of n/2 rows for 8 | n up to
    2048, else four blocks of n/4 rows for the n in (2048, 4096] whose n/4
    is in PAIR_ROWS (FFT_PAIR_ROWS); not 3000, 3240, 4320, the pure powers
    of 3 and 5, or n above 4096."""
    for ranks in (2, 4):
        if n % ranks == 0 and n // ranks in FFT_PAIR_ROWS[ranks]:
            return pair_geometry(n, 4, PAIR_THREADS, ranks)
    return None


def fft_pair_strided_geometry(n: int) -> Optional[PairGeometry]:
    """The launch of B1's clustered body on a complex64 tensor where it lies
    (``csrc/fft_pair_strided.cu``) at n: B1's (:func:`fft_pair_geometry`),
    or None where B1 launches its stage body (:func:`clustered_geometry`),
    which has no such form, and at the heights of B1_STRIDED_SPILLED."""
    geo = clustered_geometry("B1", n)
    return None if geo is None or geo.rows in B1_STRIDED_SPILLED else geo


def four_step_pair_geometry(p: int) -> Optional[PairGeometry]:
    """B3's clustered-block launch at row size p, B1's tile
    (:func:`fft_pair_geometry`): clusters of two or four blocks of p/C rows,
    a tile one group of `cols` columns of the (p, B) plane of one k2, or
    None where the stage body stays the kernel (p above 4096, 3000, 3240,
    4320, the pure powers of 3 and 5, and 960, 1280, 2560 and 3840, where
    both designs spilled). The body's design is its height's: the twiddle in
    a pass of its own where p/C is in B3_PASS_ROWS, else in the split read."""
    geo = fft_pair_geometry(p)
    if geo is None:
        return None
    built = B3_SPLIT_ROWS[geo.ranks] + B3_PASS_ROWS[geo.ranks]
    return geo if geo.rows in built else None


def bluestein_pair_geometry_c64(m: int) -> Optional[PairGeometry]:
    """B2's paired-block launch at inner size m (two blocks of m/2 rows,
    PAIR_THREADS threads), or None where the stage body stays the kernel:
    M = 1024 and M above PAIR_MAX_M (BLUESTEIN_PAIR_ROWS)."""
    if m % 2 or m // 2 not in BLUESTEIN_PAIR_ROWS:
        return None
    return pair_geometry(m, 4, PAIR_THREADS)


def rfft_odd_pack_geometry(m: int) -> Optional[PairGeometry]:
    """B5a's paired-block launch at inner size m, B2's tile
    (:func:`bluestein_pair_geometry_c64`): two blocks of m/2 rows, each of
    `cols` column pairs (column j in the re plane, j + ceil(B/2) in the im
    plane), or None where the stage body stays the kernel: M = 480, 1024
    and above PAIR_MAX_M (RFFT_ODD_PAIR_ROWS)."""
    if m % 2 or m // 2 not in RFFT_ODD_PAIR_ROWS:
        return None
    return pair_geometry(m, 4, PAIR_THREADS)


def irfft_unpack_geometry(m: int) -> Optional[PairGeometry]:
    """B4b's paired-block launch at m, B4a's tile (:func:`rfft_pack_geometry`):
    two blocks of m/2 spectrum rows, or None where the stage body stays the
    kernel: odd m, m = 1728 and m above PAIR_MAX_M (IRFFT_UNPACK_PAIR_ROWS)."""
    if m % 2 or m // 2 not in IRFFT_UNPACK_PAIR_ROWS:
        return None
    return pair_geometry(m, 4, PAIR_THREADS)


def irfft_odd_unpack_geometry(m: int) -> Optional[PairGeometry]:
    """B5b's paired-block launch at inner size m, B2's tile
    (:func:`bluestein_pair_geometry_c64`): two blocks of m/2 rows, each of
    `cols` column pairs (column j's bins on rank 0, j + ceil(B/2)'s on rank
    1), or None where the stage body stays the kernel: M = 1024 and above
    PAIR_MAX_M (IRFFT_ODD_PAIR_ROWS)."""
    if m % 2 or m // 2 not in IRFFT_ODD_PAIR_ROWS:
        return None
    return pair_geometry(m, 4, PAIR_THREADS)


# The body a kernel of two bodies runs at a size, and where that is chosen:
# its clustered- or paired-block body where the body's geometry gives one
# and the size is not in the kernel's stage-faster set, else its stage body.
# Keyed by kernel: (the clustered body's geometry at a size, or None; the
# sizes where the stage body won). B6's entry is added by stockham_vpu_dd;
# B9b's rule is two_phase_body of bailey. An A/B that forces a body swaps
# the kernel's set here, in-process.
BODIES = {
    "B1": (fft_pair_geometry, B1_STAGE_FASTER),
    "B2": (bluestein_pair_geometry_c64, B2_STAGE_FASTER),
    "B3": (four_step_pair_geometry, B3_STAGE_FASTER),
    "B4a": (rfft_pack_geometry, frozenset()),
    "B4b": (irfft_unpack_geometry, B4B_STAGE_FASTER),
    "B5a": (rfft_odd_pack_geometry, B5A_STAGE_FASTER),
    "B5b": (irfft_odd_unpack_geometry, B5B_STAGE_FASTER),
}


def clustered_geometry(kernel: str, size: int) -> Optional[PairGeometry]:
    """The launch of the clustered- or paired-block body of `kernel` of
    :data:`BODIES` at `size` (n for B1 and B6, m for B4a and B4b, the inner
    M for B2, B5a and B5b, the row size p for B3) where the kernel runs that
    body, else None: there it runs its stage body."""
    geometry, stage_faster = BODIES[kernel]
    return None if size in stage_faster else geometry(size)


def kernel_body(kernel: str, size: int) -> str:
    """The body `kernel` runs at `size`: "pair" where
    :func:`clustered_geometry` gives a launch, else "stage"."""
    return "stage" if clustered_geometry(kernel, size) is None else "pair"


def stages_reference(re_t, im_t, schedule: Sequence[int], tables,
                     forward: bool, scale: Optional[float]):
    """The stages of a TPU `schedule` over (n, B) planes with its compact
    `tables` (:func:`stage_tables`), then the mode scale: the plain version
    of every fused stage kernel. Port of ``stockham_vpu._stages_value``."""
    n = re_t.shape[0]
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


def vpu_fft_batch_minor_reference(re_t, im_t, n: int, tables, forward: bool,
                                  scale: Optional[float]):
    """Plain PyTorch B1: :func:`stages_reference` over the stages of
    :func:`radix_schedule` with the compact `tables` of
    :func:`make_stage_tables`."""
    return stages_reference(re_t, im_t, radix_schedule(n), tables, forward,
                            scale)


def check_planes(re_t, im_t, lead, what: str, dtype=torch.float32):
    """Contiguous planes of `dtype` and equal shape, leading dims `lead`; on
    the CPU or a CUDA device (the wrapper raises on any other)."""
    for t in (re_t, im_t):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what} takes torch tensors")
        if t.dtype != dtype:
            raise TypeError(f"{what} takes {dtype} planes, got {t.dtype}")
        if t.ndim != len(lead) + 1 or tuple(t.shape[:-1]) != tuple(lead):
            raise ValueError(f"{what} takes ({', '.join(map(str, lead))}, B) "
                             f"planes, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous planes")
    if re_t.shape != im_t.shape or re_t.device != im_t.device:
        raise ValueError("re/im planes differ in shape or device")
    if re_t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CPU or CUDA tensors, not {re_t.device}")


def check_tables(device, *tables, dtype=torch.float32):
    for t in tables:
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"kernel tables must be contiguous {dtype} on the "
                             "planes' device")


LIBRARY = "stockham_vpu"  # csrc/stockham_vpu.cu
PAIR_LIBRARY = "rfft_pack_pair"  # csrc/rfft_pack_pair.cu: B4a's paired body
# The library's C entry points and their argument types.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRY_POINTS = {
    "fourier_stockham_c64": [_P] * 4 + [_I] * 5 + [_P] * 3 + [_I, _F, _I, _P],
    "fourier_bluestein_c64": [_P] * 4 + [_I] * 6 + [_P] * 11 + [_F, _I, _P],
    "fourier_four_step_row_c64": [_P] * 4 + [_I] * 6 + [_P] * 5 + [_I, _F, _I, _P],
    "fourier_rfft_pack_c64": [_P] * 3 + [_I] * 5 + [_P] * 5 + [_I, _P],
    "fourier_irfft_unpack_c64": [_P] * 3 + [_I] * 5 + [_P] * 5 + [_F, _I, _P],
    "fourier_rfft_odd_pack_c64": [_P] * 3 + [_I] * 6 + [_P] * 11 + [_I, _P],
    "fourier_irfft_odd_unpack_c64": [_P] * 3 + [_I] * 6 + [_P] * 11 + [_F, _I, _P],
}


PAIR_ENTRY_POINTS = {
    "fourier_rfft_pack_pair_c64": [_P] * 3 + [_I] * 5 + [_P] * 5 + [_I, _P],
}
FFT_PAIR_LIBRARY = "fft_pair"  # csrc/fft_pair.cu: B1's clustered bodies
FFT_PAIR_ENTRY_POINTS = {
    "fourier_stockham_pair_c64": [_P] * 4 + [_I] * 6 + [_P] * 3 + [_I, _F, _I, _P],
    "fourier_stockham_pair_clusters": [_I] * 4 + [ctypes.POINTER(_I)],
}
BLUESTEIN_PAIR_LIBRARY = "bluestein_pair"  # csrc/bluestein_pair.cu: B2's
BLUESTEIN_PAIR_ENTRY_POINTS = {
    "fourier_bluestein_pair_c64": [_P] * 4 + [_I] * 6 + [_P] * 11 + [_F, _I, _P],
}
RFFT_ODD_PAIR_LIBRARY = "rfft_odd_pair"  # csrc/rfft_odd_pair.cu: B5a's
RFFT_ODD_PAIR_ENTRY_POINTS = {
    "fourier_rfft_odd_pack_pair_c64": [_P] * 3 + [_I] * 6 + [_P] * 11 + [_I, _P],
}
IRFFT_UNPACK_PAIR_LIBRARY = "irfft_unpack_pair"  # csrc/irfft_unpack_pair.cu: B4b's
IRFFT_UNPACK_PAIR_ENTRY_POINTS = {
    "fourier_irfft_unpack_pair_c64": [_P] * 3 + [_I] * 5 + [_P] * 5 + [_F, _I, _P],
}
FOUR_STEP_PAIR_LIBRARY = "four_step_pair"  # csrc/four_step_pair.cu: B3's
FOUR_STEP_PAIR_ENTRY_POINTS = {
    "fourier_four_step_pair_c64": [_P] * 4 + [_I] * 7 + [_P] * 5 + [_I, _F, _I, _P],
    "fourier_four_step_pair_clusters": [_I] * 4 + [ctypes.POINTER(_I)],
}
IRFFT_ODD_PAIR_LIBRARY = "irfft_odd_pair"  # csrc/irfft_odd_pair.cu: B5b's
IRFFT_ODD_PAIR_ENTRY_POINTS = {
    "fourier_irfft_odd_unpack_pair_c64": [_P] * 3 + [_I] * 6 + [_P] * 11 + [_F, _I, _P],
}
# csrc/fft_pair_strided.cu: B1's clustered bodies on complex64 where it lies
FFT_PAIR_STRIDED_LIBRARY = "fft_pair_strided"
FFT_PAIR_STRIDED_ENTRY_POINTS = {
    "fourier_fft_pair_strided_c64": [_P] * 2 + [_I] * 7 + [_P] * 3 + [_I, _F, _I, _P],
}


def library():
    """Build (at first use) and load the kernel library."""
    return build.bind(LIBRARY, ENTRY_POINTS)


def pair_library():
    """Build (at first use) and load B4a's paired-block library."""
    return build.bind(PAIR_LIBRARY, PAIR_ENTRY_POINTS)


def fft_pair_library():
    """Build (at first use) and load B1's clustered-block library."""
    return build.bind(FFT_PAIR_LIBRARY, FFT_PAIR_ENTRY_POINTS)


def bluestein_pair_library():
    """Build (at first use) and load B2's paired-block library."""
    return build.bind(BLUESTEIN_PAIR_LIBRARY, BLUESTEIN_PAIR_ENTRY_POINTS)


def rfft_odd_pair_library():
    """Build (at first use) and load B5a's paired-block library."""
    return build.bind(RFFT_ODD_PAIR_LIBRARY, RFFT_ODD_PAIR_ENTRY_POINTS)


def irfft_unpack_pair_library():
    """Build (at first use) and load B4b's paired-block library."""
    return build.bind(IRFFT_UNPACK_PAIR_LIBRARY, IRFFT_UNPACK_PAIR_ENTRY_POINTS)


def four_step_pair_library():
    """Build (at first use) and load B3's clustered-block library."""
    return build.bind(FOUR_STEP_PAIR_LIBRARY, FOUR_STEP_PAIR_ENTRY_POINTS)


def irfft_odd_pair_library():
    """Build (at first use) and load B5b's paired-block library."""
    return build.bind(IRFFT_ODD_PAIR_LIBRARY, IRFFT_ODD_PAIR_ENTRY_POINTS)


def fft_pair_strided_library():
    """Build (at first use) and load the library of B1's clustered bodies on
    complex64 tensors where they lie."""
    return build.bind(FFT_PAIR_STRIDED_LIBRARY, FFT_PAIR_STRIDED_ENTRY_POINTS)


def fft_pair_clusters(n: int, device) -> int:
    """The clusters of B1's clustered body at n that the card keeps at once
    (cudaOccupancyMaxActiveClusters), the grid of its persistent walk."""
    geo = fft_pair_geometry(n)
    if geo is None:
        raise ValueError(f"B1 has no clustered-block body at n={n}")
    out = ctypes.c_int(0)
    build.call(fft_pair_library(), "fourier_stockham_pair_clusters",
               f"B1's cluster count at n={n}", n, geo.ranks, geo.cols,
               torch.device(device).index or 0, ctypes.byref(out))
    return out.value


def four_step_pair_clusters(p: int, device) -> int:
    """The clusters of B3's clustered body at row size p that the card
    keeps at once (cudaOccupancyMaxActiveClusters),
    the grid of its persistent walk."""
    geo = four_step_pair_geometry(p)
    if geo is None:
        raise ValueError(f"B3 has no clustered-block body at p={p}")
    out = ctypes.c_int(0)
    build.call(four_step_pair_library(), "fourier_four_step_pair_clusters",
               f"B3's cluster count at p={p}", p, geo.ranks, geo.cols,
               torch.device(device).index or 0, ctypes.byref(out))
    return out.value


def count_split_bytes(ranks: int, n: int, batch: int, itemsize: int) -> None:
    """Count ``split.cluster_bytes``: the bytes the push split of a
    clustered ``fft_pair`` body (B1, B3, B6) sends from one block of its
    cluster to another in a launch over `batch` columns of n points,
    (ranks-1)/ranks of both planes (the columns below B; a ragged last tile
    sends its columns past B too)."""
    trace.count("split.cluster_bytes", (ranks - 1) * 2 * n * batch * itemsize // ranks)


def _launch(op: str, fn_name: str, what: str, *args) -> None:
    """Launch the operator `op` through the stage library's C entry point
    `fn_name`; raise if it fails."""
    build.launch(op, library(), fn_name, what, *args)


def radices_arg(schedule: Sequence[int]):
    """(count, C int array) of a kernel schedule, as the entry points take
    it."""
    return len(schedule), (ctypes.c_int * len(schedule))(*schedule)


def _radices(n: int):
    return radices_arg(kernel_schedule(n))


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def scale_arg(scale: Optional[float]) -> float:
    return 1.0 if scale is None else float(scale)


def vpu_fft_batch_minor(re_t, im_t, n: int, forward: bool,
                        scale: Optional[float], *, tables, kernel_tables,
                        pair_tables=None):
    """B1 over contiguous planar f32 (n, B) planes; returns new planes.

    `tables`: the compact stage tables of :func:`make_stage_tables` as
    tensors (plain version); `kernel_tables`: the (2, L) f32 tensor of
    :func:`make_kernel_tables` (the stage body), both direction-matched;
    `pair_tables`: the forward (2, L) f32 :func:`pair_tables` of n on the
    body's clusters (the clustered body reads it in both directions), None
    where n has no clustered body; all on the planes' device. The kernel is
    the clustered-block body of ``csrc/fft_pair.cu`` where
    :func:`kernel_body` says so, else the stage body. On a card the launch
    is the operator ``fourier_tpu_torch::vpu_fft``.
    """
    check_planes(re_t, im_t, (n,), "B1")
    if re_t.device.type == "cpu":
        return vpu_fft_batch_minor_reference(re_t, im_t, n, tables, forward,
                                             scale)
    check_tables(re_t.device, kernel_tables)
    return _vpu_fft_op(re_t, im_t, n, forward, scale, kernel_tables, pair_tables)


@torch.library.custom_op("fourier_tpu_torch::vpu_fft", mutates_args=(),
                         device_types="cuda")
def _vpu_fft_op(re_t: Tensor, im_t: Tensor, n: int, forward: bool,
                scale: Optional[float], kernel_tables: Tensor,
                pair_tables: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """B1's launch (see :func:`vpu_fft_batch_minor`)."""
    out_re = torch.empty_like(re_t)
    out_im = torch.empty_like(im_t)
    batch = re_t.shape[1]
    if batch == 0:
        return out_re, out_im
    data = (re_t.data_ptr(), im_t.data_ptr(), out_re.data_ptr(), out_im.data_ptr())
    geo = clustered_geometry("B1", n)
    if geo is not None:
        check_pair_tables(re_t.device, n, geo.ranks, pair_tables)
        count_split_bytes(geo.ranks, n, batch, 4)
        build.launch(
            "fourier_tpu_torch::vpu_fft",
            fft_pair_library(), "fourier_stockham_pair_c64",
            f"B1 ({geo.ranks}-block clusters) at n={n}, B={batch}", *data,
            n, batch, geo.ranks, geo.cols, geo.threads,
            *radices_arg(pass_schedule(geo.rows)),
            pair_tables[0].data_ptr(), pair_tables[1].data_ptr(), int(forward),
            scale_arg(scale), re_t.device.index, stream_of(re_t),
        )
    else:
        cols, threads = launch_geometry(n)
        _launch(
            "fourier_tpu_torch::vpu_fft",
            "fourier_stockham_c64", f"B1 at n={n}, B={batch}", *data,
            n, batch, cols, threads, *_radices(n),
            kernel_tables[0].data_ptr(), kernel_tables[1].data_ptr(),
            int(forward), scale_arg(scale), re_t.device.index, stream_of(re_t),
        )
    return out_re, out_im


@_vpu_fft_op.register_fake
def _(re_t, im_t, *_):
    return torch.empty_like(re_t), torch.empty_like(im_t)


def vpu_fft_strided_reference(x, axis: int, n: int, tables, forward: bool,
                              scale: Optional[float]):
    """Plain PyTorch of B1 along `axis` of a complex64 tensor: the axis moved
    to the front of (n, rest) planes, :func:`vpu_fft_batch_minor_reference`,
    and the result moved back (a new contiguous tensor)."""
    t = x.movedim(axis, 0)
    re, im = vpu_fft_batch_minor_reference(t.real.reshape(n, -1), t.imag.reshape(n, -1),
                                           n, tables, forward, scale)
    return torch.complex(re, im).reshape(t.shape).movedim(0, axis).contiguous()


def vpu_fft_strided(x, axis: int, n: int, forward: bool, scale: Optional[float], *,
                    tables, pair_tables=None, out=None):
    """B1 along `axis` of the contiguous complex64 tensor `x`, read and
    written where it lies: the tensor viewed as (outer, n, inner) around the
    axis, no plane copied, the scale applied in the pass. Returns `out`: a
    new contiguous tensor where None, else `out`, a contiguous complex64
    tensor of x's shape on its device, which may be `x` itself (the pass then
    runs in place) but may not overlap it otherwise.

    `tables`: the compact stage tables of :func:`make_stage_tables` (the
    plain version); `pair_tables`: the forward (2, L) f32 :func:`pair_tables`
    of n on B1's clusters, which the body reads in both directions. n must
    have a body (:func:`fft_pair_strided_geometry`). On a card the launch is
    the operator ``fourier_tpu_torch::vpu_fft_strided``
    (``csrc/fft_pair_strided.cu``); on the CPU the plain version
    (:func:`vpu_fft_strided_reference`) runs.
    """
    if not isinstance(x, torch.Tensor) or x.dtype != torch.complex64:
        raise TypeError("B1 on a tensor where it lies takes a complex64 tensor")
    if not x.is_contiguous():
        raise ValueError("B1 on a tensor where it lies takes a contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"B1 runs on CPU or CUDA tensors, not {x.device}")
    axis = axis % x.ndim if x.ndim else 0
    if x.ndim == 0 or x.shape[axis] != n:
        raise ValueError(f"axis {axis} of a tensor of shape {tuple(x.shape)} is not "
                         f"of length n={n}")
    if fft_pair_strided_geometry(n) is None:
        raise ValueError(f"B1 has no clustered-block body on a tensor where it lies "
                         f"at n={n}")
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    elif out is not x:
        if (out.dtype != x.dtype or out.shape != x.shape or out.device != x.device
                or not out.is_contiguous()):
            raise ValueError("out must be a contiguous complex64 tensor of x's shape "
                             "on x's device")
        if out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
            raise ValueError("out shares x's storage without being x")
    if x.device.type == "cpu":
        return out.copy_(vpu_fft_strided_reference(x, axis, n, tables, forward, scale))
    _vpu_fft_strided_op(out, None if out is x else x, axis, n, forward, scale, pair_tables)
    return out


@torch.library.custom_op("fourier_tpu_torch::vpu_fft_strided", mutates_args=("y",),
                         device_types="cuda")
def _vpu_fft_strided_op(y: Tensor, x: Optional[Tensor], axis: int, n: int, forward: bool,
                        scale: Optional[float], pair_tables: Optional[Tensor]) -> None:
    """B1's launch on a tensor where it lies (see :func:`vpu_fft_strided`):
    `x` into `y`, or `y` in place where `x` is None."""
    src = y if x is None else x
    if y.numel() == 0:
        return
    geo = fft_pair_strided_geometry(n)
    check_pair_tables(y.device, n, geo.ranks, pair_tables)
    outer = math.prod(y.shape[:axis])
    inner = math.prod(y.shape[axis + 1:])
    if max(outer, inner) > 0x7fffffff:
        raise ValueError(f"B1 on a tensor where it lies takes at most 2^31 - 1 "
                         f"transforms a side, got ({outer}, {n}, {inner})")
    build.launch(
        "fourier_tpu_torch::vpu_fft_strided",
        fft_pair_strided_library(), "fourier_fft_pair_strided_c64",
        f"B1 on ({outer}, {n}, {inner}) where it lies ({geo.ranks}-block clusters)",
        src.data_ptr(), y.data_ptr(), n, outer, inner, geo.ranks, geo.cols,
        geo.threads, *radices_arg(pass_schedule(geo.rows)),
        pair_tables[0].data_ptr(), pair_tables[1].data_ptr(), int(forward),
        scale_arg(scale), y.device.index, stream_of(y),
    )


@_vpu_fft_strided_op.register_fake
def _(y, x, *_):
    return None


def chirp_z_reference(re_t, im_t, n: int, m: int, schedule, tables, chirps,
                      scale: Optional[float]):
    """The whole chirp-z over (n, B) planes through an m-point inner
    transform with the stage `schedule`: the plain version of every fused
    Bluestein kernel. `tables`: the (forward, inverse) compact stage tables
    of the schedule; `chirps`: the (2, n), (2, m) and (2, n) planar tensors
    xt, wt and xo (1/m folded into xo). Port of
    ``stockham_vpu._bluestein_value``."""
    xt, wt, xo = ((c[0][:, None], c[1][:, None]) for c in chirps)
    wre, wim = cplx.mul((re_t, im_t), xt)
    pad = (0, 0, 0, m - n)
    wre = torch.nn.functional.pad(wre, pad)
    wim = torch.nn.functional.pad(wim, pad)
    wre, wim = stages_reference(wre, wim, schedule, tables[0], True, None)
    wre, wim = cplx.mul((wre, wim), wt)
    wre, wim = stages_reference(wre, wim, schedule, tables[1], False, None)
    if scale is not None:
        xo = (xo[0] * scale, xo[1] * scale)
    return cplx.mul((wre[:n], wim[:n]), xo)


def vpu_bluestein_batch_minor_reference(re_t, im_t, n: int, m: int, tables,
                                        chirps, scale: Optional[float]):
    """Plain PyTorch B2: :func:`chirp_z_reference` through the stages of
    :func:`radix_schedule` (m), with the compact tables of
    :func:`make_stage_tables`."""
    return chirp_z_reference(re_t, im_t, n, m, radix_schedule(m), tables,
                             chirps, scale)


def vpu_bluestein_batch_minor(re_t, im_t, n: int, m: int,
                              scale: Optional[float], *, tables, kernel_tables,
                              chirps, pair_tables=(None, None)):
    """B2 over contiguous planar f32 (n, B) planes; returns new planes.

    `tables`: (forward, inverse) compact stage tables for m as tensors
    (plain version); `kernel_tables`: the (forward, inverse) (2, L) tensors
    of :func:`make_kernel_tables` for m (the stage body); `pair_tables`:
    the (forward, inverse) :func:`pair_tables` of m (the paired body; None
    where m has none); `chirps`: the direction-matched (xt, wt, xo) of
    :func:`vpu_bluestein_batch_minor_reference`; all on the planes' device.
    The kernel is the paired-block body of ``csrc/bluestein_pair.cu`` where
    :func:`kernel_body` says so at M, else the stage body. On a card the
    launch is the operator ``fourier_tpu_torch::vpu_bluestein``.
    """
    check_planes(re_t, im_t, (n,), "B2")
    if re_t.device.type == "cpu":
        return vpu_bluestein_batch_minor_reference(re_t, im_t, n, m, tables,
                                                   chirps, scale)
    check_tables(re_t.device, *kernel_tables, *chirps)
    return _vpu_bluestein_op(re_t, im_t, n, m, scale, *kernel_tables, *pair_tables,
                             *chirps)


@torch.library.custom_op("fourier_tpu_torch::vpu_bluestein", mutates_args=(),
                         device_types="cuda")
def _vpu_bluestein_op(re_t: Tensor, im_t: Tensor, n: int, m: int,
                      scale: Optional[float], kf: Tensor, ki: Tensor,
                      pf: Optional[Tensor], pi: Optional[Tensor], xt: Tensor,
                      wt: Tensor, xo: Tensor) -> Tuple[Tensor, Tensor]:
    """B2's launch (see :func:`vpu_bluestein_batch_minor`)."""
    out_re = torch.empty_like(re_t)
    out_im = torch.empty_like(im_t)
    batch = re_t.shape[1]
    if batch == 0:
        return out_re, out_im
    geo = clustered_geometry("B2", m)
    if geo is not None:
        lib, fn, what = (bluestein_pair_library(), "fourier_bluestein_pair_c64",
                         "B2 (paired blocks)")
        cols, threads, schedule = geo.cols, geo.threads, pass_schedule(geo.rows)
        check_pair_tables(re_t.device, m, 2, pf, pi)
        kf, ki = pf, pi
    else:
        lib, fn, what = library(), "fourier_bluestein_c64", "B2"
        cols, threads = launch_geometry(m)
        schedule = kernel_schedule(m)
    build.launch(
        "fourier_tpu_torch::vpu_bluestein",
        lib, fn, f"{what} at n={n}, M={m}, B={batch}",
        re_t.data_ptr(), im_t.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        n, m, batch, cols, threads, *radices_arg(schedule),
        kf[0].data_ptr(), kf[1].data_ptr(), ki[0].data_ptr(), ki[1].data_ptr(),
        xt[0].data_ptr(), xt[1].data_ptr(), wt[0].data_ptr(), wt[1].data_ptr(),
        xo[0].data_ptr(), xo[1].data_ptr(),
        scale_arg(scale), re_t.device.index, stream_of(re_t),
    )
    return out_re, out_im


@_vpu_bluestein_op.register_fake
def _(re_t, im_t, *_):
    return torch.empty_like(re_t), torch.empty_like(im_t)


def vpu_fft_four_step_row_reference(re3, im3, p: int, q: int, tables, pre_tw,
                                    forward: bool, scale: Optional[float]):
    """Plain PyTorch B3: (q, p, B) planes times the (q, p) split twiddle
    `pre_tw` (W_n^(+-a*k2) at [k2, a]) and the mode scale, B1's plain stages
    over p, and the transposed store; returns natural-order (p*q, B)
    planes. `tables`: the compact stage tables of p."""
    b = re3.shape[-1]
    tr, ti = pre_tw
    if scale is not None:
        tr, ti = tr * scale, ti * scale
    re, im = cplx.mul((re3, im3), (tr[:, :, None], ti[:, :, None]))
    re = re.transpose(0, 1).reshape(p, q * b)
    im = im.transpose(0, 1).reshape(p, q * b)
    re, im = vpu_fft_batch_minor_reference(re, im, p, tables, forward, None)
    return re.reshape(p * q, b), im.reshape(p * q, b)


def vpu_fft_four_step_row(re3, im3, p: int, q: int, forward: bool,
                          scale: Optional[float], *, tables, kernel_tables,
                          pre_tw, tw_fwd=None, pair_tables=None):
    """B3 over contiguous planar f32 (q, p, B) planes (the column leg's
    output); returns new natural-order (p*q, B) planes.

    `tables`: the compact stage tables of p as tensors (plain version);
    `kernel_tables`: the (2, L) tensor of :func:`make_kernel_tables` for p
    (the stage body); `pre_tw`: the (q, p) planar split twiddle, all
    direction-matched and on the planes' device; `tw_fwd`: the forward
    (q, p) split twiddle, which the clustered body reads in both directions
    (None: `pre_tw`, which must then be the forward one); `pair_tables`:
    the forward :func:`pair_tables` of p on the body's clusters (None where
    p has no clustered body). The kernel is the clustered-block body of
    ``csrc/four_step_pair.cu`` where :func:`kernel_body` says so at p, else
    the stage body. On a card the launch is the operator
    ``fourier_tpu_torch::four_step_row``.
    """
    check_planes(re3, im3, (q, p), "B3")
    if re3.device.type == "cpu":
        return vpu_fft_four_step_row_reference(re3, im3, p, q, tables, pre_tw,
                                               forward, scale)
    check_tables(re3.device, kernel_tables, *pre_tw)
    if tw_fwd is None:
        tw_fwd = pre_tw
    return _four_step_row_op(re3, im3, p, q, forward, scale, kernel_tables,
                             pair_tables, *pre_tw, *tw_fwd, tw_fwd is pre_tw)


@torch.library.custom_op("fourier_tpu_torch::four_step_row", mutates_args=(),
                         device_types="cuda")
def _four_step_row_op(re3: Tensor, im3: Tensor, p: int, q: int, forward: bool,
                      scale: Optional[float], kernel_tables: Tensor,
                      pair_tables: Optional[Tensor], pre_re: Tensor, pre_im: Tensor,
                      fwd_re: Tensor, fwd_im: Tensor, fwd_is_pre: bool
                      ) -> Tuple[Tensor, Tensor]:
    """B3's launch (see :func:`vpu_fft_four_step_row`); `fwd_is_pre`: the
    caller gave no forward twiddle of its own."""
    batch = re3.shape[-1]
    out_re = torch.empty(p * q, batch, dtype=torch.float32, device=re3.device)
    out_im = torch.empty_like(out_re)
    if batch == 0:
        return out_re, out_im
    data = (re3.data_ptr(), im3.data_ptr(), out_re.data_ptr(), out_im.data_ptr())
    geo = clustered_geometry("B3", p)
    if geo is not None:
        if fwd_is_pre and not forward:
            raise ValueError("B3's clustered body takes the forward split "
                             "twiddle (tw_fwd) for an inverse")
        check_tables(re3.device, fwd_re, fwd_im)
        check_pair_tables(re3.device, p, geo.ranks, pair_tables)
        count_split_bytes(geo.ranks, p, q * batch, 4)
        build.launch(
            "fourier_tpu_torch::four_step_row",
            four_step_pair_library(), "fourier_four_step_pair_c64",
            f"B3 ({geo.ranks}-block clusters) at p={p}, q={q}, B={batch}", *data,
            p, q, batch, geo.ranks, geo.cols, geo.threads,
            *radices_arg(pass_schedule(geo.rows)),
            pair_tables[0].data_ptr(), pair_tables[1].data_ptr(), fwd_re.data_ptr(),
            fwd_im.data_ptr(), int(forward), scale_arg(scale),
            re3.device.index, stream_of(re3),
        )
    else:
        cols, threads = launch_geometry(p)
        _launch(
            "fourier_tpu_torch::four_step_row",
            "fourier_four_step_row_c64", f"B3 at p={p}, q={q}, B={batch}", *data,
            p, q, batch, cols, threads, *_radices(p),
            kernel_tables[0].data_ptr(), kernel_tables[1].data_ptr(),
            pre_re.data_ptr(), pre_im.data_ptr(),
            int(forward), scale_arg(scale), re3.device.index, stream_of(re3),
        )
    return out_re, out_im


@_four_step_row_op.register_fake
def _(re3, im3, p, q, *_):
    out = re3.new_empty((p * q, re3.shape[-1]))
    return out, torch.empty_like(out)


def vpu_rfft_pack_batch_minor_reference(x_t, m: int, tables, w):
    """Plain PyTorch B4a: real (2m, B) -> one-sided planar (m+1, B) spectrum.

    B1's plain forward stages over z[j] = x[2j] + i*x[2j+1] with the compact
    forward `tables` of m, then the Hermitian pack with `w`, the planar
    (2, m) table of exp(-2*pi*i*k/(2m)). Port of
    ``stockham_vpu._rfft_pack_kernel``'s math."""
    pair = x_t.reshape(m, 2, x_t.shape[-1])
    zr, zi = vpu_fft_batch_minor_reference(pair[:, 0], pair[:, 1], m, tables,
                                           True, None)
    return hermitian.pack(zr, zi, (w[0][:, None], w[1][:, None]), 0)


def vpu_irfft_unpack_batch_minor_reference(re_t, im_t, m: int, tables, w):
    """Plain PyTorch B4b: one-sided planar (m+1, B) spectrum -> real (2m, B).

    The Hermitian unpack (imaginary DC and Nyquist read as 0, conj(W^k), the
    0.5/m of the unpack and the inverse folded into one constant), B1's plain
    inverse stages with the compact inverse `tables` of m, unscaled, and the
    re-interleave. Port of ``stockham_vpu._irfft_unpack_kernel``'s math."""
    zr, zi = hermitian.unpack(re_t, im_t, (w[0][:, None], w[1][:, None]), 0,
                              half=float(np.float32(0.5 / m)))
    zr, zi = vpu_fft_batch_minor_reference(zr, zi, m, tables, False, None)
    return torch.stack([zr, zi], dim=1).reshape(2 * m, re_t.shape[-1])


def _check_w(w, m: int, device):
    check_tables(device, w)
    if tuple(w.shape) != (2, m):
        raise ValueError(f"w must be a (2, {m}) table, got {tuple(w.shape)}")


def vpu_rfft_pack_batch_minor(x_t, m: int, *, tables, kernel_tables, w,
                              pair_tables=None):
    """B4a over a contiguous real f32 (2m, B) plane; returns new planar
    (m+1, B) spectrum planes.

    `tables`: the compact forward stage tables of m as tensors (plain
    version); `kernel_tables`: the forward (2, L) tensor of
    :func:`make_kernel_tables` for m (the stage body); `pair_tables`: the
    forward :func:`pair_tables` of m (the paired body; None where m has
    none); `w`: the (2, m) f32 table of exp(-2*pi*i*k/(2m)); all on the
    plane's device. The kernel is the paired-block body where
    :func:`kernel_body` says so, else the stage body. On a card the launch
    is the operator ``fourier_tpu_torch::rfft_pack``.
    """
    check_planes(x_t, x_t, (2 * m,), "B4a")
    _check_w(w, m, x_t.device)
    if x_t.device.type == "cpu":
        return vpu_rfft_pack_batch_minor_reference(x_t, m, tables, w)
    check_tables(x_t.device, kernel_tables)
    return _rfft_pack_op(x_t, m, kernel_tables, pair_tables, w)


@torch.library.custom_op("fourier_tpu_torch::rfft_pack", mutates_args=(),
                         device_types="cuda")
def _rfft_pack_op(x_t: Tensor, m: int, kernel_tables: Tensor,
                  pair_tables: Optional[Tensor], w: Tensor) -> Tuple[Tensor, Tensor]:
    """B4a's launch (see :func:`vpu_rfft_pack_batch_minor`)."""
    batch = x_t.shape[1]
    out_re = torch.empty(m + 1, batch, dtype=torch.float32, device=x_t.device)
    out_im = torch.empty_like(out_re)
    if batch == 0:
        return out_re, out_im
    geo = clustered_geometry("B4a", m)
    if geo is not None:
        check_pair_tables(x_t.device, m, 2, pair_tables)
        build.launch(
            "fourier_tpu_torch::rfft_pack",
            pair_library(), "fourier_rfft_pack_pair_c64",
            f"B4a (paired blocks) at m={m}, B={batch}",
            x_t.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
            m, batch, geo.cols, geo.threads, *radices_arg(pass_schedule(m // 2)),
            pair_tables[0].data_ptr(), pair_tables[1].data_ptr(),
            w[0].data_ptr(), w[1].data_ptr(), x_t.device.index, stream_of(x_t),
        )
    else:
        cols, threads = launch_geometry(m)
        _launch(
            "fourier_tpu_torch::rfft_pack",
            "fourier_rfft_pack_c64", f"B4a at m={m}, B={batch}",
            x_t.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
            m, batch, cols, threads, *_radices(m),
            kernel_tables[0].data_ptr(), kernel_tables[1].data_ptr(),
            w[0].data_ptr(), w[1].data_ptr(), x_t.device.index, stream_of(x_t),
        )
    return out_re, out_im


@_rfft_pack_op.register_fake
def _(x_t, m, *_):
    out = x_t.new_empty((m + 1, x_t.shape[1]))
    return out, torch.empty_like(out)


def vpu_irfft_unpack_batch_minor(re_t, im_t, m: int, *, tables, kernel_tables,
                                 w, pair_tables=None):
    """B4b over contiguous planar f32 (m+1, B) spectrum planes; returns a new
    real (2m, B) plane (the irfft, 1/(2m) included).

    `tables`: the compact inverse stage tables of m as tensors (plain
    version); `kernel_tables`: the inverse (2, L) tensor of
    :func:`make_kernel_tables` for m (the stage body); `pair_tables`: the
    inverse :func:`pair_tables` of m (the paired body; None where m has
    none); `w`: as for :func:`vpu_rfft_pack_batch_minor` (conjugated here).
    The kernel is the paired-block body of ``csrc/irfft_unpack_pair.cu``
    where :func:`kernel_body` says so, else the stage body. On a card the
    launch is the operator ``fourier_tpu_torch::irfft_unpack``.
    """
    check_planes(re_t, im_t, (m + 1,), "B4b")
    _check_w(w, m, re_t.device)
    if re_t.device.type == "cpu":
        return vpu_irfft_unpack_batch_minor_reference(re_t, im_t, m, tables, w)
    check_tables(re_t.device, kernel_tables)
    return _irfft_unpack_op(re_t, im_t, m, kernel_tables, pair_tables, w)


@torch.library.custom_op("fourier_tpu_torch::irfft_unpack", mutates_args=(),
                         device_types="cuda")
def _irfft_unpack_op(re_t: Tensor, im_t: Tensor, m: int, kernel_tables: Tensor,
                     pair_tables: Optional[Tensor], w: Tensor) -> Tensor:
    """B4b's launch (see :func:`vpu_irfft_unpack_batch_minor`)."""
    batch = re_t.shape[1]
    out = torch.empty(2 * m, batch, dtype=torch.float32, device=re_t.device)
    if batch == 0:
        return out
    data = (re_t.data_ptr(), im_t.data_ptr(), out.data_ptr())
    h = float(np.float32(0.5 / m))
    geo = clustered_geometry("B4b", m)
    if geo is not None:
        check_pair_tables(re_t.device, m, 2, pair_tables)
        build.launch(
            "fourier_tpu_torch::irfft_unpack",
            irfft_unpack_pair_library(), "fourier_irfft_unpack_pair_c64",
            f"B4b (paired blocks) at m={m}, B={batch}", *data,
            m, batch, geo.cols, geo.threads, *radices_arg(pass_schedule(m // 2)),
            pair_tables[0].data_ptr(), pair_tables[1].data_ptr(), w[0].data_ptr(),
            w[1].data_ptr(), h, re_t.device.index, stream_of(re_t),
        )
    else:
        cols, threads = launch_geometry(m)
        _launch(
            "fourier_tpu_torch::irfft_unpack",
            "fourier_irfft_unpack_c64", f"B4b at m={m}, B={batch}", *data,
            m, batch, cols, threads, *_radices(m),
            kernel_tables[0].data_ptr(), kernel_tables[1].data_ptr(),
            w[0].data_ptr(), w[1].data_ptr(), h, re_t.device.index, stream_of(re_t),
        )
    return out


@_irfft_unpack_op.register_fake
def _(re_t, im_t, m, *_):
    return re_t.new_empty((2 * m, re_t.shape[1]))


def _pair_halves(t, h: int):
    """Columns [0, h) and [h, B) of a (rows, B) plane, the second padded with
    zero columns to h (the partners of an odd B's last column)."""
    rest = t[:, h:]
    pad = h - rest.shape[1]
    if pad:
        rest = torch.cat([rest, rest.new_zeros(rest.shape[0], pad)], dim=1)
    return t[:, :h], rest


def vpu_rfft_odd_pack_batch_minor_reference(x_t, n: int, m: int, tables,
                                            chirps):
    """Plain PyTorch B5a: real (n, B), n odd -> one-sided planar (L, B),
    L = (n+1)/2. Column j pairs with column j + ceil(B/2): B2's plain
    version transforms x_j + i*x_{j+h} (`tables`, `chirps`: B2's forward
    ones), then the two-for-one separation. Port of
    ``stockham_vpu._rfft_odd_pack_kernel``'s math."""
    b = x_t.shape[-1]
    h, L = (b + 1) // 2, (n + 1) // 2
    zr, zi = vpu_bluestein_batch_minor_reference(*_pair_halves(x_t, h), n, m,
                                                 tables, chirps, None)
    (x1r, x1i), (x2r, x2i) = hermitian.separate(zr, zi, L, 0)
    return (torch.cat([x1r, x2r[:, :b - h]], dim=1),
            torch.cat([x1i, x2i[:, :b - h]], dim=1))


def vpu_irfft_odd_unpack_batch_minor_reference(re_t, im_t, n: int, m: int,
                                               tables, chirps):
    """Plain PyTorch B5b: one-sided planar (L, B) -> real (n, B), n odd.
    Z = X1 + i*X2 (columns j and j + ceil(B/2), imaginary DC parts read as
    0, Hermitian above bin L-1), then B2's plain version with the inverse
    `chirps` and scale 1/n. Port of
    ``stockham_vpu._irfft_odd_unpack_kernel``'s math."""
    b = re_t.shape[-1]
    h = (b + 1) // 2
    x1r, x2r = _pair_halves(re_t, h)
    x1i, x2i = _pair_halves(hermitian.zero_bins(im_t, 0, last=False), h)
    zr, zi = hermitian.recombine((x1r, x1i), (x2r, x2i), 0)
    oa, ob = vpu_bluestein_batch_minor_reference(zr, zi, n, m, tables, chirps,
                                                 1.0 / n)
    return torch.cat([oa, ob[:, :b - h]], dim=1)


def _launch_odd(fn_name: str, what: str, op: str, inp, out, n: int, m: int,
                kernel_tables, pair_tables, chirps, *tail, lib=None, geo=None):
    """Launch B5a or B5b, the operator `op`: `inp`/`out` the tensors of the
    data arguments, `tail` the arguments after the tables; the stage body with
    `kernel_tables`, or the paired body of `lib` with the tile `geo` and
    `pair_tables` (forward, inverse)."""
    batch = inp[0].shape[1]
    if geo is None:
        lib, (cols, threads), schedule = library(), launch_geometry(m), kernel_schedule(m)
        kf, ki = kernel_tables
    else:
        cols, threads, schedule = geo.cols, geo.threads, pass_schedule(geo.rows)
        check_pair_tables(inp[0].device, m, 2, *pair_tables)
        kf, ki = pair_tables
    xt, wt, xo = chirps
    build.launch(
        op, lib, fn_name, f"{what} at n={n}, M={m}, B={batch}",
        *(t.data_ptr() for t in (*inp, *out)),
        n, m, batch, cols, threads, *radices_arg(schedule),
        kf[0].data_ptr(), kf[1].data_ptr(), ki[0].data_ptr(), ki[1].data_ptr(),
        xt[0].data_ptr(), xt[1].data_ptr(), wt[0].data_ptr(), wt[1].data_ptr(),
        xo[0].data_ptr(), xo[1].data_ptr(),
        *tail, inp[0].device.index, stream_of(inp[0]),
    )


def vpu_rfft_odd_pack_batch_minor(x_t, n: int, m: int, *, tables,
                                  kernel_tables, chirps, pair_tables=(None, None)):
    """B5a over a contiguous real f32 (n, B) plane, n odd; returns new planar
    (L, B) spectrum planes, L = (n+1)/2.

    `tables`, `kernel_tables`, `pair_tables`: as for
    :func:`vpu_bluestein_batch_minor`; `chirps`: the forward (xt, wt, xo);
    all on the plane's device. The kernel is the paired-block body of
    ``csrc/rfft_odd_pair.cu`` where :func:`kernel_body` says so at M, else
    the stage body. On a card the launch is the operator
    ``fourier_tpu_torch::rfft_odd_pack``.
    """
    check_planes(x_t, x_t, (n,), "B5a")
    if x_t.device.type == "cpu":
        return vpu_rfft_odd_pack_batch_minor_reference(x_t, n, m, tables,
                                                       chirps)
    check_tables(x_t.device, *kernel_tables, *chirps)
    return _rfft_odd_pack_op(x_t, n, m, *kernel_tables, *pair_tables, *chirps)


@torch.library.custom_op("fourier_tpu_torch::rfft_odd_pack", mutates_args=(),
                         device_types="cuda")
def _rfft_odd_pack_op(x_t: Tensor, n: int, m: int, kf: Tensor, ki: Tensor,
                      pf: Optional[Tensor], pi: Optional[Tensor], xt: Tensor,
                      wt: Tensor, xo: Tensor) -> Tuple[Tensor, Tensor]:
    """B5a's launch (see :func:`vpu_rfft_odd_pack_batch_minor`)."""
    L = (n + 1) // 2
    out_re = torch.empty(L, x_t.shape[1], dtype=torch.float32, device=x_t.device)
    out_im = torch.empty_like(out_re)
    if x_t.shape[1] == 0:
        return out_re, out_im
    args = ("fourier_tpu_torch::rfft_odd_pack", (x_t,), (out_re, out_im), n, m, (kf, ki),
            (pf, pi), (xt, wt, xo))
    geo = clustered_geometry("B5a", m)
    if geo is not None:
        _launch_odd("fourier_rfft_odd_pack_pair_c64", "B5a (paired blocks)", *args,
                    lib=rfft_odd_pair_library(), geo=geo)
    else:
        _launch_odd("fourier_rfft_odd_pack_c64", "B5a", *args)
    return out_re, out_im


@_rfft_odd_pack_op.register_fake
def _(x_t, n, *_):
    out = x_t.new_empty(((n + 1) // 2, x_t.shape[1]))
    return out, torch.empty_like(out)


def vpu_irfft_odd_unpack_batch_minor(re_t, im_t, n: int, m: int, *, tables,
                                     kernel_tables, chirps,
                                     pair_tables=(None, None)):
    """B5b over contiguous planar f32 (L, B) spectrum planes, n odd; returns
    a new real (n, B) plane (the irfft, 1/n included).

    `tables`, `kernel_tables`, `pair_tables`: as for
    :func:`vpu_bluestein_batch_minor`; `chirps`: the inverse (xt, wt, xo);
    all on the planes' device. The kernel is the paired-block body of
    ``csrc/irfft_odd_pair.cu`` where :func:`kernel_body` says so at M, else
    the stage body. On a card the launch is the operator
    ``fourier_tpu_torch::irfft_odd_unpack``.
    """
    check_planes(re_t, im_t, ((n + 1) // 2,), "B5b")
    if re_t.device.type == "cpu":
        return vpu_irfft_odd_unpack_batch_minor_reference(re_t, im_t, n, m,
                                                          tables, chirps)
    check_tables(re_t.device, *kernel_tables, *chirps)
    return _irfft_odd_unpack_op(re_t, im_t, n, m, *kernel_tables, *pair_tables,
                                *chirps)


@torch.library.custom_op("fourier_tpu_torch::irfft_odd_unpack", mutates_args=(),
                         device_types="cuda")
def _irfft_odd_unpack_op(re_t: Tensor, im_t: Tensor, n: int, m: int, kf: Tensor,
                         ki: Tensor, pf: Optional[Tensor], pi: Optional[Tensor],
                         xt: Tensor, wt: Tensor, xo: Tensor) -> Tensor:
    """B5b's launch (see :func:`vpu_irfft_odd_unpack_batch_minor`)."""
    out = torch.empty(n, re_t.shape[1], dtype=torch.float32, device=re_t.device)
    if re_t.shape[1] == 0:
        return out
    args = ("fourier_tpu_torch::irfft_odd_unpack", (re_t, im_t), (out,), n, m, (kf, ki),
            (pf, pi), (xt, wt, xo), 1.0 / n)
    geo = clustered_geometry("B5b", m)
    if geo is not None:
        _launch_odd("fourier_irfft_odd_unpack_pair_c64", "B5b (paired blocks)", *args,
                    lib=irfft_odd_pair_library(), geo=geo)
    else:
        _launch_odd("fourier_irfft_odd_unpack_c64", "B5b", *args)
    return out


@_irfft_odd_unpack_op.register_fake
def _(re_t, im_t, n, *_):
    return re_t.new_empty((n, re_t.shape[1]))
