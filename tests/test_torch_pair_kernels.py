"""The clustered-block bodies of kernels B1, B2, B4a, B4b, B5a, B5b, B6 and
B7 (csrc/stockham_pair.cuh).

The CUDA kernels run only on a card. Here a numpy transliteration of each
body's order of operations is held against ``np.fft`` and against the
unchanged plain versions (``vpu_fft_batch_minor_reference``,
``vpu_bluestein_batch_minor_reference``,
``vpu_rfft_pack_batch_minor_reference``,
``vpu_irfft_unpack_batch_minor_reference``,
``vpu_rfft_odd_pack_batch_minor_reference``,
``vpu_irfft_odd_unpack_batch_minor_reference``,
``vpu_dd_fft_batch_minor_reference``,
``vpu_dd_bluestein_batch_minor_reference``): the C blocks of a cluster (two,
or four for B1 and B6 at n in (2048, 4096]), each holding 1/C of the rows of
a tile in rows swizzled inside their 128-byte lines; the cross-block radix-C
split, pushed by B1, B3 and B6 (each rank copies the rows of every block at
its share of the points, forms every output there and writes it into its
rank's buffer) and read on the first pass by the chirp-z bodies and B4a;
the passes of ``pass_schedule`` with the
tables of ``pair_tables`` (narrowed to f32 for B1, B2, B4a and B5a, f64 for
B6 and B7); the store of row k of rank r to output row C*k + r of B1 and B6
(``fft_pair``, the same body at float and at double), and their inverse as
the forward body on the planes exchanged, IDFT(x) = swap(DFT(swap(x)));
B4a's even/odd rows copied into the re/im planes and the pack read from
each block's own rows; the chirp-z bodies' (B2, B7, B5a) chirp on the first
read, w on the last forward store and the join E + W_M^-p * O times the
output chirp on the final store; B5a's walk over the ceil(B/2) column pairs,
column j copied into the re plane and j + ceil(B/2) into the im plane, and
its separation of the bins k < (n+1)/2 into the two columns; B5b's bins of
column j on rank 0 and of j + ceil(B/2) on rank 1, read as Z on the first
forward read with the Hermitian tail as an index; B4b's unpack on the first
inverse pass's read from both ranks' rows and the Nyquist row, and its
store of row j of rank r to real rows 4j + 2r and 4j + 2r + 1; the
persistent walk of the clusters over column groups, ending on a ragged
group. Columns past B and rows never copied are NaN in the emulated shared
memory, so a read of either would show; the one exception is B5a's and
B5b's partner of an unpaired last column, written as zeros, which the
emulations check as such. Gates: rel-L2 1e-6 (c64), 1e-12 (c128). B4b's,
B5a's, B5b's and B6's bodies are also held against the JAX package's Pallas
kernels in interpret mode at one small size each.

The launch geometry and schedules are checked over each body's whole
domain, with the sizes at which each wrapper keeps its stage body, and the
size lists of the .cu files against the Python ones; the body rule
(``kernel_body``, ``two_phase_body``) at sizes on each side of each
kernel's choice. ``tests/test_torch_pair_kernels_card.py`` runs the
kernels on a card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fourier_tpu import Transform as JTransform
from fourier_tpu.ops.pallas import stockham_vpu as jsv
from fourier_tpu.plan.bluestein_fused import VpuBluesteinPlan as JVpuBluesteinPlan
from fourier_tpu.plan.vpu import VpuFftPlan as JVpuFftPlan
from fourier_tpu.precision import ddreal
from fourier_tpu.precision.vpu_dd_plan import VpuDdFftPlan as JVpuDdFftPlan

from fourier_tpu_torch import (FourStepLocalPlan, MxuFftPlan, Transform,
                               VpuBluesteinPlan, VpuFftPlan)
from fourier_tpu_torch import trace
from fourier_tpu_torch.ops.cuda import bailey as kb
from fourier_tpu_torch.ops.cuda import stockham_vpu as sv
from fourier_tpu_torch.ops.cuda import stockham_vpu_dd as dv
from fourier_tpu_torch.precision import VpuDdBluesteinPlan, VpuDdFftPlan
from fourier_tpu_torch.rfft import RfftPlan

RNG_SEED = 0xB4A7
C64_GATE = 1e-6
C128_GATE = 1e-12
BATCHES = (1, 7, 1000)
# Clusters of the emulated walk: 1000 columns in groups of 8 are 125 tiles,
# four rounds of 40 clusters, the last ragged.
CLUSTERS = 40
SMEM_PER_BLOCK = 232448  # bytes of shared memory a block may take on an H100

B1_DOMAIN = [m for m in range(64, 16385) if sv.radix_schedule(m) is not None]
B4A_PAIR = [m for m in B1_DOMAIN if sv.rfft_pack_geometry(m) is not None]
B7_INNER = (64, 128, 256, 512, 1024, 2048)
B1_PAIR = [n for n in B1_DOMAIN if sv.fft_pair_geometry(n) is not None]
B6_DOMAIN = [n for n in range(1, 4097) if dv.radix_schedule_dd(n) is not None]
B6_PAIR = [n for n in B6_DOMAIN if dv.fft_pair_geometry_dd(n) is not None]
# Every inner size M that VpuBluesteinPlan.choose_inner gives (n = 17..4096).
B2_INNER = sorted({m for m in (VpuBluesteinPlan.choose_inner(n, 8192)
                           for n in range(17, 4097)) if m is not None})
CSRC = Path(sv.__file__).parents[2] / "csrc"


def launches(op: str) -> int:
    """Launches of the operator ``fourier_tpu_torch::<op>`` counted so far."""
    return trace.counters()[f"launches.fourier_tpu_torch::{op}"]


def _xmacro(path, name):
    """The X(...) entries of the #define `name` in csrc/`path`."""
    lines = (CSRC / path).read_text().splitlines()
    i = next(i for i, line in enumerate(lines) if line.startswith(f"#define {name}("))
    block = [lines[i]]
    while block[-1].endswith("\\"):
        i += 1
        block.append(lines[i])
    return [int(v) for v in re.findall(r"X\((\d+)\)", "\n".join(block))]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cplx(t):
    t = np.asarray(t, np.float64)
    return t[0] + 1j * t[1]


def _rpl_log(cols, itemsize):
    """log2 of the rows in a 128-byte line (PairTile::kRplLog)."""
    row_bytes = cols * itemsize
    return 0 if row_bytes >= 128 else (1 if row_bytes == 64 else 2)


def _swizzle(row, rpl_log):
    """swizzle_row: the row moves inside its line by the XOR of the line's
    2-bit digits (4 rows a line) or its parity (2 rows a line)."""
    row = np.asarray(row)
    if rpl_log == 0:
        return row
    line = row >> rpl_log
    if rpl_log == 2:
        g = line ^ (line >> 8)
        g = g ^ (g >> 4)
        g = g ^ (g >> 2)
        return row ^ (g & 3)
    parity = np.zeros_like(line)
    for bit in range(16):
        parity ^= (line >> bit) & 1
    return row ^ parity


def _offsets(h, schedule, start):
    """(radix, stride, table offset) of each pass (pair_stride,
    pair_tw_off), the pass tables starting at `start`."""
    out, size, stride, off = [], h, 1, start
    for r in schedule:
        out.append((r, stride, off))
        if size // r > 1:
            off += size
        size //= r
        stride *= r
    return out


def _dft(r, forward):
    k = np.arange(r)
    return np.exp((-2j if forward else 2j) * np.pi * np.outer(k, k) / r)


class _Pair:
    """The C blocks of a cluster (C = geo.ranks) over T tiles at once: per
    rank a (T, rows * cols) plane of complex points, row r at _swizzle(r) *
    cols."""

    def __init__(self, geo, itemsize, tiles):
        self.rows, self.cols = geo.rows, geo.cols
        self.rpl = _rpl_log(geo.cols, itemsize)
        self.bufs = [np.full((tiles, geo.rows * geo.cols), np.nan, complex)
                     for _ in range(geo.ranks)]

    def index(self, row, col):
        return _swizzle(row, self.rpl) * self.cols + col

    def load(self, rank, row, col):
        return self.bufs[rank][:, self.index(row, col)]

    def passes(self, schedule, table, forward, first_load, hook=None):
        """pair_passes on every rank: every pass reads all its points (the
        first through `first_load`, across the cluster) before it stores;
        the last stores through `hook`. `table` holds the (C-1)*rows split
        twiddles, then the pass tables."""
        ranks = range(len(self.bufs))
        plan = _offsets(self.rows, schedule, (len(self.bufs) - 1) * self.rows)
        for s, (r, stride, off) in enumerate(plan):
            last = s == len(plan) - 1
            blk = self.rows // r
            ids = np.arange(blk * self.cols)
            col, p = ids % self.cols, ids // self.cols
            load = first_load if s == 0 else self.load
            xs = [np.stack([load(rank, k * blk + p, col) for k in range(r)])
                  for rank in ranks]
            i, j = p // stride, p % stride
            for rank, x in enumerate(xs):
                y = np.tensordot(_dft(r, forward), x, axes=(1, 0))
                if not last:
                    k = np.arange(1, r)[:, None]
                    y[1:] *= table[off + i[None, :] * r + k][:, None, :]
                for k in range(r):
                    row = (i * r + k) * stride + j
                    v = hook(rank, row, y[k]) if (last and hook) else y[k]
                    self.bufs[rank][:, self.index(row, col)] = v


def _tile_columns(tiles, cols, b):
    idx = tiles[:, None] * cols + np.arange(cols)
    return idx, idx < b


def emulate_b4a_pair(x, m, w):
    """rfft_pack_pair_c64 on a real (2m, B) array x, in f64 with the f32
    tables: the (2m, B) -> (m+1, B) one-sided spectrum."""
    geo = sv.rfft_pack_geometry(m)
    h, cols = geo.rows, geo.cols
    tab = _cplx(sv.pair_tables(m, True, np.float32))
    wc = _cplx(w)
    b = x.shape[1]
    ntiles = -(-b // cols)
    out = np.full((m + 1, b), np.nan, complex)
    rows = np.repeat(np.arange(h), cols)
    cgrid = np.tile(np.arange(cols), h)
    for t0 in range(0, ntiles, CLUSTERS):
        tiles = np.arange(t0, min(ntiles, t0 + CLUSTERS))
        cidx, valid = _tile_columns(tiles, cols, b)
        pair = _Pair(geo, 4, len(tiles))
        for rank in (0, 1):
            src = 2 * (rank * h + rows)
            col = cidx[:, cgrid]
            ok = valid[:, cgrid]
            bc = np.minimum(col, b - 1)
            z = x[src, bc] + 1j * x[src + 1, bc]  # (T, rows * cols)
            pair.bufs[rank][:, pair.index(rows, cgrid)] = np.where(ok, z, np.nan)

        def split(rank, row, col):
            a, c = pair.load(0, row, col), pair.load(1, row, col)
            return a + c if rank == 0 else (a - c) * tab[row]

        pair.passes(sv.pass_schedule(h), tab, True, split)
        for rank in (0, 1):
            j = np.arange(h + 1 if rank == 0 else h)
            if rank == 0:
                k, zk = 2 * j, np.where(j == h, 0, j)
                zm = np.where((j == 0) | (j == h), 0, h - j)
            else:
                k, zk, zm = 2 * j + 1, j, h - 1 - j
            ccol = np.arange(cols)
            z = pair.bufs[rank][:, pair.index(zk[:, None], ccol)]
            c = np.conj(pair.bufs[rank][:, pair.index(zm[:, None], ccol)])
            e, o = 0.5 * (z + c), -0.5j * (z - c)
            inner = (k < m)[:, None]
            wk = np.where(k < m, wc[np.minimum(k, m - 1)], 0.0)[:, None]
            got = np.where(inner, e + wk * o, e - o)  # (T, rows, cols)
            for ti in range(len(tiles)):
                out[k[:, None], cidx[ti][valid[ti]][None, :]] = got[ti][:, valid[ti]]
    return out


class _Planes:
    """PlanePolicy (B1, B6): the (n, B) planes, tile t the t-th group of
    `cols` columns, output row C*k + r of the same columns."""

    def __init__(self, b):
        self.b = b

    def out_shape(self, n):
        return (n, self.b)

    def tiles(self, cols):
        return -(-self.b // cols)

    def columns(self, tiles, cols):
        """The (T, cols) input columns of the tiles, and which are below B."""
        return _tile_columns(tiles, cols, self.b)

    def fetch(self, x, tiles, rows, cgrid, cols):
        cidx, valid = self.columns(tiles, cols)
        col = cidx[:, cgrid]
        return np.where(valid[:, cgrid], x[rows, np.minimum(col, self.b - 1)], np.nan)

    def prepare(self, cl, tiles, rank):
        pass

    def weight(self, tiles, rows, v):
        return v

    def store(self, out, tiles, rows, got, cols):
        cidx, valid = self.columns(tiles, cols)
        for ti in range(len(tiles)):
            out[rows[:, None], cidx[ti][valid[ti]][None, :]] = got[ti][:, valid[ti]]


def _push_rows(rank, c, h):
    """push_row: the input row that each row of rank `rank`'s buffer holds
    under fft_pair's push split, the rows s*h + rank*q + j (q = h/c, j < q)
    of every block s at its rows s*q + j."""
    q = h // c
    row = np.arange(h)
    return row // q * h + rank * q + row % q


def emulate_fft_pair(x, n, forward, scale, geo, real, io=None):
    """fft_pair (B1 at float, B6 at double) on a complex (n, B) array x, in
    f64 with the tables of pair_tables narrowed to `real`: the inverse is
    the forward body on the planes exchanged. `io` mirrors the body's I/O
    policy (default _Planes, B1's and B6's PlanePolicy): the tiles walked,
    the rows rank r copies (push_row), the pass over them before the split,
    the weight of a row as the split reads it, and the store. The push
    split: rank r reads, from its own buffer, the rows of every block s at
    each p of its share [r*q, (r+1)*q), q = h/C, forms every output v_s[p]
    and writes it into rank s's buffer at row p; the buffers it writes are
    NaN first, so a row no rank pushed would show in the passes."""
    c, h, cols = geo.ranks, geo.rows, geo.cols
    q = h // c
    tab = _cplx(sv.pair_tables(n, True, real, c))
    swap = lambda z: z.imag + 1j * z.real
    xin = x if forward else swap(x)
    io = _Planes(x.shape[1]) if io is None else io
    ntiles = io.tiles(cols)
    out = np.full(io.out_shape(n), np.nan, complex)
    rows = np.repeat(np.arange(h), cols)
    cgrid = np.tile(np.arange(cols), h)
    jrow = np.repeat(np.arange(q), cols)  # the points of a share, row-major
    jcol = np.tile(np.arange(cols), q)
    for t0 in range(0, ntiles, CLUSTERS):
        tiles = np.arange(t0, min(ntiles, t0 + CLUSTERS))
        cl = _Pair(geo, np.dtype(real).itemsize, len(tiles))
        for rank in range(c):
            cl.bufs[rank][:, cl.index(rows, cgrid)] = io.fetch(
                xin, tiles, np.repeat(_push_rows(rank, c, h), cols), cgrid, cols)
        for rank in range(c):
            io.prepare(cl, tiles, rank)
        pushed = [np.full_like(b, np.nan) for b in cl.bufs]
        for rank in range(c):
            p = rank * q + jrow
            a = [io.weight(tiles, s * h + p, cl.load(rank, s * q + jrow, jcol))
                 for s in range(c)]
            for dst in range(c):
                # (a_0 + (-1)^s a_2) + W_4^s (a_1 + (-1)^s a_3), or a_0 + (-1)^s a_1
                rho = -1 if dst & 1 else 1
                v = (a[0] + rho * a[1] if c == 2 else
                     a[0] + rho * a[2] + (-1j) ** dst * (a[1] + rho * a[3]))
                if dst:
                    v = v * tab[(dst - 1) * h + p]
                pushed[dst][:, cl.index(p, jcol)] = v
        cl.bufs = pushed
        cl.passes(sv.pass_schedule(h), tab, True, cl.load)
        k = np.arange(h)[:, None]
        for rank in range(c):  # row k of rank r is output row c*k + r
            got = cl.bufs[rank][:, cl.index(k, np.arange(cols))] * scale
            io.store(out, tiles, c * np.arange(h) + rank, got if forward else swap(got),
                     cols)
    return out


def emulate_b1_pair(x, n, forward, scale):
    """fft_pair_c64 on a complex (n, B) array x, in f64 with the f32
    tables."""
    return emulate_fft_pair(x, n, forward, scale, sv.fft_pair_geometry(n), np.float32)


def emulate_b6_pair(x, n, forward, scale):
    """fft_pair_c128 on a complex (n, B) array x, in f64 with the f64
    tables."""
    return emulate_fft_pair(x, n, forward, scale, dv.fft_pair_geometry_dd(n), np.float64)


class _FourStepPlanes(_Planes):
    """FourStepPlanes (B3, csrc/four_step_pair.cu): the (q, p, B) input,
    tile t = k2*G + g the g-th group of `cols` columns of the (p, B) plane
    of k2 (G = ceil(B / cols)); input row a = s*h + row times the forward
    four-step twiddle tw[k2, a] as the split reads it (`in_pass` False) or
    in a pass over each rank's copied rows before the split (True); row C*k
    + r of the (p, q*B) output at column k2*B + b."""

    def __init__(self, b, p, q, tw, geo, in_pass):
        super().__init__(b)
        self.p, self.q, self.tw, self.geo, self.in_pass = p, q, tw, geo, in_pass
        self.groups = -(-b // geo.cols)

    def out_shape(self, n):
        return (self.p, self.q * self.b)

    def tiles(self, cols):
        return self.q * self.groups

    def columns(self, tiles, cols):
        idx = (tiles % self.groups)[:, None] * cols + np.arange(cols)
        return idx, idx < self.b

    def fetch(self, x, tiles, rows, cgrid, cols):
        cidx, valid = self.columns(tiles, cols)
        col = np.minimum(cidx[:, cgrid], self.b - 1)
        k2 = (tiles // self.groups)[:, None]
        return np.where(valid[:, cgrid], x[k2, rows[None, :], col], np.nan)

    def prepare(self, cl, tiles, rank):
        if self.in_pass:  # every position of the rank's buffer, by its input row
            c, h, cols = self.geo.ranks, self.geo.rows, self.geo.cols
            rows = np.repeat(np.arange(h), cols)
            at = cl.index(rows, np.tile(np.arange(cols), h))
            k2 = (tiles // self.groups)[:, None]
            a = np.repeat(_push_rows(rank, c, h), cols)
            cl.bufs[rank][:, at] *= self.tw[k2, a[None, :]]

    def weight(self, tiles, rows, v):
        """Design (a): W_n^(a*k2), a = s*h + row, as the body forms it:
        tw[k2, row] * tw[k2, s*h] (both f32 table entries)."""
        if self.in_pass:
            return v
        h = self.geo.rows
        k2 = (tiles // self.groups)[:, None]
        return v * (self.tw[k2, rows[None, :] % h] * self.tw[k2, rows[None, :] // h * h])

    def store(self, out, tiles, rows, got, cols):
        cidx, valid = self.columns(tiles, cols)
        k2 = tiles // self.groups
        for ti in range(len(tiles)):
            cc = k2[ti] * self.b + cidx[ti][valid[ti]]
            out[rows[:, None], cc[None, :]] = got[ti][:, valid[ti]]


def emulate_b3_pair(x3, p, q, tw_fwd, forward, scale, in_pass=None):
    """four_step_pair_c64 on a complex (q, p, B) array x3 (the column leg's
    output), in f64 with the f32 tables: fft_pair with FourStepPlanes, the
    inverse on the planes exchanged with the forward (q, p) twiddle
    `tw_fwd` (complex), in the design `in_pass` (the one built at p's
    height by default). Returns the natural-order (p*q, B) output."""
    geo = sv.four_step_pair_geometry(p)
    if in_pass is None:
        in_pass = geo.rows in sv.B3_PASS_ROWS[geo.ranks]
    b = x3.shape[-1]
    io = _FourStepPlanes(b, p, q, tw_fwd, geo, in_pass)
    out = emulate_fft_pair(x3, p, forward, scale, geo, np.float32, io)
    return out.reshape(p * q, b)


def _chirp_passes(pair, n, m, real, chirps, read=None):
    """bluestein_pair's passes on a filled _Pair: input row r < n of the
    tiles' columns through `read(r, col)` (the policy's `input`; by default
    ChirpPlanes', rows [0, n0) on rank 0, [n0, n) on rank 1), times the
    input chirp on the first forward read (rank 1 also times W_M^row), wt on
    the last forward store, the inverse passes. Returns the inverse tables,
    for the join."""
    fw = _cplx(sv.pair_tables(m, True, real))
    iv = _cplx(sv.pair_tables(m, False, real))
    xt, wt = _cplx(chirps[0]), _cplx(chirps[1])
    n0 = (n + 1) // 2
    if read is None:
        read = lambda r, col: np.where(r < n0, pair.load(0, r, col), pair.load(1, r, col))

    def chirp_in(rank, row, col):
        inside = row < n
        r = np.where(inside, row, 0)
        a = read(r, col)
        v = a * xt[r]
        if rank == 1:
            v = v * fw[row]
        return np.where(inside, v, 0.0)

    def times_w(rank, row, v):
        return v * wt[2 * row + rank]

    schedule = sv.pass_schedule(pair.rows)
    pair.passes(schedule, fw, True, chirp_in, times_w)
    pair.passes(schedule, iv, False, pair.load)
    return iv


def _join(pair, p, iv, c):
    """pair_join: (E[p] + W_M^-p * O[p]) * c at rows p (a column array) of
    every column of the tiles, E from rank 0, O from rank 1."""
    ccol = np.arange(pair.cols)
    e = pair.bufs[0][:, pair.index(p, ccol)]
    o = pair.bufs[1][:, pair.index(p, ccol)]
    return (e + iv[p] * o) * c


def emulate_chirp_pair(x, n, m, chirps, scale, geo, real):
    """bluestein_pair (B2 at float, B7 at double) on a complex (n, B) array
    x, in f64 with the tables of pair_tables narrowed to `real`."""
    cols = geo.cols
    xo = _cplx(chirps[2])
    b = x.shape[1]
    ntiles = -(-b // cols)
    out = np.full((n, b), np.nan, complex)
    n0 = (n + 1) // 2  # rank 0 copies input rows [0, n0), rank 1 [n0, n)
    itemsize = np.dtype(real).itemsize
    for t0 in range(0, ntiles, CLUSTERS):
        tiles = np.arange(t0, min(ntiles, t0 + CLUSTERS))
        cidx, valid = _tile_columns(tiles, cols, b)
        pair = _Pair(geo, itemsize, len(tiles))
        for rank, (r0, r1) in enumerate(((0, n0), (n0, n))):
            rows = np.repeat(np.arange(r0, r1), cols)
            cgrid = np.tile(np.arange(cols), r1 - r0)
            col = cidx[:, cgrid]
            pair.bufs[rank][:, pair.index(rows, cgrid)] = np.where(
                valid[:, cgrid], x[rows, np.minimum(col, b - 1)], np.nan)
        iv = _chirp_passes(pair, n, m, real, chirps)
        for r0, r1 in ((0, n0), (n0, n)):  # each rank stores its rows
            p = np.arange(r0, r1)[:, None]
            got = _join(pair, p, iv, xo[p] * scale)
            for ti in range(len(tiles)):
                out[r0:r1, cidx[ti][valid[ti]]] = got[ti][:, valid[ti]]
    return out


def emulate_b7_pair(x, n, m, chirps, scale):
    """bluestein_pair_c128 on a complex (n, B) array x, in f64."""
    return emulate_chirp_pair(x, n, m, chirps, scale,
                              dv.bluestein_pair_geometry(m), np.float64)


def emulate_b2_pair(x, n, m, chirps, scale):
    """bluestein_pair_c64 on a complex (n, B) array x, in f64 with the f32
    tables."""
    return emulate_chirp_pair(x, n, m, chirps, scale,
                              sv.bluestein_pair_geometry_c64(m), np.float32)


def emulate_b5a_pair(x, n, m, chirps):
    """rfft_odd_pack_pair_c64 on a real (n, B) array x, n odd, in f64 with
    the f32 tables: the h = ceil(B/2) column pairs walked, z = x_j +
    i*x_{j+h} copied (the partner of an unpaired last column written as
    zeros), B2's passes, and the separation of the bins k < L, split
    between the ranks, into X1 (column j) and X2 (column j + h)."""
    geo = sv.rfft_odd_pack_geometry(m)
    cols = geo.cols
    xo = _cplx(chirps[2])
    b = x.shape[1]
    half, nbins = (b + 1) // 2, (n + 1) // 2
    ntiles = -(-half // cols)
    out = np.full((nbins, b), np.nan, complex)
    n0, k_half = (n + 1) // 2, (nbins + 1) // 2
    for t0 in range(0, ntiles, CLUSTERS):
        tiles = np.arange(t0, min(ntiles, t0 + CLUSTERS))
        cidx, valid = _tile_columns(tiles, cols, half)
        pair = _Pair(geo, 4, len(tiles))
        for rank, (r0, r1) in enumerate(((0, n0), (n0, n))):
            rows = np.repeat(np.arange(r0, r1), cols)
            cgrid = np.tile(np.arange(cols), r1 - r0)
            j, ok = cidx[:, cgrid], valid[:, cgrid]
            jp = j + half
            partner = np.where(jp < b, x[rows, np.minimum(jp, b - 1)], 0.0)
            z = np.where(ok, x[rows, np.minimum(j, b - 1)] + 1j * partner, np.nan)
            # The zeroed partners: copied columns whose partner is past B.
            assert np.all(z.imag[ok & (jp >= b)] == 0.0)
            pair.bufs[rank][:, pair.index(rows, cgrid)] = z
        iv = _chirp_passes(pair, n, m, np.float32, chirps)
        for k0, k1 in ((0, k_half), (k_half, nbins)):  # each rank's bins
            k = np.arange(k0, k1)[:, None]
            kr = np.where(k == 0, 0, n - k)
            z = _join(pair, k, iv, xo[k])
            c = np.conj(_join(pair, kr, iv, xo[kr]))
            x1, x2 = 0.5 * (z + c), -0.5j * (z - c)
            for ti in range(len(tiles)):
                js = cidx[ti][valid[ti]]
                out[k0:k1, js] = x1[ti][:, valid[ti]]
                paired = js + half < b
                out[k0:k1, js[paired] + half] = x2[ti][:, valid[ti]][:, paired]
    return out


def emulate_b5b_pair(spec, n, m, chirps):
    """irfft_odd_unpack_pair_c64 on a complex (L, B) one-sided spectrum, n
    odd, in f64 with the f32 tables: the h = ceil(B/2) column pairs walked,
    bins [0, L) of column j copied on rank 0 and of column j + h on rank 1
    (written as zeros where j + h >= B, and the DC bin's imaginary row as
    zeros), Z formed on the first forward read from bin k = p (p < L) or
    n - p of both ranks (the Hermitian tail an index), B2's passes and join times
    xo / n, the real part to column j and the imaginary part to column
    j + h: the real (n, B) signal."""
    geo = sv.irfft_odd_unpack_geometry(m)
    cols = geo.cols
    xo = _cplx(chirps[2])
    b = spec.shape[1]
    half, nbins = (b + 1) // 2, (n + 1) // 2
    ntiles = -(-half // cols)
    out = np.full((n, b), np.nan)
    rows = np.repeat(np.arange(nbins), cols)
    cgrid = np.tile(np.arange(cols), nbins)
    for t0 in range(0, ntiles, CLUSTERS):
        tiles = np.arange(t0, min(ntiles, t0 + CLUSTERS))
        cidx, valid = _tile_columns(tiles, cols, half)
        pair = _Pair(geo, 4, len(tiles))
        j, ok = cidx[:, cgrid], valid[:, cgrid]
        for rank in (0, 1):
            src = j + rank * half
            v = np.where(src < b, spec[rows, np.minimum(src, b - 1)], 0.0)
            # The zeroed partners: copied columns whose partner is past B.
            assert np.all(v[ok & (src >= b)] == 0.0)
            v = np.where(rows == 0, v.real, v)  # the DC bin's imaginary row: zeros
            pair.bufs[rank][:, pair.index(rows, cgrid)] = np.where(ok, v, np.nan)

        def z_in(row, col):  # OddUnpackPlanes::input
            head = row < nbins
            k = np.where(head, row, n - row)
            x1, x2 = pair.load(0, k, col), pair.load(1, k, col)
            return np.where(head, x1 + 1j * x2, np.conj(x1) + 1j * np.conj(x2))

        iv = _chirp_passes(pair, n, m, np.float32, chirps, z_in)
        for r0, r1 in ((0, nbins), (nbins, n)):  # each rank stores its rows
            p = np.arange(r0, r1)[:, None]
            z = _join(pair, p, iv, xo[p] / n)
            for ti in range(len(tiles)):
                js = cidx[ti][valid[ti]]
                zt = z[ti][:, valid[ti]]
                out[r0:r1, js] = zt.real
                paired = js + half < b
                out[r0:r1, js[paired] + half] = zt[:, paired].imag
    return out


def emulate_b4b_pair(spec, m, w):
    """irfft_unpack_pair_c64 on a complex (m+1, B) one-sided spectrum, in f64
    with the f32 tables: rank r copies spectrum rows [r*h, (r+1)*h); the
    first inverse pass's read of split row p forms Z[p] from X[p] (rank 0)
    and X[m-p] (rank 1's row h-p, the Nyquist row X[m] from the input at
    p = 0) and Z[p+h] from X[p+h] (rank 1) and X[h-p] (rank 0's row h-p,
    rank 1's row 0 at p = 0), X[0]'s imaginary row written as zeros at the
    copy and X[m] read as real, w[p + h] formed as -i*w[p] (loaded at
    h = 256), then the radix-2 split; the inverse passes; rank r's row j is z[2j + r],
    stored to real rows 4j + 2r and 4j + 2r + 1: the real (2m, B) signal."""
    geo = sv.irfft_unpack_geometry(m)
    h, cols = geo.rows, geo.cols
    tab = _cplx(sv.pair_tables(m, False, np.float32))
    wc = _cplx(w)
    hh = float(np.float32(0.5 / m))
    b = spec.shape[1]
    ntiles = -(-b // cols)
    out = np.full((2 * m, b), np.nan)
    rows = np.repeat(np.arange(h), cols)
    cgrid = np.tile(np.arange(cols), h)
    for t0 in range(0, ntiles, CLUSTERS):
        tiles = np.arange(t0, min(ntiles, t0 + CLUSTERS))
        cidx, valid = _tile_columns(tiles, cols, b)
        pair = _Pair(geo, 4, len(tiles))
        col = cidx[:, cgrid]
        for rank in (0, 1):
            v = spec[rank * h + rows, np.minimum(col, b - 1)]
            if rank == 0:  # X[0]'s imaginary row: zeros
                v = np.where(rows == 0, v.real, v)
            pair.bufs[rank][:, pair.index(rows, cgrid)] = np.where(valid[:, cgrid], v, np.nan)
        # X[m] of the tiles' columns, read from the input (0 past B).
        nyquist = np.where(valid, spec[m, np.minimum(cidx, b - 1)].real, 0.0)

        def unpack(x, xm, w):  # E[k] + i*conj(w^k)*O[k], 1/n folded into hh
            return hh * (x + np.conj(xm)) + 1j * np.conj(w) * hh * (x - np.conj(xm))

        def split(rank, row, col):
            head = row == 0
            q = np.where(head, 0, h - row)
            c = np.where(head, nyquist[:, col], pair.load(1, q, col))
            d = np.where(head, pair.load(1, q, col), pair.load(0, q, col))
            w = wc[row]  # w[p + h] = -i * w[p], loaded at h = 256
            z0 = unpack(pair.load(0, row, col), c, w)
            z1 = unpack(pair.load(1, row, col), d, wc[row + h] if h == 256 else -1j * w)
            return z0 + z1 if rank == 0 else (z0 - z1) * tab[row]

        pair.passes(sv.pass_schedule(h), tab, False, split)
        j, ccol = np.arange(h)[:, None], np.arange(cols)
        for rank in (0, 1):
            z = pair.bufs[rank][:, pair.index(j, ccol)]
            q = (2 * j + rank)[:, 0]
            for ti in range(len(tiles)):
                zt = z[ti][:, valid[ti]]
                js = cidx[ti][valid[ti]][None, :]
                out[2 * q[:, None], js] = zt.real
                out[2 * q[:, None] + 1, js] = zt.imag
    return out


# -- geometry ------------------------------------------------------------------


def test_b4a_pair_geometry_over_its_domain():
    keep = []
    for m in B1_DOMAIN:
        geo = sv.rfft_pack_geometry(m)
        if geo is None:
            keep.append(m)
            continue
        h = m // 2
        assert geo.rows == h and geo.cols % 8 == 0 and geo.cols & (geo.cols - 1) == 0
        assert 8 * 4 == sv.PAIR_RUN_BYTES  # a group's run: 8 f32 columns
        assert geo.smem == 4 * h * geo.cols * 4 <= SMEM_PER_BLOCK
        assert geo.threads == sv.PAIR_THREADS == 512
        assert geo.threads * sv.PAIR_POINTS >= h * geo.cols
        # The widest tile, but one group where two (64-byte rows) would fit
        # and h is not a power of two.
        assert geo.threads * sv.PAIR_POINTS < 2 * h * geo.cols or geo.cols == 8
        assert h % (1 << _rpl_log(geo.cols, 4)) == 0
        sched = sv.pass_schedule(h)
        assert np.prod(sched) == h and len(sched) >= 2
        rows = np.arange(h)
        assert np.array_equal(np.sort(_swizzle(rows, _rpl_log(geo.cols, 4))), rows)
    # The stage body stays the kernel for odd m and above m = 2048, where a
    # tile of 32-byte runs needs more than 512 threads (the double buffer
    # would fit up to m = 3632: 64 m bytes).
    assert 64 * 3632 <= SMEM_PER_BLOCK < 64 * 3640
    assert keep == [m for m in B1_DOMAIN if m % 2 or m > sv.PAIR_MAX_M]
    assert {243, 625, 729, 2187, 3125, 4096, 8192, 16384} <= set(keep)
    assert max(B4A_PAIR) == 2048 and min(m for m in keep if m % 2 == 0) == 2160
    assert sv.rfft_pack_geometry(2048) == sv.PairGeometry(1024, 8, 512, 131072)
    # One compiled body per size: the engine lists exactly these m/2.
    assert _xmacro("stockham_pair.cuh", "FOURIER_PAIR_ROWS") == [m // 2 for m in B4A_PAIR]
    assert list(sv.PAIR_ROWS) == [m // 2 for m in B4A_PAIR]
    assert "FOURIER_PAIR_ROWS(FOURIER_B4A_CASE)" in (CSRC / "rfft_pack_pair.cu").read_text()


def test_b7_pair_geometry_over_its_domain():
    for m in B7_INNER:
        geo = dv.bluestein_pair_geometry(m)
        h = m // 2
        assert geo.rows == h and geo.cols % 4 == 0 and geo.cols * 8 >= sv.PAIR_RUN_BYTES
        assert geo.smem == 4 * h * geo.cols * 8 <= SMEM_PER_BLOCK
        assert geo.threads == dv.PAIR_THREADS_DD
        assert geo.threads * sv.PAIR_POINTS >= h * geo.cols
        sched = sv.pass_schedule(h)
        assert np.prod(sched) == h and set(sched) <= {2, 4, 8, 16}
    assert dv.bluestein_pair_geometry(2048) == sv.PairGeometry(1024, 4, 256, 131072)
    assert sv.pass_schedule(1024) == (16, 16, 4) and sv.pass_schedule(512) == (16, 16, 2)
    assert sv.pass_schedule(96) == (3, 2, 16) and sv.pass_schedule(500) == (5, 5, 5, 4)
    assert sv.pass_schedule(960) == (3, 5, 8, 8) and sv.pass_schedule(480) == (3, 5, 2, 16)
    assert sv.rfft_pack_geometry(960).cols == 8 and sv.rfft_pack_geometry(1024).cols == 16


def test_b1_pair_geometry_over_its_domain():
    quad = []
    for n in B1_PAIR:
        geo = sv.fft_pair_geometry(n)
        c = geo.ranks
        assert c == (2 if n <= sv.PAIR_MAX_M else 4), n
        h = n // c
        assert geo == sv.pair_geometry(n, 4, sv.PAIR_THREADS, c)
        assert geo.rows == h and h in sv.PAIR_ROWS and h in sv.FFT_PAIR_ROWS[c]
        assert geo.cols % 8 == 0 and geo.cols & (geo.cols - 1) == 0
        assert geo.smem == 4 * h * geo.cols * 4 <= SMEM_PER_BLOCK
        assert geo.threads == 512 and geo.threads * sv.PAIR_POINTS >= h * geo.cols
        if c == 4:
            quad.append(n)
    # Two-block clusters for the 46 n with 8 | n up to 2048, four-block ones
    # for the 14 n in (2048, 4096] whose n/4 is a two-block height.
    assert [n for n in B1_PAIR if n <= 2048] == [
        n for n in B1_DOMAIN if n % 8 == 0 and n <= 2048]
    assert quad == [2160, 2304, 2400, 2560, 2592, 2880, 3072, 3200, 3456, 3600,
                    3840, 3888, 4000, 4096]
    assert len(B1_PAIR) == 60
    keep = set(B1_DOMAIN) - set(B1_PAIR)
    assert {243, 625, 729, 2187, 3000, 3125, 3240, 4320, 6561} <= keep
    assert all(n in keep for n in B1_DOMAIN if n > 4096)
    assert sv.fft_pair_geometry(4096) == sv.PairGeometry(1024, 8, 512, 131072, 4)
    assert sv.fft_pair_geometry(2048) == sv.PairGeometry(1024, 8, 512, 131072, 2)
    assert sv.fft_pair_geometry(2160) == sv.PairGeometry(540, 8, 512, 69120, 4)
    assert sv.fft_pair_geometry(256).cols == 64
    # One compiled body per (clusters, height): the kernel file lists these.
    assert "FOURIER_PAIR_ROWS(FOURIER_B1_PAIR_CASE)" in (CSRC / "fft_pair.cu").read_text()
    assert [n // 2 for n in B1_PAIR if n <= 2048] == list(sv.FFT_PAIR_ROWS[2])
    assert _xmacro("stockham_pair.cuh", "FOURIER_B1_QUAD_ROWS") == [
        n // 4 for n in quad] == list(sv.FFT_PAIR_ROWS[4])


def test_b2_pair_geometry_over_its_domain():
    pair = [m for m in B2_INNER if sv.bluestein_pair_geometry_c64(m)]
    # Every inner size up to 2048 is a paired-block height's 2h, and all
    # but M = 1024 (whose body spilled) run the paired body.
    assert set(m // 2 for m in B2_INNER if m <= 2048) <= set(sv.PAIR_ROWS)
    assert pair == [m for m in B2_INNER if m <= 2048 and m != 1024]
    assert 1024 in B2_INNER and 2160 in B2_INNER and max(B2_INNER) == 8192
    for m in pair:
        geo = sv.bluestein_pair_geometry_c64(m)
        assert geo == sv.pair_geometry(m, 4, sv.PAIR_THREADS) and geo.ranks == 2
        assert geo.smem <= SMEM_PER_BLOCK and geo.threads == 512
        # The input rows lie in rank 0's half of the padded column.
        assert max(n for n in range(17, 4097)
                   if VpuBluesteinPlan.choose_inner(n, 8192) == m) <= geo.rows
    assert sv.bluestein_pair_geometry_c64(2048) == sv.PairGeometry(1024, 8, 512, 131072, 2)
    assert sv.bluestein_pair_geometry_c64(1024) is None
    assert sv.bluestein_pair_geometry_c64(2160) is None
    assert _xmacro("stockham_pair.cuh", "FOURIER_B2_ROWS") == [
        h for h in sv.PAIR_ROWS if h != 512] == list(sv.BLUESTEIN_PAIR_ROWS)


def test_b5a_pair_geometry_over_its_domain():
    """B5a's paired bodies are B2's but M = 480: every inner size M up to
    2048 that a VpuBluesteinPlan takes but 480 and 1024, with B2's tile (now
    of column pairs); the stage body keeps those, M above 2048 and
    B5A_STAGE_FASTER."""
    pair = [m for m in B2_INNER if sv.rfft_odd_pack_geometry(m)]
    assert pair == [m for m in B2_INNER if m <= 2048 and m not in (480, 1024)]
    for m in pair:
        assert sv.rfft_odd_pack_geometry(m) == sv.bluestein_pair_geometry_c64(m)
    assert sv.rfft_odd_pack_geometry(480) is None and sv.bluestein_pair_geometry_c64(480)
    assert sv.B5A_STAGE_FASTER <= set(pair)
    # The odd n of the fused rfft routes (769..1023 plan their inner
    # 1600..2048) and the input rows in rank 0's half of the padded column.
    for n in range(769, 1025, 2):
        m = VpuBluesteinPlan.choose_inner(n, 8192)
        assert m in pair and n <= m // 2, n
    assert sv.rfft_odd_pack_geometry(2048) == sv.PairGeometry(1024, 8, 512, 131072, 2)
    # One compiled body per M/2 in FOURIER_B5A_ROWS, which rfft_odd_pair.cu
    # instantiates.
    assert "FOURIER_B5A_ROWS(FOURIER_B5A_CASE)" in (CSRC / "rfft_odd_pair.cu").read_text()
    assert _xmacro("rfft_odd_pair.cu", "FOURIER_B5A_ROWS") == [
        m // 2 for m in pair] == list(sv.RFFT_ODD_PAIR_ROWS)


def test_b4b_pair_geometry_over_its_domain():
    """B4b's paired bodies are B4a's backwards: every even m up to 2048 of
    B1's domain but 1728, with B4a's tile of m/2 spectrum rows a rank (row m,
    the Nyquist row, on neither); the stage body keeps odd m, 1728, m above
    2048 and B4B_STAGE_FASTER."""
    pair = [m for m in B1_DOMAIN if sv.irfft_unpack_geometry(m)]
    assert pair == [m for m in B4A_PAIR if m // 2 in sv.IRFFT_UNPACK_PAIR_ROWS]
    assert set(sv.IRFFT_UNPACK_PAIR_ROWS) <= set(sv.PAIR_ROWS)
    for m in pair:
        geo = sv.irfft_unpack_geometry(m)
        assert geo == sv.rfft_pack_geometry(m) and 2 * geo.rows == m
    assert sv.B4B_STAGE_FASTER <= set(pair)
    assert sv.irfft_unpack_geometry(2048) == sv.PairGeometry(1024, 8, 512, 131072, 2)
    assert all(sv.irfft_unpack_geometry(m) is None for m in (243, 625, 729, 1728, 2160, 4096))
    assert len(pair) == len(B4A_PAIR) - 1
    # One compiled body per m/2 in FOURIER_B4B_ROWS, which
    # irfft_unpack_pair.cu instantiates.
    src = (CSRC / "irfft_unpack_pair.cu").read_text()
    assert "FOURIER_B4B_ROWS(FOURIER_B4B_CASE)" in src
    assert _xmacro("irfft_unpack_pair.cu", "FOURIER_B4B_ROWS") == [
        m // 2 for m in pair] == list(sv.IRFFT_UNPACK_PAIR_ROWS)


def test_b5b_pair_geometry_over_its_domain():
    """B5b's paired bodies are at B2's inner sizes, with B2's tile (of
    column pairs): every inner size M up to 2048 that a VpuBluesteinPlan
    takes but 1024; the stage body keeps those, M above 2048 and
    B5B_STAGE_FASTER. A rank's tile holds the L = (n+1)/2 bins it copies."""
    pair = [m for m in B2_INNER if sv.irfft_odd_unpack_geometry(m)]
    assert pair == [m for m in B2_INNER if m // 2 in sv.IRFFT_ODD_PAIR_ROWS]
    assert set(sv.IRFFT_ODD_PAIR_ROWS) <= set(sv.BLUESTEIN_PAIR_ROWS)
    for m in pair:
        geo = sv.irfft_odd_unpack_geometry(m)
        assert geo == sv.bluestein_pair_geometry_c64(m)
        n = max(n for n in range(17, 4097) if VpuBluesteinPlan.choose_inner(n, 8192) == m)
        assert (n + 1) // 2 <= n <= geo.rows
    assert sv.B5B_STAGE_FASTER <= set(pair)
    assert sv.irfft_odd_unpack_geometry(2048) == sv.PairGeometry(1024, 8, 512, 131072, 2)
    assert sv.irfft_odd_unpack_geometry(1024) is None
    assert sv.irfft_odd_unpack_geometry(2160) is None
    src = (CSRC / "irfft_odd_pair.cu").read_text()
    assert "FOURIER_B5B_ROWS(FOURIER_B5B_CASE)" in src
    assert _xmacro("irfft_odd_pair.cu", "FOURIER_B5B_ROWS") == [
        m // 2 for m in pair] == list(sv.IRFFT_ODD_PAIR_ROWS)


def test_b6_pair_geometry_over_its_domain():
    """B6's clustered bodies are B1's 60 sizes at double: two blocks for
    8 | n up to 2048, four for the 14 n in (2048, 4096]; 256 threads, 32-byte
    runs of 4 f64 columns at the largest height; the stage body keeps 243,
    625, 729, 3000 and 3240."""
    assert B6_PAIR == B1_PAIR and len(B6_PAIR) == 60
    assert sorted(set(B6_DOMAIN) - set(B6_PAIR)) == [243, 625, 729, 3000, 3240]
    assert dv.B6_STAGE_FASTER <= set(B6_PAIR)
    for n in B6_PAIR:
        geo = dv.fft_pair_geometry_dd(n)
        c = geo.ranks
        assert c == (2 if n <= 2048 else 4) and geo.rows == n // c
        assert geo.rows in sv.FFT_PAIR_ROWS[c]
        assert geo == sv.pair_geometry(n, 8, dv.PAIR_THREADS_DD, c)
        assert geo.cols % 4 == 0 and geo.cols & (geo.cols - 1) == 0
        assert geo.smem == 4 * geo.rows * geo.cols * 8 <= SMEM_PER_BLOCK
        assert geo.threads == 256 and geo.threads * sv.PAIR_POINTS >= geo.rows * geo.cols
        assert geo.rows % (1 << _rpl_log(geo.cols, 8)) == 0
    assert dv.fft_pair_geometry_dd(4096) == sv.PairGeometry(1024, 4, 256, 131072, 4)
    assert dv.fft_pair_geometry_dd(2048) == sv.PairGeometry(1024, 4, 256, 131072, 2)
    assert dv.fft_pair_geometry_dd(1024) == sv.PairGeometry(512, 8, 256, 131072, 2)
    assert dv.fft_pair_geometry_dd(2160) == sv.PairGeometry(540, 4, 256, 69120, 4)
    # The stage body's 2 columns at n = 4096 (16-byte runs) against 4 here.
    assert dv.launch_geometry_dd(4096)[0] == 2
    # One compiled body per (clusters, height), from the engine's lists.
    src = (CSRC / "fft_pair_dd.cu").read_text()
    assert "FOURIER_PAIR_ROWS(FOURIER_B6_PAIR_CASE)" in src
    assert "FOURIER_B1_QUAD_ROWS(FOURIER_B6_QUAD_CASE)" in src
    assert _xmacro("stockham_pair.cuh", "FOURIER_PAIR_ROWS") == [
        n // 2 for n in B6_PAIR if n <= 2048]
    assert _xmacro("stockham_pair.cuh", "FOURIER_B1_QUAD_ROWS") == [
        n // 4 for n in B6_PAIR if n > 2048]


@pytest.mark.parametrize("lib,entry_points", [
    (sv.FFT_PAIR_LIBRARY, sv.FFT_PAIR_ENTRY_POINTS),
    (sv.BLUESTEIN_PAIR_LIBRARY, sv.BLUESTEIN_PAIR_ENTRY_POINTS),
    (sv.RFFT_ODD_PAIR_LIBRARY, sv.RFFT_ODD_PAIR_ENTRY_POINTS),
    (sv.IRFFT_UNPACK_PAIR_LIBRARY, sv.IRFFT_UNPACK_PAIR_ENTRY_POINTS),
    (sv.IRFFT_ODD_PAIR_LIBRARY, sv.IRFFT_ODD_PAIR_ENTRY_POINTS),
    (dv.FFT_PAIR_DD_LIBRARY, dv.FFT_PAIR_DD_ENTRY_POINTS),
    (sv.FFT_PAIR_STRIDED_LIBRARY, sv.FFT_PAIR_STRIDED_ENTRY_POINTS)])
def test_b1_b2_library_entry_points(lib, entry_points):
    """The clustered-block libraries of B1 (on planes and on complex64 where
    it lies), B2, B4b, B5a, B5b and B6 include the engine and define each entry point their wrappers bind with as many
    parameters; every library is built apart."""
    from fourier_tpu_torch.ops.cuda import build

    src = (build.CSRC / f"{lib}.cu").read_text()
    assert '#include "stockham_pair.cuh"' in src
    for fn_name, argtypes in [*entry_points.items(),
                              ("fourier_cuda_error_string", [int])]:
        m = re.search(rf"\b{fn_name}\(([^)]*)\)\s*{{", src)
        assert m is not None, fn_name
        assert len(m.group(1).split(",")) == len(argtypes), fn_name
    libs = (sv.LIBRARY, sv.PAIR_LIBRARY, sv.FFT_PAIR_LIBRARY,
            sv.BLUESTEIN_PAIR_LIBRARY, sv.RFFT_ODD_PAIR_LIBRARY,
            sv.IRFFT_UNPACK_PAIR_LIBRARY, sv.IRFFT_ODD_PAIR_LIBRARY, dv.LIBRARY,
            dv.FFT_PAIR_DD_LIBRARY, sv.FFT_PAIR_STRIDED_LIBRARY)
    assert len({build.library_path(name) for name in libs}) == len(libs)


def test_pair_tables_four_ranks():
    n, h = 4096, 1024
    tab = _cplx(sv.pair_tables(n, True, np.float64, 4))
    p = np.arange(h)
    for r in (1, 2, 3):
        assert np.allclose(tab[(r - 1) * h:r * h], np.exp(-2j * np.pi * r * p / n),
                           atol=1e-15)
    rest = _cplx(sv.kernel_tables(h, sv.pass_schedule(h), True))
    assert np.array_equal(tab[3 * h:], rest)
    assert np.array_equal(sv.pair_tables(2048, False), sv.pair_tables(2048, False, ranks=2))


def test_pair_library_entry_point():
    """B4a's paired-block library includes the engine and defines the entry
    point its wrapper binds with as many parameters; it is built apart from
    the stage library."""
    from fourier_tpu_torch.ops.cuda import build

    src = (build.CSRC / f"{sv.PAIR_LIBRARY}.cu").read_text()
    assert '#include "stockham_pair.cuh"' in src
    for fn_name, argtypes in [*sv.PAIR_ENTRY_POINTS.items(),
                              ("fourier_cuda_error_string", [int])]:
        m = re.search(rf"\b{fn_name}\(([^)]*)\)\s*{{", src)
        assert m is not None, fn_name
        assert len(m.group(1).split(",")) == len(argtypes), fn_name
    assert build.library_path(sv.PAIR_LIBRARY) != build.library_path(sv.LIBRARY)


def test_pair_tables():
    m = 2048
    tab = _cplx(sv.pair_tables(m, True))
    p = np.arange(m // 2)
    assert np.allclose(tab[:m // 2], np.exp(-2j * np.pi * p / m), atol=1e-15)
    assert np.allclose(_cplx(sv.pair_tables(m, False))[:m // 2],
                       np.exp(2j * np.pi * p / m), atol=1e-15)
    assert sv.pair_tables(m, True, np.float32).dtype == np.float32


# -- the bodies ------------------------------------------------------------------


_PLANS = {}


def _rfft_plan(m):
    if m not in _PLANS:
        _PLANS[m] = RfftPlan(2 * m, backend="vpu", device="cpu")
    return _PLANS[m]


@pytest.mark.parametrize("m", B4A_PAIR)
def test_b4a_pair_body_emulated(m):
    plan = _rfft_plan(m)
    assert plan.fused and plan.m == m
    rng = np.random.default_rng(RNG_SEED + m)
    for b in BATCHES:
        x = rng.standard_normal((2 * m, b)).astype(np.float32)
        got = emulate_b4a_pair(x.astype(np.float64), m, plan.w.numpy())
        assert np.isfinite(got).all(), (m, b)
        assert _rel(got, np.fft.rfft(x.astype(np.float64), axis=0)) <= C64_GATE, (m, b)
        pre, pim = sv.vpu_rfft_pack_batch_minor_reference(
            torch.as_tensor(x), m, plan.inner.tables(True), plan.w)
        assert _rel(got, pre.double().numpy() + 1j * pim.double().numpy()) <= C64_GATE


def _b7_sizes():
    """(n, M) at the least and the greatest n of each inner size M that
    plans a VpuDdBluesteinPlan, and n = 1013."""
    out = []
    for m in B7_INNER:
        ns = [n for n in range(m // 4 + 1, m // 2 + 1)
              if VpuDdBluesteinPlan.create(n, device="cpu") is not None
              and VpuDdBluesteinPlan.create(n, device="cpu").m_inner == m]
        out += sorted({(ns[0], m), (ns[-1], m)})
    return out + [(1013, 2048)]


@pytest.mark.parametrize("n,m", _b7_sizes())
def test_b7_pair_body_emulated(n, m):
    plan = VpuDdBluesteinPlan.create(n, device="cpu")
    assert plan.m_inner == m
    st = plan.stages
    tables = (st.tables(True), st.tables(False))
    rng = np.random.default_rng(RNG_SEED + n)
    for b in BATCHES:
        x = rng.standard_normal((n, b)) + 1j * rng.standard_normal((n, b))
        modes = list(Transform) if b == 7 else [Transform.FFT]
        for mode in modes:
            scale = mode.scale(n)
            chirps = plan.chirps(mode.is_forward)
            got = emulate_b7_pair(x, n, m, [c.numpy() for c in chirps],
                                  1.0 if scale is None else scale)
            want = (np.fft.fft(x, axis=0) if mode.is_forward
                    else np.fft.ifft(x, axis=0) * n) * (scale or 1.0)
            assert np.isfinite(got).all()
            assert _rel(got, want) <= C128_GATE, (n, b, mode)
            pre, pim = dv.vpu_dd_bluestein_batch_minor_reference(
                torch.as_tensor(x.real.copy()), torch.as_tensor(x.imag.copy()), n, m,
                tables, chirps, scale)
            assert _rel(got, pre.numpy() + 1j * pim.numpy()) <= C128_GATE


def _modes(b):
    """Every mode at B = 7; a forward and an inverse one at the others."""
    return list(Transform) if b == 7 else [Transform.FFT, Transform.UNSCALED_IFFT]


def _want(x, mode, n):
    return (np.fft.fft(x, axis=0) if mode.is_forward
            else np.fft.ifft(x, axis=0) * n) * (mode.scale(n) or 1.0)


@pytest.mark.parametrize("n", [64, 96, 1000, 2048, 2160, 3888, 4096])
def test_b1_pair_body_emulated(n):
    plan = VpuFftPlan.create(n, device="cpu")
    rng = np.random.default_rng(RNG_SEED + n)
    for b in BATCHES:
        x = (rng.standard_normal((n, b)) + 1j * rng.standard_normal((n, b))).astype(np.complex64)
        for mode in _modes(b):
            fwd, scale = mode.is_forward, mode.scale(n)
            got = emulate_b1_pair(x.astype(np.complex128), n, fwd,
                                  1.0 if scale is None else scale)
            assert np.isfinite(got).all(), (n, b, mode)
            assert _rel(got, _want(x.astype(np.complex128), mode, n)) <= C64_GATE, (n, b, mode)
            pre, pim = sv.vpu_fft_batch_minor_reference(
                torch.as_tensor(x.real.copy()), torch.as_tensor(x.imag.copy()), n,
                plan.tables(fwd), fwd, scale)
            assert _rel(got, pre.double().numpy() + 1j * pim.double().numpy()) <= C64_GATE


# (kernel, size, columns, bytes): the bytes of split.cluster_bytes a
# launch, (C-1)/C of both planes; B3 at p = 256 over q * B = 16 * 65.
SPLIT_BYTES = [("B1", 4096, 16384, 402_653_184), ("B1", 2048, 1000, 8_192_000),
               ("B6", 4096, 7, 344_064), ("B3", 256, 16 * 65, 1_064_960)]


@pytest.mark.parametrize("kernel,n,b,want", SPLIT_BYTES)
def test_split_cluster_bytes(kernel, n, b, want):
    """The count a wrapper adds at each launch of a clustered fft_pair body:
    the bytes its push split sends from one block of a cluster to another."""
    geo = sv.clustered_geometry(kernel, n)
    itemsize = 8 if kernel == "B6" else 4
    assert geo is not None and geo.ranks == (4 if n > 2048 else 2)
    before = trace.counters().snapshot()
    sv.count_split_bytes(geo.ranks, n, b, itemsize)
    assert trace.counters().delta(before) == {"split.cluster_bytes": want}


@pytest.mark.parametrize("n,m", [(17, 64), (73, 160), (769, 1600), (1013, 2048)])
def test_b2_pair_body_emulated(n, m):
    plan = VpuBluesteinPlan.create(n, device="cpu")
    assert plan.m_inner == m
    st = plan.stages
    tables = (st.tables(True), st.tables(False))
    rng = np.random.default_rng(RNG_SEED + n)
    for b in BATCHES:
        x = (rng.standard_normal((n, b)) + 1j * rng.standard_normal((n, b))).astype(np.complex64)
        for mode in _modes(b):
            scale = mode.scale(n)
            chirps = plan.chirps(mode.is_forward)
            got = emulate_b2_pair(x.astype(np.complex128), n, m,
                                  [c.numpy() for c in chirps],
                                  1.0 if scale is None else scale)
            assert np.isfinite(got).all(), (n, b, mode)
            assert _rel(got, _want(x.astype(np.complex128), mode, n)) <= C64_GATE, (n, b, mode)
            pre, pim = sv.vpu_bluestein_batch_minor_reference(
                torch.as_tensor(x.real.copy()), torch.as_tensor(x.imag.copy()), n, m,
                tables, chirps, scale)
            assert _rel(got, pre.double().numpy() + 1j * pim.double().numpy()) <= C64_GATE


@pytest.mark.parametrize("n,m", [(17, 64), (73, 160), (1013, 2048)])
def test_b5a_pair_body_emulated(n, m):
    """B5a's paired body at odd B (an unpaired last column against zeros),
    B = 1 (no pair at all) and a walk of several rounds ending on a ragged
    group of column pairs."""
    plan = VpuBluesteinPlan.create(n, device="cpu")
    assert plan.m_inner == m
    st = plan.stages
    tables = (st.tables(True), st.tables(False))
    chirps = plan.chirps(True)
    rng = np.random.default_rng(RNG_SEED + n)
    for b in BATCHES:
        x = rng.standard_normal((n, b)).astype(np.float32)
        got = emulate_b5a_pair(x.astype(np.float64), n, m, [c.numpy() for c in chirps])
        assert got.shape == ((n + 1) // 2, b) and np.isfinite(got).all(), (n, b)
        assert _rel(got, np.fft.rfft(x.astype(np.float64), axis=0)) <= C64_GATE, (n, b)
        pre, pim = sv.vpu_rfft_odd_pack_batch_minor_reference(
            torch.as_tensor(x), n, m, tables, chirps)
        assert _rel(got, pre.double().numpy() + 1j * pim.double().numpy()) <= C64_GATE


def _spectrum(rng, rows, b):
    """A random complex64 (rows, B) spectrum, imaginary DC (and Nyquist)
    parts included: the kernels read them as 0, as np.fft.irfft does."""
    return (rng.standard_normal((rows, b))
            + 1j * rng.standard_normal((rows, b))).astype(np.complex64)


@pytest.mark.parametrize("m", [64, 96, 512, 1000, 2048])
def test_b4b_pair_body_emulated(m):
    """B4b's paired body at B = 1, odd B and a walk of several rounds
    ending on a ragged group, against np.fft.irfft and the plain version."""
    plan = _rfft_plan(m)
    assert plan.fused and plan.m == m
    rng = np.random.default_rng(RNG_SEED + m + 1)
    for b in BATCHES:
        spec = _spectrum(rng, m + 1, b)
        got = emulate_b4b_pair(spec.astype(np.complex128), m, plan.w.numpy())
        assert got.shape == (2 * m, b) and np.isfinite(got).all(), (m, b)
        assert _rel(got, np.fft.irfft(spec.astype(np.complex128), 2 * m, axis=0)) <= C64_GATE
        p = sv.vpu_irfft_unpack_batch_minor_reference(
            torch.as_tensor(spec.real.copy()), torch.as_tensor(spec.imag.copy()), m,
            plan.inner.tables(False), plan.w)
        assert _rel(got, p.double().numpy()) <= C64_GATE, (m, b)


@pytest.mark.parametrize("n,m", [(17, 64), (73, 160), (1013, 2048)])
def test_b5b_pair_body_emulated(n, m):
    """B5b's paired body at odd B (an unpaired last column against zeros),
    B = 1 (no pair at all) and a walk of several rounds ending on a ragged
    group of column pairs, against np.fft.irfft and the plain version."""
    plan = VpuBluesteinPlan.create(n, device="cpu")
    assert plan.m_inner == m
    st = plan.stages
    tables = (st.tables(True), st.tables(False))
    chirps = plan.chirps(False)
    rng = np.random.default_rng(RNG_SEED + n + 1)
    for b in BATCHES:
        spec = _spectrum(rng, (n + 1) // 2, b)
        got = emulate_b5b_pair(spec.astype(np.complex128), n, m, [c.numpy() for c in chirps])
        assert got.shape == (n, b) and np.isfinite(got).all(), (n, b)
        assert _rel(got, np.fft.irfft(spec.astype(np.complex128), n, axis=0)) <= C64_GATE
        p = sv.vpu_irfft_odd_unpack_batch_minor_reference(
            torch.as_tensor(spec.real.copy()), torch.as_tensor(spec.imag.copy()), n, m,
            tables, chirps)
        assert _rel(got, p.double().numpy()) <= C64_GATE, (n, b)


@pytest.mark.parametrize("n", [64, 96, 1000, 1024, 2048, 2160, 3888, 4096])
def test_b6_pair_body_emulated(n):
    plan = VpuDdFftPlan.create(n, device="cpu")
    rng = np.random.default_rng(RNG_SEED + n)
    for b in BATCHES:
        x = rng.standard_normal((n, b)) + 1j * rng.standard_normal((n, b))
        for mode in _modes(b):
            fwd, scale = mode.is_forward, mode.scale(n)
            got = emulate_b6_pair(x, n, fwd, 1.0 if scale is None else scale)
            assert np.isfinite(got).all(), (n, b, mode)
            assert _rel(got, _want(x, mode, n)) <= C128_GATE, (n, b, mode)
            pre, pim = dv.vpu_dd_fft_batch_minor_reference(
                torch.as_tensor(x.real.copy()), torch.as_tensor(x.imag.copy()), n,
                plan.tables(fwd), fwd, scale)
            assert _rel(got, pre.numpy() + 1j * pim.numpy()) <= C128_GATE


def test_b5a_pair_matches_pallas_interpret():
    """B5a's paired body against the JAX package's kernel in interpret mode.
    At B = 256 the JAX lane pairing (block t with t + B/(2*128)) and the
    port's (column j with j + ceil(B/2)) coincide, column for column."""
    n, b = 17, 256
    rng = np.random.default_rng(RNG_SEED + n)
    x = rng.standard_normal((n, b)).astype(np.float32)
    jplan = JVpuBluesteinPlan.create(n, interpret=True)
    plan = VpuBluesteinPlan.create(n, device="cpu")
    assert plan.m_inner == jplan.m_inner == 64
    parts = jsv.vpu_rfft_odd_pack_batch_minor(
        x, n, jplan.m_inner, jplan.stage_tables, jplan.chirps_fwd, interpret=True)
    f = lambda t: np.asarray(t, np.float64)
    want = np.concatenate([f(parts[0]) + 1j * f(parts[1]),
                           f(parts[2]) + 1j * f(parts[3])], 1)
    got = emulate_b5a_pair(x.astype(np.float64), n, plan.m_inner,
                           [c.numpy() for c in plan.chirps(True)])
    assert want.shape == got.shape == (9, b)
    assert _rel(got, want) <= C64_GATE


def test_b4b_pair_matches_pallas_interpret():
    """B4b's paired body against the JAX package's kernel in interpret mode
    at a power of two (its _rev_rows takes only those), B = 128 (the JAX
    wrapper's lane block)."""
    m, b = 64, 128
    rng = np.random.default_rng(RNG_SEED + m)
    spec = _spectrum(rng, m + 1, b)
    jplan = JVpuFftPlan.create(m, interpret=True)
    w = _rfft_plan(m).w.numpy()
    want = np.asarray(jsv.vpu_irfft_unpack_batch_minor(
        spec.real.copy(), spec.imag.copy(), m, jplan.inv_tables,
        (w[0].reshape(-1, 1), w[1].reshape(-1, 1)), interpret=True), np.float64)
    got = emulate_b4b_pair(spec.astype(np.complex128), m, w)
    assert want.shape == got.shape == (2 * m, b)
    assert _rel(got, want) <= C64_GATE


def test_b5b_pair_matches_pallas_interpret():
    """B5b's paired body against the JAX package's kernel in interpret mode.
    At B = 256 the JAX lane pairing (block t with t + B/(2*128)) and the
    port's (column j with j + ceil(B/2)) coincide, column for column."""
    n, b = 17, 256
    rng = np.random.default_rng(RNG_SEED + n)
    spec = _spectrum(rng, (n + 1) // 2, b)
    jplan = JVpuBluesteinPlan.create(n, interpret=True)
    plan = VpuBluesteinPlan.create(n, device="cpu")
    assert plan.m_inner == jplan.m_inner == 64
    oa, ob = jsv.vpu_irfft_odd_unpack_batch_minor(
        spec.real.copy(), spec.imag.copy(), n, jplan.m_inner, jplan.stage_tables,
        jplan.chirps_inv, interpret=True)
    want = np.concatenate([np.asarray(oa, np.float64), np.asarray(ob, np.float64)], 1)
    got = emulate_b5b_pair(spec.astype(np.complex128), n, plan.m_inner,
                           [c.numpy() for c in plan.chirps(False)])
    assert want.shape == got.shape == (n, b)
    assert _rel(got, want) <= C64_GATE


def test_b6_pair_matches_pallas_interpret():
    """B6's clustered body against the JAX package's double-word kernel in
    interpret mode (its four f32 planes recombined as hi + lo in f64)."""
    n, b = 96, 5
    rng = np.random.default_rng(RNG_SEED + n)
    x = rng.standard_normal((n, b)) + 1j * rng.standard_normal((n, b))
    ref = JVpuDdFftPlan.create(n)
    assert ref.interpret
    dd = (*ddreal.from_f64(x.real), *ddreal.from_f64(x.imag))
    rh, rl, ih, il = (np.asarray(t, np.float64) for t in ref.transform_planar_dd_bm(
        dd[0], dd[1], dd[2], dd[3], JTransform(int(Transform.IFFT))))
    want = (rh + rl) + 1j * (ih + il)
    got = emulate_b6_pair(x, n, False, Transform.IFFT.scale(n))
    assert _rel(got, want) <= C128_GATE


def test_b5a_b6_body_argument_on_the_cpu():
    """On CPU tensors B5a's and B6's wrappers run the plain version, with or
    without the paired body's tables, and count no launch."""
    bplan = VpuBluesteinPlan.create(1013, device="cpu")
    st = bplan.stages
    x = torch.randn(1013, 7)
    kw = dict(tables=(st.tables(True), st.tables(False)),
              kernel_tables=(st.kernel_fwd, st.kernel_inv), chirps=bplan.chirps(True))
    before = launches("rfft_odd_pack")
    want = sv.vpu_rfft_odd_pack_batch_minor_reference(x, 1013, st.size, kw["tables"],
                                                      kw["chirps"])
    for pair in ((None, None), (st.pair_fwd, st.pair_inv)):
        got = sv.vpu_rfft_odd_pack_batch_minor(x, 1013, st.size, pair_tables=pair, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launches("rfft_odd_pack") == before
    plan = VpuDdFftPlan.create(4096, device="cpu")
    re_ = torch.randn(4096, 3, dtype=torch.float64)
    im_ = torch.randn(4096, 3, dtype=torch.float64)
    before = launches("vpu_dd_fft")
    want = dv.vpu_dd_fft_batch_minor_reference(re_, im_, 4096, plan.tables(False), False, 0.5)
    for pair in (None, plan.pair_fwd):
        got = dv.vpu_dd_fft_batch_minor(re_, im_, 4096, False, 0.5, tables=plan.tables(False),
                                        kernel_tables=plan.kernel_inv, pair_tables=pair)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launches("vpu_dd_fft") == before


def test_b4b_b5b_body_argument_on_the_cpu():
    """On CPU tensors B4b's and B5b's wrappers run the plain version, with or
    without the paired body's tables, and count no launch."""
    plan = _rfft_plan(1024)
    re_, im_ = torch.randn(1025, 5), torch.randn(1025, 5)
    kw = dict(tables=plan.inner.tables(False), kernel_tables=plan.inner.kernel_inv,
              w=plan.w)
    before = launches("irfft_unpack")
    want = sv.vpu_irfft_unpack_batch_minor_reference(re_, im_, 1024, kw["tables"], plan.w)
    for pair in (None, plan.inner.pair_inv):
        got = sv.vpu_irfft_unpack_batch_minor(re_, im_, 1024, pair_tables=pair, **kw)
        assert torch.equal(got, want)
    assert launches("irfft_unpack") == before
    bplan = VpuBluesteinPlan.create(1013, device="cpu")
    st = bplan.stages
    re_, im_ = torch.randn(507, 7), torch.randn(507, 7)
    kw = dict(tables=(st.tables(True), st.tables(False)),
              kernel_tables=(st.kernel_fwd, st.kernel_inv), chirps=bplan.chirps(False))
    before = launches("irfft_odd_unpack")
    want = sv.vpu_irfft_odd_unpack_batch_minor_reference(re_, im_, 1013, st.size,
                                                         kw["tables"], kw["chirps"])
    for pair in ((None, None), (st.pair_fwd, st.pair_inv)):
        got = sv.vpu_irfft_odd_unpack_batch_minor(re_, im_, 1013, st.size, pair_tables=pair,
                                                  **kw)
        assert torch.equal(got, want)
    assert launches("irfft_odd_unpack") == before


def test_b1_b2_body_argument_on_the_cpu():
    """On CPU tensors B1's and B2's wrappers run the plain version, with or
    without the clustered body's tables, and count no launch."""
    plan = VpuFftPlan.create(4096, device="cpu")
    re_, im_ = torch.randn(4096, 5), torch.randn(4096, 5)
    before = launches("vpu_fft")
    want = sv.vpu_fft_batch_minor_reference(re_, im_, 4096, plan.tables(False), False, 0.5)
    for pair in (None, plan.pair_fwd):
        got = sv.vpu_fft_batch_minor(re_, im_, 4096, False, 0.5, tables=plan.tables(False),
                                     kernel_tables=plan.kernel_inv, pair_tables=pair)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launches("vpu_fft") == before
    bplan = VpuBluesteinPlan.create(1013, device="cpu")
    st = bplan.stages
    re_, im_ = torch.randn(1013, 3), torch.randn(1013, 3)
    kw = dict(tables=(st.tables(True), st.tables(False)),
              kernel_tables=(st.kernel_fwd, st.kernel_inv), chirps=bplan.chirps(True))
    before = launches("vpu_bluestein")
    want = sv.vpu_bluestein_batch_minor_reference(re_, im_, 1013, st.size, kw["tables"],
                                                  kw["chirps"], None)
    for pair in ((None, None), (st.pair_fwd, st.pair_inv)):
        got = sv.vpu_bluestein_batch_minor(re_, im_, 1013, st.size, None, pair_tables=pair,
                                           **kw)
        assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert launches("vpu_bluestein") == before


def test_body_argument_on_the_cpu():
    """On CPU tensors B4a's and B7's wrappers run the plain version, B4a's
    with or without the paired body's tables, and count no launch."""
    plan = _rfft_plan(1024)
    x = torch.randn(2048, 5)
    kw = dict(tables=plan.inner.tables(True), kernel_tables=plan.inner.kernel_fwd,
              w=plan.w)
    before = launches("rfft_pack")
    want = sv.vpu_rfft_pack_batch_minor_reference(x, 1024, kw["tables"], plan.w)
    for pair in (None, plan.inner.pair_fwd):
        got = sv.vpu_rfft_pack_batch_minor(x, 1024, pair_tables=pair, **kw)
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    assert launches("rfft_pack") == before
    bplan = VpuDdBluesteinPlan.create(100, device="cpu")
    st = bplan.stages
    re = torch.randn(100, 3, dtype=torch.float64)
    bkw = dict(tables=(st.tables(True), st.tables(False)),
               pair_tables=(st.pair_fwd, st.pair_inv), chirps=bplan.chirps(True))
    before = launches("vpu_dd_bluestein")
    want = dv.vpu_dd_bluestein_batch_minor_reference(re, re, 100, st.size, bkw["tables"],
                                                     bkw["chirps"], None)
    got = dv.vpu_dd_bluestein_batch_minor(re, re, 100, st.size, None, **bkw)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert launches("vpu_dd_bluestein") == before


# The body each kernel runs at sizes on each side of its choice: clustered or
# paired ("pair"), in its stage-faster set, with no clustered geometry, and
# for B9b splits on each side of B9B_FMA_WORK ("fma" below, "mma" from it).
BODY_AT = [
    ("B1", 64, "pair"), ("B1", 1024, "pair"), ("B1", 4096, "pair"),
    ("B1", 1000, "stage"), ("B1", 576, "stage"), ("B1", 3125, "stage"),
    ("B1", 3000, "stage"), ("B1", 8192, "stage"),
    ("B2", 160, "pair"), ("B2", 2048, "pair"), ("B2", 64, "stage"), ("B2", 1000, "stage"),
    ("B2", 1024, "stage"), ("B2", 3000, "stage"),
    ("B3", 128, "pair"), ("B3", 256, "pair"), ("B3", 512, "pair"), ("B3", 1000, "stage"),
    ("B3", 320, "stage"), ("B3", 960, "stage"), ("B3", 3125, "stage"),
    ("B4a", 64, "pair"), ("B4a", 1024, "pair"), ("B4a", 2048, "pair"),
    ("B4a", 243, "stage"), ("B4a", 2160, "stage"),
    ("B4b", 1024, "pair"), ("B4b", 2048, "pair"), ("B4b", 1000, "stage"),
    ("B4b", 1728, "stage"), ("B4b", 2160, "stage"),
    ("B5a", 160, "pair"), ("B5a", 2048, "pair"), ("B5a", 1600, "stage"),
    ("B5a", 480, "stage"), ("B5a", 1024, "stage"), ("B5a", 3000, "stage"),
    ("B5b", 1600, "pair"), ("B5b", 2048, "pair"), ("B5b", 864, "stage"),
    ("B5b", 1024, "stage"), ("B5b", 3000, "stage"),
    ("B6", 1024, "pair"), ("B6", 4096, "pair"), ("B6", 3000, "stage"), ("B6", 243, "stage"),
    ("B9b", (10, 25), "fma"), ("B9b", (19, 25), "fma"), ("B9b", (20, 25), "mma"),
    ("B9b", (25, 40), "mma"), ("B9b", (128, 128), "mma"),
]


@pytest.mark.parametrize("kernel,size,body", BODY_AT,
                         ids=[f"{k}-{s}" for k, s, _ in BODY_AT])
def test_body_rule(kernel, size, body):
    """The body a kernel runs is a function of the kernel and the size
    alone: kernel_body for the kernels of BODIES, two_phase_body for B9b."""
    got = kb.two_phase_body(*size) if kernel == "B9b" else sv.kernel_body(kernel, size)
    assert got == body


# -- B3, the four-step row leg on fft_pair -----------------------------------


def _four_step(p, q):
    """FourStepLocalPlan(p*q) over (p, q) with VpuFftPlan rows (MxuFftPlan
    columns where q has no VpuFftPlan), on the CPU."""
    return FourStepLocalPlan.create(
        p * q, torch.complex64, p, q,
        lambda m, dt, dev: VpuFftPlan.create(m, dt, dev) or MxuFftPlan.create(m, dt, dev),
        device="cpu")


def _column_leg(x_t, p, q, mode):
    """The four-step's exact column leg in f64: q-point transforms over the
    (q, p*B) view of the (n, B) input, as a (q, p, B) array."""
    c = x_t.reshape(q, p * x_t.shape[1])
    c = np.fft.fft(c, axis=0) if mode.is_forward else np.fft.ifft(c, axis=0) * q
    return c.reshape(q, p, x_t.shape[1])


def test_b3_pair_geometry_over_its_domain():
    """B3's clustered bodies are at B1's sizes with B1's tile (two blocks for
    8 | p up to 2048, four for p in (2048, 4096]) but the four heights where
    both designs spilled, 56 p; the stage body keeps those, p above 4096,
    3000, 3240, 4320, the pure powers and B3_STAGE_FASTER. Each height has
    one design: (a) at 49 of them, (b) at the other 7; every route's row
    size (32768..458752) has (a)."""
    from fourier_tpu_torch.plan.four_step_local import choose_large_split

    pair = [p for p in B1_DOMAIN if sv.four_step_pair_geometry(p)]
    assert pair == [p for p in B1_PAIR if p not in (960, 1280, 2560, 3840)]
    assert len(pair) == 56
    for p in pair:
        geo = sv.four_step_pair_geometry(p)
        assert geo == sv.fft_pair_geometry(p) and geo.threads == 512
        assert geo.cols * 4 >= 32 and geo.smem <= SMEM_PER_BLOCK
        assert (geo.rows in sv.B3_SPLIT_ROWS[geo.ranks]) != (
            geo.rows in sv.B3_PASS_ROWS[geo.ranks]), p
    in_pass = [p for p in pair if p // sv.four_step_pair_geometry(p).ranks
               in sv.B3_PASS_ROWS[sv.four_step_pair_geometry(p).ranks]]
    assert in_pass == [64, 120, 240, 1440, 3600, 3888, 4000]
    assert sv.B3_STAGE_FASTER <= set(pair)
    assert all(sv.four_step_pair_geometry(p) is None
               for p in (243, 960, 1280, 2560, 3000, 3240, 3840, 4320, 8192))
    for n in (32768, 65536, 262144, 458752):
        p, _ = choose_large_split(n)
        geo = sv.four_step_pair_geometry(p)
        assert geo.rows in sv.B3_SPLIT_ROWS[geo.ranks], n
    assert sv.four_step_pair_geometry(256) == sv.PairGeometry(128, 64, 512, 131072, 2)
    assert sv.four_step_pair_geometry(512) == sv.PairGeometry(256, 32, 512, 131072, 2)
    # One compiled body per (clusters, height), from the .cu's lists.
    text = (CSRC / "four_step_pair.cu").read_text()
    lines = text.splitlines()
    for name, rows in (("FOURIER_B3_SPLIT_ROWS", sv.B3_SPLIT_ROWS),
                       ("FOURIER_B3_PASS_ROWS", sv.B3_PASS_ROWS)):
        i = lines.index(f"#define {name}(X) \\")
        block = [lines[i]]
        while block[-1].endswith("\\"):
            i += 1
            block.append(lines[i])
        assert [tuple(map(int, m)) for m in re.findall(r"X\((\d+), (\d+)\)",
                                                        "\n".join(block))] == [
            (c, h) for c in (2, 4) for h in rows[c]], name
    assert "FOURIER_B3_SPLIT_ROWS(FOURIER_B3_SPLIT_CASE)" in text
    assert "FOURIER_B3_PASS_ROWS(FOURIER_B3_PASS_CASE)" in text


def test_b3_library_entry_points():
    """B3's clustered-block library includes the engine and defines each
    entry point its wrapper binds with as many parameters; it is built
    apart from the other libraries."""
    from fourier_tpu_torch.ops.cuda import build

    src = (build.CSRC / f"{sv.FOUR_STEP_PAIR_LIBRARY}.cu").read_text()
    assert '#include "stockham_pair.cuh"' in src
    for fn_name, argtypes in [*sv.FOUR_STEP_PAIR_ENTRY_POINTS.items(),
                              ("fourier_cuda_error_string", [int])]:
        m = re.search(rf"\b{fn_name}\(([^)]*)\)\s*{{", src)
        assert m is not None, fn_name
        assert len(m.group(1).split(",")) == len(argtypes), fn_name
    libs = (sv.LIBRARY, sv.FFT_PAIR_LIBRARY, sv.FOUR_STEP_PAIR_LIBRARY)
    assert len({build.library_path(name) for name in libs}) == len(libs)


# (p, q, B): two-block clusters at p = 128 and 256, four-block ones at
# p = 4096; B = 1 and odd B, each walk several rounds of clusters but at
# p = 4096 and ending on a ragged group of columns (128 x 65: two groups of
# 64 a k2, the second of one column). These take design (a); design (b),
# the twiddle in a pass of its own, is built at p = 120 (two blocks) and
# 4000 (four).
B3_EMULATED = [(128, 256, 1), (128, 256, 7), (128, 256, 65), (256, 256, 1),
               (256, 256, 7), (4096, 16, 1), (4096, 16, 7), (120, 64, 1),
               (120, 64, 7), (4000, 8, 3)]


@pytest.mark.parametrize("p,q,b", B3_EMULATED)
def test_b3_pair_body_emulated(p, q, b):
    n = p * q
    plan = _four_step(p, q)
    rp = VpuFftPlan.create(p, device="cpu")
    tw_fwd = _cplx(plan.tw_fwd.numpy())
    rng = np.random.default_rng(RNG_SEED + n + b)
    x = (rng.standard_normal((n, b)) + 1j * rng.standard_normal((n, b))).astype(np.complex64)
    for mode in Transform:
        fwd, scale = mode.is_forward, mode.scale(n)
        x3 = _column_leg(x.astype(np.complex128), p, q, mode)
        got = emulate_b3_pair(x3, p, q, tw_fwd, fwd, 1.0 if scale is None else scale)
        assert got.shape == (n, b) and np.isfinite(got).all(), (p, b, mode)
        assert _rel(got, _want(x.astype(np.complex128), mode, n)) <= C64_GATE, (p, b, mode)
        tw = plan.tw_fwd if fwd else plan.tw_inv
        pre, pim = sv.vpu_fft_four_step_row_reference(
            torch.as_tensor(x3.real.astype(np.float32)),
            torch.as_tensor(x3.imag.astype(np.float32)), p, q, rp.tables(fwd),
            (tw[0], tw[1]), fwd, scale)
        assert _rel(got, pre.double().numpy() + 1j * pim.double().numpy()) <= C64_GATE


@pytest.mark.parametrize("mode", [Transform.FFT, Transform.SQRT_SCALED_IFFT])
def test_b3_pair_matches_pallas_interpret(mode):
    """B3's clustered body against the JAX package's kernel in interpret
    mode on the same (q, p, B) input: p = 64 (two blocks of 32 rows)."""
    p, q, b = 64, 16, 5
    rng = np.random.default_rng(RNG_SEED + int(mode))
    x3 = (rng.standard_normal((q, p, b)) + 1j * rng.standard_normal((q, p, b))).astype(
        np.complex64)
    plan = _four_step(p, q)
    fwd, scale = mode.is_forward, mode.scale(p * q)
    s = 1.0 if scale is None else np.float32(scale)
    pre = plan.tw_fwd if fwd else plan.tw_inv
    jpre = (pre[0].numpy().T * s, pre[1].numpy().T * s)
    want = jsv.vpu_fft_four_step_row(x3.real.copy(), x3.imag.copy(), p, q,
                                     jsv.make_stage_tables(p, fwd), jpre, fwd, cb=b,
                                     interpret=True)
    want = np.asarray(want[0], np.float64) + 1j * np.asarray(want[1], np.float64)
    got = emulate_b3_pair(x3.astype(np.complex128), p, q, _cplx(plan.tw_fwd.numpy()),
                          fwd, 1.0 if scale is None else scale)
    assert want.shape == got.shape == (p * q, b)
    assert _rel(got, want) <= C64_GATE


def test_b3_body_argument_on_the_cpu():
    """On CPU tensors B3's wrapper runs the plain version, with or without
    the clustered body's tables and forward twiddle, and counts no launch."""
    p, q = 256, 8
    plan = _four_step(p, q)
    rp = VpuFftPlan.create(p, device="cpu")
    re3, im3 = torch.randn(q, p, 5), torch.randn(q, p, 5)
    kw = dict(tables=rp.tables(False), kernel_tables=rp.kernel_inv,
              pre_tw=(plan.tw_inv[0], plan.tw_inv[1]))
    before = launches("four_step_row")
    want = sv.vpu_fft_four_step_row_reference(re3, im3, p, q, kw["tables"], kw["pre_tw"],
                                              False, 0.25)
    for extra in ({}, dict(pair_tables=rp.pair_fwd, tw_fwd=(plan.tw_fwd[0], plan.tw_fwd[1]))):
        got = sv.vpu_fft_four_step_row(re3, im3, p, q, False, 0.25, **extra, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launches("four_step_row") == before


# -- B1 on complex64 where it lies (csrc/fft_pair_strided.cu) ----------------


def emulate_b1_strided(x, axis, n, forward, scale):
    """fft_pair_strided_c64 along `axis` of a complex array x, in f64 with
    the f32 tables, on the index arithmetic of the body: the (outer, n,
    inner) view; the strided-column layout (inner > 1: tile t = (o, group),
    rank r's rows copied row-major, pair (row, col) at slot row*cols + col)
    or the contiguous-row one (inner = 1: tile t the transforms t*cols..,
    rank r's rows 2m and 2m + 1 of each column side by side, slot
    (m*cols + (col XOR m mod cols))*2 + row mod 2); the split's
    pairs read at their slots into fft_pair's radix-C step; the planar
    passes; X[C*k + r], row k of rank r, stored at position C*k + r of the
    axis at the tensor's strides, by rank r (strided column) or by the rank
    whose positions [r*h, (r+1)*h) hold it (contiguous row). The inverse is
    the forward body on conjugated data.
    Slots and positions never copied are NaN."""
    geo = sv.fft_pair_strided_geometry(n)
    c, h, cols = geo.ranks, geo.rows, geo.cols
    tab = _cplx(sv.pair_tables(n, True, np.float32, c))
    outer = int(np.prod(x.shape[:axis], dtype=np.int64))
    inner = int(np.prod(x.shape[axis + 1:], dtype=np.int64))
    flat = x.reshape(-1) if forward else np.conj(x.reshape(-1))
    out = np.full(flat.size, np.nan, complex)
    rows_layout = inner == 1
    groups = -(-inner // cols)
    ntiles = -(-outer // cols) if rows_layout else outer * groups
    row, col = np.repeat(np.arange(h), cols), np.tile(np.arange(cols), h)

    def slot(r, cc):
        if rows_layout:  # rows 2m, 2m + 1 side by side, columns XOR (m mod cols)
            m = r >> 1
            return (m * cols + (cc ^ (m & (cols - 1)))) * 2 + (r & 1)
        return r * cols + cc

    def positions(tiles, k):
        """The flat index of axis position k of each tile's columns, and
        which columns exist."""
        if rows_layout:
            o = tiles[:, None] * cols + col[None, :]
            return o * n + k[None, :], o < outer
        o = tiles // groups
        i = ((tiles - o * groups) * cols)[:, None] + col[None, :]
        return (o[:, None] * n + k[None, :]) * inner + i, i < inner

    for t0 in range(0, ntiles, CLUSTERS):
        tiles = np.arange(t0, min(ntiles, t0 + CLUSTERS))
        bufs = []
        for rank in range(c):  # rank r copies rows [r*h, (r+1)*h)
            src, ok = positions(tiles, rank * h + row)
            buf = np.full((len(tiles), h * cols), np.nan, complex)
            buf[:, slot(row, col)] = np.where(ok, flat[np.where(ok, src, 0)], np.nan)
            bufs.append(buf)
        cl = _Pair(geo, 4, len(tiles))

        def split(rank, r, cc):
            a = [bufs[s][:, slot(r, cc)] for s in range(c)]
            rho = -1 if rank & 1 else 1
            v = (a[0] + rho * a[1] if c == 2 else
                 a[0] + rho * a[2] + (-1j) ** rank * (a[1] + rho * a[3]))
            return v if rank == 0 else v * tab[(rank - 1) * h + r]

        cl.passes(sv.pass_schedule(h), tab, True, split)
        done = np.stack(cl.bufs)  # (C, T, points): row k of rank s is X[c*k + s]
        for rank in range(c):
            # Strided column: rank r stores its rows, at positions c*k + r.
            # Contiguous row: rank r stores positions [r*h, (r+1)*h), each
            # read from rank j mod c, row j // c.
            j = rank * h + row if rows_layout else c * row + rank
            got = done[j % c, :, cl.index(j // c, col)].T * scale
            dst, ok = positions(tiles, j)
            out[dst[ok]] = (got if forward else np.conj(got))[ok]
    return out.reshape(x.shape)


# (shape, axis): both layouts on two- and four-block clusters; ragged
# column groups (inner 5, 13, 100), a ragged group of transforms (19, 37),
# one transform alone, a mixed-radix height (96: h = 48) and a walk of
# several rounds of clusters (the (64, 96) rows: 64 transforms, kCols 64).
B1_STRIDED_EMULATED = [((2, 64, 16), 1), ((3, 64, 5), 1), ((19, 64), 1), ((64,), 0),
                       ((96, 13), 0), ((4, 96, 7), 1), ((64, 96), 1), ((2160, 3), 0),
                       ((37, 2160), 1), ((4096, 100), 0), ((9, 4096), 1)]


@pytest.mark.parametrize("shape,axis", B1_STRIDED_EMULATED)
def test_b1_strided_body_emulated(shape, axis):
    n = shape[axis]
    plan = VpuFftPlan.create(n, device="cpu")
    rng = np.random.default_rng(RNG_SEED + n + len(shape))
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    xt = torch.as_tensor(x)
    for mode in Transform:
        fwd, scale = mode.is_forward, mode.scale(n)
        got = emulate_b1_strided(x.astype(np.complex128), axis, n, fwd,
                                 1.0 if scale is None else scale)
        assert np.isfinite(got).all(), (shape, mode)
        want = (np.fft.fft(x.astype(np.complex128), axis=axis) if fwd else
                np.fft.ifft(x.astype(np.complex128), axis=axis) * n) * (scale or 1.0)
        assert _rel(got, want) <= C64_GATE, (shape, mode)
        plain = sv.vpu_fft_strided_reference(xt, axis, n, plan.tables(fwd), fwd, scale)
        assert _rel(got, plain.numpy().astype(np.complex128)) <= C64_GATE, (shape, mode)


def test_b1_strided_geometry():
    """B1 runs where it lies at B1's clustered sizes but B1_STAGE_FASTER and
    the spilled heights, on B1's launch and tile."""
    for n in B1_DOMAIN:
        geo = sv.fft_pair_strided_geometry(n)
        if (sv.kernel_body("B1", n) == "stage"
                or sv.fft_pair_geometry(n).rows in sv.B1_STRIDED_SPILLED):
            assert geo is None, n
            continue
        assert geo == sv.fft_pair_geometry(n) and geo.smem <= SMEM_PER_BLOCK, n
    assert sv.fft_pair_strided_geometry(4096).ranks == 4
    src = (CSRC / f"{sv.FFT_PAIR_STRIDED_LIBRARY}.cu").read_text()
    assert "FOURIER_PAIR_ROWS(FOURIER_B1S_PAIR_CASE)" in src
    assert "FOURIER_B1_QUAD_ROWS(FOURIER_B1S_QUAD_CASE)" in src
    spilled, stage = (line for line in src.splitlines() if "if constexpr (" in line
                      and "H ==" in line)
    assert sorted(int(h) for h in re.findall(r"H == (\d+)", spilled)) == sorted(
        sv.B1_STRIDED_SPILLED)
    assert "C == 2 &&" in stage and sorted(int(h) for h in re.findall(r"H == (\d+)", stage)) \
        == sorted(n // 2 for n in sv.B1_STAGE_FASTER)
    assert all(sv.fft_pair_geometry(n).ranks == 2 for n in sv.B1_STAGE_FASTER)


@pytest.mark.parametrize("case", ["dtype", "contiguous", "length", "size", "out", "overlap"])
def test_b1_strided_wrapper_refuses(case):
    """The wrapper's argument checks raise, on the CPU as on a card."""
    plan = VpuFftPlan.create(64, device="cpu")
    x = torch.randn(3, 64, 4, dtype=torch.complex64)
    args = dict(x=x, axis=1, n=64)
    err = ValueError
    if case == "dtype":
        args["x"], err = x.to(torch.complex128), TypeError
    elif case == "contiguous":
        args["x"] = x.transpose(0, 2)
    elif case == "length":
        args["axis"] = 2
    elif case == "size":
        plan = VpuFftPlan.create(1000, device="cpu")
        args.update(x=torch.randn(3, 1000, dtype=torch.complex64), n=1000)
    elif case == "out":
        args["out"] = torch.empty(3, 64, 5, dtype=torch.complex64)
    else:
        args["out"] = x.reshape(-1)[:x.numel()].view(x.shape)
    with pytest.raises(err):
        sv.vpu_fft_strided(forward=True, scale=None, tables=plan.tables(True),
                           pair_tables=plan.pair_fwd, **{"out": None, **args})


def test_b1_strided_on_the_cpu_in_place():
    """On CPU tensors the wrapper runs the plain version into a new tensor,
    into `out`, or in place, and counts no launch."""
    plan = VpuFftPlan.create(128, device="cpu")
    x = torch.randn(5, 128, 3, dtype=torch.complex64)
    kw = dict(tables=plan.tables(False), pair_tables=plan.pair_fwd)
    before = launches("vpu_fft_strided")
    want = sv.vpu_fft_strided_reference(x, 1, 128, kw["tables"], False, 0.5)
    got = sv.vpu_fft_strided(x, 1, 128, False, 0.5, **kw)
    assert torch.equal(got, want) and got.data_ptr() != x.data_ptr()
    y = x.clone()
    assert sv.vpu_fft_strided(y, -2, 128, False, 0.5, out=y, **kw) is y
    assert torch.equal(y, want)
    assert launches("vpu_fft_strided") == before
