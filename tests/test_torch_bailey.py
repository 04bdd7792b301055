"""Kernels B9a and B9b of the port (the DFT as dense complex products).

* The packed phase-B tables and ``choose_pack`` bitwise equal to the JAX
  package's.
* The plain B9a (``xla_fft_single``) and B9b (``reference_two_phase``), which
  the wrappers run on the CPU, against the JAX ``mxu_fft_single`` /
  ``mxu_fft_two_phase(..., interpret=True)`` and ``reference_two_phase`` on
  the same seeded planes and tables, rel-L2 <= 2e-6 (``test_torch_mxu.py``'s
  gate); the packed einsum form against the JAX one.
* a numpy transliteration of B9b's CUDA-core body (``csrc/bailey.cu``):
  the launch geometry of ``ops/cuda/bailey.py``, the thread-to-output
  mapping, the chunked fma sums, G' written over M in the padded shared
  planes; against ``np.fft`` at rel-L2 <= 1e-6 (the card's gate), with and
  without a ``tb`` cap.
* B9a's tensor-core body (``csrc/dft_mma.cu``): a numpy emulation of its
  3xTF32 products (TF32 rounding as ``cvt.rna`` does it, hi and lo parts,
  the zero-padding to a multiple of 8, each 8-wide step's hi*hi products
  from a fresh accumulator, the cross products in accumulators of their
  own), each tensor-core product rounded to nearest or toward zero, against
  ``np.fft`` at every n = 1..128 and two batches, rel-L2 <= 1e-6: the CPU
  evidence that 3xTF32 meets the card's gate.
* The geometry within the kernels' limits for every split, the C constants
  and entry points as the wrapper binds them, the wrapper contract.
* ``cuda``-marked tests hold each kernel against its plain version where a
  card is present.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_tpu.ops import dft_matrix as jdm
from fourier_tpu.ops.pallas import bailey as jb

from fourier_tpu_torch import Transform, trace
from fourier_tpu_torch.ops import bailey
from fourier_tpu_torch.ops import dft_matrix as dm
from fourier_tpu_torch.ops.cuda import bailey as kb
from fourier_tpu_torch.ops.cuda import build
from fourier_tpu_torch.plan import MxuFftPlan

RNG_SEED = 0xB9
REL_L2 = 2e-6
CARD_GATE = 1e-6
CHUNK = 16  # csrc/bailey.cu kChunk
H100_SMS = 132  # the multiprocessors of an H100 SXM
SINGLE_SIZES = (1, 2, 7, 16, 64, 100, 125, 127, 128)
SPLITS = {129: (3, 43), 243: (9, 27), 250: (10, 25), 384: (16, 24),
          1000: (25, 40), 2048: (32, 64), 4096: (64, 64), 16129: (127, 127),
          16384: (128, 128)}


def launches(op: str) -> int:
    """Launches of the operator ``fourier_tpu_torch::<op>`` counted so far."""
    return trace.counters()[f"launches.fourier_tpu_torch::{op}"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


def _planes(shape, rng):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np_want(xr, xi, mode):
    x = xr.astype(np.float64) + 1j * xi
    n = x.shape[-1]
    want = np.fft.fft(x, axis=-1) if mode.is_forward else np.fft.ifft(x, axis=-1) * n
    return want * (mode.scale(n) or 1.0)


def _tables(plan, mode):
    """The plan's planar numpy tables of `mode`, the scale folded into the
    last, as the plan hands them to the kernels."""
    tabs = [(r.numpy(), i.numpy()) for r, i in plan.tables(mode.is_forward)]
    s = np.float32(mode.scale(plan.size) or 1.0)
    if mode.scale(plan.size) is not None:
        tabs[-1] = (tabs[-1][0] * s, tabs[-1][1] * s)
    return tabs


@pytest.mark.parametrize("n1,n2", [(3, 43), (10, 25), (16, 24), (25, 40), (64, 64),
                                   (7, 128)])
def test_packed_tables_bitwise_equal_jax(n1, n2):
    pack = dm.choose_pack(n1, n2)
    assert pack == jdm.choose_pack(n1, n2)
    assert dm.choose_pack(n1, n2, 64) == jdm.choose_pack(n1, n2, 64)
    for fwd in (True, False):
        np.testing.assert_array_equal(dm.packed_phase_b(n1, n2, fwd, pack),
                                      jdm.packed_phase_b(n1, n2, fwd, pack))
        np.testing.assert_array_equal(dm.packed_phase_b(n1, n2, fwd, pack, 0.25),
                                      jdm.packed_phase_b(n1, n2, fwd, pack, 0.25))


@pytest.mark.parametrize("n", SINGLE_SIZES)
def test_plain_b9a_matches_pallas_interpret(n):
    rng = np.random.default_rng(RNG_SEED + n)
    xr, xi = _planes((5, n), rng)
    plan = MxuFftPlan.create(n, impl="pallas", device="cpu")
    for mode in (Transform.FFT, Transform.SQRT_SCALED_IFFT):
        (dre, dim), = _tables(plan, mode)
        want = jb.mxu_fft_single(jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(dre),
                                 jnp.asarray(dim), tb=8, interpret=True)
        want = np.asarray(want[0]) + 1j * np.asarray(want[1])
        got = kb.mxu_fft_single(torch.as_tensor(xr), torch.as_tensor(xi),
                                torch.as_tensor(dre), torch.as_tensor(dim))
        got = got[0].numpy() + 1j * got[1].numpy()
        assert got.shape == (5, n)
        assert _rel(got, want) <= REL_L2, (n, mode)
        assert _rel(got, _np_want(xr, xi, mode)) <= CARD_GATE, (n, mode)


@pytest.mark.parametrize("n", [129, 243, 250, 384, 1000])
def test_plain_b9b_matches_pallas_interpret(n):
    rng = np.random.default_rng(RNG_SEED + n)
    xr, xi = _planes((3, n), rng)
    plan = MxuFftPlan.create(n, impl="pallas", device="cpu")
    assert (plan.n1, plan.n2) == SPLITS[n]
    for mode in (Transform.FFT, Transform.IFFT):
        tabs = [t for pair in _tables(plan, mode) for t in pair]
        jx = (jnp.asarray(xr), jnp.asarray(xi))
        jt = [jnp.asarray(t) for t in tabs]
        want = jb.mxu_fft_two_phase(*jx, *jt, tb=2, interpret=True)
        want = np.asarray(want[0]) + 1j * np.asarray(want[1])
        ref = jb.reference_two_phase(*jx, *jt)
        ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
        got = kb.mxu_fft_two_phase(torch.as_tensor(xr), torch.as_tensor(xi),
                                   *(torch.as_tensor(t) for t in tabs))
        got = got[0].numpy() + 1j * got[1].numpy()
        assert _rel(got, want) <= REL_L2, (n, mode)
        assert _rel(got, ref) <= REL_L2, (n, mode)
        assert _rel(got, _np_want(xr, xi, mode)) <= CARD_GATE, (n, mode)


@pytest.mark.parametrize("n", [243, 1000, 4096])
def test_packed_form_matches_jax(n):
    rng = np.random.default_rng(RNG_SEED + n)
    xr, xi = _planes((3, n), rng)
    plan = MxuFftPlan.create(n, impl="xla_packed", device="cpu")
    tabs = [t for pair in _tables(plan, Transform.SQRT_SCALED_FFT) for t in pair]
    want = jb.xla_fft_two_phase_packed(jnp.asarray(xr), jnp.asarray(xi),
                                       *(jnp.asarray(t) for t in tabs))
    got = bailey.xla_fft_two_phase_packed(torch.as_tensor(xr), torch.as_tensor(xi),
                                          *(torch.as_tensor(t) for t in tabs))
    want = np.asarray(want[0]) + 1j * np.asarray(want[1])
    assert _rel(got[0].numpy() + 1j * got[1].numpy(), want) <= REL_L2


# -- numpy transliterations of csrc/bailey.cu ---------------------------------


def _fma(a, b, c):
    """fmaf: the exact product plus c, rounded once to f32."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _outputs(g, groups, rows):
    return np.where(g < groups, (rows - g + groups - 1) // groups, 0)


def _contract(dr, di, K, first, step, nout, x_at):
    """The kernel's `contract`, one lane per entry of `first`: outputs
    j < nout of row first + step*j, summed in chunks of CHUNK terms."""
    j = np.arange(kb.MAX_OUT)[:, None]
    valid = j < nout[None, :]
    rows = np.where(valid, first[None, :] + step * j, 0)
    tr = np.zeros(rows.shape, np.float32)
    ti = np.zeros(rows.shape, np.float32)
    for k0 in range(0, K, CHUNK):
        cr = np.zeros(rows.shape, np.float32)
        ci = np.zeros(rows.shape, np.float32)
        for k in range(k0, min(k0 + CHUNK, K)):
            xr, xi = x_at(k)
            d_r, d_i = dr[rows, k], di[rows, k]
            cr = _fma(d_r, xr, cr)
            cr = _fma(-d_i, xi, cr)
            ci = _fma(d_r, xi, ci)
            ci = _fma(d_i, xr, ci)
        tr, ti = tr + cr, ti + ci
    return tr, ti, valid, rows


def _emulate_b9b(xr, xi, d2, tw, d1, tb=None, sms=H100_SMS):
    b, n = xr.shape
    n2, n1 = tw[0].shape
    tpb, threads = kb.two_phase_geometry(n1, n2, b, sms, tb)
    ld, plane = n1 | 1, n2 * (n1 | 1)
    tid = np.arange(threads)
    out = np.zeros((b, n), np.complex128)
    for t0 in range(0, b, tpb):  # one block each
        count = min(tpb, b - t0)
        sm = [np.zeros(tpb * plane, np.float32) for _ in range(2)]
        e = np.arange(count * n)
        t, r = e // n, e % n
        for s, x in zip(sm, (xr, xi)):
            s[t * plane + (r // n1) * ld + r % n1] = x[t0:t0 + count].ravel()
        # Phase A: lane (t, a, g) owns G[t][g + ga*j][a].
        ga = kb.groups_of(n2)
        q, g = tid % (tpb * n1), tid // (tpb * n1)
        ta, a = q // n1, q % n1
        nout = np.where(ta < count, _outputs(g, ga, n2), 0)
        tr, ti, valid, k2 = _contract(
            d2[0], d2[1], n2, g, ga, nout,
            lambda k: (sm[0][ta * plane + k * ld + a], sm[1][ta * plane + k * ld + a]))
        # After the barrier: G' = G * T over M.
        aa = np.broadcast_to(a, k2.shape)
        at = (np.broadcast_to(ta, k2.shape) * plane + k2 * ld + aa)[valid]
        wr, wi = tw[0][k2, aa][valid], tw[1][k2, aa][valid]
        gr, gi = tr[valid], ti[valid]
        sm[0][at] = _fma(gr, wr, -(gi * wi))
        sm[1][at] = _fma(gr, wi, gi * wr)
        # Phase B: lane (t, k2, g) owns O[t][g + gb*j][k2].
        gb = kb.groups_of(n1)
        q, g = tid % (tpb * n2), tid // (tpb * n2)
        tq, kq = q // n2, q % n2
        nout = np.where(tq < count, _outputs(g, gb, n1), 0)
        tr, ti, valid, k1 = _contract(
            d1[0], d1[1], n1, g, gb, nout,
            lambda k: (sm[0][tq * plane + kq * ld + k], sm[1][tq * plane + kq * ld + k]))
        rows = np.broadcast_to(t0 + tq, k1.shape)[valid]
        cols = (k1 * n2 + np.broadcast_to(kq, k1.shape))[valid]
        out[rows, cols] = tr[valid] + 1j * ti[valid].astype(np.float64)
    return out


# sms=1, a card of one SM, gives these small batches blocks of several
# transforms.
@pytest.mark.parametrize("n,b,tb,sms", [
    (129, 7, None, H100_SMS), (250, 7, 4, H100_SMS), (384, 3, None, H100_SMS),
    (1000, 5, 2, H100_SMS), (4096, 3, None, H100_SMS), (16384, 2, None, H100_SMS),
    (129, 7, None, 1), (250, 7, 4, 1), (384, 3, None, 1), (4096, 3, None, 1)])
def test_b9b_algorithm_emulated(n, b, tb, sms):
    rng = np.random.default_rng(RNG_SEED + n)
    xr, xi = _planes((b, n), rng)
    plan = MxuFftPlan.create(n, impl="pallas", device="cpu")
    tpb, _ = kb.two_phase_geometry(plan.n1, plan.n2, b, sms, tb)
    assert tpb > 1 or sms > 1
    for mode in (Transform.FFT, Transform.IFFT):
        d2, tw, d1 = _tables(plan, mode)
        got = _emulate_b9b(xr, xi, d2, tw, d1, tb, sms)
        want = _np_want(xr, xi, mode)
        assert _rel(got, want) <= CARD_GATE, (n, mode)
        plain = bailey.reference_two_phase(
            torch.as_tensor(xr), torch.as_tensor(xi),
            *(torch.as_tensor(t) for pair in (d2, tw, d1) for t in pair))
        assert _rel(got, plain[0].numpy() + 1j * plain[1].numpy()) <= CARD_GATE


def _tf32(v):
    """cvt.rna.tf32.f32: the float32 with its low 13 mantissa bits rounded
    off, to nearest, ties away from zero (on the magnitude's bits)."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v):
    v = np.asarray(v, np.float32)
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def _mma(acc, a, b, rounding):
    """One tensor-core product: acc + a (rows, 8) @ b (8, cols)^T, the eight
    products summed exactly (f64), the sum rounded to float32 to nearest
    ("rn") or toward zero ("rz")."""
    exact = acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64).T
    out = exact.astype(np.float32)
    if rounding == "rz":
        over = np.abs(out.astype(np.float64)) > np.abs(exact)
        out = np.where(over, np.nextafter(out, np.float32(0)), out)
    return out


def _cmma_3xtf32(xr, xi, dr, di, rounding="rn"):
    """warp_cmma_3xtf32 of csrc/dft_mma.cuh: O = X (R, K) * D (N, K)^T,
    planar complex f32, K a multiple of 8; per 8-wide step of K the hi*hi
    products of Or and Oi from zero (Xr*Dr then -Xi*Di; Xr*Di then Xi*Dr)
    joined to the totals by float adds, the cross products hi*lo and lo*hi
    in accumulators of their own over all of K, added at the end."""
    zero = np.zeros((xr.shape[0], dr.shape[0]), np.float32)
    acc_r, acc_i, small_r, small_i = zero, zero, zero, zero
    for k0 in range(0, xr.shape[1], 8):
        ks = slice(k0, k0 + 8)
        arh, arl = _split(xr[:, ks])
        aih, ail = _split(xi[:, ks])
        brh, brl = _split(dr[:, ks])
        bih, bil = _split(di[:, ks])
        big_r = _mma(_mma(zero, arh, brh, rounding), -aih, bih, rounding)
        big_i = _mma(_mma(zero, arh, bih, rounding), aih, brh, rounding)
        for a, bb in ((arl, brh), (arh, brl), (-ail, bih), (-aih, bil)):
            small_r = _mma(small_r, a, bb, rounding)
        for a, bb in ((arl, bih), (arh, bil), (ail, brh), (aih, brl)):
            small_i = _mma(small_i, a, bb, rounding)
        acc_r, acc_i = acc_r + big_r, acc_i + big_i
    return acc_r + small_r, acc_i + small_i


def _pad(a, rows, cols):
    a = np.asarray(a, np.float32)
    return np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])))


def _emulate_b9a_3xtf32(xr, xi, d, rounding="rn"):
    """dft_single_mma_c64 (csrc/dft_mma.cu) on planar f32 (B, n) planes and
    the (n, n) table d: N and K zero-padded to np8, the product of
    _cmma_3xtf32. A row's result does not depend on its tile."""
    b, n = xr.shape
    np8 = kb.single_mma_geometry(n).np8
    out_r, out_i = _cmma_3xtf32(_pad(xr, b, np8), _pad(xi, b, np8), _pad(d[0], np8, np8),
                                _pad(d[1], np8, np8), rounding)
    return out_r[:, :n].astype(np.float64) + 1j * out_i[:, :n]


def _guarded_reads(t, rows, cols, ld):
    """The (rows, cols) operand warp_cmma_3xtf32<NT, true> reads from the
    (r, c) table `t` in global memory at stride `ld`: entry (i, j) loaded
    from flat offset i * ld + j where i < r and j < c, a zero elsewhere;
    no load leaves the table."""
    flat = np.asarray(t, np.float32).reshape(-1)
    r, c = t.shape
    i, j = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    ok = (i < r) & (j < c)
    at = np.where(ok, i * ld + j, 0)
    assert at.max() < flat.size
    return np.where(ok, flat[at], np.float32(0))


def _emulate_b9b_3xtf32(xr, xi, d2, tw, d1, rounding="rn", grid=None):
    """dft_two_phase_mma_c64 (csrc/dft_mma.cu) on planar f32 (B, n) planes:
    `grid` persistent blocks (one a transform by default), each walking
    transforms b, b + grid, ... through its buffers of
    two_phase_mma_geometry, zeroed once: M^T copied in transposed (only
    a < n1, b < n2 written); per chunk of S's rows k2, phase A's G^T = M^T *
    D_n2^T through _cmma_3xtf32, G' = G * T by fmaf into S (zeros where a >=
    n1 or k2 >= n2, columns a < n1p written), phase B's O = D_n1 * S^T
    through _cmma_3xtf32, stored at k1 * n2 + k2 for k1 < n1, k2 < n2.
    Unstaged tables are read from their flat memory by _guarded_reads."""
    b, n = xr.shape
    n2, n1 = tw[0].shape
    geo = kb.two_phase_mma_geometry(n1, n2)
    if geo.staged:
        d2p = [_pad(t, geo.k2p, geo.k2p) for t in d2]
        d1p = [_pad(t, geo.arows, geo.n1p) for t in d1]
    else:
        d2p = [_guarded_reads(t, geo.k2p, geo.k2p, geo.ld2) for t in d2]
        d1p = [_guarded_reads(t, geo.arows, geo.n1p, geo.ld1) for t in d1]
    grid = grid or b
    out = np.full((b, n), np.nan, np.complex128)
    for block in range(min(grid, b)):
        bufs = np.zeros((geo.buffers, 2, geo.arows, geo.ldm), np.float32)
        s = np.zeros((2, geo.chunk, geo.ldg), np.float32)
        for i, t in enumerate(range(block, b, grid)):
            m = bufs[i % geo.buffers]
            m[0, :n1, :n2] = xr[t].reshape(n2, n1).T
            m[1, :n1, :n2] = xi[t].reshape(n2, n1).T
            for c0 in range(0, geo.k2p, geo.chunk):
                rows = slice(c0, min(c0 + geo.chunk, geo.k2p))
                gr, gi = _cmma_3xtf32(m[0][:, :geo.k2p], m[1][:, :geo.k2p],
                                      d2p[0][rows], d2p[1][rows], rounding)
                k2 = np.arange(c0, rows.stop)[:, None]
                a = np.arange(geo.n1p)[None, :]
                valid = (a < n1) & (k2 < n2)
                at = (np.minimum(k2, n2 - 1), np.minimum(a, n1 - 1))
                wr, wi = tw[0][at], tw[1][at]
                gr, gi = gr[:geo.n1p].T, gi[:geo.n1p].T
                cw = rows.stop - c0
                s[0, :cw, :geo.n1p] = np.where(valid, _fma(gr, wr, -(gi * wi)), 0)
                s[1, :cw, :geo.n1p] = np.where(valid, _fma(gr, wi, gi * wr), 0)
                o_r, o_i = _cmma_3xtf32(d1p[0], d1p[1], s[0, :cw, :geo.n1p],
                                        s[1, :cw, :geo.n1p], rounding)
                keep = slice(c0, min(rows.stop, n2))
                width = keep.stop - keep.start
                o = out[t].reshape(n1, n2)
                o[:, keep] = (o_r[:n1, :width].astype(np.float64)
                              + 1j * o_i[:n1, :width])
    return out


def test_tf32_rounding():
    """_tf32 rounds to nearest with ties away from zero, keeping 10
    mantissa bits, as cvt.rna.tf32.f32 does."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    for sign in (1, -1):
        assert _tf32(np.float32(sign * (1 + ulp / 2))) == np.float32(sign * (1 + ulp))
        assert _tf32(np.float32(sign * (1 + ulp / 4))) == np.float32(sign * one)
        assert _tf32(np.float32(sign * (1 + 3 * ulp / 4))) == np.float32(sign * (1 + ulp))
    v = np.random.default_rng(RNG_SEED).standard_normal(1000).astype(np.float32)
    hi, lo = _split(v)
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0) and np.all(lo.view(np.uint32) & 0x1FFF == 0)
    assert np.all(np.abs(v.astype(np.float64) - hi - lo) <= 2.0 ** -21 * np.abs(v))


@pytest.mark.parametrize("n", range(1, kb.MAX_N + 1))
def test_b9a_3xtf32_emulated(n):
    """3xTF32 meets the card's gate at every n B9a takes, whether a
    tensor-core product rounds to nearest or toward zero; one TF32 product
    a real product would not (checked at n = 128)."""
    plan = MxuFftPlan.create(n, impl="pallas", device="cpu")
    rng = np.random.default_rng(RNG_SEED + 1000 + n)
    for b in (7, 64):
        xr, xi = _planes((b, n), rng)
        for mode in (Transform.FFT, Transform.IFFT):
            (d,) = _tables(plan, mode)
            want = _np_want(xr, xi, mode)
            for rounding in ("rn", "rz"):
                got = _emulate_b9a_3xtf32(xr, xi, d, rounding)
                assert _rel(got, want) <= CARD_GATE, (n, b, mode, rounding)
    if n == kb.MAX_N:
        (d,) = _tables(plan, Transform.FFT)
        one = lambda a, t: _tf32(a).astype(np.float64) @ _tf32(t).astype(np.float64).T
        got = (one(xr, d[0]) - one(xi, d[1])) + 1j * (one(xr, d[1]) + one(xi, d[0]))
        assert _rel(got, _np_want(xr, xi, Transform.FFT)) > 10 * CARD_GATE


def test_b9a_mma_geometry_and_entry_point():
    """B9a's tensor-core tile at every n: N and K padded to a multiple of
    8, rows at a stride of 4 mod 8 words (a fragment load's eight rows on
    distinct banks), at most MMA_MAX_TILES n-tiles a warp, 16 rows a warp
    along the m-tiles, within a block's shared memory; `tb` caps the rows
    a tile takes. The constants and the entry point of csrc/dft_mma.cu are
    the wrapper's."""
    for n in range(1, kb.MAX_N + 1):
        for tb in (None, 1, 4, 100):
            geo = kb.single_mma_geometry(n, tb)
            assert geo.np8 % 8 == 0 and geo.np8 - 8 < n <= geo.np8
            assert geo.ld == geo.np8 + 4 and (geo.ld // 4) % 2 == 1
            ntiles = geo.np8 // 8
            assert geo.wn in (1, 2, 4) and geo.wn <= ntiles
            assert -(-ntiles // geo.wn) <= kb.MMA_MAX_TILES
            assert geo.rows == 16 * (kb.MMA_WARPS // geo.wn)
            assert 1 <= geo.valid <= geo.rows and (tb is None or geo.valid <= tb)
            assert geo.smem == 4 * geo.ld * (2 * geo.np8 + 4 * geo.rows) <= kb.MAX_SMEM
    assert kb.single_mma_geometry(128) == kb.MmaGeometry(128, 132, 4, 32, 32, 202752)
    assert kb.single_mma_geometry(125) == kb.single_mma_geometry(128)
    assert kb.single_mma_geometry(7).rows == 128
    src = (build.CSRC / f"{kb.MMA_LIBRARY}.cu").read_text()
    for name, value in (("kWarps", kb.MMA_WARPS), ("kMaxTiles", kb.MMA_MAX_TILES),
                        ("kMaxN", kb.MAX_N), ("kMaxSmem", kb.MAX_SMEM)):
        assert re.search(rf"\b{name} = {value};", src), name
    assert '#include "dft_mma.cuh"' in src
    header = (build.CSRC / "dft_mma.cuh").read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    assert "cvt.rna.tf32.f32" in header
    for fn_name, argtypes in [*kb.MMA_ENTRY_POINTS.items(),
                              ("fourier_cuda_error_string", [int])]:
        m = re.search(rf"\b{fn_name}\(([^)]*)\)\s*{{", src)
        assert m is not None, fn_name
        assert len(m.group(1).split(",")) == len(argtypes), fn_name
    assert build.library_path(kb.MMA_LIBRARY) != build.library_path(kb.LIBRARY)


def _b9b_case(n, b, mode, seed):
    plan = MxuFftPlan.create(n, impl="pallas", device="cpu")
    assert (plan.n1, plan.n2) == SPLITS[n]
    xr, xi = _planes((b, n), np.random.default_rng(seed))
    return xr, xi, _tables(plan, mode)


@pytest.mark.parametrize("rounding", ["rn", "rz"])
@pytest.mark.parametrize("n", sorted(SPLITS))
def test_b9b_3xtf32_emulated(n, rounding):
    """B9b's tensor-core body meets the card's gate at every split of
    SPLITS, forward and inverse, whether a tensor-core product rounds to
    nearest or toward zero."""
    for mode in (Transform.FFT, Transform.IFFT):
        xr, xi, (d2, tw, d1) = _b9b_case(n, 3, mode, RNG_SEED + 2000 + n)
        got = _emulate_b9b_3xtf32(xr, xi, d2, tw, d1, rounding)
        assert _rel(got, _np_want(xr, xi, mode)) <= CARD_GATE, (n, mode, rounding)


@pytest.mark.parametrize("n", sorted(SPLITS))
def test_b9b_3xtf32_matches_plain(n):
    """The emulated tensor-core body against the plain version the wrapper
    runs on the CPU (bailey.reference_two_phase), in a scaled mode, with
    blocks that walk several transforms (grid 2)."""
    mode = Transform.SQRT_SCALED_IFFT
    xr, xi, tabs = _b9b_case(n, 5, mode, RNG_SEED + 3000 + n)
    got = _emulate_b9b_3xtf32(xr, xi, *tabs, grid=2)
    plain = bailey.reference_two_phase(
        torch.as_tensor(xr), torch.as_tensor(xi),
        *(torch.as_tensor(t) for pair in tabs for t in pair))
    assert _rel(got, plain[0].numpy() + 1j * plain[1].numpy()) <= CARD_GATE, n
    assert _rel(got, _emulate_b9b_3xtf32(xr, xi, *tabs)) == 0.0  # no block dependence


@pytest.mark.parametrize("n", [129, 250])
def test_b9b_3xtf32_poison_stays_in_its_row(n):
    """At padded splits a NaN row and an infinite row stay in their rows,
    with blocks that walk several transforms through the same buffers."""
    xr, xi, tabs = _b9b_case(n, 9, Transform.FFT, RNG_SEED + 4000 + n)
    xr[2, n // 2], xi[5, 0] = np.nan, np.inf
    with np.errstate(invalid="ignore"):
        got = _emulate_b9b_3xtf32(xr, xi, *tabs, grid=2)
    rest = np.setdiff1d(np.arange(9), [2, 5])
    want = _np_want(xr[rest], xi[rest], Transform.FFT)
    assert _rel(got[rest], want) <= CARD_GATE
    assert not np.isfinite(got[2]).all() and not np.isfinite(got[5]).all()


def test_b9b_mma_geometry():
    """B9b's tensor-core layout at every split n1, n2 <= 128: padded to the
    fragments (n1p, k2p multiples of 8, arows of 16), shared strides of 4
    mod 8 words, S a multiple of 8 rows, within a block's shared memory;
    tables staged up to (64, 64), read from global memory at (128, 128)."""
    for n1 in range(1, kb.MAX_N + 1):
        for n2 in range(1, kb.MAX_N + 1):
            geo = kb.two_phase_mma_geometry(n1, n2)
            assert geo.n1p - 8 < n1 <= geo.n1p and geo.n1p % 8 == 0
            assert geo.arows - 16 < n1 <= geo.arows and geo.arows % 16 == 0
            assert geo.k2p - 8 < n2 <= geo.k2p and geo.k2p % 8 == 0
            strides = [geo.ldm, geo.ldg] + ([geo.ld1, geo.ld2] if geo.staged else [])
            assert all(ld % 8 == 4 for ld in strides), (n1, n2)
            assert geo.ldm >= geo.k2p and geo.ldg >= geo.n1p
            assert (geo.ld1, geo.ld2) == ((geo.n1p + 4, geo.k2p + 4) if geo.staged
                                          else (n1, n2))
            assert geo.chunk % 8 == 0 and 8 <= geo.chunk <= geo.k2p
            assert geo.buffers in (1, 2)
            tables = 2 * (geo.k2p * geo.ld2 + geo.arows * geo.ld1) if geo.staged else 0
            assert geo.smem == 4 * (tables + 2 * geo.buffers * geo.arows * geo.ldm
                                    + 2 * geo.chunk * geo.ldg) <= kb.MAX_SMEM
    assert kb.two_phase_mma_geometry(64, 64) == kb.TwoPhaseMmaGeometry(
        64, 64, 64, 68, 68, 68, 68, True, 2, 64, 174080)
    assert kb.two_phase_mma_geometry(128, 128) == kb.TwoPhaseMmaGeometry(
        128, 128, 128, 132, 132, 128, 128, False, 1, 64, 202752)
    src = (build.CSRC / f"{kb.MMA_LIBRARY}.cu").read_text()
    assert "two_phase_geometry(int n1, int n2)" in src
    assert kb.MMA_ENTRY_POINTS["fourier_dft_two_phase_mma_c64"] == kb.ENTRY_POINTS[
        "fourier_dft_two_phase_c64"][:10] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    assert "warp_cmma_3xtf32<kMaxTiles>" in src


def test_b9b_global_tables_read_unpadded():
    """Where the tables are not staged the kernel reads D_n2 and D_n1 as the
    caller gives them, at strides n2 and n1, and the guarded product reads
    zeros past them: the same operand as the table zero-padded to (k2p,
    k2p) and (arows, n1p), with no load outside the table. The source
    instantiates the guarded product for the unstaged layout."""
    rng = np.random.default_rng(RNG_SEED)
    for n1, n2 in [(127, 127), (33, 113), (128, 128), (100, 125)]:
        geo = kb.two_phase_mma_geometry(n1, n2)
        assert not geo.staged and (geo.ld1, geo.ld2) == (n1, n2)
        for (r, c), (rows, cols, ld) in (((n2, n2), (geo.k2p, geo.k2p, geo.ld2)),
                                         ((n1, n1), (geo.arows, geo.n1p, geo.ld1))):
            t = rng.standard_normal((r, c)).astype(np.float32)
            assert np.array_equal(_guarded_reads(t, rows, cols, ld), _pad(t, rows, cols))
    src = (build.CSRC / f"{kb.MMA_LIBRARY}.cu").read_text()
    assert src.count("warp_cmma_3xtf32<kMaxTiles, !Staged>") == 2
    assert "geo.staged ? dft_two_phase_mma_c64<true> : dft_two_phase_mma_c64<false>" in src


def test_b9b_body_argument_on_the_cpu():
    """On CPU tensors B9b's wrapper runs the plain version, with or without
    a batch tile, at splits of either body, and counts no launch. The
    CUDA-core body runs below B9B_FMA_WORK (n * (n1 + n2)) and the
    tensor-core body from there on."""
    rng = np.random.default_rng(RNG_SEED)
    before = launches("mxu_fft_two_phase")
    for n in (250, 1000):  # (10, 25) on the CUDA cores, (25, 40) on the tensor cores
        plan = MxuFftPlan.create(n, impl="pallas", device="cpu")
        xr, xi = (torch.as_tensor(t) for t in _planes((3, n), rng))
        tabs = [torch.as_tensor(t) for pair in _tables(plan, Transform.FFT) for t in pair]
        want = bailey.reference_two_phase(xr, xi, *tabs)
        for tb in (None, 2):
            got = kb.mxu_fft_two_phase(xr, xi, *tabs, tb=tb)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launches("mxu_fft_two_phase") == before
    bodies = {split: kb.two_phase_body(*split) for split in
              [(3, 43), (10, 25), (16, 16), (17, 17), (2, 101), (19, 25), (2, 103),
               (20, 25), (25, 40), (64, 64), (128, 128)]}
    assert [s for s, body in bodies.items() if body == "fma"] == [
        (3, 43), (10, 25), (16, 16), (17, 17), (2, 101), (19, 25)], bodies


def test_geometry_within_kernel_limits():
    """Every split and batch gets a launch csrc/bailey.cu accepts."""
    for n1 in range(1, kb.MAX_N + 1):
        for n2 in range(1, kb.MAX_N + 1):
            for batch, tb, sms in ((1, None, H100_SMS), (1000, None, H100_SMS),
                                   (65536, None, H100_SMS), (7, 4, H100_SMS),
                                   (65536, None, 1), (7, 4, 1)):
                tpb, threads = kb.two_phase_geometry(n1, n2, batch, sms, tb)
                assert 1 <= tpb and threads <= kb.MAX_THREADS and threads % 32 == 0
                per = max(n1 * kb.groups_of(n2), n2 * kb.groups_of(n1))
                assert per > kb.SMALL_THREADS or threads <= kb.SMALL_THREADS
                assert tpb * n1 * kb.groups_of(n2) <= threads
                assert tpb * n2 * kb.groups_of(n1) <= threads
                assert 8 * tpb * n2 * (n1 | 1) <= kb.MAX_SMEM
                assert tb is None or tpb <= tb


def test_library_constants_and_entry_points():
    src = (build.CSRC / f"{kb.LIBRARY}.cu").read_text()
    for name, value in (("kMaxOut", kb.MAX_OUT), ("kChunk", CHUNK),
                        ("kTwoPhaseMaxThreads", kb.MAX_THREADS),
                        ("kTwoPhaseSmallThreads", kb.SMALL_THREADS),
                        ("kMaxN", kb.MAX_N), ("kMaxSmem", kb.MAX_SMEM)):
        assert re.search(rf"\b{name} = {value};", src), name
    for fn_name, argtypes in [*kb.ENTRY_POINTS.items(),
                              ("fourier_cuda_error_string", [int])]:
        m = re.search(rf"\b{fn_name}\(([^)]*)\)\s*{{", src)
        assert m is not None, fn_name
        assert len(m.group(1).split(",")) == len(argtypes), fn_name
    assert "mma" not in src and "wgmma" not in src  # fp32 FMA, no tensor cores


def test_wrapper_contract():
    d = torch.zeros(8, 8)
    ok = torch.zeros(3, 8)
    for bad in (torch.zeros(3, 9), torch.zeros(3, 8).double(), torch.zeros(3, 16)[:, ::2],
                torch.zeros(3, 8, device="meta"), torch.zeros(8)):
        with pytest.raises((TypeError, ValueError)):
            kb.mxu_fft_single(bad, bad, d, d)
    with pytest.raises(ValueError):
        kb.mxu_fft_single(ok, ok, d, torch.zeros(8, 7))
    with pytest.raises(ValueError):
        kb.mxu_fft_single(torch.zeros(3, 129), torch.zeros(3, 129),
                          torch.zeros(129, 129), torch.zeros(129, 129))
    n1, n2 = 4, 6
    tabs = [torch.zeros(n2, n2)] * 2 + [torch.zeros(n2, n1)] * 2 + [torch.zeros(n1, n1)] * 2
    x = torch.zeros(3, n1 * n2)
    with pytest.raises(ValueError):
        kb.mxu_fft_two_phase(torch.zeros(3, 25), torch.zeros(3, 25), *tabs)
    with pytest.raises(ValueError):
        kb.mxu_fft_two_phase(x, x, *tabs[:4], torch.zeros(n2, n2), tabs[5])
    before = (launches("mxu_fft_single"), launches("mxu_fft_two_phase"))
    kb.mxu_fft_single(ok, ok, d, d)
    kb.mxu_fft_two_phase(x, x, *tabs)
    assert (launches("mxu_fft_single"), launches("mxu_fft_two_phase")) == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 125, 128, 250, 1000, 4096, 16384])
def test_kernel_matches_plain_on_card(cuda_device, n):
    plan = MxuFftPlan.create(n, impl="pallas", device="cpu")
    rng = np.random.default_rng(RNG_SEED + n)
    xr, xi = _planes((1000, n), rng)
    re, im = (torch.as_tensor(t, device=cuda_device) for t in (xr, xi))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for mode in Transform:
            flat = [torch.as_tensor(t, device=cuda_device)
                    for pair in _tables(plan, mode) for t in pair]
            kernel = kb.mxu_fft_single if plan.single_phase else kb.mxu_fft_two_phase
            plain = (bailey.xla_fft_single if plan.single_phase
                     else bailey.reference_two_phase)
            op = "mxu_fft_single" if plan.single_phase else "mxu_fft_two_phase"
            before = launches(op)
            k = kernel(re, im, *flat)
            assert launches(op) == before + 1
            p = plain(re, im, *flat)
            got = k[0].cpu().numpy() + 1j * k[1].cpu().numpy()
            assert _rel(got, p[0].cpu().numpy() + 1j * p[1].cpu().numpy()) <= CARD_GATE
            assert _rel(got, _np_want(xr, xi, mode)) <= CARD_GATE, (n, mode)
            for tb in (1, 4):  # no result depends on the batch tile
                again = kernel(re, im, *flat, tb=tb)
                assert torch.equal(again[0], k[0]) and torch.equal(again[1], k[1])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
