// Kernels B6-B8: the complex128 route, native float64, planar and
// batch-minor, for NVIDIA Hopper (sm_90a), in one library. A c128 value is
// two f64 planes (re, im); the TPU kernels they replace emulate f64 with four
// f32 planes (hi/lo pairs), which the card does not need. Each host function
// checks its arguments, launches on the caller's stream, neither allocates
// nor synchronises, and returns cudaGetLastError().
//
// Kernel B6: the fused all-stages Stockham FFT in f64, batch-minor (n, B).
//
// Replaces fourier_tpu/ops/pallas/stockham_vpu_dd.py:_kernel (:344),
// launched by vpu_dd_fft_batch_minor (:592). It computes the DFT of every
// column of a contiguous planar f64 (n, B) pair, in any of the five modes,
// into fresh outputs, for n in radix_schedule_dd's domain (n = 2^a*3^b*5^c,
// 8 | n, 64 <= n <= 4096, plus 243, 729 and 625).
//
// What bounds it on this card: memory. One call reads and writes the two
// planes once, 32*n*B bytes (0.64 ms at n=1024, B=65536 at 3.35 TB/s),
// against 5*n*log2(n) f64 flops per column (0.10 ms at 34 TFLOP/s f64 on the
// same shape).
//
// Design: stockham_planar<double> of stockham_stages.cuh, B1's kernel at
// double, with the stage code, the masked ragged column group and the store
// scale of B1.
// - Schedule. The plan's domain is radix_schedule_dd of the TPU kernel; the
//   kernel runs kernel_schedule_dd (ops/cuda/stockham_vpu_dd.py), every
//   radix split into 8, 4, 2, 3 and 5 (27 -> 3, 3, 3; 25 -> 5, 5).
// - Registers. An f64 radix-8 stage holds two butterflies of 8 complex
//   values a thread, 64 32-bit registers of data, so f64 blocks have at most
//   512 threads (launch_geometry_dd) and take only the instantiation bounded
//   at 512, where a thread may have 128 registers.
// - Shared memory. A block's (n, cols) planes take 16*n*cols bytes, at most
//   8192 points (128 KiB): 2 columns at n = 4096, 8 at 1024, 32 up to 256.
// - Twiddles. Compact per-stage (m, r) tables, W_s^(i*k), computed in f64 at
//   plan time and kept in f64; the butterflies' constants are double
//   instantiations of the variable templates in stockham_stages.cuh. A
//   stage that kept a float constant would lose about eight digits.
//
// Kernel B7: the fused Bluestein (chirp-z) FFT in f64, batch-minor (n, B).
//
// Replaces fourier_tpu/ops/pallas/stockham_vpu_dd.py:_bluestein_kernel_dd
// (:465, stages _stages_value_dd :419), launched by
// vpu_dd_bluestein_batch_minor (:521). For every column: the chirp multiply
// with zero rows n..M-1 written into shared memory, the forward M-point
// stages, the multiply by w, the inverse stages unscaled, and the output
// chirp (1/M folded in at plan time) times the mode scale. M is
// next_power_of_two(2n-1) <= 2048.
//
// What bounds it on this card: at n = 1013, B = 65536 the bytes (32*n*B,
// 2.12 GB, 0.63 ms) and the two M = 2048 transforms on chip
// (2*5*M*log2(M)*B f64 flops, 14.8 GFLOP, 0.43 ms) are of the same order:
// the kernel sits near the card's f64 ridge point.
//
// Design: bluestein_pair_c128, the paired-block engine of stockham_pair.cuh
// at double: two blocks of a cluster share an (M, 4)-column group, 32-byte
// row runs, each block holding M/2 rows; persistent clusters walk the
// groups, cp.async bringing the next group in while the passes run; 256
// threads a block at 16 points each; the M/2-point passes fixed at compile
// time for each M (64..2048, six bodies). The n input rows all lie in the
// first half of the padded column (n <= M/2), so the cross-block split
// needs no second half: each rank copies half of them, the first pass reads
// them across the pair times the input chirp (rank 1 also times W_M^row;
// rows n.. read as zeros, never copied), the last forward pass stores times
// w, and after the inverse passes each rank joins half of the output rows,
// E[p] + W_M^-p * O[p], and stores them times xo * scale. At 1013 x 65536
// on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 5e, same run) it took
// 5.2 ms, 0.12 of the bound, where the stage body took 9.7 ms, 0.066. That
// body, bluestein_planar<double> of
// stockham_stages.cuh (B2's kernel at double, 4 columns, 512 threads), is
// still compiled for that same-run comparison; nothing else launches it.
//
// Kernel B8: the radix-r DIT split combine in f64, batch-minor.
//
// Replaces fourier_tpu/ops/pallas/dd_combine.py:_combine_kernel (:58),
// launched by dd_split_combine_batch_minor (:102). A split plan
// (precision/dd_split.py) computes FFT_n, n = r*m, r in {2, 3, 5}, as one
// batched m-point transform of the r residue classes plus this combine. The
// input is the (m, r*B) sub-spectra, class t in columns t*B..t*B+B-1 (the
// (n, B) input viewed as (m, r*B) is the classes' batch-minor input with no
// copy); the tables are r-1 planar f64 rows of m entries, w^(t*k) for class
// t. Section j of the (r, m, B) output is
//   sum_t (class t * w^(t*k) * scale) * W_r^(j*t),
// so the output viewed as (n, B) is the spectrum in natural order.
//
// What bounds it on this card: memory. One call reads and writes 32*n*B
// bytes (1.15 GB at n = 2187, B = 16384, 0.34 ms) against one complex
// multiply per class and an r-point butterfly per point.
//
// Design: one thread per (k, b), a block of 256 threads over adjacent b at
// one k (grid y), so every class load and every section store is a
// contiguous run of the batch. The r-point butterfly is stockham_stages.cuh's
// at double. The mode scale multiplies the twiddle of classes 1..r-1 and
// class 0 on load. The TPU kernel's row blocking (_row_block, a VMEM limit)
// has no counterpart.

#include "stockham_pair.cuh"
#include "stockham_stages.cuh"

namespace {

constexpr int kMaxThreadsDd = 512;
constexpr int kPairThreadsDd = 256;
constexpr int kCombineThreads = 256;

template <int R, bool F>
__global__ void __launch_bounds__(kCombineThreads)
split_combine_c128(const double* __restrict__ xre,
                   const double* __restrict__ xim, double* __restrict__ yre,
                   double* __restrict__ yim, int m, int batch,
                   const double* __restrict__ twre,
                   const double* __restrict__ twim, double scale) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (b >= batch) return;
  const size_t row = static_cast<size_t>(k) * R * batch;
  double xr[R], xi[R];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const size_t g = row + static_cast<size_t>(t) * batch + b;
    const double a = xre[g], c = xim[g];
    if (t == 0) {
      xr[0] = a * scale;
      xi[0] = c * scale;
    } else {
      const double wr = __ldg(twre + (t - 1) * m + k) * scale;
      const double wi = __ldg(twim + (t - 1) * m + k) * scale;
      xr[t] = a * wr - c * wi;
      xi[t] = a * wi + c * wr;
    }
  }
  butterfly<R, F>(xr, xi);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const size_t g = (static_cast<size_t>(j) * m + k) * batch + b;
    yre[g] = xr[j];
    yim[g] = xi[j];
  }
}

// B7's paired-block body (stockham_pair.cuh) over M = 2h. The input rows
// [0, n) are all in the first half of the padded column (n <= h), so the
// cross-block split has b = 0: rank 0 transforms u = a * xt, rank 1
// v = a * xt * W_M^row, rows n.. read as zeros, never copied. The ranks
// copy half of the input rows each, at their rows in their own buffers, and
// the first forward pass reads them across the pair; the last forward pass
// stores times wt at frequency 2*row + rank; after the inverse passes each
// rank stores half of the rows p < n of (E[p] + W_M^-p * O[p]) * xo[p] *
// scale, E from rank 0 and O from rank 1. The t.fw*
// and t.iv* tables hold the h split twiddles of their direction, then the
// pass tables; `vec`: 16-byte copies and stores. The tile and passes of
// M = 2H are fixed at compile time.
template <int Threads, int H>
__global__ void __launch_bounds__(Threads, 1)
bluestein_pair_c128(const double* __restrict__ xre,
                    const double* __restrict__ xim, double* __restrict__ yre,
                    double* __restrict__ yim, int n, int batch,
                    ChirpZ<double> t, double scale, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const smem = reinterpret_cast<double*>(smem_raw);
  using Tile = PairTile<double, Threads, H>;
  constexpr int cols = Tile::kCols, logc = Tile::kLogC, plane = H * cols;
  const size_t bs = static_cast<size_t>(batch);
  const int ntiles = (batch + cols - 1) >> logc;
  const int clusters = static_cast<int>(gridDim.x >> 1);
  // Input rows [0, n) are split between the ranks at n0: rank r copies rows
  // [r0, r1) into its own buffer, at the same rows.
  const int n0 = (n + 1) / 2;
  const int r0 = rank == 0 ? 0 : n0, r1 = rank == 0 ? n0 : n;
  auto fetch = [&](int tile, double* sre, double* sim) {
    const int b0 = tile << logc;
    if (vec) {
      constexpr int lc = logc - 1;  // a row is 1 << lc 16-byte chunks
      const int total = (2 * (r1 - r0)) << lc;
      for (int e = thread_x(); e < total; e += Threads) {
        const int c2 = (e & ((1 << lc) - 1)) << 1, rr = e >> lc;
        if (b0 + c2 < batch) {
          const int row = r0 + (rr >> 1);
          copy_async<16>((rr & 1 ? sim : sre) + Tile::index(row, c2),
                         (rr & 1 ? xim : xre) + row * bs + b0 + c2);
        }
      }
    } else {
      const int total = (2 * (r1 - r0)) << logc;
      for (int e = thread_x(); e < total; e += Threads) {
        const int col = e & (cols - 1), rr = e >> logc;
        if (b0 + col < batch) {
          const int row = r0 + (rr >> 1);
          copy_async<8>((rr & 1 ? sim : sre) + Tile::index(row, col),
                        (rr & 1 ? xim : xre) + row * bs + b0 + col);
        }
      }
    }
  };
  int buf = 0;
  int tile = static_cast<int>(blockIdx.x >> 1);
  if (tile < ntiles) fetch(tile, smem, smem + plane);
  copy_commit();
  for (; tile < ntiles; tile += clusters, buf ^= 1) {
    double* sre = smem + 2 * buf * plane;
    double* sim = sre + plane;
    if (tile + clusters < ntiles) {
      double* next = smem + 2 * (buf ^ 1) * plane;
      fetch(tile + clusters, next, next + plane);
    }
    copy_commit();
    copy_wait_previous();
    cluster.sync();  // both ranks' rows of the tile are in shared memory
    // The two ranks' buffers, each local or through distributed shared memory.
    const double* re0 = rank == 0 ? sre : cluster.map_shared_rank(sre, 0);
    const double* im0 = rank == 0 ? sim : cluster.map_shared_rank(sim, 0);
    const double* re1 = rank == 1 ? sre : cluster.map_shared_rank(sre, 1);
    const double* im1 = rank == 1 ? sim : cluster.map_shared_rank(sim, 1);
    auto chirp_in = [&](int row, int col, double& re, double& im) {
      if (row >= n) {
        re = 0.0;
        im = 0.0;
        return;
      }
      const int e = Tile::index(row, col);
      re = row < n0 ? re0[e] : re1[e];
      im = row < n0 ? im0[e] : im1[e];
      cmul(re, im, __ldg(t.xtre + row), __ldg(t.xtim + row));
      if (rank == 1) cmul(re, im, __ldg(t.fwre + row), __ldg(t.fwim + row));
    };
    auto split_done = [&] { cluster.sync(); };  // both read their input rows
    auto times_w = [&](int row, int, double& re, double& im) {
      const int f = 2 * row + rank;
      cmul(re, im, __ldg(t.wtre + f), __ldg(t.wtim + f));
    };
    pair_passes<0, true, Tile, Threads>(sre, sim, t.fwre, t.fwim, chirp_in,
                                        split_done, times_w);
    pair_passes<0, false, Tile, Threads>(sre, sim, t.ivre, t.ivim,
                                         TileLoad<Tile, double>{sre, sim},
                                         BlockSync{}, NoHook{});
    cluster.sync();  // both halves are complete
    // Rank r stores output rows [r0, r1): E from rank 0, O from rank 1.
    const int b0 = tile << logc;
    const int lc = vec ? logc - 1 : logc;
    const int width = vec ? 2 : 1;
    const int total = (r1 - r0) << lc;
    for (int e = thread_x(); e < total; e += Threads) {
      const int c = (e & ((1 << lc) - 1)) * width, p = r0 + (e >> lc);
      if (b0 + c >= batch) continue;
      const int s = Tile::index(p, c);
      const double wr = __ldg(t.ivre + p), wi = __ldg(t.ivim + p);
      const double cr = __ldg(t.xore + p) * scale, ci = __ldg(t.xoim + p) * scale;
      double vr[2] = {0.0, 0.0}, vi[2] = {0.0, 0.0};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u >= width) break;
        double o_r = re1[s + u], o_i = im1[s + u];
        cmul(o_r, o_i, wr, wi);
        vr[u] = re0[s + u] + o_r;
        vi[u] = im0[s + u] + o_i;
        cmul(vr[u], vi[u], cr, ci);
      }
      const size_t g = static_cast<size_t>(p) * bs + b0 + c;
      if (vec) {
        *reinterpret_cast<double2*>(yre + g) = make_double2(vr[0], vr[1]);
        *reinterpret_cast<double2*>(yim + g) = make_double2(vi[0], vi[1]);
      } else {
        yre[g] = vr[0];
        yim[g] = vi[0];
      }
    }
    cluster.sync();  // no copy into a buffer the partner still reads
  }
  cluster.sync();  // the partner may still read this block's tile
}

template <int R>
int launch_combine(const double* xre, const double* xim, double* yre,
                   double* yim, int m, int batch, const double* twre,
                   const double* twim, int forward, double scale, int device,
                   void* stream) {
  auto kern = forward ? split_combine_c128<R, true> : split_combine_c128<R, false>;
  int err = prepare_launch(kern, 0, device);
  if (err != 0) return err;
  const dim3 grid((batch + kCombineThreads - 1) / kCombineThreads, m);
  kern<<<grid, kCombineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, m, batch, twre, twim, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B6: transform the B = `batch` columns of the planar f64 (n, B) input into
// the planar f64 (n, B) output. `radices` (host memory, `nstages` entries
// from {2, 3, 4, 5, 8}) multiply to n; `twre`/`twim` hold the concatenated
// per-stage (n_s / r_s, r_s) f64 tables of every stage but the last;
// `threads` <= 512. Returns a cudaError_t code, 0 on success.
int fourier_stockham_c128(const double* xre, const double* xim, double* yre,
                          double* yim, int n, int batch, int cols, int threads,
                          int nstages, const int* radices, const double* twre,
                          const double* twim, int forward, double scale,
                          int device, void* stream) {
  return launch_stockham<double, kMaxThreadsDd>(
      xre, xim, yre, yim, n, batch, cols, threads, nstages, radices, twre,
      twim, forward, scale, device, stream);
}

// B7's stage body, launched only for same-run comparisons (the
// wrapper's `_body="stage"`): Bluestein transform of the B = `batch` columns of the planar f64
// (n, B) input into the planar f64 (n, B) output, through an M = `m`-point
// inner transform whose `nstages` radices (host memory) multiply to m.
// `fw*`/`iv*`: the concatenated forward / inverse f64 stage tables of that
// schedule; `xt*` (n), `wt*` (m), `xo*` (n): the direction-matched f64 chirp
// tables, 1/M folded into xo; `threads` <= 512. Returns a cudaError_t code,
// 0 on success.
int fourier_bluestein_c128(const double* xre, const double* xim, double* yre,
                           double* yim, int n, int m, int batch, int cols,
                           int threads, int nstages, const int* radices,
                           const double* fwre, const double* fwim,
                           const double* ivre, const double* ivim,
                           const double* xtre, const double* xtim,
                           const double* wtre, const double* wtim,
                           const double* xore, const double* xoim,
                           double scale, int device, void* stream) {
  const ChirpZ<double> t{fwre, fwim, ivre, ivim, xtre, xtim,
                         wtre, wtim, xore, xoim};
  return launch_bluestein<double, kMaxThreadsDd>(
      xre, xim, yre, yim, n, m, batch, cols, threads, nstages, radices, t,
      scale, device, stream);
}

// B7, paired-block body: as fourier_bluestein_c128, with tiles of m/2 rows
// and `cols` columns a block (a power of two, at least 4) and `threads` =
// 256 threads covering 16 points each. `radices` (host memory, `npasses`
// entries from {2, 4, 8, 16}) multiply to m/2; `fw*`/`iv*` hold the m/2
// split twiddles W_M^(-+p) of their direction, then the concatenated pass
// tables. Returns a cudaError_t code, 0 on success.
int fourier_bluestein_pair_c128(const double* xre, const double* xim,
                                double* yre, double* yim, int n, int m,
                                int batch, int cols, int threads, int npasses,
                                const int* radices, const double* fwre,
                                const double* fwim, const double* ivre,
                                const double* ivim, const double* xtre,
                                const double* xtim, const double* wtre,
                                const double* wtim, const double* xore,
                                const double* xoim, double scale, int device,
                                void* stream) {
  const int h = m / 2;
  if (n <= 0 || m % 2 != 0 || 2 * n - 1 > m || batch <= 0 ||
      !pair_geometry_matches<double, kPairThreadsDd>(h, cols, threads, npasses,
                                                     radices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kern)(const double*, const double*, double*, double*, int, int,
               ChirpZ<double>, double, int) = nullptr;
  switch (h) {
    case 32: kern = bluestein_pair_c128<kPairThreadsDd, 32>; break;
    case 64: kern = bluestein_pair_c128<kPairThreadsDd, 64>; break;
    case 128: kern = bluestein_pair_c128<kPairThreadsDd, 128>; break;
    case 256: kern = bluestein_pair_c128<kPairThreadsDd, 256>; break;
    case 512: kern = bluestein_pair_c128<kPairThreadsDd, 512>; break;
    case 1024: kern = bluestein_pair_c128<kPairThreadsDd, 1024>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 4 * sizeof(double) * static_cast<size_t>(h) * cols;
  const int vec = batch % 2 == 0 && aligned16(xre) && aligned16(xim) &&
                  aligned16(yre) && aligned16(yim);
  const ChirpZ<double> t{fwre, fwim, ivre, ivim, xtre, xtim,
                         wtre, wtim, xore, xoim};
  return launch_pairs(kern, (batch + cols - 1) / cols, threads, smem, device,
                      stream, xre, xim, yre, yim, n, batch, t, scale, vec);
}

// B8: combine the planar f64 (m, r*B) sub-spectra of the r residue classes
// (class t in columns t*B..t*B+B-1) into the planar f64 (r, m, B) spectrum,
// r = `radix` in {2, 3, 5}, B = `batch`. `twre`/`twim` hold r-1 rows of m
// entries, row t-1 = w^(t*k), direction-matched; `scale` is the mode scale
// (1 for unscaled modes). Returns a cudaError_t code, 0 on success.
int fourier_split_combine_c128(const double* xre, const double* xim,
                               double* yre, double* yim, int radix, int m,
                               int batch, const double* twre,
                               const double* twim, int forward, double scale,
                               int device, void* stream) {
  if (m <= 0 || m > 65535 || batch <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (radix) {
    case 2:
      return launch_combine<2>(xre, xim, yre, yim, m, batch, twre, twim,
                               forward, scale, device, stream);
    case 3:
      return launch_combine<3>(xre, xim, yre, yim, m, batch, twre, twim,
                               forward, scale, device, stream);
    case 5:
      return launch_combine<5>(xre, xim, yre, yim, m, batch, twre, twim,
                               forward, scale, device, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
