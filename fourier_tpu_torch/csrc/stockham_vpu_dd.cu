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
// Design: the clustered-block body of fft_pair_dd.cu (B1's body at double,
// a library of its own) is the kernel at the 60 n of fft_pair_geometry_dd;
// this file's stage body, stockham_planar<double> of stockham_stages.cuh
// (B1's stage kernel at double, with its stage code, masked ragged column
// group and store scale), at the rest of the domain (243, 625, 729, 3000,
// 3240 and the n of B6_STAGE_FASTER):
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
// body, bluestein_planar<double> of stockham_stages.cuh (B2's kernel at
// double, 4 columns, 512 threads), ran at no size and is gone.
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

// B7's paired-block body: bluestein_pair of stockham_pair.cuh at double.
template <int Threads, int H>
__global__ void __launch_bounds__(Threads, 1)
bluestein_pair_c128(const double* __restrict__ xre,
                    const double* __restrict__ xim, double* __restrict__ yre,
                    double* __restrict__ yim, int n, int batch,
                    ChirpZ<double> t, double scale, int vec) {
  bluestein_pair<double, Threads, H>(
      ChirpPlanes<double>{xre, xim, yre, yim, batch, scale, vec}, n, t);
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

// B7, paired-block body: Bluestein transform of the B = `batch` columns of
// the planar f64 (n, B) input into the planar f64 (n, B) output, through an
// M = `m`-point inner transform, with tiles of m/2 rows and `cols` columns
// a block (a power of two, at least 4) and `threads` = 256 threads covering
// 16 points each. `radices` (host memory, `npasses` entries from {2, 4, 8,
// 16}) multiply to m/2; `fw*`/`iv*` hold the m/2 split twiddles W_M^(-+p)
// of their direction, then the concatenated pass tables; `xt*` (n), `wt*`
// (m), `xo*` (n): the direction-matched f64 chirp tables, 1/M folded into
// xo. Returns a cudaError_t code, 0 on success.
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
  return launch_clusters<2>(kern, (batch + cols - 1) / cols, threads, smem,
                            device, stream, xre, xim, yre, yim, n, batch, t,
                            scale, vec);
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
