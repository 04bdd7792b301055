// Kernel B6, clustered-block body: the fused Stockham FFT over complex128
// planar (two f64 planes), batch-minor (n, B) planes, for NVIDIA Hopper
// (sm_90a), in a library of its own. The host function checks its
// arguments, launches on the caller's stream, neither allocates nor
// synchronises, and returns cudaGetLastError().
//
// Replaces fourier_tpu/ops/pallas/stockham_vpu_dd.py:_kernel (:344),
// launched by vpu_dd_fft_batch_minor (:592), for B1's 60 clustered sizes,
// all in B6's domain: the 46 n with 8 | n up to 2048 on clusters of C = 2
// blocks (FOURIER_PAIR_ROWS of stockham_pair.cuh) and the 14 n in (2048,
// 4096] whose n/4 is one of those halves on clusters of C = 4
// (FOURIER_B1_QUAD_ROWS). The stage body of stockham_vpu_dd.cu
// (stockham_planar<double>) stays the kernel for 243, 625 and 729, for 3000
// and 3240, whose n/4 is no body of the engine, and at the n of
// B6_STAGE_FASTER, where it won a same-run A/B (fft_pair_geometry_dd in
// ops/cuda/stockham_vpu_dd.py).
//
// What bounds it on this card: memory. One call reads and writes the two
// f64 planes once, 32*n*B bytes (0.64 ms at 1024 x 65536 at 3.35 TB/s),
// against 5*n*log2(n) f64 flops a column (0.10 ms at 34 TFLOP/s f64 on the
// same shape). On an H100 80GB HBM3 at 700 W it took 1.55-1.59 ms there and
// 2.03-2.07 ms at 4096 x 16384 (2.60 ms with a split that read all C
// ranks' rows point by point, in the same run).
//
// Design: fft_pair of stockham_pair.cuh (B1's body) at double, 256 threads
// a block, 16 points a thread, so a thread may hold up to 255 registers;
// the passes of h = n/C fixed at compile time for each size. A tile's rows
// are 32-byte runs of 4 f64 columns at h = 1024 (n = 2048 on two blocks,
// 4096 on four), 8 at h = 512, more where h is small; the stage body took
// 2 columns at n = 4096, 16-byte runs. The cross-block radix-C split is
// B1's push split at 2 f64 columns a 16-byte chunk: rank r of a cluster
// copies the rows s*h + p of every block s for p in its share [r*h/C,
// (r+1)*h/C) of both planes into its own buffer, forms all C outputs at
// its p and stores output s to rank s's buffer (16-byte DSMEM stores,
// (C-1)/C of each tile across the cluster); after the passes rank r
// stores row k to output row C*k + r, times
// the scale, in 16-byte runs where the batch is even. The inverse is the
// forward body on the planes exchanged, IDFT(x) = swap(DFT(swap(x))), so
// the tables are the forward ones: pair_tables in f64, the (C-1)*h split
// twiddles W_n^(r*p), then the pass tables, computed in f64 and never
// narrowed.

#include <utility>

#include "stockham_pair.cuh"

namespace {

constexpr int kThreads = 256;

// The forward DFT for n = C*H, times `scale`: fft_pair of
// stockham_pair.cuh at double, on the planes of its PlanePolicy.
// `twre`/`twim`: the (C-1)*H split twiddles, then the pass tables; `vec`:
// 16-byte copies and stores.
template <int C, int H>
__global__ void __launch_bounds__(kThreads, 1)
fft_pair_c128(const double* __restrict__ xre, const double* __restrict__ xim,
              double* __restrict__ yre, double* __restrict__ yim, int batch,
              const double* __restrict__ twre, const double* __restrict__ twim,
              double scale, int vec) {
  fft_pair<double, kThreads, C, H>(
      PlanePolicy<double>{xre, xim, yre, yim, batch, scale, vec}, twre, twim);
}

using Body = void (*)(const double*, const double*, double*, double*, int,
                      const double*, const double*, double, int);

// The compiled body of a C-block cluster with h rows a block, or nullptr.
Body body_of(int ranks, int h) {
  switch (ranks * 8192 + h) {
#define FOURIER_B6_PAIR_CASE(R) \
  case 2 * 8192 + R:            \
    return fft_pair_c128<2, R>;
#define FOURIER_B6_QUAD_CASE(R) \
  case 4 * 8192 + R:            \
    return fft_pair_c128<4, R>;
    FOURIER_PAIR_ROWS(FOURIER_B6_PAIR_CASE)
    FOURIER_B1_QUAD_ROWS(FOURIER_B6_QUAD_CASE)
#undef FOURIER_B6_PAIR_CASE
#undef FOURIER_B6_QUAD_CASE
    default:
      return nullptr;
  }
}

size_t smem_of(int h, int cols) {
  return 4 * sizeof(double) * static_cast<size_t>(h) * cols;
}

}  // namespace

extern "C" {

// B6, clustered-block body: the planar f64 (n, B) input (B = `batch`) into
// the planar f64 (n, B) output, on clusters of `ranks` (2 or 4) blocks of
// n/ranks rows, for the (ranks, n/ranks) of FOURIER_PAIR_ROWS (ranks 2) and
// FOURIER_B1_QUAD_ROWS (ranks 4). `cols`, `threads` and the `npasses`
// `radices` (host memory) must be the compiled body's tile and schedule of
// n/ranks; `twre`/`twim` hold the (ranks-1)*n/ranks forward split twiddles
// W_n^(r*p), then the concatenated forward pass tables, for both
// directions. Returns a cudaError_t code, 0 on success.
int fourier_stockham_pair_c128(const double* xre, const double* xim,
                               double* yre, double* yim, int n, int batch,
                               int ranks, int cols, int threads, int npasses,
                               const int* radices, const double* twre,
                               const double* twim, int forward, double scale,
                               int device, void* stream) {
  if (batch <= 0 || ranks <= 0 || n % ranks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int h = n / ranks;
  const Body kern = body_of(ranks, h);
  if (kern == nullptr ||
      !pair_geometry_matches<double, kThreads>(h, cols, threads, npasses,
                                               radices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = batch % 2 == 0 && aligned16(xre) && aligned16(xim) &&
                  aligned16(yre) && aligned16(yim);
  const int ntiles = (batch + cols - 1) / cols;
  const size_t smem = smem_of(h, cols);
  if (!forward) {  // IDFT(x) = swap(DFT(swap(x))), swap exchanging re and im
    std::swap(xre, xim);
    std::swap(yre, yim);
  }
  if (ranks == 2) {
    return launch_clusters<2>(kern, ntiles, threads, smem, device, stream, xre,
                              xim, yre, yim, batch, twre, twim, scale, vec);
  }
  return launch_clusters<4>(kern, ntiles, threads, smem, device, stream, xre,
                            xim, yre, yim, batch, twre, twim, scale, vec);
}

// The clusters of `ranks` blocks that B6's clustered body for n keeps on
// the card at once, into `clusters`. Returns a cudaError_t code, 0 on
// success.
int fourier_stockham_pair_clusters_c128(int n, int ranks, int cols, int device,
                                        int* clusters) {
  if (ranks <= 0 || n % ranks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int h = n / ranks;
  const Body kern = body_of(ranks, h);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const size_t smem = smem_of(h, cols);
  return ranks == 2
             ? max_clusters<2>(kern, kThreads, smem, device, nullptr, &cfg,
                               attr, clusters)
             : max_clusters<4>(kern, kThreads, smem, device, nullptr, &cfg,
                               attr, clusters);
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
