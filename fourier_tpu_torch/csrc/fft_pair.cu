// Kernel B1, clustered-block body: the fused Stockham FFT over complex64
// planar, batch-minor (n, B) planes, for NVIDIA Hopper (sm_90a), in a
// library of its own. The host function checks its arguments, launches on
// the caller's stream, neither allocates nor synchronises, and returns
// cudaGetLastError().
//
// Replaces fourier_tpu/ops/pallas/stockham_vpu.py:_kernel (:422), launched
// by vpu_fft_batch_minor (:1208), for 60 sizes of B1's domain: the 46 n
// with 8 | n up to 2048 on clusters of C = 2 blocks, and the 14 n in
// (2048, 4096] whose n/4 is one of those 46 halves on clusters of C = 4
// (2160, 2304, ..., 4000, 4096; FOURIER_PAIR_ROWS and FOURIER_B1_QUAD_ROWS
// in stockham_pair.cuh). The stage body of stockham_vpu.cu
// (stockham_planar<float>) stays the kernel for 3000 and 3240, for the
// pure powers 243, 625, 729, 2187, 3125 and 6561, and above 4096, where h =
// n/4 is no body of the engine, and at the n of B1_STAGE_FASTER, where it
// won a same-run A/B (fft_pair_geometry in ops/cuda/stockham_vpu.py).
//
// What bounds it on this card: memory. One call reads and writes the two
// planes once, 16*n*B bytes (0.32 ms at 4096 x 16384 at 3.35 TB/s), against
// 5*n*log2(n) flops a column, about 1.5 flops a byte at n = 4096. There, on
// an H100 80GB HBM3 at 700 W, it took 1.12-1.16 ms, 0.28 of that bound,
// against 1.40-1.44 ms with a split that read all C ranks' rows point by
// point (a same-run A/B of both) and 2.12 ms for the stage body; at 1024 x
// 65536 0.84 ms with either split.
//
// Design: fft_pair of the clustered-block engine (stockham_pair.cuh; B6's
// body at double) at float, 512 threads a block, 16 points a thread, the
// passes of h = n/C fixed at compile time for each size. The cross-block
// radix-C split, v_s[p] = W_n^(s*p) * sum_t a_t[p] * W_C^(s*t) with a_t[p]
// input row t*h + p, is pushed: rank r of a cluster copies the rows t*h +
// p of every block t for p in its share [r*h/C, (r+1)*h/C) of both planes,
// 32-byte runs of 8 columns (more where h is small), into its own buffer;
// each thread reads the C rows of one p at 4 adjacent columns (16-byte
// loads), forms all C outputs and stores v_s[p] to rank s's buffer at row
// p (16-byte st.shared::cluster stores), so (C-1)/C of each tile crosses
// the cluster once, 402,653,184 bytes a call at 4096 x 16384 (the split
// that read all C ranks' rows point by point, 4-byte DSMEM loads, moved
// four times that); after the passes rank r holds X[C*k + r] at row k and
// stores it to output row C*k + r, times the scale, in 16-byte runs where
// the batch is a multiple of 4. At n = 4096
// two blocks of 2048 rows would need 256 KiB double-buffered, so four
// blocks of 1024 rows share the group: 30 such clusters fit on the card at
// once. One body serves both directions: the inverse is the forward body on
// the planes exchanged, IDFT(x) = swap(DFT(swap(x))), so the tables are the
// forward ones (pair_tables: the (C-1)*h split twiddles, then the pass
// tables, computed in f64 and narrowed).

#include <utility>

#include "stockham_pair.cuh"

namespace {

constexpr int kThreads = 512;

// The forward DFT for n = C*H, times `scale`: fft_pair of
// stockham_pair.cuh at float, on the planes of its PlanePolicy.
// `twre`/`twim`: the (C-1)*H split twiddles W_n^(r*p) (rank r = 1..C-1,
// p < H), then the pass tables; `vec`: 16-byte copies and stores.
template <int C, int H>
__global__ void __launch_bounds__(kThreads, 1)
fft_pair_c64(const float* __restrict__ xre, const float* __restrict__ xim,
             float* __restrict__ yre, float* __restrict__ yim, int batch,
             const float* __restrict__ twre, const float* __restrict__ twim,
             float scale, int vec) {
  fft_pair<float, kThreads, C, H>(
      PlanePolicy<float>{xre, xim, yre, yim, batch, scale, vec}, twre, twim);
}

// The two-block bodies are FOURIER_PAIR_ROWS, the four-block ones
// FOURIER_B1_QUAD_ROWS (both in stockham_pair.cuh).
using Body = void (*)(const float*, const float*, float*, float*, int,
                      const float*, const float*, float, int);

// The compiled body of a C-block cluster with h rows a block, or nullptr.
Body body_of(int ranks, int h) {
  switch (ranks * 8192 + h) {
#define FOURIER_B1_PAIR_CASE(R) \
  case 2 * 8192 + R:            \
    return fft_pair_c64<2, R>;
#define FOURIER_B1_QUAD_CASE(R) \
  case 4 * 8192 + R:            \
    return fft_pair_c64<4, R>;
    FOURIER_PAIR_ROWS(FOURIER_B1_PAIR_CASE)
    FOURIER_B1_QUAD_ROWS(FOURIER_B1_QUAD_CASE)
#undef FOURIER_B1_PAIR_CASE
#undef FOURIER_B1_QUAD_CASE
    default:
      return nullptr;
  }
}

size_t smem_of(int h, int cols) {
  return 4 * sizeof(float) * static_cast<size_t>(h) * cols;
}

}  // namespace

extern "C" {

// B1, clustered-block body: the planar (n, B) input (B = `batch`) into the
// planar (n, B) output, on clusters of `ranks` (2 or 4) blocks of n/ranks
// rows, for the (ranks, n/ranks) of FOURIER_PAIR_ROWS (ranks 2) and
// FOURIER_B1_QUAD_ROWS (ranks 4). `cols`, `threads` and the `npasses`
// `radices` (host memory) must be the compiled body's tile and schedule of
// n/ranks; `twre`/`twim` hold the (ranks-1)*n/ranks forward split twiddles
// W_n^(r*p), then the concatenated forward pass tables, for both
// directions. Returns a cudaError_t code, 0 on success.
int fourier_stockham_pair_c64(const float* xre, const float* xim, float* yre,
                              float* yim, int n, int batch, int ranks,
                              int cols, int threads, int npasses,
                              const int* radices, const float* twre,
                              const float* twim, int forward, float scale,
                              int device, void* stream) {
  if (batch <= 0 || ranks <= 0 || n % ranks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int h = n / ranks;
  const Body kern = body_of(ranks, h);
  if (kern == nullptr ||
      !pair_geometry_matches<float, kThreads>(h, cols, threads, npasses,
                                              radices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = batch % 4 == 0 && aligned16(xre) && aligned16(xim) &&
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

// The clusters of `ranks` blocks that B1's clustered body for n keeps on
// the card at once, into `clusters`. Returns a cudaError_t code, 0 on
// success.
int fourier_stockham_pair_clusters(int n, int ranks, int cols, int device,
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
