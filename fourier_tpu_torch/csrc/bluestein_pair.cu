// Kernel B2, paired-block body: the fused Bluestein (chirp-z) FFT over
// complex64 planar, batch-minor (n, B) planes, for NVIDIA Hopper (sm_90a),
// in a library of its own. The host function checks its arguments, launches
// on the caller's stream, neither allocates nor synchronises, and returns
// cudaGetLastError().
//
// Replaces fourier_tpu/ops/pallas/stockham_vpu.py:_bluestein_kernel (:881),
// launched by vpu_bluestein_batch_minor (:946), for the inner sizes M <=
// 2048 (n <= 1024) that VpuBluesteinPlan.choose_inner gives, the even m of
// B1's domain, 64..2048, but M = 1024 (FOURIER_B2_ROWS of stockham_pair.cuh,
// where ptxas spilled in every arrangement of the body tried) and those of
// B2_STAGE_FASTER, where the stage body won a same-run A/B. The stage body
// of stockham_vpu.cu (bluestein_planar<float>) stays the kernel there and
// for M above 2048 (n >= 1025, up to M = 8192), where half a tile of
// 32-byte runs needs more than 512 threads at 16 points each.
//
// What bounds it on this card: at n = 1013, B = 65536 the bytes (16*n*B,
// 1.06 GB, 0.32 ms at 3.35 TB/s) against two M = 2048 transforms on chip
// (2*5*M*log2(M)*B flops, 14.8 GFLOP, 0.22 ms at 67 TFLOP/s f32): bytes,
// with the operations close behind. There, on an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 5b), it took 3.21 ms, 0.099 of that bound, against
// 4.82 ms for the stage body in the same run: a cluster's tile takes about
// 26 us, so the passes' latency and barriers, not the bytes, bound it.
//
// Design: bluestein_pair of stockham_pair.cuh (B7's and B5a's body) with
// its default planes (ChirpPlanes) at float, 512 threads a block, 16 points
// a thread, 8 columns a block at M = 2048 (more where M is small). The two
// blocks of a cluster share an (M, 32-byte)
// column group, M/2 rows each; persistent clusters walk the groups, cp.async
// bringing the next group in while the passes run. The input rows [0, n)
// lie in the first half of the padded column (M >= 2n - 1), so each rank
// copies half of them; the first forward pass reads them across the pair
// times the input chirp (rank 1 also times W_M^row), the last forward pass
// stores times wt at frequency 2*row + rank, the inverse passes follow, and
// each rank joins half of the output rows, E[p] + W_M^-p * O[p], times
// xo * scale. The split twiddles and the M/2-point pass tables of each
// direction are one f32 table each (pair_tables in
// ops/cuda/stockham_vpu.py); the chirps are the plan's, as for the stage
// body.

#include "stockham_pair.cuh"

namespace {

constexpr int kThreads = 512;

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
bluestein_pair_c64(const float* __restrict__ xre, const float* __restrict__ xim,
                   float* __restrict__ yre, float* __restrict__ yim, int n,
                   int batch, ChirpZ<float> t, float scale, int vec) {
  bluestein_pair<float, kThreads, H>(
      ChirpPlanes<float>{xre, xim, yre, yim, batch, scale, vec}, n, t);
}

}  // namespace

extern "C" {

// B2, paired-block body: Bluestein transform of the B = `batch` columns of
// the planar (n, B) input into the planar (n, B) output through an M =
// `m`-point inner transform, for the M/2 of FOURIER_B2_ROWS, with tiles
// of m/2 rows and `cols` columns a block and `threads` = 512 threads.
// `radices` (host memory, `npasses` entries) must be the compiled body's
// schedule of m/2; `fw*`/`iv*` hold the m/2 split twiddles W_M^(-+p) of
// their direction, then the concatenated pass tables; `xt*` (n), `wt*` (m),
// `xo*` (n): the direction-matched chirp tables, 1/M folded into xo.
// Returns a cudaError_t code, 0 on success.
int fourier_bluestein_pair_c64(const float* xre, const float* xim, float* yre,
                               float* yim, int n, int m, int batch, int cols,
                               int threads, int npasses, const int* radices,
                               const float* fwre, const float* fwim,
                               const float* ivre, const float* ivim,
                               const float* xtre, const float* xtim,
                               const float* wtre, const float* wtim,
                               const float* xore, const float* xoim,
                               float scale, int device, void* stream) {
  const int h = m / 2;
  if (n <= 0 || m % 2 != 0 || 2 * n - 1 > m || batch <= 0 ||
      !pair_geometry_matches<float, kThreads>(h, cols, threads, npasses,
                                              radices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kern)(const float*, const float*, float*, float*, int, int,
               ChirpZ<float>, float, int) = nullptr;
  switch (h) {
#define FOURIER_B2_CASE(R)        \
  case R:                         \
    kern = bluestein_pair_c64<R>; \
    break;
    FOURIER_B2_ROWS(FOURIER_B2_CASE)
#undef FOURIER_B2_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 4 * sizeof(float) * static_cast<size_t>(h) * cols;
  const int vec = batch % 4 == 0 && aligned16(xre) && aligned16(xim) &&
                  aligned16(yre) && aligned16(yim);
  const ChirpZ<float> t{fwre, fwim, ivre, ivim, xtre, xtim,
                        wtre, wtim, xore, xoim};
  return launch_clusters<2>(kern, (batch + cols - 1) / cols, threads, smem,
                            device, stream, xre, xim, yre, yim, n, batch, t,
                            scale, vec);
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
