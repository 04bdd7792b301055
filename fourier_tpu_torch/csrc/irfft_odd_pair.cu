// Kernel B5b, paired-block body: the odd-n irfft by the two-for-one trick,
// batch-minor, for NVIDIA Hopper (sm_90a), in a library of its own. The
// host function checks its arguments, launches on the caller's stream,
// neither allocates nor synchronises, and returns cudaGetLastError().
//
// Replaces fourier_tpu/ops/pallas/stockham_vpu.py:_irfft_odd_unpack_kernel
// (:1051), launched by vpu_irfft_odd_unpack_batch_minor (:1154), for the
// inner sizes M <= 2048 whose M/2 is in FOURIER_B5B_ROWS below: B2's 45. The
// stage body of stockham_vpu.cu (irfft_odd_unpack_c64) stays the kernel at
// M = 1024 (where B2's body spills), above M = 2048 and at the M of
// B5B_STAGE_FASTER, where it won a same-run A/B (irfft_odd_unpack_geometry in
// ops/cuda/stockham_vpu.py). As there, column j of the planar (L, B)
// one-sided spectrum, L = (n+1)/2, pairs with column j + h, h = ceil(B/2):
// one M-point chirp-z with the inverse chirps transforms
//   Z[k] = X1[k] + i*X2[k]                 (k < L),
//   Z[k] = conj X1[n-k] + i*conj X2[n-k]   (L <= k < n),
// imaginary DC parts read as 0, times 1/n; the real part of its output is
// column j of the real (n, B) signal and the imaginary part column j + h.
// An unpaired last column (odd B) runs against zeros.
//
// What bounds it on this card: as B5a, at n = 1013, B = 65536 the bytes
// (the planar (L, B) spectrum in, the real plane out: 8*n*B bytes, 0.16 ms
// at 3.35 TB/s) against one M = 2048 chirp-z for two columns (0.13 ms at
// 67 TFLOP/s f32): bytes, with the operations close behind. There, on an
// H100 80GB HBM3 at 700 W (chip_smoke.py phase 5d), it took 1.62 ms, 0.098
// of that bound, against 2.53 ms for the stage body in the same run.
//
// Design: bluestein_pair of stockham_pair.cuh (B2's and B5a's body) at
// float, 512 threads a block, with this file's policy OddUnpackPlanes for
// its input and output. The clusters walk the h column pairs. Rank 0 copies
// the L spectrum rows of columns j (X1, both planes), rank 1 the same rows
// of columns j + h (X2), 16-byte copies where B is a multiple of 8 and the
// pointers are aligned, element by element elsewhere; where j + h >= B rank
// 1 writes zeros, never leaves the tile uncopied (it would hold the previous
// tile's rows), and both write the DC bin's imaginary row as zeros. The
// first forward pass reads, for input row p < n, bin k = p (p < L) or n - p
// (above) of both ranks' tiles through distributed shared memory and forms
// Z[p] there: the Hermitian tail is an index, with no reversed copy, and
// the read has no test. The passes are B2's; each rank joins its half of the
// output rows, (E[p] + W_M^-p * O[p]) * xo[p] / n, and writes the real part
// to column j and the imaginary part to column j + h: four adjacent columns
// a thread (16-byte stores) where H is a power of two, one column a thread
// at the other heights, where the four-column join left the passes too few
// registers (7 of the 45 bodies spilled so) but at H = 864, where the
// one-column store spilled and the four-column one did not. Forming Z in
// place in a pass of its own before the first read, the other design
// tried, spilled at nine heights and was slower. The tables are B2's
// (pair_tables), the chirps the inverse ones.

#include "stockham_pair.cuh"


namespace {

constexpr int kThreads = 512;

// The M/2 of the bodies: FOURIER_B2_ROWS of stockham_pair.cuh
// (irfft_odd_unpack_geometry in ops/cuda/stockham_vpu.py;
// tests/test_torch_pair_kernels.py holds the lists equal).
#define FOURIER_B5B_ROWS(X)                                                   \
  X(32) X(36) X(40) X(48) X(60) X(64) X(72) X(80) X(96) X(100) X(108) X(120)  \
  X(128) X(144) X(160) X(180) X(192) X(200) X(216) X(240) X(256) X(288)       \
  X(300) X(320) X(324) X(360) X(384) X(400) X(432) X(480) X(500) X(540)       \
  X(576) X(600) X(640) X(648) X(720) X(768) X(800) X(864) X(900) X(960)       \
  X(972) X(1000) X(1024)

// B5b's input and output for bluestein_pair: the planar (L, B) one-sided
// spectrum (xre, xim), B = `batch`, read as Z of the `half` = ceil(B/2)
// column pairs the clusters walk, and the real (n, B) plane `y`, times
// `scale`; `vec`: 16-byte copies and stores.
struct OddUnpackPlanes {
  const float* xre;
  const float* xim;
  float* y;
  int batch;
  int half;
  float scale;
  int vec;

  __device__ __forceinline__ int columns() const { return half; }

  // Bins [0, L) of pairs b0..: columns j on rank 0, j + half on rank 1
  // (zeros past B), both planes; the DC bin's imaginary row is written as
  // zeros, so that the first read needs no test. The loops are not
  // unrolled, as B5a's.
  template <class Tile, int Threads>
  __device__ __forceinline__ void fetch(int b0, int n, float* sre,
                                        float* sim) const {
    constexpr int cols = Tile::kCols, logc = Tile::kLogC;
    const size_t bs = static_cast<size_t>(batch);
    const int nbins = (n + 1) / 2;
    const int shift = cluster_rank() == 0 ? 0 : half;
    if (vec) {
      constexpr int lc = logc - 2;  // a row is 1 << lc 16-byte chunks
      const int total = (2 * nbins) << lc;
#pragma unroll 1
      for (int e = thread_x(); e < total; e += Threads) {
        const int c = (e & ((1 << lc) - 1)) << 2, rr = e >> lc;
        if (b0 + c < half) {
          const int k = rr >> 1;
          float* dst = (rr & 1 ? sim : sre) + Tile::index(k, c);
          if (rr == 1) {
            *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          } else {
            copy_async<16>(dst, (rr & 1 ? xim : xre) + k * bs + b0 + c + shift);
          }
        }
      }
    } else {
      const int total = (2 * nbins) << logc;
#pragma unroll 1
      for (int e = thread_x(); e < total; e += Threads) {
        const int col = e & (cols - 1), rr = e >> logc;
        const int j = b0 + col;
        if (j < half) {
          const int k = rr >> 1, src = j + shift;
          float* dst = (rr & 1 ? sim : sre) + Tile::index(k, col);
          if (src < batch && rr != 1) {
            copy_async<4>(dst, (rr & 1 ? xim : xre) + k * bs + src);
          } else {
            *dst = 0.0f;  // the DC bin's imaginary part, or past B
          }
        }
      }
    }
  }

  // Z at input row `row` < n of column pair `col`: bin k = row (row < L)
  // or n - row of X1 (rank 0) and X2 (rank 1); X1 + i*X2 at the head,
  // conj X1 + i*conj X2 at the tail.
  template <class Tile>
  __device__ __forceinline__ void input(int row, int col, const float* sre,
                                        const float* sim, int n, float& re,
                                        float& im) const {
    const bool head = row < (n + 1) / 2;
    const unsigned e = 4u * Tile::index(head ? row : n - row, col);
    const float ar = load_cluster<float>(cluster_addr(sre, 0) + e);
    const float br = load_cluster<float>(cluster_addr(sre, 1) + e);
    const float ai = load_cluster<float>(cluster_addr(sim, 0) + e);
    const float bi = load_cluster<float>(cluster_addr(sim, 1) + e);
    re = head ? ar - bi : ar + bi;
    im = head ? ai + br : br - ai;
  }

  // This block's output rows [r0, r1) (pair_input_rows) of pairs b0..:
  // Z[p] = (E[p] + W_M^-p * O[p]) * xo[p] * scale from both ranks' tiles
  // (pair_join), its real part to column j, its imaginary part to column
  // j + half (masked past B); four columns a thread where `wide` (see the
  // top of this file), one elsewhere.
  template <class Tile, int Threads>
  __device__ __forceinline__ void store(int b0, int n, float* sre, float* sim,
                                        const ChirpZ<float>& t) const {
    constexpr int logc = Tile::kLogC;
    constexpr int H = Tile::kRows;
    constexpr bool wide = (H & (H - 1)) == 0 || H == 864;
    const unsigned er = cluster_addr(sre, 0), ei = cluster_addr(sim, 0);
    const unsigned o_r = cluster_addr(sre, 1), o_i = cluster_addr(sim, 1);
    const size_t bs = static_cast<size_t>(batch);
    int r0, r1;
    pair_input_rows(n, r0, r1);
    const bool v4 = wide && vec;
    const int lc = v4 ? logc - 2 : logc;
    const int width = v4 ? 4 : 1;
    const int total = (r1 - r0) << lc;
    for (int e = thread_x(); e < total; e += Threads) {
      const int c = (e & ((1 << lc) - 1)) * width, p = r0 + (e >> lc);
      const int j = b0 + c;
      if (j >= half) continue;
      float vr[4] = {}, vi[4] = {};
      pair_join(er, ei, o_r, o_i, 4u * Tile::index(p, c), width,
                __ldg(t.ivre + p), __ldg(t.ivim + p), __ldg(t.xore + p) * scale,
                __ldg(t.xoim + p) * scale, vr, vi);
      const size_t g = static_cast<size_t>(p) * bs + j;
      if (v4) {
        store16(y + g, vr);
        store16(y + g + half, vi);
      } else {
        y[g] = vr[0];
        if (j + half < batch) y[g + half] = vi[0];
      }
    }
  }
};

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
irfft_odd_unpack_pair_c64(const float* __restrict__ xre,
                          const float* __restrict__ xim, float* __restrict__ y,
                          int n, int batch, int half, ChirpZ<float> t,
                          float scale, int vec) {
  bluestein_pair<float, kThreads, H>(
      OddUnpackPlanes{xre, xim, y, batch, half, scale, vec}, n, t);
}

}  // namespace

extern "C" {

// Odd-n irfft (B5b), paired-block body: the planar (L, B) one-sided
// spectrum (B = `batch`, L = (n+1)/2) into the real (n, B) output `y`
// through an M = `m`-point inner transform, for the M/2 of
// FOURIER_B5B_ROWS, with tiles of m/2 rows and `cols` column pairs a block
// and `threads` = 512 threads. `radices` (host memory, `npasses` entries)
// must be the compiled body's schedule of m/2; `fw*`/`iv*` hold the m/2
// split twiddles W_M^(-+p), then the concatenated pass tables; `xt*` (n),
// `wt*` (m), `xo*` (n): the inverse chirp tables, 1/M folded into xo;
// `scale` multiplies the output chirp (1/n for the irfft). Returns a
// cudaError_t code, 0 on success.
int fourier_irfft_odd_unpack_pair_c64(const float* xre, const float* xim,
                                      float* y, int n, int m, int batch,
                                      int cols, int threads, int npasses,
                                      const int* radices, const float* fwre,
                                      const float* fwim, const float* ivre,
                                      const float* ivim, const float* xtre,
                                      const float* xtim, const float* wtre,
                                      const float* wtim, const float* xore,
                                      const float* xoim, float scale,
                                      int device, void* stream) {
  const int h = m / 2;
  if (n < 3 || n % 2 != 1 || m % 2 != 0 || 2 * n - 1 > m || batch <= 0 ||
      !pair_geometry_matches<float, kThreads>(h, cols, threads, npasses,
                                              radices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kern)(const float*, const float*, float*, int, int, int,
               ChirpZ<float>, float, int) = nullptr;
  switch (h) {
#define FOURIER_B5B_CASE(R)              \
  case R:                                \
    kern = irfft_odd_unpack_pair_c64<R>; \
    break;
    FOURIER_B5B_ROWS(FOURIER_B5B_CASE)
#undef FOURIER_B5B_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 4 * sizeof(float) * static_cast<size_t>(h) * cols;
  const int vec = batch % 8 == 0 && aligned16(xre) && aligned16(xim) &&
                  aligned16(y);
  const int half = (batch + 1) / 2;
  const ChirpZ<float> t{fwre, fwim, ivre, ivim, xtre, xtim,
                        wtre, wtim, xore, xoim};
  return launch_clusters<2>(kern, (half + cols - 1) / cols, threads, smem,
                            device, stream, xre, xim, y, n, batch, half, t,
                            scale, vec);
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
