// Kernel B5a, paired-block body: the odd-n rfft by the two-for-one trick,
// batch-minor, for NVIDIA Hopper (sm_90a), in a library of its own. The
// host function checks its arguments, launches on the caller's stream,
// neither allocates nor synchronises, and returns cudaGetLastError().
//
// Replaces fourier_tpu/ops/pallas/stockham_vpu.py:_rfft_odd_pack_kernel
// (:1029), launched by vpu_rfft_odd_pack_batch_minor (:1099), for the inner
// sizes M <= 2048 whose M/2 is in FOURIER_B5A_ROWS below: B2's sizes but M
// = 480, where this body spilled in every arrangement of its store that was
// tried (and not M = 1024, where B2's body and this one spill). The stage
// body of stockham_vpu.cu (rfft_odd_pack_c64) stays the kernel there, above
// M = 2048 (n >= 1025) and at the M of B5A_STAGE_FASTER, where it won a
// same-run A/B (rfft_odd_pack_geometry in ops/cuda/stockham_vpu.py). As
// there, column j of the real (n, B) input pairs with column j + h, h =
// ceil(B/2): one M-point chirp-z transforms z = x_j + i*x_{j+h} into Z, and
// the separation of bins k < L = (n+1)/2,
//   X1[k] = (Z[k] + conj Z[(n-k) mod n]) / 2       -> column j,
//   X2[k] = -i*(Z[k] - conj Z[(n-k) mod n]) / 2    -> column j + h,
// gives the one-sided spectra of both columns. An unpaired last column (odd
// B) runs against zeros.
//
// What bounds it on this card: at n = 1013, B = 65536 the bytes (the real
// plane in, the planar (L, B) spectrum out: 8*n*B bytes, 0.16 ms at 3.35
// TB/s) against one M = 2048 chirp-z for two columns (half of B2's flops
// a column, 8.4 GFLOP with the separation, 0.13 ms at 67 TFLOP/s f32):
// bytes, with the operations close behind.
//
// Design: bluestein_pair of stockham_pair.cuh (B2's body) at float, 512
// threads a block, with this file's policy OddPackPlanes for its input and
// output. The clusters walk the h column pairs, not the B columns. A rank
// copies its half of the input rows of columns j into the re plane of its
// tile and of columns j + h into the im plane (16-byte copies where B is a
// multiple of 8 and the pointers are aligned, so that j and j + h both lie
// on 16-byte boundaries in every row; element by element elsewhere); where
// j + h >= B the im plane is written as zeros, never left uncopied (it
// would hold the previous tile's rows). The passes are B2's: the input
// chirp on the first forward read, wt on the last forward store, the
// inverse passes. The store takes two steps: each rank joins Z[p] = (E[p] +
// W_M^-p * O[p]) * xo[p] for its half of the rows p < n from both ranks'
// tiles (rank 0 holds E, rank 1 O) and writes it over its own row p; after
// a cluster barrier the ranks split the bins k < L, read Z[k] (rank 0) and
// Z[(n-k) mod n] (rank 1) through distributed shared memory, separate them
// and store X1 to column j and X2 to column j + h (16-byte stores where the
// copies were 16-byte). The tables are B2's (pair_tables, forward chirps).

#include "stockham_pair.cuh"

namespace {

constexpr int kThreads = 512;

// The M/2 of the bodies: FOURIER_B2_ROWS of stockham_pair.cuh but 240
// (rfft_odd_pack_geometry in ops/cuda/stockham_vpu.py;
// tests/test_torch_pair_kernels.py holds the lists equal).
#define FOURIER_B5A_ROWS(X)                                                   \
  X(32) X(36) X(40) X(48) X(60) X(64) X(72) X(80) X(96) X(100) X(108) X(120)  \
  X(128) X(144) X(160) X(180) X(192) X(200) X(216) X(256) X(288) X(300)       \
  X(320) X(324) X(360) X(384) X(400) X(432) X(480) X(500) X(540) X(576)       \
  X(600) X(640) X(648) X(720) X(768) X(800) X(864) X(900) X(960) X(972)       \
  X(1000) X(1024)

// B5a's input and output for bluestein_pair: the real (n, B) plane `x`,
// B = `batch`, read as z = x_j + i*x_{j+half} for the `half` = ceil(B/2)
// column pairs the clusters walk, and the planar (L, B) one-sided spectrum
// (yre, yim); `vec`: 16-byte copies and stores.
struct OddPackPlanes {
  const float* x;
  float* yre;
  float* yim;
  int batch;
  int half;
  int vec;

  __device__ __forceinline__ int columns() const { return half; }

  // This rank's input rows of pairs b0..: x_j into the re plane, x_{j+half}
  // into the im plane (zeros past B). The loops are not unrolled: with them
  // unrolled, more of the mixed-radix bodies spilled.
  template <class Tile, int Threads>
  __device__ __forceinline__ void fetch(int b0, int n, float* sre,
                                        float* sim) const {
    constexpr int cols = Tile::kCols, logc = Tile::kLogC;
    const size_t bs = static_cast<size_t>(batch);
    int r0, r1;
    pair_input_rows(n, r0, r1);
    if (vec) {
      constexpr int lc = logc - 2;  // a row is 1 << lc 16-byte chunks
      const int total = (2 * (r1 - r0)) << lc;
#pragma unroll 1
      for (int e = thread_x(); e < total; e += Threads) {
        const int c = (e & ((1 << lc) - 1)) << 2, rr = e >> lc;
        if (b0 + c < half) {
          const int row = r0 + (rr >> 1);
          copy_async<16>((rr & 1 ? sim : sre) + Tile::index(row, c),
                         x + row * bs + b0 + c + (rr & 1 ? half : 0));
        }
      }
    } else {
      const int total = (2 * (r1 - r0)) << logc;
#pragma unroll 1
      for (int e = thread_x(); e < total; e += Threads) {
        const int col = e & (cols - 1), rr = e >> logc;
        const int j = b0 + col;
        if (j < half) {
          const int row = r0 + (rr >> 1), src = j + (rr & 1 ? half : 0);
          float* dst = (rr & 1 ? sim : sre) + Tile::index(row, col);
          if (src < batch) {
            copy_async<4>(dst, x + row * bs + src);
          } else {
            *dst = 0.0f;  // the unpaired last column's partner
          }
        }
      }
    }
  }

  // Input row `row` < n of column pair `col`, from the rank that copied it.
  template <class Tile>
  __device__ __forceinline__ void input(int row, int col, const float* sre,
                                        const float* sim, int n, float& re,
                                        float& im) const {
    pair_input<Tile>(row, col, sre, sim, n, re, im);
  }

  // The tile's output. Rank 0 holds E and rank 1 O of the chirp-z's
  // M-point inverse; Z[p] = (E[p] + W_M^-p * O[p]) * xo[p] (pair_join), and
  // the ranks split the bins k < L = (n+1)/2, separating Z[k] and
  // Z[(n-k) mod n] of each into X1 and X2. Where H is a power of two both Z
  // of a bin are joined at once, 16-byte runs where `vec`. Elsewhere the
  // passes leave too few registers for that (11 of the 45 bodies spilled
  // so, and 7 still with the two steps below at 16-byte runs), and the store
  // takes two steps a cluster barrier apart, one column a thread (a warp's
  // stores still fill whole 32-byte sectors): each rank writes Z[p] over
  // row p of its own tile for its input rows p (pair_input_rows: [0, L) on
  // rank 0, [L, n) on rank 1), which its partner does not read; then the
  // bins read Z[k] on rank 0 and Z[(n-k) mod n] on rank 1.
  template <class Tile, int Threads>
  __device__ __forceinline__ void store(int b0, int n, float* sre, float* sim,
                                        const ChirpZ<float>& t) const {
    if constexpr ((Tile::kRows & (Tile::kRows - 1)) == 0) {
      join_and_separate<Tile, Threads>(b0, n, sre, sim, t);
    } else {
      join_then_separate<Tile, Threads>(b0, n, sre, sim, t);
    }
  }

  // The bins [k0, k1) of this rank: rank 0 [0, ceil(L/2)), rank 1 the rest.
  static __device__ __forceinline__ void own_bins(int n, int& k0, int& k1) {
    const int nbins = (n + 1) / 2, k_half = (nbins + 1) / 2;
    const bool first = cluster_rank() == 0;
    k0 = first ? 0 : k_half;
    k1 = first ? k_half : nbins;
  }

  // X1 = (Z[k] + conj S) / 2 to column j, X2 = -i*(Z[k] - conj S) / 2 to
  // column j + half (masked past B) for `width` adjacent j from b0 + c on,
  // S = Z[(n-k) mod n].
  __device__ __forceinline__ void separate(int k, int b0, int c, int width,
                                           const float (&zr)[4], const float (&zi)[4],
                                           const float (&sr)[4],
                                           const float (&si)[4]) const {
    float ar[4], ai[4], br[4], bi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ar[u] = 0.5f * (zr[u] + sr[u]);
      ai[u] = 0.5f * (zi[u] - si[u]);
      br[u] = 0.5f * (zi[u] + si[u]);
      bi[u] = -0.5f * (zr[u] - sr[u]);
    }
    const size_t g = static_cast<size_t>(k) * static_cast<size_t>(batch) + b0 + c;
    if (width == 4) {
      store16(yre + g, ar);
      store16(yim + g, ai);
      store16(yre + g + half, br);
      store16(yim + g + half, bi);
    } else {
      yre[g] = ar[0];
      yim[g] = ai[0];
      if (b0 + c + half < batch) {
        yre[g + half] = br[0];
        yim[g + half] = bi[0];
      }
    }
  }

  template <class Tile, int Threads>
  __device__ __forceinline__ void join_and_separate(int b0, int n, const float* sre,
                                                    const float* sim,
                                                    const ChirpZ<float>& t) const {
    constexpr int logc = Tile::kLogC;
    const unsigned er = cluster_addr(sre, 0), ei = cluster_addr(sim, 0);
    const unsigned o_r = cluster_addr(sre, 1), o_i = cluster_addr(sim, 1);
    int k0, k1;
    own_bins(n, k0, k1);
    const int lc = vec ? logc - 2 : logc;
    const int width = vec ? 4 : 1;
    const int total = (k1 - k0) << lc;
    for (int e = thread_x(); e < total; e += Threads) {
      const int c = (e & ((1 << lc) - 1)) * width, k = k0 + (e >> lc);
      if (b0 + c >= half) continue;
      const int kr = k == 0 ? 0 : n - k;  // (n-k) mod n
      float zr[4] = {}, zi[4] = {}, sr[4] = {}, si[4] = {};
      pair_join(er, ei, o_r, o_i, 4u * Tile::index(k, c), width,
                __ldg(t.ivre + k), __ldg(t.ivim + k), __ldg(t.xore + k),
                __ldg(t.xoim + k), zr, zi);
      pair_join(er, ei, o_r, o_i, 4u * Tile::index(kr, c), width,
                __ldg(t.ivre + kr), __ldg(t.ivim + kr), __ldg(t.xore + kr),
                __ldg(t.xoim + kr), sr, si);
      separate(k, b0, c, width, zr, zi, sr, si);
    }
  }

  template <class Tile, int Threads>
  __device__ __forceinline__ void join_then_separate(int b0, int n, float* sre,
                                                     float* sim,
                                                     const ChirpZ<float>& t) const {
    constexpr int logc = Tile::kLogC, cols = Tile::kCols;
    {
      const unsigned er = cluster_addr(sre, 0), ei = cluster_addr(sim, 0);
      const unsigned o_r = cluster_addr(sre, 1), o_i = cluster_addr(sim, 1);
      int r0, r1;
      pair_input_rows(n, r0, r1);
      const int total = (r1 - r0) << logc;
      for (int e = thread_x(); e < total; e += Threads) {
        const int c = e & (cols - 1), p = r0 + (e >> logc);
        if (b0 + c >= half) continue;
        const int s = Tile::index(p, c);
        float vr[1], vi[1];
        pair_join(er, ei, o_r, o_i, 4u * s, 1, __ldg(t.ivre + p), __ldg(t.ivim + p),
                  __ldg(t.xore + p), __ldg(t.xoim + p), vr, vi);
        sre[s] = vr[0];
        sim[s] = vi[0];
      }
    }
    cg::this_cluster().sync();  // Z is complete on both ranks
    const unsigned zr0 = cluster_addr(sre, 0), zi0 = cluster_addr(sim, 0);
    const unsigned zr1 = cluster_addr(sre, 1), zi1 = cluster_addr(sim, 1);
    int k0, k1;
    own_bins(n, k0, k1);
    const int total = (k1 - k0) << logc;
    for (int e = thread_x(); e < total; e += Threads) {
      const int c = e & (cols - 1), k = k0 + (e >> logc);
      if (b0 + c >= half) continue;
      const int kr = k == 0 ? 0 : n - k;  // (n-k) mod n
      const unsigned sk = 4u * Tile::index(k, c), skr = 4u * Tile::index(kr, c);
      const float zr = load_cluster<float>(zr0 + sk), zi = load_cluster<float>(zi0 + sk);
      const float sr = load_cluster<float>((k == 0 ? zr0 : zr1) + skr);
      const float si = load_cluster<float>((k == 0 ? zi0 : zi1) + skr);
      const int j = b0 + c;
      const size_t g = static_cast<size_t>(k) * static_cast<size_t>(batch) + j;
      yre[g] = 0.5f * (zr + sr);
      yim[g] = 0.5f * (zi - si);
      if (j + half < batch) {
        yre[g + half] = 0.5f * (zi + si);
        yim[g + half] = -0.5f * (zr - sr);
      }
    }
  }
};

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
rfft_odd_pack_pair_c64(const float* __restrict__ x, float* __restrict__ yre,
                       float* __restrict__ yim, int n, int batch, int half,
                       ChirpZ<float> t, int vec) {
  bluestein_pair<float, kThreads, H>(OddPackPlanes{x, yre, yim, batch, half, vec},
                                     n, t);
}

}  // namespace

extern "C" {

// Odd-n rfft (B5a), paired-block body: the real (n, B) input `x` (B =
// `batch`) into the planar (L, B) one-sided spectrum, L = (n+1)/2, through
// an M = `m`-point inner transform, for the M/2 of FOURIER_B5A_ROWS, with
// tiles of m/2 rows and `cols` column pairs a block and `threads` = 512
// threads. `radices` (host memory, `npasses` entries) must be the compiled
// body's schedule of m/2; `fw*`/`iv*` hold the m/2 split twiddles
// W_M^(-+p), then the concatenated pass tables; `xt*` (n), `wt*` (m), `xo*`
// (n): the forward chirp tables, 1/M folded into xo. Returns a cudaError_t
// code, 0 on success.
int fourier_rfft_odd_pack_pair_c64(const float* x, float* yre, float* yim,
                                   int n, int m, int batch, int cols,
                                   int threads, int npasses, const int* radices,
                                   const float* fwre, const float* fwim,
                                   const float* ivre, const float* ivim,
                                   const float* xtre, const float* xtim,
                                   const float* wtre, const float* wtim,
                                   const float* xore, const float* xoim,
                                   int device, void* stream) {
  const int h = m / 2;
  if (n < 3 || n % 2 != 1 || m % 2 != 0 || 2 * n - 1 > m || batch <= 0 ||
      !pair_geometry_matches<float, kThreads>(h, cols, threads, npasses,
                                              radices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kern)(const float*, float*, float*, int, int, int, ChirpZ<float>,
               int) = nullptr;
  switch (h) {
#define FOURIER_B5A_CASE(R)           \
  case R:                             \
    kern = rfft_odd_pack_pair_c64<R>; \
    break;
    FOURIER_B5A_ROWS(FOURIER_B5A_CASE)
#undef FOURIER_B5A_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 4 * sizeof(float) * static_cast<size_t>(h) * cols;
  const int vec = batch % 8 == 0 && aligned16(x) && aligned16(yre) &&
                  aligned16(yim);
  const int half = (batch + 1) / 2;
  const ChirpZ<float> t{fwre, fwim, ivre, ivim, xtre, xtim,
                        wtre, wtim, xore, xoim};
  return launch_clusters<2>(kern, (half + cols - 1) / cols, threads, smem,
                            device, stream, x, yre, yim, n, batch, half, t,
                            vec);
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
