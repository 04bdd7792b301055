// Kernel B3, clustered-block body: the row leg of the single-chip four-step
// FFT over complex64 planar, batch-minor planes, for NVIDIA Hopper
// (sm_90a), in a library of its own. The host function checks its
// arguments, launches on the caller's stream, neither allocates nor
// synchronises, and returns cudaGetLastError().
//
// Replaces fourier_tpu/ops/pallas/stockham_vpu.py:_four_step_row_kernel
// (:778), launched by vpu_fft_four_step_row (:805), for the p of B1's 60
// clustered bodies (FOURIER_PAIR_ROWS and FOURIER_B1_QUAD_ROWS in
// stockham_pair.cuh): a transform of n = p*q (plan/four_step_local.py) runs
// q-point column transforms over the (q, p*B) view of its (n, B) input, and
// this body takes their result as the planar (q, p, B) planes, element
// (k2, a, b) at (k2*p + a)*B + b. For every k2 and column b it
//   1. multiplies row a by the split twiddle W_n^(a*k2) (a plan-time (q, p)
//      table, row k2);
//   2. runs the p-point DFT;
//   3. stores X[k1] at k1*(q*B) + k2*B + b, times the mode scale,
// so that the (p*q, B) output is in natural order. The stage body of
// stockham_vpu.cu (four_step_row_c64) stays the kernel for p above 4096,
// 3000, 3240 and the pure powers of 3 and 5, which have no clustered body,
// at p = 960, 1280, 2560 and 3840, where both designs below spilled, and at
// the p of B3_STAGE_FASTER, where it won a same-run A/B
// (four_step_pair_geometry in ops/cuda/stockham_vpu.py).
//
// What bounds it on this card: memory. One call reads and writes the two
// planes once, 16*p*q*B bytes (0.32 ms at 65536 x 1024 at 3.35 TB/s),
// against 5*p*log2(p) + 6*p flops a row. The stage body moved those bytes
// at 0.30 of that bound (1.08 ms), with a radix switch at run time, one
// tile a block and no copy in flight during the stages. On an H100 80GB
// HBM3 at 700 W this body took 0.65 ms there, 0.49 of the bound (0.72-0.75
// ms with a split that read each point from its block's buffer across the
// cluster, in the same run; the stage body 1.08 ms in chip_smoke.py phases
// 5c and 5g).
//
// Design: fft_pair of the clustered-block engine (stockham_pair.cuh, B1's
// body) with the I/O policy FourStepPlanes: 512 threads a block, the
// passes of h = p/C fixed at compile time for each p, persistent clusters
// fed by cp.async into two buffers. A tile is (k2, g): the g-th group of
// kCols columns of the (p, B) plane of k2, t = k2*G + g with G = ceil(B /
// kCols), so the clusters walk q*G tiles. Rank r copies the rows s*h + j
// of that plane, j in its share [r*h/C, (r+1)*h/C) of each block s (the
// engine's push split; runs of the tile's width, 16-byte copies where 4 |
// B, the pointers are aligned and the runs are wider than 32 bytes); the
// split reads block s's row j times the four-step twiddle W_n^((s*h +
// j)*k2), formed as W_n^(j*k2) * W_n^(s*h*k2), one table entry a point and
// one a tile (design (a)), forms the C outputs of the engine's radix-C
// step and stores output s to rank s's buffer (16-byte DSMEM stores,
// (C-1)/C of the tile across the cluster); after the passes rank r holds
// X[C*k + r] at row k and stores it to output row (C*k + r) of the (p,
// q*B) view, at column k2*B + b0, times the scale: runs of the tile's width
// at stride q*B. Columns past B are never stored. At 7 of the 11 heights
// where (a) spilled with a split that read each point from its block's
// buffer across the cluster, design (b) multiplies each copied row by the twiddle of
// its input row in a pass of its own before the split (at the other 4 it
// spilled too); it moves
// the same bytes with one more pass over shared memory, and was 15% slower
// than (a) at p = 128, 256 and 512 in a build of both designs there.
//
// One body serves both directions: the inverse is the forward body on the
// planes exchanged, IDFT(x) = swap(DFT(swap(x))), swap exchanging re and
// im. The inverse's twiddle W_n^(-a*k2) = conj(w) then goes in as the
// forward one, since swap(x * conj(w)) = swap(x) * w: the body reads only
// the forward (q, p) table, for both directions, and the forward tables of
// pair_tables(p).

#include <utility>

#include "stockham_pair.cuh"

namespace {

constexpr int kThreads = 512;

// B3's input and output: the planar (q, P, B) planes of the column leg,
// walked as q*G tiles of (k2, g), and the planar (P, q*B) output. Both
// designs of the four-step twiddle: in the split read (kInPass false: each
// of the C rows the split combines is multiplied by its twiddle as it is
// read) or in a pass of its own (kInPass true: after its copies land and
// before the split, each rank multiplies its own h rows in place).
template <int C, int H, bool kInPass>
struct FourStepPlanes {
  using Tile = PairTile<float, kThreads, H>;
  static constexpr int P = C * H;
  static constexpr int kV = 4;  // floats a 16-byte chunk
  static constexpr int kLogV = 2;
  const float* xre;
  const float* xim;
  float* yre;
  float* yim;
  const float* twre;  // the forward (q, P) four-step twiddle, row k2
  const float* twim;
  int batch;
  size_t bs;  // the row stride B, widened once
  int q;
  float scale;
  int vec;

  __device__ __forceinline__ FourStepPlanes(const float* xre_, const float* xim_,
                                            float* yre_, float* yim_,
                                            const float* twre_, const float* twim_,
                                            int batch_, int q_, float scale_, int vec_)
      : xre(xre_), xim(xim_), yre(yre_), yim(yim_), twre(twre_), twim(twim_),
        batch(batch_), bs(static_cast<size_t>(batch_)), q(q_), scale(scale_),
        vec(vec_) {}

  // G = ceil(B / kCols), the tiles of one k2, computed where it is used
  // rather than kept live across the passes.
  __device__ __forceinline__ int groups() const {
    return (batch + Tile::kCols - 1) >> Tile::kLogC;
  }

  template <class>
  __device__ __forceinline__ int tiles() const {
    return q * groups();
  }

  // Row push_row(row) of the (P, B) plane of k2 = t / G, columns b0 = (t
  // mod G) * kCols.. below B, into row `row` (0..H-1).
  template <class, int Threads, int, int>
  __device__ __forceinline__ void fetch(int t, float* sre, float* sim) const {
    constexpr int cols = Tile::kCols, logc = Tile::kLogC;
    const int k2 = t / groups();
    const int b0 = (t - k2 * groups()) << logc;
    const size_t src = static_cast<size_t>(k2) * P * bs + b0;
    const int rank = cluster_rank();
    if (vec) {
      constexpr int lc = logc - kLogV;  // a row is 1 << lc 16-byte chunks
#pragma unroll 1
      for (int e = thread_x(); e < (2 * H) << lc; e += Threads) {
        const int c = (e & ((1 << lc) - 1)) << kLogV, rr = e >> lc;
        if (b0 + c < batch) {
          const int row = rr >> 1;
          copy_async<16>((rr & 1 ? sim : sre) + Tile::index(row, c),
                         (rr & 1 ? xim : xre) + src + push_row<C, H>(row, rank) * bs + c);
        }
      }
    } else {
#pragma unroll 1
      for (int e = thread_x(); e < (2 * H) << logc; e += Threads) {
        const int col = e & (cols - 1), rr = e >> logc;
        if (b0 + col < batch) {
          const int row = rr >> 1;
          copy_async<4>((rr & 1 ? sim : sre) + Tile::index(row, col),
                        (rr & 1 ? xim : xre) + src + push_row<C, H>(row, rank) * bs + col);
        }
      }
    }
  }

  // Design (b): once the block's copies of tile t have landed, each of
  // this rank's rows times the twiddle of its input row a = push_row(row),
  // in place (one table load a point).
  template <class, int Threads, int, int>
  __device__ __forceinline__ void prepare(int t, float* sre, float* sim) const {
    if constexpr (kInPass) {
      constexpr int logc = Tile::kLogC;
      __syncthreads();  // every thread's copies of tile t have landed
      const int w0 = (t / groups()) * P;
      const int rank = cluster_rank();
      for (int e = thread_x(); e < H << logc; e += Threads) {
        const int row = e >> logc;
        const int s = Tile::index(row, e & (Tile::kCols - 1));
        const int w = w0 + push_row<C, H>(row, rank);
        float re = sre[s], im = sim[s];
        cmul(re, im, __ldg(twre + w), __ldg(twim + w));
        sre[s] = re;
        sim[s] = im;
      }
    }
  }

  // Design (a): block s's row `row` (the split's p) of tile t times
  // W_n^((s*H + row)*k2) as the split reads it, formed as W_n^(row*k2) *
  // W_n^(s*H*k2): one table entry a point, the same for the C rows the
  // split combines, and one a tile and block (s*H + row and s*H are both in
  // row k2 of the table).
  template <int>
  __device__ __forceinline__ void weight(int t, int s, int row, float& re,
                                         float& im) const {
    if constexpr (!kInPass) {
      const int w = (t / groups()) * P;
      float wr = __ldg(twre + w + row), wi = __ldg(twim + w + row);
      if (s > 0) cmul(wr, wi, __ldg(twre + w + s * H), __ldg(twim + w + s * H));
      cmul(re, im, wr, wi);
    }
  }

  // Row k of this rank's finished tile t holds X[C*k + rank]: row C*k +
  // rank of the (P, q*B) output at column k2*B + b0.., times the scale.
  template <class, int Threads, int, int>
  __device__ __forceinline__ void store(int t, const float* sre,
                                        const float* sim) const {
    constexpr int cols = Tile::kCols, logc = Tile::kLogC;
    const int k2 = t / groups();
    const int b0 = (t - k2 * groups()) << logc;
    const size_t out0 = static_cast<size_t>(k2) * bs + b0;
    const size_t stride = static_cast<size_t>(q) * bs;  // one output row
    if (vec) {
      constexpr int lc = logc - kLogV;
      for (int e = thread_x(); e < H << lc; e += Threads) {
        const int c = (e & ((1 << lc) - 1)) << kLogV, k = e >> lc;
        if (b0 + c >= batch) continue;
        const int s = Tile::index(k, c);
        float a[kV], b[kV], vr[kV], vi[kV];
        load16(sre + s, a);
        load16(sim + s, b);
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          vr[u] = a[u] * scale;
          vi[u] = b[u] * scale;
        }
        const size_t g = static_cast<size_t>(C * k + cluster_rank()) * stride + out0 + c;
        store16(yre + g, vr);
        store16(yim + g, vi);
      }
    } else {
      for (int e = thread_x(); e < H << logc; e += Threads) {
        const int col = e & (cols - 1), k = e >> logc;
        if (b0 + col >= batch) continue;
        const int s = Tile::index(k, col);
        const size_t g = static_cast<size_t>(C * k + cluster_rank()) * stride + out0 + col;
        yre[g] = sre[s] * scale;
        yim[g] = sim[s] * scale;
      }
    }
  }
};

// The forward row leg for p = C*H, times `scale`. `twre`/`twim`: the
// (C-1)*H split twiddles of pair_tables(p), then the pass tables; `prre`/
// `prim`: the forward (q, p) four-step twiddle; `vec`: 16-byte copies and
// stores.
template <int C, int H, bool kInPass>
__global__ void __launch_bounds__(kThreads, 1)
four_step_pair_c64(const float* __restrict__ xre, const float* __restrict__ xim,
                   float* __restrict__ yre, float* __restrict__ yim, int q,
                   int batch, const float* __restrict__ twre,
                   const float* __restrict__ twim, const float* __restrict__ prre,
                   const float* __restrict__ prim, float scale, int vec) {
  fft_pair<float, kThreads, C, H>(
      FourStepPlanes<C, H, kInPass>{xre, xim, yre, yim, prre, prim, batch, q,
                                    scale, vec},
      twre, twim);
}

using Body = void (*)(const float*, const float*, float*, float*, int, int,
                      const float*, const float*, const float*, const float*,
                      float, int);

// The (C, h) of the bodies of each design. Design (a) is built at every
// (C, h) of B1's clustered bodies at which it compiled with no spill (at
// 512 threads ptxas spilled it at 11 of the 60, all among the tightest
// heights); design (b) only at the 7 of those 11 where it compiles clean.
// The design is thus a function of the height. ops/cuda/stockham_vpu.py
// holds these lists as B3_SPLIT_ROWS and B3_PASS_ROWS.
#define FOURIER_B3_SPLIT_ROWS(X) \
  X(2, 36) X(2, 40) X(2, 48) X(2, 64) X(2, 72) X(2, 80) X(2, 96) X(2, 100) \
  X(2, 108) X(2, 128) X(2, 144) X(2, 160) X(2, 180) X(2, 192) X(2, 200) \
  X(2, 216) X(2, 240) X(2, 256) X(2, 288) X(2, 300) X(2, 320) X(2, 324) \
  X(2, 360) X(2, 384) X(2, 400) X(2, 432) X(2, 500) X(2, 512) X(2, 540) \
  X(2, 576) X(2, 600) X(2, 648) X(2, 768) X(2, 800) X(2, 864) X(2, 900) \
  X(2, 960) X(2, 972) X(2, 1000) X(2, 1024) X(4, 540) X(4, 576) X(4, 600) \
  X(4, 648) X(4, 720) X(4, 768) X(4, 800) X(4, 864) X(4, 1024)
#define FOURIER_B3_PASS_ROWS(X) \
  X(2, 32) X(2, 60) X(2, 120) X(2, 720) X(4, 900) X(4, 972) X(4, 1000)

// The compiled body of a C-block cluster with h rows a block (the one
// design built at that height), or nullptr.
Body body_of(int ranks, int h) {
  switch (ranks * 8192 + h) {
#define FOURIER_B3_SPLIT_CASE(C, R) \
  case C * 8192 + R:                \
    return four_step_pair_c64<C, R, false>;
#define FOURIER_B3_PASS_CASE(C, R) \
  case C * 8192 + R:               \
    return four_step_pair_c64<C, R, true>;
    FOURIER_B3_SPLIT_ROWS(FOURIER_B3_SPLIT_CASE)
    FOURIER_B3_PASS_ROWS(FOURIER_B3_PASS_CASE)
#undef FOURIER_B3_SPLIT_CASE
#undef FOURIER_B3_PASS_CASE
    default:
      return nullptr;
  }
}

size_t smem_of(int h, int cols) {
  return 4 * sizeof(float) * static_cast<size_t>(h) * cols;
}

}  // namespace

extern "C" {

// B3, clustered-block body: the planar (q, p, B) input (B = `batch`) into
// the planar (p, q*B) output, on clusters of `ranks` (2 or 4) blocks of
// p/ranks rows, the four-step twiddle in the split read (the (ranks,
// p/ranks) of FOURIER_B3_SPLIT_ROWS) or in a pass of its own (those of
// FOURIER_B3_PASS_ROWS). `cols`, `threads` and the `npasses` `radices`
// (host memory) must be the compiled body's tile and schedule of p/ranks;
// `twre`/`twim` hold pair_tables(p)'s forward split twiddles and pass
// tables, and `prre`/`prim` the forward (q, p) four-step twiddle, row k2 =
// W_n^(a*k2), for both directions. Returns a cudaError_t code, 0 on
// success.
int fourier_four_step_pair_c64(const float* xre, const float* xim, float* yre,
                               float* yim, int p, int q, int batch, int ranks,
                               int cols, int threads, int npasses,
                               const int* radices, const float* twre,
                               const float* twim, const float* prre,
                               const float* prim, int forward, float scale,
                               int device, void* stream) {
  if (batch <= 0 || q <= 0 || ranks <= 0 || p % ranks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int h = p / ranks;
  const Body kern = body_of(ranks, h);
  if (kern == nullptr ||
      !pair_geometry_matches<float, kThreads>(h, cols, threads, npasses,
                                              radices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ntiles = static_cast<long long>(q) * ((batch + cols - 1) / cols);
  if (ntiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies and stores only where a tile's runs are wider than 32
  // bytes: at 32-byte runs (cols = 8, 34 of the 56 p) the body took
  // 1.3-1.7x its time with 4-byte ones at the same B (chip_smoke.py phase
  // 5g on an H100 80GB HBM3 at 700 W); wider runs gain from them.
  const int vec = cols > 8 && batch % 4 == 0 && aligned16(xre) && aligned16(xim) &&
                  aligned16(yre) && aligned16(yim);
  const size_t smem = smem_of(h, cols);
  if (!forward) {  // IDFT(x) = swap(DFT(swap(x))), swap exchanging re and im
    std::swap(xre, xim);
    std::swap(yre, yim);
  }
  const int tiles = static_cast<int>(ntiles);
  if (ranks == 2) {
    return launch_clusters<2>(kern, tiles, threads, smem, device, stream, xre,
                              xim, yre, yim, q, batch, twre, twim, prre, prim,
                              scale, vec);
  }
  return launch_clusters<4>(kern, tiles, threads, smem, device, stream, xre,
                            xim, yre, yim, q, batch, twre, twim, prre, prim,
                            scale, vec);
}

// The clusters of `ranks` blocks that B3's clustered body for p keeps on
// the card at once, into `clusters`. Returns a cudaError_t code, 0 on
// success.
int fourier_four_step_pair_clusters(int p, int ranks, int cols, int device,
                                    int* clusters) {
  if (ranks <= 0 || p % ranks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int h = p / ranks;
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
