// Kernel B4b, paired-block body: the even-n irfft unpack, batch-minor, for
// NVIDIA Hopper (sm_90a), in a library of its own. The host function checks
// its arguments, launches on the caller's stream, neither allocates nor
// synchronises, and returns cudaGetLastError().
//
// Replaces fourier_tpu/ops/pallas/stockham_vpu.py:_irfft_unpack_kernel
// (:574), launched by vpu_irfft_unpack_batch_minor (:699), for the even
// m = n/2 up to 2048 of B1's domain whose m/2 is in FOURIER_B4B_ROWS below:
// B4a's 46 sizes but m = 1728, where this body spilled in every arrangement
// tried. The stage body of stockham_vpu.cu (rfft_even_c64<false>) stays the
// kernel there, for odd m (243, 625, 729, 2187, 3125), above m = 2048 and at
// the m of B4B_STAGE_FASTER, where it won a same-run A/B
// (irfft_unpack_geometry in ops/cuda/stockham_vpu.py). As there, from the
// (m+1, B) one-sided spectrum X, with h = 0.5/m and W = exp(-2*pi*i/n),
//   Z[k] = E[k] + i*conj(W^k)*O[k],  E[k] = h*(X[k] + conj X[m-k]),
//                                    O[k] = h*(X[k] - conj X[m-k])
// (k < m, imaginary parts of X[0] and X[m] read as 0), z = IDFT_m(Z)
// unscaled (1/n is in h), and y[2j] + i*y[2j+1] = z[j].
//
// What bounds it on this card: memory, as B4a's. One call reads the planar
// (m+1, B) spectrum and writes the real (2m, B) plane, 8*n*B bytes (0.16 ms
// at 4096 x 16384 at 3.35 TB/s), against 5*m*log2(m) flops a column.
// There, on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 5d), it took
// 0.59 ms, 0.27 of that bound, against 0.76 ms for the stage body in the
// same run.
//
// Design: B4a's paired-block body run backwards, at float, 512 threads a
// block, the passes of h = m/2 fixed at compile time for each size. Rank r
// of a cluster copies spectrum rows [r*H, (r+1)*H) of both planes into its
// rows 0..H-1 (X[0]'s imaginary row written as zeros). Z[p] needs X[p] and
// X[m-p], Z[p+H] needs X[p+H] and X[H-p], so for split row p the rows
// {p, H-p} of rank 0 and {p, H-p} of rank 1 (X[H+p] and X[m-p]) form a
// closed group: the first inverse pass's read (the cross-block radix-2
// split, u = Z[p] + Z[p+H] on rank 0, v = (Z[p] - Z[p+H]) * W_m^-p on rank
// 1) reads those four X of its row through distributed shared memory and
// forms both Z there, with w[p] and w[p+H] = -i*w[p]: the unpack costs no
// pass and no barrier of its own. A separate in-place unpack pass before
// a plain split, one thread a group, was the other design tried: it spilled
// at ten heights and was slower at m = 2048 in a same-run comparison on an
// H100. The group's head, p = 0, also needs X[m], which no
// rank holds; it is read with __ldg from global memory there, one row of the
// (m+1, B) input that no other read touches, rather than given an extra tile
// row (which would change every body's tile, swizzle and shared memory for
// one row in m). After the inverse passes (unscaled) rank r's row j holds
// z[2j + r], stored to real rows 4j + 2r and 4j + 2r + 1 in 16-byte runs
// where B is a multiple of 4 and the pointers are aligned. The split
// twiddles W_m^-p and the pass tables are one f32 table (pair_tables(m,
// False) in ops/cuda/stockham_vpu.py); w is the plan's (2, m) table,
// conjugated here.

#include "stockham_pair.cuh"

namespace {

constexpr int kThreads = 512;

// The m/2 of the bodies: FOURIER_PAIR_ROWS of stockham_pair.cuh, B4a's, but
// 864 (irfft_unpack_geometry in ops/cuda/stockham_vpu.py;
// tests/test_torch_pair_kernels.py holds the lists equal).
#define FOURIER_B4B_ROWS(X)                                                   \
  X(32) X(36) X(40) X(48) X(60) X(64) X(72) X(80) X(96) X(100) X(108) X(120)  \
  X(128) X(144) X(160) X(180) X(192) X(200) X(216) X(240) X(256) X(288)       \
  X(300) X(320) X(324) X(360) X(384) X(400) X(432) X(480) X(500) X(512)       \
  X(540) X(576) X(600) X(640) X(648) X(720) X(768) X(800) X(900) X(960)       \
  X(972) X(1000) X(1024)

// Z[k] = E[k] + i*conj(w)*O[k] from X[k] = (xr, xi) and X[m-k] = (mr, mi).
__device__ __forceinline__ void unpack_point(float xr, float xi, float mr,
                                             float mi, float wr, float wi,
                                             float h, float& zr, float& zi) {
  const float er = h * (xr + mr), ei = h * (xi - mi);
  const float wor = h * (xr - mr), woi = h * (xi + mi);
  const float o_r = wr * wor + wi * woi, o_i = wr * woi - wi * wor;
  zr = er - o_i;
  zi = ei + o_r;
}

// The body for m = 2H. `twre`/`twim`: the H inverse split twiddles W_m^-p,
// then the inverse pass tables; `wre`/`wim`: exp(-2*pi*i*k/(2m)), k < m;
// `h` = 0.5/m; `vec`: 16-byte copies and stores.
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
irfft_unpack_pair_c64(const float* __restrict__ xre,
                      const float* __restrict__ xim, float* __restrict__ y,
                      int batch, const float* __restrict__ twre,
                      const float* __restrict__ twim,
                      const float* __restrict__ wre,
                      const float* __restrict__ wim, float h, int vec) {
  using Tile = PairTile<float, kThreads, H>;
  constexpr int m = 2 * H, cols = Tile::kCols, logc = Tile::kLogC;
  // w[p+H] = -i*w[p] saves two loads a point of the first pass, except at
  // H = 256, where that body spilled and the one that loads w[p+H] did not.
  constexpr bool kDeriveW = H != 256;
  constexpr int plane = H * cols;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const smem = reinterpret_cast<float*>(smem_raw);
  const size_t bs = static_cast<size_t>(batch);
  const int ntiles = (batch + cols - 1) >> logc;
  // Spectrum rows [rank*H, (rank+1)*H) of both planes into rows 0..H-1,
  // for the columns of tile t below B.
  auto fetch = [&](int t, float* sre, float* sim) {
    const int b0 = t << logc;
    const size_t src = static_cast<size_t>(cluster_rank()) * H * bs + b0;
    const int zero_row = cluster_rank() == 0 ? 1 : -1;  // X[0]'s imaginary row
    if (vec) {
      constexpr int lc = logc - 2;  // a row is 1 << lc 16-byte chunks
      auto chunk = [&](int e) {
        const int c = (e & ((1 << lc) - 1)) << 2, rr = e >> lc;
        if (b0 + c < batch) {
          const int row = rr >> 1;
          float* dst = (rr & 1 ? sim : sre) + Tile::index(row, c);
          if (rr == zero_row) {
            *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          } else {
            copy_async<16>(dst, (rr & 1 ? xim : xre) + src + row * bs + c);
          }
        }
      };
#pragma unroll 1
      for (int e = thread_x(); e < (2 * H) << lc; e += kThreads) chunk(e);
    } else {
      auto chunk = [&](int e) {
        const int col = e & (cols - 1), rr = e >> logc;
        if (b0 + col < batch) {
          const int row = rr >> 1;
          float* dst = (rr & 1 ? sim : sre) + Tile::index(row, col);
          if (rr == zero_row) {
            *dst = 0.0f;
          } else {
            copy_async<4>(dst, (rr & 1 ? xim : xre) + src + row * bs + col);
          }
        }
      };
#pragma unroll 1
      for (int e = thread_x(); e < (2 * H) << logc; e += kThreads) chunk(e);
    }
  };
  int buf = 0;
  int t = cluster_id();
  if (t < ntiles) fetch(t, smem, smem + plane);
  copy_commit();
  for (; t < ntiles; t += cluster_count(), buf ^= 1) {
    float* sre = smem + 2 * buf * plane;
    float* sim = sre + plane;
    if (t + cluster_count() < ntiles) {
      float* next = smem + 2 * (buf ^ 1) * plane;
      fetch(t + cluster_count(), next, next + plane);
    }
    copy_commit();
    copy_wait_previous();
    cluster.sync();  // both halves of tile t are in shared memory
    const unsigned re0 = cluster_addr(sre, 0), im0 = cluster_addr(sim, 0);
    const unsigned re1 = cluster_addr(sre, 1), im1 = cluster_addr(sim, 1);
    // Split row p: Z[p] from X[p] (rank 0, row p) and X[m-p] (rank 1, row
    // H-p; X[m] from global memory at p = 0), Z[p+H] from X[p+H] (rank 1,
    // row p) and X[H-p] (rank 0, row H-p; rank 1's row 0 at p = 0); then
    // this rank's output of the radix-2 step.
    auto split = [&](int row, int col, float& re, float& im) {
      const bool head = row == 0;
      const unsigned sp = 4u * Tile::index(row, col);
      const unsigned sq = 4u * Tile::index(head ? 0 : H - row, col);
      const float ar = load_cluster<float>(re0 + sp);
      const float br = load_cluster<float>(re1 + sp);
      const float ai = load_cluster<float>(im0 + sp);
      const float bi = load_cluster<float>(im1 + sp);
      const float dr = load_cluster<float>((head ? re1 : re0) + sq);
      const float di = load_cluster<float>((head ? im1 : im0) + sq);
      float cr, ci;
      if (head) {  // X[m], the Nyquist row; X[0] and X[m] are real
        const int b = (t << logc) + col;
        cr = b < batch ? __ldg(xre + static_cast<size_t>(m) * bs + b) : 0.0f;
        ci = 0.0f;
      } else {
        cr = load_cluster<float>(re1 + sq);
        ci = load_cluster<float>(im1 + sq);
      }
      float zr, zi, yr, yi;
      if constexpr (kDeriveW) {
        const float wr = __ldg(wre + row), wi = __ldg(wim + row);
        unpack_point(ar, ai, cr, ci, wr, wi, h, zr, zi);
        unpack_point(br, bi, dr, di, wi, -wr, h, yr, yi);  // w[p+H] = -i*w[p]
      } else {
        unpack_point(ar, ai, cr, ci, __ldg(wre + row), __ldg(wim + row), h, zr, zi);
        unpack_point(br, bi, dr, di, __ldg(wre + row + H), __ldg(wim + row + H), h,
                     yr, yi);
      }
      if (cluster_rank() == 0) {
        re = zr + yr;
        im = zi + yi;
      } else {  // (Z[p] - Z[p+H]) * W_m^-p
        re = zr - yr;
        im = zi - yi;
        cmul(re, im, __ldg(twre + row), __ldg(twim + row));
      }
    };
    auto split_done = [&] { cluster.sync(); };  // the partner read its rows
    pair_passes<0, false, Tile, kThreads, H>(sre, sim, twre, twim, split,
                                             split_done, NoHook{});
    // Row j holds z[2j + rank]: real rows 4j + 2*rank and 4j + 2*rank + 1.
    const int b0 = t << logc;
    if (vec) {
      constexpr int lc = logc - 2;
      for (int e = thread_x(); e < H << lc; e += kThreads) {
        const int c = (e & ((1 << lc) - 1)) << 2, j = e >> lc;
        if (b0 + c >= batch) continue;
        const int s = Tile::index(j, c);
        float a[4], b[4];
        load16(sre + s, a);
        load16(sim + s, b);
        const size_t g = static_cast<size_t>(4 * j + 2 * cluster_rank()) * bs + b0 + c;
        store16(y + g, a);
        store16(y + g + bs, b);
      }
    } else {
      for (int e = thread_x(); e < H << logc; e += kThreads) {
        const int col = e & (cols - 1), j = e >> logc;
        if (b0 + col >= batch) continue;
        const int s = Tile::index(j, col);
        const size_t g = static_cast<size_t>(4 * j + 2 * cluster_rank()) * bs + b0 + col;
        y[g] = sre[s];
        y[g + bs] = sim[s];
      }
    }
    __syncthreads();  // the next copy into this buffer follows the stores
  }
  cluster.sync();  // the partner may still read this block's tile
}

}  // namespace

extern "C" {

// Even-n irfft (B4b), paired-block body: the planar (m+1, B) one-sided
// spectrum (B = `batch`) into the real (2m, B) output `y`, for the m of
// FOURIER_B4B_ROWS (times 2). `cols`, `threads` and the `npasses`
// `radices` (host memory) must be the compiled body's tile and schedule of
// m/2; `twre`/`twim` hold the m/2 inverse split twiddles W_m^-p, then the
// concatenated inverse pass tables; `wre`/`wim` the m entries of
// exp(-2*pi*i*k/(2m)) (conjugated here); `h` = 0.5/m. Returns a cudaError_t
// code, 0 on success.
int fourier_irfft_unpack_pair_c64(const float* xre, const float* xim, float* y,
                                  int m, int batch, int cols, int threads,
                                  int npasses, const int* radices,
                                  const float* twre, const float* twim,
                                  const float* wre, const float* wim, float h,
                                  int device, void* stream) {
  const int half = m / 2;
  if (batch <= 0 || m % 2 != 0 ||
      !pair_geometry_matches<float, kThreads>(half, cols, threads, npasses,
                                              radices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kern)(const float*, const float*, float*, int, const float*,
               const float*, const float*, const float*, float, int) = nullptr;
  switch (half) {
#define FOURIER_B4B_CASE(R)          \
  case R:                            \
    kern = irfft_unpack_pair_c64<R>; \
    break;
    FOURIER_B4B_ROWS(FOURIER_B4B_CASE)
#undef FOURIER_B4B_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 4 * sizeof(float) * static_cast<size_t>(half) * cols;
  const int vec = batch % 4 == 0 && aligned16(xre) && aligned16(xim) &&
                  aligned16(y);
  return launch_clusters<2>(kern, (batch + cols - 1) / cols, threads, smem,
                            device, stream, xre, xim, y, batch, twre, twim,
                            wre, wim, h, vec);
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
