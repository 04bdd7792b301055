// Kernel B4a, paired-block body: the even-n rfft pack, batch-minor, for
// NVIDIA Hopper (sm_90a), in a library of its own. The host function checks
// its arguments, launches on the caller's stream, neither allocates nor
// synchronises, and returns cudaGetLastError().
//
// Replaces fourier_tpu/ops/pallas/stockham_vpu.py:_rfft_pack_kernel (:529),
// launched by vpu_rfft_pack_batch_minor (:619), for every even m = n/2 up to
// 2048 of B1's domain (46 sizes, 64..2048); the stage body of
// stockham_vpu.cu (rfft_even_c64<true>) stays the kernel for odd m (243,
// 625, 729, 2187, 3125) and for m above 2048, where a tile of 32-byte runs
// would need more than 512 threads at 16 points each, which leaves a
// thread 64 registers. As there, z[j] = x[2j] + i*x[2j+1], Z = FFT_m(z),
// and X[k] = E[k] + W^k*O[k] (k < m), X[m] = E[0] - O[0], with
// E[k] = (Z[k] + conj Z[(m-k) mod m])/2, O[k] = -i*(Z[k] - conj Z[(m-k) mod
// m])/2, W = exp(-2*pi*i/n).
//
// What bounds it on this card: memory. One call reads the real (2m, B)
// plane and writes the (m+1, B) planar spectrum, 8*n*B bytes (0.16 ms at
// 4096 x 16384 at 3.35 TB/s), against 5*m*log2(m) flops a column. There,
// on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 5d), it took 0.49 ms,
// 0.33 of that bound, against 0.85 ms for the stage body in the same run.
//
// Design: the paired-block engine of stockham_pair.cuh at float, 512
// threads a block, with the passes of h = m/2 fixed at compile time for
// each of the 46 sizes. Rank r of a cluster copies rows 2(r*h + j) and
// 2(r*h + j) + 1 of x, 32-byte runs of 8 columns (more where h is small),
// into the re and im planes of its row j; the first pass reads both ranks'
// rows for the cross-block radix-2 split; after the passes rank 0 holds
// Z[2j] and rank 1 Z[2j+1] at row j, so each rank packs its own parity of k
// from its own rows, X[2j] (j <= h) from rows j and h-j, X[2j+1] from rows
// j and h-1-j, and stores 16-byte runs. The split twiddles W_m^p and the
// pass tables are one f32 table, computed in f64 on the host
// (pair_tables in ops/cuda/stockham_vpu.py); w is the plan's (2, m) table.

#include "stockham_pair.cuh"

namespace {

constexpr int kThreads = 512;

// Z[k] and Z[mirror] of one column into X[k] = E[k] + W^k*O[k] (`inner`,
// k < m) or X[m] = E[0] - O[0].
__device__ __forceinline__ void pack_point(float zr, float zi, float mr,
                                           float mi, float wr, float wi,
                                           bool inner, float& xr, float& xi) {
  const float cr = mr, ci = -mi;
  const float er = 0.5f * (zr + cr), ei = 0.5f * (zi + ci);
  const float o_r = 0.5f * (zi - ci), o_i = -0.5f * (zr - cr);
  if (inner) {
    xr = er + wr * o_r - wi * o_i;
    xi = ei + wr * o_i + wi * o_r;
  } else {
    xr = er - o_r;
    xi = ei - o_i;
  }
}

// The body for m = 2H. `twre`/`twim`: the H forward split twiddles W_m^p,
// then the pass tables; `vec`: 16-byte copies and stores.
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
rfft_pack_pair_c64(const float* __restrict__ x, float* __restrict__ yre,
                   float* __restrict__ yim, int batch,
                   const float* __restrict__ twre,
                   const float* __restrict__ twim,
                   const float* __restrict__ wre,
                   const float* __restrict__ wim, int vec) {
  using Tile = PairTile<float, kThreads, H>;
  constexpr int m = 2 * H, cols = Tile::kCols, logc = Tile::kLogC;
  constexpr int plane = H * cols;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const smem = reinterpret_cast<float*>(smem_raw);
  const size_t bs = static_cast<size_t>(batch);
  const int ntiles = (batch + cols - 1) >> logc;
  // Rows 2(rank*H + j) and 2(rank*H + j) + 1 of x into the re and im planes
  // of row j, for the columns of tile t below B.
  auto fetch = [&](int t, float* sre, float* sim) {
    const int b0 = t << logc;
    const float* src = x + 2 * static_cast<size_t>(rank) * H * bs + b0;
    if (vec) {
      constexpr int lc = logc - 2;  // a row is 1 << lc 16-byte chunks
      for (int e = thread_x(); e < (2 * H) << lc; e += kThreads) {
        const int c4 = (e & ((1 << lc) - 1)) << 2, rr = e >> lc;
        if (b0 + c4 < batch) {
          copy_async<16>((rr & 1 ? sim : sre) + Tile::index(rr >> 1, c4),
                         src + rr * bs + c4);
        }
      }
    } else {
      for (int e = thread_x(); e < (2 * H) << logc; e += kThreads) {
        const int col = e & (cols - 1), rr = e >> logc;
        if (b0 + col < batch) {
          copy_async<4>((rr & 1 ? sim : sre) + Tile::index(rr >> 1, col),
                        src + rr * bs + col);
        }
      }
    }
  };
  // Output row of local row j, and the rows of Z[k] and Z[(m-k) mod m].
  auto rows_of = [&](int j, int& k, int& zk, int& zm) {
    if (rank == 0) {
      k = 2 * j;
      zk = j == H ? 0 : j;
      zm = (j == 0 || j == H) ? 0 : H - j;
    } else {
      k = 2 * j + 1;
      zk = j;
      zm = H - 1 - j;
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
    const float* pre = cluster.map_shared_rank(sre, rank ^ 1);
    const float* pim = cluster.map_shared_rank(sim, rank ^ 1);
    auto split = [&](int row, int col, float& re, float& im) {
      const int e = Tile::index(row, col);
      const float ar = sre[e], ai = sim[e], br = pre[e], bi = pim[e];
      if (rank == 0) {
        re = ar + br;
        im = ai + bi;
      } else {  // (rank 0's rows - this block's) * W_m^row
        re = br - ar;
        im = bi - ai;
        cmul(re, im, __ldg(twre + row), __ldg(twim + row));
      }
    };
    auto split_done = [&] { cluster.sync(); };  // the partner read its rows
    pair_passes<0, true, Tile, kThreads, H>(sre, sim, twre, twim, split,
                                            split_done, NoHook{});
    const int b0 = t << logc;
    const int nrows = rank == 0 ? H + 1 : H;
    if (vec) {
      constexpr int lc = logc - 2;
      for (int e = thread_x(); e < nrows << lc; e += kThreads) {
        const int c4 = (e & ((1 << lc) - 1)) << 2, j = e >> lc;
        if (b0 + c4 >= batch) continue;
        int k, zk, zm;
        rows_of(j, k, zk, zm);
        const int ek = Tile::index(zk, c4), em = Tile::index(zm, c4);
        const float4 ar = *reinterpret_cast<const float4*>(sre + ek);
        const float4 ai = *reinterpret_cast<const float4*>(sim + ek);
        const float4 br = *reinterpret_cast<const float4*>(sre + em);
        const float4 bi = *reinterpret_cast<const float4*>(sim + em);
        const bool inner = k < m;
        const float wr = inner ? __ldg(wre + k) : 0.0f;
        const float wi = inner ? __ldg(wim + k) : 0.0f;
        float4 xr, xi;
        pack_point(ar.x, ai.x, br.x, bi.x, wr, wi, inner, xr.x, xi.x);
        pack_point(ar.y, ai.y, br.y, bi.y, wr, wi, inner, xr.y, xi.y);
        pack_point(ar.z, ai.z, br.z, bi.z, wr, wi, inner, xr.z, xi.z);
        pack_point(ar.w, ai.w, br.w, bi.w, wr, wi, inner, xr.w, xi.w);
        const size_t g = static_cast<size_t>(k) * bs + b0 + c4;
        *reinterpret_cast<float4*>(yre + g) = xr;
        *reinterpret_cast<float4*>(yim + g) = xi;
      }
    } else {
      for (int e = thread_x(); e < nrows << logc; e += kThreads) {
        const int col = e & (cols - 1), j = e >> logc;
        if (b0 + col >= batch) continue;
        int k, zk, zm;
        rows_of(j, k, zk, zm);
        const int ek = Tile::index(zk, col), em = Tile::index(zm, col);
        const bool inner = k < m;
        const float wr = inner ? __ldg(wre + k) : 0.0f;
        const float wi = inner ? __ldg(wim + k) : 0.0f;
        float xr, xi;
        pack_point(sre[ek], sim[ek], sre[em], sim[em], wr, wi, inner, xr, xi);
        const size_t g = static_cast<size_t>(k) * bs + b0 + col;
        yre[g] = xr;
        yim[g] = xi;
      }
    }
    __syncthreads();  // the next copy into this buffer follows the pack
  }
  cluster.sync();  // the partner may still read this block's tile
}

}  // namespace

extern "C" {

// Even-n rfft (B4a), paired-block body: the real (2m, B) input `x`
// (B = `batch`) into the planar (m+1, B) one-sided spectrum, for the m of
// FOURIER_PAIR_ROWS (times 2). `cols`, `threads` and the `npasses`
// `radices` (host memory) must be the compiled body's tile and schedule of
// m/2; `twre`/`twim` hold the m/2 forward split twiddles W_m^p, then the
// concatenated pass tables; `wre`/`wim` the m entries of exp(-2*pi*i*k/(2m)).
// Returns a cudaError_t code, 0 on success.
int fourier_rfft_pack_pair_c64(const float* x, float* yre, float* yim, int m,
                               int batch, int cols, int threads, int npasses,
                               const int* radices, const float* twre,
                               const float* twim, const float* wre,
                               const float* wim, int device, void* stream) {
  const int h = m / 2;
  if (batch <= 0 || m % 2 != 0 ||
      !pair_geometry_matches<float, kThreads>(h, cols, threads, npasses,
                                              radices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kern)(const float*, float*, float*, int, const float*, const float*,
               const float*, const float*, int) = nullptr;
  switch (h) {
#define FOURIER_B4A_CASE(R) \
  case R:                   \
    kern = rfft_pack_pair_c64<R>; \
    break;
    FOURIER_PAIR_ROWS(FOURIER_B4A_CASE)
#undef FOURIER_B4A_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 4 * sizeof(float) * static_cast<size_t>(h) * cols;
  const int vec = batch % 4 == 0 && aligned16(x) && aligned16(yre) &&
                  aligned16(yim);
  return launch_clusters<2>(kern, (batch + cols - 1) / cols, threads, smem,
                            device, stream, x, yre, yim, batch, twre, twim,
                            wre, wim, vec);
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
