// Kernels B9a and B9b, tensor-core bodies: the DFT as dense complex
// products, planar complex64, batch-major (B, n), for NVIDIA Hopper
// (sm_90a), in a library of their own. Each host function checks its
// arguments, launches on the caller's stream, neither allocates nor
// synchronises, and returns cudaGetLastError().
//
// Kernel B9a: one dense DFT product, n <= 128.
//
// Replaces fourier_tpu/ops/pallas/bailey.py:_single_phase_kernel (:81),
// launched by mxu_fft_single (:128), the TPU's matrix-unit kernel:
// O[t, k] = sum_j D[k, j] x[t, j] for the B rows t of the planar (B, n)
// input, D the plan's (n, n) table with the direction and the mode scale
// folded in: the complex product O = X * D^T, M = B, N = K = n.
//
// What bounds it on this card: the bytes, 16*n*B (0.039 ms at 125 x 65536
// at 3.35 TB/s), and the tensor cores' operations, 3 TF32 products per
// f32 product, 3*8*n*n*B flops (0.050 ms there at 495 TFLOP/s dense): the
// larger, the operations. On an H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 5f) it took 0.27 ms there, 0.18 of that bound, against 1.45 ms for
// B9a's CUDA-core body, since removed, in the same run (torch.fft 0.097
// ms); its worst
// rel-L2 over phase 3f's shapes was 1.6e-7 against np.fft.
//
// Design: 3xTF32 on mma.sync (dft_mma.cuh; the counterpart of the JAX
// kernel's Precision.HIGHEST on the matrix unit, never one TF32 product: it
// keeps about three digits). A persistent grid (the SMs times the blocks
// that fit on one); each block stages D once in shared memory as two f32
// planes, N and K zero-padded to np8 = ceil(n / 8) * 8 (rows at stride
// np8 + 4, 135 KiB at n = 128), and splits each fragment into hi and lo as
// it loads it (four planes of hi and lo D do not fit beside a tile there).
// A tile of R = 16*WM rows (R*n contiguous floats in each plane of the
// batch-major input) comes in by cp.async, a warp a row, 16-byte copies
// where 4 | n and the pointers are aligned, element by element elsewhere,
// into one of two buffers while the other tile's products run; its rows
// sit at stride np8 + 4, which keeps the fragment loads off shared bank
// conflicts, and its columns n..np8-1 stay zero (the results written back
// over a tile leave zeros there, so a NaN or an infinity in one row reaches
// no other row). Eight warps: WN along the n-tiles of the
// output (1, 2 or 4, so that a warp holds at most four), WM = 8/WN along
// its 16-row m-tiles. When every warp is done with a tile, the results go
// back over it and leave by coalesced stores.
//
// Kernel B9b: the fused two-phase DFT, n = n1*n2 with n1, n2 <= 128.
//
// Replaces fourier_tpu/ops/pallas/bailey.py:_two_phase_kernel (:92),
// launched by mxu_fft_two_phase (:163). Per transform, with M =
// x.reshape(n2, n1): phase A G = D_n2 M, the twiddle G' = G * T (T of
// shape (n2, n1)), phase B O[k1, k2] = sum_a D_n1[k1, a] G'[k2, a], stored
// at k1*n2 + k2 (natural order). The CUDA-core body of bailey.cu stays
// beside it for the small transforms below B9B_FMA_WORK (ops/cuda/bailey.py
// two_phase_body).
//
// What bounds it on this card: the tensor cores' operations, 3 TF32
// products per f32 product, 3 * (8*n*(n1+n2) + 14*n) flops a transform
// (0.42 ms at 4096 x 16384, 0.21 ms at 16384 x 1024, at 495 TFLOP/s dense),
// against 16*n bytes (0.32 and 0.08 ms at 3.35 TB/s). In one run of
// chip_smoke.py on an H100 80GB HBM3 at 700 W (phase 5f) it took 2.2013 ms
// and 1.5834 ms there, 0.19 and 0.13 of that bound, against 7.5456 and
// 3.7279 ms for the CUDA-core body (torch.fft 0.7232 and 0.2136 ms); its
// worst rel-L2 over phase 3f's shapes was 3.5e-7 against the plain version.
//
// Design: both phases through B9a's warp product (warp_cmma_3xtf32, the
// same 3xTF32 sums), which reads both operands with K contiguous, so phase
// A computes G^T = M^T * D_n2^T (M lands transposed in shared memory, a
// 4-byte cp.async an element, rows a at a stride of 4 mod 8 words) and
// phase B O = D_n1 * G'^T with G' as rows k2 contiguous in a: O comes out
// in natural order. N and K are zero-padded to multiples of 8 and the rows
// of phase A (a) and phase B (k1) to 16-row m-tiles. The epilogue of phase
// A multiplies the fragments by T (read through the read-only path) and
// writes G' into S, a region of its own, with zeros where a >= n1 or k2 >=
// n2; M^T's padding is zeroed once and never written, so a NaN or an
// infinity reaches no other transform. Phase B's fragments go straight to
// global memory (8-byte stores where n2 is even). S holds a chunk of the
// rows k2 of G': phase A and phase B run per chunk, so a warp's results never
// wait in registers for the others. A persistent grid (the SMs times the
// blocks that fit on one) of eight warps, each taking warp jobs (one
// m-tile times up to four n-tiles) in turn, one transform at a time.
// two_phase_geometry picks the layout: up to (64, 64) D_n2 and D_n1 sit
// in shared memory and two buffers let the next transform arrive by
// cp.async while this one's products run; at (128, 128) one transform's
// M^T alone takes 132 KiB, so the tables are read from global memory as
// the caller gives them (the products' reads past n1 or n2 guarded, a
// second instantiation of the kernel) and the next transform arrives once
// phase A of the last chunk is done.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"
#include "dft_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 128;
constexpr int kMaxTiles = 4;  // n-tiles a warp holds
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's dynamic maximum

// The tile of size n: np8 columns, a row stride of np8 + 4 floats, WN warps
// along the n-tiles and R = 16 * (8 / WN) rows.
struct MmaGeometry {
  int np8, ld, wn, rows;
};

__host__ __device__ inline MmaGeometry mma_geometry(int n) {
  const int np8 = (n + 7) / 8 * 8, ntiles = np8 / 8;
  const int wn = ntiles <= kMaxTiles ? 1 : ntiles <= 2 * kMaxTiles ? 2 : 4;
  return {np8, np8 + 4, wn, 16 * (kWarps / wn)};
}

inline size_t smem_of(const MmaGeometry& geo) {
  return sizeof(float) * static_cast<size_t>(geo.ld) * (2 * geo.np8 + 4 * geo.rows);
}

// B9a on the tensor cores: tiles of `valid` (<= R) rows, block b taking
// tiles b, b + gridDim.x, ...; `vec`: 16-byte copies.
__global__ void __launch_bounds__(kThreads)
dft_single_mma_c64(const float* __restrict__ xre, const float* __restrict__ xim,
                   float* __restrict__ yre, float* __restrict__ yim,
                   const float* __restrict__ dre, const float* __restrict__ dim,
                   int n, int batch, int valid, int vec) {
  extern __shared__ __align__(16) float smem[];
  const MmaGeometry geo = mma_geometry(n);
  const int ld = geo.ld, plane = geo.rows * ld;
  float* sdr = smem;  // D, (np8, ld), zero-padded
  float* sdi = sdr + geo.np8 * ld;
  float* tiles = sdi + geo.np8 * ld;  // two buffers of two (R, ld) planes
  for (int e = threadIdx.x; e < ld * (2 * geo.np8 + 4 * geo.rows); e += kThreads) {
    smem[e] = 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int k = e / n, j = e - k * n;
    sdr[k * ld + j] = dre[e];
    sdi[k * ld + j] = dim[e];
  }
  const int ntiles = (batch + valid - 1) / valid;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Rows [t*valid, t*valid + rows) of both planes into buffer `b`, a warp
  // a row at a time (no division by n).
  auto fetch = [&](int t, int b) {
    float* sre = tiles + 2 * b * plane;
    float* sim = sre + plane;
    const size_t base = static_cast<size_t>(t) * valid * n;
    const int rows = min(valid, batch - t * valid);
    for (int r = warp; r < rows; r += kWarps) {
      const size_t g = base + static_cast<size_t>(r) * n;
      if (vec) {
        for (int j = 4 * lane; j < n; j += 128) {
          copy_async<16>(sre + r * ld + j, xre + g + j);
          copy_async<16>(sim + r * ld + j, xim + g + j);
        }
      } else {
        for (int j = lane; j < n; j += 32) {
          copy_async<4>(sre + r * ld + j, xre + g + j);
          copy_async<4>(sim + r * ld + j, xim + g + j);
        }
      }
    }
  };
  const int wm = warp / geo.wn, wn = warp - wm * geo.wn;
  // The warp's n-tiles: wn, wn + WN, ... below np8 / 8.
  const int my_tiles = (geo.np8 / 8 - wn + geo.wn - 1) / geo.wn;
  int b = 0;
  if (static_cast<int>(blockIdx.x) < ntiles) fetch(blockIdx.x, 0);
  copy_commit();
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, b ^= 1) {
    if (t + static_cast<int>(gridDim.x) < ntiles) fetch(t + gridDim.x, b ^ 1);
    copy_commit();
    copy_wait_previous();
    __syncthreads();  // tile t, and D, are in shared memory
    float* sre = tiles + 2 * b * plane;
    float* sim = sre + plane;
    WarpCTile<kMaxTiles> acc;
    warp_cmma_3xtf32<kMaxTiles>(sre + 16 * wm * ld, sim + 16 * wm * ld, ld,
                                sdr + 8 * wn * ld, sdi + 8 * wn * ld, ld,
                                8 * geo.wn, my_tiles, geo.np8, lane, acc);
    __syncthreads();  // every warp has read the tile: the results go over it
    const int g = lane >> 2, c = lane & 3;
    // Columns n..np8-1 get zeros, not their products (0 * x, NaN where a
    // row holds a NaN or an infinity): the copies never write them, and a
    // later tile in this buffer must find them zero.
    const auto keep = [n](int col, float v) { return col < n ? v : 0.f; };
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) {
      if (j >= my_tiles) break;
      const int col = 8 * (wn + geo.wn * j) + 2 * c;
      const int r0 = (16 * wm + g) * ld + col, r1 = r0 + 8 * ld;
      *reinterpret_cast<float2*>(sre + r0) =
          make_float2(keep(col, acc.re[j][0]), keep(col + 1, acc.re[j][1]));
      *reinterpret_cast<float2*>(sre + r1) =
          make_float2(keep(col, acc.re[j][2]), keep(col + 1, acc.re[j][3]));
      *reinterpret_cast<float2*>(sim + r0) =
          make_float2(keep(col, acc.im[j][0]), keep(col + 1, acc.im[j][1]));
      *reinterpret_cast<float2*>(sim + r1) =
          make_float2(keep(col, acc.im[j][2]), keep(col + 1, acc.im[j][3]));
    }
    __syncthreads();
    const size_t base = static_cast<size_t>(t) * valid * n;
    const int rows = min(valid, batch - t * valid);
    for (int r = warp; r < rows; r += kWarps) {
      const size_t g = base + static_cast<size_t>(r) * n;
      for (int k = lane; k < n; k += 32) {
        yre[g + k] = sre[r * ld + k];
        yim[g + k] = sim[r * ld + k];
      }
    }
    __syncthreads();  // the next copy into this buffer follows the stores
  }
}

// B9b's layout at split (n1, n2): n1p = ceil(n1 / 8) * 8, arows = ceil(n1 /
// 16) * 16 (phase A's rows a and phase B's rows k1, in 16-row m-tiles), k2p =
// ceil(n2 / 8) * 8. A transform's buffer holds M^T, rows a at stride ldm =
// k2p + 4; S holds `chunk` rows k2 of G' at stride ldg = n1p + 4; D_n2 (k2p
// rows) and D_n1 (arows rows) sit in shared memory at strides ld2 = k2p + 4
// and ld1 = n1p + 4 where `staged`, else they are read from global memory
// as they are, at strides n2 and n1, reads past them guarded (zeros). The
// first layout in the
// order (staged, two buffers, whole S), (staged, two, S of 64 rows),
// (global, two, whole), (global, two, 64), (global, one, whole), (global,
// one, 64) that fits in kMaxSmem.
struct TwoPhaseGeometry {
  int n1p, arows, k2p, ldm, ldg, ld1, ld2, staged, buffers, chunk;
};

__host__ __device__ inline int two_phase_floats(const TwoPhaseGeometry& g) {
  return (g.staged ? 2 * (g.k2p * g.ld2 + g.arows * g.ld1) : 0) +
         2 * g.buffers * g.arows * g.ldm + 2 * g.chunk * g.ldg;
}

__host__ __device__ inline TwoPhaseGeometry two_phase_geometry(int n1, int n2) {
  TwoPhaseGeometry g;
  g.n1p = (n1 + 7) / 8 * 8;
  g.arows = (n1 + 15) / 16 * 16;
  g.k2p = (n2 + 7) / 8 * 8;
  g.ldm = g.k2p + 4;
  g.ldg = g.n1p + 4;
  for (int option = 0; option < 6; ++option) {
    g.staged = option < 2;
    g.buffers = option < 4 ? 2 : 1;
    g.chunk = option % 2 && g.k2p > 64 ? 64 : g.k2p;
    g.ld2 = g.staged ? g.k2p + 4 : n2;
    g.ld1 = g.staged ? g.n1p + 4 : n1;
    if (sizeof(float) * static_cast<size_t>(two_phase_floats(g)) <= kMaxSmem) break;
  }
  return g;
}

// B9b on the tensor cores: transform t of `batch`, block b taking t = b, b +
// gridDim.x, ...; `vec`: 8-byte stores (n2 even, outputs aligned). `Staged`
// is the geometry's `staged`: without it the products guard their reads of
// D_n2 and D_n1 in global memory.
template <bool Staged>
__global__ void __launch_bounds__(kThreads)
dft_two_phase_mma_c64(const float* __restrict__ xre, const float* __restrict__ xim,
                      float* __restrict__ yre, float* __restrict__ yim,
                      const float* __restrict__ d2re, const float* __restrict__ d2im,
                      const float* __restrict__ twre, const float* __restrict__ twim,
                      const float* __restrict__ d1re, const float* __restrict__ d1im,
                      int n1, int n2, int batch, int vec) {
  extern __shared__ __align__(16) float smem[];
  const TwoPhaseGeometry geo = two_phase_geometry(n1, n2);
  const int n = n1 * n2, plane = geo.arows * geo.ldm;
  const int t2 = Staged ? geo.k2p * geo.ld2 : 0;
  const int t1 = Staged ? geo.arows * geo.ld1 : 0;
  float* s2r = smem;  // D_n2, (k2p, ld2), where staged
  float* s2i = s2r + t2;
  float* s1r = s2i + t2;  // D_n1, (arows, ld1), where staged
  float* s1i = s1r + t1;
  float* bufs = s1i + t1;  // `buffers` buffers of two (arows, ldm) planes: M^T
  float* sgr = bufs + 2 * geo.buffers * plane;  // G', (chunk, ldg)
  float* sgi = sgr + geo.chunk * geo.ldg;
  // Zeros once: the padding of M^T (columns n2..k2p-1) and of the tables is
  // read by the products, and the copies never write it.
  for (int e = threadIdx.x; e < two_phase_floats(geo); e += kThreads) smem[e] = 0.f;
  __syncthreads();
  const float *a2r = d2re, *a2i = d2im, *a1r = d1re, *a1i = d1im;
  if (Staged) {
    for (int e = threadIdx.x; e < n2 * n2; e += kThreads) {
      const int k = e / n2, j = e - k * n2;
      s2r[k * geo.ld2 + j] = d2re[e];
      s2i[k * geo.ld2 + j] = d2im[e];
    }
    for (int e = threadIdx.x; e < n1 * n1; e += kThreads) {
      const int k = e / n1, j = e - k * n1;
      s1r[k * geo.ld1 + j] = d1re[e];
      s1i[k * geo.ld1 + j] = d1im[e];
    }
    a2r = s2r;
    a2i = s2i;
    a1r = s1r;
    a1i = s1i;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  // Transform t into buffer `b`, transposed: x[b2 * n1 + a] to M^T[a][b2].
  auto fetch = [&](int t, int b) {
    float* mr = bufs + 2 * b * plane;
    float* mi = mr + plane;
    const size_t base = static_cast<size_t>(t) * n;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int row = e / n1, a = e - row * n1;
      copy_async<4>(mr + a * geo.ldm + row, xre + base + e);
      copy_async<4>(mi + a * geo.ldm + row, xim + base + e);
    }
  };
  const int mtiles = geo.arows / 16;
  int b = 0;
  if (static_cast<int>(blockIdx.x) < batch) fetch(blockIdx.x, 0);
  copy_commit();
  for (int t = blockIdx.x; t < batch; t += gridDim.x) {
    const bool more = t + static_cast<int>(gridDim.x) < batch;
    if (geo.buffers == 2 && more) fetch(t + gridDim.x, b ^ 1);
    copy_commit();
    copy_wait_previous();
    __syncthreads();  // transform t, and the tables, are in shared memory
    const float* mr = bufs + 2 * b * plane;
    const float* mi = mr + plane;
    const size_t base = static_cast<size_t>(t) * n;
    for (int c0 = 0; c0 < geo.k2p; c0 += geo.chunk) {
      // The chunk's columns k2 in n-tiles of 8, groups of up to four a warp.
      const int ntiles = min(geo.chunk, geo.k2p - c0) / 8;
      const int groups = (ntiles + 3) / 4, jobs = mtiles * groups;
      // Phase A: G^T = M^T * D_n2^T, rows a and columns k2 of the chunk;
      // G' = G * T into S, zeros where a >= n1 or k2 >= n2.
      for (int job = warp; job < jobs; job += kWarps) {
        const int m = job / groups, q = job - m * groups;
        const int tiles = min(kMaxTiles, ntiles - kMaxTiles * q);
        WarpCTile<kMaxTiles> acc;
        warp_cmma_3xtf32<kMaxTiles, !Staged>(
            mr + 16 * m * geo.ldm, mi + 16 * m * geo.ldm, geo.ldm,
            a2r + (c0 + 32 * q) * geo.ld2, a2i + (c0 + 32 * q) * geo.ld2, geo.ld2, 8,
            tiles, geo.k2p, lane, acc, 16, n2 - c0 - 32 * q, n2);
#pragma unroll
        for (int j = 0; j < kMaxTiles; ++j) {
          if (j >= tiles) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int a = 16 * m + g + 8 * (e >> 1);
            const int row = 32 * q + 8 * j + 2 * c + (e & 1), k2 = c0 + row;
            if (a >= geo.n1p) continue;
            float gr = 0.f, gi = 0.f;
            if (a < n1 && k2 < n2) {
              const float wr = __ldg(twre + k2 * n1 + a);
              const float wi = __ldg(twim + k2 * n1 + a);
              gr = fmaf(acc.re[j][e], wr, -(acc.im[j][e] * wi));
              gi = fmaf(acc.re[j][e], wi, acc.im[j][e] * wr);
            }
            sgr[row * geo.ldg + a] = gr;
            sgi[row * geo.ldg + a] = gi;
          }
        }
      }
      __syncthreads();  // S holds the chunk's G'
      if (geo.buffers == 1 && more && c0 + geo.chunk >= geo.k2p) {
        fetch(t + gridDim.x, 0);  // M^T is read: the next transform comes in
        copy_commit();
      }
      // Phase B: O = D_n1 * G'^T, rows k1 and the chunk's columns k2, stored
      // at k1 * n2 + k2.
      for (int job = warp; job < jobs; job += kWarps) {
        const int m = job / groups, q = job - m * groups;
        const int tiles = min(kMaxTiles, ntiles - kMaxTiles * q);
        WarpCTile<kMaxTiles> acc;
        warp_cmma_3xtf32<kMaxTiles, !Staged>(
            a1r + 16 * m * geo.ld1, a1i + 16 * m * geo.ld1, geo.ld1,
            sgr + 32 * q * geo.ldg, sgi + 32 * q * geo.ldg, geo.ldg, 8, tiles, geo.n1p,
            lane, acc, n1 - 16 * m, geo.chunk, n1);
#pragma unroll
        for (int j = 0; j < kMaxTiles; ++j) {
          if (j >= tiles) break;
          const int k2 = c0 + 32 * q + 8 * j + 2 * c;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k1 = 16 * m + g + 8 * h;
            if (k1 >= n1 || k2 >= n2) continue;
            const size_t o = base + static_cast<size_t>(k1) * n2 + k2;
            if (vec) {
              *reinterpret_cast<float2*>(yre + o) =
                  make_float2(acc.re[j][2 * h], acc.re[j][2 * h + 1]);
              *reinterpret_cast<float2*>(yim + o) =
                  make_float2(acc.im[j][2 * h], acc.im[j][2 * h + 1]);
            } else {
              yre[o] = acc.re[j][2 * h];
              yim[o] = acc.im[j][2 * h];
              if (k2 + 1 < n2) {
                yre[o + 1] = acc.re[j][2 * h + 1];
                yim[o + 1] = acc.im[j][2 * h + 1];
              }
            }
          }
        }
      }
      __syncthreads();  // S is read: the next chunk may write it
    }
    if (geo.buffers == 2) b ^= 1;
  }
}

}  // namespace

extern "C" {

// B9a on the tensor cores: O[t, k] = sum_j D[k, j] x[t, j] for the B =
// `batch` rows of the planar f32 (B, n) input, 1 <= n <= 128, into the
// planar f32 (B, n) output. `dre`/`dim`: the (n, n) planar table,
// direction and scale folded in; `rows`: the rows a tile takes, at most
// the tile's R = 16 * (8 / WN) (mma_geometry). Returns a cudaError_t code,
// 0 on success.
int fourier_dft_single_mma_c64(const float* xre, const float* xim, float* yre,
                               float* yim, const float* dre, const float* dim,
                               int n, int batch, int rows, int device,
                               void* stream) {
  if (n < 1 || n > kMaxN || batch < 1 || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MmaGeometry geo = mma_geometry(n);
  const size_t smem = smem_of(geo);
  if (rows > geo.rows || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dft_single_mma_c64,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dft_single_mma_c64,
                                                    kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  const int vec = n % 4 == 0 && aligned(xre) && aligned(xim);
  const int tiles = (batch + rows - 1) / rows;
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  dft_single_mma_c64<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, dre, dim, n, batch, rows, vec);
  return static_cast<int>(cudaGetLastError());
}

// B9b on the tensor cores: the two-phase DFT of the B = `batch` rows of the
// planar f32 (B, n) input, n = n1 * n2 (1 <= n1, n2 <= 128), into the planar
// f32 (B, n) output in natural order. Tables, planar f32 and row-major,
// direction and scale folded in: D_n2 (n2, n2), the split twiddle T (n2,
// n1) and D_n1 (n1, n1). Returns a cudaError_t code, 0 on success.
int fourier_dft_two_phase_mma_c64(const float* xre, const float* xim, float* yre,
                                  float* yim, const float* d2re, const float* d2im,
                                  const float* twre, const float* twim,
                                  const float* d1re, const float* d1im, int n1,
                                  int n2, int batch, int device, void* stream) {
  if (n1 < 1 || n2 < 1 || n1 > kMaxN || n2 > kMaxN || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TwoPhaseGeometry geo = two_phase_geometry(n1, n2);
  const size_t smem = sizeof(float) * static_cast<size_t>(two_phase_floats(geo));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = geo.staged ? dft_two_phase_mma_c64<true> : dft_two_phase_mma_c64<false>;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 7u) == 0;
  };
  const int vec = n2 % 2 == 0 && aligned(yre) && aligned(yim);
  const int grid = batch < sms * per_sm ? batch : sms * per_sm;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, d2re, d2im, twre, twim, d1re, d1im, n1, n2, batch, vec);
  return static_cast<int>(cudaGetLastError());
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
