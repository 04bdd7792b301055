// Kernel B9a, tensor-core body: one dense DFT product, planar complex64,
// batch-major (B, n), n <= 128, for NVIDIA Hopper (sm_90a), in a library of
// its own. The host function checks its arguments, launches on the
// caller's stream, neither allocates nor synchronises, and returns
// cudaGetLastError().
//
// Replaces fourier_tpu/ops/pallas/bailey.py:_single_phase_kernel (:81),
// launched by mxu_fft_single (:128), the TPU's matrix-unit kernel:
// O[t, k] = sum_j D[k, j] x[t, j] for the B rows t of the planar (B, n)
// input, D the plan's (n, n) table with the direction and the mode scale
// folded in: the complex product O = X * D^T, M = B, N = K = n. The
// CUDA-core body of bailey.cu (dft_single_c64) stays beside it for
// same-run comparisons (mxu_fft_single's `_body`).
//
// What bounds it on this card: the bytes, 16*n*B (0.039 ms at 125 x 65536
// at 3.35 TB/s), and the tensor cores' operations, 3 TF32 products per
// f32 product, 3*8*n*n*B flops (0.050 ms there at 495 TFLOP/s dense): the
// larger, the operations. On an H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 5f) it took 0.27 ms there, 0.18 of that bound, against 1.45 ms for
// the CUDA-core body in the same run (torch.fft 0.097 ms); its worst
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

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
