// Kernel B9b on the CUDA cores: the DFT as dense complex products, planar
// complex64, batch-major (B, n), for NVIDIA Hopper (sm_90a), in one
// library. Its host function checks its arguments, launches on the
// caller's stream, neither allocates nor synchronises, and returns
// cudaGetLastError().
//
// This is B9b's first body. B9a and B9b run on the tensor cores in 3xTF32,
// in a library of their own (MMA_LIBRARY of ops/cuda/bailey.py); the
// wrapper launches this body for B9b's small transforms, n * (n1 + n2) <
// B9B_FMA_WORK, where the card's sweep found it faster: the tensor-core
// body leaves most of its warps idle there.
//
// Every product runs on the CUDA cores in fp32 FMA: no TF32 and no tensor
// core, so the caller's TF32 setting cannot reach them (the JAX kernels pin
// Precision.HIGHEST). Each sum over the contraction index is taken in chunks
// of kChunk terms, each chunk summed on its own and then added to the
// output's total: a plain running sum over 128 terms loses about twice as
// many bits (rel-L2 4.0e-7 against 1.7e-7 at n = 16384, from a numpy
// transliteration of this kernel with fma rounding).
//
// Kernel B9b: the fused two-phase DFT, n = n1*n2 with n1, n2 <= 128.
//
// Replaces fourier_tpu/ops/pallas/bailey.py:_two_phase_kernel (:92),
// launched by mxu_fft_two_phase (:163). Per transform, with M =
// x.reshape(n2, n1):
//   phase A  G[k2, a] = sum_b D_n2[k2, b] M[b, a]
//   twiddle  G'[k2, a] = G[k2, a] * T[k2, a]
//   phase B  O[k1, k2] = sum_a D_n1[k1, a] G'[k2, a], stored at k1*n2 + k2
// so the output is in natural order, the input read once and the output
// written once.
//
// What bounds it on the CUDA cores: operations. 8*n*(n1+n2) + 14*n flops
// per transform against 16*n bytes: 1.04 ms against 0.32 ms at n = 4096
// (64, 64), B = 16384. In one run of chip_smoke.py on an H100 80GB HBM3 at
// 700 W (phase 5f) this body took 7.5456 ms there and 3.7279 ms at 16384 x
// 1024, against 2.2013 and 1.5834 ms for the tensor-core body.
//
// Design: a block takes `tpb` whole transforms and keeps their M in dynamic
// shared memory, rows padded to an odd stride ld = n1 | 1 (132 KiB at
// n = 16384, one transform). The three tables, at most 384 KiB, are read
// through the read-only cache (__ldg) and stay in L2. Phase A: thread
// (t, a, g) owns G[k2, a] for k2 = g + GA*j, GA = ceil(n2 / 16), in
// registers; after a barrier it multiplies by T and writes G' over M. Phase
// B: thread (t, k2, g) owns O[k1, k2] for k1 = g + GB*j and stores along k2,
// coalesced. The odd stride keeps phase B's reads along k2 on distinct
// banks. At n = 16384 a block is 1024 threads with 16 outputs each, at most
// 64 registers a thread; a split that needs at most 512 threads a transform
// runs blocks of at most 512 (128 registers a thread, no spill).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxOut = 16;  // complex outputs a thread accumulates
constexpr int kChunk = 16;   // terms summed before they join the total
constexpr int kTwoPhaseMaxThreads = 1024;
// Blocks of at most this many threads take the instantiation bounded
// there, where a thread may hold 128 registers instead of 64.
constexpr int kTwoPhaseSmallThreads = 512;
constexpr int kMaxN = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's dynamic maximum

__device__ __forceinline__ void cmac(float& ar, float& ai, float dr, float di,
                                     float xr, float xi) {
  ar = fmaf(dr, xr, ar);
  ar = fmaf(-di, xi, ar);
  ai = fmaf(dr, xi, ai);
  ai = fmaf(di, xr, ai);
}

template <bool kGlobal>
__device__ __forceinline__ float table(const float* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// out_j = sum_k D[row_j, k] * x[k * xstride], row_j = first + step * j for
// j < nout, D row-major with K columns (global memory when kGlobal, else
// shared); x in shared memory. Sums run in chunks of kChunk terms.
template <bool kGlobal>
__device__ __forceinline__ void contract(const float* dr, const float* di,
                                         int K, int first, int step, int nout,
                                         const float* xr, const float* xi,
                                         int xstride, float (&tr)[kMaxOut],
                                         float (&ti)[kMaxOut]) {
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    tr[j] = 0.f;
    ti[j] = 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    float cr[kMaxOut], ci[kMaxOut];
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      cr[j] = 0.f;
      ci[j] = 0.f;
    }
    const int k1 = min(k0 + kChunk, K);
    for (int k = k0; k < k1; ++k) {
      const float x_r = xr[k * xstride];
      const float x_i = xi[k * xstride];
#pragma unroll
      for (int j = 0; j < kMaxOut; ++j) {
        if (j < nout) {
          const int e = (first + step * j) * K + k;
          cmac(cr[j], ci[j], table<kGlobal>(dr + e), table<kGlobal>(di + e),
               x_r, x_i);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      tr[j] += cr[j];
      ti[j] += ci[j];
    }
  }
}

__host__ __device__ inline int groups_of(int rows) {
  return (rows + kMaxOut - 1) / kMaxOut;
}

__device__ inline int outputs_of(int g, int groups, int rows) {
  return g < groups ? (rows - g + groups - 1) / groups : 0;
}

template <int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
dft_two_phase_c64(const float* __restrict__ xre, const float* __restrict__ xim,
                  float* __restrict__ yre, float* __restrict__ yim,
                  const float* __restrict__ d2re, const float* __restrict__ d2im,
                  const float* __restrict__ twre, const float* __restrict__ twim,
                  const float* __restrict__ d1re, const float* __restrict__ d1im,
                  int n1, int n2, int batch, int tpb) {
  extern __shared__ float smem[];
  const int n = n1 * n2;
  const int ld = n1 | 1;
  const int plane = n2 * ld;  // one transform's M, then G', row k2 at k2 * ld
  float* smr = smem;
  float* smi = smem + tpb * plane;
  const size_t t0 = static_cast<size_t>(blockIdx.x) * tpb;
  const size_t left = batch - t0;
  const int count = left < static_cast<size_t>(tpb) ? static_cast<int>(left) : tpb;
  const size_t base = t0 * n;
  for (int e = threadIdx.x; e < count * n; e += blockDim.x) {
    const int t = e / n;
    const int r = e - t * n;
    const int b = r / n1;
    const int a = r - b * n1;
    smr[t * plane + b * ld + a] = xre[base + e];
    smi[t * plane + b * ld + a] = xim[base + e];
  }
  __syncthreads();

  // Phase A: thread (t, a, g) owns G[t][k2][a], k2 = g + ga * j.
  float tr[kMaxOut], ti[kMaxOut];
  const int ga = groups_of(n2);
  const int qa = threadIdx.x % (tpb * n1);
  const int g_a = threadIdx.x / (tpb * n1);
  const int t_a = qa / n1;
  const int a = qa - t_a * n1;
  const int nout_a = t_a < count ? outputs_of(g_a, ga, n2) : 0;
  if (nout_a > 0) {
    contract<true>(d2re, d2im, n2, g_a, ga, nout_a, smr + t_a * plane + a,
                   smi + t_a * plane + a, ld, tr, ti);
  }
  __syncthreads();  // all of M has been read: G' goes over it
  if (nout_a > 0) {
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      if (j < nout_a) {
        const int k2 = g_a + ga * j;
        const float wr = __ldg(twre + k2 * n1 + a);
        const float wi = __ldg(twim + k2 * n1 + a);
        smr[t_a * plane + k2 * ld + a] = fmaf(tr[j], wr, -(ti[j] * wi));
        smi[t_a * plane + k2 * ld + a] = fmaf(tr[j], wi, ti[j] * wr);
      }
    }
  }
  __syncthreads();

  // Phase B: thread (t, k2, g) owns O[t][k1][k2], k1 = g + gb * j.
  const int gb = groups_of(n1);
  const int qb = threadIdx.x % (tpb * n2);
  const int g_b = threadIdx.x / (tpb * n2);
  const int t_b = qb / n2;
  const int k2 = qb - t_b * n2;
  const int nout_b = t_b < count ? outputs_of(g_b, gb, n1) : 0;
  if (nout_b > 0) {
    contract<true>(d1re, d1im, n1, g_b, gb, nout_b, smr + t_b * plane + k2 * ld,
                   smi + t_b * plane + k2 * ld, 1, tr, ti);
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      if (j < nout_b) {
        const size_t o = base + static_cast<size_t>(t_b) * n +
                         static_cast<size_t>(g_b + gb * j) * n2 + k2;
        yre[o] = tr[j];
        yim[o] = ti[j];
      }
    }
  }
}

template <typename Kernel>
int prepare(Kernel kern, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// B9b: the two-phase DFT of the B = `batch` rows of the planar f32 (B, n)
// input, n = n1 * n2 (1 <= n1, n2 <= 128), into the planar f32 (B, n)
// output in natural order. Tables, planar f32 and row-major: D_n2 (n2, n2),
// the split twiddle T (n2, n1) and D_n1 (n1, n1), direction and scale folded
// in. `tpb` transforms a block and `threads` threads a block, with
// tpb * n1 * ceil(n2 / 16) and tpb * n2 * ceil(n1 / 16) both <= threads <=
// 1024 and the block's 8 * tpb * n2 * (n1 | 1) bytes of shared memory within
// 227 KB. Returns a cudaError_t code, 0 on success.
int fourier_dft_two_phase_c64(const float* xre, const float* xim, float* yre,
                              float* yim, const float* d2re, const float* d2im,
                              const float* twre, const float* twim,
                              const float* d1re, const float* d1im, int n1,
                              int n2, int batch, int tpb, int threads,
                              int device, void* stream) {
  if (n1 < 1 || n2 < 1 || n1 > kMaxN || n2 > kMaxN || batch < 1 || tpb < 1 ||
      threads < 1 || threads > kTwoPhaseMaxThreads ||
      tpb * n1 * groups_of(n2) > threads || tpb * n2 * groups_of(n1) > threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(tpb) * n2 * (n1 | 1);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = threads <= kTwoPhaseSmallThreads
                  ? dft_two_phase_c64<kTwoPhaseSmallThreads>
                  : dft_two_phase_c64<kTwoPhaseMaxThreads>;
  int err = prepare(kern, smem, device);
  if (err != 0) return err;
  const int grid = (batch + tpb - 1) / tpb;
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, d2re, d2im, twre, twim, d1re, d1im, n1, n2, batch, tpb);
  return static_cast<int>(cudaGetLastError());
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
