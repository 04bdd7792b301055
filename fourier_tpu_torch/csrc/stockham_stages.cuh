// Shared stage code of the fused Stockham kernels B1, B2 and B3 (complex64
// planar, batch-minor, NVIDIA Hopper sm_90a): the radix-2/3/4/5/8
// butterflies, one in-place Stockham stage over a block's (n, cols) planes in
// shared memory, the loop over a stage schedule, and the host-side checks
// every launch makes.
//
// It is included by stockham_vpu.cu, the one translation unit of the kernel
// library; build.py keys the library by every source under csrc/, this
// header included.
//
// Layout of the planes in shared memory: element (row, col) of a block's
// (n, cols) planes is at row * cols + col, so consecutive threads touch
// consecutive columns.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxStages = 16;
constexpr int kPointsPerThread = 16;
constexpr int kMaxThreads = 1024;

struct Schedule {
  int nstages;
  int radix[kMaxStages];
  int tw_off[kMaxStages];  // start of the stage's (m, r) table, in points
};

constexpr float kC8 = static_cast<float>(0.70710678118654752440);    // cos(pi/4)
constexpr float kS3 = static_cast<float>(0.86602540378443864676);    // sin(pi/3)
constexpr float kC51 = static_cast<float>(0.30901699437494742410);   // cos(2pi/5)
constexpr float kC52 = static_cast<float>(-0.80901699437494742410);  // cos(4pi/5)
constexpr float kS51 = static_cast<float>(0.95105651629515357212);   // sin(2pi/5)
constexpr float kS52 = static_cast<float>(0.58778525229247312917);   // sin(4pi/5)

// In-place radix-4: two radix-2 layers and a -i (forward) or +i rotation.
template <bool F>
__device__ __forceinline__ void b4(float& r0, float& i0, float& r1, float& i1,
                                   float& r2, float& i2, float& r3, float& i3) {
  const float a0r = r0 + r2, a0i = i0 + i2;
  const float a1r = r0 - r2, a1i = i0 - i2;
  const float a2r = r1 + r3, a2i = i1 + i3;
  const float dr = r1 - r3, di = i1 - i3;
  r0 = a0r + a2r;
  i0 = a0i + a2i;
  r2 = a0r - a2r;
  i2 = a0i - a2i;
  if (F) {  // y1 = a1 - i*d, y3 = a1 + i*d
    r1 = a1r + di;
    i1 = a1i - dr;
    r3 = a1r - di;
    i3 = a1i + dr;
  } else {
    r1 = a1r - di;
    i1 = a1i + dr;
    r3 = a1r + di;
    i3 = a1i - dr;
  }
}

// In-place R-point DFT of (r[k], i[k]), natural order in and out; the
// forward direction uses W = exp(-2*pi*i/R).
template <int R, bool F>
__device__ __forceinline__ void butterfly(float (&r)[R], float (&i)[R]) {
  if constexpr (R == 2) {
    const float ar = r[0], ai = i[0];
    r[0] = ar + r[1];
    i[0] = ai + i[1];
    r[1] = ar - r[1];
    i[1] = ai - i[1];
  } else if constexpr (R == 3) {
    const float s = F ? -kS3 : kS3;
    const float ar = r[1] + r[2], ai = i[1] + i[2];
    const float br = r[1] - r[2], bi = i[1] - i[2];
    const float ur = r[0] - 0.5f * ar, ui = i[0] - 0.5f * ai;
    const float vr = -s * bi, vi = s * br;  // i*s*b
    r[0] += ar;
    i[0] += ai;
    r[1] = ur + vr;
    i[1] = ui + vi;
    r[2] = ur - vr;
    i[2] = ui - vi;
  } else if constexpr (R == 4) {
    b4<F>(r[0], i[0], r[1], i[1], r[2], i[2], r[3], i[3]);
  } else if constexpr (R == 5) {
    const float sg = F ? -1.0f : 1.0f;
    const float t1r = r[1] + r[4], t1i = i[1] + i[4];
    const float t2r = r[2] + r[3], t2i = i[2] + i[3];
    const float t3r = r[1] - r[4], t3i = i[1] - i[4];
    const float t4r = r[2] - r[3], t4i = i[2] - i[3];
    const float ar = r[0] + kC51 * t1r + kC52 * t2r;
    const float ai = i[0] + kC51 * t1i + kC52 * t2i;
    const float br = r[0] + kC52 * t1r + kC51 * t2r;
    const float bi = i[0] + kC52 * t1i + kC51 * t2i;
    const float ur = kS51 * t3r + kS52 * t4r, ui = kS51 * t3i + kS52 * t4i;
    const float vr = kS52 * t3r - kS51 * t4r, vi = kS52 * t3i - kS51 * t4i;
    r[0] += t1r + t2r;
    i[0] += t1i + t2i;
    r[1] = ar - sg * ui;
    i[1] = ai + sg * ur;
    r[2] = br - sg * vi;
    i[2] = bi + sg * vr;
    r[3] = br + sg * vi;
    i[3] = bi - sg * vr;
    r[4] = ar + sg * ui;
    i[4] = ai - sg * ur;
  } else if constexpr (R == 8) {
    // Two radix-4 over the even and odd points, then a radix-2 combine
    // with W_8^k.
    b4<F>(r[0], i[0], r[2], i[2], r[4], i[4], r[6], i[6]);
    b4<F>(r[1], i[1], r[3], i[3], r[5], i[5], r[7], i[7]);
    const float wi = F ? -kC8 : kC8;  // W_8^1 = kC8 + i*wi
    const float e[4][2] = {{r[0], i[0]}, {r[2], i[2]}, {r[4], i[4]}, {r[6], i[6]}};
    float o[4][2];
    o[0][0] = r[1];
    o[0][1] = i[1];
    o[1][0] = r[3] * kC8 - i[3] * wi;  // W_8^1
    o[1][1] = r[3] * wi + i[3] * kC8;
    o[2][0] = F ? i[5] : -i[5];  // W_8^2 = -i (forward)
    o[2][1] = F ? -r[5] : r[5];
    o[3][0] = -r[7] * kC8 - i[7] * wi;  // W_8^3 = -kC8 + i*wi
    o[3][1] = r[7] * wi - i[7] * kC8;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r[k] = e[k][0] + o[k][0];
      i[k] = e[k][1] + o[k][1];
      r[k + 4] = e[k][0] - o[k][0];
      i[k + 4] = e[k][1] - o[k][1];
    }
  }
}

// One radix-R Stockham stage over the block's (n, cols) planes in shared
// memory, in place. The input viewed as (R, m, stride) at (k, i, j) is
// butterflied along k, output k is multiplied by W_size^(i*k) unless m == 1,
// and written to the output viewed as (m, R, stride) at (i, k, j).
template <int R, bool F>
__device__ __noinline__ void stage(float* sre, float* sim, int n, int cols,
                                   int size, int stride,
                                   const float* __restrict__ twre,
                                   const float* __restrict__ twim) {
  constexpr int NB = (kPointsPerThread + R - 1) / R;  // butterflies per thread
  const int m = size / R;
  const int blk = m * stride;  // == n / R
  const int nbfly = blk * cols;
  float xr[NB][R], xi[NB][R];
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int id = threadIdx.x + q * blockDim.x;
    if (id < nbfly) {
      const int p = id / cols, col = id - p * cols;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int e = (k * blk + p) * cols + col;
        xr[q][k] = sre[e];
        xi[q][k] = sim[e];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int id = threadIdx.x + q * blockDim.x;
    if (id < nbfly) {
      const int p = id / cols, col = id - p * cols;
      const int i = p / stride, j = p - i * stride;
      butterfly<R, F>(xr[q], xi[q]);
      if (m > 1) {
#pragma unroll
        for (int k = 1; k < R; ++k) {
          const float wr = __ldg(twre + i * R + k);
          const float wi = __ldg(twim + i * R + k);
          const float a = xr[q][k], b = xi[q][k];
          xr[q][k] = a * wr - b * wi;
          xi[q][k] = a * wi + b * wr;
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int e = ((i * R + k) * stride + j) * cols + col;
        sre[e] = xr[q][k];
        sim[e] = xi[q][k];
      }
    }
  }
  __syncthreads();
}

// Every stage of `sch` over the block's (n, cols) planes, in place; the
// planes are complete in shared memory when it returns. `twre`/`twim` hold
// the concatenated per-stage tables at the offsets of `sch`.
template <bool F>
__device__ __forceinline__ void run_stages(float* sre, float* sim, int n,
                                           int cols, const Schedule& sch,
                                           const float* __restrict__ twre,
                                           const float* __restrict__ twim) {
  int size = n, stride = 1;
  for (int s = 0; s < sch.nstages; ++s) {
    const int r = sch.radix[s];
    const float* tr = twre + sch.tw_off[s];
    const float* ti = twim + sch.tw_off[s];
    switch (r) {
      case 2: stage<2, F>(sre, sim, n, cols, size, stride, tr, ti); break;
      case 3: stage<3, F>(sre, sim, n, cols, size, stride, tr, ti); break;
      case 4: stage<4, F>(sre, sim, n, cols, size, stride, tr, ti); break;
      case 5: stage<5, F>(sre, sim, n, cols, size, stride, tr, ti); break;
      case 8: stage<8, F>(sre, sim, n, cols, size, stride, tr, ti); break;
    }
    size /= r;
    stride *= r;
  }
}

// Host side. Builds the schedule of an n-point transform from `nstages`
// radices (host memory, each from {2, 3, 4, 5, 8}, multiplying to n), with
// the offsets of the concatenated tables: every stage but the last owns
// n_s / r_s * r_s = n_s points. Returns a cudaError_t code, 0 on success.
inline int make_schedule(int n, int nstages, const int* radices, Schedule* sch) {
  if (n <= 0 || nstages <= 0 || nstages > kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sch->nstages = nstages;
  int size = n, off = 0;
  for (int s = 0; s < nstages; ++s) {
    const int r = radices[s];
    if ((r != 2 && r != 3 && r != 4 && r != 5 && r != 8) || size % r != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    sch->radix[s] = r;
    sch->tw_off[s] = off;
    if (size / r > 1) off += size;
    size /= r;
  }
  return size == 1 ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// True when `threads` threads (a multiple of 32, at most kMaxThreads) cover a
// block's n * cols points at kPointsPerThread each.
inline bool block_fits(int n, int cols, int threads) {
  return cols > 0 && threads > 0 && threads <= kMaxThreads &&
         threads % 32 == 0 &&
         static_cast<long long>(threads) * kPointsPerThread >=
             static_cast<long long>(n) * cols;
}

// Select the device and let `kern` take `smem` bytes of dynamic shared
// memory (above 48 KiB only after the attribute is raised).
template <typename Kernel>
int prepare_launch(Kernel kern, size_t smem, int device) {
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
