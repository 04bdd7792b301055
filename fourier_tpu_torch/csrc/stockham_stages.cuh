// Shared stage code of the fused Stockham kernels, planar and batch-minor,
// for NVIDIA Hopper sm_90a: the radix-2/3/4/5/8 butterflies, one in-place
// Stockham stage over a block's (n, cols) planes in shared memory, the loop
// over a stage schedule, the chirp-z body of the Bluestein kernels, the
// all-stages and Bluestein kernels themselves with their host-side launchers,
// and the host-side checks every launch makes.
//
// Everything is templated on the real type T: float for the complex64
// kernels of stockham_vpu.cu (B1-B5), double for the complex128 kernels of
// stockham_vpu_dd.cu (B6-B8). The butterflies' constants are variable
// templates written from the same long decimal literals, so a double stage
// keeps every digit and a float stage gets the literal narrowed at compile
// time, as before the templating.
//
// build.py keys every library by every source under csrc/, this header
// included.
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

template <typename T>
constexpr T kC8 = static_cast<T>(0.70710678118654752440);    // cos(pi/4)
template <typename T>
constexpr T kS3 = static_cast<T>(0.86602540378443864676);    // sin(pi/3)
template <typename T>
constexpr T kC51 = static_cast<T>(0.30901699437494742410);   // cos(2pi/5)
template <typename T>
constexpr T kC52 = static_cast<T>(-0.80901699437494742410);  // cos(4pi/5)
template <typename T>
constexpr T kS51 = static_cast<T>(0.95105651629515357212);   // sin(2pi/5)
template <typename T>
constexpr T kS52 = static_cast<T>(0.58778525229247312917);   // sin(4pi/5)

// In-place radix-4: two radix-2 layers and a -i (forward) or +i rotation.
template <bool F, typename T>
__device__ __forceinline__ void b4(T& r0, T& i0, T& r1, T& i1, T& r2, T& i2,
                                   T& r3, T& i3) {
  const T a0r = r0 + r2, a0i = i0 + i2;
  const T a1r = r0 - r2, a1i = i0 - i2;
  const T a2r = r1 + r3, a2i = i1 + i3;
  const T dr = r1 - r3, di = i1 - i3;
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
template <int R, bool F, typename T>
__device__ __forceinline__ void butterfly(T (&r)[R], T (&i)[R]) {
  if constexpr (R == 2) {
    const T ar = r[0], ai = i[0];
    r[0] = ar + r[1];
    i[0] = ai + i[1];
    r[1] = ar - r[1];
    i[1] = ai - i[1];
  } else if constexpr (R == 3) {
    const T s = F ? -kS3<T> : kS3<T>;
    const T ar = r[1] + r[2], ai = i[1] + i[2];
    const T br = r[1] - r[2], bi = i[1] - i[2];
    const T ur = r[0] - static_cast<T>(0.5) * ar;
    const T ui = i[0] - static_cast<T>(0.5) * ai;
    const T vr = -s * bi, vi = s * br;  // i*s*b
    r[0] += ar;
    i[0] += ai;
    r[1] = ur + vr;
    i[1] = ui + vi;
    r[2] = ur - vr;
    i[2] = ui - vi;
  } else if constexpr (R == 4) {
    b4<F>(r[0], i[0], r[1], i[1], r[2], i[2], r[3], i[3]);
  } else if constexpr (R == 5) {
    const T sg = F ? static_cast<T>(-1) : static_cast<T>(1);
    const T t1r = r[1] + r[4], t1i = i[1] + i[4];
    const T t2r = r[2] + r[3], t2i = i[2] + i[3];
    const T t3r = r[1] - r[4], t3i = i[1] - i[4];
    const T t4r = r[2] - r[3], t4i = i[2] - i[3];
    const T ar = r[0] + kC51<T> * t1r + kC52<T> * t2r;
    const T ai = i[0] + kC51<T> * t1i + kC52<T> * t2i;
    const T br = r[0] + kC52<T> * t1r + kC51<T> * t2r;
    const T bi = i[0] + kC52<T> * t1i + kC51<T> * t2i;
    const T ur = kS51<T> * t3r + kS52<T> * t4r;
    const T ui = kS51<T> * t3i + kS52<T> * t4i;
    const T vr = kS52<T> * t3r - kS51<T> * t4r;
    const T vi = kS52<T> * t3i - kS51<T> * t4i;
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
    constexpr T c8 = kC8<T>;
    b4<F>(r[0], i[0], r[2], i[2], r[4], i[4], r[6], i[6]);
    b4<F>(r[1], i[1], r[3], i[3], r[5], i[5], r[7], i[7]);
    const T wi = F ? -c8 : c8;  // W_8^1 = c8 + i*wi
    const T e[4][2] = {{r[0], i[0]}, {r[2], i[2]}, {r[4], i[4]}, {r[6], i[6]}};
    T o[4][2];
    o[0][0] = r[1];
    o[0][1] = i[1];
    o[1][0] = r[3] * c8 - i[3] * wi;  // W_8^1
    o[1][1] = r[3] * wi + i[3] * c8;
    o[2][0] = F ? i[5] : -i[5];  // W_8^2 = -i (forward)
    o[2][1] = F ? -r[5] : r[5];
    o[3][0] = -r[7] * c8 - i[7] * wi;  // W_8^3 = -c8 + i*wi
    o[3][1] = r[7] * wi - i[7] * c8;
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
template <int R, bool F, typename T>
__device__ __noinline__ void stage(T* sre, T* sim, int n, int cols, int size,
                                   int stride, const T* __restrict__ twre,
                                   const T* __restrict__ twim) {
  constexpr int NB = (kPointsPerThread + R - 1) / R;  // butterflies per thread
  const int m = size / R;
  const int blk = m * stride;  // == n / R
  const int nbfly = blk * cols;
  T xr[NB][R], xi[NB][R];
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
          const T wr = __ldg(twre + i * R + k);
          const T wi = __ldg(twim + i * R + k);
          const T a = xr[q][k], b = xi[q][k];
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
template <bool F, typename T>
__device__ __forceinline__ void run_stages(T* sre, T* sim, int n, int cols,
                                           const Schedule& sch,
                                           const T* __restrict__ twre,
                                           const T* __restrict__ twim) {
  int size = n, stride = 1;
  for (int s = 0; s < sch.nstages; ++s) {
    const int r = sch.radix[s];
    const T* tr = twre + sch.tw_off[s];
    const T* ti = twim + sch.tw_off[s];
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

// One direction's chirp-z tables: the inner schedule's forward and inverse
// stage tables, the input chirp xt (n), the transformed padded chirp wt (M)
// and the output chirp xo (n, 1/M folded in).
template <typename T>
struct ChirpZ {
  const T* fwre;
  const T* fwim;
  const T* ivre;
  const T* ivim;
  const T* xtre;
  const T* xtim;
  const T* wtre;
  const T* wtim;
  const T* xore;
  const T* xoim;
};

// Steps 1-5 of the chirp-z over the block's (m, cols) planes: row r < n of
// column c becomes load(r, c) times xt[r] (load gives a pair with .x and .y,
// zeros for a masked column), rows n..m-1 zeros; then the forward stages,
// the w multiply and the inverse stages, unscaled. The planes are complete
// when it returns; the output chirp is the caller's.
template <typename T, typename Load>
__device__ __forceinline__ void chirp_z(T* sre, T* sim, int n, int m, int cols,
                                        const Schedule& sch, const ChirpZ<T>& t,
                                        Load load) {
  const int total = m * cols;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int row = e / cols, col = e - row * cols;
    T vr = 0, vi = 0;
    if (row < n) {
      const auto v = load(row, col);
      const T cr = __ldg(t.xtre + row), ci = __ldg(t.xtim + row);
      vr = v.x * cr - v.y * ci;
      vi = v.x * ci + v.y * cr;
    }
    sre[e] = vr;
    sim[e] = vi;
  }
  __syncthreads();
  run_stages<true>(sre, sim, m, cols, sch, t.fwre, t.fwim);
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int row = e / cols;
    const T wr = __ldg(t.wtre + row), wi = __ldg(t.wtim + row);
    const T a = sre[e], c = sim[e];
    sre[e] = a * wr - c * wi;
    sim[e] = a * wi + c * wr;
  }
  __syncthreads();
  run_stages<false>(sre, sim, m, cols, sch, t.ivre, t.ivim);
}

// The fused all-stages Stockham kernel (B1 at float, B6 at double): every
// column of the planar (n, B) input through the stages of `sch` into the
// planar (n, B) output, times `scale` on the store. A block owns `cols`
// adjacent columns; the ragged last group is masked, not padded.
template <typename T, bool F, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
stockham_planar(const T* __restrict__ xre, const T* __restrict__ xim,
                T* __restrict__ yre, T* __restrict__ yim, int n, int batch,
                int cols, Schedule sch, const T* __restrict__ twre,
                const T* __restrict__ twim, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sre = reinterpret_cast<T*>(smem_raw);
  T* sim = sre + n * cols;
  const int b0 = blockIdx.x * cols;
  const int total = n * cols;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int row = e / cols, col = e - row * cols, b = b0 + col;
    T vr = 0, vi = 0;
    if (b < batch) {
      const size_t g = static_cast<size_t>(row) * batch + b;
      vr = xre[g];
      vi = xim[g];
    }
    sre[e] = vr;
    sim[e] = vi;
  }
  __syncthreads();
  run_stages<F>(sre, sim, n, cols, sch, twre, twim);
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int row = e / cols, col = e - row * cols, b = b0 + col;
    if (b < batch) {
      const size_t g = static_cast<size_t>(row) * batch + b;
      yre[g] = sre[e] * scale;
      yim[g] = sim[e] * scale;
    }
  }
}

// The fused Bluestein kernel (B2's stage body): for every column
// of the planar (n, B) input, chirp_z through the m-point schedule `sch`,
// then the first n rows times xo * scale, stored. Layout as stockham_planar
// at size m.
template <typename T, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
bluestein_planar(const T* __restrict__ xre, const T* __restrict__ xim,
                 T* __restrict__ yre, T* __restrict__ yim, int n, int m,
                 int batch, int cols, Schedule sch, ChirpZ<T> t, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sre = reinterpret_cast<T*>(smem_raw);
  T* sim = sre + m * cols;
  const int b0 = blockIdx.x * cols;
  struct Pair {
    T x, y;
  };
  // 1-5. chirp in, zero rows, forward stages, w, inverse stages.
  chirp_z(sre, sim, n, m, cols, sch, t, [&](int row, int col) {
    const int b = b0 + col;
    if (b >= batch) return Pair{0, 0};
    const size_t g = static_cast<size_t>(row) * batch + b;
    return Pair{xre[g], xim[g]};
  });
  // 6. output chirp (1/M folded in) times the mode scale, first n rows.
  const int out = n * cols;
  for (int e = threadIdx.x; e < out; e += blockDim.x) {
    const int row = e / cols, col = e - row * cols, b = b0 + col;
    if (b < batch) {
      const T cr = __ldg(t.xore + row) * scale;
      const T ci = __ldg(t.xoim + row) * scale;
      const T a = sre[e], c = sim[e];
      const size_t g = static_cast<size_t>(row) * batch + b;
      yre[g] = a * cr - c * ci;
      yim[g] = a * ci + c * cr;
    }
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

// True when `threads` threads (a multiple of 32, at most `max_threads`) cover
// a block's n * cols points at kPointsPerThread each.
inline bool block_fits(int n, int cols, int threads,
                       int max_threads = kMaxThreads) {
  return cols > 0 && threads > 0 && threads <= max_threads &&
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

// Check the arguments of stockham_planar, build its schedule and launch it
// on `stream` with blocks of at most MaxThreads threads. Returns a
// cudaError_t code, 0 on success.
template <typename T, int MaxThreads>
int launch_stockham(const T* xre, const T* xim, T* yre, T* yim, int n,
                    int batch, int cols, int threads, int nstages,
                    const int* radices, const T* twre, const T* twim,
                    int forward, T scale, int device, void* stream) {
  Schedule sch{};
  if (batch <= 0 || !block_fits(n, cols, threads, MaxThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = make_schedule(n, nstages, radices, &sch);
  if (err != 0) return err;
  const size_t smem = 2 * sizeof(T) * static_cast<size_t>(n) * cols;
  auto kern = forward ? stockham_planar<T, true, MaxThreads>
                      : stockham_planar<T, false, MaxThreads>;
  err = prepare_launch(kern, smem, device);
  if (err != 0) return err;
  const dim3 grid((batch + cols - 1) / cols);
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, n, batch, cols, sch, twre, twim, scale);
  return static_cast<int>(cudaGetLastError());
}

// Check the arguments of bluestein_planar, build the m-point schedule and
// launch it on `stream`. Returns a cudaError_t code, 0 on success.
template <typename T, int MaxThreads>
int launch_bluestein(const T* xre, const T* xim, T* yre, T* yim, int n, int m,
                     int batch, int cols, int threads, int nstages,
                     const int* radices, const ChirpZ<T>& t, T scale,
                     int device, void* stream) {
  Schedule sch{};
  if (n <= 0 || 2 * n - 1 > m || batch <= 0 ||
      !block_fits(m, cols, threads, MaxThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = make_schedule(m, nstages, radices, &sch);
  if (err != 0) return err;
  const size_t smem = 2 * sizeof(T) * static_cast<size_t>(m) * cols;
  auto kern = bluestein_planar<T, MaxThreads>;
  err = prepare_launch(kern, smem, device);
  if (err != 0) return err;
  const dim3 grid((batch + cols - 1) / cols);
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, n, m, batch, cols, sch, t, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
