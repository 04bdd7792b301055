// Kernel B1: the fused all-stages mixed-radix Stockham FFT, complex64 planar,
// batch-minor (n, B), for NVIDIA Hopper (sm_90a).
//
// Replaces fourier_tpu/ops/pallas/stockham_vpu.py:_kernel, launched by
// vpu_fft_batch_minor. It computes the DFT of every column of a contiguous
// planar f32 (n, B) pair, in any of the five modes, into fresh outputs; the
// input is never written.
//
// What bounds it on this card: memory. All stages stay on chip, so one call
// reads and writes the two planes once, 16*n*B bytes, against about 5*n*log2(n)
// flops per column: roughly 1.5 flops per byte at n=4096, far below the
// H100's f32 ridge point.
//
// Design:
// - Layout and coalescing. A block owns `cols` adjacent batch columns
//   (launch_geometry in ops/cuda/stockham_vpu.py: 32 for n <= 256, 8 up to
//   n = 2048, then 4, 2 and 1 at n = 4096, 8192 and 16384). Consecutive
//   threads load consecutive columns of one row, so each row segment is one
//   contiguous cols*4-byte run. The ragged last column group is masked, not
//   padded. Narrow runs are the kernel's main cost at large n: on an H100 a
//   load-and-store-only version of it took 2.24 ms at n=4096 with 2 columns
//   (8-byte runs) but 0.54 ms at n=1024 with 8 columns, on the same bytes.
//   Wider column groups (a two-pass split, or a cluster sharing its shared
//   memory) are the next step.
// - Shared memory. The block's (n, cols) planes live in dynamic shared
//   memory, 8*n*cols bytes, at most 128 KiB. A Stockham ping-pong pair would
//   need twice that, past the 227 KB a block may use at n = 16384, so every
//   stage runs in place: each thread loads the inputs of its butterflies into
//   registers, the block synchronises, then each thread writes its outputs.
// - Stage schedule. The plan's domain is radix_schedule(n) of the TPU kernel,
//   but this kernel runs its own schedule (kernel_schedule in
//   ops/cuda/stockham_vpu.py): every radix of radix_schedule split into
//   radices 8, 4, 2, 3 and 5, because the TPU's radix-64/81/125 blocks hold
//   128-250 floats per butterfly in registers. Each thread handles at most
//   kPointsPerThread points per stage, which sets the block size.
// - Registers. A stage is a separate (non-inlined) function per radix, and
//   blocks of at most 512 threads take an instantiation bounded at 512
//   threads, so ptxas may give a thread 64 registers instead of 32; on an
//   H100 this removed their spills (n=4096 with 2 columns a block: 3.54 ms
//   before, 2.76 ms after). 1024-thread blocks keep 32 registers and spill.
// - Twiddles. Compact per-stage (m, r) tables, W_s^(i*k), computed in f64 at
//   plan time and narrowed to f32, concatenated stage after stage; the final
//   stage (m == 1) has none. The butterflies' constants are f64 literals
//   narrowed at compile time. No trigonometry runs on the device.
// - Scale. The mode scale is applied once, on the store (1.0 for unscaled
//   modes, which is exact).
// - The host function checks its arguments, launches on the caller's stream,
//   neither allocates nor synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>

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

template <bool F, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
stockham_c64(const float* __restrict__ xre, const float* __restrict__ xim,
             float* __restrict__ yre, float* __restrict__ yim, int n, int batch,
             int cols, Schedule sch, const float* __restrict__ twre,
             const float* __restrict__ twim, float scale) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + n * cols;
  const int b0 = blockIdx.x * cols;
  const int total = n * cols;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int row = e / cols, col = e - row * cols, b = b0 + col;
    float vr = 0.0f, vi = 0.0f;
    if (b < batch) {
      const size_t g = static_cast<size_t>(row) * batch + b;
      vr = xre[g];
      vi = xim[g];
    }
    sre[e] = vr;
    sim[e] = vi;
  }
  __syncthreads();
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
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int row = e / cols, col = e - row * cols, b = b0 + col;
    if (b < batch) {
      const size_t g = static_cast<size_t>(row) * batch + b;
      yre[g] = sre[e] * scale;
      yim[g] = sim[e] * scale;
    }
  }
}

}  // namespace

extern "C" {

// Transform the B = `batch` columns of the planar (n, B) input into the
// planar (n, B) output. `radices` (host memory, `nstages` entries from
// {2, 3, 4, 5, 8}) multiply to n; `twre`/`twim` hold the concatenated
// per-stage (n_s / r_s, r_s) tables of every stage but the last. Returns a
// cudaError_t code, 0 on success.
int fourier_stockham_c64(const float* xre, const float* xim, float* yre,
                         float* yim, int n, int batch, int cols, int threads,
                         int nstages, const int* radices, const float* twre,
                         const float* twim, int forward, float scale,
                         int device, void* stream) {
  if (n <= 0 || batch <= 0 || cols <= 0 || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 || nstages <= 0 ||
      nstages > kMaxStages ||
      static_cast<long long>(threads) * kPointsPerThread <
          static_cast<long long>(n) * cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Schedule sch{};
  sch.nstages = nstages;
  int size = n, off = 0;
  for (int s = 0; s < nstages; ++s) {
    const int r = radices[s];
    if ((r != 2 && r != 3 && r != 4 && r != 5 && r != 8) || size % r != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    sch.radix[s] = r;
    sch.tw_off[s] = off;
    if (size / r > 1) off += size;
    size /= r;
  }
  if (size != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(n) * cols;
  auto kern = threads <= 512
                  ? (forward ? stockham_c64<true, 512> : stockham_c64<false, 512>)
                  : (forward ? stockham_c64<true, kMaxThreads>
                             : stockham_c64<false, kMaxThreads>);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((batch + cols - 1) / cols);
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, n, batch, cols, sch, twre, twim, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
