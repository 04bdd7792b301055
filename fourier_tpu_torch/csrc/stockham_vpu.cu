// Kernels B1, B2 and B3: the fused Stockham FFTs over complex64 planar,
// batch-minor planes, for NVIDIA Hopper (sm_90a), in one library. The
// butterflies, the in-place stage, the stage loop and the host-side checks
// of all three live in stockham_stages.cuh. Each host function checks its
// arguments, launches on the caller's stream, neither allocates nor
// synchronises, and returns cudaGetLastError().
//
// Kernel B1: the fused all-stages mixed-radix Stockham FFT, batch-minor
// (n, B).
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

#include "stockham_stages.cuh"

namespace {

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

}  // namespace

// Kernel B2: the fused Bluestein (chirp-z) FFT, batch-minor (n, B).
//
// Replaces fourier_tpu/ops/pallas/stockham_vpu.py:_bluestein_kernel (:881,
// body _bluestein_value :918), launched by vpu_bluestein_batch_minor (:946).
// For every column of a contiguous planar f32 (n, B) input it computes, into
// fresh outputs:
//   1. x * xt (the direction-matched chirp, n entries);
//   2. zero rows n..M-1, written into shared memory, never read from memory;
//   3. the forward M-point Stockham stages;
//   4. times wt (the plan-time FFT of the padded chirp, M entries);
//   5. the inverse M-point stages, unscaled;
//   6. the first n rows times xo * scale (xo carries 1/M from plan time; the
//      mode scale arrives as a float, as in B1), stored.
// M is 5-smooth with 8 | M and M <= 8192 (VpuBluesteinPlan.choose_inner).
//
// What bounds it on this card: it reads and writes only n rows per column,
// 16*n*B bytes, but runs two M >= 2n-1 point transforms on chip, about
// 10*M*log2(M) flops per column: at n = 1013 (M = 2048) some 13 flops per
// byte, several times B1's, yet still below the H100's f32 ridge point. The
// stages' shared-memory traffic and their two barriers per stage (twice as
// many stages as B1 at the same M) are the likely limit; the narrow
// batch-minor row runs of B1 apply as well.
//
// Design:
// - A block owns `cols` adjacent columns, as B1 would at size M
//   (launch_geometry(M) of ops/cuda/stockham_vpu.py: 8 at M = 2048, 5 at
//   2880, 2 at 8192). Its (M, cols) planes live in dynamic shared memory,
//   8*M*cols bytes, at most 128 KiB (64 KiB per column at M = 8192); the
//   attribute is raised above 48 KiB. The ragged last column group is masked, not padded: the
//   batch is never padded.
// - The stages run in place, as in B1: first the forward schedule with its
//   tables, then the inverse one with its own, both kernel_schedule(M) of
//   the wrapper.
// - The chirp, w and output tables are read from global memory (__ldg) at
//   the row each thread owns; they are f64 plan-time values narrowed to f32.

namespace {

template <int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
bluestein_c64(const float* __restrict__ xre, const float* __restrict__ xim,
              float* __restrict__ yre, float* __restrict__ yim, int n, int m,
              int batch, int cols, Schedule sch,
              const float* __restrict__ fwre, const float* __restrict__ fwim,
              const float* __restrict__ ivre, const float* __restrict__ ivim,
              const float* __restrict__ xtre, const float* __restrict__ xtim,
              const float* __restrict__ wtre, const float* __restrict__ wtim,
              const float* __restrict__ xore, const float* __restrict__ xoim,
              float scale) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + m * cols;
  const int b0 = blockIdx.x * cols;
  const int total = m * cols;
  // 1-2. chirp multiply into the first n rows, zeros below.
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int row = e / cols, col = e - row * cols, b = b0 + col;
    float vr = 0.0f, vi = 0.0f;
    if (row < n && b < batch) {
      const size_t g = static_cast<size_t>(row) * batch + b;
      const float a = xre[g], c = xim[g];
      const float cr = __ldg(xtre + row), ci = __ldg(xtim + row);
      vr = a * cr - c * ci;
      vi = a * ci + c * cr;
    }
    sre[e] = vr;
    sim[e] = vi;
  }
  __syncthreads();
  // 3. forward inner transform.
  run_stages<true>(sre, sim, m, cols, sch, fwre, fwim);
  // 4. w multiply.
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int row = e / cols;
    const float wr = __ldg(wtre + row), wi = __ldg(wtim + row);
    const float a = sre[e], c = sim[e];
    sre[e] = a * wr - c * wi;
    sim[e] = a * wi + c * wr;
  }
  __syncthreads();
  // 5. inverse inner transform (unscaled).
  run_stages<false>(sre, sim, m, cols, sch, ivre, ivim);
  // 6. output chirp (1/M folded in) times the mode scale, first n rows.
  const int out = n * cols;
  for (int e = threadIdx.x; e < out; e += blockDim.x) {
    const int row = e / cols, col = e - row * cols, b = b0 + col;
    if (b < batch) {
      const float cr = __ldg(xore + row) * scale;
      const float ci = __ldg(xoim + row) * scale;
      const float a = sre[e], c = sim[e];
      const size_t g = static_cast<size_t>(row) * batch + b;
      yre[g] = a * cr - c * ci;
      yim[g] = a * ci + c * cr;
    }
  }
}

}  // namespace

// Kernel B3: the row leg of the single-chip four-step FFT, batch-minor.
//
// Replaces fourier_tpu/ops/pallas/stockham_vpu.py:_four_step_row_kernel
// (:778), launched by vpu_fft_four_step_row (:805). A transform of size
// n = p*q (plan/four_step_local.py) first runs q-point column transforms
// (kernel B1) over the contiguous (q, p*B) view of the (n, B) input; this
// kernel takes that result as (q, p, B), element (k2, a, b) at
// (k2*p + a)*B + b, and for every k2 and column b:
//   1. multiplies row a by the split twiddle W_n^(+-a*k2) times the mode
//      scale (a plan-time (q, p) table, row k2; the scale arrives as a float);
//   2. runs the p-point Stockham stages of B1;
//   3. stores element (k1, b) at k1*(q*B) + k2*B + b.
// The output, read as (n, B), is then in natural order X[k1*q + k2]: the
// dense twiddle pass and the (q, p, B) -> (p, q, B) transpose of the plain
// route cost no extra pass over memory.
//
// What bounds it on this card: memory, as B1. One call reads and writes the
// two planes once, 16*n*B bytes, against about 5*p*log2(p) + 6*p flops per
// row; the transposed store writes runs of cols*4 bytes at stride q*B.
//
// Design:
// - Grid: column groups on x, k2 on y (q <= 16384 fits gridDim.y). A block
//   owns `cols` adjacent batch columns of one k2 (launch_geometry(p) of
//   ops/cuda/stockham_vpu.py, as B1 at size p); its (p, cols) planes live in
//   dynamic shared memory, in place, with B1's stages. The ragged last
//   column group is masked.
// - Offsets into the data are size_t: q*p*B passes 2^31 (n = 262144 at
//   B = 16384 is 4.3e9 elements).

namespace {

template <bool F, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
four_step_row_c64(const float* __restrict__ xre, const float* __restrict__ xim,
                  float* __restrict__ yre, float* __restrict__ yim, int p,
                  int q, int batch, int cols, Schedule sch,
                  const float* __restrict__ twre, const float* __restrict__ twim,
                  const float* __restrict__ prre, const float* __restrict__ prim,
                  float scale) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + p * cols;
  const int b0 = blockIdx.x * cols;
  const int k2 = blockIdx.y;
  const int total = p * cols;
  const size_t in0 = static_cast<size_t>(k2) * p * batch;
  const float* pr = prre + static_cast<size_t>(k2) * p;
  const float* pi = prim + static_cast<size_t>(k2) * p;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int a = e / cols, col = e - a * cols, b = b0 + col;
    float vr = 0.0f, vi = 0.0f;
    if (b < batch) {
      const size_t g = in0 + static_cast<size_t>(a) * batch + b;
      const float xr = xre[g], xi = xim[g];
      const float tr = __ldg(pr + a) * scale, ti = __ldg(pi + a) * scale;
      vr = xr * tr - xi * ti;
      vi = xr * ti + xi * tr;
    }
    sre[e] = vr;
    sim[e] = vi;
  }
  __syncthreads();
  run_stages<F>(sre, sim, p, cols, sch, twre, twim);
  const size_t row_stride = static_cast<size_t>(q) * batch;
  const size_t out0 = static_cast<size_t>(k2) * batch;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int k1 = e / cols, col = e - k1 * cols, b = b0 + col;
    if (b < batch) {
      const size_t g = static_cast<size_t>(k1) * row_stride + out0 + b;
      yre[g] = sre[e];
      yim[g] = sim[e];
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
  Schedule sch{};
  if (batch <= 0 || !block_fits(n, cols, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = make_schedule(n, nstages, radices, &sch);
  if (err != 0) return err;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(n) * cols;
  auto kern = threads <= 512
                  ? (forward ? stockham_c64<true, 512> : stockham_c64<false, 512>)
                  : (forward ? stockham_c64<true, kMaxThreads>
                             : stockham_c64<false, kMaxThreads>);
  err = prepare_launch(kern, smem, device);
  if (err != 0) return err;
  const dim3 grid((batch + cols - 1) / cols);
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, n, batch, cols, sch, twre, twim, scale);
  return static_cast<int>(cudaGetLastError());
}

// Bluestein transform of the B = `batch` columns of the planar (n, B) input
// into the planar (n, B) output, through an M = `m`-point inner transform
// whose `nstages` radices (host memory, from {2, 3, 4, 5, 8}) multiply to m.
// `fw*`/`iv*`: the concatenated forward / inverse stage tables of that
// schedule; `xt*` (n), `wt*` (m), `xo*` (n): the direction-matched chirp
// tables, 1/M folded into xo. Returns a cudaError_t code, 0 on success.
int fourier_bluestein_c64(const float* xre, const float* xim, float* yre,
                          float* yim, int n, int m, int batch, int cols,
                          int threads, int nstages, const int* radices,
                          const float* fwre, const float* fwim,
                          const float* ivre, const float* ivim,
                          const float* xtre, const float* xtim,
                          const float* wtre, const float* wtim,
                          const float* xore, const float* xoim, float scale,
                          int device, void* stream) {
  Schedule sch{};
  if (n <= 0 || 2 * n - 1 > m || batch <= 0 || !block_fits(m, cols, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = make_schedule(m, nstages, radices, &sch);
  if (err != 0) return err;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(m) * cols;
  auto kern = threads <= 512 ? bluestein_c64<512> : bluestein_c64<kMaxThreads>;
  err = prepare_launch(kern, smem, device);
  if (err != 0) return err;
  const dim3 grid((batch + cols - 1) / cols);
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, n, m, batch, cols, sch, fwre, fwim, ivre, ivim,
      xtre, xtim, wtre, wtim, xore, xoim, scale);
  return static_cast<int>(cudaGetLastError());
}

// Row leg of an n = p*q four-step: the planar (q, p, B) input (B = `batch`)
// into the planar (p, q*B) output. `radices` (host memory, `nstages` entries
// from {2, 3, 4, 5, 8}) multiply to p; `twre`/`twim` hold the concatenated
// per-stage tables of that schedule; `prre`/`prim` the (q, p) split twiddle
// table, row k2 = W_n^(+-a*k2). Returns a cudaError_t code, 0 on success.
int fourier_four_step_row_c64(const float* xre, const float* xim, float* yre,
                              float* yim, int p, int q, int batch, int cols,
                              int threads, int nstages, const int* radices,
                              const float* twre, const float* twim,
                              const float* prre, const float* prim,
                              int forward, float scale, int device,
                              void* stream) {
  Schedule sch{};
  if (q <= 0 || q > 65535 || batch <= 0 || !block_fits(p, cols, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = make_schedule(p, nstages, radices, &sch);
  if (err != 0) return err;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(p) * cols;
  auto kern = threads <= 512
                  ? (forward ? four_step_row_c64<true, 512>
                             : four_step_row_c64<false, 512>)
                  : (forward ? four_step_row_c64<true, kMaxThreads>
                             : four_step_row_c64<false, kMaxThreads>);
  err = prepare_launch(kern, smem, device);
  if (err != 0) return err;
  const dim3 grid((batch + cols - 1) / cols, q);
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, yre, yim, p, q, batch, cols, sch, twre, twim, prre, prim,
      scale);
  return static_cast<int>(cudaGetLastError());
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
