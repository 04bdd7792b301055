// Kernels B1-B5: the fused Stockham FFTs over complex64 planar, batch-minor
// planes (B1, B2, B3) and the real transforms built on them (B4a, B4b, B5a,
// B5b), for NVIDIA Hopper (sm_90a), in one library. The butterflies, the
// in-place stage, the stage loop and the host-side checks of all of them
// live in stockham_stages.cuh. Each host function checks its
// arguments, launches on the caller's stream, neither allocates nor
// synchronises, and returns cudaGetLastError().
//
// Kernel B1: the fused all-stages mixed-radix Stockham FFT, batch-minor
// (n, B). This is its stage body; the clustered-block body of fft_pair.cu
// (its own library) is the kernel at the 60 n of fft_pair_geometry (8 | n up
// to 4096, but 3000 and 3240) except B1_STAGE_FASTER (ops/cuda/
// stockham_vpu.py), and this body at the rest of B1's domain: those, 3000,
// 3240, the pure powers of 3 and 5, and every n above 4096.
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
//   The clustered body keeps 32-byte runs by sharing a column group among
//   the blocks of a cluster.
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
// The kernel is stockham_planar<float> of stockham_stages.cuh, which B6
// instantiates at double.

#include "stockham_stages.cuh"

// Kernel B2: the fused Bluestein (chirp-z) FFT, batch-minor (n, B). This is
// its stage body; the paired-block body of bluestein_pair.cu (its own
// library) is the kernel at the inner sizes M <= 2048 but 1024 of
// bluestein_pair_geometry_c64 except B2_STAGE_FASTER (ops/cuda/
// stockham_vpu.py), and this body at those, at M = 1024 and above 2048.
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
// The kernel is bluestein_planar<float> of stockham_stages.cuh; its steps
// 1-5 are chirp_z there, which the odd-n real kernels B5a and B5b share.
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
//   attribute is raised above 48 KiB. The ragged last column group is masked, not
//   padded: the batch is never padded.
// - The stages run in place, as in B1: first the forward schedule with its
//   tables, then the inverse one with its own, both kernel_schedule(M) of
//   the wrapper.
// - The chirp, w and output tables are read from global memory (__ldg) at
//   the row each thread owns; they are f64 plan-time values narrowed to f32.

// Kernel B3: the row leg of the single-chip four-step FFT, batch-minor.
// This is its stage body; the clustered-block body of four_step_pair.cu
// (its own library) is the kernel at the 56 p of four_step_pair_geometry
// (B1's clustered sizes but 960, 1280, 2560 and 3840) except
// B3_STAGE_FASTER (ops/cuda/stockham_vpu.py), and this body at the rest.
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

// Kernels B4a and B4b: the even-n real transforms, batch-minor.
//
// Replace fourier_tpu/ops/pallas/stockham_vpu.py:_rfft_pack_kernel (:529),
// launched by vpu_rfft_pack_batch_minor (:619), and _irfft_unpack_kernel
// (:574), launched by vpu_irfft_unpack_batch_minor (:699). For n = 2m, a
// real (2m, B) signal is the m-point complex signal z[j] = x[2j] + i*x[2j+1];
// with Z = FFT_m(z), E[k] = (Z[k] + conj Z[(m-k) mod m])/2 and
// O[k] = -i*(Z[k] - conj Z[(m-k) mod m])/2, the one-sided spectrum is
// X[k] = E[k] + W^k*O[k] (k < m) and X[m] = E[0] - O[0], W = exp(-2*pi*i/n).
//   B4a: real (2m, B) -> planar (m+1, B): load rows 2j and 2j+1 into the
//        re and im planes of row j, B1's forward m-point stages, then the
//        pack, read from shared memory and stored to fresh outputs.
//   B4b: planar (m+1, B) -> real (2m, B): the unpack builds Z[k] from rows
//        k and m-k of the input (imaginary DC and Nyquist read as 0, as
//        numpy's irfft ignores them), with conj(W^k) and h = 0.5/m, so the
//        inverse stages run unscaled; row j is stored to rows 2j and 2j+1.
//
// What bounds them on this card: memory, as B1. One call moves about 8*n*B
// bytes (n*B*4 real, (m+1)*B*8 complex), half a c2c of size n, against
// B1's m-point stages; the narrow cols*4-byte row runs cost most, as in B1.
//
// Design:
// - B1's layout: a block owns `cols` adjacent batch columns
//   (launch_geometry(m)), its (m, cols) planes live in dynamic shared
//   memory, 8*m*cols bytes, the stages run in place through run_stages, the
//   ragged last column group is masked, not padded; offsets are size_t.
// - The even/odd split is addressing: row 2j goes to the re plane, row 2j+1
//   to the im plane, and back. The mirror (m-k) mod m is an index into
//   shared memory, not a reverse pass, so every m of B1's domain is served
//   (the TPU kernel's row reverse takes only powers of two).
// - The twiddle w is a planar (2, m) table of exp(-2*pi*i*k/n), f64 at plan
//   time, narrowed; B4b conjugates it.
// - B4a's body here (rfft_even_c64<true>) is the kernel for odd m (243, 625,
//   729, 2187, 3125) and for m above 2048. For every other m the wrapper
//   launches the paired-block body of rfft_pack_pair.cu: 32-byte row runs
//   over two blocks of a cluster, persistent, fed by cp.async, its passes
//   fixed at compile time. At 4096 x 16384 on an H100 80GB HBM3 at 700 W
//   (chip_smoke.py phase 5d, same run) that body took 0.49 ms, 0.33 of the
//   0.160 ms byte bound, and this one 0.85 ms, 0.19 of it.
//
// Kernels B5a and B5b: the odd-n real transforms, two-for-one, batch-minor.
//
// Replace fourier_tpu/ops/pallas/stockham_vpu.py:_rfft_odd_pack_kernel
// (:1029), launched by vpu_rfft_odd_pack_batch_minor (:1099), and
// _irfft_odd_unpack_kernel (:1051), launched by
// vpu_irfft_odd_unpack_batch_minor (:1154). Column j pairs with column
// j + h, h = ceil(B/2): one chirp-z (B2's chirp_z) transforms
// z = x_j + i*x_{j+h}, and with Z_rev[k] = Z[(n-k) mod n] the two one-sided
// spectra (L = (n+1)/2 bins) are X1 = (Z + conj Z_rev)/2 and
// X2 = -i*(Z - conj Z_rev)/2.
//   B5a: real (n, B) -> planar (L, B): chirp-z with the forward chirps, the
//        output chirp applied in shared memory (a pass, then a barrier),
//        then the separation read from rows k and (n-k) mod n; X1 goes to
//        column j, X2 to column j + h.
//   B5b: planar (L, B) -> real (n, B): Z[k] = X1[k] + i*X2[k] for k < L and
//        conj X1[n-k] + i*conj X2[n-k] above, imaginary DC parts read as 0;
//        chirp-z with the inverse chirps, the output chirp times 1/n; re
//        goes to column j, im to column j + h.
// When j + h >= B (odd B, B = 1) the partner is read as zeros and its
// writes are masked. The batch is never padded.
//
// What bounds them on this card: as B2, the on-chip M-point stage passes,
// not bytes; one chirp-z serves two columns, so about half B2's time per
// column at the same n. Their layout is B2's at size M, over h columns.

namespace {

template <bool Pack, int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
rfft_even_c64(const float* __restrict__ xre, const float* __restrict__ xim,
              float* __restrict__ yre, float* __restrict__ yim, int m,
              int batch, int cols, Schedule sch,
              const float* __restrict__ twre, const float* __restrict__ twim,
              const float* __restrict__ wre, const float* __restrict__ wim,
              float h) {
  // Pack (B4a): xre is the real (2m, B) signal, yre/yim the (m+1, B)
  // spectrum. Unpack (B4b): xre/xim the (m+1, B) spectrum, yre the real
  // (2m, B) signal.
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + m * cols;
  const int b0 = blockIdx.x * cols;
  const int total = m * cols;
  const size_t bs = static_cast<size_t>(batch);
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int k = e / cols, col = e - k * cols, b = b0 + col;
    float vr = 0.0f, vi = 0.0f;
    if (b < batch) {
      if constexpr (Pack) {
        const size_t g = 2 * static_cast<size_t>(k) * bs + b;
        vr = xre[g];
        vi = xre[g + bs];
      } else {
        // Z[k] = E[k] + i*conj(W^k)*WO[k] from X[k] and conj X[m-k].
        const size_t g = static_cast<size_t>(k) * bs + b;
        const size_t gr = static_cast<size_t>(m - k) * bs + b;
        const float xr = xre[g], xi = k == 0 ? 0.0f : xim[g];
        const float cr = xre[gr], ci = k == 0 ? 0.0f : -xim[gr];
        const float er = h * (xr + cr), ei = h * (xi + ci);
        const float wor = h * (xr - cr), woi = h * (xi - ci);
        const float wr = __ldg(wre + k), wi = __ldg(wim + k);
        const float o_r = wr * wor + wi * woi, o_i = wr * woi - wi * wor;
        vr = er - o_i;
        vi = ei + o_r;
      }
    }
    sre[e] = vr;
    sim[e] = vi;
  }
  __syncthreads();
  run_stages<Pack>(sre, sim, m, cols, sch, twre, twim);
  if constexpr (Pack) {
    const int out = (m + 1) * cols;
    for (int e = threadIdx.x; e < out; e += blockDim.x) {
      const int k = e / cols, col = e - k * cols, b = b0 + col;
      if (b < batch) {
        const int kk = k == m ? 0 : k;       // row m reads E[0] and O[0]
        const int kr = kk == 0 ? 0 : m - kk;  // (m-k) mod m
        const float zr = sre[kk * cols + col], zi = sim[kk * cols + col];
        const float cr = sre[kr * cols + col], ci = -sim[kr * cols + col];
        const float er = 0.5f * (zr + cr), ei = 0.5f * (zi + ci);
        const float o_r = 0.5f * (zi - ci), o_i = -0.5f * (zr - cr);
        float xr, xi;
        if (k < m) {
          const float wr = __ldg(wre + k), wi = __ldg(wim + k);
          xr = er + wr * o_r - wi * o_i;
          xi = ei + wr * o_i + wi * o_r;
        } else {
          xr = er - o_r;
          xi = ei - o_i;
        }
        const size_t g = static_cast<size_t>(k) * bs + b;
        yre[g] = xr;
        yim[g] = xi;
      }
    }
  } else {
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int j = e / cols, col = e - j * cols, b = b0 + col;
      if (b < batch) {
        const size_t g = 2 * static_cast<size_t>(j) * bs + b;
        yre[g] = sre[e];
        yre[g + bs] = sim[e];
      }
    }
  }
}

template <int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
rfft_odd_pack_c64(const float* __restrict__ x, float* __restrict__ yre,
                  float* __restrict__ yim, int n, int m, int batch, int half,
                  int cols, Schedule sch, ChirpZ<float> t) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + m * cols;
  const int b0 = blockIdx.x * cols;
  const size_t bs = static_cast<size_t>(batch);
  // 1-5. chirp-z of x_j + i*x_{j+h}.
  chirp_z(sre, sim, n, m, cols, sch, t, [&](int row, int col) {
    const int j = b0 + col;
    float a = 0.0f, c = 0.0f;
    if (j < half) {
      const size_t g = static_cast<size_t>(row) * bs + j;
      a = x[g];
      if (j + half < batch) c = x[g + half];
    }
    return make_float2(a, c);
  });
  // 6. output chirp (1/M folded in) on the first n rows, in place.
  const int out = n * cols;
  for (int e = threadIdx.x; e < out; e += blockDim.x) {
    const int row = e / cols;
    const float cr = __ldg(t.xore + row), ci = __ldg(t.xoim + row);
    const float a = sre[e], c = sim[e];
    sre[e] = a * cr - c * ci;
    sim[e] = a * ci + c * cr;
  }
  __syncthreads();
  // 7. two-for-one separation of bins 0..L-1.
  const int nbins = (n + 1) / 2;
  const int sep = nbins * cols;
  for (int e = threadIdx.x; e < sep; e += blockDim.x) {
    const int k = e / cols, col = e - k * cols, j = b0 + col;
    if (j < half) {
      const int kr = k == 0 ? 0 : n - k;  // (n-k) mod n
      const float zr = sre[e], zi = sim[e];
      const float sr = sre[kr * cols + col], si = sim[kr * cols + col];
      const size_t g = static_cast<size_t>(k) * bs + j;
      yre[g] = 0.5f * (zr + sr);
      yim[g] = 0.5f * (zi - si);
      if (j + half < batch) {
        yre[g + half] = 0.5f * (zi + si);
        yim[g + half] = -0.5f * (zr - sr);
      }
    }
  }
}

template <int MaxThreads>
__global__ void __launch_bounds__(MaxThreads)
irfft_odd_unpack_c64(const float* __restrict__ xre,
                     const float* __restrict__ xim, float* __restrict__ y,
                     int n, int m, int batch, int half, int cols, Schedule sch,
                     ChirpZ<float> t, float scale) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + m * cols;
  const int b0 = blockIdx.x * cols;
  const size_t bs = static_cast<size_t>(batch);
  const int nbins = (n + 1) / 2;
  // 1-5. chirp-z of Z = X1 + i*X2, Hermitian above bin L-1.
  chirp_z(sre, sim, n, m, cols, sch, t, [&](int row, int col) {
    const int j = b0 + col;
    if (j >= half) return make_float2(0.0f, 0.0f);
    const bool head = row < nbins;
    const int k = head ? row : n - row;
    const size_t g = static_cast<size_t>(k) * bs + j;
    const float ar = xre[g], ai = k == 0 ? 0.0f : xim[g];
    float br = 0.0f, bi = 0.0f;
    if (j + half < batch) {
      br = xre[g + half];
      bi = k == 0 ? 0.0f : xim[g + half];
    }
    // head: X1 + i*X2; tail: conj X1 + i*conj X2.
    return head ? make_float2(ar - bi, ai + br) : make_float2(ar + bi, br - ai);
  });
  // 6. output chirp (1/M folded in) times `scale`; re to column j, im to
  // column j + h.
  const int out = n * cols;
  for (int e = threadIdx.x; e < out; e += blockDim.x) {
    const int row = e / cols, col = e - row * cols, j = b0 + col;
    if (j < half) {
      const float cr = __ldg(t.xore + row) * scale;
      const float ci = __ldg(t.xoim + row) * scale;
      const float a = sre[e], c = sim[e];
      const size_t g = static_cast<size_t>(row) * bs + j;
      y[g] = a * cr - c * ci;
      if (j + half < batch) y[g + half] = a * ci + c * cr;
    }
  }
}

// True for an odd n >= 3 whose chirp-z fits an m-point inner transform.
inline bool odd_fits(int n, int m) {
  return n >= 3 && n % 2 == 1 && 2 * n - 1 <= m;
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
  return threads <= 512
             ? launch_stockham<float, 512>(xre, xim, yre, yim, n, batch, cols,
                                           threads, nstages, radices, twre,
                                           twim, forward, scale, device, stream)
             : launch_stockham<float, kMaxThreads>(
                   xre, xim, yre, yim, n, batch, cols, threads, nstages,
                   radices, twre, twim, forward, scale, device, stream);
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
  const ChirpZ<float> t{fwre, fwim, ivre, ivim, xtre, xtim, wtre, wtim, xore, xoim};
  return threads <= 512
             ? launch_bluestein<float, 512>(xre, xim, yre, yim, n, m, batch,
                                            cols, threads, nstages, radices, t,
                                            scale, device, stream)
             : launch_bluestein<float, kMaxThreads>(
                   xre, xim, yre, yim, n, m, batch, cols, threads, nstages,
                   radices, t, scale, device, stream);
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

// Even-n rfft (B4a): the real (2m, B) input `x` (B = `batch`) into the
// planar (m+1, B) one-sided spectrum. `radices` (host memory, `nstages`
// entries from {2, 3, 4, 5, 8}) multiply to m; `twre`/`twim` hold the
// concatenated forward stage tables of that schedule; `wre`/`wim` the m
// entries of exp(-2*pi*i*k/(2m)). Returns a cudaError_t code, 0 on success.
int fourier_rfft_pack_c64(const float* x, float* yre, float* yim, int m,
                          int batch, int cols, int threads, int nstages,
                          const int* radices, const float* twre,
                          const float* twim, const float* wre, const float* wim,
                          int device, void* stream) {
  Schedule sch{};
  if (batch <= 0 || !block_fits(m, cols, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = make_schedule(m, nstages, radices, &sch);
  if (err != 0) return err;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(m) * cols;
  auto kern = threads <= 512 ? rfft_even_c64<true, 512>
                             : rfft_even_c64<true, kMaxThreads>;
  err = prepare_launch(kern, smem, device);
  if (err != 0) return err;
  const dim3 grid((batch + cols - 1) / cols);
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, nullptr, yre, yim, m, batch, cols, sch, twre, twim, wre, wim, 0.5f);
  return static_cast<int>(cudaGetLastError());
}

// Even-n irfft (B4b): the planar (m+1, B) one-sided spectrum into the real
// (2m, B) output `y`. `twre`/`twim`: the inverse stage tables of the m-point
// schedule; `wre`/`wim` as for B4a (conjugated here); `h` = 0.5/m. Returns
// a cudaError_t code, 0 on success.
int fourier_irfft_unpack_c64(const float* xre, const float* xim, float* y,
                             int m, int batch, int cols, int threads,
                             int nstages, const int* radices, const float* twre,
                             const float* twim, const float* wre,
                             const float* wim, float h, int device,
                             void* stream) {
  Schedule sch{};
  if (batch <= 0 || !block_fits(m, cols, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = make_schedule(m, nstages, radices, &sch);
  if (err != 0) return err;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(m) * cols;
  auto kern = threads <= 512 ? rfft_even_c64<false, 512>
                             : rfft_even_c64<false, kMaxThreads>;
  err = prepare_launch(kern, smem, device);
  if (err != 0) return err;
  const dim3 grid((batch + cols - 1) / cols);
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, y, nullptr, m, batch, cols, sch, twre, twim, wre, wim, h);
  return static_cast<int>(cudaGetLastError());
}

// Odd-n rfft (B5a): the real (n, B) input `x` into the planar (L, B)
// one-sided spectrum, L = (n+1)/2; column j and column j + ceil(B/2) share
// one chirp-z. The tables are B2's, forward direction. Returns a
// cudaError_t code, 0 on success.
int fourier_rfft_odd_pack_c64(const float* x, float* yre, float* yim, int n,
                              int m, int batch, int cols, int threads,
                              int nstages, const int* radices,
                              const float* fwre, const float* fwim,
                              const float* ivre, const float* ivim,
                              const float* xtre, const float* xtim,
                              const float* wtre, const float* wtim,
                              const float* xore, const float* xoim, int device,
                              void* stream) {
  Schedule sch{};
  if (!odd_fits(n, m) || batch <= 0 || !block_fits(m, cols, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = make_schedule(m, nstages, radices, &sch);
  if (err != 0) return err;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(m) * cols;
  auto kern = threads <= 512 ? rfft_odd_pack_c64<512>
                             : rfft_odd_pack_c64<kMaxThreads>;
  err = prepare_launch(kern, smem, device);
  if (err != 0) return err;
  const int half = (batch + 1) / 2;
  const dim3 grid((half + cols - 1) / cols);
  const ChirpZ<float> t{fwre, fwim, ivre, ivim, xtre, xtim, wtre, wtim, xore, xoim};
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, yre, yim, n, m, batch, half, cols, sch, t);
  return static_cast<int>(cudaGetLastError());
}

// Odd-n irfft (B5b): the planar (L, B) one-sided spectrum into the real
// (n, B) output `y`, column pairs as in B5a. The tables are B2's, inverse
// direction; `scale` multiplies the output chirp (1/n for irfft). Returns a
// cudaError_t code, 0 on success.
int fourier_irfft_odd_unpack_c64(const float* xre, const float* xim, float* y,
                                 int n, int m, int batch, int cols,
                                 int threads, int nstages, const int* radices,
                                 const float* fwre, const float* fwim,
                                 const float* ivre, const float* ivim,
                                 const float* xtre, const float* xtim,
                                 const float* wtre, const float* wtim,
                                 const float* xore, const float* xoim,
                                 float scale, int device, void* stream) {
  Schedule sch{};
  if (!odd_fits(n, m) || batch <= 0 || !block_fits(m, cols, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = make_schedule(m, nstages, radices, &sch);
  if (err != 0) return err;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(m) * cols;
  auto kern = threads <= 512 ? irfft_odd_unpack_c64<512>
                             : irfft_odd_unpack_c64<kMaxThreads>;
  err = prepare_launch(kern, smem, device);
  if (err != 0) return err;
  const int half = (batch + 1) / 2;
  const dim3 grid((half + cols - 1) / cols);
  const ChirpZ<float> t{fwre, fwim, ivre, ivim, xtre, xtim, wtre, wtim, xore, xoim};
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xre, xim, y, n, m, batch, half, cols, sch, t, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
