// The warp-level complex product of the dense DFT kernels on the tensor
// cores of NVIDIA Hopper (sm_90a), in 3xTF32: the body of B9a
// (dft_mma.cu), written so that B9b's two phases can call it too.
//
// The product. A warp owns a 16-row m-tile of the planar complex left
// factor X (row-major, rows 16 apart in shared memory at stride ldx) and
// up to NT 8-column n-tiles of the output O = X * D^T, D planar complex and
// row-major (row k of D is column k of O), and accumulates
//   Or = Xr * Dr^T - Xi * Di^T,   Oi = Xr * Di^T + Xi * Dr^T
// over K (a multiple of 8) with mma.sync.aligned.m16n8k8.row.col.f32.tf32:
// four real products per complex one (not the three-product Gauss form,
// which loses accuracy), each in 3xTF32. A float v is split as hi =
// tf32(v) (cvt.rna: 10 mantissa bits, round to nearest, ties away) and lo =
// tf32(v - hi), and a real product is hi*hi + hi*lo + lo*hi, the lo*lo term
// (about 2^-22 of the product) dropped: close to a float product, where one
// TF32 product keeps about three decimal digits.
//
// The sums. A tensor-core product adds its eight products to the
// accumulator and rounds the result, not as a float add does (rounding
// toward zero has been measured on earlier parts), so a long chain of
// products into one accumulator can drift. The hi*hi products of each
// 8-wide step therefore go into an accumulator started at zero, which a
// float add joins to the output's total; the six small cross products
// (hi*lo and lo*hi, some 2^-11 of the total) run in accumulators of their
// own across the whole of K and join the total at the end.
//
// Fragments (PTX ISA, mma.m16n8k8 with .tf32): lane = 4*g + c. A holds
// rows g and g+8 at columns c and c+4 of the 8-wide step; B (a row of D
// per output column) holds D row g at columns c and c+4; the accumulator
// holds rows g and g+8 at columns 2c and 2c+1. With strides ldx and ldd
// equal to 4 mod 8 words, the eight rows a fragment load reads fall on
// eight distinct groups of four banks: no bank conflict.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// tf32(v) as cvt.rna does it: the float with its low 13 mantissa bits
// rounded off, to nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo + O(2^-22 v), hi and lo TF32.
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// acc (16 x 8 f32 fragment) += a (16 x 8 TF32) * b (8 x 8 TF32).
__device__ __forceinline__ void mma_tf32(float (&acc)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t tf32_neg(uint32_t v) { return v ^ 0x80000000u; }

// The warp's O fragments, NT n-tiles of planar complex accumulators.
template <int NT>
struct WarpCTile {
  float re[NT][4];
  float im[NT][4];
};

// O[j] = X (16 x K) * D_j^T for the warp's n-tiles j < `ntiles` (<= NT): D_j
// the 8 rows of D from `dre`/`dim` + j * `dstep` rows on, X's 16 rows from
// `xre`/`xim` on. Strides `ldx` and `ldd` are in floats; K is a multiple
// of 8 and the entries of X and D in columns K.. are never read. `lane` is
// the lane of the calling thread; all 32 lanes of the warp call it with the
// same arguments otherwise. With `Guard`, X's rows from `x_rows` on, D's
// rows (j * dstep + g) from `d_rows` on and both factors' columns from
// `k_valid` on are read as zeros, never loaded: unpadded tables in global
// memory.
template <int NT, bool Guard = false>
__device__ __forceinline__ void warp_cmma_3xtf32(const float* xre, const float* xim,
                                                 int ldx, const float* dre,
                                                 const float* dim, int ldd,
                                                 int dstep, int ntiles, int k_len,
                                                 int lane, WarpCTile<NT>& out,
                                                 int x_rows = 0, int d_rows = 0,
                                                 int k_valid = 0) {
  const int g = lane >> 2, c = lane & 3;
  const auto load = [](const float* p, bool ok) { return !Guard || ok ? *p : 0.f; };
  float small_re[NT][4], small_im[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out.re[j][e] = out.im[j][e] = 0.f;
      small_re[j][e] = small_im[j][e] = 0.f;
    }
  }
  const float* xr0 = xre + g * ldx + c;
  const float* xi0 = xim + g * ldx + c;
#pragma unroll 1
  for (int k0 = 0; k0 < k_len; k0 += 8) {
    // A fragments of Xr, Xi and -Xi, hi and lo.
    uint32_t ar_hi[4], ar_lo[4], ai_hi[4], ai_lo[4], ni_hi[4], ni_lo[4];
    const int offs[4] = {k0, 8 * ldx + k0, k0 + 4, 8 * ldx + k0 + 4};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = g + 8 * (e & 1) < x_rows && k0 + c + 4 * (e >> 1) < k_valid;
      tf32_split(load(xr0 + offs[e], ok), ar_hi[e], ar_lo[e]);
      tf32_split(load(xi0 + offs[e], ok), ai_hi[e], ai_lo[e]);
      ni_hi[e] = tf32_neg(ai_hi[e]);
      ni_lo[e] = tf32_neg(ai_lo[e]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= ntiles) break;
      const int row = (j * dstep + g) * ldd + k0 + c;
      const bool in_row = j * dstep + g < d_rows;
      const bool ok0 = in_row && k0 + c < k_valid, ok1 = in_row && k0 + c + 4 < k_valid;
      uint32_t br_hi[2], br_lo[2], bi_hi[2], bi_lo[2];
      tf32_split(load(dre + row, ok0), br_hi[0], br_lo[0]);
      tf32_split(load(dre + row + 4, ok1), br_hi[1], br_lo[1]);
      tf32_split(load(dim + row, ok0), bi_hi[0], bi_lo[0]);
      tf32_split(load(dim + row + 4, ok1), bi_hi[1], bi_lo[1]);
      // The hi*hi products of this step, from zero.
      float big_re[4] = {0.f, 0.f, 0.f, 0.f}, big_im[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(big_re, ar_hi, br_hi);
      mma_tf32(big_re, ni_hi, bi_hi);
      mma_tf32(big_im, ar_hi, bi_hi);
      mma_tf32(big_im, ai_hi, br_hi);
      // The cross products, across all of K.
      mma_tf32(small_re[j], ar_lo, br_hi);
      mma_tf32(small_re[j], ar_hi, br_lo);
      mma_tf32(small_re[j], ni_lo, bi_hi);
      mma_tf32(small_re[j], ni_hi, bi_lo);
      mma_tf32(small_im[j], ar_lo, bi_hi);
      mma_tf32(small_im[j], ar_hi, bi_lo);
      mma_tf32(small_im[j], ai_lo, br_hi);
      mma_tf32(small_im[j], ai_hi, br_lo);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out.re[j][e] += big_re[e];
        out.im[j][e] += big_im[e];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out.re[j][e] += small_re[j][e];
      out.im[j][e] += small_im[j][e];
    }
  }
}

}  // namespace
