// Clustered-block Stockham engine for NVIDIA Hopper sm_90a: the stage code
// of the redesigned kernels B1 (fft_pair.cu), B2 (bluestein_pair.cu), B3
// (four_step_pair.cu), B4a (rfft_pack_pair.cu), B4b (irfft_unpack_pair.cu),
// B5a (rfft_odd_pair.cu) and B5b (irfft_odd_pair.cu), all float, and B6
// (fft_pair_dd.cu) and B7 (stockham_vpu_dd.cu), double. B1-B6 at the sizes
// their clustered bodies do not cover keep the stage code of
// stockham_stages.cuh; this header reuses its butterflies. fft_pair (B1, B3,
// B6) and bluestein_pair (B2, B5a, B5b, B7) take an I/O policy: the engine's
// passes and walk, each kernel's own tiles, copies and stores.
//
// The layout. A column group is 32 bytes of a row (8 float or 4 double
// columns): a copy-only probe on an H100 moved a (2048, 32768) f32 plane in
// 0.663 ms through 16-byte row runs and in 0.272 ms through 32-byte ones,
// so no tile reads a run narrower than 32 bytes. A whole M-point column
// group of 32-byte runs does not fit a block twice over at M = 2048, so the
// C blocks of a thread-block cluster (C = 2 or 4) share it, h = M/C rows a
// block. The first radix-C step runs across the cluster:
//   v_r[p] = W_M^(r*p) * sum_s a_s[p] * W_C^(r*s),   FFT_h(v_r) = X[C*k + r],
// with a_s[p] = input row s*h + p. For C = 2 that is u = a + b and v = (a -
// b) * W_M^p. Rank r then runs an independent h-point Stockham transform
// over v_r, its own tile of h rows, so each block holds one tile in each of
// two buffers: at h = 1024, 2 x 64 KiB in f32 (8 columns) and in f64 (4
// columns); B1 and B6 take C = 4 for n in (2048, 4096].
// Where h is smaller, a tile takes several
// adjacent groups, up to kPairPoints points a thread. The split twiddles
// W_M^(r*p), r = 1..C-1, are the (C-1)*h entries before the pass tables
// (pair_tables in ops/cuda/stockham_vpu.py).
//
// fft_pair's split pushes (pair_push_split). Rank r copies the rows s*h + p
// of every block s for p in its share [r*h/C, (r+1)*h/C) (push_row), so it
// holds all C inputs of the butterflies at its p; it forms every output
// v_s[p] and stores it to rank s's buffer at row p, 16-byte
// st.shared::cluster stores of adjacent columns, one of the C destinations
// its own. (C-1)/C of each tile crosses the cluster once: 3/4 of 64 KiB a
// block and tile at n = 4096, 402,653,184 bytes a 4096 x 16384 call. The
// chirp-z bodies (bluestein_pair) and B1s (fft_pair_strided.cu) still read
// their split's inputs from the partners' buffers, point by point.
//
// Persistent clusters. The grid is as many clusters as fit on the card at
// once (cudaOccupancyMaxActiveClusters), and cluster c walks the column
// groups c, c + clusters, ...; while the passes run on one buffer,
// cp.async brings the next group into the other (16-byte copies, one
// commit group a tile, cp.async.wait_group 1 before use), so every load of
// a tile is in flight at once and overlaps the previous tile's passes. A
// ragged batch (B not a multiple of the 16-byte chunk, or a misaligned
// pointer) copies element by element instead; columns past B are never
// copied or stored, and each column's transform reads only its own column.
// fft_pair's split reads its inputs from its own buffer, arrives at a
// cluster barrier, forms its outputs, and waits there before it stores any
// to a partner, so no rank overwrites inputs that their rank has yet to
// read; a second cluster barrier opens the first pass. A split that reads
// the partners' buffers synchronises the cluster after its reads and before
// its stores (`sy0` of pair_passes), so no rank overwrites a buffer, or
// copies the next tile into one, that a partner still reads.
//
// The passes. The h-point schedule, fixed at compile time for each h a
// kernel is built for (pair_radix; pass_schedule in
// ops/cuda/stockham_vpu.py), takes a power of two in radix-16 passes and
// one of 8, 4 or 2 (1024 = 16*16*4); other sizes put their radix-3 and -5
// passes first (960 = 3*5*8*8). A pass is one
// shared-memory exchange: each thread loads its butterflies' points into
// registers, the block synchronises, then it butterflies, twiddles and
// stores them. Every pass is inlined at its radix and stride, with no
// switch and no division at run time; the tile's columns are a power of
// two, so indices are shifts. Rows are swizzled inside each 128-byte line
// (swizzle_row) so that the strided stores of the first passes fall on
// distinct banks. The schedule is a template argument, not a loop with a
// switch on the radix: such a loop keeps every radix's code, several times
// over, in one kernel, and its index arithmetic live across the walk over
// tiles, and was no faster than the stage body.
//
// Registers. A float body has 512 threads and so at most 128 registers a
// thread (a double body, B6 and B7, has 256 threads, 16 points a thread
// too, and up to 255), and the passes of the mixed-radix heights use
// nearly all of them:
// any value kept live across the passes can make ptxas spill. So the thread
// index, the block's rank, the cluster's index and the grid's clusters are
// read where they are used, through volatile asm (thread_x, cluster_rank,
// cluster_id, cluster_count), and a partner's tile is read or written at a
// 32-bit shared::cluster address made where it is used (cluster_addr,
// load_cluster, store_cluster16), not through 64-bit generic pointers held
// across the tile.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"
#include "stockham_stages.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kPairPoints = 16;  // points a thread holds in a pass
constexpr int kPairRunBytes = 32;  // a column group's row run

template <typename T>
constexpr T kC16 = static_cast<T>(0.92387953251128675613);  // cos(pi/8)
template <typename T>
constexpr T kS16 = static_cast<T>(0.38268343236508977173);  // sin(pi/8)

template <typename T>
__device__ __forceinline__ void cmul(T& r, T& i, T wr, T wi) {
  const T a = r;
  r = a * wr - i * wi;
  i = a * wi + i * wr;
}

// In-place 16-point DFT, natural order in and out: four radix-4 DFTs over
// n = 4*n1 + n2 (along n1), the twiddles W_16^(n2*k1), four radix-4 DFTs
// along n2, and the 4x4 transpose to k = k1 + 4*k2 as a renaming.
template <bool F, typename T>
__device__ __forceinline__ void butterfly16(T (&r)[16], T (&i)[16]) {
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {
    b4<F>(r[n2], i[n2], r[4 + n2], i[4 + n2], r[8 + n2], i[8 + n2], r[12 + n2],
          i[12 + n2]);
  }
  // Position 4*k1 + n2 holds A[n2][k1]; W_16^e = cos(2*pi*e/16) + s*i*sin.
  const T s = F ? static_cast<T>(-1) : static_cast<T>(1);
  const T c16 = kC16<T>, s16 = kS16<T>, c8 = kC8<T>;
  cmul(r[5], i[5], c16, s * s16);     // e = 1
  cmul(r[6], i[6], c8, s * c8);       // e = 2
  cmul(r[9], i[9], c8, s * c8);       // e = 2
  cmul(r[7], i[7], s16, s * c16);     // e = 3
  cmul(r[13], i[13], s16, s * c16);   // e = 3
  {                                   // e = 4: times s*i
    const T a = r[10];
    r[10] = -s * i[10];
    i[10] = s * a;
  }
  cmul(r[11], i[11], -c8, s * c8);    // e = 6
  cmul(r[14], i[14], -c8, s * c8);    // e = 6
  cmul(r[15], i[15], -c16, -s * s16);  // e = 9
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    b4<F>(r[4 * k1], i[4 * k1], r[4 * k1 + 1], i[4 * k1 + 1], r[4 * k1 + 2],
          i[4 * k1 + 2], r[4 * k1 + 3], i[4 * k1 + 3]);
  }
  T tr[16], ti[16];
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      tr[k1 + 4 * k2] = r[4 * k1 + k2];
      ti[k1 + 4 * k2] = i[4 * k1 + k2];
    }
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    r[e] = tr[e];
    i[e] = ti[e];
  }
}

template <int R, bool F, typename T>
__device__ __forceinline__ void pair_butterfly(T (&r)[R], T (&i)[R]) {
  if constexpr (R == 16) {
    butterfly16<F>(r, i);
  } else {
    butterfly<R, F>(r, i);
  }
}

// The pass schedule of an h-point transform, h = 2^a * 3^b * 5^c with
// a = 4q + r. A power of two takes q passes of 16 and one of 2^r (none when
// r = 0). Otherwise b passes of 3 and c of 5 come first, then one of 2^r and
// q of 16, or 8, 8 and q - 1 of 16 where r = 2: with 16s first or a 4
// beside the 3s and 5s, ptxas spilled some of B4a's 512-thread bodies
// (h = 960 at every order tried).
__host__ __device__ constexpr int pair_exponent(int h, int p) {
  int e = 0;
  while (h % p == 0) {
    h /= p;
    ++e;
  }
  return e;
}

__host__ __device__ constexpr int pair_npasses(int h) {
  const int a = pair_exponent(h, 2);
  return a / 4 + (a % 4 ? 1 : 0) + pair_exponent(h, 3) + pair_exponent(h, 5);
}

__host__ __device__ constexpr int pair_radix(int h, int s) {
  const int a = pair_exponent(h, 2), b = pair_exponent(h, 3), c = pair_exponent(h, 5);
  const int q = a / 4, r = a % 4;
  if (b + c == 0) return s < q ? 16 : (1 << r);
  if (s < b) return 3;
  if (s < b + c) return 5;
  s -= b + c;
  if (r == 2 && q > 0) return s < 2 ? 8 : 16;
  if (r > 0) {
    if (s == 0) return 1 << r;
    --s;
  }
  return 16;
}

// Stride (product of the earlier radices) and offset in the pass tables of
// pass s.
__host__ __device__ constexpr int pair_stride(int h, int s) {
  int v = 1;
  for (int t = 0; t < s; ++t) v *= pair_radix(h, t);
  return v;
}

__host__ __device__ constexpr int pair_tw_off(int h, int s) {
  int off = 0, size = h;
  for (int t = 0; t < s; ++t) {
    if (size / pair_radix(h, t) > 1) off += size;
    size /= pair_radix(h, t);
  }
  return off;
}

// Columns of a tile of h rows: the most 32-byte groups of `itemsize`-byte
// values whose points `threads` threads cover at kPairPoints each, except
// that an h that is not a power of two keeps one group where two (64-byte
// rows) would fit: B4a's body spilled at h = 480 with two, at every pass
// order tried.
__host__ __device__ constexpr int pair_cols(int itemsize, int threads, int h) {
  int c = kPairRunBytes / itemsize;
  while (2 * h * c <= kPairPoints * threads) c *= 2;
  if (c * itemsize == 2 * kPairRunBytes && (h & (h - 1)) != 0) c /= 2;
  return c;
}

// A block's tile: H rows of pair_cols columns; row r is stored at
// swizzle_row(r) * cols in each plane.
template <typename T, int Threads, int H>
struct PairTile {
  static constexpr int kRows = H;
  static constexpr int kCols = pair_cols(static_cast<int>(sizeof(T)), Threads, H);
  static constexpr int kLogC = pair_exponent(kCols, 2);
  // log2 of the rows in a 128-byte line: 2 for 32-byte rows, 1 for 64, 0
  // from 128 bytes up.
  static constexpr int kRowBytes = kCols * static_cast<int>(sizeof(T));
  static constexpr int kRplLog = kRowBytes >= 128 ? 0 : (kRowBytes == 64 ? 1 : 2);
  static_assert(H % (1 << kRplLog) == 0, "rows fill whole lines");
  static_assert(H * kCols <= kPairPoints * Threads, "threads cover the tile");

  // Row r moves inside its 128-byte line by the XOR of the line index's
  // 2-bit digits (4 rows a line) or its parity (2 rows a line), so rows 2^t
  // apart that one warp stores land in distinct positions of their lines.
  static __device__ __forceinline__ int swizzle_row(int row) {
    if constexpr (kRplLog == 0) {
      return row;
    } else if constexpr (kRplLog == 1) {
      return row ^ (__popc(row >> 1) & 1);
    } else {
      int fold = row >> 2;
      fold ^= fold >> 8;
      fold ^= fold >> 4;
      fold ^= fold >> 2;
      return row ^ (fold & 3);
    }
  }

  static __device__ __forceinline__ int index(int row, int col) {
    return (swizzle_row(row) << kLogC) + col;
  }
};

// threadIdx.x, read where it is used: a read the compiler cannot hoist, so
// that the index arithmetic of every pass, copy and store is not lifted out
// of the walk over tiles and kept live (spilled) across it.
__device__ __forceinline__ int thread_x() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// Default pass hooks: a plane load from the block's own tile, the block
// barrier, and no store hook.
template <class Tile, typename T>
struct TileLoad {
  const T* sre;
  const T* sim;
  __device__ __forceinline__ void operator()(int row, int col, T& re, T& im) const {
    const int e = Tile::index(row, col);
    re = sre[e];
    im = sim[e];
  }
};

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

struct NoHook {
  template <typename T>
  __device__ __forceinline__ void operator()(int, int, T&, T&) const {}
};

// One radix-R Stockham pass over the tile, in place: the input viewed as
// (R, size/R, Stride) at (k, i, j) is read through `ld` into registers,
// `sy` synchronises, then each butterfly along k is computed, output k is
// multiplied by W_size^(i*k) (`twre`/`twim`, unless the pass is the last),
// passed through `hook` and stored at ((i*R + k)*Stride + j); the pass ends
// with a block barrier.
template <int R, int Stride, bool Twiddle, bool F, class Tile, int Threads,
          typename T, class Ld, class Sy, class Hook>
__device__ __forceinline__ void pair_pass(T* sre, T* sim,
                                          const T* __restrict__ twre,
                                          const T* __restrict__ twim,
                                          const Ld& ld, const Sy& sy,
                                          const Hook& hook) {
  constexpr int kBlk = Tile::kRows / R;
  constexpr int kButterflies = kBlk << Tile::kLogC;
  // Butterflies a thread: no more than the tile needs, so a radix-3 or -5
  // pass over a tile of fewer than kPairPoints * Threads points holds no
  // idle registers (at most 16 points at radix 16, 8, 4 and 2, 18 and 20 at
  // 3 and 5).
  constexpr int NB = (kButterflies + Threads - 1) / Threads;
  constexpr int kMask = Tile::kCols - 1;
  const int tid = thread_x();
  T xr[NB][R], xi[NB][R];
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int id = tid + q * Threads;
    if (id < kButterflies) {
      const int col = id & kMask, p = id >> Tile::kLogC;
#pragma unroll
      for (int k = 0; k < R; ++k) ld(k * kBlk + p, col, xr[q][k], xi[q][k]);
    }
  }
  sy();
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int id = tid + q * Threads;
    if (id < kButterflies) {
      const int col = id & kMask, p = id >> Tile::kLogC;
      const int i = p / Stride, j = p - i * Stride;
      pair_butterfly<R, F>(xr[q], xi[q]);
      if constexpr (Twiddle) {
#pragma unroll
        for (int k = 1; k < R; ++k) {
          cmul(xr[q][k], xi[q][k], __ldg(twre + i * R + k), __ldg(twim + i * R + k));
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int row = (i * R + k) * Stride + j;
        hook(row, col, xr[q][k], xi[q][k]);
        const int e = Tile::index(row, col);
        sre[e] = xr[q][k];
        sim[e] = xi[q][k];
      }
    }
  }
  __syncthreads();
}

// Passes S.. of the tile's H-point transform: the first reads through
// `ld0` and synchronises with `sy0` (the cross-block split), the last
// stores through `hook`; the tile is complete when it returns. `twre` and
// `twim` hold the pass tables from entry Off on (after the split
// twiddles).
template <int S, bool F, class Tile, int Threads, int Off, typename T, class Ld0,
          class Sy0, class Hook>
__device__ __forceinline__ void pair_passes(T* sre, T* sim,
                                            const T* __restrict__ twre,
                                            const T* __restrict__ twim,
                                            const Ld0& ld0, const Sy0& sy0,
                                            const Hook& hook) {
  constexpr int H = Tile::kRows;
  constexpr int kPasses = pair_npasses(H);
  static_assert(kPasses >= 2, "the first pass is not the last");
  if constexpr (S < kPasses) {
    constexpr int R = pair_radix(H, S), St = pair_stride(H, S);
    constexpr int off = Off + pair_tw_off(H, S);
    constexpr bool last = S == kPasses - 1;
    const TileLoad<Tile, T> ld{sre, sim};
    if constexpr (S == 0) {
      pair_pass<R, St, true, F, Tile, Threads>(sre, sim, twre + off, twim + off,
                                               ld0, sy0, NoHook{});
    } else if constexpr (last) {
      pair_pass<R, St, false, F, Tile, Threads>(sre, sim, twre + off, twim + off,
                                                ld, BlockSync{}, hook);
    } else {
      pair_pass<R, St, true, F, Tile, Threads>(sre, sim, twre + off, twim + off,
                                               ld, BlockSync{}, NoHook{});
    }
    pair_passes<S + 1, F, Tile, Threads, Off>(sre, sim, twre, twim, ld0, sy0, hook);
  }
}

// A 16-byte store of 4 float or 2 double values.
__device__ __forceinline__ void store16(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(double* dst, const double (&v)[2]) {
  *reinterpret_cast<double2*>(dst) = make_double2(v[0], v[1]);
}

// The 32-bit shared::cluster address of `p`, a location in this block's
// shared memory, in the shared memory of the cluster's block `rank` (mapa),
// and a load from such an address (distributed shared memory). Volatile
// asm: a load does not move across a cluster barrier, and an address is made
// where it is read, not kept live (spilled) across the passes.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(rank));
  return d;
}

__device__ __forceinline__ void load_cluster(unsigned addr, float& v) {
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr));
}

__device__ __forceinline__ void load_cluster(unsigned addr, double& v) {
  asm volatile("ld.shared::cluster.f64 %0, [%1];" : "=d"(v) : "r"(addr));
}

template <typename T>
__device__ __forceinline__ T load_cluster(unsigned addr) {
  T v;
  load_cluster(addr, v);
  return v;
}

// The block's rank in its cluster, the cluster's index in the grid and the
// grid's clusters, read where they are used (volatile, like thread_x()), so
// that neither they nor what is derived from them is kept live across the
// passes of the clustered bodies.
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_id() {
  int r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_count() {
  int r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}

// A 16-byte store of 4 float or 2 double values to a shared::cluster
// address (cluster_addr), a partner's buffer or this block's own.
__device__ __forceinline__ void store_cluster16(unsigned addr, const float (&v)[4]) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

__device__ __forceinline__ void store_cluster16(unsigned addr, const double (&v)[2]) {
  asm volatile("st.shared::cluster.v2.f64 [%0], {%1, %2};" ::"r"(addr), "d"(v[0]),
               "d"(v[1])
               : "memory");
}

// The rows of fft_pair's push split: rank `rank` of C takes p in its share
// [rank*Q, (rank+1)*Q), Q = H/C, of each block s of the tile's C*H input
// rows, and copies input row s*H + p to its buffer's row s*Q + (p -
// rank*Q). The input row that its buffer's row `l` holds.
template <int C, int H>
__device__ __forceinline__ int push_row(int l, int rank) {
  constexpr int Q = H / C;
  static_assert(H % C == 0, "the ranks share a block's rows evenly");
  return l + (l / Q) * (H - Q) + rank * Q;
}

// A 16-byte load from shared memory of 4 float or 2 double values.
__device__ __forceinline__ void load16(const float* src, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load16(const double* src, double (&v)[2]) {
  const double2 a = *reinterpret_cast<const double2*>(src);
  v[0] = a.x;
  v[1] = a.y;
}

// The default input and output of fft_pair (B1, B6): the planar (n, B)
// input and output planes, B = `batch`, whose column groups of kCols the
// clusters walk (`tiles`). Rank r copies the rows of its split's share of
// a tile's columns into its own buffer (`fetch`, push_row), the split reads
// them as they are (`weight` is the identity, `prepare` does nothing), and
// rank r stores row k of its finished tile to output row C*k + r, times
// `scale` (`store`); `vec`: 16-byte copies and stores. A kernel that reads
// or writes other planes (B3's four-step row leg, four_step_pair.cu)
// passes its own policy with these five members.
template <typename T>
struct PlanePolicy {
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));  // values a chunk
  static constexpr int kLogV = pair_exponent(kV, 2);
  const T* xre;
  const T* xim;
  T* yre;
  T* yim;
  int batch;
  size_t bs;  // the row stride B, widened once
  T scale;
  int vec;

  __device__ __forceinline__ PlanePolicy(const T* xre_, const T* xim_, T* yre_,
                                         T* yim_, int batch_, T scale_, int vec_)
      : xre(xre_), xim(xim_), yre(yre_), yim(yim_), batch(batch_),
        bs(static_cast<size_t>(batch_)), scale(scale_), vec(vec_) {}

  template <class Tile>
  __device__ __forceinline__ int tiles() const {
    return (batch + Tile::kCols - 1) >> Tile::kLogC;
  }

  // Input row push_row(row) of both planes into row `row` (0..H-1), for
  // the columns of tile t below B. The copy loops are not unrolled:
  // unrolled, ptxas spilled a register of four of B1's sixty bodies.
  template <class Tile, int Threads, int C, int H>
  __device__ __forceinline__ void fetch(int t, T* sre, T* sim) const {
    constexpr int cols = Tile::kCols, logc = Tile::kLogC;
    const int b0 = t << logc;
    const int rank = cluster_rank();
    if (vec) {
      constexpr int lc = logc - kLogV;  // a row is 1 << lc 16-byte chunks
#pragma unroll 1
      for (int e = thread_x(); e < (2 * H) << lc; e += Threads) {
        const int c = (e & ((1 << lc) - 1)) << kLogV, rr = e >> lc;
        if (b0 + c < batch) {
          const int row = rr >> 1;
          copy_async<16>(
              (rr & 1 ? sim : sre) + Tile::index(row, c),
              (rr & 1 ? xim : xre) + push_row<C, H>(row, rank) * bs + b0 + c);
        }
      }
    } else {
#pragma unroll 1
      for (int e = thread_x(); e < (2 * H) << logc; e += Threads) {
        const int col = e & (cols - 1), rr = e >> logc;
        if (b0 + col < batch) {
          const int row = rr >> 1;
          copy_async<static_cast<int>(sizeof(T))>(
              (rr & 1 ? sim : sre) + Tile::index(row, col),
              (rr & 1 ? xim : xre) + push_row<C, H>(row, rank) * bs + b0 + col);
        }
      }
    }
  }

  // After this thread's copies of tile t have landed and before the split
  // reads them: nothing.
  template <class Tile, int Threads, int C, int H>
  __device__ __forceinline__ void prepare(int, T*, T*) const {}

  // Rank s's row `row` of tile t, as the split reads it: as copied.
  template <int H>
  __device__ __forceinline__ void weight(int, int, int, T&, T&) const {}

  // Row k of this rank's finished tile t holds X[C*k + rank]: output row
  // C*k + rank, times the scale.
  template <class Tile, int Threads, int C, int H>
  __device__ __forceinline__ void store(int t, const T* sre, const T* sim) const {
    constexpr int cols = Tile::kCols, logc = Tile::kLogC;
    const int b0 = t << logc;
    if (vec) {
      constexpr int lc = logc - kLogV;
      for (int e = thread_x(); e < H << lc; e += Threads) {
        const int c = (e & ((1 << lc) - 1)) << kLogV, k = e >> lc;
        if (b0 + c >= batch) continue;
        const int s = Tile::index(k, c);
        T a[kV], b[kV], vr[kV], vi[kV];
        load16(sre + s, a);
        load16(sim + s, b);
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          vr[u] = a[u] * scale;
          vi[u] = b[u] * scale;
        }
        const size_t g = static_cast<size_t>(C * k + cluster_rank()) * bs + b0 + c;
        store16(yre + g, vr);
        store16(yim + g, vi);
      }
    } else {
      for (int e = thread_x(); e < H << logc; e += Threads) {
        const int col = e & (cols - 1), k = e >> logc;
        if (b0 + col >= batch) continue;
        const int s = Tile::index(k, col);
        const size_t g = static_cast<size_t>(C * k + cluster_rank()) * bs + b0 + col;
        yre[g] = sre[s] * scale;
        yim[g] = sim[s] * scale;
      }
    }
  }
};

// The radix-C step of the push split on column u of a thread's C inputs
// a_s (rows r, i), in place: output s = sum_t a_t * W_C^(s*t). For C = 4,
// u = a_0 + (-1)^s a_2 and w = a_1 + (-1)^s a_3, output u + W_4^s * w.
template <int C, int V, typename T>
__device__ __forceinline__ void split_butterfly(T (&r)[C][V], T (&i)[C][V], int u) {
  if constexpr (C == 2) {
    const T ar = r[0][u], ai = i[0][u];
    r[0][u] = ar + r[1][u];
    i[0][u] = ai + i[1][u];
    r[1][u] = ar - r[1][u];
    i[1][u] = ai - i[1][u];
  } else {
    const T u0r = r[0][u] + r[2][u], u0i = i[0][u] + i[2][u];
    const T u1r = r[0][u] - r[2][u], u1i = i[0][u] - i[2][u];
    const T w0r = r[1][u] + r[3][u], w0i = i[1][u] + i[3][u];
    const T w1r = r[1][u] - r[3][u], w1i = i[1][u] - i[3][u];
    r[0][u] = u0r + w0r;  // W_4^0 = 1
    i[0][u] = u0i + w0i;
    r[1][u] = u1r + w1i;  // W_4^1 = -i
    i[1][u] = u1i - w1r;
    r[2][u] = u0r - w0r;  // W_4^2 = -1
    i[2][u] = u0i - w0i;
    r[3][u] = u1r - w1i;  // W_4^3 = i
    i[3][u] = u1i + w1r;
  }
}

// fft_pair's cross-block radix-C split of tile t, pushed (see the top of
// this file). Rank r holds the input rows s*H + p, p in its share [r*Q,
// (r+1)*Q), Q = H/C, of every block s at its buffer's rows s*Q + p - r*Q
// (push_row). A thread takes one p and kV adjacent columns, a 16-byte chunk
// of a row: it reads the chunk of its C rows from its own buffer (16-byte
// loads) and weighs each point (`io.weight`); it arrives at a cluster
// barrier, forms every output v_s[p] = W_n^(s*p) * sum_t a_t[p] * W_C^(s*t)
// while the barrier completes, waits, and stores v_s[p] to rank s's buffer
// at row p (16-byte st.shared::cluster stores). A closing cluster barrier
// makes every output visible to its rank. Threads past the share's chunks
// (at h/C = 135 rows, 270 chunks at 8 columns) take no part. `twre`/`twim`
// hold the (C-1)*H split twiddles W_n^(s*p) (s = 1..C-1).
template <class Tile, int Threads, int C, int H, typename T, class IO>
__device__ __forceinline__ void pair_push_split(const IO& io, int t, T* sre, T* sim,
                                                const T* __restrict__ twre,
                                                const T* __restrict__ twim) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));  // columns a chunk
  constexpr int kLogV = pair_exponent(kV, 2);
  constexpr int kLogChunks = Tile::kLogC - kLogV;  // a row is 1 << kLogChunks chunks
  constexpr int Q = H / C;
  constexpr int kChunks = Q << kLogChunks;
  constexpr int NB = (kChunks + Threads - 1) / Threads;  // chunks a thread
  constexpr unsigned kItem = sizeof(T);
  T xr[NB][C][kV], xi[NB][C][kV];
  // Where every thread takes NB chunks, the test of `id` folds away: kept,
  // it cost ptxas spills at h = 1024 and 512. The barriers are the
  // intrinsics (arrive: release, wait: acquire), which spilled fewer
  // bodies than the same PTX instructions written as asm.
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int id = thread_x() + q * Threads;
    if (kChunks % Threads == 0 || id < kChunks) {
      const int j = id >> kLogChunks, c = (id & ((1 << kLogChunks) - 1)) << kLogV;
      const int p = cluster_rank() * Q + j;
#pragma unroll
      for (int s = 0; s < C; ++s) {
        const int e = Tile::index(s * Q + j, c);
        load16(sre + e, xr[q][s]);
        load16(sim + e, xi[q][s]);
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          io.template weight<H>(t, s, p, xr[q][s][u], xi[q][s][u]);
        }
      }
    }
  }
  __cluster_barrier_arrive();  // this rank has read its rows of tile t
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int id = thread_x() + q * Threads;
    if (kChunks % Threads == 0 || id < kChunks) {
      const int p = cluster_rank() * Q + (id >> kLogChunks);
#pragma unroll
      for (int u = 0; u < kV; ++u) split_butterfly<C, kV>(xr[q], xi[q], u);
#pragma unroll
      for (int s = 1; s < C; ++s) {
        const T wr = __ldg(twre + (s - 1) * H + p), wi = __ldg(twim + (s - 1) * H + p);
#pragma unroll
        for (int u = 0; u < kV; ++u) cmul(xr[q][s][u], xi[q][s][u], wr, wi);
      }
    }
  }
  __cluster_barrier_wait();  // every rank has read its rows: the buffers take outputs
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int id = thread_x() + q * Threads;
    if (kChunks % Threads == 0 || id < kChunks) {
      const int c = (id & ((1 << kLogChunks) - 1)) << kLogV;
      const int p = cluster_rank() * Q + (id >> kLogChunks);
      const unsigned off = kItem * static_cast<unsigned>(Tile::index(p, c));
#pragma unroll
      for (int s = 0; s < C; ++s) {
        store_cluster16(cluster_addr(sre, s) + off, xr[q][s]);
        store_cluster16(cluster_addr(sim, s) + off, xi[q][s]);
      }
    }
  }
  __cluster_barrier_arrive();  // every output of tile t is in its rank's buffer
  __cluster_barrier_wait();
}

// The clustered-block body of B1 (float, fft_pair.cu), B6 (double,
// fft_pair_dd.cu) and B3 (float, four_step_pair.cu): the forward DFT of
// every column of a tile of n = C*H rows. The policy `io` (PlanePolicy above
// for B1 and B6) gives the tiles the clusters walk (`tiles`), copies the
// rows of rank r's share of tile t (push_row) into its own buffer (`fetch`,
// cp.async), may pass over the landed rows before the split (`prepare`),
// weighs block s's row p as the split reads it (`weight`), and stores the
// finished tile, whose row k holds X[C*k + r] on rank r (`store`). The
// split (pair_push_split) leaves rank r's buffer holding v_r, and the
// passes read only the block's own buffer. `twre`/`twim`: the (C-1)*H split
// twiddles W_n^(r*p) (rank r = 1..C-1, p < H), then the pass tables. The
// inverse is this body on the planes exchanged (the host swaps the
// pointers).
template <typename T, int Threads, int C, int H, class IO>
__device__ __forceinline__ void fft_pair(const IO& io, const T* __restrict__ twre,
                                         const T* __restrict__ twim) {
  using Tile = PairTile<T, Threads, H>;
  constexpr int plane = H * Tile::kCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int ntiles = io.template tiles<Tile>();
  int buf = 0;
  int t = cluster_id();
  if (t < ntiles) io.template fetch<Tile, Threads, C, H>(t, smem, smem + plane);
  copy_commit();
  for (; t < ntiles; t += cluster_count(), buf ^= 1) {
    T* sre = smem + 2 * buf * plane;
    T* sim = sre + plane;
    if (t + cluster_count() < ntiles) {
      T* next = smem + 2 * (buf ^ 1) * plane;
      io.template fetch<Tile, Threads, C, H>(t + cluster_count(), next, next + plane);
    }
    copy_commit();
    copy_wait_previous();
    io.template prepare<Tile, Threads, C, H>(t, sre, sim);
    __syncthreads();  // every thread's copies of tile t are in this block's buffer
    pair_push_split<Tile, Threads, C, H>(io, t, sre, sim, twre, twim);
    pair_passes<0, true, Tile, Threads, (C - 1) * H>(
        sre, sim, twre, twim, TileLoad<Tile, T>{sre, sim}, BlockSync{}, NoHook{});
    io.template store<Tile, Threads, C, H>(t, sre, sim);
    __syncthreads();  // the next copy into this buffer follows the stores
  }
  // No partner reads or writes this block's shared memory after the last
  // split's closing barrier, so the block exits without another.
}

// The input rows [r0, r1) a rank of a chirp-z body copies: the n rows split
// at (n + 1) / 2.
__device__ __forceinline__ void pair_input_rows(int n, int& r0, int& r1) {
  const int n0 = (n + 1) / 2;
  const bool first = cluster_rank() == 0;
  r0 = first ? 0 : n0;
  r1 = first ? n0 : n;
}

// Input row `row` < n of column `col` of a chirp-z body's tile, read from the
// rank that copied it (pair_input_rows).
template <class Tile, typename T>
__device__ __forceinline__ void pair_input(int row, int col, const T* sre,
                                           const T* sim, int n, T& re, T& im) {
  constexpr unsigned kItem = sizeof(T);
  const unsigned e = kItem * Tile::index(row, col);
  const int src = row < (n + 1) / 2 ? 0 : 1;
  re = load_cluster<T>(cluster_addr(sre, src) + e);
  im = load_cluster<T>(cluster_addr(sim, src) + e);
}

// Row p of the chirp-z's M-point inverse at `width` (1 or kV) adjacent
// columns from tile offset `s` (bytes) on: (E[p] + W_M^-p * O[p]) * c, E
// from rank 0's finished tile (er, ei), O from rank 1's (o_r, o_i), (wr, wi)
// = W_M^-p and (cr, ci) = c, into the first `width` entries of (vr, vi).
template <typename T, int kV>
__device__ __forceinline__ void pair_join(unsigned er, unsigned ei, unsigned o_r,
                                          unsigned o_i, unsigned s, int width,
                                          T wr, T wi, T cr, T ci, T (&vr)[kV],
                                          T (&vi)[kV]) {
  constexpr unsigned kItem = sizeof(T);
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    if (u >= width) break;
    const unsigned su = s + kItem * u;
    T o_re = load_cluster<T>(o_r + su), o_im = load_cluster<T>(o_i + su);
    cmul(o_re, o_im, wr, wi);
    vr[u] = load_cluster<T>(er + su) + o_re;
    vi[u] = load_cluster<T>(ei + su) + o_im;
    cmul(vr[u], vi[u], cr, ci);
  }
}

// The default input and output of bluestein_pair (B2, B7): the planar
// (n, B) input and output planes, B = `batch`, whose B columns the clusters
// walk; each rank copies its half of the input rows at their rows in its
// own buffer (`fetch`), where the first pass reads them (`input`,
// pair_input), and each rank stores half of the output rows, times xo *
// `scale` (`store`); `vec`: 16-byte copies and stores. A kernel that reads
// or writes other planes (B5a's and B5b's two-for-one in rfft_odd_pair.cu
// and irfft_odd_pair.cu) passes its own policy with these four members.
template <typename T>
struct ChirpPlanes {
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));  // values a chunk
  static constexpr int kLogV = pair_exponent(kV, 2);
  static constexpr unsigned kItem = sizeof(T);
  const T* xre;
  const T* xim;
  T* yre;
  T* yim;
  int batch;
  T scale;
  int vec;

  __device__ __forceinline__ int columns() const { return batch; }

  // This rank's input rows of the columns b0.. of a tile into its buffer.
  template <class Tile, int Threads>
  __device__ __forceinline__ void fetch(int b0, int n, T* sre, T* sim) const {
    constexpr int cols = Tile::kCols, logc = Tile::kLogC;
    const size_t bs = static_cast<size_t>(batch);
    int r0, r1;
    pair_input_rows(n, r0, r1);
    if (vec) {
      constexpr int lc = logc - kLogV;  // a row is 1 << lc 16-byte chunks
      const int total = (2 * (r1 - r0)) << lc;
      for (int e = thread_x(); e < total; e += Threads) {
        const int c = (e & ((1 << lc) - 1)) << kLogV, rr = e >> lc;
        if (b0 + c < batch) {
          const int row = r0 + (rr >> 1);
          copy_async<16>((rr & 1 ? sim : sre) + Tile::index(row, c),
                         (rr & 1 ? xim : xre) + row * bs + b0 + c);
        }
      }
    } else {
      const int total = (2 * (r1 - r0)) << logc;
      for (int e = thread_x(); e < total; e += Threads) {
        const int col = e & (cols - 1), rr = e >> logc;
        if (b0 + col < batch) {
          const int row = r0 + (rr >> 1);
          copy_async<static_cast<int>(sizeof(T))>(
              (rr & 1 ? sim : sre) + Tile::index(row, col),
              (rr & 1 ? xim : xre) + row * bs + b0 + col);
        }
      }
    }
  }

  // Input row `row` < n of column `col`, from the rank that copied it.
  template <class Tile>
  __device__ __forceinline__ void input(int row, int col, const T* sre,
                                        const T* sim, int n, T& re, T& im) const {
    pair_input<Tile>(row, col, sre, sim, n, re, im);
  }

  // This block's output rows [r0, r1) of the columns b0.. of a tile.
  template <class Tile, int Threads>
  __device__ __forceinline__ void store(int b0, int n, T* sre, T* sim,
                                        const ChirpZ<T>& t) const {
    constexpr int logc = Tile::kLogC;
    const unsigned er = cluster_addr(sre, 0), ei = cluster_addr(sim, 0);
    const unsigned o_r = cluster_addr(sre, 1), o_i = cluster_addr(sim, 1);
    const size_t bs = static_cast<size_t>(batch);
    int r0, r1;
    pair_input_rows(n, r0, r1);
    const int lc = vec ? logc - kLogV : logc;
    const int width = vec ? kV : 1;
    const int total = (r1 - r0) << lc;
    for (int e = thread_x(); e < total; e += Threads) {
      const int c = (e & ((1 << lc) - 1)) * width, p = r0 + (e >> lc);
      if (b0 + c >= batch) continue;
      T vr[kV] = {}, vi[kV] = {};
      pair_join(er, ei, o_r, o_i, kItem * Tile::index(p, c), width,
                __ldg(t.ivre + p), __ldg(t.ivim + p), __ldg(t.xore + p) * scale,
                __ldg(t.xoim + p) * scale, vr, vi);
      const size_t g = static_cast<size_t>(p) * bs + b0 + c;
      if (vec) {
        store16(yre + g, vr);
        store16(yim + g, vi);
      } else {
        yre[g] = vr[0];
        yim[g] = vi[0];
      }
    }
  }
};

// The paired-block chirp-z body of B2 (float, bluestein_pair.cu), B7
// (double, stockham_vpu_dd.cu), B5a (float, rfft_odd_pair.cu) and B5b
// (float, irfft_odd_pair.cu) over M = 2H, on a pair of blocks. The input
// rows [0, n) are all in the first half of the padded column (n <= H), so
// the cross-block split has b = 0: rank 0 transforms u = a * xt, rank 1
// v = a * xt * W_M^row, rows n.. read as zeros, never copied. The policy
// `io` (ChirpPlanes above for B2 and B7) gives the columns the clusters
// walk (`columns`), copies a tile's input into a rank's buffer (`fetch`,
// cp.async), reads input row a < n of a column from the ranks' buffers for
// the first forward pass (`input`; ChirpPlanes: rows [0, (n+1)/2) copied on
// rank 0, the rest on rank 1, pair_input), and, once both ranks' inverse
// passes are done, stores the
// tile's output (`store`, which may read both ranks' tiles, rank 0 holding
// E and rank 1 O of the M-point inverse, and may write its own after a
// cluster barrier). The last forward pass stores times wt at frequency
// 2*row + rank. The t.fw* and t.iv* tables hold the H split twiddles of
// their direction, then the pass tables. The tile and passes of M = 2H are
// fixed at compile time.
template <typename T, int Threads, int H, class IO>
__device__ __forceinline__ void bluestein_pair(const IO& io, int n,
                                               const ChirpZ<T>& t) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  using Tile = PairTile<T, Threads, H>;
  constexpr int logc = Tile::kLogC, plane = H * Tile::kCols;
  // Cluster c walks tiles c, c + clusters, ...; its k-th tile is in
  // buffer k mod 2. The walk's state is the tile alone: the rest is read
  // again where it is used.
  if ((cluster_id() << logc) < io.columns()) {
    io.template fetch<Tile, Threads>(cluster_id() << logc, n, smem, smem + plane);
  }
  copy_commit();
  for (int tile = cluster_id(); (tile << logc) < io.columns();
       tile += cluster_count()) {
    const int buf = (tile / cluster_count()) & 1;
    T* sre = smem + 2 * buf * plane;
    T* sim = sre + plane;
    const int next_tile = tile + cluster_count();
    if ((next_tile << logc) < io.columns()) {
      T* next = smem + 2 * (buf ^ 1) * plane;
      io.template fetch<Tile, Threads>(next_tile << logc, n, next, next + plane);
    }
    copy_commit();
    copy_wait_previous();
    cluster.sync();  // both ranks' rows of the tile are in shared memory
    // Input row `row` times the input chirp (and W_M^row on rank 1).
    auto chirp_in = [&](int row, int col, T& re, T& im) {
      if (row >= n) {
        re = T(0);
        im = T(0);
        return;
      }
      io.template input<Tile>(row, col, sre, sim, n, re, im);
      cmul(re, im, __ldg(t.xtre + row), __ldg(t.xtim + row));
      if (cluster_rank() == 1) cmul(re, im, __ldg(t.fwre + row), __ldg(t.fwim + row));
    };
    auto split_done = [&] { cluster.sync(); };  // both read their input rows
    auto times_w = [&](int row, int, T& re, T& im) {
      const int f = 2 * row + cluster_rank();
      cmul(re, im, __ldg(t.wtre + f), __ldg(t.wtim + f));
    };
    pair_passes<0, true, Tile, Threads, H>(sre, sim, t.fwre, t.fwim, chirp_in,
                                           split_done, times_w);
    pair_passes<0, false, Tile, Threads, H>(sre, sim, t.ivre, t.ivim,
                                            TileLoad<Tile, T>{sre, sim},
                                            BlockSync{}, NoHook{});
    cluster.sync();  // both halves are complete
    io.template store<Tile, Threads>(tile << logc, n, sre, sim, t);
    cluster.sync();  // no copy into a buffer the partner still reads
  }
  cluster.sync();  // the partner may still read this block's tile
}

// The h = m/2 of each even m of B1's domain up to 2048 (46 sizes): the
// heights of B4a's bodies and of B1's two-block ones, and of B2's but 512
// (rfft_pack_geometry, fft_pair_geometry and bluestein_pair_geometry_c64 in
// ops/cuda/stockham_vpu.py; tests/test_torch_pair_kernels.py holds each
// list here equal to its Python one).
#define FOURIER_PAIR_ROWS(X)                                                  \
  X(32) X(36) X(40) X(48) X(60) X(64) X(72) X(80) X(96) X(100) X(108) X(120)  \
  X(128) X(144) X(160) X(180) X(192) X(200) X(216) X(240) X(256) X(288)       \
  X(300) X(320) X(324) X(360) X(384) X(400) X(432) X(480) X(500) X(512)       \
  X(540) X(576) X(600) X(640) X(648) X(720) X(768) X(800) X(864) X(900)       \
  X(960) X(972) X(1000) X(1024)

// The h = n/4 of the four-block bodies of B1 (fft_pair.cu) and B6
// (fft_pair_dd.cu): n in (2048, 4096] with n/4 in FOURIER_PAIR_ROWS
// (fft_pair_geometry in ops/cuda/stockham_vpu.py, fft_pair_geometry_dd in
// ops/cuda/stockham_vpu_dd.py). Their two-block bodies are
// FOURIER_PAIR_ROWS.
#define FOURIER_B1_QUAD_ROWS(X)                                               \
  X(540) X(576) X(600) X(640) X(648) X(720) X(768) X(800) X(864) X(900)       \
  X(960) X(972) X(1000) X(1024)

// The M/2 of the paired chirp-z bodies of B2 (bluestein_pair.cu):
// FOURIER_PAIR_ROWS but 512 (M = 1024), where ptxas spilled in the passes
// with every arrangement of the body that was tried, so the stage body
// stays the kernel there (bluestein_pair_geometry_c64 in
// ops/cuda/stockham_vpu.py). B5a's (rfft_odd_pair.cu) are these but 240.
#define FOURIER_B2_ROWS(X)                                                    \
  X(32) X(36) X(40) X(48) X(60) X(64) X(72) X(80) X(96) X(100) X(108) X(120)  \
  X(128) X(144) X(160) X(180) X(192) X(200) X(216) X(240) X(256) X(288)       \
  X(300) X(320) X(324) X(360) X(384) X(400) X(432) X(480) X(500) X(540)       \
  X(576) X(600) X(640) X(648) X(720) X(768) X(800) X(864) X(900) X(960)       \
  X(972) X(1000) X(1024)

// Host side. True when the caller's geometry is the compiled body's for
// h = `rows`: `cols` columns a tile, `threads` threads, and `npasses`
// radices (host memory) equal to pair_radix's.
template <typename T, int Threads>
inline bool pair_geometry_matches(int rows, int cols, int threads, int npasses,
                                  const int* radices) {
  if (rows < 1 || threads != Threads || npasses != pair_npasses(rows)) {
    return false;
  }
  if (cols != pair_cols(static_cast<int>(sizeof(T)), Threads, rows)) return false;
  for (int s = 0; s < npasses; ++s) {
    if (radices[s] != pair_radix(rows, s)) return false;
  }
  return true;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// The clusters of C blocks that `kern` keeps on the card at once with
// `threads` threads and `smem` bytes of dynamic shared memory a block, into
// `clusters`; fills `cfg` and `attr` for the launch. Returns a cudaError_t
// code, 0 on success.
template <int C, typename... Params>
int max_clusters(void (*kern)(Params...), int threads, size_t smem, int device,
                 void* stream, cudaLaunchConfig_t* cfg,
                 cudaLaunchAttribute* attr, int* clusters) {
  int err = prepare_launch(kern, smem, device);
  if (err != 0) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(C);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  *clusters = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(clusters, kern, cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  return *clusters > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// Launch `kern` as clusters of C blocks of `threads` threads with `smem`
// bytes of dynamic shared memory each, as many clusters as fit on the card
// at once and at most `ntiles`. Returns a cudaError_t code, 0 on success.
template <int C, typename... Params, typename... Args>
int launch_clusters(void (*kern)(Params...), int ntiles, int threads,
                    size_t smem, int device, void* stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int clusters = 0;
  int err = max_clusters<C>(kern, threads, smem, device, stream, &cfg, attr,
                            &clusters);
  if (err != 0) return err;
  cfg.gridDim = dim3(C * std::min(clusters, ntiles));
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
