// Kernel B1's clustered-block body on a complex64 tensor where it lies: the
// transform along one axis of a contiguous interleaved (re, im) tensor,
// read and written at the tensor's own strides, for NVIDIA Hopper (sm_90a),
// in a library of its own. The host function checks its arguments,
// launches on the caller's stream, neither allocates nor synchronises, and
// returns cudaGetLastError().
//
// Replaces no TPU kernel: the JAX package (fourier_tpu/ndim.py) runs each
// axis of an N-D transform through B1's batch-minor planes
// (fourier_tpu/ops/pallas/stockham_vpu.py:vpu_fft_batch_minor, :1208), and
// so did the port, with a copy an axis to split the complex tensor into
// planes and bring the axis to the front, a join back to complex64 and a
// multiply for the scale. Those passes took 37.8% of the device time of
// fft2/ifft2 on 32 images of 4096 x 4096 (14.4 ms of a 37.9 ms call on an
// H100 80GB HBM3 at 700 W). This body makes each axis one pass over the
// tensor and nothing else: the route of ndim.py's in-place passes
// (ops/cuda/stockham_vpu.py: vpu_fft_strided).
//
// What bounds it on this card: memory. One pass reads and writes the
// tensor once, 16 bytes a point (2.56 ms for 32 x 4096 x 4096 at 3.35
// TB/s), against 5*n*log2(n) flops a transform.
//
// The view. The tensor is (outer, n, inner) around the transformed axis.
// The sizes are B1's clustered ones (FOURIER_PAIR_ROWS and
// FOURIER_B1_QUAD_ROWS in stockham_pair.cuh: clusters of C = 2 or 4 blocks
// of h = n/C rows), with the engine's tile of h rows by kCols columns, its
// passes, split and tables (fft_pair of stockham_pair.cuh, whose walk
// this body follows with its own first read). Two layouts:
//   * a strided column (inner > 1, e.g. the first axis of fft2): a tile is
//     kCols adjacent columns i0.. of one outer index o, the tiles walked as
//     (o, column group); rank r copies rows [r*h, (r+1)*h) of it, each row
//     one run of kCols interleaved values (64 bytes at 8 columns) at the
//     row stride inner*8 bytes, into a row-major buffer;
//   * a contiguous row (inner = 1, the last axis): a tile is kCols adjacent
//     transforms, each one contiguous run of n values; rank r copies its h
//     contiguous values of each, consecutive threads on consecutive
//     16-byte chunks (rows 2m and 2m + 1) of one transform, into a buffer
//     that holds the chunks of the kCols columns of each m side by side,
//     in the order column XOR (m mod kCols), so that the copies of
//     consecutive m land on distinct banks. The loads run along the
//     transformed axis, and the transpose into the (row, column) tile
//     happens in shared memory.
// Both buffers hold interleaved (re, im) pairs in 16-byte copies (cp.async;
// 8-byte ones where the tensor or the inner extent is not 16-byte aligned).
// The first pass's split reads each partner's pair with one 8-byte
// distributed shared-memory load and stores the planar (re, im) tile the
// later passes run on over the buffer, after the cluster barrier that
// closes the split's reads. In both layouts the split's loads of 8 columns
// by 2 rows a half-warp are 128 contiguous bytes of a partner's buffer: a
// column-major buffer (columns padded apart onto distinct banks) took the
// first pass of (32 x 4096, 4096) from 5.8 to 10.2 ms, against the strided
// column's, on an H100 80GB HBM3 at 700 W. Each layout is a body of its
// own (the Rows template argument), so that neither carries the other's
// index arithmetic through the passes.

// The store. Rank r holds X[C*k + r] at row k of its tile, written times
// the scale to position C*k + r of the axis at the tensor's strides. In
// the strided-column layout rank r stores its own rows, runs of kCols
// values, 8 bytes a thread (16-byte stores of two values spilled registers
// at (4, 1024), (2, 640) and (2, 480) and were no faster). In the
// contiguous-row layout its rows are C values apart in memory: there rank
// r stores positions [r*h, (r+1)*h) of each transform instead, reading
// each from the rank that holds it after a cluster barrier, in 16-byte
// stores (one 8-byte store every C values, the ranks filling each sector
// between them, took 14.3 ms a pass of (32 x 4096, 4096) against 11.5, on
// an H100 80GB HBM3 at 700 W).
//
// The inverse is this body on conjugated data, IDFT(x) =
// conj(DFT(conj(x))): the split negates the imaginary part it reads and
// the store negates the one it writes (the scale's sign), so the forward
// tables serve both directions. A pass may run in place (y = x): every
// rank has copied its rows of a tile's columns before the cluster barrier
// that opens the split, the prefetched tile is another tile's columns, and
// no other cluster reads or writes the tile's columns.

#include "stockham_pair.cuh"

namespace {

constexpr int kThreads = 512;

// Waits until all of this thread's copies have landed.
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// An 8-byte load of a (re, im) pair from distributed shared memory.
__device__ __forceinline__ void load_cluster_pair(unsigned addr, float& re, float& im) {
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(re), "=f"(im)
               : "r"(addr));
}

// The tensor viewed as (outer, n, inner), n = C*H, and its tiles, in the
// contiguous-row layout (Rows: inner = 1) or the strided-column one. Every
// extent is read from the kernel's parameters where it is used.
template <int C, int H, bool Rows>
struct StridedC64 {
  using Tile = PairTile<float, kThreads, H>;
  static constexpr int kCols = Tile::kCols, kLogC = Tile::kLogC;
  const float* x;
  float* y;
  int outer;
  int inner;
  float scale;
  float scale_im;  // the scale, negated for the inverse
  float sign;      // 1, or -1 for the inverse: the split's conjugation
  int vec;

  // Column groups of one outer index (strided column).
  __device__ __forceinline__ int groups() const {
    return (inner + kCols - 1) >> kLogC;
  }

  __device__ __forceinline__ int tiles() const {
    return Rows ? (outer + kCols - 1) >> kLogC : outer * groups();
  }

  // The buffer slot (a pair) of row `row`, column `col` of a fetched tile:
  // row-major (strided column); or rows 2m and 2m + 1 of a column side by
  // side, the kCols columns of m in the order col XOR (m mod kCols) (the
  // 16-byte chunks of consecutive m of one column land on distinct banks)
  // (contiguous row).
  __device__ __forceinline__ static int slot(int row, int col) {
    if constexpr (Rows) {
      const int m = row >> 1;
      return (((m << kLogC) + (col ^ (m & (kCols - 1)))) << 1) + (row & 1);
    } else {
      return (row << kLogC) + col;
    }
  }

  // Rank r's rows [r*H, (r+1)*H) of tile t's columns into `buf`.
  __device__ __forceinline__ void fetch(int t, float* buf) const {
    const int r0 = cluster_rank() * H;
    constexpr int n = C * H;
    if constexpr (Rows) {
      // Columns o = t*kCols + c, each n contiguous values.
      const int o0 = t << kLogC;
      const size_t src = static_cast<size_t>(o0) * n + r0;
      if (vec) {  // 16-byte chunks: rows 2m and 2m + 1 of column c
        constexpr int half = H / 2;
#pragma unroll 1
        for (int e = thread_x(); e < kCols * half; e += kThreads) {
          const int c = e / half, m = e - c * half;
          if (o0 + c < outer) {
            copy_async<16>(buf + 2 * slot(2 * m, c),
                           x + 2 * (src + static_cast<size_t>(c) * n + 2 * m));
          }
        }
      } else {
#pragma unroll 1
        for (int e = thread_x(); e < kCols * H; e += kThreads) {
          const int c = e / H, row = e - c * H;
          if (o0 + c < outer) {
            copy_async<8>(buf + 2 * slot(row, c),
                          x + 2 * (src + static_cast<size_t>(c) * n + row));
          }
        }
      }
    } else {
      // Columns i0.. of outer index o, rows at stride inner.
      const int o = t / groups();
      const int i0 = (t - o * groups()) << kLogC;
      const size_t in = static_cast<size_t>(inner);
      const size_t src = (static_cast<size_t>(o) * n + r0) * in + i0;
      if (vec) {
        constexpr int lc = kLogC - 1;  // a row is 1 << lc 16-byte chunks
#pragma unroll 1
        for (int e = thread_x(); e < H << lc; e += kThreads) {
          const int c = (e & ((1 << lc) - 1)) << 1, row = e >> lc;
          if (i0 + c < inner) {
            copy_async<16>(buf + 2 * ((row << kLogC) + c),
                           x + 2 * (src + row * in + c));
          }
        }
      } else {
#pragma unroll 1
        for (int e = thread_x(); e < H << kLogC; e += kThreads) {
          const int c = e & (kCols - 1), row = e >> kLogC;
          if (i0 + c < inner) {
            copy_async<8>(buf + 2 * ((row << kLogC) + c), x + 2 * (src + row * in + c));
          }
        }
      }
    }
  }

  // Row k of rank s's finished planar tile t holds X[C*k + s], times the
  // scale at position C*k + s of the axis. Contiguous row (after a cluster
  // barrier): rank r stores positions [r*H, (r+1)*H) of each transform, the
  // pair j, j + 1 (j even) read from ranks j mod C and j mod C + 1 at row
  // j / C, so that each store is 16 contiguous bytes. Strided column: rank
  // r stores its own rows C*k + r, runs of kCols values.
  __device__ __forceinline__ void store(int t, const float* sre, const float* sim) const {
    constexpr int n = C * H;
    const int rank = cluster_rank();
    if constexpr (Rows) {
      const int o0 = t << kLogC;
      constexpr int half = H / 2;
#pragma unroll 1
      for (int e = thread_x(); e < kCols * half; e += kThreads) {
        const int c = e & (kCols - 1), j = rank * H + 2 * (e >> kLogC);
        if (o0 + c >= outer) continue;
        const int s = j % C, k = j / C;
        const unsigned off = 4u * static_cast<unsigned>(Tile::index(k, c));
        const float r0 = load_cluster<float>(cluster_addr(sre, s) + off);
        const float i0 = load_cluster<float>(cluster_addr(sim, s) + off);
        const float r1 = load_cluster<float>(cluster_addr(sre, s + 1) + off);
        const float i1 = load_cluster<float>(cluster_addr(sim, s + 1) + off);
        float* const g = y + 2 * (static_cast<size_t>(o0 + c) * n + j);
        if (vec) {
          *reinterpret_cast<float4*>(g) =
              make_float4(r0 * scale, i0 * scale_im, r1 * scale, i1 * scale_im);
        } else {
          *reinterpret_cast<float2*>(g) = make_float2(r0 * scale, i0 * scale_im);
          *reinterpret_cast<float2*>(g + 2) = make_float2(r1 * scale, i1 * scale_im);
        }
      }
    } else {
      const int o = t / groups();
      const int i0 = (t - o * groups()) << kLogC;
      const size_t in = static_cast<size_t>(inner);
      const size_t dst = static_cast<size_t>(o) * n * in + i0;
#pragma unroll 1
      for (int e = thread_x(); e < H << kLogC; e += kThreads) {
        const int c = e & (kCols - 1), k = e >> kLogC;
        if (i0 + c >= inner) continue;
        const int s = Tile::index(k, c);
        const size_t g = dst + static_cast<size_t>(C * k + rank) * in + c;
        *reinterpret_cast<float2*>(y + 2 * g) = make_float2(sre[s] * scale, sim[s] * scale_im);
      }
    }
  }
};

// The transform of n = C*H along the axis of the (outer, n, inner) view of
// x into y (y may be x), times `scale` (`scale_im` = scale * sign on the
// imaginary part); `sign` -1 for the inverse. The kernel's parameters are
// the policy's members as they are, so that none is kept in a register.
// `twre`/`twim`: the (C-1)*H split twiddles W_n^(r*p), then the pass tables
// (pair_tables), the forward ones in both directions. The walk is
// fft_pair's (stockham_pair.cuh): persistent clusters, the next tile's
// copies in flight in the other buffer while a tile's passes run, the
// cross-block radix-C split in the first pass, here reading the interleaved
// pairs of the fetched buffers. The next tile's copies go out after the
// cluster barrier that opens a tile, not before it: at (4, 1024) a pass of
// (32, 4096, 4096) took 8.76 ms against 9.77 along the first axis and
// 10.72 against 11.50 along the last (an H100 80GB HBM3 at 700 W), and in
// the contiguous-row layout that barrier also orders the next copies after
// the partners' reads of the buffer in the last store.
template <int C, int H, bool Rows>
__global__ void __launch_bounds__(kThreads, 1)
fft_pair_strided_c64(const float* x, float* y, int outer, int inner,
                     const float* __restrict__ twre, const float* __restrict__ twim,
                     float scale, float scale_im, float sign, int vec) {
  using IO = StridedC64<C, H, Rows>;
  using Tile = typename IO::Tile;
  constexpr int plane = H * Tile::kCols;
  constexpr int pitch = 2 * plane;  // floats of a buffer
  const IO io{x, y, outer, inner, scale, scale_im, sign, vec};
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const smem = reinterpret_cast<float*>(smem_raw);
  const int ntiles = io.tiles();
  int buf = 0;
  int t = cluster_id();
  if (t < ntiles) io.fetch(t, smem);
  copy_commit();
  for (; t < ntiles; t += cluster_count(), buf ^= 1) {
    float* const sre = smem + buf * pitch;
    float* const sim = sre + plane;
    copy_wait_all();
    cluster.sync();  // every rank's rows of tile t are in shared memory
    // The next tile's copies go out after the barrier, which every rank
    // passes only once its reads of the other buffer, in the last tile's
    // split and store, are done.
    if (t + cluster_count() < ntiles) io.fetch(t + cluster_count(), smem + (buf ^ 1) * pitch);
    copy_commit();
    // As fft_pair's split: only this rank's output of the radix-C step,
    // v = sum_s a_s * W_C^(rank*s), times W_n^(rank*p), each partner's
    // pair (conjugated for the inverse) read at a 32-bit shared::cluster
    // address.
    unsigned a[C];
#pragma unroll
    for (int s = 0; s < C; ++s) a[s] = cluster_addr(sre, s);
    auto split = [&](int row, int col, float& re, float& im) {
      const int rank = cluster_rank();
      const unsigned off = 8u * static_cast<unsigned>(io.slot(row, col));
      float ar[C], ai[C];
#pragma unroll
      for (int s = 0; s < C; ++s) {
        load_cluster_pair(a[s] + off, ar[s], ai[s]);
        ai[s] *= io.sign;
      }
      const float rho = rank & 1 ? -1.0f : 1.0f;
      if constexpr (C == 2) {
        re = ar[0] + rho * ar[1];
        im = ai[0] + rho * ai[1];
      } else {
        const float ur = ar[0] + rho * ar[2], ui = ai[0] + rho * ai[2];
        float wr = ar[1] + rho * ar[3], wi = ai[1] + rho * ai[3];
        // W_4^rank = 1, -i, -1, i.
        cmul(wr, wi, static_cast<float>((rank == 0) - (rank == 2)),
             static_cast<float>((rank == 3) - (rank == 1)));
        re = ur + wr;
        im = ui + wi;
      }
      if (rank > 0) {
        const int w = (rank - 1) * H + row;
        cmul(re, im, __ldg(twre + w), __ldg(twim + w));
      }
    };
    auto split_done = [&] { cluster.sync(); };  // the partners read their rows
    pair_passes<0, true, Tile, kThreads, (C - 1) * H>(sre, sim, twre, twim, split,
                                                      split_done, NoHook{});
    if constexpr (Rows) cluster.sync();  // every rank's tile t is complete
    io.store(t, sre, sim);
  }
  cluster.sync();  // a partner may still read this block's tile
}

// B1's sizes (FOURIER_PAIR_ROWS on two-block clusters, FOURIER_B1_QUAD_ROWS
// on four-block ones, in stockham_pair.cuh) but two sets, which keep the
// planes: h = 720, 800 and 864 (n = 1440, 1600, 1728, 2880, 3200 and
// 3456), where ptxas spilled the strided-column body on both cluster
// sizes (4 to 12 bytes; B1_STRIDED_SPILLED in ops/cuda/stockham_vpu.py),
// and the two-block heights of the n where B1 runs its stage body
// (B1_STAGE_FASTER: 576, 648, 800, 960 and 1000).
using Body = void (*)(const float*, float*, int, int, const float*, const float*,
                      float, float, float, int);

template <int C, int H>
constexpr Body strided_body(bool rows) {
  if constexpr (H == 720 || H == 800 || H == 864) {
    return nullptr;
  } else if constexpr (C == 2 && (H == 288 || H == 324 || H == 400 || H == 480 || H == 500)) {
    return nullptr;
  } else {
    return rows ? fft_pair_strided_c64<C, H, true> : fft_pair_strided_c64<C, H, false>;
  }
}

// The compiled body of a C-block cluster with h rows a block in the
// contiguous-row layout (`rows`) or the strided-column one, or nullptr.
Body body_of(int ranks, int h, bool rows) {
  switch (ranks * 8192 + h) {
#define FOURIER_B1S_PAIR_CASE(R) \
  case 2 * 8192 + R:             \
    return strided_body<2, R>(rows);
#define FOURIER_B1S_QUAD_CASE(R) \
  case 4 * 8192 + R:             \
    return strided_body<4, R>(rows);
    FOURIER_PAIR_ROWS(FOURIER_B1S_PAIR_CASE)
    FOURIER_B1_QUAD_ROWS(FOURIER_B1S_QUAD_CASE)
#undef FOURIER_B1S_PAIR_CASE
#undef FOURIER_B1S_QUAD_CASE
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" {

// B1's clustered-block body along the axis of the contiguous interleaved
// complex64 tensor `x` viewed as (outer, n, inner), into `y` of the same
// shape (y may be x: the pass then runs in place), on clusters of `ranks`
// (2 or 4) blocks of n/ranks rows, for the (ranks, n/ranks) of
// FOURIER_PAIR_ROWS (ranks 2) and FOURIER_B1_QUAD_ROWS (ranks 4). `cols`,
// `threads` and the `npasses` `radices` (host memory) must be the compiled
// body's tile and schedule of n/ranks; `twre`/`twim` hold B1's forward
// pair tables of n for both directions. Returns a cudaError_t code, 0 on
// success.
int fourier_fft_pair_strided_c64(const float* x, float* y, int n, int outer,
                                 int inner, int ranks, int cols, int threads,
                                 int npasses, const int* radices,
                                 const float* twre, const float* twim,
                                 int forward, float scale, int device,
                                 void* stream) {
  if (outer <= 0 || inner <= 0 || ranks <= 0 || n % ranks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int h = n / ranks;
  const Body kern = body_of(ranks, h, inner == 1);
  if (kern == nullptr ||
      !pair_geometry_matches<float, kThreads>(h, cols, threads, npasses,
                                              radices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long groups = (static_cast<long long>(inner) + cols - 1) / cols;
  const long long ntiles = inner == 1 ? (static_cast<long long>(outer) + cols - 1) / cols
                                      : static_cast<long long>(outer) * groups;
  if (ntiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned16(x) && aligned16(y) && (inner == 1 || inner % 2 == 0);
  const size_t smem = 4 * sizeof(float) * static_cast<size_t>(h) * cols;
  const float sign = forward ? 1.0f : -1.0f;
  const int tiles = static_cast<int>(ntiles);
  if (ranks == 2) {
    return launch_clusters<2>(kern, tiles, threads, smem, device, stream, x, y,
                              outer, inner, twre, twim, scale, scale * sign,
                              sign, vec);
  }
  return launch_clusters<4>(kern, tiles, threads, smem, device, stream, x, y,
                            outer, inner, twre, twim, scale, scale * sign, sign,
                            vec);
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
