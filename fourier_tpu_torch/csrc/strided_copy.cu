// The exchange layer's one copy primitive: a copy between two strided views
// of the same shape, for NVIDIA Hopper (sm_90a), in a library of its own.
// The host function checks its arguments, launches on the caller's stream,
// neither allocates nor synchronises, and returns cudaGetLastError().
//
// Replaces no TPU kernel: the JAX package's sharded plans
// (fourier_tpu/parallel/sharded.py) leave their transposes to XLA, inside
// all_to_all and shard_map. The port's sharded plans
// (fourier_tpu_torch/parallel/exchange.py) lay each leg's pieces out with
// gather and the result with assemble, copies of a permuted view that
// transpose the innermost dim of the source against the innermost dim of
// the destination. PyTorch's elementwise copy does not tile such a copy
// through shared memory, so on one side it reads or writes at a stride: on
// four H100 80GB HBM3 at 700 W, 128 images of 4096 x 4096 split by rows,
// those copies took 54.8 ms of an 89.9 ms call, against 7.7 ms at the
// memory's rate.
//
// What bounds it on this card: memory. A copy reads and writes every
// element once: 2 x elements x element size at 3.35 TB/s (2.564 ms for
// the 2 x 2^29 floats of one rank's planes in that cell).
//
// The view. The caller (ops/cuda/strided_copy.py: copy_layout) hands the
// copy over as at most kMaxDims dims with positive extents, ordered by the
// destination's strides (dim ndim-1 is its innermost), adjacent dims merged
// where both sides allow it, each with a source and a destination stride
// in elements, and `sdim`, the source's innermost dim. Up to kMaxPlanes
// planes of the same layout (the real and imaginary planes of a piece, or
// the four limbs of a double-word call) go in one launch, one plane a
// blockIdx.y. Elements are 4 or 8 bytes and are moved as bits.
//
// Two bodies, picked by the strides:
//   * tiled (sdim != ndim-1: the two innermost dims differ). A block walks
//     tiles of kTile x kTile elements spanning the source's innermost dim
//     and the destination's, the outer dims and the tiles walked by the
//     grid. A warp reads kTile consecutive elements of the source's
//     innermost dim (two 128-byte lines of 4-byte elements) into a row of a
//     shared tile padded by one element, so that the column reads of the
//     write phase fall on distinct banks, and writes kTile consecutive
//     elements of the destination's innermost dim. Ragged edges are
//     masked. Each thread keeps its kTile*kTile/(32*kRows) loads of a tile
//     in flight at once.
//   * straight (sdim == ndim-1: both sides share their innermost dim). Each
//     thread copies one element, or one 16-byte vector where both sides
//     are unit-stride along it and every plane, extent and outer stride is
//     16-byte aligned.

// The tile. On an H100 80GB HBM3 at 700 W, at the three copies of that
// cell (2 x 2^29 floats each), 64 x 64 tiles on 4 warps took 2.99-3.06 ms
// a copy (84-86% of the bound), against 3.1-3.2 ms on 2 or 8 warps,
// 3.2-3.8 ms for 32 x 32 tiles on 4-8 warps and 5.5 ms on 16; a grid of 8
// waves of resident blocks ran 0-1.6% faster than 4, 2.0-2.8% than 2 and
// 1.9-4.4% than 1. A contiguous copy of the same bytes (no transpose)
// took 2.854-2.865 ms (90%), so a TMA tile load with an mbarrier could win
// at most the 5% between the two, and was not built.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxDims = 6;
constexpr int kMaxPlanes = 4;
constexpr int kTile = 64;  // a tile's side, in elements
constexpr int kRows = 4;  // warps a block of the tiled body
constexpr int kWaves = 8;  // grid: resident blocks x kWaves
constexpr int kStraightThreads = 256;

static_assert(kTile % 32 == 0 && kTile % kRows == 0, "tile of whole warps");

struct Layout {
  int ndim;
  int sdim;
  long long size[kMaxDims];
  long long sstride[kMaxDims];
  long long dstride[kMaxDims];
};

// The dims a block walks over, every index static so that the kernel reads
// them from its parameters: up to kMaxDims-1 outer dims (innermost last),
// and the one or two inner dims that a tile or a thread spans.
struct Walk {
  int nouter;
  long long osize[kMaxDims - 1];
  long long osrc[kMaxDims - 1];
  long long odst[kMaxDims - 1];
  long long ns, s_src, s_dst;  // the source's innermost dim
  long long nd, d_src, d_dst;  // the destination's innermost dim (tiled body)
};

struct Planes {
  const void* src[kMaxPlanes];
  void* dst[kMaxPlanes];
};

// Plane `i` of `a`, by selects (a dynamic index would copy the parameter
// to local memory).
template <typename Ptr>
__device__ __forceinline__ Ptr plane(const Ptr (&a)[kMaxPlanes], unsigned i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// The source and destination offsets of outer index `rest`, innermost dim
// first.
__device__ __forceinline__ void outer_offsets(const Walk& w, long long rest,
                                              long long* so, long long* doff) {
  long long s = 0, d = 0;
#pragma unroll
  for (int k = kMaxDims - 2; k >= 0; --k) {
    if (k < w.nouter) {
      const long long i = rest % w.osize[k];
      rest /= w.osize[k];
      s += i * w.osrc[k];
      d += i * w.odst[k];
    }
  }
  *so = s;
  *doff = d;
}

template <typename T>
__global__ void __launch_bounds__(32 * kRows)
    strided_copy_tiled(Walk w, Planes P, long long tiles_s, long long tiles_d,
                       long long ntiles) {
  constexpr int kPer = kTile / kRows;  // rows of the tile a warp moves
  constexpr int kLane = kTile / 32;  // elements of a row a lane moves
  __shared__ T tile[kTile][kTile + 1];
  const T* __restrict__ src = static_cast<const T*>(plane(P.src, blockIdx.y));
  T* __restrict__ dst = static_cast<T*>(plane(P.dst, blockIdx.y));
  const int lane = threadIdx.x, row = threadIdx.y;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long td = t % tiles_d;
    const long long ts = (t / tiles_d) % tiles_s;
    long long so, doff;
    outer_offsets(w, t / tiles_d / tiles_s, &so, &doff);
    const long long s0 = ts * kTile, d0 = td * kTile;
    // Read: lanes along the source's innermost dim, rows along the
    // destination's; tile[d][s].
    T v[kPer][kLane] = {};
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long d = d0 + row + j * kRows;
#pragma unroll
      for (int i = 0; i < kLane; ++i) {
        const long long s = s0 + lane + i * 32;
        if (d < w.nd && s < w.ns) v[j][i] = src[so + s * w.s_src + d * w.d_src];
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
#pragma unroll
      for (int i = 0; i < kLane; ++i) tile[row + j * kRows][lane + i * 32] = v[j][i];
    }
    __syncthreads();
    // Write: lanes along the destination's innermost dim, rows along the
    // source's.
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long s = s0 + row + j * kRows;
#pragma unroll
      for (int i = 0; i < kLane; ++i) {
        const long long d = d0 + lane + i * 32;
        if (d < w.nd && s < w.ns) {
          dst[doff + s * w.s_dst + d * w.d_dst] = tile[lane + i * 32][row + j * kRows];
        }
      }
    }
    __syncthreads();
  }
}

template <typename V>
__global__ void __launch_bounds__(kStraightThreads)
    strided_copy_straight(Walk w, Planes P, long long total) {
  const V* __restrict__ src = static_cast<const V*>(plane(P.src, blockIdx.y));
  V* __restrict__ dst = static_cast<V*>(plane(P.dst, blockIdx.y));
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < total; e += step) {
    const long long i = e % w.ns;
    long long so, doff;
    outer_offsets(w, e / w.ns, &so, &doff);
    dst[doff + i * w.s_dst] = src[so + i * w.s_src];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// The walk of `L`: its outer dims are all but the destination's innermost
// dim and, for the tiled body, the source's.
Walk walk_of(const Layout& L) {
  Walk w{};
  const int dd = L.ndim - 1, sd = L.sdim;
  for (int k = 0; k < dd; ++k) {
    if (k == sd) continue;
    w.osize[w.nouter] = L.size[k];
    w.osrc[w.nouter] = L.sstride[k];
    w.odst[w.nouter] = L.dstride[k];
    ++w.nouter;
  }
  w.ns = L.size[sd];
  w.s_src = L.sstride[sd];
  w.s_dst = L.dstride[sd];
  w.nd = L.size[dd];
  w.d_src = L.sstride[dd];
  w.d_dst = L.dstride[dd];
  return w;
}

// Blocks of `kern` that fit on the card at once, times kWaves.
template <typename Kernel>
int grid_cap(Kernel kern, int threads, int device, int* cap) {
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *cap = std::max(1, sms * per_sm * kWaves);
  return 0;
}

template <typename T>
int launch_tiled(const Layout& L, const Planes& P, int nplanes, int device,
                 cudaStream_t stream) {
  const Walk w = walk_of(L);
  const long long tiles_s = (w.ns + kTile - 1) / kTile;
  const long long tiles_d = (w.nd + kTile - 1) / kTile;
  long long ntiles = tiles_s * tiles_d;
  for (int k = 0; k < w.nouter; ++k) ntiles *= w.osize[k];
  int cap = 0;
  const int err = grid_cap(strided_copy_tiled<T>, 32 * kRows, device, &cap);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(std::min<long long>(ntiles, cap)), nplanes);
  strided_copy_tiled<T><<<grid, dim3(32, kRows), 0, stream>>>(w, P, tiles_s, tiles_d,
                                                              ntiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_straight(const Layout& L, const Planes& P, int nplanes, int device,
                    cudaStream_t stream) {
  const Walk w = walk_of(L);
  long long total = w.ns;
  for (int k = 0; k < w.nouter; ++k) total *= w.osize[k];
  int cap = 0;
  const int err = grid_cap(strided_copy_straight<V>, kStraightThreads, device, &cap);
  if (err != 0) return err;
  const long long blocks = (total + kStraightThreads - 1) / kStraightThreads;
  const dim3 grid(static_cast<unsigned>(std::min<long long>(blocks, cap)), nplanes);
  strided_copy_straight<V><<<grid, kStraightThreads, 0, stream>>>(w, P, total);
  return static_cast<int>(cudaGetLastError());
}

// The straight body on 16-byte vectors of `per` elements where both sides
// allow it: the layout rescaled to vectors.
bool vectorize(Layout* L, const Planes& P, int nplanes, int per) {
  const int in = L->ndim - 1;
  if (L->sstride[in] != 1 || L->dstride[in] != 1 || L->size[in] % per != 0) return false;
  for (int k = 0; k < in; ++k) {
    if (L->sstride[k] % per != 0 || L->dstride[k] % per != 0) return false;
  }
  for (int p = 0; p < nplanes; ++p) {
    if (!aligned16(P.src[p]) || !aligned16(P.dst[p])) return false;
  }
  L->size[in] /= per;
  for (int k = 0; k < in; ++k) {
    L->sstride[k] /= per;
    L->dstride[k] /= per;
  }
  return true;
}

template <typename T>
int launch(Layout L, const Planes& P, int nplanes, int device, cudaStream_t stream) {
  if (L.sdim != L.ndim - 1) return launch_tiled<T>(L, P, nplanes, device, stream);
  if (vectorize(&L, P, nplanes, 16 / static_cast<int>(sizeof(T)))) {
    return launch_straight<uint4>(L, P, nplanes, device, stream);
  }
  return launch_straight<T>(L, P, nplanes, device, stream);
}

}  // namespace

extern "C" {

// Copy `nplanes` (1..4) source planes `src` into the destination planes
// `dst` (host arrays of device pointers), each plane laid out as the
// `ndim` (1..6) dims of `size` with element strides `sstride` (source) and
// `dstride` (destination), ordered by the destination's strides with dim
// ndim-1 its innermost, `sdim` the source's innermost dim; elements of
// `elem_bytes` (4 or 8) bytes. The tiled body runs where sdim != ndim-1,
// the straight body where they are equal. Returns a cudaError_t code, 0 on
// success.
int fourier_strided_copy(int nplanes, const void* const* src, void* const* dst,
                         int ndim, int sdim, const long long* size,
                         const long long* sstride, const long long* dstride,
                         int elem_bytes, int device, void* stream) {
  if (nplanes < 1 || nplanes > kMaxPlanes || ndim < 1 || ndim > kMaxDims ||
      sdim < 0 || sdim >= ndim || (elem_bytes != 4 && elem_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layout L{};
  L.ndim = ndim;
  L.sdim = sdim;
  for (int k = 0; k < ndim; ++k) {
    if (size[k] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    L.size[k] = size[k];
    L.sstride[k] = sstride[k];
    L.dstride[k] = dstride[k];
  }
  Planes P{};
  for (int p = 0; p < nplanes; ++p) {
    if (src[p] == nullptr || dst[p] == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    P.src[p] = src[p];
    P.dst[p] = dst[p];
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem_bytes == 4 ? launch<std::uint32_t>(L, P, nplanes, device, s)
                         : launch<std::uint64_t>(L, P, nplanes, device, s);
}

const char* fourier_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
