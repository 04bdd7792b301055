// Asynchronous copies from global to shared memory (cp.async, sm_80 and
// later): the copies of the clustered-block engine (stockham_pair.cuh) and
// of the tensor-core bodies of B9a and B9b (dft_mma.cu). A thread starts
// copies, closes them into a commit group, and waits until all but its
// latest group have landed; a block barrier after the wait makes every
// thread's copies visible to the block.

#pragma once

namespace {

// cp.async of `Bytes` (16, 8 or 4) from global to shared memory.
template <int Bytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"(Bytes));
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait_previous() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

}  // namespace
