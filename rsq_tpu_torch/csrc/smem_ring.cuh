// The shared-memory ring of the tensor-core matmuls (w8_matmul.cu,
// w4a4_matmul.cu): cp.async copies of global tiles into ring slots, their
// commit and wait, the slots' bank swizzle, and the opt-in to more than
// 48 KB of dynamic shared memory.

#pragma once

#include <cuda_runtime.h>

namespace smem_ring {

// Copy `chunk` bytes (16 or 4; `bytes` of them read, 0 for a zero fill)
// from global src to shared dst without holding a register.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, int chunk) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (chunk == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Byte offset of (row, col) in a tile of NT-byte rows: its 16-byte chunks
// XOR-swizzled by bits SH and SH + 1 of the row, the bits in which the four
// threads t = lane % 4 of a warp differ, so the warp's word reads of one
// column group fall on 32 distinct banks.
template <int NT, int SH>
__device__ __forceinline__ int swizzle(int row, int col) {
  return row * NT + (((col >> 4) ^ (((row >> SH) & 3) << 1)) << 4) +
         (col & 15);
}

// Let `kernel` take `bytes` of dynamic shared memory, once: `ready` is the
// caller's flag for that kernel (one per template instance).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, bool& ready) {
  if (ready) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  ready = e == cudaSuccess;
  return e;
}

}  // namespace smem_ring
