// Helpers shared by the kernels that stream their operands through a ring of
// shared-memory stages (K1b, csrc/vq_grouped.cu; K3, csrc/flash_attention.cu):
// the cp.async copies, and the opt-in to more than 48 KB of dynamic shared
// memory.
#pragma once
#include <cuda_runtime.h>

#include <atomic>

namespace mcq {

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
// (gmem must still be a valid address)
__device__ __forceinline__ void cpAsync16(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

// the same for one float, for operands that are not 16-byte aligned
__device__ __forceinline__ void cpAsync4(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cpCommit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cpWait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device.
// The attribute belongs to the device's context, so it is set once per
// device ordinal (one bit of `devices` each, kept per kernel by the caller);
// ordinals past 63 set it on every launch. Setting it twice is harmless, so
// two threads racing on the first launch are too.
template <class Kernel>
cudaError_t allowSharedBytes(Kernel kernel, int bytes, std::atomic<unsigned long long>& devices) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit != 0 && (devices.load(std::memory_order_relaxed) & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) devices.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace mcq
