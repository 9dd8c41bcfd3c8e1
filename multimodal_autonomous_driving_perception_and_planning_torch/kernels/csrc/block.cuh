// Block-wide helpers of the one-block kernels K1 (tracker_step.cu), K3
// (tagging_step.cu) and K4 (associate.cu): asynchronous staging of their
// rings into shared memory, and their launchers' shared memory limit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Let `Kernel` take `bytes` of dynamic shared memory in a launch.  Without
// the attribute a launch may take 48 KB less the kernel's static shared
// memory (a launch above that fails with cudaErrorInvalidValue), so the
// attribute is raised only beyond that: the kernel's static size is read
// once.
template <auto Kernel>
inline cudaError_t allow_dynamic_smem(size_t bytes) {
  static const size_t static_bytes = [] {
    cudaFuncAttributes a{};
    return cudaFuncGetAttributes(&a, Kernel) == cudaSuccess ? a.sharedSizeBytes : (size_t)48 * 1024;
  }();
  if (bytes + static_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Asynchronous copies from device to shared memory (`cp.async`).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// Waits for this thread's copies; a __syncthreads() after it makes every
// thread's copies visible to the block.
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Start copying `n` 4-byte words from global `src` to shared `dst` (16-byte
// aligned) on the whole block: 16-byte copies where `src` is 16-byte
// aligned, and 4-byte copies for the tail (n not a multiple of 4) or for
// all of it otherwise.  Returns at once; see cp_async_wait_all.
__device__ __forceinline__ void stage_async(void* dst, const void* src, int n) {
  int done = 0;
  if (aligned16(src)) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      cp_async16(static_cast<char*>(dst) + 16 * i, static_cast<const char*>(src) + 16 * i);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x)
    cp_async4(static_cast<char*>(dst) + 4 * i, static_cast<const char*>(src) + 4 * i);
}
