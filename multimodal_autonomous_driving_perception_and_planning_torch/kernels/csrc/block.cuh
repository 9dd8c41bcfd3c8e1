// Helpers of kernels K1 (tracker_step.cu), K3 (tagging_step.cu), K4
// (associate.cu) and K5 (nms_keep.cu): asynchronous staging into shared
// memory, their launchers' shared memory limit, the address of a word in
// another block of a thread block cluster, and phase clocks.
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

// Closes this thread's copies since the last commit into a group; waits
// until at most N of its groups are pending (the newest ones).
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Start copying `n` 4-byte words from global `src` to shared `dst` (16-byte
// aligned) on the threads `first`, `first + stride`, ...: 16-byte copies
// where `src` is 16-byte aligned, and 4-byte copies for the tail (n not a
// multiple of 4) or for all of it otherwise.  Returns at once; see
// cp_async_wait_all.
__device__ __forceinline__ void stage_async_by(void* dst, const void* src, int n, int first, int stride) {
  int done = 0;
  if (aligned16(src)) {
    const int n4 = n >> 2;
    for (int i = first; i < n4; i += stride)
      cp_async16(static_cast<char*>(dst) + 16 * i, static_cast<const char*>(src) + 16 * i);
    done = n4 << 2;
  }
  for (int i = done + first; i < n; i += stride)
    cp_async4(static_cast<char*>(dst) + 4 * i, static_cast<const char*>(src) + 4 * i);
}

// `stage_async_by` on the whole block.
__device__ __forceinline__ void stage_async(void* dst, const void* src, int n) {
  stage_async_by(dst, src, n, threadIdx.x, blockDim.x);
}

// `n` bytes from global `src` to shared `dst` (16-byte aligned), likewise:
// 16-byte copies where `src` is 16-byte aligned, 4-byte ones where it is
// 4-byte aligned, and plain byte copies for what is left.
__device__ __forceinline__ void stage_bytes_async_by(void* dst, const void* src, int n, int first, int stride) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  const int unit = aligned16(src) ? 16 : (reinterpret_cast<uintptr_t>(src) & 3u) == 0 ? 4 : 0;
  int done = 0;
  if (unit == 16) {
    for (int i = first; i < (n >> 4); i += stride) cp_async16(d + 16 * i, s + 16 * i);
    done = n & ~15;
  } else if (unit == 4) {
    for (int i = first; i < (n >> 2); i += stride) cp_async4(d + 4 * i, s + 4 * i);
    done = n & ~3;
  }
  for (int i = done + first; i < n; i += stride) d[i] = s[i];
}

// The 32-bit shared::cluster address of `p` in block `rank`'s shared memory.
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  unsigned a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// Programmatic dependent launch: a kernel launched on a stream with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// block of the kernel before it has called `grid_launch_dependents` (or
// exited), and waits in `grid_dependency_wait` until that kernel has
// finished and its writes are visible.  Without the attribute both return
// at once.
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void grid_dependency_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// A launch on `st`, with the attribute `extra` where it is not null; with
// `after`, one that may start while the kernel before it finishes
// (`grid_launch_dependents`, `grid_dependency_wait`), so that its loads of
// its own inputs overlap that kernel.
template <class... Params, class... Args>
inline cudaError_t launch_after(bool after, void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                                cudaStream_t st, cudaLaunchAttribute* extra, Args... args) {
  cudaLaunchAttribute attrs[2];
  int n = 0;
  if (after) {
    attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n++].val.programmaticStreamSerializationAllowed = 1;
  }
  if (extra) attrs[n++] = *extra;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The SMs of the current device, read once.
inline int device_sms() {
  static const int sms = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// Phase clocks of a cluster kernel, in a build with -DMADPP_PHASE_CLOCKS
// only: thread 0 of each of the first kPhaseBlocks blocks stores clock64()
// at the start (mark 0) and at the end of each phase (marks 1, 2, ...);
// the source's `madpp_*_phases` copies them out, kPhaseMarks a block.
// Each source is built into a library of its own for this.
#ifdef MADPP_PHASE_CLOCKS
constexpr int kPhaseBlocks = 16, kPhaseMarks = 8;
static __device__ long long g_phase_clocks[kPhaseBlocks * kPhaseMarks];
#define PHASE_MARK(k)                                      \
  if (threadIdx.x == 0 && blockIdx.x < (unsigned)kPhaseBlocks) \
  g_phase_clocks[blockIdx.x * kPhaseMarks + (k)] = clock64()
#else
#define PHASE_MARK(k) \
  do {                \
  } while (0)
#endif
