// Kernel K4: the standalone greedy IoU association, one (T, D) matrix per
// launch, in one thread block.
//
// Replaces the Pallas TPU kernel in the JAX package's
// ops/association_pallas.py (`_associate_kernel`, launched by
// `greedy_associate_pallas`).  Its plain PyTorch version is
// ops/association.py `_greedy_associate_plain`, and the kernel equals it on
// every input: tied row ranks, ranks anywhere in int32, -0 and +0, NaN.
//
// Bound on an H100: at (T, D) = (64, 16) the call reads 4.4 KB and writes
// 256 B, about 1.4 ns at 3.35 TB/s, and each association round compares
// the matrix's entries a few times; both are far below the launch latency,
// so the call is latency-bound: by its round trips to device memory and by
// the chain of dependent steps of each round.  The design:
//  - one wave of loads: each of 256 threads starts asynchronous copies
//    (`cp.async`, 16 bytes where the rows allow it, else 4) of an eighth
//    of its rows and their ranks straight into the padded layout of the
//    key matrix, with no division an element, and waits once;
//  - the fixpoint (association.cuh `greedy_associate`, shared with K1):
//    the block writes the keys over the staged IoUs and lists the
//    eligible pairs; warp 0 runs the rounds when at most 32 are eligible,
//    a warp a 32 rows otherwise, with one barrier a round.
//
// Two instances, chosen by shape: the one above for T <= 128 and D <= 64,
// and for larger tables, up to 1,024 rows and 1,024 columns, a block of
// 1,024 threads that reads the matrix from device memory in each round
// that needs it, with only the row and column bests in shared memory
// (association.cuh `greedy_associate_general`).  The wrapper checks the
// limits.

#include <cuda_runtime.h>

#include "association.cuh"

namespace {

constexpr int kMaxT = 128;
constexpr int kMaxD = 64;
constexpr int kThreads = 256;

static_assert(kThreads / 32 <= kAssocWarps, "the association lists entries a warp");

__global__ void __launch_bounds__(kThreads)
associate_kernel(const float* __restrict__ iou, const int* __restrict__ rank, int* __restrict__ match, int T,
                 int D, float thr) {
  extern __shared__ __align__(16) unsigned s_keys[];  // 32 ceil(T / 32) rows of assoc_key_stride(D)
  __shared__ __align__(16) unsigned s_scratch[kAssocScratch];
  __shared__ int s_rank[kMaxT];
  __shared__ unsigned s_col_done[kMaxD / 32];

  const int ldk = assoc_key_stride(D);
  const bool vec = (D & 3) == 0 && aligned16(iou);
  const int tid = threadIdx.x;
  if (tid < T) cp_async4(s_rank + tid, rank + tid);
  // Thread (t mod 32, part) copies an eighth of row t's columns.
  const int part = tid >> 5, parts = kThreads >> 5;
  for (int t = tid & 31; t < T; t += 32) {
    const float* src = iou + t * D;
    unsigned* dst = s_keys + t * ldk;
    if (vec) {
      for (int c = 4 * part; c < D; c += 4 * parts) cp_async16(dst + c, src + c);
    } else {
      for (int c = part; c < D; c += parts) cp_async4(dst + c, src + c);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  greedy_associate(reinterpret_cast<const float*>(s_keys), ldk, s_keys, s_rank, T, D, thr, match, s_col_done,
                   s_scratch);
}

constexpr int kGeneralThreads = 1024;

__global__ void __launch_bounds__(kGeneralThreads)
associate_general_kernel(const float* __restrict__ iou, const int* __restrict__ rank, int* __restrict__ match,
                         int T, int D, float thr) {
  extern __shared__ __align__(16) unsigned long long s_general[];  // [rank (T)] [the rounds' memory]
  int* s_rank = reinterpret_cast<int*>(s_general);
  void* s_assoc = s_general + ((T + 1) >> 1);
  for (int t = threadIdx.x; t < T; t += kGeneralThreads) s_rank[t] = rank[t];
  __syncthreads();
  greedy_associate_general([&](int t, int d) { return __ldg(iou + (size_t)t * D + d); }, s_rank, T, D, thr,
                           s_assoc);
  const int* m = assoc_general_match(s_assoc, T, D);
  for (int t = threadIdx.x; t < T; t += kGeneralThreads) match[t] = m[t];
}

}  // namespace

extern "C" int madpp_associate(const void* iou, const void* rank, void* match, int T, int D, float thr,
                               void* stream) {
  if (T < 1 || D < 1 || T > kAssocGeneralMax || D > kAssocGeneralMax) return (int)cudaErrorInvalidValue;
  if (T > kMaxT || D > kMaxD) {
    const size_t smem = 8 * (size_t)((T + 1) / 2) + assoc_general_smem(T, D);
    const cudaError_t err = allow_dynamic_smem<associate_general_kernel>(smem);
    if (err != cudaSuccess) return (int)err;
    associate_general_kernel<<<1, kGeneralThreads, smem, (cudaStream_t)stream>>>(
        (const float*)iou, (const int*)rank, (int*)match, T, D, thr);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(unsigned) * 32 * (size_t)((T + 31) / 32) * (size_t)assoc_key_stride(D);
  associate_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>((const float*)iou, (const int*)rank,
                                                               (int*)match, T, D, thr);
  return (int)cudaGetLastError();
}
