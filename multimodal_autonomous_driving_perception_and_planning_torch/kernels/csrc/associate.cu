// Kernel K4: the standalone greedy IoU association, one (T, D) matrix per
// launch, in one thread block.
//
// Replaces the Pallas TPU kernel in the JAX package's
// ops/association_pallas.py (`_associate_kernel`, launched by
// `greedy_associate_pallas`).  Its plain PyTorch version is
// ops/association.py `_greedy_associate_plain`, and the kernel equals it on
// every input, tied row ranks included.
//
// Bound on an H100: at (T, D) = (64, 16) the call reads 4.4 KB and writes
// 256 B, about 1.4 ns at 3.35 TB/s, and each association round scans the
// matrix twice; both are far below the launch latency, so the call is
// latency-bound.  The design keeps the whole fixpoint in one launch: the
// matrix and the ranks go to shared memory once, and the rounds of
// `greedy_associate_block` (association.cuh, shared with kernel K1: two
// parallel arg-max reductions and one `__syncthreads_or` a round) run with
// no host synchronisation between them.  This kernel's own launch and
// loads are as first written; only the shared fixpoint was redesigned.
//
// Limits: T <= 128, D <= 64 (the wrapper checks them).

#include <cuda_runtime.h>

#include "association.cuh"

namespace {

constexpr int kMaxT = 128;
constexpr int kMaxD = 64;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
associate_kernel(const float* iou, const int* rank, int* match, int T, int D, float thr) {
  extern __shared__ float s_iou[];  // T * (D + 1), padded rows
  __shared__ int s_rank[kMaxT];
  __shared__ int s_match[kMaxT];
  __shared__ int s_row_best[kMaxT];
  __shared__ int s_col_best[kMaxD];
  __shared__ unsigned s_row_done[kMaxT / 32], s_col_done[kMaxD / 32];

  const int ld = D + 1;
  for (int i = threadIdx.x; i < T * D; i += blockDim.x) {
    const int t = i / D;
    s_iou[t * ld + (i - t * D)] = iou[i];
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x) s_rank[t] = rank[t];
  __syncthreads();
  greedy_associate_block(s_iou, ld, s_rank, T, D, thr, s_match, s_row_best, s_col_best,
                         s_row_done, s_col_done);
  for (int t = threadIdx.x; t < T; t += blockDim.x) match[t] = s_match[t];
}

}  // namespace

extern "C" int madpp_associate(const void* iou, const void* rank, void* match, int T, int D,
                               float thr, void* stream) {
  if (T < 1 || T > kMaxT || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)T * (size_t)(D + 1);
  associate_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)iou, (const int*)rank, (int*)match, T, D, thr);
  return (int)cudaGetLastError();
}
