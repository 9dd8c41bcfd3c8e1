// Kernel K5: the greedy-NMS keep mask, one image per thread block, B images
// per launch.
//
// Replaces the Pallas TPU kernel in the JAX package's ops/nms_pallas.py
// (`_nms_keep_kernel`, launched by `nms_keep_pallas`).  Its plain PyTorch
// version is ops/nms.py `_nms_keep_plain`, the suppression fixpoint
//   keep_j = alive_j & !any_i (keep_i & S_ij),  S_ij = (i < j) & (iou_ij > thr),
// iterated from keep = alive.  Since S_ij needs i < j, keep_j depends only on
// earlier candidates, so the fixpoint is unique and equals sequential greedy
// NMS in score order; this kernel computes greedy directly, with no rounds,
// and equals the fixpoint bit for bit on every input.
//
// Bound on an H100: at (B, K) = (64, 256) the call reads 344 KB (boxes and
// scores) and writes 16 KB, about 0.1 us at 3.35 TB/s, and computes at most
// K (K - 1) / 2 IoUs an image, about 0.5 us at 67 TFLOP/s float32.  The
// greedy scan is serial in score order, which no roofline covers.  The
// design: one block an image builds the suppression bits of every pair
// (i < j) into shared memory, a warp ballot per 32 columns, and one warp
// then walks the rows in order, OR-ing the row of each kept candidate into
// a "removed" mask held one 32-bit word per lane.  Nothing goes back to the
// host between images or rounds.
//
// Exactness: the IoU is `pairwise_iou` op for op with the _rn intrinsics,
// which nvcc never contracts into an FMA (as in kernel K1), so every
// threshold decision equals the plain version's.
//
// Limits: 1 <= K <= 1024 (the wrapper checks it).  Shared memory is 16 K +
// 4 K ceil(K / 32) + 4 ceil(K / 32) bytes: 12.3 KB at K = 256, 144 KB at
// K = 1024, which needs the opt-in dynamic shared-memory attribute.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float iou_rn(float4 a, float4 b) {
  const float iw = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float ih = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  const float inter = (iw > 0.0f && ih > 0.0f) ? __fmul_rn(iw, ih) : 0.0f;
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                bool* __restrict__ keep, int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) >> 5;  // 32-bit words a row
  float4* s_box = reinterpret_cast<float4*>(smem);  // K boxes
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_box + K);  // K rows of W words
  unsigned* s_removed = s_mask + (size_t)K * W;  // W words

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t img = blockIdx.x;
  const float* bx = boxes + img * K * 4;
  const float* sc = scores + img * K;

  for (int i = tid; i < K; i += kThreads) {
    s_box[i] = make_float4(bx[4 * i], bx[4 * i + 1], bx[4 * i + 2], bx[4 * i + 3]);
  }
  // Dead candidates (score <= 0) start removed: never kept, never suppress.
  for (int w = warp; w < W; w += kWarps) {
    const int j = w * 32 + lane;
    const unsigned alive = __ballot_sync(kFull, j < K && sc[j] > 0.0f);
    if (lane == 0) s_removed[w] = ~alive;
  }
  __syncthreads();

  // Row i, word w: bit b set iff j = 32 w + b > i and iou(i, j) > thr.
  for (int q = warp; q < K * W; q += kWarps) {
    const int i = q / W, w = q - i * W;
    unsigned bits = 0u;
    if (w * 32 + 31 > i) {  // warp-uniform: the word holds some j > i
      const int j = w * 32 + lane;
      const bool s = j > i && j < K && iou_rn(s_box[i], s_box[j]) > thr;
      bits = __ballot_sync(kFull, s);
    }
    if (lane == 0) s_mask[q] = bits;
  }
  __syncthreads();

  // Greedy scan in score order on warp 0: lane w holds removed word w.
  if (warp == 0) {
    unsigned removed = lane < W ? s_removed[lane] : 0u;
    for (int i = 0; i < K; ++i) {
      const unsigned r = __shfl_sync(kFull, removed, i >> 5);
      if (!((r >> (i & 31)) & 1u) && lane < W) removed |= s_mask[(size_t)i * W + lane];
    }
    if (lane < W) s_removed[lane] = removed;
  }
  __syncthreads();

  for (int j = tid; j < K; j += kThreads) {
    keep[img * K + j] = !((s_removed[j >> 5] >> (j & 31)) & 1u);
  }
}

}  // namespace

extern "C" int madpp_nms_keep(const void* boxes, const void* scores, void* keep, int B, int K,
                              float thr, void* stream) {
  if (B < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const size_t W = (size_t)(K + 31) / 32;
  const size_t smem = 16 * (size_t)K + 4 * (size_t)K * W + 4 * W;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_keep_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)scores, (bool*)keep, K, thr);
  return (int)cudaGetLastError();
}
