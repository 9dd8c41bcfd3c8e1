// Kernel K5: the greedy-NMS keep mask of B images in one launch, a thread
// block cluster of 1 to 8 blocks an image.
//
// Replaces the Pallas TPU kernel in the JAX package's ops/nms_pallas.py
// (`_nms_keep_kernel`, :39, launched by `nms_keep_pallas`, :86).  Its plain
// PyTorch version is ops/nms.py `_nms_keep_plain`, the suppression fixpoint
//   keep_j = alive_j & !any_i (keep_i & S_ij),  S_ij = (i < j) & (iou_ij > thr),
// iterated from keep = alive, alive_j = score_j > 0 (NaN is dead; dead
// entries may stand anywhere).  Since S_ij needs i < j, keep_j depends only
// on earlier candidates, so the fixpoint is unique and equals sequential
// greedy NMS in index order; this kernel computes that greedy result and
// equals the fixpoint bit for bit on every input.
//
// Bound on an H100 SXM: at the YOLO path's (B, K) = (64, 256) a call reads
// 344 KB (boxes and scores) and writes 16 KB, 0.1 us at 3.35 TB/s, and
// needs 16 operations an IoU pair of live candidates, 0.5 us at 67 TFLOP/s
// float32; both lie under the card's launch floor of about 1.1 us, so the
// bound cannot be approached, let alone half of it.
//
// The design, against what held the one-block-an-image version back:
//  1. Grid.  A cluster of C blocks an image, C the largest of 8, 4, 2 for
//     which all B clusters are resident at once, one block an SM
//     (cudaOccupancyMaxActiveClusters), and every warp of the cluster gets
//     an item of the mask build; else C = 1.  Every block builds a share of
//     the mask into rank 0's shared memory (distributed shared memory), the
//     items dealt out across the ranks in turn; rank 0 then scans.
//  2. Mask build.  Only what the scan can read: row i, words w >= i / 32,
//     as items (row group g, word w, quarter q) read from a table of (g, w)
//     pairs, so no index needs a runtime division; items whose rows or
//     columns are all dead are skipped.  A warp takes an item: lane b is row
//     32 g + b and computes the 8 bits of quarter q of word w from 8
//     independent IoUs against column boxes broadcast from shared memory,
//     branch-free, then stores them as one byte.  The division is not on
//     this path: iou > thr is decided as inter > union * hi or
//     inter < union * lo, hi and lo 2^-19 (16 ulps) either side of thr,
//     which the rounded quotient cannot cross; a pair between the two, or
//     with a threshold outside [2^-20, 2^20] or an area outside
//     [2^-38, 2^38], takes the exact __fdiv_rn (rare, warp-uniform branch).
//  3. Scan.  Warp 0 of rank 0 takes a 32-candidate word at a time, lane w'
//     holding the removed bits of word w'.  Within word w lane b holds row
//     32 w + b's diagonal word: if no candidate suppresses another (one
//     ballot), all are kept; else the fixpoint keep = cand & ~OR_{b in keep}
//     diag_b runs from keep = cand, one warp OR-reduction a round, as many
//     rounds as the word's longest suppression chain.  Then the kept rows
//     with a bit in a later word (nz, from the build's ballots) are OR-ed
//     into the later words, lane w' taking word w', eight independent loads
//     at a time.  The serial chain is W words, not K candidates.
//  4. Loads.  One wave: thread i loads candidate i's box (16 bytes; scalar
//     loads if the pointer is not 16-byte aligned) and score; the alive and
//     area-range words are ballots.  The first cluster barrier is split
//     (relaxed arrive before the loads, wait after them).
//  5. Host.  The opt-in shared-memory size and the cluster occupancies are
//     set and read once a device, not on every launch.
//
// Exactness: the IoU is `pairwise_iou` as the jitted JAX package computes
// it, with the _rn intrinsics, which nvcc never contracts: compiled XLA
// contracts the union to fma(w_b, h_b, area_a) - inter, so the kernel takes
// __fmaf_rn there (one rounding) and everything else op for op.  The proof
// below reads only the union value that the reference divides by, however
// it was rounded, and its range: with area_a and area_b = w_b * h_b (rounded)
// in [2^-38, 2^38], the exact w_b * h_b is within 2^-24 of area_b, and the
// contracted union, at least max(area_a, w_b h_b) - 1 ulp and at most twice
// 2^38 + 1 ulp, stays in [2^-40, 2^40].  With union there and thr in
// [2^-20, 2^20] both products are normal, each off by at most 2^-24, so
// inter > union * hi puts the quotient above thr (1 + 2^-20) and its
// rounding above thr, and inter < union * lo below.  fminf/fmaxf differ
// from torch.minimum/maximum only on NaN, and a NaN coordinate makes w_b,
// h_b or area_a, and so the union, NaN: an IoU of 0 on both sides.
//
// Shared memory, each block of a cluster, W = ceil(K / 32), Kp = 32 W,
// S = Kp + 1, P = W (W + 1) / 2 pairs, 4 P items:
//   boxes   float4[Kp]       (16 Kp bytes; zero beyond K)
//   sides   float2[Kp]       (x2 - x1, y2 - y1) of each box, rounded
//   alive   uint32[32]       bit b of word w: score of 32 w + b > 0
//   ok      uint32[32]       bit b of word w: area of 32 w + b in range
//   nzg     uint32[32]       bit b of word g: row 32 g + b has a bit in a
//                            word after g (rank 0's, from the nz slots)
//   nz      uint32[4 P]      an item's rows with a bit set (rank 0's)
//   mask    uint32[W * S]    word w of row i at w * S + i (rank 0's); the
//                            stride S keeps both the build's and the scan's
//                            accesses free of bank conflicts
//   pairs   uint16[P]        (g << 8) | w for w >= g
// 15.4 KB at K = 256, 166 KB at K = 1024 (under the opt-in 227 KB).
//
// Limits: 1 <= K <= 1024 and B >= 1 (the wrapper checks both).  The launch
// goes on the given stream, allocates nothing and never synchronises.
//
// Candidate pools beyond 1,024 (every anchor of yolov8 at 640, 8,400; at
// 1,280, 33,600) take the large instance below the launcher of this one:
// the mask no longer fits in shared memory (K W 4 bytes, 8.8 MB an image
// at 8,400), so it goes to a device workspace the wrapper allocates, in
// two kernels (`madpp_nms_keep_large`).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#ifndef NMS_MAX_CLUSTER
#define NMS_MAX_CLUSTER 8  // largest cluster an image; build with 1 for one block an image
#endif

namespace {

constexpr int kMaxK = 1024;
constexpr int kMaxW = kMaxK / 32;
constexpr int kThreads = 1024;  // a thread a candidate at K = 1024
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
// The division-free decision's ranges and margin (header, point 2).
constexpr float kThrLo = 0x1p-20f, kThrHi = 0x1p20f, kAreaLo = 0x1p-38f, kAreaHi = 0x1p38f;
constexpr float kMargin = 0x1p-19f;

__host__ __device__ inline int words(int K) { return (K + 31) >> 5; }

__host__ __device__ inline int pairs(int W) { return W * (W + 1) / 2; }

__host__ __device__ inline size_t smem_bytes(int K) {
  const size_t W = words(K), Kp = 32 * W, S = Kp + 1, items = 4 * pairs((int)W);
  return 16 * Kp + 8 * Kp + 4 * 3 * kMaxW + 4 * items + 4 * W * S + ((2 * pairs((int)W) + 3) & ~(size_t)3);
}

// The union of `pairwise_iou` as compiled XLA computes it: fma(w_b, h_b,
// area_a) - inter, one rounding for the fma; wh_b = (w_b, h_b).
__device__ __forceinline__ float contracted_union(float area_a, float2 wh_b, float inter) {
  return __fsub_rn(__fmaf_rn(wh_b.x, wh_b.y, area_a), inter);
}

// The 32-bit shared::cluster address of `p` in rank 0's shared memory (a
// block's own shared::cta address is one, for a cluster of 1), and stores
// through such addresses.  A generic pointer to another block's shared
// memory (`map_shared_rank`) is 64 bits from the shared window's base,
// whose special-register reads the compiler hoisted above the loads.
__device__ __forceinline__ unsigned rank0_addr(const void* p, bool clustered) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (clustered) asm("mapa.shared::cluster.u32 %0, %1, 0;" : "=r"(a) : "r"(a));
  return a;
}

__device__ __forceinline__ void st_cluster_u8(unsigned addr, unsigned v) {
  asm volatile("st.shared::cluster.u8 [%0], %1;" ::"r"(addr), "h"((unsigned short)(v & 0xffu)) : "memory");
}

__device__ __forceinline__ void st_cluster_u32(unsigned addr, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// iou(a, b) > thr, as the jitted `pairwise_iou` decides it, with the exact division.
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b, float2 wh_b, float thr) {
  const float iw = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float ih = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  const float inter = (iw > 0.0f && ih > 0.0f) ? __fmul_rn(iw, ih) : 0.0f;
  const float uni = contracted_union(area_a, wh_b, inter);
  return (uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f) > thr;
}

__global__ void __launch_bounds__(kThreads, 1)
nms_keep_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                bool* __restrict__ keep, int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), csize = cluster.num_blocks();
  const int W = words(K), Kp = W << 5, S = Kp + 1, P = pairs(W), items = P << 2;
  float4* s_box = reinterpret_cast<float4*>(smem);
  float2* s_wh = reinterpret_cast<float2*>(s_box + Kp);
  unsigned* s_alive = reinterpret_cast<unsigned*>(s_wh + Kp);
  unsigned* s_ok = s_alive + kMaxW;
  unsigned* s_nzg = s_ok + kMaxW;
  unsigned* s_nz = s_nzg + kMaxW;
  unsigned* s_mask = s_nz + items;
  unsigned short* s_pair = reinterpret_cast<unsigned short*>(s_mask + (size_t)W * S);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t img = blockIdx.x >> (__ffs(csize) - 1);  // csize is a power of 2
  const float* bx = boxes + img * (size_t)K * 4;
  const float* sc = scores + img * (size_t)K;
  // Every block of the cluster must run before any touches another's
  // shared memory: arrive now, wait after the loads.  Nothing is ordered by
  // this barrier, so it is relaxed (no fence).
  if (csize > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // One wave of loads: thread i takes candidate i's box and score.
  float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float score = 0.0f;
  if (tid < K) {
    b = (reinterpret_cast<uintptr_t>(bx) & 15u) == 0
            ? __ldg(reinterpret_cast<const float4*>(bx) + tid)
            : make_float4(bx[4 * tid], bx[4 * tid + 1], bx[4 * tid + 2], bx[4 * tid + 3]);
    score = sc[tid];
  }
  const float2 wh = make_float2(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float area = __fmul_rn(wh.x, wh.y);
  if (tid < Kp) {
    s_box[tid] = b;
    s_wh[tid] = wh;
  }
  const unsigned alive = __ballot_sync(kFull, tid < K && score > 0.0f);  // NaN is dead
  const unsigned ok = __ballot_sync(kFull, area >= kAreaLo && area <= kAreaHi);
  if (lane == 0 && warp < W) {
    s_alive[warp] = alive;
    s_ok[warp] = ok;
  }
  if (tid < W) {  // the (g, w) pairs of row group g = tid, after those of groups < g
    const int g = tid;
    int p = g * W - g * (g - 1) / 2;
    for (int w = g; w < W; ++w) s_pair[p++] = (unsigned short)((g << 8) | w);
  }
  __syncthreads();
  if (csize > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");

  // Mask build.  Item (g, w, q): rows 32 g + lane, columns 32 w + 8 q + k,
  // one byte of word w of each row into rank 0's mask, and into rank 0's
  // nz slot of the item the rows with a bit set (0 for a skipped item).
  const unsigned mask0 = rank0_addr(s_mask, csize > 1), nz0 = rank0_addr(s_nz, csize > 1);
  const bool fast = thr >= kThrLo && thr <= kThrHi;
  const float hi = __fmul_rn(thr, 1.0f + kMargin), lo = __fmul_rn(thr, 1.0f - kMargin);
  for (int it = warp * (int)csize + (int)rank; it < items; it += (int)csize * kWarps) {
    const unsigned pr = s_pair[it >> 2];
    const int q = it & 3, g = pr >> 8, w = pr & 255;
    unsigned rows = 0u;
    if (((s_alive[w] >> (q << 3)) & 0xffu) != 0u && s_alive[g] != 0u) {
      const int i = (g << 5) + lane, j0 = (w << 5) + (q << 3);
      const float4 a = s_box[i];
      const float2 wh_a = s_wh[i];
      const float area_a = __fmul_rn(wh_a.x, wh_a.y);
      unsigned bits = 0u, slow = 0xffu;
      if (fast && ((s_ok[w] >> (q << 3)) & 0xffu) == 0xffu) {  // warp-uniform
        unsigned open = 0u;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 c = s_box[j0 + k];
          const float iw = __fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x));
          const float ih = __fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y));
          const float inter = (iw > 0.0f && ih > 0.0f) ? __fmul_rn(iw, ih) : 0.0f;
          const float uni = contracted_union(area_a, s_wh[j0 + k], inter);
          const bool above = inter > __fmul_rn(uni, hi), below = inter < __fmul_rn(uni, lo);
          if (above) bits |= 1u << k;
          if (!(above || below)) open |= 1u << k;
        }
        if ((s_ok[g] >> lane) & 1u) slow = open;
      }
      if (__any_sync(kFull, slow != 0u)) {  // rare: decide with the exact division
        while (slow != 0u) {
          const int k = __ffs(slow) - 1;
          slow &= slow - 1u;
          const unsigned bit = 1u << k;
          bits = iou_above(a, area_a, s_box[j0 + k], s_wh[j0 + k], thr) ? bits | bit : bits & ~bit;
        }
      }
      if (w == g) bits &= ~((2u << lane) - 1u) >> (q << 3);  // only j > i
      st_cluster_u8(mask0 + 4u * (unsigned)(w * S + i) + (unsigned)q, bits);
      rows = __ballot_sync(kFull, bits != 0u);
    }
    if (lane == 0) st_cluster_u32(nz0 + 4u * (unsigned)it, rows);
  }
  if (csize > 1) {
    cluster.sync();  // the whole mask in rank 0
  } else {
    __syncthreads();
  }
  if (rank != 0) return;
  // nz of row group g = warp: the rows with a bit in a word after g, the OR
  // of the nz slots of the group's items past the diagonal, items
  // 4 (p + 1) .. 4 (p + W - g) - 1 with p = g W - g (g - 1) / 2.
  if (warp < W) {
    const int g = warp, p = g * W - g * (g - 1) / 2;
    unsigned v = 0u;
    for (int t = 4 * (p + 1) + lane; t < 4 * (p + W - g); t += 32) v |= s_nz[t];
    v = __reduce_or_sync(kFull, v);
    if (lane == 0) s_nzg[g] = v;
  }
  __syncthreads();
  if (warp != 0) return;

  // Greedy scan, a word at a time (header, point 3); lane w' holds the
  // removed bits of word w', dead candidates and those past K from the start.
  unsigned removed = lane < W ? ~s_alive[lane] : 0u;
  bool* out = keep + img * (size_t)K;
  unsigned diag = s_mask[lane], nz = s_nzg[0];
  for (int w = 0; w < W; ++w) {
    const bool more = w + 1 < W;
    const unsigned diag_next = more ? s_mask[(size_t)(w + 1) * (S + 32) + lane] : 0u;
    const unsigned nz_next = more ? s_nzg[w + 1] : 0u;
    const unsigned cand = ~__shfl_sync(kFull, removed, w);
    unsigned kept = cand;
    if (__ballot_sync(kFull, ((cand >> lane) & 1u) && (diag & cand) != 0u) != 0u) {
      for (;;) {
        const unsigned next = cand & ~__reduce_or_sync(kFull, (kept >> lane) & 1u ? diag : 0u);
        if (next == kept) break;
        kept = next;
      }
    }
    const int j = (w << 5) + lane;
    if (j < K) out[j] = (kept >> lane) & 1u;
    unsigned m = kept & nz;  // kept rows with a bit in a later word
    const bool mine = lane > w && lane < W;
    const unsigned* col = s_mask + (size_t)lane * S + (w << 5);
    while (m != 0u) {
      unsigned v = 0u;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = __ffs(m) - 1;
        m &= m - 1u;
        if (mine && r >= 0) v |= col[r];
      }
      removed |= v;
    }
    diag = diag_next;
    nz = nz_next;
  }
}

struct DeviceState {
  bool ready;
  int max_clusters[4];  // resident clusters of 1, 2, 4, 8 blocks at K = 1024's shared memory
};

DeviceState g_devices[kMaxDevices];

cudaError_t prepare(DeviceState& st) {
  const int smem = (int)smem_bytes(kMaxK);
  cudaError_t err = cudaFuncSetAttribute(nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  st.max_clusters[0] = 0;
  for (int e = 1, c = 2; e < 4; ++e, c <<= 1) {
    st.max_clusters[e] = 0;
    if (c > NMS_MAX_CLUSTER) continue;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&st.max_clusters[e], nms_keep_kernel, &cfg);
    if (err != cudaSuccess) return err;
  }
  st.ready = true;
  return cudaSuccess;
}

// The cluster size of a launch at (B, K): the largest of 8, 4, 2 (up to
// NMS_MAX_CLUSTER) whose B clusters are all resident at once, one block an
// SM, and whose warps all get an item of the mask build.
unsigned cluster_size(const DeviceState& st, int B, int K) {
  const int items = pairs(words(K)) * 4;
  for (int e = 3; e >= 1; --e) {
    const int size = 1 << e;
    if (B <= st.max_clusters[e] && size * kWarps <= items) return size;
  }
  return 1;
}

cudaError_t device_state(DeviceState** st) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *st = &g_devices[dev];
  return (*st)->ready ? cudaSuccess : prepare(**st);
}

}  // namespace

extern "C" int madpp_nms_keep(const void* boxes, const void* scores, void* keep, int B, int K,
                              float thr, void* stream) {
  if (B < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  DeviceState* st = nullptr;
  cudaError_t err = device_state(&st);
  if (err != cudaSuccess) return (int)err;
  const unsigned c = cluster_size(*st, B, K);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)B * c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(K);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nms_keep_kernel, (const float*)boxes, (const float*)scores, (bool*)keep, K, thr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The cluster size a launch at (B, K) takes on the current device, or minus
// the CUDA error code.
extern "C" int madpp_nms_keep_cluster(int B, int K) {
  if (B < 1 || K < 1 || K > kMaxK) return -(int)cudaErrorInvalidValue;
  DeviceState* st = nullptr;
  const cudaError_t err = device_state(&st);
  return err == cudaSuccess ? (int)cluster_size(*st, B, K) : -(int)err;
}


// --- The large instance: K > 1,024 ------------------------------------------
//
// Two kernels on the stream, with the contract above at any K:
//  1. Mask (`nms_mask_kernel`).  Word w of row i, bit k: candidate
//     j = 32 w + k > i has iou(i, j) > thr, as `iou_above` decides it (the
//     contracted union and the exact __fdiv_rn; boxes that do not overlap
//     give IoU 0 without the division).  A block takes 32 rows (group g)
//     and 8 words (256 columns, their boxes in shared memory), a warp a
//     word, a lane a row; only the words the scan reads, w >= g, are
//     written.  A warp whose word lies past its rows' own word and holds a
//     bit sets those rows in `nz` (word g of the image, one atomicOr).
//  2. Scan (`nms_scan_kernel`), a block an image, in score order a word at
//     a time as the instance above scans: `removed` (a word a 32
//     candidates, in shared memory) starts as the dead candidates and those
//     past K; warp 0 takes word w's candidates, solves the word's own
//     suppressions from its rows' diagonal words (the fixpoint keep = cand
//     & ~OR_{b kept} diag_b) and writes their keep bits; then every thread
//     ORs the kept rows that have a later bit (`nz`) into the later words
//     it owns (x = tid mod blockDim).  One barrier a word, two when a kept
//     row has later bits.
// Workspace (the wrapper's, cached): the mask, B K W words (row i of image
// b at (b K + i) W), and `nz`, B W words, cleared by the launcher.  Bound
// at (64, 8,400): 2.26 G IoU pairs of 16 operations, 0.54 ms at 67 TFLOP/s
// float32, over 565 MB of mask written and read, 0.34 ms at 3.35 TB/s.
namespace {

constexpr int kMaskRows = 32, kMaskWords = 8;  // a mask block: 32 rows x 8 words
constexpr int kMaskThreads = kMaskRows * kMaskWords;
constexpr int kScanThreads = 256;

__device__ __forceinline__ float4 load_box(const float* bx, int i) {
  return make_float4(__ldg(bx + 4 * i), __ldg(bx + 4 * i + 1), __ldg(bx + 4 * i + 2), __ldg(bx + 4 * i + 3));
}

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ boxes, unsigned* __restrict__ mask, unsigned* __restrict__ nz, int K,
                int W, float thr) {
  __shared__ float4 s_box[kMaskThreads];
  __shared__ float2 s_wh[kMaskThreads];
  const int g = blockIdx.y, w0 = blockIdx.x * kMaskWords;
  if (w0 + kMaskWords - 1 < g) return;  // every word left of the rows' own
  const size_t img = blockIdx.z;
  const float* bx = boxes + img * (size_t)K * 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = 32 * w0 + tid;  // this thread's column to stage
  const float4 c = j < K ? load_box(bx, j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  s_box[tid] = c;
  s_wh[tid] = make_float2(__fsub_rn(c.z, c.x), __fsub_rn(c.w, c.y));
  const int i = 32 * g + lane, w = w0 + warp;
  const float4 a = i < K ? load_box(bx, i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const bool zero_above = 0.0f > thr;  // iou 0: no overlap, or an empty intersection
  __syncthreads();
  if (w < g || w >= W) return;  // the warp's word: left of the rows' own, or past the last
  unsigned bits = 0u;
  if (i < K) {
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      const int jj = 32 * w + k;
      const float4 b = s_box[32 * warp + k];
      const float iw = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
      const float ih = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
      const bool above = (iw > 0.0f && ih > 0.0f) ? iou_above(a, area_a, b, s_wh[32 * warp + k], thr) : zero_above;
      bits |= (above && jj > i && jj < K) ? 1u << k : 0u;
    }
    mask[(img * (size_t)K + i) * (size_t)W + w] = bits;
  }
  const unsigned later = __ballot_sync(0xffffffffu, w > g && bits != 0u);
  if (lane == 0 && later != 0u) atomicOr(nz + img * (size_t)W + g, later);
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const float* __restrict__ scores, const unsigned* __restrict__ mask, const unsigned* __restrict__ nz,
                bool* __restrict__ keep, int K, int W) {
  extern __shared__ unsigned s_removed[];  // W words
  __shared__ unsigned s_todo[2];
  const size_t img = blockIdx.x;
  const float* sc = scores + img * (size_t)K;
  const unsigned* rows = mask + img * (size_t)K * (size_t)W;
  const unsigned* nz_img = nz + img * (size_t)W;
  bool* out = keep + img * (size_t)K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int x0 = 32 * warp; x0 < 32 * W; x0 += kScanThreads) {  // word x0 / 32 on warp x0 / 32 mod 8
    const int j = x0 + lane;
    const unsigned alive = __ballot_sync(0xffffffffu, j < K && sc[j] > 0.0f);  // NaN is dead
    if (lane == 0) s_removed[x0 >> 5] = ~alive;
  }
  __syncthreads();
  // Warp 0 reads word w's diagonal words and nz one word ahead.
  unsigned diag = 0u, nzw = 0u;
  if (warp == 0) {
    diag = lane < K ? rows[(size_t)lane * W] : 0u;
    nzw = nz_img[0];
  }
  for (int w = 0; w < W; ++w) {
    if (warp == 0) {
      const int i = 32 * w + lane;
      unsigned diag_next = 0u, nz_next = 0u;
      if (w + 1 < W) {
        diag_next = i + 32 < K ? rows[(size_t)(i + 32) * W + w + 1] : 0u;
        nz_next = nz_img[w + 1];
      }
      const unsigned cand = ~s_removed[w];
      unsigned kept = cand;
      if (__ballot_sync(0xffffffffu, ((cand >> lane) & 1u) && (diag & cand) != 0u) != 0u) {
        for (;;) {
          const unsigned next = cand & ~__reduce_or_sync(0xffffffffu, (kept >> lane) & 1u ? diag : 0u);
          if (next == kept) break;
          kept = next;
        }
      }
      if (i < K) out[i] = (kept >> lane) & 1u;
      if (lane == 0) s_todo[w & 1] = kept & nzw;
      diag = diag_next;
      nzw = nz_next;
    }
    __syncthreads();
    unsigned todo = s_todo[w & 1];
    if (todo == 0u) continue;
    for (int x = tid; x < W; x += kScanThreads) {
      if (x <= w) continue;
      unsigned v = 0u;
      for (unsigned m = todo; m != 0u; m &= m - 1u) v |= rows[(size_t)(32 * w + __ffs(m) - 1) * W + x];
      s_removed[x] |= v;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int madpp_nms_keep_large(const void* boxes, const void* scores, void* keep, void* mask, void* nz, int B,
                                    int K, float thr, void* stream) {
  if (B < 1 || K < 1 || B > 65535 || mask == nullptr || nz == nullptr) return (int)cudaErrorInvalidValue;
  const int W = words(K);
  if (W > 65535 || (size_t)W * sizeof(unsigned) > 48 * 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(nz, 0, (size_t)B * W * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((W + kMaskWords - 1) / kMaskWords), (unsigned)W, (unsigned)B);
  nms_mask_kernel<<<grid, kMaskThreads, 0, st>>>((const float*)boxes, (unsigned*)mask, (unsigned*)nz, K, W, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<B, kScanThreads, (size_t)W * sizeof(unsigned), st>>>((const float*)scores, (const unsigned*)mask,
                                                                        (const unsigned*)nz, (bool*)keep, K, W);
  return (int)cudaGetLastError();
}

