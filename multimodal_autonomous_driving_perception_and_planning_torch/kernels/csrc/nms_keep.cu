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

#include "block.cuh"

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
// Two kernels on the stream, with the contract above at any K.  The mask
// (K W words an image, 8.8 MB at 8,400) no longer fits in shared memory, so
// it goes to a device workspace the wrapper allocates and caches.  Bound at
// (64, 8,400): 2.26 G IoU pairs of 16 operations, 0.54 ms at 67 TFLOP/s
// float32, beside about 283 MB of mask written once and read in part, 85 us
// at 3.35 TB/s: the mask kernel is bound by its instructions, the scan by
// its chain of words.
//
// Layout.  Only the words the scan reads are stored: row i of row group
// g = i / 32 keeps words g .. W - 1, in a segment of S_g = 8 ceil((W - g) /
// 8) words (the tail zero), the 32 rows of a group side by side, the
// groups in order (`row_base`).  Every segment starts on a 32-byte sector,
// and an image takes 256 sum_u ceil(u / 8) words, about half of the K W of
// the wrapper's workspace (image b at b (K W rounded down to 8)).
//  1. Mask (`nms_mask_kernel`).  A block takes a row group and 64 of its
//     words (2,048 columns, their boxes and alive bits in shared memory), a
//     warp 8 of them: lane b is row 32 g + b and stores its 8 words as two
//     16-byte stores, one whole sector.  The grid covers the upper triangle
//     of (row group, 64 words) only (`tri_group`); a row group whose rows
//     are all dead leaves at once, and a word whose candidates are all dead
//     takes no IoU (the scan reads such words only to OR them into words
//     already removed).  iou > thr is decided without the division, as the
//     instance above decides it (header, point 2): inter > union * hi or
//     inter < union * lo, the exact __fdiv_rn only between the two or where
//     the threshold or an area lies outside the proof's range.  A warp whose
//     words past the rows' own hold a bit sets those rows in `nz` (word g of
//     the image, one atomicOr).
//  2. Scan (`nms_scan_kernel`), a block an image, by tiles of 8 words (256
//     rows): each tile's diagonal block (its rows' words inside the tile) is
//     staged into shared memory two tiles ahead (`cp.async`, double-
//     buffered), and warp 0 solves the tile's words from shared memory
//     alone: word w's candidates (not removed) all kept where none
//     suppresses another (one ballot), else kept in score order, a kept one
//     at a time removing those it suppresses (each lane alike, from the
//     staged rows: the fixpoint keep = cand & ~OR_{b kept} diag_b in as
//     many steps as kept candidates, where iterating it took a warp
//     reduction for each link of the word's longest chain); then each
//     kept row's later words inside the tile ORed into their removed bits
//     by warp reductions, all seven independent.  Then the whole
//     block ORs the tile's kept rows that have a later bit (`nz`, staged
//     once) into every word past the tile, a thread a word (at most three:
//     K <= 49,152), the loads of a row's words side by side and every load
//     of eight rows in flight.  Two barriers a tile where one word took one
//     or two before.
namespace {

constexpr int kMaskWarps = 8;
constexpr int kMaskThreads = 32 * kMaskWarps;
constexpr int kChunkWords = 8 * kMaskWarps;  // a mask block's words of each row: a sector a warp
constexpr int kTileWords = 8;                // a scan tile's words
constexpr int kTileRows = 32 * kTileWords;
constexpr int kScanThreads = 512;
constexpr int kScanOwn = 3;  // words past a tile a scan thread ORs: W <= 1,536 (K <= 49,152)

// sum_{u = 1 .. n} ceil(u / m), for even m.
__host__ __device__ inline long long ceil_sum(long long n, long long m) {
  const long long q = n / m, r = n % m;
  return (q + 1) * (m / 2 * q + r);
}

// The words an image's mask takes, and the offset of row i's segment in it.
__host__ __device__ inline size_t image_words(int W) { return 256 * (size_t)ceil_sum(W, 8); }

__device__ __forceinline__ size_t row_base(int i, int W) {
  const int g = i >> 5;
  const size_t seg = 8 * (size_t)((W - g + 7) >> 3);
  return 256 * (size_t)(ceil_sum(W, 8) - ceil_sum(W - g, 8)) + (size_t)(i & 31) * seg;
}

// The row group and chunk of mask block `L` of an image: blocks go group by
// group, ceil((W - g) / 64) for group g, so the groups before g take
// cs(W) - cs(W - g) of them (cs = ceil_sum(., 64)).
__device__ __forceinline__ int2 tri_group(long long L, int W) {
  const long long total = ceil_sum(W, kChunkWords);
  int lo = 0, hi = W - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (total - ceil_sum(W - mid, kChunkWords) <= L) lo = mid;
    else hi = mid - 1;
  }
  return make_int2(lo, (int)(L - (total - ceil_sum(W - lo, kChunkWords))));
}

__device__ __forceinline__ float4 load_box(const float* bx, int i) {
  return make_float4(__ldg(bx + 4 * i), __ldg(bx + 4 * i + 1), __ldg(bx + 4 * i + 2), __ldg(bx + 4 * i + 3));
}

// The mask kernel's dynamic shared memory: the chunk's column boxes, their
// (width, height), alive and area-range bits.
constexpr size_t kMaskSmem = (16 + 8) * 32 * kChunkWords + 2 * 4 * kChunkWords;

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ boxes, const float* __restrict__ scores, unsigned* __restrict__ mask,
                unsigned* __restrict__ nz, int K, int W, size_t img_stride, float thr) {
  extern __shared__ __align__(16) unsigned char s_mask_smem[];
  float4* s_box = reinterpret_cast<float4*>(s_mask_smem);
  float2* s_wh = reinterpret_cast<float2*>(s_box + 32 * kChunkWords);
  unsigned* s_alive = reinterpret_cast<unsigned*>(s_wh + 32 * kChunkWords);
  unsigned* s_ok = s_alive + kChunkWords;
  const size_t img = blockIdx.y;
  const int2 gc = tri_group(blockIdx.x, W);
  const int g = gc.x, w0 = g + kChunkWords * gc.y;  // the row group and the chunk's first word
  const float* bx = boxes + img * (size_t)K * 4;
  const float* sc = scores + img * (size_t)K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = 32 * g + lane;  // this lane's row
  const bool row_alive = i < K && sc[i] > 0.0f;  // NaN is dead
  if (!__syncthreads_or(row_alive)) return;  // every row of the group dead
  for (int x = tid; x < 32 * kChunkWords; x += kMaskThreads) {  // word x / 32 of the chunk on warp x / 32 mod 8
    const int j = 32 * w0 + x;
    const float4 c = j < K ? load_box(bx, j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float2 wh = make_float2(__fsub_rn(c.z, c.x), __fsub_rn(c.w, c.y));
    const float area = __fmul_rn(wh.x, wh.y);
    s_box[x] = c;
    s_wh[x] = wh;
    const unsigned alive = __ballot_sync(kFull, j < K && sc[j] > 0.0f);
    const unsigned ok = __ballot_sync(kFull, j >= K || (area >= kAreaLo && area <= kAreaHi));
    if (lane == 0) s_alive[x >> 5] = alive, s_ok[x >> 5] = ok;
  }
  const float4 a = i < K ? load_box(bx, i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const bool fast = thr >= kThrLo && thr <= kThrHi;
  const bool row_ok = area_a >= kAreaLo && area_a <= kAreaHi;
  const float hi = __fmul_rn(thr, 1.0f + kMargin), lo = __fmul_rn(thr, 1.0f - kMargin);
  __syncthreads();

  const int ws = w0 + 8 * warp;  // this warp's sector: words ws .. ws + 7
  if (ws >= W) return;
  unsigned bits[8];
  bool live = false, later = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int w = ws + e, x0 = 32 * (w - w0);
    unsigned b = 0u;
    if (w < W && s_alive[w - w0] != 0u) {  // warp-uniform
      live = true;
      unsigned slow = kFull;
      if (fast && s_ok[w - w0] == kFull) {  // warp-uniform: the band decides, the division rarely
        unsigned open = 0u;
#pragma unroll 8
        for (int k = 0; k < 32; ++k) {
          const float4 c = s_box[x0 + k];
          const float iw = __fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x));
          const float ih = __fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y));
          // Here every width is finite, so where the boxes do not overlap
          // the product is a zero (of either sign), which the comparisons
          // below decide as they decide the reference's +0.
          const float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
          const float uni = contracted_union(area_a, s_wh[x0 + k], inter);
          const bool above = inter > __fmul_rn(uni, hi), below = inter < __fmul_rn(uni, lo);
          b |= above ? 1u << k : 0u;
          open |= (above || below) ? 0u : 1u << k;
        }
        slow = row_ok ? open : kFull;
      }
      if (__any_sync(kFull, slow != 0u)) {  // rare: decide with the exact division
        while (slow != 0u) {
          const int k = __ffs(slow) - 1;
          slow &= slow - 1u;
          const bool above = iou_above(a, area_a, s_box[x0 + k], s_wh[x0 + k], thr);
          b = above ? b | 1u << k : b & ~(1u << k);
        }
      }
      if (w == g) b &= ~((2u << lane) - 1u);  // only j > i
      later |= w > g && b != 0u;
    }
    bits[e] = b;
  }
  if (live) {  // warp-uniform; a sector of dead words is never read but to OR it into removed words
    uint4* dst = reinterpret_cast<uint4*>(mask + img * img_stride + row_base(i, W) + (ws - g));
    dst[0] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
    dst[1] = make_uint4(bits[4], bits[5], bits[6], bits[7]);
  }
  const unsigned rows = __ballot_sync(kFull, later);
  if (lane == 0 && rows != 0u) atomicOr(nz + img * (size_t)W + g, rows);
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const float* __restrict__ scores, const unsigned* __restrict__ mask, const unsigned* __restrict__ nz,
                bool* __restrict__ keep, int K, int W, size_t img_stride) {
  extern __shared__ unsigned s_scan_smem[];
  unsigned* s_removed = s_scan_smem;  // W words
  unsigned* s_nz = s_scan_smem + W;   // W words: the image's nz
  __shared__ __align__(16) unsigned s_tile[2][kTileRows * kTileWords];  // row r of the tile: words 8 r ..
  __shared__ long long s_base[kTileRows];  // the tile's kept rows with a later bit: row_base - own word
  __shared__ int s_n;
  const size_t img = blockIdx.x;
  const float* sc = scores + img * (size_t)K;
  const unsigned* m_img = mask + img * img_stride;
  const unsigned* nz_img = nz + img * (size_t)W;
  bool* out = keep + img * (size_t)K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NT = (W + kTileWords - 1) / kTileWords;
  for (int x0 = 32 * warp; x0 < 32 * W; x0 += kScanThreads) {  // removed: the dead and those past K
    const int j = x0 + lane;
    const unsigned alive = __ballot_sync(kFull, j < K && sc[j] > 0.0f);  // NaN is dead
    if (lane == 0) s_removed[x0 >> 5] = ~alive;
  }
  for (int x = tid; x < W; x += kScanThreads) s_nz[x] = nz_img[x];
  // Tile t's diagonal block into s_tile[t & 1]: row 256 t + r's words 8 t ..
  // 8 t + 7 from its own word on (those before it are never read).  One
  // commit group a call, empty past the last tile.
  auto stage = [&](int t) {
    if (t < NT) {
      for (int e = tid; e < kTileRows * kTileWords; e += kScanThreads) {
        const int r = kTileRows * t + (e >> 3), w = kTileWords * t + (e & 7);
        if (r < K && w < W && w >= (r >> 5)) cp_async4(&s_tile[t & 1][e], m_img + row_base(r, W) + (w - (r >> 5)));
      }
    }
    cp_async_commit();
  };
  stage(0);
  stage(1);
  for (int t = 0; t < NT; ++t) {
    cp_async_wait_group<1>();
    __syncthreads();  // tile t staged; the last tile's ORs landed
    if (warp == 0) {
      const unsigned* tile = s_tile[t & 1];
      const int w_first = kTileWords * t, nw = min(kTileWords, W - w_first);
      // Lane v < nw holds the removed bits of the tile's word v, and the nz
      // of its row group.
      unsigned rem = lane < nw ? s_removed[w_first + lane] : 0u;
      const unsigned nzw = lane < nw ? s_nz[w_first + lane] : 0u;
      int n = 0;
      for (int u = 0; u < nw; ++u) {
        const unsigned* rows = tile + 32 * u * kTileWords;  // row 32 (w_first + u) + b at rows + 8 b
        const unsigned* row = rows + lane * kTileWords;
        const unsigned diag = row[u];
        const unsigned cand = ~__shfl_sync(kFull, rem, u);
        unsigned kept = cand;
        if (__ballot_sync(kFull, ((cand >> lane) & 1u) && (diag & cand) != 0u) != 0u) {
          // In score order, a kept candidate at a time, each lane alike:
          // the first one left is kept and removes those it suppresses.
          kept = 0u;
          for (unsigned left = cand; left != 0u;) {
            const int b = __ffs(left) - 1;
            kept |= 1u << b;
            left &= ~(rows[b * kTileWords + u] | (1u << b));
          }
        }
        const int i = 32 * (w_first + u) + lane;
        const bool mine = (kept >> lane) & 1u;
        if (i < K) out[i] = mine;
#pragma unroll
        for (int v = 1; v < kTileWords; ++v) {  // the kept rows' later words inside the tile, independent
          const unsigned o = __reduce_or_sync(kFull, (mine && v > u && v < nw) ? row[v] : 0u);
          rem |= lane == v ? o : 0u;
        }
        const unsigned more = kept & __shfl_sync(kFull, nzw, u);  // kept rows with a later bit
        if ((more >> lane) & 1u)
          s_base[n + __popc(more & ((1u << lane) - 1u))] = (long long)row_base(i, W) - (w_first + u);
        n += __popc(more);
      }
      if (lane == 0) s_n = n;
    }
    __syncthreads();
    stage(t + 2);  // into the buffer warp 0 has just read
    const int n = s_n;
    if (n == 0) continue;
    // Each thread's words past the tile (at most kScanOwn), every load of a
    // batch of 8 rows in flight at once.
    const int x0 = kTileWords * (t + 1) + tid;
    unsigned v[kScanOwn] = {};
    for (int q = 0; q < n; q += 8) {
      unsigned u[8][kScanOwn];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const long long base = q + k < n ? s_base[q + k] : -1;
#pragma unroll
        for (int o = 0; o < kScanOwn; ++o) {
          const int x = x0 + o * kScanThreads;
          u[k][o] = (base >= 0 && x < W) ? m_img[base + x] : 0u;
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int o = 0; o < kScanOwn; ++o) v[o] |= u[k][o];
    }
#pragma unroll
    for (int o = 0; o < kScanOwn; ++o)
      if (x0 + o * kScanThreads < W) s_removed[x0 + o * kScanThreads] |= v[o];
  }
  cp_async_wait_group<0>();
}

}  // namespace

extern "C" int madpp_nms_keep_large(const void* boxes, const void* scores, void* keep, void* mask, void* nz, int B,
                                    int K, float thr, void* stream) {
  if (B < 1 || K < 1 || B > 65535 || mask == nullptr || nz == nullptr) return (int)cudaErrorInvalidValue;
  const int W = words(K);
  // The wrapper's workspace holds K W words an image; an image's mask takes
  // about half (`image_words`), each image on a sector.
  const size_t img_stride = ((size_t)K * W) & ~(size_t)7;
  if (W > kScanOwn * kScanThreads || image_words(W) > img_stride)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(nz, 0, (size_t)B * W * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  err = allow_dynamic_smem<nms_mask_kernel>(kMaskSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_sum(W, kChunkWords), (unsigned)B);
  nms_mask_kernel<<<grid, kMaskThreads, kMaskSmem, st>>>((const float*)boxes, (const float*)scores, (unsigned*)mask,
                                                 (unsigned*)nz, K, W, img_stride, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<B, kScanThreads, 2 * (size_t)W * sizeof(unsigned), st>>>(
      (const float*)scores, (const unsigned*)mask, (const unsigned*)nz, (bool*)keep, K, W, img_stride);
  return (int)cudaGetLastError();
}
