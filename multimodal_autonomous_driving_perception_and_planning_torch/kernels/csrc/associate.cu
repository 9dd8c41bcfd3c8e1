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
// and for larger tables, up to 4,096 rows and 4,096 columns, a thread block
// cluster of up to 16 blocks of 1,024 threads (association.cuh, "The
// general instance"): each block stages the keys of its rows and columns
// once, in shared memory or, where they do not fit (1,024 x 1,024 and
// beyond), in a device scratch the wrapper allocates, and the rounds
// exchange their bests through distributed shared memory.  Bound at
// (1,024, 1,024): the 4 MB matrix read once, 1.25 us at 3.35 TB/s, and
// at (4,096, 4,096) the 64 MB one, 20 us; the design reads it once a
// launch and then only keys.  The wrapper checks the limits.

#include <cooperative_groups.h>
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

// The general instance's staging: the row lines of this block's rows and
// the column lines of its columns, as keys, from `iou` in device memory.
// Both keep several loads in flight a thread (a load a step, then its
// store, left each thread waiting on device memory once an entry), and
// the block's warps split between them by their entries, so that both
// start loading at once.
// Each takes threads `idx` of `nthreads`.
//
// Row lines: 16-byte loads, four in flight, when every row starts 16-byte
// aligned (D a multiple of 4, the lines then the rows themselves), else
// 4-byte loads, eight in flight.
__device__ inline void stage_rows(const float* iou, int D, float thr, unsigned* rowkeys, const AssocPlan& p,
                                  int2 rows, int idx, int nthreads) {
  const int n = rows.y * p.rstride;
  const float* src = iou + (size_t)rows.x * D;
  if ((D & 3) == 0 && aligned16(iou)) {
    const int n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(rowkeys);
    for (int x0 = idx; x0 < n4; x0 += 4 * nthreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = x0 + u * nthreads < n4 ? __ldg(s4 + x0 + u * nthreads) : make_float4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (x0 + u * nthreads < n4)
          d4[x0 + u * nthreads] = make_uint4(assoc_key(v[u].x, thr), assoc_key(v[u].y, thr),
                                             assoc_key(v[u].z, thr), assoc_key(v[u].w, thr));
    }
    return;
  }
  for (int x0 = idx; x0 < n; x0 += 8 * nthreads) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int x = x0 + u * nthreads, i = x / p.rstride, d = x - i * p.rstride;
      v[u] = (x < n && d < D) ? __ldg(src + (size_t)i * D + d) : -1.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (x0 + u * nthreads < n) rowkeys[x0 + u * nthreads] = assoc_key(v[u], thr);
  }
}

// Column lines: a thread takes row t and 16 of this block's columns at a
// time (four 16-byte loads where aligned) along the row, consecutive
// threads consecutive rows, so that the stores of a column line's words
// sit side by side.
__device__ inline void stage_cols(const float* iou, int T, int D, float thr, unsigned* colkeys, const AssocPlan& p,
                                  int2 cols, int idx, int nthreads) {
  const bool vec = (D & 3) == 0 && aligned16(iou);  // then cols.y and each row's start are multiples of 4
  const int n = p.cstride * ((cols.y + 15) >> 4);
  for (int x = idx; x < n; x += nthreads) {
    const int c = x / p.cstride, t = x - c * p.cstride, j0 = 16 * c;
    const float* row = iou + (size_t)t * D + cols.x;
    float v[16];
    if (t < T && vec) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 a = j0 + 4 * q < cols.y ? __ldg(reinterpret_cast<const float4*>(row + j0) + q)
                                             : make_float4(-1, -1, -1, -1);
        v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z, v[4 * q + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = (t < T && j0 + u < cols.y) ? __ldg(row + j0 + u) : -1.0f;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (j0 + u < cols.y) colkeys[(size_t)(j0 + u) * p.cstride + t] = assoc_key(v[u], thr);
  }
}

// The block's warps for the row lines, by the share of its entries they
// hold (at least one warp for each kind that has entries).
__device__ inline int row_warps(const AssocPlan& p, int2 rows, int2 cols) {
  const int nr = rows.y * p.rstride, nc = cols.y * p.cstride, warps = blockDim.x >> 5;
  if (nc == 0) return warps;
  if (nr == 0) return 0;
  return min(warps - 1, max(1, (int)(((long long)warps * nr + (nr + nc) / 2) / (nr + nc))));
}

// The general instance: one cluster (`assoc_plan`) for the matrix.  Each
// block loads every row's rank, stages the keys of its rows and columns
// (`stage_rows`, `stage_cols`) and runs the cluster rounds.  `scratch`
// holds the key lines when they do not fit in shared memory (block r's at
// r assoc_key_words), else is null.
__global__ void __launch_bounds__(kAssocClusterThreads)
associate_general_kernel(const float* __restrict__ iou, const int* __restrict__ rank, int* __restrict__ match,
                         int T, int D, float thr, AssocPlan p, unsigned* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned s_general[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int me = (int)cluster.block_rank();
  const AssocShared s = assoc_carve(s_general, p, scratch == nullptr);
  unsigned* rowkeys = scratch ? scratch + (size_t)me * assoc_key_words(p) : s.keys;
  unsigned* colkeys = rowkeys + (size_t)p.rows * p.rstride;
  const int2 rows = assoc_span(me, p.rows, T), cols = assoc_span(me, p.cols, D);
  assoc_init(s, p);
  for (int t = threadIdx.x; t < T; t += blockDim.x) s.rank[t] = rank[t];
  const int rw = 32 * row_warps(p, rows, cols);
  if ((int)threadIdx.x < rw) {
    stage_rows(iou, D, thr, rowkeys, p, rows, threadIdx.x, rw);
  } else {
    stage_cols(iou, T, D, thr, colkeys, p, cols, threadIdx.x - rw, blockDim.x - rw);
  }
  __syncthreads();
  cluster_associate(s, rowkeys, colkeys, p, T, D);
  for (int i = threadIdx.x; i < rows.y; i += blockDim.x) match[rows.x + i] = s.match[i];
  // No block leaves before every block has received its last bests.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The general instance's launch plan at (T, D): the cluster, whether the
// key lines fit in shared memory, and its bytes a block.
struct GeneralLaunch {
  AssocPlan plan;
  bool keys_in_smem;
  size_t smem;
};

GeneralLaunch general_launch(int T, int D) {
  GeneralLaunch g;
  g.plan = assoc_plan(T, D);
  g.keys_in_smem = assoc_shared_bytes(g.plan, true) <= kAssocSmemLimit;
  g.smem = assoc_shared_bytes(g.plan, g.keys_in_smem);
  return g;
}

bool is_general(int T, int D) { return T > kMaxT || D > kMaxD; }

}  // namespace

// Words of device scratch the launch at (T, D) needs (0: none, the keys
// fit in shared memory or the small instance runs), or -1 outside the
// limits.
extern "C" long long madpp_associate_scratch(int T, int D) {
  if (T < 1 || D < 1 || T > kAssocGeneralMax || D > kAssocGeneralMax) return -1;
  if (!is_general(T, D)) return 0;
  const GeneralLaunch g = general_launch(T, D);
  return g.keys_in_smem ? 0 : (long long)(assoc_key_words(g.plan) * g.plan.cluster);
}

// The cluster size the launch at (T, D) takes (1 for the small instance's
// single block), or -1 outside the limits.
extern "C" int madpp_associate_cluster(int T, int D) {
  if (T < 1 || D < 1 || T > kAssocGeneralMax || D > kAssocGeneralMax) return -1;
  return is_general(T, D) ? assoc_plan(T, D).cluster : 1;
}

extern "C" int madpp_associate(const void* iou, const void* rank, void* match, int T, int D, float thr,
                               void* scratch, void* stream) {
  if (T < 1 || D < 1 || T > kAssocGeneralMax || D > kAssocGeneralMax) return (int)cudaErrorInvalidValue;
  if (is_general(T, D)) {
    const GeneralLaunch g = general_launch(T, D);
    if (!g.keys_in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_dynamic_smem<associate_general_kernel>(g.smem);
    if (err == cudaSuccess && g.plan.cluster > 8)
      err = cudaFuncSetAttribute(associate_general_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)g.plan.cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)g.plan.cluster);
    cfg.blockDim = dim3(kAssocClusterThreads);
    cfg.dynamicSmemBytes = g.smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, associate_general_kernel, (const float*)iou, (const int*)rank, (int*)match, T,
                             D, thr, g.plan, g.keys_in_smem ? (unsigned*)nullptr : (unsigned*)scratch);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(unsigned) * 32 * (size_t)((T + 31) / 32) * (size_t)assoc_key_stride(D);
  associate_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>((const float*)iou, (const int*)rank,
                                                               (int*)match, T, D, thr);
  return (int)cudaGetLastError();
}
