// Kernel K4: the standalone greedy IoU association, one (T, D) matrix per
// launch.
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
// Instances, chosen by shape (`general_launch`): the one above for T <= 128
// and D <= 64; for larger tables, up to 4,096 rows and 4,096 columns, a
// thread block cluster of up to 16 blocks of 1,024 threads (association.cuh,
// "The general instance"), whose rounds exchange their bests through
// distributed shared memory.  The cluster takes its keys by one of two
// routes (`staged_route`):
//  - in the cluster, where they fit in its shared memory up to 1,024 rows
//    and columns: each block computes the keys of its rows and of its
//    columns from the matrix (`stage_rows`, `stage_cols`), each key twice,
//    and its first bests from its lines;
//  - staged, where they do not fit ((1,024, 1,024) and beyond) or beyond
//    1,024 lines: two kernels on the stream.  `associate_stage_kernel`
//    computes each key once over the whole card (association.cuh, "Staging
//    over the whole card") into a device scratch the wrapper allocates,
//    both layouts, and each line's best entry in each chunk of 32 entries,
//    a column's with a row that holds it, stored in place: no atomic, so
//    nothing to clear first.  The cluster kernel may start while it
//    finishes (programmatic dependent launch), loads the ranks meanwhile,
//    then takes each line's first best and chunk masks from those chunk
//    bests (`staged_firsts`) and runs the masked rounds, which read only
//    the chunks with an eligible key.
// Bound at (1,024, 1,024): the 4 MB matrix read once, 1.25 us at 3.35
// TB/s; at (4,096, 4,096) the 64 MB one, 20 us.  The staged route reads it
// once and writes 2 keys an entry.  The wrapper checks the limits.

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

// The in-cluster route's staging: the row lines of this block's rows and
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

// The staged route's device scratch: every block's key lines (block r's at
// r assoc_key_words), then each row line's best entry in each of its
// chunks of 32 columns, each column line's in each of its chunks of 32 rows
// with a row that holds it (0 where the chunk holds no eligible key), all
// written by `associate_stage_kernel`.
struct StagedScratch {
  unsigned* keys;
  unsigned long long *rowpart, *colpart;  // [T][rch], [D][cch]
  int* colrow;                            // [D][cch]
  int rch, cch;                           // chunks of a row line, of a column line
};

__host__ __device__ inline size_t staged_words(const AssocPlan& p, int T, int D) {
  const size_t rch = (D + 31) / 32, cch = (T + 31) / 32;
  return ((size_t)p.cluster * assoc_key_words(p) + 2 * T * rch + 3 * D * cch + 3) & ~(size_t)3;
}

__device__ inline StagedScratch staged_scratch(unsigned* scratch, const AssocPlan& p, int T, int D) {
  StagedScratch s;
  s.rch = (D + 31) / 32;
  s.cch = (T + 31) / 32;
  s.keys = scratch;
  s.rowpart = reinterpret_cast<unsigned long long*>(scratch + (size_t)p.cluster * assoc_key_words(p));
  s.colpart = s.rowpart + (size_t)T * s.rch;
  s.colrow = reinterpret_cast<int*>(s.colpart + (size_t)D * s.cch);
  return s;
}

// The stage kernel (association.cuh, "Staging over the whole card"): a
// warp's kRows rows by 32 columns, every load in flight at once, each key
// written to its row line and, through the transpose, to its column line;
// each entry's 64-bit key the rounds' own (`line_entry`: the IoU key, then
// the inverted tie-break key rank * D + d + 2^31 in wrapping 32-bit
// arithmetic), so that a chunk's best is the rounds' best of it on every
// rank, tied or at int32's ends.  A warp's 32 columns are one chunk of its
// rows; its 32 rows one chunk of its columns in big tiles, and in small
// tiles the block's 4 row groups together.
template <int kRows>
__global__ void __launch_bounds__(kStageThreads)
associate_stage_kernel(const float* __restrict__ iou, const int* __restrict__ rank, int T, int D, float thr,
                       AssocPlan a, unsigned* __restrict__ scratch) {
  constexpr int kBlockRows = 4 * kRows;
  __shared__ unsigned s_base[kBlockRows];  // each row's tie-break base, rank * D + 2^31
  __shared__ unsigned s_tile[kStageThreads / 32][kRows][33];
  __shared__ unsigned long long s_cbest[4][kStageCols];
  __shared__ int s_crow[4][kStageCols];
  grid_launch_dependents();  // the cluster kernel loads its ranks meanwhile
  const StagedScratch ss = staged_scratch(scratch, a, T, D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, rg = warp >> 1, cg = warp & 1;
  const int t_blk = blockIdx.y * kBlockRows, d_blk = blockIdx.x * kStageCols;
  const int t0 = t_blk + kRows * rg, d0 = d_blk + 32 * cg, d = d0 + lane;
  float v[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) v[i] = (t0 + i < T && d < D) ? __ldg(iou + (size_t)(t0 + i) * D + d) : -1.0f;
  if (tid < kBlockRows)
    s_base[tid] = t_blk + tid < T ? (unsigned)__ldg(rank + t_blk + tid) * (unsigned)D + 0x80000000u : 0u;
  __syncthreads();
  const unsigned* base = s_base + kRows * rg;
  unsigned (*tile)[33] = s_tile[warp];
  unsigned* rowline = stage_row_line(ss.keys, a, t0);
  unsigned* colline = stage_col_line(ss.keys, a, d0);
  unsigned long long cbest = 0ull;  // lane by column: column d's best of the warp's rows, and its row
  int crow = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const unsigned k = assoc_key(v[i], thr);
    tile[i][lane] = k;
    if (t0 + i < T && d < a.rstride) rowline[(size_t)i * a.rstride + d] = k;  // zero past D
    const unsigned long long e = line_entry(k, true, base[i] + (unsigned)d);
    if (e > cbest) cbest = e, crow = t0 + i;
  }
  __syncwarp();
  const unsigned long long rbest = stage_transpose<kRows>(tile, colline, a, D, t0, d0, [&](unsigned k, int i, int dk) {
    return line_entry(k, true, base[i] + (unsigned)dk);
  });
  if (lane < kRows && t0 + lane < T && d0 < D) ss.rowpart[(size_t)(t0 + lane) * ss.rch + (d0 >> 5)] = rbest;
  if constexpr (kRows == 32) {
    if (d < D && t0 < T) {
      const size_t at = (size_t)d * ss.cch + (t0 >> 5);
      ss.colpart[at] = cbest;
      ss.colrow[at] = crow;
    }
  } else {
    s_cbest[rg][32 * cg + lane] = cbest;
    s_crow[rg][32 * cg + lane] = crow;
    __syncthreads();
    if (tid < kStageCols && d_blk + tid < D) {
      unsigned long long b = s_cbest[0][tid];
      int r = s_crow[0][tid];
#pragma unroll
      for (int q = 1; q < 4; ++q)
        if (s_cbest[q][tid] > b) b = s_cbest[q][tid], r = s_crow[q][tid];
      const size_t at = (size_t)(d_blk + tid) * ss.cch + (t_blk >> 5);
      ss.colpart[at] = b;
      ss.colrow[at] = r;
    }
  }
}

// The staged route's first bests: each of this block's lines' best (every
// row live, every column untaken) as the maximum of its chunk bests, a
// column's row the one its best chunk names, and each line's chunk masks
// (association.cuh `LineMasks`, `rmask` and `cmask` the words of the
// block's rows and columns), a bit where its chunk best is not 0: a warp a
// line, lane c chunk c of each mask word.
__device__ inline void staged_firsts(const StagedScratch& ss, const AssocShared& s, unsigned* rmask, unsigned* cmask,
                                     int2 rows, int2 cols) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int l = threadIdx.x >> 5; l < rows.y + cols.y; l += nwarps) {
    const bool is_row = l < rows.y;
    const int i = is_row ? l : l - rows.y, n = is_row ? ss.rch : ss.cch, words = (n + 31) >> 5;
    const size_t at = is_row ? (size_t)(rows.x + i) * ss.rch : (size_t)(cols.x + i) * ss.cch;
    const unsigned long long* part = (is_row ? ss.rowpart : ss.colpart) + at;
    unsigned long long v[4];
    int r[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int c = 32 * w + lane;
      v[w] = c < n ? part[c] : 0ull;
      r[w] = !is_row && c < n ? ss.colrow[at + c] : 0;
    }
    unsigned* mask = is_row ? rmask + (size_t)i * words : cmask + (size_t)i * words;
    unsigned long long best = 0ull;
    int row = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (v[w] > best) best = v[w], row = r[w];
      const unsigned bits = __ballot_sync(0xffffffffu, v[w] != 0ull);
      if (lane == 0 && w < words) mask[w] = bits;
    }
    if (is_row) {
      best = warp_max_u64(best);
      if (lane == 0) s.rowbest[i] = best;
    } else {
      int arg;
      best = col_best_of_warp(best, row, &arg);
      if (lane == 0) s.colbest[i] = best, s.colrow[i] = arg;
    }
  }
}

// The general instance: one cluster (`assoc_plan`) for the matrix.  Each
// block loads every row's rank, then takes its lines' keys and first bests
// by its route, runs the cluster rounds and writes its rows' matches.
// Staged: `scratch` is the stage kernel's (`StagedScratch`), the chunk
// masks in shared memory after the rounds'; else the keys go to shared
// memory and `scratch` is null.
template <bool kStaged>
__global__ void __launch_bounds__(kAssocClusterThreads)
associate_general_kernel(const float* __restrict__ iou, const int* __restrict__ rank, int* __restrict__ match,
                         int T, int D, float thr, AssocPlan p, unsigned* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned s_general[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int me = (int)cluster.block_rank();
  const AssocShared s = assoc_carve(s_general, p, !kStaged);
  const int2 rows = assoc_span(me, p.rows, T), cols = assoc_span(me, p.cols, D);
  PHASE_MARK(0);
  assoc_init(s, p);
  for (int t = threadIdx.x; t < T; t += blockDim.x) s.rank[t] = rank[t];
  PHASE_MARK(1);
  if constexpr (kStaged) {
    const StagedScratch ss = staged_scratch(scratch, p, T, D);
    unsigned* rowkeys = ss.keys + (size_t)me * assoc_key_words(p);
    unsigned* rmask = s_general + assoc_shared_bytes(p, false) / 4;
    unsigned* cmask = rmask + (size_t)p.rows * mask_words(D);
    grid_dependency_wait();  // the stage kernel's keys and chunk bests
    staged_firsts(ss, s, rmask, cmask, rows, cols);
    __syncthreads();
    PHASE_MARK(2);
    cluster_associate<true>(s, rowkeys, rowkeys + (size_t)p.rows * p.rstride, p, T, D, true,
                            LineMasks{rmask, cmask, mask_words(D), mask_words(T)});
  } else {
    unsigned* colkeys = s.keys + (size_t)p.rows * p.rstride;
    const int rw = 32 * row_warps(p, rows, cols);
    if ((int)threadIdx.x < rw) {
      stage_rows(iou, D, thr, s.keys, p, rows, threadIdx.x, rw);
    } else {
      stage_cols(iou, T, D, thr, colkeys, p, cols, threadIdx.x - rw, blockDim.x - rw);
    }
    __syncthreads();
    PHASE_MARK(2);
    cluster_associate(s, s.keys, colkeys, p, T, D);
  }
  PHASE_MARK(3);
  for (int i = threadIdx.x; i < rows.y; i += blockDim.x) match[rows.x + i] = s.match[i];
  PHASE_MARK(4);
  // No block leaves before every block has received its last bests.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The route of the general instance at (T, D) on the cluster `p`: staged
// where the keys do not fit in its shared memory (`keys_fit`), beyond 1,024
// lines, and where a block's column lines hold at least 4 times the keys
// of its row lines: on such tall tables the few blocks that own columns
// stage T-long lines while the others wait.  Else in the cluster, whose
// rounds read the lines from shared memory.  (`split_compare.py --routes`
// times both; on an H100 the staged route won by 17-25% at (512, 64),
// (768, 64), (1,024, 64) and (1,025, 64), column lines 5.4-8 times the row
// lines', and lost by 4-19% at (64, 300), (160, 80), (256, 128), (384,
// 128) and (512, 512), at most 2 times.)
bool staged_route(const AssocPlan& p, int T, int D, bool keys_fit) {
  return !keys_fit || T > 1024 || D > 1024 || (size_t)p.cols * p.cstride >= 4 * (size_t)p.rows * p.rstride;
}

// The general instance's launch plan at (T, D): the cluster, the route and
// the cluster kernel's shared memory a block (the staged route's chunk
// masks after the rounds').
struct GeneralLaunch {
  AssocPlan plan;
  bool staged;
  size_t smem;
};

GeneralLaunch general_launch(int T, int D) {
  GeneralLaunch g;
  g.plan = assoc_plan(T, D);
  g.staged = staged_route(g.plan, T, D, assoc_shared_bytes(g.plan, true) <= kAssocSmemLimit);
  g.smem = g.staged ? assoc_shared_bytes(g.plan, false) +
                          4 * ((size_t)g.plan.rows * mask_words(D) + (size_t)g.plan.cols * mask_words(T))
                    : assoc_shared_bytes(g.plan, true);
  return g;
}

bool is_general(int T, int D) { return T > kMaxT || D > kMaxD; }

// One launch of the cluster kernel's instance; staged, after the stage
// kernel, it may start while that one finishes.
template <bool kStaged>
cudaError_t launch_cluster(const GeneralLaunch& g, const float* iou, const int* rank, int* match, int T, int D,
                           float thr, unsigned* scratch, cudaStream_t st) {
  cudaError_t err = allow_dynamic_smem<associate_general_kernel<kStaged>>(g.smem);
  if (err == cudaSuccess && g.plan.cluster > 8)
    err = cudaFuncSetAttribute(associate_general_kernel<kStaged>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)g.plan.cluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  return launch_after(kStaged, associate_general_kernel<kStaged>, dim3((unsigned)g.plan.cluster),
                      dim3(kAssocClusterThreads), g.smem, st, &cluster, iou, rank, match, T, D, thr, g.plan, scratch);
}

}  // namespace

// Words of device scratch the launch at (T, D) needs (0: none, the small
// instance runs or the cluster stages the keys itself), or -1 outside the
// limits.
extern "C" long long madpp_associate_scratch(int T, int D) {
  if (T < 1 || D < 1 || T > kAssocGeneralMax || D > kAssocGeneralMax) return -1;
  if (!is_general(T, D)) return 0;
  const GeneralLaunch g = general_launch(T, D);
  return g.staged ? (long long)staged_words(g.plan, T, D) : 0;
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_general(T, D)) {
    const GeneralLaunch g = general_launch(T, D);
    const float* x = (const float*)iou;
    const int* r = (const int*)rank;
    if (!g.staged) return (int)launch_cluster<false>(g, x, r, (int*)match, T, D, thr, nullptr, st);
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    unsigned* sc = (unsigned*)scratch;
    const bool big = stage_big_tiles(g.plan, 1);
    if (big) {
      associate_stage_kernel<32><<<stage_grid(g.plan, 1, true), kStageThreads, 0, st>>>(x, r, T, D, thr, g.plan, sc);
    } else {
      associate_stage_kernel<8><<<stage_grid(g.plan, 1, false), kStageThreads, 0, st>>>(x, r, T, D, thr, g.plan, sc);
    }
    cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) err = launch_cluster<true>(g, x, r, (int*)match, T, D, thr, sc, st);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  const size_t smem = sizeof(unsigned) * 32 * (size_t)((T + 31) / 32) * (size_t)assoc_key_stride(D);
  associate_kernel<<<1, kThreads, smem, st>>>((const float*)iou, (const int*)rank, (int*)match, T, D, thr);
  return (int)cudaGetLastError();
}

#ifdef MADPP_PHASE_CLOCKS
// The phase clocks of the last general launch (block.cuh `PHASE_MARK`):
// for each of kPhaseBlocks blocks, clock64() at the start and at the end of
// the rank loads, the staging, the rounds and the match write.  Copies the
// kPhaseBlocks x kPhaseMarks reads to host memory `out`; returns the CUDA
// error code.
extern "C" int madpp_associate_phases(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));
}
#endif
