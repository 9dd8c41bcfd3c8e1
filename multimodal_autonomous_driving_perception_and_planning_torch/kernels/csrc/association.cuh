// The greedy mutual-max association fixpoint as a block-wide device
// function, shared by kernel K1 (tracker_step.cu) and the standalone
// association kernel K4 (associate.cu).
//
// What bounds the fixpoint on an H100: its matrix is at most 128 x 64, so
// a round is a few thousand comparisons.  The cost is the chain of
// dependent steps a round, not the bytes: a round spread over the block
// waits on barriers, shared atomics and shuffle trees (about 1.35 us a
// round on the card), and a warp alone issues an instruction only when
// the one it waits on is done.  So the design cuts instructions off the
// chain, with no atomic, and at most one barrier a round:
//  - once a launch, the whole block turns each entry into one 32-bit key
//    whose unsigned order is the IoU's among eligible entries (the IoU's
//    bits with -0 turned into +0, plus one; 0 for an entry that is not
//    eligible: below the threshold, negative, NaN), and each warp lists
//    its eligible ones by ballots (a shared atomic a step was several
//    times slower in a clocked build).  Each row's tie-break key is
//    rank * D + d in int32 arithmetic that wraps, as the plain version
//    computes it, offset by 2^31 so that it orders as an unsigned number;
//    (IoU key, inverted tie-break key) is one 64-bit key.
//  - Sparse rounds, when at most 32 entries are eligible (every matrix of
//    the paths: at most 19 on the synthetic stream): lane e of warp 0 holds
//    entry e and finds once, in one pass over the list, the entries of its
//    row or column (`conflict`) and those of them that beat it (`better`).
//    A round is then two ballots: an entry is taken when no live entry of
//    `better` is left, and retires when an entry of `conflict` is taken.
//  - Dense rounds otherwise, on a warp a 32 rows (ceil(T / 32) warps, one
//    on each of the SM's four schedulers at T = 128; one warp for all
//    rows took 4.5 us a (128, 64) round on the card): lane l of warp w
//    holds row 32 w + l, whose keys live in shared memory in rows padded to a
//    multiple of 16 columns, plus 4 words so that 16-byte loads of 32 rows
//    hit distinct banks.  A round reads the row 16 columns at a time with
//    16-byte loads, masks taken rows and columns with bits held in
//    registers, takes the row's best as a tree of 64-bit maxima, and each
//    column's best over the warp's rows as two warp reductions
//    (`__reduce_max_sync` of the IoU key, `__reduce_min_sync` of the
//    tie-break key among the rows at that maximum; a lane a column over
//    the warp's 32 rows, from 32 loads and a tree of compares, was slower
//    at (64, 16) and at (128, 64) on the card).  Lane 0 writes them to
//    shared memory with a mask of the columns that the warp's best row of
//    the column also picked; after one barrier every warp combines the
//    warps' bests: a column is taken when a warp holding its best flagged
//    it, and a row is accepted when its warp's best of its column is the
//    best of all.  Double buffers by round keep a warp that runs ahead
//    off what the others still read.  A staircase matrix that accepts one
//    pair a round (min(T, D) + 1 rounds) is the worst case.
// Either way the loop ends with the first round that takes nothing.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "block.cuh"

constexpr int kI32Max = 2147483647;

// The most eligible entries the sparse rounds take (a warp's lanes); more
// go to the dense rounds.  Built with -DASSOC_SPARSE_MAX=0, every matrix
// takes the dense rounds (split_compare.py times the two on one matrix).
#ifndef ASSOC_SPARSE_MAX
#define ASSOC_SPARSE_MAX 32
#endif
static_assert(ASSOC_SPARSE_MAX >= 0 && ASSOC_SPARSE_MAX <= 32, "the sparse rounds hold an entry a lane");

// Largest power of two <= n, for n >= 1.
__device__ __forceinline__ int floor_pow2(int n) { return 1 << (31 - __clz(n)); }

// Row stride, in 32-bit words, of the key matrix of `greedy_associate`
// for D columns: D rounded up to 16, plus 4.  The key matrix holds
// 32 * ceil(T / 32) rows.
__host__ __device__ __forceinline__ int assoc_key_stride(int D) { return ((D + 15) & ~15) + 4; }

// The warps of a block `greedy_associate` has room for, and the words of
// the scratch it takes beside the keys: a list segment of 32 eligible
// entries a warp (4 words each), the matches (128), the compacted list or
// the columns' keys of a dense round (128), a count a warp.
constexpr int kAssocWarps = 8;
constexpr int kAssocScratch = kAssocWarps * 128 + 128 + 128 + kAssocWarps;
// The warps of the dense rounds (a warp a 32 rows, T <= 128); their column
// bests (2 x 4 x 64 pairs) take the list segments' room, their masks
// (2 x 4 pairs) the compacted list's.
constexpr int kAssocDenseWarps = 4;
static_assert(2 * kAssocDenseWarps * 64 * 2 <= kAssocWarps * 128 && 2 * kAssocDenseWarps * 2 <= 128,
              "the dense rounds' scratch");

// The eligible entry's key: its IoU's bits (sign cleared, so -0 ties +0)
// plus one, which orders as the IoU among entries >= 0; 0 if not eligible.
__device__ __forceinline__ unsigned assoc_key(float v, float thr) {
  return (v >= thr && v >= 0.0f) ? (__float_as_uint(v) & 0x7fffffffu) + 1u : 0u;
}

// Sparse rounds on one warp over the `n` <= 32 entries of `list`, each
// (row, column, low and high word of (IoU key << 32 | ~tie-break key)).
// Writes match[t] for t < T and the taken columns to `col_done`.
__device__ inline void associate_sparse(const uint4* list, int n, int T, int* s_match, int* match,
                                        unsigned* col_done) {
  const int lane = threadIdx.x & 31;
  const uint4 me = list[lane];  // read past n too: masked below
  const unsigned valid = n >= 32 ? 0xffffffffu : (1u << n) - 1u;
  unsigned conflict = 0u, better = 0u;  // the entries of my row or column; those that beat me
  for (int j0 = 0; j0 < n; j0 += 8) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j0 + jj;
      const uint4 o = list[j & 31];
      const bool same = (o.x == me.x) | (o.y == me.y);
      const bool gt = (o.w > me.w) | ((o.w == me.w) & (o.z > me.z));
      conflict |= same ? 1u << (j & 31) : 0u;
      better |= (same & gt) ? 1u << (j & 31) : 0u;
    }
  }
  conflict &= valid;
  better &= valid;
  for (int t = lane; t < T; t += 32) s_match[t] = -1;
  __syncwarp();
  bool alive = lane < n;
  unsigned live = valid;  // the live entries
  bool took = false;
  while (true) {
    const bool take = alive && (better & live) == 0u;
    const unsigned acc = __ballot_sync(0xffffffffu, take);
    if (acc == 0u) break;
    took |= take;
    alive = alive && (conflict & acc) == 0u;
    live = __ballot_sync(0xffffffffu, alive);
  }
  if (took) s_match[me.x] = (int)me.y;
  const unsigned lo = __reduce_or_sync(0xffffffffu, took && me.y < 32u ? 1u << me.y : 0u);
  const unsigned hi = __reduce_or_sync(0xffffffffu, took && me.y >= 32u ? 1u << (me.y & 31u) : 0u);
  __syncwarp();
  for (int t = lane; t < T; t += 32) match[t] = s_match[t];
  if (lane == 0) col_done[0] = lo, col_done[1] = hi;
}

// The better of two column bests (IoU key, larger first; tie-break key,
// smaller first).
__device__ __forceinline__ uint2 col_best(uint2 a, uint2 b) {
  return (b.x > a.x || (b.x == a.x && b.y < a.y)) ? b : a;
}

// Dense rounds over the key matrix `keys` (see `greedy_associate`), called
// by warps 0 .. R - 1, R = ceil(T / 32): warp w holds rows 32 w + lane.
// `part` holds 2 x kAssocDenseWarps x 64 column bests, `flags` 2 x
// kAssocDenseWarps masks, both double-buffered by round so that one
// barrier a round keeps the warps apart.  Writes match[t] for t < T and,
// from warp 0, the taken columns to `col_done`.
__device__ inline void associate_dense(const unsigned* keys, const int* rank, int T, int D, uint2* part,
                                       uint2* flags, int* match, unsigned* col_done) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = threadIdx.x;
  const int R = (T + 31) >> 5, nchunk = (D + 15) >> 4;
  const uint4* row = reinterpret_cast<const uint4*>(keys + t * assoc_key_stride(D));
  const unsigned base = t < T ? (unsigned)rank[t] * (unsigned)D + 0x80000000u : 0u;  // the tie-break key's base
  unsigned rmask = t < T ? 0xffffffffu : 0u;  // all ones while the row is live
  int m_out = -1;
  unsigned long long cdone = 0ull;  // taken columns
  for (int buf = 0;; buf ^= 1) {
    uint2* own_part = part + (buf * kAssocDenseWarps + warp) * 64;
    unsigned long long best = 0ull;  // (IoU key, ~tie-break key)
    for (int j = 0; j < nchunk; ++j) {
      const unsigned cl = ~(unsigned)(cdone >> (16 * j));  // live columns
      unsigned kk[16], cmax[16], cmin[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = row[4 * j + q];
        kk[4 * q] = v.x & (0u - ((cl >> (4 * q)) & 1u)) & rmask;
        kk[4 * q + 1] = v.y & (0u - ((cl >> (4 * q + 1)) & 1u)) & rmask;
        kk[4 * q + 2] = v.z & (0u - ((cl >> (4 * q + 2)) & 1u)) & rmask;
        kk[4 * q + 3] = v.w & (0u - ((cl >> (4 * q + 3)) & 1u)) & rmask;
      }
      // The row's best as a tree of independent compares.
      const unsigned nb = ~base - 16u * j;  // ~(base + column)
      unsigned long long key[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) key[i] = ((unsigned long long)kk[i] << 32) | (nb - i);
#pragma unroll
      for (int i = 0; i < 8; ++i) key[i] = key[i + 8] > key[i] ? key[i + 8] : key[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) key[i] = key[i + 4] > key[i] ? key[i + 4] : key[i];
#pragma unroll
      for (int i = 0; i < 2; ++i) key[i] = key[i + 2] > key[i] ? key[i + 2] : key[i];
      key[0] = key[1] > key[0] ? key[1] : key[0];
      best = key[0] > best ? key[0] : best;
      // Each column's best over this warp's rows: the IoU key's maximum,
      // then the least tie-break key among the rows at it (a taken
      // column's maximum is 0: no row can accept it).
#pragma unroll
      for (int i = 0; i < 16; ++i) cmax[i] = __reduce_max_sync(0xffffffffu, kk[i]);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        cmin[i] = __reduce_min_sync(0xffffffffu, kk[i] == cmax[i] ? base + 16u * j + i : 0xffffffffu);
      if (lane == 0) {
        uint4* dst = reinterpret_cast<uint4*>(own_part + 16 * j);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          dst[q] = make_uint4(cmax[2 * q], cmin[2 * q], cmax[2 * q + 1], cmin[2 * q + 1]);
      }
    }
    __syncwarp();
    // The row's best pair is its warp's best of that column (`top`); the
    // warp flags those columns for the others.
    const int d = (int)((~(unsigned)best - base) & 63u);
    const uint2 own = own_part[d];
    const bool top = ((unsigned)(best >> 32) != 0u) & (own.x == (unsigned)(best >> 32)) & (own.y == ~(unsigned)best);
    const unsigned flo = __reduce_or_sync(0xffffffffu, top && d < 32 ? 1u << d : 0u);
    const unsigned fhi = __reduce_or_sync(0xffffffffu, top && d >= 32 ? 1u << (d & 31) : 0u);
    if (lane == 0) flags[buf * kAssocDenseWarps + warp] = make_uint2(flo, fhi);
    if (R > 1) {
      asm volatile("bar.sync 1, %0;" ::"r"(32 * R) : "memory");
    } else {
      __syncwarp();
    }
    // Column c is taken when a warp whose best of c is the best of all
    // flagged it; lane l looks at columns l and l + 32, every warp alike.
    // A row is accepted when its warp's best of its column is the best of
    // all.
    const uint2* now = part + buf * kAssocDenseWarps * 64;
    const uint2* now_flags = flags + buf * kAssocDenseWarps;
    bool taken[2] = {false, false};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (lane + 32 * h >= 16 * nchunk) continue;
      uint2 g = make_uint2(0u, 0xffffffffu);
      bool flagged = false;
      for (int w = 0; w < R; ++w) {
        const uint2 p = now[w * 64 + lane + 32 * h];
        const bool f = ((h ? now_flags[w].y : now_flags[w].x) >> lane) & 1u;
        const bool better = p.x > g.x || (p.x == g.x && p.y < g.y);
        flagged = better ? f : flagged || (f && p.x == g.x && p.y == g.y);
        g = better ? p : g;
      }
      taken[h] = g.x != 0u && flagged;
    }
    uint2 top_d = own;
    for (int w = 0; w < R; ++w) top_d = col_best(top_d, now[w * 64 + d]);
    const unsigned lo = __ballot_sync(0xffffffffu, taken[0]), hi = __ballot_sync(0xffffffffu, taken[1]);
    if ((lo | hi) == 0u) break;
    cdone |= ((unsigned long long)hi << 32) | lo;
    const bool took = top && top_d.x == own.x && top_d.y == own.y;
    m_out = took ? d : m_out;
    rmask = took ? 0u : rmask;
  }
  if (t < T) match[t] = m_out;
  if (t == 0) {
    col_done[0] = (unsigned)cdone;
    col_done[1] = (unsigned)(cdone >> 32);
  }
}

// The block's part of `greedy_associate`: the keys of the padded matrix
// (W columns, 32 ceil(T / 32) rows; 0 outside T x D), one entry a thread
// and step, four steps' loads in flight at once, and this warp's eligible
// entries in `seg` in order, by ballots.  Returns the warp's count of them
// (only the first 32 are stored).
template <int W>
__device__ __forceinline__ unsigned associate_keys(const float* iou, int ld, unsigned* keys, const int* rank,
                                                   int T, int D, float thr, uint4* seg) {
  const int lane = threadIdx.x & 31, step = blockDim.x;
  const int n = 32 * ((T + 31) >> 5) * W, ldk = assoc_key_stride(D);
  unsigned woff = 0u;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * step) {
    // Four loads in flight before any store: `keys` may be `iou`.
    float f[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * step, t = i / W, d = i - W * (i / W);
      f[u] = (i < n && t < T && d < D) ? iou[t * ld + d] : -1.0f;
    }
    // Then the four ballots (i < n is the same across a warp), then the
    // stores, so that no branch stands between the ballots.
    unsigned k[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) k[u] = assoc_key(f[u], thr);
#pragma unroll
    for (int u = 0; u < 4; ++u) b[u] = __ballot_sync(0xffffffffu, k[u] != 0u);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * step, t = i / W, d = i - W * (i / W);
      if (i < n) keys[t * ldk + d] = k[u];
      const unsigned at = woff + __popc(b[u] & ((1u << lane) - 1u));
      if (k[u] != 0u && at < 32u)
        seg[at] = make_uint4(t, d, ~((unsigned)rank[t] * (unsigned)D + 0x80000000u + d), k[u]);
      woff += __popc(b[u]);
    }
  }
  return woff;
}

// The fixpoint; its plain version is ops/association.py
// `_greedy_associate_plain`, which it equals on every input: ties of IoU,
// -0 and +0, NaN, tied ranks and ranks anywhere in int32 (the tie-break
// key rank * D + d wraps as the plain version's does).  A pair is eligible
// while iou >= thr and iou >= 0 and neither its row nor its column is
// taken.  Each round takes every eligible pair that is the best of its
// row (IoU desc, key asc) and of its column (IoU desc, key asc; rows of
// equal key tie, and all of them take the column).
//
// Called by all threads of the block (a multiple of 32, at least 128),
// T <= 128, D <= 64; warp 0 runs sparse rounds, warps 0 .. ceil(T / 32) - 1
// dense ones (on named barrier 1).  `iou` is the (T, D) matrix in shared
// memory with row stride `ld`; entries of invalid pairs must already be
// -1.  `keys` is shared memory of 32 ceil(T / 32) rows of
// `assoc_key_stride(D)` words, 16-byte aligned; it may be `iou` itself
// when `ld` is that stride (each thread reads an entry before it writes
// its key over it).  `rank` has T entries; the caller syncs the block
// after writing it and `iou`.  `scratch` is shared memory of
// kAssocScratch words, 16-byte aligned.  Writes match[t] for t < T (the
// matched column or -1) and the taken columns as two words of bits to
// `col_done`.  The caller syncs before reading them.
__device__ inline void greedy_associate(const float* iou, int ld, unsigned* keys, const int* rank, int T, int D,
                                        float thr, int* match, unsigned* col_done, unsigned* scratch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint4* segs = reinterpret_cast<uint4*>(scratch);  // a segment of 32 entries a warp
  int* s_match = reinterpret_cast<int*>(scratch + kAssocWarps * 128);
  unsigned* s_aux = scratch + kAssocWarps * 128 + 128;  // the compacted list, or a dense round's columns
  unsigned* s_cnt = scratch + kAssocWarps * 128 + 256;
  // Keys over the padded matrix (0 outside T x D); each warp lists its
  // eligible entries in its own segment, in order, by ballots: no atomics.
  unsigned woff = 0u;
  switch ((D + 15) >> 4) {
    case 1: woff = associate_keys<16>(iou, ld, keys, rank, T, D, thr, segs + warp * 32); break;
    case 2: woff = associate_keys<32>(iou, ld, keys, rank, T, D, thr, segs + warp * 32); break;
    case 3: woff = associate_keys<48>(iou, ld, keys, rank, T, D, thr, segs + warp * 32); break;
    default: woff = associate_keys<64>(iou, ld, keys, rank, T, D, thr, segs + warp * 32); break;
  }
  if (lane == 0) s_cnt[warp] = woff;
  __syncthreads();
  // Every warp: the list's length; warp 0: entry e of it on lane e.
  const int nwarps = blockDim.x >> 5;
  int c[kAssocWarps];
#pragma unroll
  for (int w = 0; w < kAssocWarps; ++w) c[w] = w < nwarps ? (int)s_cnt[w] : 0;
  int n = 0, w_e = 0, at_e = 0;
#pragma unroll
  for (int w = 0; w < kAssocWarps; ++w) {
    if (lane >= n && lane < n + c[w]) w_e = w, at_e = lane - n;
    n += c[w];
  }
  if (n <= ASSOC_SPARSE_MAX) {
    if (warp != 0) return;
    uint4* list = reinterpret_cast<uint4*>(s_aux);
    if (lane < n) list[lane] = segs[w_e * 32 + at_e];
    __syncwarp();
    associate_sparse(list, n, T, s_match, match, col_done);
  } else if (warp < ((T + 31) >> 5)) {
    // The list's segments are free now: they hold the column bests.
    associate_dense(keys, rank, T, D, reinterpret_cast<uint2*>(scratch), reinterpret_cast<uint2*>(s_aux), match,
                    col_done);
  }
}


// --- The general instance: tables beyond T <= 128, D <= 64 ------------------
//
// Up to kAssocGeneralMax (4,096) rows and columns, on a thread block
// cluster of C blocks of 1,024 threads a lane (`assoc_plan`); a block owns
// at most 256 rows and 256 columns at 4,096 (at most 1,024 at any shape),
// and loops a thread over every 1,024th row where a round decides every
// row.  What held the one-block
// version back: the whole table on one SM, every round computing
// IoUs or rereading the float matrix, column bests as a chain of T
// dependent steps a thread.  The design:
//  - Partition.  Block r of the cluster owns rows [r R, r R + R) and
//    columns [r K, r K + K), R and K multiples of 32 (`AssocPlan::rows`,
//    `cols`).  It keeps the keys of its rows (its row lines, a row's D
//    keys in a row) and of its columns (its column lines, a column's T
//    keys in a row), each the 32-bit `assoc_key`, staged once a launch,
//    so that no round divides or reads a float.  Two routes:
//    * in the cluster, where the lines fit in the block's shared memory
//      (K1 up to 1,024 slots, `stage_general_keys`; K4 up to 1,024 rows
//      and columns, associate.cu `stage_rows`, `stage_cols`): each key is
//      computed twice, by its row's owner and by its column's owner, so no
//      block ever needs another's keys;
//    * staged, where they leave shared memory (4 MB of keys, 8 MB with
//      both layouts, at 1,024 x 1,024; 128 MB at 4,096 x 4,096, beyond the
//      50 MB L2) and beyond 1,024 lines: a stage kernel before the cluster
//      computes each key once over the whole card into a device scratch
//      the wrapper allocates ("Staging over the whole card", below), with
//      each line's first best and chunk masks, by which the rounds skip
//      chunks with no eligible key (`LineMasks`, `cluster_associate<true>`);
//      the rounds read the lines from L2 or device memory.  K1 takes the
//      first bests by 64-bit atomicMax and the masks by atomicOr into a
//      scratch its rank kernel clears; K4, which has no kernel before its
//      stage kernel, stores each line's best in each chunk in place and
//      the cluster kernel takes the maximum and the masks from those.
//  - Bests.  A warp a line for both kinds: lanes read the line 16 bytes at
//    a time, mask taken columns (row lines) or matched rows (column lines)
//    with bits every block holds, and a warp reduction gives the line's
//    best 64-bit key (IoU key << 32 | ~tie-break key, as the rounds above
//    order them) and, for a column, the row that holds it.  That replaces
//    the serial column chain.  After the first round only the stale bests
//    are recomputed: a row's when its best column was taken, a column's
//    when its best row was matched (a best that is still live stays the
//    best: rounds only remove rows and columns).
//  - Exchange, through distributed shared memory, with no cluster barrier
//    in the rounds.  Each line's warp pushes the line's best (recomputed,
//    or carried over) to every block of the cluster, lane c to block c,
//    with `st.async`, which counts its bytes on an mbarrier of the
//    receiving block; each block expects every row's and every column's
//    best, 8 (T + D) bytes a round, and waits on its own mbarrier alone.
//    Then every block decides the whole round itself: a live row is
//    accepted when its best is its column's best (rows of equal key all
//    take the column, as the plain version's do), so every block holds the
//    same matched-row and taken-column bits, and the loop ends at the first
//    round that accepts nothing, on every block alike.  The received bests
//    and the mbarriers are double-buffered by round parity: a block pushes
//    into a half again two rounds later, only after it has received the
//    next round's bests from every block, which each sent after it had
//    read that half.  One cluster barrier a launch, before the first push,
//    makes the mbarriers' initialisation visible; a cluster barrier a
//    round (arrive with release, wait with acquire) was the slower design
//    on the card.
// A staircase (one pair a round) makes every live line stale each round:
// at 1,024 x 1,024 its 1,025 rounds read about 2 G keys in all.  The
// received bests take 16 (T + D) bytes a block, 128 KB at 4,096 x 4,096,
// and with the ranks and bits the rounds' shared memory 151 KB there
// (`assoc_shared_bytes`, the keys off-chip; K4's staged route adds its
// lines' chunk masks, 8 KB): about where one cluster of 16 blocks ends.
constexpr int kAssocGeneralMax = 4096;
constexpr int kAssocClusterThreads = 1024;
constexpr int kAssocClusterMax = 16;  // above 8 needs cudaFuncAttributeNonPortableClusterSizeAllowed
constexpr int kAssocBitWords = kAssocGeneralMax / 32;
// The dynamic shared memory a block may take on an H100 (227 KB).
constexpr size_t kAssocSmemLimit = 232448;

// The partition of a (T, D) table over a cluster: C blocks, each owning
// `rows` rows and `cols` columns (the last ones fewer or none), its row
// lines `rstride` words apart and its column lines `cstride` (16-byte
// rows, zero past D and T).  C is the power of two nearest above
// (T + D) / 64, at most 16: 4 at (160, 80), 8 at (64, 300) and (256,
// 128), 16 from (1,024, 1,024) on.  More blocks take fewer lines each, in
// the staging and in each round, which was faster on the card up to 8
// blocks at (256, 128).  A block owns at most 1,024 rows (a thread a row
// where the caller needs one): 256 at T = 4,096.
struct AssocPlan {
  int cluster, rows, cols, rstride, cstride;
};

__host__ __device__ inline AssocPlan assoc_plan(int T, int D) {
  const int want = (T + D + 63) / 64;
  int c = 1;
  while (c < want && c < kAssocClusterMax) c <<= 1;
  AssocPlan p;
  p.cluster = c;
  p.rows = 32 * (((T + 31) / 32 + c - 1) / c);
  p.cols = 32 * (((D + 31) / 32 + c - 1) / c);
  p.rstride = (D + 3) & ~3;
  p.cstride = (T + 3) & ~3;
  return p;
}

// Words of one block's key lines (its row lines, then its column lines).
__host__ __device__ inline size_t assoc_key_words(const AssocPlan& p) {
  return (size_t)p.rows * p.rstride + (size_t)p.cols * p.cstride;
}

// Shared memory of the rounds, a block: the key lines where they live there,
// the bests of its rows and columns (8 bytes each), every row's and every
// column's best received, by round parity (2 x 8 bytes each), the two
// mbarriers, every row's rank, the column bests' rows and its rows'
// matches (4 bytes each), and the matched-row and taken-column bits (32
// words each, kAssocBitWords).
__host__ __device__ inline size_t assoc_shared_bytes(const AssocPlan& p, bool keys_in_smem) {
  return (keys_in_smem ? 4 * assoc_key_words(p) : 0) + 12 * (size_t)(p.rows + p.cols) +
         16 * (size_t)(p.cstride + p.rstride) + 16 + 4 * (size_t)p.cstride + 4 * 2 * kAssocBitWords;
}

struct AssocShared {
  unsigned* keys;                         // this block's lines, or null (device scratch)
  unsigned long long *rowbest, *colbest;  // this block's rows' and columns' bests
  unsigned long long *allrow, *allcol;    // [2][cstride], [2][rstride]: every best received, by parity
  unsigned long long* mbar;               // [2]: the bytes of each parity's bests
  int* rank;                              // every row's rank (cstride)
  int* colrow;                            // the row of each of this block's column bests
  int* match;                             // this block's rows' matches (-1 unmatched)
  unsigned *matched, *taken;              // every row matched, every column taken: bits
};

// `assoc_shared_bytes` of 16-byte aligned shared memory, carved.
__device__ inline AssocShared assoc_carve(void* base, const AssocPlan& p, bool keys_in_smem) {
  AssocShared s;
  char* c = static_cast<char*>(base);
  s.keys = keys_in_smem ? reinterpret_cast<unsigned*>(c) : nullptr;
  c += keys_in_smem ? 4 * assoc_key_words(p) : 0;
  s.rowbest = reinterpret_cast<unsigned long long*>(c);
  s.colbest = s.rowbest + p.rows;
  s.allrow = s.colbest + p.cols;
  s.allcol = s.allrow + 2 * p.cstride;
  s.mbar = s.allcol + 2 * p.rstride;
  s.rank = reinterpret_cast<int*>(s.mbar + 2);
  s.colrow = s.rank + p.cstride;
  s.match = s.colrow + p.cols;
  s.matched = reinterpret_cast<unsigned*>(s.match + p.rows);
  s.taken = s.matched + kAssocBitWords;
  return s;
}

// The first row and the count of rows (columns) block `r` owns.
__device__ __forceinline__ int2 assoc_span(int r, int per, int n) {
  const int lo = min(r * per, n);
  return make_int2(lo, min(per, n - lo));
}

__device__ __forceinline__ bool bit_of(const unsigned* bits, unsigned i) { return (bits[i >> 5] >> (i & 31)) & 1u; }

__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long v) {
  // Two 32-bit reductions (`redux.sync`): the high words' maximum, then the
  // low words' among the lanes at it (five 64-bit shuffle steps were the
  // longest chain of a round).
  const unsigned hi = __reduce_max_sync(0xffffffffu, (unsigned)(v >> 32));
  const unsigned lo = __reduce_max_sync(0xffffffffu, (unsigned)(v >> 32) == hi ? (unsigned)v : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

// Stores `v` at `addr` in a block of the cluster and counts its 8 bytes on
// that block's mbarrier at `mbar` (both shared::cluster addresses).
__device__ __forceinline__ void st_async_b64(unsigned addr, unsigned long long v, unsigned mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];" ::"r"(addr), "l"(v),
               "r"(mbar)
               : "memory");
}

// Clears the bits and the matches, initialises the mbarriers and arrives on
// the cluster barrier that `cluster_associate` waits on before its first
// push.  Called by every thread of every block of the cluster; the caller
// writes s.rank[t] for t < T (the words past T are read, but only beside
// keys of 0), syncs the block before `cluster_associate`, and runs no other
// cluster barrier in between.
__device__ inline void assoc_init(const AssocShared& s, const AssocPlan& p) {
  for (int i = threadIdx.x; i < 2 * kAssocBitWords; i += blockDim.x) s.matched[i] = 0u;
  for (int i = threadIdx.x; i < p.rows; i += blockDim.x) s.match[i] = -1;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(s.mbar)) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(s.mbar + 1)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

// One entry of a line as a 64-bit key (0 unless eligible and live).
__device__ __forceinline__ unsigned long long line_entry(unsigned k, bool live, unsigned tie) {
  return (live && k) ? ((unsigned long long)k << 32) | ~tie : 0ull;
}

// The best live entry of a row line, on a warp: `base` is the row's
// tie-break base (rank * D + 2^31), column d's tie-break key base + d.
// Entries 4 q .. 4 q + 3 of a row line into `best`: `base` is the row's
// tie-break base, columns taken in `taken` dead.
__device__ __forceinline__ void row_quad(const uint4* l4, int q, const unsigned* taken, unsigned base,
                                         unsigned long long& best) {
  const uint4 k = l4[q];
  const unsigned live = ~(taken[q >> 3] >> ((4 * q) & 31));
  const unsigned d = base + 4u * q;
  unsigned long long e0 = line_entry(k.x, live & 1u, d), e1 = line_entry(k.y, live & 2u, d + 1u);
  unsigned long long e2 = line_entry(k.z, live & 4u, d + 2u), e3 = line_entry(k.w, live & 8u, d + 3u);
  e0 = e1 > e0 ? e1 : e0;
  e2 = e3 > e2 ? e3 : e2;
  e0 = e2 > e0 ? e2 : e0;
  best = e0 > best ? e0 : best;
}

__device__ inline unsigned long long row_line_best(const unsigned* line, int n4, const unsigned* taken,
                                                   unsigned base) {
  const uint4* l4 = reinterpret_cast<const uint4*>(line);
  unsigned long long best = 0ull;
#pragma unroll 4
  for (int q = threadIdx.x & 31; q < n4; q += 32) row_quad(l4, q, taken, base, best);
  return warp_max_u64(best);
}

// The best live entry of column line d, on a warp, and its row (`*arg`):
// row t's tie-break key is rank[t] * D + d + 2^31 (`dcol` = d + 2^31).
// Entries 4 q .. 4 q + 3 of a column line into `best` and its row `at`:
// rows matched in `matched` dead.
__device__ __forceinline__ void col_quad(const uint4* l4, const int4* r4, int q, const unsigned* matched, unsigned D,
                                         unsigned dcol, unsigned long long& best, int& at) {
  const uint4 k = l4[q];
  const int4 r = r4[q];
  const unsigned live = ~(matched[q >> 3] >> ((4 * q) & 31));
  const unsigned long long e0 = line_entry(k.x, live & 1u, (unsigned)r.x * D + dcol);
  const unsigned long long e1 = line_entry(k.y, live & 2u, (unsigned)r.y * D + dcol);
  const unsigned long long e2 = line_entry(k.z, live & 4u, (unsigned)r.z * D + dcol);
  const unsigned long long e3 = line_entry(k.w, live & 8u, (unsigned)r.w * D + dcol);
  if (e0 > best) best = e0, at = 4 * q;
  if (e1 > best) best = e1, at = 4 * q + 1;
  if (e2 > best) best = e2, at = 4 * q + 2;
  if (e3 > best) best = e3, at = 4 * q + 3;
}

// The line's best and, in `arg`, its row: the least lane's among equal
// bests (entries never tie: their tie-break keys differ).
__device__ __forceinline__ unsigned long long col_best_of_warp(unsigned long long best, int at, int* arg) {
  const unsigned long long m = warp_max_u64(best);
  *arg = __reduce_min_sync(0xffffffffu, best == m ? (unsigned)at : 0xffffffffu);
  return m;
}

__device__ inline unsigned long long col_line_best(const unsigned* line, int n4, const unsigned* matched,
                                                   const int* rank, unsigned D, unsigned dcol, int* arg) {
  const uint4* l4 = reinterpret_cast<const uint4*>(line);
  const int4* r4 = reinterpret_cast<const int4*>(rank);
  unsigned long long best = 0ull;
  int at = 0;
#pragma unroll 2
  for (int q = threadIdx.x & 31; q < n4; q += 32) col_quad(l4, r4, q, matched, D, dcol, best, at);
  return col_best_of_warp(best, at, arg);
}

// Chunk masks of a block's key lines, where the lines were staged over the
// card (K1: tracker_step.cu `tracker_stage_kernel`; K4: associate.cu
// `associate_stage_kernel`): bit c of a line's mask words is set when its
// chunk c (entries 32 c .. 32 c + 31) holds an eligible key.  The block's
// i-th row's words at rows + i rw, its j-th column's at cols + j cw
// (`mask_words` each).  A recomputed best reads only the chunks whose bit
// is set and whose columns (rows) are not all taken (matched): the others
// hold no live eligible entry, so the best is the same.
struct LineMasks {
  const unsigned *rows, *cols;
  int rw, cw;
};

// Mask words of a line of n entries: a bit a chunk of 32.
__host__ __device__ inline int mask_words(int n) { return (n + 1023) / 1024; }

// The chunks of one of a line's 32-chunk mask words that a recomputed best
// reads, as a ballot (lane c: chunk 32 m + c).
__device__ __forceinline__ unsigned live_chunks(unsigned mask_word, const unsigned* dead_bits, int m) {
  const int lane = threadIdx.x & 31;
  return __ballot_sync(0xffffffffu, ((mask_word >> lane) & 1u) && dead_bits[32 * m + lane] != 0xffffffffu);
}

// The uint4 of a line that this lane reads in a pass over `act`'s chunks,
// four chunks a pass (lanes 8 q .. 8 q + 7 the q-th set bit's 8 uint4s), or
// -1; drops the pass's chunks from `act`.
__device__ __forceinline__ int chunk_quad(unsigned& act, int m) {
  const int lane = threadIdx.x & 31;
  const unsigned pos = __fns(act, 0, (lane >> 3) + 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) act &= act - 1u;
  return pos == 0xffffffffu ? -1 : 8 * (32 * m + (int)pos) + (lane & 7);
}

// `row_line_best` over the chunks `mask` (mw words) marks.
__device__ inline unsigned long long row_line_best_masked(const unsigned* line, int n4, const unsigned* mask, int mw,
                                                          const unsigned* taken, unsigned base) {
  const uint4* l4 = reinterpret_cast<const uint4*>(line);
  unsigned long long best = 0ull;
  for (int m = 0; m < mw; ++m) {
    unsigned act = live_chunks(mask[m], taken, m);
    while (act != 0u) {
      const int q = chunk_quad(act, m);
      if (q >= 0 && q < n4) row_quad(l4, q, taken, base, best);
    }
  }
  return warp_max_u64(best);
}

// `col_line_best` over the chunks `mask` (mw words) marks.
__device__ inline unsigned long long col_line_best_masked(const unsigned* line, int n4, const unsigned* mask, int mw,
                                                          const unsigned* matched, const int* rank, unsigned D,
                                                          unsigned dcol, int* arg) {
  const uint4* l4 = reinterpret_cast<const uint4*>(line);
  const int4* r4 = reinterpret_cast<const int4*>(rank);
  unsigned long long best = 0ull;
  int at = 0;
  for (int m = 0; m < mw; ++m) {
    unsigned act = live_chunks(mask[m], matched, m);
    while (act != 0u) {
      const int q = chunk_quad(act, m);
      if (q >= 0 && q < n4) col_quad(l4, r4, q, matched, D, dcol, best, at);
    }
  }
  return col_best_of_warp(best, at, arg);
}

// The fixpoint on the cluster, with the contract of `greedy_associate` for
// T, D up to kAssocGeneralMax.  Called by every thread of every block of
// the cluster (kAssocClusterThreads each), after
// `assoc_init`, the lines staged and a block sync; `rowkeys` and `colkeys`
// are this block's lines (`s.keys` or its part of the device scratch).
// With `staged`, the caller has also written the first round's bests
// (s.rowbest, s.colbest and s.colrow: each line's best with every row live
// and every column untaken), which the first round pushes as they are.
// With kMasked, the recomputed bests read only the chunks `masks` marks.  On
// return s.match holds this block's rows' matches and s.matched, s.taken
// every row's and column's state, alike on every block; every push to this
// block has landed.  Returns the rounds taken, the last (which accepts
// nothing) included.
template <bool kMasked = false>
__device__ inline int cluster_associate(const AssocShared& s, const unsigned* rowkeys, const unsigned* colkeys,
                                        const AssocPlan& p, int T, int D, bool staged = false,
                                        LineMasks masks = LineMasks{}) {
  const unsigned C = (unsigned)p.cluster;
  unsigned me;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(me));
  const int2 rows = assoc_span((int)me, p.rows, T), cols = assoc_span((int)me, p.cols, D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int rn4 = p.rstride >> 2, cn4 = p.cstride >> 2;
  const unsigned bytes = 8u * (unsigned)(T + D);
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");  // every block's mbarriers are ready
  int rounds = 0;
  for (int par = 0;; par ^= 1) {
    const bool first = rounds++ == 0, fresh = first && !staged;
    unsigned long long* allrow = s.allrow + par * p.cstride;
    unsigned long long* allcol = s.allcol + par * p.rstride;
    const unsigned mbar = smem_addr(s.mbar + par);
    if (tid == 0) asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar), "r"(bytes) : "memory");
    // Row bests, a warp a row: the stale ones recomputed (all in the first
    // round), the others carried over; pushed to every block.
    for (int i = warp; i < rows.y; i += nwarps) {
      const int t = rows.x + i;
      const unsigned base = (unsigned)s.rank[t] * (unsigned)D + 0x80000000u;
      unsigned long long best = s.rowbest[i];
      if (fresh || (!first && !bit_of(s.matched, t) && best != 0ull && bit_of(s.taken, ~(unsigned)best - base))) {
        if constexpr (kMasked)
          best = row_line_best_masked(rowkeys + (size_t)i * p.rstride, rn4, masks.rows + (size_t)i * masks.rw,
                                      masks.rw, s.taken, base);
        else
          best = row_line_best(rowkeys + (size_t)i * p.rstride, rn4, s.taken, base);
        if (lane == 0) s.rowbest[i] = best;
      }
      if ((unsigned)lane < C) st_async_b64(cluster_addr(allrow + t, lane), best, cluster_addr(s.mbar + par, lane));
    }
    // Column bests, a warp a column, likewise.
    for (int j = warp; j < cols.y; j += nwarps) {
      const int d = cols.x + j;
      unsigned long long best = s.colbest[j];
      if (fresh || (!first && !bit_of(s.taken, d) && best != 0ull && bit_of(s.matched, s.colrow[j]))) {
        int arg;
        if constexpr (kMasked)
          best = col_line_best_masked(colkeys + (size_t)j * p.cstride, cn4, masks.cols + (size_t)j * masks.cw,
                                      masks.cw, s.matched, s.rank, (unsigned)D, (unsigned)d + 0x80000000u, &arg);
        else
          best = col_line_best(colkeys + (size_t)j * p.cstride, cn4, s.matched, s.rank, (unsigned)D,
                               (unsigned)d + 0x80000000u, &arg);
        if (lane == 0) s.colbest[j] = best, s.colrow[j] = arg;
      }
      if ((unsigned)lane < C) st_async_b64(cluster_addr(allcol + d, lane), best, cluster_addr(s.mbar + par, lane));
    }
    // Every row's and column's best of this round, from every block.
    const unsigned parity = (unsigned)((rounds - 1) >> 1) & 1u;
    unsigned ok;
    do {
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
          : "=r"(ok)
          : "r"(mbar), "r"(parity)
          : "memory");
    } while (!ok);
    // Accept every live row whose best is its column's best, a thread every
    // blockDim-th row (a warp the same 32-row word of the bits each pass);
    // every block decides the same.
    bool any = false;
    for (int t0 = 0; t0 < T; t0 += blockDim.x) {
      const int t = t0 + tid;
      bool took = false;
      if (t < T) {
        const unsigned long long b = allrow[t];
        if (b != 0ull && !bit_of(s.matched, t)) {
          const unsigned d = ~(unsigned)b - ((unsigned)s.rank[t] * (unsigned)D + 0x80000000u);
          if (allcol[d] == b) {
            took = true;
            atomicOr(s.taken + (d >> 5), 1u << (d & 31));
            if (t >= rows.x && t < rows.x + rows.y) s.match[t - rows.x] = (int)d;
          }
        }
      }
      const unsigned acc = __ballot_sync(0xffffffffu, took);
      if (lane == 0 && acc != 0u) s.matched[t >> 5] |= acc;
      any |= took;
    }
    if (!__syncthreads_or(any)) return rounds;
  }
}

// --- Staging over the whole card -----------------------------------------
//
// Where the keys leave shared memory, a stage kernel before the cluster
// kernel computes each key once over the whole card (K1: tracker_step.cu
// `tracker_stage_kernel`; K4: associate.cu `associate_stage_kernel`) into a
// device scratch, block r's lines at r assoc_key_words.  A stage block
// takes a tile of 4 kRows rows by kStageCols columns on kStageThreads
// threads, 8 warps as 4 row groups of kRows rows by 2 column groups of 32
// columns.  A warp writes its keys to their row lines, lane by column, and
// through a shared-memory transpose to their column lines, lane by row
// (`stage_transpose`), and takes in the same pass each of its lines' best
// within its part of the tile.  kRows is 32 where such tiles fill the
// card's SMs twice over, else 8 (`stage_big_tiles`), so that small tables
// still fill it.
constexpr int kStageThreads = 256, kStageCols = 64;

// The row line of row t, a warp's first, in the lines from `keys`: a warp's
// rows lie in one block's lines (the partition's spans are multiples of 32).
__device__ __forceinline__ unsigned* stage_row_line(unsigned* keys, const AssocPlan& a, int t) {
  const int r = t / a.rows;
  return keys + (size_t)r * assoc_key_words(a) + (size_t)(t - r * a.rows) * a.rstride;
}

// The column line of column d, a warp's first (its 32 columns lie in one
// block's lines).
__device__ __forceinline__ unsigned* stage_col_line(unsigned* keys, const AssocPlan& a, int d) {
  const int r = d / a.cols;
  return keys + (size_t)r * assoc_key_words(a) + (size_t)a.rows * a.rstride + (size_t)(d - r * a.cols) * a.cstride;
}

// The transpose half of a stage warp's tile.  `tile[i][c]` holds the key of
// row t0 + i, column d0 + c.  Lane by row (row t0 + lane % kRows, kRows of
// the 32 columns from kRows (lane / kRows)), the warp stores the keys into
// the column lines from `colline` (column d0's), a column's kRows stores
// side by side, zero past T up to the lines' stride.  Returns the largest
// `row_entry(k, i, d)` over row t0 + i's eligible keys of the 32 columns,
// combined over the row's lanes (lanes i < kRows hold row t0 + i's).
template <int kRows, class RowEntry>
__device__ __forceinline__ unsigned long long stage_transpose(unsigned (*tile)[33], unsigned* colline,
                                                              const AssocPlan& a, int D, int t0, int d0,
                                                              RowEntry row_entry) {
  const int lane = threadIdx.x & 31, r = lane % kRows, c0 = kRows * (lane / kRows), t = t0 + r;
  unsigned long long rbest = 0ull;
#pragma unroll 4
  for (int c = c0; c < c0 + kRows; ++c) {
    const unsigned k = tile[r][c];
    if (d0 + c < D && t < a.cstride) colline[(size_t)c * a.cstride + t] = k;
    const unsigned long long e = row_entry(k, r, d0 + c);
    rbest = (k != 0u && e > rbest) ? e : rbest;
  }
#pragma unroll
  for (int o = kRows; o < 32; o <<= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, rbest, o);
    rbest = other > rbest ? other : rbest;
  }
  return rbest;
}

// Whether the stage kernel over `a`'s lines for B lanes takes blocks of
// 32-row warps (when they fill the card's SMs twice over) or of 8-row warps
// (four times the blocks); and its grid (x: column tiles, y: row tiles, z:
// lanes).
inline bool stage_big_tiles(const AssocPlan& a, int B) {
  const size_t cols = (a.rstride + kStageCols - 1) / kStageCols, big = (a.cstride + 127) / 128;
  return cols * big * B >= 2 * (size_t)device_sms();
}

inline dim3 stage_grid(const AssocPlan& a, int B, bool big) {
  return dim3((unsigned)((a.rstride + kStageCols - 1) / kStageCols),
              (unsigned)(big ? (a.cstride + 127) / 128 : (a.cstride + 31) / 32), (unsigned)B);
}
