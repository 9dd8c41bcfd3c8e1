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
// Up to kAssocGeneralMax rows and columns, on one whole block.  The fast
// rounds above keep the key matrix and their column bests in shared memory
// and hold column masks of two words; at T = D = 1,024 the float32 matrix
// alone is 4 MB.  So the general rounds keep no matrix: `iou(t, d)` gives
// an entry where the caller keeps it (K4: device memory; K1: computed from
// the boxes in shared memory), and shared memory holds, a row, its best
// live entry as one 64-bit key (IoU key << 32 | ~tie-break key, as the
// dense rounds order them), and, a column, its best live row's key and
// that row.  A round accepts every live row whose best is its column's
// best (rows of equal key all take the column, as the plain version's do),
// then recomputes only the bests that the round made stale: a row's when
// its column was taken (a warp a row, lanes over the columns), a column's
// when its row was matched (a thread a column, over the rows).  A best
// that is still live stays the best, since rounds only remove rows and
// columns.  Two barriers a round; the first round computes every best.
// Correct first: a round of the first kind reads the whole matrix.
constexpr int kAssocGeneralMax = 1024;

// Bytes of shared memory the general rounds take for T rows and D columns:
// row bests and column bests (8 bytes each), then the matches (T), the
// taken columns (D) and the column bests' rows (D), 4 bytes each.
__host__ __device__ inline size_t assoc_general_smem(int T, int D) {
  return 8 * (size_t)(T + D) + 4 * ((size_t)T + 2 * (size_t)D);
}

__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// The general fixpoint, with the contract of `greedy_associate` for T, D
// up to kAssocGeneralMax: `iou(t, d)` is the entry (-1 for invalid pairs),
// `rank` the T row ranks in shared memory, `smem` the shared memory of
// `assoc_general_smem(T, D)` bytes, 8-byte aligned.  Called by all threads
// of the block; the caller syncs after writing `rank` and what `iou`
// reads.  Writes the matches to `smem`'s int array returned by
// `assoc_general_match(smem, T, D)` and the taken columns (1 or 0) to
// `assoc_general_taken`; the block is synced when it returns.
__device__ __forceinline__ int* assoc_general_match(void* smem, int T, int D) {
  return reinterpret_cast<int*>(static_cast<unsigned long long*>(smem) + T + D);
}
__device__ __forceinline__ int* assoc_general_taken(void* smem, int T, int D) {
  return assoc_general_match(smem, T, D) + T;
}

template <class Iou>
__device__ void greedy_associate_general(Iou iou, const int* rank, int T, int D, float thr, void* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  unsigned long long* rowbest = static_cast<unsigned long long*>(smem);
  unsigned long long* colbest = rowbest + T;
  int* match = assoc_general_match(smem, T, D);
  int* taken = match + T;
  int* colrow = taken + D;
  for (int t = tid; t < T; t += nthreads) match[t] = -1;
  for (int d = tid; d < D; d += nthreads) taken[d] = 0;
  __syncthreads();
  for (bool first = true;; first = false) {
    // Row bests, a warp a row: the stale ones (all in the first round).
    for (int t = warp; t < T; t += nwarps) {
      const unsigned base = (unsigned)rank[t] * (unsigned)D + 0x80000000u;  // the tie-break key's base
      const unsigned long long b = rowbest[t];
      if (!first && !(match[t] < 0 && b != 0ull && taken[~(unsigned)b - base])) continue;
      unsigned long long best = 0ull;
      for (int d = lane; d < D; d += 32) {
        if (taken[d]) continue;
        const unsigned k = assoc_key(iou(t, d), thr);
        const unsigned long long e = k ? ((unsigned long long)k << 32) | ~(base + (unsigned)d) : 0ull;
        best = e > best ? e : best;
      }
      best = warp_max_u64(best);
      if (lane == 0) rowbest[t] = best;
    }
    // Column bests, a thread a column: the stale ones.
    for (int d = tid; d < D; d += nthreads) {
      if (!first && !(!taken[d] && colbest[d] != 0ull && match[colrow[d]] >= 0)) continue;
      unsigned long long best = 0ull;
      int arg = 0;
#pragma unroll 4
      for (int t = 0; t < T; ++t) {
        if (match[t] >= 0) continue;
        const unsigned k = assoc_key(iou(t, d), thr);
        const unsigned long long e =
            k ? ((unsigned long long)k << 32) | ~((unsigned)rank[t] * (unsigned)D + 0x80000000u + (unsigned)d) : 0ull;
        if (e > best) best = e, arg = t;
      }
      colbest[d] = best;
      colrow[d] = arg;
    }
    __syncthreads();
    // Accept every live row whose best is its column's best.
    bool took = false;
    for (int t = tid; t < T; t += nthreads) {
      const unsigned long long b = rowbest[t];
      if (match[t] >= 0 || b == 0ull) continue;
      const int d = (int)(~(unsigned)b - ((unsigned)rank[t] * (unsigned)D + 0x80000000u));
      if (colbest[d] == b) {
        match[t] = d;
        taken[d] = 1;
        took = true;
      }
    }
    if (!__syncthreads_or(took)) break;
  }
}
