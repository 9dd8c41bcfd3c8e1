// The greedy mutual-max association fixpoint as a block-wide device
// function, shared by kernel K1 (tracker_step.cu) and the standalone
// association kernel K4 (associate.cu).
//
// What bounds the fixpoint on an H100: its matrix is at most 128 x 64
// floats in shared memory, so each round is a few hundred shared loads and
// comparisons.  The cost is the chain of dependent steps, not the bytes:
// the earlier version walked every column's 64 rows on one thread (three
// shared loads and a dependent compare a row) and closed each round with
// three barriers.  Here each round is two parallel arg-max reductions, a
// few shared loads a lane followed by a shuffle tree, then one accepting
// pass and one `__syncthreads_or` that both publishes the round's writes
// and says whether it accepted a pair.  A staircase matrix that accepts one
// pair a round (min(T, D) + 1 rounds) is the worst case.
#pragma once

#include <stdint.h>

#include "block.cuh"

constexpr int kI32Max = 2147483647;

// Largest power of two <= n, for n >= 1.
__device__ __forceinline__ int floor_pow2(int n) { return 1 << (31 - __clz(n)); }

// The fixpoint over an IoU matrix in shared memory (row stride `ld`); its
// plain version is ops/association.py `_greedy_associate_plain`, which it
// equals on every input.  Entries of invalid pairs must already be -1.  A
// pair is eligible while iou >= thr and iou >= 0 and neither its row nor its
// column is taken.  Each round finds every row's best column (the key IoU
// desc, column asc) and every column's best row (IoU desc, rank asc, row
// asc), accepts the mutual pairs, and the loop ends with the first round
// that accepts nothing.  Rows that share the column's best IoU and rank are
// all accepted, as the plain version's key rank * D + det ties them; with
// distinct ranks (the tracker's) there is one.  Every reduction runs on a
// key with a total order (IoU is compared as a float: a -0 and a +0 tie, as
// in the plain version, and a NaN is never eligible), so its result does not
// depend on the order in which lanes combine.
//
// Called by all threads of the block; needs blockDim.x a multiple of 32 and
// >= T, T <= 128, D <= 64.  `row_done` holds 4 words and `col_done` 2, one
// bit a row or column; they are left set for the caller (`col_done` marks
// the matched detections).  Ends synced.
__device__ inline void greedy_associate_block(const float* iou, int ld, const int* rank, int T, int D,
                                              float thr, int* match, int* row_best, int* col_best,
                                              unsigned* row_done, unsigned* col_done) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31;
  for (int t = tid; t < T; t += nthreads) match[t] = -1;
  if (tid < 4) row_done[tid] = 0u;
  if (tid < 2) col_done[tid] = 0u;
  // Lanes a row and a column: powers of two, so each group lies in one warp.
  const int rl = min(32, floor_pow2(nthreads / T));
  const int cl = min(32, floor_pow2(nthreads / D));
  const int my_row = tid / rl, row_sub = tid & (rl - 1);
  const int my_col = tid / cl, col_sub = tid & (cl - 1);
  __syncthreads();
  while (true) {
    // The taken rows and columns as 64-bit masks in registers.
    const uint64_t cdone = (uint64_t)col_done[0] | ((uint64_t)col_done[1] << 32);
    const uint64_t rdone_lo = (uint64_t)row_done[0] | ((uint64_t)row_done[1] << 32);
    const uint64_t rdone_hi = (uint64_t)row_done[2] | ((uint64_t)row_done[3] << 32);
    auto row_taken = [&](int t) { return (((t < 64 ? rdone_lo : rdone_hi) >> (t & 63)) & 1u) != 0; };

    // Row best: (IoU desc, column asc) over this lane's columns, then across
    // the row's lanes.
    float rv = -1.0f;
    int rd = -1;
    if (my_row < T && !row_taken(my_row)) {
      const float* row = iou + my_row * ld;
#pragma unroll 4
      for (int d = row_sub; d < D; d += rl) {
        const float v = row[d];
        if (!((cdone >> d) & 1u) && v >= thr && v >= 0.0f && v > rv) {
          rv = v;
          rd = d;
        }
      }
    }
    for (int off = rl >> 1; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, rv, off);
      const int od = __shfl_xor_sync(0xffffffffu, rd, off);
      if (ov > rv || (ov == rv && od >= 0 && (rd < 0 || od < rd))) {
        rv = ov;
        rd = od;
      }
    }
    if (row_sub == 0 && my_row < T) row_best[my_row] = rd;

    // Column best: (IoU desc, rank asc, row asc) over this lane's rows, then
    // across the column's lanes.
    float cv = -1.0f;
    int cr = kI32Max, ct = -1;
    if (my_col < D && !((cdone >> my_col) & 1u)) {
#pragma unroll 4
      for (int t = col_sub; t < T; t += cl) {
        const float v = iou[t * ld + my_col];
        const int r = rank[t];
        if (!row_taken(t) && v >= thr && v >= 0.0f && (v > cv || (v == cv && (r < cr || (r == cr && t < ct))))) {
          cv = v;
          cr = r;
          ct = t;
        }
      }
    }
    for (int off = cl >> 1; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, cv, off);
      const int orank = __shfl_xor_sync(0xffffffffu, cr, off);
      const int ot = __shfl_xor_sync(0xffffffffu, ct, off);
      if (ot >= 0 && (ct < 0 || ov > cv || (ov == cv && (orank < cr || (orank == cr && ot < ct))))) {
        cv = ov;
        cr = orank;
        ct = ot;
      }
    }
    if (col_sub == 0 && my_col < D) col_best[my_col] = ct;
    __syncthreads();

    // Accept the mutual pairs, and rows of the column's best rank that tie
    // its best IoU.  Warps 0-3 hold rows 0-127, one a lane.
    bool accepted = false;
    if (tid < 128) {
      const int t = tid;
      if (t < T) {
        const int d = row_best[t];
        const int c = d >= 0 ? col_best[d] : -1;
        if (c == t || (c >= 0 && rank[t] == rank[c] && iou[t * ld + d] == iou[c * ld + d])) {
          accepted = true;
          match[t] = d;
          atomicOr(&col_done[d >> 5], 1u << (d & 31));
        }
      }
      const unsigned b = __ballot_sync(0xffffffffu, accepted);
      if (lane == 0 && b) row_done[tid >> 5] |= b;
    }
    if (!__syncthreads_or(accepted)) break;
  }
}
