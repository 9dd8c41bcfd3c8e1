// The greedy mutual-max association fixpoint as a block-wide device
// function, shared by kernel K1 (tracker_step.cu) and the standalone
// association kernel K4 (associate.cu).
#pragma once

constexpr int kI32Max = 2147483647;

// The fixpoint over an IoU matrix in shared memory (row stride `ld`); its
// plain version is ops/association.py `_greedy_associate_plain`, which it
// equals on every input.  Entries of invalid pairs must already be -1.  A
// pair is eligible while iou >= thr and iou >= 0 and neither its row nor its
// column is taken.  Each round finds every row's best column (first column
// at the row max) and every column's best row (lowest rank at the column
// max), accepts the mutual pairs, and the loop ends with the first round
// that accepts nothing.  Rows that share the column's best IoU and rank are
// all accepted, as the plain version's key rank * D + det ties them; with
// distinct ranks (the tracker's) there is one.  Called by all threads of
// the block; ends synced.
__device__ inline void greedy_associate_block(const float* iou, int ld,
                                              const int* rank, int T, int D,
                                              float thr, int* match,
                                              int* row_best, int* col_best,
                                              int* row_done, int* col_done,
                                              int* flag) {
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    match[t] = -1;
    row_done[t] = 0;
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) col_done[d] = 0;
  __syncthreads();
  while (true) {
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      int best = -1;
      float bv = -1.0f;
      if (!row_done[t]) {
        for (int d = 0; d < D; ++d) {
          if (col_done[d]) continue;
          float v = iou[t * ld + d];
          if (v >= thr && v >= 0.0f && v > bv) {
            bv = v;
            best = d;
          }
        }
      }
      row_best[t] = best;
    }
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      int best = -1, br = kI32Max;
      float bv = -1.0f;
      if (!col_done[d]) {
        for (int t = 0; t < T; ++t) {
          if (row_done[t]) continue;
          float v = iou[t * ld + d];
          if (v >= thr && v >= 0.0f && (v > bv || (v == bv && rank[t] < br))) {
            bv = v;
            br = rank[t];
            best = t;
          }
        }
      }
      col_best[d] = best;
    }
    if (threadIdx.x == 0) *flag = 0;
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const int d = row_best[t];
      const int c = d >= 0 ? col_best[d] : -1;
      if (c == t || (c >= 0 && rank[t] == rank[c] && iou[t * ld + d] == iou[c * ld + d])) {
        match[t] = d;
        row_done[t] = 1;
        col_done[d] = 1;
        *flag = 1;
      }
    }
    __syncthreads();
    int progressed = *flag;
    __syncthreads();
    if (!progressed) break;
  }
}
