// Kernel K1: one whole tracker step (IoU, association, lifecycle, confirmed
// order) for one frame, in one thread block.
//
// Replaces the Pallas TPU kernel in the JAX package's
// ops/tracker_pallas.py (`_make_kernel`, launched by `tracker_update_pallas`).
// Its plain PyTorch version is tracking/tracker.py `tracker_update` followed
// by `confirmed_order`; the kernel is bit-identical to it.
//
// Bound on an H100: at T=64 slots, D=16 detections, L=50 the step reads
// about 29.6 KB and writes about 29.7 KB (the trajectory ring dominates),
// about 18 ns at 3.35 TB/s, and does a few thousand flops.  Both are far
// below the launch latency of a few microseconds, so the step is
// latency-bound.  The design answers that by doing the whole step in one
// launch: the table and the (T, D) IoU matrix stay in shared memory, every
// phase is separated only by __syncthreads(), and nothing goes back to the
// host (next_id and the confirmed count stay on the device).
//
// Exactness: the IoU must equal `pairwise_iou` bit for bit, or tie-breaks
// and track ids move.  Every float operation on that path uses the _rn
// intrinsics, which the compiler never contracts into an FMA.
//
// Limits: T <= 128, D <= 64 (the wrapper checks them).

#include <cuda_runtime.h>
#include <stdint.h>

#include "association.cuh"

namespace {

constexpr int kMaxT = 128;
constexpr int kMaxD = 64;
constexpr int kThreads = 256;

struct TrackerIn {
  const int* track_id;
  const float* bbox;  // (T, 4)
  const int* class_id;
  const float* conf;
  const int* age;
  const int* hits;
  const int* misses;
  const float* traj;  // (T, 2L)
  const int* traj_len;
  const float* vel;  // (T, 2)
  const int* vel_count;
  const int* next_id;  // ()
  const float* det_bbox;  // (D, 4)
  const int* det_class;
  const float* det_conf;
  const bool* det_valid;
};

struct TrackerOut {
  int* track_id;
  float* bbox;
  int* class_id;
  float* conf;
  int* age;
  int* hits;
  int* misses;
  float* traj;
  int* traj_len;
  float* vel;
  int* vel_count;
  int* next_id;
  int* match;
  int* order;
  int* n_conf;
};

struct TrackerParams {
  int T, D, L;
  float iou_threshold;
  int max_age, min_hits;
};

__device__ __forceinline__ float center(float a, float b) {
  return __fmul_rn(__fadd_rn(a, b), 0.5f);
}

// Number of set flags before index `i`; `bits` holds one ballot word per
// 32 indices.
__device__ __forceinline__ int prefix_count(const unsigned* bits, int i) {
  int c = 0;
  for (int w = 0; w < (i >> 5); ++w) c += __popc(bits[w]);
  return c + __popc(bits[i >> 5] & ((1u << (i & 31)) - 1u));
}

__global__ void __launch_bounds__(kThreads)
tracker_step_kernel(TrackerIn in, TrackerOut out, TrackerParams p) {
  extern __shared__ float s_iou[];  // T * (D + 1), padded rows
  __shared__ float s_tb[kMaxT][4];
  __shared__ float s_db[kMaxD][4];
  __shared__ int s_id[kMaxT];
  __shared__ int s_rank[kMaxT];
  __shared__ int s_match[kMaxT];
  __shared__ int s_row_best[kMaxT];
  __shared__ int s_row_done[kMaxT];
  __shared__ int s_okey[kMaxT];
  __shared__ int s_traj_mode[kMaxT];  // 0 keep, 1 ring write, 2 birth
  __shared__ int s_widx[kMaxT];
  __shared__ float s_cx[kMaxT];
  __shared__ float s_cy[kMaxT];
  __shared__ int s_dvalid[kMaxD];
  __shared__ int s_col_best[kMaxD];
  __shared__ int s_col_done[kMaxD];
  __shared__ int s_det_of_rank[kMaxD];
  __shared__ unsigned s_free_bits[kMaxT / 32];
  __shared__ unsigned s_want_bits[kMaxD / 32];
  __shared__ unsigned s_conf_bits[kMaxT / 32];
  __shared__ int s_flag;

  const int T = p.T, D = p.D, L = p.L;
  const int ld = D + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // --- load the table's boxes and ids and the detections -----------------
  for (int t = tid; t < T; t += blockDim.x) {
    s_id[t] = in.track_id[t];
    for (int k = 0; k < 4; ++k) s_tb[t][k] = in.bbox[t * 4 + k];
  }
  for (int d = tid; d < D; d += blockDim.x) {
    s_dvalid[d] = in.det_valid[d] ? 1 : 0;
    for (int k = 0; k < 4; ++k) s_db[d][k] = in.det_bbox[d * 4 + k];
  }
  __syncthreads();

  // --- IoU, op for op `pairwise_iou`; invalid pairs are -1 ----------------
  for (int i = tid; i < T * D; i += blockDim.x) {
    const int t = i / D, d = i - t * D;
    const float ax1 = s_tb[t][0], ay1 = s_tb[t][1], ax2 = s_tb[t][2], ay2 = s_tb[t][3];
    const float bx1 = s_db[d][0], by1 = s_db[d][1], bx2 = s_db[d][2], by2 = s_db[d][3];
    const float iw = __fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1));
    const float ih = __fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1));
    const float inter = (iw > 0.0f && ih > 0.0f) ? __fmul_rn(iw, ih) : 0.0f;
    const float area_a = __fmul_rn(__fsub_rn(ax2, ax1), __fsub_rn(ay2, ay1));
    const float area_b = __fmul_rn(__fsub_rn(bx2, bx1), __fsub_rn(by2, by1));
    const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
    float v = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
    if (!(s_id[t] > 0 && s_dvalid[d])) v = -1.0f;
    s_iou[t * ld + d] = v;
  }
  // --- stable rank of each slot by id, dead slots last (`id_rank`) -------
  for (int t = tid; t < T; t += blockDim.x) {
    const int kt = s_id[t] > 0 ? s_id[t] : kI32Max;
    int r = 0;
    for (int j = 0; j < T; ++j) {
      const int kj = s_id[j] > 0 ? s_id[j] : kI32Max;
      r += (kj < kt) || (kj == kt && j < t);
    }
    s_rank[t] = r;
  }
  __syncthreads();

  greedy_associate_block(s_iou, ld, s_rank, T, D, p.iou_threshold, s_match,
                         s_row_best, s_col_best, s_row_done, s_col_done, &s_flag);

  // --- birth ranks: ballot scans over the free slots and wanted dets -----
  if (tid < kMaxT) {
    const bool free_slot = tid < T && s_id[tid] == 0;
    const unsigned b = __ballot_sync(0xffffffffu, free_slot);
    if (lane == 0) s_free_bits[warp] = b;
  }
  if (tid < kMaxD) {
    const bool want = tid < D && s_dvalid[tid] && !s_col_done[tid];
    const unsigned b = __ballot_sync(0xffffffffu, want);
    if (lane == 0) s_want_bits[warp] = b;
  }
  __syncthreads();
  int n_free = 0, n_want = 0;
  for (int w = 0; w < kMaxT / 32; ++w) n_free += __popc(s_free_bits[w]);
  for (int w = 0; w < kMaxD / 32; ++w) n_want += __popc(s_want_bits[w]);
  const int n_birth = min(n_free, n_want);
  for (int d = tid; d < D; d += blockDim.x) {
    if ((s_want_bits[d >> 5] >> (d & 31)) & 1u) {
      const int r = prefix_count(s_want_bits, d);
      if (r < n_birth) s_det_of_rank[r] = d;
    }
  }
  __syncthreads();
  const int next_id = *in.next_id;

  // --- per slot: matched update, birth, death ------------------------------
  for (int t = tid; t < T; t += blockDim.x) {
    const int id0 = s_id[t];
    const int alive = id0 > 0 ? 1 : 0;
    const int m = s_match[t];
    const bool matched = m >= 0;

    int id = id0;
    float bx1 = s_tb[t][0], by1 = s_tb[t][1], bx2 = s_tb[t][2], by2 = s_tb[t][3];
    int cls = in.class_id[t];
    float conf = in.conf[t];
    int age = in.age[t] + alive;
    int hits = in.hits[t] + (matched ? 1 : 0);
    int misses = matched ? 0 : in.misses[t] + alive;
    float vx = in.vel[t * 2 + 0], vy = in.vel[t * 2 + 1];
    int vcnt = in.vel_count[t] + (matched ? 1 : 0);
    int tlen = in.traj_len[t];
    int mode = 0;
    float cx = 0.0f, cy = 0.0f;

    if (matched) {
      cx = center(s_db[m][0], s_db[m][2]);
      cy = center(s_db[m][1], s_db[m][3]);
      vx = __fsub_rn(cx, center(bx1, bx2));  // before the bbox overwrite
      vy = __fsub_rn(cy, center(by1, by2));
      bx1 = s_db[m][0];
      by1 = s_db[m][1];
      bx2 = s_db[m][2];
      by2 = s_db[m][3];
      conf = in.det_conf[m];
      mode = 1;
      s_widx[t] = tlen % L;
      tlen += 1;
    }
    if (id0 == 0) {
      const int r = prefix_count(s_free_bits, t);
      if (r < n_birth) {
        const int d = s_det_of_rank[r];
        id = next_id + r;
        bx1 = s_db[d][0];
        by1 = s_db[d][1];
        bx2 = s_db[d][2];
        by2 = s_db[d][3];
        cls = in.det_class[d];
        conf = in.det_conf[d];
        age = 0;
        hits = 1;
        misses = 0;
        vx = 0.0f;
        vy = 0.0f;
        vcnt = 0;
        tlen = 1;
        mode = 2;
        cx = center(bx1, bx2);
        cy = center(by1, by2);
      }
    }
    if (id > 0 && misses > p.max_age) {  // strictly after the miss increment
      id = 0;
      hits = 0;
      tlen = 0;
      vcnt = 0;
    }

    out.track_id[t] = id;
    out.bbox[t * 4 + 0] = bx1;
    out.bbox[t * 4 + 1] = by1;
    out.bbox[t * 4 + 2] = bx2;
    out.bbox[t * 4 + 3] = by2;
    out.class_id[t] = cls;
    out.conf[t] = conf;
    out.age[t] = age;
    out.hits[t] = hits;
    out.misses[t] = misses;
    out.vel[t * 2 + 0] = vx;
    out.vel[t * 2 + 1] = vy;
    out.vel_count[t] = vcnt;
    out.traj_len[t] = tlen;
    out.match[t] = m;
    s_traj_mode[t] = mode;
    s_cx[t] = cx;
    s_cy[t] = cy;
    s_okey[t] = (id > 0 && hits >= p.min_hits) ? id : kI32Max;
  }
  __syncthreads();

  // --- trajectory ring: copy, with the matched write or the birth row -----
  const int W = 2 * L;
  for (int i = tid; i < T * W; i += blockDim.x) {
    const int t = i / W, c = i - t * W;
    const int mode = s_traj_mode[t];
    float v = in.traj[i];
    if (mode == 2) {
      v = c == 0 ? s_cx[t] : (c == 1 ? s_cy[t] : 0.0f);
    } else if (mode == 1 && (c >> 1) == s_widx[t]) {
      v = (c & 1) ? s_cy[t] : s_cx[t];
    }
    out.traj[i] = v;
  }

  // --- confirmed order: stable by (id, slot), unconfirmed slots last ------
  for (int t = tid; t < T; t += blockDim.x) {
    const int kt = s_okey[t];
    int r = 0;
    for (int j = 0; j < T; ++j) {
      const int kj = s_okey[j];
      r += (kj < kt) || (kj == kt && j < t);
    }
    out.order[r] = t;
  }
  if (tid < kMaxT) {
    const bool confirmed = tid < T && s_okey[tid] != kI32Max;
    const unsigned b = __ballot_sync(0xffffffffu, confirmed);
    if (lane == 0) s_conf_bits[warp] = b;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int w = 0; w < kMaxT / 32; ++w) n += __popc(s_conf_bits[w]);
    *out.n_conf = n;
    *out.next_id = next_id + n_birth;
  }
}

}  // namespace

extern "C" int madpp_tracker_step(
    const void* track_id, const void* bbox, const void* class_id, const void* conf,
    const void* age, const void* hits, const void* misses, const void* traj,
    const void* traj_len, const void* vel, const void* vel_count, const void* next_id,
    const void* det_bbox, const void* det_class, const void* det_conf,
    const void* det_valid, void* o_track_id, void* o_bbox, void* o_class_id,
    void* o_conf, void* o_age, void* o_hits, void* o_misses, void* o_traj,
    void* o_traj_len, void* o_vel, void* o_vel_count, void* o_next_id, void* o_match,
    void* o_order, void* o_n_conf, int T, int D, int L, float iou_threshold,
    int max_age, int min_hits, void* stream) {
  if (T < 1 || T > kMaxT || D < 1 || D > kMaxD || L < 1) return (int)cudaErrorInvalidValue;
  TrackerIn in{(const int*)track_id, (const float*)bbox, (const int*)class_id,
               (const float*)conf, (const int*)age, (const int*)hits,
               (const int*)misses, (const float*)traj, (const int*)traj_len,
               (const float*)vel, (const int*)vel_count, (const int*)next_id,
               (const float*)det_bbox, (const int*)det_class, (const float*)det_conf,
               (const bool*)det_valid};
  TrackerOut out{(int*)o_track_id, (float*)o_bbox, (int*)o_class_id, (float*)o_conf,
                 (int*)o_age, (int*)o_hits, (int*)o_misses, (float*)o_traj,
                 (int*)o_traj_len, (float*)o_vel, (int*)o_vel_count, (int*)o_next_id,
                 (int*)o_match, (int*)o_order, (int*)o_n_conf};
  TrackerParams p{T, D, L, iou_threshold, max_age, min_hits};
  const size_t smem = sizeof(float) * (size_t)T * (size_t)(D + 1);
  tracker_step_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(in, out, p);
  return (int)cudaGetLastError();
}
