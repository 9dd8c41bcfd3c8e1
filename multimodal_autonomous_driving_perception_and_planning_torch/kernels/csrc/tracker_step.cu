// Kernel K1: one whole tracker step (IoU, association, lifecycle, confirmed
// order) for one frame, in one thread block a lane.
//
// Lanes: the grid has B blocks, and block b runs lane b's whole step, as
// the unbatched kernel runs it.  Every input and output field is (B, ...)
// contiguous, lane b at b times the field's size a lane (`lane_in`,
// `lane_out`), so the unbatched call is B = 1 of the same kernel.  The
// lanes share nothing: the server's sessions and the runner's cameras each
// take a lane, and all of them advance in one launch a frame.
//
// Replaces the Pallas TPU kernel in the JAX package's
// ops/tracker_pallas.py (`_make_kernel`, launched by `tracker_update_pallas`).
// Its plain PyTorch version is tracking/tracker.py `tracker_update` followed
// by `confirmed_order`; the kernel is bit-identical to it on every output.
//
// Bound on an H100: at T=64 slots, D=16 detections, L=50 the step reads
// about 29.6 KB and writes about 29.7 KB (the trajectory ring dominates),
// about 18 ns at 3.35 TB/s, and does a few thousand operations.  Both are
// far below the launch latency, so what bounds the step is its chain of
// dependent steps: each round trip to device memory (about a microsecond
// with the launch's cold caches) and each barrier-separated phase.  The
// design keeps that chain short:
//  - one wave of loads at the start: every thread requests all of its
//    inputs at once (the slot fields into registers of the slot's thread,
//    boxes and detections into shared memory), and the trajectory ring goes
//    to shared memory by asynchronous 16-byte copies (`cp.async`) whose
//    latency hides behind the IoU and the ranks;
//  - the association's keys built by the block, its rounds on one warp
//    with no barrier when at most 32 pairs are eligible (every frame of
//    the paths), else on a warp a 32 slots with one barrier a round
//    (association.cuh `greedy_associate`, shared with K4);
//  - both stable ranks (`id_rank` and the confirmed order) as parallel
//    counts, a few threads a slot over 16-byte loads of the keys, summed by
//    shuffles;
//  - births without a barrier: the free slots and the unmatched detections
//    are bit masks, and slot t finds its detection as the r-th set bit;
//  - the ring goes out right after the association, from shared memory as
//    16-byte stores that need no per-element logic, and after one barrier
//    each slot's thread stores this frame's write (two floats, or the row
//    of a birth) over it.  A ring that does not fit in shared memory (L
//    above about 170 at T = 128, D = 64) is copied from device memory
//    instead; one that is not 16-byte aligned or not a multiple of 16
//    bytes (T L odd) takes 4-byte copies for what is left.
// Nothing goes back to the host: next_id and the confirmed count stay on
// the device.
//
// Exactness: the IoU must equal `pairwise_iou` bit for bit, or tie-breaks
// and track ids move.  Every float operation on that path uses the _rn
// intrinsics, which the compiler never contracts into an FMA.  Every
// reduction runs on a key with a total order.
//
// Outputs are carved from one float32 and one int32 buffer, each field at a
// multiple of 4 elements (16 bytes), in the order of ops/tracker_kernel.py
// `FLOAT_FIELDS` and `INT_FIELDS`.
//
// Two instances, chosen by shape: the one described above for T <= 128 and
// D <= 64, and a general one for T and D up to 1,024 (below, before the
// launcher).  L >= 1, B >= 1.  The wrapper checks the limits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "association.cuh"

namespace {

constexpr int kMaxT = 128;
constexpr int kMaxD = 64;
constexpr int kThreads = 256;
static_assert(kThreads / 32 <= kAssocWarps, "the association lists entries a warp");
constexpr int kDetThread0 = kThreads - kMaxD;  // threads 192-255 load the detections
// Dynamic shared memory the kernel may take: the staged ring, the IoU
// matrix and the association's keys, under the 227 KB a block may use
// beside the static arrays.
constexpr size_t kMaxDynamicSmem = 200 * 1024;

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
  float *traj, *bbox, *conf, *vel;
  int *track_id, *class_id, *age, *hits, *misses, *traj_len, *vel_count, *match, *order, *next_id, *n_conf;
};

struct TrackerParams {
  int T, D, L;
  float iou_threshold;
  int max_age, min_hits;
  int stage_ring;  // the ring goes through shared memory
};

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

// The output fields in the buffers, each (B, ...) and at a multiple of 4
// elements: ops/tracker_kernel.py FLOAT_FIELDS (trajectory, bbox,
// confidence, velocity) and INT_FIELDS (track_id, class_id, age, hits,
// misses, traj_len, vel_count, match, order, next_id, n_confirmed).
TrackerOut carve(float* f, int* i, int T, int L, int B) {
  TrackerOut o;
  float** fs[] = {&o.traj, &o.bbox, &o.conf, &o.vel};
  const size_t fn[] = {(size_t)2 * T * L, (size_t)4 * T, (size_t)T, (size_t)2 * T};
  for (int k = 0; k < 4; ++k) {
    *fs[k] = f;
    f += round4(fn[k] * B);
  }
  int** is[] = {&o.track_id, &o.class_id, &o.age, &o.hits, &o.misses, &o.traj_len,
                &o.vel_count, &o.match, &o.order, &o.next_id, &o.n_conf};
  for (int k = 0; k < 11; ++k) {
    *is[k] = i;
    i += round4((k < 9 ? (size_t)T : 1) * B);
  }
  return o;
}

// Lane b's inputs and outputs: each field advanced by b times its size a lane.
__device__ __forceinline__ TrackerIn lane_in(TrackerIn in, size_t b, int T, int D, int L) {
  const size_t t = b * T, d = b * D;
  in.track_id += t, in.bbox += 4 * t, in.class_id += t, in.conf += t, in.age += t, in.hits += t;
  in.misses += t, in.traj += 2 * L * t, in.traj_len += t, in.vel += 2 * t, in.vel_count += t;
  in.next_id += b;
  in.det_bbox += 4 * d, in.det_class += d, in.det_conf += d, in.det_valid += d;
  return in;
}

__device__ __forceinline__ TrackerOut lane_out(TrackerOut out, size_t b, int T, int L) {
  const size_t t = b * T;
  out.traj += 2 * L * t, out.bbox += 4 * t, out.conf += t, out.vel += 2 * t;
  out.track_id += t, out.class_id += t, out.age += t, out.hits += t, out.misses += t;
  out.traj_len += t, out.vel_count += t, out.match += t, out.order += t;
  out.next_id += b, out.n_conf += b;
  return out;
}

__device__ __forceinline__ float center(float a, float b) {
  return __fmul_rn(__fadd_rn(a, b), 0.5f);
}

// The IoU of a track box and a detection box as the jitted `pairwise_iou`
// computes it: the union contracted to fma(w_b, h_b, area_a) - inter, one
// rounding for the fma.
__device__ __forceinline__ float pair_iou(float4 a, float4 b) {
  const float iw = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float ih = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  const float inter = (iw > 0.0f && ih > 0.0f) ? __fmul_rn(iw, ih) : 0.0f;
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float uni = __fsub_rn(__fmaf_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y), area_a), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

// Number of set flags before index `i`; `bits` holds one word per 32.
__device__ __forceinline__ int prefix_count(const unsigned* bits, int i) {
  int c = 0;
  for (int w = 0; w < (i >> 5); ++w) c += __popc(bits[w]);
  return c + __popc(bits[i >> 5] & ((1u << (i & 31)) - 1u));
}

// A slot's fields, loaded by its thread.
struct Slot {
  int id0, cls, age, hits, misses, vcnt, tlen;
  float conf, vx, vy;
};

// Slot t's matched update, birth and death, its outputs written and its
// confirmed key (id, or INT32_MAX) to `s_key[t]`; returns whether it is
// confirmed.  A free slot of rank r < n_birth among the free slots
// (`free_bits`) takes the detection `nth_want(r)`.
template <class NthWant>
__device__ __forceinline__ bool slot_update(int t, Slot s, float4 tb, int m, const unsigned* free_bits, int n_birth,
                                            int next_id, NthWant nth_want, const float4* s_db, const int* s_dcls,
                                            const float* s_dconf, int* s_key, const TrackerOut& out,
                                            const TrackerParams& p) {
  const int W = 2 * p.L;
  int id0 = s.id0, cls = s.cls, age = s.age, hits = s.hits, misses = s.misses, vcnt = s.vcnt, tlen = s.tlen;
  float conf = s.conf, vx = s.vx, vy = s.vy;
  const int alive = id0 > 0 ? 1 : 0;
  const bool matched = m >= 0;
  int id = id0;
  float4 box = tb;
  age += alive;
  hits += matched ? 1 : 0;
  misses = matched ? 0 : misses + alive;
  vcnt += matched ? 1 : 0;

  float* ring = out.traj + (size_t)t * W;
  if (matched) {
    const float4 db = s_db[m];
    const float cx = center(db.x, db.z), cy = center(db.y, db.w);
    vx = __fsub_rn(cx, center(tb.x, tb.z));  // before the bbox overwrite
    vy = __fsub_rn(cy, center(tb.y, tb.w));
    box = db;
    conf = s_dconf[m];
    const int widx = tlen % p.L;
    ring[2 * widx] = cx;
    ring[2 * widx + 1] = cy;
    tlen += 1;
  }
  if (id0 == 0) {
    const int r = prefix_count(free_bits, t);
    if (r < n_birth) {
      id = next_id + r;
      const int d = nth_want(r);
      box = s_db[d];
      cls = s_dcls[d];
      conf = s_dconf[d];
      age = 0;
      hits = 1;
      misses = 0;
      vx = 0.0f;
      vy = 0.0f;
      vcnt = 0;
      tlen = 1;
      ring[0] = center(box.x, box.z);
      ring[1] = center(box.y, box.w);
      for (int c = 2; c < W; ++c) ring[c] = 0.0f;
    }
  }
  if (id > 0 && misses > p.max_age) {  // strictly after the miss increment
    id = 0;
    hits = 0;
    tlen = 0;
    vcnt = 0;
  }

  out.track_id[t] = id;
  out.bbox[4 * t + 0] = box.x;
  out.bbox[4 * t + 1] = box.y;
  out.bbox[4 * t + 2] = box.z;
  out.bbox[4 * t + 3] = box.w;
  out.class_id[t] = cls;
  out.conf[t] = conf;
  out.age[t] = age;
  out.hits[t] = hits;
  out.misses[t] = misses;
  out.vel[2 * t + 0] = vx;
  out.vel[2 * t + 1] = vy;
  out.vel_count[t] = vcnt;
  out.traj_len[t] = tlen;
  out.match[t] = m;
  const bool confirmed = id > 0 && hits >= p.min_hits;
  s_key[t] = confirmed ? id : kI32Max;
  return confirmed;
}

// Stable ascending rank of each of `key[0..T)` (ties by index), counted in
// parallel: P = 256 / T threads (a power of two) share slot t, each
// comparing t's key with a contiguous share of the others, read 16 bytes
// at a time, and a shuffle sum adds the shares.  `key` is 16-byte aligned
// with room for kMaxT entries.  Writes rank[t] = r, or order[r] = t where
// `rank` is null.  (A warp ballot a slot and 32 keys, tried first, cost
// about 3,000 cycles a rank on the card: 8 dependent ballots a warp.)
__device__ __forceinline__ void stable_rank(const int* key, int T, int* rank, int* order) {
  const int per = min(32, floor_pow2(kThreads / T));
  const int t = threadIdx.x / per, sub = threadIdx.x & (per - 1);
  const int span = (((T + per - 1) / per) + 3) & ~3;  // per * span <= kMaxT
  int r = 0;
  if (t < T) {
    const int kt = key[t];
#pragma unroll 4
    for (int j = sub * span; j < (sub + 1) * span; j += 4) {
      const int4 k = *reinterpret_cast<const int4*>(key + j);
      r += (j < T) && (k.x < kt || (k.x == kt && j < t));
      r += (j + 1 < T) && (k.y < kt || (k.y == kt && j + 1 < t));
      r += (j + 2 < T) && (k.z < kt || (k.z == kt && j + 2 < t));
      r += (j + 3 < T) && (k.w < kt || (k.w == kt && j + 3 < t));
    }
  }
  for (int off = per >> 1; off > 0; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
  if (sub == 0 && t < T) {
    if (rank) rank[t] = r;
    else order[r] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
tracker_step_kernel(TrackerIn lanes_in, TrackerOut lanes_out, TrackerParams p) {
  // [ring (if staged)] [IoU T x (D + 1)] [association keys]
  extern __shared__ __align__(16) float s_dyn[];
  __shared__ float4 s_tb[kMaxT];
  __shared__ float4 s_db[kMaxD];
  __shared__ int s_id[kMaxT];
  __shared__ __align__(16) int s_key[kMaxT];  // the id key, then the confirmed key
  __shared__ int s_rank[kMaxT];
  __shared__ int s_match[kMaxT];
  __shared__ __align__(16) unsigned s_assoc[kAssocScratch];
  __shared__ int s_dcls[kMaxD];
  __shared__ float s_dconf[kMaxD];
  __shared__ unsigned s_col_done[kMaxD / 32];
  __shared__ unsigned s_valid_bits[kMaxD / 32], s_free_bits[kMaxT / 32], s_conf_bits[kMaxT / 32];
  __shared__ int s_next_id;

  const int T = p.T, D = p.D, W = 2 * p.L;
  const TrackerIn in = lane_in(lanes_in, blockIdx.x, T, D, p.L);
  const TrackerOut out = lane_out(lanes_out, blockIdx.x, T, p.L);
  const int ld = D + 1;
  const int n_ring = T * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* s_ring = s_dyn;
  float* s_iou = s_dyn + (p.stage_ring ? round4(n_ring) : 0);
  unsigned* s_keys = reinterpret_cast<unsigned*>(s_iou + round4((size_t)T * ld));

  // --- one wave of loads ----------------------------------------------------
  if (p.stage_ring) stage_async(s_ring, in.traj, n_ring);
  int id0 = 0, cls = 0, age = 0, hits = 0, misses = 0, vcnt = 0, tlen = 0;
  float conf = 0.0f, vx = 0.0f, vy = 0.0f;
  if (tid < kMaxT) {
    const bool slot = tid < T;
    if (slot) {
      const int t = tid;
      id0 = in.track_id[t];
      s_tb[t] = make_float4(in.bbox[4 * t], in.bbox[4 * t + 1], in.bbox[4 * t + 2], in.bbox[4 * t + 3]);
      cls = in.class_id[t];
      conf = in.conf[t];
      age = in.age[t];
      hits = in.hits[t];
      misses = in.misses[t];
      tlen = in.traj_len[t];
      vx = in.vel[2 * t];
      vy = in.vel[2 * t + 1];
      vcnt = in.vel_count[t];
      s_id[t] = id0;
      s_key[t] = id0 > 0 ? id0 : kI32Max;
    }
    const unsigned b = __ballot_sync(0xffffffffu, slot && id0 == 0);
    if (lane == 0) s_free_bits[warp] = b;
  } else if (tid >= kDetThread0) {
    const int d = tid - kDetThread0;
    bool valid = false;
    if (d < D) {
      valid = in.det_valid[d];
      s_db[d] = make_float4(in.det_bbox[4 * d], in.det_bbox[4 * d + 1], in.det_bbox[4 * d + 2],
                            in.det_bbox[4 * d + 3]);
      s_dcls[d] = in.det_class[d];
      s_dconf[d] = in.det_conf[d];
    }
    const unsigned b = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) s_valid_bits[d >> 5] = b;
  } else if (tid == kMaxT) {
    s_next_id = *in.next_id;
  }
  __syncthreads();

  // --- IoU as the jitted `pairwise_iou` computes it: the union contracted to
  // fma(w_b, h_b, area_a) - inter, one rounding for the fma; invalid pairs -1
  const int step_t = kThreads / D, step_d = kThreads - step_t * D;
  for (int i = tid, t = tid / D, d = tid - (tid / D) * D; i < T * D; i += kThreads) {
    float v = pair_iou(s_tb[t], s_db[d]);
    if (!(s_id[t] > 0 && ((s_valid_bits[d >> 5] >> (d & 31)) & 1u))) v = -1.0f;
    s_iou[t * ld + d] = v;
    t += step_t;
    d += step_d;
    if (d >= D) {
      d -= D;
      ++t;
    }
  }
  // Stable rank of each slot by id, dead slots last (`id_rank`).
  stable_rank(s_key, T, s_rank, nullptr);
  // The ring has had the IoU and the ranks to land; the barrier makes
  // every thread's copies visible.
  if (p.stage_ring) cp_async_wait_all();
  __syncthreads();
  greedy_associate(s_iou, ld, s_keys, s_rank, T, D, p.iou_threshold, s_match, s_col_done, s_assoc);
  __syncthreads();

  // --- the ring out as it was, 16 bytes a store where both ends allow ------
  // This frame's writes follow after a barrier, from each slot's thread.
  const float* src = p.stage_ring ? s_ring : in.traj;
  int done = 0;
  if (aligned16(out.traj) && aligned16(src)) {
    const int n4 = n_ring >> 2;
    for (int i = tid; i < n4; i += kThreads)
      reinterpret_cast<float4*>(out.traj)[i] = reinterpret_cast<const float4*>(src)[i];
    done = n4 << 2;
  }
  for (int i = done + tid; i < n_ring; i += kThreads) out.traj[i] = src[i];

  // --- births: the k-th unmatched valid detection takes the k-th free slot
  const unsigned want0 = s_valid_bits[0] & ~s_col_done[0];
  const unsigned want1 = s_valid_bits[1] & ~s_col_done[1];
  int n_free = 0;
  for (int w = 0; w < kMaxT / 32; ++w) n_free += __popc(s_free_bits[w]);
  const int n_birth = min(n_free, __popc(want0) + __popc(want1));
  const int next_id = s_next_id;
  __syncthreads();

  // --- per slot: matched update, birth, death ------------------------------
  if (tid < kMaxT) {
    bool confirmed = false;
    if (tid < T) {
      // The r-th set bit of the wanted mask.
      auto nth_want = [&](int r) {
        unsigned w = want0;
        int base = 0;
        if (r >= __popc(want0)) {
          r -= __popc(want0);
          w = want1;
          base = 32;
        }
        for (int k = 0; k < r; ++k) w &= w - 1u;
        return base + __ffs(w) - 1;
      };
      confirmed = slot_update(tid, Slot{id0, cls, age, hits, misses, vcnt, tlen, conf, vx, vy}, s_tb[tid],
                              s_match[tid], s_free_bits, n_birth, next_id, nth_want, s_db, s_dcls, s_dconf, s_key,
                              out, p);
    }
    const unsigned b = __ballot_sync(0xffffffffu, confirmed);
    if (lane == 0) s_conf_bits[warp] = b;
  }
  __syncthreads();

  // --- confirmed order: stable by (id, slot), unconfirmed slots last ------
  stable_rank(s_key, T, nullptr, out.order);
  if (tid == 0) {
    int n = 0;
    for (int w = 0; w < kMaxT / 32; ++w) n += __popc(s_conf_bits[w]);
    *out.n_conf = n;
    *out.next_id = next_id + n_birth;
  }
}

// --- The general instance: T and D up to 1,024 -----------------------------
//
// One block of 1,024 threads a lane, thread t holding slot t and loading
// detection t.  What the instance above keeps in static arrays sized 128
// and 64, and in two-word masks, is here sized by T and D in dynamic shared
// memory and held as ceil(n / 32) words; the association runs the general
// rounds (association.cuh `greedy_associate_general`), which compute each
// IoU from the boxes when a round needs it, so no matrix is stored; the
// ranks count over all T keys on each slot's thread; births find the r-th
// unmatched detection by a prefix count over the mask's words; the ring
// is copied from device memory (at T = 1,024 and L = 50 it is 410 KB).
// Same arithmetic, same outputs, bit for bit.
constexpr int kGeneralThreads = 1024;
constexpr int kGeneralMax = kGeneralThreads;  // T and D
static_assert(kGeneralMax <= kAssocGeneralMax, "the general rounds take the general tables");

// Dynamic shared memory of the general instance: boxes of the slots and of
// the detections (16 bytes each), the association's rounds, then ids,
// keys, ranks (T each), classes and confidences (D each).
__host__ __device__ inline size_t general_smem(int T, int D) {
  return 16 * (size_t)(T + D) + assoc_general_smem(T, D) + 4 * (3 * (size_t)T + 2 * (size_t)D);
}

// Stable ascending rank of key[0..T) on thread t, over all T keys.
__device__ __forceinline__ int stable_rank_of(const int* key, int T, int t) {
  const int kt = key[t];
  int r = 0;
  for (int j = 0; j < T; ++j) r += key[j] < kt || (key[j] == kt && j < t);
  return r;
}

__global__ void __launch_bounds__(kGeneralThreads)
tracker_step_general(TrackerIn lanes_in, TrackerOut lanes_out, TrackerParams p) {
  extern __shared__ __align__(16) float4 s_gen[];
  __shared__ unsigned s_valid_bits[kGeneralMax / 32], s_want_bits[kGeneralMax / 32];
  __shared__ unsigned s_free_bits[kGeneralMax / 32], s_conf_bits[kGeneralMax / 32];
  __shared__ int s_next_id;

  const int T = p.T, D = p.D, W = 2 * p.L;
  const TrackerIn in = lane_in(lanes_in, blockIdx.x, T, D, p.L);
  const TrackerOut out = lane_out(lanes_out, blockIdx.x, T, p.L);
  float4* s_tb = s_gen;
  float4* s_db = s_tb + T;
  void* s_assoc = s_db + D;
  int* s_id = reinterpret_cast<int*>(static_cast<char*>(s_assoc) + assoc_general_smem(T, D));
  int* s_key = s_id + T;
  int* s_rank = s_key + T;
  int* s_dcls = s_rank + T;
  float* s_dconf = reinterpret_cast<float*>(s_dcls + D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // --- loads: slot tid and detection tid --------------------------------------
  Slot s{0, 0, 0, 0, 0, 0, 0, 0.0f, 0.0f, 0.0f};
  const bool slot = tid < T;
  if (slot) {
    const int t = tid;
    s = Slot{in.track_id[t], in.class_id[t], in.age[t], in.hits[t], in.misses[t], in.vel_count[t],
             in.traj_len[t], in.conf[t], in.vel[2 * t], in.vel[2 * t + 1]};
    s_tb[t] = make_float4(in.bbox[4 * t], in.bbox[4 * t + 1], in.bbox[4 * t + 2], in.bbox[4 * t + 3]);
    s_id[t] = s.id0;
    s_key[t] = s.id0 > 0 ? s.id0 : kI32Max;
  }
  const unsigned fb = __ballot_sync(0xffffffffu, slot && s.id0 == 0);
  bool valid = false;
  if (tid < D) {
    const int d = tid;
    valid = in.det_valid[d];
    s_db[d] = make_float4(in.det_bbox[4 * d], in.det_bbox[4 * d + 1], in.det_bbox[4 * d + 2],
                          in.det_bbox[4 * d + 3]);
    s_dcls[d] = in.det_class[d];
    s_dconf[d] = in.det_conf[d];
  }
  const unsigned vb = __ballot_sync(0xffffffffu, valid);
  if (lane == 0) s_free_bits[warp] = fb, s_valid_bits[warp] = vb;
  if (tid == 0) s_next_id = *in.next_id;
  __syncthreads();

  // --- the id rank, then the association over IoUs computed as needed ---------
  if (slot) s_rank[tid] = stable_rank_of(s_key, T, tid);
  __syncthreads();
  greedy_associate_general(
      [&](int t, int d) {
        const float v = pair_iou(s_tb[t], s_db[d]);
        return (s_id[t] > 0 && ((s_valid_bits[d >> 5] >> (d & 31)) & 1u)) ? v : -1.0f;
      },
      s_rank, T, D, p.iou_threshold, s_assoc);
  const int* s_match = assoc_general_match(s_assoc, T, D);
  const int* s_taken = assoc_general_taken(s_assoc, T, D);

  // --- the ring out as it was; this frame's writes follow after a barrier -----
  const int n_ring = T * W;
  int done = 0;
  if (aligned16(out.traj) && aligned16(in.traj)) {
    const int n4 = n_ring >> 2;
    for (int i = tid; i < n4; i += kGeneralThreads)
      reinterpret_cast<float4*>(out.traj)[i] = reinterpret_cast<const float4*>(in.traj)[i];
    done = n4 << 2;
  }
  for (int i = done + tid; i < n_ring; i += kGeneralThreads) out.traj[i] = in.traj[i];
  const unsigned wb = __ballot_sync(0xffffffffu, valid && !s_taken[tid < D ? tid : 0]);
  if (lane == 0) s_want_bits[warp] = wb;
  __syncthreads();

  // --- births: the k-th unmatched valid detection takes the k-th free slot ----
  int n_free = 0, n_want = 0;
  for (int w = 0; w < kGeneralMax / 32; ++w) n_free += __popc(s_free_bits[w]), n_want += __popc(s_want_bits[w]);
  const int n_birth = min(n_free, n_want);
  const int next_id = s_next_id;
  bool confirmed = false;
  if (slot) {
    // The r-th set bit of the wanted mask, by a prefix count over its words.
    auto nth_want = [&](int r) {
      int w = 0;
      for (; r >= __popc(s_want_bits[w]); ++w) r -= __popc(s_want_bits[w]);
      unsigned bits = s_want_bits[w];
      for (int k = 0; k < r; ++k) bits &= bits - 1u;
      return 32 * w + __ffs(bits) - 1;
    };
    confirmed = slot_update(tid, s, s_tb[tid], s_match[tid], s_free_bits, n_birth, next_id, nth_want, s_db,
                            s_dcls, s_dconf, s_key, out, p);
  }
  const unsigned cb = __ballot_sync(0xffffffffu, confirmed);
  if (lane == 0) s_conf_bits[warp] = cb;
  __syncthreads();

  // --- confirmed order: stable by (id, slot), unconfirmed slots last ----------
  if (slot) out.order[stable_rank_of(s_key, T, tid)] = tid;
  if (tid == 0) {
    int n = 0;
    for (int w = 0; w < kGeneralMax / 32; ++w) n += __popc(s_conf_bits[w]);
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
    const void* det_valid, void* out_f, void* out_i, int B, int T, int D, int L,
    float iou_threshold, int max_age, int min_hits, void* stream) {
  if (B < 1 || T < 1 || T > kGeneralMax || D < 1 || D > kGeneralMax || L < 1) return (int)cudaErrorInvalidValue;
  TrackerIn in{(const int*)track_id, (const float*)bbox, (const int*)class_id,
               (const float*)conf, (const int*)age, (const int*)hits,
               (const int*)misses, (const float*)traj, (const int*)traj_len,
               (const float*)vel, (const int*)vel_count, (const int*)next_id,
               (const float*)det_bbox, (const int*)det_class, (const float*)det_conf,
               (const bool*)det_valid};
  const TrackerOut out = carve((float*)out_f, (int*)out_i, T, L, B);
  if (T > kMaxT || D > kMaxD) {
    const size_t smem = general_smem(T, D);
    const cudaError_t err = allow_dynamic_smem<tracker_step_general>(smem);
    if (err != cudaSuccess) return (int)err;
    const TrackerParams p{T, D, L, iou_threshold, max_age, min_hits, 0};
    tracker_step_general<<<B, kGeneralThreads, smem, (cudaStream_t)stream>>>(in, out, p);
    return (int)cudaGetLastError();
  }
  const size_t iou_bytes = sizeof(float) * round4((size_t)T * (size_t)(D + 1));
  const size_t key_bytes = sizeof(unsigned) * 32 * (size_t)((T + 31) / 32) * (size_t)assoc_key_stride(D);
  const size_t ring_bytes = sizeof(float) * round4((size_t)2 * T * L);
  const bool stage = ring_bytes + iou_bytes + key_bytes <= kMaxDynamicSmem;
  const size_t smem = iou_bytes + key_bytes + (stage ? ring_bytes : 0);
  const cudaError_t err = allow_dynamic_smem<tracker_step_kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  TrackerParams p{T, D, L, iou_threshold, max_age, min_hits, stage ? 1 : 0};
  tracker_step_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(in, out, p);
  return (int)cudaGetLastError();
}
