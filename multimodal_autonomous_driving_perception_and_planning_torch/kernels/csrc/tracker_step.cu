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
// D <= 64, and a general one for T and D up to 4,096, a thread block
// cluster a lane (below, before the launcher).  L >= 1, B >= 1.  The
// wrapper checks the limits and allocates the general instance's key
// scratch where the shape needs it (`madpp_tracker_scratch`).

#include <cooperative_groups.h>
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
// (`free_bits`) takes the detection `nth_want(r)`.  `s_db[d]` is detection
// d's box (shared memory, or `BoxRef`).
template <class NthWant, class DetBoxes>
__device__ __forceinline__ bool slot_update(int t, Slot s, float4 tb, int m, const unsigned* free_bits, int n_birth,
                                            int next_id, NthWant nth_want, DetBoxes s_db, const int* s_dcls,
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

// --- The general instance: T and D up to 4,096 -----------------------------
//
// A thread block cluster a lane (association.cuh `assoc_plan`: C blocks of
// 1,024 threads; the grid is B clusters), block r owning the slots and
// detections of its part of the association's partition and, for
// everything after it, its slots (at most 1,024 a block: 256 at T =
// 4,096).  What held the one-block version back:
// the whole step on one SM of 132, an IoU recomputed, with its
// division, whenever a round touched an entry, column bests as a chain of T
// steps, both stable ranks counted over all T keys on each slot's thread
// (about 1 M shared-memory reads each at T = 1,024), and the 410 KB ring
// copy on that one SM.  Each block here:
//  - loads every slot's id (its free and live bits) and every detection's
//    valid bit, a thread every 1,024th, with every box, class and
//    confidence into shared memory where they fit (`GeneralPlan::lines`;
//    beyond, up to 160 KB at 4,096 x 4,096, they are read from device
//    memory, `BoxRef`), its slots' other fields into the registers of the
//    slot's thread, and starts copying its slots' ring rows into shared
//    memory (`cp.async`, 16 bytes where aligned, 4 for the rest) where
//    they fit;
//  - ranks every slot by id (`id_rank`): up to 1,024 slots by a bitonic
//    sort of (key, slot) pairs on every block, a thread a pair
//    (`sort_pairs`; 55 exchange steps at T = 1,024, 15 of them through
//    shared memory, the rest shuffles); beyond, by counting over the
//    cluster (`cluster_places`: each block sorts its own at most 256
//    slots, gathers every block's sorted list through distributed shared
//    memory and places its slots by binary searches, then hands their
//    ranks to every block); both in the room of the rounds' received bests,
//    which no block fills before every block has arrived (`assoc_init`);
//  - stages the IoU keys of its slots and of its detections once, with the
//    first round's bests of those lines in the same pass
//    (`stage_general_keys`; `pair_iou`'s division only where the boxes
//    overlap), then runs the cluster rounds (association.cuh
//    `cluster_associate`).  Where the keys leave shared memory (1,024 x
//    1,024 and beyond), two kernels before it do the ranks and the keys
//    over the whole card instead, each key once (`tracker_rank_kernel`,
//    `tracker_stage_kernel`, below), and the block loads the ranks and its
//    lines' first bests;
//  - writes its slots' ring rows out as they were, then each of its slots'
//    update, birth and death (`slot_update`, as in the instance above; the
//    free, valid and wanted masks are every block's);
// then the confirmed order: up to 1,024 slots each slot's confirmed key and
// each warp's confirmed bits go to block 0 (distributed shared memory
// stores), which after one cluster barrier sorts the pairs and writes the
// counters; beyond, every block places its own slots (`cluster_places`).
// Same arithmetic, same outputs, bit for bit.
constexpr int kGeneralThreads = kAssocClusterThreads;
constexpr int kGeneralMax = kAssocGeneralMax;  // T and D

// A lane's launch plan at (T, D, L): the association's partition, whether
// every slot's and detection's box, class and confidence, its key lines and
// the block's ring rows fit in shared memory, and the block's bytes of it.
struct GeneralPlan {
  AssocPlan assoc;
  int lines_in_smem, keys_in_smem, stage_ring;
  size_t smem;
};

// Shared memory a block takes besides the rounds' and the ring's: with
// `lines`, every slot's box and every detection's box, class and
// confidence; every slot's confirmed key; the valid, free, live, wanted and
// confirmed bits and the next id.
__host__ __device__ inline size_t general_fixed_smem(int T, int D, bool lines) {
  return (lines ? 16 * (size_t)(T + D) + 8 * (size_t)D : 0) + 4 * (size_t)T + 4 * (5 * (size_t)kAssocBitWords + 4);
}

__host__ __device__ inline GeneralPlan general_plan(int T, int D, int L) {
  GeneralPlan g;
  g.assoc = assoc_plan(T, D);
  g.lines_in_smem = general_fixed_smem(T, D, true) + assoc_shared_bytes(g.assoc, false) <= kAssocSmemLimit;
  const size_t fixed = general_fixed_smem(T, D, g.lines_in_smem);
  // Beyond 1,024 slots the stage kernels always run (their ranks by
  // counting over the card), so the keys go to device scratch.
  g.keys_in_smem = T <= kGeneralThreads && fixed + assoc_shared_bytes(g.assoc, true) <= kAssocSmemLimit;
  const size_t base = fixed + assoc_shared_bytes(g.assoc, g.keys_in_smem);
  const size_t ring = 4 * round4((size_t)g.assoc.rows * 2 * L);
  g.stage_ring = base + ring <= kAssocSmemLimit;
  g.smem = base + (g.stage_ring ? ring : 0);
  return g;
}

// A lane's device scratch where the keys leave shared memory: every
// block's key lines (block r's at r assoc_key_words), every slot's id rank
// and the slot at each rank, every row's and every column's first-round
// best, and every row's and every column's chunk mask (association.cuh
// `LineMasks`), all written by the kernels that run before the cluster
// kernel (`tracker_rank_kernel`, `tracker_stage_kernel`).
struct LaneScratch {
  unsigned* keys;
  int *rank, *by_rank;
  unsigned long long *rowbest, *colbest;
  unsigned *rowmask, *colmask;
  int rw, cw;  // mask words a row, a column
};

__host__ __device__ inline size_t lane_scratch_words(const GeneralPlan& g, int T, int D) {
  const size_t n = (size_t)g.assoc.cluster * assoc_key_words(g.assoc) + 2 * round4((size_t)T) + 2 * ((size_t)T + D) +
                   (size_t)T * mask_words(D) + (size_t)D * mask_words(T);
  return round4(n);
}

__device__ inline LaneScratch lane_scratch(unsigned* scratch, const GeneralPlan& g, int T, int D, int lane) {
  LaneScratch l;
  l.keys = scratch + (size_t)lane * lane_scratch_words(g, T, D);
  l.rank = reinterpret_cast<int*>(l.keys + (size_t)g.assoc.cluster * assoc_key_words(g.assoc));
  l.by_rank = l.rank + round4((size_t)T);
  l.rowbest = reinterpret_cast<unsigned long long*>(l.by_rank + round4((size_t)T));
  l.colbest = l.rowbest + T;
  l.rw = mask_words(D);
  l.cw = mask_words(T);
  l.rowmask = reinterpret_cast<unsigned*>(l.colbest + D);
  l.colmask = l.rowmask + (size_t)T * l.rw;
  return l;
}

// Box i of an (n, 4) float32 array: from shared memory where staged, else
// from device memory as four loads (no alignment assumed).
struct BoxRef {
  const float4* s;
  const float* g;
  __device__ __forceinline__ float4 operator[](int i) const {
    return s ? s[i] : make_float4(__ldg(g + 4 * i), __ldg(g + 4 * i + 1), __ldg(g + 4 * i + 2), __ldg(g + 4 * i + 3));
  }
};

// One step of a bitonic sort: this thread's value `v` against its
// partner's `o` (thread i ^ j), in a run of k sorted up where i & k is 0.
__device__ __forceinline__ unsigned long long bitonic_step(unsigned long long v, unsigned long long o, int i, int j,
                                                           int k) {
  return (((i & j) == 0) == ((i & k) == 0)) ? (o < v ? o : v) : (o > v ? o : v);
}

// Sorts one 64-bit value a thread over threads 0 .. n - 1 ascending (n a
// power of two from 32 up to the block's 1,024 threads), bitonically:
// exchanges between threads under 32 apart by shuffles, unrolled, the
// others through `buf` (a value a thread) between two block barriers.
// Warps from n on only meet the barriers.  Returns the value at this
// thread's place (threads below n).  Called by every thread of the block.
// (The steps as one runtime loop, each a branch, or on all 32 warps at
// any n, were several times slower on the card.)
__device__ inline unsigned long long sort_pairs(unsigned long long v, int n, unsigned long long* buf) {
  const int i = threadIdx.x;
  const bool in = i < n;  // whole warps: n is a multiple of 32
  if (in) {
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) v = bitonic_step(v, __shfl_xor_sync(0xffffffffu, v, j), i, j, k);
    }
  }
  for (int k = 64; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      if (in) buf[i] = v;
      __syncthreads();
      if (in) v = bitonic_step(v, buf[i ^ j], i, j, k);
      __syncthreads();
    }
    if (in) {
#pragma unroll
      for (int j = 16; j > 0; j >>= 1) v = bitonic_step(v, __shfl_xor_sync(0xffffffffu, v, j), i, j, k);
    }
  }
  return v;
}

// Slot t's sort pair: its key in signed order, then t (ties by slot).
__device__ __forceinline__ unsigned long long rank_pair(int key, int t) {
  return ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) | (unsigned)t;
}

// The sort's size for n pairs: a power of two, at least a warp.
__device__ __forceinline__ int sort_size(int n) {
  int p = 32;
  while (p < n) p <<= 1;
  return p;
}

// The key of slot box `a` and detection box `b`, bit for bit
// assoc_key(pair_iou(a, b), thr): boxes that do not overlap have IoU +0
// (`zero_key`) and skip the division.
__device__ __forceinline__ unsigned general_iou_key(float4 a, float4 b, float thr, unsigned zero_key) {
  const float iw = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float ih = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  return (iw > 0.0f && ih > 0.0f) ? assoc_key(pair_iou(a, b), thr) : zero_key;
}

// This block's key lines (association.cuh): a warp a line, its lanes over
// the line's entries, and in the same pass the first round's bests of the
// lines (every row live, every column untaken), as `cluster_associate`
// would compute them.  Keys of a slot that is not live or an invalid
// detection are 0.
__device__ inline void stage_general_keys(BoxRef tb, BoxRef db, const unsigned* s_live, const unsigned* s_valid,
                                          const AssocShared& s, unsigned* rowkeys, unsigned* colkeys,
                                          const AssocPlan& a, int T, int D, int2 rows, int2 cols, float thr) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const unsigned zero_key = assoc_key(0.0f, thr);
  for (int l = threadIdx.x >> 5; l < rows.y + cols.y; l += nwarps) {
    unsigned long long best = 0ull;
    if (l < rows.y) {
      const int t = rows.x + l;
      const float4 box = tb[t];
      const bool alive = bit_of(s_live, t);
      const unsigned base = (unsigned)s.rank[t] * (unsigned)D + 0x80000000u;
      unsigned* line = rowkeys + (size_t)l * a.rstride;
      for (int d = lane; d < a.rstride; d += 32) {
        const unsigned k = (d < D && alive && bit_of(s_valid, d)) ? general_iou_key(box, db[d], thr, zero_key) : 0u;
        line[d] = k;
        const unsigned long long e = line_entry(k, true, base + (unsigned)d);
        best = e > best ? e : best;
      }
      best = warp_max_u64(best);
      if (lane == 0) s.rowbest[l] = best;
    } else {
      const int j = l - rows.y, d = cols.x + j;
      const float4 box = db[d];
      const bool valid = bit_of(s_valid, d);
      const unsigned dcol = (unsigned)d + 0x80000000u;
      unsigned* line = colkeys + (size_t)j * a.cstride;
      int at = 0;
      for (int t = lane; t < a.cstride; t += 32) {
        const unsigned k = (t < T && valid && bit_of(s_live, t)) ? general_iou_key(tb[t], box, thr, zero_key) : 0u;
        line[t] = k;
        const unsigned long long e = line_entry(k, true, (unsigned)s.rank[t] * (unsigned)D + dcol);
        if (e > best) best = e, at = t;
      }
      const unsigned long long m = warp_max_u64(best);
      const unsigned arg = __reduce_min_sync(0xffffffffu, best == m ? (unsigned)at : 0xffffffffu);
      if (lane == 0) s.colbest[j] = m, s.colrow[j] = (int)arg;
    }
  }
}

// Sorts every slot's pair (`pair(t)` for t < T <= 1,024) ascending, a
// value a thread in registers (`sort_pairs`), and calls `put(p,
// (unsigned)sorted[p])` for each place p < T; `buf` holds sort_size(T)
// pairs.  Called by every thread of the block.
template <class Pair, class Put>
__device__ inline void sort_slots(int T, unsigned long long* buf, Pair pair, Put put) {
  const int tid = threadIdx.x;
  const unsigned long long v = sort_pairs(tid < T ? pair(tid) : ~0ull, sort_size(T), buf);
  if (tid < T) put(tid, (unsigned)v);
}

// Beyond 1,024 slots, the confirmed order by counting over the cluster:
// each block sorts its own slots' (key, slot) pairs (`v`, this thread's
// slot's pair, or ~0 past the block's slots; at most 256, `sort_pairs`)
// into a list in shared memory; after a cluster barrier it gathers every
// block's list through distributed shared memory, and the place of its
// s-th smallest pair is s plus the pairs below it in every other list,
// counted by binary searches, a thread four lists (threads 4 s .. 4 s + 3,
// the searches in lockstep).  Returns, in those threads, (place, slot).
// `room` is the rounds' received-best room (16 (cstride + rstride) bytes,
// free after the rounds): the list, then the gathered lists, C a.rows
// pairs.  Called by every thread of every block; the caller runs a cluster
// barrier before any block leaves (the gathers read every block's list).
__device__ inline int2 cluster_places(const AssocPlan& a, unsigned long long v, unsigned long long* room) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int tid = threadIdx.x, n = sort_size(a.rows), me = (int)cluster.block_rank();
  unsigned long long* list = room;
  unsigned long long* all = room + n;
  v = sort_pairs(v, n, list);
  if (tid < a.rows) list[tid] = v;  // the block's pairs ascending, then ~0 (a.rows <= n)
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  // At most 16 x 256 pairs: four a thread, their loads issued together.
  unsigned long long got[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = tid + u * kGeneralThreads, b = e / a.rows;
    got[u] = e < a.cluster * a.rows ? *cluster.map_shared_rank(list + (e - b * a.rows), b) : 0ull;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (tid + u * kGeneralThreads < a.cluster * a.rows) all[tid + u * kGeneralThreads] = got[u];
  __syncthreads();
  const int sl = tid >> 2, q = tid & 3;
  const unsigned long long x = sl < a.rows ? list[sl] : ~0ull;
  int pos[4] = {0, 0, 0, 0};
  bool use[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) use[u] = q + 4 * u < a.cluster && q + 4 * u != me && x != ~0ull;
  for (int step = floor_pow2(a.rows); step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned long long* l = all + (size_t)(q + 4 * u) * a.rows;
      if (use[u] && pos[u] + step <= a.rows && l[pos[u] + step - 1] < x) pos[u] += step;
    }
  }
  int place = pos[0] + pos[1] + pos[2] + pos[3] + (q == 0 ? sl : 0);
  place += __shfl_xor_sync(0xffffffffu, place, 1);
  place += __shfl_xor_sync(0xffffffffu, place, 2);
  return make_int2(place, x == ~0ull ? -1 : (int)(unsigned)x);
}

// --- Staging over the whole card, where the keys leave shared memory -----
//
// At (1,024, 1,024) and beyond the keys live in device scratch, and
// computing them inside the cluster took the cluster's 16 SMs of 132, each
// key twice (by its row's owner and its column's).  Two kernels on the same
// stream before the cluster kernel do that work over the card instead:
//  - `tracker_rank_kernel`: every slot's id rank by counting (a warp a
//    slot, its lanes over the ids 16 bytes at a time from shared memory),
//    its inverse, and the first-round bests and chunk masks cleared;
//  - `tracker_stage_kernel`: a block a 128 x 64 tile, a warp 32 x 32 keys
//    (on small tables a 32 x 64 tile, a warp 8 x 32, so that the blocks
//    fill the card), each key computed once (`general_iou_key`,
//    `pair_iou`'s division only where the boxes overlap) and written to its
//    row line, lane by column, and through a shared-memory transpose to its
//    column line, lane by row (association.cuh `stage_transpose`, shared
//    with K4's stage kernel).  The first round's bests come out of the
//    same pass: each line's best within the tile, combined over the
//    block's warps, then maxed into the scratch's bests by one 64-bit
//    atomicMax a line and block, packed so that the maximum is the rounds'
//    own best: a row's (key, then the least column), a column's (key, then
//    the least id rank); and each line's chunk masks (association.cuh
//    `LineMasks`) by one atomicOr.
// The cluster kernel then loads the ranks and the bests and goes straight
// to the rounds, which read only the chunks the masks mark.  Each kernel
// may start while the one before it finishes (`launch_after`).
constexpr int kRankThreads = 1024, kRankSlots = kRankThreads / 32;

__global__ void __launch_bounds__(kRankThreads)
tracker_rank_kernel(const int* __restrict__ track_id, int T, int D, GeneralPlan g, unsigned* __restrict__ scratch) {
  __shared__ __align__(16) int s_key[kGeneralMax];
  grid_launch_dependents();  // the stage kernel loads its boxes meanwhile
  const int lane_b = blockIdx.y;
  const LaneScratch ls = lane_scratch(scratch, g, T, D, lane_b);
  const int* id = track_id + (size_t)lane_b * T;
  const int n4 = (T + 3) >> 2;
  for (int j = threadIdx.x; j < 4 * n4; j += kRankThreads) {
    const int v = j < T ? id[j] : 0;
    s_key[j] = v > 0 ? v : kI32Max;  // dead slots last; the padding past T never counts (j > every t)
  }
  // The first-round bests and the chunk masks start empty: the stage kernel
  // maxes and ORs into them.
  const int stride = gridDim.x * kRankThreads, first = blockIdx.x * kRankThreads + threadIdx.x;
  for (int x = first; x < T + D; x += stride) ls.rowbest[x] = 0ull;  // the column bests follow the rows'
  for (int x = first; x < T * ls.rw + D * ls.cw; x += stride) ls.rowmask[x] = 0u;  // and the column masks
  __syncthreads();
  // A warp a slot, its lanes over consecutive 16-byte chunks of the keys.
  const int t = blockIdx.x * kRankSlots + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  int r = 0;
  if (t < T) {
    const int kt = s_key[t];
#pragma unroll 4
    for (int c = lane; c < n4; c += 32) {
      const int4 k = reinterpret_cast<const int4*>(s_key)[c];
      const int j = 4 * c;
      r += (k.x < kt) | ((k.x == kt) & (j < t));
      r += (k.y < kt) | ((k.y == kt) & (j + 1 < t));
      r += (k.z < kt) | ((k.z == kt) & (j + 2 < t));
      r += (k.w < kt) | ((k.w == kt) & (j + 3 < t));
    }
  }
  r = __reduce_add_sync(0xffffffffu, r);
  if (t < T && lane == 0) ls.rank[t] = r, ls.by_rank[r] = t;
}

// A stage block: 8 warps as 4 row groups of kRows rows by 2 column groups
// of 32 columns (kRows 32 on large tables, 8 on small ones, where the
// blocks would be too few for the card).
template <int kRows>
__global__ void __launch_bounds__(kStageThreads)
tracker_stage_kernel(TrackerIn lanes_in, TrackerParams p, GeneralPlan g, unsigned* __restrict__ scratch) {
  constexpr int kBlockRows = 4 * kRows;
  __shared__ float4 s_tb[kBlockRows];
  __shared__ int s_rk[kBlockRows];
  __shared__ bool s_live[kBlockRows];
  __shared__ unsigned s_tile[kStageThreads / 32][kRows][33];
  __shared__ unsigned long long s_rowpart[2][kBlockRows], s_colpart[4][kStageCols];
  const int T = p.T, D = p.D, lane_b = blockIdx.z;
  const AssocPlan& a = g.assoc;
  const TrackerIn in = lane_in(lanes_in, lane_b, T, D, p.L);
  const LaneScratch ls = lane_scratch(scratch, g, T, D, lane_b);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, rg = warp >> 1, cg = warp & 1;
  const int t_blk = blockIdx.y * kBlockRows, d_blk = blockIdx.x * kStageCols;
  grid_launch_dependents();  // the cluster kernel loads its slots meanwhile
  if (tid < kBlockRows) {
    const int t = t_blk + tid;
    const bool in_t = t < T;
    s_tb[tid] = in_t ? make_float4(in.bbox[4 * t], in.bbox[4 * t + 1], in.bbox[4 * t + 2], in.bbox[4 * t + 3])
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s_live[tid] = in_t && in.track_id[t] > 0;
  }
  const int t0 = t_blk + kRows * rg, d0 = d_blk + 32 * cg, d = d0 + lane;
  const bool valid = d < D && in.det_valid[d];
  const float4 db = valid ? make_float4(in.det_bbox[4 * d], in.det_bbox[4 * d + 1], in.det_bbox[4 * d + 2],
                                        in.det_bbox[4 * d + 3])
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  unsigned* rowline = stage_row_line(ls.keys, a, t0);
  unsigned* colline = stage_col_line(ls.keys, a, d0);
  const unsigned zero_key = assoc_key(0.0f, p.iou_threshold);
  unsigned (*tile)[33] = s_tile[warp];
  grid_dependency_wait();  // the ranks, and the bests and masks cleared
  if (tid < kBlockRows) s_rk[tid] = t_blk + tid < T ? ls.rank[t_blk + tid] : 0;
  __syncthreads();
  unsigned long long cbest = 0ull;
#pragma unroll 4
  for (int i = 0; i < kRows; ++i) {  // lane by column: row t0 + i
    const int tr = kRows * rg + i;
    const unsigned k = (valid && s_live[tr]) ? general_iou_key(s_tb[tr], db, p.iou_threshold, zero_key) : 0u;
    tile[i][lane] = k;
    if (t0 + i < T && d < a.rstride) rowline[(size_t)i * a.rstride + d] = k;  // zero past D
    const unsigned long long e = ((unsigned long long)k << 32) | (0xffffffffu - (unsigned)s_rk[tr]);
    cbest = (k != 0u && e > cbest) ? e : cbest;
  }
  __syncwarp();
  const unsigned long long rbest = stage_transpose<kRows>(tile, colline, a, D, t0, d0, [](unsigned k, int, int dk) {
    return ((unsigned long long)k << 32) | (0xffffffffu - (unsigned)dk);
  });
  // A best is nonzero exactly where its line's entries here hold an
  // eligible key: the chunk's mask bit.
  if (lane < kRows) s_rowpart[cg][kRows * rg + lane] = rbest;
  s_colpart[rg][32 * cg + lane] = cbest;
  __syncthreads();
  if (tid < kBlockRows) {  // row t_blk + tid: chunks d_blk / 32 and the next, in one mask word
    const unsigned long long r0 = s_rowpart[0][tid], r1 = s_rowpart[1][tid];
    const unsigned long long v = max(r0, r1);
    const int ch = d_blk >> 5;
    const unsigned bits = ((r0 != 0ull ? 1u : 0u) | (r1 != 0ull ? 2u : 0u)) << (ch & 31);
    if (v != 0ull && t_blk + tid < T) {
      atomicMax(ls.rowbest + t_blk + tid, v);
      atomicOr(ls.rowmask + (size_t)(t_blk + tid) * ls.rw + (ch >> 5), bits);
    }
  } else if (tid < kBlockRows + kStageCols) {  // column d_blk + c: the chunks of the block's rows, in one mask word
    const int c = tid - kBlockRows;
    unsigned long long v = 0ull;
    unsigned bits = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v = max(v, s_colpart[q][c]);
      bits |= (s_colpart[q][c] != 0ull ? 1u : 0u) << (((t_blk + kRows * q) >> 5) & 31);
    }
    if (v != 0ull && d_blk + c < D) {
      atomicMax(ls.colbest + d_blk + c, v);
      atomicOr(ls.colmask + (size_t)(d_blk + c) * ls.cw + (t_blk >> 5 >> 5), bits);
    }
  }
}

// The stage kernel's launch (association.cuh `stage_big_tiles`).
cudaError_t launch_stage(const TrackerIn& in, const TrackerParams& p, const GeneralPlan& g, unsigned* scratch, int B,
                         cudaStream_t st) {
  const bool big = stage_big_tiles(g.assoc, B);
  const dim3 grid = stage_grid(g.assoc, B, big);
  const cudaError_t err =
      big ? launch_after(true, tracker_stage_kernel<32>, grid, dim3(kStageThreads), 0, st, nullptr, in, p, g, scratch)
          : launch_after(true, tracker_stage_kernel<8>, grid, dim3(kStageThreads), 0, st, nullptr, in, p, g, scratch);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Instances: kStaged where the stage kernels ran (the keys in device
// scratch), kWide beyond 1,024 slots (only staged).
template <bool kStaged, bool kWide>
__global__ void __launch_bounds__(kGeneralThreads)
tracker_step_general(TrackerIn lanes_in, TrackerOut lanes_out, TrackerParams p, GeneralPlan g,
                     unsigned* __restrict__ scratch) {
  static_assert(kStaged || !kWide, "beyond 1,024 slots the stage kernels rank the slots");
  extern __shared__ __align__(16) float4 s_gen[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  PHASE_MARK(0);
  const AssocPlan& a = g.assoc;
  const int me = (int)cluster.block_rank(), lane_b = blockIdx.x / a.cluster;
  const int T = p.T, D = p.D, W = 2 * p.L;
  const TrackerIn in = lane_in(lanes_in, lane_b, T, D, p.L);
  const TrackerOut out = lane_out(lanes_out, lane_b, T, p.L);
  // [the rounds'] [ring rows (if staged)] [slot boxes, detection boxes,
  // classes, confidences (if staged)] [confirmed keys] [bits] [next id]
  const AssocShared s = assoc_carve(s_gen, a, g.keys_in_smem);
  char* c = reinterpret_cast<char*>(s_gen) + assoc_shared_bytes(a, g.keys_in_smem);
  float* s_ring = reinterpret_cast<float*>(c);
  c += g.stage_ring ? 4 * round4((size_t)a.rows * W) : 0;
  float4* s_tb = reinterpret_cast<float4*>(c);
  float4* s_db = s_tb + T;
  int* s_dcls = reinterpret_cast<int*>(s_db + D);
  float* s_dconf = reinterpret_cast<float*>(s_dcls + D);
  c += g.lines_in_smem ? 16 * (size_t)(T + D) + 8 * (size_t)D : 0;
  int* s_ckey = reinterpret_cast<int*>(c);
  unsigned* s_valid = reinterpret_cast<unsigned*>(s_ckey + T);
  unsigned* s_free = s_valid + kAssocBitWords;
  unsigned* s_live = s_free + kAssocBitWords;
  unsigned* s_want = s_live + kAssocBitWords;
  unsigned* s_conf = s_want + kAssocBitWords;
  int* s_next_id = reinterpret_cast<int*>(s_conf + kAssocBitWords);
  // The ranks' pairs take the room of the rounds' received bests (16
  // cstride bytes >= 8 sort_size(T) and 8 (sort_size(a.rows) + C a.rows))
  // before `assoc_init` and after the rounds.
  unsigned long long* s_sort = s.allrow;
  const BoxRef tb{g.lines_in_smem ? s_tb : nullptr, in.bbox}, db{g.lines_in_smem ? s_db : nullptr, in.det_bbox};
  const int* dcls = g.lines_in_smem ? s_dcls : in.det_class;
  const float* dconf = g.lines_in_smem ? s_dconf : in.det_conf;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tw = (T + 31) >> 5, dw = (D + 31) >> 5;  // words of the slot and detection bits
  const int2 rows = assoc_span(me, a.rows, T), cols = assoc_span(me, a.cols, D);
  const LaneScratch ls = kStaged ? lane_scratch(scratch, g, T, D, lane_b) : LaneScratch{};
  unsigned* rowkeys = kStaged ? ls.keys + (size_t)me * assoc_key_words(a) : s.keys;
  unsigned* colkeys = rowkeys + (size_t)a.rows * a.rstride;

  // --- loads: every slot's id, every detection, this block's slots ---------
  if (g.stage_ring) stage_async(s_ring, in.traj + (size_t)rows.x * W, rows.y * W);
  int id0 = 0;  // slot tid's id (the sort's, up to 1,024 slots)
  for (int t0 = 0; t0 < T; t0 += kGeneralThreads) {
    const int t = t0 + tid;
    int id = 0;
    if (t < T) {
      id = in.track_id[t];
      if (g.lines_in_smem)
        s_tb[t] = make_float4(in.bbox[4 * t], in.bbox[4 * t + 1], in.bbox[4 * t + 2], in.bbox[4 * t + 3]);
    }
    if (t0 == 0) id0 = id;
    const unsigned fb = __ballot_sync(0xffffffffu, t < T && id == 0), lb = __ballot_sync(0xffffffffu, id > 0);
    if (lane == 0 && (t >> 5) < tw) s_free[t >> 5] = fb, s_live[t >> 5] = lb;
  }
  for (int d0 = 0; d0 < D; d0 += kGeneralThreads) {
    const int d = d0 + tid;
    bool valid = false;
    if (d < D) {
      valid = in.det_valid[d];
      if (g.lines_in_smem) {
        s_db[d] = make_float4(in.det_bbox[4 * d], in.det_bbox[4 * d + 1], in.det_bbox[4 * d + 2],
                              in.det_bbox[4 * d + 3]);
        s_dcls[d] = in.det_class[d];
        s_dconf[d] = in.det_conf[d];
      }
    }
    const unsigned vb = __ballot_sync(0xffffffffu, valid);
    if (lane == 0 && (d >> 5) < dw) s_valid[d >> 5] = vb;
  }
  const bool mine = tid < rows.y;
  const int t_mine = rows.x + tid;
  Slot sl{0, 0, 0, 0, 0, 0, 0, 0.0f, 0.0f, 0.0f};
  if (mine) {
    const int t = t_mine;
    sl = Slot{in.track_id[t], in.class_id[t], in.age[t], in.hits[t], in.misses[t], in.vel_count[t],
              in.traj_len[t], in.conf[t], in.vel[2 * t], in.vel[2 * t + 1]};
  }
  if (tid == 0) *s_next_id = *in.next_id;
  __syncthreads();
  PHASE_MARK(1);

  // --- the id rank: every slot's, dead slots last, ties by slot -------------
  if constexpr (kStaged) {
    // The rank kernel's, once the stage kernel (after it) has finished:
    // the loads above ran meanwhile.
    grid_dependency_wait();
    for (int t = tid; t < T; t += kGeneralThreads) s.rank[t] = ls.rank[t];
  } else {
    sort_slots(
        T, s_sort,
        [&](int t) {
          const int id = T <= kGeneralThreads ? id0 : in.track_id[t];
          return rank_pair(id > 0 ? id : kI32Max, t);
        },
        [&](int place, unsigned t) { s.rank[t] = place; });
  }
  assoc_init(s, a);  // after the ranks: no block pushes into their room before every block has arrived
  __syncthreads();
  PHASE_MARK(2);

  // --- the keys of this block's slots and detections, then the rounds -------
  if constexpr (kStaged) {
    // The stage kernel's bests, packed for its atomicMax, as the rounds
    // order them: a row's (key, least column), a column's (key, least rank).
    for (int i = tid; i < rows.y; i += kGeneralThreads) {
      const int t = rows.x + i;
      const unsigned long long v = ls.rowbest[t];
      const unsigned d = 0xffffffffu - (unsigned)v;
      s.rowbest[i] = line_entry((unsigned)(v >> 32), true, (unsigned)s.rank[t] * (unsigned)D + 0x80000000u + d);
    }
    for (int j = tid; j < cols.y; j += kGeneralThreads) {
      const int d = cols.x + j;
      const unsigned long long v = ls.colbest[d];
      const unsigned r = 0xffffffffu - (unsigned)v;
      const bool any = v != 0ull;
      s.colbest[j] = line_entry((unsigned)(v >> 32), true, r * (unsigned)D + (unsigned)d + 0x80000000u);
      s.colrow[j] = any ? ls.by_rank[r] : 0;
    }
  } else {
    stage_general_keys(tb, db, s_live, s_valid, s, rowkeys, colkeys, a, T, D, rows, cols, p.iou_threshold);
  }
  __syncthreads();
  PHASE_MARK(3);
  if constexpr (kStaged)
    cluster_associate<true>(s, rowkeys, colkeys, a, T, D, true,
                            LineMasks{ls.rowmask + (size_t)rows.x * ls.rw, ls.colmask + (size_t)cols.x * ls.cw, ls.rw,
                                      ls.cw});
  else
    cluster_associate(s, rowkeys, colkeys, a, T, D, true);
  PHASE_MARK(4);

  // --- this block's ring rows out as they were; this frame's writes follow ---
  if (g.stage_ring) cp_async_wait_all();
  __syncthreads();
  const float* src = g.stage_ring ? s_ring : in.traj + (size_t)rows.x * W;
  float* dst = out.traj + (size_t)rows.x * W;
  const int n_ring = rows.y * W;
  int done = 0;
  if (aligned16(dst) && aligned16(src)) {
    const int n4 = n_ring >> 2;
    for (int i = tid; i < n4; i += kGeneralThreads)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    done = n4 << 2;
  }
  for (int i = done + tid; i < n_ring; i += kGeneralThreads) dst[i] = src[i];
  if (tid < dw) s_want[tid] = s_valid[tid] & ~s.taken[tid];
  __syncthreads();
  PHASE_MARK(5);

  // --- births: the k-th unmatched valid detection takes the k-th free slot ----
  int n_free = 0, n_want = 0;
  for (int w = 0; w < tw; ++w) n_free += __popc(s_free[w]);
  for (int w = 0; w < dw; ++w) n_want += __popc(s_want[w]);
  const int n_birth = min(n_free, n_want);
  const int next_id = *s_next_id;
  bool confirmed = false;
  if (mine) {
    // The r-th set bit of the wanted mask, by a prefix count over its words.
    auto nth_want = [&](int r) {
      int w = 0;
      for (; r >= __popc(s_want[w]); ++w) r -= __popc(s_want[w]);
      unsigned bits = s_want[w];
      for (int k = 0; k < r; ++k) bits &= bits - 1u;
      return 32 * w + __ffs(bits) - 1;
    };
    // Each slot's confirmed key: to block 0, which orders them, or beyond
    // 1,024 slots kept by the slot's own block.
    confirmed = slot_update(t_mine, sl, tb[t_mine], s.match[tid], s_free, n_birth, next_id, nth_want, db, dcls,
                            dconf, kWide ? s_ckey : cluster.map_shared_rank(s_ckey, 0), out, p);
  }
  // Each warp's confirmed bits go to block 0, which counts them.
  const unsigned cb = __ballot_sync(0xffffffffu, confirmed);
  if (lane == 0 && 32 * warp < rows.y) cluster.map_shared_rank(s_conf, 0)[(rows.x >> 5) + warp] = cb;
  PHASE_MARK(6);

  // --- confirmed order: stable by (id, slot), unconfirmed slots last ---------
  if constexpr (kWide) {
    // Every block places its own slots (`cluster_places`' barrier also
    // brings every warp's confirmed bits to block 0).
    const int2 placed = cluster_places(a, mine ? rank_pair(s_ckey[t_mine], t_mine) : ~0ull, s_sort);
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");  // this block's gathers are done
    if (placed.y >= 0 && (tid & 3) == 0) out.order[placed.x] = placed.y;
  } else {
    cluster.sync();  // block 0 holds every slot's confirmed key and bit
    if (me == 0)
      sort_slots(
          T, s_sort, [&](int t) { return rank_pair(s_ckey[t], t); },
          [&](int place, unsigned t) { out.order[place] = (int)t; });
  }
  if (me == 0 && warp == 0) {
    int n_conf = 0;
    for (int w = lane; w < tw; w += 32) n_conf += __popc(s_conf[w]);
    n_conf = __reduce_add_sync(0xffffffffu, n_conf);
    if (lane == 0) {
      *out.n_conf = n_conf;
      *out.next_id = next_id + n_birth;
    }
  }
  PHASE_MARK(7);
  if constexpr (kWide) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // no block leaves while others gather
}

// One launch of the cluster kernel's instance: B clusters of the plan's
// size, its dynamic shared memory allowed; after the stage kernels, it may
// start while they finish.
template <bool kStaged, bool kWide>
int launch_general(const TrackerIn& in, const TrackerOut& out, const TrackerParams& p, const GeneralPlan& g,
                   unsigned* scratch, int B, cudaStream_t st) {
  cudaError_t err = allow_dynamic_smem<tracker_step_general<kStaged, kWide>>(g.smem);
  if (err == cudaSuccess && g.assoc.cluster > 8)
    err = cudaFuncSetAttribute(tracker_step_general<kStaged, kWide>, cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)g.assoc.cluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  err = launch_after(kStaged, tracker_step_general<kStaged, kWide>, dim3((unsigned)B * (unsigned)g.assoc.cluster),
                     dim3(kGeneralThreads), g.smem, st, &cluster, in, out, p, g, scratch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Words of device scratch a lane of the launch at (T, D, L) needs for the
// association's keys, the id ranks, the first round's bests and the chunk
// masks (0: the keys fit in shared memory, or the small instance runs), or
// -1 outside the limits.
extern "C" long long madpp_tracker_scratch(int T, int D, int L) {
  if (T < 1 || T > kGeneralMax || D < 1 || D > kGeneralMax || L < 1) return -1;
  if (T <= kMaxT && D <= kMaxD) return 0;
  const GeneralPlan g = general_plan(T, D, L);
  return g.keys_in_smem ? 0 : (long long)lane_scratch_words(g, T, D);
}

// The blocks a lane of the launch at (T, D, L) takes (its cluster; 1 for
// the small instance), or -1 outside the limits.
extern "C" int madpp_tracker_cluster(int T, int D, int L) {
  if (T < 1 || T > kGeneralMax || D < 1 || D > kGeneralMax || L < 1) return -1;
  return (T <= kMaxT && D <= kMaxD) ? 1 : assoc_plan(T, D).cluster;
}

extern "C" int madpp_tracker_step(
    const void* track_id, const void* bbox, const void* class_id, const void* conf,
    const void* age, const void* hits, const void* misses, const void* traj,
    const void* traj_len, const void* vel, const void* vel_count, const void* next_id,
    const void* det_bbox, const void* det_class, const void* det_conf,
    const void* det_valid, void* out_f, void* out_i, void* scratch, int B, int T, int D, int L,
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
    const GeneralPlan g = general_plan(T, D, L);
    if (!g.keys_in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const TrackerParams p{T, D, L, iou_threshold, max_age, min_hits, 0};
    const cudaStream_t st = (cudaStream_t)stream;
    if (g.keys_in_smem) return launch_general<false, false>(in, out, p, g, nullptr, B, st);
    // The ranks, the keys and the first bests over the card, then the cluster.
    tracker_rank_kernel<<<dim3((unsigned)((T + kRankSlots - 1) / kRankSlots), (unsigned)B), kRankThreads, 0, st>>>(
        (const int*)track_id, T, D, g, (unsigned*)scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = launch_stage(in, p, g, (unsigned*)scratch, B, st);
    if (err != cudaSuccess) return (int)err;
    return T > kGeneralThreads ? launch_general<true, true>(in, out, p, g, (unsigned*)scratch, B, st)
                               : launch_general<true, false>(in, out, p, g, (unsigned*)scratch, B, st);
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

#ifdef MADPP_PHASE_CLOCKS
// The phase clocks of the last general launch (lane 0's blocks, block.cuh
// `PHASE_MARK`): for each of kPhaseBlocks blocks, kPhaseMarks clock64()
// reads (start, then the end of each phase: loads, id rank with the wait for
// the stage kernels, staging, rounds, ring copy, updates, confirmed order).
// Copies them to host memory `out`; returns the CUDA error code.
extern "C" int madpp_tracker_phases(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));
}
#endif
