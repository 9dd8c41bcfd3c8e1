// Kernel K3: the whole tagging stage for one frame -- scene classifier with
// its vote ring, maneuver detector over its history ring, per-slot
// interaction detector with its center ring and risk cascade -- in one
// thread block a lane.
//
// Lanes: the grid has B blocks, and block b runs lane b's step as the
// unbatched kernel runs it.  Every per-lane input and output field is
// (B, ...) contiguous, lane b at b times the field's size a lane
// (`lane_in`, `lane_out`); the rules' constants are shared.  The unbatched
// call is B = 1 of the same kernel.
//
// Replaces the Pallas TPU kernel in the JAX package's ops/tagging_pallas.py
// (`_make_kernel`, launched by `make_fused_tagging_step`), in both of its
// modes: `FramesMode` reads the lane-fit and scene-feature rows, detections
// mode bakes in the reference's defaults.  Its plain PyTorch version is
// tagging/rules.py `tagging_step_plain`, and the kernel repeats that version
// rounding step for rounding step: every float operation is an _rn
// intrinsic, which the compiler never contracts, and the multiply-adds that
// the plain version rounds once (as XLA does for the JAX package) are
// rounded the plain version's way, through double.  So every tag equals the
// plain version's bit for bit, the ring statistics included: the kernel
// sums the maneuver window oldest first, as the plain version does, where
// the TPU kernel summed it in slot order.
//
// Bound on an H100: at T=64 the step reads about 17 KB and writes about
// 17 KB, the two copies of the (T, 60) float32 center ring being most of
// it, about 1e-5 ms at 3.35 TB/s; its arithmetic is a few thousand
// operations.  Both are far below the launch latency, so what bounds the
// step is its chain of dependent steps: round trips to device memory and
// barrier-separated phases.  The design keeps that chain to one wave of
// loads and three phases, in one block of 256 threads:
//  A. every input is requested at once: the center ring, the maneuver
//     history and the vote ring go to shared memory by asynchronous
//     16-byte copies (`cp.async`), each slot's fields to its thread's
//     registers, the detection columns to the scene warp's registers;
//  B. warps 0-3 run the per-slot work (distance, TTC, center ring, cut-in
//     drift, cascade), one thread a slot; beside them warp 4 runs the scene
//     classifier, its counts as warp sums and "the last matching detection
//     wins" as the highest matching index, and warp 5 the maneuver
//     detector, summing its window oldest first from shared memory so its
//     floats stay bit-identical, and writes the history ring out;
//  C. warps 0-3 reduce the slots' results, each warp a share of the
//     aggregates: presence by `__any_sync`, the last-wins confidence of
//     each type as the first slot of the highest id (`__reduce_max_sync`
//     then `__reduce_min_sync`), the counts by `__reduce_add_sync`, the
//     minima of distance and TTC as a `__reduce_min_sync` on their bits,
//     and the primary interaction on its key (risk rank desc, confidence
//     asc, id asc, slot asc) one component at a time.  Every key has a total
//     order, so no tag depends on the order of combination.  Warps 4-7
//     write the center ring out from shared memory as 16-byte stores with
//     this frame's centers patched in.
// The state's counters and the timestamp are written here too, so nothing
// goes back to the host.  Rings that do not fit in shared memory are read
// from device memory instead, and rings that are not 16-byte aligned or
// not a multiple of 16 bytes take 4-byte copies for what is left.
//
// Outputs are carved from one float32 and one int32 buffer, each field
// (B, ...) at a multiple of 4 elements (16 bytes), in the order of
// ops/tagging_kernel.py `output_shapes`: floats center ring (T, 2 HI),
// maneuver history (H, 6), tag_f; ints votes (W), ring lengths (T), the
// scene, maneuver and frame counters (each a scalar), tag_i.
//   tag_f: [0, 12) the JAX package's SF row, [12] timestamp,
//          [13, 26) per-type confidence, then per slot: confidence,
//          distance, relative speed, TTC (T each);
//   tag_i: [0, 21) the SI row, [21, 34) per-type presence, then per slot:
//          type, risk, has-TTC (T each).
//
// Two instances, chosen by shape: the one described above for T <= 128,
// and a general one for T up to 4,096 on a thread block cluster a lane
// (below, before the launcher).  Any D, B >= 1.  The wrapper checks the
// limits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block.cuh"

namespace {

constexpr int kMaxT = 128;
constexpr int kThreads = 256;
constexpr int kSceneWarp = 4, kManeuverWarp = 5;
constexpr int kDetRegs = 2;  // chunks of 32 detections the scene warp loads in the first wave
constexpr int kTypes = 13;   // interaction types
constexpr int kSF = 13;      // float scalars, the timestamp included
constexpr int kSI = 21;      // int scalars
constexpr int kI32Max = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;  // +inf as bits
// Dynamic shared memory the kernel may take for the staged rings.
constexpr size_t kMaxDynamicSmem = 200 * 1024;

// The order of PARAM_NAMES in ops/tagging_kernel.py.
struct TagParams {
  float frame_height, inv_frame_height, half_width, quarter_width, three_quarter_width;
  float inv_fps, deg_per_rad;
  float inv_10, inv_20, inv_5, inv_3, inv_90, inv_45, inv_360;
  float lane_change_yaw_deg, turn_yaw_rate_deg, hard_brake, brake, accel, stopped_speed;
  float near_miss_distance, pedestrian_danger_distance, cut_in_distance;
  float following_distance_min, following_distance_max, ttc_warning, ttc_critical;
};
constexpr int kNumParams = 27;
static_assert(sizeof(TagParams) == kNumParams * sizeof(float), "TagParams layout");

struct TagIn {
  const int* dcls;  // (D,)
  const float* dconf;
  const bool* dvalid;
  const float* tbox;  // (T, 4)
  const int* tcls;
  const int* tid;
  const int* thits;
  const float* tvel;  // (T, 2)
  const int* tvelc;
  const float* vrow;  // (11,) VehicleState field order
  const int* votes;   // (W,)
  const int* scene_count;
  const float* mhist;  // (H, 6)
  const int* man_count;
  const float* icent;  // (T, 2 HI)
  const int* ilen;
  const int* iprev;
  const int* frame_count;
  const float* lrow;  // (8,) frames mode: left fit, right fit, found flags
  const float* frow;  // (6,) frames mode: the scene features
};

struct TagOut {
  float *icent, *mhist, *tag_f;
  int *votes, *ilen, *scene_count, *man_count, *frame_count, *tag_i;
};

struct TagDims {
  int T, D, W, H, HI, min_hits;
  int stage;  // the rings go through shared memory
};

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

// The packed rows' widths (ops/tagging_kernel.py FLOAT_TAGS, INT_TAGS).
__host__ __device__ inline int tag_f_width(int T) { return kSF + kTypes + 4 * T; }
__host__ __device__ inline int tag_i_width(int T) { return kSI + kTypes + 3 * T; }

// The output fields in the buffers, each (B, ...) at a multiple of 4
// elements (ops/tagging_kernel.py `output_shapes`).
TagOut carve(float* f, int* i, const TagDims& dm, int B) {
  TagOut o;
  float** fs[] = {&o.icent, &o.mhist, &o.tag_f};
  const size_t fn[] = {(size_t)2 * dm.T * dm.HI, (size_t)6 * dm.H, (size_t)tag_f_width(dm.T)};
  for (int k = 0; k < 3; ++k) {
    *fs[k] = f;
    f += round4(fn[k] * B);
  }
  int** is[] = {&o.votes, &o.ilen, &o.scene_count, &o.man_count, &o.frame_count, &o.tag_i};
  const size_t ni[] = {(size_t)dm.W, (size_t)dm.T, 1, 1, 1, (size_t)tag_i_width(dm.T)};
  for (int k = 0; k < 6; ++k) {
    *is[k] = i;
    i += round4(ni[k] * B);
  }
  return o;
}

// Lane b's inputs and outputs: each per-lane field advanced by b times its
// size a lane.
__device__ __forceinline__ TagIn lane_in(TagIn in, size_t b, const TagDims& dm) {
  const size_t t = b * dm.T, d = b * dm.D;
  in.dcls += d, in.dconf += d, in.dvalid += d;
  in.tbox += 4 * t, in.tcls += t, in.tid += t, in.thits += t, in.tvel += 2 * t, in.tvelc += t;
  in.vrow += 11 * b, in.votes += b * dm.W, in.scene_count += b, in.mhist += 6 * b * dm.H;
  in.man_count += b, in.icent += 2 * t * dm.HI, in.ilen += t, in.iprev += t, in.frame_count += b;
  if (in.lrow) in.lrow += 8 * b, in.frow += 6 * b;
  return in;
}

__device__ __forceinline__ TagOut lane_out(TagOut out, size_t b, const TagDims& dm) {
  const size_t t = b * dm.T;
  out.icent += 2 * t * dm.HI, out.mhist += 6 * b * dm.H, out.tag_f += b * tag_f_width(dm.T);
  out.votes += b * dm.W, out.ilen += t, out.scene_count += b, out.man_count += b, out.frame_count += b;
  out.tag_i += b * tag_i_width(dm.T);
  return out;
}

// VehicleState field order.
enum { kX = 0, kY = 1, kHeading = 4, kSpeed = 5, kAccel = 6, kYaw = 7 };
// Detection class ids (detector.py:39-48).
enum { kCar = 0, kTruck = 1, kPed = 2, kCyc = 3, kMoto = 4, kBus = 5, kTLight = 6, kSSign = 7 };
// Interaction codes (tagging/rules.py INTERACTIONS).
enum { kFollowing = 1, kCutIn = 4, kPedCrossing = 6, kPedWaiting = 7, kCycNearby = 8, kNearMiss = 9 };

// An interaction's confidence, one constant a type (tagging/rules.py's
// rule table); 0 for the types that no rule gives.
__host__ __device__ constexpr float type_conf(int k) {
  return k == kNearMiss ? 0.9f
         : k == kPedCrossing ? 0.8f
         : k == kPedWaiting ? 0.6f
         : k == kCycNearby ? 0.7f
         : k == kFollowing ? 0.75f
         : k == kCutIn ? 0.7f
         : 0.0f;
}

// Risk rank in descending string order (the reference's sort quirk).
__device__ __forceinline__ int risk_rank(int r) {
  return r == 0 ? 2 : r == 1 ? 3 : r == 2 ? 1 : 0;
}

__device__ __forceinline__ int fmod_i(int a, int m) { return ((a % m) + m) % m; }

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// a * b + c as the plain version's `_fma`: the product exact in double, the
// sum rounded to double, then to float.
__device__ __forceinline__ float fma_d(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// Scene score table (tagging/rules.py _SCENE_WEIGHTS): rows are conditions,
// columns road types.
__device__ __constant__ float kSceneW[7][6] = {
    {0.0f, 0.4f, 0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.5f, 0.0f, 0.0f, 0.0f},
    {0.0f, 0.3f, 0.0f, 0.2f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.2f, 0.3f, 0.0f, 0.0f},
    {0.0f, 0.0f, 0.0f, 0.0f, 0.3f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f, 0.3f, 0.0f},
    {0.0f, 0.0f, 0.2f, 0.1f, 0.0f, 0.0f},
};

// The scene warp's detections: lane l holds d = l + 32 c for c < kDetRegs,
// loaded in the first wave.
struct DetRegs {
  bool valid[kDetRegs];
  int cls[kDetRegs];
  float conf[kDetRegs];
};

// Scene classifier and vote ring (rules.py `_scene`) on one warp.  The
// detection counts are warp sums, and "the last matching detection wins"
// takes the highest matching index, which lane (d mod 32) holds.  The rest
// runs on lane 0.  `votes` is the vote ring before this frame, `count` the
// scene counter, `frow` and `lrow` the frames-mode rows.
template <bool FramesMode>
__device__ void scene_classify(const TagIn& in, const TagOut& out, const TagDims& dm,
                               const TagParams& p, float speed, const int* votes, const DetRegs& dr,
                               const float* frow, const float* lrow, int count) {
  const int lane = threadIdx.x & 31;
  int traffic = 0, vehicles = 0, peds = 0, tl_d = -1, ss_d = -1;
  bool any = false;
  float tl_c = 0.0f, ss_c = 0.0f;
  auto take = [&](int d, bool valid, int c, float conf) {
    if (!valid) return;
    any = true;
    traffic += (c == kTLight) + (c == kSSign);
    vehicles += (c == kCar) + (c == kTruck) + (c == kBus);
    peds += (c == kPed);
    if (c == kTLight) {  // a lane's detections ascend, so its last match stays
      tl_d = d;
      tl_c = conf;
    }
    if (c == kSSign) {
      ss_d = d;
      ss_c = conf;
    }
  };
#pragma unroll
  for (int c = 0; c < kDetRegs; ++c) take(32 * c + lane, dr.valid[c], dr.cls[c], dr.conf[c]);
  for (int d = 32 * kDetRegs + lane; d < dm.D; d += 32) take(d, in.dvalid[d], in.dcls[d], in.dconf[d]);
  const bool any_dets = __any_sync(kFull, any);
  traffic = __reduce_add_sync(kFull, traffic);
  vehicles = __reduce_add_sync(kFull, vehicles);
  peds = __reduce_add_sync(kFull, peds);
  const int tl_last = __reduce_max_sync(kFull, tl_d);
  const int ss_last = __reduce_max_sync(kFull, ss_d);
  const float tl_conf = __shfl_sync(kFull, tl_c, tl_last & 31);
  const float ss_conf = __shfl_sync(kFull, ss_c, ss_last & 31);
  if (lane != 0) return;
  const bool has_tl = tl_last >= 0, has_ss = ss_last >= 0;

  float brightness = 128.0f, lap_var = 1000.0f;
  bool dense_center = false, many_long = false, green = false, both_lanes = false;
  if (FramesMode) {
    dense_center = frow[0] > 0.15f;
    many_long = frow[1] > 5.0f && frow[2] > 150.0f;
    green = frow[3] > 0.15f;
    brightness = frow[4];
    lap_var = frow[5];
    both_lanes = lrow[6] > 0.0f && lrow[7] > 0.0f;
  }
  const float conds[7] = {
      dense_center ? 1.0f : 0.0f,
      many_long ? 1.0f : 0.0f,
      (any_dets && traffic > 0) ? 1.0f : 0.0f,
      (any_dets && vehicles > 3) ? 1.0f : 0.0f,
      (any_dets && vehicles <= 1) ? 1.0f : 0.0f,
      green ? 1.0f : 0.0f,
      both_lanes ? 1.0f : 0.0f,
  };
  // Each score sums its column top to bottom; the total sums the whole
  // product row-major (XLA's orders, which the plain version keeps).
  float scores[6], total = 0.0f;
  for (int j = 0; j < 6; ++j) scores[j] = fmul(conds[0], kSceneW[0][j]);
  for (int r = 1; r < 7; ++r)
    for (int j = 0; j < 6; ++j) scores[j] = fadd(scores[j], fmul(conds[r], kSceneW[r][j]));
  for (int r = 0; r < 7; ++r)
    for (int j = 0; j < 6; ++j) total = fadd(total, fmul(conds[r], kSceneW[r][j]));
  total = fadd(total, 0.001f);
  int best = 0;
  float conf = fdiv(scores[0], total);
  for (int j = 1; j < 6; ++j) {
    const float v = fdiv(scores[j], total);
    if (v > conf) {  // the first maximum
      conf = v;
      best = j;
    }
  }
  const bool uncertain = conf < 0.3f;
  const int road_type = uncertain ? 3 : best;
  const float road_conf = uncertain ? 0.3f : conf;

  // Majority vote over the last <= W road types, this one included, with
  // the first appearance in the window breaking ties.
  const int W = dm.W;
  const int widx = fmod_i(count, W);
  const int count1 = count + 1;
  const int n_hist = min(count1, W);
  int counts6[6], first6[6];
  for (int r = 0; r < 6; ++r) {
    counts6[r] = 0;
    first6[r] = W + 1;
  }
  for (int s = 0; s < W; ++s) {
    const int v = s == widx ? road_type : votes[s];
    const int j = fmod_i(s - count1, W);  // window position, oldest first
    if (j >= W - n_hist && v >= 0 && v < 6) {
      counts6[v] += 1;
      first6[v] = min(first6[v], j);
    }
  }
  int max_count = counts6[0];
  for (int r = 1; r < 6; ++r) max_count = max(max_count, counts6[r]);
  int winner = 0, best_key = kI32Max;
  for (int r = 0; r < 6; ++r) {
    const int key = counts6[r] == max_count ? first6[r] : W + 2;
    if (key < best_key) {
      best_key = key;
      winner = r;
    }
  }
  const bool use_vote = n_hist >= 2 && max_count > n_hist / 2;
  const int smoothed = use_vote ? winner : road_type;
  for (int s = 0; s < W; ++s) out.votes[s] = s == widx ? smoothed : votes[s];
  *out.scene_count = count1;

  int lane_count = 2;
  if (FramesMode) {
    const float yb = p.frame_height;
    const float lb = fadd(fadd(fmul(fmul(lrow[0], yb), yb), fmul(lrow[1], yb)), lrow[2]);
    const float rb = fadd(fadd(fmul(fmul(lrow[3], yb), yb), fmul(lrow[4], yb)), lrow[5]);
    const float width = fabsf(fsub(rb, lb));
    lane_count = both_lanes ? (width > 200.0f ? 3 : (width > 100.0f ? 2 : 1)) : 2;
  }
  const bool night = brightness < 60.0f;

  float* sf = out.tag_f;
  int* si = out.tag_i;
  sf[0] = road_conf;
  sf[1] = has_tl ? tl_conf : 0.0f;
  sf[2] = has_ss ? ss_conf : 0.0f;
  sf[3] = brightness > 120.0f ? 0.8f : 0.5f;
  si[0] = smoothed;
  si[1] = road_type;
  si[2] = lane_count;
  si[12] = has_tl && any_dets;
  si[13] = has_ss && any_dets;
  si[14] = any_dets && peds > 0;
  si[15] = night;
  si[16] = !night;
  si[17] = speed < 2.0f;
  si[18] = speed > 15.0f;
  si[19] = lap_var < 100.0f;
}

// Maneuver detector over the history ring (rules.py `_maneuver`), on one
// thread.  `entry` is this frame's (speed, heading, accel, yaw, x, y),
// `mhist` the ring before this frame and `count` its counter.
__device__ void maneuver_detect(const TagOut& out, const TagDims& dm, const TagParams& p,
                                const float* entry, const float* mhist, int count) {
  const int H = dm.H;
  const int widx = fmod_i(count, H);
  const int count1 = count + 1;
  auto at = [&](int slot, int k) { return slot == widx ? entry[k] : mhist[slot * 6 + k]; };
  const float speed = entry[0], accel = entry[2], yaw = entry[3];
  const float deg = p.deg_per_rad;
  const float yaw_deg = fmul(yaw, deg);

  // Lateral: mean and std of the last 10 yaw rates, oldest first.
  float v[10];
  for (int k = 0; k < 10; ++k) v[k] = at(fmod_i(count1 - 10 + k, H), 3);
  float sum = v[0];
  for (int k = 1; k < 10; ++k) sum = fadd(sum, v[k]);
  const float avg = fmul(sum, p.inv_10);
  float c = fsub(v[0], avg);
  float var = fmul(c, c);
  for (int k = 1; k < 10; ++k) {
    c = fsub(v[k], avg);
    var = fma_d(c, c, var);
  }
  const float std_yaw = __fsqrt_rn(fmul(var, p.inv_10));
  const float avg_deg = fmul(avg, deg);
  const bool have10 = count1 >= 10;
  const bool swerve = have10 && std_yaw > 0.1f;
  const bool lc_left = have10 && !swerve && avg_deg > p.lane_change_yaw_deg;
  const bool lc_right = have10 && !swerve && avg_deg < -p.lane_change_yaw_deg;
  const int lateral = swerve ? 3 : (lc_left ? 1 : (lc_right ? 2 : 0));
  const float lat_conf = swerve ? fminf(fmul(std_yaw, 5.0f), 0.9f)
                         : (lc_left || lc_right) ? fminf(fmul(fabsf(avg_deg), p.inv_20), 0.9f)
                                                 : 0.8f;

  // Longitudinal.
  const bool stopped = speed < p.stopped_speed;
  const bool hard_brake = accel < p.hard_brake;
  const bool brake = accel < p.brake;
  const bool accelerating = accel > p.accel;
  const int longitudinal =
      stopped ? 4 : (hard_brake ? 3 : (brake ? 2 : (accelerating ? 1 : 0)));
  const float lon_conf =
      stopped ? 0.95f
      : hard_brake ? fminf(fmul(fabsf(accel), p.inv_5), 0.95f)
      : brake ? fminf(fmul(fabsf(accel), p.inv_3), 0.9f)
      : accelerating ? fminf(fmul(accel, p.inv_3), 0.9f)
                     : 0.8f;

  // Turning: heading change over the last 15 frames, wrapped.
  const bool have15 = count1 >= 15;
  float hc = fmul(fsub(at(fmod_i(count1 - 1, H), 1), at(fmod_i(count1 - 15, H), 1)), deg);
  hc = fma_d(floorf(fmul(fadd(hc, 180.0f), p.inv_360)), -360.0f, hc);
  const float ahc = fabsf(hc);
  const bool u_turn = ahc > 120.0f, t_left = hc > 60.0f, t_right = hc < -60.0f;
  const bool c_left = hc > 15.0f, c_right = hc < -15.0f;
  const bool inst_left = yaw_deg > p.turn_yaw_rate_deg;
  const bool inst_right = yaw_deg < -p.turn_yaw_rate_deg;
  const int turning_hist =
      u_turn ? 3 : (t_left ? 1 : (t_right ? 2 : (c_left ? 4 : (c_right ? 5 : -1))));
  const float conf_hist = u_turn ? 0.8f
                          : (t_left || t_right) ? fminf(fmul(ahc, p.inv_90), 0.9f)
                          : (c_left || c_right) ? fminf(fmul(ahc, p.inv_45), 0.8f)
                                                : 0.0f;
  const int turning_inst = inst_left ? 4 : (inst_right ? 5 : 0);
  const float conf_inst = (inst_left || inst_right) ? 0.6f : 0.8f;
  const bool use_hist = have15 && turning_hist >= 0;
  const int turning = have15 ? (use_hist ? turning_hist : turning_inst) : 0;
  const float turn_conf = have15 ? (use_hist ? conf_hist : conf_inst) : 0.5f;

  *out.man_count = count1;
  float* sf = out.tag_f;
  int* si = out.tag_i;
  sf[4] = lat_conf;
  sf[5] = lon_conf;
  sf[6] = turn_conf;
  sf[7] = fmul(speed, 3.6f);
  sf[8] = accel;
  sf[9] = yaw_deg;
  si[3] = lateral;
  si[4] = longitudinal;
  si[5] = turning;
}

// A slot's fields, loaded by its thread.
struct SlotIn {
  int id, cls, hits, velc, iprev, ilen;
  float b0, b1, b2, b3, vel_y;
};

// The per-slot results that the aggregates read, in shared memory.
struct SlotArrays {
  int *conf, *lwidx, *id, *cls, *itype, *irisk, *httc;
  float *cx, *cy, *iconf, *dist, *ttc;
};

// A slot's results that the aggregates read, in registers.  `lwidx` is the
// ring column pair written this frame, -1 for none.
struct SlotOut {
  bool conf, httc;
  int lwidx, id, cls, itype, irisk;
  float cx, cy, iconf, dist, ttc;
};

// Slot t's distance, TTC, center ring, cut-in drift and cascade: its
// outputs written, its results returned.  `ring` is the slot's center ring
// row before this frame (2 HI floats), staged or in device memory.
__device__ __forceinline__ SlotOut slot_eval(int t, const SlotIn& s, float speed, const float* ring, const TagDims& dm,
                                             const TagParams& p, const TagOut& out) {
  const int T = dm.T, HI = dm.HI;
  const int id = s.id, cls = s.cls, hits = s.hits, velc = s.velc, iprev = s.iprev, ilen = s.ilen;
  const float b0 = s.b0, b1 = s.b1, b2 = s.b2, b3 = s.b3, vel_y = s.vel_y;
  float* tf = out.tag_f;
  int* ti = out.tag_i;
  const bool conf = id > 0 && hits >= dm.min_hits;

  const float box_h = fsub(b3, b1);
  const float base_d = fma_d(fma_d(-b3, p.inv_frame_height, 1.0f), 50.0f, 5.0f);
  const float size_f = fdiv(100.0f, fadd(box_h, 10.0f));
  const float dist =
      box_h <= 0.0f ? 50.0f : fminf(fmaxf(fmul(fadd(base_d, size_f), 0.5f), 2.0f), 100.0f);
  const float rel = velc > 0 ? fsub(speed, vel_y) : 0.0f;
  const bool ttc_ok = rel > 0.1f;
  const float ttc = ttc_ok ? fdiv(dist, rel) : INFINITY;
  const bool has_ttc = ttc_ok && ttc > 0.0f;

  // Center ring: a slot claimed by a new id starts afresh.
  const int lens = iprev == id ? ilen : 0;
  const int lwidx = fmod_i(lens, HI);
  const int hist_len = conf ? lens + 1 : lens;
  const float cx = fmul(fadd(b0, b2), 0.5f);
  const float cy = fmul(fadd(b1, b3), 0.5f);
  const int oldest = hist_len < HI ? 0 : fmod_i(hist_len, HI);
  const int newest = fmod_i(hist_len - 1, HI);
  const float start_x = (conf && oldest == lwidx) ? cx : ring[2 * oldest];
  const float end_x = (conf && newest == lwidx) ? cx : ring[2 * newest];
  const bool cut_drift = fabsf(fsub(end_x, p.half_width)) < fabsf(fsub(start_x, p.half_width));

  const bool near_miss = dist < p.near_miss_distance;
  const bool ped_close = cls == kPed && dist < p.pedestrian_danger_distance;
  const bool ped_center = fabsf(fsub(cx, p.half_width)) < p.quarter_width;
  const bool cyc_near = cls == kCyc && dist < 15.0f;
  const bool is_veh = cls == kCar || cls == kTruck || cls == kBus;
  const bool in_front = cx > p.quarter_width && cx < p.three_quarter_width;
  const bool following = is_veh && in_front && dist > p.following_distance_min &&
                         dist < p.following_distance_max;
  const bool cut_in = is_veh && hist_len >= 10 && cut_drift && dist < p.cut_in_distance;

  // Priority: near miss > pedestrian > cyclist > following > cut-in.
  int itype = -1, irisk = 0;
  float iconf = 0.0f;
  if (conf) {
    if (near_miss) {
      itype = kNearMiss, iconf = type_conf(kNearMiss), irisk = 3;
    } else if (ped_close && ped_center) {
      itype = kPedCrossing, iconf = type_conf(kPedCrossing), irisk = dist < 8.0f ? 2 : 1;
    } else if (ped_close) {
      itype = kPedWaiting, iconf = type_conf(kPedWaiting), irisk = 0;
    } else if (cyc_near) {
      itype = kCycNearby, iconf = type_conf(kCycNearby), irisk = dist < 8.0f ? 1 : 0;
    } else if (following) {
      itype = kFollowing, iconf = type_conf(kFollowing);
      irisk = (has_ttc && ttc < p.ttc_warning) ? 2 : (dist < 10.0f ? 1 : 0);
    } else if (cut_in) {
      itype = kCutIn, iconf = type_conf(kCutIn), irisk = 1;
    }
  }

  out.ilen[t] = hist_len;
  tf[kSF + kTypes + t] = iconf;
  tf[kSF + kTypes + T + t] = dist;
  tf[kSF + kTypes + 2 * T + t] = rel;
  tf[kSF + kTypes + 3 * T + t] = has_ttc ? ttc : 0.0f;
  ti[kSI + kTypes + t] = itype;
  ti[kSI + kTypes + T + t] = irisk;
  ti[kSI + kTypes + 2 * T + t] = has_ttc;
  return SlotOut{conf, has_ttc, conf ? lwidx : -1, id, cls, itype, irisk, cx, cy, iconf, dist, ttc};
}

// `slot_eval` with the center ring before this frame at `icent` (T rows)
// and the results to `sa`.
__device__ __forceinline__ void slot_tags(int t, const SlotIn& s, float speed, const float* icent, const TagDims& dm,
                                          const TagParams& p, const TagOut& out, const SlotArrays& sa) {
  const SlotOut o = slot_eval(t, s, speed, icent + (size_t)t * 2 * dm.HI, dm, p, out);
  sa.conf[t] = o.conf;
  sa.lwidx[t] = o.lwidx;
  sa.cx[t] = o.cx;
  sa.cy[t] = o.cy;
  sa.id[t] = o.id;
  sa.cls[t] = o.cls;
  sa.itype[t] = o.itype;
  sa.irisk[t] = o.irisk;
  sa.httc[t] = o.httc;
  sa.iconf[t] = o.iconf;
  sa.dist[t] = o.dist;
  sa.ttc[t] = o.ttc;
}

template <bool FramesMode>
__global__ void __launch_bounds__(kThreads)
tagging_step_kernel(TagIn lanes_in, TagOut lanes_out, TagDims dm, TagParams p) {
  extern __shared__ __align__(16) float s_dyn[];  // staged: center ring, history ring, votes
  __shared__ int s_conf[kMaxT];
  __shared__ int s_lwidx[kMaxT];  // ring column pair written this frame, -1 for none
  __shared__ float s_cx[kMaxT], s_cy[kMaxT];
  __shared__ int s_id[kMaxT], s_cls[kMaxT], s_itype[kMaxT], s_irisk[kMaxT], s_httc[kMaxT];
  __shared__ float s_iconf[kMaxT], s_dist[kMaxT], s_ttc[kMaxT];

  const TagIn in = lane_in(lanes_in, blockIdx.x, dm);
  const TagOut out = lane_out(lanes_out, blockIdx.x, dm);
  const int T = dm.T, HI = dm.HI, tix = threadIdx.x;
  const int lane = tix & 31, warp = tix >> 5;
  const int n_ring = 2 * T * HI, n_hist = 6 * dm.H;
  float* tf = out.tag_f;
  int* ti = out.tag_i;

  // --- A. one wave of loads ------------------------------------------------
  const float* icent = in.icent;
  const float* mhist = in.mhist;
  const int* votes = in.votes;
  if (dm.stage) {
    float* s_icent = s_dyn;
    float* s_mhist = s_icent + round4(n_ring);
    int* s_votes = reinterpret_cast<int*>(s_mhist + round4(n_hist));
    stage_async(s_icent, in.icent, n_ring);
    stage_async(s_mhist, in.mhist, n_hist);
    stage_async(s_votes, in.votes, dm.W);
    icent = s_icent;
    mhist = s_mhist;
    votes = s_votes;
  }
  const float speed = in.vrow[kSpeed];
  int id = 0, cls = 0, hits = 0, velc = 0, iprev = 0, ilen = 0, count = 0, frames = 0;
  float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, b3 = 0.0f, vel_y = 0.0f;
  DetRegs dr;
  float entry[6], frow[6], lrow[8];
  if (tix < T) {
    const int t = tix;
    id = in.tid[t];
    cls = in.tcls[t];
    b0 = in.tbox[t * 4];
    b1 = in.tbox[t * 4 + 1];
    b2 = in.tbox[t * 4 + 2];
    b3 = in.tbox[t * 4 + 3];
    hits = in.thits[t];
    velc = in.tvelc[t];
    vel_y = in.tvel[t * 2 + 1];
    iprev = in.iprev[t];
    ilen = in.ilen[t];
  } else if (warp == kSceneWarp) {
#pragma unroll
    for (int c = 0; c < kDetRegs; ++c) {
      const int d = 32 * c + lane;
      dr.valid[c] = d < dm.D && in.dvalid[d];
      dr.cls[c] = d < dm.D ? in.dcls[d] : 0;
      dr.conf[c] = d < dm.D ? in.dconf[d] : 0.0f;
    }
    count = *in.scene_count;
    if (FramesMode) {
      for (int k = 0; k < 6; ++k) frow[k] = in.frow[k];
      for (int k = 0; k < 8; ++k) lrow[k] = in.lrow[k];
    }
  } else if (warp == kManeuverWarp) {
    const int fields[6] = {kSpeed, kHeading, kAccel, kYaw, kX, kY};
    for (int k = 0; k < 6; ++k) entry[k] = in.vrow[fields[k]];
    count = *in.man_count;
    frames = *in.frame_count;
  }
  if (dm.stage) cp_async_wait_all();
  __syncthreads();

  // --- B. per slot, beside the scene and the maneuver warps -----------------
  if (tix < T) {
    slot_tags(tix, SlotIn{id, cls, hits, velc, iprev, ilen, b0, b1, b2, b3, vel_y}, speed, icent, dm, p, out,
              SlotArrays{s_conf, s_lwidx, s_id, s_cls, s_itype, s_irisk, s_httc, s_cx, s_cy, s_iconf, s_dist, s_ttc});
  } else if (warp == kSceneWarp) {
    scene_classify<FramesMode>(in, out, dm, p, speed, votes, dr, frow, lrow, count);
  } else if (warp == kManeuverWarp) {
    if (lane == 0) {
      maneuver_detect(out, dm, p, entry, mhist, count);
      *out.frame_count = frames + 1;
      tf[12] = fmul(__int2float_rn(frames), p.inv_fps);  // timestamp
    }
    const int mwidx = fmod_i(count, dm.H);
    for (int i = lane; i < n_hist; i += 32) {
      const int r = i / 6;
      out.mhist[i] = r == mwidx ? entry[i - r * 6] : mhist[i];
    }
  }
  __syncthreads();

  // --- C. aggregates on warps 0-3, the center ring out on warps 4-7 ---------
  // Distances are clamped to [2, 100] (a box with a NaN gives 2) and a TTC
  // counts only when it is positive, so the minima see no NaN and no
  // signed zero: on such floats the order of the bits is that of the values.
  if (warp < 2) {
    // Presence (confidence > 0.5) and last-wins confidence of the types
    // [7 warp, 7 warp + 7): the first slot holding the highest id.  Each
    // lane holds its slots t = lane + 32 j in registers.
    int type[kMaxT / 32], ids[kMaxT / 32];
    float conf[kMaxT / 32];
#pragma unroll
    for (int j = 0; j < kMaxT / 32; ++j) {
      const int t = lane + 32 * j;
      type[j] = t < T ? s_itype[t] : -1;
      ids[j] = t < T ? s_id[t] : 0;
      conf[j] = t < T ? s_iconf[t] : 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < 7; ++kk) {
      const int k = 7 * warp + kk;
      int best_id = -1, best_slot = kI32Max;
      bool present = false;
#pragma unroll
      for (int j = 0; j < kMaxT / 32; ++j) {
        if (type[j] != k) continue;
        present |= conf[j] > 0.5f;
        if (ids[j] > best_id) {
          best_id = ids[j];
          best_slot = lane + 32 * j;
        }
      }
      const int top = __reduce_max_sync(kFull, best_id);
      const int slot = __reduce_min_sync(kFull, best_id == top ? best_slot : kI32Max);
      present = __any_sync(kFull, present);
      if (lane == 0 && k < kTypes) {
        tf[kSF + k] = top >= 0 ? s_iconf[slot] : 0.0f;
        ti[kSI + k] = present;
      }
    }
  } else if (warp == 2) {
    int n_conf = 0, peds = 0, cycs = 0, vehs = 0;
    unsigned dmin = kInfBits, tmin = kInfBits;
#pragma unroll
    for (int j = 0; j < kMaxT / 32; ++j) {
      const int t = lane + 32 * j;
      if (t >= T || !s_conf[t]) continue;
      const int c = s_cls[t];
      n_conf += 1;
      peds += c == kPed;
      cycs += c == kCyc;
      vehs += c == kCar || c == kTruck || c == kBus || c == kMoto;
      dmin = min(dmin, __float_as_uint(s_dist[t]));
      if (s_httc[t]) tmin = min(tmin, __float_as_uint(s_ttc[t]));
    }
    n_conf = __reduce_add_sync(kFull, n_conf);
    peds = __reduce_add_sync(kFull, peds);
    cycs = __reduce_add_sync(kFull, cycs);
    vehs = __reduce_add_sync(kFull, vehs);
    dmin = __reduce_min_sync(kFull, dmin);
    tmin = __reduce_min_sync(kFull, tmin);
    if (lane == 0) {
      tf[10] = dmin < kInfBits ? __uint_as_float(dmin) : 0.0f;
      tf[11] = tmin < kInfBits ? __uint_as_float(tmin) : 0.0f;
      ti[8] = n_conf;
      ti[9] = peds;
      ti[10] = cycs;
      ti[11] = vehs;
      ti[20] = tmin < kInfBits;
    }
  } else if (warp == 3) {
    // Primary interaction: the best (risk rank desc, confidence asc, id
    // asc, slot asc); confidences are positive, so their bits order them.
    int rank = -1, max_risk = 0, best_id = kI32Max, best_slot = kI32Max;
    unsigned conf_bits = ~0u, tmin = kInfBits;
#pragma unroll
    for (int j = 0; j < kMaxT / 32; ++j) {
      const int t = lane + 32 * j;
      if (t >= T) continue;
      if (s_conf[t] && s_httc[t]) tmin = min(tmin, __float_as_uint(s_ttc[t]));
      if (s_itype[t] < 0) continue;
      max_risk = max(max_risk, s_irisk[t]);
      const int r = risk_rank(s_irisk[t]);
      const unsigned c = __float_as_uint(s_iconf[t]);
      const int i = s_id[t];
      if (r > rank || (r == rank && (c < conf_bits || (c == conf_bits && i < best_id)))) {
        rank = r;
        conf_bits = c;
        best_id = i;
        best_slot = t;
      }
    }
    const int top_rank = __reduce_max_sync(kFull, rank);
    const unsigned top_conf = __reduce_min_sync(kFull, rank == top_rank ? conf_bits : ~0u);
    const bool tied = rank == top_rank && conf_bits == top_conf;
    const int top_id = __reduce_min_sync(kFull, tied ? best_id : kI32Max);
    const int slot = __reduce_min_sync(kFull, tied && best_id == top_id ? best_slot : kI32Max);
    max_risk = __reduce_max_sync(kFull, max_risk);
    tmin = __reduce_min_sync(kFull, tmin);
    if (lane == 0) {
      const bool any_int = top_rank >= 0;
      const bool critical = tmin < kInfBits && __uint_as_float(tmin) < p.ttc_critical;
      ti[6] = any_int ? s_itype[slot] : -1;
      ti[7] = any_int ? (critical ? 3 : max_risk) : 0;
    }
  } else {
    // The center ring, each confirmed slot's center at its write index.
    const int ring_w = 2 * HI;
    auto patched = [&](int t, int c, float v) {
      return s_lwidx[t] == (c >> 1) ? ((c & 1) ? s_cy[t] : s_cx[t]) : v;
    };
    const int j = tix - 4 * 32, nj = kThreads - 4 * 32;
    int done = 0;
    if (aligned16(out.icent) && aligned16(icent)) {
      const int n4 = n_ring >> 2;
      for (int i = j; i < n4; i += nj) {
        float4 v = reinterpret_cast<const float4*>(icent)[i];
        float* e = &v.x;
        int t = (4 * i) / ring_w, c = 4 * i - t * ring_w;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          e[k] = patched(t, c, e[k]);
          if (++c == ring_w) {
            c = 0;
            ++t;
          }
        }
        reinterpret_cast<float4*>(out.icent)[i] = v;
      }
      done = n4 << 2;
    }
    for (int i = done + j; i < n_ring; i += nj) {
      const int t = i / ring_w;
      out.icent[i] = patched(t, i - t * ring_w, icent[i]);
    }
  }
}

// --- The general instance: T up to 4,096, a thread block cluster a lane ----
//
//  - Partition.  A cluster of C blocks a lane (`tag_plan`): block r owns
//    the slots [r R, r R + R), R a multiple of 32 and at most kBlockSlots
//    (128) up to 1,024 slots, kWideBlockSlots (256) beyond, one thread a
//    slot, and the same rows of the center ring; C is 2 up to 256 slots, 8
//    at 1,024 and 16 at 4,096 (a non-portable cluster size).  Every block
//    has kSideWarps warps beyond its slots': on block 0 they run the scene
//    classifier, the maneuver detector and the combination of the
//    aggregates, beside the slots.  Blocks of 256 slots (C = 1 up to 256,
//    4 at 1,024) were slower a launch on an H100 at T = 160, 256 and
//    1,024; beyond 1,024 slots they keep the cluster to 16 blocks.
//  - One wave of loads.  At entry each slot's thread requests its fields
//    into registers, each slot warp its 32 rows of the center ring, and on
//    block 0 the scene warp the detections and the vote ring, the maneuver
//    warp the history ring, all by `cp.async` into shared memory.  No
//    barrier of the block: each warp waits for its own copies.  After
//    that, nothing is read from device memory.
//  - The ring by the slots' own warps.  A slot reads its two ring entries
//    and patches its row's two floats at `lwidx` in shared memory, then
//    its warp writes its rows out as 16-byte stores (4-byte ones where the
//    ring is not 16-byte aligned or not a multiple of 16 bytes).
//  - Two-level aggregates.  Each slot warp reduces its 32 slots in
//    registers with `__reduce_*_sync`: the types present, the counts, the
//    distance and TTC minima on their bits, the max risk, and the primary
//    interaction's key (risk rank desc, confidence asc, id asc, slot asc).
//    A type's confidence is one constant (`type_conf`), so its last-wins
//    confidence needs no key: it is that constant wherever some slot has
//    the type.  The warp pushes its record, 3 chunks of 16 bytes, into
//    block 0's shared memory with `st.async`, which counts the bytes on
//    block 0's mbarrier, so no barrier of the cluster follows the slots.  Block 0's combine warp
//    waits on that mbarrier alone, folds records lane, lane + 32, ... (at
//    most 128, four a lane) into one a lane and reduces those across the
//    warp, with the same keys both times.  Every key is a total order, so
//    no tag depends on the order of combination.
// One cluster barrier a launch (arrive relaxed at entry, wait before the
// first push) makes the mbarrier's initialisation visible to the cluster.
// Rings that do not fit in shared memory are read from device memory
// instead, the slots' warps copying their rows device to device before
// patching them.  Same arithmetic (`slot_eval`, `scene_classify`,
// `maneuver_detect`), same outputs.
constexpr int kGeneralMaxT = 4096;
constexpr int kBlockSlots = 128;      // slots a block at most, up to kBlockSlotsUpTo slots
constexpr int kWideBlockSlots = 256;  // beyond: 16 blocks at 4,096
constexpr int kBlockSlotsUpTo = 1024;
constexpr int kSideWarps = 3;  // block 0: the scene, the maneuver, the combination
constexpr int kGeneralThreads = kWideBlockSlots + 32 * kSideWarps;  // the most a block takes
constexpr int kRecordChunks = 3;  // a warp's record
constexpr int kMaxRecords = kGeneralMaxT / 32;
constexpr int kClusterMax = 16;  // above 8 needs cudaFuncAttributeNonPortableClusterSizeAllowed
static_assert((kGeneralMaxT / kWideBlockSlots) <= kClusterMax, "the widest plan fits a cluster");

// C blocks a lane, each owning `rows` slots (the last ones fewer or none):
// the fewest blocks of at most kBlockSlots slots (kWideBlockSlots beyond
// kBlockSlotsUpTo slots), the warps split evenly.  C * rows / 32, the
// records, is at most kMaxRecords.
struct TagPlan {
  int cluster, rows;
};

__host__ __device__ inline TagPlan tag_plan(int T) {
  const int warps = (T + 31) / 32, per = (T > kBlockSlotsUpTo ? kWideBlockSlots : kBlockSlots) / 32;
  const int c = (warps + per - 1) / per;
  return TagPlan{c, 32 * ((warps + c - 1) / c)};
}

// Byte offsets of a block's shared memory: the records (block 0's), the
// mbarrier, then, where staged, the block's ring rows, the history ring,
// the vote ring and the detections' columns.
struct GenLayout {
  size_t rec, mbar, ring, mhist, votes, dcls, dconf, dvalid, total;
};

__host__ __device__ inline GenLayout gen_layout(const TagDims& dm, const TagPlan& g, bool stage) {
  GenLayout l;
  size_t o = 0;
  l.rec = o;
  o += (size_t)16 * kRecordChunks * kMaxRecords;
  l.mbar = o;
  o += 16;
  const size_t k = stage ? 1 : 0;
  l.ring = o;
  o += k * 4 * (size_t)g.rows * 2 * dm.HI;
  l.mhist = o;
  o += k * 4 * round4((size_t)6 * dm.H);
  l.votes = o;
  o += k * 4 * round4(dm.W);
  l.dcls = o;
  o += k * 4 * round4(dm.D);
  l.dconf = o;
  o += k * 4 * round4(dm.D);
  l.dvalid = o;
  o += k * ((dm.D + 15) & ~(size_t)15);
  l.total = o;
  return l;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The cluster barrier, arrive (relaxed: it orders nothing but the
// mbarrier's initialisation, which its own fence releases) and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() { asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;" ::: "memory"); }

// Stores `v` at `addr` in a block of the cluster and counts its 16 bytes on
// that block's mbarrier at `mbar` (both shared::cluster addresses).
__device__ __forceinline__ void st_async_v4(unsigned addr, uint4 v, unsigned mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(mbar)
               : "memory");
}

// `n` floats from `src` to `dst` on a warp: 16-byte copies where both are
// 16-byte aligned, 4-byte ones for the tail or for all of it otherwise.
__device__ __forceinline__ void warp_copy(float* dst, const float* src, int n, int lane) {
  int done = 0;
  if (aligned16(dst) && aligned16(src)) {
    const int n4 = n >> 2;
#pragma unroll 4
    for (int i = lane; i < n4; i += 32) reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    done = n4 << 2;
  }
  for (int i = done + lane; i < n; i += 32) dst[i] = src[i];
}

// A warp's record of its slots (`o` this lane's slot, `w0` the warp's
// first slot; lanes past T hold no slot), reduced in registers: returns the
// 16-byte chunk this lane pushes (lanes 0-2).  Chunk 0: the type bits, the
// confirmed count and pedestrians, cyclists and vehicles (16 bits each; at
// most 32 a warp), the max risk and the primary interaction's type + 1; chunk
// 1: the distance and TTC minima as bits, the primary's key (its
// confidence's bits, 3 - its risk rank); chunk 2: its id and slot.  Keys
// of no slot are all ones.
__device__ __forceinline__ uint4 warp_record(const SlotOut& o, int w0, int lane) {
  const bool typed = o.itype >= 0;
  const unsigned types = __reduce_or_sync(kFull, typed ? 1u << o.itype : 0u);
  const unsigned n_conf = __reduce_add_sync(kFull, o.conf);
  const unsigned peds = __reduce_add_sync(kFull, o.conf && o.cls == kPed);
  const unsigned cycs = __reduce_add_sync(kFull, o.conf && o.cls == kCyc);
  const unsigned vehs = __reduce_add_sync(
      kFull, o.conf && (o.cls == kCar || o.cls == kTruck || o.cls == kBus || o.cls == kMoto));
  const unsigned dmin = __reduce_min_sync(kFull, o.conf ? __float_as_uint(o.dist) : kInfBits);
  const unsigned tmin = __reduce_min_sync(kFull, o.conf && o.httc ? __float_as_uint(o.ttc) : kInfBits);
  const unsigned max_risk = __reduce_max_sync(kFull, typed ? (unsigned)o.irisk : 0u);
  // The primary interaction: confidences are positive, so their bits
  // order them.
  const unsigned rkey = typed ? 3u - (unsigned)risk_rank(o.irisk) : ~0u;
  const unsigned ckey = typed ? __float_as_uint(o.iconf) : ~0u;
  const unsigned r1 = __reduce_min_sync(kFull, rkey);
  const unsigned c1 = __reduce_min_sync(kFull, rkey == r1 ? ckey : ~0u);
  const bool tied = typed && rkey == r1 && ckey == c1;
  const unsigned id1 = __reduce_min_sync(kFull, tied ? (unsigned)o.id : ~0u);
  const unsigned won = __ballot_sync(kFull, tied && (unsigned)o.id == id1);
  const int at = won ? __ffs(won) - 1 : 0;
  const int itype = __shfl_sync(kFull, o.itype, at);
  if (lane == 0)
    return make_uint4(types, n_conf | peds << 16, cycs | vehs << 16, max_risk | (unsigned)(won ? itype + 1 : 0) << 16);
  if (lane == 1) return make_uint4(dmin, tmin, c1, r1);
  return make_uint4(id1, won ? (unsigned)(w0 + at) : ~0u, 0u, 0u);
}

// Block 0's combine warp: the `nrec` records in `rec` (at most
// kMaxRecords), lane l folding records l, l + 32, ... into one with the
// keys of `warp_record`, then the lanes' records reduced with the same
// keys, and the aggregates written.
__device__ __forceinline__ void combine_records(const uint4* rec, int nrec, const TagParams& p, const TagOut& out) {
  const int lane = threadIdx.x & 31;
  // No record: the identity of each reduction.
  uint4 a = make_uint4(0u, 0u, 0u, 0u), b = make_uint4(kInfBits, kInfBits, ~0u, ~0u), c = make_uint4(~0u, ~0u, 0u, 0u);
  for (int k = lane; k < nrec; k += 32) {
    const uint4* r = rec + (size_t)k * kRecordChunks;
    const uint4 ra = r[0], rb = r[1], rc = r[2];
    // Counts are at most 4,096 a record sum, within their 16 bits.
    a = make_uint4(a.x | ra.x, a.y + ra.y, a.z + ra.z, max(a.w & 0xffffu, ra.w & 0xffffu) | (a.w & 0xffff0000u));
    const unsigned prim = a.w >> 16;
    b.x = min(b.x, rb.x);
    b.y = min(b.y, rb.y);
    // The primary's key, lowest first: (3 - risk rank, confidence bits, id, slot).
    const bool lower = rb.w < b.w || (rb.w == b.w && (rb.z < b.z || (rb.z == b.z && (rc.x < c.x ||
                                                     (rc.x == c.x && rc.y < c.y)))));
    if (lower) b.z = rb.z, b.w = rb.w, c.x = rc.x, c.y = rc.y;
    a.w = (a.w & 0xffffu) | ((lower ? ra.w >> 16 : prim) << 16);
  }
  const unsigned types = __reduce_or_sync(kFull, a.x);
  const unsigned n_conf = __reduce_add_sync(kFull, a.y & 0xffffu), peds = __reduce_add_sync(kFull, a.y >> 16);
  const unsigned cycs = __reduce_add_sync(kFull, a.z & 0xffffu), vehs = __reduce_add_sync(kFull, a.z >> 16);
  const unsigned max_risk = __reduce_max_sync(kFull, a.w & 0xffffu);
  const unsigned dmin = __reduce_min_sync(kFull, b.x), tmin = __reduce_min_sync(kFull, b.y);
  const unsigned r1 = __reduce_min_sync(kFull, b.w);
  const unsigned c1 = __reduce_min_sync(kFull, b.w == r1 ? b.z : ~0u);
  const bool tied = b.w == r1 && b.z == c1;
  const unsigned id1 = __reduce_min_sync(kFull, tied ? c.x : ~0u);
  const unsigned s1 = __reduce_min_sync(kFull, tied && c.x == id1 ? c.y : ~0u);
  const unsigned won = __ballot_sync(kFull, tied && c.x == id1 && c.y == s1);
  const int itype = (int)(__shfl_sync(kFull, a.w, won ? __ffs(won) - 1 : 0) >> 16) - 1;
  float* tf = out.tag_f;
  int* ti = out.tag_i;
  if (lane < kTypes) {  // a type's confidence is its constant; present where that is above 0.5
    const bool has = (types >> lane) & 1u;
    tf[kSF + lane] = has ? type_conf(lane) : 0.0f;
    ti[kSI + lane] = has && type_conf(lane) > 0.5f;
  }
  if (lane == 0) {
    const bool any_int = r1 != ~0u;
    const bool critical = tmin < kInfBits && __uint_as_float(tmin) < p.ttc_critical;
    tf[10] = dmin < kInfBits ? __uint_as_float(dmin) : 0.0f;
    tf[11] = tmin < kInfBits ? __uint_as_float(tmin) : 0.0f;
    ti[6] = any_int ? itype : -1;
    ti[7] = any_int ? (critical ? 3 : (int)max_risk) : 0;
    ti[8] = (int)n_conf;
    ti[9] = (int)peds;
    ti[10] = (int)cycs;
    ti[11] = (int)vehs;
    ti[20] = tmin < kInfBits;
  }
}

template <bool FramesMode>
__global__ void __launch_bounds__(kGeneralThreads)
tagging_step_cluster(TagIn lanes_in, TagOut lanes_out, TagDims dm, TagParams p, TagPlan g) {
  extern __shared__ __align__(16) unsigned char s_gen[];
  const unsigned rank = cluster_rank();
  const TagIn in = lane_in(lanes_in, blockIdx.x / (unsigned)g.cluster, dm);
  const TagOut out = lane_out(lanes_out, blockIdx.x / (unsigned)g.cluster, dm);
  const int T = dm.T, ring_w = 2 * dm.HI, tix = threadIdx.x;
  const int lane = tix & 31, warp = tix >> 5, slot_warps = g.rows >> 5;
  const GenLayout L = gen_layout(dm, g, dm.stage);
  uint4* s_rec = reinterpret_cast<uint4*>(s_gen + L.rec);
  unsigned long long* s_mbar = reinterpret_cast<unsigned long long*>(s_gen + L.mbar);
  const float speed = in.vrow[kSpeed];

  if (warp < slot_warps) {
    // --- a slot a thread: its fields and its warp's ring rows requested ---
    const int w0 = (int)rank * g.rows + 32 * warp, t = w0 + lane;
    const int n = min(max(T - w0, 0), 32) * ring_w;  // the warp's ring floats
    float* s_ring = reinterpret_cast<float*>(s_gen + L.ring) + (size_t)32 * warp * ring_w;
    const float* ring_in = in.icent + (size_t)w0 * ring_w;
    if (dm.stage) stage_async_by(s_ring, ring_in, n, lane, 32);
    SlotIn s{};
    if (t < T) {
      s = SlotIn{in.tid[t], in.tcls[t], in.thits[t], in.tvelc[t], in.iprev[t], in.ilen[t],
                 in.tbox[t * 4], in.tbox[t * 4 + 1], in.tbox[t * 4 + 2], in.tbox[t * 4 + 3], in.tvel[t * 2 + 1]};
    }
    cluster_arrive_relaxed();
    if (dm.stage) cp_async_wait_all();
    __syncwarp();
    SlotOut o{false, false, -1, 0, 0, -1, 0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (t < T) {
      o = slot_eval(t, s, speed, dm.stage ? s_ring + (size_t)lane * ring_w : ring_in + (size_t)lane * ring_w, dm, p,
                    out);
      if (dm.stage && o.lwidx >= 0) {
        s_ring[(size_t)lane * ring_w + 2 * o.lwidx] = o.cx;
        s_ring[(size_t)lane * ring_w + 2 * o.lwidx + 1] = o.cy;
      }
    }
    __syncwarp();
    // The warp's ring rows out, this frame's centers patched in.
    float* ring_out = out.icent + (size_t)w0 * ring_w;
    warp_copy(ring_out, dm.stage ? s_ring : ring_in, n, lane);
    if (!dm.stage) {
      __syncwarp();
      if (o.lwidx >= 0) {
        ring_out[(size_t)lane * ring_w + 2 * o.lwidx] = o.cx;
        ring_out[(size_t)lane * ring_w + 2 * o.lwidx + 1] = o.cy;
      }
    }
    const uint4 chunk = warp_record(o, w0, lane);
    cluster_wait();  // block 0's mbarrier is initialised
    if (lane < kRecordChunks) {
      const uint4* dst = s_rec + ((size_t)rank * slot_warps + warp) * kRecordChunks + lane;
      st_async_v4(cluster_addr(dst, 0), chunk, cluster_addr(s_mbar, 0));
    }
    return;
  }
  if (rank != 0) {  // the side warps of blocks 1..C-1 hold no work
    cluster_arrive_relaxed();
    return;
  }
  float* tf = out.tag_f;
  if (warp == slot_warps) {
    // --- the scene classifier and the vote ring ---
    const int count = *in.scene_count;
    float frow[6], lrow[8];
    if (FramesMode) {
      for (int k = 0; k < 6; ++k) frow[k] = in.frow[k];
      for (int k = 0; k < 8; ++k) lrow[k] = in.lrow[k];
    }
    TagIn sin = in;
    DetRegs dr;
    if (dm.stage) {
      int* s_dcls = reinterpret_cast<int*>(s_gen + L.dcls);
      float* s_dconf = reinterpret_cast<float*>(s_gen + L.dconf);
      bool* s_dvalid = reinterpret_cast<bool*>(s_gen + L.dvalid);
      int* s_votes = reinterpret_cast<int*>(s_gen + L.votes);
      stage_async_by(s_dcls, in.dcls, dm.D, lane, 32);
      stage_async_by(s_dconf, in.dconf, dm.D, lane, 32);
      stage_bytes_async_by(s_dvalid, in.dvalid, dm.D, lane, 32);
      stage_async_by(s_votes, in.votes, dm.W, lane, 32);
      sin.dcls = s_dcls, sin.dconf = s_dconf, sin.dvalid = s_dvalid, sin.votes = s_votes;
    }
    cluster_arrive_relaxed();
    if (dm.stage) cp_async_wait_all();
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kDetRegs; ++c) {
      const int d = 32 * c + lane;
      dr.valid[c] = d < dm.D && sin.dvalid[d];
      dr.cls[c] = d < dm.D ? sin.dcls[d] : 0;
      dr.conf[c] = d < dm.D ? sin.dconf[d] : 0.0f;
    }
    scene_classify<FramesMode>(sin, out, dm, p, speed, sin.votes, dr, frow, lrow, count);
  } else if (warp == slot_warps + 1) {
    // --- the maneuver detector and the history ring ---
    const int fields[6] = {kSpeed, kHeading, kAccel, kYaw, kX, kY};
    float entry[6];
    for (int k = 0; k < 6; ++k) entry[k] = in.vrow[fields[k]];
    const int count = *in.man_count, frames = *in.frame_count;
    const float* mhist = in.mhist;
    if (dm.stage) {
      float* s_mhist = reinterpret_cast<float*>(s_gen + L.mhist);
      stage_async_by(s_mhist, in.mhist, 6 * dm.H, lane, 32);
      mhist = s_mhist;
    }
    cluster_arrive_relaxed();
    if (dm.stage) cp_async_wait_all();
    __syncwarp();
    if (lane == 0) {
      maneuver_detect(out, dm, p, entry, mhist, count);
      *out.frame_count = frames + 1;
      tf[12] = fmul(__int2float_rn(frames), p.inv_fps);  // timestamp
    }
    const int mwidx = fmod_i(count, dm.H);
    for (int i = lane; i < 6 * dm.H; i += 32) {
      const int r = i / 6;
      out.mhist[i] = r == mwidx ? entry[i - r * 6] : mhist[i];
    }
  } else {
    // --- the combination: every slot warp's record, then the aggregates ---
    const unsigned mbar = smem_addr(s_mbar);
    const int nrec = g.cluster * slot_warps;
    if (lane == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mbar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar),
                   "r"((unsigned)(16 * kRecordChunks * nrec))
                   : "memory");
    }
    cluster_arrive_relaxed();
    unsigned ok;
    do {
      asm volatile(
          "{ .reg .pred q; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 q, [%1], %2; selp.u32 %0, 1, 0, q; }"
          : "=r"(ok)
          : "r"(mbar), "r"(0u)
          : "memory");
    } while (!ok);
    combine_records(s_rec, nrec, p, out);
  }
}

template <bool FramesMode>
int launch(const TagIn& in, const TagOut& out, const TagDims& dm, const TagParams& p, int B, size_t smem,
           cudaStream_t stream) {
  if (dm.T > kMaxT) {
    const TagPlan g = tag_plan(dm.T);
    TagDims gd = dm;
    gd.stage = gen_layout(dm, g, true).total <= kMaxDynamicSmem ? 1 : 0;
    const size_t gsmem = gen_layout(gd, g, gd.stage).total;
    cudaError_t err = allow_dynamic_smem<tagging_step_cluster<FramesMode>>(gsmem);
    if (err == cudaSuccess && g.cluster > 8)
      err = cudaFuncSetAttribute(tagging_step_cluster<FramesMode>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)g.cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)B * (unsigned)g.cluster);
    cfg.blockDim = dim3((unsigned)(g.rows + 32 * kSideWarps));
    cfg.dynamicSmemBytes = gsmem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, tagging_step_cluster<FramesMode>, in, out, gd, p, g);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const cudaError_t err = allow_dynamic_smem<tagging_step_kernel<FramesMode>>(smem);
  if (err != cudaSuccess) return (int)err;
  tagging_step_kernel<FramesMode><<<B, kThreads, smem, stream>>>(in, out, dm, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int madpp_tagging_step(
    const void* dcls, const void* dconf, const void* dvalid, const void* tbox, const void* tcls,
    const void* tid, const void* thits, const void* tvel, const void* tvelc, const void* vrow,
    const void* votes, const void* scene_count, const void* mhist, const void* man_count,
    const void* icent, const void* ilen, const void* iprev, const void* frame_count,
    const void* lrow, const void* frow, void* out_f, void* out_i, const void* host_params,
    int B, int T, int D, int W, int H, int HI, int min_hits, int frames_mode, void* stream) {
  if (B < 1 || T < 1 || T > kGeneralMaxT || D < 1 || W < 1 || H < 1 || HI < 1) return (int)cudaErrorInvalidValue;
  if (frames_mode && (lrow == nullptr || frow == nullptr)) return (int)cudaErrorInvalidValue;
  TagIn in{(const int*)dcls, (const float*)dconf, (const bool*)dvalid, (const float*)tbox,
           (const int*)tcls, (const int*)tid, (const int*)thits, (const float*)tvel,
           (const int*)tvelc, (const float*)vrow, (const int*)votes, (const int*)scene_count,
           (const float*)mhist, (const int*)man_count, (const float*)icent, (const int*)ilen,
           (const int*)iprev, (const int*)frame_count, (const float*)lrow, (const float*)frow};
  const size_t staged = sizeof(float) * (round4((size_t)2 * T * HI) + round4((size_t)6 * H) + round4(W));
  const TagDims dm{T, D, W, H, HI, min_hits, staged <= kMaxDynamicSmem ? 1 : 0};
  const TagOut out = carve((float*)out_f, (int*)out_i, dm, B);
  TagParams p;
  const float* hp = (const float*)host_params;
  float* pp = reinterpret_cast<float*>(&p);
  for (int i = 0; i < kNumParams; ++i) pp[i] = hp[i];
  const size_t smem = dm.stage ? staged : 0;
  return frames_mode ? launch<true>(in, out, dm, p, B, smem, (cudaStream_t)stream)
                     : launch<false>(in, out, dm, p, B, smem, (cudaStream_t)stream);
}

// The blocks of the thread block cluster a launch at (T, D) takes a lane (1:
// the small instance's single block); -1 outside the kernel's limits.
extern "C" int madpp_tagging_cluster(int T, int D) {
  if (T < 1 || T > kGeneralMaxT || D < 1) return -1;
  return T > kMaxT ? tag_plan(T).cluster : 1;
}
