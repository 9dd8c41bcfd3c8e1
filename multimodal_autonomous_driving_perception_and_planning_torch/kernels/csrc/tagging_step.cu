// Kernel K3: the whole tagging stage for one frame -- scene classifier with
// its vote ring, maneuver detector over its history ring, per-slot
// interaction detector with its center ring and risk cascade -- in one
// thread block.
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
// operations.  Both are far below the launch latency, so the step is
// latency-bound.  The design answers with one launch: one thread per track
// slot for the interaction work, the ring copies spread over the block, and
// the aggregates on a few threads that read the slots' results from shared
// memory -- thread k < 13 the presence and last-wins confidence of
// interaction type k, thread 32 the counts, minima, primary interaction and
// overall risk, thread 64 the scene classifier and the maneuver detector.
// The state's counters and the timestamp are written here too, so nothing
// goes back to the host.
//
// Output layout (ops/tagging_kernel.py FLOAT_TAGS, INT_TAGS):
//   tag_f: [0, 12) the JAX package's SF row, [12] timestamp,
//          [13, 26) per-type confidence, then per slot: confidence,
//          distance, relative speed, TTC (T each);
//   tag_i: [0, 21) the SI row, [21, 34) per-type presence, then per slot:
//          type, risk, has-TTC (T each).
//
// Limits: T <= 128 (the wrapper checks it).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 128;
constexpr int kThreads = 128;
constexpr int kTypes = 13;  // interaction types
constexpr int kSF = 13;     // float scalars, the timestamp included
constexpr int kSI = 21;     // int scalars
constexpr int kI32Max = 2147483647;

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
  int* votes;
  float* mhist;
  float* icent;
  int* ilen;
  int* counts;  // scene_count, man_count, frame_count
  float* tag_f;
  int* tag_i;
};

struct TagDims {
  int T, D, W, H, HI, min_hits;
};

// VehicleState field order.
enum { kX = 0, kY = 1, kHeading = 4, kSpeed = 5, kAccel = 6, kYaw = 7 };
// Detection class ids (detector.py:39-48).
enum { kCar = 0, kTruck = 1, kPed = 2, kCyc = 3, kMoto = 4, kBus = 5, kTLight = 6, kSSign = 7 };
// Interaction codes (tagging/rules.py INTERACTIONS).
enum { kFollowing = 1, kCutIn = 4, kPedCrossing = 6, kPedWaiting = 7, kCycNearby = 8, kNearMiss = 9 };

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

// Scene classifier and vote ring (rules.py `_scene`), on one thread.
template <bool FramesMode>
__device__ void scene_classify(const TagIn& in, const TagOut& out, const TagDims& dm,
                               const TagParams& p, float speed) {
  bool any_dets = false, has_tl = false, has_ss = false;
  int traffic = 0, vehicles = 0, peds = 0;
  float tl_conf = 0.0f, ss_conf = 0.0f;
  for (int d = 0; d < dm.D; ++d) {
    if (!in.dvalid[d]) continue;
    any_dets = true;
    const int c = in.dcls[d];
    traffic += (c == kTLight) + (c == kSSign);
    vehicles += (c == kCar) + (c == kTruck) + (c == kBus);
    peds += (c == kPed);
    if (c == kTLight) {  // the last matching detection wins
      has_tl = true;
      tl_conf = in.dconf[d];
    }
    if (c == kSSign) {
      has_ss = true;
      ss_conf = in.dconf[d];
    }
  }

  float brightness = 128.0f, lap_var = 1000.0f;
  bool dense_center = false, many_long = false, green = false, both_lanes = false;
  if (FramesMode) {
    dense_center = in.frow[0] > 0.15f;
    many_long = in.frow[1] > 5.0f && in.frow[2] > 150.0f;
    green = in.frow[3] > 0.15f;
    brightness = in.frow[4];
    lap_var = in.frow[5];
    both_lanes = in.lrow[6] > 0.0f && in.lrow[7] > 0.0f;
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
  const int count = *in.scene_count;
  const int widx = fmod_i(count, W);
  const int count1 = count + 1;
  const int n_hist = min(count1, W);
  int counts6[6], first6[6];
  for (int r = 0; r < 6; ++r) {
    counts6[r] = 0;
    first6[r] = W + 1;
  }
  for (int s = 0; s < W; ++s) {
    const int v = s == widx ? road_type : in.votes[s];
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
  for (int s = 0; s < W; ++s) out.votes[s] = s == widx ? smoothed : in.votes[s];
  out.counts[0] = count1;

  int lane_count = 2;
  if (FramesMode) {
    const float yb = p.frame_height;
    const float lb = fadd(fadd(fmul(fmul(in.lrow[0], yb), yb), fmul(in.lrow[1], yb)), in.lrow[2]);
    const float rb = fadd(fadd(fmul(fmul(in.lrow[3], yb), yb), fmul(in.lrow[4], yb)), in.lrow[5]);
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
// thread.  `entry` is this frame's (speed, heading, accel, yaw, x, y).
__device__ void maneuver_detect(const TagIn& in, const TagOut& out, const TagDims& dm,
                                const TagParams& p, const float* entry) {
  const int H = dm.H;
  const int count = *in.man_count;
  const int widx = fmod_i(count, H);
  const int count1 = count + 1;
  auto at = [&](int slot, int k) { return slot == widx ? entry[k] : in.mhist[slot * 6 + k]; };
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

  out.counts[1] = count1;
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

template <bool FramesMode>
__global__ void __launch_bounds__(kThreads)
tagging_step_kernel(TagIn in, TagOut out, TagDims dm, TagParams p) {
  __shared__ int s_conf[kMaxT];
  __shared__ int s_lwidx[kMaxT];  // ring column pair written this frame, -1 for none
  __shared__ float s_cx[kMaxT], s_cy[kMaxT];
  __shared__ int s_id[kMaxT], s_cls[kMaxT], s_itype[kMaxT], s_irisk[kMaxT], s_httc[kMaxT];
  __shared__ float s_iconf[kMaxT], s_dist[kMaxT], s_ttc[kMaxT];

  const int T = dm.T, HI = dm.HI, tix = threadIdx.x;
  const float speed = in.vrow[kSpeed];
  float* tf = out.tag_f;
  int* ti = out.tag_i;

  // --- per slot: distance, TTC, center ring, cut-in drift, cascade --------
  for (int t = tix; t < T; t += blockDim.x) {
    const int id = in.tid[t], cls = in.tcls[t];
    const float b0 = in.tbox[t * 4], b1 = in.tbox[t * 4 + 1];
    const float b2 = in.tbox[t * 4 + 2], b3 = in.tbox[t * 4 + 3];
    const bool conf = id > 0 && in.thits[t] >= dm.min_hits;

    const float box_h = fsub(b3, b1);
    const float base_d = fma_d(fma_d(-b3, p.inv_frame_height, 1.0f), 50.0f, 5.0f);
    const float size_f = fdiv(100.0f, fadd(box_h, 10.0f));
    const float dist =
        box_h <= 0.0f ? 50.0f : fminf(fmaxf(fmul(fadd(base_d, size_f), 0.5f), 2.0f), 100.0f);
    const float rel = in.tvelc[t] > 0 ? fsub(speed, in.tvel[t * 2 + 1]) : 0.0f;
    const bool ttc_ok = rel > 0.1f;
    const float ttc = ttc_ok ? fdiv(dist, rel) : INFINITY;
    const bool has_ttc = ttc_ok && ttc > 0.0f;

    // Center ring: a slot claimed by a new id starts afresh.
    const int lens = in.iprev[t] == id ? in.ilen[t] : 0;
    const int lwidx = fmod_i(lens, HI);
    const int hist_len = conf ? lens + 1 : lens;
    const float cx = fmul(fadd(b0, b2), 0.5f);
    const float cy = fmul(fadd(b1, b3), 0.5f);
    const int oldest = hist_len < HI ? 0 : fmod_i(hist_len, HI);
    const int newest = fmod_i(hist_len - 1, HI);
    const float* ring = in.icent + (size_t)t * 2 * HI;
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
        itype = kNearMiss, iconf = 0.9f, irisk = 3;
      } else if (ped_close && ped_center) {
        itype = kPedCrossing, iconf = 0.8f, irisk = dist < 8.0f ? 2 : 1;
      } else if (ped_close) {
        itype = kPedWaiting, iconf = 0.6f, irisk = 0;
      } else if (cyc_near) {
        itype = kCycNearby, iconf = 0.7f, irisk = dist < 8.0f ? 1 : 0;
      } else if (following) {
        itype = kFollowing, iconf = 0.75f;
        irisk = (has_ttc && ttc < p.ttc_warning) ? 2 : (dist < 10.0f ? 1 : 0);
      } else if (cut_in) {
        itype = kCutIn, iconf = 0.7f, irisk = 1;
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
    s_conf[t] = conf;
    s_lwidx[t] = conf ? lwidx : -1;
    s_cx[t] = cx;
    s_cy[t] = cy;
    s_id[t] = id;
    s_cls[t] = cls;
    s_itype[t] = itype;
    s_irisk[t] = irisk;
    s_httc[t] = has_ttc;
    s_iconf[t] = iconf;
    s_dist[t] = dist;
    s_ttc[t] = ttc;
  }
  __syncthreads();

  // --- the rings, copied by the whole block with this frame's entries -----
  const int ring_w = 2 * HI;
  for (int i = tix; i < T * ring_w; i += blockDim.x) {
    const int t = i / ring_w, c = i - t * ring_w;
    out.icent[i] = s_lwidx[t] == (c >> 1) ? ((c & 1) ? s_cy[t] : s_cx[t]) : in.icent[i];
  }
  const float entry[6] = {speed, in.vrow[kHeading], in.vrow[kAccel],
                          in.vrow[kYaw], in.vrow[kX], in.vrow[kY]};
  const int mwidx = fmod_i(*in.man_count, dm.H);
  for (int i = tix; i < dm.H * 6; i += blockDim.x) {
    const int r = i / 6;
    out.mhist[i] = r == mwidx ? entry[i - r * 6] : in.mhist[i];
  }

  // --- aggregates, each on its own thread ----------------------------------
  if (tix < kTypes) {
    // Presence (confidence > 0.5) and last-wins confidence of type `tix`:
    // the first slot holding the highest id of that type.
    bool any = false, present = false;
    int best_id = -1, best_slot = 0;
    for (int t = 0; t < T; ++t) {
      if (s_itype[t] != tix) continue;
      any = true;
      present |= s_iconf[t] > 0.5f;
      if (s_id[t] > best_id) {
        best_id = s_id[t];
        best_slot = t;
      }
    }
    tf[kSF + tix] = any ? s_iconf[best_slot] : 0.0f;
    ti[kSI + tix] = present;
  } else if (tix == 32) {
    int n_conf = 0, peds = 0, cycs = 0, vehs = 0, max_risk = 0;
    float min_dist = INFINITY, min_ttc = INFINITY;
    bool any_int = false;
    // Primary interaction: the best (risk rank desc, confidence asc, id
    // asc), the first slot on a full tie.
    int best_rank = -1, best_id = kI32Max, best_slot = 0;
    float best_conf = INFINITY;
    for (int t = 0; t < T; ++t) {
      if (s_conf[t]) {
        const int c = s_cls[t];
        n_conf += 1;
        peds += c == kPed;
        cycs += c == kCyc;
        vehs += c == kCar || c == kTruck || c == kBus || c == kMoto;
        min_dist = fminf(min_dist, s_dist[t]);
        if (s_httc[t]) min_ttc = fminf(min_ttc, s_ttc[t]);
      }
      if (s_itype[t] >= 0) {
        any_int = true;
        max_risk = max(max_risk, s_irisk[t]);
        const int r = risk_rank(s_irisk[t]);
        const float c = s_iconf[t];
        const int id = s_id[t];
        if (r > best_rank || (r == best_rank && (c < best_conf || (c == best_conf && id < best_id)))) {
          best_rank = r;
          best_conf = c;
          best_id = id;
          best_slot = t;
        }
      }
    }
    const bool has_min_ttc = min_ttc < INFINITY;
    const bool critical = has_min_ttc && min_ttc < p.ttc_critical;
    tf[10] = min_dist < INFINITY ? min_dist : 0.0f;
    tf[11] = has_min_ttc ? min_ttc : 0.0f;
    ti[6] = any_int ? s_itype[best_slot] : -1;
    ti[7] = any_int ? (critical ? 3 : max_risk) : 0;
    ti[8] = n_conf;
    ti[9] = peds;
    ti[10] = cycs;
    ti[11] = vehs;
    ti[20] = has_min_ttc;
  } else if (tix == 64) {
    scene_classify<FramesMode>(in, out, dm, p, speed);
    maneuver_detect(in, out, dm, p, entry);
    const int frames = *in.frame_count;
    out.counts[2] = frames + 1;
    tf[12] = fmul(__int2float_rn(frames), p.inv_fps);  // timestamp
  }
}

}  // namespace

extern "C" int madpp_tagging_step(
    const void* dcls, const void* dconf, const void* dvalid, const void* tbox, const void* tcls, const void* tid, const void* thits,
    const void* tvel, const void* tvelc, const void* vrow, const void* votes,
    const void* scene_count, const void* mhist, const void* man_count, const void* icent,
    const void* ilen, const void* iprev, const void* frame_count, const void* lrow,
    const void* frow, void* o_votes, void* o_mhist, void* o_icent, void* o_ilen,
    void* o_counts, void* o_tag_f, void* o_tag_i, const void* host_params, int T, int D,
    int W, int H, int HI, int min_hits, int frames_mode, void* stream) {
  if (T < 1 || T > kMaxT || D < 1 || W < 1 || H < 1 || HI < 1) return (int)cudaErrorInvalidValue;
  if (frames_mode && (lrow == nullptr || frow == nullptr)) return (int)cudaErrorInvalidValue;
  TagIn in{(const int*)dcls, (const float*)dconf, (const bool*)dvalid, (const float*)tbox, (const int*)tcls, (const int*)tid, (const int*)thits,
           (const float*)tvel, (const int*)tvelc, (const float*)vrow, (const int*)votes,
           (const int*)scene_count, (const float*)mhist, (const int*)man_count,
           (const float*)icent, (const int*)ilen, (const int*)iprev,
           (const int*)frame_count, (const float*)lrow, (const float*)frow};
  TagOut out{(int*)o_votes, (float*)o_mhist, (float*)o_icent, (int*)o_ilen,
             (int*)o_counts, (float*)o_tag_f, (int*)o_tag_i};
  TagDims dm{T, D, W, H, HI, min_hits};
  TagParams p;
  const float* hp = (const float*)host_params;
  float* pp = reinterpret_cast<float*>(&p);
  for (int i = 0; i < kNumParams; ++i) pp[i] = hp[i];
  if (frames_mode)
    tagging_step_kernel<true><<<1, kThreads, 0, (cudaStream_t)stream>>>(in, out, dm, p);
  else
    tagging_step_kernel<false><<<1, kThreads, 0, (cudaStream_t)stream>>>(in, out, dm, p);
  return (int)cudaGetLastError();
}
