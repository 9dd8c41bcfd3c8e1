// Kernel K6: the motion planner of one frame (every candidate trajectory,
// its cost, the stable order by cost and the chosen plan's rows), in one
// thread block a lane.
//
// Replaces no TPU kernel: the JAX package's planner
// (planning/planner.py `plan`, ops/quintic.py) is XLA's fusion of tensor
// ops and has no Pallas kernel.  The port ran the same tensor ops, about
// 57 launches a frame, each costing the host 15-25 us of dispatch for a
// few hundred bytes of work, and the frame step waited on that host time
// more than on any other stage.  The plain PyTorch version is
// planning/planner.py `plan_plain` (ops/quintic.py's tensor ops), which
// stays the CPU's path and the reference of this kernel's tests.
//
// Bound on an H100: at the default grid (C = 21 candidates of N = 51
// waypoints, no reference path, no obstacles) the step reads about 0.6 KB
// and writes about 22.6 KB (positions, headings, speeds and curvatures of
// every candidate, the costs, the order and the chosen plan's rows), and
// does about 50 thousand floating-point operations: 7 ns of memory and
// under a nanosecond of arithmetic, far below the launch latency.  It is
// latency-bound: by the round trip to device memory and by each
// candidate's chain of dependent steps (the arc length is a prefix sum,
// and the headings and curvatures are differences of neighbours).  The
// design keeps that chain short:
//  - a warp a candidate (a block of min(C, 32) warps, each looping over
//    its candidates when C is larger), a lane a waypoint: the waypoints go
//    by in chunks of 32, so any N takes the same code;
//  - the arc length as a warp scan (5 shuffles) with the chunk's carry,
//    in the plain version's form (cumsum(v) - v[0]) dt;
//  - the heading of waypoint i - 1 and the curvature of waypoint i - 1 on
//    the lane of waypoint i, its neighbours by one shuffle and, on lane 0,
//    from the previous chunk's lane 31: one pass, no barrier;
//  - each cost term summed on its lanes and reduced by shuffles, then
//    added in the plain version's order (velocity, acceleration, curvature,
//    reference path, obstacles);
//  - the order as a parallel count: candidate i's place is the number of
//    candidates before it by (cost, index), a NaN cost after every number,
//    as `torch.sort(stable=True)` places them; `best` is place 0, and the
//    block copies its positions and speeds to the chosen plan's rows.
// Costs are read back from the output after one barrier, so neither C nor
// N, the reference capacity R nor the obstacle count O meets a limit of
// shared memory.
//
// Precision: float32, as the plain version.  Every elementwise operation
// uses the _rn intrinsics, which the compiler never contracts into a fused
// multiply-add, so each rounds once as the tensor op computing it does;
// cosf, sinf, atan2f and the divisions are the accurate (not the fast-math)
// functions.  The sums (the prefix sum and each cost's sum over waypoints)
// run in another order than the tensor ops' reductions: positions, costs
// and curvatures agree with the plain version to a few ulps of their
// largest terms, not bit for bit.
//
// Lanes: the grid has B blocks, and block b plans lane b from its own
// start state, reference path and obstacles, as its unbatched launch does:
// each lane's result is bit for bit that of its B = 1 launch.  The start
// state is read from a row of `width` floats at four field offsets, so the
// kernel takes K2's (..., 11) vehicle row as well as a (..., 4) state.
//
// Outputs are carved from one float32 and one int32 buffer, each field (B,
// ...) at a multiple of 4 elements (16 bytes), in the order of
// ops/planner_kernel.py `FLOAT_FIELDS` and `INT_FIELDS`.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
// float32(pi / 2): the plain version adds math.pi / 2 to a float32 heading.
constexpr float kHalfPi = 1.57079632679489661923f;

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

// One rounding each, never contracted.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float hyp(float dx, float dy) { return __fsqrt_rn(add(mul(dx, dx), mul(dy, dy))); }

struct PlanIn {
  const float* state;  // (B, width): x, y, heading, speed at fx, fy, fh, fv
  const float* t;  // (N,) the time grid
  const float* alpha;  // (N,) 1 - e^-t
  const float* blend;  // (N,) the quintic lateral blend
  const float* lat;  // (C,) lateral offsets
  const float* tv;  // (C,) target speeds
  const float* ref;  // (B, R, 2) or null
  const bool* ref_valid;  // (B, R) or null: every point valid
  const float* obs;  // (B, O, 3) x, y, radius, or null
  const bool* obs_valid;  // (B, O) or null: every obstacle valid
  int C, N, R, O, width, fx, fy, fh, fv;
};

struct Weights {
  float lateral, velocity, acceleration, curvature, cruise, dt;
};

// The output fields, each (B, ...): positions (C, N, 2), headings,
// velocities and curvatures (C, N), costs (C,), the chosen plan's
// positions (N, 2) and velocities (N,); order (C,) and best () as int32.
struct PlanOut {
  float *pos, *head, *vel, *curv, *cost, *best_pos, *best_vel;
  int *order, *best;
};

PlanOut carve(float* f, int* n, int B, int C, int N) {
  PlanOut o;
  float** fs[] = {&o.pos, &o.head, &o.vel, &o.curv, &o.cost, &o.best_pos, &o.best_vel};
  const size_t sizes[] = {(size_t)C * N * 2, (size_t)C * N, (size_t)C * N, (size_t)C * N, (size_t)C,
                          (size_t)N * 2, (size_t)N};
  for (int k = 0; k < 7; ++k) {
    *fs[k] = f;
    f += round4(sizes[k] * B);
  }
  o.order = n;
  o.best = n + round4((size_t)C * B);
  return o;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = add(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// Whether candidate j's cost a comes before candidate i's b in the
// stable ascending order: numbers by value, NaN after every number, ties
// (and NaNs among themselves) by index.
__device__ __forceinline__ bool before(float a, int j, float b, int i) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return nb;
  if (!na && a != b) return a < b;
  return j < i;
}

__global__ void __launch_bounds__(kMaxWarps * 32) plan_step_kernel(PlanIn in, Weights w, PlanOut lanes_out) {
  __shared__ int s_best;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int C = in.C, N = in.N, R = in.R, O = in.O;
  const size_t b = blockIdx.x, cn = (size_t)C * N;

  // This block's lane: its start state, inputs and output fields.
  const float* row = in.state + b * in.width;
  const float x0 = __ldg(row + in.fx), y0 = __ldg(row + in.fy);
  const float h0 = __ldg(row + in.fh), v0 = __ldg(row + in.fv);
  const float* ref = in.ref ? in.ref + b * R * 2 : nullptr;
  const bool* ref_valid = in.ref_valid ? in.ref_valid + b * R : nullptr;
  const float* obs = in.obs ? in.obs + b * O * 3 : nullptr;
  const bool* obs_valid = in.obs_valid ? in.obs_valid + b * O : nullptr;
  float2* pos = reinterpret_cast<float2*>(lanes_out.pos) + b * cn;
  float* head = lanes_out.head + b * cn;
  float* vel = lanes_out.vel + b * cn;
  float* curv = lanes_out.curv + b * cn;
  float* cost = lanes_out.cost + b * C;
  int* order = lanes_out.order + b * C;

  // Frenet to global: the heading's rotation and its normal's.
  const float c = cosf(h0), sn = sinf(h0);
  const float hn = add(h0, kHalfPi);
  const float cp = cosf(hn), sp = sinf(hn);
  // With no valid reference point the plain version skips the term.
  bool ref_any = ref != nullptr && ref_valid == nullptr && R > 0;
  if (ref_valid != nullptr)
    for (int r = 0; r < R && !ref_any; ++r) ref_any = ref_valid[r];
  const float alpha0 = __ldg(in.alpha);

  for (int k = warp; k < C; k += warps) {
    const float dvel = sub(__ldg(in.tv + k), v0), df = __ldg(in.lat + k);
    const float vel0 = add(v0, mul(dvel, alpha0));
    float2* kpos = pos + (size_t)k * N;
    float* khead = head + (size_t)k * N;
    float* kvel = vel + (size_t)k * N;
    float* kcurv = curv + (size_t)k * N;
    // The prefix sum of the speeds before this chunk, and waypoint
    // base - 1's x, y, speed, time and heading h[base - 2] (lane 31's).
    float carry = 0.0f, xc = 0.0f, yc = 0.0f, vc = 0.0f, tc = 0.0f, hc = 0.0f;
    float s_vel = 0.0f, s_acc = 0.0f, s_curv = 0.0f, s_ref = 0.0f, s_obs = 0.0f;
    // Lane i - base holds waypoint i, and writes heading and curvature
    // i - 1: chunks up to waypoint N, the last heading's copy.
    for (int base = 0; base <= N; base += 32) {
      const int i = base + lane;
      float v = 0.0f, ti = 0.0f, x = 0.0f, y = 0.0f;
      if (i < N) {
        ti = __ldg(in.t + i);
        v = add(v0, mul(dvel, __ldg(in.alpha + i)));
      }
      float cum = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float u = __shfl_up_sync(kFull, cum, d);
        if (lane >= d) cum = add(u, cum);
      }
      cum = add(carry, cum);
      carry = __shfl_sync(kFull, cum, 31);
      if (i < N) {
        const float s = mul(sub(cum, vel0), w.dt);
        const float l = mul(df, __ldg(in.blend + i));
        x = add(add(x0, mul(s, c)), mul(l, cp));
        y = add(add(y0, mul(s, sn)), mul(l, sp));
        kpos[i] = make_float2(x, y);
        kvel[i] = v;
        const float e = sub(v, w.cruise);
        s_vel = add(s_vel, mul(e, e));
        if (ref != nullptr) {
          float m = INFINITY;
          for (int r = 0; r < R; ++r) {
            if (ref_valid != nullptr && !ref_valid[r]) continue;
            const float d = hyp(sub(x, __ldg(ref + 2 * r)), sub(y, __ldg(ref + 2 * r + 1)));
            m = (isnan(m) || d >= m) ? m : d;  // NaN stays, as in amin
          }
          s_ref = add(s_ref, mul(m, m));
        }
        if (obs != nullptr) {
          for (int o = 0; o < O; ++o) {
            if (obs_valid != nullptr && !obs_valid[o]) continue;
            const float rad = __ldg(obs + 3 * o + 2);
            const float dist = hyp(sub(x, __ldg(obs + 3 * o)), sub(y, __ldg(obs + 3 * o + 1)));
            const float r2 = mul(rad, 2.0f), r4 = mul(rad, 4.0f);
            const float hard = dist < r2 ? mul(sub(r2, dist), 1000.0f) : 0.0f;
            // 10 / u as the tensor op computes it: reciprocal(u) * 10.
            const float soft = (dist >= r2 && dist < r4) ? mul(quo(1.0f, add(sub(dist, rad), 0.1f)), 10.0f) : 0.0f;
            s_obs = add(s_obs, add(hard, soft));
          }
        }
      }
      // Waypoint i - 1's position, speed and time.
      float xm = __shfl_up_sync(kFull, x, 1), ym = __shfl_up_sync(kFull, y, 1);
      float vm = __shfl_up_sync(kFull, v, 1), tm = __shfl_up_sync(kFull, ti, 1);
      if (lane == 0) xm = xc, ym = yc, vm = vc, tm = tc;
      // Heading i - 1 (the last repeats the one before), then h[i - 2].
      float h = 0.0f;
      if (i >= 1 && i < N) h = atan2f(sub(y, ym), sub(x, xm));
      float hm = __shfl_up_sync(kFull, h, 1);
      if (lane == 0) hm = hc;
      if (i == N) h = hm;
      if (i >= 1 && i <= N) {
        khead[i - 1] = h;
        // Curvature i - 1: the backward heading difference over v dt +
        // 1e-6, zero at both ends.
        const float kappa = (i >= 2 && i < N) ? quo(sub(h, hm), add(mul(vm, w.dt), 1e-6f)) : 0.0f;
        kcurv[i - 1] = kappa;
        s_curv = add(s_curv, mul(kappa, kappa));
      }
      if (i >= 1 && i < N) {
        // Acceleration i - 1 over a positive time step, else 0.
        const float dts = sub(ti, tm);
        const bool positive = dts > 0.0f;
        const float a = positive ? quo(sub(v, vm), dts) : 0.0f;
        s_acc = add(s_acc, mul(a, a));
      }
      xc = __shfl_sync(kFull, x, 31), yc = __shfl_sync(kFull, y, 31);
      vc = __shfl_sync(kFull, v, 31), tc = __shfl_sync(kFull, ti, 31);
      hc = __shfl_sync(kFull, h, 31);
    }
    s_vel = warp_sum(s_vel), s_acc = warp_sum(s_acc), s_curv = warp_sum(s_curv);
    s_ref = warp_sum(s_ref), s_obs = warp_sum(s_obs);
    if (lane == 0) {
      float total = mul(s_vel, w.velocity);
      total = add(total, mul(s_acc, w.acceleration));
      total = add(total, mul(s_curv, w.curvature));
      if (ref != nullptr) total = add(total, mul(ref_any ? s_ref : 0.0f, w.lateral));
      if (obs != nullptr) total = add(total, s_obs);
      cost[k] = total;
    }
  }
  __syncthreads();

  // The stable order by cost: each candidate's place, counted.
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const float ci = cost[i];
    int place = 0;
    for (int j = 0; j < C; ++j) place += before(cost[j], j, ci, i);
    order[place] = i;
    if (place == 0) s_best = i;
  }
  __syncthreads();
  const int best = s_best;
  if (threadIdx.x == 0) lanes_out.best[b] = best;
  const float2* bpos = pos + (size_t)best * N;
  const float* bvel = vel + (size_t)best * N;
  float2* out_pos = reinterpret_cast<float2*>(lanes_out.best_pos) + b * N;
  float* out_vel = lanes_out.best_vel + b * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    out_pos[i] = bpos[i];
    out_vel[i] = bvel[i];
  }
}

}  // namespace

extern "C" int madpp_plan_step(const void* state, const void* t, const void* alpha, const void* blend,
                               const void* lat, const void* tv, const void* ref, const void* ref_valid,
                               const void* obs, const void* obs_valid, void* out_f, void* out_i, int B, int C,
                               int N, int R, int O, int width, int fx, int fy, int fh, int fv, float w_lateral,
                               float w_velocity, float w_acceleration, float w_curvature, float cruise, float dt,
                               void* stream) {
  if (B < 1 || C < 1 || N < 3 || R < 0 || O < 0 || width < 1) return (int)cudaErrorInvalidValue;
  if (fx < 0 || fx >= width || fy < 0 || fy >= width || fh < 0 || fh >= width || fv < 0 || fv >= width)
    return (int)cudaErrorInvalidValue;
  if ((ref == nullptr && ref_valid != nullptr) || (obs == nullptr && obs_valid != nullptr))
    return (int)cudaErrorInvalidValue;
  PlanIn in{(const float*)state, (const float*)t, (const float*)alpha, (const float*)blend,
            (const float*)lat, (const float*)tv, (const float*)ref, (const bool*)ref_valid,
            (const float*)obs, (const bool*)obs_valid, C, N, R, O, width, fx, fy, fh, fv};
  const Weights w{w_lateral, w_velocity, w_acceleration, w_curvature, cruise, dt};
  const int warps = C < kMaxWarps ? C : kMaxWarps;
  plan_step_kernel<<<B, warps * 32, 0, (cudaStream_t)stream>>>(in, w, carve((float*)out_f, (int*)out_i, B, C, N));
  return (int)cudaGetLastError();
}
