// Kernel K2: one ego step of the 6-state constant-acceleration Kalman filter
// (predict, Joseph-form update, has-measurement select, both state
// extractions) on one warp.
//
// Replaces the Pallas TPU kernel in the JAX package's ops/kalman_pallas.py
// (`_make_kernel`, launched by `make_fused_estimator_step`).  Its plain
// PyTorch version is estimation/ego.py `_estimator_step_xla`.  Unlike the TPU
// kernel it also derives heading and yaw rate, with atan2, so the step needs
// no further launches.
//
// Bound on an H100: the step moves about 0.8 KB (x, P, F, Q, R in; x, P and
// 11 scalars out) and does about 2,300 floating-point operations: well
// under a nanosecond either way, far below the launch latency.  The step
// is latency-bound: by its round trip to device memory and by its chain of
// dependent operations, which on one thread would be some 124 loads one
// after another and every product, division and square root in series.
// One warp shares it:
//  - one wave of loads: each lane loads one or two entries of each input
//    (all requests in flight together) and stores them to shared memory
//    as doubles;
//  - each 6x6 product one output entry a lane (FP, then P1 = FP F^T + Q,
//    then A P1 and K R, then the Joseph sum), a __syncwarp between
//    dependent products; x1 = F x0 beside FP;
//  - the 4x4 Cholesky factor of S = P1[:4, :4] + R computed on each of 6
//    lanes at once, each solving one row of the gain K = P1[:, :4] S^-1,
//    with reciprocal square roots in place of the divisions;
//  - the predicted extraction (its atan2) on a lane of its own beside
//    P1, the reported one on another lane at the end; the outputs stored
//    by the lanes that hold them.
// The outputs go to one float32 buffer carved as ops/kalman_kernel.py
// carves it: x, P, the vehicle row, and the time, heading and speed that
// the next step reads (unbatched: at 0, 8, 44, 56, 60 and 64).
//
// Lanes: the grid has B blocks of one warp, and block b runs lane b's step
// as the unbatched kernel runs it, so each lane's result is bit for bit
// the one its B = 1 launch gives.  Every per-lane field is (B, ...)
// contiguous, lane b at b times the field's size a lane; F, Q and R are
// shared.  A block a lane, and not four lanes' warps a block, because the
// step's chain of dependent products, not the SMs' issue slots, sets its
// time: at B <= 132 each lane's warp has an SM to itself, and a block of
// 32 threads keeps one `__shared__` struct a warp with no indexing.
//
// Precision: the state is float32 in memory, as in the plain version, but
// the algebra runs in double and rounds once on store.  The reported
// acceleration is a finite difference over dt = 0.033 s that amplifies
// float32 rounding thirtyfold; in double the kernel stays at the float64
// reference's side of the 1e-4 budget, and a float32 run on another device
// differs from it by that run's own rounding only.  Each dot product sums
// in the plain version's order; the reciprocals move the gain by a few
// units in the last place of a double.  The kernel is held to its plain
// version at a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// float32 pi, the value the plain version's comparisons and wraps use.
constexpr double kPi = static_cast<double>(3.14159265358979323846f);

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

struct KalmanIn {
  const float* x;  // (6,)
  const float* P;  // (6, 6)
  const float* time;  // ()
  const float* prev_heading;  // ()
  const float* z;  // (4,)
  const bool* has_meas;  // ()
  const float* F;  // (6, 6)
  const float* Q;  // (6, 6)
  const float* R;  // (4, 4)
};

// The output fields, each (B, ...) at a multiple of 4 elements
// (ops/launch.py `buffer_plan`): x (6,), P (6, 6), the vehicle row (11,),
// and the next step's time, prev_heading and prev_speed ().
struct KalmanOut {
  float *x, *P, *vs, *time, *heading, *speed;
};

KalmanOut carve(float* f, int B) {
  KalmanOut o;
  float** fs[] = {&o.x, &o.P, &o.vs, &o.time, &o.heading, &o.speed};
  const size_t n[] = {6, 36, 11, 1, 1, 1};
  for (int k = 0; k < 6; ++k) {
    *fs[k] = f;
    f += round4(n[k] * B);
  }
  return o;
}

struct Shared {
  double x0[6], P0[36], F[36], Q[36], R[16], z[4];
  double x1[6], FP[36], P1[36], K[24], AP[36], KR[24], x2[6];
  double speed_p, heading_p;
};

// Row `c` of the gain: solve S k = P1[c, :4] by the unrolled SPD Cholesky
// of ops/kalman.py `_solve_spd4`, with the reciprocal of each diagonal
// entry of the factor (`rsqrt`) in place of its divisions: four long
// operations in the chain instead of 4 square roots and 14 divisions.
__device__ __forceinline__ void gain_row(const Shared& s, int c, double* k) {
  double S[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) S[i][j] = s.P1[i * 6 + j] + s.R[i * 4 + j];
  const double i11 = rsqrt(S[0][0]);
  const double l21 = S[1][0] * i11;
  const double l31 = S[2][0] * i11;
  const double l41 = S[3][0] * i11;
  const double i22 = rsqrt(S[1][1] - l21 * l21);
  const double l32 = (S[2][1] - l31 * l21) * i22;
  const double l42 = (S[3][1] - l41 * l21) * i22;
  const double i33 = rsqrt(S[2][2] - l31 * l31 - l32 * l32);
  const double l43 = (S[3][2] - l41 * l31 - l42 * l32) * i33;
  const double i44 = rsqrt(S[3][3] - l41 * l41 - l42 * l42 - l43 * l43);
  const double b1 = s.P1[c * 6 + 0], b2 = s.P1[c * 6 + 1], b3 = s.P1[c * 6 + 2], b4 = s.P1[c * 6 + 3];
  const double y1 = b1 * i11;
  const double y2 = (b2 - l21 * y1) * i22;
  const double y3 = (b3 - l31 * y1 - l32 * y2) * i33;
  const double y4 = (b4 - l41 * y1 - l42 * y2 - l43 * y3) * i44;
  k[3] = y4 * i44;
  k[2] = (y3 - l43 * k[3]) * i33;
  k[1] = (y2 - l32 * k[2] - l42 * k[3]) * i22;
  k[0] = (y1 - l21 * k[1] - l31 * k[2] - l41 * k[3]) * i11;
}

// Entry (i, j) of A = I - K H, H = [I4 | 0].
__device__ __forceinline__ double a_entry(const Shared& s, int i, int j) {
  return (i == j ? 1.0 : 0.0) - (j < 4 ? s.K[i * 4 + j] : 0.0);
}

__global__ void __launch_bounds__(32) kalman_step_kernel(KalmanIn lanes_in, KalmanOut lanes_out, float dt_f,
                                                         float hold_f) {
  __shared__ Shared s;
  const int lane = threadIdx.x;
  // This block's lane of the batch: per-lane fields advanced by its size.
  const size_t b = blockIdx.x;
  KalmanIn in = lanes_in;
  in.x += 6 * b, in.P += 36 * b, in.time += b, in.prev_heading += b, in.z += 4 * b, in.has_meas += b;
  const KalmanOut out = {lanes_out.x + 6 * b, lanes_out.P + 36 * b, lanes_out.vs + 11 * b,
                         lanes_out.time + b, lanes_out.heading + b, lanes_out.speed + b};
  const double dt = dt_f, hold = hold_f;
  // Entries of the 36-entry products: every lane one, lanes 0-3 a second.
  const int e0 = lane, e1 = lane + 32;
  const bool two = e1 < 36;

  // --- one wave of loads ----------------------------------------------------
  const float p0 = __ldg(in.P + e0), f0 = __ldg(in.F + e0), q0 = __ldg(in.Q + e0);
  float p1 = 0.0f, f1 = 0.0f, q1 = 0.0f, r0 = 0.0f, x0 = 0.0f, z0 = 0.0f;
  if (two) p1 = __ldg(in.P + e1), f1 = __ldg(in.F + e1), q1 = __ldg(in.Q + e1);
  if (lane < 16) r0 = __ldg(in.R + lane);
  if (lane < 6) x0 = __ldg(in.x + lane);
  if (lane < 4) z0 = __ldg(in.z + lane);
  const float time0 = __ldg(in.time), prev_heading = __ldg(in.prev_heading);
  const bool has = *in.has_meas;
  s.P0[e0] = p0, s.F[e0] = f0, s.Q[e0] = q0;
  if (two) s.P0[e1] = p1, s.F[e1] = f1, s.Q[e1] = q1;
  if (lane < 16) s.R[lane] = r0;
  if (lane < 6) s.x0[lane] = x0;
  if (lane < 4) s.z[lane] = z0;
  __syncwarp();

  // --- predict: x1 = F x0, FP = F P0, then P1 = FP F^T + Q ------------------
  auto fp = [&](int e) {
    const int i = e / 6, j = e - 6 * (e / 6);
    double a = 0.0;
#pragma unroll
    for (int k = 0; k < 6; ++k) a += s.F[i * 6 + k] * s.P0[k * 6 + j];
    s.FP[e] = a;
  };
  fp(e0);
  if (two) fp(e1);
  if (lane >= 26) {
    const int i = lane - 26;
    double a = 0.0;
#pragma unroll
    for (int k = 0; k < 6; ++k) a += s.F[i * 6 + k] * s.x0[k];
    s.x1[i] = a;
  }
  __syncwarp();
  auto p1_entry = [&](int e) {
    const int i = e / 6, j = e - 6 * (e / 6);
    double a = 0.0;
#pragma unroll
    for (int k = 0; k < 6; ++k) a += s.FP[i * 6 + k] * s.F[j * 6 + k];
    return a + s.Q[e];
  };
  double pa = p1_entry(e0), pb = two ? p1_entry(e1) : 0.0;
  s.P1[e0] = pa;
  if (two) s.P1[e1] = pb;
  if (lane == 31) {
    // The predicted extraction (predict()'s side effect on prev_heading
    // and prev_speed), beside P1.
    const double vx = s.x1[2], vy = s.x1[3];
    const double speed_p = sqrt(vx * vx + vy * vy);
    s.speed_p = speed_p;
    s.heading_p = speed_p > hold ? atan2(vy, vx) : (double)prev_heading;
  }
  __syncwarp();

  if (has) {
    // --- the gain: one row a lane, the factor on each of them ---------------
    if (lane < 6) {
      double k[4];
      gain_row(s, lane, k);
#pragma unroll
      for (int c = 0; c < 4; ++c) s.K[lane * 4 + c] = k[c];
    }
    __syncwarp();
    // --- AP = A P1 and KR = K R ------------------------------------------
    auto ap = [&](int e) {
      const int i = e / 6, j = e - 6 * (e / 6);
      double a = 0.0;
#pragma unroll
      for (int k = 0; k < 6; ++k) a += a_entry(s, i, k) * s.P1[k * 6 + j];
      s.AP[e] = a;
    };
    ap(e0);
    if (two) ap(e1);
    if (lane >= 4 && lane < 28) {
      const int e = lane - 4, i = e >> 2, j = e & 3;
      double a = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) a += s.K[i * 4 + k] * s.R[k * 4 + j];
      s.KR[e] = a;
    }
    __syncwarp();
    // --- P2 = AP A^T + KR K^T, x2 = x1 + K (z - x1[:4]) --------------------
    auto p2_entry = [&](int e) {
      const int i = e / 6, j = e - 6 * (e / 6);
      double a = 0.0, b = 0.0;
#pragma unroll
      for (int k = 0; k < 6; ++k) a += s.AP[i * 6 + k] * a_entry(s, j, k);
#pragma unroll
      for (int k = 0; k < 4; ++k) b += s.KR[i * 4 + k] * s.K[j * 4 + k];
      return a + b;
    };
    pa = p2_entry(e0);
    if (two) pb = p2_entry(e1);
    if (lane >= 26) {
      const int i = lane - 26;
      double a = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) a += s.K[i * 4 + k] * (s.z[k] - s.x1[k]);
      s.x2[i] = s.x1[i] + a;
    }
  } else if (lane < 6) {
    s.x2[lane] = s.x1[lane];
  }

  float* o_x = out.x;
  float* o_P = out.P;
  float* vs = out.vs;
  o_P[e0] = (float)pa;
  if (two) o_P[e1] = (float)pb;
  // The uncertainties' diagonal entries: (0,0), (1,1), (2,2), (3,3).
  const double d00 = __shfl_sync(0xffffffffu, pa, 0), d11 = __shfl_sync(0xffffffffu, pa, 7);
  const double d22 = __shfl_sync(0xffffffffu, pa, 14), d33 = __shfl_sync(0xffffffffu, pa, 21);
  __syncwarp();

  // --- outputs: the state, then the reported extraction --------------------
  // (11,) row in VehicleState field order: x, y, vx, vy, heading, speed,
  // acceleration, yaw_rate, timestamp, pos_uncertainty, vel_uncertainty.
  if (lane < 6) o_x[lane] = (float)s.x2[lane];
  if (lane < 4) vs[lane] = (float)s.x2[lane];
  if (lane == 8) vs[8] = *out.time = time0 + dt_f;
  if (lane == 9) vs[9] = (float)sqrt(d00 + d11);
  if (lane == 10) vs[10] = (float)sqrt(d22 + d33);
  if (lane == 30) {
    const double vx = s.x2[2], vy = s.x2[3];
    const double speed = sqrt(vx * vx + vy * vy);
    const double heading_p = s.heading_p;
    const double heading = speed > hold ? atan2(vy, vx) : heading_p;
    double hdiff = heading - heading_p;
    if (hdiff > kPi) hdiff -= 2.0 * kPi;
    if (hdiff < -kPi) hdiff += 2.0 * kPi;
    vs[4] = *out.heading = (float)heading;
    vs[5] = *out.speed = (float)speed;
    vs[6] = dt > 0.0 ? (float)((speed - s.speed_p) / dt) : 0.0f;
    vs[7] = dt > 0.0 ? (float)(hdiff / dt) : 0.0f;
  }
}

}  // namespace

extern "C" int madpp_kalman_step(const void* x, const void* P, const void* time, const void* prev_heading,
                                 const void* z, const void* has_meas, const void* F, const void* Q,
                                 const void* R, void* out, int B, float dt, float hold, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  KalmanIn in{(const float*)x, (const float*)P, (const float*)time,
              (const float*)prev_heading, (const float*)z, (const bool*)has_meas,
              (const float*)F, (const float*)Q, (const float*)R};
  kalman_step_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(in, carve((float*)out, B), dt, hold);
  return (int)cudaGetLastError();
}
