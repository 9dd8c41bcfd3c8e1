// Kernel K2: one ego step of the 6-state constant-acceleration Kalman filter
// (predict, Joseph-form update, has-measurement select, both state
// extractions) in one thread.
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
// is latency-bound; the design keeps the whole 6x6 algebra in one thread's
// registers, with no shared memory, no synchronisation and one launch.
//
// Precision: the state is float32 in memory, as in the plain version, but
// the algebra runs in double and rounds once on store.  The reported
// acceleration is a finite difference over dt = 0.033 s that amplifies
// float32 rounding thirtyfold; in double the kernel stays at the float64
// reference's side of the 1e-4 budget, and a float32 run on another device
// differs from it by that run's own rounding only.  The kernel is held to
// its plain version at a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// float32 pi, the value the plain version's comparisons and wraps use.
constexpr double kPi = static_cast<double>(3.14159265358979323846f);

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

struct KalmanOut {
  float* x;  // (6,)
  float* P;  // (6, 6)
  // (11,) in VehicleState field order: x, y, vx, vy, heading, speed,
  // acceleration, yaw_rate, timestamp, pos_uncertainty, vel_uncertainty.
  float* vs;
};

__global__ void kalman_step_kernel(KalmanIn in, KalmanOut out, float dt_f, float hold_f) {
  const double dt = dt_f, hold = hold_f;
  double x0[6], P0[6][6], F[6][6], Q[6][6], R[4][4];
  for (int i = 0; i < 6; ++i) {
    x0[i] = in.x[i];
    for (int j = 0; j < 6; ++j) {
      P0[i][j] = in.P[i * 6 + j];
      F[i][j] = in.F[i * 6 + j];
      Q[i][j] = in.Q[i * 6 + j];
    }
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) R[i][j] = in.R[i * 4 + j];

  // predict: x1 = F x0, P1 = (F P0) F^T + Q
  double x1[6], FP[6][6], P1[6][6];
  for (int i = 0; i < 6; ++i) {
    double s = 0.0;
    for (int k = 0; k < 6; ++k) s += F[i][k] * x0[k];
    x1[i] = s;
    for (int j = 0; j < 6; ++j) {
      double a = 0.0;
      for (int k = 0; k < 6; ++k) a += F[i][k] * P0[k][j];
      FP[i][j] = a;
    }
  }
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      double a = 0.0;
      for (int k = 0; k < 6; ++k) a += FP[i][k] * F[j][k];
      P1[i][j] = a + Q[i][j];
    }
  const float time1 = *in.time + dt_f;

  // first extraction (predict()'s side effect on prev_heading / prev_speed)
  const double speed_p = sqrt(x1[2] * x1[2] + x1[3] * x1[3]);
  const double heading_p = speed_p > hold ? atan2(x1[3], x1[2]) : (double)*in.prev_heading;

  double x2[6], P2[6][6];
  if (*in.has_meas) {
    // Joseph-form update with H = [I4 | 0]: S = P1[:4,:4] + R, PHT = P1[:, :4]
    double S[4][4];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) S[i][j] = P1[i][j] + R[i][j];
    // unrolled SPD Cholesky (ops/kalman.py `_solve_spd4`), K = PHT S^-1
    const double l11 = sqrt(S[0][0]);
    const double l21 = S[1][0] / l11;
    const double l31 = S[2][0] / l11;
    const double l41 = S[3][0] / l11;
    const double l22 = sqrt(S[1][1] - l21 * l21);
    const double l32 = (S[2][1] - l31 * l21) / l22;
    const double l42 = (S[3][1] - l41 * l21) / l22;
    const double l33 = sqrt(S[2][2] - l31 * l31 - l32 * l32);
    const double l43 = (S[3][2] - l41 * l31 - l42 * l32) / l33;
    const double l44 = sqrt(S[3][3] - l41 * l41 - l42 * l42 - l43 * l43);
    double K[6][4];
    for (int c = 0; c < 6; ++c) {  // solve S k = PHT^T[:, c] for row c of K
      const double b1 = P1[c][0], b2 = P1[c][1], b3 = P1[c][2], b4 = P1[c][3];
      const double y1 = b1 / l11;
      const double y2 = (b2 - l21 * y1) / l22;
      const double y3 = (b3 - l31 * y1 - l32 * y2) / l33;
      const double y4 = (b4 - l41 * y1 - l42 * y2 - l43 * y3) / l44;
      const double k4 = y4 / l44;
      const double k3 = (y3 - l43 * k4) / l33;
      const double k2 = (y2 - l32 * k3 - l42 * k4) / l22;
      const double k1 = (y1 - l21 * k2 - l31 * k3 - l41 * k4) / l11;
      K[c][0] = k1;
      K[c][1] = k2;
      K[c][2] = k3;
      K[c][3] = k4;
    }
    double y[4];
    for (int i = 0; i < 4; ++i) y[i] = (double)in.z[i] - x1[i];
    for (int i = 0; i < 6; ++i) {
      double s = 0.0;
      for (int k = 0; k < 4; ++k) s += K[i][k] * y[k];
      x2[i] = x1[i] + s;
    }
    // P2 = (I - K H) P1 (I - K H)^T + K R K^T
    double A[6][6], AP[6][6], KR[6][4];
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) A[i][j] = (i == j ? 1.0 : 0.0) - (j < 4 ? K[i][j] : 0.0);
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) {
        double a = 0.0;
        for (int k = 0; k < 6; ++k) a += A[i][k] * P1[k][j];
        AP[i][j] = a;
      }
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 4; ++j) {
        double a = 0.0;
        for (int k = 0; k < 4; ++k) a += K[i][k] * R[k][j];
        KR[i][j] = a;
      }
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) {
        double a = 0.0, b = 0.0;
        for (int k = 0; k < 6; ++k) a += AP[i][k] * A[j][k];
        for (int k = 0; k < 4; ++k) b += KR[i][k] * K[j][k];
        P2[i][j] = a + b;
      }
  } else {
    for (int i = 0; i < 6; ++i) {
      x2[i] = x1[i];
      for (int j = 0; j < 6; ++j) P2[i][j] = P1[i][j];
    }
  }

  for (int i = 0; i < 6; ++i) {
    out.x[i] = (float)x2[i];
    for (int j = 0; j < 6; ++j) out.P[i * 6 + j] = (float)P2[i][j];
  }

  // reported extraction, against the post-predict heading / speed
  const double speed = sqrt(x2[2] * x2[2] + x2[3] * x2[3]);
  const double heading = speed > hold ? atan2(x2[3], x2[2]) : heading_p;
  double hdiff = heading - heading_p;
  if (hdiff > kPi) hdiff -= 2.0 * kPi;
  if (hdiff < -kPi) hdiff += 2.0 * kPi;

  out.vs[0] = (float)x2[0];
  out.vs[1] = (float)x2[1];
  out.vs[2] = (float)x2[2];
  out.vs[3] = (float)x2[3];
  out.vs[4] = (float)heading;
  out.vs[5] = (float)speed;
  out.vs[6] = dt > 0.0 ? (float)((speed - speed_p) / dt) : 0.0f;
  out.vs[7] = dt > 0.0 ? (float)(hdiff / dt) : 0.0f;
  out.vs[8] = time1;
  out.vs[9] = (float)sqrt(P2[0][0] + P2[1][1]);
  out.vs[10] = (float)sqrt(P2[2][2] + P2[3][3]);
}

}  // namespace

extern "C" int madpp_kalman_step(const void* x, const void* P, const void* time,
                                 const void* prev_heading, const void* z,
                                 const void* has_meas, const void* F, const void* Q,
                                 const void* R, void* o_x, void* o_P, void* o_vs,
                                 float dt, float hold, void* stream) {
  KalmanIn in{(const float*)x, (const float*)P, (const float*)time,
              (const float*)prev_heading, (const float*)z, (const bool*)has_meas,
              (const float*)F, (const float*)Q, (const float*)R};
  KalmanOut out{(float*)o_x, (float*)o_P, (float*)o_vs};
  kalman_step_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(in, out, dt, hold);
  return (int)cudaGetLastError();
}
