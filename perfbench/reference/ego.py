"""Plain ego estimator: a 6-state constant-acceleration Kalman filter over
[x, y, vx, vy, ax, ay] with [x, y, vx, vy] measured, a Joseph-form update,
and the derived state of each frame.

A frame predicts, advances the clock, derives speed and heading once (only
to update the previous speed and heading), updates with the measurement,
and derives the reported state: speed, heading (held below 0.1 m/s),
acceleration and yaw rate as finite differences against the post-predict
values, and the position and velocity uncertainties.  The filter's state
is a dict: ``x`` (6,), ``P`` (6, 6), ``time``, ``prev_heading``,
``prev_speed``; computed in ``dtype`` (float64 for the reference).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

ROW_FIELDS = ("x", "y", "vx", "vy", "heading", "speed", "acceleration", "yaw_rate", "timestamp",
              "pos_uncertainty", "vel_uncertainty")


def model(est: Dict, dtype, device):
    """F, H, Q, R as the configuration states them, in float32, then in
    ``dtype``."""
    dt = est["dt"]
    h = 0.5 * dt * dt
    F = np.array([[1, 0, dt, 0, h, 0], [0, 1, 0, dt, 0, h], [0, 0, 1, 0, dt, 0],
                  [0, 0, 0, 1, 0, dt], [0, 0, 0, 0, 1, 0], [0, 0, 0, 0, 0, 1]], np.float32)
    H = np.zeros((4, 6), np.float32)
    H[np.arange(4), np.arange(4)] = 1
    q = np.full((6,), est["process_noise"], np.float32)
    q[4:] *= est["accel_noise_scale"]
    R = (np.eye(4) * est["measurement_noise"]).astype(np.float32)
    return tuple(torch.from_numpy(m).to(device=device, dtype=dtype) for m in (F, H, np.diag(q), R))


def _solve_spd4(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """S X = B for a symmetric positive definite 4x4 S by its Cholesky
    factor and two triangular solves."""
    l11 = torch.sqrt(S[0, 0])
    l21, l31, l41 = S[1, 0] / l11, S[2, 0] / l11, S[3, 0] / l11
    l22 = torch.sqrt(S[1, 1] - l21 * l21)
    l32 = (S[2, 1] - l31 * l21) / l22
    l42 = (S[3, 1] - l41 * l21) / l22
    l33 = torch.sqrt(S[2, 2] - l31 * l31 - l32 * l32)
    l43 = (S[3, 2] - l41 * l31 - l42 * l32) / l33
    l44 = torch.sqrt(S[3, 3] - l41 * l41 - l42 * l42 - l43 * l43)
    y1 = B[0] / l11
    y2 = (B[1] - l21 * y1) / l22
    y3 = (B[2] - l31 * y1 - l32 * y2) / l33
    y4 = (B[3] - l41 * y1 - l42 * y2 - l43 * y3) / l44
    x4 = y4 / l44
    x3 = (y3 - l43 * x4) / l33
    x2 = (y2 - l32 * x3 - l42 * x4) / l22
    x1 = (y1 - l21 * x2 - l31 * x3 - l41 * x4) / l11
    return torch.stack([x1, x2, x3, x4])


def _derive(x, P, time, prev_heading, prev_speed, dt, hold):
    speed = torch.sqrt(x[2] * x[2] + x[3] * x[3])
    heading = torch.where(speed > hold, torch.atan2(x[3], x[2]), prev_heading)
    accel = (speed - prev_speed) / dt
    dh = heading - prev_heading
    dh = torch.where(dh > math.pi, dh - 2 * math.pi, dh)
    dh = torch.where(dh < -math.pi, dh + 2 * math.pi, dh)
    row = torch.stack([x[0], x[1], x[2], x[3], heading, speed, accel, dh / dt, time,
                       torch.sqrt(P[0, 0] + P[1, 1]), torch.sqrt(P[2, 2] + P[3, 3])])
    return row, heading, speed


def step(ks: Dict[str, torch.Tensor], z: torch.Tensor, est: Dict, dtype=torch.float64):
    """One measured frame.  Returns (state', the (11,) row in ``ROW_FIELDS``
    order)."""
    x, P = ks["x"].to(dtype), ks["P"].to(dtype)
    F, H, Q, R = model(est, dtype, x.device)
    dt, hold = est["dt"], est["speed_heading_hold"]
    x = F @ x
    P = F @ P @ F.T + Q
    time = ks["time"].to(dtype) + dt
    _, ph, ps = _derive(x, P, time, ks["prev_heading"].to(dtype), ks["prev_speed"].to(dtype), dt, hold)
    y = z.to(dtype) - H @ x
    PHT = P @ H.T
    S = H @ PHT + R
    K = _solve_spd4(S, PHT.T).T
    x = x + K @ y
    I_KH = torch.eye(6, dtype=dtype, device=x.device) - K @ H
    P = I_KH @ P @ I_KH.T + K @ R @ K.T
    row, ph, ps = _derive(x, P, time, ph, ps, dt, hold)
    return {"x": x, "P": P, "time": time, "prev_heading": ph, "prev_speed": ps}, row
