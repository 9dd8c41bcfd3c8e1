"""Kalman filter predict and Joseph-form update, as plain tensor ops.

The reference's filterpy 6-state constant-acceleration filter
(src/state_estimation/vehicle_state.py:68-106).  The update uses the
Joseph-form covariance update, matching filterpy's ``KalmanFilter.update``.
The matrix products must run in full float32: on the card set
``torch.backends.cuda.matmul.allow_tf32 = False`` where parity is measured
(it is PyTorch's default).

Both functions take states with leading batch dimensions, ``x`` (..., S)
and ``P`` (..., S, S), as the JAX package's take them under ``vmap``: the
per-agent Kalman bank advances every track slot in one call.  An unbatched
state takes the matrix-vector path it always took, so its results stay
what the ego estimator's plain step (kernel K2's reference) gives.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch


class KalmanModel(NamedTuple):
    """The model matrices: float32 numpy arrays from
    `make_constant_accel_model`, tensors once `utils.convert.
    kalman_model_from_numpy` has put them on a device."""

    F: Any  # (S, S) state transition
    H: Any  # (M, S) measurement
    Q: Any  # (S, S) process noise
    R: Any  # (M, M) measurement noise


def make_constant_accel_model(
    dt: float,
    process_noise: float = 0.1,
    measurement_noise: float = 1.0,
    accel_noise_scale: float = 10.0,
) -> KalmanModel:
    """Constant-acceleration model over state [x, y, vx, vy, ax, ay] with
    measurements [x, y, vx, vy] (vehicle_state.py:75-98), as float32 numpy
    arrays; `utils.convert.kalman_model_from_numpy` puts them on a device."""
    h = 0.5 * dt * dt
    F = np.array(
        [
            [1, 0, dt, 0, h, 0],
            [0, 1, 0, dt, 0, h],
            [0, 0, 1, 0, dt, 0],
            [0, 0, 0, 1, 0, dt],
            [0, 0, 0, 0, 1, 0],
            [0, 0, 0, 0, 0, 1],
        ],
        dtype=np.float32,
    )
    H = np.zeros((4, 6), dtype=np.float32)
    H[np.arange(4), np.arange(4)] = 1
    q = np.ones((6,), dtype=np.float32) * process_noise
    q[4] *= accel_noise_scale
    q[5] *= accel_noise_scale
    Q = np.diag(q).astype(np.float32)
    R = (np.eye(4) * measurement_noise).astype(np.float32)
    return KalmanModel(F=F, H=H, Q=Q, R=R)


def kalman_predict(
    model: KalmanModel, x: torch.Tensor, P: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x' = Fx,  P' = FPF^T + Q, over any leading batch dimensions."""
    x = model.F @ x if x.dim() == 1 else x @ model.F.T
    P = model.F @ P @ model.F.T + model.Q
    return x, P


def _solve_spd4(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve S X = B for SPD 4x4 S via a fully unrolled Cholesky factor and
    two triangular solves (the innovation covariance is SPD).  ``S`` is
    (..., 4, 4) and ``B`` (..., 4, n); the factor's entries broadcast over
    the rows of ``B``."""
    def s(i, j):
        return S[..., i, j, None]

    l11 = torch.sqrt(s(0, 0))
    l21 = s(1, 0) / l11
    l31 = s(2, 0) / l11
    l41 = s(3, 0) / l11
    l22 = torch.sqrt(s(1, 1) - l21 * l21)
    l32 = (s(2, 1) - l31 * l21) / l22
    l42 = (s(3, 1) - l41 * l21) / l22
    l33 = torch.sqrt(s(2, 2) - l31 * l31 - l32 * l32)
    l43 = (s(3, 2) - l41 * l31 - l42 * l32) / l33
    l44 = torch.sqrt(s(3, 3) - l41 * l41 - l42 * l42 - l43 * l43)

    # Forward substitution L Y = B (rows of Y are (..., n) vectors).
    y1 = B[..., 0, :] / l11
    y2 = (B[..., 1, :] - l21 * y1) / l22
    y3 = (B[..., 2, :] - l31 * y1 - l32 * y2) / l33
    y4 = (B[..., 3, :] - l41 * y1 - l42 * y2 - l43 * y3) / l44
    # Back substitution L^T X = Y.
    x4 = y4 / l44
    x3 = (y3 - l43 * x4) / l33
    x2 = (y2 - l32 * x3 - l42 * x4) / l22
    x1 = (y1 - l21 * x2 - l31 * x3 - l41 * x4) / l11
    return torch.stack([x1, x2, x3, x4], dim=-2)


def kalman_update(
    model: KalmanModel, x: torch.Tensor, P: torch.Tensor, z: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joseph-form measurement update (filterpy-compatible), over any
    leading batch dimensions."""
    H, R = model.H, model.R
    batched = x.dim() > 1
    y = z - (x @ H.T if batched else H @ x)
    PHT = P @ H.T
    S = H @ PHT + R
    PHT_T = PHT.transpose(-1, -2)
    if S.shape[-1] == 4:
        K = _solve_spd4(S, PHT_T).transpose(-1, -2)  # K = PHT S^-1, no explicit inverse
    else:
        K = torch.linalg.solve(S.transpose(-1, -2), PHT_T).transpose(-1, -2)
    x = x + ((K @ y[..., None])[..., 0] if batched else K @ y)
    I_KH = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device) - K @ H
    P = I_KH @ P @ I_KH.transpose(-1, -2) + K @ R @ K.transpose(-1, -2)
    return x, P
