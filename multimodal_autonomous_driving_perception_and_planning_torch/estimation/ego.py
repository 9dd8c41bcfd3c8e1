"""Ego vehicle state estimation, one step per frame.

The reference's ``step()`` (src/state_estimation/vehicle_state.py:33-257)
calls ``predict()`` then ``update()``, and *both* call ``_extract_state``,
which mutates ``prev_heading``/``prev_speed`` (:108-117, :119-137,
:158-198).  The acceleration and yaw rate reported for a frame are
therefore finite differences against the *post-predict* values of the same
frame.  Both versions here keep that: extract once after predict (keeping
only the prev_* side effects), then again after the update.

`estimator_step` is the entry point: for CUDA tensors it launches kernel K2
(ops.kalman_kernel), for CPU tensors it runs the plain version.  A state
with a leading lane axis (x (B, 6) and so on) is B filters stepped at once:
one launch on the card, the plain version lane by lane on the CPU.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..config import EstimatorConfig
from ..ops import kalman_kernel
from ..ops.kalman import KalmanModel, kalman_predict, kalman_update
from ..types import KalmanState, VehicleState, map_lanes, vehicle_row, vehicle_state_from_row


def extract_state(
    x: torch.Tensor,
    P: torch.Tensor,
    time: torch.Tensor,
    prev_heading: torch.Tensor,
    prev_speed: torch.Tensor,
    dt: float,
    speed_heading_hold: float = 0.1,
) -> Tuple[VehicleState, torch.Tensor, torch.Tensor]:
    """Derive (speed, heading, accel, yaw rate, uncertainties) from (x, P),
    as vehicle_state.py:158-198.  Returns the state plus the updated
    (prev_heading, prev_speed) memory."""
    px, py, vx, vy = x[0], x[1], x[2], x[3]
    speed = torch.sqrt(vx * vx + vy * vy)
    heading = torch.where(speed > speed_heading_hold, torch.atan2(vy, vx), prev_heading)
    acceleration = (speed - prev_speed) / dt if dt > 0 else torch.zeros_like(speed)

    heading_diff = heading - prev_heading
    heading_diff = torch.where(heading_diff > math.pi, heading_diff - 2 * math.pi, heading_diff)
    heading_diff = torch.where(heading_diff < -math.pi, heading_diff + 2 * math.pi, heading_diff)
    yaw_rate = heading_diff / dt if dt > 0 else torch.zeros_like(heading_diff)

    state = VehicleState(
        x=px,
        y=py,
        vx=vx,
        vy=vy,
        heading=heading,
        speed=speed,
        acceleration=acceleration,
        yaw_rate=yaw_rate,
        timestamp=time,
        pos_uncertainty=torch.sqrt(P[0, 0] + P[1, 1]),
        vel_uncertainty=torch.sqrt(P[2, 2] + P[3, 3]),
    )
    return state, heading, speed


def set_initial_state(
    ks: KalmanState,
    x: float,
    y: float,
    vx: float = 0.0,
    vy: float = 0.0,
    ax: float = 0.0,
    ay: float = 0.0,
) -> KalmanState:
    """Seed the filter at a known state (vehicle_state.py:242-248): sets the
    6-vector and primes prev_heading/prev_speed from the given velocity, so
    that the first frame's finite differences are taken against it.  As the
    JAX package computes them: the heading in float32 from the velocity in
    float32, the speed as the correctly rounded float32 root of the float32
    of the double square sum (a root rounded from double is; torch's float32
    root on the CPU can stand an ulp off).  On the host, then moved."""
    vel = torch.tensor([vy, vx], dtype=torch.float32)
    speed = math.sqrt(float(np.float32(vx * vx + vy * vy)))
    return KalmanState(
        x=torch.tensor([x, y, vx, vy, ax, ay], dtype=ks.x.dtype).to(ks.x.device),
        P=ks.P,
        time=ks.time,
        prev_heading=torch.atan2(vel[0], vel[1]).to(ks.prev_heading),
        prev_speed=torch.tensor(speed, dtype=torch.float32).to(ks.prev_speed),
    )


def estimator_step(
    ks: KalmanState,
    model: KalmanModel,
    measurement: torch.Tensor,
    has_measurement,
    cfg: EstimatorConfig,
) -> Tuple[KalmanState, VehicleState]:
    """predict + optional update, as vehicle_state.py:139-156.

    ``model`` holds tensors on the state's device.  ``measurement`` is (4,)
    [x, y, vx, vy]; it is ignored where ``has_measurement`` is False (the
    reference's measurement-skip branch).  CUDA tensors go through kernel
    K2, CPU tensors through the plain version.
    """
    new_ks, row = estimator_step_row(ks, model, measurement, has_measurement, cfg)
    return new_ks, vehicle_state_from_row(row)


def estimator_step_row(
    ks: KalmanState,
    model: KalmanModel,
    measurement: torch.Tensor,
    has_measurement,
    cfg: EstimatorConfig,
) -> Tuple[KalmanState, torch.Tensor]:
    """`estimator_step` with the vehicle state as one (11,) float32 row in
    VehicleState field order, (B, 11) with a lane axis: on the card, the
    row kernel K2 writes."""
    device = ks.x.device
    lead = tuple(ks.x.shape[:-1])
    measurement = measurement.to(torch.float32)
    has_measurement = torch.as_tensor(has_measurement, dtype=torch.bool, device=device)
    if has_measurement.shape != lead:
        has_measurement = has_measurement.expand(lead).contiguous()
    if device.type == "cuda":
        return _estimator_row_fused(ks, model, measurement, has_measurement, cfg)
    if device.type != "cpu":
        raise ValueError(f"estimator_step: unsupported device {device}")
    if lead:
        return map_lanes(
            lambda k, z, h: estimator_step_row(k, model, z, h, cfg), lead[0], ks, measurement, has_measurement
        )
    new_ks, state = _estimator_step_xla(ks, model, measurement, has_measurement, cfg)
    return new_ks, vehicle_row(state)


def _estimator_step_xla(
    ks: KalmanState,
    model: KalmanModel,
    measurement: torch.Tensor,
    has_measurement: torch.Tensor,
    cfg: EstimatorConfig,
) -> Tuple[KalmanState, VehicleState]:
    """The plain estimator step (kernel K2's reference), named after the
    JAX package's XLA formulation it mirrors op for op."""
    # predict(): advances time, extracts state for its prev_* side effects.
    x, P = kalman_predict(model, ks.x, ks.P)
    time = ks.time + cfg.dt
    _, prev_heading, prev_speed = extract_state(
        x, P, time, ks.prev_heading, ks.prev_speed, cfg.dt, cfg.speed_heading_hold
    )

    # update(z): Joseph-form update, then the reported extraction.
    xu, Pu = kalman_update(model, x, P, measurement)
    x = torch.where(has_measurement, xu, x)
    P = torch.where(has_measurement, Pu, P)

    state, prev_heading, prev_speed = extract_state(
        x, P, time, prev_heading, prev_speed, cfg.dt, cfg.speed_heading_hold
    )
    new_ks = KalmanState(x=x, P=P, time=time, prev_heading=prev_heading, prev_speed=prev_speed)
    return new_ks, state


def _estimator_row_fused(
    ks: KalmanState,
    model: KalmanModel,
    measurement: torch.Tensor,
    has_measurement: torch.Tensor,
    cfg: EstimatorConfig,
) -> Tuple[KalmanState, torch.Tensor]:
    """`estimator_step_row` through kernel K2 (CUDA tensors only)."""
    return kalman_kernel.kalman_step(ks, model, measurement, has_measurement, cfg.dt, cfg.speed_heading_hold)


def _estimator_step_fused(
    ks: KalmanState,
    model: KalmanModel,
    measurement: torch.Tensor,
    has_measurement: torch.Tensor,
    cfg: EstimatorConfig,
) -> Tuple[KalmanState, VehicleState]:
    """`estimator_step` through kernel K2 (CUDA tensors only)."""
    new_ks, row = _estimator_row_fused(ks, model, measurement, has_measurement, cfg)
    return new_ks, vehicle_state_from_row(row)
