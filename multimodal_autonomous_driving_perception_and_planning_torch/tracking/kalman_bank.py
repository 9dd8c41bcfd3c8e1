"""Opt-in per-agent Kalman smoothing bank over the runner's track outputs.

The reference tracker has no per-track filter (its velocity is a raw frame
difference, multi_object_tracker.py:180-205), so this stage is opt-in and
leaves the tracking decisions alone: it post-processes the outputs of
`make_sequence_runner`.

One constant-acceleration filter per track slot, all N slots advanced as
one batched predict and Joseph update (ops/kalman.py over (N, 6) states and
(N, 6, 6) covariances) a frame.  The JAX package has no kernel here, and
neither has the port: a frame is a few dozen batched tensor ops.  Each
slot's lifecycle follows the ``track_id`` stream:
  * id changed (birth or slot reuse) -> the filter restarts at the
    measurement;
  * same id, slot alive              -> predict + Joseph update;
  * slot free                        -> state carried (masked out of output).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import PipelineConfig
from ..ops.kalman import kalman_predict, kalman_update, make_constant_accel_model
from ..utils.convert import kalman_model_from_numpy
from ..utils.device import resolve_device


def make_kalman_bank(
    cfg: PipelineConfig,
    process_noise: float = 1.0,
    measurement_noise: float = 4.0,
    accel_noise_scale: float = 10.0,
    initial_covariance: float = 100.0,
    device="cuda",
):
    """Build ``smooth(outs) -> dict`` over a runner's outputs.

    ``outs`` needs ``track_id`` (T, N), ``track_bbox`` (T, N, 4),
    ``track_velocity`` (T, N, 2) and ``track_vel_count`` (T, N), numpy or
    tensors; N is ``cfg.tracker.max_tracks``.  Returns per-frame smoothed
    ``positions`` (T, N, 2), ``velocities`` (T, N, 2) and ``valid`` (T, N)
    on the bank's device.  The noise defaults are in pixels: box centers
    jitter by a few pixels frame to frame, which is what the bank smooths.
    """
    dev = resolve_device(device)
    # Track space counts time in frames: the track velocities are raw
    # per-frame differences, so dt = 1 frame, not the estimator's dt.
    model = kalman_model_from_numpy(
        *make_constant_accel_model(
            1.0,
            process_noise=process_noise,
            measurement_noise=measurement_noise,
            accel_noise_scale=accel_noise_scale,
        ),
        device=dev,
    )
    n = cfg.tracker.max_tracks
    p_reset = torch.eye(6, dtype=torch.float32, device=dev) * float(initial_covariance)

    def smooth(outs) -> Dict[str, torch.Tensor]:
        def take(key, dtype):
            return torch.as_tensor(outs[key]).to(device=dev, dtype=dtype)

        tids = take("track_id", torch.int32)  # (T, N)
        bbox = take("track_bbox", torch.float32)  # (T, N, 4)
        vel = take("track_velocity", torch.float32)  # (T, N, 2)
        has_vel = take("track_vel_count", torch.int32) > 0  # (T, N)
        if tids.shape[1] != n:
            raise ValueError(f"the outputs have {tids.shape[1]} track slots, the bank {n}")
        centers = torch.stack(
            [(bbox[..., 0] + bbox[..., 2]) * 0.5, (bbox[..., 1] + bbox[..., 3]) * 0.5], dim=-1
        )
        num_frames = tids.shape[0]
        x = torch.zeros((n, 6), dtype=torch.float32, device=dev)
        P = p_reset.expand(n, 6, 6)
        prev_id = torch.zeros((n,), dtype=torch.int32, device=dev)
        zeros2 = torch.zeros((n, 2), dtype=torch.float32, device=dev)
        states = torch.empty((num_frames, n, 6), dtype=torch.float32, device=dev)
        for t in range(num_frames):
            tid, c, hv = tids[t], centers[t], has_vel[t, :, None]
            alive = tid > 0
            fresh = (alive & (tid != prev_id))[:, None]
            cont = (alive & (tid == prev_id))[:, None]
            # Velocity measurement: the raw frame difference; before the
            # first difference exists, the predicted velocity (a zero
            # velocity residual: a position-only update of the mean).
            xp, Pp = kalman_predict(model, x, P)
            z = torch.cat([c, torch.where(hv, vel[t], xp[:, 2:4])], dim=-1)
            xu, Pu = kalman_update(model, xp, Pp, z)
            x_reset = torch.cat([c, torch.where(hv, vel[t], zeros2), zeros2], dim=-1)
            x = torch.where(fresh, x_reset, torch.where(cont, xu, x))
            P = torch.where(fresh[..., None], p_reset, torch.where(cont[..., None], Pu, P))
            prev_id = tid
            states[t] = x
        return {
            "positions": states[..., :2],
            "velocities": states[..., 2:4],
            "valid": tids > 0,
        }

    return smooth
