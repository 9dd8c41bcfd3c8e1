"""Wrapper of kernel K2 (kernels/csrc/kalman_step.cu): one ego step of the
6-state constant-acceleration filter in one launch.

Replaces the Pallas TPU kernel of the JAX package's ops/kalman_pallas.py
(`_make_kernel`, launched by `make_fused_estimator_step`).  The plain
PyTorch version is estimation/ego.py `_estimator_step_xla`.  The kernel
also derives heading and yaw rate (``atan2f``), which the TPU kernel left
to XLA, so the whole step is one launch.

Bound on an H100: the step moves about 0.8 KB and does about 2,300
floating-point operations, well under a nanosecond either way and far
below the launch latency; it is latency-bound.  The kernel shares the step
over one warp: one wave of loads, one entry of each 6x6 product a lane,
the gain's six rows on six lanes (kalman_step.cu says more).  The state
stays float32 in memory; the algebra runs in double, which keeps the
finite-difference acceleration close to the float64 reference.

The wrapper does one thing per call (ops/launch.py): one pass of checks,
one output buffer carved into x, P and the vehicle row (`output_fields`;
the kernel carves the same offsets), and the stream without re-entering
the device context.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build
from ..ops.kalman import KalmanModel
from ..types import VEHICLE_STATE_FIELDS, KalmanState
from . import launch

# The output fields in the kernel's buffer (kalman_step.cu kOutX, kOutP,
# kOutVs): x (6,), P (6, 6), the vehicle row (11,).
OUTPUT_SHAPES = ((6,), (6, 6), (len(VEHICLE_STATE_FIELDS),))

# Launches of the kernel in this process; only `kalman_step` adds to it.
launches = 0


def output_fields(device) -> tuple:
    """The kernel's outputs carved from one float32 buffer:
    ``(buffer, [x, P, vs])``."""
    return launch.carve(OUTPUT_SHAPES, torch.float32, device)


def kalman_step(
    ks: KalmanState,
    model: KalmanModel,
    measurement: torch.Tensor,
    has_measurement: torch.Tensor,
    dt: float,
    speed_heading_hold: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 on CUDA tensors.

    Returns (x (6,), P (6, 6), vs (11,)), ``vs`` holding the reported
    VehicleState fields in declaration order.
    """
    global launches
    device = ks.x.device
    if device.type != "cuda":
        raise ValueError(f"kalman_step launches a CUDA kernel; got a tensor on {device}")
    f32 = torch.float32
    ins = (
        ("x", ks.x, f32, (6,)),
        ("P", ks.P, f32, (6, 6)),
        ("time", ks.time, f32, ()),
        ("prev_heading", ks.prev_heading, f32, ()),
        ("measurement", measurement, f32, (4,)),
        ("has_measurement", has_measurement, torch.bool, ()),
        ("F", model.F, f32, (6, 6)),
        ("Q", model.Q, f32, (6, 6)),
        ("R", model.R, f32, (4, 4)),
    )
    launch.check_inputs("kalman_step", device, ins)
    buf, (x, P, vs) = output_fields(device)
    ptrs = [t.data_ptr() for _, t, _, _ in ins]
    kernel = build.kernels().kalman_step
    args = (buf.data_ptr(), float(dt), float(speed_heading_hold))
    err = launch.launch(device, lambda stream: kernel(*ptrs, *args, stream))
    if err != 0:
        raise RuntimeError(f"kalman_step: kernel launch failed with CUDA error {err}")
    launches += 1
    return x, P, vs
