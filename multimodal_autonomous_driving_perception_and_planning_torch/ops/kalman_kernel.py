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
one output buffer carved into x, P, the vehicle row and the next step's
time, heading and speed (`unpack`; the kernel carves the same
offsets), and the stream without re-entering the device context.

Lanes: a state with a leading lane axis, x (B, 6) and so on, goes through
one launch of B one-warp blocks, each lane's step exactly as its
unbatched launch computes it; the model's F, Q and R are shared.  An
unbatched call is the kernel's B = 1.  ``launches`` counts launches.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..kernels import build
from ..ops.kalman import KalmanModel
from ..types import VEHICLE_STATE_FIELDS, KalmanState
from . import launch

# The output fields in the kernel's buffer (kalman_step.cu `carve`): x (6,),
# P (6, 6), the vehicle row (11,), and the time, heading and speed the next
# step reads as its time, prev_heading and prev_speed ().
OUTPUT_SHAPES = ((6,), (6, 6), (len(VEHICLE_STATE_FIELDS),), (), (), ())

# Launches of the kernel in this process; only `kalman_step` adds to it.
launches = 0


@functools.lru_cache(maxsize=None)
def output_shapes(lead: tuple = ()) -> tuple:
    """OUTPUT_SHAPES behind the lane axis ``lead`` (``()`` or ``(B,)``)."""
    return tuple(lead + s for s in OUTPUT_SHAPES)


def output_fields(device, lead: tuple = ()) -> tuple:
    """The kernel's outputs carved from one float32 buffer, each behind the
    lane axis ``lead``: ``(buffer, [x, P, vs, time, heading, speed])``."""
    return launch.carve(output_shapes(lead), torch.float32, device)


def kalman_step(
    ks: KalmanState,
    model: KalmanModel,
    measurement: torch.Tensor,
    has_measurement: torch.Tensor,
    dt: float,
    speed_heading_hold: float,
) -> Tuple[KalmanState, torch.Tensor]:
    """Launch K2 on CUDA tensors, with or without a leading lane axis.

    Returns (new_state, vs), ``vs`` the (..., 11) row of the reported
    VehicleState fields in declaration order.
    """
    buf = kalman_buffer(ks, model, measurement, has_measurement, dt, speed_heading_hold)
    return unpack(buf, tuple(ks.x.shape[:-1]))


def kalman_buffer(
    ks: KalmanState,
    model: KalmanModel,
    measurement: torch.Tensor,
    has_measurement: torch.Tensor,
    dt: float,
    speed_heading_hold: float,
) -> torch.Tensor:
    """Launch K2 and return its output buffer; `unpack` carves the fields
    from it.  The CUDA implementation of the ``madpp.kalman_step`` op
    (ops/library.py).  The kernel reads neither ``ks.prev_speed`` nor
    ``model.H`` (its measurement model is fixed)."""
    global launches
    device = ks.x.device
    if device.type != "cuda":
        raise ValueError(f"kalman_step launches a CUDA kernel; got a tensor on {device}")
    lead = tuple(ks.x.shape[:-1])
    if len(lead) > 1 or (lead and lead[0] < 1):
        raise ValueError(f"kalman_step takes at most one lane axis; got x of shape {tuple(ks.x.shape)}")
    f32 = torch.float32
    ins = (
        ("x", ks.x, f32, lead + (6,)),
        ("P", ks.P, f32, lead + (6, 6)),
        ("time", ks.time, f32, lead),
        ("prev_heading", ks.prev_heading, f32, lead),
        ("measurement", measurement, f32, lead + (4,)),
        ("has_measurement", has_measurement, torch.bool, lead),
        ("F", model.F, f32, (6, 6)),
        ("Q", model.Q, f32, (6, 6)),
        ("R", model.R, f32, (4, 4)),
    )
    launch.check_inputs("kalman_step", device, ins)
    buf = launch.buffer(output_shapes(lead), f32, device)
    ptrs = [t.data_ptr() for _, t, _, _ in ins]
    kernel = build.kernels().kalman_step
    args = (buf.data_ptr(), lead[0] if lead else 1, float(dt), float(speed_heading_hold))
    err = launch.launch(device, lambda stream: kernel(*ptrs, *args, stream))
    if err != 0:
        raise RuntimeError(f"kalman_step: kernel launch failed with CUDA error {err}")
    launches += 1
    return buf


def unpack(buf: torch.Tensor, lead: tuple = ()) -> Tuple[KalmanState, torch.Tensor]:
    """The fields of K2's buffer behind the lane axis ``lead``, as views:
    (new_state, vs)."""
    x, P, vs, time, heading, speed = launch.split(buf, output_shapes(lead))
    return KalmanState(x=x, P=P, time=time, prev_heading=heading, prev_speed=speed), vs
