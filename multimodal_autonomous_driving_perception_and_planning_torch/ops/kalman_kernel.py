"""Wrapper of kernel K2 (kernels/csrc/kalman_step.cu): one ego step of the
6-state constant-acceleration filter in one launch.

Replaces the Pallas TPU kernel of the JAX package's ops/kalman_pallas.py
(`_make_kernel`, launched by `make_fused_estimator_step`).  The plain
PyTorch version is estimation/ego.py `_estimator_step_xla`.  The kernel
also derives heading and yaw rate (``atan2f``), which the TPU kernel left
to XLA, so the whole step is one launch.

Bound on an H100: the step moves about 0.8 KB and does about 2,300
floating-point operations, well under a nanosecond either way and far
below the launch latency; it is latency-bound.  The kernel keeps the whole
6x6 algebra in one thread's registers: no shared memory, no
synchronisation, one launch per frame.  The state stays float32 in memory;
the algebra runs in double, which keeps the finite-difference acceleration
close to the float64 reference (see the note in kalman_step.cu).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build
from ..ops.kalman import KalmanModel
from ..types import VEHICLE_STATE_FIELDS, KalmanState

# Launches of the kernel in this process; only `kalman_step` adds to it.
launches = 0


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
    for name, t, dtype, shape in ins:
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"kalman_step: {name} is {t.dtype} {tuple(t.shape)} on {t.device}; "
                f"expected {dtype} {shape} on {device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"kalman_step: {name} is not contiguous")
    x = torch.empty((6,), dtype=f32, device=device)
    P = torch.empty((6, 6), dtype=f32, device=device)
    vs = torch.empty((len(VEHICLE_STATE_FIELDS),), dtype=f32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = build.kernels().kalman_step(
            *[t.data_ptr() for _, t, _, _ in ins],
            x.data_ptr(), P.data_ptr(), vs.data_ptr(),
            float(dt), float(speed_heading_hold), stream,
        )
    if err != 0:
        raise RuntimeError(f"kalman_step: kernel launch failed with CUDA error {err}")
    launches += 1
    return x, P, vs
