"""Wrapper of kernel K6 (kernels/csrc/plan_step.cu): the motion planner of
one frame in one launch.

Replaces no TPU kernel: the JAX package's planner (planning/planner.py,
ops/quintic.py) is a fusion XLA makes of tensor ops, with no Pallas
kernel.  K6 was added because the port's tensor ops launched about 57
kernels a frame for the planner, each costing the host 15-25 us of
dispatch for a few hundred bytes of work, and that host time held the
frame step more than any other stage.  The plain PyTorch version is
planning/planner.py `plan_plain` (ops/quintic.py), the CPU's path.

Bound on an H100: at the default grid (21 candidates of 51 waypoints) a
step reads about 0.6 KB, writes about 22.6 KB and does about 50 thousand
floating-point operations, some 7 ns of memory and under a nanosecond of
arithmetic: far below the launch latency, so the step is latency-bound.
The kernel runs a candidate on a warp and its waypoints on the lanes, 32
at a time, with the arc length as a warp scan and every neighbour
difference by shuffles, in one pass with no barrier; then the stable
order as a parallel count (plan_step.cu says more).  The wrapper does one
thing per call (ops/launch.py): one pass of checks, two output buffers
carved into the fields of `PlanResult` and the chosen plan's rows, and the
stream without re-entering the device context.  It reads nothing back.

The start state is read from a row at four field offsets: a (..., 4)
state at `STATE_FIELDS`, or K2's (..., 11) vehicle row at `ROW_FIELDS`,
so the frame step hands over K2's output as it is.

Lanes: a start state with a leading lane axis, (B, W), goes through one
launch of B blocks, each lane planned as its unbatched launch plans it,
bit for bit; the optional reference path and obstacles then carry the
same axis.  ``launches`` counts launches, not lanes.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from ..config import PlannerConfig
from ..kernels import build
from ..types import VEHICLE_STATE_FIELDS, PlanResult
from . import launch
from .quintic import _time_grid, candidate_grid

# Where x, y, heading and speed sit in a (..., 4) start state and in K2's
# (..., 11) vehicle row.
STATE_FIELDS = (0, 1, 2, 3)
ROW_FIELDS = tuple(VEHICLE_STATE_FIELDS.index(k) for k in ("x", "y", "heading", "speed"))

# The output fields, in the order the kernel carves its two buffers
# (plan_step.cu `carve`).
FLOAT_FIELDS = ("positions", "headings", "velocities", "curvatures", "costs", "best_positions", "best_velocities")
INT_FIELDS = ("order", "best")

# Launches of the kernel in this process; only `plan_step` adds to it.
launches = 0


@functools.lru_cache(maxsize=None)
def output_shapes(C: int, N: int, lead: tuple = ()) -> tuple:
    """The shapes of FLOAT_FIELDS and of INT_FIELDS at C candidates of N
    waypoints, behind the lane axes ``lead``."""
    per_lane = ((C, N, 2), (C, N), (C, N), (C, N), (C,), (N, 2), (N,))
    return tuple(lead + s for s in per_lane), (lead + (C,), lead)


def plan_step(
    state: torch.Tensor,
    cfg: PlannerConfig,
    reference_positions: Optional[torch.Tensor] = None,
    reference_valid: Optional[torch.Tensor] = None,
    obstacles: Optional[torch.Tensor] = None,
    obstacles_valid: Optional[torch.Tensor] = None,
    fields: Tuple[int, int, int, int] = STATE_FIELDS,
) -> Tuple[PlanResult, torch.Tensor, torch.Tensor]:
    """Launch K6 on CUDA tensors: ``state`` (..., W) float32 holds x, y,
    heading and speed at ``fields``; the reference path (..., R, 2) and its
    valid flags (..., R), and the obstacles (..., O, 3) and theirs (..., O),
    carry the same leading axes.  Returns (the plan, the chosen plan's
    positions (..., N, 2), its velocities (..., N))."""
    global launches
    device = state.device
    if device.type != "cuda":
        raise ValueError(f"plan_step launches a CUDA kernel; got a tensor on {device}")
    if state.dim() < 1 or state.shape[-1] <= max(fields) or min(fields) < 0:
        raise ValueError(f"plan_step reads fields {fields} of the start state; got shape {tuple(state.shape)}")
    lead, width = tuple(state.shape[:-1]), state.shape[-1]
    B = math.prod(lead)
    if B < 1:
        raise ValueError(f"plan_step takes at least one lane; got a start state of shape {tuple(state.shape)}")
    lat, tv = candidate_grid(cfg.num_samples, cfg.lateral_range, tuple(cfg.target_velocities), device)
    t, alpha, blend = _time_grid(cfg.planning_horizon, cfg.dt, device)
    C, N = lat.shape[0], t.shape[0]
    if C < 1 or N < 3:
        raise ValueError(f"plan_step takes at least 1 candidate and 3 waypoints; the config gives {C} and {N}")
    f32 = torch.float32
    ins = [("state", state, f32, lead + (width,))]
    R = O = 0
    if reference_positions is not None:
        R = reference_positions.shape[-2] if reference_positions.dim() >= 2 else 0
        ins.append(("reference_positions", reference_positions, f32, lead + (R, 2)))
        if reference_valid is not None:
            ins.append(("reference_valid", reference_valid, torch.bool, lead + (R,)))
    else:
        reference_valid = None  # the plain version reads the flags only with the path
    if obstacles is not None:
        O = obstacles.shape[-2] if obstacles.dim() >= 2 else 0
        ins.append(("obstacles", obstacles, f32, lead + (O, 3)))
        if obstacles_valid is not None:
            ins.append(("obstacles_valid", obstacles_valid, torch.bool, lead + (O,)))
    launch.check_inputs("plan_step", device, ins)
    if reference_positions is not None and R < 1:
        raise ValueError("plan_step takes a reference path of at least one point (the plain version's minimum)")
    if O == 0:  # no obstacle adds nothing to a cost
        obstacles = obstacles_valid = None

    fshapes, ishapes = output_shapes(C, N, lead)
    fbuf = launch.buffer(fshapes, f32, device)
    ibuf = launch.buffer(ishapes, torch.int32, device)
    ptrs = [state.data_ptr(), t.data_ptr(), alpha.data_ptr(), blend.data_ptr(), lat.data_ptr(), tv.data_ptr()]
    ptrs += [0 if x is None else x.data_ptr() for x in (reference_positions, reference_valid, obstacles, obstacles_valid)]
    args = (fbuf.data_ptr(), ibuf.data_ptr(), B, C, N, R, O, width, *fields, float(cfg.w_lateral),
            float(cfg.w_velocity), float(cfg.w_acceleration), float(cfg.w_curvature), float(cfg.cruise_velocity),
            float(cfg.dt))
    kernel = build.kernels().plan_step
    err = launch.launch(device, lambda stream: kernel(*ptrs, *args, stream))
    if err != 0:
        raise RuntimeError(f"plan_step: kernel launch failed with CUDA error {err}")
    launches += 1
    pos, head, vel, curv, costs, best_pos, best_vel = launch.split(fbuf, fshapes)
    order, best = launch.split(ibuf, ishapes)
    pr = PlanResult(positions=pos, headings=head, velocities=vel, curvatures=curv, timestamps=t, costs=costs,
                    lateral_offsets=lat, target_velocities=tv, best=best, order=order)
    return pr, best_pos, best_vel
