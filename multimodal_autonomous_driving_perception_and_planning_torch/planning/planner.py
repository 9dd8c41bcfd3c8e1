"""Motion planner: all candidates at once, then a stable sort by cost.

The reference's 21 x 51 double Python loop (src/planning/motion_planner.py:
264-303) as one broadcast tensor program (ops.quintic), `plan_plain`;
selection is a stable sort over the costs, so the sorted list matches
``candidates.sort(key=cost)`` and `best` is the first minimum.  On the
card the whole plan is kernel K6 (ops/planner_kernel.py), one launch for
all lanes; on the CPU it is `plan_plain`.  The choice follows the start
state's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import PlannerConfig
from ..ops import planner_kernel
from ..ops.quintic import candidate_grid, evaluate_costs, generate_candidates
from ..types import PlanResult, vehicle_state_from_row
from ..utils.device import resolve_device


def make_reference_path(waypoints, capacity: int, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad an (R, 2) reference path into the fixed-capacity buffer the cost
    takes (mirrors set_reference_path, motion_planner.py:93-124: only the
    positions matter to the cost, :224-231).  Returns ``(buf (capacity, 2)
    float32, valid (capacity,) bool)`` on ``device``: the card unless the
    caller asks for the CPU (`utils.device.resolve_device`, which refuses
    ``cuda`` on a machine without a card)."""
    wp = torch.as_tensor(waypoints, dtype=torch.float32).reshape(-1, 2)
    n = wp.shape[0]
    if n > capacity:
        raise ValueError(f"reference path has {n} points, capacity {capacity}")
    dev = resolve_device(device)
    buf = torch.zeros((capacity, 2), dtype=torch.float32)
    buf[:n] = wp
    return buf.to(dev), (torch.arange(capacity) < n).to(dev)


def plan(
    current_state: torch.Tensor,
    cfg: PlannerConfig,
    reference_positions: Optional[torch.Tensor] = None,
    reference_valid: Optional[torch.Tensor] = None,
    obstacles: Optional[torch.Tensor] = None,
    obstacles_valid: Optional[torch.Tensor] = None,
) -> PlanResult:
    """Plan from (x, y, heading, velocity) on ``current_state``'s device:
    kernel K6 on the card, `plan_plain` on the CPU.  ``current_state``
    (..., 4) with leading lane dimensions plans each lane (the optional
    references and obstacles then carry them too)."""
    if current_state.device.type == "cuda":
        state = current_state.to(torch.float32).contiguous()
        return planner_kernel.plan_step(
            state, cfg, reference_positions, reference_valid, obstacles, obstacles_valid
        )[0]
    return plan_plain(current_state, cfg, reference_positions, reference_valid, obstacles, obstacles_valid)


def plan_from_row(
    row: torch.Tensor,
    cfg: PlannerConfig,
    reference_positions: Optional[torch.Tensor] = None,
    reference_valid: Optional[torch.Tensor] = None,
    obstacles: Optional[torch.Tensor] = None,
    obstacles_valid: Optional[torch.Tensor] = None,
) -> Tuple[PlanResult, torch.Tensor, torch.Tensor]:
    """Plan from K2's (11,) or (B, 11) vehicle row, as the frame step does:
    kernel K6 on the card, reading the row where it lies;
    `plan_from_row_plain` on the CPU.  Returns (the plan, the chosen plan's
    positions (..., N, 2), its velocities (..., N))."""
    if row.device.type == "cuda":
        return planner_kernel.plan_step(
            row, cfg, reference_positions, reference_valid, obstacles, obstacles_valid,
            fields=planner_kernel.ROW_FIELDS,
        )
    return plan_from_row_plain(row, cfg, reference_positions, reference_valid, obstacles, obstacles_valid)


def plan_from_row_plain(
    row: torch.Tensor,
    cfg: PlannerConfig,
    reference_positions: Optional[torch.Tensor] = None,
    reference_valid: Optional[torch.Tensor] = None,
    obstacles: Optional[torch.Tensor] = None,
    obstacles_valid: Optional[torch.Tensor] = None,
) -> Tuple[PlanResult, torch.Tensor, torch.Tensor]:
    """`plan_from_row` in tensor ops on any device: the start state stacked
    from the row's fields, `plan_plain`, and the chosen plan's rows
    gathered.  The program utils/export.py traces calls it by name: an
    exported program holds no call of the kernel library."""
    vstate = vehicle_state_from_row(row)
    current = torch.stack([vstate.x, vstate.y, vstate.heading, vstate.speed], dim=-1)
    pr = plan_plain(current, cfg, reference_positions, reference_valid, obstacles, obstacles_valid)
    if row.dim() > 1:
        lanes = torch.arange(row.shape[0], device=row.device)
        return pr, pr.positions[lanes, pr.best], pr.velocities[lanes, pr.best]
    best = pr.best.view(1)
    return pr, pr.positions.index_select(0, best)[0], pr.velocities.index_select(0, best)[0]


def plan_plain(
    current_state: torch.Tensor,
    cfg: PlannerConfig,
    reference_positions: Optional[torch.Tensor] = None,
    reference_valid: Optional[torch.Tensor] = None,
    obstacles: Optional[torch.Tensor] = None,
    obstacles_valid: Optional[torch.Tensor] = None,
) -> PlanResult:
    """K6's plain version: `plan` as broadcast tensor ops on
    ``current_state``'s device."""
    lat, tv = candidate_grid(
        cfg.num_samples, cfg.lateral_range, tuple(cfg.target_velocities), current_state.device
    )
    cand = generate_candidates(
        current_state.to(torch.float32), lat, tv, cfg.planning_horizon, cfg.dt
    )
    costs = evaluate_costs(
        cand,
        w_lateral=cfg.w_lateral,
        w_velocity=cfg.w_velocity,
        w_acceleration=cfg.w_acceleration,
        w_curvature=cfg.w_curvature,
        cruise_velocity=cfg.cruise_velocity,
        reference_positions=reference_positions,
        reference_valid=reference_valid,
        obstacles=obstacles,
        obstacles_valid=obstacles_valid,
    )
    order = torch.sort(costs, dim=-1, stable=True).indices.to(torch.int32)
    return PlanResult(
        positions=cand.positions,
        headings=cand.headings,
        velocities=cand.velocities,
        curvatures=cand.curvatures,
        timestamps=cand.timestamps,
        costs=costs,
        lateral_offsets=cand.lateral_offsets,
        target_velocities=cand.target_velocities,
        best=order[..., 0],
        order=order,
    )


def trajectory_type(lateral_offset: float) -> str:
    """Host-side label mirroring motion_planner.py:288-294."""
    if abs(lateral_offset) < 0.5:
        return "lane_keep"
    if lateral_offset < 0:
        return "lane_change_left"
    return "lane_change_right"
