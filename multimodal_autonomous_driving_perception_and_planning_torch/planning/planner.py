"""Motion planner: all candidates at once, then a stable sort by cost.

The reference's 21 x 51 double Python loop (src/planning/motion_planner.py:
264-303) as one broadcast tensor program (ops.quintic); selection is a
stable sort over the costs, so the sorted list matches
``candidates.sort(key=cost)`` and `best` is the first minimum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import PlannerConfig
from ..ops.quintic import candidate_grid, evaluate_costs, generate_candidates
from ..types import PlanResult
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
    """Plan from (x, y, heading, velocity) on ``current_state``'s device;
    ``current_state`` (..., 4) with leading lane dimensions plans each lane
    (the optional references and obstacles then carry them too)."""
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
