"""Plain motion planner: 7 lateral offsets x 3 target speeds, 51 waypoints
over 5 s, each candidate scored, the first cheapest chosen.

A candidate's speed blends from the current speed to its target as ``v0 +
(vt - v0)(1 - e^-t)``; its arc length accumulates ``v dt`` from 0; its
lateral offset follows the quintic ``d (10 tau^3 - 15 tau^4 + 6 tau^5)``,
``tau = t / horizon``; positions rotate (arc, lateral) by the heading.  The
heading is the finite difference of positions (the last repeating), the
curvature the heading difference over ``v dt + 1e-6`` (0 at both ends).
The cost is ``w_v sum (v - cruise)^2 + w_a sum a^2 + w_c sum kappa^2``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def plan(start: torch.Tensor, cfg: Dict, dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """``start`` (4,) [x, y, heading, speed] -> ``costs`` (C,), ``best`` (),
    ``positions`` (C, N, 2), ``velocities`` (C, N)."""
    dev = start.device
    x0, y0, h0, v0 = start.to(dtype).unbind()
    n = int(cfg["planning_horizon"] / cfg["dt"]) + 1
    dt = cfg["dt"]
    t = torch.linspace(0.0, cfg["planning_horizon"], n, dtype=torch.float64, device=dev)
    alpha = (1.0 - torch.exp(-t)).to(dtype)
    tau = (t / cfg["planning_horizon"]).clamp(0.0, 1.0)
    blend = (10 * tau**3 - 15 * tau**4 + 6 * tau**5).to(dtype)
    offs = torch.linspace(-cfg["lateral_range"], cfg["lateral_range"], cfg["num_samples"], dtype=torch.float64)
    vels = torch.tensor(cfg["target_velocities"], dtype=torch.float64)
    lat_off = offs.repeat_interleave(len(vels)).to(dev, dtype)
    tv = vels.repeat(len(offs)).to(dev, dtype)

    vel = v0 + (tv[:, None] - v0) * alpha[None, :]
    s = (torch.cumsum(vel, dim=-1) - vel[:, :1]) * dt
    lat = lat_off[:, None] * blend[None, :]
    x = x0 + s * torch.cos(h0) + lat * torch.cos(h0 + math.pi / 2)
    y = y0 + s * torch.sin(h0) + lat * torch.sin(h0 + math.pi / 2)
    head = torch.atan2(y[:, 1:] - y[:, :-1], x[:, 1:] - x[:, :-1])
    head = torch.cat([head, head[:, -1:]], dim=-1)
    kappa = (head[:, 1:] - head[:, :-1])[:, :-1] / (vel[:, 1:-1] * dt + 1e-6)
    zero = torch.zeros_like(kappa[:, :1])
    kappa = torch.cat([zero, kappa, zero], dim=-1)
    accel = (vel[:, 1:] - vel[:, :-1]) / (t[1:] - t[:-1]).to(dtype)
    costs = (cfg["w_velocity"] * ((vel - cfg["cruise_velocity"]) ** 2).sum(-1)
             + cfg["w_acceleration"] * (accel**2).sum(-1)
             + cfg["w_curvature"] * (kappa**2).sum(-1))
    best = torch.sort(costs, stable=True).indices[0]
    return {"costs": costs, "best": best, "positions": torch.stack([x, y], dim=-1), "velocities": vel}
