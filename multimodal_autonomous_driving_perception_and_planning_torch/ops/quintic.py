"""Closed-form quintic trajectory sampling and cost scoring, as tensor ops.

The reference planner's 21-candidate x 51-waypoint loop
(src/planning/motion_planner.py:126-262) as broadcast (C, N) expressions:
  * velocity blend v(t) = v0 + (vt - v0)(1 - e^{-t})           (:151-157)
  * arc length s[i] = s[i-1] + v[i] * dt with s[0] = 0          (:156-157)
  * lateral d(tau) = df (10 tau^3 - 15 tau^4 + 6 tau^5)         (:163-169)
  * Frenet->global via heading rotation                          (:171-180)
  * finite-diff heading, the last waypoint repeating the
    previous heading                                             (:182-190)
  * curvature = dheading / (v dt + 1e-6), zero at both ends      (:192-196)
  * cost = w_v sum (v-10)^2 + w_a sum accel^2 + w_c sum kappa^2
    [+ lateral-to-reference and obstacle terms]                  (:206-262)

The constant vectors (the time grid, the lateral grid and the quintic
blend) are built on the host in float32 so that they equal, bit for bit,
the values the JAX package's planner computes under ``jit``: there XLA
turns each division by a constant into a multiplication by its rounded
reciprocal, and contracts the blend polynomial into two fused
multiply-adds.  A near-tie in cost would otherwise flip the chosen plan.

Every function takes leading lane dimensions on the start state (and on
the optional references and obstacles), (..., C, N) out: B planners in one
pass of tensor ops.  The unbatched call runs the same ops on (C, N).
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

_F32 = np.float32


class CandidateSet(NamedTuple):
    positions: torch.Tensor  # (C, N, 2)
    headings: torch.Tensor  # (C, N)
    velocities: torch.Tensor  # (C, N)
    curvatures: torch.Tensor  # (C, N)
    timestamps: torch.Tensor  # (N,)
    lateral_offsets: torch.Tensor  # (C,)
    target_velocities: torch.Tensor  # (C,)


def _fma_f32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Elementwise ``a * b + c`` rounded once to float32 (numpy has no fma):
    the exact value as a fraction, then the nearest float32, ties to even."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, _F32) for v in (a, b, c)))
    out = np.empty(a.shape, _F32)
    for i, (x, y, z) in enumerate(zip(a.flat, b.flat, c.flat)):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        r = _F32(float(exact))  # within one float32 step of the answer
        cands = (np.nextafter(r, _F32(-np.inf)), r, np.nextafter(r, _F32(np.inf)))
        out.flat[i] = min(
            cands, key=lambda v: (abs(Fraction(float(v)) - exact), int(v.view(np.uint32)) & 1)
        )
    return out


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32 as XLA computes it:
    ``start * (1 - i * r) + i * (stop * r)`` with ``r = 1 / (num - 1)``
    rounded to float32, and ``stop`` itself last."""
    if num == 1:
        return np.asarray([start], _F32)
    div = num - 1
    i = np.arange(div, dtype=_F32)
    r = _F32(1) / _F32(div)
    out = _F32(start) * (_F32(1) - i * r) + i * (_F32(stop) * r)
    return np.concatenate([out, np.asarray([stop], _F32)]).astype(_F32)


def quintic_blend(t: np.ndarray, planning_horizon: float) -> np.ndarray:
    """``10 tau^3 - 15 tau^4 + 6 tau^5`` with ``tau = clip(t / horizon)``,
    as XLA computes it: the powers by repeated squaring, the polynomial as
    ``fma(tau^5, 6, fma(tau^3, 10, -(tau^4 * 15)))``."""
    tau = np.clip(t * (_F32(1) / _F32(planning_horizon)), _F32(0), _F32(1)).astype(_F32)
    tau2 = tau * tau
    tau3 = tau2 * tau
    tau4 = tau2 * tau2
    tau5 = tau * tau4
    return _fma_f32(tau5, _F32(6), _fma_f32(tau3, _F32(10), -(tau4 * _F32(15))))


@functools.lru_cache(maxsize=16)
def _time_grid(
    planning_horizon: float, dt: float, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(t, 1 - e^{-t}, blend) on ``device``, built once per grid and device
    so that a frame copies nothing from the host.  All three are computed
    on the CPU and then copied: a constant computed on the card (its own
    ``exp``) would differ by ulps from the CPU's, and a program exported on
    the CPU (utils/export.py) carries the CPU's."""
    n = int(planning_horizon / dt) + 1
    t_np = linspace_f32(0.0, planning_horizon, n)
    t_cpu = torch.from_numpy(t_np)
    t = t_cpu.to(device)
    alpha = (1.0 - torch.exp(-t_cpu)).to(device)
    blend = torch.from_numpy(quintic_blend(t_np, planning_horizon)).to(device)
    return t, alpha, blend


@functools.lru_cache(maxsize=16)
def candidate_grid(
    num_samples: int, lateral_range: float, target_velocities: tuple, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's (lateral offset x target velocity) grid in its loop
    order: offsets outer, velocities inner (motion_planner.py:282-297)."""
    offs = linspace_f32(-lateral_range, lateral_range, num_samples)
    vels = np.asarray(target_velocities, _F32)
    lat = np.repeat(offs, vels.shape[0])
    tv = np.tile(vels, offs.shape[0])
    return torch.from_numpy(lat).to(device), torch.from_numpy(tv).to(device)


def generate_candidates(
    start_state: torch.Tensor,
    lateral_offsets: torch.Tensor,
    target_velocities: torch.Tensor,
    planning_horizon: float,
    dt: float,
) -> CandidateSet:
    """Generate all candidate trajectories at once.

    Args:
      start_state: (..., 4) [x, y, heading, velocity].
      lateral_offsets: (C,) final lateral offsets df.
      target_velocities: (C,) target speeds.
    """
    # Each start value as (..., 1, 1), against the (C, N) grids.
    x0, y0, heading0, v0 = start_state[..., None, None].unbind(-3)
    t, alpha, blend = _time_grid(planning_horizon, dt, start_state.device)

    # Velocity profile and arc length (s[0]=0; s[i] accumulates v[i]*dt).
    vel = v0 + (target_velocities[:, None] - v0) * alpha[None, :]  # (..., C, N)
    s = (torch.cumsum(vel, dim=-1) - vel[..., :1]) * dt  # (..., C, N)

    # Quintic lateral blend.
    lat = lateral_offsets[:, None] * blend[None, :]  # (C, N)

    # Frenet -> global.
    c, sn = torch.cos(heading0), torch.sin(heading0)
    cp, sp = torch.cos(heading0 + math.pi / 2), torch.sin(heading0 + math.pi / 2)
    x = x0 + s * c + lat * cp
    y = y0 + s * sn + lat * sp
    positions = torch.stack([x, y], dim=-1)  # (..., C, N, 2)

    # Finite-difference heading; the last waypoint repeats the previous one.
    dx = x[..., 1:] - x[..., :-1]
    dy = y[..., 1:] - y[..., :-1]
    head = torch.atan2(dy, dx)  # (..., C, N-1)
    headings = torch.cat([head, head[..., -1:]], dim=-1)  # (..., C, N)

    # Curvature: dheading / (v dt + 1e-6); zero at the first and last point.
    dhead = headings[..., 1:] - headings[..., :-1]
    kappa_mid = dhead[..., :-1] / (vel[..., 1:-1] * dt + 1e-6)  # (..., C, N-2)
    zeros = torch.zeros_like(kappa_mid[..., :1])
    curvatures = torch.cat([zeros, kappa_mid, zeros], dim=-1)  # (..., C, N)

    return CandidateSet(
        positions=positions,
        headings=headings,
        velocities=vel,
        curvatures=curvatures,
        timestamps=t,
        lateral_offsets=lateral_offsets,
        target_velocities=target_velocities,
    )


def evaluate_costs(
    cand: CandidateSet,
    w_lateral: float,
    w_velocity: float,
    w_acceleration: float,
    w_curvature: float,
    cruise_velocity: float = 10.0,
    reference_positions: Optional[torch.Tensor] = None,  # (..., R, 2)
    reference_valid: Optional[torch.Tensor] = None,  # (..., R) bool
    obstacles: Optional[torch.Tensor] = None,  # (..., O, 3) x, y, radius
    obstacles_valid: Optional[torch.Tensor] = None,  # (..., O) bool
) -> torch.Tensor:
    """Total cost per candidate, (..., C), matching motion_planner.py:206-262."""
    vel = cand.velocities  # (..., C, N)
    t = cand.timestamps  # (N,)

    cost = w_velocity * torch.sum((vel - cruise_velocity) ** 2, dim=-1)

    dts = t[1:] - t[:-1]  # (N-1,)
    positive = dts > 0
    accel = (vel[..., 1:] - vel[..., :-1]) / torch.where(positive, dts, 1.0)
    accel = torch.where(positive, accel, 0.0)
    cost = cost + w_acceleration * torch.sum(accel**2, dim=-1)

    cost = cost + w_curvature * torch.sum(cand.curvatures**2, dim=-1)

    if reference_positions is not None:
        # (..., C, N, R) pairwise distances, masked min over reference points.
        diff = cand.positions[..., :, :, None, :] - reference_positions[..., None, None, :, :]
        dist = torch.linalg.vector_norm(diff, dim=-1)
        if reference_valid is not None:
            dist = torch.where(reference_valid[..., None, None, :], dist, math.inf)
        min_dist = dist.amin(dim=-1)  # (..., C, N)
        lat_cost = torch.sum(min_dist**2, dim=-1)
        # With no valid reference point the reference skips the term.
        if reference_valid is not None:
            lat_cost = torch.where(reference_valid.any(dim=-1, keepdim=True), lat_cost, 0.0)
        cost = cost + w_lateral * lat_cost

    if obstacles is not None:
        ox = obstacles[..., None, None, :, 0]  # (..., 1, 1, O)
        oy = obstacles[..., None, None, :, 1]
        orad = obstacles[..., None, None, :, 2]
        dx = cand.positions[..., :, :, None, 0] - ox
        dy = cand.positions[..., :, :, None, 1] - oy
        dist = torch.sqrt(dx**2 + dy**2)  # (..., C, N, O)
        hard = torch.where(dist < orad * 2, 1000.0 * (orad * 2 - dist), 0.0)
        soft = torch.where(
            (dist >= orad * 2) & (dist < orad * 4), 10.0 / (dist - orad + 0.1), 0.0
        )
        pen = hard + soft
        if obstacles_valid is not None:
            pen = torch.where(obstacles_valid[..., None, None, :], pen, 0.0)
        cost = cost + torch.sum(pen, dim=(-2, -1))

    return cost
