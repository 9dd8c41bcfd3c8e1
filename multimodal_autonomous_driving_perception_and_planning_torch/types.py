"""Fixed-shape state and output tables, as frozen dataclasses of tensors.

The same schemas as the JAX package's types.py: every collection is a
fixed-capacity table with a validity mask, so each kernel sees static
shapes.  The constructors take the device the tables live on.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


def _center(bbox: torch.Tensor) -> torch.Tensor:
    """((x1+x2)/2, (y1+y2)/2) of xyxy boxes (detector.py:23-26)."""
    return torch.stack(
        [(bbox[..., 0] + bbox[..., 2]) * 0.5, (bbox[..., 1] + bbox[..., 3]) * 0.5],
        dim=-1,
    )


@_frozen
class Detections:
    """Fixed-capacity detection table; leading dimension D = max_detections."""

    bbox: Any  # (D, 4) float32, xyxy
    class_id: Any  # (D,) int32
    confidence: Any  # (D,) float32
    valid: Any  # (D,) bool

    @property
    def center(self) -> torch.Tensor:
        return _center(self.bbox)

    @staticmethod
    def empty(capacity: int, device) -> "Detections":
        return Detections(
            bbox=torch.zeros((capacity, 4), dtype=torch.float32, device=device),
            class_id=torch.zeros((capacity,), dtype=torch.int32, device=device),
            confidence=torch.zeros((capacity,), dtype=torch.float32, device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )


@_frozen
class TrackTable:
    """Fixed-slot multi-object track table; a slot is occupied iff
    ``track_id > 0``.  ``trajectory`` is the flat interleaved (T, 2L) ring
    [x0, y0, x1, y1, ...]; ``traj_len`` counts total writes."""

    track_id: Any  # (T,) int32, 0 = free slot
    bbox: Any  # (T, 4) float32
    class_id: Any  # (T,) int32
    confidence: Any  # (T,) float32
    age: Any  # (T,) int32
    hits: Any  # (T,) int32
    misses: Any  # (T,) int32
    trajectory: Any  # (T, 2*L) float32
    traj_len: Any  # (T,) int32
    velocity: Any  # (T, 2) float32
    vel_count: Any  # (T,) int32
    next_id: Any  # () int32

    @property
    def alive(self) -> torch.Tensor:
        return self.track_id > 0

    @property
    def center(self) -> torch.Tensor:
        return _center(self.bbox)

    @staticmethod
    def empty(capacity: int, trajectory_length: int, device) -> "TrackTable":
        def zi(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        def zf(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return TrackTable(
            track_id=zi(capacity),
            bbox=zf(capacity, 4),
            class_id=zi(capacity),
            confidence=zf(capacity),
            age=zi(capacity),
            hits=zi(capacity),
            misses=zi(capacity),
            trajectory=zf(capacity, 2 * trajectory_length),
            traj_len=zi(capacity),
            velocity=zf(capacity, 2),
            vel_count=zi(capacity),
            next_id=torch.ones((), dtype=torch.int32, device=device),
        )


@_frozen
class KalmanState:
    """6-state constant-acceleration ego filter state plus the reference
    estimator's derived-quantity memory (vehicle_state.py:61-66)."""

    x: Any  # (6,) float32 [x, y, vx, vy, ax, ay]
    P: Any  # (6, 6) float32
    time: Any  # () float32
    prev_heading: Any  # () float32
    prev_speed: Any  # () float32

    @staticmethod
    def initial(initial_covariance: float, device) -> "KalmanState":
        def z():
            return torch.zeros((), dtype=torch.float32, device=device)

        return KalmanState(
            x=torch.zeros((6,), dtype=torch.float32, device=device),
            P=torch.eye(6, dtype=torch.float32, device=device) * initial_covariance,
            time=z(),
            prev_heading=z(),
            prev_speed=z(),
        )


@_frozen
class VehicleState:
    """Per-frame estimated ego state (vehicle_state.py:14-30)."""

    x: Any
    y: Any
    vx: Any
    vy: Any
    heading: Any
    speed: Any
    acceleration: Any
    yaw_rate: Any
    timestamp: Any
    pos_uncertainty: Any
    vel_uncertainty: Any


VEHICLE_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(VehicleState))


def vehicle_row(vstate: VehicleState) -> torch.Tensor:
    """The state as one (..., 11) float32 row in field order (a new tensor)."""
    return torch.stack(
        [torch.as_tensor(getattr(vstate, n), dtype=torch.float32) for n in VEHICLE_STATE_FIELDS], dim=-1
    )


def vehicle_state_from_row(row: torch.Tensor) -> VehicleState:
    """The state whose fields are views of the entries of an (..., 11) row."""
    return VehicleState(*row.unbind(-1))


@_frozen
class PlanResult:
    """Planner output: all candidates plus the selected optimum."""

    positions: Any  # (C, N, 2) float32 world xy
    headings: Any  # (C, N) float32
    velocities: Any  # (C, N) float32
    curvatures: Any  # (C, N) float32
    timestamps: Any  # (N,) float32
    costs: Any  # (C,) float32
    lateral_offsets: Any  # (C,) float32
    target_velocities: Any  # (C,) float32
    best: Any  # () int32 argmin-cost candidate index
    order: Any  # (C,) int32 stable cost-sorted candidate order


@_frozen
class LaneState:
    """Cross-frame lane-fit memory (lane_detector.py:43-45)."""

    left_fit: Any  # (3,) float32
    right_fit: Any  # (3,) float32
    left_valid: Any  # () bool
    right_valid: Any  # () bool

    @staticmethod
    def initial(device) -> "LaneState":
        def z():
            return torch.zeros((3,), dtype=torch.float32, device=device)

        def f():
            return torch.zeros((), dtype=torch.bool, device=device)

        return LaneState(left_fit=z(), right_fit=z(), left_valid=f(), right_valid=f())


@_frozen
class LaneObservation:
    """Per-frame lane detection output (lane_detector.py:169-174, 253-272)."""

    left_fit: Any
    right_fit: Any
    left_found: Any
    right_found: Any
    left_confidence: Any
    right_confidence: Any
    offset_px: Any
    has_offset: Any


@_frozen
class TaggingState:
    """Cross-frame memory of the three rule-based taggers (scene vote ring,
    maneuver history, per-slot interaction center history)."""

    scene_votes: Any  # (W,) int32
    scene_count: Any  # () int32
    man_history: Any  # (H, 6) float32
    man_count: Any  # () int32
    int_centers: Any  # (T, 2*H) float32, interleaved
    int_len: Any  # (T,) int32
    int_track_id: Any  # (T,) int32
    frame_count: Any  # () int32

    @staticmethod
    def initial(
        window: int,
        history: int,
        max_tracks: int,
        device,
        interaction_history: int | None = None,
    ) -> "TaggingState":
        if interaction_history is None:
            interaction_history = history

        def zi(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        return TaggingState(
            scene_votes=torch.full((window,), -1, dtype=torch.int32, device=device),
            scene_count=zi(),
            man_history=torch.zeros((history, 6), dtype=torch.float32, device=device),
            man_count=zi(),
            int_centers=torch.zeros(
                (max_tracks, 2 * interaction_history), dtype=torch.float32, device=device
            ),
            int_len=zi(max_tracks),
            int_track_id=zi(max_tracks),
            frame_count=zi(),
        )


@_frozen
class PipelineState:
    """Full per-frame carry of the pipeline."""

    tracks: TrackTable
    kalman: KalmanState
    lanes: LaneState
    tagging: TaggingState
    frame_idx: Any  # () int32


# --- trees of tensors --------------------------------------------------------
# The tables above nest as the JAX package's registered dataclasses do, so
# their leaves in field order, depth first, are `jax.tree_util.tree_leaves`'
# order: a state flattened here and one flattened there line up leaf by leaf.


def tree_leaves(tree) -> list:
    """The tensors of a table (or of a table of tables) in field order,
    depth first: the JAX package's leaf order."""
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree) for leaf in tree_leaves(getattr(tree, f.name))]
    return [tree]


def tree_unflatten(template, leaves):
    """A table shaped like ``template`` whose tensors are ``leaves``, in
    `tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if dataclasses.is_dataclass(node):
            return type(node)(**{f.name: build(getattr(node, f.name)) for f in dataclasses.fields(node)})
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn, *trees):
    """``fn`` over the corresponding tensors of tables shaped alike (or of
    dicts, tuples or lists of them).  A None is an empty subtree, as in
    `jax.tree_util.tree_map`: it stays None and ``fn`` never sees it."""
    first = trees[0]
    if first is None:
        return None
    if dataclasses.is_dataclass(first):
        return type(first)(
            **{f.name: tree_map(fn, *(getattr(t, f.name) for t in trees)) for f in dataclasses.fields(first)}
        )
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def to_numpy(tree):
    """A table (or a dict, tuple or list of tables) with every tensor copied
    to the host as a numpy array, every other leaf through `np.asarray` and
    every None kept: the JAX package's `types.to_numpy`."""
    return tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x), tree)


def stack_lanes(trees):
    """Tables shaped alike stacked on a new leading lane axis, one
    `torch.stack` a leaf."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def lane_of(tree, i: int):
    """Lane ``i`` of a table with a leading lane axis, as views."""
    return tree_map(lambda leaf: leaf[i], tree)


def map_lanes(fn, lanes: int, *args):
    """``fn`` on each of ``lanes`` lanes of its arguments (tables with a
    leading lane axis; None passes through), the results stacked: how the
    plain versions take a lane axis on the CPU."""
    return stack_lanes(
        [fn(*(None if a is None else lane_of(a, b) for a in args)) for b in range(lanes)]
    )
