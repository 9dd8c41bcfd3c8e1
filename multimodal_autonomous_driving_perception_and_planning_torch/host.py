"""Host-side result records.

The pipeline emits fixed-shape tensors; user-facing surfaces (the tagging
aggregation, the tag database, the apps) want the reference's record
shapes: lists of detections, tracks with trajectories, a VehicleState,
Trajectory objects (detector.py:14-26, multi_object_tracker.py:14-47,
vehicle_state.py:14-30, motion_planner.py:14-54).  This module converts a
runner's stacked outputs into those per-frame records on the host, after
the device work is done.  The outputs may be tensors on the card or the
CPU, or numpy arrays: `extract_frame` moves only frame f's slice of what it
reads to numpy.  A copy of the JAX package's host.py, which the port
cannot import.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .planning.planner import trajectory_type
from .types import VEHICLE_STATE_FIELDS

CLASS_NAMES = (
    "car",
    "truck",
    "pedestrian",
    "cyclist",
    "motorcycle",
    "bus",
    "traffic_light",
    "stop_sign",
)

# BGR per class (detector.py:51-60).
CLASS_COLORS = {
    0: (0, 255, 0),
    1: (0, 165, 255),
    2: (0, 0, 255),
    3: (255, 255, 0),
    4: (255, 0, 255),
    5: (0, 255, 255),
    6: (128, 0, 128),
    7: (0, 128, 255),
}


@dataclasses.dataclass
class HostDetection:
    bbox: Tuple[float, float, float, float]
    class_id: int
    class_name: str
    confidence: float

    @property
    def center(self) -> Tuple[float, float]:
        x1, y1, x2, y2 = self.bbox
        return ((x1 + x2) / 2, (y1 + y2) / 2)


@dataclasses.dataclass
class HostTrack:
    track_id: int
    bbox: Tuple[float, float, float, float]
    class_id: int
    class_name: str
    confidence: float
    age: int
    hits: int
    misses: int
    trajectory: List[Tuple[float, float]]
    velocity: Optional[Tuple[float, float]]

    @property
    def center(self) -> Tuple[float, float]:
        x1, y1, x2, y2 = self.bbox
        return ((x1 + x2) / 2, (y1 + y2) / 2)

    def predict_next_position(self) -> Tuple[float, float]:
        """Constant-velocity next-center prediction
        (multi_object_tracker.py:41-47)."""
        cx, cy = self.center
        if self.velocity:
            vx, vy = self.velocity
            return (cx + vx, cy + vy)
        return (cx, cy)


def get_all_trajectories(tracks: List["HostTrack"]) -> Dict[int, List[Tuple[float, float]]]:
    """{track_id: trajectory} for confirmed tracks
    (multi_object_tracker.py:243-249; the confirmed filter is already applied
    when `extract_frame` builds the track list)."""
    return {t.track_id: list(t.trajectory) for t in tracks}


def get_lane_center_offset(
    frame_width: int,
    left_points: Optional[np.ndarray],
    right_points: Optional[np.ndarray],
) -> Optional[float]:
    """Vehicle offset from lane center in pixels, from rasterized lane
    points (lane_detector.py:253-272).  Negative = lane center right of the
    vehicle.  Returns None unless both lanes exist."""
    if left_points is None or right_points is None:
        return None
    lane_center = (float(left_points[-1, 0]) + float(right_points[-1, 0])) / 2
    return frame_width / 2 - lane_center


@dataclasses.dataclass
class HostVehicleState:
    x: float
    y: float
    vx: float
    vy: float
    heading: float
    speed: float
    acceleration: float
    yaw_rate: float
    timestamp: float
    pos_uncertainty: float = 0.0
    vel_uncertainty: float = 0.0


@dataclasses.dataclass
class HostTrajectory:
    positions: np.ndarray  # (N, 2)
    velocities: np.ndarray  # (N,)
    cost: float
    trajectory_type: str

    def get_positions(self) -> np.ndarray:
        return self.positions


@dataclasses.dataclass
class FrameResult:
    frame_idx: int
    detections: List[HostDetection]
    tracks: List[HostTrack]
    vehicle_state: HostVehicleState
    optimal_trajectory: HostTrajectory
    candidate_trajectories: List[HostTrajectory]
    lane_left: Optional[np.ndarray]  # (3,) poly coeffs or None
    lane_right: Optional[np.ndarray]
    lane_offset: Optional[float]
    tags: Dict


def to_numpy(x) -> np.ndarray:
    """``x`` as a numpy array: a tensor (on any device) copied to the host,
    anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _unroll_ring(ring: np.ndarray, count: int) -> List[Tuple[float, float]]:
    cap = ring.shape[0]
    if count <= cap:
        pts = ring[:count]
    else:
        k = count % cap
        pts = np.concatenate([ring[k:], ring[:k]])
    return [tuple(p) for p in pts]


def trajectory_type_of(lateral_offset: float) -> str:
    """Alias of planning.planner.trajectory_type (single source for the
    0.5 m lane-keep/lane-change threshold, motion_planner.py:288-294)."""
    return trajectory_type(lateral_offset)


def extract_frame(outs: Dict, dets_in: Dict, f: int) -> FrameResult:
    """Build the FrameResult for frame f from a runner's stacked outputs.

    Args:
      outs: dict of stacked (F, ...) outputs: tensors on any device, or
        arrays.
      dets_in: the detection input stream dict (bbox/class_id/confidence/valid).
    """
    g = lambda k: to_numpy(outs[k][f])  # noqa: E731
    d = {k: to_numpy(dets_in[k][f]) for k in ("bbox", "class_id", "confidence", "valid")}

    detections = []
    for j in np.flatnonzero(d["valid"]):
        cid = int(d["class_id"][j])
        detections.append(
            HostDetection(
                bbox=tuple(d["bbox"][j].tolist()),
                class_id=cid,
                class_name=CLASS_NAMES[cid],
                confidence=float(d["confidence"][j]),
            )
        )

    tracks = []
    order = g("confirmed_order")
    n = int(g("num_confirmed"))
    fields = {k: g(k) for k in ("track_class_id", "track_vel_count", "track_id", "track_bbox", "track_confidence",
                                "track_age", "track_hits", "track_misses", "track_trajectory", "track_traj_len",
                                "track_velocity")}
    for s in order[:n]:
        cid = int(fields["track_class_id"][s])
        vel_count = int(fields["track_vel_count"][s])
        tracks.append(
            HostTrack(
                track_id=int(fields["track_id"][s]),
                bbox=tuple(fields["track_bbox"][s].tolist()),
                class_id=cid,
                class_name=CLASS_NAMES[cid],
                confidence=float(fields["track_confidence"][s]),
                age=int(fields["track_age"][s]),
                hits=int(fields["track_hits"][s]),
                misses=int(fields["track_misses"][s]),
                trajectory=_unroll_ring(
                    fields["track_trajectory"][s].reshape(-1, 2),
                    int(fields["track_traj_len"][s]),
                ),
                velocity=(
                    tuple(fields["track_velocity"][s].tolist()) if vel_count > 0 else None
                ),
            )
        )

    vs = outs["vehicle_state"]
    vstate = HostVehicleState(**{k: float(to_numpy(getattr(vs, k)[f])) for k in VEHICLE_STATE_FIELDS})

    costs = g("plan_costs")
    positions = g("plan_positions")
    velocities = g("plan_velocities")
    lat_offs = g("plan_lateral_offsets")
    cand_order = g("plan_order")
    candidates = [
        HostTrajectory(
            positions=positions[c],
            velocities=velocities[c],
            cost=float(costs[c]),
            trajectory_type=trajectory_type(float(lat_offs[c])),
        )
        for c in cand_order
    ]
    optimal = candidates[0]

    lane_left = lane_right = None
    lane_offset = None
    if "lane_obs" in outs:
        lo = outs["lane_obs"]
        if bool(to_numpy(lo.left_found[f])):
            lane_left = to_numpy(lo.left_fit[f])
        if bool(to_numpy(lo.right_found[f])):
            lane_right = to_numpy(lo.right_fit[f])
        if bool(to_numpy(lo.has_offset[f])):
            lane_offset = float(to_numpy(lo.offset_px[f]))

    tags = {}
    if "tags" in outs and outs["tags"]:
        tags = {k: to_numpy(v[f]) for k, v in outs["tags"].items()}

    return FrameResult(
        frame_idx=f,
        detections=detections,
        tracks=tracks,
        vehicle_state=vstate,
        optimal_trajectory=optimal,
        candidate_trajectories=candidates,
        lane_left=lane_left,
        lane_right=lane_right,
        lane_offset=lane_offset,
        tags=tags,
    )


class EgoStateHistory:
    """Host-side ego-state history with the reference estimator's getter
    surface (vehicle_state.py:200-240), capped at 1000 entries (:134-135).

    The device pipeline emits the per-frame VehicleState stacked over time;
    feed that in with `extend_from_outputs` (or append individual states).
    """

    def __init__(self, cap: int = 1000):
        self.cap = cap
        self._states: "collections.deque[HostVehicleState]" = collections.deque(
            maxlen=cap
        )

    def append(self, state: HostVehicleState) -> None:
        self._states.append(state)

    def extend_from_outputs(self, vehicle_state) -> None:
        """Ingest a stacked VehicleState of (T,) tensors or arrays."""
        cols = {k: to_numpy(getattr(vehicle_state, k)) for k in VEHICLE_STATE_FIELDS}
        for f in range(len(cols["x"])):
            self.append(HostVehicleState(**{k: float(v[f]) for k, v in cols.items()}))

    def get_state_history(self, n: Optional[int] = None) -> List[HostVehicleState]:
        states = list(self._states)
        if n is None:
            return states
        return states[-n:]

    def get_trajectory(self) -> np.ndarray:
        if not self._states:
            return np.array([])
        return np.array([[s.x, s.y] for s in self._states])

    def get_velocity_history(self) -> np.ndarray:
        if not self._states:
            return np.array([])
        return np.array([[s.vx, s.vy] for s in self._states])

    def get_speed_history(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._states:
            return np.array([]), np.array([])
        t = np.array([s.timestamp for s in self._states])
        return t, np.array([s.speed for s in self._states])

    def get_heading_history(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._states:
            return np.array([]), np.array([])
        t = np.array([s.timestamp for s in self._states])
        return t, np.array([s.heading for s in self._states])

    def reset(self) -> None:
        self._states.clear()


def lane_points(fit: np.ndarray, frame_height: int, n: int = 50) -> np.ndarray:
    """Rasterize a lane polynomial like lane_detector.py:163-167."""
    ys = np.linspace(frame_height * 0.6, frame_height, n)
    xs = np.polyval(fit, ys)
    return np.column_stack([xs, ys]).astype(np.int32)
